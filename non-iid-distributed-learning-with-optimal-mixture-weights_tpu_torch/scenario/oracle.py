"""``PropertyOracle``: run one composed scenario, assert the standing
invariants.

The JAX package's ``scenario/oracle.py`` on the port's modules: the same
invariants, verdicts and serve leg, and a train leg on the device the
oracle is given (``PropertyOracle(device=...)``: the card unless told
``"cpu"``).

A scenario runs in two legs off one :class:`~.spec.ScenarioPlan`:

- **train leg** — the fault plan drives ``rounds`` aggregation rounds
  through the port's defense plane (``fedcore.faults.inject_fault_row``
  -> ``fedcore.robust.sanitize_updates`` -> coordinatewise median ->
  hold the model when nobody is left), plain tensor code on the
  oracle's device. The clients' updates and losses are drawn with numpy
  from the scenario's ``updates`` stream, as in the JAX package, and
  moved to the device; the surviving global model comes back to the
  host as float32 and seeds the serve leg's weights.

- **serve leg** — on the host, as in the JAX package: a real pod:
  per-host numpy :class:`OracleEngine`
  behind in-process ``PodWorker`` TCP servers, ``SocketTransport``
  replicas (net-chaos plan attached) under a ``FailoverRouter``,
  ``ServingService`` with burn-rate admission control, the replica
  chaos plan at the dispatch boundary, and the event schedule firing
  kills / rejoins / swaps / scale events between submits.

The oracle then asserts the repo's standing invariants as typed
:class:`Violation` records (:data:`INVARIANTS` is the table the README
documents) instead of hard asserts — a campaign wants ALL violations
of a scenario, not the first.

Violations are deliberately TIMING-ROBUST: they hold (or break)
identically however the thread scheduler interleaves a run, which is
what lets the campaign pin bitwise-identical verdicts per seed while
latencies float. ``inject=`` plants harness-level bugs (a dropped
future, a duplicated span, a post-freeze compile) so the shrinker's
own tests can prove a seeded violation reduces to a minimal repro —
committed regressions replay with ``inject=()``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from ..device import resolve_device
from ..fedcore.faults import inject_fault_row
from ..fedcore.robust import coordinatewise_median, sanitize_updates
from ..utils.seeds import derive_rng
from ..utils.telemetry import Registry
from ..utils.trace import Tracer
from .spec import ScenarioPlan, ScenarioSpec

#: The standing invariants the oracle asserts, code -> statement.
INVARIANTS = {
    "LOST_REQUEST": "every accepted request's future resolves — with "
                    "a result or a TYPED failure, never silence",
    "SPAN_MISSING": "every submitted request lands exactly one "
                    "'request' span in the tracer (none missing)",
    "SPAN_DUPLICATE": "every submitted request lands exactly one "
                      "'request' span in the tracer (none doubled)",
    "RECOMPILE": "zero engine compiles after the warmup freeze, "
                 "whatever the chaos/load mix dispatched",
    "INTERACTIVE_SHED": "the interactive class is never policy-shed "
                        "(admission sheds shadow/batch first, and "
                        "only them)",
    "VERSION_DISAGREEMENT": "after the stream drains, every live "
                            "worker serves the pod's agreed weight "
                            "version (kills + swaps + rejoins "
                            "included)",
    "NONFINITE_AGG": "the aggregated global model stays finite "
                     "through every faulty round (NaN/Inf client "
                     "reports are quarantined, never aggregated)",
    "NONDETERMINISM": "the same master seed re-derives the bitwise "
                      "-identical scenario schedule",
    "LATENCY_REGRESSION": "with the latency property armed, the serve "
                          "leg's p95 stays within the calibrated "
                          "per-host baseline envelope (measured on "
                          "THIS host, un-chaosed, before the stream)",
}

#: Invariant codes whose firing depends on wall-clock timing, not the
#: seeded schedule. They ride the in-memory Verdict (and the artifact's
#: ``racy`` side channel) but stay OUT of ``Verdict.codes()`` — the
#: digest-stable fingerprint two same-seed runs must agree on — and
#: out of campaign gating: a loaded CI box must not turn a
#: deterministic sweep red.
RACY_CODES = frozenset({"LATENCY_REGRESSION"})

#: Harness-level bug injections (shrinker tests; module docstring).
INJECTABLE = ("lose_request", "dup_span", "recompile")

#: Failure types a resolved future may legitimately carry — the
#: serving plane's typed taxonomy. Anything else (or an unresolved
#: future) is a LOST_REQUEST.
_TYPED_OUTCOMES: tuple = ()  # filled lazily; serving imports are heavy


def _typed_outcomes() -> tuple:
    global _TYPED_OUTCOMES
    if not _TYPED_OUTCOMES:
        from ..serving.control import AdmissionShed
        from ..serving.replica import (NoReplicasAvailable, ReplicaDead,
                                       ReplicaUnavailable)
        from ..serving.service import (DeadlineExceeded, Overloaded,
                                       ServiceStopped)
        from ..serving.transport import FrameError
        _TYPED_OUTCOMES = (
            AdmissionShed, DeadlineExceeded, Overloaded, ServiceStopped,
            NoReplicasAvailable, ReplicaDead, ReplicaUnavailable,
            FrameError, ConnectionError)
    return _TYPED_OUTCOMES


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant break: the code (an :data:`INVARIANTS` key) and
    the human detail. ``detail`` is excluded from verdict digests —
    it may carry timing-flavored evidence; the CODE is the
    deterministic fact."""

    code: str
    detail: str

    def __post_init__(self):
        if self.code not in INVARIANTS:
            raise ValueError(
                f"unknown violation code {self.code!r} (expected one "
                f"of {sorted(INVARIANTS)})")


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One scenario's outcome: the spec it ran, the schedule digest it
    expanded to, every violation found, and the (deterministic subset
    of) run counts."""

    spec: str
    digest: str
    violations: tuple
    counts: dict

    @property
    def ok(self) -> bool:
        return not self.violations

    def codes(self) -> tuple:
        """Sorted STABLE violation codes — the digest-stable failure
        fingerprint two same-seed runs must agree on. Timing-racy
        codes (:data:`RACY_CODES`) are excluded; see
        :meth:`racy_codes`."""
        return tuple(sorted(v.code for v in self.violations
                            if v.code not in RACY_CODES))

    def racy_codes(self) -> tuple:
        """Sorted timing-racy violation codes — reported, never
        digested or gated on."""
        return tuple(sorted(v.code for v in self.violations
                            if v.code in RACY_CODES))

    #: counts that are pure functions of the seeded schedule. The
    #: live serve leg also tracks timing-RACY telemetry (how many
    #: requests resolved as results vs typed failures depends on
    #: whether a chaos wedge outlasts a deadline on THIS run), which
    #: stays on the in-memory Verdict but out of the artifact — the
    #: campaign artifact is bitwise-deterministic per seed, so only
    #: schedule-determined facts may land in it. ``resolved`` (the
    #: sum of both outcomes) is deterministic even though the split
    #: is not: the LOST_REQUEST invariant pins every request to
    #: resolve one way or the other.
    _STABLE_COUNTS = ("requests", "rounds", "lost", "kills",
                      "restarts", "scale_ups", "scale_downs")

    def to_record(self) -> dict:
        counts = {k: self.counts[k] for k in self._STABLE_COUNTS
                  if k in self.counts}
        if "served" in self.counts:
            counts["resolved"] = (self.counts["served"]
                                  + self.counts["typed_failures"])
        rec = {"spec": self.spec, "digest": self.digest,
               "ok": not self.codes(), "codes": list(self.codes()),
               "violations": [{"code": v.code, "detail": v.detail}
                              for v in self.violations
                              if v.code not in RACY_CODES],
               "counts": counts}
        racy = self.racy_codes()
        if racy:
            # the side channel: present only when a racy property
            # fired, so every record written before RACY_CODES
            # existed is byte-identical
            rec["racy"] = list(racy)
        return rec


# ---------------------------------------------------------------------
# the serve-leg engine
# ---------------------------------------------------------------------

class OracleEngine:
    """Numpy engine each pod worker hosts: ``predict`` is one matmul,
    so a scenario costs milliseconds, while the POD around it — frame
    protocol, sockets, failover, admission — is entirely real.

    The recompile invariant is made REAL here: ``warmup`` runs every
    ladder bucket once and freezes; any batch shape the service
    dispatches afterwards that the warmup never saw counts a compile
    (exactly what a fresh shape does to a compiled ladder). The batcher
    pads every dispatch to a bucket, so a nonzero post-freeze count is
    a genuine contract break, not noise."""

    def __init__(self, W, buckets=(1, 8, 32), version: int = 0):
        self.W = np.asarray(W, dtype=np.float32)
        if self.W.ndim != 2:
            raise ValueError(
                f"OracleEngine weights must be (classes, dim), got "
                f"shape {self.W.shape}")
        self.buckets = tuple(int(b) for b in buckets)
        self.compile_count = 0
        self._version = int(version)
        self._frozen = False
        self._shapes: set = set()
        self._lock = threading.Lock()

    @property
    def input_dim(self) -> int:
        return int(self.W.shape[1])

    @property
    def num_classes(self) -> int:
        return int(self.W.shape[0])

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def params(self) -> dict:
        """The live weight pytree — what the worker's ``sync`` frame
        serves a rejoining peer."""
        with self._lock:
            return {"w": self.W}

    @property
    def rff(self):
        return None

    def warmup(self) -> int:
        for b in self.buckets:
            self.predict(np.zeros((b, self.input_dim), np.float32))
        with self._lock:
            self._frozen = True
        return 0

    def predict(self, X, version=None, record_timings=True):
        X = np.asarray(X, dtype=np.float32)
        rows = int(X.shape[0])
        # pad to the ladder like the real ServingEngine does — the
        # compiled-program key is the BUCKET a batch lands in, so only
        # a batch no warmed bucket covers is a fresh compile
        bucket = next((b for b in sorted(self.buckets) if b >= rows),
                      rows)
        with self._lock:
            # the recompile DETECTOR, not a cache: a post-freeze novel
            # bucket shape is precisely the event being counted
            if bucket not in self._shapes:
                self._shapes.add(bucket)
                if self._frozen:
                    self.compile_count += 1
            W = self.W
        return X @ W.T

    def swap_weights(self, params=None, rff=None,
                     version: int | None = None) -> int:
        if params is None or "w" not in params:
            raise ValueError("OracleEngine.swap_weights needs params "
                             "with a 'w' entry")
        W = np.asarray(params["w"], dtype=np.float32)
        if W.shape != self.W.shape:
            raise ValueError(
                f"swap shape {W.shape} != installed {self.W.shape}")
        with self._lock:
            self.W = W
            self._version = (self._version + 1 if version is None
                             else int(version))
            return self._version


# ---------------------------------------------------------------------
# the train leg
# ---------------------------------------------------------------------

def _train_step(params, stacked, losses, drop, scale, poison, fill):
    """One round of the defense plane on the oracle's device: the plan
    row's faults injected, non-finite reports quarantined, the
    coordinatewise median of the present clients. Selections, masks and
    one scale, so a card run gives the CPU run's bits."""
    stacked, losses = inject_fault_row(
        params, stacked, losses, scale, poison, fill)
    stacked, losses, ok = sanitize_updates(params, stacked, losses)
    present = ok * (1.0 - drop)
    agg = coordinatewise_median(stacked, present)
    n = torch.sum(present)
    # an all-faulty round aggregates NOBODY: hold the model
    return {k: torch.where(n > 0, agg[k], params[k]) for k in agg}


#: Serve-leg model dimensions — fixed across scenarios so the pod's
#: bucket ladder is one shape family.
MODEL_CLASSES, MODEL_DIM = 3, 8

#: Calibration probes per host for the latency baseline leg, and the
#: fixed epsilon (seconds) added to the threshold — thread wakeup +
#: queue hop costs that scale with nothing the scenario controls.
_CALIBRATE_PROBES = 8
_LATENCY_EPSILON_S = 0.05


# ---------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------

class PropertyOracle:
    """Runs scenarios and returns :class:`Verdict` records.

    ``time_scale`` compresses the load schedule's arrival gaps (a 2s
    flash crowd replays in ~40ms of sleeps), ``max_gap_s`` caps any
    single gap, ``lost_wait_s`` bounds how long an unresolved future
    is presumed in flight before it is declared LOST, and ``inject``
    plants harness bugs (:data:`INJECTABLE`) for the shrinker tests.
    ``device`` is where the train leg runs (``None``: the card, which
    must exist; ``"cpu"`` to run without one); the serve leg is host
    code on any device.

    ``latency_slo`` (off by default) arms the
    calibrated-timing property family: before the stream, the oracle
    measures each host's un-chaosed dispatch baseline over its OWN
    wire (fresh chaos-free transport, :data:`_CALIBRATE_PROBES`
    probes), then asserts the run's end-to-end p95 stays under
    ``latency_slo``-times the worst per-host baseline p95 (plus a
    fixed scheduler-noise epsilon). Regressions land as the RACY
    ``LATENCY_REGRESSION`` violation: reported per run, excluded from
    digests and campaign gating — calibration makes the threshold
    machine-relative, but wall-clock is still wall-clock.
    """

    def __init__(self, inject=(), time_scale: float = 0.02,
                 max_gap_s: float = 0.01, request_timeout_s: float = 8.0,
                 lost_wait_s: float = 5.0,
                 latency_slo: float | None = None, device=None):
        self.device = resolve_device(device)
        inject = tuple(inject)
        for tok in inject:
            if tok not in INJECTABLE:
                raise ValueError(
                    f"unknown inject token {tok!r} (expected one of "
                    f"{INJECTABLE})")
        self.inject = inject
        if time_scale < 0 or max_gap_s < 0:
            raise ValueError("time_scale and max_gap_s must be >= 0")
        if lost_wait_s <= 0 or request_timeout_s <= 0:
            raise ValueError(
                "lost_wait_s and request_timeout_s must be positive")
        self.time_scale = float(time_scale)
        self.max_gap_s = float(max_gap_s)
        self.request_timeout_s = float(request_timeout_s)
        self.lost_wait_s = float(lost_wait_s)
        if latency_slo is not None and latency_slo <= 1.0:
            raise ValueError(
                f"latency_slo={latency_slo} must be > 1.0 (a factor "
                "over the calibrated baseline) or None")
        self.latency_slo = (None if latency_slo is None
                            else float(latency_slo))

    # -- entry ---------------------------------------------------------
    def run(self, spec) -> Verdict:
        if isinstance(spec, str):
            spec = ScenarioSpec.parse(spec)
        plan = spec.expand()
        violations: list[Violation] = []
        # the bitwise contract, asserted per run: a fresh parse of the
        # canonical string must re-derive the identical schedule
        digest = plan.digest()
        re_digest = ScenarioSpec.parse(
            spec.canonical()).schedule_digest()
        if re_digest != digest:
            violations.append(Violation(
                "NONDETERMINISM",
                f"schedule digest {digest[:12]} re-derived as "
                f"{re_digest[:12]} from the canonical spec string"))
        W = self._run_train(spec, plan, violations)
        counts = self._run_serve(spec, plan, W, violations)
        counts["rounds"] = spec.rounds
        return Verdict(spec=spec.canonical(), digest=digest,
                       violations=tuple(violations), counts=counts)

    # -- train leg -----------------------------------------------------
    def _run_train(self, spec: ScenarioSpec, plan: ScenarioPlan,
                   violations: list) -> np.ndarray:
        dev = self.device
        rng = derive_rng(spec.seed, "updates")
        W0 = rng.standard_normal(
            (MODEL_CLASSES, MODEL_DIM)).astype(np.float32)
        params = {"w": torch.from_numpy(W0).to(dev)}
        drop, scale, poison, fill, _ = plan.fault_plan.rows(
            0, spec.rounds, dev)
        for r in range(spec.rounds):
            noise = rng.standard_normal(
                (spec.clients, MODEL_CLASSES,
                 MODEL_DIM)).astype(np.float32) * 0.1
            stacked = {"w": params["w"][None, :, :]
                       + torch.from_numpy(noise).to(dev)}
            losses = torch.from_numpy(
                rng.uniform(0.5, 2.0, spec.clients).astype(
                    np.float32)).to(dev)
            params = _train_step(params, stacked, losses, drop[r],
                                 scale[r], poison[r], fill[r])
        W = params["w"].cpu().numpy()
        if not np.all(np.isfinite(W)):
            bad = int(np.size(W) - np.isfinite(W).sum())
            violations.append(Violation(
                "NONFINITE_AGG",
                f"{bad} non-finite coordinate(s) in the aggregated "
                f"global model after {spec.rounds} faulty round(s) "
                f"(fault spec {spec.fault_spec()!r})"))
            W = W0  # serve something finite so the serve leg still runs
        return W

    # -- serve leg -----------------------------------------------------
    def _run_serve(self, spec: ScenarioSpec, plan: ScenarioPlan,
                   W: np.ndarray, violations: list) -> dict:
        run = _ServeRun(self, spec, plan, W)
        try:
            run.start()
            run.drive()
            run.collect(violations)
        finally:
            run.close()
        return run.counts


class _ServeRun:
    """One scenario's serve leg: fleet lifecycle, the submit loop with
    the event schedule, then the invariant sweep. Split from the
    oracle so every piece of mutable run state dies with the run."""

    def __init__(self, oracle: PropertyOracle, spec: ScenarioSpec,
                 plan: ScenarioPlan, W: np.ndarray):
        self.oracle = oracle
        self.spec = spec
        self.plan = plan
        self.W0 = np.asarray(W, dtype=np.float32)
        self.engines: dict[int, OracleEngine] = {}
        self.workers: dict = {}       # host -> PodWorker | None (dead)
        self.endpoints: dict = {}     # host -> (host, port)
        self.replica_ids: list = []   # autoscale add stack
        self.pod = None
        self.router = None
        self.service = None
        self.tracer = Tracer()
        self.metrics = None
        self.futures: list = []       # (idx, slo_class, request_id, fut)
        self.counts = {
            "requests": 0, "served": 0, "typed_failures": 0, "lost": 0,
            "swaps_applied": 0, "events_skipped": 0, "kills": 0,
            "restarts": 0, "scale_ups": 0, "scale_downs": 0,
            # coverage axes of the hunter, harvested off the worker
            # counters (at kill time for the dying instance, at the
            # sweep for survivors). Schedule-determined — every
            # resync/refusal/rejection is a consequence of WHICH
            # events the plan scripted, not of thread timing — so the
            # hunter may steer on them. In-memory only: the pinned
            # artifact record layout predates them.
            "resyncs": 0, "sync_timeouts": 0, "stale_refused": 0,
            "forge_rejected": 0}
        self._next_host = spec.replicas
        self._latencies: list = []
        self._baseline_p95 = 0.0

    # -- fleet lifecycle ----------------------------------------------
    def _new_worker(self, host: int, port: int = 0, peers=None):
        from ..serving.transport import PodWorker

        engine = OracleEngine(self.W0)
        engine.warmup()
        self.engines[host] = engine
        worker = PodWorker(engine, port=port, worker_id=host,
                           tracer=self.tracer,
                           peers=list(peers or []),
                           forge_sync=self.plan.net_plan.forge_at(
                               host)).start()
        self.workers[host] = worker
        self.endpoints[host] = ("127.0.0.1", worker.port)
        return worker

    def _harvest(self, worker) -> None:
        """Fold one worker instance's sync-protocol counters into the
        run counts — called when the instance dies (its successor
        restarts from zero) and once per survivor at the sweep."""
        if worker is None:
            return
        for key in ("resyncs", "sync_timeouts", "stale_refused",
                    "forge_rejected"):
            self.counts[key] += int(getattr(worker, key, 0))

    def _live_endpoints(self, excluding: int | None = None) -> list:
        return [ep for h, ep in sorted(self.endpoints.items())
                if h != excluding and self.workers.get(h) is not None]

    def _attach_replica(self, host: int):
        from ..serving.replica import Replica
        from ..serving.transport import SocketTransport

        transport = SocketTransport(
            self.endpoints[host], client=self.pod, host_index=host,
            chaos=self.plan.net_plan, backoff_ms=20.0)
        return Replica(host, self.pod, plan=self.plan.chaos_plan,
                       transport=transport)

    def start(self):
        from ..serving.control import AdmissionController
        from ..serving.metrics import ServeMetrics
        from ..serving.replica import FailoverRouter
        from ..serving.service import ServingService
        from ..serving.transport import PodClientEngine

        for host in range(self.spec.replicas):
            self._new_worker(host)
        self.pod = PodClientEngine(
            [self.endpoints[h] for h in range(self.spec.replicas)])
        replicas = [self._attach_replica(h)
                    for h in range(self.spec.replicas)]
        self.metrics = ServeMetrics(registry=Registry())
        self.router = FailoverRouter(replicas, policy="round_robin")
        admission = AdmissionController(self.metrics)
        self.service = ServingService(
            self.router, metrics=self.metrics, tracer=self.tracer,
            admission=admission)
        self.service.__enter__()
        if self.oracle.latency_slo is not None:
            self._baseline_p95 = self._calibrate()

    def _calibrate(self) -> float:
        """The baseline leg of the latency property: per host, a fresh
        CHAOS-FREE transport dispatches :data:`_CALIBRATE_PROBES`
        one-row probes over the same wire the stream will use; the
        threshold anchors on the WORST host's p95, so the property
        measures regression relative to this machine right now, not
        against a number tuned on someone else's box."""
        from ..serving.transport import SocketTransport

        worst = 0.0
        for host in sorted(self.endpoints):
            x = np.zeros((1, MODEL_DIM), np.float32)
            laps = []
            with SocketTransport(self.endpoints[host],
                                 host_index=host) as t:
                for _ in range(_CALIBRATE_PROBES):
                    t0 = time.perf_counter()
                    t.dispatch(x, record_timings=False)
                    laps.append(time.perf_counter() - t0)
            worst = max(worst, float(np.percentile(laps, 95)))
        return worst

    def close(self):
        if self.service is not None:
            try:
                self.service.stop(drain_queue=True)
            except Exception:
                pass  # a clean teardown must not mask the verdict
        if self.router is not None:
            try:
                self.router.__exit__(None, None, None)
            except Exception:
                pass
        for worker in self.workers.values():
            if worker is not None:
                worker.stop()

    # -- the event schedule -------------------------------------------
    def _apply_event(self, ev):
        kind = ev.kind
        if kind == "kill":
            worker = self.workers.get(ev.arg)
            if worker is None:
                self.counts["events_skipped"] += 1
                return
            worker.stop()
            self._harvest(worker)
            self.workers[ev.arg] = None
            self.counts["kills"] += 1
        elif kind == "restart":
            self._restart(ev.arg)
        elif kind == "swap":
            self._swap(ev.arg)
        elif kind == "scale_up":
            self._scale_up()
        elif kind == "scale_down":
            self._scale_down()

    def _restart(self, host: int):
        if self.workers.get(host) is not None:
            self.counts["events_skipped"] += 1
            return
        # a SIGKILLed worker restarts from its checkpoint — the STALE
        # weights/version — and re-requests the agreed version from
        # its peers on handshake (the announce-gap fix)
        _, port = self.endpoints[host]
        self._new_worker(host, port=port,
                         peers=self._live_endpoints(excluding=host))
        self.counts["restarts"] += 1

    def _swap(self, ordinal: int):
        from ..serving.transport import TransportError

        delta = derive_rng(self.spec.seed, "swap", ordinal)\
            .standard_normal(self.W0.shape).astype(np.float32) * 0.05
        victims = [h for h in sorted(self.endpoints)
                   if self.plan.net_plan.announce_restart_at(h)
                   == ordinal]
        # the scripted mid-announce race: the victim dies
        # BEFORE this announce, then the on_announce hook restarts it
        # the instant its (failed) endpoint attempt returns — its
        # rejoin sync runs while the announce is still walking the
        # remaining endpoints, so the victim resyncs from a peer the
        # new version may not have reached yet
        for h in victims:
            worker = self.workers.get(h)
            if worker is not None:
                worker.stop()
                self._harvest(worker)
                self.workers[h] = None
                self.counts["kills"] += 1
        if victims:
            by_ep = {self.endpoints[h]: h for h in victims}

            def rejoin_mid_announce(ep, ok):
                h = by_ep.get(tuple(ep))
                if h is not None and self.workers.get(h) is None:
                    self._restart(h)

            self.pod.on_announce = rejoin_mid_announce
        try:
            self.pod.swap_weights({"w": self.W0 + delta})
        except (TransportError, OSError):
            # every worker down at announce time: a skipped swap is a
            # legitimate outcome (counted), not an invariant break
            self.counts["events_skipped"] += 1
            return
        finally:
            if victims:
                self.pod.on_announce = None
        self.counts["swaps_applied"] += 1

    def _scale_up(self):
        host = self._next_host
        self._new_worker(host, peers=self._live_endpoints())
        self.pod.endpoints.append(self.endpoints[host])
        rid = self.router.add_replica(self._attach_replica(host))
        self.replica_ids.append(rid)
        self._next_host += 1
        self.counts["scale_ups"] += 1

    def _scale_down(self):
        if not self.replica_ids:
            self.counts["events_skipped"] += 1
            return
        # retire the routing identity only; the worker stays in the
        # pod (it keeps receiving announces, and the version sweep
        # still covers it — a scaled-out host is not a dead host)
        self.router.remove_replica(self.replica_ids.pop())
        self.counts["scale_downs"] += 1

    # -- the submit loop ----------------------------------------------
    def drive(self):
        spec, plan = self.spec, self.plan
        events = list(plan.events)
        rng = derive_rng(spec.seed, "requests")
        rows_per = rng.randint(1, 5, size=spec.requests)
        X_all = rng.standard_normal(
            (int(rows_per.sum()), MODEL_DIM)).astype(np.float32)
        row0 = np.concatenate([[0], np.cumsum(rows_per)])
        for k in range(spec.requests):
            while events and events[0].at <= k:
                self._apply_event(events.pop(0))
            gap = min(float(plan.gaps[k]) * self.oracle.time_scale,
                      self.oracle.max_gap_s)
            if gap > 0:
                time.sleep(gap)
            self._submit_one(
                k, X_all[row0[k]:row0[k + 1]], plan.classes[k])
        for ev in events:           # events scheduled at the tail
            self._apply_event(ev)
        # any worker still down rejoins before the sweep — the version
        # -agreement invariant is a statement about the DRAINED pod
        for host, worker in sorted(self.workers.items()):
            if worker is None:
                self._restart(host)

    def _submit_one(self, k: int, x: np.ndarray, slo_class: str):
        fut = self.service.submit(
            x, timeout_s=self.oracle.request_timeout_s,
            slo_class=slo_class)
        if self.oracle.latency_slo is not None:
            t0 = time.perf_counter()
            fut.add_done_callback(
                lambda _f, t0=t0: self._latencies.append(
                    time.perf_counter() - t0))
        self.futures.append((k, slo_class, fut.request_id, fut))
        self.counts["requests"] += 1

    # -- the invariant sweep ------------------------------------------
    def collect(self, violations: list):
        self._inject_bugs()
        typed = _typed_outcomes()
        deadline = time.monotonic() + self.oracle.lost_wait_s \
            + self.oracle.request_timeout_s
        shed_interactive = []
        from ..serving.control import AdmissionShed
        for k, slo, _, fut in self.futures:
            try:
                fut.result(timeout=max(0.05,
                                       deadline - time.monotonic()))
                self.counts["served"] += 1
            except FutureTimeout:
                self.counts["lost"] += 1
                violations.append(Violation(
                    "LOST_REQUEST",
                    f"request {k} ({slo}) never resolved within "
                    f"{self.oracle.lost_wait_s:.1f}s past its "
                    "deadline — an accepted future went silent"))
            except typed as e:
                self.counts["typed_failures"] += 1
                if slo == "interactive" and isinstance(e, AdmissionShed):
                    shed_interactive.append(k)
            except BaseException as e:
                self.counts["lost"] += 1
                violations.append(Violation(
                    "LOST_REQUEST",
                    f"request {k} ({slo}) failed OUTSIDE the typed "
                    f"taxonomy: {type(e).__name__}: {e}"))
        for _, worker in sorted(self.workers.items()):
            self._harvest(worker)
        self._check_spans(violations)
        self._check_recompiles(violations)
        self._check_interactive(shed_interactive, violations)
        self._check_versions(violations)
        self._check_latency(violations)

    def _inject_bugs(self):
        inject = self.oracle.inject
        if "lose_request" in inject and self.futures:
            # the simulated dropped requeue: the caller's handle to
            # one mid-stream accepted request is forgotten unresolved
            k, slo, rid, _ = self.futures[len(self.futures) // 2]
            self.futures[len(self.futures) // 2] = (k, slo, rid,
                                                    Future())
        if "dup_span" in inject and self.futures:
            rid = self.futures[0][2]
            self.tracer.emit("request", rid, time.perf_counter(),
                             0.001, attrs={"injected": True})
        if "recompile" in inject and self.engines:
            self.engines[min(self.engines)].compile_count += 1

    def _check_spans(self, violations: list):
        from collections import Counter

        got = Counter(r["trace_id"] for r in self.tracer.records()
                      if r["name"] == "request")
        want = Counter(rid for _, _, rid, _ in self.futures)
        for rid in sorted(want - got):
            violations.append(Violation(
                "SPAN_MISSING",
                f"request {rid} resolved without a 'request' span"))
        for rid, n in sorted(got.items()):
            if n > want.get(rid, 0) and want.get(rid, 0) > 0:
                violations.append(Violation(
                    "SPAN_DUPLICATE",
                    f"request {rid} landed {n} 'request' spans"))

    def _check_recompiles(self, violations: list):
        total = sum(e.compile_count for e in self.engines.values())
        if total:
            violations.append(Violation(
                "RECOMPILE",
                f"{total} post-freeze compile(s) across "
                f"{len(self.engines)} engine(s) — the batcher "
                "dispatched a shape the warmed ladder never saw"))

    def _check_interactive(self, shed: list, violations: list):
        from ..serving.metrics import SHED_CLASS_METRIC

        counted = 0.0
        for inst in self.metrics.registry.instruments():
            if inst.name == SHED_CLASS_METRIC \
                    and inst.kind == "counter" \
                    and inst.label_dict.get("class") == "interactive":
                counted += inst.value
        if shed or counted:
            violations.append(Violation(
                "INTERACTIVE_SHED",
                f"interactive requests policy-shed: futures={shed}, "
                f"counter={counted:g} — the protected class shed"))

    def _check_versions(self, violations: list):
        agreed = self.pod.version
        stale = {h: e.version
                 for h, e in sorted(self.engines.items())
                 if self.workers.get(h) is not None
                 and e.version != agreed}
        if stale:
            violations.append(Violation(
                "VERSION_DISAGREEMENT",
                f"pod agreed on v{agreed} but live worker(s) serve "
                f"{stale} — an announce-gap rejoin kept stale "
                "weights"))

    def _check_latency(self, violations: list):
        slo = self.oracle.latency_slo
        if slo is None or not self._latencies:
            return
        p95 = float(np.percentile(self._latencies, 95))
        threshold = slo * self._baseline_p95 + _LATENCY_EPSILON_S
        if p95 > threshold:
            violations.append(Violation(
                "LATENCY_REGRESSION",
                f"serve p95 {p95 * 1e3:.1f}ms exceeds "
                f"{slo:g}x the calibrated baseline p95 "
                f"{self._baseline_p95 * 1e3:.1f}ms "
                f"(+{_LATENCY_EPSILON_S * 1e3:.0f}ms epsilon) over "
                f"{len(self._latencies)} request(s)"))
