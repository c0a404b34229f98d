"""Overload control plane: burn-rate admission control + autoscaling.

A copy of the JAX package's ``serving/control.py`` (stdlib-only). The
SIGNAL layer: every request carries an ``slo_class``,
``ServeMetrics`` records a per-class latency family, and
``utils.telemetry.SloEvaluator`` turns it into attainment and
error-budget burn rate over rolling windows. Blind queue-depth
shedding at ``max_queue`` alone would take interactive and batch
traffic down together. This module is the CONTROL layer that consumes
those signals:

- :class:`AdmissionController` — sheds BEFORE queue residency blows
  the deadline. The trigger is burn rate > ``burn_threshold`` on a
  rolling window (the standard SRE signal: >1 means the error budget
  is burning faster than the objective allows); the queue-residency
  percentile family (``serve_queue_residency_seconds``, windowed)
  corroborates, so a burst of slow-but-served requests with an empty
  queue never sheds. Shedding is CLASS-AWARE and escalates one class
  at a time through ``shed_order`` (shadow first, then batch);
  classes not in the order — interactive — are never policy-shed (the
  ``max_queue`` door remains the last-resort backstop for them).
  Escalation is fast (``escalate_ticks`` corroborated evaluations),
  relaxation deliberately slow (``relax_ticks`` clean ones) — the
  hysteresis that keeps the controller from flapping a class in and
  out of service at the evaluation cadence. Rejections surface as
  :class:`AdmissionShed` (a typed outcome distinct from the deadline
  path), counted per class on ``serve_requests_shed_total{class=}``.

- :class:`Autoscaler` — spins replicas up and down from the same
  observed signals: scale OUT when a class burns past
  ``scale_up_burn`` (or requests are being policy-shed — shed traffic
  IS unserved demand) with queue residency corroborating; scale IN
  only after ``down_ticks`` consecutive quiet evaluations, and only
  replicas this autoscaler added (``min_replicas`` is a hard floor).
  Hysteresis is three-fold — separate up/down thresholds, consecutive
  -tick requirements, and a ``cooldown_s`` after every action — so
  the fleet never flaps. Scale-out calls the ``replica_factory``,
  which attaches a replica over an already-built engine.
  ``max_replicas`` bounds the fleet absolutely.

Both consumers poll; neither ever mutates an instrument —
``SloEvaluator.evaluate`` is a pure read, which is what makes it safe
to call from the submit path (the controller caches one decision per
``interval_s``) and from the autoscaler's tick thread concurrently.
Clocks are injectable (default: the metrics registry's clock), so the
tests drive hand-computed burn-rate fixtures through both machines
deterministically.
"""

from __future__ import annotations

import threading
import time

from ..utils.telemetry import DEFAULT_SLO_CLASSES, SloEvaluator
from .metrics import QUEUE_RESIDENCY_METRIC, SHED_CLASS_METRIC

#: Which classes shed, and in what order, as the controller escalates:
#: index 0 sheds first. Interactive is deliberately ABSENT — it is
#: never policy-shed; protecting it is the whole point of shedding the
#: others (the bounded queue remains its last-resort backstop).
DEFAULT_SHED_ORDER = ("shadow", "batch")


class AdmissionShed(RuntimeError):
    """Request policy-shed by the admission controller — a deliberate
    load-shedding verdict on a well-formed request, NOT a deadline
    blowout (``DeadlineExceeded``) and NOT queue backpressure
    (``Overloaded``). A caller seeing this should back off or degrade;
    retrying immediately re-offers exactly the load being shed."""


def _registry_of(metrics):
    """Accept a ``ServeMetrics`` bundle or a bare telemetry
    ``Registry`` — the controller and autoscaler only ever READ the
    registry underneath."""
    return getattr(metrics, "registry", metrics)


def admission_shed_rate(registry, window_s: float,
                        now: float | None = None) -> float:
    """Fleet-wide policy-shed rate (requests/s) over the trailing
    window, summed across the per-class ``serve_requests_shed_total``
    family — the autoscaler's capacity-shortfall signal: a class
    being shed is demand the current fleet is refusing, which burn
    rate alone stops reporting the moment shedding makes the served
    remainder look healthy."""
    total = 0.0
    for inst in registry.instruments():
        if inst.name == SHED_CLASS_METRIC and inst.kind == "counter":
            total += inst.rate(window_s, now=now)
    return total


def _queue_p95_ms(registry, window_s: float,
                  now: float | None = None) -> float | None:
    """Windowed p95 of queue-stage residency, in ms (None with no
    samples in the window) — the corroboration read both consumers
    share."""
    hist = registry.lookup(QUEUE_RESIDENCY_METRIC)
    if hist is None:
        return None
    p = hist.percentile(95, window_s=window_s, now=now)
    return None if p is None else p * 1e3


class AdmissionController:
    """Class-aware burn-rate admission control (module docstring).

    ``admit(slo_class)`` is the hot call — ``ServingService.submit``
    asks it once per request — so the decision is CACHED: at most one
    evaluation per ``interval_s``, everything between is a set lookup
    under a lock held for nanoseconds. The evaluation itself (window
    scans + the queue-percentile sort) runs OUTSIDE that lock: the
    thread whose admit() claims the interval gathers the evidence
    unlocked while every other submit keeps reading the previous
    verdict — one interval of staleness, never a stall. ``queue_floor_
    ms`` (default: half the tightest class threshold) is the
    corroboration bar: burn alone never sheds unless queued requests
    are actually aging toward their deadlines.
    """

    def __init__(self, metrics, classes=DEFAULT_SLO_CLASSES,
                 shed_order=DEFAULT_SHED_ORDER, window_s: float = 5.0,
                 burn_threshold: float = 1.0,
                 min_window_requests: int = 20,
                 queue_floor_ms: float | None = None,
                 interval_s: float = 0.05, escalate_ticks: int = 2,
                 relax_ticks: int = 4, clock=None):
        if not shed_order:
            raise ValueError("shed_order must name at least one class "
                             "(an admission controller that can shed "
                             "nothing is a no-op wearing the name)")
        if window_s <= 0 or interval_s <= 0:
            raise ValueError(
                f"window_s={window_s} and interval_s={interval_s} "
                "must be positive")
        if escalate_ticks < 1 or relax_ticks < 1:
            raise ValueError("escalate_ticks and relax_ticks must be "
                             ">= 1")
        self.registry = _registry_of(metrics)
        self.classes = tuple(classes)
        self.shed_order = tuple(shed_order)
        protected = {c.name for c in self.classes} - set(self.shed_order)
        if not protected:
            raise ValueError(
                "every evaluated class is in shed_order — at least one "
                "class must be protected (shedding exists to protect "
                "something)")
        self.window_s = float(window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_window_requests = int(min_window_requests)
        self.queue_floor_ms = (
            min(c.threshold_ms for c in self.classes) / 2.0
            if queue_floor_ms is None else float(queue_floor_ms))
        self.interval_s = float(interval_s)
        self.escalate_ticks = int(escalate_ticks)
        self.relax_ticks = int(relax_ticks)
        self.clock = clock if clock is not None else self.registry.clock
        self._evaluator = SloEvaluator(self.registry,
                                       classes=self.classes,
                                       windows_s=(self.window_s,))
        self._lock = threading.Lock()
        self._level = 0
        self._hot = 0       # consecutive corroborated-triggered evals
        self._cool = 0      # consecutive clean evals
        self._shed: frozenset = frozenset()
        self._last_eval = float("-inf")
        self._last: dict = {}  # the latest evaluation's evidence
        self.evaluations = 0

    # -- the decision -------------------------------------------------
    def admit(self, slo_class: str | None, now: float | None = None) -> bool:
        """Whether a request of ``slo_class`` may enter the queue
        right now. The submit-path call: cached verdict, re-evaluated
        at most every ``interval_s`` — the claiming thread evaluates
        with the lock RELEASED (concurrent submits read the previous
        verdict meanwhile; see class docstring)."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            due = now - self._last_eval >= self.interval_s
            if due:
                # claim the interval under the lock so exactly one
                # thread pays the evaluation; everyone else proceeds
                self._last_eval = now
        if due:
            self._evaluate(now)
        with self._lock:
            return (slo_class or "default") not in self._shed

    def decide(self, now: float | None = None) -> dict:
        """Force one evaluation and return its evidence (tests and
        dashboards; ``admit`` drives the same machine on its own
        cadence)."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            self._last_eval = now
        self._evaluate(now)
        with self._lock:
            return dict(self._last)

    def _evaluate(self, now: float) -> None:
        """Gather the evidence UNLOCKED (window scans + percentile
        sort — the expensive part), then apply the hysteresis
        transition and publish the new shed set under the lock."""
        burns = self._evaluator.burn_rates(self.window_s, now=now)
        q_ms = _queue_p95_ms(self.registry, self.window_s, now=now)
        triggered = [
            name for name, rec in burns.items()
            if rec["burn_rate"] is not None
            and rec["burn_rate"] > self.burn_threshold
            and rec["total"] >= self.min_window_requests]
        corroborated = q_ms is not None and q_ms >= self.queue_floor_ms
        with self._lock:
            self._apply_locked(now, burns, triggered, q_ms,
                               corroborated)

    def _apply_locked(self, now, burns, triggered, q_ms,
                      corroborated) -> None:
        self.evaluations += 1
        if triggered and corroborated:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.escalate_ticks \
                    and self._level < len(self.shed_order):
                self._level += 1
                self._hot = 0  # each further class needs fresh ticks
        else:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.relax_ticks and self._level > 0:
                self._level -= 1
                self._cool = 0
        self._shed = frozenset(self.shed_order[:self._level])
        self._last = {
            "t": round(now, 6), "level": self._level,
            "shed": sorted(self._shed), "triggered": triggered,
            "queue_p95_ms": None if q_ms is None else round(q_ms, 3),
            "corroborated": corroborated,
            "burns": {name: rec["burn_rate"]
                      for name, rec in burns.items()},
            "hot": self._hot, "cool": self._cool,
        }

    # -- observability -------------------------------------------------
    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def shed_classes(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._shed))

    def state(self) -> dict:
        """The latest evaluation's evidence (empty before the first)."""
        with self._lock:
            return dict(self._last)


class Autoscaler:
    """Burn-rate + queue-residency driven fleet sizing (module
    docstring). Owns nothing but the decision: the ``router``
    (``FailoverRouter``) holds the fleet, the ``replica_factory``
    builds one replica per scale-out (over the fleet's shared —
    ideally AOT artifact-loaded — engine), and ``metrics`` supplies
    the signals. ``tick()`` is one decision; ``start()`` runs it on a
    daemon thread at ``interval_s``. Not re-entrant: one ticker at a
    time (the poll thread, or a test driving ``tick`` by hand).
    """

    def __init__(self, router, replica_factory, metrics,
                 classes=DEFAULT_SLO_CLASSES, window_s: float = 5.0,
                 min_replicas: int | None = None, max_replicas: int = 8,
                 scale_up_burn: float = 1.0,
                 scale_down_burn: float = 0.5,
                 queue_floor_ms: float | None = None,
                 up_ticks: int = 2, down_ticks: int = 6,
                 cooldown_s: float = 1.0, min_window_requests: int = 20,
                 clock=None):
        if window_s <= 0 or cooldown_s < 0:
            raise ValueError(f"window_s={window_s} must be positive "
                             f"and cooldown_s={cooldown_s} >= 0")
        if up_ticks < 1 or down_ticks < 1:
            raise ValueError("up_ticks and down_ticks must be >= 1")
        if scale_down_burn >= scale_up_burn:
            raise ValueError(
                f"scale_down_burn={scale_down_burn} must sit strictly "
                f"below scale_up_burn={scale_up_burn} — the dead band "
                "between them is the hysteresis that stops flapping")
        self.router = router
        self.replica_factory = replica_factory
        self.registry = _registry_of(metrics)
        self.classes = tuple(classes)
        self.window_s = float(window_s)
        size0 = router.fleet_size()
        self.min_replicas = (size0 if min_replicas is None
                             else int(min_replicas))
        self.max_replicas = int(max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas={self.min_replicas} <= "
                f"max_replicas={self.max_replicas}")
        self.scale_up_burn = float(scale_up_burn)
        self.scale_down_burn = float(scale_down_burn)
        self.queue_floor_ms = (
            min(c.threshold_ms for c in self.classes) / 2.0
            if queue_floor_ms is None else float(queue_floor_ms))
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_s = float(cooldown_s)
        self.min_window_requests = int(min_window_requests)
        self.clock = clock if clock is not None else self.registry.clock
        self._evaluator = SloEvaluator(self.registry,
                                       classes=self.classes,
                                       windows_s=(self.window_s,))
        self._lock = threading.Lock()
        self._hot = 0
        self._quiet = 0
        self._last_action_t = float("-inf")
        self._added: list[int] = []  # replica ids this scaler added
        self._t0 = self.clock()
        # replica-seconds integral (the denominator of
        # attainment-per-replica-second): accumulated at every
        # size change, extrapolated at read time
        self._rs_acc = 0.0
        self._rs_mark = self._t0
        self._rs_size = size0
        self.events: list[dict] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- accounting ---------------------------------------------------
    def _mark_locked(self, now: float) -> None:
        self._rs_acc += self._rs_size * (now - self._rs_mark)
        self._rs_mark = now
        self._rs_size = self.router.fleet_size()

    def replica_seconds(self, now: float | None = None) -> float:
        """∫ fleet-size dt since construction — what a fixed-N fleet
        spends as ``N * wall``; the autoscaler's whole claim is doing
        the same SLO work with less of this."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            return self._rs_acc + self._rs_size * (now - self._rs_mark)

    # -- the decision -------------------------------------------------
    def tick(self, now: float | None = None) -> dict:
        """One sizing decision. Reads burn rates, the policy-shed
        rate, and windowed queue residency; applies the hysteresis
        machine; performs at most ONE add or remove. Returns the
        decision record (also appended to ``events`` when it acted).
        The replica build/attach runs OUTSIDE the scaler's lock — a
        factory loading an artifact must not stall a concurrent
        ``replica_seconds`` read."""
        now = self.clock() if now is None else float(now)
        burns = self._evaluator.burn_rates(self.window_s, now=now)
        shed_rate = admission_shed_rate(self.registry, self.window_s,
                                        now=now)
        q_ms = _queue_p95_ms(self.registry, self.window_s, now=now)
        burning = [
            name for name, rec in burns.items()
            if rec["burn_rate"] is not None
            and rec["burn_rate"] > self.scale_up_burn
            and rec["total"] >= self.min_window_requests]
        calm = all(
            rec["burn_rate"] is None
            or rec["burn_rate"] < self.scale_down_burn
            for rec in burns.values())
        corroborated = q_ms is not None and q_ms >= self.queue_floor_ms
        # shed traffic corroborates by itself: the controller only
        # sheds off the same queue evidence, and a fleet busy refusing
        # work must not wait for its (now-protected) queue to re-age
        up_signal = (burning and corroborated) or shed_rate > 0
        down_signal = calm and shed_rate == 0 and not corroborated
        with self._lock:
            if up_signal:
                self._hot += 1
                self._quiet = 0
            elif down_signal:
                self._quiet += 1
                self._hot = 0
            else:
                self._hot = 0
                self._quiet = 0
            size = self.router.fleet_size()
            cooled = now - self._last_action_t >= self.cooldown_s
            do_up = (self._hot >= self.up_ticks and cooled
                     and size < self.max_replicas)
            do_down = (not do_up and self._quiet >= self.down_ticks
                       and cooled and size > self.min_replicas
                       and bool(self._added))
            rid_down = self._added[-1] if do_down else None
        rec = {"t": round(now - self._t0, 4), "action": "hold",
               "size": size, "burning": burning,
               "shed_rate": round(shed_rate, 3),
               "queue_p95_ms": None if q_ms is None else round(q_ms, 3)}
        if do_up:
            try:
                next_id = 1 + max(
                    r.replica_id for r in self.router.replicas)
                t_a = time.perf_counter()
                rid = self.router.add_replica(
                    self.replica_factory(next_id))
                attach_ms = (time.perf_counter() - t_a) * 1e3
            except Exception:
                # a factory that cannot build (artifact missing, bad
                # engine) must not kill the tick loop — counted, and
                # the fleet simply stays its size this tick
                self.errors += 1
                rec["action"] = "error"
                return rec
            with self._lock:
                self._added.append(rid)
                self._hot = 0
                self._last_action_t = now
                self._mark_locked(now)
                self.scale_ups += 1
                rec.update(action="up", size=self._rs_size,
                           replica_id=rid,
                           attach_ms=round(attach_ms, 3))
                self.events.append(dict(rec))
        elif do_down:
            try:
                self.router.remove_replica(rid_down)
            except KeyError:
                # somebody else (an operator, a future controller)
                # already removed our replica: forget the stale id or
                # every later scale-in would retry it forever and the
                # fleet could never shrink
                with self._lock:
                    if rid_down in self._added:
                        self._added.remove(rid_down)
                self.errors += 1
                rec["action"] = "error"
                return rec
            except Exception:
                self.errors += 1
                rec["action"] = "error"
                return rec
            with self._lock:
                self._added.remove(rid_down)
                self._quiet = 0
                self._last_action_t = now
                self._mark_locked(now)
                self.scale_downs += 1
                rec.update(action="down", size=self._rs_size,
                           replica_id=rid_down)
                self.events.append(dict(rec))
        return rec

    # -- lifecycle ----------------------------------------------------
    def start(self, interval_s: float = 0.25) -> "Autoscaler":
        """Tick on a daemon thread every ``interval_s`` until
        :meth:`stop`. A tick that raises is counted (``errors``) and
        the loop continues — a transient signal-read failure must not
        leave the fleet unmanaged."""
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be positive")
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    self.errors += 1

        self._thread = threading.Thread(target=loop, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
