"""Replica fleet + failover router: serving that assumes replicas die.

A copy of the JAX package's ``serving/replica.py`` (stdlib only; its
names, signatures, exception types and messages). A single engine lets
one wedged or dying backend take every in-flight request with it. This
module is the single-host half of the pod: N :class:`Replica`
identities over ONE :class:`~serving.engine.ServingEngine` — they share
the rung ladder and the versioned weight store, so a failover adds no
shape and a hot swap reaches every replica at once — behind a
:class:`FailoverRouter` that presents the engine interface to
:class:`~serving.service.ServingService` unchanged. Across processes
(``serving.transport``) the router's contract (route to the healthiest,
re-queue a dead replica's in-flight batch against survivors, hedge the
tail) stays; only the dispatch transport changes.

**Health gating.** Each replica carries a consecutive-failure circuit
breaker with half-open probing (``failure_threshold`` failures open
the circuit; after ``cooldown_s`` one probe is allowed through — a
success closes it, a failure re-opens) plus an EWMA of observed
dispatch latency. Routing picks the healthiest available replica:
closed circuits before half-open probes, lower EWMA first
(``policy="ewma"``), or strict rotation (``policy="round_robin"`` —
fully deterministic, what the chaos determinism tests pin).

**Dead-replica requeue.** A dispatch that raises :class:`ReplicaDead`
(or any other failure) marks the replica's health and immediately
re-dispatches the SAME in-flight batch against the next survivor —
the requeue, with the caller's remaining deadline
honored (``predict(deadline=...)`` stops the failover walk once the
deadline passes, and the service's retry layer then sheds exactly the
expired requests). When survivors exist but every circuit is open the
router fails TRANSIENTLY (:class:`ReplicaUnavailable` is a
``ConnectionError``), so the service's bounded-backoff retry re-enters
after the cooldown; only when every replica is permanently dead does
it fail fast (:class:`NoReplicasAvailable`).

**Hedged dispatch.** Optionally (``hedge=True``), a dispatch that
exceeds a latency-percentile threshold (``hedge_percentile`` of
observed dispatch latency times ``hedge_factor``, floored at
``hedge_floor_ms``) is mirrored to the next-healthiest replica and
the first result wins — the classic tail-taming hedge. Hedge and
failover dispatches run on other threads; the engine's dispatch enters
``fedcore.aggregate.full_fp32`` on whichever thread calls it, so a
mirror's reply is computed under the same fp32 settings as the
primary's (no TF32 on the card). When the
PRIMARY resolves first, the losing mirror's dispatch is marked
**cancelled**: its result is discarded when it lands and its outcome
does NOT count against the replica's circuit breaker or latency EWMA
(``hedges_cancelled`` fleet counter + per-replica ``cancelled``) — a
mirror that lost a race it was only drafted into must not distort
health. A mirror that WINS records normally (``hedge_wins``), and a
killed mirror still marks its replica dead even when cancelled (a
chaos kill is a fact about the replica, not about the race). Once
the threshold arms, EVERY dispatch — primary and mirror — runs
out-of-band (``record_timings=False``): two threads racing into the
engine's single-consumer timing slot would cross-bill the serving
worker's stage attribution, so hedged-mode spans trade the pad/
dispatch split (pad bills to dispatch) for the tail protection.

Observability: per-replica routed/ok/failed/requeued counters and
circuit state flow through :meth:`FailoverRouter.replica_stats` into
``ServeMetrics.snapshot()['failover']``; every served request span
carries ``replica_id``/``failovers`` (``service.py`` reads them from
the router's ``pop_timings`` slot).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import ThreadPoolExecutor, wait

from .chaos import CLEAN, FLAKY, KILL, SLOW, WEDGE, ChaosFault, \
    resolve_chaos_plan
from .metrics import LatencyHistogram
from .transport import InProcessTransport


class ReplicaDead(RuntimeError):
    """The replica is permanently gone — this dispatch and every later
    one. Routers treat it as terminal for the replica (health state
    'dead', never probed again) and requeue the in-flight batch; it is
    NOT a transient error (retrying the same replica is futile by
    definition)."""


class NoReplicasAvailable(RuntimeError):
    """Every replica in the fleet is permanently dead. Deliberately a
    plain RuntimeError with no transient wording: with nobody left to
    fail over to, a retry can only burn the caller's deadline."""


class ReplicaUnavailable(ConnectionError):
    """No replica is routable RIGHT NOW (circuits open, or everything
    failed this pass), but survivors exist. A ``ConnectionError`` on
    purpose: the service's transient classifier retries with backoff,
    by which time a cooldown may have half-opened a circuit."""


class Replica:
    """One serving identity over the shared engine, with the chaos
    plan injected at its dispatch boundary.

    The replica is deliberately thin: identity (``replica_id``), a
    dispatch counter (the chaos plan's time axis), and the dead flag.
    All model state — rung ladder, versioned weights — lives in
    the shared engine, which is exactly why a failover or hot swap
    adds no shape.
    """

    def __init__(self, replica_id: int, engine, plan=None,
                 service_rate_rows_s: float | None = None,
                 transport=None):
        """``transport``: the :class:`~serving.transport.
        DispatchTransport` this replica dispatches through. None (the
        default) builds an ``InProcessTransport`` over ``engine`` —
        the extracted direct-call path, byte-identical to the pre-seam
        behavior; a ``SocketTransport`` makes this replica a remote
        POD WORKER while every layer above (router health gating,
        requeue, hedging, the control plane) works unchanged. With a
        remote transport, ``engine`` is the pod's shared
        ``PodClientEngine`` facade (the router's one-engine contract
        then means one POD, exactly as it meant one rung ladder).

        ``service_rate_rows_s``: an optional per-replica CAPACITY
        model (the load twin of the chaos plan's ``slow`` cells, used
        by the control-plane tests): each
        dispatch reserves ``rows / rate`` seconds of this replica's
        serial capacity and waits until the replica is free before
        running — so a fleet of N such replicas serves at most
        ``N * rate`` rows/s and saturates REALISTICALLY (queue
        residency grows, deadlines blow, burn rate climbs) instead of
        at whatever one shared in-process engine happens to do. The
        wait is for the replica to come FREE, not for the modeled
        service time itself — the issuing worker stays pipelined, the
        way a dispatch queue to a real remote host would. None (the
        default) disables the model entirely: dispatch is
        bit-identical to a bare engine call."""
        self.replica_id = int(replica_id)
        self.engine = engine
        self.transport = (transport if transport is not None
                          else InProcessTransport(engine))
        self._plan = plan
        # None disables; anything else must validate — a falsy 0 must
        # hit the error below, not silently mean "infinitely fast"
        self._rate = (None if service_rate_rows_s is None
                      else float(service_rate_rows_s))
        if self._rate is not None and self._rate <= 0:
            raise ValueError(
                f"service_rate_rows_s={service_rate_rows_s} must be a "
                "positive rows/s capacity")
        self._next_free = 0.0
        self._lock = threading.Lock()
        self._dispatches = 0
        self.dead = False
        self.dead_reason: str | None = None

    @property
    def dispatches(self) -> int:
        with self._lock:
            return self._dispatches

    def predict(self, X, version: int | None = None,
                record_timings: bool = True,
                deadline: float | None = None, trace_ctx=None):
        """One engine dispatch through this replica's chaos boundary
        and transport. Raises :class:`ReplicaDead` once killed (this
        dispatch and forever after), :class:`ChaosFault` on
        wedge/flaky cells, and stretches slow cells by the plan's
        multiplier; clean cells run the transport bit-identically to
        a direct engine call (``InProcessTransport``). ``deadline``
        (absolute ``perf_counter``) and ``trace_ctx`` flow to the
        transport: a socket transport derives its connect/read
        timeouts from the remaining budget and carries the trace
        context across the wire; the in-process transport ignores
        both."""
        with self._lock:
            if self.dead:
                raise ReplicaDead(
                    f"replica {self.replica_id} is dead "
                    f"({self.dead_reason})")
            k = self._dispatches
            self._dispatches += 1
            role = (self._plan.role(self.replica_id, k)
                    if self._plan is not None else CLEAN)
            if role == KILL:
                self.dead = True
                self.dead_reason = f"chaos kill at dispatch {k}"
        if role == KILL:
            raise ReplicaDead(
                f"replica {self.replica_id} killed by chaos at "
                f"dispatch {k}")
        if role == WEDGE:
            # the stall happens, THEN the failure: a wedged backend
            # holds the connection open past the deadline before the
            # transport finally gives up — hedging exists to mask
            # exactly this window
            time.sleep(self._plan.wedge_s)
            raise ChaosFault(
                f"replica {self.replica_id} wedged at dispatch {k} "
                f"(stalled {self._plan.wedge_s}s, then dropped)")
        if role == FLAKY:
            raise ChaosFault(
                f"replica {self.replica_id} flaky dispatch {k}")
        if self._rate is not None:
            # the capacity model: reserve this batch's service time on
            # the replica's serial timeline, wait until the replica is
            # free (sleep OUTSIDE the lock — the reservation is the
            # critical section, the waiting is not)
            rows = 1 if X.ndim == 1 else int(X.shape[0])
            with self._lock:
                now = time.perf_counter()
                start = self._next_free if self._next_free > now else now
                self._next_free = start + rows / self._rate
            if start > now:
                time.sleep(start - now)
        t0 = time.perf_counter()
        out = self.transport.dispatch(X, version=version,
                                      deadline=deadline,
                                      trace_ctx=trace_ctx,
                                      record_timings=record_timings)
        if role == SLOW:
            # proportional, not fixed: a slow replica is slow on big
            # batches too, which is what the EWMA must learn
            time.sleep((self._plan.slow_mult - 1.0)
                       * (time.perf_counter() - t0))
        return out


class ReplicaSet:
    """N replicas over one shared engine (see module docstring).

    ``chaos`` takes the ``serving.chaos`` surface: None, a spec string
    (``"kill=0.01,flaky=0.05,seed=7"``), a ``ChaosSpec``, or a
    prebuilt ``ChaosPlan`` (shape-checked against ``n_replicas``).
    The engine should be warmed BEFORE wrapping (``engine.warmup()``);
    warmup never routes through replicas, so chaos cannot fire during
    warm-up and the dispatch counters count real traffic only.
    """

    def __init__(self, engine, n_replicas: int, chaos=None,
                 horizon: int = 4096,
                 service_rate_rows_s: float | None = None):
        n_replicas = int(n_replicas)
        if n_replicas < 1:
            raise ValueError(
                f"need at least one replica, got {n_replicas}")
        self.engine = engine
        self.plan = resolve_chaos_plan(chaos, n_replicas, horizon)
        self.replicas = [Replica(i, engine, self.plan,
                                 service_rate_rows_s=service_rate_rows_s)
                         for i in range(n_replicas)]

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, i: int) -> Replica:
        return self.replicas[i]


class ReplicaHealth:
    """Per-replica circuit breaker + latency EWMA (router-internal;
    all mutation happens under the router's lock)."""

    def __init__(self, failure_threshold: int, cooldown_s: float,
                 ewma_alpha: float):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.ewma_alpha = float(ewma_alpha)
        self.failures = 0  # consecutive
        self.dead = False
        self.ewma_s: float | None = None
        self._open_since: float | None = None
        self._half_open = False
        self._probe_inflight = False

    @property
    def state(self) -> str:
        if self.dead:
            return "dead"
        if self.failures < self.failure_threshold:
            return "closed"
        return "half_open" if self._half_open else "open"

    def available(self, now: float) -> bool:
        """Whether a dispatch may route here right now. An open
        circuit transitions to half-open once the cooldown elapses —
        the single observation that lets a recovered replica re-earn
        traffic instead of staying benched forever. Half-open admits
        exactly ONE in-flight probe (the router marks it via
        :meth:`on_probe` at pick time): concurrent dispatches — hedge
        mirrors especially — must not pile onto a maybe-still-broken
        replica before the probe's outcome is known."""
        if self.dead:
            return False
        if self.failures < self.failure_threshold:
            return True
        if self._half_open:
            return not self._probe_inflight
        if (self._open_since is not None
                and now - self._open_since >= self.cooldown_s):
            self._half_open = True
            return True
        return False

    def on_probe(self) -> None:
        """The router routed a dispatch to this half-open replica:
        close the probe window until the outcome lands."""
        if self._half_open:
            self._probe_inflight = True

    def on_success(self, dt_s: float) -> None:
        self.failures = 0
        self._open_since = None
        self._half_open = False
        self._probe_inflight = False
        a = self.ewma_alpha
        self.ewma_s = (dt_s if self.ewma_s is None
                       else a * dt_s + (1 - a) * self.ewma_s)

    def on_failure(self, now: float) -> None:
        self.failures += 1
        self._probe_inflight = False
        if self.failures >= self.failure_threshold:
            # (re-)open: a half-open probe that fails starts a fresh
            # cooldown rather than probing again immediately
            self._open_since = now
            self._half_open = False

    def on_cancelled(self) -> None:
        """A drafted hedge mirror's outcome was DISCARDED: release the
        half-open probe slot the pick may hold (leaking it would bench
        the replica forever) without recording success or failure —
        the circuit state and EWMA stay exactly as they were."""
        self._probe_inflight = False

    def on_dead(self) -> None:
        self.dead = True
        self._half_open = False
        self._probe_inflight = False


class FailoverRouter:
    """Health-gated, hedging, failover front over a replica fleet.

    Presents the engine interface (``predict`` / ``pop_timings`` /
    ``buckets`` / ``input_dim`` / versioned-weight methods), so it
    drops into :class:`~serving.service.ServingService` where a bare
    engine went — the service's transient-retry layer composes with
    the router's failover instead of being replaced by it: one
    ``predict`` call walks the survivors once (the requeue); if the
    walk ends with every circuit open, the TRANSIENT failure hands
    control back to the service's backoff, whose next attempt
    re-enters after cooldowns have half-opened circuits.
    """

    _POLICIES = ("ewma", "round_robin")

    def __init__(self, replicas, policy: str = "ewma",
                 failure_threshold: int = 3, cooldown_s: float = 0.25,
                 ewma_alpha: float = 0.2, hedge: bool = False,
                 hedge_percentile: int = 95, hedge_factor: float = 2.0,
                 hedge_floor_ms: float = 1.0,
                 hedge_min_samples: int = 20, registry=None,
                 hedge_window_s: float | None = None):
        """``registry`` (``utils.telemetry.Registry``, optional): when
        given, every successful dispatch additionally lands in the
        ``serve_replica_dispatch_seconds{replica=N}`` histogram family
        — the per-replica latency TIME SERIES the EWMA cannot provide
        (an EWMA has no window percentiles) — and in the fleet-level
        ``serve_fleet_dispatch_seconds`` series the adaptive hedge
        threshold reads. None keeps the router registry-free.

        ``hedge_window_s``: ADAPTIVE hedging — the hedge threshold becomes the
        ``hedge_percentile`` of the dispatch latencies observed in
        the trailing ``hedge_window_s`` seconds (the registry's
        rolling series) times ``hedge_factor``, instead of the same
        percentile of the all-time reservoir. A fleet whose latency
        regime SHIFTS (a slow replica joins, load rises, a chaos
        phase starts) re-arms its threshold within one window,
        where the all-time percentile would keep hedging against a
        distribution that no longer exists. Requires ``registry``
        (the window lives in its series); until the window holds
        ``hedge_min_samples`` dispatches the threshold falls back to
        the all-time reservoir — a cold window must not disarm
        tail protection that evidence already supports."""
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("FailoverRouter needs at least one replica")
        engines = {id(r.engine) for r in self.replicas}
        if len(engines) != 1:
            # the single-host contract: one rung ladder, one weight
            # store. Distinct engines would silently re-introduce
            # per-replica warm-ups and version skew (the message is the
            # JAX package's).
            raise ValueError(
                "all replicas must share ONE engine (one compiled "
                "bucket ladder / weight store); got "
                f"{len(engines)} distinct engines")
        self.engine = self.replicas[0].engine
        if policy not in self._POLICIES:
            raise ValueError(
                f"policy must be one of {self._POLICIES}, got {policy!r}")
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.policy = policy
        self.hedge = bool(hedge)
        self.hedge_percentile = int(hedge_percentile)
        self.hedge_factor = float(hedge_factor)
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.hedge_min_samples = int(hedge_min_samples)
        self.hedge_window_s = (None if hedge_window_s is None
                               else float(hedge_window_s))
        if self.hedge_window_s is not None:
            if self.hedge_window_s <= 0:
                raise ValueError(
                    f"hedge_window_s={hedge_window_s} must be positive")
            if registry is None:
                raise ValueError(
                    "adaptive hedging (hedge_window_s) needs a "
                    "registry= — the rolling window lives in its "
                    "series")
        # health-plane construction params kept: replicas added at
        # runtime (Autoscaler scale-out) get identical circuit/EWMA
        # settings to the founding fleet
        self._failure_threshold = int(failure_threshold)
        self._cooldown_s = float(cooldown_s)
        self._ewma_alpha = float(ewma_alpha)
        self._registry = registry
        self._removed = 0
        self._lock = threading.RLock()
        self._health = {r.replica_id: ReplicaHealth(
            failure_threshold, cooldown_s, ewma_alpha)
            for r in self.replicas}
        self._counts = {r.replica_id: {"routed": 0, "ok": 0,
                                       "failed": 0, "requeued": 0,
                                       "cancelled": 0}
                        for r in self.replicas}
        self.requeues = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.hedges_cancelled = 0
        self._rr = 0  # round-robin cursor (mutated under the lock)
        self._hist = LatencyHistogram(max_samples=4096)
        # per-replica dispatch-latency series (built once: the
        # registry's creation lock must not sit on the dispatch path)
        self._reg_hist = {} if registry is None else {
            r.replica_id: registry.histogram(
                "serve_replica_dispatch_seconds",
                "successful dispatch latency, by replica",
                labels={"replica": r.replica_id})
            for r in self.replicas}
        # fleet-level dispatch series: the adaptive hedge threshold's
        # rolling evidence (a per-replica family cannot answer "what
        # does a NORMAL dispatch cost right now" in one read)
        self._fleet_hist = None if registry is None else \
            registry.histogram(
                "serve_fleet_dispatch_seconds",
                "successful dispatch latency, fleet-wide (adaptive "
                "hedge window)")
        self._pool: ThreadPoolExecutor | None = None
        self._timings: dict | None = None

    # -- engine interface passthrough ---------------------------------
    @property
    def buckets(self):
        return self.engine.buckets

    @property
    def input_dim(self):
        return self.engine.input_dim

    @property
    def num_classes(self):
        return self.engine.num_classes

    @property
    def version(self):
        return self.engine.version

    @property
    def versions_installed(self):
        return self.engine.versions_installed

    @property
    def compile_count(self):
        return self.engine.compile_count

    @property
    def params(self):
        return self.engine.params

    @property
    def rff(self):
        return self.engine.rff

    def warmup(self) -> int:
        """Warm the shared ladder DIRECTLY on the engine — warmup
        is not traffic, so it never consumes chaos cells or dispatch
        counters, and one warmup serves every replica."""
        return self.engine.warmup()

    def swap_weights(self, *a, **kw):
        return self.engine.swap_weights(*a, **kw)

    def install_weights(self, *a, **kw):
        return self.engine.install_weights(*a, **kw)

    def retire(self, *a, **kw):
        return self.engine.retire(*a, **kw)

    def pop_timings(self) -> dict | None:
        """The router-owned stage-split slot (same single-consumer
        contract as the engine's): pad/dispatch split of the winning
        replica dispatch, plus ``replica`` / ``failovers`` /
        ``hedged`` — what the service stamps onto request spans."""
        t, self._timings = self._timings, None
        return t

    def close(self) -> None:
        """Shut the hedge pool down (idempotent). Outstanding hedge
        losers finish their dispatch first — an abandoned dispatch
        cannot be cancelled mid-flight anyway."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- elastic fleet -------------------------------------------------
    def fleet_size(self) -> int:
        with self._lock:
            return len(self.replicas)

    def add_replica(self, replica: Replica) -> int:
        """Grow the fleet at runtime — the Autoscaler's scale-out
        hook. The replica must share THE engine (the single-host
        contract ``__init__`` enforces: one rung ladder, one
        weight store — which is also why attaching is microseconds:
        there is nothing to warm or load, the engine came up once,
        ideally from an exported ladder). It gets a fresh circuit/EWMA
        with the founding fleet's settings and is routable from the
        next ``_pick``. Returns the replica id."""
        if replica.engine is not self.engine:
            raise ValueError(
                "added replica must share the fleet's ONE engine "
                "(one compiled bucket ladder / weight store)")
        rid = replica.replica_id
        reg_hist = None
        if self._registry is not None:
            # built OUTSIDE the router lock, same as __init__: the
            # registry's creation lock must not nest under routing
            reg_hist = self._registry.histogram(
                "serve_replica_dispatch_seconds",
                "successful dispatch latency, by replica",
                labels={"replica": rid})
        with self._lock:
            if any(r.replica_id == rid for r in self.replicas):
                raise ValueError(
                    f"replica id {rid} is already in the fleet")
            self.replicas.append(replica)
            self._health[rid] = ReplicaHealth(
                self._failure_threshold, self._cooldown_s,
                self._ewma_alpha)
            # counters survive a remove/re-add cycle (cumulative — an
            # id that served twice reports everything it ever did)
            self._counts.setdefault(rid, {"routed": 0, "ok": 0,
                                          "failed": 0, "requeued": 0,
                                          "cancelled": 0})
            if reg_hist is not None:
                self._reg_hist[rid] = reg_hist
        return rid

    def remove_replica(self, replica_id: int) -> None:
        """Retire a replica from ROUTING — the Autoscaler's scale-in
        hook. Its health and counter entries stay (an in-flight
        dispatch racing the removal still lands its accounting; the
        entries are a few ints), it just never gets picked again.
        Refuses to empty the fleet: scale-to-zero is a shutdown, not
        a routing decision."""
        with self._lock:
            idx = next((i for i, r in enumerate(self.replicas)
                        if r.replica_id == replica_id), None)
            if idx is None:
                raise KeyError(
                    f"replica {replica_id} is not in the fleet")
            if len(self.replicas) == 1:
                raise ValueError(
                    "refusing to remove the last replica — an empty "
                    "fleet serves nothing; stop the service instead")
            self.replicas.pop(idx)
            self._removed += 1

    # -- health / routing ---------------------------------------------
    def _pick(self, excluded: set) -> Replica | None:
        now = time.perf_counter()
        with self._lock:
            avail = [r for r in self.replicas
                     if r.replica_id not in excluded
                     and self._health[r.replica_id].available(now)]
            if not avail:
                return None
            if self.policy == "round_robin":
                n = len(self.replicas)
                ids = {r.replica_id for r in avail}
                cand = None
                for off in range(n):
                    c = self.replicas[(self._rr + off) % n]
                    if c.replica_id in ids:
                        self._rr = ((self._rr + off) + 1) % n
                        cand = c
                        break
            else:
                # ewma policy: closed circuits before half-open probes,
                # unsampled replicas before sampled (spread the first
                # dispatches), then lowest observed latency; replica id
                # breaks ties deterministically
                def key(r):
                    h = self._health[r.replica_id]
                    sampled = h.ewma_s is not None
                    return (0 if h.state == "closed" else 1,
                            1 if sampled else 0,
                            h.ewma_s if sampled else 0.0,
                            r.replica_id)
                cand = min(avail, key=key)
            if cand is not None:
                # routing to a half-open replica consumes its single
                # probe slot until the outcome lands
                self._health[cand.replica_id].on_probe()
            return cand

    def _raise_unroutable(self, excluded: set):
        with self._lock:
            # count over the CURRENT fleet, not the health dict: a
            # removed replica's retained health entry must not make a
            # live fleet read as all-dead
            n = len(self.replicas)
            dead = sum(1 for r in self.replicas
                       if self._health[r.replica_id].dead)
        if dead == n:
            raise NoReplicasAvailable(
                f"all {n} replicas are dead; nothing "
                "left to fail over to")
        raise ReplicaUnavailable(
            "no routable replica this pass (every survivor is "
            "circuit-open or already failed this batch); transient — "
            "cooldowns half-open circuits")

    def replica_stats(self) -> dict:
        """Per-replica counters + health state, plus fleet totals —
        consumed by ``ServeMetrics.snapshot()`` (the ``failover``
        section) and ``chip_smoke.py``'s ``fleet`` phase."""
        with self._lock:
            reps = {}
            dead = 0
            for r in self.replicas:
                h = self._health[r.replica_id]
                c = self._counts[r.replica_id]
                dead += int(h.dead)
                reps[str(r.replica_id)] = {
                    **c,
                    "state": h.state,
                    "ewma_ms": (None if h.ewma_s is None
                                else round(h.ewma_s * 1e3, 4)),
                }
            return {"replicas": reps, "requeues": self.requeues,
                    "hedges": self.hedges,
                    "hedge_wins": self.hedge_wins,
                    "hedges_cancelled": self.hedges_cancelled,
                    "dead_replicas": dead,
                    "fleet_size": len(self.replicas),
                    "removed_replicas": self._removed}

    # -- dispatch -----------------------------------------------------
    def _attempt(self, rep: Replica, X, version, record_timings,
                 cancel: threading.Event | None = None,
                 deadline: float | None = None, trace_ctx=None):
        """One replica dispatch with health + counter accounting.
        Returns ``(out, timing)``; raises the replica's failure after
        recording it (the caller decides whether to fail over).

        ``cancel`` (hedge mirrors only): when set by the time the
        dispatch completes, the outcome is DISCARDED from health
        accounting — no circuit-breaker failure, no EWMA sample, no
        ok/failed count; the per-replica ``cancelled`` counter records
        it instead. A :class:`ReplicaDead` still marks the replica
        dead (a kill is a fact about the replica, not the race). The
        check is best-effort by construction: a mirror whose dispatch
        completed in the instant before the winner set the flag has
        already recorded a genuine observation, which is harmless."""
        rid = rep.replica_id
        with self._lock:
            self._counts[rid]["routed"] += 1
        t0 = time.perf_counter()
        kw = {}
        # only forward what is SET: replica subclasses predating the
        # transport seam (old predict signatures) keep working for
        # deadline-free dispatch, and passing an explicit deadline to
        # one fails loudly instead of being silently dropped
        if deadline is not None:
            kw["deadline"] = deadline
        if trace_ctx is not None:
            kw["trace_ctx"] = trace_ctx
        try:
            out = rep.predict(X, version=version,
                              record_timings=record_timings, **kw)
        except ReplicaDead:
            cancelled = cancel is not None and cancel.is_set()
            with self._lock:
                self._health[rid].on_dead()
                if cancelled:
                    self._counts[rid]["cancelled"] += 1
                else:
                    self._counts[rid]["failed"] += 1
            raise
        except Exception:
            cancelled = cancel is not None and cancel.is_set()
            with self._lock:
                if cancelled:
                    self._counts[rid]["cancelled"] += 1
                    self._health[rid].on_cancelled()
                else:
                    self._health[rid].on_failure(time.perf_counter())
                    self._counts[rid]["failed"] += 1
            raise
        dt = time.perf_counter() - t0
        if cancel is not None and cancel.is_set():
            # the race is already answered: hand the result back (the
            # caller discards it) without letting a drafted mirror's
            # latency or success touch this replica's health; the
            # half-open probe slot it may hold is released so the
            # replica is not benched by a discarded observation
            with self._lock:
                self._counts[rid]["cancelled"] += 1
                self._health[rid].on_cancelled()
            return out, {"pad_s": 0.0, "dispatch_s": dt, "bucket": 0,
                         "version": version}
        # fallback model-version attribution when the engine's timing
        # slot is unavailable (untimed hedged attempts skip it): a
        # pinned dispatch (version=N, e.g. the rollout's candidate
        # split) must report N, not whatever is live — only a
        # version=None dispatch resolves to the engine's live version
        fb_ver = (version if version is not None
                  else getattr(self.engine, "version", None))
        if record_timings:
            pop = getattr(self.engine, "pop_timings", None)
            et = pop() if pop is not None else None
            pad = et["pad_s"] if et else 0.0
            timing = {
                "pad_s": pad,
                # chaos/scheduling stall beyond the engine's own split
                # bills to the dispatch stage — honest: that IS what a
                # slow backend looks like from the worker thread
                "dispatch_s": max(0.0, dt - pad),
                "bucket": (et or {}).get("bucket", 0),
                "version": (et or {}).get("version", fb_ver),
            }
        else:
            timing = {"pad_s": 0.0, "dispatch_s": dt, "bucket": 0,
                      "version": fb_ver}
        with self._lock:
            self._health[rid].on_success(dt)
            self._counts[rid]["ok"] += 1
        self._hist.record(dt)
        reg_hist = self._reg_hist.get(rid)
        if reg_hist is not None:
            # the telemetry-plane twin of the EWMA sample: a windowed
            # per-replica latency series (outside the router lock —
            # the instrument locks itself)
            reg_hist.observe(dt)
        if self._fleet_hist is not None:
            # the adaptive hedge window's evidence — cancelled
            # dispatches never reach here, so a drafted mirror's race
            # cannot distort the threshold either
            self._fleet_hist.observe(dt)
        return out, timing

    def _hedge_timeout_s(self) -> float | None:
        """The latency-percentile hedge threshold, in seconds — None
        until hedging is enabled AND enough dispatches were observed
        to make the percentile meaningful (hedging off a cold
        histogram would mirror everything). With ``hedge_window_s``
        set (adaptive mode), the percentile tracks the LIVE latency
        distribution — dispatches in the trailing window — and falls
        back to the all-time reservoir while the window is thin."""
        if not self.hedge:
            return None
        q = self.hedge_percentile
        if self.hedge_window_s is not None \
                and self._fleet_hist is not None:
            vals = self._fleet_hist.window_values(self.hedge_window_s)
            if len(vals) >= self.hedge_min_samples:
                vals.sort()
                idx = min(len(vals) - 1,
                          max(0, -(-q * len(vals) // 100) - 1))
                return max(self.hedge_floor_ms / 1e3,
                           vals[idx] * self.hedge_factor)
            # thin window: fall through to the all-time evidence
        if self._hist.count < self.hedge_min_samples:
            return None
        p = self._hist.percentiles((q,))[f"p{q}_ms"]
        if p is None:
            return None
        return max(self.hedge_floor_ms, p * self.hedge_factor) / 1e3

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, 2 * len(self.replicas)),
                    thread_name_prefix="hedge")
            return self._pool

    def _dispatch(self, rep: Replica, X, version, record_timings,
                  excluded: set, failed: set,
                  deadline: float | None = None, trace_ctx=None):
        """One (possibly hedged) attempt on ``rep``. Returns
        ``(out, timing, winner, hedged)``; raises only when the
        primary — and the mirror, if one launched — failed, adding
        every replica whose attempt raised to ``failed`` so the
        failover walk never re-dispatches this batch to a replica
        that already failed it (the mirror is not ``rep``)."""
        hedge_s = self._hedge_timeout_s()
        if hedge_s is None:
            try:
                out, timing = self._attempt(rep, X, version,
                                            record_timings,
                                            deadline=deadline,
                                            trace_ctx=trace_ctx)
            except Exception:
                failed.add(rep.replica_id)
                raise
            return out, timing, rep, False
        pool = self._ensure_pool()
        # ONCE ARMED, every attempt (primary included) is untimed: two
        # threads racing into the engine's single-consumer timing slot
        # would cross-bill the serving worker's stage attribution. The
        # untimed fallback can't see the version the engine resolves
        # at dispatch start, so snapshot the live version NOW — a
        # post-completion read would race a concurrent hot swap by the
        # whole dispatch duration and stamp the WRONG model_version on
        # the span
        ver0 = (version if version is not None
                else getattr(self.engine, "version", None))

        def attributed(timing):
            return {**timing, "version": ver0}

        primary = pool.submit(self._attempt, rep, X, version, False,
                              deadline=deadline, trace_ctx=trace_ctx)
        try:
            out, timing = primary.result(timeout=hedge_s)
            return out, attributed(timing), rep, False
        except FuturesTimeout:
            pass  # primary exceeded the threshold: hedge
        except Exception:
            failed.add(rep.replica_id)
            raise
        mirror_rep = self._pick(excluded | {rep.replica_id})
        if mirror_rep is None:
            # nobody to mirror to: ride the primary out
            try:
                out, timing = primary.result()
            except Exception:
                failed.add(rep.replica_id)
                raise
            return out, attributed(timing), rep, False
        with self._lock:
            self.hedges += 1
        cancel_mirror = threading.Event()
        mirror = pool.submit(self._attempt, mirror_rep, X, version,
                             False, cancel_mirror, deadline=deadline,
                             trace_ctx=trace_ctx)
        pending = {primary: rep, mirror: mirror_rep}
        last_exc: BaseException | None = None
        while pending:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                who = pending.pop(fut)
                try:
                    out, timing = fut.result()
                except BaseException as e:
                    failed.add(who.replica_id)
                    last_exc = e
                    continue
                if who is mirror_rep:
                    with self._lock:
                        self.hedge_wins += 1
                elif mirror in pending and not mirror.done():
                    # the primary resolved first: mark the losing
                    # mirror's STILL-RUNNING dispatch CANCELLED — its
                    # eventual result is discarded in _attempt
                    # without touching its replica's health/EWMA
                    # (counters: fleet
                    # hedges_cancelled here, per-replica 'cancelled'
                    # at the discarded completion). A mirror that
                    # already completed (both futures in one wake)
                    # recorded a genuine outcome — cancelling it now
                    # would only desync the two counters; the tiny
                    # done()-to-flag-check window remains best-effort
                    # by construction (see _attempt)
                    cancel_mirror.set()
                    with self._lock:
                        self.hedges_cancelled += 1
                return out, attributed(timing), who, True
        assert last_exc is not None
        raise last_exc

    def predict(self, X, version: int | None = None,
                record_timings: bool = True,
                deadline: float | None = None, trace_ctx=None):
        """Engine-compatible dispatch with failover (see class
        docstring). ``deadline`` is an absolute ``perf_counter`` time
        (the service passes the batch's earliest request deadline):
        once past it the failover walk stops with a TRANSIENT error,
        letting the service shed exactly the expired requests and
        retry the rest — a requeue never turns into a late success
        for a request whose caller already gave up. The deadline also
        flows INTO each attempt's transport, so a socket
        dispatch bounds its connect/read timeouts by the remaining
        budget; ``trace_ctx`` (a ``TRACECTX.v1`` carrier) rides along
        so remote workers join the request's trace."""
        excluded: set = set()
        failovers = 0
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                raise ReplicaUnavailable(
                    "failover stopped: request deadline reached before "
                    "a survivor answered")
            rep = self._pick(excluded)
            if rep is None:
                self._raise_unroutable(excluded)
            failed: set = set()
            try:
                out, timing, winner, hedged = self._dispatch(
                    rep, X, version, record_timings, excluded, failed,
                    deadline=deadline, trace_ctx=trace_ctx)
            except Exception:
                # the requeue: EVERY replica that failed this batch —
                # the primary, and the hedge mirror if one launched
                # and also failed — moves out of the walk, and the
                # batch re-dispatches to the next survivor immediately
                # (no backoff — the caller's clock is running)
                failed.add(rep.replica_id)
                failovers += 1
                with self._lock:
                    for rid in failed - excluded:
                        self.requeues += 1
                        self._counts[rid]["requeued"] += 1
                excluded |= failed
                continue
            if record_timings:
                timing = dict(timing)
                timing["replica"] = winner.replica_id
                timing["failovers"] = failovers
                if hedged:
                    timing["hedged"] = True
                self._timings = timing
            return out
