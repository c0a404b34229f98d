"""Serving observability: latency percentiles, throughput, shed counts.

A copy of the JAX package's ``serving/metrics.py`` on this package's
``utils.telemetry``. Stdlib-only (a serving box must not grow runtime
deps for its gauges).
The histogram keeps raw samples up to a bound and computes percentiles
by sorting at snapshot time — exact, and at serving-bench scale (1e4-1e5
samples) far cheaper than maintaining quantile sketches. Past the bound
it degrades to uniform reservoir sampling, so long-running services keep
statistically honest tails instead of silently dropping the newest data
— and SAYS so: snapshots carry ``seen`` vs ``sampled`` counts and a
``reservoir_degraded`` flag, so a bench artifact can tell exact
percentiles from sampled ones.

:class:`ServeMetrics` is based on the typed instrument registry (``utils/telemetry.py``): every
counter/gauge is a registry instrument backed by a ring-buffer TIME
SERIES, so rolling rates and SLO burn-rate signals are computable at
any point (``ServeMetrics.slo()``), and the whole bundle exports
through the standard wire shapes (Prometheus text, OTLP JSON). The
``snapshot()`` dict has the JAX package's field names, so both
packages' snapshots compare key for key. Request latency is
additionally recorded per SLO CLASS (the
``serve_request_latency_seconds{class=...}`` family) — the per-class
attainment input of the control plane (``serving/control.py``).

Device-time attribution: a sampled ``torch.profiler`` probe
(``ServingEngine.device_attribution``) installed via
:meth:`ServeMetrics.install_device_attribution` splits the blocking
``device_*`` stage family into actual device compute vs launch, copy
and queue residency (``device_compute_*`` / ``xla_queue_*``: the JAX
package's key names, kept so both snapshots read the same; a
constant-fraction scaling of the measured family, exact for
percentiles). On the CPU the probe yields ``source="none"`` and the
split is honestly absent.
"""

from __future__ import annotations

import random
import threading
import time

from ..utils.telemetry import Registry, SloEvaluator

#: Bucket bounds (in ROWS) for the request/batch size histograms —
#: powers of two spanning the single-row to max-default-rung range.
ROWS_BOUNDS = tuple(float(2 ** k) for k in range(13))

#: Queue-stage residency as a registry TIME SERIES (seconds): the
#: windowed queue-percentile family the admission controller and
#: autoscaler corroborate the burn-rate trigger against —
#: the snapshot's ``queue_p50_ms`` family is exact but all-time, and a
#: control loop needs the recent tail.
QUEUE_RESIDENCY_METRIC = "serve_queue_residency_seconds"

#: Per-class door-shed counter family (``{class=...}``): requests
#: refused BEFORE queueing — policy sheds by the admission controller
#: and ``Overloaded`` rejections at ``max_queue`` alike. What
#: dashboards read to tell door shedding from deadline blowouts, and
#: what the autoscaler reads as its capacity-shortfall signal (a
#: class being refused IS unserved demand, whichever door refused it).
SHED_CLASS_METRIC = "serve_requests_shed_total"

#: Per-class deadline-miss counter family (``{class=...}``): requests
#: whose deadline expired UNSERVED. ``SloEvaluator`` folds the
#: window's misses into attainment as SLO-bad — a miss is bad
#: regardless of how long it waited (judging it by waited time would
#: read a 50ms death as "good" under a 100ms threshold and hide
#: overload from the burn signal precisely when callers run deadlines
#: tighter than the class objective).
DEADLINE_MISS_METRIC = "serve_deadline_misses_total"


class LatencyHistogram:
    """Exact-percentile latency recorder with reservoir degradation."""

    def __init__(self, max_samples: int = 100_000):
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._seen = 0
        self._rng = random.Random(0)  # deterministic reservoir
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._record_locked(seconds)

    def record_many(self, seconds) -> None:
        """Record a batch of samples under ONE lock round-trip — the
        serving worker records every request of a micro-batch at once,
        and under continuous batching (many small batches) per-sample
        locking was a measurable slice of the telemetry plane's cost."""
        with self._lock:
            for s in seconds:
                self._record_locked(s)

    def _record_locked(self, seconds: float) -> None:
        self._seen += 1
        if len(self._samples) < self.max_samples:
            self._samples.append(seconds)
        else:
            j = self._rng.randrange(self._seen)
            if j < self.max_samples:
                self._samples[j] = seconds

    @property
    def count(self) -> int:
        return self._seen

    @property
    def sampled(self) -> int:
        """Samples actually retained (== ``count`` until the reservoir
        bound is hit, then pinned at ``max_samples``)."""
        with self._lock:
            return len(self._samples)

    @property
    def degraded(self) -> bool:
        """True once ``percentiles()`` reports reservoir APPROXIMATIONS
        rather than exact order statistics — the honesty flag snapshots
        surface so an artifact can never pass a sampled tail off as an
        exact one."""
        with self._lock:
            return self._seen > len(self._samples)

    def accounting(self) -> dict:
        """The honesty triple: ``{"seen", "sampled",
        "reservoir_degraded"}``."""
        with self._lock:
            return {"seen": self._seen, "sampled": len(self._samples),
                    "reservoir_degraded": self._seen > len(self._samples)}

    def percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        """``{"p50_ms": ..., ...}`` — nearest-rank, in milliseconds."""
        with self._lock:
            data = sorted(self._samples)
        out = {}
        for q in qs:
            if not data:
                out[f"p{q}_ms"] = None
                continue
            idx = min(len(data) - 1, max(0, -(-q * len(data) // 100) - 1))
            out[f"p{q}_ms"] = round(data[idx] * 1e3, 4)
        return out


class ServeMetrics:
    """One bundle of everything a serving run and its tests
    assert on: request latency, rows/requests served, shedding, queue
    pressure, and (via the engine) the compile-cache counter.

    Counters/gauges are registry instruments (``self.registry``) so
    every one is also a monotonic-timestamped time series; the integer
    attributes the pre-registry surface exposed (``metrics.retries``
    etc.) remain as read properties. Pass ``registry=`` to share one
    registry across services or to run the plane in its cheap
    series-off mode (``Registry(enabled=False)``).
    """

    #: Per-request pipeline stages the service records
    #: (``service._serve_batch``): time queued before the batch formed,
    #: coalesce+pad to the bucket, and the engine dispatch itself.
    #: Snapshot keys are ``{stage}_p50_ms`` etc. — the per-stage
    #: percentile families that let a tail regression localize.
    STAGES = ("queue", "pad", "device")

    #: The sub-stage split of ``device`` the profiler attribution
    #: unlocks (additive; present only when a ``source == "profiler"``
    #: attribution is installed).
    DEVICE_SPLIT = ("device_compute", "xla_queue")

    def __init__(self, registry: Registry | None = None):
        self.registry = registry if registry is not None else Registry()
        self.latency = LatencyHistogram()
        # request-level stage latencies: batch-shared stages (pad,
        # device) record once per REQUEST in the batch, so the
        # percentiles weight stages by the requests they delayed —
        # comparable to the end-to-end latency histogram above
        self.stage_latency = {s: LatencyHistogram() for s in self.STAGES}
        self._lock = threading.Lock()
        reg = self.registry
        self._c_requests = reg.counter(
            "serve_requests_total", "requests served")
        self._c_rows = reg.counter("serve_rows_total", "rows served")
        self._c_batches = reg.counter(
            "serve_batches_total", "engine micro-batches dispatched")
        self._c_shed = {
            reason: reg.counter("serve_shed_total",
                                "requests shed, by reason",
                                labels={"reason": reason})
            for reason in ("deadline", "overload", "shutdown",
                           "admission")}
        # per-class policy sheds + deadline misses: children cached so the submit/worker paths skip
        # the registry creation lock
        self._shed_class: dict = {}
        self._miss_class: dict = {}
        self._c_retries = reg.counter(
            "serve_engine_retries_total",
            "transient engine-dispatch retries")
        self._c_requests_retried = reg.counter(
            "serve_requests_retried_total",
            "requests that saw at least one dispatch retry")
        self._c_swaps = reg.counter(
            "serve_weight_swaps_total", "hot weight swaps absorbed")
        self._c_shadow = reg.counter(
            "serve_shadow_requests_total",
            "requests mirrored to a rollout candidate")
        self._c_cand_err = reg.counter(
            "serve_candidate_errors_total",
            "candidate dispatch failures absorbed")
        self._c_rollbacks = reg.counter(
            "serve_rollbacks_total", "rollout rollbacks")
        self._c_staleness_err = reg.counter(
            "serve_staleness_errors_total",
            "failed live staleness lookups")
        self._c_probe_dropped = reg.counter(
            "serve_shadow_probes_dropped_total",
            "shadow probes dropped at the off-thread probe queue")
        # request/batch size evidence: raw row counts as histogram
        # SERIES — what a ladder learner reads to re-bucket from
        # observed traffic
        self._h_req_rows = reg.histogram(
            "serve_request_rows", "rows per served request",
            bounds=ROWS_BOUNDS)
        self._h_batch_rows = reg.histogram(
            "serve_batch_rows", "rows per dispatched micro-batch",
            bounds=ROWS_BOUNDS)
        # queue-stage residency as a windowed series: the
        # admission/autoscaling corroboration family — stage_latency
        # above keeps the exact all-time percentiles the snapshot
        # contract reads; a control loop reads the recent tail here
        self._h_queue_res = reg.histogram(
            QUEUE_RESIDENCY_METRIC,
            "queue-stage residency per request (control-plane "
            "corroboration window)")
        self._g_queue_depth = reg.gauge(
            "serve_queue_depth", "observed queue depth at submit")
        self._g_staleness = reg.gauge(
            "serve_staleness_rounds",
            "rounds the live model trails the newest published one")
        # per-SLO-class latency family (seconds): what SloEvaluator
        # reads; children cached here so the per-batch path skips the
        # registry's creation lock (idempotent either way)
        self._lat_class: dict = {}
        self.requests_by_version: dict = {}
        self.model_version = None
        self.staleness_rounds = 0
        # live staleness source (the rollout controller installs its
        # registry lookup here): snapshot() re-derives staleness at
        # read time, so a service that STOPS swapping still reports
        # itself falling behind as training publishes — the swap-time
        # cache alone would freeze at its last value
        self.staleness_of = None
        self._queue_depth_peak = 0
        self._max_request_retries = 0
        # the sampled profiler attribution (install_device_attribution)
        self._device_attr: dict | None = None
        self._t_first = None
        self._t_last = None

    # -- pre-registry integer surface (read compatibility) ------------
    @property
    def requests_served(self) -> int:
        return int(self._c_requests.value)

    @property
    def rows_served(self) -> int:
        return int(self._c_rows.value)

    @property
    def batches(self) -> int:
        return int(self._c_batches.value)

    @property
    def shed_deadline(self) -> int:
        return int(self._c_shed["deadline"].value)

    @property
    def shed_overload(self) -> int:
        return int(self._c_shed["overload"].value)

    @property
    def shed_shutdown(self) -> int:
        return int(self._c_shed["shutdown"].value)

    @property
    def shed_admission(self) -> int:
        return int(self._c_shed["admission"].value)

    @property
    def retries(self) -> int:
        return int(self._c_retries.value)

    @property
    def requests_retried(self) -> int:
        return int(self._c_requests_retried.value)

    @property
    def max_request_retries(self) -> int:
        with self._lock:
            return self._max_request_retries

    @property
    def queue_depth_peak(self) -> int:
        with self._lock:
            return self._queue_depth_peak

    @property
    def weight_swaps(self) -> int:
        return int(self._c_swaps.value)

    @property
    def shadow_requests(self) -> int:
        return int(self._c_shadow.value)

    @property
    def candidate_errors(self) -> int:
        return int(self._c_cand_err.value)

    @property
    def rollbacks(self) -> int:
        return int(self._c_rollbacks.value)

    @property
    def staleness_errors(self) -> int:
        return int(self._c_staleness_err.value)

    @property
    def shadow_probes_dropped(self) -> int:
        return int(self._c_probe_dropped.value)

    # -- recording ----------------------------------------------------
    def _class_hist(self, slo_class: str):
        hist = self._lat_class.get(slo_class)
        if hist is None:
            hist = self.registry.histogram(
                "serve_request_latency_seconds",
                "end-to-end request latency, by SLO class",
                labels={"class": slo_class})
            self._lat_class[slo_class] = hist
        return hist

    def observe_queue_depth(self, depth: int) -> None:
        self._g_queue_depth.set(depth)
        with self._lock:
            if depth > self._queue_depth_peak:
                self._queue_depth_peak = depth

    def record_shed(self, reason: str,
                    slo_class: str | None = None) -> None:
        """``reason``: 'deadline' (request expired while queued),
        'overload' (rejected at the door), 'admission' (policy-shed by
        the admission controller), or 'shutdown' (backlog dropped by a
        non-draining stop) — separable signals: an operator alerting
        on deadline violations must not page on a deliberate shutdown.

        ``slo_class``: the shed request's class. Deadline sheds count
        on the per-class ``serve_deadline_misses_total`` family, which
        ``SloEvaluator`` folds into attainment as SLO-bad; 'overload'
        (``max_queue``) rejections count on the per-class door-shed
        family the autoscaler reads — either way, without the class
        dimension overload would be invisible to the control signals
        exactly when it matters (survivorship bias: only the requests
        that still got served would report latency). Misses are a
        COUNTER, not a waited-time latency sample: a miss is bad
        whatever it waited, while a waited-time sample under the class
        threshold would read as good whenever a caller's deadline is
        tighter than the SLO."""
        self._c_shed.get(reason, self._c_shed["overload"]).inc()
        if slo_class is None:
            return
        if reason == "deadline":
            c = self._miss_class.get(slo_class)
            if c is None:
                c = self.registry.counter(
                    DEADLINE_MISS_METRIC,
                    "requests whose deadline expired unserved, "
                    "by class",
                    labels={"class": slo_class})
                self._miss_class[slo_class] = c
            c.inc()
        elif reason == "overload":
            # a max_queue rejection is a door shed like an admission
            # shed: same per-class family, so burn/shed-rate consumers
            # see refused interactive traffic instead of a healthy
            # survivor population
            self._shed_counter(slo_class).inc()

    def _shed_counter(self, slo_class: str):
        c = self._shed_class.get(slo_class)
        if c is None:
            c = self.registry.counter(
                SHED_CLASS_METRIC,
                "requests shed at the door (admission policy or "
                "max_queue overload), by class",
                labels={"class": slo_class})
            self._shed_class[slo_class] = c
        return c

    def record_admission_shed(self, slo_class: str) -> None:
        """One request policy-shed at the door by admission control
       : counted per CLASS on the ``serve_requests_shed_
        total{class=...}`` family (the dashboard/autoscaler signal)
        and under the generic shed reason 'admission'. Deliberately
        NOT recorded into the latency family or the miss counter —
        the controller's own shedding must not feed back into its
        burn trigger (it would lock the shed level in forever)."""
        self._shed_counter(slo_class).inc()
        self._c_shed["admission"].inc()

    def record_swap(self, version, staleness_rounds: int = 0) -> None:
        """One hot weight swap: ``version`` is now live,
        ``staleness_rounds`` rounds behind the newest published model
        (0 when it IS the newest). Called by the rollout controller on
        promote/revert — the dimension that lets an operator see the
        service keep pace with training."""
        self._c_swaps.inc()
        self._g_staleness.set(int(staleness_rounds))
        with self._lock:
            self.model_version = version
            self.staleness_rounds = int(staleness_rounds)

    def record_shadow(self, n_requests: int) -> None:
        """Shadow dispatches: requests mirrored to the candidate but
        answered from the live version (dark-launch traffic, never
        caller-visible)."""
        self._c_shadow.inc(int(n_requests))

    def record_candidate_error(self, n_requests: int = 1) -> None:
        """Candidate dispatch failures absorbed by the live fallback
        (ab mode) or discarded (shadow mode) — what the rollout error
        budget counts."""
        self._c_cand_err.inc(int(n_requests))

    def record_rollback(self) -> None:
        self._c_rollbacks.inc()

    def record_staleness_error(self) -> None:
        """One failed staleness lookup (``staleness_of`` or a router's
        ``staleness_rounds`` raising) absorbed by a staleness-unknown
        default — counted so a broken registry hookup is visible
        instead of reading as a permanently-current service."""
        self._c_staleness_err.inc()

    def record_probe_dropped(self, n_requests: int = 1) -> None:
        """Shadow probes shed at the off-thread probe queue (the queue
        bounds probe backlog so a slow candidate can never leak memory
        on the probe thread) — counted, never silent: the rollout
        controller sees fewer observations, and an operator can tell
        "candidate under-observed" from "candidate healthy"."""
        self._c_probe_dropped.inc(int(n_requests))

    def record_retry(self) -> None:
        """One transient engine-dispatch failure absorbed by the
        service's bounded-backoff retry (``service._serve_batch``).
        A nonzero steady rate is the operator's early-warning signal
        that the engine's backend is flapping even while every request
        still succeeds."""
        self._c_retries.inc()

    def install_device_attribution(self, attr: dict | None) -> None:
        """Install a sampled device-time attribution record
        (``ServingEngine.device_attribution`` /
        ``utils.telemetry.attribute_device_time``). With
        ``source == "profiler"`` the snapshot's ``device_*`` family
        grows the ``device_compute_*`` / ``xla_queue_*`` split; any
        other source (the CPU fallback) is surfaced verbatim so the
        artifact records WHY the split is absent."""
        with self._lock:
            self._device_attr = None if attr is None else dict(attr)

    def record_batch(self, n_requests: int, n_rows: int,
                     latencies: list[float],
                     now: float | None = None,
                     stage_seconds: dict | None = None,
                     request_retries: list[int] | None = None,
                     version=None, slo_classes=None,
                     rows_per_request: list[int] | None = None) -> None:
        """``stage_seconds``: ``{"queue": [per-request s, ...],
        "pad": s, "device": s}`` — scalar stages are batch-shared and
        recorded once per request (see ``stage_latency``).
        ``request_retries``: per-request transient-dispatch retry
        counts (the batch-level aggregate already rides
        :meth:`record_retry`). ``version``: which model version
        answered this batch (per-version served counts).
        ``slo_classes``: per-request SLO class names aligned with
        ``latencies`` (default: every request in the "default" class)
        — the label on the registry latency family the SLO evaluator
        reads. ``rows_per_request``: per-request row counts — the
        request-size evidence the ladder learner consumes
        (``serve_request_rows``); the batch total always lands on
        ``serve_batch_rows``."""
        now = time.perf_counter() if now is None else now
        self._c_batches.inc()
        self._c_requests.inc(int(n_requests))
        self._c_rows.inc(int(n_rows))
        self._h_batch_rows.observe(int(n_rows))
        if rows_per_request:
            self._h_req_rows.observe_many(rows_per_request)
        with self._lock:
            if version is not None:
                self.requests_by_version[version] = (
                    self.requests_by_version.get(version, 0) + n_requests)
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
            if request_retries:
                n_retried = sum(1 for r in request_retries if r > 0)
                self._max_request_retries = max(self._max_request_retries,
                                                *request_retries)
            else:
                n_retried = 0
        if n_retried:
            self._c_requests_retried.inc(n_retried)
        # bulk paths throughout: one lock round-trip per instrument
        # per BATCH, not per request — under continuous batching the
        # batch count multiplies, and per-sample locking here was a
        # measurable slice of the telemetry plane's <=1.05x budget
        self.latency.record_many(latencies)
        if slo_classes and len(slo_classes) != len(latencies):
            # the old per-index loop raised IndexError on a short
            # list; the bulk zip below would silently truncate — and
            # a per-class family quietly missing samples skews the
            # SLO signal with no error anywhere
            raise ValueError(
                f"slo_classes ({len(slo_classes)}) must align with "
                f"latencies ({len(latencies)})")
        if slo_classes:
            by_cls: dict = {}
            for s, cls in zip(latencies, slo_classes):
                by_cls.setdefault(cls or "default", []).append(s)
            for cls, vals in by_cls.items():
                self._class_hist(cls).observe_many(vals)
        else:
            self._class_hist("default").observe_many(latencies)
        if stage_seconds:
            for stage, val in stage_seconds.items():
                hist = self.stage_latency[stage]
                if isinstance(val, (list, tuple)):
                    hist.record_many(val)
                else:
                    val = [val] * int(n_requests)
                    hist.record_many(val)
                if stage == "queue":
                    # the control plane's corroboration window (one
                    # bulk observe per batch, same budget discipline
                    # as the families above)
                    self._h_queue_res.observe_many(val)

    # -- SLO / export surfaces ----------------------------------------
    def slo(self, classes=None, windows_s=(60.0, 300.0)) -> dict:
        """Per-class SLO attainment + burn rate over the latency
        family's rolling windows (``utils.telemetry.SloEvaluator``) —
        the admission-control / autoscaling signal. ``classes``
        defaults to the plane's standard interactive/batch pair."""
        from ..utils.telemetry import DEFAULT_SLO_CLASSES

        ev = SloEvaluator(self.registry,
                          classes=classes or DEFAULT_SLO_CLASSES,
                          windows_s=windows_s)
        return ev.evaluate()

    def snapshot(self, engine=None) -> dict:
        with self._lock:
            elapsed = ((self._t_last - self._t_first)
                       if self._t_first is not None
                       and self._t_last is not None
                       and self._t_last > self._t_first else None)
            model_version = self.model_version
            staleness_rounds = self.staleness_rounds
            max_retries = self._max_request_retries
            peak = self._queue_depth_peak
            device_attr = (None if self._device_attr is None
                           else dict(self._device_attr))
            # copied under the lock: record_batch mutates this dict
            # under the same lock, and an unlocked sorted() here could
            # die mid-iteration on a concurrent first-version insert
            by_version = dict(self.requests_by_version)
        requests = self.requests_served
        rows = self.rows_served
        batches = self.batches
        snap = {
            "requests": requests,
            "rows": rows,
            "batches": batches,
            "shed_deadline": self.shed_deadline,
            "shed_overload": self.shed_overload,
            "shed_shutdown": self.shed_shutdown,
            "shed_admission": self.shed_admission,
            # dict() first: submit threads insert first-seen classes
            # concurrently, and sorted() over a live dict could die
            # mid-iteration (the registry makes re-creation idempotent,
            # so the unlocked get-then-set in record_admission_shed is
            # safe; this read just needs a stable view)
            "requests_shed_by_class": {
                cls: int(c.value)
                for cls, c in sorted(dict(self._shed_class).items())},
            "retries": self.retries,
            "requests_retried": self.requests_retried,
            "max_request_retries": max_retries,
            "queue_depth_peak": peak,
            "mean_batch_rows": (
                round(rows / batches, 2) if batches else None),
            "throughput_req_per_s": (
                round(requests / elapsed, 2) if elapsed else None),
            "throughput_rows_per_s": (
                round(rows / elapsed, 2) if elapsed else None),
            # rollout dimensions: live version + how far behind
            # training, swaps absorbed, canary traffic and its
            # fallback/rollback counters, per-version served split
            "model_version": model_version,
            "staleness_rounds": staleness_rounds,
            "weight_swaps": self.weight_swaps,
            "shadow_requests": self.shadow_requests,
            "shadow_probes_dropped": self.shadow_probes_dropped,
            "candidate_errors": self.candidate_errors,
            "rollbacks": self.rollbacks,
            "requests_by_version": {
                str(k): v for k, v in sorted(by_version.items())},
        }
        snap.update(self.latency.percentiles())
        # the reservoir honesty triple: whether
        # the percentiles above are exact order statistics or sampled
        acct = self.latency.accounting()
        snap["latency_seen"] = acct["seen"]
        snap["latency_sampled"] = acct["sampled"]
        snap["reservoir_degraded"] = acct["reservoir_degraded"]
        # per-stage percentile families (queue_p50_ms, pad_p95_ms,
        # device_p99_ms, ...): request-level tracing — a tail
        # regression in the end-to-end percentiles localizes to the
        # stage whose family moved with it
        for stage, hist in self.stage_latency.items():
            snap.update({f"{stage}_{k}": v
                         for k, v in hist.percentiles().items()})
        # the profiler-backed device split (additive): the device stage
        # scaled by the SAMPLED compute fraction — exact for
        # percentiles under constant-fraction scaling, and labeled with
        # its source so a reader can never mistake it for a
        # per-request measurement. Absent (with the reason recorded)
        # on hosts whose profiler yields no device lane (CPU).
        snap["device_attribution"] = device_attr
        if device_attr and device_attr.get("source") == "profiler":
            frac = float(device_attr.get("compute_fraction", 0.0))
            for q, v in self.stage_latency["device"].percentiles().items():
                if v is None:
                    split = {"device_compute": None, "xla_queue": None}
                else:
                    split = {"device_compute": round(v * frac, 4),
                             "xla_queue": round(v * (1.0 - frac), 4)}
                for name, sv in split.items():
                    snap[f"{name}_{q}"] = sv
        if engine is not None:
            snap["compile_count"] = engine.compile_count
            if snap["model_version"] is None:
                # no swap ever recorded: the engine's own live version
                # is the honest default (a single-version service)
                snap["model_version"] = getattr(engine, "version", None)
            stats = getattr(engine, "replica_stats", None)
            if callable(stats):
                # the failover plane (serving/replica.py): per-replica
                # routed/ok/failed/requeued counters + circuit state,
                # plus fleet totals (requeues/hedges/hedge_wins/dead).
                # Pulled at snapshot time like compile_count — the
                # router owns the counters; the snapshot reports them.
                snap["failover"] = stats()
        if self.staleness_of is not None \
                and snap["model_version"] is not None:
            try:
                snap["staleness_rounds"] = int(
                    self.staleness_of(snap["model_version"]))
            except Exception:
                # keep the swap-time value over no value — but COUNT
                # the broken lookup (GL006: a swallowed failure must
                # land in telemetry, or a dead registry hookup reads
                # as a healthy, permanently-current service)
                self.record_staleness_error()
        snap["staleness_errors"] = self.staleness_errors
        return snap
