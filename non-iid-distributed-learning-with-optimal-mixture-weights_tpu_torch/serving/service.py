"""Request loop: a thread + queue front over the batched engine.

A copy of the JAX package's ``serving/service.py`` on this package's
``utils.trace``; the engine behind it is ``serving.engine.ServingEngine``
(or anything with its ``predict``/``buckets``/``pop_timings`` surface).
Deliberately stdlib-only (``threading``/``queue``/``concurrent.futures``
— no server framework; the container adds no runtime deps and a real
deployment would front this with whatever RPC layer it already has).
The loop is the continuous-batching serving shape:

  submit() -> bounded queue -> worker admits everything queued the
  moment the previous dispatch returns (batcher.admit — no linger) ->
  expired requests shed -> one engine dispatch -> per-request futures
  resolved.

Queue admission pipelines with rung dispatch: while one batch occupies
the engine, arrivals accumulate; the instant the rung frees they are
admitted into the next dispatch. Under load batches fill themselves
(the previous dispatch time IS the batching window); at low rates a
request dispatches solo immediately. ``mode="drain"`` selects the
legacy fixed-micro-batch policy (linger up to ``max_wait_ms`` filling
toward the largest rung) — kept as the baseline continuous batching
is measured against. The worker re-reads the engine's ladder per
batch, so atomically-installed rungs (``ServingEngine.install_rung``)
take effect mid-stream, pre-warmed off the hot path.

Overload policy is shed-at-the-door: when the queue holds ``max_queue``
requests, ``submit`` fails IMMEDIATELY with :class:`Overloaded` instead
of queueing work that would only time out later — bounded queue depth is
what keeps p99 bounded under a load spike. Per-request deadlines are
enforced at dequeue: a request that waited past its deadline is resolved
with :class:`DeadlineExceeded` and never spends engine time.

The ``engine`` may also be a failover router over a replica fleet
(``serving.replica.FailoverRouter``): the service detects its
``deadline=`` capability once
and passes each batch's earliest request deadline into dispatch, so a
dead replica's in-flight batch requeues against survivors only while
some caller can still make its deadline; the router's per-dispatch
``replica_id``/``failovers``/``hedged`` dimensions ride the same
``pop_timings`` slot as the stage split and land on every served
request span.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..utils.trace import NULL_TRACER, inject_context
from .batcher import (admit, coalesce, drain, edf_order, partition,
                      request_rows, rung_cut, split_results)
from .control import AdmissionShed
from .metrics import ServeMetrics
from .rollout import assigned_to_candidate


class Overloaded(RuntimeError):
    """Queue at capacity; request shed before enqueue."""


class DeadlineExceeded(TimeoutError):
    """Request expired while queued; never reached the engine."""


class ServiceStopped(RuntimeError):
    """Backlog request dropped by a non-draining shutdown — distinct
    from :class:`DeadlineExceeded` so a caller retrying timeouts with a
    longer deadline does not misread a deliberate stop as one."""


#: Lower-cased substrings marking an engine-dispatch failure as
#: transient (worth a bounded retry): the gRPC/absl status families a
#: remote-attached accelerator surfaces when the tunnel hiccups, plus
#: generic connectivity wording. Deliberately NOT any bare
#: RuntimeError — a programming error must fail fast, every time.
_TRANSIENT_MARKERS = (
    "unavailable", "resource_exhausted", "deadline_exceeded", "aborted",
    "connection", "socket", "unreachable", "temporarily",
)


def _is_transient(exc: BaseException) -> bool:
    """Whether an engine dispatch failure is worth retrying: OS-level
    connectivity errors by type, backend/RPC errors by status wording.
    Shape/validation errors (``ValueError``/``TypeError``) are
    permanent by construction — retrying the same malformed batch can
    only fail the same way, slower."""
    if isinstance(exc, (ValueError, TypeError)):
        return False
    if isinstance(exc, (OSError, ConnectionError)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


def _resolve(fut: Future, result=None, exc=None) -> None:
    """Resolve a request Future, tolerating caller-side cancellation:
    ``set_result``/``set_exception`` on a cancelled Future raise
    ``InvalidStateError``, and letting that escape would kill the
    worker thread and strand every other queued request forever."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    future: Future
    t_submit: float
    deadline: float | None  # absolute perf_counter time, or None
    id: str = ""  # request id assigned at submit; rides the whole path
    retries: int = 0  # transient engine-dispatch retries this request saw
    slo: str = "default"  # SLO class label on the latency family
    deferrals: int = 0  # EDF cycles this request was deferred (aging)


class ServingService:
    """Thread-per-engine serving loop with dynamic micro-batching.

    Use as a context manager (or ``start()``/``stop()``). ``submit``
    is thread-safe and non-blocking: it returns a
    ``concurrent.futures.Future`` resolving to the request's logits.
    """

    #: Batch-formation policies: continuous admission (admit whatever
    #: is queued the moment the previous dispatch returns — the
    #: default) vs the legacy fixed-micro-batch drain (linger up to
    #: ``max_wait_ms`` filling toward the top rung — the measured
    #: baseline of the serve bench's continuous_batching leg).
    MODES = ("continuous", "drain")

    #: EDF aging bound: a request deferred this many scheduling cycles
    #: is exempted to the FRONT of the next batch regardless of its
    #: deadline. Pure EDF would starve deadline-FREE requests under a
    #: sustained deadline'd stream (they sort last forever, and fresh
    #: arrivals leapfrog them every cycle) — aging restores the
    #: pre-EDF bounded-holdover guarantee: every request dispatches
    #: within EDF_MAX_DEFERRALS + 1 cycles of first being admitted.
    EDF_MAX_DEFERRALS = 4

    def __init__(self, engine, max_queue: int = 1024,
                 max_wait_ms: float = 2.0, metrics: ServeMetrics | None = None,
                 retries: int = 2, retry_backoff_ms: float = 5.0,
                 tracer=None, router=None, mode: str = "continuous",
                 rung_aware: bool = False, admission=None,
                 slo_classes=None):
        """``mode``: batch-formation policy (:data:`MODES`). In
        ``"continuous"`` (default) ``max_wait_ms`` is unused — the
        batching window is the previous dispatch itself; ``"drain"``
        keeps the fixed-micro-batch semantics. ``rung_aware``
        (continuous mode only): cut each admitted batch back to a
        ladder rung boundary (``batcher.rung_cut``) when padding past
        it would out-cost deferring the tail one dispatch — worth
        turning on where pad rows cost real device time; on CPU
        hosts per-dispatch overhead dominates and a serve benchmark
        measured the cut net-negative, hence default off.

        ``retries``/``retry_backoff_ms``: bounded exponential-backoff
        retry of TRANSIENT engine-dispatch failures (``_is_transient``;
        a flapping remote-accelerator tunnel) — at most ``retries``
        re-dispatches per batch, backoff doubling from
        ``retry_backoff_ms`` but never sleeping past the earliest live
        deadline in the batch. Permanent errors (bad shapes, real
        bugs) still fail every affected future on the first attempt.
        Retries are counted in ``metrics.snapshot()['retries']``.

        ``tracer`` (``utils.trace.Tracer``): request-level tracing.
        Every submit gets a request id regardless (exposed as the
        returned Future's ``request_id``); with an
        ENABLED tracer each request additionally lands exactly one
        ``"request"`` span on resolution — outcome, queue/pad/device
        stage split, retry count — and the retry/deadline events
        become ``"engine_retry"``/``"deadline_exceeded"`` annotations.
        Default is the shared no-op tracer (zero per-request cost
        beyond the id counter).

        ``router`` (``serving.rollout.RolloutController`` attaches
        itself here): the rollout traffic splitter. When set, the
        worker reads one atomic ``router.split()`` snapshot per
        micro-batch and routes the deterministically-assigned slice to
        the candidate version — dispatched-and-discarded in shadow
        mode, answered-from-candidate (with live fallback on failure)
        in ab mode — reporting outcomes back via ``router.observe``.
        None serves everything from the engine's live version.

        ``admission`` (``serving.control.AdmissionController``):
        class-aware policy shedding at the door. When set, every
        submit first asks ``admission.admit(slo_class)``; a refused
        request never queues — its Future resolves with the typed
        :class:`~serving.control.AdmissionShed` (NOT raised like
        ``Overloaded``: the request was well-formed and accepted far
        enough to earn a request id, a ``shed``-annotated span, and
        the per-class ``serve_requests_shed_total`` counter — the
        surfaces a dashboard needs to tell policy shedding from
        deadline blowouts). None admits everything.

        ``slo_classes``: an iterable
        of ``utils.telemetry.SloClass`` giving the class vocabulary
        its DEADLINES — a ``submit(slo_class="interactive")`` with no
        explicit ``timeout_s`` gets the class's default timeout
        (``SloClass.timeout_s()``), so callers stop hand-picking
        deadlines the vocabulary already implies. An explicit
        ``timeout_s=`` always wins; classes outside the vocabulary
        (including the implicit ``"default"``) keep the deadline-free
        behavior. None (the default) applies no class deadlines."""
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        self.engine = engine
        self.router = router
        self.admission = admission
        self.mode = mode
        self.rung_aware = bool(rung_aware)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.max_queue = int(max_queue)
        self.max_wait = max_wait_ms / 1e3
        self.retries = int(retries)
        self.retry_backoff = retry_backoff_ms / 1e3
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # the per-class deadline vocabulary: resolved once
        # to a plain name->seconds map so submit pays a dict lookup,
        # not an attribute walk
        self._class_timeout = (
            {} if slo_classes is None
            else {c.name: c.timeout_s() for c in slo_classes})
        self._width = engine.input_dim  # computed once, checked per submit
        # capability check once, not per probe: whether the engine's
        # predict supports the out-of-band record_timings=False mode
        # (a TypeError-based fallback at dispatch time would misread a
        # genuine TypeError from inside predict as a missing kwarg),
        # and whether it takes the failover deadline (a FailoverRouter
        # stops requeueing a dead replica's batch once the earliest
        # request deadline passes; a plain engine has no use for it)
        try:
            import inspect

            sig_params = inspect.signature(engine.predict).parameters
            self._predict_untimed = "record_timings" in sig_params
            self._predict_deadline = "deadline" in sig_params
            # whether dispatch can carry a TRACECTX carrier across a
            # process boundary (a FailoverRouter over SocketTransport
            # replicas); a plain engine has no hop to cross
            self._predict_trace = "trace_ctx" in sig_params
        except (TypeError, ValueError):
            self._predict_untimed = False
            self._predict_deadline = False
            self._predict_trace = False
        self._q: queue.Queue[_Request] = queue.Queue()
        # accepted-but-unserved request count, mutated under the lock:
        # a bare qsize()-then-put check is a race (N concurrent submits
        # could all pass it and blow the bound exactly during the load
        # spike it exists for), and Queue(maxsize=...) would make the
        # batcher's drain() put-back block against full-queue pressure
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # off-thread shadow probing: shadow dispatches ride a dedicated
        # daemon thread instead of serializing behind live traffic on
        # the worker. Bounded queue so a slow candidate sheds probes
        # (counted) instead of growing probe backlog without bound.
        self._probe_q: queue.Queue = queue.Queue(maxsize=256)
        self._probe_thread: threading.Thread | None = None

    # -- tracing ------------------------------------------------------
    def _staleness(self, version) -> int:
        """Rounds the given version trails the newest published model
        — from the router's registry when one is attached, else 0 (a
        single-version service is by definition current)."""
        r = self.router
        if r is None or version is None:
            return 0
        try:
            return int(r.staleness_rounds(version))
        except Exception:
            # a router whose registry lookup breaks must not take the
            # request span down with it — but the failure is COUNTED
            # (GL006), not silently read as "current"
            self.metrics.record_staleness_error()
            return 0

    def _trace_request(self, req: _Request, outcome: str, done: float,
                       queue_s=None, pad_s=None, device_s=None,
                       batch_id=None, where=None, version=None,
                       staleness=None, extra=None) -> None:
        """Emit the one ``"request"`` span a submitted request gets at
        resolution — whichever path resolved it (served, deadline,
        error, shutdown), so the exported trace holds every accepted
        request id exactly once. Deadline outcomes additionally land a
        ``"deadline_exceeded"`` annotation naming WHERE the request
        expired (queued / during retries / the post-stop sweep). Every span carries the rollout
        dimensions: ``model_version`` (the version that answered, or
        the live version at resolution for unserved outcomes) and
        ``staleness_rounds`` (how far that version trails the newest
        published model). ``extra``: the failover dimensions a
        FailoverRouter reports per dispatch (``replica_id`` — which
        replica answered; ``failovers`` — how many dead/failed
        replicas this batch requeued past; ``hedged``), merged into
        the span attrs so a requeued request is attributable."""
        if not self.tracer.enabled:
            return
        if version is None:
            version = getattr(self.engine, "version", None)
        if staleness is None:
            # batch callers pass it precomputed (constant across a
            # served group); one-off resolutions look it up here
            staleness = self._staleness(version)
        # lean on purpose (no per-field rounding, attrs dict handed to
        # emit as-is): this runs once per served request, and its cost
        # IS the trace plane's overhead the serve bench measures
        attrs = {"outcome": outcome, "rows": request_rows(req.x),
                 "retries": req.retries, "model_version": version,
                 "staleness_rounds": staleness, "slo_class": req.slo}
        if queue_s is not None:
            attrs["queue_ms"] = queue_s * 1e3
        if pad_s is not None:
            attrs["pad_ms"] = pad_s * 1e3
        if device_s is not None:
            attrs["device_ms"] = device_s * 1e3
        if batch_id is not None:
            attrs["batch"] = batch_id
        if extra:
            attrs.update(extra)
        if outcome == "deadline":
            self.tracer.annotate("deadline_exceeded", req.id,
                                 where=where or "queued")
        elif outcome == "shed":
            # policy shedding is attributable
            # on the trace, distinct from the deadline annotation — a
            # dashboard joining spans can split "we refused it" from
            # "we were too slow for it"
            self.tracer.annotate("shed", req.id, slo_class=req.slo,
                                 policy="admission")
        self.tracer.emit("request", req.id, req.t_submit,
                         done - req.t_submit, attrs=attrs)

    def _engine_stage_split(self, fallback_device_s: float) -> tuple:
        """``(pad_s, device_s, version, extra)`` of the engine call
        that just returned: the engine's own host-timed split when it
        exposes one (``ServingEngine.pop_timings``) — which also names
        the model version that actually answered — else the whole call
        billed to the device stage with the engine's live version
        (honest for a custom engine with no split). ``extra`` is the
        failover dimensions a FailoverRouter stamps into its timing
        slot (replica_id / failovers / hedged); empty for a bare
        engine."""
        pop = getattr(self.engine, "pop_timings", None)
        timing = pop() if pop is not None else None
        if timing:
            extra = {}
            if "replica" in timing:
                extra["replica_id"] = timing["replica"]
                extra["failovers"] = timing.get("failovers", 0)
                if timing.get("hedged"):
                    extra["hedged"] = True
            return (timing["pad_s"], timing["dispatch_s"],
                    timing.get("version"), extra)
        return (0.0, fallback_device_s,
                getattr(self.engine, "version", None), {})

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "ServingService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker,
                                        name="serve-worker", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_queue: bool = True) -> None:
        """Graceful stop: by default the worker finishes everything
        already queued before exiting (accepted work is served);
        ``drain_queue=False`` sheds the backlog with
        :class:`ServiceStopped` instead.

        Setting the stop flag makes ``submit`` refuse new work, so the
        worker's drain terminates; a submit that raced past the flag
        check is caught by the post-join sweep — no Future is ever
        stranded by a shutdown."""
        if self._thread is None:
            return
        if not drain_queue:
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                with self._depth_lock:
                    self._depth -= 1
                self.metrics.record_shed("shutdown")
                self._trace_request(req, "shutdown", time.perf_counter())
                _resolve(req.future,
                         exc=ServiceStopped("service stopping"))
        with self._depth_lock:
            # same lock as submit's check-and-put: see the atomicity
            # comment there
            self._stop.set()
        self._thread.join()
        self._thread = None
        if self._probe_thread is not None:
            # the worker is joined, so no probe can be enqueued after
            # this sentinel: every accepted probe is processed before
            # stop returns (a caller's post-stop snapshot sees the
            # full shadow_requests count, same contract as in-line)
            self._probe_q.put(None)
            self._probe_thread.join()
            self._probe_thread = None
        self._sweep_leftovers(drain_queue)

    def _sweep_leftovers(self, drain_queue: bool) -> None:
        """Resolve requests the worker never saw — a ``submit`` that
        passed the liveness check concurrently with ``stop`` lands its
        request after the worker exited; served (or shed) here, its
        Future resolves instead of hanging a caller forever."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            with self._depth_lock:
                self._depth -= 1
            t_seen = time.perf_counter()
            expired = (req.deadline is not None and t_seen > req.deadline)
            if expired:
                # the sweep honors deadlines exactly like the worker's
                # dequeue check — a stop() race must not turn an
                # already-expired request into a late success
                self.metrics.record_shed("deadline", slo_class=req.slo)
                self._trace_request(req, "deadline", t_seen,
                                    queue_s=t_seen - req.t_submit,
                                    where="sweep")
                _resolve(req.future,
                         exc=DeadlineExceeded("expired while queued"))
                continue
            if not drain_queue:
                self.metrics.record_shed("shutdown")
                self._trace_request(req, "shutdown", t_seen,
                                    queue_s=t_seen - req.t_submit)
                _resolve(req.future,
                         exc=ServiceStopped("service stopped"))
                continue
            try:
                out = self.engine.predict(req.x)
            except Exception as e:
                self._trace_request(req, "error", time.perf_counter(),
                                    queue_s=t_seen - req.t_submit)
                _resolve(req.future, exc=e)
                continue
            done = time.perf_counter()
            queue_s = t_seen - req.t_submit
            pad_s, device_s, ver, rext = self._engine_stage_split(
                done - t_seen)
            # same accounting as the worker path: served is served,
            # whichever thread resolved it — and metrics before the
            # future, so a caller's post-result snapshot counts it
            self.metrics.record_batch(
                n_requests=1, n_rows=request_rows(req.x),
                latencies=[done - req.t_submit], now=done,
                stage_seconds={"queue": [queue_s], "pad": pad_s,
                               "device": device_s},
                request_retries=[req.retries], version=ver,
                slo_classes=[req.slo],
                rows_per_request=[request_rows(req.x)])
            self._trace_request(req, "ok", done, queue_s=queue_s,
                                pad_s=pad_s, device_s=device_s,
                                version=ver, extra=rext)
            _resolve(req.future, result=out)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request side -------------------------------------------------
    def submit(self, x, timeout_s: float | None = None,
               slo_class: str | None = None) -> Future:
        """Enqueue one request; sheds immediately when over capacity.

        ``slo_class`` labels the request on the metrics plane's
        per-class latency family (``serve_request_latency_seconds
        {class=...}``) — the SLO attainment/burn-rate input
        (``ServeMetrics.slo()``) — and DRIVES the
        control plane: with an ``admission`` controller attached the
        class decides whether this request is policy-shed (the
        returned Future then resolves with ``AdmissionShed``), and
        the class's typical deadline shapes the worker's EDF dispatch
        order under pressure."""
        if self._thread is None:
            raise RuntimeError("service not started")
        x = np.asarray(x, dtype=np.float32)
        if (x.ndim not in (1, 2) or x.shape[-1] != self._width
                or x.shape[0] == 0):
            # reject malformed payloads HERE, in the caller's thread —
            # queued, they could only fail inside the worker, where a
            # width mismatch would poison the whole coalesced batch
            # (failing OTHER callers' valid requests alongside), and a
            # zero-row batch would succeed or fail depending on what
            # it happened to be coalesced with
            raise ValueError(
                f"request must be a ({self._width},) row or a non-empty "
                f"(n, {self._width}) batch, got shape {x.shape}")
        if timeout_s is None:
            # the class vocabulary's deadline: implied by
            # slo_class, never overriding an explicit timeout_s, and
            # absent entirely for classes outside the vocabulary
            timeout_s = self._class_timeout.get(slo_class or "default")
        now = time.perf_counter()
        fut: Future = Future()
        req = _Request(
            x=x, future=fut, t_submit=now,
            deadline=None if timeout_s is None else now + timeout_s,
            id=self.tracer.new_id("req"),
            slo=slo_class or "default")
        # the id is caller-visible: a client logging fut.request_id can
        # join its own records against the exported trace
        fut.request_id = req.id
        if self.admission is not None \
                and not self.admission.admit(req.slo):
            # policy shed BEFORE the queue: the controller
            # decided this class sheds under the current burn rate,
            # so the request must not spend queue residency only to
            # blow a deadline later. Resolved, not raised — the typed
            # AdmissionShed rides the Future like every other outcome,
            # with its span and per-class counter (see __init__)
            self.metrics.record_admission_shed(req.slo)
            self._trace_request(req, "shed", time.perf_counter())
            _resolve(fut, exc=AdmissionShed(
                f"{req.slo!r} request shed by admission control "
                "(error-budget burn over threshold; lower classes "
                "shed first) — back off or degrade"))
            return fut
        with self._depth_lock:
            # stop-check and enqueue are ATOMIC under the lock: stop()
            # flips the flag under the same lock, so a put either
            # happens-before the flag (the worker/post-join sweep will
            # see it) or the submit observes the flag and refuses —
            # there is no window for a request to land after the sweep
            if self._stop.is_set():
                # typed so failover logic can tell a deliberate stop
                # from an unexpected server error (ServiceStopped IS a
                # RuntimeError, so broad handlers still work)
                raise ServiceStopped("service stopping")
            depth = self._depth
            if depth >= self.max_queue:
                shed = True
            else:
                shed = False
                self._depth += 1
                depth = self._depth
                # the queue is UNBOUNDED (depth is bounded here, by _depth) so put
                # never blocks; stop-check+enqueue must stay one atomic region
                self._q.put(req)
        if shed:
            # class-attributed: a refused interactive request must
            # reach the shed-rate signal, or the control plane reads
            # a door-rejecting service as healthy survivors
            self.metrics.record_shed("overload", slo_class=req.slo)
            raise Overloaded(
                f"queue depth {depth} at capacity "
                f"(max_queue={self.max_queue})")
        self.metrics.observe_queue_depth(depth)
        return fut

    def predict(self, x, timeout_s: float | None = None):
        """Blocking convenience: submit and wait."""
        return self.submit(x, timeout_s=timeout_s).result()

    # -- worker side --------------------------------------------------
    def _worker(self) -> None:
        carry: list = []  # requests dequeued but not yet dispatched:
        # the over-budget holdover plus (continuous mode) the
        # rung-cut's deferred tail. Carried requests seed the NEXT
        # batch ahead of fresh arrivals; under pressure the EDF sort
        # may then push a later-deadline carried request behind
        # sooner-deadline fresh traffic, so the pre-EDF "strictly
        # frontward" bound no longer holds per cycle — the aging
        # exemption (EDF_MAX_DEFERRALS) restores a hard bound: every
        # request dispatches within EDF_MAX_DEFERRALS + 1 cycles of
        # first being admitted, deadline or not
        while True:
            if not carry:
                try:
                    carry = [self._q.get(timeout=0.02)]
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
            # re-read the ladder top EVERY batch: install_rung/
            # retire_rung swap the rung tuple atomically at runtime
            # (the learned-ladder plane), and a latched max would cap
            # admission at a stale ladder forever
            ladder = self.engine.buckets
            max_rows = ladder[-1]
            if self.mode == "continuous" or self._stop.is_set():
                # continuous batching: admit what is queued NOW — the
                # previous dispatch was the batching window, nothing
                # lingers (also the shutdown drain: stop must not
                # wait). With rung_aware set, the batch is then cut
                # back to a rung boundary when padding past it would
                # out-cost the deferral (a DEVICE-bound policy: on
                # CPU hosts per-dispatch overhead dominates pad rows
                # and the JAX package's serve bench measured the cut
                # net-negative,
                # so it is opt-in, for backends where pad rows cost
                # real device time)
                # admission budget is TWO rungs, not one: the extra
                # rung is the EDF lookahead window — at exactly one
                # rung, a batch that fills to the brim would hide the
                # soonest-deadline request sitting just behind it in
                # the queue, and "deadline scheduling" would degrade
                # to FIFO precisely under the pressure it exists for.
                # The overflow seeds the next batch via the carry (the
                # same bounded holdover contract as before; depth
                # accounting is per DISPATCHED request, unchanged).
                batch, held = admit(self._q, carry, 2 * max_rows)
                rows_list = [request_rows(r.x) for r in batch]
                if held is not None or sum(rows_list) > max_rows:
                    # PRESSURE: more admitted than one dispatch can
                    # take, so somebody defers — deadline scheduling
                    #: soonest-deadline-first, so the
                    # deferred tail is the most-patient traffic, not
                    # whoever arrived last. Stable FIFO among equal /
                    # absent deadlines, so the clean-load path is
                    # byte-identical to the pre-EDF worker. AGED
                    # requests (deferred EDF_MAX_DEFERRALS times) jump
                    # the sort entirely: EDF alone would starve a
                    # deadline-free request behind a sustained
                    # deadline'd stream forever.
                    batch = edf_order(batch)
                    aged = [r for r in batch
                            if r.deferrals >= self.EDF_MAX_DEFERRALS]
                    if aged:
                        batch = aged + [
                            r for r in batch
                            if r.deferrals < self.EDF_MAX_DEFERRALS]
                    rows_list = [request_rows(r.x) for r in batch]
                # hard-cap the batch at the rung budget: a carried
                # seed can EXCEED it when a rung-cut tail stacks with
                # a holdover, and dispatching past the top rung would
                # make the engine chunk the coalesced batch — splitting
                # a request across dispatches, the exact thing the
                # holdover contract forbids. The head request always
                # dispatches (oversized singles are the engine's
                # documented chunking case).
                cap, rows = 1, rows_list[0]
                while cap < len(batch) and \
                        rows + rows_list[cap] <= max_rows:
                    rows += rows_list[cap]
                    cap += 1
                carry = batch[cap:]
                batch = batch[:cap]
                if self.rung_aware:
                    cut = rung_cut(rows_list[:cap], ladder)
                    carry = batch[cut:] + carry
                    batch = batch[:cut]
            else:
                batch, held = drain(self._q, carry[0], max_rows,
                                    max_wait=self.max_wait)
                carry = []
            if held is not None:
                carry.append(held)
            for r in carry:
                # the EDF aging clock: one tick per cycle a request
                # sits deferred (no-op in drain mode — its carry is
                # only ever the single holdover, served next cycle)
                r.deferrals += 1
            with self._depth_lock:
                # these requests left the queue for good (the holdover
                # stays accounted until its own batch serves it)
                self._depth -= len(batch)
            now = time.perf_counter()
            live = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    # the class rides onto the deadline-miss counter
                    # the SLO evaluator folds in as SLO-bad: under
                    # overload the shed requests ARE the signal
                    self.metrics.record_shed("deadline",
                                             slo_class=req.slo)
                    self._trace_request(req, "deadline", now,
                                        queue_s=now - req.t_submit,
                                        where="queued")
                    _resolve(req.future, exc=DeadlineExceeded(
                        f"queued {now - req.t_submit:.4f}s, past the "
                        "request deadline"))
                else:
                    live.append(req)
            if not live:
                continue
            self._serve_batch(live)

    def _serve_batch(self, live) -> None:
        """One micro-batch through the engine. With no router, the
        whole batch is one live-version group. With an active rollout
        split, the batch partitions INSIDE the micro-batcher by the
        deterministic per-request-id hash (``rollout.
        assigned_to_candidate``): shadow mode serves everyone from the
        live version and then mirrors the assigned slice to the
        candidate (results discarded, prediction agreement reported);
        ab mode answers the assigned slice FROM the candidate, falling
        back to the live version if the candidate dispatch fails. The
        split snapshot is read once per batch — promotion/rollback
        between batches is therefore atomic with respect to dispatch,
        and a ``version=None`` (live) dispatch re-resolves inside the
        engine on every attempt, so retries can never run against a
        half-swapped engine. Stage attribution happens per GROUP (each
        group stamps its own start): under an ab split, the candidate
        group's wait behind the live group's dispatch is queue
        residency, not pad time."""
        bid = self.tracer.new_id("batch") if self.tracer.enabled else None
        router = self.router
        split = router.split() if router is not None else None
        if split is None:
            self._serve_group(live, None, bid)
            return
        cand_ver, fraction, mode = split
        if mode == "shadow":
            # probe over the requests ACTUALLY served (a mid-retry
            # deadline trim may have shed some), paired with their
            # live outputs — alignment by construction
            pairs = self._serve_group(live, None, bid)
            probe = [(r, o) for r, o in pairs or []
                     if assigned_to_candidate(r.id, fraction)]
            if probe:
                if self._predict_untimed:
                    # off-thread warm dispatch:
                    # the probe's callers were ALREADY answered from
                    # the live outputs, so nothing user-visible waits
                    # on it — hand it to the probe thread instead of
                    # serializing candidate dispatch behind the next
                    # live batch. Requires the out-of-band dispatch
                    # mode (record_timings=False): without it the
                    # probe's pop-and-discard would race this thread's
                    # own timing slot, so such engines keep the
                    # in-line probe.
                    self._ensure_probe_thread()
                    try:
                        self._probe_q.put_nowait(
                            (probe, cand_ver, router, bid))
                    except queue.Full:
                        # shed, never block the worker: counted so an
                        # under-observed candidate is visible
                        self.metrics.record_probe_dropped(len(probe))
                else:
                    self._shadow_probe(probe, cand_ver, router, bid)
            return
        assigned, rest = partition(
            live, lambda r: assigned_to_candidate(r.id, fraction))
        if rest:
            self._serve_group(rest, None, bid)
        if assigned:
            self._serve_group(assigned, cand_ver, bid, router=router)

    def _ensure_probe_thread(self) -> None:
        """Start the shadow-probe thread on first use. Called only
        from the worker thread, so creation cannot race itself."""
        if self._probe_thread is None:
            self._probe_thread = threading.Thread(
                target=self._probe_worker, name="serve-shadow-probe",
                daemon=True)
            self._probe_thread.start()

    def _probe_worker(self) -> None:
        """Drain the probe queue until the shutdown sentinel (None).
        Probes dispatch out-of-band (``record_timings=False``), so
        nothing here can bill timing or version into the serving
        worker's slot — the property that made this safe to move off
        the worker thread."""
        while True:
            item = self._probe_q.get()
            if item is None:
                return
            probe, cand_ver, router, bid = item
            try:
                self._shadow_probe(probe, cand_ver, router, bid)
            except Exception:
                # a probe failure must never kill the probe thread
                # (every later candidate would silently go
                # unobserved); count it into the candidate budget —
                # the same signal a failed in-line probe feeds
                self.metrics.record_candidate_error(len(probe))

    def _shadow_probe(self, probe, cand_ver, router, bid) -> None:
        """Dark-launch dispatch: the assigned ``(request, live_out)``
        pairs' payloads run through the candidate version AFTER their
        callers were already answered from the live outputs —
        user-invisible by construction. Reports dispatch
        success/failure and row-level argmax agreement (candidate vs
        live) to the controller; the probe dispatches out-of-band
        (``record_timings=False``) so its timing and version can
        never be billed to a real batch — also what keeps this safe
        to move off the worker thread later."""
        try:
            X, spans = coalesce([r.x for r, _ in probe])
            if self._predict_untimed:
                raw = self.engine.predict(X, version=cand_ver,
                                          record_timings=False)
            else:
                # a custom engine without the kwarg: dispatch anyway
                # and discard whatever timing slot it may have set
                raw = self.engine.predict(X, version=cand_ver)
                pop = getattr(self.engine, "pop_timings", None)
                if pop is not None:
                    pop()
            couts = split_results(raw, spans)
        except Exception as e:
            self.metrics.record_candidate_error(len(probe))
            if bid is not None:
                self.tracer.annotate(
                    "shadow_error", bid, version=cand_ver,
                    error=type(e).__name__, n_requests=len(probe))
            router.observe(cand_ver, errors=len(probe))
            return
        hits = rows = 0
        for (_, live_out), c in zip(probe, couts):
            a = np.argmax(np.atleast_2d(live_out), -1)
            b = np.argmax(np.atleast_2d(c), -1)
            hits += int(np.sum(a == b))
            rows += int(a.size)
        self.metrics.record_shadow(len(probe))
        router.observe(cand_ver, served=len(probe),
                       agreement=(hits, rows))

    def _serve_group(self, live, version, bid, router=None):
        """One request group through one engine dispatch, with
        bounded-backoff retry of transient failures; every future in
        ``live`` is resolved here (result, deadline, or error) —
        nothing can strand, whichever way the engine fails.
        ``version=None`` serves the engine's live version (re-resolved
        at every dispatch attempt); a candidate ``version`` gets ONE
        attempt and falls back to the live version on any failure,
        reporting the error to ``router`` — a broken canary degrades
        to the old model, never to a caller-visible error. Returns the
        served ``(request, output)`` pairs (deadline-trimmed requests
        excluded) on success, None otherwise. The group's own start
        time closes each request's queue-wait stage; the engine
        call's pad/device split and the retry count complete the
        per-request stage attribution."""
        # the GROUP's own start, not the batch formation time: under
        # an ab split the candidate group runs after the live group's
        # whole dispatch, and billing that gap to the pad stage would
        # misread an ordinary canary as a host-stacking regression —
        # it is queue residency, and lands there below
        t_formed = time.perf_counter()
        try:
            # coalesce INSIDE the guard: mixed feature widths in
            # one micro-batch raise here, and an escape would kill
            # the worker thread and strand every queued future
            X, spans = coalesce([r.x for r in live])
        except Exception as e:  # batch failure -> every caller told
            for req in live:
                self._trace_request(req, "error", time.perf_counter(),
                                    queue_s=t_formed - req.t_submit,
                                    batch_id=bid)
                _resolve(req.future, exc=e)
            return None
        coalesce_s = time.perf_counter() - t_formed
        attempt = 0
        use_version = version
        while True:
            try:
                t_d0 = time.perf_counter()
                kw = {}
                if use_version is not None:
                    kw["version"] = use_version
                if self._predict_trace and bid is not None:
                    # the cross-process trace carrier: the
                    # batch id is the trace a remote worker's
                    # pod_dispatch span joins — request spans keep
                    # landing exactly once, router-side, with batch=
                    # as the join key
                    kw["trace_ctx"] = inject_context(bid)
                if self._predict_deadline:
                    # the batch's earliest live deadline bounds the
                    # router's failover walk: a dead replica's batch
                    # requeues against survivors only while some
                    # caller can still be answered in time (recomputed
                    # per attempt — the deadline trim below shrinks
                    # `live`)
                    dls = [r.deadline for r in live
                           if r.deadline is not None]
                    if dls:
                        kw["deadline"] = min(dls)
                raw = self.engine.predict(X, **kw)
                predict_s = time.perf_counter() - t_d0
                outs = split_results(raw, spans)
                break
            except Exception as e:
                if use_version is not None:
                    # candidate dispatch failed (retired mid-flight, a
                    # broken weight set, a flapping backend — any
                    # cause): fall back to the LIVE version for these
                    # callers and report the error to the controller's
                    # budget. No retry budget consumed — the live
                    # dispatch below keeps the full transient policy.
                    self.metrics.record_candidate_error(len(live))
                    if bid is not None:
                        self.tracer.annotate(
                            "candidate_fallback", bid,
                            version=use_version,
                            error=type(e).__name__,
                            n_requests=len(live))
                    if router is not None:
                        router.observe(use_version, errors=len(live))
                    use_version = None
                    continue
                if not _is_transient(e) or attempt >= self.retries:
                    # permanent (or out of budget): fail fast, every
                    # caller told — same contract as before retries
                    done = time.perf_counter()
                    for req in live:
                        self._trace_request(
                            req, "error", done,
                            queue_s=t_formed - req.t_submit,
                            batch_id=bid)
                        _resolve(req.future, exc=e)
                    return None
                attempt += 1
                self.metrics.record_retry()
                for req in live:
                    req.retries += 1
                if bid is not None:
                    # the transient-retry event, attributable:
                    # which batch, which attempt, what the engine threw
                    self.tracer.annotate(
                        "engine_retry", bid, attempt=attempt,
                        error=type(e).__name__, n_requests=len(live))
                delay = self.retry_backoff * (2 ** (attempt - 1))
                now = time.perf_counter()
                budgets = [r.deadline - now for r in live
                           if r.deadline is not None]
                if budgets:
                    # deadline-respecting: sleep at most HALF the
                    # earliest remaining budget — sleeping the full
                    # backoff (or exactly up to the deadline) would
                    # guarantee the tightest-deadline request expires
                    # without its retry ever being attempted, while
                    # half-the-budget always leaves room for one more
                    # dispatch and still paces (no busy spin)
                    delay = min(delay, max(0.0, min(budgets) / 2))
                if delay:
                    time.sleep(delay)
                now = time.perf_counter()
                # partition by predicate, NOT by `in`-membership: the
                # dataclass __eq__ would compare the numpy payloads
                expired = [r for r in live
                           if r.deadline is not None and now > r.deadline]
                if expired:
                    for req in expired:
                        self.metrics.record_shed("deadline",
                                                 slo_class=req.slo)
                        self._trace_request(
                            req, "deadline", now,
                            queue_s=t_formed - req.t_submit,
                            batch_id=bid, where="during_retries")
                        _resolve(req.future, exc=DeadlineExceeded(
                            "expired during engine-dispatch retries"))
                    live = [r for r in live
                            if r.deadline is None or now <= r.deadline]
                    if not live:
                        return None
                    # already coalesced once above, so this re-coalesce
                    # of a subset cannot raise
                    X, spans = coalesce([r.x for r in live])
        done = time.perf_counter()
        pad_s, device_s, served_ver, rext = self._engine_stage_split(
            predict_s)
        pad_s += coalesce_s  # host-side stacking is part of the stage
        queue_waits = [t_formed - r.t_submit for r in live]
        if use_version is not None and router is not None:
            # candidate answered these callers; feed the controller's
            # promotion counter (errors were reported in the loop)
            router.observe(use_version, served=len(live))
        # metrics BEFORE resolving futures: a caller that waits on
        # its future and then snapshots must see this batch counted
        rows_each = [request_rows(r.x) for r in live]
        self.metrics.record_batch(
            n_requests=len(live),
            n_rows=sum(rows_each),
            latencies=[done - r.t_submit for r in live],
            now=done,
            stage_seconds={"queue": queue_waits, "pad": pad_s,
                           "device": device_s},
            request_retries=[r.retries for r in live],
            version=served_ver,
            slo_classes=[r.slo for r in live],
            rows_per_request=rows_each)
        stale = (self._staleness(served_ver) if self.tracer.enabled
                 else 0)  # constant across the group: look up once
        for req, q_s in zip(live, queue_waits):
            self._trace_request(req, "ok", done, queue_s=q_s,
                                pad_s=pad_s, device_s=device_s,
                                batch_id=bid, version=served_ver,
                                staleness=stale, extra=rext)
        for req, out in zip(live, outs):
            _resolve(req.future, result=out)
        return list(zip(live, outs))
