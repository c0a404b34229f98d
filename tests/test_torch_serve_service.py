"""The serving host planes of the port on its engine, on the CPU: the
batcher, the service loop and the overload control plane.

``fedamw_tpu_torch.serving``'s ``batcher``, ``service``, ``metrics`` and
``control`` are copies of the JAX package's, so the behaviour its tests
pin (``tests/test_serving.py:268-638`` and ``tests/test_control.py``) is
held here on the port's modules with the port's ``ServingEngine`` behind
them, on the CPU: every future resolved with its own logits, deadline
and queue-overflow sheds, stop/drain semantics, engine errors and the
transient-retry budget, the burn-rate admission controller and its
hysteresis, class-aware shedding with typed outcomes, the autoscaler's
up/down machine over a replica fleet, deadline-ordered dispatch under
pressure and the SLO classes' default deadlines. The autoscaler drives
``Fleet`` below, the router surface it needs (the JAX package's replica
router is not carried). Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest

from fedamw_tpu_torch.serving import (AdmissionController, AdmissionShed,
                                      Autoscaler, DeadlineExceeded,
                                      MicroBatcher, Overloaded,
                                      ServeMetrics, ServiceStopped,
                                      ServingEngine as _ServingEngine,
                                      ServingService, admission_shed_rate,
                                      coalesce, edf_order, split_results)
from fedamw_tpu_torch.serving.metrics import (QUEUE_RESIDENCY_METRIC,
                                              SHED_CLASS_METRIC)
from fedamw_tpu_torch.utils.telemetry import (Registry, SloClass,
                                              SloEvaluator)
from fedamw_tpu_torch.utils.trace import Tracer
from torch_threads import one_torch_thread  # noqa: F401


class ServingEngine(_ServingEngine):
    """The port's engine on the CPU."""

    def __init__(self, *a, device=None, **kw):
        super().__init__(*a, device=device or "cpu", **kw)


class Replica:
    """One member of a ``Fleet``."""

    def __init__(self, replica_id, engine):
        self.replica_id = int(replica_id)
        self.engine = engine


class Fleet:
    """The router surface ``Autoscaler`` drives: ``fleet_size``,
    ``replicas``, ``add_replica`` (a duplicate id refused) and
    ``remove_replica`` (``KeyError`` for an absent id)."""

    def __init__(self, engine, n):
        self.engine = engine
        self.replicas = [Replica(i, engine) for i in range(n)]

    def fleet_size(self):
        return len(self.replicas)

    def add_replica(self, rep):
        if any(r.replica_id == rep.replica_id for r in self.replicas):
            raise ValueError(f"replica {rep.replica_id} exists")
        self.replicas.append(rep)
        return rep.replica_id

    def remove_replica(self, rid):
        if all(r.replica_id != rid for r in self.replicas):
            raise KeyError(rid)
        self.replicas = [r for r in self.replicas if r.replica_id != rid]

D, C = 16, 3

# The logits of a request served inside a coalesced batch (another rung,
# another position) go through another CPU product kernel than the same
# rows served alone (the BLAS blocks by the row count), so the last bit
# of a sum may change: held at this tolerance, with the argmax equal.
# At one rung and one position they are bitwise
# (tests/test_torch_serve_engine.py).
ROWS = dict(rtol=1e-5, atol=1e-6)


def assert_logits(got, want):
    np.testing.assert_allclose(got, want, **ROWS)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def test_coalesce_split_roundtrip():
    rng = np.random.RandomState(4)
    payloads = [rng.randn(16).astype(np.float32),
                rng.randn(3, 16).astype(np.float32),
                rng.randn(1, 16).astype(np.float32)]
    X, spans = coalesce(payloads)
    assert X.shape == (5, 16)
    outs = split_results(X, spans)  # identity engine
    np.testing.assert_array_equal(outs[0], payloads[0])  # 1-D restored
    np.testing.assert_array_equal(outs[1], payloads[1])
    assert outs[2].shape == (1, 16)


def test_micro_batcher_routes_results():
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(3, 16).astype(np.float32)}
    engine = ServingEngine(params, buckets=(8, 64))
    payloads = [rng.randn(k, 16).astype(np.float32) for k in (2, 5, 1)]
    outs = MicroBatcher(engine).run(payloads)
    for x, o in zip(payloads, outs):
        assert_logits(o, engine.predict(x))
    assert MicroBatcher(engine).run([]) == []


def test_drain_never_splits_a_request_and_hands_back_holdover():
    import queue as queue_mod

    from fedamw_tpu_torch.serving import drain

    q = queue_mod.Queue()
    for k in (4, 3):
        q.put(np.zeros((k, 8), np.float32))
    batch, held = drain(q, np.zeros((2, 8), np.float32), max_rows=8,
                        max_wait=0.0)
    # 2 + 4 fit; the 3-row request would exceed 8 -> handed back as the
    # next batch's seed (NOT re-queued at the tail, where a sustained
    # stream of fresh arrivals could starve it past its deadline)
    assert [b.shape[0] for b in batch] == [2, 4]
    assert held is not None and held.shape[0] == 3
    assert q.qsize() == 0
    # exact-fit and timeout drains have no holdover
    batch, held = drain(q, np.zeros((8, 8), np.float32), max_rows=8,
                        max_wait=0.0)
    assert [b.shape[0] for b in batch] == [8] and held is None


def _engine(seed=6, d=16, C=3, buckets=(8, 64)):
    rng = np.random.RandomState(seed)
    return ServingEngine({"w": rng.randn(C, d).astype(np.float32)},
                         buckets=buckets)


def test_service_resolves_each_future_with_its_own_logits():
    engine = _engine()
    rng = np.random.RandomState(7)
    payloads = [rng.randn(k, 16).astype(np.float32)
                for k in (1, 4, 2, 8, 3)]
    with ServingService(engine, max_wait_ms=1.0) as svc:
        futs = [svc.submit(x) for x in payloads]
        for x, f in zip(payloads, futs):
            assert_logits(f.result(timeout=30),
                                          engine.predict(x))
        assert svc.metrics.requests_served == len(payloads)
        assert svc.metrics.latency.count == len(payloads)


def test_service_sheds_expired_deadline():
    engine = _engine()
    svc = ServingService(engine, max_wait_ms=1.0)
    # submit BEFORE start: the request sits queued past its deadline,
    # deterministically (no race against a live worker)
    svc._thread = object()  # satisfy the started check for submit
    fut = svc.submit(np.zeros((2, 16), np.float32), timeout_s=0.0)
    time.sleep(0.01)
    svc._thread = None
    with svc:
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
    assert svc.metrics.shed_deadline == 1


def test_service_sheds_on_queue_overflow():
    engine = _engine()
    svc = ServingService(engine, max_queue=2)
    svc._thread = object()  # queue fills while no worker drains
    svc.submit(np.zeros((1, 16), np.float32))
    svc.submit(np.zeros((1, 16), np.float32))
    with pytest.raises(Overloaded):
        svc.submit(np.zeros((1, 16), np.float32))
    assert svc.metrics.shed_overload == 1
    assert svc.metrics.queue_depth_peak >= 2
    svc._thread = None
    with svc:  # the two accepted requests still drain gracefully
        pass
    assert svc.metrics.requests_served == 2


def test_service_stop_without_drain_sheds_backlog():
    engine = _engine()
    svc = ServingService(engine)
    svc._thread = object()
    fut = svc.submit(np.zeros((1, 16), np.float32))
    svc._thread = None
    svc.start()
    svc.stop(drain_queue=False)
    # the backlog future is resolved either way (served if the worker
    # got to it first, shed otherwise) — never left hanging
    assert fut.done()


def test_service_propagates_engine_errors_and_worker_survives():
    """An engine-side failure resolves every future in the batch with
    the error and leaves the worker alive for later traffic — never a
    silently dead thread with stranded futures."""
    engine = _engine()
    real_predict = engine.predict
    state = {"failed": False}

    def flaky(X):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("transient engine failure")
        return real_predict(X)

    engine.predict = flaky
    svc = ServingService(engine, max_wait_ms=20.0)
    # queue both before the worker starts so they land in ONE batch
    svc._thread = object()
    f1 = svc.submit(np.zeros((2, 16), np.float32))
    f2 = svc.submit(np.zeros((3, 16), np.float32))
    svc._thread = None
    with svc:
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="transient"):
                f.result(timeout=30)
        ok = svc.submit(np.zeros((2, 16), np.float32))
        assert_logits(
            ok.result(timeout=30),
            real_predict(np.zeros((2, 16), np.float32)))


def test_submit_requires_started_service():
    with pytest.raises(RuntimeError, match="not started"):
        ServingService(_engine()).submit(np.zeros((1, 16), np.float32))


def test_cancelled_future_does_not_kill_the_worker():
    """A caller cancelling its pending Future must not crash the
    worker on resolution (set_result on a cancelled Future raises
    InvalidStateError) — the rest of the batch and all later traffic
    keep being served (code-review finding, reproduced live)."""
    engine = _engine()
    svc = ServingService(engine, max_wait_ms=20.0)
    svc._thread = object()  # queue before start: same batch, no races
    f1 = svc.submit(np.zeros((2, 16), np.float32))
    f2 = svc.submit(np.ones((2, 16), np.float32))
    assert f1.cancel()
    svc._thread = None
    with svc:
        assert_logits(
            f2.result(timeout=30),
            engine.predict(np.ones((2, 16), np.float32)))
        later = svc.submit(np.ones((3, 16), np.float32))
        assert later.result(timeout=30).shape == (3, 3)


def test_submit_refused_once_stopping():
    """Refusing new work after stop() begins is what guarantees the
    worker's final drain terminates under sustained submit load."""
    with ServingService(_engine()) as svc:
        svc._stop.set()
        with pytest.raises(ServiceStopped, match="stopping"):
            svc.submit(np.zeros((1, 16), np.float32))
        svc._stop.clear()


def test_stop_sweep_resolves_requests_the_worker_never_saw():
    """A submit racing stop() can land its request after the worker
    exits; the post-join sweep must resolve that Future (served on a
    graceful stop, shed on drain_queue=False) instead of stranding the
    caller forever and leaking a depth slot (code-review finding)."""
    from concurrent.futures import Future

    from fedamw_tpu_torch.serving.service import _Request

    for drain_queue, check in ((True, "served"), (False, "shed")):
        engine = _engine()
        svc = ServingService(engine)
        fut: Future = Future()
        x = np.ones((2, 16), np.float32)
        # simulate the race: the request lands post-join, as if submit
        # passed the liveness check concurrently with stop()
        svc._q.put(_Request(x=x, future=fut, t_submit=0.0, deadline=None))
        with svc._depth_lock:
            svc._depth += 1
        svc._sweep_leftovers(drain_queue)
        if check == "served":
            assert_logits(fut.result(timeout=5),
                                          engine.predict(x))
            # sweep-served requests count in metrics like worker-served
            assert svc.metrics.requests_served == 1
            assert svc.metrics.latency.count == 1
        else:
            # shutdown shed is NOT a deadline violation: distinct
            # exception and counter, so operators and retry logic can
            # tell a deliberate stop from a timeout
            with pytest.raises(ServiceStopped):
                fut.result(timeout=5)
            assert svc.metrics.shed_shutdown == 1
            assert svc.metrics.shed_deadline == 0
        assert svc._depth == 0  # the capacity slot was reclaimed

    # an already-expired leftover is shed, not served late — the sweep
    # honors deadlines exactly like the worker's dequeue check
    engine = _engine()
    svc = ServingService(engine)
    fut = Future()
    svc._q.put(_Request(x=np.ones((2, 16), np.float32), future=fut,
                        t_submit=0.0, deadline=0.0))
    with svc._depth_lock:
        svc._depth += 1
    svc._sweep_leftovers(True)
    with pytest.raises(DeadlineExceeded, match="expired"):
        fut.result(timeout=5)
    assert svc.metrics.shed_deadline == 1 and svc._depth == 0


def test_submit_rejects_malformed_payload_synchronously():
    """A 0-d/3-d or wrong-width payload must fail in the CALLER's
    thread: queued, it would poison the coalesced batch and fail OTHER
    callers' valid requests alongside (code-review finding)."""
    with ServingService(_engine()) as svc:
        for bad in (1.0, np.zeros((2, 3, 4), np.float32),
                    np.zeros((2, 7), np.float32),   # width != 16
                    np.zeros((0, 16), np.float32),  # zero rows
                    np.zeros(7, np.float32)):
            with pytest.raises(ValueError, match="request must be"):
                svc.submit(bad)
        assert svc.metrics.shed_overload == 0  # rejected, not shed


def test_overload_bound_is_atomic_under_concurrent_submits():
    """The max_queue bound must hold under a concurrent submit storm
    (the depth check is a locked counter, not a qsize()-then-put
    race): accepted requests never exceed max_queue before the worker
    starts draining."""
    import threading as th

    engine = _engine()
    svc = ServingService(engine, max_queue=8)
    svc._thread = object()  # no worker: the bound alone limits depth
    accepted, errs = [], []

    def storm():
        try:
            accepted.append(svc.submit(np.zeros((1, 16), np.float32)))
        except Overloaded:
            errs.append(1)

    threads = [th.Thread(target=storm) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(accepted) == 8 and len(errs) == 24
    assert svc.metrics.shed_overload == 24
    svc._thread = None
    with svc:  # accepted backlog drains gracefully
        for f in accepted:
            f.result(timeout=30)
    assert svc.metrics.requests_served == 8


def test_transient_engine_failure_retried_with_backoff():
    """A flapping engine backend (here: two UNAVAILABLE failures, then
    success) is absorbed by the bounded retry — every future resolves
    with its result, and the retry counter lands in the metrics
    snapshot."""
    engine = _engine()
    real_predict = engine.predict
    state = {"fails": 2}

    def flaky(X):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise RuntimeError("UNAVAILABLE: backend tunnel hiccup")
        return real_predict(X)

    engine.predict = flaky
    with ServingService(engine, max_wait_ms=20.0, retries=2,
                        retry_backoff_ms=1.0) as svc:
        f1 = svc.submit(np.zeros((2, 16), np.float32))
        f2 = svc.submit(np.ones((3, 16), np.float32))
        assert_logits(
            f1.result(timeout=30),
            real_predict(np.zeros((2, 16), np.float32)))
        f2.result(timeout=30)
        snap = svc.metrics.snapshot()
    assert snap["retries"] == 2
    assert snap["requests"] == 2


def test_transient_failure_beyond_budget_fails_every_future():
    engine = _engine()

    def always_down(X):
        raise ConnectionError("engine unreachable")

    engine.predict = always_down
    with ServingService(engine, max_wait_ms=20.0, retries=1,
                        retry_backoff_ms=1.0) as svc:
        f = svc.submit(np.zeros((2, 16), np.float32))
        with pytest.raises(ConnectionError):
            f.result(timeout=30)
        assert svc.metrics.retries == 1  # budget spent, then fail fast


def test_permanent_engine_error_fails_fast_without_retry():
    """ValueError/TypeError (and anything not matching the transient
    markers) must not burn retry latency — same-batch redispatch can
    only fail identically."""
    engine = _engine()

    def broken(X):
        raise ValueError("shape mismatch inside the engine")

    engine.predict = broken
    with ServingService(engine, max_wait_ms=20.0, retries=3,
                        retry_backoff_ms=50.0) as svc:
        f = svc.submit(np.zeros((2, 16), np.float32))
        with pytest.raises(ValueError):
            f.result(timeout=30)
        assert svc.metrics.retries == 0


def test_retry_respects_request_deadline():
    """An always-transient engine + a short request deadline: the
    request resolves DeadlineExceeded (shed as 'deadline') rather than
    burning the full backoff schedule past its deadline — the retry
    loop caps each sleep at the earliest live deadline and sheds
    expired requests between attempts."""
    engine = _engine()

    def always_down(X):
        raise OSError("connection reset")

    engine.predict = always_down
    with ServingService(engine, max_wait_ms=1.0, retries=50,
                        retry_backoff_ms=40.0) as svc:
        t0 = time.perf_counter()
        f = svc.submit(np.zeros((2, 16), np.float32), timeout_s=0.15)
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=30)
        # 50 x 40ms+ of blind backoff would be 2s+; the deadline cap
        # ends the episode within a few sleep quanta of the deadline
        assert time.perf_counter() - t0 < 1.5
    assert svc.metrics.shed_deadline == 1
    assert svc.metrics.retries >= 1


D, C = 16, 3


CLASSES = (SloClass("interactive", threshold_ms=50.0, objective=0.99),
           SloClass("batch", threshold_ms=500.0, objective=0.95))


def make_engine(buckets=(1, 8, 32)):
    rng = np.random.RandomState(1)
    e = ServingEngine({"w": rng.randn(C, D).astype(np.float32)},
                      buckets=buckets)
    e.warmup()
    return e


class Clock:
    """Injectable monotonic clock: tests advance time by hand."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def make_plane(clk):
    """A metrics bundle on a fake-clock registry — every series
    timestamp below is hand-placed."""
    return ServeMetrics(registry=Registry(clock=clk))


def feed(m, n_bad, n_good, cls="batch", queue_s=0.4, bad_s=0.9,
         good_s=0.005):
    """Record ``n_bad`` over-threshold + ``n_good`` under-threshold
    latencies for ``cls`` plus queue residency — one hand-computed
    burn-rate evidence batch at the registry clock's current time."""
    n = n_bad + n_good
    m.record_batch(n, n, latencies=[bad_s] * n_bad + [good_s] * n_good,
                   stage_seconds={"queue": [queue_s] * n},
                   slo_classes=[cls] * n)


def test_burn_rates_hand_computed():
    clk = Clock()
    m = make_plane(clk)
    # batch: 4 bad of 20 => attainment 0.8, err 0.2, budget 0.05,
    # burn 4.0; interactive: no traffic => None, never 100%
    feed(m, n_bad=4, n_good=16, cls="batch")
    ev = SloEvaluator(m.registry, classes=CLASSES, windows_s=(60.0,))
    rec = ev.burn_rates(now=clk())
    assert rec["batch"]["total"] == 20 and rec["batch"]["good"] == 16
    assert rec["batch"]["attainment"] == pytest.approx(0.8)
    assert rec["batch"]["burn_rate"] == pytest.approx(4.0)
    assert rec["interactive"]["burn_rate"] is None
    # the window ages the evidence out
    clk.t += 120
    rec = ev.burn_rates(now=clk())
    assert rec["batch"]["burn_rate"] is None


def test_deadline_shed_counts_slo_bad_regardless_of_wait():
    """Survivorship-bias guard: a deadline-shed request lands on its
    class's deadline-miss counter and the evaluator folds it into
    attainment as SLO-BAD — a miss is bad whatever it waited, so the
    burn signal sees overload even when callers run deadlines TIGHTER
    than the class threshold (a waited-time latency sample would have
    read such a death as 'good')."""
    clk = Clock()
    m = make_plane(clk)
    # batch threshold is 500ms; these requests died at 50ms — still
    # SLO-bad, every one of them
    for _ in range(10):
        m.record_shed("deadline", slo_class="batch")
    ev = SloEvaluator(m.registry, classes=CLASSES, windows_s=(60.0,))
    rec = ev.burn_rates(now=clk())
    assert rec["batch"]["total"] == 10 and rec["batch"]["good"] == 0
    assert rec["batch"]["missed"] == 10
    assert rec["batch"]["attainment"] == 0.0
    assert m.shed_deadline == 10
    # misses COMPOSE with served samples: 10 missed + 10 served-good
    # => attainment 0.5, burn 10 (budget 0.05)
    feed(m, n_bad=0, n_good=10, good_s=0.005)
    rec = ev.burn_rates(now=clk())
    assert rec["batch"]["total"] == 20 and rec["batch"]["good"] == 10
    assert rec["batch"]["attainment"] == pytest.approx(0.5)
    assert rec["batch"]["burn_rate"] == pytest.approx(10.0)
    # evaluate() shares the same window arithmetic (one definition)
    full = ev.evaluate(now=clk())
    assert full["classes"]["batch"]["windows"]["60s"] == rec["batch"]
    # admission sheds deliberately do NOT count as misses (the
    # controller's own shedding must not feed back into its trigger)
    m.record_admission_shed("batch")
    assert ev.burn_rates(now=clk())["batch"]["missed"] == 10
    # ...and the miss evidence ages out with the window
    clk.t += 120
    assert ev.burn_rates(now=clk())["batch"]["burn_rate"] is None


def test_admission_shed_counters_and_rate():
    clk = Clock()
    m = make_plane(clk)
    for _ in range(6):
        m.record_admission_shed("batch")
    m.record_admission_shed("shadow")
    snap = m.snapshot()
    assert snap["shed_admission"] == 7 and m.shed_admission == 7
    assert snap["requests_shed_by_class"] == {"batch": 6, "shadow": 1}
    assert m.registry.lookup(SHED_CLASS_METRIC,
                             labels={"class": "batch"}).value == 6
    assert admission_shed_rate(m.registry, 10.0,
                               now=clk()) == pytest.approx(0.7)
    clk.t += 100  # rate ages out with the window
    assert admission_shed_rate(m.registry, 10.0, now=clk()) == 0.0


def test_queue_residency_family_records():
    clk = Clock()
    m = make_plane(clk)
    m.record_batch(4, 4, latencies=[0.01] * 4,
                   stage_seconds={"queue": [0.2, 0.3, 0.4, 0.5]})
    hist = m.registry.lookup(QUEUE_RESIDENCY_METRIC)
    assert hist is not None and hist.count == 4
    assert hist.percentile(95, window_s=60.0,
                           now=clk()) == pytest.approx(0.5)


def make_controller(m, **kw):
    kw.setdefault("classes", CLASSES)
    kw.setdefault("shed_order", ("shadow", "batch"))
    kw.setdefault("window_s", 5.0)
    kw.setdefault("interval_s", 0.05)
    kw.setdefault("escalate_ticks", 2)
    kw.setdefault("relax_ticks", 3)
    kw.setdefault("min_window_requests", 10)
    return AdmissionController(m, **kw)


def test_controller_validates():
    m = make_plane(Clock())
    with pytest.raises(ValueError, match="shed_order"):
        AdmissionController(m, classes=CLASSES, shed_order=())
    with pytest.raises(ValueError, match="protected"):
        AdmissionController(m, classes=CLASSES,
                            shed_order=("interactive", "batch"))
    with pytest.raises(ValueError, match="positive"):
        make_controller(m, window_s=0)
    with pytest.raises(ValueError, match=">= 1"):
        make_controller(m, escalate_ticks=0)


def test_controller_escalates_one_class_at_a_time():
    """The hand-computed shed fixture: batch burn 4.0 with 400ms queue
    residency corroborating => shadow sheds after escalate_ticks,
    batch after another escalate_ticks, interactive NEVER."""
    clk = Clock()
    m = make_plane(clk)
    ctl = make_controller(m)
    feed(m, n_bad=8, n_good=12)
    assert ctl.decide(clk())["triggered"] == ["batch"]
    assert ctl.level == 0  # one tick is not escalation
    ctl.decide(clk())
    assert ctl.level == 1 and ctl.shed_classes() == ("shadow",)
    assert not ctl.admit("shadow", now=clk.t)
    assert ctl.admit("batch", now=clk.t)
    ctl.decide(clk())
    ctl.decide(clk())
    assert ctl.level == 2 and ctl.shed_classes() == ("batch", "shadow")
    assert not ctl.admit("batch", now=clk.t)
    assert ctl.admit("interactive", now=clk.t)  # protected, always
    for _ in range(10):  # escalation is BOUNDED by the shed order
        ctl.decide(clk())
    assert ctl.level == 2


def test_controller_burn_without_queue_never_sheds():
    """The corroboration gate: slow-but-served traffic with an empty
    queue is not overload — burn alone must not shed."""
    clk = Clock()
    m = make_plane(clk)
    ctl = make_controller(m)
    feed(m, n_bad=8, n_good=12, queue_s=0.001)  # 1ms queue residency
    for _ in range(6):
        d = ctl.decide(clk())
    assert d["triggered"] == ["batch"] and not d["corroborated"]
    assert ctl.level == 0 and ctl.admit("shadow", now=clk.t)


def test_controller_thin_evidence_never_sheds():
    clk = Clock()
    m = make_plane(clk)
    ctl = make_controller(m, min_window_requests=30)
    feed(m, n_bad=8, n_good=12)  # 20 < 30: not enough evidence
    for _ in range(4):
        ctl.decide(clk())
    assert ctl.level == 0


def test_controller_relaxes_slowly_with_hysteresis():
    clk = Clock()
    m = make_plane(clk)
    ctl = make_controller(m)
    feed(m, n_bad=8, n_good=12)
    for _ in range(4):
        ctl.decide(clk())
    assert ctl.level == 2
    clk.t += 10  # the bad window ages out entirely
    feed(m, n_bad=0, n_good=20, queue_s=0.001)
    ctl.decide(clk())
    ctl.decide(clk())
    assert ctl.level == 2  # 2 clean ticks < relax_ticks: still shed
    ctl.decide(clk())
    assert ctl.level == 1  # relax one LEVEL per relax_ticks
    for _ in range(3):
        ctl.decide(clk())
    assert ctl.level == 0 and ctl.shed_classes() == ()
    assert ctl.admit("batch", now=clk.t)


def test_admit_caches_by_interval():
    """admit() is the submit-path call: at most one evaluation per
    interval_s, everything between is a cached set lookup."""
    clk = Clock()
    m = make_plane(clk)
    ctl = make_controller(m, interval_s=1.0)
    for _ in range(50):
        ctl.admit("batch", now=clk.t)
    assert ctl.evaluations == 1
    clk.t += 1.1
    ctl.admit("batch", now=clk.t)
    assert ctl.evaluations == 2


def make_scaler(router, m, clk, **kw):
    engine = router.engine
    kw.setdefault("classes", CLASSES)
    kw.setdefault("window_s", 5.0)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("scale_down_burn", 0.25)
    kw.setdefault("min_window_requests", 10)
    return Autoscaler(router, lambda rid: Replica(rid, engine), m,
                      clock=clk, **kw)


def test_autoscaler_validates():
    engine = make_engine()
    router = Fleet(engine, 1)
    m = make_plane(Clock())
    with pytest.raises(ValueError, match="hysteresis"):
        make_scaler(router, m, Clock(), scale_down_burn=1.5)
    with pytest.raises(ValueError, match="min_replicas"):
        make_scaler(router, m, Clock(), min_replicas=0)
    with pytest.raises(ValueError, match=">= 1"):
        make_scaler(router, m, Clock(), up_ticks=0)


def test_autoscaler_scales_up_under_flash_crowd():
    """The flash-crowd pin, clock-driven: clean traffic holds, the
    burn spike scales up after up_ticks (cooldown gating each step)
    up to max_replicas and never past."""
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 1)
    asc = make_scaler(router, m, clk, max_replicas=3)
    feed(m, n_bad=0, n_good=20, queue_s=0.001)
    for _ in range(5):
        assert asc.tick(clk())["action"] == "hold"
    assert router.fleet_size() == 1
    # the crowd arrives: burn 4.0, 400ms queue residency
    clk.t += 1
    feed(m, n_bad=8, n_good=12)
    assert asc.tick(clk())["action"] == "hold"  # tick 1 of up_ticks=2
    rec = asc.tick(clk())
    assert rec["action"] == "up" and router.fleet_size() == 2
    assert rec["attach_ms"] >= 0 and rec["replica_id"] == 1
    # cooldown holds the next step
    clk.t += 0.2
    asc.tick(clk())
    asc.tick(clk())
    assert router.fleet_size() == 2
    clk.t += 1.0  # cooldown over; evidence still burning
    asc.tick(clk())
    asc.tick(clk())
    assert router.fleet_size() == 3 and asc.scale_ups == 2
    clk.t += 1.0  # max-fleet bound: never past max_replicas
    for _ in range(6):
        asc.tick(clk())
    assert router.fleet_size() == 3
    assert [e["action"] for e in asc.events] == ["up", "up"]


def test_autoscaler_shed_rate_alone_scales_up():
    """Policy-shed traffic IS unserved demand: once the controller
    sheds, the served remainder looks healthy — the shed-rate signal
    must scale the fleet without waiting for burn or queue to re-age."""
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 1)
    asc = make_scaler(router, m, clk, up_ticks=1)
    m.record_admission_shed("batch")
    rec = asc.tick(clk())
    assert rec["action"] == "up" and rec["shed_rate"] > 0
    assert router.fleet_size() == 2


def test_autoscaler_scales_down_with_hysteresis_and_floor():
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 1)
    asc = make_scaler(router, m, clk, up_ticks=1, down_ticks=3)
    feed(m, n_bad=8, n_good=12)
    asc.tick(clk())
    clk.t += 2
    feed(m, n_bad=8, n_good=12)
    asc.tick(clk())
    assert router.fleet_size() == 3
    # quiet: the bad window ages out entirely, no sheds, no queue
    clk.t += 20
    assert asc.tick(clk())["action"] == "hold"  # quiet tick 1
    asc.tick(clk())
    assert router.fleet_size() == 3  # 2 quiet ticks < down_ticks
    rec = asc.tick(clk())
    assert rec["action"] == "down" and router.fleet_size() == 2
    assert rec["replica_id"] == 2  # last added goes first
    clk.t += 2  # cooldown, then the remaining added replica
    for _ in range(3):
        asc.tick(clk())
    assert router.fleet_size() == 1 and asc.scale_downs == 2
    # the floor: the founding replica is never the autoscaler's to take
    clk.t += 5
    for _ in range(8):
        asc.tick(clk())
    assert router.fleet_size() == 1


def test_autoscaler_dead_band_holds():
    """Burn between the down and up thresholds is the hysteresis dead
    band: no action, ever — the no-flap pin."""
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 1)
    asc = make_scaler(router, m, clk, up_ticks=1, down_ticks=2,
                      scale_up_burn=1.0, scale_down_burn=0.25)
    # batch: 1 bad of 20 => burn 1.0 — NOT > up threshold, not < 0.25
    feed(m, n_bad=1, n_good=19)
    for _ in range(10):
        assert asc.tick(clk())["action"] == "hold"
    assert asc.events == [] and router.fleet_size() == 1


def test_autoscaler_replica_seconds_integral():
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 2)
    asc = make_scaler(router, m, clk, up_ticks=1)
    clk.t += 10  # 2 replicas for 10s
    assert asc.replica_seconds(clk()) == pytest.approx(20.0)
    feed(m, n_bad=8, n_good=12)
    asc.tick(clk())  # -> 3 replicas at t+10
    clk.t += 5  # 3 replicas for 5s
    assert asc.replica_seconds(clk()) == pytest.approx(35.0)


def test_overload_rejection_is_class_attributed():
    """A max_queue rejection is a door shed like an admission shed:
    it must land on the per-class shed family (the autoscaler's
    capacity-shortfall signal), not vanish into a classless counter
    while the survivors read healthy."""
    engine = make_engine()
    with ServingService(engine, max_queue=0) as svc:
        x = np.random.RandomState(0).randn(1, D).astype(np.float32)
        from fedamw_tpu_torch.serving import Overloaded

        with pytest.raises(Overloaded):
            svc.submit(x, slo_class="interactive")
        snap = svc.metrics.snapshot(engine)
    assert snap["shed_overload"] == 1
    assert snap["requests_shed_by_class"] == {"interactive": 1}
    assert admission_shed_rate(svc.metrics.registry, 60.0) > 0


def test_autoscaler_forgets_externally_removed_replica():
    """An operator removing the autoscaler's replica out from under
    it must not wedge scale-in forever: the KeyError prunes the stale
    id and the next quiet period removes the remaining added one."""
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 1)
    asc = make_scaler(router, m, clk, up_ticks=1, down_ticks=1,
                      cooldown_s=0.0)
    feed(m, n_bad=8, n_good=12)
    asc.tick(clk())
    clk.t += 2
    feed(m, n_bad=8, n_good=12)
    asc.tick(clk())
    assert router.fleet_size() == 3
    router.remove_replica(2)  # the operator takes the last-added one
    clk.t += 20  # quiet: everything aged out
    rec = asc.tick(clk())
    assert rec["action"] == "error" and asc.errors == 1
    rec = asc.tick(clk())  # the stale id is forgotten: shrink works
    assert rec["action"] == "down" and rec["replica_id"] == 1
    assert router.fleet_size() == 1


def test_autoscaler_factory_error_counted_not_fatal():
    clk = Clock()
    m = make_plane(clk)
    engine = make_engine()
    router = Fleet(engine, 1)

    def boom(rid):
        raise RuntimeError("artifact missing")

    asc = Autoscaler(router, boom, m, classes=CLASSES, window_s=5.0,
                     up_ticks=1, scale_down_burn=0.25, clock=clk,
                     min_window_requests=10)
    feed(m, n_bad=8, n_good=12)
    rec = asc.tick(clk())
    assert rec["action"] == "error" and asc.errors == 1
    assert router.fleet_size() == 1


class _R:
    def __init__(self, deadline, t_submit):
        self.deadline = deadline
        self.t_submit = t_submit


def test_edf_order_pure():
    a = _R(5.0, 1.0)
    b = _R(2.0, 2.0)
    c = _R(None, 0.5)
    d = _R(2.0, 1.5)
    out = edf_order([a, b, c, d])
    # soonest deadline first; FIFO among equals; no-deadline last
    assert out == [d, b, a, c]
    # all-deadline-free: byte-identical FIFO (the clean-load path)
    e, f = _R(None, 1.0), _R(None, 2.0)
    assert edf_order([e, f]) == [e, f]
    assert edf_order([f, e]) == [e, f]


class _SlowFirstEngine:
    """Engine front whose FIRST dispatch stalls — the window in which
    the EDF test queues its out-of-order-deadline requests."""

    def __init__(self, engine, stall_s=0.25):
        self._engine = engine
        self._stall = stall_s
        self._calls = 0
        self.buckets = (1, 2)
        self.input_dim = engine.input_dim

    def predict(self, X, **kw):
        self._calls += 1
        if self._calls == 1:
            time.sleep(self._stall)
        return self._engine.predict(X, **kw)


def test_service_dispatches_soonest_deadline_first_under_pressure():
    """Three queued requests against a 2-row ladder: the worker must
    serve the two soonest deadlines and defer the most patient, in
    deadline order — not arrival order."""
    engine = make_engine()
    front = _SlowFirstEngine(engine)
    order, lock = [], threading.Lock()

    def tag(name):
        def cb(fut):
            with lock:
                order.append(name)
        return cb

    x = np.random.RandomState(0).randn(1, D).astype(np.float32)
    with ServingService(front, max_queue=64) as svc:
        first = svc.submit(x, timeout_s=30.0)
        first.add_done_callback(tag("first"))
        time.sleep(0.05)  # the worker is inside the stalled dispatch
        # arrival order is the REVERSE of deadline order
        for name, to in (("patient", 20.0), ("mid", 10.0),
                         ("urgent", 5.0)):
            svc.submit(x, timeout_s=to).add_done_callback(tag(name))
        time.sleep(0.02)
        deadline = time.time() + 10
        while len(order) < 4 and time.time() < deadline:
            time.sleep(0.01)
    # dispatch 2 carries [urgent, mid] (2-row cap), "patient" defers
    assert order[0] == "first"
    assert order.index("urgent") < order.index("patient")
    assert order.index("mid") < order.index("patient")


def test_edf_aging_bounds_deferral_of_deadline_free_requests():
    """Starvation guard: pure EDF sorts a deadline-FREE request last
    every cycle, and a sustained deadline'd stream would defer it
    forever. Aging (EDF_MAX_DEFERRALS) exempts it to the front after
    a bounded number of deferrals — it must resolve well before the
    deadline'd tail, not after it."""
    engine = make_engine(buckets=(1,))  # one row per dispatch
    order, lock = [], threading.Lock()

    def tag(name):
        def cb(fut):
            with lock:
                order.append(name)
        return cb

    x = np.random.RandomState(0).randn(1, D).astype(np.float32)
    with ServingService(engine, max_queue=256) as svc:
        # a pre-queued pressure train, then the deadline-free request,
        # then MORE deadline'd traffic behind it: every cycle's EDF
        # window holds a sooner deadline than "free"'s (none)
        for i in range(10):
            svc.submit(x, timeout_s=30.0).add_done_callback(
                tag(f"a{i}"))
        free = svc.submit(x)  # no deadline: pure EDF would starve it
        free.add_done_callback(tag("free"))
        for i in range(15):
            svc.submit(x, timeout_s=30.0).add_done_callback(
                tag(f"b{i}"))
        free.result(timeout=30)
        deadline = time.time() + 20
        while len(order) < 26 and time.time() < deadline:
            time.sleep(0.01)
    assert len(order) == 26
    # bounded deferral: "free" dispatched within EDF_MAX_DEFERRALS-ish
    # cycles of the deadline'd traffic overtaking it — NOT last
    assert order.index("free") < order.index("b10")


class _StubAdmission:
    """Duck-typed controller: sheds exactly the named classes —
    isolates the service wiring from the controller's dynamics."""

    def __init__(self, shed):
        self.shed = set(shed)

    def admit(self, slo_class, now=None):
        return slo_class not in self.shed


def test_admission_shed_resolves_future_typed_with_span():
    engine = make_engine()
    tracer = Tracer()
    with ServingService(engine, tracer=tracer,
                        admission=_StubAdmission({"batch"})) as svc:
        x = np.random.RandomState(0).randn(2, D).astype(np.float32)
        shed_fut = svc.submit(x, slo_class="batch")
        ok_fut = svc.submit(x, slo_class="interactive")
        # the shed future is ALREADY resolved, with the typed error —
        # not Overloaded, not DeadlineExceeded
        with pytest.raises(AdmissionShed, match="batch"):
            shed_fut.result(timeout=0)
        ok_fut.result(timeout=30)
        snap = svc.metrics.snapshot(engine)
    assert snap["shed_admission"] == 1
    assert snap["requests_shed_by_class"] == {"batch": 1}
    assert snap["shed_deadline"] == 0  # NOT the deadline path
    assert snap["requests"] == 1  # the interactive one served
    # exactly one span per submitted id — the shed one included, with
    # the shed annotation naming class and policy
    spans = {s["trace_id"]: s for s in tracer.records()
             if s["name"] == "request"}
    assert set(spans) == {shed_fut.request_id, ok_fut.request_id}
    assert spans[shed_fut.request_id]["attrs"]["outcome"] == "shed"
    assert spans[ok_fut.request_id]["attrs"]["outcome"] == "ok"
    ann = [s for s in tracer.records() if s["name"] == "shed"]
    assert len(ann) == 1
    assert ann[0]["trace_id"] == shed_fut.request_id
    assert ann[0]["attrs"]["slo_class"] == "batch"
    assert ann[0]["attrs"]["policy"] == "admission"


class _WedgedEngine:
    """Engine whose dispatch stalls far past any class deadline —
    what a class-implied timeout must protect callers from."""

    def __init__(self, stall_s=5.0):
        self.buckets = (1, 8)
        self.input_dim = D
        self.num_classes = C
        self.version = 0
        self.compile_count = 0
        self.stall_s = stall_s

    def predict(self, X, version=None, record_timings=True):
        time.sleep(self.stall_s)
        return np.zeros((np.atleast_2d(X).shape[0], C), np.float32)


def test_slo_class_owns_a_default_timeout():
    # explicit wins; unset derives 4x the threshold — the vocabulary
    # owns the number either way
    c = SloClass("interactive", threshold_ms=50.0, objective=0.9,
                 default_timeout_s=0.75)
    assert c.timeout_s() == 0.75
    d = SloClass("batch", threshold_ms=500.0, objective=0.9)
    assert d.timeout_s() == pytest.approx(2.0)
    with pytest.raises(ValueError, match="default_timeout_s"):
        SloClass("x", threshold_ms=10.0, default_timeout_s=0.0)


def test_class_deadline_applies_without_hand_picked_timeout():
    """A submit that names its class but no timeout gets the class
    deadline — observable as a DeadlineExceeded against a wedged engine,
    where no deadline would hang the caller for the full stall."""
    from fedamw_tpu_torch.serving import DeadlineExceeded

    classes = (SloClass("interactive", threshold_ms=50.0,
                        objective=0.9, default_timeout_s=0.2),)
    engine = _WedgedEngine(stall_s=1.0)
    with ServingService(engine, slo_classes=classes) as svc:
        x = np.zeros((1, D), np.float32)
        # head request occupies the engine for the full stall...
        head = svc.submit(x, slo_class="interactive")
        time.sleep(0.1)  # let the worker dequeue it and wedge
        # ...so the second ages in the queue past its CLASS deadline
        # (0.2s) — no timeout_s hand-picked anywhere
        fut = svc.submit(x, slo_class="interactive")
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert head.result(timeout=30).shape == (1, C)


def test_explicit_timeout_wins_over_class_default():
    classes = (SloClass("interactive", threshold_ms=50.0,
                        objective=0.9, default_timeout_s=0.05),)
    engine = _WedgedEngine(stall_s=0.3)
    with ServingService(engine, slo_classes=classes) as svc:
        x = np.zeros((1, D), np.float32)
        # the caller's explicit, LONGER deadline overrides the tiny
        # class default: the request survives the stall
        out = svc.submit(x, slo_class="interactive",
                         timeout_s=30.0).result(timeout=30)
        assert out.shape == (1, C)


def test_unknown_class_and_no_vocabulary_stay_deadline_free():
    # outside the vocabulary (and with no vocabulary at all), nothing
    # changes: no implied deadline
    classes = (SloClass("interactive", threshold_ms=50.0,
                        objective=0.9, default_timeout_s=0.05),)
    engine = _WedgedEngine(stall_s=0.3)
    with ServingService(engine, slo_classes=classes) as svc:
        x = np.zeros((1, D), np.float32)
        out = svc.submit(x, slo_class="bulk").result(timeout=30)
        assert out.shape == (1, C)
    with ServingService(engine) as svc:
        out = svc.submit(x, slo_class="interactive").result(timeout=30)
        assert out.shape == (1, C)


def test_serving_exports_the_ported_names():
    """The package exports its modules' names, and none of the modules
    it does not carry."""
    import fedamw_tpu_torch.serving as serving

    for name in serving.__all__:
        assert getattr(serving, name) is not None, name
    assert serving.ServingEngine is _ServingEngine
    for absent in ("FailoverRouter", "LadderLearner", "ChaosSpec",
                   "PodWorker", "export_ladder"):
        assert absent not in serving.__all__
        assert not hasattr(serving, absent)
