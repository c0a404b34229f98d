"""The train->serve loop of the port on its engine, on the CPU: the
versioned registry, the checkpoint watcher and the shadow/A-B rollout.

``fedamw_tpu_torch.serving``'s ``registry``, ``rollout``, ``service``
and ``metrics`` are copies of the JAX package's; the behaviour its tests
pin (``tests/test_rollout.py``, and the watcher's in
``tests/test_replica.py``) is held here on the port's modules with the
port's ``ServingEngine`` behind them: registry publish, staleness and
prune; checkpoints read back with their markers (the port's pickle
layout, and the JAX package's); the deterministic split; the parity
gate, the shadow canary's promotion, the error-budget rollback with the
live fallback, A/B slices; staleness on every span and in the snapshot;
swaps atomic under concurrent submits with the shape count flat; the
fractional ramp; the off-thread shadow probe; the watcher's round order,
retries, lifecycle and callback errors, and its refusal of the artifact
plane. The engine's own swap contracts are
``tests/test_torch_serve_engine.py``. Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest

from fedamw_tpu_torch.serving import (CheckpointWatcher, ModelRegistry,
                                      RolloutController,
                                      ServingEngine as _ServingEngine,
                                      ServingService,
                                      assigned_to_candidate, split_key)
from fedamw_tpu_torch.utils.trace import Tracer
from torch_threads import one_torch_thread  # noqa: F401


class ServingEngine(_ServingEngine):
    """The port's engine on the CPU."""

    def __init__(self, *a, device=None, **kw):
        super().__init__(*a, device=device or "cpu", **kw)

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


def base_params(scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (scale * rng.randn(C, D)).astype(np.float32)}


def make_engine(buckets=(1, 8, 32), rff=False, **kw):
    rng = np.random.RandomState(1)
    r = None
    if rff:
        r = (rng.randn(8, D).astype(np.float32),
             rng.randn(D).astype(np.float32))
        kw.setdefault("params", {"w": rng.randn(C, D).astype(np.float32)})
    params = kw.pop("params", base_params())
    e = ServingEngine(params, rff=r, buckets=buckets, **kw)
    e.warmup()
    return e


def test_registry_publish_get_latest_staleness():
    reg = ModelRegistry()
    assert reg.latest() is None and len(reg) == 0
    v1 = reg.publish(base_params(), round_idx=2,
                     metadata={"eval_acc": 91.25})
    v2 = reg.publish(base_params(2.0), round_idx=7)
    assert v2 == v1 + 1 and reg.versions() == [v1, v2]
    assert reg.latest().version == v2
    assert reg.get(v1).eval_acc == 91.25 and reg.get(v2).eval_acc is None
    # staleness: rounds the newest publish is ahead of a version
    assert reg.staleness_rounds(v1) == 5
    assert reg.staleness_rounds(v2) == 0
    assert reg.staleness_rounds(999) == 0  # unknown stays 0, not huge
    with pytest.raises(KeyError, match="not in registry"):
        reg.get(999)
    # withdrawing a gate-rejected publish stops it counting toward
    # everyone else's staleness
    assert reg.withdraw(v2) is True and reg.withdraw(v2) is False
    assert reg.staleness_rounds(v1) == 0


def test_registry_publish_checkpoint_carries_markers(tmp_path):
    from fedamw_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.RandomState(3)
    rff = (rng.randn(8, D).astype(np.float32),
           rng.randn(D).astype(np.float32))
    save_checkpoint(str(tmp_path / "ck"), base_params(), p=np.ones(4) / 4,
                    round_idx=6, rff=rff, extra={"eval_acc": 88.5})
    reg = ModelRegistry()
    v = reg.publish_checkpoint(str(tmp_path / "ck"))
    entry = reg.get(v)
    assert entry.round_idx == 6 and entry.eval_acc == 88.5
    assert entry.source.startswith("checkpoint:")
    np.testing.assert_array_equal(entry.rff[0], rff[0])
    # the published params serve: straight into an engine (raw width
    # comes from the checkpointed draw: rff_W is (d_raw, D_features))
    engine = ServingEngine(entry.params, rff=entry.rff, buckets=(8,))
    assert engine.input_dim == rff[0].shape[0]


def test_registry_prune_keeps_protected():
    reg = ModelRegistry()
    vs = [reg.publish(base_params(), round_idx=k) for k in range(5)]
    removed = reg.prune(keep=2, protect=(vs[0],))
    assert vs[0] in reg and vs[-1] in reg
    assert len(reg) == 2 + 1 - 1  # keep=2 total, protected survives
    for v in removed:
        assert v not in reg


def test_router_slot_is_singular_and_detachable():
    engine = make_engine()
    reg = ModelRegistry()
    cand = reg.publish(base_params(2.0), round_idx=1)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        a = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                              min_requests=10 ** 6)
        assert a.stage(cand)
        # a second controller must not silently orphan A's rollout
        with pytest.raises(ValueError, match="already has a router"):
            RolloutController(svc, reg, mode="shadow", fraction=0.5)
        a.detach()  # rolls back the in-flight candidate, frees slot
        assert cand not in engine.versions_installed
        assert svc.router is None
        b = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                              min_requests=0)
        assert b.stage(cand) and engine.version == cand


def test_min_agreement_is_shadow_only():
    """ab mode has no paired live outputs to measure agreement on —
    configuring the floor there must refuse loudly, not silently
    never enforce."""
    engine = make_engine()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        with pytest.raises(ValueError, match="shadow-mode"):
            RolloutController(svc, ModelRegistry(), mode="ab",
                              min_agreement=0.9)


def test_parity_gate_dispatch_never_pollutes_worker_timings():
    """The controller's parity-gate predict runs on another thread;
    with record_timings=False it must not land in the pop_timings
    slot the serving worker attributes spans from."""
    engine = make_engine()
    X = np.random.RandomState(5).randn(4, D).astype(np.float32)
    engine.predict(X)  # worker-style call: populates the slot
    engine.install_weights(9, base_params(3.0))
    engine.predict(X, version=9, record_timings=False)
    t = engine.pop_timings()
    assert t is not None and t["version"] == engine.version  # not 9
    assert engine.pop_timings() is None


def test_split_assignment_is_deterministic_and_monotone():
    ids = [f"req-{i}" for i in range(2000)]
    a1 = [assigned_to_candidate(i, 0.3) for i in ids]
    a2 = [assigned_to_candidate(i, 0.3) for i in ids]
    assert a1 == a2  # pure function of the id
    # monotone ramp: everyone at 0.3 is still assigned at 0.6
    a_wide = [assigned_to_candidate(i, 0.6) for i in ids]
    assert all(w for n, w in zip(a1, a_wide) if n)
    # edges and rough calibration
    assert not any(assigned_to_candidate(i, 0.0) for i in ids)
    assert all(assigned_to_candidate(i, 1.0) for i in ids)
    frac = np.mean(a1)
    assert 0.25 < frac < 0.35
    assert all(0.0 <= split_key(i) < 1.0 for i in ids)


def test_partition_preserves_order_and_covers_batch():
    from fedamw_tpu_torch.serving import partition

    hit, miss = partition(list(range(10)), lambda x: x % 3 == 0)
    assert hit == [0, 3, 6, 9] and miss == [1, 2, 4, 5, 7, 8]
    assert partition([], lambda x: True) == ([], [])


def test_format_rollout_report_reads_like_a_verdict():
    from fedamw_tpu_torch.utils.reporting import format_rollout_report

    line = format_rollout_report({
        "mode": "shadow", "swaps": 3, "swap_p50_ms": 0.4,
        "swap_max_ms": 5.6, "canary": "promoted", "canary_ms": 118.8,
        "rollback_drill": "rolled_back", "inflight_p95_ms": 9.5,
        "recompiles_during_swaps": 0, "final_version": 3,
        "staleness_rounds": 1})
    assert "3 swaps" in line and "canary promoted" in line
    assert "drill rolled_back" in line and "recompiles 0" in line
    assert "serving v3" in line


def _labels_for(engine, X):
    return np.argmax(engine.predict(X), -1)


def test_parity_gate_failure_rolls_back_and_live_keeps_serving():
    engine = make_engine()
    rng = np.random.RandomState(9)
    X = rng.randn(64, D).astype(np.float32)
    y = _labels_for(engine, X)  # live model scores 100 on its own labels
    reg = ModelRegistry()
    # sign-flipped weights published under the clean model's accuracy:
    # the gate must catch the lie before any traffic reaches them
    bad = reg.publish(base_params(-1.0), round_idx=1,
                      metadata={"eval_acc": 100.0})
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                                min_requests=0, parity_data=(X, y))
        live_before = engine.version
        assert ctl.stage(bad) is False
        # prior version serving, candidate fully retired
        assert engine.version == live_before
        assert bad not in engine.versions_installed
        out = svc.predict(X[:4])
        assert_logits(out, engine.predict(X[:4]))
    assert ctl.events[-1]["event"] == "rollback"
    assert ctl.events[-1]["gate"]["match"] is False
    assert svc.metrics.rollbacks == 1
    assert ctl.split() is None


def test_shadow_canary_promotes_after_budget_and_answers_from_live():
    engine = make_engine()
    rng = np.random.RandomState(11)
    X = rng.randn(64, D).astype(np.float32)
    y = _labels_for(engine, X)
    reg = ModelRegistry()
    # 2x weights: same argmax (gate passes, agreement 1.0), different
    # logits (so "answered from live" is distinguishable bitwise)
    cand = reg.publish(base_params(2.0), round_idx=3,
                       metadata={"eval_acc": 100.0})
    payload = X[:4]
    live_out = engine.predict(payload)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=1.0,
                                min_requests=10, error_budget=0,
                                min_agreement=0.99, parity_data=(X, y))
        assert ctl.stage(cand) is True
        assert engine.version != cand  # staged, not yet live
        pre = [svc.submit(payload) for _ in range(10)]
        for f in pre:
            # shadow phase: every caller answered from the LIVE version
            # even though its request was mirrored to the candidate
            out = f.result(timeout=30)
            if engine.version != cand:  # before the flip lands
                assert_logits(out, live_out)
        deadline = time.perf_counter() + 30
        while engine.version != cand and time.perf_counter() < deadline:
            time.sleep(0.005)
        assert engine.version == cand  # canary promoted
        post = svc.predict(payload)
        np.testing.assert_allclose(post, 2 * live_out, rtol=1e-5)
        snap = svc.metrics.snapshot(engine)
    assert snap["model_version"] == cand
    assert snap["weight_swaps"] == 1
    assert snap["shadow_requests"] >= 10
    assert snap["candidate_errors"] == 0 and snap["rollbacks"] == 0
    assert ctl.events[-1]["event"] == "promoted"
    assert ctl.events[-1]["agreement"] == 1.0


class _CandidateFails(ServingEngine):
    """Candidate-version dispatches raise; live dispatches serve."""

    fail_version = None

    def predict(self, X, version=None):
        if version is not None and version == self.fail_version:
            raise RuntimeError("candidate weights exploded")
        return super().predict(X, version=version)


def test_error_budget_rollback_with_live_fallback_in_ab_mode():
    rng = np.random.RandomState(1)
    engine = _CandidateFails(base_params(), buckets=(1, 8, 32))
    engine.warmup()
    reg = ModelRegistry()
    cand = reg.publish(base_params(2.0), round_idx=1)
    engine.fail_version = cand
    payload = rng.randn(2, D).astype(np.float32)
    live_out = engine.predict(payload)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="ab", fraction=1.0,
                                min_requests=1000, error_budget=3)
        assert ctl.stage(cand) is True
        futs = [svc.submit(payload) for _ in range(8)]
        for f in futs:
            # every A/B caller transparently falls back to the live
            # version — a broken canary never surfaces as an error
            assert_logits(f.result(timeout=30),
                                          live_out)
        deadline = time.perf_counter() + 30
        while ctl.split() is not None and time.perf_counter() < deadline:
            time.sleep(0.005)
        snap = svc.metrics.snapshot(engine)
    assert ctl.split() is None  # rolled back, not promoted
    assert engine.version != cand
    assert cand not in engine.versions_installed
    assert snap["candidate_errors"] > 3
    assert snap["rollbacks"] == 1
    assert ctl.events[-1]["event"] == "rollback"
    assert "error budget" in ctl.events[-1]["reason"]


def test_ab_mode_serves_candidate_slice_by_request_id():
    engine = make_engine()
    rng = np.random.RandomState(13)
    reg = ModelRegistry()
    cand = reg.publish(base_params(2.0), round_idx=1)
    payload = rng.randn(2, D).astype(np.float32)
    live_out = engine.predict(payload)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="ab", fraction=0.5,
                                min_requests=10 ** 6)  # never promotes
        assert ctl.stage(cand) is True
        futs = [svc.submit(payload) for _ in range(40)]
        for f in futs:
            out = f.result(timeout=30)
            if assigned_to_candidate(f.request_id, 0.5):
                np.testing.assert_allclose(out, 2 * live_out, rtol=1e-5)
            else:
                assert_logits(out, live_out)
        snap = svc.metrics.snapshot(engine)
    by_ver = snap["requests_by_version"]
    assert set(by_ver) == {str(engine.version), str(cand)}
    assert sum(by_ver.values()) == 40
    ctl.rollback("test done")


def test_stage_gate_exception_retires_candidate_and_allows_retry():
    """A parity gate that cannot RUN (malformed parity data here; a
    transient backend blip in production) must not leak the installed
    candidate — the same version number must be re-stageable once the
    problem clears."""
    engine = make_engine()
    rng = np.random.RandomState(9)
    reg = ModelRegistry()
    cand = reg.publish(base_params(2.0), round_idx=1,
                       metadata={"eval_acc": 100.0})
    bad_width = rng.randn(8, D + 3).astype(np.float32)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                                min_requests=10 ** 6,
                                parity_data=(bad_width, np.zeros(8)))
        with pytest.raises(ValueError, match="expected"):
            ctl.stage(cand)
        assert cand not in engine.versions_installed  # no leak
        assert ctl.split() is None
        # retry with usable parity data: the slot was cleaned up, so
        # staging the SAME version must not raise "already installed"
        # (2x weights share the live argmax, so the gate passes)
        X = rng.randn(64, D).astype(np.float32)
        ctl.parity_data = (X, _labels_for(engine, X))
        assert ctl.stage(cand) is True
        ctl.rollback("test done")


def test_snapshot_staleness_tracks_registry_after_swaps_stop():
    """The falling-behind signal: once promoted, a service that never
    swaps again must still watch its staleness grow as training
    publishes new rounds."""
    engine = make_engine()
    rng = np.random.RandomState(11)
    X = rng.randn(64, D).astype(np.float32)
    y = _labels_for(engine, X)
    reg = ModelRegistry()
    cand = reg.publish(base_params(2.0), round_idx=3,
                       metadata={"eval_acc": 100.0})
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                                min_requests=0, parity_data=(X, y))
        assert ctl.stage(cand) and engine.version == cand
        assert svc.metrics.snapshot(engine)["staleness_rounds"] == 0
        reg.publish(base_params(3.0), round_idx=10)  # training moves on
        snap = svc.metrics.snapshot(engine)
    assert snap["staleness_rounds"] == 7  # live at read time, not swap


def test_registry_seeded_engine_reports_staleness_before_any_swap(
        tmp_path):
    """The never-swapped window: an engine seeded with its REGISTRY
    version (the documented load(version=) flow) watches itself fall
    behind as training publishes, before any rollout ever runs."""
    from fedamw_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path / "ck"), base_params(), round_idx=2,
                    extra={"eval_acc": 50.0})
    reg = ModelRegistry()
    live_v = reg.publish_checkpoint(str(tmp_path / "ck"))
    engine = ServingEngine.load(str(tmp_path / "ck"), buckets=(1, 8),
                                version=live_v)
    engine.warmup()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        RolloutController(svc, reg, mode="shadow", fraction=0.5,
                          min_requests=10 ** 6)
        assert svc.metrics.snapshot(engine)["staleness_rounds"] == 0
        reg.publish(base_params(2.0), round_idx=9)
        snap = svc.metrics.snapshot(engine)
    assert snap["model_version"] == live_v
    assert snap["staleness_rounds"] == 7  # behind, with zero swaps


def test_snapshot_counts_broken_staleness_lookup():
    """GL006 regression (graftlint): a raising ``staleness_of`` keeps
    degrading to the swap-time value — but the failure is COUNTED
    (``staleness_errors``), never silently swallowed; a dead registry
    hookup must not read as a permanently-current service."""
    from fedamw_tpu_torch.serving import ServeMetrics

    m = ServeMetrics()
    m.record_swap(version=3, staleness_rounds=2)

    def broken(_version):
        raise KeyError("registry lost the version")

    m.staleness_of = broken
    snap = m.snapshot()
    assert snap["staleness_rounds"] == 2  # swap-time value survives
    assert snap["staleness_errors"] == 1
    assert m.snapshot()["staleness_errors"] == 2  # counts per lookup
    m.staleness_of = lambda v: 9  # recovered source wins again
    snap = m.snapshot()
    assert snap["staleness_rounds"] == 9
    assert snap["staleness_errors"] == 2  # no new error


def test_span_staleness_counts_broken_router_lookup():
    """GL006 regression (graftlint): a router whose
    ``staleness_rounds`` raises must not take the request span down —
    the span reports staleness 0 and the failure lands in
    ``staleness_errors``."""
    engine = make_engine()
    rng = np.random.RandomState(13)
    X = rng.randn(4, D).astype(np.float32)
    tracer = Tracer(enabled=True)

    class _BrokenRouter:
        def split(self):
            return None

        def staleness_rounds(self, version):
            raise RuntimeError("registry connection lost")

    with ServingService(engine, max_wait_ms=0.5, tracer=tracer) as svc:
        svc.router = _BrokenRouter()
        out = svc.predict(X)
    assert out.shape == (4, C)
    spans = [r for r in tracer.records() if r["kind"] == "span"
             and r["name"] == "request"]
    assert len(spans) == 1  # the span still landed
    assert spans[0]["attrs"]["staleness_rounds"] == 0
    assert svc.metrics.staleness_errors >= 1


def test_second_concurrent_stage_is_refused():
    engine = make_engine()
    reg = ModelRegistry()
    v1 = reg.publish(base_params(2.0), round_idx=1)
    v2 = reg.publish(base_params(3.0), round_idx=2)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                                min_requests=10 ** 6)
        assert ctl.stage(v1)
        with pytest.raises(RuntimeError, match="in flight"):
            ctl.stage(v2)
        ctl.rollback("test done")
        assert ctl.stage(v2)  # slot free again after rollback
        ctl.rollback("test done")


def test_continuous_promote_loop_bounds_installed_versions():
    """The headline long-lived scenario: one stage->promote per
    published round. The engine must hold at most live + one prior
    (for revert) on device — never every version it ever served."""
    engine = make_engine()
    reg = ModelRegistry()
    X = np.random.RandomState(5).randn(2, D).astype(np.float32)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                                min_requests=0)  # direct verified deploy
        for k in range(1, 6):
            v = reg.publish(base_params(float(k + 1)), round_idx=k)
            assert ctl.stage(v)
            assert engine.version == v
            assert len(engine.versions_installed) <= 2
        out = svc.predict(X)
    # prior kept for revert, everything older retired
    assert engine.versions_installed == [4, 5]
    np.testing.assert_allclose(out, engine.predict(X, version=5))
    prev = ctl.revert()
    assert prev == 4 and engine.version == 4
    # the reverted-away version is retired (the memory bound holds
    # through reverts) and the one-shot prior slot is consumed
    assert engine.versions_installed == [4]
    with pytest.raises(RuntimeError, match="prior"):
        ctl.revert()


def test_every_request_span_carries_version_and_staleness():
    engine = make_engine()
    rng = np.random.RandomState(17)
    X = rng.randn(64, D).astype(np.float32)
    y = _labels_for(engine, X)
    reg = ModelRegistry()
    reg.publish(base_params(), round_idx=1)  # makes v0 stale by publish
    cand = reg.publish(base_params(2.0), round_idx=4,
                       metadata={"eval_acc": 100.0})
    tracer = Tracer()
    payload = X[:2]
    with ServingService(engine, max_wait_ms=0.5, tracer=tracer) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=0.5,
                                min_requests=0, parity_data=(X, y))
        n_before = 6
        for _ in range(n_before):
            svc.predict(payload)
        ctl.stage(cand)  # min_requests=0: immediate verified deploy
        assert engine.version == cand
        for _ in range(6):
            svc.predict(payload)
        # a deadline-shed request must carry the dimensions too
        dead = svc.submit(payload, timeout_s=0.0)
        with pytest.raises(Exception):
            dead.result(timeout=30)
    spans = [r for r in tracer.records() if r["name"] == "request"]
    assert len(spans) == 13
    for s in spans:
        assert "model_version" in s["attrs"], s
        assert "staleness_rounds" in s["attrs"], s
        assert s["attrs"]["staleness_rounds"] >= 0
    served_by = {s["attrs"]["model_version"] for s in spans
                 if s["attrs"]["outcome"] == "ok"}
    assert cand in served_by  # post-swap traffic attributed to it
    # the promoted candidate is the newest publish: staleness 0
    post = [s for s in spans if s["attrs"]["model_version"] == cand]
    assert all(s["attrs"]["staleness_rounds"] == 0 for s in post)
    snap = svc.metrics.snapshot(engine)
    assert snap["model_version"] == cand
    assert snap["staleness_rounds"] == 0


def test_swap_atomic_under_concurrent_submit_zero_recompiles():
    """Rapid swaps against concurrent submitters: every result must be
    EXACTLY one installed version's output — params and rff of
    different versions can never mix (versions differ in BOTH, so any
    torn read would produce an output matching neither) — and the
    compiled ladder never grows."""
    rng = np.random.RandomState(2)
    W = rng.randn(8, D).astype(np.float32)
    b = rng.randn(D).astype(np.float32)
    params = {"w": rng.randn(C, D).astype(np.float32)}
    engine = ServingEngine(params, rff=(W, b), buckets=(1, 8))
    engine.warmup()
    X = rng.randn(4, 8).astype(np.float32)
    # version k: params scaled by (k+1) AND a shifted rff offset
    for k in (1, 2, 3):
        engine.install_weights(
            k, {"w": (k + 1.0) * params["w"]}, rff=(W, b + k))
    expected = {k: engine.predict(X, version=k) for k in (0, 1, 2, 3)}
    cc = engine.compile_count
    stop = threading.Event()
    failures: list = []

    def swapper():
        k = 0
        while not stop.is_set():
            engine.swap_weights(version=k % 4)
            k += 1

    with ServingService(engine, max_wait_ms=0.2) as svc:
        th = threading.Thread(target=swapper)
        th.start()
        try:
            futs = [svc.submit(X) for _ in range(200)]
            for f in futs:
                out = f.result(timeout=60)
                if not any(np.allclose(out, e, **ROWS)
                           for e in expected.values()):
                    failures.append(out)
        finally:
            stop.set()
            th.join()
    assert not failures, (
        f"{len(failures)} results matched NO installed version — "
        "a torn params/rff read escaped the swap lock")
    assert engine.compile_count == cc


class _FailOnce(ServingEngine):
    """First dispatch raises a transient error; later ones serve."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fail_next = False

    def predict(self, X, version=None):
        if self.fail_next:
            self.fail_next = False
            raise ConnectionError("remote tunnel blip")
        return super().predict(X, version=version)


def test_retry_re_resolves_live_version_across_a_swap():
    """A request queued against version k whose dispatch hits a
    transient failure, with a hot swap landing during the retry
    backoff, must be answered by the NEW live version — the retry
    re-resolves instead of dispatching against a half-swapped
    engine."""
    rng = np.random.RandomState(3)
    engine = _FailOnce(base_params(), buckets=(1, 8))
    engine.warmup()
    X = rng.randn(2, D).astype(np.float32)
    out_old = engine.predict(X)
    with ServingService(engine, max_wait_ms=0.2, retries=2,
                        retry_backoff_ms=150.0) as svc:
        engine.fail_next = True
        fut = svc.submit(X)
        time.sleep(0.03)  # let the worker dispatch, fail, start backoff
        engine.swap_weights(base_params(2.0))  # swap DURING the backoff
        out = fut.result(timeout=60)
    np.testing.assert_allclose(out, 2 * out_old, rtol=1e-5)
    assert svc.metrics.retries == 1
    assert svc.metrics.requests_retried == 1


def _staged_ramp_controller(svc, reg, **ramp_kw):
    """A staged candidate under a ramping controller, with
    min_requests high enough that observe() never promotes during the
    ramp assertions (the ramp is about EXPOSURE, not survival)."""
    cand = reg.publish(base_params(2.0), round_idx=3)
    ctl = RolloutController(svc, reg, mode="ab", min_requests=10_000,
                            error_budget=2, **ramp_kw)
    assert ctl.stage(cand) is True
    return ctl, cand


def test_ramp_grows_fraction_on_error_free_windows():
    """Each error-free ramp_every-dispatch window multiplies the split
    by ramp_factor, capped at max_fraction — exposure is EARNED from
    the observed error budget, not scheduled."""
    engine = make_engine()
    reg = ModelRegistry()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl, cand = _staged_ramp_controller(
            svc, reg, fraction=0.1, ramp_every=10, ramp_factor=2.0,
            max_fraction=0.8)
        assert ctl.split() == (cand, 0.1, "ab")
        ctl.observe(cand, served=10)
        assert ctl.split()[1] == pytest.approx(0.2)
        ctl.observe(cand, served=4)   # mid-window: no growth yet
        assert ctl.split()[1] == pytest.approx(0.2)
        ctl.observe(cand, served=6)   # window completes error-free
        assert ctl.split()[1] == pytest.approx(0.4)
        ctl.observe(cand, served=10)
        assert ctl.split()[1] == pytest.approx(0.8)  # capped
        ctl.observe(cand, served=10)
        assert ctl.split()[1] == pytest.approx(0.8)  # stays capped
        ramps = [e for e in ctl.events if e["event"] == "ramped"]
        assert [e["fraction"] for e in ramps] == \
            [pytest.approx(f) for f in (0.2, 0.4, 0.8)]
        ctl.rollback("test done")


def test_ramp_window_with_error_holds_fraction():
    """A window that observed a candidate error (still within the
    budget) holds the current exposure; the NEXT error-free window
    grows it again. Exceeding the budget still rolls the canary back
    from whatever fraction the ramp reached."""
    engine = make_engine()
    reg = ModelRegistry()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl, cand = _staged_ramp_controller(
            svc, reg, fraction=0.25, ramp_every=8, ramp_factor=2.0)
        ctl.observe(cand, served=7, errors=1)  # window closes dirty
        assert ctl.split()[1] == pytest.approx(0.25)  # held, not grown
        ctl.observe(cand, served=8)            # clean window
        assert ctl.split()[1] == pytest.approx(0.5)
        # budget exceeded (error_budget=2): full rollback, ramp or not
        ctl.observe(cand, served=2, errors=2)
        assert ctl.split() is None
        assert ctl.events[-1]["event"] == "rollback"


def test_ramp_restarts_at_base_fraction_for_each_candidate():
    """A new stage() must re-earn exposure from the configured base —
    the prior rollout's grown fraction was ITS trust, not the next
    candidate's."""
    engine = make_engine()
    reg = ModelRegistry()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl, cand = _staged_ramp_controller(
            svc, reg, fraction=0.1, ramp_every=5, ramp_factor=4.0)
        ctl.observe(cand, served=5)
        assert ctl.split()[1] == pytest.approx(0.4)
        ctl.rollback("operator")
        cand2 = reg.publish(base_params(3.0), round_idx=4)
        assert ctl.stage(cand2) is True
        assert ctl.split() == (cand2, pytest.approx(0.1), "ab")
        ctl.rollback("test done")


def test_ramp_growth_keeps_assigned_ids_assigned():
    """The ramp composes with the deterministic hash split: growing
    the fraction is monotone — every id on the candidate at the
    smaller split is still on it at the larger one (no flapping
    mid-ramp), which is the property that makes a ramped rollout's
    per-id behavior reproducible."""
    ids = [f"req-{i}" for i in range(400)]
    fractions = [0.1, 0.2, 0.4, 0.8, 1.0]
    assigned = [{i for i in ids if assigned_to_candidate(i, f)}
                for f in fractions]
    for smaller, larger in zip(assigned, assigned[1:]):
        assert smaller <= larger
    # and the ramp actually exposes more traffic at each step
    assert all(len(a) < len(b) for a, b in zip(assigned, assigned[1:]))


def test_ramp_constructor_validation():
    engine = make_engine()
    reg = ModelRegistry()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        with pytest.raises(ValueError, match="ramp_every"):
            RolloutController(svc, reg, ramp_every=0)
        with pytest.raises(ValueError, match="ramp_factor"):
            RolloutController(svc, reg, ramp_every=5, ramp_factor=1.0)
        with pytest.raises(ValueError, match="max_fraction"):
            RolloutController(svc, reg, fraction=0.5, ramp_every=5,
                              max_fraction=0.25)
        # the slot must be clean after refused constructions
        ctl = RolloutController(svc, reg, ramp_every=5)
        assert ctl.status()["ramp_every"] == 5
        ctl.detach()


def test_ramp_batched_report_closes_multiple_windows():
    """A single batched observe() carries its residual across window
    boundaries: served=25 at ramp_every=10 closes two windows (two
    growth steps) and leaves 5 dispatches toward the third — a
    reset-to-zero would silently stretch the configured schedule for
    workers that report in large batches."""
    engine = make_engine()
    reg = ModelRegistry()
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl, cand = _staged_ramp_controller(
            svc, reg, fraction=0.1, ramp_every=10, ramp_factor=2.0)
        ctl.observe(cand, served=25)
        assert ctl.split()[1] == pytest.approx(0.4)  # two windows
        ctl.observe(cand, served=5)                  # residual + 5
        assert ctl.split()[1] == pytest.approx(0.8)
        ctl.rollback("test done")


class _ThreadRecordingEngine(ServingEngine):
    """Records which thread ran every CANDIDATE-version dispatch."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.candidate_threads: list = []

    def predict(self, X, version=None, record_timings=True):
        if version is not None:
            self.candidate_threads.append(
                threading.current_thread().name)
        return super().predict(X, version=version,
                               record_timings=record_timings)


def test_shadow_probe_runs_off_the_worker_thread():
    """Shadow warm dispatch must ride the
    dedicated probe thread, never the serving worker (where it would
    serialize candidate dispatch behind live traffic) — and every
    accepted probe is still processed before stop() returns, so the
    post-stop snapshot carries the full shadow count."""
    engine = _ThreadRecordingEngine(base_params(), buckets=(1, 8, 32))
    engine.warmup()
    rng = np.random.RandomState(17)
    reg = ModelRegistry()
    cand = reg.publish(base_params(2.0), round_idx=1)
    payload = rng.randn(2, D).astype(np.float32)
    with ServingService(engine, max_wait_ms=0.5) as svc:
        ctl = RolloutController(svc, reg, mode="shadow", fraction=1.0,
                                min_requests=10 ** 6)  # never promotes
        assert ctl.stage(cand) is True
        for f in [svc.submit(payload) for _ in range(12)]:
            f.result(timeout=30)
    snap = svc.metrics.snapshot(engine)
    # every probe landed (stop drains the probe queue before joining)
    assert snap["shadow_requests"] == 12
    assert snap["shadow_probes_dropped"] == 0
    assert engine.candidate_threads  # probes actually dispatched
    assert set(engine.candidate_threads) == {"serve-shadow-probe"}
    ctl.rollback("test done")


# -- checkpoint watcher


def _write_ckpt(path, seed=0, round_idx=1):
    from fedamw_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.RandomState(seed)
    save_checkpoint(str(path),
                    {"w": rng.randn(C, D).astype(np.float32)},
                    round_idx=round_idx)


def test_watcher_publishes_in_round_order_and_dedupes(tmp_path):
    _write_ckpt(tmp_path / "v0002", seed=2, round_idx=2)
    _write_ckpt(tmp_path / "v0001", seed=1, round_idx=1)
    (tmp_path / "not_a_version").mkdir()
    reg = ModelRegistry()
    w = CheckpointWatcher(reg, str(tmp_path), poll_interval_s=0.02)
    out = w.poll_once()
    assert len(out) == 2
    # ingested in ROUND order (the numeric suffix), so staleness
    # accounting stays monotone: v0001 first
    assert [name for name, _ in w.published] == ["v0001", "v0002"]
    assert reg.get(out[0]).round_idx == 1
    assert reg.get(out[1]).round_idx == 2
    assert w.poll_once() == [] and len(reg) == 2  # seen: no re-publish
    assert w.errors == 0


def test_watcher_retries_damaged_entry_until_it_loads(tmp_path):
    (tmp_path / "v0001").mkdir()  # a checkpoint "mid-write": no state
    _write_ckpt(tmp_path / "v0002", seed=2, round_idx=2)
    reg = ModelRegistry()
    w = CheckpointWatcher(reg, str(tmp_path), poll_interval_s=0.02)
    # the damaged entry STOPS the poll: v0002 waits behind it, else
    # the recovered v0001 would later take a higher registry version
    # and latest() would regress to the round-1 model
    assert w.poll_once() == [] and w.errors == 1
    assert len(reg) == 0
    _write_ckpt(tmp_path / "v0001", round_idx=1)  # the write completes
    out = w.poll_once()  # retried, never marked seen — then v0002
    assert len(out) == 2
    assert [name for name, _ in w.published] == ["v0001", "v0002"]
    assert reg.latest().round_idx == 2


def test_watcher_daemon_lifecycle_and_clean_shutdown(tmp_path):
    reg = ModelRegistry()
    seen = []
    with pytest.raises(ValueError, match="poll_interval_s"):
        CheckpointWatcher(reg, str(tmp_path), poll_interval_s=0.0)
    with CheckpointWatcher(
            reg, str(tmp_path / "later"), poll_interval_s=0.02,
            on_publish=lambda v, p: seen.append(v)) as w:
        with pytest.raises(RuntimeError, match="already started"):
            w.start()
        # the directory does not exist yet (training starts later):
        # a normal startup state, not an error
        time.sleep(0.05)
        assert w.errors == 0 and w.polls >= 1
        (tmp_path / "later").mkdir()
        _write_ckpt(tmp_path / "later" / "v0003", round_idx=3)
        deadline = time.time() + 5
        while not w.published and time.time() < deadline:
            time.sleep(0.01)
        assert [n for n, _ in w.published] == ["v0003"]
        assert seen == [w.published[0][1]]
    assert w._thread is None  # joined
    w.stop()  # idempotent


def test_watcher_on_publish_errors_counted_not_fatal(tmp_path):
    _write_ckpt(tmp_path / "v0001", round_idx=1)
    _write_ckpt(tmp_path / "v0002", round_idx=2)
    reg = ModelRegistry()

    def boom(v, path):
        raise RuntimeError("subscriber bug")

    w = CheckpointWatcher(reg, str(tmp_path), poll_interval_s=0.02,
                          on_publish=boom)
    out = w.poll_once()
    # the callback's failure never blocks ingestion: both published,
    # both errors counted
    assert len(out) == 2 and len(reg) == 2 and w.errors == 2


def test_watcher_refuses_the_artifact_plane(tmp_path):
    """The watcher's artifact options are carried
    (``tests/test_torch_serve_artifacts.py`` exports with them); what it
    refuses is the JAX watcher's: ``artifact_keep`` below 1, which would
    delete the export that just landed. The other options are taken as
    given."""
    reg = ModelRegistry()
    for keep in (0, -1):
        with pytest.raises(ValueError, match="artifact_keep"):
            CheckpointWatcher(reg, str(tmp_path),
                              artifact_dir=str(tmp_path / "art"),
                              artifact_keep=keep)
    protect = lambda: ()  # noqa: E731
    w = CheckpointWatcher(reg, str(tmp_path),
                          artifact_dir=str(tmp_path / "art"),
                          artifact_buckets=[1, 8], artifact_keep=2,
                          artifact_protect=protect, device="cpu")
    assert (w.artifact_dir, w.artifact_buckets, w.artifact_keep) == (
        str(tmp_path / "art"), (1, 8), 2)
    assert w.artifact_protect is protect
    assert w.artifacts == [] and w.artifacts_pruned == []


def test_registry_reads_a_jax_checkpoint(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote in its pickle layout publishes
    here with its markers, and serves through the port's engine."""
    import sys

    from fedamw_tpu.utils.checkpoint import save_checkpoint as jsave

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(C, D).astype(np.float32)}
    rff = (rng.randn(8, D).astype(np.float32),
           rng.randn(1, D).astype(np.float32))
    jsave(str(tmp_path / "v0004"), params, round_idx=4, rff=rff,
          extra={"eval_acc": 91.5}, feature_dtype="bfloat16")
    reg = ModelRegistry()
    w = CheckpointWatcher(reg, str(tmp_path), poll_interval_s=0.02)
    (v,) = w.poll_once()
    entry = reg.get(v)
    assert (entry.round_idx, entry.eval_acc) == (4, 91.5)
    assert entry.metadata["feature_dtype"] == "bfloat16"
    engine = ServingEngine(entry.params, rff=entry.rff, buckets=(8,),
                           feature_dtype=entry.metadata["feature_dtype"])
    assert engine.input_dim == 8
    assert engine.predict(np.zeros((3, 8), np.float32)).shape == (3, C)
