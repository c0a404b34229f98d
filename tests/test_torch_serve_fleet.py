"""The port's serving fleet against the JAX package's, on the CPU: the
failover router over replicas, the autoscaler over a real router, and
the learned rung ladder.

``fedamw_tpu_torch.serving.replica`` and ``ladder`` are copies of the
JAX package's modules, over the port's ``ServingEngine``. Held here:

- **Replica.** A ``round_robin`` router over 3 replicas under one
  scripted ``ChaosPlan`` (a kill, flaky cells, slow cells) drives the
  same request sequence over the JAX engine and over the port's: the
  answering replica and the failovers of every request, the router's
  final counters and health states are equal, and the logits within
  1e-5 with the argmax equal (``PERF.md`` § 2: the same float32
  products in another summation order). ``NoReplicasAvailable`` and
  ``ReplicaUnavailable`` raise where the JAX router raises them. A
  hedged mirror answers a wedged dispatch with the primary's bits.
- **Control.** The autoscaler adds replicas to a real router, the added
  replica serves traffic, and scale-in takes it out.
- **Ladder.** ``learn_ladder``, ``ladder_waste`` and a
  ``LadderLearner``'s proposals, charges and freezes equal the JAX
  package's on the same size streams; ``apply_proposal`` moves the
  engine's ``compile_count`` by exactly the rungs it installed.

Chaos stalls stay at tens of milliseconds. A ``cuda`` case holds a
hedged router's replies on the card bitwise to the fp32 forward with
TF32 allowed process-wide.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import fedamw_tpu.serving as jserving
import fedamw_tpu_torch.serving as tserving
from fedamw_tpu_torch.serving import (ChaosPlan, FailoverRouter,
                                      LadderLearner, Replica, ReplicaSet,
                                      ServeMetrics, ServingService,
                                      apply_proposal)
from fedamw_tpu_torch.utils.telemetry import Registry
from torch_threads import one_torch_thread  # noqa: F401

D, C = 16, 3
BUCKETS = (1, 8, 32)
TOL = dict(rtol=1e-5, atol=1e-5)
FIXED = (1, 8, 64, 512, 4096)


def _params(seed=1):
    return {"w": np.random.RandomState(seed).randn(C, D).astype(np.float32)}


def _engine(params=None, buckets=BUCKETS):
    e = tserving.ServingEngine(params or _params(), buckets=buckets,
                               device="cpu")
    e.warmup()
    return e


def _jengine(params=None, buckets=BUCKETS):
    e = jserving.ServingEngine(params or _params(), buckets=buckets)
    e.warmup()
    return e


def rows(n, seed=5):
    return np.random.RandomState(seed).randn(n, D).astype(np.float32)


# -- the router against the JAX router -----------------------------------------

SIZES = [3, 1, 8, 20, 5, 2, 32, 7, 40, 1, 9, 4, 16, 2, 6, 30, 1, 3]


def _drive(mod, engine):
    """The same request sequence through a round-robin router under one
    scripted plan: per request (answering replica, failovers, logits or
    the error's type name), then the router's counters."""
    plan = mod.ChaosPlan.scripted(3, kills={0: 3}, flaky={1: [1, 4]},
                                  slow={2: [0, 2, 3]}, slow_mult=1.5,
                                  horizon=64)
    trail, outs = [], []
    with mod.FailoverRouter(mod.ReplicaSet(engine, 3, chaos=plan),
                            policy="round_robin") as router:
        for k, n in enumerate(SIZES):
            try:
                out = router.predict(rows(n, seed=k))
            except Exception as e:  # compared by type below
                trail.append(type(e).__name__)
                continue
            t = router.pop_timings()
            trail.append((t["replica"], t["failovers"], t["bucket"]))
            outs.append(out)
        stats = _untimed(router.replica_stats())
    dispatches = [r.dispatches for r in router.replicas]
    return trail, outs, stats, dispatches


def _untimed(stats):
    """``replica_stats`` without the latency EWMA (a host time)."""
    for rep in stats["replicas"].values():
        assert rep.pop("ewma_ms") is None or rep["ok"] > 0
    return stats


def test_router_under_chaos_answers_as_the_jax_router():
    t_trail, t_outs, t_stats, t_disp = _drive(tserving, _engine())
    j_trail, j_outs, j_stats, j_disp = _drive(jserving, _jengine())
    assert t_trail == j_trail
    assert t_stats == j_stats
    assert t_disp == j_disp
    # the schedule fired: a kill, requeues, a flaky failure
    assert t_stats["dead_replicas"] == 1 and t_stats["requeues"] >= 2
    assert t_stats["replicas"]["0"]["state"] == "dead"
    for got, want in zip(t_outs, j_outs):
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", ["all_dead", "every_survivor_failed",
                                  "deadline_passed", "circuit_open"])
def test_router_raises_where_the_jax_router_raises(case):
    def run(mod, engine):
        kw = {}
        if case == "all_dead":
            plan = mod.ChaosPlan.scripted(2, kills={0: 0, 1: 0}, horizon=8)
        elif case == "every_survivor_failed":
            plan = mod.ChaosPlan.scripted(2, flaky={0: [0], 1: [0]},
                                          horizon=8)
        elif case == "circuit_open":
            plan = mod.ChaosPlan.scripted(1, flaky={0: [0, 1]}, horizon=8)
            kw = dict(failure_threshold=2, cooldown_s=30.0)
        else:
            plan = None
        n = 1 if case == "circuit_open" else 2
        router = mod.FailoverRouter(mod.ReplicaSet(engine, n, chaos=plan),
                                    policy="round_robin", **kw)
        seen = []
        for _ in range(3):
            deadline = (time.perf_counter() - 1.0
                        if case == "deadline_passed" else None)
            try:
                router.predict(rows(2), deadline=deadline)
                seen.append("ok")
            except Exception as e:
                seen.append((type(e).__name__, isinstance(
                    e, ConnectionError)))
        return seen, _untimed(router.replica_stats())

    t_seen, t_stats = run(tserving, _engine())
    j_seen, j_stats = run(jserving, _jengine())
    assert t_seen == j_seen and t_stats == j_stats
    want = {"all_dead": ("NoReplicasAvailable", False),
            "every_survivor_failed": ("ReplicaUnavailable", True),
            "deadline_passed": ("ReplicaUnavailable", True),
            "circuit_open": ("ReplicaUnavailable", True)}[case]
    assert t_seen[0] == want


def test_hedged_mirror_answers_a_wedge_with_the_primary_bits():
    """Replica 0 wedges (90 ms) once the hedge threshold is armed; the
    mirror on replica 1 answers first, with the bits the primary's
    clean dispatch gives (both dispatch the one engine under
    ``full_fp32``), and its health is untouched by the race."""
    engine = _engine()
    plan = ChaosPlan.scripted(2, wedges={0: [2]}, wedge_s=0.09, horizon=64)
    with FailoverRouter(ReplicaSet(engine, 2, chaos=plan),
                        policy="round_robin", hedge=True,
                        hedge_min_samples=4, hedge_factor=2.0,
                        hedge_floor_ms=1.0) as router:
        for k in range(4):
            router.predict(rows(2, seed=k))
        assert router._hedge_timeout_s() is not None
        X = rows(3, seed=99)
        t0 = time.perf_counter()
        out = router.predict(X)
        assert time.perf_counter() - t0 < 0.085  # before the wedge ends
        np.testing.assert_array_equal(out, engine.predict(X))
        assert router.hedges == 1 and router.hedge_wins == 1
        timing = router.pop_timings()
        assert timing["hedged"] is True and timing["replica"] == 1


def test_service_over_a_dying_fleet_loses_no_request():
    """A mid-stream kill behind ``ServingService``: every request is
    answered with its own logits, nothing added to the engine's shape
    count."""
    engine = _engine()
    cc = engine.compile_count
    plan = ChaosPlan.scripted(3, kills={0: 1}, flaky={1: [1]}, horizon=64)
    reqs = [rows(1 + k % 9, seed=k) for k in range(30)]
    outs = []
    with FailoverRouter(ReplicaSet(engine, 3, chaos=plan),
                        policy="round_robin") as router:
        with ServingService(router, max_queue=64) as svc:
            for wave in range(0, 30, 5):  # several batches
                futs = [svc.submit(x, timeout_s=30.0)
                        for x in reqs[wave:wave + 5]]
                outs += [f.result(timeout=30) for f in futs]
            snap = svc.metrics.snapshot(router)
    for x, o in zip(reqs, outs):
        np.testing.assert_allclose(o, engine.predict(x), rtol=1e-5,
                                   atol=1e-6)
    assert snap["failover"]["dead_replicas"] == 1
    assert snap["failover"]["requeues"] >= 1
    assert engine.compile_count == cc


# -- control: the autoscaler over a real router --------------------------------

def test_autoscaler_scales_out_and_in_over_a_real_router():
    from fedamw_tpu_torch.serving import Autoscaler
    from fedamw_tpu_torch.utils.telemetry import SloClass

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clk = Clock()
    classes = (SloClass("batch", threshold_ms=500.0, objective=0.95),)
    m = ServeMetrics(registry=Registry(clock=clk))
    engine = _engine()
    router = FailoverRouter([Replica(0, engine)], policy="round_robin")
    asc = Autoscaler(router, lambda rid: Replica(rid, engine), m,
                     classes=classes, window_s=5.0, max_replicas=3,
                     up_ticks=1, down_ticks=2, cooldown_s=0.0,
                     scale_down_burn=0.25, min_window_requests=10,
                     clock=clk)
    m.record_batch(20, 20, latencies=[0.9] * 8 + [0.005] * 12,
                   stage_seconds={"queue": [0.4] * 20},
                   slo_classes=["batch"] * 20)
    rec = asc.tick(clk())
    assert rec["action"] == "up" and router.fleet_size() == 2
    for k in range(4):  # the added replica takes its turn
        router.predict(rows(2, seed=k))
    assert router.replica_stats()["replicas"]["1"]["ok"] == 2
    clk.t += 30  # quiet: the bad window ages out
    asc.tick(clk())
    rec = asc.tick(clk())
    assert rec["action"] == "down" and rec["replica_id"] == 1
    assert router.fleet_size() == 1
    assert [r.replica_id for r in router.replicas] == [0]


# -- the learned ladder against the JAX package's -----------------------------

def _sizes(seed, n=400):
    rng = np.random.RandomState(seed)
    pool = [1, 2, 3, 7, 9, 17, 33, 50, 100, 250, 300, 700, 1500, 4096, 5000]
    probs = rng.dirichlet(np.ones(len(pool)))
    return [int(s) for s in rng.choice(pool, size=n, p=probs)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget, cost", [(1, 0.0), (3, 0.0), (6, 0.0),
                                          (6, 500.0)])
def test_learn_ladder_and_waste_equal_jax(seed, budget, cost):
    sizes = _sizes(seed)
    rungs = tserving.learn_ladder(sizes, budget, program_cost=cost)
    assert rungs == jserving.learn_ladder(sizes, budget, program_cost=cost)
    for ladder in (rungs, FIXED, (4, 8)):
        assert tserving.ladder_waste(sizes, ladder) == \
            jserving.ladder_waste(sizes, ladder)


def test_ladder_errors_equal_jax():
    for call in (lambda m: m.ladder_waste([0], (4, 8)),
                 lambda m: m.ladder_waste([3], ()),
                 lambda m: m.learn_ladder([], 3),
                 lambda m: m.learn_ladder([3], 0),
                 lambda m: m.LadderLearner(None, recompile_budget=-1)):
        with pytest.raises(ValueError) as ej:
            call(jserving)
        with pytest.raises(ValueError) as et:
            call(tserving)
        assert str(et.value) == str(ej.value)


def _metrics(mod, sizes):
    m = mod.ServeMetrics()
    for s in sizes:
        m.record_batch(n_requests=1, n_rows=s, latencies=[1e-4],
                       rows_per_request=[s])
    return m


@pytest.mark.parametrize("sizes, current, kw", [
    ([1, 3, 3, 5, 24, 24] * 20, (1, 8, 64), dict(max_rungs=4)),
    ([1, 3, 3, 5, 24, 24] * 20, (1, 8, 64),
     dict(max_rungs=4, recompile_budget=2)),
    ([1, 8, 64] * 30, (1, 8, 64), dict(max_rungs=3)),
    ([1, 8], (1, 8), dict(min_samples=64)),
    (_sizes(7, 300), FIXED, dict(max_rungs=6, program_cost=100.0)),
])
def test_learner_proposals_charges_and_freeze_equal_jax(sizes, current, kw):
    kw = {"min_samples": 32, **kw}
    tl = LadderLearner(_metrics(tserving, sizes).registry, **kw)
    jl = jserving.LadderLearner(_metrics(jserving, sizes).registry, **kw)
    assert tl.observed_sizes() == jl.observed_sizes()
    for _ in range(3):
        tp, jp = tl.propose(current), jl.propose(current)
        assert (tp is None) == (jp is None)
        assert tl.last_reason == jl.last_reason
        if tp is None:
            break
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        tl.charge(len(tp.install))
        jl.charge(len(jp.install))
        assert (tl.recompiles_spent, tl.budget_remaining, tl.frozen) == (
            jl.recompiles_spent, jl.budget_remaining, jl.frozen)
    tl.freeze()
    jl.freeze()
    assert tl.propose(current) is None and jl.propose(current) is None
    assert tl.last_reason == jl.last_reason


def test_apply_proposal_counts_exactly_the_installed_rungs():
    engine = _engine(buckets=(1, 8, 64))
    cc = engine.compile_count
    m = _metrics(tserving, [1, 3, 3, 5, 24, 24] * 20)
    learner = LadderLearner(m.registry, max_rungs=4, recompile_budget=8,
                            min_samples=32)
    prop = learner.propose(engine.buckets)
    assert prop is not None and prop.install
    ladder = apply_proposal(engine, prop, learner)
    assert ladder == engine.buckets == prop.rungs
    assert learner.recompiles_spent == len(prop.install)
    assert engine.compile_count == cc + len(prop.install)
    X = rows(4)
    np.testing.assert_allclose(engine.predict(X), X @ _params()["w"].T,
                               rtol=1e-5, atol=1e-5)
    assert engine.compile_count == cc + len(prop.install)


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_hedged_replies_on_the_card_are_bitwise_under_full_fp32():
    """With TF32 allowed process-wide, a hedged router's replies (the
    primary's and the mirror's, each on a pool thread) are bitwise the
    fp32 forward: every dispatch enters ``full_fp32`` on its own
    thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fedamw_tpu_torch.fedcore.aggregate import full_fp32
    from fedamw_tpu_torch.models import get_model

    model = get_model("conv4x8")
    params = model.init(torch.Generator().manual_seed(3), 64, C)
    engine = tserving.ServingEngine(params, model=model, input_dim=64,
                                    buckets=(8, 64))
    engine.warmup()
    prev = torch.get_float32_matmul_precision(), \
        torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        plan = ChaosPlan.scripted(2, wedges={0: [4, 6]}, wedge_s=0.05,
                                  horizon=64)
        with FailoverRouter(ReplicaSet(engine, 2, chaos=plan),
                            policy="round_robin", hedge=True,
                            hedge_min_samples=4,
                            hedge_floor_ms=1.0) as router:
            X = np.random.RandomState(5).randn(40, 64).astype(np.float32)
            outs = [router.predict(X) for _ in range(10)]
            assert router.hedges >= 1
        dev_params = {k: v.cuda() for k, v in params.items()}
        x = torch.from_numpy(np.concatenate(
            [X, np.zeros((24, 64), np.float32)])).cuda()
        with torch.inference_mode(), full_fp32():
            want = model.apply(dev_params, x)[:40].cpu().numpy()
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]
    for out in outs:
        np.testing.assert_array_equal(out, want)
