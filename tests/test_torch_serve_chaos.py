"""The port's chaos plane against the JAX package's, on the CPU.

``fedamw_tpu_torch.serving.chaos`` is a copy of the JAX package's
``serving/chaos.py``: the same grammars expand through the same seeded
numpy generators, so every plan must equal the JAX plan exactly, cell
for cell (the failover and pod schedules of both packages are the same
schedule). Held here: ``ChaosPlan.build``/``scripted``, ``NetChaosPlan``
(its role matrix, kills, announce races, forged peers and counts),
``LoadSpec.offsets`` and ``rate``, the parsed specs field for field, the
resolvers, and every parse or validation error: the same exception type
and message in both packages. Exact comparisons throughout: a plan is
data, not a float result.
"""

import dataclasses

import numpy as np
import pytest

import fedamw_tpu.serving.chaos as jchaos
import fedamw_tpu_torch.serving.chaos as tchaos
from torch_threads import one_torch_thread  # noqa: F401

CHAOS_SPECS = [
    "kill=0.01,wedge=0.02:0.5,flaky=0.05,slow=0.1:4.0,seed=7",
    "kill=0.03,flaky=0.1,seed=11",
    "wedge=0.1,slow=0.2",
    "flaky=0.3,seed=123456",
    "",
]

NET_SPECS = [
    "partition=0.02:250,refuse=0.05,lag=0.1:20,kill_host=1@12,seed=7",
    "refuse=0.2,seed=3",
    "lag=0.5:5,kill_host=0@3,kill_host=2@9,seed=19",
    "restart_during_announce=0@1,forge_sync=2@120,partition=0.1",
    "",
]

LOAD_SPECS = [
    "shape=flash,base=200,peak=1600,duration=6,at=0.35,width=0.25,seed=17",
    "shape=diurnal,base=50,peak=400,duration=3,seed=2",
    "shape=overload,base=100,peak=900,duration=2,at=0.5,seed=5",
]


def _same_error(fn_j, fn_t):
    """Both callables raise the same exception type with the same
    message."""
    with pytest.raises(Exception) as ej:
        fn_j()
    with pytest.raises(Exception) as et:
        fn_t()
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("text", CHAOS_SPECS)
@pytest.mark.parametrize("n, horizon", [(3, 64), (4, 4096)])
def test_chaos_plan_build_equals_jax(text, n, horizon):
    js, ts = jchaos.ChaosSpec.parse(text), tchaos.ChaosSpec.parse(text)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    jp = jchaos.ChaosPlan.build(js, n, horizon)
    tp = tchaos.ChaosPlan.build(ts, n, horizon)
    assert tp.roles.dtype == jp.roles.dtype
    np.testing.assert_array_equal(tp.roles, jp.roles)
    assert (tp.wedge_s, tp.slow_mult, tp.n_replicas, tp.horizon) == (
        jp.wedge_s, jp.slow_mult, jp.n_replicas, jp.horizon)
    assert tp.kills_planned() == jp.kills_planned()
    for r in range(n):
        assert tp.kill_at(r) == jp.kill_at(r)
        assert [tp.role(r, k) for k in (0, 5, horizon - 1, horizon + 9)] \
            == [jp.role(r, k) for k in (0, 5, horizon - 1, horizon + 9)]


@pytest.mark.parametrize("kw", [
    dict(kills={0: 50}, wedges={1: [20, 80]}, flaky={2: [10, 30, 60]},
         slow={3: range(5, 41)}, wedge_s=0.05, slow_mult=3.0),
    dict(kills={1: 2, 2: 5}, wedges={0: [3]}, wedge_s=0.25,
         horizon=65536),
    dict(flaky={0: [0, 1]}, horizon=16),
])
def test_chaos_plan_scripted_equals_jax(kw):
    jp = jchaos.ChaosPlan.scripted(4, **kw)
    tp = tchaos.ChaosPlan.scripted(4, **kw)
    np.testing.assert_array_equal(tp.roles, jp.roles)
    assert tp.kills_planned() == jp.kills_planned()
    assert (tp.wedge_s, tp.slow_mult, tp.horizon) == (
        jp.wedge_s, jp.slow_mult, jp.horizon)


@pytest.mark.parametrize("text", NET_SPECS)
def test_net_chaos_plan_equals_jax(text):
    js = jchaos.NetChaosSpec.parse(text)
    ts = tchaos.NetChaosSpec.parse(text)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    jp = jchaos.NetChaosPlan.build(js, 3, horizon=512)
    tp = tchaos.NetChaosPlan.build(ts, 3, horizon=512)
    np.testing.assert_array_equal(tp.roles, jp.roles)
    assert (tp.partition_s, tp.lag_s, tp.kills, tp.announce_restarts,
            tp.forges) == (jp.partition_s, jp.lag_s, jp.kills,
                           jp.announce_restarts, jp.forges)
    assert tp.counts() == jp.counts()
    for h in range(3):
        assert (tp.kill_at(h), tp.announce_restart_at(h),
                tp.forge_at(h)) == (jp.kill_at(h),
                                    jp.announce_restart_at(h),
                                    jp.forge_at(h))
    # the resolver builds the same plan from the same string
    np.testing.assert_array_equal(
        tchaos.resolve_net_chaos(text, 3, 64).roles,
        jchaos.resolve_net_chaos(text, 3, 64).roles)


def test_net_chaos_scripted_equals_jax():
    kw = dict(partitions={0: [1, 4]}, refuses={1: [0]}, lags={2: [2, 3]},
              kills={0: 20}, partition_s=0.02, lag_s=0.01)
    jp = jchaos.NetChaosPlan.scripted(3, **kw)
    tp = tchaos.NetChaosPlan.scripted(3, **kw)
    np.testing.assert_array_equal(tp.roles, jp.roles)
    assert tp.kills == jp.kills and tp.counts() == jp.counts()


@pytest.mark.parametrize("text", LOAD_SPECS)
def test_load_spec_offsets_equal_jax(text):
    js, ts = jchaos.LoadSpec.parse(text), tchaos.LoadSpec.parse(text)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    to, jo = ts.offsets(), js.offsets()
    assert to.dtype == jo.dtype and to.size > 0
    np.testing.assert_array_equal(to, jo)
    for t in np.linspace(-0.1, js.duration_s + 0.1, 23):
        assert ts.rate(float(t)) == js.rate(float(t))


@pytest.mark.parametrize("cls, text", [
    ("ChaosSpec", "boom=1"), ("ChaosSpec", "kill"),
    ("ChaosSpec", "kill=lots"), ("ChaosSpec", "kill=1.5"),
    ("ChaosSpec", "kill=0.6,flaky=0.6"), ("ChaosSpec", "wedge=0.1:0"),
    ("ChaosSpec", "slow=0.1:0.5"), ("ChaosSpec", "seed=x"),
    ("NetChaosSpec", "boom=1"), ("NetChaosSpec", "kill_host=1"),
    ("NetChaosSpec", "kill_host=0@1,kill_host=0@2"),
    ("NetChaosSpec", "partition=0.7,refuse=0.5"),
    ("NetChaosSpec", "partition=0.1:0"), ("NetChaosSpec", "lag=0.1:-5"),
    ("NetChaosSpec", "forge_sync=1@0"),
    ("NetChaosSpec", "restart_during_announce=0"),
    ("LoadSpec", "shape=square"), ("LoadSpec", "base=0"),
    ("LoadSpec", "base=10,peak=5"), ("LoadSpec", "at=2"),
    ("LoadSpec", "shape=flash,at=0.9,width=0.2"), ("LoadSpec", "what=1"),
    ("LoadSpec", "duration"),
])
def test_parse_errors_raise_the_jax_type_and_message(cls, text):
    _same_error(lambda: getattr(jchaos, cls).parse(text),
                lambda: getattr(tchaos, cls).parse(text))


def test_plan_validation_and_resolvers_match_jax():
    for mod_call in (
            lambda m: m.ChaosPlan.scripted(2, kills={0: 1},
                                           flaky={0: [1]}),
            lambda m: m.ChaosPlan.scripted(2, kills={5: 0}),
            lambda m: m.ChaosPlan.scripted(2, kills={0: 9}, horizon=4),
            lambda m: m.ChaosPlan(np.zeros(3)),
            lambda m: m.ChaosPlan(np.full((2, 2), 9)),
            lambda m: m.ChaosPlan.build(m.ChaosSpec(), 0),
            lambda m: m.NetChaosPlan.scripted(2, refuses={0: [1]},
                                              lags={0: [1]}),
            lambda m: m.NetChaosPlan(np.zeros((1, 2)), kills={0: -1}),
            lambda m: m.resolve_chaos_plan(42, 3),
            lambda m: m.resolve_chaos_plan(
                m.ChaosPlan.build(m.ChaosSpec(flaky=0.2), 3, 8), 5),
            lambda m: m.resolve_net_chaos(3.5, 2),
            lambda m: m.resolve_net_chaos(
                m.NetChaosPlan.build(m.NetChaosSpec(), 1), 2)):
        _same_error(lambda: mod_call(jchaos), lambda: mod_call(tchaos))
    assert tchaos.resolve_chaos_plan(None, 3) is None
    assert tchaos.resolve_net_chaos(None, 3) is None
    plan = tchaos.resolve_chaos_plan("kill=0.5,seed=3", 2, horizon=16)
    np.testing.assert_array_equal(
        plan.roles, jchaos.resolve_chaos_plan("kill=0.5,seed=3", 2,
                                              horizon=16).roles)
    assert tchaos.resolve_chaos_plan(plan, 2) is plan
    # the role codes are the JAX package's
    for name in ("CLEAN", "KILL", "WEDGE", "FLAKY", "SLOW", "NET_CLEAN",
                 "NET_PARTITION", "NET_REFUSE", "NET_LAG"):
        assert getattr(tchaos, name) == getattr(jchaos, name)
    assert issubclass(tchaos.ChaosFault, ConnectionError)
