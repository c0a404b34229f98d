"""The port's fault plans (``fedamw_tpu_torch.fedcore.faults``) against the
JAX package's ``fedcore/faults.py``, on the CPU.

A plan is drawn on the host from ``numpy.random.RandomState(spec.seed)``
in both packages, so the port's plan is the JAX package's array for
array, with no injection. ``inject_fault_row`` is held against the JAX
twin on seeded numpy inputs to 1e-6, and its clean clients against their
own input bit for bit (the outer ``where``). Spec parsing and the plan's
checks raise the JAX package's errors, message for message.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore import faults as jf
from fedamw_tpu_torch.fedcore import faults as tf

SPECS = [
    "drop=0.1,straggle=0.2:0.5,corrupt=0.05:nan,seed=7",
    "corrupt=0.3:sign,seed=3",
    "corrupt=0.25:scale:25,drop=0.05,seed=2",
    "corrupt=0.2:inf,seed=9",
    "lie=0.2:0.01,straggle=0.2:0.25,seed=5",
    "drop=1.0",
    "",
]
PLAN_FIELDS = ("drop", "straggle", "corrupt", "lie", "scale", "poison",
               "fill", "report")


@pytest.mark.parametrize("text", SPECS)
def test_spec_parses_as_in_jax(text):
    assert dataclasses.asdict(tf.FaultSpec.parse(text)) == (
        dataclasses.asdict(jf.FaultSpec.parse(text)))


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("shape", [(6, 10), (1, 50)])
def test_plan_equals_jax_build(text, shape):
    tp = tf.FaultPlan.build(tf.FaultSpec.parse(text), *shape)
    jp = jf.FaultPlan.build(jf.FaultSpec.parse(text), *shape)
    assert (tp.rounds, tp.num_clients) == (jp.rounds, jp.num_clients)
    for k in PLAN_FIELDS:
        a, b = getattr(tp, k), getattr(jp, k)
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("start,stop", [(0, 6), (2, 5)])
def test_rows_are_the_jax_rows_on_the_device(start, stop):
    text = SPECS[0]
    tp = tf.FaultPlan.build(tf.FaultSpec.parse(text), 6, 10)
    jp = jf.FaultPlan.build(jf.FaultSpec.parse(text), 6, 10)
    trows = tp.rows(start, stop, "cpu")
    jrows = jp.rows(start, stop)
    assert len(trows) == len(jrows) == 5
    for a, b in zip(trows, jrows):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        assert a.shape == (stop - start, 10)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _row_inputs(mode, seed=0, J=7, C=3, D=5):
    """Seeded global weights, stacked client weights, losses and one plan
    row with every kind of cell."""
    rng = np.random.RandomState(seed)
    g = rng.randn(C, D).astype(np.float32)
    s = (g[None] + 0.1 * rng.randn(J, C, D)).astype(np.float32)
    losses = rng.rand(J).astype(np.float32)
    scale = np.ones(J, np.float32)
    poison = np.zeros(J, np.float32)
    fill = np.zeros(J, np.float32)
    scale[1] = 0.5                      # straggler
    if mode in ("nan", "inf"):
        poison[3] = 1.0
        fill[3] = np.nan if mode == "nan" else np.inf
    else:
        scale[3] = -1.0 if mode == "sign" else 25.0
    return g, s, losses, scale, poison, fill


@pytest.mark.parametrize("mode", ["nan", "inf", "sign", "scale"])
def test_inject_fault_row_matches_jax(mode):
    g, s, losses, scale, poison, fill = _row_inputs(mode)
    t_st, t_l = tf.inject_fault_row(
        {"w": torch.from_numpy(g)}, {"w": torch.from_numpy(s)},
        torch.from_numpy(losses), torch.from_numpy(scale),
        torch.from_numpy(poison), torch.from_numpy(fill))
    j_st, j_l = jf.inject_fault_row(
        {"w": jnp.asarray(g)}, {"w": jnp.asarray(s)}, jnp.asarray(losses),
        jnp.asarray(scale), jnp.asarray(poison), jnp.asarray(fill))
    np.testing.assert_allclose(t_st["w"].numpy(), np.asarray(j_st["w"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t_l.numpy(), np.asarray(j_l))
    # clean clients pass through bit for bit, faulty ones do not
    clean = (scale == 1.0) & (poison == 0.0)
    assert torch.equal(t_st["w"][clean], torch.from_numpy(s[clean]))
    assert not torch.equal(t_st["w"][~clean], torch.from_numpy(s[~clean]))
    if mode in ("nan", "inf"):
        assert not torch.isfinite(t_st["w"][3]).any()
        assert not np.isfinite(t_l[3].item())


BAD_SPECS = [
    "drop", "drop=abc", "unknown=0.1", "drop=0.6,straggle=0.6",
    "drop=1.5", "straggle=0.1:0", "straggle=0.1:1.5", "lie=0.1:0",
    "corrupt=0.1:bogus", "corrupt=0.1:scale:inf", "seed=1.5",
    "corrupt=0.1:scale:x", "lie=-0.1",
]


@pytest.mark.parametrize("text", BAD_SPECS)
def test_spec_errors_are_the_jax_errors(text):
    with pytest.raises(ValueError) as jerr:
        jf.FaultSpec.parse(text)
    with pytest.raises(ValueError) as terr:
        tf.FaultSpec.parse(text)
    assert str(terr.value) == str(jerr.value)


def _plan_args(R=3, J=4):
    z = np.zeros((R, J), np.float32)
    return [z, z.copy(), z.copy(), np.ones((R, J), np.float32), z.copy(),
            z.copy()]


@pytest.mark.parametrize("case", ["shape", "lie_without_report",
                                  "report_shape"])
def test_plan_checks_are_the_jax_checks(case):
    args, kw = _plan_args(), {}
    if case == "shape":
        args[2] = np.zeros((3, 5), np.float32)
    elif case == "lie_without_report":
        lie = np.zeros((3, 4), np.float32)
        lie[0, 1] = 1
        kw["lie"] = lie
    else:
        kw["report"] = np.ones((2, 4), np.float32)
    with pytest.raises(ValueError) as jerr:
        jf.FaultPlan(*args, **kw)
    with pytest.raises(ValueError) as terr:
        tf.FaultPlan(*args, **kw)
    assert str(terr.value) == str(jerr.value)


def test_derived_report_is_the_jax_report():
    args = _plan_args()
    args[1][1, 2] = 1.0
    args[3][1, 2] = 0.25
    np.testing.assert_array_equal(tf.FaultPlan(*args).report,
                                  jf.FaultPlan(*args).report)


def test_resolve_fault_plan_takes_what_jax_takes():
    assert tf.resolve_fault_plan(None, 3, 4) is None
    from_str = tf.resolve_fault_plan(SPECS[0], 3, 4)
    from_spec = tf.resolve_fault_plan(tf.FaultSpec.parse(SPECS[0]), 3, 4)
    for k in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(from_str, k),
                                      getattr(from_spec, k))
    assert tf.resolve_fault_plan(from_str, 3, 4) is from_str
    with pytest.raises(ValueError) as terr:
        tf.resolve_fault_plan(from_str, 5, 4)
    with pytest.raises(ValueError) as jerr:
        jf.resolve_fault_plan(jf.FaultPlan.build(
            jf.FaultSpec.parse(SPECS[0]), 3, 4), 5, 4)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="FaultPlan, got int"):
        tf.resolve_fault_plan(3, 3, 4)
