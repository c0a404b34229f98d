"""The port's ops, batching, aggregation and evaluation against the JAX
package, on the same numpy inputs.

Tolerance: float32 on both sides with another summation order, so
values agree to about 1e-6 relative (atol 1e-6 on O(1) values); index
and mask outputs agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.aggregate import client_logits as jclient_logits
from fedamw_tpu.fedcore.aggregate import weighted_average as jweighted_average
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.fedcore.evaluate import make_evaluator as jmake_evaluator
from fedamw_tpu.models import linear_model as jlinear_model
from fedamw_tpu.ops import losses as jl
from fedamw_tpu.ops.metrics import top1_correct as jtop1
from fedamw_tpu.ops.rff import rff_map as jrff_map
from fedamw_tpu.ops.schedule import lr_schedule_array as jschedule
from fedamw_tpu_torch.fedcore import (
    client_logits,
    make_evaluator,
    weighted_average,
)
from fedamw_tpu_torch.fedcore.batching import (
    batch_counts,
    batch_valid,
    epoch_batches,
)
from fedamw_tpu_torch.models import linear_model
from fedamw_tpu_torch.ops import losses as tl
from fedamw_tpu_torch.ops.metrics import top1_correct
from fedamw_tpu_torch.ops.rff import rff_map, rff_params
from fedamw_tpu_torch.ops.schedule import lr_schedule_array
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rng(seed=0):
    return np.random.RandomState(seed)


def test_l2_norm_safe_value_and_zero_subgradient():
    x = _rng().randn(4, 5).astype(np.float32)
    np.testing.assert_allclose(float(tl.l2_norm_safe(_t(x))),
                               float(jl.l2_norm_safe(jnp.asarray(x))), **TOL)
    for v in (np.zeros((3, 2), np.float32), x):
        xt = _t(v).requires_grad_(True)
        tl.l2_norm_safe(xt).backward()
        gj = jax.grad(jl.l2_norm_safe)(jnp.asarray(v))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **TOL)
    xt = torch.zeros(3, requires_grad=True)
    tl.l2_norm_safe(xt).backward()
    assert torch.equal(xt.grad, torch.zeros(3))  # not NaN at 0


def test_per_example_losses_and_masked_mean():
    r = _rng(1)
    z = r.randn(9, 4).astype(np.float32)
    y = r.randint(0, 4, 9).astype(np.int32)
    t = r.randn(9).astype(np.float32)
    m = (r.rand(9) < 0.6).astype(np.float32)
    np.testing.assert_allclose(tl.ce_per_example(_t(z), _t(y)).numpy(),
                               np.asarray(jl.ce_per_example(z, y)), **TOL)
    np.testing.assert_allclose(tl.mse_per_example(_t(z), _t(t)).numpy(),
                               np.asarray(jl.mse_per_example(z, t)), **TOL)
    np.testing.assert_allclose(
        float(tl.masked_mean(_t(t), _t(m))), float(jl.masked_mean(t, m)),
        **TOL)
    assert float(tl.masked_mean(_t(t), torch.zeros(9))) == 0.0


@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("same_anchor", [True, False])
def test_training_loss_and_gradient(task, same_anchor):
    """Value and autograd gradient of the full objective, including the
    first FedProx step (w == anchor: zero prox subgradient)."""
    r = _rng(2)
    w = r.randn(3, 6).astype(np.float32)
    anchor = w if same_anchor else r.randn(3, 6).astype(np.float32)
    x = r.randn(8, 6).astype(np.float32)
    y = (r.randint(0, 3, 8).astype(np.int32) if task == "classification"
         else r.randn(8).astype(np.float32))
    m = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.float32)

    def jloss(wj):
        return jl.training_loss({"w": wj}, {"w": jnp.asarray(anchor)},
                                jlinear_model().apply, x, y, m, task,
                                0.05, 0.01)[0]

    wt = _t(w).requires_grad_(True)
    lt, (_, cnt) = tl.training_loss({"w": wt}, {"w": _t(anchor)},
                                    linear_model().apply, _t(x), _t(y), _t(m),
                                    task, 0.05, 0.01)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(jloss(jnp.asarray(w))),
                               **TOL)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(jax.grad(jloss)(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-6)
    assert float(cnt) == m.sum()


def test_top1_correct_first_max_wins_ties():
    z = np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0], [0.0, -1.0, 5.0]],
                 np.float32)
    for y in ([1, 0, 2], [2, 1, 2]):
        y = np.array(y, np.int32)
        np.testing.assert_array_equal(top1_correct(_t(z), _t(y)).numpy(),
                                      np.asarray(jtop1(z, y)))
    assert top1_correct(_t(z), _t(np.array([1, 0, 2]))).tolist() == [1, 1, 1]


@pytest.mark.parametrize("mode", ["reference", "paper", "constant"])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 7, 100])
def test_lr_schedule_array_matches(mode, T):
    a = lr_schedule_array(0.5, T, mode)
    b = jschedule(0.5, T, mode)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_lr_schedule_unknown_mode_raises():
    with pytest.raises(ValueError):
        lr_schedule_array(0.5, 3, "cosine")


def test_rff_map_on_injected_draw():
    r = _rng(3)
    X = r.rand(20, 7).astype(np.float32)
    W = (0.1 * r.randn(7, 64)).astype(np.float32)
    b = (2 * np.pi * r.rand(1, 64)).astype(np.float32)
    np.testing.assert_allclose(rff_map(_t(X), _t(W), _t(b)).numpy(),
                               np.asarray(jrff_map(X, W, b)), **TOL)


def test_rff_params_shapes_and_ranges():
    W, b = rff_params(torch.Generator().manual_seed(0), 5, 300, 0.1)
    assert W.shape == (5, 300) and b.shape == (1, 300)
    assert 0.05 < float(W.std()) < 0.15
    assert float(b.min()) >= 0.0 and float(b.max()) < 2 * np.pi


@pytest.mark.parametrize("n,B,with_mask", [(50, 16, True), (64, 32, True),
                                           (53, 16, False), (7, 32, True)])
def test_epoch_batches_injected_positions(n, B, with_mask):
    """Injected JAX positions give JAX's validity exactly; valid rows come
    first and padding last."""
    r = _rng(4)
    mask = ((r.rand(n) < 0.7).astype(np.float32) if with_mask else None)
    key = jax.random.PRNGKey(5)
    if with_mask:
        pj, vj = jepoch_batches(key, n, B, jnp.asarray(mask))
    else:
        pj, vj = jepoch_batches(key, n, B)
    pt, vt = epoch_batches(n, B, None if mask is None else _t(mask),
                           positions=_t(pj))
    assert pt.shape == (batch_counts(n, B)[0], B)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    flat = vt.reshape(-1).numpy()
    k = int(flat.sum())
    assert np.all(flat[:k] == 1) and np.all(flat[k:] == 0)


def test_epoch_batches_drawn_from_generator():
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.float32)
    pa, va = epoch_batches(10, 4, mask,
                           generator=torch.Generator().manual_seed(1))
    pb, vb = epoch_batches(10, 4, mask,
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(pa, pb) and torch.equal(va, vb)
    flat_p, flat_v = pa.reshape(-1), va.reshape(-1)
    assert sorted(flat_p[:7].tolist()) == [0, 2, 3, 5, 6, 8, 9]
    assert flat_v.tolist() == [1] * 7 + [0] * 5
    with pytest.raises(ValueError, match="positions shape"):
        epoch_batches(10, 4, mask, positions=torch.zeros(2, 4))


def test_batch_valid_batched_over_clients():
    r = _rng(6)
    mask = (r.rand(3, 20) < 0.5).astype(np.float32)
    pos = np.stack([np.stack([np.asarray(jepoch_batches(k, 20, 8,
                                                        jnp.asarray(mask[j]))[0])
                              for k in jax.random.split(
                                  jax.random.PRNGKey(j), 2)])
                    for j in range(3)])
    v = batch_valid(_t(pos), 20, _t(mask))
    for j in range(3):
        for e in range(2):
            np.testing.assert_array_equal(
                v[j, e].numpy(),
                np.asarray(jepoch_batches(jax.random.split(
                    jax.random.PRNGKey(j), 2)[e], 20, 8,
                    jnp.asarray(mask[j]))[1]))


def test_weighted_average_and_client_logits():
    r = _rng(7)
    stacked = r.randn(5, 3, 11).astype(np.float32)
    p = r.rand(5).astype(np.float32)
    X = r.randn(13, 11).astype(np.float32)
    np.testing.assert_allclose(
        weighted_average({"w": _t(stacked)}, _t(p))["w"].numpy(),
        np.asarray(jweighted_average({"w": jnp.asarray(stacked)},
                                     jnp.asarray(p))["w"]), **TOL)
    lt = client_logits(linear_model().apply, {"w": _t(stacked)}, _t(X))
    lj = jclient_logits(jlinear_model().apply, {"w": jnp.asarray(stacked)},
                        jnp.asarray(X))
    assert lt.shape == (13, 5, 3) and lt.is_contiguous()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_evaluator_matches(task):
    r = _rng(8)
    w = r.randn(4, 9).astype(np.float32)
    X = r.randn(30, 9).astype(np.float32)
    y = (r.randint(0, 4, 30).astype(np.int32) if task == "classification"
         else r.randn(30).astype(np.float32))
    lt, at = make_evaluator(linear_model().apply, task)({"w": _t(w)}, _t(X),
                                                         _t(y))
    lj, aj = jmake_evaluator(jlinear_model().apply, task)(
        {"w": jnp.asarray(w)}, jnp.asarray(X), jnp.asarray(y))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6)
