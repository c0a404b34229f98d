"""Kernel 1's plain version against the JAX package's client kernels.

The port's ``client_epoch`` wrapper runs its plain PyTorch version on CPU
tensors; here it is held against the JAX package's
``make_local_update`` in both forms — the fused Pallas epoch kernel in
interpret mode and the XLA scan — on the same pre-gathered batches: the
positions the JAX side draws from its key (``split(key, epochs)`` ->
``epoch_batches``) are injected into the port. Both tasks, the four
(mu, lam) penalty combinations, masked partial batches, an empty client
and a vmapped round. Tolerances are those of
``tests/test_pallas_kernel.py``: weights atol 2e-5 / rtol 1e-5, loss
atol 1e-4, accuracy atol 1e-3.

The CUDA kernel itself needs a card; the ``cuda``-marked tests hold it
against the plain version there and skip on a machine without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.fedcore.client import make_client_round as jmake_client_round
from fedamw_tpu.fedcore.client import make_local_update as jmake_local_update
from fedamw_tpu.models import linear_model as jlinear_model
from fedamw_tpu_torch.fedcore import (
    client_epoch,
    client_epoch_plain,
    make_client_round,
    make_local_update,
)

N, D, C, B, EPOCHS, N_MAX = 300, 256, 3, 32, 2, 64
W_TOL = dict(atol=2e-5, rtol=1e-5)


def _data(task, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(np.float32)
    if task == "classification":
        y = rng.randint(0, C, N).astype(np.int32)
    else:
        y = rng.randn(N).astype(np.float32)
    w0 = (rng.randn(C, D) * 0.1).astype(np.float32)
    return X, y, w0


def _client(n, seed=1):
    rng = np.random.RandomState(seed)
    idx = np.zeros(N_MAX, np.int32)
    mask = np.zeros(N_MAX, np.float32)
    idx[:n] = rng.choice(N, size=n, replace=False)
    mask[:n] = 1.0
    return idx, mask


def _positions(key, mask):
    """The positions the JAX local update draws for this key."""
    return np.stack([np.asarray(jepoch_batches(k, N_MAX, B, jnp.asarray(mask))[0])
                     for k in jax.random.split(key, EPOCHS)])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("mu,lam", [(0.0, 0.0), (0.05, 0.0), (0.0, 0.01),
                                    (0.05, 0.01)])
def test_plain_epoch_matches_jax_single_client(task, mu, lam, impl):
    X, y, w0 = _data(task)
    idx, mask = _client(50)  # 50 of 64 slots: the second batch is partial
    key = jax.random.PRNGKey(7)
    apply_fn = jlinear_model().apply if impl == "xla" else None
    lu_j = jmake_local_update(apply_fn, task, EPOCHS, B, N_MAX,
                              kernel_impl=impl)
    wj, lj, aj = lu_j({"w": jnp.asarray(w0)}, jnp.asarray(X), jnp.asarray(y),
                      jnp.asarray(idx), jnp.asarray(mask), key,
                      jnp.float32(0.1), jnp.float32(mu), jnp.float32(lam))

    lu_t = make_local_update(task, EPOCHS, B, N_MAX)
    wt, lt, at = lu_t({"w": _t(w0)}, _t(X), _t(y), _t(idx).long(), _t(mask),
                      _t(_positions(key, mask)), 0.1, mu, lam)
    np.testing.assert_allclose(wt["w"].numpy(), np.asarray(wj["w"]), **W_TOL)
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-4)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-3)


def test_plain_epoch_empty_client_is_inert():
    X, y, w0 = _data("classification")
    idx, mask = _client(0)
    lu_t = make_local_update("classification", EPOCHS, B, N_MAX)
    pos = _positions(jax.random.PRNGKey(0), mask)
    wt, lt, at = lu_t({"w": _t(w0)}, _t(X), _t(y), _t(idx).long(), _t(mask),
                      _t(pos), 0.1, 0.0, 0.0)
    np.testing.assert_array_equal(wt["w"].numpy(), w0)
    assert float(lt) == 0.0 and float(at) == 0.0


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_plain_round_matches_jax_vmapped_round(impl):
    task, J = "classification", 6
    X, y, w0 = _data(task)
    rng = np.random.RandomState(3)
    idx = rng.randint(0, N, size=(J, N_MAX)).astype(np.int32)
    mask = (rng.rand(J, N_MAX) < 0.8).astype(np.float32)
    mask[4] = 0.0  # one empty client beside partial ones
    keys = jax.random.split(jax.random.PRNGKey(11), J)
    args = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(idx),
            jnp.asarray(mask), keys, jnp.float32(0.2), jnp.float32(0.01),
            jnp.float32(0.001))
    rf_j = jax.jit(jmake_client_round(jlinear_model().apply, task, EPOCHS, B,
                                      N_MAX, kernel_impl=impl))
    sj, lj, aj = rf_j({"w": jnp.asarray(w0)}, *args)

    pos = np.stack([_positions(keys[j], mask[j]) for j in range(J)])
    rf_t = make_client_round(task, EPOCHS, B, N_MAX)
    st, lt, at = rf_t({"w": _t(w0)}, _t(X), _t(y), _t(idx).long(), _t(mask),
                      _t(pos), 0.2, 0.01, 0.001)
    np.testing.assert_allclose(st["w"].numpy(), np.asarray(sj["w"]), **W_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-3)
    np.testing.assert_array_equal(st["w"][4].numpy(), w0)


def _epoch_inputs(task, device, J=5, S=3, seed=0):
    X, y, w0 = _data(task, seed)
    rng = np.random.RandomState(seed + 1)
    rows = rng.randint(0, N, size=(J, S, B)).astype(np.int32)
    valid = (rng.rand(J, S, B) < 0.7).astype(np.float32)
    valid[1] = 0.0          # an empty client
    valid[2, 1:] = 0.0      # empty trailing steps
    W = np.repeat(w0[None], J, 0) + rng.randn(J, C, D).astype(np.float32) * 0.01
    return [torch.from_numpy(a).to(device) for a in (W, w0, X, y, rows, valid)]


def test_wrapper_runs_plain_version_for_cpu_tensors():
    args = _epoch_inputs("classification", "cpu")
    before = client_epoch.launches
    wa, ma = client_epoch(*args, 0.1, 0.05, 0.01, "classification")
    wb, mb = client_epoch_plain(*args, 0.1, 0.05, 0.01, "classification")
    assert client_epoch.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(wa, wb, rtol=0, atol=0)
    torch.testing.assert_close(ma, mb, rtol=0, atol=0)
    torch.testing.assert_close(wa[1], args[0][1], rtol=0, atol=0)
    assert float(ma[1, 2]) == 0.0


def test_wrapper_rejects_bad_inputs():
    W, w0, X, y, rows, valid = _epoch_inputs("classification", "cpu")
    with pytest.raises(ValueError, match="rows"):
        client_epoch(W, w0, X, y, rows.long(), valid, 0.1, 0, 0,
                     "classification")
    with pytest.raises(ValueError, match="y"):
        client_epoch(W, w0, X, y.float(), rows, valid, 0.1, 0, 0,
                     "classification")
    with pytest.raises(ValueError, match="W"):
        client_epoch(W.transpose(1, 2), w0, X, y, rows, valid, 0.1, 0, 0,
                     "classification")


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_kernel_matches_plain_version(task):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _epoch_inputs(task, "cuda")
    before = client_epoch.launches
    wk, mk = client_epoch(*args, 0.1, 0.05, 0.01, task)
    torch.cuda.synchronize()
    assert client_epoch.launches == before + 1
    wp, mp = client_epoch_plain(*args, 0.1, 0.05, 0.01, task)
    torch.testing.assert_close(wk, wp, **W_TOL)
    torch.testing.assert_close(mk, mp, atol=1e-3, rtol=1e-5)
