"""Kernel 2's plain version and the port's p-solver against the JAX package.

The port's ``make_p_solver`` (whose epochs go through ``p_epoch``, the
plain PyTorch version on CPU tensors) is held against the JAX package's
``make_p_solver`` in both forms — the XLA solve and the fused Pallas
p-epoch kernel in interpret mode — with the shuffles the JAX solve draws
from its key (``split(key, num_epochs)`` -> ``epoch_batches``) injected.
Both tasks, momentum 0.9 and 0, a partial last batch, and
``client_valid`` freezing padded clients. Tolerances are those of
``tests/test_pallas_psolver.py``: rtol 2e-5, atol 2e-6. The reference is
the XLA solve and interpret-mode Pallas on the CPU, never TPU artifacts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.aggregate import make_p_solver as jmake_p_solver
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu_torch.fedcore import make_p_solver, p_epoch, p_epoch_plain
from fedamw_tpu_torch.fedcore.batching import batch_valid

TOL = dict(rtol=2e-5, atol=2e-6)


def _mk(task, n_val, J, C, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n_val, J, C).astype(np.float32)
    if task == "classification":
        y = rng.randint(0, C, n_val).astype(np.int32)
    else:
        y = rng.randn(n_val).astype(np.float32)
    p = rng.rand(J).astype(np.float32)
    return logits, y, p / p.sum()


def _positions(key, n_val, B, epochs):
    return np.stack([np.asarray(jepoch_batches(k, n_val, B)[0])
                     for k in jax.random.split(key, epochs)])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("task,C", [("classification", 3),
                                    ("classification", 2),
                                    ("regression", 1)])
@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_plain_solver_matches_jax(task, C, momentum, impl):
    n_val, J, B, E = 53, 7, 16, 3  # last batch partial (53 = 3*16 + 5)
    logits, y, p0 = _mk(task, n_val, J, C)
    key = jax.random.PRNGKey(42)
    sj, ij = jmake_p_solver(task, n_val, B, 5e-3, momentum, kernel_impl=impl)
    pj, oj, lj, aj = sj(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(p0),
                        ij(jnp.asarray(p0)), key, E)

    st, it = make_p_solver(task, n_val, B, 5e-3, momentum)
    pt, ot, lt, at = st(_t(logits), _t(y), _t(p0), it(_t(p0)),
                        _t(_positions(key, n_val, B, E)))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=2e-5)
    leaves = jax.tree_util.tree_leaves(oj)
    if momentum > 0:
        np.testing.assert_allclose(ot["trace"].numpy(), np.asarray(leaves[0]),
                                   **TOL)
    else:
        assert ot == {} and leaves == []


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_plain_solver_client_valid_freezes_padding(impl):
    n_val, J, C, B, E = 48, 6, 2, 16, 4
    logits, y, p0 = _mk("classification", n_val, J, C, seed=3)
    cv = np.array([1, 1, 1, 1, 0, 0], np.float32)
    p0 = (p0 * cv / np.sum(p0 * cv)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    sj, ij = jmake_p_solver("classification", n_val, B, 1e-2, 0.9,
                            kernel_impl=impl)
    pj = sj(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(p0),
            ij(jnp.asarray(p0)), key, E, client_valid=jnp.asarray(cv))[0]

    st, it = make_p_solver("classification", n_val, B, 1e-2, 0.9)
    pt = st(_t(logits), _t(y), _t(p0), it(_t(p0)),
            _t(_positions(key, n_val, B, E)), client_valid=_t(cv))[0]
    np.testing.assert_array_equal(pt.numpy()[4:], np.zeros(2))
    assert not np.allclose(pt.numpy()[:4], p0[:4])
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    n_val, J, C, B = 40, 5, 4, 16
    logits, y, p0 = _mk("classification", n_val, J, C, seed=5)
    pos = _t(_positions(jax.random.PRNGKey(3), n_val, B, 1)[0])
    args = (_t(p0), torch.zeros(J), torch.ones(J), _t(logits), _t(y),
            pos.to(torch.int32), batch_valid(pos, n_val))
    before = p_epoch.launches
    a = p_epoch(*args, 1e-2, 0.9, "classification")
    b = p_epoch_plain(*args, 1e-2, 0.9, "classification")
    assert p_epoch.launches == before
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert float(a[2][2]) == n_val  # every validation row counted once


def test_guards_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_p_solver("classification", 10, p_guard="simplex")


@pytest.mark.cuda
@pytest.mark.parametrize("task,C", [("classification", 10), ("regression", 1)])
def test_cuda_kernel_matches_plain_version(task, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n_val, J, B = 200, 50, 16
    logits, y, p0 = _mk(task, n_val, J, C, seed=7)
    pos = _t(_positions(jax.random.PRNGKey(1), n_val, B, 1)[0])
    cv = np.ones(J, np.float32)
    cv[-3:] = 0.0
    args = [_t(a).cuda() for a in (p0, np.zeros(J, np.float32), cv, logits, y)]
    args += [pos.to(torch.int32).cuda(), batch_valid(pos, n_val).cuda()]
    before = p_epoch.launches
    pk, bk, mk = p_epoch(*args, 1e-2, 0.9, task)
    torch.cuda.synchronize()
    assert p_epoch.launches == before + 1
    pp, bp, mp = p_epoch_plain(*args, 1e-2, 0.9, task)
    torch.testing.assert_close(pk, pp, **TOL)
    torch.testing.assert_close(bk, bp, **TOL)
    torch.testing.assert_close(mk, mp, rtol=2e-5, atol=1e-4)
