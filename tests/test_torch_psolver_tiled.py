"""The class-tiled split kernel's arithmetic, emulated on the CPU.

``csrc/p_epoch.cu:split_tiled_p_epoch_kernel`` splits the classes over a
cluster of k CTAs: CTA q reads its slice of every row from the
class-split layout (``psolver_kernel.class_split``), sums z over the
clients for its classes, and the loss needs every row's statistics over
all C, which the CTAs push to each other and merge in rank order (the
first maximum over all C: a tie across slices to the lower rank, within
one to the lower class; ``Z = sum_q S_q exp(m_q - M)``). d is then local,
each CTA's partial ``g`` covers its classes over the step's groups of
rows (``tiled_layout``'s rows) in order, and the k partials are summed in
rank order on every CTA, which all update the same p.

``emulated_epoch`` does that arithmetic in PyTorch, rank by rank and
group by group, and is held against the JAX package's solver (the XLA
solve and, for one case, the Pallas p-epoch kernel in interpret mode, as
``tests/test_pallas_psolver.py`` runs it) with every shuffle injected:
random logits, the all-equal tie case and C = 33, 105, both tasks, at
rtol 2e-5, atol 2e-6 (``tests/test_torch_psolver.py``'s). The kernel
itself needs a card: ``tests/test_torch_psolver.py``'s ``cuda`` cases
hold it against ``p_epoch_plain`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.aggregate import make_p_solver as jmake_p_solver
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu_torch.fedcore import psolver_kernel as pk
from fedamw_tpu_torch.fedcore.batching import (
    batch_valid, weighted_epoch_metrics)
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-6)


def emulated_epoch(p, buf, cv, logits, y, positions, valid, lr, momentum,
                   task, k):
    """One epoch as the class-tiled split kernel computes it on a
    ``k``-cluster; returns ``(p, buf, metrics (3,))`` like
    ``p_epoch_plain``."""
    S, B = positions.shape
    n_val, J, C = logits.shape
    split = pk.class_split(logits, k)
    rows = pk.tiled_layout(B, J, C, k)[1]
    bounds = [pk.tiled_class_lo(C, k, q) for q in range(k + 1)]
    cls = task == "classification"
    metrics = torch.zeros(3)
    for s in range(S):
        pos, bv = positions[s].long(), valid[s]
        cnt = bv.sum()
        inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
        g_rank = torch.zeros(k, J)
        for g0 in range(0, B, rows):
            b = slice(g0, min(B, g0 + rows))
            Ls, zs, stats = [], [], []
            for q in range(k):
                lo, hi = bounds[q], bounds[q + 1]
                L = split[q][pos[b]][:, :, :hi - lo]  # (nr, J, cq)
                z = torch.einsum("bjc,j->bc", L, p)
                if cls:
                    m, idx = z.max(-1)  # the first maximum of the slice
                    lab = y[pos[b]].long() - lo
                    own = (lab >= 0) & (lab < hi - lo)
                    zl = torch.where(own, z.gather(
                        1, lab.clamp(0, hi - lo - 1)[:, None])[:, 0], 0.0)
                    z = torch.exp(z - m[:, None])  # kept for d, as the kernel
                    stats.append((m, z.sum(-1), zl, idx + lo))
                else:
                    stats.append(torch.square(z - y[pos[b]][:, None]).sum(-1))
                Ls.append(L)
                zs.append(z)
            scale = (bv[b] * inv_cnt)[:, None]
            if cls:
                M, pred = stats[0][0], stats[0][3]
                for m, _, _, idx in stats[1:]:
                    up = m > M  # strictly: a tie stays with the lower rank
                    M, pred = torch.where(up, m, M), torch.where(up, idx, pred)
                Z, zl = torch.zeros_like(M), torch.zeros_like(M)
                for m, e, zq, _ in stats:
                    Z = Z + e * torch.exp(m - M)
                    zl = zl + zq
                loss = torch.log(Z) + M - zl
                hit = (pred == y[pos[b]].long()).float()
            else:
                loss = sum(stats) / C
                hit = torch.zeros_like(loss)
            for q in range(k):
                lo = bounds[q]
                if cls:
                    onehot = (torch.arange(lo, bounds[q + 1])[None, :]
                              == y[pos[b]].long()[:, None]).float()
                    f = torch.exp(stats[q][0] - M) / Z  # exp(m_q - M) / Z
                    d = (zs[q] * f[:, None] - onehot) * scale
                else:
                    d = (zs[q] - y[pos[b]][:, None]) * (2.0 / C) * scale
                g_rank[q] += torch.einsum("bjc,bc->j", Ls[q], d)
            metrics[0] += (loss * bv[b]).sum()
            metrics[1] += (hit * bv[b]).sum()
        g = torch.zeros(J)
        for q in range(k):  # rank order, the same sum on every CTA
            g = g + g_rank[q]
        buf = momentum * buf + g * cv
        p = p - lr * buf
        metrics[2] += cnt
    return p, buf, metrics


def _inputs(task, n_val, J, C, case, seed):
    rng = np.random.RandomState(seed)
    if case == "tie":
        # constant over the classes: every z row is flat, its first
        # maximum class 0; labels mostly 0 so that hits count
        logits = np.repeat(rng.randn(n_val, J, 1), C, -1).astype(np.float32)
        y = np.where(rng.rand(n_val) < 0.5, 0,
                     rng.randint(0, C, n_val)).astype(np.int32)
    else:
        logits = rng.randn(n_val, J, C).astype(np.float32)
        y = (rng.randint(0, C, n_val).astype(np.int32)
             if task == "classification"
             else rng.randn(n_val).astype(np.float32))
    p0 = rng.rand(J).astype(np.float32)
    return (logits / np.sqrt(J)).astype(np.float32), y, p0 / p0.sum()


@pytest.mark.parametrize("task,C,case,k,impl", [
    ("classification", 33, "random", 4, "xla"),
    ("classification", 105, "random", 16, "xla"),
    ("classification", 105, "random", 1, "xla"),
    ("classification", 105, "random", 4, "pallas_interpret"),
    ("classification", 33, "tie", 8, "xla"),
    ("classification", 105, "tie", 16, "xla"),
    ("regression", 33, "random", 4, "xla"),
])
def test_emulated_class_split_epochs_match_jax(task, C, case, k, impl):
    """Two epochs of the kernel's merge, rank by rank, against the JAX
    package's solver on the same shuffles (n_val 53: the last batch
    partial; B = 16; momentum 0.9; a masked client)."""
    n_val, J, B, E, lr, momentum = 53, 7, 16, 2, 5e-2, 0.9
    logits, y, p0 = _inputs(task, n_val, J, C, case, seed=C + k)
    cv = np.ones(J, np.float32)
    cv[-1] = 0.0
    key = jax.random.PRNGKey(C)
    sj, ij = jmake_p_solver(task, n_val, B, lr, momentum, kernel_impl=impl)
    pj, oj, lj, aj = sj(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(p0),
                        ij(jnp.asarray(p0)), key, E,
                        client_valid=jnp.asarray(cv))
    positions = torch.from_numpy(np.stack([
        np.asarray(jepoch_batches(kk, n_val, B)[0])
        for kk in jax.random.split(key, E)]))
    p, buf = torch.from_numpy(p0), torch.zeros(J)
    args = (torch.from_numpy(cv), torch.from_numpy(logits),
            torch.from_numpy(y))
    for e in range(E):
        p, buf, met = emulated_epoch(
            p, buf, *args, positions[e].to(torch.int32),
            batch_valid(positions[e], n_val), lr, momentum, task, k)
    loss, acc = weighted_epoch_metrics(met[0], met[1], met[2])
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), **TOL)
    np.testing.assert_allclose(
        buf.numpy(), np.asarray(jax.tree_util.tree_leaves(oj)[0]), **TOL)
    np.testing.assert_allclose(float(loss), float(lj), rtol=2e-5)
    np.testing.assert_allclose(float(acc), float(aj), rtol=2e-5)
    if case == "tie":
        # every first maximum is class 0: the hits are the label-0 rows
        last = positions[-1].long()
        ok = batch_valid(positions[-1], n_val)
        want = float((torch.from_numpy(y)[last] == 0).float().mul(ok).sum())
        assert float(met[1]) == want > 0


@pytest.mark.parametrize("C,k", [(33, 4), (105, 16), (105, 8), (1000, 16),
                                 (53, 2), (5, 1)])
def test_class_split_layout(C, k):
    """``class_split``: rank q's classes ``[qC/k, (q+1)C/k)`` (widths
    differing by at most one), each client's slice zero-padded to
    ``tiled_width`` (a multiple of 4 floats), the rest of the layout
    the logits exactly."""
    rng = np.random.RandomState(C)
    logits = torch.from_numpy(rng.randn(3, 5, C).astype(np.float32))
    split = pk.class_split(logits, k)
    W = pk.tiled_width(C, k)
    assert tuple(split.shape) == (k, 3, 5, W) and W % 4 == 0
    widths = [pk.tiled_class_lo(C, k, q + 1) - pk.tiled_class_lo(C, k, q)
              for q in range(k)]
    assert sum(widths) == C and max(widths) - min(widths) <= 1
    assert W == -(-max(widths) // 4) * 4
    back = torch.cat([split[q, :, :, :widths[q]] for q in range(k)], -1)
    assert torch.equal(back, logits)
    for q in range(k):
        assert not split[q, :, :, widths[q]:].any()
