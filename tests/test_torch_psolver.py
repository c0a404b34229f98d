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

The p-guards: the plain epoch with ``clip``, ``clip:R`` and ``simplex``
against the JAX package's XLA solver with the same guard, and
``project_simplex_fixed_point`` (the kernels' algorithm) against the JAX
package's sort-based ``project_simplex``.

``launch_plan`` (which kernel of ``csrc/p_epoch.cu`` runs, by shape) is
tested here on the CPU. The kernels need a card: the ``cuda``-marked
tests hold the staged, split and unstaged kernels, with and without a
guard, against ``p_epoch_plain`` over a grid of shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.aggregate import make_p_solver as jmake_p_solver
from fedamw_tpu.fedcore.aggregate import project_simplex as jproject_simplex
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu_torch.fedcore import cuda_build
from fedamw_tpu_torch.fedcore import make_p_solver, p_epoch, p_epoch_plain
from fedamw_tpu_torch.fedcore import psolver_kernel as pk
from fedamw_tpu_torch.fedcore.aggregate import (
    make_guard, project_simplex, project_simplex_fixed_point)
from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches

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


@pytest.mark.parametrize("guard", ["simplex", "clip", "clip:0.3"])
def test_guarded_solver_projects_every_step(guard):
    """A guarded solve runs the plain epoch with the projection after
    every step: the same as stepping ``p_epoch_plain`` with the guard by
    hand, and the guard's constraint holds at the end."""
    from fedamw_tpu_torch.fedcore.aggregate import make_guard

    n_val, J, C, B, E = 40, 5, 4, 16, 2
    logits, y, p0 = _mk("classification", n_val, J, C, seed=6)
    pos = _t(_positions(jax.random.PRNGKey(2), n_val, B, E))
    cv = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    solve, init = make_p_solver("classification", n_val, B, 0.5, 0.9,
                                p_guard=guard)
    p, state, _, _ = solve(_t(logits), _t(y), _t(p0), init(_t(p0)), pos,
                           client_valid=cv)
    g = make_guard(guard)
    pp, buf = _t(p0), torch.zeros(J)
    for e in range(E):
        pp, buf, _ = p_epoch_plain(pp, buf, cv, _t(logits), _t(y),
                                   pos[e].to(torch.int32),
                                   batch_valid(pos[e], n_val), 0.5, 0.9,
                                   "classification", guard=g)
    torch.testing.assert_close(p, pp, rtol=0, atol=0)
    torch.testing.assert_close(state["trace"], buf, rtol=0, atol=0)
    if guard == "simplex":
        assert float(p[2]) == 0.0 and abs(float(p.sum()) - 1) < 1e-6
    else:
        radius = float(guard.split(":")[1]) if ":" in guard else 1.0
        assert float(torch.linalg.norm(p)) <= radius * (1 + 1e-6)


@pytest.mark.parametrize("guard", ["clip", "clip:0.5", "simplex"])
@pytest.mark.parametrize("J,cv_kind", [(1, "all"), (7, "some"), (7, "none"),
                                       (50, "some"), (400, "all")])
def test_guarded_plain_epochs_match_jax(guard, J, cv_kind):
    """``p_epoch_plain`` with each guard, stepped by ``make_p_solver``
    over two epochs of injected shuffles, against the JAX package's XLA
    solver with the same ``p_guard``: every client valid, some invalid,
    or none (the simplex then zeroes p). rtol 2e-5, atol 2e-6, as
    ``tests/test_pallas_psolver.py``."""
    n_val, C, B, E = 37, 3, 16, 2
    logits, y, p0 = _mk("classification", n_val, J, C, seed=J)
    logits = (logits / np.sqrt(J)).astype(np.float32)
    cv = np.ones(J, np.float32)
    if cv_kind == "some":
        cv[::3] = 0.0
    elif cv_kind == "none":
        cv[:] = 0.0
    p0 = (3.0 * p0).astype(np.float32)  # above the clip radius
    key = jax.random.PRNGKey(J)
    sj, ij = jmake_p_solver("classification", n_val, B, 0.5, 0.9,
                            kernel_impl="xla", p_guard=guard)
    pj, oj, lj, _ = sj(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(p0),
                       ij(jnp.asarray(p0)), key, E,
                       client_valid=jnp.asarray(cv))
    st, it = make_p_solver("classification", n_val, B, 0.5, 0.9,
                           p_guard=guard)
    pt, ot, lt, _ = st(_t(logits), _t(y), _t(p0), it(_t(p0)),
                       _t(_positions(key, n_val, B, E)),
                       client_valid=_t(cv))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    np.testing.assert_allclose(
        ot["trace"].numpy(), np.asarray(jax.tree_util.tree_leaves(oj)[0]),
        **TOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    if guard == "simplex":
        want = 0.0 if cv_kind == "none" else 1.0
        assert abs(float(pt.sum()) - want) < 1e-5
        assert np.all(pt.numpy()[cv == 0] == 0)


def _simplex_cases():
    rng = np.random.RandomState(11)
    return {
        "random": (rng.randn(50), None),
        "random masked": (rng.randn(50), (rng.rand(50) > 0.3)),
        "ties": (np.array([0.5, 0.5, 0.5, 0.2, 0.2, -1.0]), None),
        "all equal": (np.full(9, 0.3), None),
        "one dominant": (np.array([10.0, 0.1, 0.2, -0.3]), None),
        "negative": (-np.abs(rng.randn(12)) - 1.0, None),
        "sums to one": (np.full(4, 0.25), None),
        "one valid": (rng.randn(6), np.eye(6)[2] > 0),
        "none valid": (rng.randn(5), np.zeros(5, bool)),
        "large J": (rng.randn(4096) * 0.01, rng.rand(4096) > 0.1),
    }


@pytest.mark.parametrize("case", sorted(_simplex_cases()))
def test_fixed_point_simplex_matches_jax(case):
    """Michelot's fixed point (the kernels' simplex guard) against the
    JAX package's sort-based projection, atol 1e-6; the port's sort-based
    one agrees too."""
    v, valid = _simplex_cases()[case]
    v = v.astype(np.float32)
    valid = None if valid is None else valid.astype(np.float32)
    want = np.asarray(jproject_simplex(
        jnp.asarray(v), None if valid is None else jnp.asarray(valid)))
    vt = _t(v)
    mt = None if valid is None else _t(valid)
    got = project_simplex_fixed_point(vt, mt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(project_simplex(vt, mt).numpy(), want,
                               rtol=0, atol=1e-6)
    if valid is None or valid.any():
        assert abs(float(got.sum()) - 1.0) < 1e-5 and got.min() >= 0


def test_guards_carry_their_kernel_code():
    """The kernels read a guard's ``kind`` and ``radius``; any other
    callable is not a guard they run."""
    assert pk.guard_code(None) == (0, 0.0)
    assert pk.guard_code(make_guard("clip")) == (1, 1.0)
    assert pk.guard_code(make_guard("clip:0.5")) == (1, 0.5)
    assert pk.guard_code(make_guard("simplex"))[0] == 2
    assert make_guard("none") is None
    with pytest.raises(ValueError, match="make_guard"):
        pk.guard_code(project_simplex)


def test_unknown_guard_is_refused():
    with pytest.raises(ValueError, match="expected 'none', 'simplex'"):
        make_p_solver("classification", 10, p_guard="box")


# -- the launch plan (CPU) -----------------------------------------------------


def test_plan_main_path_layout():
    plan = pk.launch_plan(16, 50, 10)
    # 2 mbarriers per warp (16 B); floats: two stages of 16 rows of
    # 500, h 16*50, p/buf/cv 3*50, per-warp sums 4*16 (metrics, guard)
    assert plan == pk.PEpochPlan(
        kernel="staged", warps=16, classes=10,
        smem_bytes=16 * 16 + 4 * (2 * 16 * 500 + 16 * 50 + 150 + 64))
    assert pk.kernel_symbol(plan, 10) == \
        "21staged_p_epoch_kernelILi10ELb1ELb0E"
    assert pk.kernel_symbol(plan, 10, guarded=True) == \
        "21staged_p_epoch_kernelILi10ELb1ELb1E"
    # the main path's regression twin, and a batch wider than 16 warps
    assert pk.launch_plan(16, 50, 1).classes == 1
    assert pk.launch_plan(33, 50, 10).warps == 16


@pytest.mark.parametrize("B,J,C,smem_limit,route", [
    (16, 50, 10, cuda_build.SMEM_LIMIT, "staged"),     # the main path
    (16, 355, 10, cuda_build.SMEM_LIMIT, "split"),
    (16, 356, 10, cuda_build.SMEM_LIMIT, "split"),     # past the unstaged one
    (16, 400, 10, cuda_build.SMEM_LIMIT, "split"),     # 400 partitions
    (16, 137, 26, cuda_build.SMEM_LIMIT, "split"),
    (16, 138, 26, cuda_build.SMEM_LIMIT, "split"),
    (16, 50, 10, 40000, "split"),  # a smaller block: staged no longer fits
    (16, 50, 33, 20000, None),     # no split above 32 classes, nor unstaged
])
def test_plan_is_none_where_no_kernel_takes_the_shape(B, J, C,
                                                      smem_limit, route):
    """The plan by shape alone, with ``smem_limit`` passed in: its
    kernel, or None where no kernel takes the shape (the wrapper then
    refuses CUDA tensors before any launch)."""
    plan = pk.launch_plan(B, J, C, smem_limit=smem_limit)
    assert (plan.kernel if plan else None) == route
    if plan is not None:
        assert plan.smem_bytes <= smem_limit


def test_wrapper_counts_no_launch_on_the_cpu():
    """On the CPU every call is the plain version, even at a shape no
    plan takes on the card: nothing is counted."""
    n_val, J, C, B = 40, 400, 10, 16
    logits, y, p0 = _mk("classification", n_val, J, C, seed=1)
    pos = _t(_positions(jax.random.PRNGKey(0), n_val, B, 1)[0])
    pk.reset_counts()
    p_epoch(_t(p0), torch.zeros(J), torch.ones(J), _t(logits), _t(y),
            pos.to(torch.int32), batch_valid(pos, n_val), 1e-2, 0.9,
            "classification")
    assert p_epoch.launches == 0
    assert p_epoch.launches_by_kernel == {"staged": 0, "split": 0,
                                          "unstaged": 0}


@pytest.mark.parametrize("B,J,C,kernel", [
    (16, 170, 10, "staged"),    # the widest J two stages hold at B=16
    (16, 171, 10, "split"),     # past two stages: J split over a cluster
    (16, 355, 10, "split"),     # the widest J the unstaged kernel held
    (16, 50, 33, "unstaged"),   # no staged instantiation above 32 classes
    (513, 2, 1, "unstaged"),    # more rows than 16 warps' lanes
])
def test_plan_chooses_kernel(B, J, C, kernel):
    plan = pk.launch_plan(B, J, C)
    assert plan.kernel == kernel
    assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
    if kernel == "split":
        assert plan.smem_bytes == pk.split_smem_bytes(B, J, C, plan.cluster,
                                                      plan.stream)
        assert pk.kernel_symbol(plan, C) == "20split_p_epoch_kernelILi10ELb1E"
    if kernel == "unstaged":
        assert plan == pk.PEpochPlan("unstaged", 8, 0,
                                     pk.unstaged_smem_bytes(B, J, C))
        assert pk.kernel_symbol(plan, C) == "23unstaged_p_epoch_kernel"


@pytest.mark.parametrize("C,nc", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 8),
                                  (10, 10), (11, 16), (26, 26), (27, 32),
                                  (33, 0)])
def test_plan_instantiated_classes(C, nc):
    assert pk.staged_classes(C) == nc


def test_plan_refuses_what_fits_nowhere():
    assert pk.launch_plan(16, 4096, 33) is None  # > 32 classes, too wide
    with pytest.raises(ValueError, match="does not fit"):
        pk.launch_plan(16, 200, 10, kernel="staged")
    with pytest.raises(ValueError, match="kernel must be"):
        pk.launch_plan(16, 50, 10, kernel="fast")
    with pytest.raises(ValueError, match="bad shape"):
        pk.launch_plan(0, 50, 10)


def test_plan_takes_every_shape_the_first_kernel_took():
    """Every (B, J, C) the port's first p_epoch kernel (now the unstaged
    one) fits in shared memory still gets a plan."""
    for B in (1, 2, 15, 16, 17, 32, 33, 64, 256, 512, 513, 1024, 4096):
        for J in (1, 2, 7, 50, 100, 170, 171, 200, 355, 1000):
            for C in (1, 2, 3, 10, 26, 32, 33, 100):
                if pk.unstaged_smem_bytes(B, J, C) > cuda_build.SMEM_LIMIT:
                    continue
                plan = pk.launch_plan(B, J, C)
                assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
                assert pk.launch_plan(B, J, C, kernel="unstaged")


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_takes_every_shape_of_the_grid(max_cluster):
    """Every B in {8, 16, 32}, C in {1, 2, 3, 6, 10, 26} and 1 <= J <=
    4096 gets a plan, with the non-portable 16-CTA cluster or without it;
    the staged kernel keeps every shape it took (the main path's J = 50
    among them), and each split plan's bytes are its layout's."""
    for B in (8, 16, 32):
        for C in (1, 2, 3, 6, 10, 26):
            for J in range(1, 4097):
                plan = pk.launch_plan(B, J, C, max_cluster=max_cluster)
                assert plan is not None, (B, J, C)
                assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
                staged = pk.staged_smem_bytes(B, J, C)
                assert (plan.kernel == "staged") == (
                    staged <= cuda_build.SMEM_LIMIT), (B, J, C)
                if plan.kernel == "split":
                    assert plan.cluster <= max_cluster
                    assert plan.slice_width == pk.split_slice(J, plan.cluster)
                    assert plan.smem_bytes == pk.split_smem_bytes(
                        B, J, C, plan.cluster, plan.stream)
    assert pk.launch_plan(16, 50, 10).kernel == "staged"


@pytest.mark.parametrize("J,C,cluster,stream", [
    (356, 10, 4, False),    # 400 partitions' neighbour: a 4-CTA ring
    (400, 10, 4, False),
    (138, 26, 4, False),
    (1000, 26, 16, False),  # held only by the non-portable cluster
    (1658, 2, 4, False),
    (4096, 2, 8, False),
    (4096, 10, 16, True),   # past every ring: streamed
    (4096, 26, 16, True),
])
def test_plan_split_at_the_first_shapes_past_one_cta(J, C, cluster, stream):
    """The first J the staged and unstaged kernels refused (356 at C = 10,
    138 at C = 26, 1658 at C = 2) and the scale shapes run the split
    kernel: the smallest cluster that holds two stages of row slices,
    else the largest that streams them."""
    plan = pk.launch_plan(16, J, C)
    assert (plan.kernel, plan.cluster, plan.stream) == ("split", cluster,
                                                        stream)
    assert plan.warps == 16 and plan.classes == C
    assert plan.smem_bytes == pk.split_smem_bytes(16, J, C, cluster, stream)
    if stream:
        assert pk.split_smem_bytes(16, J, C, cluster, False) > \
            cuda_build.SMEM_LIMIT
    eight = pk.launch_plan(16, J, C, max_cluster=8)
    assert eight.kernel == "split" and eight.cluster <= 8


@pytest.mark.parametrize("J,k,width", [(400, 4, 100), (1000, 16, 64),
                                       (4096, 8, 512), (7, 2, 4),
                                       (513, 16, 36)])
def test_split_slice_rounds_to_four_clients(J, k, width):
    assert pk.split_slice(J, k) == width
    assert k * width >= J and width % 4 == 0


def test_bulk_rows_needs_aligned_rows():
    base = torch.zeros(4 * 50 * 10 + 1)
    assert pk.bulk_rows(base[:2000].view(4, 50, 10))
    assert not pk.bulk_rows(base[1:2001].view(4, 50, 10))  # 4 B off
    assert not pk.bulk_rows(base[:4 * 7 * 3].view(4, 7, 3))  # 84 B rows


# -- the kernels on the card ----------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _p_inputs(task, n_val, J, C, B, seed=7, masked=3):
    """CUDA inputs of one p-epoch: logits, labels or targets, p, a
    nonzero momentum buffer, ``cv`` with the last ``masked`` clients
    zeroed (none when J is smaller), and one shuffled epoch.

    The logits are scaled by 1/sqrt(J) so that an SGD step at lr 1e-2
    stays well conditioned at every J: unscaled, lr * |L_b|^2 reaches ~4
    at J=200 and the iteration diverges, and the plain version's own
    fp32 rounding then exceeds TOL against fp64."""
    logits, y, p0 = _mk(task, n_val, J, C, seed=seed)
    logits = (logits / np.sqrt(J)).astype(np.float32)
    rng = np.random.RandomState(seed + 1)
    buf = (0.1 * rng.randn(J)).astype(np.float32)
    cv = np.ones(J, np.float32)
    if J > masked:
        cv[J - masked:] = 0.0
    pos = epoch_batches(n_val, B, generator=torch.Generator().manual_seed(
        seed))[0]
    args = [_t(a).cuda() for a in (p0, buf, cv, logits, y)]
    return args + [pos.to(torch.int32).cuda(),
                   batch_valid(pos, n_val).cuda()]


def _kernel_vs_plain(args, task, momentum=0.9, kernel=None, guard=None,
                     lr=1e-2):
    before = p_epoch.launches
    g = make_guard(guard) if guard else None
    pk_, bk, mk = p_epoch(*args, lr, momentum, task, kernel=kernel, guard=g)
    torch.cuda.synchronize()
    assert p_epoch.launches == before + 1
    pp, bp, mp = p_epoch_plain(*args, lr, momentum, task, guard=g)
    torch.testing.assert_close(pk_, pp, **TOL)
    torch.testing.assert_close(bk, bp, **TOL)
    torch.testing.assert_close(mk, mp, rtol=2e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 33])
@pytest.mark.parametrize("J", [1, 7, 50, 200])
@pytest.mark.parametrize("C", [1, 2, 3, 10, 26])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_kernel_grid_matches_plain_version(task, C, J, B):
    """The kernel the plan names, or its refusal, over a shape grid; the
    last batch is partial (n_val = 3B + 5) and some clients masked."""
    _need_card()
    n_val = 3 * B + 5
    args = _p_inputs(task, n_val, J, C, B)
    if pk.launch_plan(B, J, C) is None:
        with pytest.raises(ValueError, match="shared memory"):
            p_epoch(*args, 1e-2, 0.9, task)
        return
    _kernel_vs_plain(args, task)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["staged", "split", "unstaged"])
@pytest.mark.parametrize("guard", ["clip", "clip:0.5", "simplex"])
def test_cuda_guarded_epoch_matches_plain_version(guard, kernel):
    """Each guard in each kernel's epilogue against the plain epoch with
    the same guard, on one shape all three take (some clients masked),
    at an lr that moves p off the simplex and past the clip radius every
    step; the guard's constraint holds at the end."""
    _need_card()
    args = _p_inputs("classification", 200, 50, 10, 16)
    args[0] = 3.0 * args[0]
    before = dict(p_epoch.launches_by_kernel)
    _kernel_vs_plain(args, "classification", kernel=kernel, guard=guard,
                     lr=0.5)
    assert p_epoch.launches_by_kernel[kernel] == before[kernel] + 1
    p, _, _ = p_epoch(*args, 0.5, 0.9, "classification", kernel=kernel,
                      guard=make_guard(guard))
    if guard == "simplex":
        assert abs(float(p.sum()) - 1) < 1e-5
        assert bool((p[args[2] == 0] == 0).all()) and float(p.min()) >= 0
    else:
        radius = float(guard.split(":")[1]) if ":" in guard else 1.0
        assert float(torch.linalg.norm(p)) <= radius * (1 + 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [None, "clip", "simplex"])
@pytest.mark.parametrize("J,C", [(400, 10), (1000, 26), (4096, 2),
                                 (4096, 10), (4096, 26)])
def test_cuda_split_kernel_matches_plain_version(J, C, guard):
    """The split kernel at the J the one-CTA kernels refused, holding its
    row slices (J = 400, 1000, 4096 at C = 2) or streaming them (J = 4096
    at C = 10, 26), with and without a guard."""
    _need_card()
    args = _p_inputs("classification", 200, J, C, 16)
    plan = pk.launch_plan(16, J, C, max_cluster=pk.split_max_cluster(0))
    assert plan.kernel == "split"
    before = dict(p_epoch.launches_by_kernel)
    _kernel_vs_plain(args, "classification", guard=guard)
    assert p_epoch.launches_by_kernel["split"] == before["split"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 33])
@pytest.mark.parametrize("task,C", [("classification", 3),
                                    ("regression", 1), ("classification", 5)])
def test_cuda_split_kernel_other_batches(task, C, B):
    """B = 8 (one row a warp, 8 warps) and B = 33 (three rows on warp
    0), an odd C (5: the 8-class instantiation) and J*C not a multiple of
    4 (element-wise copies of the slices), each past the staged kernel."""
    _need_card()
    J = 4001
    args = _p_inputs(task, 3 * B + 5, J, C, B)
    plan = pk.launch_plan(B, J, C)
    assert plan.kernel == "split" and not pk.bulk_rows(args[3])
    _kernel_vs_plain(args, task)


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("task,C", [("classification", 10), ("regression", 1)])
def test_cuda_kernel_main_shapes(task, C, momentum):
    """n_val 11983, J 50, B 16: 749 steps, the last one of 15 rows."""
    _need_card()
    args = _p_inputs(task, 11983, 50, C, 16)
    assert pk.launch_plan(16, 50, C).kernel == "staged"
    assert float(args[-1][-1].sum()) == 15.0
    before = dict(p_epoch.launches_by_kernel)
    _kernel_vs_plain(args, task, momentum)
    assert p_epoch.launches_by_kernel["staged"] == before["staged"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("J,C", [(7, 3), (50, 10)])
def test_cuda_kernel_unaligned_rows(J, C):
    """Element-wise cp.async: J*C odd (7*3), or the logits 4 bytes off a
    16-byte boundary (50*10)."""
    _need_card()
    args = _p_inputs("classification", 200, J, C, 16)
    logits = args[3]
    if (J * C) % 4 == 0:
        buf = torch.empty(logits.numel() + 1, device="cuda")
        args[3] = buf[1:].view(logits.shape)
        args[3].copy_(logits)
    assert not pk.bulk_rows(args[3])
    _kernel_vs_plain(args, "classification")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["staged", "split", "unstaged"])
def test_cuda_both_kernels_on_one_shape(kernel):
    _need_card()
    args = _p_inputs("classification", 500, 50, 10, 16)
    before = dict(p_epoch.launches_by_kernel)
    _kernel_vs_plain(args, "classification", kernel=kernel)
    assert p_epoch.launches_by_kernel[kernel] == before[kernel] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("J,guard", [(50, None), (400, None), (4096, None),
                                     (50, "simplex"), (400, "simplex"),
                                     (400, "clip")])
@pytest.mark.parametrize("task,C", [("classification", 10), ("regression", 1)])
def test_cuda_kernel_is_deterministic(task, C, J, guard):
    """Two launches give bitwise-identical p, buf and metrics: the staged
    kernel (J = 50) and the split one (400, and 4096 streamed at C = 10),
    guarded or not (fixed-order sums, no atomics)."""
    _need_card()
    args = _p_inputs(task, 2000, J, C, 16)
    g = make_guard(guard) if guard else None
    a = p_epoch(*args, 1e-2, 0.9, task, guard=g)
    b = p_epoch(*args, 1e-2, 0.9, task, guard=g)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


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
