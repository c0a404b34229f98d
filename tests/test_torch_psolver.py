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

import hashlib

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
    make_guard, project_simplex, project_simplex_fixed_point,
    simplex_fixed_point, warp_order_sum)
from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches
from torch_threads import one_torch_thread  # noqa: F401

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
                                    ("regression", 1),
                                    ("classification", 33),
                                    ("classification", 105)])
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
    on_simplex = rng.dirichlet(np.ones(40))
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
        # the guard warp's lanes: one client, a partial warp, one full
        # warp, one client past it, several rows of lanes
        "J=1": (rng.randn(1), None),
        "J=31": (rng.randn(31), None),
        "J=32": (rng.randn(32), rng.rand(32) > 0.2),
        "J=33": (rng.randn(33), None),
        "J=400": (rng.randn(400) * 0.1, rng.rand(400) > 0.1),
        "J=1024": (rng.randn(1024) * 0.05, None),
        # entries equal to the final theta leave the support (p_j > theta)
        "ties at theta": (np.array([1.5, 0.5, 0.5, 0.5]), None),
        "every entry above theta": (0.1 + 0.01 * rng.rand(50), None),
        "one valid of 1024": (rng.randn(1024), np.eye(1024)[700] > 0),
        "none valid of 33": (rng.randn(33), np.zeros(33, bool)),
        "on the simplex": (on_simplex, None),
        # the support shrinks over 7 rounds
        "one large among 1024": (np.r_[1.0, rng.exponential(0.01, 1023)],
                                 None),
        "one ulp above theta": (_one_ulp_above_theta(), None),
    }


def _one_ulp_above_theta():
    """50 entries, one of them the next float above the projection's
    theta: within the sums' rounding, the support's size alternates
    between two values every round unless a round whose theta does not
    rise ends the fixed point (it ran to J + 1 rounds without that)."""
    v = (np.random.RandomState(12).rand(50) * 2.0 / 50).astype(np.float32)
    theta = simplex_fixed_point(_t(v))[2]
    v[14] = np.nextafter(np.float32(theta), np.float32(np.inf))
    return v


def _jax_projection(v, valid):
    """The JAX package's ``project_simplex`` of ``v`` over ``valid``
    through one shape (one compilation for every case): ``v`` padded to
    4096 clients with invalid ones, which the projection zeroes and
    leaves out of its support."""
    J, n = v.shape[0], 4096
    pv, pm = np.zeros(n, np.float32), np.zeros(n, np.float32)
    pv[:J] = v
    pm[:J] = 1.0 if valid is None else valid
    out = np.asarray(jproject_simplex(jnp.asarray(pv), jnp.asarray(pm)))
    assert not out[J:].any()
    return out[:J]


@pytest.mark.parametrize("case", sorted(_simplex_cases()))
def test_fixed_point_simplex_matches_jax(case):
    """Michelot's fixed point (the kernels' simplex guard), with the sums in
    the guard warp's order, against the JAX package's sort-based
    projection, atol 1e-6; the port's sort-based one agrees too."""
    v, valid = _simplex_cases()[case]
    v = v.astype(np.float32)
    valid = None if valid is None else valid.astype(np.float32)
    want = _jax_projection(v, valid)
    vt = _t(v)
    mt = None if valid is None else _t(valid)
    got = project_simplex_fixed_point(vt, mt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(project_simplex(vt, mt).numpy(), want,
                               rtol=0, atol=1e-6)
    if valid is None or valid.any():
        assert abs(float(got.sum()) - 1.0) < 1e-5 and got.min() >= 0
    else:
        assert not got.any()
    if valid is not None:
        assert not got[valid == 0].any()
    _, rounds, theta = simplex_fixed_point(vt, mt)
    if case == "one large among 1024":
        assert rounds >= 6
    if case in ("every entry above theta", "J=1"):
        assert rounds == 1
    if case == "one ulp above theta":
        assert rounds <= 3
    if case == "ties at theta":
        np.testing.assert_array_equal(got, [1.0, 0.0, 0.0, 0.0])
    # the kernels start each step's fixed point from the last step's theta:
    # from below, above (none or few pass it), or at it, the same
    # projection; at it the support holds, and one round confirms it
    for start in (theta, theta - 0.05, theta + 0.05, theta + 1e3, -1e3):
        warm, r, t = simplex_fixed_point(vt, mt, start)
        np.testing.assert_allclose(warm.numpy(), want, rtol=0, atol=1e-6)
        if valid is None or valid.any():
            assert r >= 1
            if start == theta and case != "one ulp above theta":
                assert r == 1 and t == theta


@pytest.mark.parametrize("J", [1, 31, 32, 33, 50, 400, 1024])
def test_warp_order_sum_is_the_guard_warps(J):
    """``warp_order_sum`` against a lane-by-lane emulation of the guard
    warp in float32: lane l sums clients l, l + 32, ... in order, then
    each butterfly level adds lane l ^ o's value to lane l's; every lane
    ends with the mirror's bits."""
    v = np.random.RandomState(J).randn(J).astype(np.float32)
    lanes = np.zeros(32, np.float32)
    for j in range(J):
        lanes[j % 32] = np.float32(lanes[j % 32] + v[j])
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
    got = warp_order_sum(torch.from_numpy(v))
    assert (lanes == lanes[0]).all()
    assert got.dtype == torch.float32 and float(got) == float(lanes[0])


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
    (16, 50, 33, 20000, "split_tiled"),  # past the unstaged one at 33
    (16, 50, 105, cuda_build.SMEM_LIMIT, "split_tiled"),  # sector's shape
    (600, 50, 105, cuda_build.SMEM_LIMIT, None),  # B > 512 past unstaged
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
                                          "unstaged": 0, "split_tiled": 0}


@pytest.mark.parametrize("B,J,C,kernel", [
    (16, 170, 10, "staged"),    # the widest J two stages hold at B=16
    (16, 171, 10, "split"),     # past two stages: J split over a cluster
    (16, 355, 10, "split"),     # the widest J the unstaged kernel held
    (16, 50, 33, "split_tiled"),  # no staged instantiation above 32
                                  # classes: the class-tiled split kernel
    (513, 2, 1, "unstaged"),    # more rows than 16 warps' lanes
    (513, 2, 33, "unstaged"),
    (16, 50, 70, "split_tiled"),  # the unstaged kernel's widest C at J = 50
    (16, 50, 71, "split_tiled"),
    (16, 50, 1000, "split_tiled"),
])
def test_plan_chooses_kernel(B, J, C, kernel):
    plan = pk.launch_plan(B, J, C)
    assert plan.kernel == kernel
    assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
    if kernel == "split_tiled":
        assert plan.classes == 0
        assert plan.smem_bytes == pk.tiled_layout(B, J, C, plan.cluster)[0]
        assert pk.kernel_symbol(plan, C) == \
            "26split_tiled_p_epoch_kernelILb0ELb0EE"
        assert pk.kernel_symbol(plan, C, guarded=True) == \
            "26split_tiled_p_epoch_kernelILb0ELb1EE"
    if kernel == "split":
        assert plan.smem_bytes == pk.split_smem_bytes(B, J, C, plan.cluster,
                                                      plan.stream)
        assert pk.kernel_symbol(plan, C) == \
            "20split_p_epoch_kernelILi10ELb1ELb0E"
        assert pk.kernel_symbol(plan, C, guarded=True) == \
            "20split_p_epoch_kernelILi10ELb1ELb1E"
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
    """More than 32 classes at B <= 512 take the class-tiled split plan
    (J = 4096 at C = 33 among them, and J = 100,000 at C = 1,000, its
    state in global memory and its ring streamed); no plan past B = 512
    and the unstaged kernel, nor where two stages of one row's class
    slice and one client pass a block even over 16 CTAs; a forced kernel
    that does not fit raises, the staged kernel at more than 32 classes
    among them."""
    assert pk.launch_plan(16, 4096, 33).kernel == "split_tiled"
    huge = pk.launch_plan(16, 100000, 1000)
    assert (huge.kernel, huge.global_state, huge.stream) == ("split_tiled",
                                                             True, True)
    assert pk.launch_plan(600, 50, 105) is None
    assert pk.launch_plan(16, 50, 400000) is None
    with pytest.raises(ValueError, match="does not fit"):
        pk.launch_plan(16, 50, 33, kernel="staged")
    with pytest.raises(ValueError, match="does not fit"):
        pk.launch_plan(16, 50, 105, kernel="split")
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
            for C in (1, 2, 3, 10, 26, 32, 33, 64, 71, 100, 105, 1000):
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


def _split_smem_before_the_push_exchange(B, J, C, k, stream):
    """Shared memory of one CTA of the split kernel's first layout (two
    stages of ``B`` rows of the slice unless streamed, ``h (B, Jk)``,
    ``p``, ``buf``, ``cv``, the per-warp sums and two slots of every
    row's partial logits)."""
    nw, jk = pk.staged_warps(B), pk.split_slice(J, k)
    ring = 0 if stream else 2 * B * jk * C
    xs = -(-max(B * C, 2) // 4) * 4
    return 16 * nw + 4 * (ring + B * jk + 3 * jk + 4 * nw + 2 * xs)


def _plan_before_the_tiled_kernel(B, J, C, smem_limit, max_cluster):
    """``launch_plan`` as it was before the class-tiled split kernel:
    (kernel, warps, classes, smem_bytes, cluster, slice_width, stream),
    or None; the split kernel's with its first layout."""
    nc = pk.staged_classes(C)
    if B <= pk.MAX_STAGED_BATCH and nc:
        smem = pk.staged_smem_bytes(B, J, C)
        if smem <= smem_limit:
            return ("staged", pk.staged_warps(B), nc, smem, 1, 0, False)
        sizes = [k for k in (2, 4, 8, 16) if k <= max_cluster]
        for stream, order in ((False, sizes), (True, sizes[::-1])):
            for k in order:
                smem = _split_smem_before_the_push_exchange(B, J, C, k,
                                                             stream)
                if smem <= smem_limit:
                    return ("split", pk.staged_warps(B), nc, smem, k,
                            pk.split_slice(J, k), stream)
    smem = pk.unstaged_smem_bytes(B, J, C)
    if smem <= smem_limit:
        return ("unstaged", 8, 0, smem, 1, 0, False)
    return None


def _tiled_smem_before_the_redesign(B, J, C, k, stream):
    """Shared memory of one CTA of the class-tiled split kernel's first
    design (J over the cluster): two mbarriers a warp, two stages of its
    slices of ``B`` rows unless streamed, ``h`` of a group of a row a
    warp, its slices of p, buf, cv and g, the per-warp sums and two
    exchange slots of ``NW*C`` floats."""
    nw, jk = pk.staged_warps(B), pk.split_slice(J, k)
    ring = 0 if stream else 2 * B * jk * C
    xs = -(-max(nw * C, 2) // 4) * 4
    return 16 * nw + 4 * (ring + nw * jk + 4 * jk + 4 * nw + 2 * xs)


def _kernel_before_the_redesign(B, J, C, smem_limit, max_cluster):
    """``launch_plan``'s kernel before the class-tiled split kernel's
    redesign, or None: the staged and split kernels, then the unstaged
    kernel, then, at ``B <= 512``, the first class-tiled design where its
    slices fit a block, held or streamed, at some cluster of 2 to 16."""
    nc = pk.staged_classes(C)
    if B <= pk.MAX_STAGED_BATCH and nc:
        if pk.staged_smem_bytes(B, J, C) <= smem_limit:
            return "staged"
        if pk._split_plan(B, J, C, nc, smem_limit, max_cluster) is not None:
            return "split"
    if pk.unstaged_smem_bytes(B, J, C) <= smem_limit:
        return "unstaged"
    sizes = [k for k in pk.SPLIT_CLUSTERS if k <= max_cluster]
    if B <= pk.MAX_STAGED_BATCH and any(
            _tiled_smem_before_the_redesign(B, J, C, k, stream) <= smem_limit
            for k in sizes for stream in (False, True)):
        return "split_tiled"
    return None


GRID_MANY_C = (33, 64, 71, 105, 1000)


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_keeps_every_shape_taken_before_the_tiled_kernel(max_cluster):
    """Every shape that had a plan keeps one, at the card's block and a
    smaller one. Against the plan before the class-tiled split kernel:
    the staged plans and the unstaged plans at ``C <= 32`` or ``B > 512``
    field for field, a split plan with the redesigned kernel's layout
    (``split_layout`` at its cluster, its slices covering J). The
    unstaged kernel's shapes past 32 classes at ``B <= 512`` (C = 33 to
    70 at J = 50 among them) now run the class-tiled split kernel, which
    the card measured faster there (PERF.md § 6). Every shape the first
    class-tiled design took (``_kernel_before_the_redesign``) runs the
    redesigned one; B > 512 past the unstaged kernel still has none."""
    fields = ("kernel", "warps", "classes", "smem_bytes", "cluster",
              "slice_width", "stream")
    for smem_limit in (cuda_build.SMEM_LIMIT, 40000):
        for B in (1, 8, 16, 17, 32, 33, 64, 256, 512, 513, 1024):
            for J in (1, 2, 7, 50, 100, 171, 356, 1000, 4096):
                for C in (1, 2, 3, 10, 26, 32, 33, 50, 64, 70, 71, 105,
                          1000):
                    old = _plan_before_the_tiled_kernel(B, J, C, smem_limit,
                                                        max_cluster)
                    new = pk.launch_plan(B, J, C, smem_limit=smem_limit,
                                         max_cluster=max_cluster)
                    shape = (smem_limit, B, J, C, max_cluster)
                    tiled = pk._tiled_plan(B, J, C, smem_limit, max_cluster)
                    if new is not None:
                        assert new.smem_bytes <= smem_limit, shape
                    if old is not None and old[0] == "split":
                        assert new.kernel == "split", shape
                        smem, tile, stages, warps = pk.split_layout(
                            B, J, C, new.cluster, new.stream, smem_limit)
                        assert (new.smem_bytes, new.tile, new.stages,
                                new.warps, new.classes) == (
                            smem, tile, stages, warps, old[2]), shape
                        assert new.cluster <= max_cluster, shape
                        assert new.cluster * new.slice_width >= J, shape
                        continue
                    if (old is not None and old[0] == "unstaged" and C > 32
                            and B <= pk.MAX_STAGED_BATCH):
                        assert new == tiled and tiled is not None, shape
                        continue
                    if old is not None:
                        assert tuple(getattr(new, f) for f in fields) == old, \
                            shape
                        continue
                    before = _kernel_before_the_redesign(B, J, C, smem_limit,
                                                         max_cluster)
                    if before == "split_tiled":
                        assert new is not None, shape
                    if B > pk.MAX_STAGED_BATCH or tiled is None:
                        assert new is None, shape
                        continue
                    assert new == tiled and new.kernel == "split_tiled", shape
                    assert new.cluster <= min(max_cluster, C), shape


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_takes_every_shape_past_32_classes(max_cluster):
    """B in {8, 16, 32}, C in {33, 64, 71, 105, 1000} and every J up to
    1024 run the class-tiled split kernel: its cluster within the limit
    and C, its layout ``tiled_layout``'s at that size (rows, tile of
    clients, stages, g's exchange, where the state lives), its slice the
    classes' padded width. At the sector stand-in's shape 8 CTAs of 13 or
    14 classes hold a group of all 16 rows; at aloi's 16 CTAs of 62 or 63
    hold groups of 8. Forced at C = 10 its own rule's size; at B = 512
    groups of 16 rows, so the statistics slots hold 16 rows whatever B."""
    for B in (8, 16, 32):
        for C in GRID_MANY_C:
            for J in range(1, 1025):
                plan = pk.launch_plan(B, J, C, max_cluster=max_cluster)
                assert plan.kernel == "split_tiled", (B, J, C)
                assert plan.cluster <= min(max_cluster, C), (B, J, C)
                assert plan.slice_width == pk.tiled_width(C, plan.cluster)
                lay = pk.tiled_layout(B, J, C, plan.cluster)
                assert (plan.smem_bytes, plan.rows, plan.tile, plan.stages,
                        plan.gchunk, plan.global_state) == lay, (B, J, C)
                assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
                assert plan.stream == (plan.tile < J)
    plan = pk.launch_plan(16, 50, 105)
    assert (plan.cluster, plan.slice_width, plan.stream, plan.rows) == (
        8, 16, False, 16)
    plan = pk.launch_plan(16, 50, 1000)
    assert (plan.cluster, plan.slice_width, plan.stream, plan.rows) == (
        16, 64, False, 8)
    # forced at C = 10: 4 CTAs of 2 or 3 classes padded to 4, 4 stages of
    # 16 rows; 128 bytes of mbarriers, then floats: 2 information slots of
    # 36, the ring 4*16*50*4, z and d 2*16*4, statistics 8*4*16, g 2*4*52,
    # the per-warp sums 64, p, buf, cv and g 4*52
    forced = pk.launch_plan(16, 50, 10, kernel="split_tiled")
    assert forced == pk.PEpochPlan(
        "split_tiled", 16, 0, 128 + 4 * (72 + 12800 + 128 + 512 + 416 + 64
                                         + 208),
        4, 4, False, 50, 4, 16, 52, False)
    wide_b = pk.launch_plan(512, 50, 1000)
    assert wide_b.kernel == "split_tiled" and wide_b.rows <= 16


@pytest.mark.parametrize("J,C,cluster", [
    (50, 105, 8),    # sector's C: 0.431 ms against 0.467 at 4, 0.452 at 16
    (50, 1000, 16),  # aloi's
    (50, 33, 8),     # 0.386 at 4 and 8
    (50, 53, 8),     # rcv1.multiclass's C
    (50, 70, 8),
    (10, 105, 4),
    (200, 105, 16),
    (400, 105, 16),
    (4, 40, 2),
])
def test_plan_tiled_cluster_rule_is_the_measured_one(J, C, cluster):
    """The class-tiled split kernel's cluster (``_split_tiled_cluster``,
    the least ``tiled_step_us``) is the size measured fastest on an H100
    at each shape of its fit (B = 16; ``tools/p_epoch_phases.py
    --cluster all``); with 8 CTAs at most, the fastest of those."""
    plan = pk.launch_plan(16, J, C)
    assert (plan.kernel, plan.cluster) == ("split_tiled", cluster)
    cost = {k: pk.tiled_step_us(16, J, C, k, *(lambda lay: (
        lay[1], lay[2] < J))(pk.tiled_layout(16, J, C, k)))
        for k in pk.TILED_CLUSTERS if k <= C}
    assert plan.cluster == min(cost, key=lambda k: (cost[k], -k))
    eight = pk.launch_plan(16, J, C, max_cluster=8)
    assert eight.cluster == min((k for k in cost if k <= 8),
                                key=lambda k: (cost[k], -k))


@pytest.mark.parametrize("J,C,cluster,stream", [
    (356, 10, 4, False),    # 400 partitions' neighbour: a 4-CTA ring
    (400, 10, 8, False),
    (138, 26, 8, False),
    (1000, 26, 16, True),   # the push exchange's slots leave no ring
    (1658, 2, 8, False),
    (4096, 2, 16, False),
    (4096, 10, 16, True),   # past every ring: streamed
    (4096, 26, 16, True),
])
def test_plan_split_at_the_first_shapes_past_one_cta(J, C, cluster, stream):
    """J past the staged kernel's two stages and past where the unstaged
    kernel's block stops fitting (356 at C = 10, 138 at C = 26, 1658 at
    C = 2; ``launch_plan(16, J, 10)`` already moves from the staged to
    the split plan at J = 171) and the scale shapes run the split
    kernel on the measured rule's cluster (``_split_cluster``): the
    smallest that holds its row slices with a lane's share of a row at
    most ``SPLIT_LANE_FLOATS``, else the largest that holds, else the
    largest that streams them."""
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


@pytest.mark.parametrize("max_cluster,J,C,cluster,stream", [
    (16, 400, 10, 8, False),   # 2.20 ms against 2.72 at 4 and 2.47 at 16
    (16, 1024, 7, 8, False),   # the zoo's covtype_1024
    (16, 1000, 26, 16, True),  # every size streams: the largest
    (16, 4096, 2, 16, False),  # 8 holds with 16 clients a lane: too many
    (8, 400, 10, 8, False),
    (8, 1024, 7, 8, False),
    (8, 1000, 26, 8, True),
    (8, 4096, 2, 8, False),    # none holds few enough: the largest that does
])
def test_plan_split_cluster_follows_the_measured_rule(max_cluster, J, C,
                                                      cluster, stream):
    """The split kernel's cluster, with and without the non-portable
    16-CTA cluster, is the rule fitted to the card's readings
    (``psolver_kernel._split_cluster``); the ring is ``split_layout``'s at
    that size, holding a tile of the whole slice or streaming narrower
    tiles, with two stages at least."""
    plan = pk.launch_plan(16, J, C, max_cluster=max_cluster)
    assert (plan.kernel, plan.cluster, plan.stream) == ("split", cluster,
                                                        stream)
    smem, tile, stages, warps = pk.split_layout(16, J, C, cluster, stream)
    assert (plan.smem_bytes, plan.tile, plan.stages, plan.warps) == (
        smem, tile, stages, warps)
    assert stages >= 2 and (stream or tile == plan.slice_width)
    jk = plan.slice_width
    lane_floats = -(-jk // 32) * (C + 4)
    smaller = [k for k in pk.SPLIT_CLUSTERS if k < cluster]
    if not stream and lane_floats <= pk.SPLIT_LANE_FLOATS:
        # no smaller size holds few enough
        for k in smaller:
            held = pk.split_layout(16, J, C, k, False)[0] <= \
                cuda_build.SMEM_LIMIT
            assert not held or -(-pk.split_slice(J, k) // 32) * (C + 4) > \
                pk.SPLIT_LANE_FLOATS
    # a forced size takes its own layout, and a size that fits neither
    # way is refused
    forced = pk.launch_plan(16, J, C, kernel="split", cluster=2)
    assert forced.cluster == 2 and forced.smem_bytes <= cuda_build.SMEM_LIMIT
    with pytest.raises(ValueError, match="cluster must be"):
        pk.launch_plan(16, J, C, cluster=3)


# sha256 of the reprs of launch_plan(B, J, C, smem_limit=..., max_cluster=...)
# over _frozen_plan_grid(), in its order, as the plans were before the
# guard's gather (computed from that commit's psolver_kernel.py)
PLANS_BEFORE_THE_GUARD_GATHER = (
    "e8e838e27fa9706acd5917b985dff5f4bf8d0d7ccde64bb4af71b4ab31317996")


def _frozen_plan_grid():
    for smem_limit in (cuda_build.SMEM_LIMIT, 40000):
        for max_cluster in (16, 8):
            for B in (1, 8, 16, 33, 512, 513):
                for J in (1, 50, 171, 356, 400, 512, 1000, 1024, 4096):
                    for C in (1, 2, 7, 10, 26, 33, 105):
                        yield B, J, C, smem_limit, max_cluster


def test_plan_unguarded_keeps_every_kernel_and_cluster():
    """Every unguarded plan is what it was before the split kernel's guard
    gathered p (every field: kernel, cluster, layout; frozen as a digest of
    the grid's plans). A guarded plan differs only where the split kernel
    runs: its layout holds the gather (``split_guard_floats`` more floats
    a CTA, the ring refitted around them), in a size that fits; every
    other kernel's guarded plan is its unguarded one."""
    digest = hashlib.sha256()
    for B, J, C, smem_limit, max_cluster in _frozen_plan_grid():
        kw = dict(smem_limit=smem_limit, max_cluster=max_cluster)
        plan = pk.launch_plan(B, J, C, **kw)
        digest.update(repr(plan).encode())
        if plan is None or plan.kernel != "split":
            assert pk.launch_plan(B, J, C, guarded=True, **kw) == plan
            continue
        guarded = pk.launch_plan(B, J, C, guarded=True, **kw)
        assert guarded.smem_bytes <= smem_limit
        if guarded.kernel == "split":
            assert (guarded.smem_bytes, guarded.tile, guarded.stages,
                    guarded.warps) == pk.split_layout(
                B, J, C, guarded.cluster, guarded.stream, smem_limit,
                guarded=True)
            assert guarded.smem_bytes == 4 * pk.split_guard_floats(
                J, guarded.cluster) + pk.split_ring_bytes(
                B, J, C, guarded.cluster, guarded.warps, guarded.tile,
                guarded.stages)
    assert digest.hexdigest() == PLANS_BEFORE_THE_GUARD_GATHER
    # the shapes the guard runs on the split plan in chip_smoke.py and the
    # zoo keep their clusters, guarded or not
    for J, C, k in ((400, 10, 8), (512, 10, 8), (1024, 7, 8)):
        for guarded in (False, True):
            plan = pk.launch_plan(16, J, C, guarded=guarded)
            assert (plan.kernel, plan.cluster, plan.stream) == (
                "split", k, False)


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
@pytest.mark.parametrize("n_val", [200, 11983])
@pytest.mark.parametrize("kernel", ["staged", "split", "unstaged"])
@pytest.mark.parametrize("guard", ["clip", "clip:0.5", "simplex"])
def test_cuda_guarded_epoch_matches_plain_version(guard, kernel, n_val):
    """Each guard in each kernel's epilogue against the plain epoch with
    the same guard, on one shape all three take (some clients masked),
    at an lr that moves p off the simplex and past the clip radius every
    step, over 13 steps and over the main path's 749; the guard's
    constraint holds at the end."""
    _need_card()
    args = _p_inputs("classification", n_val, 50, 10, 16)
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
@pytest.mark.parametrize("guard", [None, "clip", "simplex"])
@pytest.mark.parametrize("k", [2, 4, 8, 16])
@pytest.mark.parametrize("J,C", [(400, 10), (512, 10), (1024, 7),
                                 (1000, 26)])
def test_cuda_split_kernel_at_every_cluster(J, C, k, guard):
    """The split kernel with its cluster forced to each size (held slices
    or a streamed ring, whichever the layout gives), unguarded and with
    each guard (the gather of p over 2 to 16 CTAs)."""
    _need_card()
    if k > pk.split_max_cluster(0):
        pytest.skip(f"this card schedules no {k}-CTA cluster")
    args = _p_inputs("classification", 200, J, C, 16)
    before = dict(p_epoch.launches_by_kernel)
    g = make_guard(guard) if guard else None
    pk_, bk, mk = p_epoch(*args, 1e-2, 0.9, "classification",
                          kernel="split", guard=g, cluster=k)
    torch.cuda.synchronize()
    assert p_epoch.launches_by_kernel["split"] == before["split"] + 1
    pp, bp, mp = p_epoch_plain(*args, 1e-2, 0.9, "classification", guard=g)
    torch.testing.assert_close(pk_, pp, **TOL)
    torch.testing.assert_close(bk, bp, **TOL)
    torch.testing.assert_close(mk, mp, rtol=2e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["split", "split_tiled"])
def test_cuda_guard_support_shrinks_over_many_rounds(kernel):
    """One large entry among 1,023 small ones, exponentially spread (J =
    1024, C = 7): the first step's projection shrinks its support over
    five rounds or more (``simplex_fixed_point`` takes 8 on p0 itself, the
    kernels' first step starting cold), on the split plan and forced onto
    the class-tiled one; against the plain epoch, and the kernel's rounds
    counter sees those rounds."""
    _need_card()
    args = _p_inputs("classification", 300, 1024, 7, 16)
    rng = np.random.RandomState(3)
    p0 = np.r_[1.0, rng.exponential(0.01, 1023)].astype(np.float32)
    args[0] = _t(p0).cuda()
    args[2] = torch.ones(1024, device="cuda")
    _kernel_vs_plain(args, "classification", kernel=kernel, guard="simplex")
    rounds = torch.zeros(2, dtype=torch.int32, device="cuda")
    p_epoch(*args, 1e-2, 0.9, "classification", kernel=kernel,
            guard=make_guard("simplex"), guard_rounds=rounds)
    torch.cuda.synchronize()
    assert int(rounds[1]) >= 5
    assert simplex_fixed_point(_t(p0))[1] >= 6


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [None, "clip", "simplex"])
@pytest.mark.parametrize("J,C,nc", [(1024, 7, 8), (512, 10, 10)])
def test_cuda_split_kernel_zoo_shape(J, C, nc, guard):
    """The zoo's p-solves, covtype_1024 (J = 1024, C = 7: the rounded
    8-class instantiation) and mnist_conv_512 (J = 512, C = 10), at a
    small n_val, bitwise on repeat."""
    _need_card()
    args = _p_inputs("classification", 300, J, C, 16)
    plan = pk.launch_plan(16, J, C, max_cluster=pk.split_max_cluster(0),
                          guarded=guard is not None)
    assert (plan.kernel, plan.classes) == ("split", nc)
    _kernel_vs_plain(args, "classification", guard=guard)
    g = make_guard(guard) if guard else None
    a = p_epoch(*args, 1e-2, 0.9, "classification", guard=g)
    b = p_epoch(*args, 1e-2, 0.9, "classification", guard=g)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("guard", ["clip", "simplex"])
@pytest.mark.parametrize("B,J,C", [(8, 4096, 10), (33, 4001, 3),
                                   (33, 400, 10)])
def test_cuda_split_kernel_other_batches_guarded(B, J, C, guard):
    """A guard with B = 8 (streamed at J = 4096, C = 10) and B = 33 (three
    groups of rows, one exchange a group; J*C odd: element-wise copies),
    bitwise on repeat."""
    _need_card()
    args = _p_inputs("classification", 3 * B + 5, J, C, B)
    assert pk.launch_plan(B, J, C).kernel == "split"
    _kernel_vs_plain(args, "classification", guard=guard)
    g = make_guard(guard)
    a = p_epoch(*args, 1e-2, 0.9, "classification", guard=g)
    b = p_epoch(*args, 1e-2, 0.9, "classification", guard=g)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


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


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [None, "clip", "simplex"])
@pytest.mark.parametrize("J,C", [(50, 33), (50, 53), (50, 105), (50, 1000),
                                 (400, 1000)])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_tiled_split_kernel_matches_plain_version(task, J, C, guard):
    """The class-tiled split kernel by plan at B = 16: J = 50 at C = 33,
    53 (rcv1.multiclass's), 105 (sector's) and 1,000 (aloi's), and
    J = 400 at C = 1,000, where the ring streams tiles of clients and g
    goes over the cluster in two exchanges; unguarded and with each
    guard."""
    _need_card()
    args = _p_inputs(task, 200, J, C, 16)
    plan = pk.launch_plan(16, J, C, max_cluster=pk.split_max_cluster(0))
    assert plan.kernel == "split_tiled"
    assert plan.stream == (J == 400) and (plan.gchunk < J) == (J == 400)
    before = dict(p_epoch.launches_by_kernel)
    _kernel_vs_plain(args, task, guard=guard)
    assert p_epoch.launches_by_kernel["split_tiled"] == \
        before["split_tiled"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [None, "simplex"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("C", [53, 105])
def test_cuda_tiled_split_kernel_at_every_cluster(C, k, guard):
    """The class-tiled split kernel forced to each cluster size at J = 50,
    B = 16: classes [qC/k, (q+1)C/k) a CTA, one CTA to 16."""
    _need_card()
    if k > pk.split_max_cluster(0):
        pytest.skip(f"this card schedules no {k}-CTA cluster")
    args = _p_inputs("classification", 200, 50, C, 16)
    g = make_guard(guard) if guard else None
    pk_, bk, mk = p_epoch(*args, 1e-2, 0.9, "classification",
                          kernel="split_tiled", guard=g, cluster=k)
    torch.cuda.synchronize()
    pp, bp, mp = p_epoch_plain(*args, 1e-2, 0.9, "classification", guard=g)
    torch.testing.assert_close(pk_, pp, **TOL)
    torch.testing.assert_close(bk, bp, **TOL)
    torch.testing.assert_close(mk, mp, rtol=2e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [105, 1000])
def test_cuda_tiled_split_kernel_tie_case(C):
    """Logits constant over the classes: every row's z is flat, so its
    first maximum over all C is class 0 on every CTA (a tie across slices
    goes to rank 0): the hits are exactly the valid label-0 rows."""
    _need_card()
    args = _p_inputs("classification", 200, 50, C, 16)
    args[3] = args[3][:, :, :1].expand(-1, -1, C).contiguous()
    args[4] = torch.where(torch.arange(200, device="cuda") % 3 == 0, 0,
                          args[4]).to(torch.int32)
    _kernel_vs_plain(args, "classification")
    _, _, m = p_epoch(*args, 1e-2, 0.9, "classification")
    pos, valid = args[5].long(), args[6]
    assert float(m[1]) == float(((args[4][pos] == 0).float() * valid).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [None, "simplex"])
def test_cuda_tiled_split_kernel_state_in_global_memory(guard):
    """J = 13,000 at C = 105: p, buf, cv and g leave no room beside the
    ring, so p, buf and g live in a global scratch a CTA
    (``global_state``), the ring streams and g takes 51 exchanges."""
    _need_card()
    args = _p_inputs("classification", 48, 13000, 105, 16)
    plan = pk.launch_plan(16, 13000, 105, max_cluster=pk.split_max_cluster(0))
    assert plan.kernel == "split_tiled" and plan.global_state and plan.stream
    _kernel_vs_plain(args, "classification", guard=guard)


@pytest.mark.cuda
@pytest.mark.parametrize("J,C", [(7, 3), (50, 10), (4001, 5)])
def test_cuda_tiled_split_kernel_forced_at_few_classes(J, C):
    """Forced at 32 classes or fewer: fewer classes a CTA than a quad of
    4 (the class-split layout pads them); J*C odd, whose rows are not
    16-byte multiples in the (n_val, J, C) layout; J = 4001, groups of
    one row."""
    _need_card()
    args = _p_inputs("classification", 200, J, C, 16)
    _kernel_vs_plain(args, "classification", kernel="split_tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [105, 1000])
def test_cuda_tiled_split_kernel_is_deterministic(C):
    """Two launches bitwise equal, with and without the simplex guard
    (fixed-order sums on every CTA, no atomics)."""
    _need_card()
    args = _p_inputs("classification", 500, 50, C, 16)
    for guard in (None, make_guard("simplex")):
        a = p_epoch(*args, 1e-2, 0.9, "classification", guard=guard)
        b = p_epoch(*args, 1e-2, 0.9, "classification", guard=guard)
        torch.cuda.synchronize()
        for u, v in zip(a, b):
            assert torch.equal(u, v)
