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

Rows stored in bfloat16 or float16 (``prepare_setup(feature_dtype=...)``)
are widened to float32 for the product on both sides; the plain version
is held against the JAX package on the same 2-byte matrix, at the same
tolerances (the widening is exact).

Past the staged kernel's shared-memory limit (D = 6,000 at C = 10 with
float32 rows) the plain version is held against the JAX package the same
way: the wide plan runs that shape on the card.

The CUDA kernel itself needs a card; the ``cuda``-marked tests hold it
against the plain version there, over a grid of shapes (both tasks, C in
{1, 3, 10, 32}, D in {256, 250, 2000}, B in {32, 17}, J in {5, 70}),
every cluster size, unaligned rows, 2-byte rows, the unstaged kernel, the
wide kernel (forced at D = 250, 2000 and 6,001 and at B = 300, by shape
at D = 6,000, 10,000 and 40,000 and B = 4096, exact and rounded classes,
every cluster up to 16, 2-byte rows at D = 9,000 and 9,001), the staged
kernel of 2-byte rows (its ring: the main and Centralized shapes, rows
not 16-byte multiples, B = 20, C = 3, 16, 26, every cluster) and bitwise
determinism checks, and skip on a machine without one. The launch plan
(kernel, cluster size, client order, shared-memory bytes, refused
shapes; the 2-byte cluster rule against the times it was fitted to) is
pure Python and tested here on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.fedcore.client import make_client_round as jmake_client_round
from fedamw_tpu.fedcore.client import make_local_update as jmake_local_update
from fedamw_tpu.models import linear_model as jlinear_model
from fedamw_tpu_torch.convert import features_from_jax
from fedamw_tpu_torch.fedcore import (
    client_epoch,
    client_epoch_plain,
    cuda_build,
    make_client_round,
    make_local_update,
)
from fedamw_tpu_torch.fedcore import epoch_kernel as ek
from torch_threads import one_torch_thread  # noqa: F401

N, D, C, B, EPOCHS, N_MAX = 300, 256, 3, 32, 2, 64
W_TOL = dict(atol=2e-5, rtol=1e-5)


def _data(task, seed=0, C=C, D=D):
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


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_plain_epoch_two_byte_rows_match_jax(task, dtype, impl):
    """The same local update on a 2-byte feature matrix: the JAX package
    promotes the rows to float32 in the product, the plain version widens
    them; the same tolerances as float32 rows."""
    X, y, w0 = _data(task)
    Xn = np.asarray(jnp.asarray(X).astype(dtype))
    Xt = features_from_jax(Xn)
    assert Xt.dtype == getattr(torch, dtype)
    idx, mask = _client(50)
    key = jax.random.PRNGKey(9)
    apply_fn = jlinear_model().apply if impl == "xla" else None
    lu_j = jmake_local_update(apply_fn, task, EPOCHS, B, N_MAX,
                              kernel_impl=impl)
    wj, lj, aj = lu_j({"w": jnp.asarray(w0)}, jnp.asarray(Xn),
                      jnp.asarray(y), jnp.asarray(idx), jnp.asarray(mask),
                      key, jnp.float32(0.1), jnp.float32(0.05),
                      jnp.float32(0.01))
    lu_t = make_local_update(task, EPOCHS, B, N_MAX)
    wt, lt, at = lu_t({"w": _t(w0)}, Xt, _t(y), _t(idx).long(), _t(mask),
                      _t(_positions(key, mask)), 0.1, 0.05, 0.01)
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


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_plain_round_matches_jax_past_the_shared_memory_limit(task, impl):
    """D = 6,000 at C = 10: past what the staged kernel holds with float32
    rows (5,376), the shape the wide plan takes on the card. Rows scaled
    to D = 256's squared norm, as ``_epoch_inputs`` does."""
    Cw, Dw, J = 10, 6000, 2
    X, y, w0 = _data(task, seed=5, C=Cw, D=Dw)
    X = X * np.float32(np.sqrt(256.0 / Dw))
    assert launch_plan(J, B, Cw, Dw, H100_SMS).kernel == "wide"
    rng = np.random.RandomState(6)
    idx = rng.randint(0, N, size=(J, N_MAX)).astype(np.int32)
    mask = (rng.rand(J, N_MAX) < 0.8).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(13), J)
    apply_fn = jlinear_model().apply if impl == "xla" else None
    rf_j = jax.jit(jmake_client_round(apply_fn, task, EPOCHS, B, N_MAX,
                                      kernel_impl=impl))
    sj, lj, aj = rf_j({"w": jnp.asarray(w0)}, jnp.asarray(X), jnp.asarray(y),
                      jnp.asarray(idx), jnp.asarray(mask), keys,
                      jnp.float32(0.1), jnp.float32(0.05), jnp.float32(0.01))
    pos = np.stack([_positions(keys[j], mask[j]) for j in range(J)])
    rf_t = make_client_round(task, EPOCHS, B, N_MAX)
    st, lt, at = rf_t({"w": _t(w0)}, _t(X), _t(y), _t(idx).long(), _t(mask),
                      _t(pos), 0.1, 0.05, 0.01)
    np.testing.assert_allclose(st["w"].numpy(), np.asarray(sj["w"]), **W_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-3)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("Cm", [33, 105])
def test_plain_round_matches_jax_past_32_classes(Cm, task, impl):
    """C = 33 and 105 (D = 64, B = 8, S = 3, J = 2): the shapes the
    class-tiled wide plan takes on the card; the JAX package's Pallas
    epoch kernel (interpret mode) and XLA scan take any C. The same
    pre-gathered batches on both sides, drawn from the JAX keys."""
    Dm, Bm, n_max, J = 64, 8, 24, 2
    X, y, w0 = _data(task, seed=8, C=Cm, D=Dm)
    X = X * np.float32(np.sqrt(256.0 / Dm))
    assert launch_plan(J, Bm, Cm, Dm, H100_SMS).kernel == "wide_tiled"
    rng = np.random.RandomState(9)
    idx = rng.randint(0, N, size=(J, n_max)).astype(np.int32)
    mask = (rng.rand(J, n_max) < 0.8).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(17), J)
    apply_fn = jlinear_model().apply if impl == "xla" else None
    rf_j = jax.jit(jmake_client_round(apply_fn, task, EPOCHS, Bm, n_max,
                                      kernel_impl=impl))
    sj, lj, aj = rf_j({"w": jnp.asarray(w0)}, jnp.asarray(X), jnp.asarray(y),
                      jnp.asarray(idx), jnp.asarray(mask), keys,
                      jnp.float32(0.1), jnp.float32(0.05), jnp.float32(0.01))
    pos = np.stack([np.stack([
        np.asarray(jepoch_batches(k, n_max, Bm, jnp.asarray(mask[j]))[0])
        for k in jax.random.split(keys[j], EPOCHS)]) for j in range(J)])
    assert pos.shape[2] == 3  # S = 3 steps an epoch
    rf_t = make_client_round(task, EPOCHS, Bm, n_max)
    st, lt, at = rf_t({"w": _t(w0)}, _t(X), _t(y), _t(idx).long(), _t(mask),
                      _t(pos), 0.1, 0.05, 0.01)
    np.testing.assert_allclose(st["w"].numpy(), np.asarray(sj["w"]), **W_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-3)


def _epoch_inputs(task, device, J=5, S=3, seed=0, C=C, D=D, B=B):
    X, y, w0 = _data(task, seed, C, D)
    # rows keep the squared norm of D=256's (~256) at every D, so lr-0.1
    # SGD stays as well-posed as there instead of diverging (a diverging
    # run amplifies summation-order differences past any tolerance)
    X = X * np.float32(np.sqrt(256.0 / D))
    rng = np.random.RandomState(seed + 1)
    rows = rng.randint(0, N, size=(J, S, B)).astype(np.int32)
    valid = (rng.rand(J, S, B) < 0.7).astype(np.float32)
    valid[1] = 0.0          # an empty client
    valid[2, 1:] = 0.0      # empty trailing steps
    if S > 3:
        valid[3, 1] = 0.0   # an empty step between non-empty ones
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wrapper_widens_two_byte_rows_on_the_cpu(dtype):
    """A 2-byte X runs the plain version on the CPU: the same epoch as on
    its float32 widening, bit for bit."""
    W, w0, X, y, rows, valid = _epoch_inputs("classification", "cpu")
    Xn = X.to(dtype)
    a = client_epoch(W, w0, Xn, y, rows, valid, 0.1, 0.05, 0.01,
                     "classification")
    b = client_epoch_plain(W, w0, Xn.float(), y, rows, valid, 0.1, 0.05,
                           0.01, "classification")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_wrapper_rejects_bad_inputs():
    W, w0, X, y, rows, valid = _epoch_inputs("classification", "cpu")
    with pytest.raises(ValueError, match="X must be one of"):
        client_epoch(W, w0, X.to(torch.float64), y, rows, valid, 0.1, 0, 0,
                     "classification")
    with pytest.raises(ValueError, match="rows"):
        client_epoch(W, w0, X, y, rows.long(), valid, 0.1, 0, 0,
                     "classification")
    with pytest.raises(ValueError, match="y"):
        client_epoch(W, w0, X, y.float(), rows, valid, 0.1, 0, 0,
                     "classification")
    with pytest.raises(ValueError, match="W"):
        client_epoch(W.transpose(1, 2), w0, X, y, rows, valid, 0.1, 0, 0,
                     "classification")


# -- the launch plan (pure Python, no card) ---------------------------------

H100_SMS = 132
# the clusters of 1 to 16 wide CTAs an H100 runs at once
# (cudaOccupancyMaxActiveClusters, chip_smoke.py's wide_d line)
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# the plan as an H100 gives it
launch_plan = functools.partial(ek.launch_plan, active_clusters=H100_ACTIVE)
# each client's non-empty steps in the first epoch of chip_smoke.py's
# sector stand-in (50 Dirichlet(0.01) clients, batches of 32), where the
# class-tiled kernel's cluster rule was measured
SECTOR_STEPS = (1, 5, 5, 4, 4, 4, 2, 5, 3, 4, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4,
                2, 3, 4, 4, 2, 3, 3, 5, 3, 3, 3, 4, 4, 4, 3, 4, 2, 4, 5, 4,
                5, 4, 3, 3, 5, 2, 5, 3, 5, 4)


@functools.lru_cache(maxsize=None)
def _main_steps(J, B=32):
    """Each client's non-empty steps in a local epoch of the main path:
    the mnist stand-in's Dirichlet(0.01) split into J clients, the train
    rows of ``prepare_setup``'s split, batches of B (what the wrapper
    hands the wide kernel's cluster rule)."""
    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.data import load_dataset

    setup = prepare_setup(load_dataset("mnist", num_partitions=J, alpha=0.01),
                          D=16, seed=100, rng=np.random.RandomState(100),
                          device="cpu")
    return tuple(int(v) for v in torch.ceil(setup.mask.sum(1) / B).tolist())


@pytest.mark.parametrize("J,B,C,D,k", [
    (50, 32, 10, 2000, 4),   # main path: the smallest k with two tiles
    (50, 32, 1, 2000, 4),    # its regression twin
    (50, 16, 1, 2000, 2),    # half the batch: k = 2 double-buffers
    (5, 32, 10, 2000, 8),    # few clients: more SMs per client
    (70, 32, 3, 256, 1),     # small slices fit whole, J fills the card
    (70, 32, 3, 2000, 4),    # J * k > 132: a second wave
    (50, 32, 26, 2000, 8),   # letter's 26 classes need the largest cluster
    (5, 32, 1, 4, 1),        # a slice of 4 columns: no empty CTA
])
def test_plan_chooses_cluster_size(J, B, C, D, k):
    plan = launch_plan(J, B, C, D, H100_SMS)
    assert plan.cluster == k
    assert plan.ctas == J * k
    assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
    assert plan.slice_width % 4 == 0
    assert (k - 1) * plan.slice_width < D  # every CTA holds columns


def test_plan_main_path_layout():
    plan = launch_plan(50, 32, 10, 2000, H100_SMS)
    # header 48 B; floats: w, anchor 2*10*500; two tiles 2*32*500; two
    # exchange buffers 2*(4 + 32*12); logits 32*12; row scratch 4*32;
    # block sums 16; then 2*32 row ids
    floats = 2 * 10 * 500 + 2 * 32 * 500 + 2 * (4 + 32 * 12) + 32 * 12 \
        + 4 * 32 + 16
    assert plan == ek.EpochPlan(cluster=4, slice_width=500, classes=10,
                                smem_bytes=48 + 4 * (floats + 64), ctas=200)
    # k = 2 cannot double-buffer the step tile
    assert ek.staged_smem_bytes(32, 10, 2000, 2) > cuda_build.SMEM_LIMIT
    assert ek.kernel_symbol(plan, 10) == "19staged_epoch_kernelILi10ELb1E"


@pytest.mark.parametrize("C,nc", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 8),
                                  (6, 6), (10, 10), (11, 16), (26, 26),
                                  (27, 32), (32, 32), (33, 0), (105, 0),
                                  (1000, 0)])
def test_plan_instantiated_classes(C, nc):
    """The instantiation of each class count; none past 32 (0: the
    class-tiled wide kernel takes C at run time)."""
    assert ek.instantiated_classes(C) == nc
    assert launch_plan(5, 32, C, 256, H100_SMS).classes == nc


def test_plan_refuses_what_fits_nowhere():
    """Past the instantiated classes the class-tiled wide plan; no plan
    (None) only where a chunk of 8 rows' logits of a CTA's classes passes
    a block's shared memory (past 57,152 classes at 8 CTAs, 113,152 at
    16); a shape past both the staged and the unstaged kernel's shared
    memory takes the wide plan; a bad shape or a forced cluster or kernel
    that does not fit raise, the staged, unstaged and wide kernels at
    more than 32 classes among them, and a class-tiled cluster of more
    CTAs than classes."""
    assert launch_plan(5, 32, 33, 256, H100_SMS).kernel == "wide_tiled"
    assert launch_plan(5, 32, 4000, 256, H100_SMS).kernel == "wide_tiled"
    assert launch_plan(5, 32, 57152, 256, H100_SMS).kernel == "wide_tiled"
    assert launch_plan(5, 32, 57153, 256, H100_SMS) is None
    assert launch_plan(5, 32, 113152, 256, H100_SMS,
                       max_cluster=16).kernel == "wide_tiled"
    assert launch_plan(5, 32, 113153, 256, H100_SMS, max_cluster=16) is None
    with pytest.raises(ValueError, match="does not fit the wide kernel"):
        launch_plan(5, 32, 3, 256, H100_SMS, kernel="wide_tiled", cluster=4)
    assert launch_plan(5, 4096, 32, 4000, H100_SMS).kernel == "wide"
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(5, 32, 10, 10000, H100_SMS, kernel="staged")
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(5, 32, 10, 10000, H100_SMS, kernel="unstaged")
    with pytest.raises(ValueError, match="does not fit the wide kernel"):
        launch_plan(5, 32, 10, 10000, H100_SMS, kernel="wide", cluster=16)
    with pytest.raises(ValueError, match="kernel must be one of"):
        launch_plan(5, 32, 10, 256, H100_SMS, kernel="split")
    with pytest.raises(ValueError, match="bad shape"):
        launch_plan(5, 32, 0, 256, H100_SMS)
    with pytest.raises(ValueError, match="at most 32 classes"):
        launch_plan(5, 32, 33, 256, H100_SMS, cluster=1)
    for kernel in ("staged", "unstaged", "wide"):
        with pytest.raises(ValueError, match="at most 32 classes"):
            launch_plan(5, 32, 105, 256, H100_SMS, kernel=kernel)
    with pytest.raises(ValueError, match="does not fit the wide kernel"):
        launch_plan(5, 32, 105, 256, H100_SMS, kernel="wide_tiled",
                       cluster=16)
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(50, 32, 10, 2000, H100_SMS, cluster=2)
    with pytest.raises(ValueError, match="bad shape"):
        launch_plan(5, 0, 10, 256, H100_SMS)


@pytest.mark.parametrize("J,B,C,D,smem_limit,route", [
    (50, 32, 10, 2000, cuda_build.SMEM_LIMIT, ("staged", 4)),  # main path
    (400, 32, 10, 2000, cuda_build.SMEM_LIMIT, ("staged", 4)),  # 400 parts
    (50, 1024, 10, 2000, cuda_build.SMEM_LIMIT, ("unstaged", 0)),
    (5, 32, 33, 256, cuda_build.SMEM_LIMIT, ("wide_tiled", 8)),  # > 32
    (50, 32, 105, 2000, cuda_build.SMEM_LIMIT, ("wide_tiled", 2)),  # sector
    (5, 32, 60000, 256, cuda_build.SMEM_LIMIT, None),  # 8 rows' logits
    (5, 4096, 32, 4000, cuda_build.SMEM_LIMIT, ("wide", 8)),
    (5, 32, 10, 20000, cuda_build.SMEM_LIMIT, ("wide", 8)),  # W too wide
    (50, 32, 10, 2000, 100000, ("staged", 8)),   # a smaller block: wider
    (50, 32, 10, 2000, 20000, ("wide", 2)),
])
def test_plan_is_none_where_no_kernel_takes_the_shape(J, B, C, D,
                                                      smem_limit, route):
    """The plan by shape alone, with ``num_sms`` and ``smem_limit``
    passed in: its kernel and cluster size, or None where no kernel takes
    the shape (a chunk of 8 rows' logits of a CTA's classes past a block's
    shared memory at every cluster:
    the wrapper then refuses CUDA tensors before any launch). Shapes past
    the staged and unstaged kernels' shared memory take the wide plan,
    more than 32 classes the class-tiled one."""
    plan = launch_plan(J, B, C, D, H100_SMS, smem_limit)
    assert ((plan.kernel, plan.cluster) if plan else None) == route
    if plan is not None:
        assert plan.smem_bytes <= smem_limit


def test_plan_two_byte_rows_layout():
    """2-byte rows: slices round to 8 elements (16 bytes); the staged
    kernel of 2-byte rows (a producer warp's ring) holds as many stages of
    half-byte tiles as fit, up to 4, so a smaller cluster fits more D;
    its cluster is the measured rule's (``_narrow_cluster``): 8 CTAs at
    the main shape with the main path's steps (2 before: the one-wave
    rule), 4 at J = 400, 8 at Centralized's J = 1. The D limit of the
    largest cluster stays 8,704 at C = 10, B = 32 (5,376 float32
    columns); past each limit the wide plan takes over (8 CTAs at J =
    5)."""
    assert ek.slice_width(2000, 4, 2) == 504 and ek.slice_width(250, 4, 2) == 64
    assert ek.slice_width(2000, 4) == 500
    # the ring's layout at the main shape's 8 CTAs: header 112 B; floats:
    # w, anchor 2*10*256; two exchange buffers 2*(4 + 32*12); logits
    # 32*12; row loss and hits 2*32; block sums 16; 4 stages' row weights,
    # labels and ids 3*4*32; then 4 stages of 32 rows x 256 2-byte columns
    floats = (2 * 10 * 256 + 2 * (4 + 32 * 12) + 32 * 12 + 2 * 32 + 16
              + 3 * 4 * 32)
    smem = 112 + 4 * floats + 2 * 4 * 32 * 256
    assert ek.staged_ring_smem_bytes(32, 10, 2000, 8, 4) == smem
    plan = launch_plan(50, 32, 10, 2000, H100_SMS, row_bytes=2,
                       steps=_main_steps(50))
    assert plan == ek.EpochPlan(cluster=8, slice_width=256, classes=10,
                                smem_bytes=smem, ctas=400, stages=4)
    assert ek.kernel_symbol(plan, 10) == "24staged_ring_epoch_kernelILi10ELb1E"
    assert launch_plan(400, 32, 10, 2000, H100_SMS, row_bytes=2,
                       steps=_main_steps(400)).cluster == 4
    assert launch_plan(1, 32, 10, 2000, H100_SMS, row_bytes=2).cluster == 8
    # the depth: 2 stages at one CTA's 2,000 do not fit, 2 at k = 2
    assert [ek.narrow_stages(32, 10, 2000, k, cuda_build.SMEM_LIMIT)
            for k in (1, 2, 4, 8)] == [0, 2, 4, 4]
    # the gradient pass's columns a thread: 1 at 256 columns, 2 at 504,
    # 4 at 1,000 (each measured fastest there); 2 past 16 classes
    assert [ek.narrow_grad_cols(Dk, 10) for Dk in (256, 504, 1000)] == [
        1, 2, 4]
    assert ek.narrow_grad_cols(1000, 26) == 2
    # past each row type's limit the wide plan takes over (8 CTAs: the
    # fewest steps at J = 5, every client a cluster of its own)
    for D, f32_k, b16_k in ((5376, "staged", "staged"),
                            (5377, "wide", "staged"),
                            (8704, "wide", "staged"), (8705, "wide", "wide")):
        a = launch_plan(5, 32, 10, D, H100_SMS)
        b = launch_plan(5, 32, 10, D, H100_SMS, row_bytes=2)
        assert (a.kernel, a.cluster) == (f32_k, 8), D
        assert (b.kernel, b.cluster) == (b16_k, 8), D
    assert launch_plan(5, 32, 10, 8704, H100_SMS, row_bytes=2).stages == 2


# ms of the staged kernel of 2-byte rows forced at each cluster that fits
# (bfloat16 rows, C = 10, B = 32; J = 1 is Centralized's one client of
# 1,501 steps, every other J the mnist stand-in's Dirichlet(0.01) split;
# tools/client_epoch_variants.py --shapes grid on an NVIDIA H100 80GB HBM3
# at 700 W, PERF.md § 6): what _narrow_cluster is fitted to
NARROW_GRID_MS = {
    (1, 784): {1: 13.709, 2: 9.714, 4: 7.465, 8: 7.436},
    (1, 1504): {2: 12.964, 4: 9.758, 8: 7.667},
    (1, 2000): {2: 15.064, 4: 9.904, 8: 7.933},
    (1, 3000): {4: 13.26, 8: 10.115},
    (1, 4096): {4: 15.345, 8: 10.186},
    (1, 5376): {8: 13.251},
    (1, 7000): {8: 15.026},
    (1, 8704): {8: 19.095},
    (5, 784): {1: 4.447, 2: 3.145, 4: 2.403, 8: 2.389},
    (5, 1504): {2: 4.217, 4: 3.152, 8: 2.476},
    (5, 2000): {2: 4.85, 4: 3.169, 8: 2.534},
    (5, 3000): {4: 4.247, 8: 3.235},
    (5, 4096): {4: 4.922, 8: 3.261},
    (5, 5376): {8: 4.222},
    (5, 7000): {8: 4.832},
    (5, 8704): {8: 6.148},
    (50, 784): {1: 1.405, 2: 0.997, 4: 0.759, 8: 0.755},
    (50, 1504): {2: 1.336, 4: 0.995, 8: 0.784},
    (50, 2000): {2: 1.56, 4: 1.02, 8: 0.815},
    (50, 3000): {4: 1.346, 8: 1.025},
    (50, 4096): {4: 1.584, 8: 1.047},
    (50, 5376): {8: 1.346},
    (50, 7000): {8: 1.581},
    (50, 8704): {8: 1.986},
    (400, 784): {1: 0.641, 2: 0.457, 4: 0.422, 8: 0.771},
    (400, 1504): {2: 0.606, 4: 0.548, 8: 0.828},
    (400, 2000): {2: 0.707, 4: 0.599, 8: 0.899},
    (400, 3000): {4: 0.779, 8: 1.105},
    (400, 4096): {4: 0.936, 8: 1.178},
    (400, 5376): {8: 1.499},
    (400, 7000): {8: 1.766},
    (400, 8704): {8: 2.183},
}


@pytest.mark.parametrize("J,D", list(NARROW_GRID_MS))
def test_plan_two_byte_cluster_rule_is_the_measured_one(J, D):
    """The staged kernel of 2-byte rows at every shape of the grid its
    cluster rule was fitted to: the clusters whose ring fits are the ones
    measured, and the rule's pick, given the card's clusters at once and
    the clients' steps, is the size measured fastest or within 0.6% of
    it (4 CTAs at D = 784 where 8 measured 0.4% faster)."""
    ms = NARROW_GRID_MS[J, D]
    fits = [k for k in ek.STAGED_CLUSTERS
            if ek.narrow_stages(32, 10, D, k, cuda_build.SMEM_LIMIT)]
    assert fits == sorted(ms)
    steps = (1501,) if J == 1 else _main_steps(J)
    plan = launch_plan(J, 32, 10, D, H100_SMS, row_bytes=2, steps=steps)
    assert plan.kernel == "staged" and plan.stages >= 2
    assert ms[plan.cluster] <= 1.006 * min(ms.values()), (plan, ms)


def test_plan_falls_back_to_unstaged_kernel_for_huge_batches():
    plan = launch_plan(50, 1024, 10, 2000, H100_SMS)
    assert plan.cluster == 0 and plan.ctas == 50 and plan.classes == 32
    assert plan.smem_bytes == ek.unstaged_smem_bytes(1024, 10, 2000)
    assert ek.kernel_symbol(plan, 10) == "21unstaged_epoch_kernelILi32E"


def test_plan_takes_every_shape_the_unstaged_kernel_takes():
    for B in (1, 16, 17, 32, 64, 256, 1024, 4096):
        for C in (1, 3, 10, 16, 32):
            for D in (1, 4, 250, 256, 784, 2000, 3000):
                if ek.unstaged_smem_bytes(B, C, D) > cuda_build.SMEM_LIMIT:
                    continue
                plan = launch_plan(50, B, C, D, H100_SMS)
                assert plan.smem_bytes <= cuda_build.SMEM_LIMIT


GRID_B = (1, 17, 32, 1024, 4096)
GRID_C = (1, 3, 10, 26, 32)
GRID_D = (1, 250, 2000, 5377, 10000, 65536)


@pytest.mark.parametrize("J", [1, 50, 1024])
@pytest.mark.parametrize("row_bytes", [2, 4])
def test_plan_takes_every_shape_up_to_32_classes(row_bytes, J):
    """Every B, every D and every C up to 32 has a plan, for both row
    sizes and with clusters of up to 8 or 16 CTAs; each fits a block's
    shared memory and its slices cover D with none empty. A wide plan's
    shared memory is its ring layout's (``ring_smem_bytes``, inside
    ``SMEM_LIMIT``): a chunk of at most ``WARPS * ring_rows`` rows, a ring
    of 3 to 16 stages of at most 256 columns, the rows held from pass to
    pass only where one chunk takes the batch and the stages are whole
    multiples of the slice's tiles, and the cluster the measured rule's
    choice (J clients of equal steps) among the sizes that fit with no
    empty slice."""
    for max_cluster in (8, 16):
        for B in GRID_B:
            for C in GRID_C:
                for D in GRID_D:
                    plan = launch_plan(J, B, C, D, H100_SMS,
                                          row_bytes=row_bytes,
                                          max_cluster=max_cluster)
                    shape = (J, B, C, D, row_bytes, max_cluster)
                    assert plan is not None, shape
                    assert plan.smem_bytes <= cuda_build.SMEM_LIMIT, shape
                    if plan.kernel == "unstaged":
                        continue
                    assert plan.cluster <= max_cluster, shape
                    assert plan.cluster * plan.slice_width >= D, shape
                    assert (plan.cluster - 1) * plan.slice_width < D, shape
                    if plan.kernel == "wide":
                        assert plan.chunk % 8 == 0, shape
                        assert 8 <= plan.chunk <= ek.WARPS * ek.ring_rows(
                            C), shape
                        hold = plan.scratch_bytes == 0
                        assert plan.smem_bytes == ek.ring_smem_bytes(
                            B, C, D, plan.cluster, plan.chunk, plan.tile,
                            plan.stages, plan.w_res, hold, row_bytes), shape
                        assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
                        assert (ek.RING_MIN_STAGES <= plan.stages
                                <= ek.RING_MAX_STAGES), shape
                        assert (plan.tile % 8 == 0
                                and plan.tile <= ek.RING_TILE), shape
                        ntiles = -(-plan.slice_width // plan.tile)
                        assert not plan.rows_res or (
                            B <= plan.chunk
                            and plan.stages % ntiles == 0), shape
                        lays = {k: ek._ring_layout(
                            B, C, D, k, cuda_build.SMEM_LIMIT, row_bytes)
                                for k in ek.WIDE_CLUSTERS if k <= max_cluster
                                and (k - 1) * ek.slice_width(
                                    D, k, row_bytes) < D}
                        lays = {k: lay for k, lay in lays.items() if lay}
                        assert plan.cluster == ek._wide_cluster(
                            (1,) * J, B, C, D, row_bytes, tuple(lays.items()),
                            tuple(H100_ACTIVE.items())), shape


def _plan_before_the_wide_kernel(J, B, C, D, num_sms, smem_limit,
                                 row_bytes):
    """``launch_plan`` as it was before the wide kernel: (cluster,
    slice_width, classes, smem_bytes, ctas), or None."""
    if C > ek.MAX_CLASSES:
        return None
    sizes = [k for k in (1, 2, 4, 8)
             if ek.staged_smem_bytes(B, C, D, k, row_bytes) <= smem_limit]
    if not sizes:
        smem = ek.unstaged_smem_bytes(B, C, D)
        if smem > smem_limit:
            return None
        return (0, D, 8 if C <= 8 else 32, smem, J)
    fill = max(k for k in (1, 2, 4, 8) if k == 1 or J * k <= num_sms)
    k = max(sizes[0], fill)
    while k > sizes[0] and (k - 1) * ek.slice_width(D, k, row_bytes) >= D:
        k //= 2
    return (k, ek.slice_width(D, k, row_bytes), ek.instantiated_classes(C),
            ek.staged_smem_bytes(B, C, D, k, row_bytes), J * k)


def _plan_of_the_two_byte_ring(J, B, C, D, smem_limit):
    """The staged plan of 2-byte rows as the ring kernel's rule set it:
    (cluster, slice_width, classes, smem_bytes, ctas, stages), or None
    where no ring of 2 stages fits. J clients of one step each, the
    clusters ``H100_ACTIVE`` runs at once."""
    def stages(k):
        return max((n for n in (2, 3, 4) if ek.staged_ring_smem_bytes(
            B, C, D, k, n) <= smem_limit), default=0)

    sizes = [k for k in (1, 2, 4, 8) if stages(k)]
    if not sizes:
        return None
    sizes = [k for k in sizes
             if k == sizes[0] or (k - 1) * ek.slice_width(D, k, 2) < D]
    nc = ek.instantiated_classes(C)
    rb = 8 if nc <= 4 else (4 if nc <= 10 else (2 if nc <= 16 else 1))

    def cost(k):
        Dk = ek.slice_width(D, k, 2)
        cols = {g: -(-Dk // (256 * g)) * g for g in (4, 2, 1)
                if g < 4 or nc <= 16}
        g = min(cols, key=lambda g: (cols[g], -g))
        passes = -(-(-(-B // rb)) // 8) * -(-Dk // 256) + cols[g] * B / 32
        return -(-J // H100_ACTIVE[k]) * (2.70 + 0.083 * k + 0.89 * passes)

    k = min(sizes, key=lambda k: (cost(k), -k))
    return (k, ek.slice_width(D, k, 2), nc,
            ek.staged_ring_smem_bytes(B, C, D, k, stages(k)), J * k,
            stages(k))


@pytest.mark.parametrize("row_bytes", [2, 4])
def test_plan_keeps_every_shape_taken_before_the_wide_kernel(row_bytes):
    """Every shape the staged or the unstaged kernel took keeps its
    kernel, cluster, slice, instantiation, shared memory and grid, at
    either cluster limit and at a smaller block too; only shapes neither
    took run the wide kernel, and past 32 classes the class-tiled one.
    2-byte rows are held against the ring kernel's rule
    (``_plan_of_the_two_byte_ring``): its plan wherever its ring of 2
    stages fits, else the unstaged kernel's, else the wide kernel, so
    every shape keeps a kernel and none is refused."""
    for smem_limit in (cuda_build.SMEM_LIMIT, 100000):
        for J in (1, 5, 50, 70, 400):
            for B in (1, 16, 17, 32, 64, 100, 1024, 4096):
                for C in (1, 2, 3, 5, 10, 16, 26, 32, 33, 64, 71, 105,
                          1000):
                    for D in (1, 4, 250, 256, 784, 2000, 3000, 5376, 6000,
                              8704):
                        old = _plan_before_the_wide_kernel(
                            J, B, C, D, H100_SMS, smem_limit, row_bytes)
                        ring = (_plan_of_the_two_byte_ring(
                            J, B, C, D, smem_limit)
                                if row_bytes == 2 and C <= 32 else None)
                        for max_cluster in (8, 16):
                            new = launch_plan(J, B, C, D, H100_SMS,
                                                 smem_limit,
                                                 row_bytes=row_bytes,
                                                 max_cluster=max_cluster)
                            shape = (smem_limit, J, B, C, D, max_cluster)
                            if ring is not None:
                                assert new.kernel == "staged", shape
                                assert (new.cluster, new.slice_width,
                                        new.classes, new.smem_bytes,
                                        new.ctas, new.stages) == ring, shape
                                continue
                            if row_bytes == 2 and old is not None and old[0]:
                                # the old staged kernel's shape past the
                                # ring: the unstaged kernel where it fits
                                fits = ek.unstaged_smem_bytes(
                                    B, C, D) <= smem_limit
                                assert new.kernel == (
                                    "unstaged" if fits else "wide"), shape
                                continue
                            if old is None:
                                assert new.kernel == ("wide_tiled" if C > 32
                                                      else "wide"), shape
                                continue
                            assert new.kernel == (
                                "staged" if old[0] else "unstaged"), shape
                            assert (new.cluster, new.slice_width,
                                    new.classes, new.smem_bytes,
                                    new.ctas) == old, shape


def test_plan_wide_layout():
    """The wide plan at mnist's shape with D = 10,000 on an H100 (16-CTA
    clusters, 7 of them at once) and the main path's steps: 16 CTAs a
    client, 628 columns each in 3 ring tiles of 216, W's and the anchor's
    slices and the step's rows held in shared memory, one chunk of the 32
    rows, the batch buffer held; 8 CTAs where the card takes no 16-CTA
    cluster (W held, the rows streamed twice through 3 stages). Its layout
    in bytes; its symbol; a batch too large to hold goes to global
    scratch; forced at a shape the staged kernel takes, at any cluster."""
    steps = _main_steps(50)
    plan = launch_plan(50, 32, 10, 10000, H100_SMS, max_cluster=16,
                       steps=steps)
    # wide_smem_bytes' layout: header 16 B; floats: two exchange buffers
    # 2*(4 + 32*12), row loss and hits 2*32, block sums 16; the batch
    # buffer 32*(12 + 2); then the ring header (272 B of mbarriers, 16 of
    # metrics), W and the anchor 2*10*628 floats, 6 stages of 32 rows x
    # 216 columns
    base = 16 + 4 * (2 * (4 + 32 * 12) + 2 * 32 + 16) + 4 * 32 * 14
    assert ek.wide_smem_bytes(32, 10, 32, True) == base
    smem = base + 288 + 4 * 2 * 10 * 628 + 4 * 6 * 32 * 216
    assert plan == ek.EpochPlan(cluster=16, slice_width=628, classes=10,
                                smem_bytes=smem, ctas=800, kernel="wide",
                                chunk=32, scratch_bytes=0, tile=216,
                                stages=6, w_res=True, rows_res=True)
    assert ek.kernel_symbol(plan, 10) == "17wide_epoch_kernelILi10ELb1E"
    assert ek.kernel_symbol(launch_plan(5, 32, 11, 10000, H100_SMS),
                            11) == "17wide_epoch_kernelILi16ELb0E"
    eight = launch_plan(50, 32, 10, 10000, H100_SMS, steps=steps)
    assert (eight.cluster, eight.slice_width, eight.tile, eight.stages,
            eight.w_res, eight.rows_res) == (8, 1252, 256, 3, True, False)
    assert eight.smem_bytes == base + 288 + 4 * 2 * 10 * 1252 + 4 * 3 * 32 * 256
    # bfloat16 rows: slices round to 8 elements, stages take half the bytes
    bf = launch_plan(50, 32, 10, 9000, H100_SMS, row_bytes=2, steps=steps)
    assert (bf.cluster, bf.slice_width, bf.tile, bf.w_res, bf.rows_res) == (
        8, 1128, 232, True, True)
    assert bf.smem_bytes == ek.ring_smem_bytes(
        32, 10, 9000, 8, 32, 232, bf.stages, True, True, row_bytes=2)
    big = launch_plan(50, 4096, 10, 2000, H100_SMS, steps=steps)
    assert (big.kernel, big.cluster, big.chunk) == ("wide", 8, 32)
    assert big.scratch_bytes == 4 * 400 * 4096 * 14
    assert not big.rows_res
    assert big.smem_bytes == ek.ring_smem_bytes(
        4096, 10, 2000, 8, 32, big.tile, big.stages, big.w_res, False)
    # a chunk holds at most 8 warps' forward rows: 8, 4, 2 or 1 a warp
    assert launch_plan(5, 4096, 3, 4000, H100_SMS,
                       kernel="wide").chunk == 64
    assert launch_plan(5, 4096, 16, 4000, H100_SMS).chunk == 16
    assert launch_plan(5, 4096, 32, 4000, H100_SMS).chunk == 8
    # forced: the wide kernel at a shape the staged kernel takes, at any
    # cluster size up to the limit
    forced = launch_plan(5, 32, 10, 250, H100_SMS, kernel="wide")
    assert (forced.kernel, forced.cluster) == ("wide", 8)
    assert forced.cluster * forced.slice_width >= 250
    assert launch_plan(5, 32, 10, 250, H100_SMS, kernel="wide",
                       cluster=2).slice_width == 128
    # a block too small for one chunk of 8 rows: no plan
    assert launch_plan(5, 32, 32, 10000, H100_SMS, smem_limit=1000) is None
    # the bytes a CTA moves a step by the layout's arithmetic: wide_d's 32
    # rows of its 628 columns once, W held; the exchange's partials
    assert ek.wide_step_bytes(32, 10, 10000, 16, True, True) == {
        "rows": 32 * 628 * 4, "w_and_anchor": 0, "exchange": 4 * 16 * 32 * 12}
    assert ek.wide_step_bytes(32, 10, 10000, 2, False, False) == {
        "rows": 2 * 32 * 5000 * 4, "w_and_anchor": 16 * 10 * 5000,
        "exchange": 4 * 2 * 32 * 12}


def test_plan_wide_cluster_rule_is_the_measured_one():
    """The cluster rule pinned where it was measured on an H100 (132, 66,
    30, 15 and 7 clusters of 1 to 16 CTAs at once), each pick the size
    measured fastest there: 16 CTAs a client at wide_d's J = 50,
    D = 10,000 with the main path's steps and at Centralized's J = 1
    (1,501 steps); 8 where the card takes no 16; 8 at J = 400, on the
    main path's split and with one client of 150 steps and 399 of 30. The launch lasts the busiest
    cluster's steps of a longest-first schedule over the clusters the
    card runs at once: a card that runs fewer, or none of a size, makes
    the same J take fewer CTAs; with no steps given, J clients of equal
    steps. Without the clusters the card runs at once, no rule."""
    steps = _main_steps(50)

    def k_of(J, D, **kw):
        return launch_plan(J, 32, 10, D, H100_SMS, max_cluster=16,
                           **kw).cluster

    assert k_of(50, 10000, steps=steps) == 16
    assert k_of(1, 10000, steps=(1501,)) == 16
    assert launch_plan(50, 32, 10, 10000, H100_SMS,
                       steps=steps).cluster == 8
    assert launch_plan(1, 32, 10, 10000, H100_SMS,
                       steps=(1501,)).cluster == 8
    assert k_of(50, 10000, steps=steps, row_bytes=2) == 16
    skewed = (150,) + (30,) * 399
    assert k_of(400, 10000, steps=skewed) == 8
    assert k_of(400, 10000, steps=_main_steps(400)) == 8
    # the steps come from a function, called only where they decide: not
    # by the staged plan, nor where every client has a cluster of its own
    # at every size
    assert k_of(50, 10000, steps=lambda: steps) == 16
    assert launch_plan(50, 32, 10, 2000, H100_SMS,
                       steps=lambda: 1 / 0).kernel == "staged"
    assert k_of(1, 10000, steps=lambda: 1 / 0) == 16
    assert k_of(7, 10000, steps=lambda: 1 / 0) == 16
    # equal steps: 50 clusters of 16 take 8 turns of 7, of 8 only 4 of 15
    assert k_of(50, 10000) == 8
    # the longest-first schedule
    assert ek._busiest_steps((5, 3, 3, 2), 2) == 7
    assert ek._busiest_steps(skewed, 7) == 1740
    assert ek._busiest_steps(steps, 15) == 150
    # a card that runs fewer clusters at once: the same J takes fewer CTAs
    few = {**H100_ACTIVE, 16: 1}
    assert k_of(50, 10000, steps=steps, active_clusters=few) == 8
    # a size the card does not run at all is never chosen
    none16 = {**H100_ACTIVE, 16: 0}
    assert k_of(1, 10000, steps=(1501,), active_clusters=none16) == 8
    with pytest.raises(ValueError, match="at once"):
        ek.launch_plan(1, 32, 10, 10000, H100_SMS)


GRID_MANY_C = (33, 64, 71, 105, 1000)


@pytest.mark.parametrize("J", [1, 50, 1024])
@pytest.mark.parametrize("row_bytes", [2, 4])
def test_plan_takes_every_shape_past_32_classes(row_bytes, J):
    """Every B and D at C in {33, 64, 71, 105, 1000} has the class-tiled
    wide plan, at either cluster limit; each fits a block's shared
    memory, its layout is ``tiled_smem_bytes``' at its cluster (no CTA
    without a class, each reading the whole rows: the slice is D), a
    chunk of 8 to 32 rows, a ring of 2 to 8 stages of at most 256
    columns (2 only with W held), and its cluster is the measured rule's
    choice (J clients of equal steps) among the sizes whose layout
    fits."""
    for max_cluster in (8, 16):
        for B in GRID_B:
            for C in GRID_MANY_C:
                for D in GRID_D:
                    plan = launch_plan(J, B, C, D, H100_SMS,
                                          row_bytes=row_bytes,
                                          max_cluster=max_cluster)
                    shape = (J, B, C, D, row_bytes, max_cluster)
                    assert plan is not None, shape
                    assert plan.kernel == "wide_tiled", shape
                    assert plan.classes == 0, shape
                    assert plan.smem_bytes <= cuda_build.SMEM_LIMIT, shape
                    hold = plan.scratch_bytes == 0
                    assert plan.smem_bytes == ek.tiled_smem_bytes(
                        B, C, D, plan.cluster, plan.chunk, plan.tile,
                        plan.stages, plan.w_res, hold, row_bytes), shape
                    assert plan.scratch_bytes == (0 if hold else 4 * plan.ctas
                                                  * ek.tiled_batch_floats(
                                                      B, C, plan.cluster))
                    assert plan.cluster <= min(max_cluster, C), shape
                    assert plan.slice_width == D, shape
                    assert plan.chunk % 8 == 0, shape
                    assert 8 <= plan.chunk <= ek.TILED_MAX_CHUNK, shape
                    assert 2 <= plan.stages <= ek.TILED_MAX_STAGES, shape
                    assert plan.stages >= 3 or plan.w_res or \
                        ek.tiled_smem_bytes(
                            B, C, D, plan.cluster, plan.chunk, plan.tile, 3,
                            False, hold, row_bytes) > cuda_build.SMEM_LIMIT, shape
                    assert plan.tile % 8 == 0 and 8 <= plan.tile <= 256
                    lays = {k: ek._tiled_layout(
                        B, C, D, k, cuda_build.SMEM_LIMIT, row_bytes)
                            for k in ek.WIDE_CLUSTERS
                            if k <= max_cluster and k <= C}
                    lays = {k: lay for k, lay in lays.items() if lay}
                    assert plan.cluster == ek._tiled_cluster(
                        (1,) * J, B, C, D, row_bytes, tuple(lays.items()),
                        tuple(H100_ACTIVE.items())), shape


def test_plan_tiled_layout():
    """The class-tiled wide plan at the sector stand-in's shape (J = 50,
    B = 32, C = 105, D = 2,000 with the stand-in's steps: 8 CTAs a client,
    14 classes a CTA over the whole rows, W's slice held beside 2 stages
    of 256 columns, the batch buffer held) and at aloi's 1,000 classes (W
    streamed from W_out, 4 stages); Centralized's one client at 16 CTAs;
    forced at 11 classes; its layout in bytes; its symbols in the
    compiler's report, one a source of W."""
    plan = launch_plan(50, 32, 105, 2000, H100_SMS, steps=SECTOR_STEPS)
    # header 288 B (34 mbarriers, the step header); floats: the pushed row
    # stats 2*8*32*4 and sums of squares 2*8*4, the chunk's row state
    # 8*32, block sums 16, the forward's partials 4096; the batch buffer
    # 32*(16 + 2); W 14 x (2000 + 4); 2 stages of 32 rows x (256 + 4)
    floats = 2 * 8 * 32 * 4 + 2 * 8 * 4 + 8 * 32 + 16 + 4096
    smem = (288 + 4 * floats + 4 * 32 * 18 + 4 * 14 * 2004
            + 2 * 32 * 260 * 4)
    assert ek.tiled_smem_bytes(32, 105, 2000, 8, 32, 256, 2, True,
                               True) == smem
    assert plan == ek.EpochPlan(cluster=8, slice_width=2000, classes=0,
                                smem_bytes=smem, ctas=400,
                                kernel="wide_tiled", chunk=32,
                                scratch_bytes=0, tile=256, stages=2,
                                w_res=True)
    assert ek.tiled_classes(105, 8) == 14
    assert ek.kernel_symbol(plan, 105) == "23wide_tiled_epoch_kernelILi0EE"
    aloi = launch_plan(50, 32, 1000, 2000, H100_SMS, steps=(20,) * 50)
    assert (aloi.kernel, aloi.cluster, aloi.tile, aloi.w_res) == (
        "wide_tiled", 4, 256, False)
    assert aloi.smem_bytes == ek.tiled_smem_bytes(
        32, 1000, 2000, 4, 32, 256, aloi.stages, False, True)
    assert ek.kernel_symbol(aloi, 1000) == "23wide_tiled_epoch_kernelILi1EE"
    unaligned = launch_plan(5, 32, 1000, 6001, H100_SMS)
    assert ek.kernel_symbol(unaligned, 1000) == \
        "23wide_tiled_epoch_kernelILi2EE"
    # a batch buffer too large to hold goes to global scratch
    big = launch_plan(5, 4096, 1000, 2000, H100_SMS)
    assert big.scratch_bytes == 4 * big.ctas * ek.tiled_batch_floats(
        4096, 1000, big.cluster)
    # Centralized's one client: 16 CTAs, 7 classes each, W held
    one = launch_plan(1, 32, 105, 2000, H100_SMS, max_cluster=16,
                      steps=(161,))
    assert (one.kernel, one.cluster, one.slice_width, one.tile,
            one.w_res) == ("wide_tiled", 16, 2000, 256, True)
    forced = launch_plan(5, 32, 11, 250, H100_SMS, kernel="wide_tiled")
    assert (forced.kernel, forced.classes) == ("wide_tiled", 0)
    assert forced.smem_bytes == ek.tiled_smem_bytes(
        32, 11, 250, forced.cluster, 32, 256, forced.stages, True, True)
    assert ek.wide_batch_floats(32, 10) == 32 * 14
    assert ek.tiled_batch_floats(32, 105, 8) == 32 * 18


def test_plan_tiled_cluster_rule_is_the_measured_one():
    """The class-tiled kernel's cluster rule pinned where it was measured
    on an H100 (132, 66, 30, 15 and 7 clusters of 1 to 16 CTAs at once),
    each pick the size measured fastest there: 8 CTAs a client at the
    sector stand-in's C = 105, J = 50 with its steps (0.747 ms against
    0.951 at 4 and 1.236 at 16), 16 at Centralized's J = 1 over its 161
    steps (6.64 ms; 8 where the card takes no 16), 4 at aloi's
    C = 1,000, J = 50 of 20 steps (26.86 ms against 27.34 at 2 and 27.21
    at 8). The steps come from a function, called only where some size
    runs fewer clusters at once than J; without the card's answer the
    SMs over k stand in for it; a size the card does not run is never
    chosen."""
    def k_of(J, C, **kw):
        return launch_plan(J, 32, C, 2000, H100_SMS, max_cluster=16,
                           **kw).cluster

    assert k_of(50, 105, steps=SECTOR_STEPS) == 8
    assert k_of(50, 1000, steps=(20,) * 50) == 4
    assert k_of(1, 105, steps=(161,)) == 16
    assert launch_plan(1, 32, 105, 2000, H100_SMS,
                       steps=(161,)).cluster == 8
    assert k_of(50, 105, steps=lambda: SECTOR_STEPS) == 8
    assert k_of(1, 105, steps=lambda: 1 / 0) == 16
    assert k_of(7, 105, steps=lambda: 1 / 0) == 16
    # without the card's clusters at once: 132 // k of each size
    assert ek.launch_plan(1, 32, 105, 2000, H100_SMS, max_cluster=16,
                          steps=(161,)).cluster == 16
    none16 = {**H100_ACTIVE, 16: 0}
    assert k_of(1, 105, steps=(161,), active_clusters=none16) == 8
    # the model's parts: passes of a tile (forward, gradient)
    assert ek.tiled_passes(105, 8, 32, 256) == (1, 1)
    assert ek.tiled_passes(1000, 2, 32, 128) == (4, 8)
    assert ek.tiled_passes(1000, 4, 32, 256) == (2, 8)
    # a step's estimate: chunks, sweeps, FMAs and, W streamed, W's bytes
    # of every CTA running
    assert ek.tiled_step_us(32, 1000, 2000, 4, 32, 256, False, 120) == (
        ek.TILED_CHUNK_US + ek.TILED_SWEEP_US * 8 * 10
        + 2 * 32 * 256 * 2000 / ek.TILED_FMA_STREAMED_PER_US
        + 120 * 12 * 250 * 2000 / ek.TILED_W_BYTES_PER_US)


def _tiled_plan_before_the_redesign(B, C, smem_limit, cluster=None,
                                    max_cluster=8):
    """Whether the first class-tiled wide plan took a shape (its cluster
    split D and held a chunk's partial logits of all C classes twice):
    its chunk of at most 128 rows, or None."""
    CP = -(-C // 4) * 4
    if cluster is not None and cluster not in [k for k in ek.WIDE_CLUSTERS
                                               if k <= max_cluster]:
        return None
    return next((c for c in range(min(-(-B // 8) * 8, 128), 0, -8)
                 if 16 + 4 * (2 * (4 + c * CP) + 2 * c + 16) <= smem_limit),
                None)


@pytest.mark.parametrize("row_bytes", [2, 4])
def test_plan_keeps_every_shape_taken_before_the_tiled_kernel(row_bytes):
    """Every shape the first class-tiled plan took (every C past 32 by
    shape, any C forced, up to its 3,628-class limit, at every B and D)
    still gets the class-tiled plan, and every forced cluster it took
    with at least one class a CTA still fits; past its limit the
    redesign takes more classes."""
    for smem_limit in (cuda_build.SMEM_LIMIT, 100000):
        for J in (1, 50, 400):
            for B in (1, 16, 17, 32, 512, 4096):
                for C in (1, 10, 32, 33, 105, 1000, 3000, 3620, 3700):
                    for D in (1, 250, 2000, 10000):
                        for max_cluster in (8, 16):
                            old = _tiled_plan_before_the_redesign(
                                B, C, smem_limit)
                            new = launch_plan(
                                J, B, C, D, H100_SMS, smem_limit,
                                row_bytes=row_bytes,
                                max_cluster=max_cluster,
                                kernel="wide_tiled" if C <= 32 else None)
                            shape = (smem_limit, J, B, C, D, max_cluster)
                            if old is not None:
                                assert new.kernel == "wide_tiled", shape
                            for k in ek.WIDE_CLUSTERS:
                                if k > min(C, max_cluster) or \
                                        _tiled_plan_before_the_redesign(
                                            B, C, smem_limit, k,
                                            max_cluster) is None:
                                    continue
                                forced = launch_plan(
                                    J, B, C, D, H100_SMS, smem_limit,
                                    row_bytes=row_bytes, cluster=k,
                                    kernel="wide_tiled",
                                    max_cluster=max_cluster)
                                assert forced.cluster == k, shape
    # the first plan's last class count at a 32-row batch, and past it
    assert _tiled_plan_before_the_redesign(32, 3628, cuda_build.SMEM_LIMIT)
    assert not _tiled_plan_before_the_redesign(32, 3629,
                                               cuda_build.SMEM_LIMIT)
    assert launch_plan(50, 32, 3629, 2000, H100_SMS).kernel == "wide_tiled"


@pytest.mark.parametrize("B", [16, 32, 512])
@pytest.mark.parametrize("D", [64, 2000, 10000])
def test_tiled_layout_fits_a_block_at_every_class_count(B, D):
    """The class-tiled kernel's layout (ring stages, chunk, held W, batch
    buffer) fits ``cuda_build.SMEM_LIMIT`` at every C from 33 to the
    first plan's last (3,628 classes), at every cluster, for both row
    sizes: a chunk of 8 to 32 rows (the whole batch up to 32 wherever a
    CTA holds at most 1,000 classes), at least 2 stages, W held only with
    the widest tile (256 columns or the whole row) and then the widest
    tile whatever the ring's depth."""
    for row_bytes in (2, 4):
        for C in range(33, 3629):
            for k in ek.WIDE_CLUSTERS:
                lay = ek._tiled_layout(B, C, D, k, cuda_build.SMEM_LIMIT,
                                       row_bytes)
                assert lay is not None, (B, C, D, k)
                chunk, tile, stages, w_res, hold = lay
                assert ek.tiled_smem_bytes(
                    B, C, D, k, chunk, tile, stages, w_res, hold,
                    row_bytes) <= cuda_build.SMEM_LIMIT, (B, C, D, k)
                assert 8 <= chunk <= min(-(-B // 8) * 8, 32), (B, C, D, k)
                if ek.tiled_classes(C, k) <= 1000:
                    assert chunk == min(-(-B // 8) * 8, 32), (B, C, D, k)
                assert 2 <= stages <= ek.TILED_MAX_STAGES
                assert not w_res or tile == min(256, -(-D // 8) * 8)
        ek._tiled_layout.cache_clear()


def test_client_order_largest_first_stable():
    J, S, B = 6, 5, 4
    valid = torch.zeros(J, S, B)
    for j, steps in enumerate((2, 5, 0, 5, 1, 3)):
        valid[j, :steps, 0] = 1.0
    valid[5, 4, 2] = 1.0  # a fourth non-empty step after an empty one
    order, nsteps = ek.client_order(valid)
    assert nsteps.dtype == torch.int32 and order.dtype == torch.int32
    assert nsteps.tolist() == [2, 5, 0, 5, 1, 4]
    assert order.tolist() == [1, 3, 5, 0, 4, 2]


def test_parse_ptxas_report():
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119staged_epoch_kernelILi10ELb1EEEvNS_4ArgsE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_119staged_epoch_kernelILi10ELb1EEEvNS_4ArgsE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 90 registers, used 1 barriers\n"
        "ptxas info    : Function properties for _Zfoo\n"
        "    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads\n"
        "ptxas info    : Used 255 registers\n")
    usage = cuda_build.parse_ptxas(log)
    (name,) = [n for n in usage if "19staged_epoch_kernelILi10ELb1E" in n]
    assert usage[name] == {"stack_bytes": 0, "spill_bytes": 0,
                           "registers": 90}
    assert usage["_Zfoo"] == {"stack_bytes": 8, "spill_bytes": 32,
                              "registers": 255}


# -- the kernel on the card ---------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _kernel_vs_plain(task, args, **kw):
    before = client_epoch.launches
    wk, mk = client_epoch(*args, 0.1, 0.05, 0.01, task, **kw)
    torch.cuda.synchronize()
    assert client_epoch.launches == before + 1
    wp, mp = client_epoch_plain(*args, 0.1, 0.05, 0.01, task)
    torch.testing.assert_close(wk, wp, **W_TOL)
    torch.testing.assert_close(mk, mp, atol=1e-3, rtol=1e-5)
    return wk, mk


@pytest.mark.cuda
@pytest.mark.parametrize("J", [5, 70])
@pytest.mark.parametrize("B_", [32, 17])
@pytest.mark.parametrize("D_", [256, 250, 2000])
@pytest.mark.parametrize("C_", [1, 3, 10, 32])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_kernel_matches_plain_version(task, C_, D_, B_, J):
    _need_card()
    args = _epoch_inputs(task, "cuda", J=J, S=6, C=C_, D=D_, B=B_)
    wk, _ = _kernel_vs_plain(task, args)
    torch.testing.assert_close(wk[1], args[0][1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [256, 250])
def test_cuda_kernel_every_cluster_size(D_, cluster):
    _need_card()
    args = _epoch_inputs("classification", "cuda", S=6, C=10, D=D_)
    _kernel_vs_plain("classification", args, cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("B_", [64, 100])
def test_cuda_kernel_batch_wider_than_a_warp(B_):
    """The row packing walks B in chunks of 32 lanes."""
    _need_card()
    args = _epoch_inputs("classification", "cuda", S=6, C=10, D=2000, B=B_)
    _kernel_vs_plain("classification", args)


@pytest.mark.cuda
def test_cuda_kernel_unaligned_rows():
    """X 4 bytes off a 16-byte boundary: element-wise copies, D % 4 == 0."""
    _need_card()
    W, w0, X, y, rows, valid = _epoch_inputs("classification", "cuda", S=6)
    buf = torch.empty(X.numel() + 1, device="cuda")
    Xu = buf[1:].view(X.shape)
    Xu.copy_(X)
    assert Xu.data_ptr() % 16 != 0
    _kernel_vs_plain("classification", [W, w0, Xu, y, rows, valid])


@pytest.mark.cuda
def test_cuda_shape_no_plan_takes_is_refused():
    """120,000 classes: a chunk of 8 rows' logits of a CTA's classes
    passes a block's shared memory even at 16 CTAs, so the wrapper
    refuses CUDA tensors before any launch (``kernel_impl="plain"`` runs
    them); a forced staged kernel at 33 classes is refused too."""
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=5, S=3, C=120000, D=4)
    before = dict(client_epoch.launches_by_kernel)
    with pytest.raises(ValueError, match="no client_epoch kernel takes"):
        client_epoch(*args, 0.1, 0.05, 0.01, "classification")
    args = _epoch_inputs("classification", "cuda", J=5, S=3, C=33, D=256)
    with pytest.raises(ValueError, match="at most 32 classes"):
        client_epoch(*args, 0.1, 0.05, 0.01, "classification",
                     kernel="staged")
    assert client_epoch.launches_by_kernel == before


@pytest.mark.cuda
def test_cuda_unstaged_kernel_matches_plain_version():
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=3, S=2, C=10, D=2000,
                         B=1024)
    assert launch_plan(3, 1024, 10, 2000, H100_SMS).cluster == 0
    _kernel_vs_plain("classification", args)


@pytest.mark.cuda
@pytest.mark.parametrize("J", [5, 70])
@pytest.mark.parametrize("D_", [256, 250, 2000])
@pytest.mark.parametrize("C_", [1, 10, 26])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_kernel_two_byte_rows_match_plain_version(task, dtype, C_, D_,
                                                       J):
    """bf16 and f16 rows, staged as they are and widened as read: D = 256
    and 2000 copy by cp.async.bulk, D = 250 element by element."""
    _need_card()
    args = _epoch_inputs(task, "cuda", J=J, S=6, C=C_, D=D_)
    args[2] = args[2].to(getattr(torch, dtype))
    wk, _ = _kernel_vs_plain(task, args)
    torch.testing.assert_close(wk[1], args[0][1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_two_byte_rows_every_cluster_size(dtype, cluster):
    _need_card()
    args = _epoch_inputs("classification", "cuda", S=6, C=10, D=256)
    args[2] = args[2].to(getattr(torch, dtype))
    _kernel_vs_plain("classification", args, cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_two_byte_rows_unstaged_and_unaligned(dtype):
    """The unstaged kernel reads 2-byte rows from global memory; an X 2
    bytes off a 16-byte boundary is copied element by element."""
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=3, S=2, C=10, D=2000,
                         B=1024)
    args[2] = args[2].to(getattr(torch, dtype))
    _kernel_vs_plain("classification", args)
    args = _epoch_inputs("classification", "cuda", S=6, C=10, D=256)
    X = args[2].to(getattr(torch, dtype))
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device="cuda")
    args[2] = buf[1:].view(X.shape)
    args[2].copy_(X)
    assert args[2].data_ptr() % 16 != 0
    _kernel_vs_plain("classification", args)


# the staged kernel of 2-byte rows (its producer warp's ring): (task, J,
# S, B, C, D). The main shape; Centralized's one client of 1,501 steps; a
# D whose rows are not 16-byte multiples (lane-wise copies, bulk = 0); B
# not a multiple of 8; the rounded instantiations' class counts and
# letter's exact 26; the regression task's packed targets. Every case has
# an empty client, empty trailing steps and an empty step between others
# (_epoch_inputs; Centralized's one client has none).
RING_CASES = {
    "main": ("classification", 50, 150, 32, 10, 2000),
    "centralized": ("classification", 1, 1501, 32, 10, 2000),
    "D=2001": ("classification", 5, 6, 32, 10, 2001),
    "B=20": ("classification", 5, 6, 20, 10, 2000),
    "C=3": ("classification", 5, 6, 32, 3, 2000),
    "C=16": ("classification", 5, 6, 32, 16, 2000),
    "C=26": ("classification", 5, 6, 32, 26, 2000),
    "regression": ("regression", 5, 6, 32, 1, 2000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_staged_ring_kernel_matches_plain_version(dtype, case):
    """The staged kernel of 2-byte rows, forced, at its plan's cluster and
    ring, against the plain version under the strong penalties (weights
    atol 2e-5, rtol 1e-5): the row packing, the labels packed with the
    rows, the reduce-scatter of the partial logits, both gradient widths
    and the sums of squares folded into the update."""
    _need_card()
    task, J, S, B_, C_, D_ = RING_CASES[case]
    args = _epoch_inputs(task, "cuda", J=max(J, 5), S=S, C=C_, D=D_, B=B_)
    if J == 1:  # client 0: every step holds rows
        args = [args[0][:1].contiguous(), args[1], args[2], args[3],
                args[4][:1].contiguous(), args[5][:1].contiguous()]
    args[2] = args[2].to(getattr(torch, dtype))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = launch_plan(J, B_, C_, D_, sms, row_bytes=2, kernel="staged",
                       active_clusters=ek.wide_active_clusters(0))
    assert plan.stages >= 2, plan
    before = client_epoch.launches_by_kernel["staged"]
    _kernel_vs_plain(task, args, kernel="staged")
    assert client_epoch.launches_by_kernel["staged"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [784, 2000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_staged_ring_every_cluster_size(dtype, D_, cluster):
    """Every cluster of the 2-byte staged kernel that fits (D = 2,000 at
    one CTA does not: its two stages pass a block) and its ring's depth
    there, against the plain version."""
    _need_card()
    if ek.narrow_stages(32, 10, D_, cluster, cuda_build.SMEM_LIMIT) == 0:
        with pytest.raises(ValueError, match="does not fit"):
            launch_plan(5, 32, 10, D_, H100_SMS, row_bytes=2,
                        cluster=cluster)
        return
    args = _epoch_inputs("classification", "cuda", S=6, C=10, D=D_)
    args[2] = args[2].to(getattr(torch, dtype))
    _kernel_vs_plain("classification", args, cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_kernel_is_deterministic(task):
    _need_card()
    args = _epoch_inputs(task, "cuda", J=70, S=6, C=10 if task ==
                         "classification" else 1, D=2000)
    for X in (args[2], args[2].to(torch.bfloat16)):
        args[2] = X
        w1, m1 = client_epoch(*args, 0.1, 0.05, 0.01, task)
        w2, m2 = client_epoch(*args, 0.1, 0.05, 0.01, task)
        torch.cuda.synchronize()
        assert torch.equal(w1, w2) and torch.equal(m1, m2)


# the wide kernel's cases: (forced kernel, J, S, D, B); by shape, D = 6,000
# and B = 4096 are past the staged and unstaged kernels at C >= 10,
# D = 40,000 at every C; D = 6,001 copies rows element-wise (not 16-byte
# multiples); B = 300 works several chunks a step; D = 10,000 is wide_d's
# J and D (W and the step's rows held in shared memory)
WIDE_CASES = {
    "forced D=250": ("wide", 5, 6, 250, 32),
    "forced D=2000": ("wide", 70, 6, 2000, 32),
    "D=6000": (None, 5, 6, 6000, 32),
    "B=4096": (None, 3, 2, 2000, 4096),    # the batch buffer in scratch
    "D=40000": (None, 5, 4, 40000, 32),
    "D=6001": ("wide", 5, 6, 6001, 32),
    "B=300": ("wide", 5, 4, 2000, 300),
    "D=10000": (None, 50, 6, 10000, 32),
}
# the by-shape cases another kernel takes: at C <= 5 D = 6,000 still fits
# the staged kernel and B = 4096 the unstaged one, and at C = 1 so does
# D = 10,000 (W and the anchor whole in 80 KB); every other case is wide
NOT_WIDE = {("D=6000", 1): "staged", ("D=6000", 5): "staged",
            ("B=4096", 1): "unstaged", ("B=4096", 5): "unstaged",
            ("D=10000", 1): "unstaged"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("C_", [1, 5, 10, 11, 32])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_wide_kernel_matches_plain_version(task, C_, case):
    """The wide kernel, forced where the staged kernel would run and by
    shape past the staged and unstaged kernels, against the plain
    version, at exact and rounded instantiations (C = 5 and 11 skip
    classes of the 8 and 16 they run); the by-shape cases of ``NOT_WIDE``
    run the kernel it names; the empty client keeps its weights."""
    _need_card()
    kernel, J, S, D_, B_ = WIDE_CASES[case]
    args = _epoch_inputs(task, "cuda", J=J, S=S, C=C_, D=D_, B=B_)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = launch_plan(
        J, B_, C_, D_, sms, kernel=kernel,
        max_cluster=ek.wide_max_cluster(0),
        active_clusters=ek.wide_active_clusters(0)).kernel
    assert runs == NOT_WIDE.get((case, C_), "wide")
    before = client_epoch.launches_by_kernel[runs]
    wk, _ = _kernel_vs_plain(task, args, kernel=kernel)
    assert client_epoch.launches_by_kernel[runs] == before + 1
    torch.testing.assert_close(wk[1], args[0][1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D_", [6000, 10000])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cuda_wide_kernel_every_cluster_size(cluster, D_):
    """Every cluster at both widths: W in global memory or held, the rows
    streamed twice or held, 3 to 16 stages."""
    _need_card()
    if cluster > ek.wide_max_cluster(0):
        pytest.skip(f"this card schedules clusters of {ek.wide_max_cluster(0)}")
    args = _epoch_inputs("classification", "cuda", J=5, S=6, C=10, D=D_)
    _kernel_vs_plain("classification", args, kernel="wide", cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("D_", [9000, 9001])
def test_cuda_wide_kernel_two_byte_rows(D_, task, dtype):
    """2-byte rows at D = 9,000, past the staged kernel's 8,704, and at
    D = 9,001, whose rows are no multiple of 16 bytes (copied element by
    element into the ring)."""
    _need_card()
    args = _epoch_inputs(task, "cuda", J=5, S=6, C=10, D=D_)
    args[2] = args[2].to(getattr(torch, dtype))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert launch_plan(5, B, 10, D_, sms, row_bytes=2).kernel == "wide"
    before = client_epoch.launches_by_kernel["wide"]
    _kernel_vs_plain(task, args)
    assert client_epoch.launches_by_kernel["wide"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["D=6000", "B=4096"])
def test_cuda_wide_kernel_is_deterministic(case):
    """Two launches of the wide kernel bitwise equal, with the batch
    buffer in shared memory and in global scratch, float32 and bf16
    rows."""
    _need_card()
    _, J, S, D_, B_ = WIDE_CASES[case]
    args = _epoch_inputs("classification", "cuda", J=J, S=S, C=10, D=D_,
                         B=B_)
    for X in (args[2], args[2].to(torch.bfloat16)):
        args[2] = X
        w1, m1 = client_epoch(*args, 0.1, 0.05, 0.01, "classification")
        w2, m2 = client_epoch(*args, 0.1, 0.05, 0.01, "classification")
        torch.cuda.synchronize()
        assert torch.equal(w1, w2) and torch.equal(m1, m2)


# the class-tiled wide kernel's cases: (J, S, D, B); by shape at every C
# past 32 (W's slice held in shared memory or read from W_out; D = 6,001
# copies rows element-wise and reads W_out a float at a time)
TILED_CASES = {
    "D=2000": (5, 4, 2000, 32),
    "D=250": (70, 3, 250, 17),
    "D=10000": (3, 3, 10000, 32),
    "D=6001": (3, 2, 6001, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILED_CASES))
@pytest.mark.parametrize("C_", [33, 105, 1000])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cuda_tiled_wide_kernel_matches_plain_version(task, C_, case):
    """The class-tiled wide kernel by shape past 32 classes against the
    plain version; the empty client keeps its weights."""
    _need_card()
    J, S, D_, B_ = TILED_CASES[case]
    args = _epoch_inputs(task, "cuda", J=J, S=S, C=C_, D=D_, B=B_)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert launch_plan(J, B_, C_, D_, sms).kernel == "wide_tiled"
    before = client_epoch.launches_by_kernel["wide_tiled"]
    wk, _ = _kernel_vs_plain(task, args)
    assert client_epoch.launches_by_kernel["wide_tiled"] == before + 1
    torch.testing.assert_close(wk[1], args[0][1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cuda_tiled_wide_kernel_every_cluster_size(cluster):
    """105 classes forced at each cluster size (16 where the card takes
    it): 105, 53, 27, 14 or 7 classes a CTA, W's slice held in shared
    memory from 8 CTAs on, streamed from W_out below."""
    _need_card()
    if cluster > ek.wide_max_cluster(0):
        pytest.skip("the card does not schedule a 16-CTA cluster")
    args = _epoch_inputs("classification", "cuda", J=5, S=4, C=105, D=2000)
    plan = launch_plan(5, 32, 105, 2000, H100_SMS, kernel="wide_tiled",
                       cluster=cluster, max_cluster=16)
    assert plan.w_res == (cluster >= 8)
    _kernel_vs_plain("classification", args, kernel="wide_tiled",
                     cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("C_", [1, 10, 32])
def test_cuda_tiled_wide_kernel_forced_at_few_classes(C_):
    """Forced at 32 classes or fewer, where the class-instantiated wide
    kernel runs by shape: one partial tile."""
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=5, S=4, C=C_, D=2000)
    _kernel_vs_plain("classification", args, kernel="wide_tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_tiled_wide_kernel_two_byte_rows(dtype):
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=5, S=4, C=105, D=2000)
    args[2] = args[2].to(getattr(torch, dtype))
    before = client_epoch.launches_by_kernel["wide_tiled"]
    _kernel_vs_plain("classification", args)
    assert client_epoch.launches_by_kernel["wide_tiled"] == before + 1


@pytest.mark.cuda
def test_cuda_tiled_wide_kernel_tie_takes_the_first_maximum():
    """W = anchor = 0 at 105 classes: every logit of the first step is 0,
    so the first maximum is class 0 and each client's hits are its valid
    label-0 rows, exactly (one step)."""
    _need_card()
    W, w0, X, y, rows, valid = _epoch_inputs("classification", "cuda", J=5,
                                             S=1, C=105, D=2000)
    y = (torch.arange(N, device="cuda") % 3).to(torch.int32)  # many zeros
    W, w0 = torch.zeros_like(W), torch.zeros_like(w0)
    args = [W, w0, X, y, rows, valid]
    _, mk = _kernel_vs_plain("classification", args)
    zeros = ((y[rows[:, 0].long()] == 0).float() * valid[:, 0]).sum(-1)
    assert float(zeros.sum()) > 0
    assert torch.equal(mk[:, 1], zeros)


@pytest.mark.cuda
@pytest.mark.parametrize("C_", [105, 1000])
def test_cuda_tiled_wide_kernel_is_deterministic(C_):
    """Two launches bitwise equal, the batch buffer held (C = 105) and in
    global scratch (C = 1,000), float32 and bf16 rows."""
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=5, S=4, C=C_, D=2000)
    for X in (args[2], args[2].to(torch.bfloat16)):
        args[2] = X
        w1, m1 = client_epoch(*args, 0.1, 0.05, 0.01, "classification")
        w2, m2 = client_epoch(*args, 0.1, 0.05, 0.01, "classification")
        torch.cuda.synchronize()
        assert torch.equal(w1, w2) and torch.equal(m1, m2)
