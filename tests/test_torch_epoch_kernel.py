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

The CUDA kernel itself needs a card; the ``cuda``-marked tests hold it
against the plain version there, over a grid of shapes (both tasks, C in
{1, 3, 10, 32}, D in {256, 250, 2000}, B in {32, 17}, J in {5, 70}),
every cluster size, unaligned rows, 2-byte rows, the unstaged kernel and
a bitwise determinism check, and skip on a machine without one. The
launch plan (cluster size, client order, shared-memory bytes, refused
shapes) is pure Python and tested here on the CPU.
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
    plan = ek.launch_plan(J, B, C, D, H100_SMS)
    assert plan.cluster == k
    assert plan.ctas == J * k
    assert plan.smem_bytes <= cuda_build.SMEM_LIMIT
    assert plan.slice_width % 4 == 0
    assert (k - 1) * plan.slice_width < D  # every CTA holds columns


def test_plan_main_path_layout():
    plan = ek.launch_plan(50, 32, 10, 2000, H100_SMS)
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
                                  (27, 32), (32, 32)])
def test_plan_instantiated_classes(C, nc):
    assert ek.instantiated_classes(C) == nc
    assert ek.launch_plan(5, 32, C, 256, H100_SMS).classes == nc


def test_plan_refuses_what_fits_nowhere():
    """No plan (None) past the instantiated classes or shared memory; a
    bad shape or a forced cluster that does not fit raise."""
    assert ek.launch_plan(5, 32, 33, 256, H100_SMS) is None
    assert ek.launch_plan(5, 4096, 32, 4000, H100_SMS) is None
    with pytest.raises(ValueError, match="bad shape"):
        ek.launch_plan(5, 32, 0, 256, H100_SMS)
    with pytest.raises(ValueError, match="at most 32 classes"):
        ek.launch_plan(5, 32, 33, 256, H100_SMS, cluster=1)
    with pytest.raises(ValueError, match="does not fit"):
        ek.launch_plan(50, 32, 10, 2000, H100_SMS, cluster=2)
    with pytest.raises(ValueError, match="bad shape"):
        ek.launch_plan(5, 0, 10, 256, H100_SMS)


@pytest.mark.parametrize("J,B,C,D,smem_limit,route", [
    (50, 32, 10, 2000, cuda_build.SMEM_LIMIT, 4),   # the main path
    (400, 32, 10, 2000, cuda_build.SMEM_LIMIT, 4),  # 400 partitions
    (50, 1024, 10, 2000, cuda_build.SMEM_LIMIT, 0),  # the unstaged kernel
    (5, 32, 33, 256, cuda_build.SMEM_LIMIT, None),  # more than 32 classes
    (5, 4096, 32, 4000, cuda_build.SMEM_LIMIT, None),
    (5, 32, 10, 20000, cuda_build.SMEM_LIMIT, None),  # W too wide to hold
    (50, 32, 10, 2000, 100000, 8),   # a smaller block: a wider cluster
    (50, 32, 10, 2000, 20000, None),
])
def test_plan_is_none_where_no_kernel_takes_the_shape(J, B, C, D,
                                                      smem_limit, route):
    """The plan by shape alone, with ``num_sms`` and ``smem_limit``
    passed in: its cluster size, or None where no kernel takes the shape
    (the wrapper then refuses CUDA tensors before any launch)."""
    plan = ek.launch_plan(J, B, C, D, H100_SMS, smem_limit)
    assert (plan.cluster if plan else None) == route
    if plan is not None:
        assert plan.smem_bytes <= smem_limit


def test_plan_two_byte_rows_layout():
    """2-byte rows: slices round to 8 elements (16 bytes), the two step
    tiles take half the bytes, so a smaller cluster holds the main path
    and the D limit of the largest cluster rises (C = 10, B = 32: 5,376
    float32 columns, 8,704 2-byte ones)."""
    assert ek.slice_width(2000, 4, 2) == 504 and ek.slice_width(250, 4, 2) == 64
    assert ek.slice_width(2000, 4) == 500
    f32 = ek.staged_smem_bytes(32, 10, 2000, 4)
    b16 = ek.staged_smem_bytes(32, 10, 2000, 4, row_bytes=2)
    # the tiles: 2 * 32 rows of 500 floats against 2 * 32 rows of 504
    # 2-byte elements; W and the anchor slices grow by 2 * 10 * 4 floats
    assert f32 - b16 == 4 * 2 * 32 * 500 - 2 * 2 * 32 * 504 - 4 * 2 * 10 * 4
    plan = ek.launch_plan(50, 32, 10, 2000, H100_SMS, row_bytes=2)
    assert (plan.cluster, plan.slice_width) == (2, 1000)
    for D, f32_k, b16_k in ((5376, 8, 8), (5377, 0, 8), (8704, 0, 8),
                            (8705, 0, 0)):
        a = ek.launch_plan(5, 32, 10, D, H100_SMS)
        b = ek.launch_plan(5, 32, 10, D, H100_SMS, row_bytes=2)
        assert (a.cluster if a else 0) == f32_k, D
        assert (b.cluster if b else 0) == b16_k, D


def test_plan_falls_back_to_unstaged_kernel_for_huge_batches():
    plan = ek.launch_plan(50, 1024, 10, 2000, H100_SMS)
    assert plan.cluster == 0 and plan.ctas == 50 and plan.classes == 32
    assert plan.smem_bytes == ek.unstaged_smem_bytes(1024, 10, 2000)
    assert ek.kernel_symbol(plan, 10) == "21unstaged_epoch_kernelILi32E"


def test_plan_takes_every_shape_the_unstaged_kernel_takes():
    for B in (1, 16, 17, 32, 64, 256, 1024, 4096):
        for C in (1, 3, 10, 16, 32):
            for D in (1, 4, 250, 256, 784, 2000, 3000):
                if ek.unstaged_smem_bytes(B, C, D) > cuda_build.SMEM_LIMIT:
                    continue
                plan = ek.launch_plan(50, B, C, D, H100_SMS)
                assert plan.smem_bytes <= cuda_build.SMEM_LIMIT


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
    """33 classes: no instantiation takes them, so the wrapper refuses
    CUDA tensors before any launch (``kernel_impl="plain"`` runs them)."""
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=5, S=3, C=33, D=256)
    before = dict(client_epoch.launches_by_kernel)
    with pytest.raises(ValueError, match="no client_epoch kernel takes"):
        client_epoch(*args, 0.1, 0.05, 0.01, "classification")
    assert client_epoch.launches_by_kernel == before


@pytest.mark.cuda
def test_cuda_unstaged_kernel_matches_plain_version():
    _need_card()
    args = _epoch_inputs("classification", "cuda", J=3, S=2, C=10, D=2000,
                         B=1024)
    assert ek.launch_plan(3, 1024, 10, 2000, H100_SMS).cluster == 0
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
