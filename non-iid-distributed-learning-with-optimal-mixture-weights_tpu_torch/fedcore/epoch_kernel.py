"""Kernel 1: one local-SGD epoch of every client, bias-free linear model.

Replaces the JAX package's Pallas TPU kernel
``fedcore/pallas_kernel.py:_epoch_kernel`` (built by
``make_pallas_epoch``). The hand-written CUDA kernel is
``csrc/client_epoch.cu``, one launch per local epoch for all J clients.

What bounds it on an H100 is not the bytes of the gathered rows (about
``4 C`` fp32 flops per element read, far below the fp32 ridge) but the
longest client's serial chain of steps: under a Dirichlet split one
client walks several times the mean client's steps, and the launch lasts
that client's non-empty steps times one step's latency. The design cuts
that latency (``launch_plan`` chooses its shape):

- a thread-block cluster of ``k`` CTAs owns one client, each CTA holding
  a ``D/k`` slice of W and of the prox anchor in shared memory; one
  exchange of the partial logits and sums of squares through
  distributed shared memory per step;
- each step's valid rows are staged into shared memory asynchronously
  (``cp.async.bulk`` per row, or element-wise ``cp.async`` when rows are
  not 16-byte aligned), the next step's copies in flight while the
  current one computes, and both passes read the staged rows;
- clusters run the clients with the most non-empty steps first
  (``client_order``), so a second wave holds only short clients;
- the class count is a template parameter, exact for the registry's
  datasets (at most 32 classes);
- rows are read in the type X is stored in: float32, or bfloat16 or
  float16 under ``prepare_setup(feature_dtype=...)``, staged as they are
  (2-byte rows halve the ring) and widened to fp32 as they are read; one
  library per row type (``cuda_build.BUILDS``).

Two more plans take what the staged kernel cannot (``launch_plan``):
batches too large to stage run an unstaged kernel where W and the anchor
fit one CTA whole (one CTA per client, rows read from global memory in
both passes); every other shape of at most 32 classes runs the wide
kernel: a cluster of ``k`` CTAs per client (up to 16 where the card
schedules it, ``wide_max_cluster``), W's slice updated in place in global
memory, rows read from global memory in both passes, the batch worked in
chunks of at most ``MAX_CHUNK`` rows with one exchange each, so neither D
nor B bounds it. Past 32 classes every shape runs the class-tiled wide
kernel (``"wide_tiled"``): the wide kernel with C taken at run time, its
accumulators walking the classes in tiles of 32 and each row's loss one
warp's online logsumexp over the tiles; its chunk shrinks as C grows
(about 24 rows at C = 1,000), so only a chunk of 8 rows' logits past a
block's shared memory (some 3,600 classes) bounds it.

``client_epoch`` is the wrapper: CPU tensors go to ``client_epoch_plain``,
the plain PyTorch version of the same function; CUDA tensors launch the
kernel ``launch_plan`` names or raise. ``client_epoch.launches`` counts
kernel launches, ``client_epoch.launches_by_kernel`` the same by kernel
(``KERNELS``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build

WARPS = 8                  # of a CTA (kThreads / 32 in client_epoch.cu)
MAX_CLUSTER = 8            # the portable cluster size
STAGED_CLUSTERS = (1, 2, 4, MAX_CLUSTER)
WIDE_CLUSTERS = STAGED_CLUSTERS + (16,)  # 16 where the card schedules it
HEADER_BYTES = 48          # mbarriers and per-stage counts (client_epoch.cu)
WIDE_HEADER_BYTES = 16     # the wide kernel's step header (client_epoch.cu)
MAX_CHUNK = 128            # rows of one exchange of the wide kernel
MAX_CLASSES = 32           # of the instantiations; past it the tiled one
KERNELS = ("staged", "unstaged", "wide", "wide_tiled")
# class counts with an exact instantiation; any other C runs the next bound
EXACT_CLASSES = (1, 2, 3, 6, 10, 26)
CLASS_BOUNDS = (4, 8, 16, 32)
# the library (cuda_build.BUILDS) that reads rows of each feature dtype
ROW_LIBRARIES = {torch.float32: "client_epoch",
                 torch.bfloat16: "client_epoch_bf16",
                 torch.float16: "client_epoch_f16"}


def client_epoch_plain(W, anchor, X, y, rows, valid, lr, mu, lam, task):
    """The epoch in plain PyTorch, batched over the client axis.

    ``W (J, C, D)`` epoch-start weights, ``anchor (C, D)`` the
    round-incoming weights (the prox anchor of every local epoch,
    ``pallas_kernel.py:55``), ``X (N, D)`` float32, bfloat16 or float16
    (gathered rows widened to float32, as JAX promotes them in the
    product), ``y (N,)`` int32 labels or
    float32 targets, ``rows (J, S, B)`` global row ids, ``valid (J, S, B)``
    0/1. Returns ``(W (J, C, D), metrics (J, 3))`` with metrics
    ``(sum loss*cnt, sum correct, sum cnt)`` over the epoch's steps.

    The whole epoch's gathered features ``(J, S, B, D)``, in float32, are
    built in one index op when they fit ``route.EPOCH_GATHER_BYTES_LIMIT``,
    else one step's ``(J, B, D)`` at a time.
    """
    from .route import EPOCH_GATHER_BYTES_LIMIT

    J, S, B = rows.shape
    C, D = anchor.shape
    cls = task == "classification"
    rows = rows.long()
    whole = J * S * B * D * 4 <= EPOCH_GATHER_BYTES_LIMIT
    xs = X[rows].float() if whole else None
    ys = y[rows]
    lr, mu, lam = (torch.tensor(v, dtype=torch.float32, device=W.device)
                   for v in (lr, mu, lam))
    met = torch.zeros((J, 3), dtype=torch.float32, device=W.device)
    for s in range(S):
        xb = xs[:, s] if whole else X[rows[:, s]].float()   # (J, B, D)
        yb, bv = ys[:, s], valid[:, s]                       # (J, B)
        cnt = bv.sum(1)
        inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
        scale = (bv * inv_cnt[:, None])[..., None]           # (J, B, 1)
        z = torch.bmm(xb, W.transpose(1, 2))                 # (J, B, C)
        if cls:
            zmax = z.max(-1, keepdim=True).values
            ez = torch.exp(z - zmax)
            Z = ez.sum(-1, keepdim=True)
            onehot = torch.nn.functional.one_hot(yb.long(), C).float()
            per = (torch.log(Z) + zmax)[..., 0] - (z * onehot).sum(-1)
            dz = (ez / Z - onehot) * scale
            correct = ((torch.argmax(z, -1) == yb).float() * bv).sum(1)
        else:
            err = z - yb[..., None]
            per = torch.square(err).sum(-1) / C
            dz = err * (2.0 / C) * scale
            correct = torch.zeros_like(cnt)
        data_loss = (per * bv).sum(1) * inv_cnt
        grad = torch.bmm(dz.transpose(1, 2), xb)             # (J, C, D)
        diff = W - anchor
        sq_p = torch.square(diff).sum((1, 2))[:, None, None]
        sq_r = torch.square(W).sum((1, 2))[:, None, None]
        one = torch.ones_like(sq_p)
        norm_p = torch.where(sq_p > 0, torch.sqrt(torch.where(sq_p > 0, sq_p, one)), 0.0)
        norm_r = torch.where(sq_r > 0, torch.sqrt(torch.where(sq_r > 0, sq_r, one)), 0.0)
        grad = grad + mu * torch.where(
            sq_p > 0, diff / torch.clamp(norm_p, min=1e-30), 0.0)
        grad = grad + lam * torch.where(
            sq_r > 0, W / torch.clamp(norm_r, min=1e-30), 0.0)
        loss = data_loss + mu * norm_p[:, 0, 0] + lam * norm_r[:, 0, 0]
        ok = (cnt > 0).float()[:, None, None]
        W = W - lr * ok * grad
        met = met + torch.stack([loss * cnt, correct, cnt], dim=1)
    return W, met


def _check(W, anchor, X, y, rows, valid, task):
    J, C, D = W.shape
    expect = {
        "anchor": (anchor, torch.float32, (C, D)),
        "X": (X, X.dtype, (X.shape[0], D)),
        "y": (y, torch.int32 if task == "classification" else torch.float32,
              (X.shape[0],)),
        "rows": (rows, torch.int32, (J,) + tuple(rows.shape[1:])),
        "valid": (valid, torch.float32, tuple(rows.shape)),
    }
    if W.dtype != torch.float32 or not W.is_contiguous():
        raise ValueError("W must be a contiguous float32 (J, C, D) tensor")
    if X.dtype not in ROW_LIBRARIES:
        raise ValueError(f"X must be one of {list(ROW_LIBRARIES)}, got "
                         f"{X.dtype}")
    if rows.dim() != 3:
        raise ValueError(f"rows must be (J, S, B), got {tuple(rows.shape)}")
    for name, (t, dtype, shape) in expect.items():
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device}, W on {W.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def instantiated_classes(C: int) -> int:
    """The class count of the kernel instantiation that runs ``C``
    classes: ``C`` itself when it is one of ``EXACT_CLASSES``, else the
    next of ``CLASS_BOUNDS`` (its classes from ``C`` on are skipped); 0
    past ``MAX_CLASSES``, where no instantiation holds them and the
    class-tiled wide kernel takes ``C`` at run time."""
    if C < 1:
        raise ValueError(f"client_epoch kernel takes 1 class or more, got {C}")
    if C in EXACT_CLASSES:
        return C
    return next((nc for nc in CLASS_BOUNDS if C <= nc), 0)


def slice_width(D: int, k: int, row_bytes: int = 4) -> int:
    """Columns of D one CTA of a k-cluster holds: ``ceil(D / k)`` rounded
    up to 16 bytes of rows (4 float32 or 8 2-byte elements: 16-byte
    aligned slices); the last may be narrower."""
    return _round_up(-(-D // k), 16 // row_bytes)


def staged_smem_bytes(B: int, C: int, D: int, k: int,
                      row_bytes: int = 4) -> int:
    """Shared memory of one CTA of the staged kernel (the layout of
    ``staged_smem_bytes`` in ``client_epoch.cu``): the W and anchor
    slices, two stages of ``(B, Dk)`` rows of ``row_bytes`` elements, the
    double-buffered exchange of partial logits, the logits, per-row
    scratch and row ids."""
    Dk = slice_width(D, k, row_bytes)
    Bp, CP = _round_up(B, 8), _round_up(instantiated_classes(C), 4)
    floats = (2 * C * Dk + 2 * (4 + Bp * CP) + Bp * CP + 4 * Bp
              + 2 * WARPS)
    return HEADER_BYTES + 4 * (floats + 2 * Bp) + row_bytes * 2 * Bp * Dk


def unstaged_smem_bytes(B: int, C: int, D: int) -> int:
    """Shared memory of the unstaged kernel's CTA: W and the anchor
    whole, the logits and per-row scratch."""
    return 4 * (2 * C * D + B * C + 3 * B + 2 * WARPS) + 4 * B


def _wide_classes(C: int, tiled: bool) -> int:
    """The classes a wide CTA's layout holds: the instantiation's, or
    ``C`` itself for the class-tiled kernel (the only one past
    ``MAX_CLASSES``)."""
    return C if tiled else (instantiated_classes(C) or C)


def wide_batch_floats(B: int, C: int, tiled: bool = False) -> int:
    """Floats of one wide CTA's batch buffer: the packed rows' ids and
    weights and d loss / dz of each (``wide_batch_floats`` in
    ``client_epoch.cu``); ``tiled`` for the class-tiled kernel."""
    return _round_up(B, 8) * (_round_up(_wide_classes(C, tiled), 4) + 2)


def wide_smem_bytes(B: int, C: int, chunk: int, hold: bool,
                    tiled: bool = False) -> int:
    """Shared memory of one CTA of the wide kernel (``wide_smem_bytes`` in
    ``client_epoch.cu``): the step header, the double-buffered exchange of
    a chunk's partial logits, the chunk's row losses and hits, the block
    sums, and the batch buffer when ``hold`` keeps it there; ``tiled`` for
    the class-tiled kernel. Independent of D."""
    CP = _round_up(_wide_classes(C, tiled), 4)
    floats = 2 * (4 + chunk * CP) + 2 * chunk + 2 * WARPS
    return (WIDE_HEADER_BYTES + 4 * floats
            + (4 * wide_batch_floats(B, C, tiled) if hold else 0))


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """How one launch runs: ``kernel`` one of ``KERNELS``; ``cluster``
    CTAs per client (0 for the unstaged kernel, one CTA per client), each
    holding ``slice_width`` columns of D; ``classes`` is the instantiated
    class count (0 for the class-tiled kernel, which takes C at run time),
    ``smem_bytes`` one CTA's dynamic shared memory, ``ctas`` the grid.
    The wide kernels work the batch in chunks of ``chunk`` rows and keep
    their batch buffers in ``scratch_bytes`` of global memory (0: in
    shared memory)."""

    cluster: int
    slice_width: int
    classes: int
    smem_bytes: int
    ctas: int
    kernel: str = "staged"
    chunk: int = 0
    scratch_bytes: int = 0


def _one_wave(J: int, num_sms: int, sizes) -> int:
    """The largest of ``sizes`` whose ``J * k`` CTAs fit the SMs in one
    wave (more SMs per client shorten the critical chain)."""
    return max(k for k in sizes if k == 1 or J * k <= num_sms)


def _no_empty_slice(k: int, floor: int, D: int, row_bytes: int) -> int:
    """``k`` halved, down to ``floor``, while a slice would be empty."""
    while k > floor and (k - 1) * slice_width(D, k, row_bytes) >= D:
        k //= 2
    return k


def _staged_plan(J, B, C, D, num_sms, smem_limit, cluster, row_bytes):
    sizes = [k for k in STAGED_CLUSTERS
             if staged_smem_bytes(B, C, D, k, row_bytes) <= smem_limit]
    if cluster is not None:
        if cluster not in sizes:
            raise ValueError(
                f"cluster {cluster} does not fit: the sizes that fit "
                f"C={C}, D={D}, B={B} are {sizes}")
        k = cluster
    elif not sizes:
        return None
    else:
        k = _no_empty_slice(max(sizes[0], _one_wave(J, num_sms,
                                                    STAGED_CLUSTERS)),
                            sizes[0], D, row_bytes)
    return EpochPlan(k, slice_width(D, k, row_bytes), instantiated_classes(C),
                     staged_smem_bytes(B, C, D, k, row_bytes), J * k)


def _wide_plan(J, B, C, D, num_sms, smem_limit, cluster, row_bytes,
               max_cluster, tiled=False):
    sizes = [k for k in WIDE_CLUSTERS if k <= max_cluster]
    chunk = next((c for c in range(min(_round_up(B, 8), MAX_CHUNK), 0, -8)
                  if wide_smem_bytes(B, C, c, False, tiled) <= smem_limit),
                 None)
    if cluster is not None and (chunk is None or cluster not in sizes):
        raise ValueError(
            f"cluster {cluster} does not fit the wide kernel: it takes "
            f"{sizes} and needs {wide_smem_bytes(B, C, 8, False, tiled)} "
            f"bytes of shared memory at least, of {smem_limit}")
    if chunk is None:
        return None
    hold = wide_smem_bytes(B, C, chunk, True, tiled) <= smem_limit
    k = cluster if cluster is not None else _no_empty_slice(
        _one_wave(J, num_sms, sizes), 1, D, row_bytes)
    return EpochPlan(
        k, slice_width(D, k, row_bytes),
        0 if tiled else instantiated_classes(C),
        wide_smem_bytes(B, C, chunk, hold, tiled), J * k,
        "wide_tiled" if tiled else "wide", chunk,
        0 if hold else 4 * J * k * wide_batch_floats(B, C, tiled))


def launch_plan(J: int, B: int, C: int, D: int, num_sms: int,
                smem_limit: int = cuda_build.SMEM_LIMIT,
                cluster: int | None = None,
                row_bytes: int = 4, kernel: str | None = None,
                max_cluster: int = MAX_CLUSTER) -> EpochPlan | None:
    """The launch shape for ``J`` clients of batch ``B``, ``C`` classes
    and ``D`` features of ``row_bytes`` each (4, or 2 for bfloat16 and
    float16 rows) on a card of ``num_sms`` SMs, in this order:

    - the staged kernel where a cluster of 1, 2, 4 or 8 CTAs fits two
      step tiles in ``smem_limit``: ``k`` is the larger of the smallest
      that fits and the largest whose ``J * k`` CTAs still fit the SMs in
      one wave, halved while a slice would be empty;
    - else the unstaged kernel where W and the anchor fit whole;
    - else the wide kernel: ``k`` by the same one-wave rule over clusters
      of up to ``max_cluster`` (8, or 16 where the card schedules it) with
      no shared-memory floor, the batch in chunks of the most rows (a
      multiple of 8, at most ``MAX_CHUNK``) that fit ``smem_limit``, the
      batch buffer in shared memory where it fits too;
    - past ``MAX_CLASSES`` classes, at every B and D, the class-tiled wide
      kernel (``"wide_tiled"``) by the same rules, its layout holding C.

    None only for a ``smem_limit`` too small for a chunk of 8 rows (past
    about 3,600 classes at the card's limit). ``kernel`` forces one of
    ``KERNELS`` (``"wide_tiled"`` at any C; the others at most
    ``MAX_CLASSES``) and ``cluster`` its ``k`` (a ``cluster`` alone forces
    the staged kernel's); ``ValueError`` says when they do not fit.
    """
    if J < 0 or B < 1 or C < 1 or D < 1:
        raise ValueError(f"bad shape J={J}, B={B}, C={C}, D={D}")
    if kernel not in (None,) + KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel is None and cluster is not None:
        kernel = "staged"
    if C > MAX_CLASSES and kernel not in (None, "wide_tiled"):
        raise ValueError(f"the {kernel} kernel does not fit C={C} (cluster "
                         f"{cluster}): it takes at most {MAX_CLASSES} "
                         "classes; the class-tiled wide kernel takes more")
    if C > MAX_CLASSES or kernel == "wide_tiled":
        return _wide_plan(J, B, C, D, num_sms, smem_limit, cluster,
                          row_bytes, max_cluster, tiled=True)
    if kernel in (None, "staged"):
        plan = _staged_plan(J, B, C, D, num_sms, smem_limit, cluster,
                            row_bytes)
        if plan is not None:
            return plan
        if kernel == "staged":
            raise ValueError(f"the staged kernel does not fit C={C}, D={D}, "
                             f"B={B} at any cluster size")
    if kernel in (None, "unstaged"):
        smem = unstaged_smem_bytes(B, C, D)
        if smem <= smem_limit and cluster is None:
            return EpochPlan(0, D, 8 if C <= 8 else MAX_CLASSES, smem, J,
                             "unstaged")
        if kernel == "unstaged":
            raise ValueError(f"the unstaged kernel does not fit C={C}, "
                             f"D={D}, B={B} (cluster {cluster})")
    return _wide_plan(J, B, C, D, num_sms, smem_limit, cluster, row_bytes,
                      max_cluster)


def kernel_symbol(plan: EpochPlan, C: int) -> str:
    """The part of the mangled name that picks out the instantiation
    ``plan`` runs for ``C`` classes in the compiler's report
    (``cuda_build.ptxas_usage``)."""
    if plan.kernel == "unstaged":
        name, args = "unstaged_epoch_kernel", f"ILi{plan.classes}E"
    elif plan.kernel == "wide_tiled":
        name, args = "wide_tiled_epoch_kernel", "E"
    else:
        name = f"{plan.kernel}_epoch_kernel"
        args = f"ILi{plan.classes}ELb{int(C in EXACT_CLASSES)}E"
    return f"{len(name)}{name}{args}"


def client_order(valid):
    """``(order, nsteps)`` from ``valid (J, S, B)``: each client's count
    of non-empty steps, and the clients by that count, largest first
    (ties in client order). Both int32 on ``valid``'s device, computed
    there without a host sync."""
    nsteps = (valid != 0).any(-1).sum(-1, dtype=torch.int32)
    order = torch.argsort(nsteps, descending=True, stable=True)
    return order.to(torch.int32), nsteps


@functools.lru_cache(maxsize=None)
def _library(name: str = "client_epoch"):
    """The loaded library ``name`` (one of ``ROW_LIBRARIES``)."""
    lib = cuda_build.load(name)
    lib.client_epoch_launch_staged.restype = ctypes.c_int
    lib.client_epoch_launch_staged.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_launch_unstaged.restype = ctypes.c_int
    lib.client_epoch_launch_unstaged.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_launch_wide.restype = ctypes.c_int
    lib.client_epoch_launch_wide.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_staged_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_staged_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.client_epoch_unstaged_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_unstaged_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.client_epoch_instantiated_classes.restype = ctypes.c_int
    lib.client_epoch_instantiated_classes.argtypes = [ctypes.c_int]
    lib.client_epoch_row_bytes.restype = ctypes.c_int
    lib.client_epoch_row_bytes.argtypes = []
    lib.client_epoch_slice_width.restype = ctypes.c_int
    lib.client_epoch_slice_width.argtypes = [ctypes.c_int] * 2
    lib.client_epoch_wide_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_wide_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.client_epoch_wide_batch_floats.restype = ctypes.c_size_t
    lib.client_epoch_wide_batch_floats.argtypes = [ctypes.c_int] * 3
    lib.client_epoch_wide_max_cluster.restype = ctypes.c_int
    lib.client_epoch_wide_max_cluster.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def wide_max_cluster(device_index: int, name: str = "client_epoch") -> int:
    """The largest cluster the wide kernel launches on card
    ``device_index``: 16 where the card schedules a 16-CTA cluster of its
    largest CTA, else 8 (``client_epoch_wide_max_cluster`` of library
    ``name``)."""
    with torch.cuda.device(device_index):
        return _library(name).client_epoch_wide_max_cluster()


def _check_plan(lib, plan: EpochPlan, B: int, C: int, D: int,
                row_bytes: int) -> None:
    """The plan's layout must be the kernel's: same row type, shared
    memory, instantiation, slice and, wide, scratch."""
    scratch = 0
    tiled = int(plan.kernel == "wide_tiled")
    if plan.kernel == "staged":
        smem = lib.client_epoch_staged_smem_bytes(B, C, D, plan.cluster)
    elif plan.kernel in ("wide", "wide_tiled"):
        hold = plan.scratch_bytes == 0
        smem = lib.client_epoch_wide_smem_bytes(B, C, plan.chunk, int(hold),
                                                tiled)
        if not hold:
            scratch = 4 * plan.ctas * lib.client_epoch_wide_batch_floats(
                B, C, tiled)
    else:
        smem = lib.client_epoch_unstaged_smem_bytes(B, C, D)
    if plan.kernel == "unstaged":
        nc, width = plan.classes, D
    else:
        nc = 0 if tiled else lib.client_epoch_instantiated_classes(C)
        width = lib.client_epoch_slice_width(D, plan.cluster)
    got = (lib.client_epoch_row_bytes(), smem, nc, width, scratch)
    if got != (row_bytes, plan.smem_bytes, plan.classes, plan.slice_width,
               plan.scratch_bytes):
        raise RuntimeError(
            f"launch plan {plan} for {row_bytes}-byte rows disagrees with "
            f"csrc/client_epoch.cu (row bytes, smem bytes, classes, slice, "
            f"scratch bytes = {got})")


def client_epoch(W, anchor, X, y, rows, valid, lr, mu, lam, task,
                 cluster=None, kernel=None):
    """One local epoch of all J clients; same contract as
    ``client_epoch_plain``. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/client_epoch.cu`` as ``launch_plan`` says, or
    raise where no plan takes the shape (a chunk of 8 rows' logits past
    a block's shared memory: some 3,600 classes).
    ``kernel`` forces one of ``KERNELS`` and ``cluster`` the cluster size
    (for tests and measurement)."""
    _check(W, anchor, X, y, rows, valid, task)
    if W.device.type == "cpu":
        return client_epoch_plain(W, anchor, X, y, rows, valid, lr, mu, lam,
                                  task)
    if W.device.type != "cuda":
        raise ValueError(f"client_epoch runs on cpu or cuda, not {W.device}")
    J, C, D = W.shape
    S, B = rows.shape[1:]
    row_bytes = X.element_size()
    sms = torch.cuda.get_device_properties(W.device).multi_processor_count
    name = ROW_LIBRARIES[X.dtype]
    plan = launch_plan(
        J, B, C, D, sms, cluster=cluster, row_bytes=row_bytes, kernel=kernel,
        max_cluster=wide_max_cluster(W.device.index, name))
    if plan is None:
        raise ValueError(
            f"no client_epoch kernel takes C={C}: a chunk of 8 rows' "
            f"logits needs {wide_smem_bytes(B, C, 8, False, True)} bytes "
            f"of shared memory, a block has {cuda_build.SMEM_LIMIT}: run it "
            "with kernel_impl='plain'")
    lib = _library(name)
    _check_plan(lib, plan, B, C, D, row_bytes)
    W_out = torch.empty_like(W)
    metrics = torch.zeros((J, 3), dtype=torch.float32, device=W.device)
    if J == 0:
        return W_out, metrics
    stream = torch.cuda.current_stream(W.device).cuda_stream
    is_cls = int(task == "classification")
    scalars = (float(lr), float(mu), float(lam), stream)
    if plan.kernel == "unstaged":
        err = lib.client_epoch_launch_unstaged(
            W.data_ptr(), anchor.data_ptr(), X.data_ptr(), y.data_ptr(),
            rows.data_ptr(), valid.data_ptr(), W_out.data_ptr(),
            metrics.data_ptr(), J, S, B, C, D, is_cls, *scalars)
    else:
        order, nsteps = client_order(valid)
        ptrs = (W.data_ptr(), anchor.data_ptr(), X.data_ptr(), y.data_ptr(),
                rows.data_ptr(), valid.data_ptr(), order.data_ptr(),
                nsteps.data_ptr(), W_out.data_ptr(), metrics.data_ptr())
        if plan.kernel == "staged":
            bulk = int((D * row_bytes) % 16 == 0 and X.data_ptr() % 16 == 0)
            err = lib.client_epoch_launch_staged(
                *ptrs, J, S, B, C, D, plan.cluster, is_cls, bulk, *scalars)
        else:
            scratch = (torch.empty(plan.scratch_bytes // 4,
                                   dtype=torch.float32, device=W.device)
                       if plan.scratch_bytes else None)
            err = lib.client_epoch_launch_wide(
                *ptrs, None if scratch is None else scratch.data_ptr(), J, S,
                B, C, D, plan.cluster, plan.chunk,
                int(plan.kernel == "wide_tiled"), is_cls, *scalars)
    cuda_build.check(err, "client_epoch launch", lib)
    client_epoch.launches += 1
    client_epoch.launches_by_kernel[plan.kernel] += 1
    return W_out, metrics


def reset_counts() -> None:
    """Set ``client_epoch``'s launch counts to 0."""
    client_epoch.launches = 0
    client_epoch.launches_by_kernel = dict.fromkeys(KERNELS, 0)


reset_counts()
