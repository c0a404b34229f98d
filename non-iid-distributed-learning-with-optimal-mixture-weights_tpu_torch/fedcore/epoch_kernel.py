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
  library per row type (``cuda_build.BUILDS``). 2-byte rows run the
  staged kernel's redesign for them (``staged_ring_epoch_kernel``): a
  producer warp packs each step's rows and labels and issues their copies
  into a ring of up to ``STAGED_RING_MAX_STAGES`` stages a step or more
  ahead of 8 consumer warps, which read 8 columns a 16-byte load, sum the
  forward partials by a reduce-scatter, take the row losses 8 lanes a row
  and fold the next step's norms into the update; ``_narrow_cluster``
  picks its cluster by a fit to its measured times (``narrow_step_us``).

Two more plans take what the staged kernel cannot (``launch_plan``):
batches too large to stage run an unstaged kernel where W and the anchor
fit one CTA whole (one CTA per client, rows read from global memory in
both passes); every other shape of at most 32 classes runs the wide
kernel: a cluster of ``k`` CTAs per client (up to 16 where the card
schedules it, ``wide_max_cluster``; ``_wide_cluster`` picks ``k`` by how
long a longest-first schedule of the clients' steps would last over the
clusters the card runs at once, ``wide_active_clusters``, each step timed
by a fit to the kernel's measured times), whose producer warp streams
each step's rows through a ring of ``stages`` bulk-copy tiles of ``tile``
columns in shared memory for 8 consumer warps; W's tile is read once for
all of a warp's rows, W's and the anchor's slices stay in shared memory
where they fit (``w_res``), and a step's rows stay in the ring from pass
to pass where one chunk takes the batch (``rows_res``); the batch is
worked in chunks of at most ``WARPS * ring_rows`` rows with one exchange
each, so neither D nor B bounds it. Past 32 classes every shape runs the
class-tiled wide kernel (``"wide_tiled"``), C taken at run time: the
wide kernel's producer warp and ring, but its cluster splits the classes,
not D (``tiled_classes`` of them a CTA, over the whole rows), so the
cluster exchanges four floats a row (the CTA's maximum, first class at
it, sum of exponentials and label logit) and each CTA forms its own
classes' d loss / dz; W's ``(Ck, D)`` slice stays in shared memory where
it fits (``w_res``), the FMAs are register-blocked in both passes, and
``_tiled_cluster`` picks ``k`` by a fit to its measured times. Only a
chunk of 8 rows' logits of a CTA's classes past a block's shared memory
(some 57,000 classes at 8 CTAs) bounds it.

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
import heapq

import torch

from . import cuda_build

WARPS = 8                  # of a CTA (kThreads / 32 in client_epoch.cu)
MAX_CLUSTER = 8            # the portable cluster size
STAGED_CLUSTERS = (1, 2, 4, MAX_CLUSTER)
WIDE_CLUSTERS = STAGED_CLUSTERS + (16,)  # 16 where the card schedules it
HEADER_BYTES = 48          # mbarriers and per-stage counts (client_epoch.cu)
STAGED_RING_HEADER_BYTES = 112  # the 2-byte staged kernel's ring header
STAGED_RING_MAX_STAGES = 4      # its ring's stages, at most (2 at least)
WIDE_HEADER_BYTES = 16     # the wide kernel's step header (client_epoch.cu)
RING_TILE = 256            # the widest ring stage of both wide kernels
TILED_MAX_CHUNK = 32       # rows of one exchange of the class-tiled kernel
TILED_MAX_STAGES = 8       # its ring's stages, at most
TILED_HEADER_BYTES = 8 * (2 * 16 + 2) + 16  # mbarriers, step header
TILED_ZACC_MIN = 256 * 16  # floats of the forward's split partials
RING_MIN_STAGES = 3        # its ring's stages: at least, and at most
RING_MAX_STAGES = 16       # (kRingMaxStages in client_epoch.cu)
RING_HEADER_BYTES = 8 * (2 * RING_MAX_STAGES + 2) + 16  # mbarriers, metrics
# A step of the wide kernel on an NVIDIA H100 80GB HBM3 at 700 W
# (_wide_cluster): ~4.5 µs of fixed work (exchange, row losses, barriers)
# and ~12 ns for each column of a CTA's slice, fitted to its times forced
# at each cluster at Centralized's J = 1 (C = 10, B = 32, D = 10,000: 124.2,
# 65.3, 35.6, 18.7 and 11.6 µs a step at k = 1 to 16, chip_smoke.py's
# wide_d ms_by_cluster); unless the bytes that every CTA then running moves
# a step take longer at the rate such launches reached with every SM
# streaming W from global memory (WIDE_HBM_BYTES_PER_US: 2.35 and 2.09 TB/s
# at k = 2 and 4, J = 400, one client of 150 steps and 399 of 30,
# tools/client_epoch_phases.py).
WIDE_STEP_US = 4.5
WIDE_COLUMN_US = 0.012
WIDE_HBM_BYTES_PER_US = 2.2e6
# A step of the staged kernel of 2-byte rows (_narrow_cluster), fitted to
# its times forced at each cluster on an NVIDIA H100 80GB HBM3 at 700 W
# (tools/client_epoch_variants.py --shapes grid, bfloat16 rows, Centralized's
# one client of 1,501 steps at D = 784 to 8,704: within 5% at every k but
# one CTA, 8%): fixed work (the exchange's barrier, the row losses, the
# block barriers), a CTA of the cluster (the exchange reads), and a pass of
# the warps or threads over a CTA's slice (narrow_passes).
NARROW_STEP_US = 2.70
NARROW_CTA_US = 0.083
NARROW_PASS_US = 0.89
# A step of the class-tiled wide kernel (_tiled_cluster), fitted to its
# times forced at each cluster on an NVIDIA H100 80GB HBM3 at 700 W
# (tools/client_epoch_variants.py --clusters 1,2,4,8,16: the sector
# stand-in's C = 105 at J = 50 and at Centralized's J = 1, aloi's C =
# 1,000 at J = 50): a fixed cost a chunk (its exchange and row losses), a
# fixed cost a sweep of a tile's columns by a pass of blocks (its stage
# wait, its update's loads), the FMAs of a CTA's classes at one CTA's
# rate with W held in shared memory or read from global memory, and W's
# bytes that every CTA then running moves when it is not held.
TILED_CHUNK_US = 2.0
TILED_SWEEP_US = 2.0
TILED_FMA_PER_US = 1.2e5
TILED_FMA_STREAMED_PER_US = 7.0e4
TILED_W_BYTES_PER_US = 8.0e6
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


def staged_ring_smem_bytes(B: int, C: int, D: int, k: int,
                           stages: int) -> int:
    """Shared memory of one CTA of the staged kernel of 2-byte rows
    (``staged_ring_smem_bytes`` in ``client_epoch.cu``): its header of
    mbarriers and stage counts, the W and anchor slices, ``stages`` stages
    of ``(B, Dk)`` 2-byte rows, the double-buffered exchange, the logits,
    per-row scratch, the block sums and each stage's row weights, labels
    and ids."""
    Dk = slice_width(D, k, 2)
    Bp, CP = _round_up(B, 8), _round_up(instantiated_classes(C), 4)
    floats = (2 * C * Dk + 2 * (4 + Bp * CP) + Bp * CP + 2 * Bp
              + 2 * WARPS + 3 * stages * Bp)
    return STAGED_RING_HEADER_BYTES + 4 * floats + 2 * stages * Bp * Dk


def unstaged_smem_bytes(B: int, C: int, D: int) -> int:
    """Shared memory of the unstaged kernel's CTA: W and the anchor
    whole, the logits and per-row scratch."""
    return 4 * (2 * C * D + B * C + 3 * B + 2 * WARPS) + 4 * B


def wide_batch_floats(B: int, C: int) -> int:
    """Floats of one wide CTA's batch buffer: the packed rows' ids and
    weights and d loss / dz of each (``wide_batch_floats`` in
    ``client_epoch.cu``)."""
    return _round_up(B, 8) * (_round_up(instantiated_classes(C) or C, 4) + 2)


def wide_smem_bytes(B: int, C: int, chunk: int, hold: bool) -> int:
    """The part of the wide kernel's shared memory that
    ``ring_smem_bytes`` starts with (``wide_smem_bytes`` in
    ``client_epoch.cu``): the step header, the double-buffered exchange of
    a chunk's partial logits, the chunk's row losses and hits, the block
    sums, and the batch buffer when ``hold`` keeps it there."""
    CP = _round_up(instantiated_classes(C) or C, 4)
    floats = 2 * (4 + chunk * CP) + 2 * chunk + 2 * WARPS
    return (WIDE_HEADER_BYTES + 4 * floats
            + (4 * wide_batch_floats(B, C) if hold else 0))


def tiled_classes(C: int, k: int) -> int:
    """Classes one CTA of the class-tiled kernel's ``k``-cluster owns at
    most, over the whole rows: ``ceil(C / k)`` (CTA q owns classes
    ``[q C // k, (q + 1) C // k)``, at least one for ``k <= C``)."""
    return -(-C // k)


def tiled_batch_floats(B: int, C: int, k: int) -> int:
    """Floats of one class-tiled CTA's batch buffer: the packed rows' ids
    and weights, then the logits, then d loss / dz, of its classes (their
    count rounded up to 8)."""
    return _round_up(B, 8) * (_round_up(tiled_classes(C, k), 8) + 2)


def tiled_smem_bytes(B: int, C: int, D: int, k: int, chunk: int, tile: int,
                     stages: int, w_res: bool, hold: bool,
                     row_bytes: int = 4) -> int:
    """Shared memory of one CTA of the class-tiled wide kernel of a
    ``k``-cluster (``tiled_smem_bytes`` in ``client_epoch.cu``): its
    header; the pushed row stats of two exchanges (k ranks x chunk x 4
    floats) and sums of squares; the chunk's row state and the block
    sums; the forward pass's partials (at least ``TILED_ZACC_MIN`` floats,
    else a chunk of the CTA's logits); the batch buffer when ``hold``; W's
    ``(tiled_classes, D)`` slice (rows padded to 4 floats and 16 bytes
    more) when ``w_res``; and ``stages`` stages of ``chunk`` rows of
    ``tile`` elements of ``row_bytes`` and 16 bytes of padding."""
    CkP = _round_up(tiled_classes(C, k), 8)
    floats = (2 * k * chunk * 4 + 2 * k * 4 + 8 * chunk + 2 * WARPS
              + max(TILED_ZACC_MIN, chunk * CkP))
    return (TILED_HEADER_BYTES + 4 * floats
            + (4 * tiled_batch_floats(B, C, k) if hold else 0)
            + (4 * tiled_classes(C, k) * (_round_up(D, 4) + 4) if w_res
               else 0)
            + stages * chunk * (tile * row_bytes + 16))


def ring_rows(C: int) -> int:
    """Rows one consumer warp of the wide kernel carries through its
    forward pass at ``C`` classes (its partial logits stay in registers
    over the tiles): a chunk holds at most ``WARPS`` times as many."""
    nc = instantiated_classes(C)
    return 8 if nc <= 4 else (4 if nc <= 10 else (2 if nc <= 16 else 1))


def ring_smem_bytes(B: int, C: int, D: int, k: int, chunk: int, tile: int,
                    stages: int, w_res: bool, hold: bool,
                    row_bytes: int = 4) -> int:
    """Shared memory of one CTA of the wide kernel of a ``k``-cluster
    (``ring_smem_bytes`` in ``client_epoch.cu``): ``wide_smem_bytes``'
    layout rounded to 16 bytes, the ring's mbarriers, W's and the anchor's
    ``(C, slice_width)`` float32 slices where ``w_res`` holds them, and
    ``stages`` stages of ``(chunk, tile)`` row elements of ``row_bytes``."""
    Dk = slice_width(D, k, row_bytes)
    return (_round_up(wide_smem_bytes(B, C, chunk, hold), 16)
            + RING_HEADER_BYTES + (8 * C * Dk if w_res else 0)
            + stages * chunk * tile * row_bytes)


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """How one launch runs: ``kernel`` one of ``KERNELS``; ``cluster``
    CTAs per client (0 for the unstaged kernel, one CTA per client), each
    holding ``slice_width`` columns of D; ``classes`` is the instantiated
    class count (0 for the class-tiled kernel, which takes C at run time),
    ``smem_bytes`` one CTA's dynamic shared memory, ``ctas`` the grid.
    The wide kernels work the batch in chunks of ``chunk`` rows and keep
    their batch buffers in ``scratch_bytes`` of global memory (0: in
    shared memory). The wide kernel streams rows through a ring of
    ``stages`` stages of ``tile`` columns, holds W's and the anchor's
    slices in shared memory where ``w_res`` and a step's rows from its
    forward to its gradient pass where ``rows_res``."""

    cluster: int
    slice_width: int
    classes: int
    smem_bytes: int
    ctas: int
    kernel: str = "staged"
    chunk: int = 0
    scratch_bytes: int = 0
    tile: int = 0
    stages: int = 0
    w_res: bool = False
    rows_res: bool = False


def _one_wave(J: int, num_sms: int, sizes) -> int:
    """The largest of ``sizes`` whose ``J * k`` CTAs fit the SMs in one
    wave (more SMs per client shorten the critical chain)."""
    return max(k for k in sizes if k == 1 or J * k <= num_sms)


def _no_empty_slice(k: int, floor: int, D: int, row_bytes: int) -> int:
    """``k`` halved, down to ``floor``, while a slice would be empty."""
    while k > floor and (k - 1) * slice_width(D, k, row_bytes) >= D:
        k //= 2
    return k


def narrow_stages(B: int, C: int, D: int, k: int, smem_limit: int) -> int:
    """The ring depth of the staged kernel of 2-byte rows at a
    ``k``-cluster: as many stages as fit ``smem_limit``, at most
    ``STAGED_RING_MAX_STAGES``; 0 where two do not."""
    return max((n for n in range(2, STAGED_RING_MAX_STAGES + 1)
                if staged_ring_smem_bytes(B, C, D, k, n) <= smem_limit),
               default=0)


def narrow_grad_cols(Dk: int, nc: int) -> int:
    """Columns a thread of the 2-byte staged kernel's gradient pass takes
    over a slice of ``Dk`` at ``nc`` instantiated classes
    (``staged_grad_cols`` in ``client_epoch.cu``): of 4, 2 and 1 the one
    whose passes of the block's threads times its columns is least, the
    wider on a tie; 4 only at 16 classes or fewer."""
    cost = {g: -(-Dk // (g * WARPS * 32)) * g for g in (4, 2, 1)
            if g < 4 or nc <= 16}
    return min(cost, key=lambda g: (cost[g], -g))


def narrow_passes(B: int, C: int, D: int, k: int) -> float:
    """Passes over a CTA's slice in one step of B rows of the 2-byte staged
    kernel at a ``k``-cluster: the forward pass's warps (``ring_rows``
    rows a warp, 256 columns a pass) and the gradient pass's threads
    (``narrow_grad_cols`` columns each, B rows), in units of B = 32."""
    Dk = slice_width(D, k, 2)
    nc = instantiated_classes(C)
    fwd = -(-(-(-B // ring_rows(C))) // WARPS) * -(-Dk // 256)
    g = narrow_grad_cols(Dk, nc)
    return fwd + -(-Dk // (g * WARPS * 32)) * g * B / 32


def narrow_step_us(B: int, C: int, D: int, k: int) -> float:
    """The estimated µs of one step of B rows of the staged kernel of
    2-byte rows at a ``k``-cluster (see ``_narrow_cluster``)."""
    return (NARROW_STEP_US + NARROW_CTA_US * k
            + NARROW_PASS_US * narrow_passes(B, C, D, k))


@functools.lru_cache(maxsize=256)
def _narrow_cluster(steps, B, C, D, sizes, active):
    """The staged kernel's cluster for 2-byte rows among ``sizes`` (those
    whose ring of 2 stages fits, with no empty slice; ``active`` pairs of
    k and the clusters of k CTAs the card runs at once): the one of least
    estimated time, the larger on a tie. A launch lasts the steps of the
    busiest of the ``active[k]`` clusters running at once (a longest-first
    schedule of the clients' ``steps``) times ``narrow_step_us`` at B
    rows: ``NARROW_STEP_US`` of fixed work, ``NARROW_CTA_US`` a CTA of
    the cluster and ``NARROW_PASS_US`` a pass over a CTA's slice
    (``narrow_passes``). On an NVIDIA H100 80GB HBM3 at 700 W (132, 66,
    30 and 15 clusters of 1 to 8 CTAs at once) it picks 8 CTAs at the main
    path's J = 50, D = 2,000 with its steps and at Centralized's J = 1, 4
    at J = 400 on the mnist stand-in's split: over the grid of J = 1, 5,
    50, 400 by D = 784 to 8,704 each pick is the size measured fastest or
    within 0.6% of it (``tools/client_epoch_variants.py --shapes
    grid``)."""
    active = dict(active)

    def cost(k):
        return (_busiest_steps(steps, active[k])
                * narrow_step_us(B, C, D, k))

    return min(sizes, key=lambda k: (cost(k), -k))


def _narrow_plan(J, B, C, D, num_sms, smem_limit, cluster, active_clusters,
                 steps):
    """The staged plan of 2-byte rows: the ring kernel at the cluster of
    ``_narrow_cluster`` (forced: ``cluster``), ``narrow_stages`` deep."""
    sizes = [k for k in STAGED_CLUSTERS
             if narrow_stages(B, C, D, k, smem_limit)]
    if cluster is not None:
        if cluster not in sizes:
            raise ValueError(
                f"cluster {cluster} does not fit: the sizes that fit "
                f"C={C}, D={D}, B={B} are {sizes}")
        k = cluster
    else:
        if active_clusters is None:  # without the card's answer: the SMs
            active_clusters = {k: num_sms // k for k in WIDE_CLUSTERS}
        sizes = [k for k in sizes if active_clusters.get(k, 0) > 0
                 and (k == sizes[0] or (k - 1) * slice_width(D, k, 2) < D)]
        if not sizes:
            return None
        if J <= min(active_clusters[k] for k in sizes):
            steps = (1,) * J
        else:
            steps = steps() if callable(steps) else steps
            steps = (1,) * J if steps is None else tuple(steps)
        k = _narrow_cluster(steps, B, C, D, tuple(sizes),
                            tuple(sorted(active_clusters.items())))
    stages = narrow_stages(B, C, D, k, smem_limit)
    return EpochPlan(k, slice_width(D, k, 2), instantiated_classes(C),
                     staged_ring_smem_bytes(B, C, D, k, stages), J * k,
                     stages=stages)


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


@functools.lru_cache(maxsize=None)
def _tiled_layout(B, C, D, k, smem_limit, row_bytes):
    """``(chunk, tile, stages, w_res, hold)`` of the class-tiled kernel at
    a ``k``-cluster, or None where no chunk of 8 rows fits: the largest
    chunk (at most ``TILED_MAX_CHUNK``) that fits 2 stages of 8 columns;
    the batch buffer held where it then fits; W's slice held where it
    fits beside 2 stages of the widest tile (at most ``RING_TILE``
    columns, or the whole row), else the widest tile that fits 3 stages
    (2 where none does) with W read from global memory; then as many
    stages as fit, up to ``TILED_MAX_STAGES``. Wide tiles come first:
    a stage's row copies cost the same at 128 columns as at 256 (the
    sector stand-in's C = 105 at 8 CTAs took 0.749 ms with W held in 2
    stages of 256 columns, 1.117 ms in 5 stages of 128, and 1.016 with W
    streamed through 6 of 256; ``tools/client_epoch_variants.py``)."""
    def fits(chunk, tile, stages, w_res, hold):
        return tiled_smem_bytes(B, C, D, k, chunk, tile, stages, w_res,
                                hold, row_bytes) <= smem_limit

    widest = min(RING_TILE, _round_up(D, 8))
    tiles = [widest] + [t for t in (128, 64, 32, 16, 8) if t < widest]
    chunk = next((c for c in range(min(_round_up(B, 8), TILED_MAX_CHUNK), 0,
                                   -8) if fits(c, 8, 2, False, False)), None)
    if chunk is None:
        return None
    hold = fits(chunk, 8, 2, False, True)
    w_res, tile = fits(chunk, widest, 2, True, hold), widest
    if not w_res:
        tile = next((t for t in tiles if fits(chunk, t, 3, False, hold)),
                    None) or next(t for t in tiles
                                  if fits(chunk, t, 2, False, hold))
    stages = max(n for n in range(2, TILED_MAX_STAGES + 1)
                 if fits(chunk, tile, n, w_res, hold))
    return chunk, tile, stages, w_res, hold


def tiled_passes(C: int, k: int, chunk: int, tile: int) -> tuple[int, int]:
    """Passes of the class-tiled kernel's thread blocks over one tile:
    ``(forward, gradient)``. The forward pass's blocks of 4 rows x 4
    classes of a chunk, and the gradient pass's of 8 classes x 4 columns
    (its lanes splitting the rows in up to 8 groups while blocks are
    fewer than the 256 consumer threads), walked 256 at a time."""
    CkP = _round_up(tiled_classes(C, k), 8)
    fblocks, gblocks = (chunk // 4) * (CkP // 4), (CkP // 8) * (tile // 4)
    rs = 1
    while rs < 8 and gblocks * rs * 2 <= 256:
        rs *= 2
    return -(-fblocks // 256), -(-(gblocks * rs) // 256)


def tiled_step_us(n: int, C: int, D: int, k: int, chunk: int, tile: int,
                  w_res: bool, ctas: int) -> float:
    """The estimated µs of one step of ``n`` rows of the class-tiled
    kernel, each CTA of a ``k``-cluster running ``ctas`` at once (see
    ``_tiled_cluster``)."""
    CkP = _round_up(tiled_classes(C, k), 8)
    fpasses, gpasses = tiled_passes(C, k, chunk, tile)
    t = (TILED_CHUNK_US * -(-n // chunk)
         + TILED_SWEEP_US * -(-D // tile) * (fpasses + gpasses)
         + 2 * n * CkP * D / (TILED_FMA_PER_US if w_res
                              else TILED_FMA_STREAMED_PER_US))
    if not w_res:  # W's slice read in both passes and written a step
        t += ctas * 12 * tiled_classes(C, k) * D / TILED_W_BYTES_PER_US
    return t


@functools.lru_cache(maxsize=256)
def _tiled_cluster(steps, B, C, D, row_bytes, layouts, active):
    """The class-tiled kernel's cluster among the sizes of ``layouts``
    (pairs of k and its ``_tiled_layout``; ``active`` pairs of k and the
    clusters of k CTAs the card runs at once): the one of least estimated
    time, the larger on a tie. A launch lasts the steps of the busiest of
    the ``active[k]`` clusters running at once (a longest-first schedule
    of the clients' ``steps``) times ``tiled_step_us`` at B rows:
    ``TILED_CHUNK_US`` a chunk, ``TILED_SWEEP_US`` a tile's pass of blocks
    (``tiled_passes``), the FMAs of both passes over the CTA's classes at
    ``TILED_FMA_PER_US`` with W held or ``TILED_FMA_STREAMED_PER_US``
    without, and then W's bytes that every CTA running moves at
    ``TILED_W_BYTES_PER_US``. On an NVIDIA H100 80GB HBM3 at 700 W (132,
    66, 30, 15 and 7 clusters of 1 to 16 CTAs at once) it picks 8 CTAs
    at the sector stand-in's C = 105, J = 50 with its steps, 16 at
    Centralized's J = 1, and 4 at aloi's C = 1,000, J = 50, 20 steps a
    client: each the size measured fastest there
    (``tools/client_epoch_variants.py``)."""
    layouts, active = dict(layouts), dict(active)

    def cost(k):
        chunk, tile, _, w_res, _ = layouts[k]
        ctas = k * min(len(steps), active[k])
        return _busiest_steps(steps, active[k]) * tiled_step_us(
            B, C, D, k, chunk, tile, w_res, ctas)

    return min(layouts, key=lambda k: (cost(k), -k))


def _tiled_plan(J, B, C, D, num_sms, smem_limit, cluster, row_bytes,
                max_cluster, active_clusters, steps):
    # the sizes that leave no CTA without a class
    sizes = [k for k in WIDE_CLUSTERS if k <= max_cluster and k <= C]
    if cluster is not None:
        layout = (_tiled_layout(B, C, D, cluster, smem_limit, row_bytes)
                  if cluster in sizes else None)
        if layout is None:
            raise ValueError(
                f"cluster {cluster} does not fit the wide kernel: it takes "
                f"{sizes} and needs {tiled_smem_bytes(B, C, D, cluster, 8, 8, 3, False, False, row_bytes)} "
                f"bytes of shared memory at least, of {smem_limit}")
        k = cluster
    else:
        if active_clusters is None:  # without the card's answer: the SMs
            active_clusters = {k: num_sms // k for k in WIDE_CLUSTERS}
        layouts = {k: _tiled_layout(B, C, D, k, smem_limit, row_bytes)
                   for k in sizes if active_clusters.get(k, 0) > 0}
        layouts = {k: lay for k, lay in layouts.items() if lay}
        if not layouts:
            return None
        if J <= min(active_clusters[k] for k in layouts):
            steps = (1,) * J
        else:
            steps = steps() if callable(steps) else steps
            steps = (1,) * J if steps is None else tuple(steps)
        k = _tiled_cluster(steps, B, C, D, row_bytes, tuple(layouts.items()),
                           tuple(sorted(active_clusters.items())))
        layout = layouts[k]
    chunk, tile, stages, w_res, hold = layout
    return EpochPlan(
        k, D, 0, tiled_smem_bytes(B, C, D, k, chunk, tile, stages, w_res,
                                  hold, row_bytes), J * k, "wide_tiled",
        chunk, 0 if hold else 4 * J * k * tiled_batch_floats(B, C, k), tile,
        stages, w_res)


def _ring_tiles(Dk: int, widest: int) -> int:
    """Columns of a ring stage: the slice in as few tiles of at most
    ``widest`` columns as it takes, of equal width rounded up to 8."""
    return _round_up(-(-Dk // -(-Dk // widest)), 8)


@functools.lru_cache(maxsize=None)
def _ring_layout(B, C, D, k, smem_limit, row_bytes):
    """``(chunk, tile, stages, w_res, rows_res, hold)`` of the wide kernel
    at a ``k``-cluster, or None where no chunk of 8 rows fits: the largest
    chunk (at most ``WARPS * ring_rows``), then the widest tile, that fit
    ``RING_MIN_STAGES`` stages; the batch buffer held, then W's and the
    anchor's slices, where they still fit; the step's rows held from pass
    to pass where one chunk takes the batch and a multiple of the slice's
    tiles (at least ``RING_MIN_STAGES``) fits; else as many stages as fit,
    up to ``RING_MAX_STAGES``."""
    Dk = slice_width(D, k, row_bytes)
    widest = min(RING_TILE, _round_up(Dk, 8))

    def fits(chunk, tile, stages, w_res, hold):
        return ring_smem_bytes(B, C, D, k, chunk, tile, stages, w_res, hold,
                               row_bytes) <= smem_limit

    found = next(((chunk, _ring_tiles(Dk, w))
                  for chunk in range(min(_round_up(B, 8),
                                         WARPS * ring_rows(C)), 0, -8)
                  for w in (widest, widest // 2, widest // 4, widest // 8,
                            widest // 16, widest // 32) if w >= 8
                  and fits(chunk, _ring_tiles(Dk, w), RING_MIN_STAGES,
                           False, False)), None)
    if found is None:
        return None
    chunk, tile = found
    hold = fits(chunk, tile, RING_MIN_STAGES, False, True)
    w_res = fits(chunk, tile, RING_MIN_STAGES, True, hold)
    ntiles = -(-Dk // tile)
    if B <= chunk:
        for m in range(RING_MAX_STAGES // ntiles, 0, -1):
            if (m * ntiles >= RING_MIN_STAGES
                    and fits(chunk, tile, m * ntiles, w_res, hold)):
                return chunk, tile, m * ntiles, w_res, True, hold
    stages = max(n for n in range(RING_MIN_STAGES, RING_MAX_STAGES + 1)
                 if fits(chunk, tile, n, w_res, hold))
    return chunk, tile, stages, w_res, False, hold


def wide_step_bytes(n: int, C: int, D: int, k: int, w_res: bool,
                    rows_res: bool, row_bytes: int = 4) -> dict[str, int]:
    """Bytes one CTA of the wide kernel of a ``k``-cluster moves in a step
    of ``n`` rows, by its layout's arithmetic: ``rows``, the rows' slices
    copied from global memory into the ring (twice unless ``rows_res``
    holds them from pass to pass); ``w_and_anchor``, W's slice read in the
    forward pass, and W and the anchor read and W written in the update,
    unless ``w_res`` holds them in shared memory; ``exchange``, the
    partial logits read from the k CTAs' shared memory."""
    Dk = min(slice_width(D, k, row_bytes), D)
    CP = _round_up(instantiated_classes(C), 4)
    return {"rows": n * Dk * row_bytes * (1 if rows_res else 2),
            "w_and_anchor": 0 if w_res else 16 * C * Dk,
            "exchange": 4 * k * n * CP}


@functools.lru_cache(maxsize=256)
def _busiest_steps(steps: tuple, slots: int) -> int:
    """Steps of the busiest of ``slots`` clusters running at once when the
    clients of ``steps``, largest first (``client_order``), each go to the
    first that is free."""
    loads = [0] * max(1, min(slots, len(steps)))
    for s in sorted(steps, reverse=True):
        heapq.heapreplace(loads, loads[0] + s)
    return max(loads)


@functools.lru_cache(maxsize=256)
def _wide_cluster(steps, B, C, D, row_bytes, layouts, active):
    """The wide kernel's cluster among the sizes of ``layouts`` (pairs of
    k and its ``_ring_layout``; ``active`` pairs of k and ``active[k]``,
    both tuples, so that a choice once made is looked up): the one of
    least estimated time, the larger on a tie. A launch lasts the steps
    of the busiest of the ``active[k]`` clusters the card runs at once,
    given the clients' ``steps`` in longest-first order; a step lasts ``WIDE_STEP_US`` plus
    ``WIDE_COLUMN_US`` for each column of a slice, or, if longer, the
    bytes the CTAs then running move from global memory
    (``wide_step_bytes`` at B rows) at ``WIDE_HBM_BYTES_PER_US``. On an
    NVIDIA H100 80GB HBM3 at 700 W (132, 66, 30, 15 and 7 clusters of 1
    to 16 CTAs at once) it picks 16 CTAs at wide_d's J = 50, D = 10,000
    and at Centralized's J = 1 (``chip_smoke.py``'s ``wide_d``
    ``ms_by_cluster``), 8 at J = 400, on the mnist stand-in's split
    (``tools/wide_epoch_paths.py``) and on one client of 150 steps and
    399 of 30 (``tools/client_epoch_phases.py``): each the size measured
    fastest there."""
    layouts, active = dict(layouts), dict(active)

    def cost(k):
        _, _, _, w_res, rows_res, _ = layouts[k]
        moved = wide_step_bytes(B, C, D, k, w_res, rows_res, row_bytes)
        ctas = k * min(len(steps), active[k])
        step_us = max(
            WIDE_STEP_US + WIDE_COLUMN_US * min(slice_width(D, k, row_bytes),
                                                D),
            ctas * (moved["rows"] + moved["w_and_anchor"])
            / WIDE_HBM_BYTES_PER_US)
        return _busiest_steps(steps, active[k]) * step_us

    return min(layouts, key=lambda k: (cost(k), -k))


def _wide_plan(J, B, C, D, smem_limit, cluster, row_bytes, max_cluster,
               active_clusters, steps):
    sizes = [k for k in WIDE_CLUSTERS if k <= max_cluster]
    if cluster is not None:
        layout = (_ring_layout(B, C, D, cluster, smem_limit, row_bytes)
                  if cluster in sizes else None)
        if layout is None:
            raise ValueError(
                f"cluster {cluster} does not fit the wide kernel: it takes "
                f"{sizes} and needs {ring_smem_bytes(B, C, D, cluster, 8, 8, RING_MIN_STAGES, False, False, row_bytes)} "
                f"bytes of shared memory at least, of {smem_limit}")
        k = cluster
    else:
        if active_clusters is None:
            raise ValueError("the wide kernel's cluster needs the clusters "
                             "the card runs at once (wide_active_clusters)")
        # the sizes the card runs, with no empty slice, whose layout fits
        layouts = {k: _ring_layout(B, C, D, k, smem_limit, row_bytes)
                   for k in sizes if active_clusters[k] > 0
                   and (k - 1) * slice_width(D, k, row_bytes) < D}
        layouts = {k: lay for k, lay in layouts.items() if lay}
        if not layouts:
            return None
        if J <= min(active_clusters[k] for k in layouts):
            # every client has a cluster of its own at every size: the
            # longest client's steps bound each size alike
            steps = (1,) * J
        else:
            steps = steps() if callable(steps) else steps
            steps = (1,) * J if steps is None else tuple(steps)
        k = _wide_cluster(steps, B, C, D, row_bytes, tuple(layouts.items()),
                          tuple(sorted(active_clusters.items())))
        layout = layouts[k]
    chunk, tile, stages, w_res, rows_res, hold = layout
    return EpochPlan(
        k, slice_width(D, k, row_bytes), instantiated_classes(C),
        ring_smem_bytes(B, C, D, k, chunk, tile, stages, w_res, hold,
                        row_bytes), J * k, "wide", chunk,
        0 if hold else 4 * J * k * wide_batch_floats(B, C), tile, stages,
        w_res, rows_res)


def launch_plan(J: int, B: int, C: int, D: int, num_sms: int,
                smem_limit: int = cuda_build.SMEM_LIMIT,
                cluster: int | None = None,
                row_bytes: int = 4, kernel: str | None = None,
                max_cluster: int = MAX_CLUSTER,
                active_clusters=None, steps=None) -> EpochPlan | None:
    """The launch shape for ``J`` clients of batch ``B``, ``C`` classes
    and ``D`` features of ``row_bytes`` each (4, or 2 for bfloat16 and
    float16 rows) on a card of ``num_sms`` SMs, in this order:

    - the staged kernel where a cluster of 1, 2, 4 or 8 CTAs fits two
      step tiles in ``smem_limit``: ``k`` is the larger of the smallest
      that fits and the largest whose ``J * k`` CTAs still fit the SMs in
      one wave, halved while a slice would be empty; for 2-byte rows its
      ring (``_narrow_plan``) where 2 stages fit, ``k`` by
      ``_narrow_cluster`` from ``active_clusters`` and ``steps`` (as the
      wide kernel's: None, the SMs over k), ``narrow_stages`` deep;
    - else the unstaged kernel where W and the anchor fit whole;
    - else the wide kernel: ``k`` among clusters of up to ``max_cluster``
      (8, or 16 where the card schedules it) by ``_wide_cluster``, from
      ``active_clusters`` (k to the clusters of k CTAs the card runs at
      once, ``wide_active_clusters``) and ``steps`` (each client's count
      of non-empty steps, or a function returning them, called only where
      some size runs fewer clusters at once than J; None: J clients of
      equal steps); its ring layout by ``_ring_layout``;
    - past ``MAX_CLASSES`` classes, at every B and D, the class-tiled wide
      kernel (``"wide_tiled"``): ``k`` among the sizes that leave no CTA
      without a class by ``_tiled_cluster`` (``active_clusters`` None: the
      SMs over k), its layout by ``_tiled_layout``; each CTA holds the whole
      rows (``slice_width`` D) and ``tiled_classes`` classes.

    None only for a ``smem_limit`` too small for a chunk of 8 rows (past
    about 57,000 classes at 8 CTAs, 113,000 at 16, at the card's limit).
    ``kernel`` forces one of
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
        return _tiled_plan(J, B, C, D, num_sms, smem_limit, cluster,
                           row_bytes, max_cluster, active_clusters, steps)
    if kernel in (None, "staged"):
        plan = (_narrow_plan(J, B, C, D, num_sms, smem_limit, cluster,
                             active_clusters, steps) if row_bytes == 2
                else _staged_plan(J, B, C, D, num_sms, smem_limit, cluster,
                                  row_bytes))
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
    return _wide_plan(J, B, C, D, smem_limit, cluster, row_bytes, max_cluster,
                      active_clusters, steps)


def kernel_symbol(plan: EpochPlan, C: int) -> str:
    """The part of the mangled name that picks out the instantiation
    ``plan`` runs for ``C`` classes in the compiler's report
    (``cuda_build.ptxas_usage``)."""
    if plan.kernel == "unstaged":
        name, args = "unstaged_epoch_kernel", f"ILi{plan.classes}E"
    elif plan.kernel == "staged" and plan.stages:  # 2-byte rows: the ring
        name = "staged_ring_epoch_kernel"
        args = f"ILi{plan.classes}ELb{int(C in EXACT_CLASSES)}E"
    elif plan.kernel == "wide_tiled":
        # the source of W: shared memory, W_out in float4s, or in floats
        src = 0 if plan.w_res else (1 if plan.slice_width % 4 == 0 else 2)
        name, args = "wide_tiled_epoch_kernel", f"ILi{src}EE"
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
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_launch_unstaged.restype = ctypes.c_int
    lib.client_epoch_launch_unstaged.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_launch_wide.restype = ctypes.c_int
    lib.client_epoch_launch_wide.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_staged_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_staged_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.client_epoch_staged_ring_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_staged_ring_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.client_epoch_unstaged_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_unstaged_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.client_epoch_instantiated_classes.restype = ctypes.c_int
    lib.client_epoch_instantiated_classes.argtypes = [ctypes.c_int]
    lib.client_epoch_row_bytes.restype = ctypes.c_int
    lib.client_epoch_row_bytes.argtypes = []
    lib.client_epoch_slice_width.restype = ctypes.c_int
    lib.client_epoch_slice_width.argtypes = [ctypes.c_int] * 2
    lib.client_epoch_tiled_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_tiled_smem_bytes.argtypes = [ctypes.c_int] * 9
    lib.client_epoch_tiled_batch_floats.restype = ctypes.c_size_t
    lib.client_epoch_tiled_batch_floats.argtypes = [ctypes.c_int] * 3
    lib.client_epoch_ring_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_ring_smem_bytes.argtypes = [ctypes.c_int] * 9
    lib.client_epoch_wide_batch_floats.restype = ctypes.c_size_t
    lib.client_epoch_wide_batch_floats.argtypes = [ctypes.c_int] * 2
    lib.client_epoch_wide_max_cluster.restype = ctypes.c_int
    lib.client_epoch_wide_max_cluster.argtypes = []
    lib.client_epoch_wide_active_clusters.restype = ctypes.c_int
    lib.client_epoch_wide_active_clusters.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def wide_max_cluster(device_index: int, name: str = "client_epoch") -> int:
    """The largest cluster the wide kernel launches on card
    ``device_index``: 16 where the card schedules a 16-CTA cluster of its
    largest CTA, else 8 (``client_epoch_wide_max_cluster`` of library
    ``name``)."""
    with torch.cuda.device(device_index):
        return _library(name).client_epoch_wide_max_cluster()


@functools.lru_cache(maxsize=None)
def wide_active_clusters(device_index: int,
                         name: str = "client_epoch") -> dict[int, int]:
    """How many clusters of each of ``WIDE_CLUSTERS`` CTAs of the wide
    kernel card ``device_index`` runs at once, each CTA a full block of
    shared memory (``client_epoch_wide_active_clusters``: the card's
    ``cudaOccupancyMaxActiveClusters``; a cluster sits in one GPC)."""
    with torch.cuda.device(device_index):
        lib = _library(name)
        return {k: lib.client_epoch_wide_active_clusters(k)
                for k in WIDE_CLUSTERS}


@functools.lru_cache(maxsize=256)
def _check_plan(name: str, plan: EpochPlan, B: int, C: int, D: int,
                row_bytes: int) -> None:
    """The plan's layout must be the kernel's in library ``name``: same
    row type, shared memory, instantiation, slice and, wide, scratch
    (the class-tiled kernel's CTAs read whole rows: its slice is D)."""
    lib = _library(name)
    scratch = 0
    tiled = int(plan.kernel == "wide_tiled")
    if plan.kernel == "staged" and plan.stages:
        smem = lib.client_epoch_staged_ring_smem_bytes(
            B, C, D, plan.cluster, plan.stages)
    elif plan.kernel == "staged":
        smem = lib.client_epoch_staged_smem_bytes(B, C, D, plan.cluster)
    elif plan.kernel in ("wide", "wide_tiled"):
        hold = plan.scratch_bytes == 0
        if tiled:
            smem = lib.client_epoch_tiled_smem_bytes(
                B, C, D, plan.cluster, plan.chunk, plan.tile, plan.stages,
                int(plan.w_res), int(hold))
        else:
            smem = lib.client_epoch_ring_smem_bytes(
                B, C, D, plan.cluster, plan.chunk, plan.tile, plan.stages,
                int(plan.w_res), int(hold))
        if not hold:
            scratch = 4 * plan.ctas * (
                lib.client_epoch_tiled_batch_floats(B, C, plan.cluster)
                if tiled else lib.client_epoch_wide_batch_floats(B, C))
    else:
        smem = lib.client_epoch_unstaged_smem_bytes(B, C, D)
    if plan.kernel in ("unstaged", "wide_tiled"):  # whole rows
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


def card_plan(W, X, rows, valid, cluster=None, kernel=None, ordered=None):
    """The plan ``client_epoch`` takes for these CUDA tensors: the card's
    SMs, its largest cluster and the clusters it runs at once, and, where
    a cluster rule reads them, each client's steps (one host read of
    ``client_order(valid)``, appended to ``ordered`` when given)."""
    J, C, D = W.shape
    B = rows.shape[2]
    name = ROW_LIBRARIES[X.dtype]
    dev = W.device.index
    sms = torch.cuda.get_device_properties(W.device).multi_processor_count

    def steps():
        # one host read, made only where there are more clients than some
        # cluster size runs at once
        got = client_order(valid)
        if ordered is not None:
            ordered.append(got)
        return got[1].tolist()

    return launch_plan(
        J, B, C, D, sms, cluster=cluster, row_bytes=X.element_size(),
        kernel=kernel, max_cluster=wide_max_cluster(dev, name),
        active_clusters=wide_active_clusters(dev, name), steps=steps)


def client_epoch(W, anchor, X, y, rows, valid, lr, mu, lam, task,
                 cluster=None, kernel=None):
    """One local epoch of all J clients; same contract as
    ``client_epoch_plain``. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/client_epoch.cu`` as ``launch_plan`` says, or
    raise where no plan takes the shape (a chunk of 8 rows' logits of a
    CTA's classes past a block's shared memory: some 57,000 classes at 8
    CTAs).
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
    name = ROW_LIBRARIES[X.dtype]
    dev = W.device.index
    W_out = torch.empty_like(W)
    metrics = torch.zeros((J, 3), dtype=torch.float32, device=W.device)
    ordered = []
    plan = card_plan(W, X, rows, valid, cluster, kernel, ordered)
    if plan is None:
        raise ValueError(
            f"no client_epoch kernel takes C={C}: a chunk of 8 rows' "
            f"logits of a CTA's {tiled_classes(C, wide_max_cluster(dev, name))} "
            f"classes needs more than the {cuda_build.SMEM_LIMIT} bytes of "
            "shared memory of a block: run it with kernel_impl='plain'")
    lib = _library(name)
    _check_plan(name, plan, B, C, D, row_bytes)
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
        order, nsteps = ordered[0] if ordered else client_order(valid)
        ptrs = (W.data_ptr(), anchor.data_ptr(), X.data_ptr(), y.data_ptr(),
                rows.data_ptr(), valid.data_ptr(), order.data_ptr(),
                nsteps.data_ptr(), W_out.data_ptr(), metrics.data_ptr())
        bulk = int((D * row_bytes) % 16 == 0 and X.data_ptr() % 16 == 0)
        if plan.kernel == "staged":
            err = lib.client_epoch_launch_staged(
                *ptrs, J, S, B, C, D, plan.cluster, plan.stages, is_cls,
                bulk, *scalars)
        else:
            scratch = (torch.empty(plan.scratch_bytes // 4,
                                   dtype=torch.float32, device=W.device)
                       if plan.scratch_bytes else None)
            err = lib.client_epoch_launch_wide(
                *ptrs, None if scratch is None else scratch.data_ptr(), J, S,
                B, C, D, plan.cluster, plan.chunk, plan.tile, plan.stages,
                int(plan.w_res), int(plan.rows_res), bulk,
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
