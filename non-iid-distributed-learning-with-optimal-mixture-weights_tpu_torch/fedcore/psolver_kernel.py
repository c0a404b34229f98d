"""Kernel 2: one shuffled epoch of FedAMW's mixture-weight (p) SGD.

Replaces the JAX package's Pallas TPU kernel
``fedcore/pallas_psolver.py:_p_epoch_kernel`` (built by
``make_pallas_p_epoch``, wrapped by ``aggregate.py:_make_pallas_solve``).
The hand-written CUDA kernels are in ``csrc/p_epoch.cu``, one launch per
p-epoch; each step gathers its ``(B, J, C)`` block of the pooled
validation logits through ``positions``.

What bounds it on an H100 is not bytes — one read of the ``(n_val, J,
C)`` logits per epoch, which sit in L2, against 4 flops per element — but
the latency of S serial steps, each needing the ``p`` of the step before.
The staged kernel cuts one step's latency: one CTA, one warp per batch
row (at most 16 warps); each warp copies its rows of the next step into
a two-stage shared-memory ring (``cp.async.bulk`` per row when rows are
16-byte aligned, element-wise ``cp.async`` otherwise) with the row ids
loaded two steps ahead, so no global load is on a step's critical path;
the logits, loss and ``h[b, j] = sum_c L[b, j, c] d[b, c]`` of a row are
warp-local, and two block barriers per step frame the ``p`` update.

Where two stages of rows plus ``h`` exceed one block's shared memory, the
split kernel runs the same step with J split over a thread-block cluster
of ``k`` CTAs (2 to 16): each CTA owns a slice of ``p``, ``buf``, ``cv``
and of every row. A producer warp streams each step's row slices through
a ring of ``cp.async.bulk`` tiles (``split_layout``: whole slices held
from the z pass to the h pass where they fit, ``stream=False``; else
narrower tiles copied once a pass, ``stream=True``) and the step's
labels and valid flags through shared memory; each consumer warp (one a
batch row) pushes its row's partial logits into every CTA with
``st.async`` and sums the k ranks' in rank order from its own shared
memory, so no cluster barrier is left inside the epoch. The cluster is
fitted to the card's readings (``_split_cluster``); ``_split_reach``
keeps the shapes the split kernel takes.

More than 32 classes at ``B <= 512`` run the class-tiled split kernel
(``"split_tiled"``, any C at run time): the classes over a cluster of
``k`` CTAs (1 to 16; CTA q owns ``[qC/k, (q+1)C/k)``), reading the
logits in the class-split layout (``class_split``: ``(k, n_val, J, W)``,
each CTA's slices padded to ``W = tiled_width(C, k)``, made once a
p-solve by ``make_p_solver``), a producer warp's ring of groups of rows
(``tiled_layout``), z of its classes local, the loss's row statistics
and then ``g`` (J floats) summed over the cluster by push exchanges, and
p, buf and the guard replicated on every CTA. Its cluster is fitted to
the card's readings (``_split_tiled_cluster``). Shapes the staged and
split kernels do not take and ``B > 512`` run the unstaged kernel, the
port's first design (one CTA of 256 threads, five barriers per step),
where the step's ``(B, J, C)`` block fits one CTA; at ``C <= 32`` and
``B <= 512`` the class-tiled kernel takes what is left. ``launch_plan``
picks the kernel by shape alone; ``B > 512`` past the unstaged kernel,
or a class slice too wide for two stages of one row, is left without
one.

Every kernel applies the p-guards of ``aggregate.make_guard`` (``clip:R``
and the projection onto the simplex over the valid clients, by
Michelot's fixed point started from the last step's threshold) as an
epilogue of its p update, selected at launch: one warp projects the
whole of p with shuffle sums and no barrier inside the fixed point
(``warp_guard`` in ``p_epoch.cu``; ``aggregate.simplex_fixed_point`` is
its plain mirror); the split kernel first gathers p from its cluster in
one push exchange (clip pushes its warps' sums of squares instead), in
room its guarded layouts reserve (``split_guard_floats``). The staged,
split and class-tiled kernels each have a guarded and an unguarded
instantiation.

``p_epoch`` is the wrapper: CPU tensors go to ``p_epoch_plain``, the
plain PyTorch version; CUDA tensors launch the kernel the plan names or
raise (a shape no plan takes, or a guard that is not one of
``make_guard``'s). ``p_epoch.launches`` counts kernel launches,
``p_epoch.launches_by_kernel`` the same by kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build
from .epoch_kernel import CLASS_BOUNDS, EXACT_CLASSES

MAX_WARPS = 16             # of the staged kernel's CTA (kMaxWarps in p_epoch.cu)
MAX_STAGED_BATCH = 32 * MAX_WARPS  # a lane of its warp per row
UNSTAGED_WARPS = 8         # kThreads / 32 of the unstaged kernel
SPLIT_CLUSTERS = (2, 4, 8, 16)  # 16 is non-portable: where the card allows
SPLIT_MAX_STAGES = 8       # the split kernel's ring (kSplitMaxStages)
TILED_CLUSTERS = (1, 2, 4, 8, 16)  # the class-tiled split kernel's (k <= C)
TILED_WARPS = 16           # its consumer warps (kTiledWarps; one producer)
TILED_MAX_ROWS = 16        # rows of its groups (kTiledMaxRows)
TILED_MAX_STAGES = 4       # kTiledMaxStages
TILED_G_CHUNK = 256        # clients of g an exchange carries (kTiledGChunk)
KERNELS = ("staged", "split", "unstaged", "split_tiled")
# the kernels' guard argument (kGuard* in p_epoch.cu)
GUARD_CODES = {"clip": 1, "simplex": 2}


def p_epoch_plain(p, buf, cv, logits, y_val, positions, valid, lr, momentum,
                  task, guard=None):
    """The epoch in plain PyTorch.

    ``p, buf, cv (J,)`` mixture weights, momentum buffer and client
    validity; ``logits (n_val, J, C)``; ``y_val (n_val,)`` int32 labels
    or float32 targets; ``positions, valid (S, B)``. Each step:
    ``z = einsum('bjc,j->bc')``, masked-mean CE/MSE, ``g = einsum(
    'bjc,bc->j') * cv``, ``buf = m*buf + g``, ``p -= lr*buf`` (optax /
    torch SGD momentum; no count guard), then ``p = guard(p, cv)`` when a
    ``guard`` is given (projected SGD: the momentum is left as it is).
    Returns ``(p, buf, metrics (3,))`` with ``(sum loss*cnt, sum correct,
    sum cnt)``.

    The epoch's gathered logits ``(S, B, J, C)`` are built in one index op
    when they fit ``route.EPOCH_GATHER_BYTES_LIMIT``, else per step.
    """
    from .route import EPOCH_GATHER_BYTES_LIMIT

    S, B = positions.shape
    _, J, C = logits.shape
    cls = task == "classification"
    positions = positions.long()
    whole = S * B * J * C * logits.element_size() <= EPOCH_GATHER_BYTES_LIMIT
    ls = logits[positions] if whole else None
    ys = y_val[positions]
    lr, momentum = (torch.tensor(v, dtype=torch.float32, device=p.device)
                    for v in (lr, momentum))
    steps = []
    for s in range(S):
        lb = ls[s] if whole else logits[positions[s]]      # (B, J, C)
        yb, bv = ys[s], valid[s]
        cnt = bv.sum()
        inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
        z = torch.einsum("bjc,j->bc", lb, p)
        scale = (bv * inv_cnt)[:, None]
        if cls:
            zmax = z.max(-1, keepdim=True).values
            ez = torch.exp(z - zmax)
            Z = ez.sum(-1, keepdim=True)
            onehot = torch.nn.functional.one_hot(yb.long(), C).float()
            per = (torch.log(Z) + zmax)[:, 0] - (z * onehot).sum(-1)
            d = (ez / Z - onehot) * scale
            correct = ((torch.argmax(z, -1) == yb).float() * bv).sum()
        else:
            err = z - yb[:, None]
            per = torch.square(err).sum(-1) / C
            d = err * (2.0 / C) * scale
            correct = torch.zeros_like(cnt)
        loss = (per * bv).sum() * inv_cnt
        g = torch.einsum("bjc,bc->j", lb, d) * cv
        buf = momentum * buf + g
        p = p - lr * buf
        if guard is not None:
            p = guard(p, cv)
        steps.append(torch.stack([loss * cnt, correct, cnt]))
    return p, buf, torch.stack(steps).sum(0)


def _check(p, buf, cv, logits, y_val, positions, valid, task):
    n_val, J, C = logits.shape
    expect = {
        "buf": (buf, torch.float32, (J,)),
        "cv": (cv, torch.float32, (J,)),
        "logits": (logits, torch.float32, (n_val, J, C)),
        "y_val": (y_val, torch.int32 if task == "classification"
                  else torch.float32, (n_val,)),
        "positions": (positions, torch.int32, tuple(positions.shape)),
        "valid": (valid, torch.float32, tuple(positions.shape)),
    }
    if (p.dtype != torch.float32 or tuple(p.shape) != (J,)
            or not p.is_contiguous()):
        raise ValueError(f"p must be a contiguous float32 ({J},) tensor, "
                         f"got {p.dtype} {tuple(p.shape)}")
    if positions.dim() != 2:
        raise ValueError(f"positions must be (S, B), got "
                         f"{tuple(positions.shape)}")
    for name, (t, dtype, shape) in expect.items():
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def staged_classes(C: int) -> int:
    """The class count of the staged kernel's instantiation that runs
    ``C`` classes (``C`` itself for ``EXACT_CLASSES``, else the next of
    ``CLASS_BOUNDS``); 0 when none does (``C > 32``)."""
    if C in EXACT_CLASSES:
        return C
    return next((nc for nc in CLASS_BOUNDS if C <= nc), 0)


def staged_warps(B: int) -> int:
    """Warps of the staged and split kernels' CTA: one per row, at most
    16."""
    return min(B, MAX_WARPS)


def staged_smem_bytes(B: int, J: int, C: int) -> int:
    """Shared memory of the staged kernel (``staged_smem_bytes`` in
    ``p_epoch.cu``): two mbarriers per warp, two stages of ``B`` rows of
    ``J*C`` floats each padded to 4, ``h (B, J)``, ``p``, ``buf``, ``cv``
    and the per-warp sums (metrics and guard, 4 a warp)."""
    nw, jcp = staged_warps(B), -(-J * C // 4) * 4
    return 16 * nw + 4 * (2 * B * jcp + B * J + 3 * J + 4 * nw)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def split_slice(J: int, k: int) -> int:
    """Clients one CTA of a ``k``-cluster owns: ``ceil(J / k)`` rounded up
    to 4, so that every slice of a row starts 16-byte aligned when
    ``J*C`` is a multiple of 4; the last slices may be narrower, or
    empty."""
    per_cta = -(-J // k)
    return -(-per_cta // 4) * 4


def split_guard_floats(J: int, k: int) -> int:
    """Floats a guard adds to one CTA of the split kernel
    (``split_guard_floats`` in ``p_epoch.cu``): the whole of p gathered
    from the cluster every step and the whole of cv (``k * Jk`` each; clip's
    ``k * MAX_WARPS`` partial sums take the same room, at least as much of
    it), and the exchange's mbarrier padded to 16 bytes."""
    return k * max(2 * split_slice(J, k), MAX_WARPS) + 4


def split_ring_bytes(B: int, J: int, C: int, k: int, warps: int, tile: int,
                     stages: int, guarded: bool = False) -> int:
    """Shared memory of one CTA of the split kernel with ``warps``
    consumer warps and a ring of ``stages`` stages of ``tile`` clients
    (``split_ring_bytes`` in ``p_epoch.cu``): the mbarriers (a full one
    a stage and warp, an empty one a stage, an exchange one a slot set
    and warp, a full and an empty one for each of two slots of row
    information; padded to 16 bytes), then in floats the two slots of
    row information (a step's labels, valid flags and count, padded to
    4), the stages (``warps`` rows of ``tile*C`` each), two slot sets of
    the exchange (a slot a rank: a row of ``C`` floats padded to 4 a
    warp), ``h (warps, Jk)`` (each warp's rows summed), the slice's
    ``p``, ``buf`` and ``cv`` and the per-warp sums; ``guarded``,
    ``split_guard_floats`` more."""
    jk = split_slice(J, k)
    slot = warps * _round_up(C, 4)
    header = _round_up(8 * (stages * (warps + 1) + 2 * warps + 4), 16)
    return header + 4 * (2 * _round_up(2 * B + 1, 4)
                         + stages * warps * tile * C + 2 * k * slot
                         + warps * jk + 3 * jk + 4 * warps
                         + (split_guard_floats(J, k) if guarded else 0))


def split_layout(B: int, J: int, C: int, k: int, stream: bool,
                 smem_limit: int = cuda_build.SMEM_LIMIT,
                 guarded: bool = False) -> tuple[int, int, int, int]:
    """``(smem_bytes, tile, stages, warps)`` of the split kernel
    (``split_layout`` in ``p_epoch.cu``, at the card's block): holding
    (``stream`` False), one tile of the whole slice a stage and a warp a
    row, as many stages as fit up to ``SPLIT_MAX_STAGES``, at least 2;
    streaming, the widest tile (the slice halved, then halved again,
    rounded up to 4 clients) of which two stages fit, then as many
    stages as fit, with a warp a row or, where no tile fits, half as
    many warps (at most 32 rows a warp), and so on. Where nothing fits,
    the least layout, whose bytes pass ``smem_limit``. ``guarded``: the
    layout of a launch with a p-guard (``split_ring_bytes``)."""
    jk = split_slice(J, k)
    first = _round_up(-(-jk // 2), 4) if stream else jk

    def fits(warps, tile, stages):
        return split_ring_bytes(B, J, C, k, warps, tile, stages,
                                guarded) <= smem_limit

    warps = staged_warps(B)
    while warps >= max(1, -(-B // 32)):
        tile = first
        while True:
            if fits(warps, tile, 2):
                stages = 2
                while (stages < SPLIT_MAX_STAGES
                       and fits(warps, tile, stages + 1)):
                    stages += 1
                return (split_ring_bytes(B, J, C, k, warps, tile, stages,
                                         guarded), tile, stages, warps)
            if not stream or tile == 4:
                break
            tile = _round_up(-(-tile // 2), 4)
        if not stream:
            break
        warps //= 2
    tile = 4 if stream else jk
    return (split_ring_bytes(B, J, C, k, staged_warps(B), tile, 2, guarded),
            tile, 2, staged_warps(B))


def split_smem_bytes(B: int, J: int, C: int, k: int, stream: bool) -> int:
    """Shared memory of one CTA of the split kernel (``split_layout``'s
    bytes)."""
    return split_layout(B, J, C, k, stream)[0]


def tiled_class_lo(C: int, k: int, q: int) -> int:
    """The first class CTA ``q`` of a ``k``-cluster of the class-tiled
    split kernel owns (``q = k``: ``C``): a balanced split."""
    return q * C // k


def tiled_width(C: int, k: int) -> int:
    """Floats of one client's slice in the class-split layout: the widest
    slice, ``ceil(C / k)``, rounded up to 4 (16-byte aligned spans)."""
    return _round_up(-(-C // k), 4)


def tiled_bytes(B: int, J: int, C: int, k: int, rows: int, tile: int,
                stages: int, gchunk: int, state_global: bool) -> int:
    """Shared memory of one CTA of the class-tiled split kernel
    (``tiled_bytes`` in ``p_epoch.cu``): the mbarriers (a full and an
    empty one a stage, two each for the statistics' and g's slot sets and
    the row information; padded to 16 bytes), then in floats the two
    row-information slots, ``stages`` stages of ``rows`` rows of ``tile``
    clients' slices (``W`` floats each), two row buffers of z and d
    (``rows*W``), two statistics slot sets (``k`` ranks, 4 floats a row),
    two g slot sets (``k*gchunk``), the per-warp sums and, unless
    ``state_global``, p, buf, cv and g (``round_up(J, 4)`` each)."""
    W, jp = tiled_width(C, k), _round_up(J, 4)
    header = _round_up(8 * (2 * stages + 8), 16)
    return header + 4 * (2 * _round_up(2 * B + 1, 4)
                         + stages * rows * tile * W + 2 * rows * W
                         + 8 * k * rows + 2 * k * gchunk + 4 * TILED_WARPS
                         + (0 if state_global else 4 * jp))


def tiled_layout(B: int, J: int, C: int, k: int,
                 smem_limit: int = cuda_build.SMEM_LIMIT
                 ) -> tuple[int, int, int, int, int, bool]:
    """``(smem_bytes, rows, tile, stages, gchunk, state_global)`` of the
    class-tiled split kernel at ``(B, J, C, k)`` (``tiled_layout`` in
    ``p_epoch.cu``, at the card's block): g in exchanges of ``gchunk =
    min(round_up(J, 4), TILED_G_CHUNK)`` clients; with the state (p, buf,
    cv, g) in shared memory, else in global memory: holding, groups of
    ``rows`` rows (``min(B, 16)``, halved while two stages do not fit) of
    all J clients (``tile == J``); else streaming, the most rows (halved
    the same way) and for them the widest tile of clients (J halved, then
    halved again) of which two stages fit; then as many stages as fit up to
    ``TILED_MAX_STAGES``. Where nothing fits, the least layout, whose
    bytes pass ``smem_limit``."""
    gx, r0 = min(_round_up(J, 4), TILED_G_CHUNK), min(B, TILED_MAX_ROWS)

    def fits(rows, tile, sg, stages=2):
        return tiled_bytes(B, J, C, k, rows, tile, stages, gx,
                           sg) <= smem_limit

    def make(rows, tile, sg):
        stages = 2
        while stages < TILED_MAX_STAGES and fits(rows, tile, sg, stages + 1):
            stages += 1
        return (tiled_bytes(B, J, C, k, rows, tile, stages, gx, sg), rows,
                tile, stages, gx, sg)

    for sg in (False, True):
        rows = r0
        while rows >= 1:
            if fits(rows, J, sg):
                return make(rows, J, sg)
            rows //= 2
        rows = r0
        while rows >= 1:
            tile = (J + 1) // 2
            while True:
                if fits(rows, tile, sg):
                    return make(rows, tile, sg)
                if tile == 1:
                    break
                tile = (tile + 1) // 2
            rows //= 2
    return (tiled_bytes(B, J, C, k, 1, 1, 2, gx, True), 1, 1, 2, gx, True)


def class_split(logits, k: int):
    """``logits (n_val, J, C)`` in the class-tiled split kernel's layout
    for a ``k``-cluster: ``(k, n_val, J, W)``, rank q's classes
    ``[tiled_class_lo(C, k, q), tiled_class_lo(C, k, q + 1))`` of every
    row and client, zero-padded to ``W = tiled_width(C, k)``: so each
    CTA's slice of a row (or of a tile of its clients) is one contiguous
    16-byte aligned span, whatever C. Made once a p-solve
    (``make_p_solver``), not once an epoch."""
    n_val, J, C = logits.shape
    out = torch.zeros((k, n_val, J, tiled_width(C, k)), dtype=logits.dtype,
                      device=logits.device)
    for q in range(k):
        lo, hi = tiled_class_lo(C, k, q), tiled_class_lo(C, k, q + 1)
        out[q, :, :, :hi - lo] = logits[:, :, lo:hi]
    return out


def prepare_logits(logits, B: int):
    """What ``p_epoch`` takes as ``split_logits`` at batch ``B`` for every
    epoch of a p-solve over ``logits``: their ``class_split`` layout where
    the plan runs the class-tiled split kernel on the card, else None."""
    if logits.device.type != "cuda":
        return None
    _, J, C = logits.shape
    plan = launch_plan(B, J, C, max_cluster=split_max_cluster(
        logits.device.index or 0))
    if plan is None or plan.kernel != "split_tiled":
        return None
    return class_split(logits, plan.cluster)


def unstaged_smem_bytes(B: int, J: int, C: int) -> int:
    """Shared memory of the unstaged kernel: the step's ``(B, J, C)``
    block, ``p``, ``buf``, ``cv``, the logits, per-row scratch and the
    guard's per-warp sums."""
    return 4 * (B * J * C + 3 * J + B * C + 3 * B + 4 * UNSTAGED_WARPS) + 4 * B


@dataclasses.dataclass(frozen=True)
class PEpochPlan:
    """How one launch runs: ``kernel`` one of ``KERNELS``, the ``warps``
    of each CTA, the instantiated ``classes`` (0 for the unstaged and the
    class-tiled split kernels, which take C at run time) and one CTA's
    dynamic ``smem_bytes``; for the split kernels, the ``cluster`` of
    CTAs, the ``slice_width`` each owns (the split kernel's clients, the
    class-tiled kernel's padded classes ``tiled_width``), whether it
    ``stream``s its rows (copies them into its ring again for the h pass),
    the ring's ``tile`` of clients and its ``stages``; for the
    class-tiled kernel, the ``rows`` of a group, the clients of g an
    exchange carries (``gchunk``) and whether p, buf and g live in global
    memory (``global_state``). Both split kernels' CTAs have one producer
    warp beside their ``warps``."""

    kernel: str
    warps: int
    classes: int
    smem_bytes: int
    cluster: int = 1
    slice_width: int = 0
    stream: bool = False
    tile: int = 0
    stages: int = 0
    rows: int = 0
    gchunk: int = 0
    global_state: bool = False


def _split_reach(B: int, J: int, C: int, smem_limit: int,
                 max_cluster: int) -> bool:
    """Whether the split kernel takes ``(B, J, C)``: where its first
    layout fit a block streaming over the largest cluster (a slot of
    every row's partial logits a CTA, pulled over the cluster, beside
    ``h (B, Jk)``). The push exchange needs less at large B and more at
    a small block; this bound keeps the kernel every shape ran before
    (the staged, unstaged or class-tiled kernels take the rest), and
    ``split_layout`` fits every shape inside it."""
    nw = staged_warps(B)
    jk = split_slice(J, max(k for k in SPLIT_CLUSTERS if k <= max_cluster))
    return 16 * nw + 4 * (B * jk + 3 * jk + 4 * nw
                          + 2 * _round_up(max(B * C, 2), 4)) <= smem_limit


# the split kernel's cluster rule: a cluster whose CTAs hold their slices
# is small enough when a lane's share of a row, ceil(Jk / 32) clients of C
# logits and about 4 floats of their own (p, h, the loop), is at most this
SPLIT_LANE_FLOATS = 48


def _split_cluster(B: int, J: int, C: int, sizes: list[int],
                   smem_limit: int, guarded: bool = False
                   ) -> tuple[int, bool] | None:
    """``(k, stream)`` of the split kernel at ``(B, J, C)`` among the
    cluster ``sizes``: the smallest whose CTAs hold their row slices
    (``split_layout`` with ``stream`` False) with ``ceil(Jk/32) * (C + 4)
    <= SPLIT_LANE_FLOATS``; else the largest that holds; else the
    largest whose CTAs fit streaming. Fitted to
    ``tools/p_epoch_clusters.py`` on an H100 (B = 16, n_val 11,983, ms a
    launch at k = 2, 4, 8, 16; S streaming, else holding): J = 400, C =
    10 4.03 S, 2.72, 2.20, 2.48; J = 512, C = 10 4.49 S, 2.39, 2.14,
    2.50; J = 356, C = 10 3.13 S, 2.15, 2.17, 2.54; J = 800, C = 10 6.36
    S, 4.08 S, 2.83, 2.65; J = 2,000, C = 10 18.37 S, 8.00 S, 4.35 S,
    2.88; J = 1,024, C = 7 6.25 S, 3.76 S, 2.64, 2.61; J = 138, C = 26
    4.49 S, 3.44, 3.26, 3.89; J = 200, C = 26 4.47 S, 3.48, 3.31, 3.92;
    J = 1,658, C = 2 3.36 S, 2.08, 1.82, 1.99; J = 2,048, C = 2 3.71 S,
    2.22, 1.86, 1.86; J = 4,096, C = 2 9.92 S, 3.85 S, 2.29, 2.04; J =
    1,000, C = 26 and J = 4,096, C = 10 and 26 stream at every size,
    fastest at 16. A larger cluster shortens a CTA's passes over its
    slice and lengthens the exchange (0.5 us a step at k = 4, 0.7 at 8,
    1.0 at 16, ``tools/p_epoch_phases.py``); streaming
    copies every tile twice. A p-guard keeps the rule (``guarded`` only
    reserves its gather's room in the layouts): with the simplex guard
    (``--guard simplex --lr 1e-2``, beside the unguarded sweep in one
    call, k = 2, 4, 8, 16) J = 400 5.15, 3.89, 3.28, 3.64 (unguarded 3.96,
    2.65, 2.16, 2.41); J = 512 4.62, 3.62, 3.28, 3.70 (4.51, 2.33, 2.09,
    2.43); J = 1,024, C = 7 7.94, 5.83, 4.63, 4.59 (6.24, 3.73, 2.57,
    2.58): 16 within 1% of 8 guarded and unguarded alike."""
    held = [k for k in sizes
            if split_layout(B, J, C, k, False, smem_limit,
                            guarded)[0] <= smem_limit]
    for k in held:
        if -(-split_slice(J, k) // 32) * (C + 4) <= SPLIT_LANE_FLOATS:
            return k, False
    if held:
        return held[-1], False
    streamed = [k for k in sizes
                if split_layout(B, J, C, k, True, smem_limit,
                                guarded)[0] <= smem_limit]
    return (streamed[-1], True) if streamed else None


def _split_plan(B: int, J: int, C: int, nc: int, smem_limit: int,
                max_cluster: int, cluster: int | None = None,
                guarded: bool = False) -> PEpochPlan | None:
    """The split kernel's plan for the instantiation of ``nc`` classes:
    the cluster of ``_split_cluster`` inside ``_split_reach``, with the
    guarded layout where ``guarded``. ``cluster`` forces a size (None
    where its CTAs fit neither way)."""
    sizes = [k for k in SPLIT_CLUSTERS if k <= max_cluster
             and cluster in (None, k)]
    if not _split_reach(B, J, C, smem_limit, max_cluster):
        return None
    chosen = _split_cluster(B, J, C, sizes, smem_limit, guarded)
    if chosen is None:
        return None
    k, stream = chosen
    smem, tile, stages, warps = split_layout(B, J, C, k, stream, smem_limit,
                                             guarded)
    return PEpochPlan("split", warps, nc, smem, k, split_slice(J, k),
                      stream, tile, stages)


# the class-tiled split kernel's step time, fitted to its readings on an
# NVIDIA H100 80GB HBM3 at 700 W (_split_tiled_cluster's): a group of rows
# (its statistics exchange, two block barriers, the passes' fixed part), a
# float of a step's class slices a CTA reads in both passes, and the
# cluster's square (the two exchanges and the merge over the ranks)
TILED_GROUP_US = 4.13
TILED_FLOAT_US = 0.0951e-3
TILED_CLUSTER2_US = 0.00409


def tiled_step_us(B: int, J: int, C: int, k: int, rows: int,
                  stream: bool) -> float:
    """The class-tiled split kernel's estimated µs a step at ``(B, J, C)``
    on a ``k``-cluster whose layout takes groups of ``rows`` rows
    (``stream``: its tiles of clients read twice): ``TILED_GROUP_US`` a
    group, ``TILED_FLOAT_US`` a float of the ``B*J*W`` a CTA reads, and
    ``TILED_CLUSTER2_US * k**2``."""
    groups = -(-B // rows)
    return (TILED_GROUP_US * groups
            + TILED_FLOAT_US * B * J * tiled_width(C, k) * (2 if stream else 1)
            + TILED_CLUSTER2_US * k * k)


def _split_tiled_cluster(B: int, J: int, C: int, sizes: list[int],
                         smem_limit: int) -> int:
    """The class-tiled split kernel's cluster among ``sizes`` (each of
    which fits): the least ``tiled_step_us`` at its layout, the larger
    size on a tie. Fitted to ``tools/p_epoch_phases.py --kernel
    split_tiled --cluster all`` on an H100 (B = 16, n_val 1,262, ms a
    launch at k = 1, 2, 4, 8, 16; the fastest in brackets): J = 50,
    C = 105 1.944, 0.819, 0.467, 0.431, 0.452 [8]; C = 1,000 32.49 (k = 1
    streams), 9.590, 4.366, 2.319, 1.105 [16]; C = 33 0.805, 0.434,
    0.386, 0.386, 0.442 [4, 8]; C = 53 0.802, 0.452, 0.395, 0.387, 0.443
    [8]; C = 70 1.776, 0.824, 0.447, 0.420, 0.452 [8]; J = 10, C = 105
    0.512, 0.388, 0.362, 0.383, 0.434 [4]; J = 200, C = 105 14.30, 4.740,
    1.936, 0.936, 0.828 [16]; J = 400, C = 105 9.236 (streams), 14.06,
    5.160, 2.221, 1.841 [16]; J = 4, C = 40 0.358, 0.333, 0.343, 0.370,
    0.419 [2]. It picks the fastest at each. Fewer CTAs give each more
    classes to read in both passes, and at large J fewer rows a group
    (one statistics exchange each); more add to the exchanges and the
    merge."""
    def cost(k):
        _, rows, tile, _, _, _ = tiled_layout(B, J, C, k, smem_limit)
        return tiled_step_us(B, J, C, k, rows, tile < J)

    return min(sizes, key=lambda k: (cost(k), -k))


def _tiled_plan(B: int, J: int, C: int, smem_limit: int, max_cluster: int,
                cluster: int | None = None) -> PEpochPlan | None:
    """The class-tiled split kernel's plan: the cluster of
    ``_split_tiled_cluster`` among the sizes of ``TILED_CLUSTERS`` up to
    ``max_cluster`` and ``C`` whose layout fits ``smem_limit``, with that
    size's ``tiled_layout``; ``cluster`` forces a size (None where it does
    not fit)."""
    sizes = [k for k in TILED_CLUSTERS if k <= min(max_cluster, C)
             and cluster in (None, k)
             and tiled_layout(B, J, C, k, smem_limit)[0] <= smem_limit]
    if not sizes:
        return None
    k = _split_tiled_cluster(B, J, C, sizes, smem_limit)
    smem, rows, tile, stages, gchunk, sg = tiled_layout(B, J, C, k,
                                                        smem_limit)
    return PEpochPlan("split_tiled", TILED_WARPS, 0, smem, k,
                      tiled_width(C, k), tile < J, tile, stages, rows,
                      gchunk, sg)


def launch_plan(B: int, J: int, C: int, kernel: str | None = None,
                smem_limit: int = cuda_build.SMEM_LIMIT,
                max_cluster: int = SPLIT_CLUSTERS[-1],
                cluster: int | None = None,
                guarded: bool = False) -> PEpochPlan | None:
    """The kernel for batch ``B``, ``J`` clients and ``C`` classes, by
    shape alone: the staged kernel when ``B <= 512``, ``C <= 32`` and its
    two stages plus ``h`` fit a block's shared memory (``smem_limit``);
    else, with the same bounds on B and C, the split kernel over a
    cluster of at most ``max_cluster`` CTAs (``_split_plan``); else, at
    ``B <= 512`` and ``C > 32``, the class-tiled split kernel
    (``_tiled_plan``; on an H100 it ran several times under the unstaged
    kernel at every such shape timed, J = 2 to 50, C = 33 to 105, PERF.md
    § 6); else the unstaged kernel (B > 512) when its step block fits; else, at ``B <= 512``, the class-tiled split kernel; else None
    (no kernel takes the shape). ``kernel`` forces one of ``KERNELS``
    (``"split_tiled"`` at any C), and ``ValueError`` says when it does
    not fit; ``cluster`` forces the split kernels' cluster (for
    measurement; a plan at that size, or ``ValueError``; 1 only the
    class-tiled kernel's). ``guarded``: the plan of a launch with a
    p-guard, whose split layouts hold its gather of p
    (``split_guard_floats``); every other kernel's plan is the same."""
    if B < 1 or J < 1 or C < 1:
        raise ValueError(f"bad shape B={B}, J={J}, C={C}")
    if kernel not in (None,) + KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if cluster is not None and cluster not in TILED_CLUSTERS:
        raise ValueError(f"cluster must be one of {TILED_CLUSTERS}, got "
                         f"{cluster!r}")
    fits = {}
    nc = staged_classes(C)
    if B <= MAX_STAGED_BATCH and nc:
        smem = staged_smem_bytes(B, J, C)
        if smem <= smem_limit:
            fits["staged"] = PEpochPlan("staged", staged_warps(B), nc, smem)
        split = _split_plan(B, J, C, nc, smem_limit, max_cluster, cluster,
                            guarded)
        if split is not None:
            fits["split"] = split
    tiled = (_tiled_plan(B, J, C, smem_limit, max_cluster, cluster)
             if B <= MAX_STAGED_BATCH else None)
    if tiled is not None and C > 32:
        fits["split_tiled"] = tiled
    smem = unstaged_smem_bytes(B, J, C)
    if smem <= smem_limit:
        fits["unstaged"] = PEpochPlan("unstaged", UNSTAGED_WARPS, 0, smem)
    if tiled is not None:
        fits.setdefault("split_tiled", tiled)
    if kernel is not None:
        if kernel not in fits:
            raise ValueError(f"the {kernel} p_epoch kernel does not fit "
                             f"B={B}, J={J}, C={C}; these do: {list(fits)}")
        plan = fits[kernel]
    else:
        plan = next(iter(fits.values()), None)
    if cluster is not None and (plan is None or plan.cluster != cluster):
        raise ValueError(f"no split p_epoch kernel fits B={B}, J={J}, C={C} "
                         f"on a {cluster}-CTA cluster: {plan}")
    return plan


def kernel_symbol(plan: PEpochPlan, C: int, guarded: bool = False) -> str:
    """The part of the mangled name that picks out the kernel ``plan``
    runs for ``C`` classes in the compiler's report
    (``cuda_build.ptxas_usage``); the staged, split and class-tiled split
    kernels have an instantiation with the guard epilogue (``guarded``)
    and one without."""
    if plan.kernel == "unstaged":
        return "23unstaged_p_epoch_kernel"
    if plan.kernel == "split_tiled":
        # an instantiation by where p, buf and g live
        return (f"26split_tiled_p_epoch_kernelILb{int(plan.global_state)}E"
                f"Lb{int(guarded)}EE")
    name = f"{plan.kernel}_p_epoch_kernel"
    return (f"{len(name)}{name}ILi{plan.classes}ELb{int(C in EXACT_CLASSES)}E"
            f"Lb{int(guarded)}E")


def bulk_rows(logits) -> bool:
    """Whether the staged and split kernels (both) copy rows with
    ``cp.async.bulk``: a row's ``J*C`` floats a multiple of 16 bytes and
    the logits 16-byte aligned; else they copy them element-wise with
    ``cp.async``."""
    _, J, C = logits.shape
    return (J * C) % 4 == 0 and logits.data_ptr() % 16 == 0


def guard_code(guard) -> tuple[int, float]:
    """``(code, radius)`` the kernels take for ``guard``: ``(0, 0.0)`` for
    None, else the ``kind`` and ``radius`` of a guard made by
    ``aggregate.make_guard``. Any other callable raises: the kernels run
    only those guards."""
    if guard is None:
        return 0, 0.0
    kind = getattr(guard, "kind", None)
    if kind not in GUARD_CODES:
        raise ValueError(
            f"the p_epoch kernels run the guards of aggregate.make_guard "
            f"({sorted(GUARD_CODES)}), not {guard!r}")
    return GUARD_CODES[kind], float(getattr(guard, "radius", 0.0))


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("p_epoch")
    floats = [ctypes.c_float] * 3
    for name, nptr, ints in (("staged", 11, 7), ("split", 11, 9),
                             ("unstaged", 11, 6), ("split_tiled", 12, 8)):
        fn = getattr(lib, f"p_epoch_launch_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * ints
                       + floats + [ctypes.c_void_p])
    for name, nargs in (("p_epoch_staged_smem_bytes", 3),
                        ("p_epoch_unstaged_smem_bytes", 3),
                        ("p_epoch_split_smem_bytes", 6)):
        getattr(lib, name).restype = ctypes.c_size_t
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    for name, nargs in (("p_epoch_staged_warps", 1),
                        ("p_epoch_instantiated_classes", 1),
                        ("p_epoch_split_slice", 2),
                        ("p_epoch_split_guard_floats", 2),
                        ("p_epoch_split_max_cluster", 0)):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    lib.p_epoch_split_layout.restype = ctypes.c_int
    lib.p_epoch_split_layout.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.p_epoch_tiled_layout.restype = ctypes.c_int
    lib.p_epoch_tiled_layout.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)]
    return lib


@functools.lru_cache(maxsize=None)
def split_max_cluster(device_index: int) -> int:
    """The largest cluster the split kernel launches on card
    ``device_index``: 16 where the card schedules a 16-CTA cluster of the
    largest CTA, else 8 (``p_epoch_split_max_cluster``)."""
    with torch.cuda.device(device_index):
        return _library().p_epoch_split_max_cluster()


def _check_plan(lib, plan: PEpochPlan, B: int, J: int, C: int,
                guarded: bool = False) -> None:
    """The plan's layout must be the kernel's: same shared memory, warps,
    instantiation and, split, slice (and the split kernels' rings; the
    split kernel's with its guard's gather where ``guarded``)."""
    if plan.kernel == "split_tiled":
        out, smem = (ctypes.c_int * 6)(), ctypes.c_size_t()
        lib.p_epoch_tiled_layout(B, J, C, plan.cluster, out,
                                 ctypes.byref(smem))
        got = (smem.value, *out)
        want = (plan.smem_bytes, plan.rows, plan.tile, plan.stages,
                plan.gchunk, int(plan.global_state), plan.slice_width)
        if got != want:
            raise RuntimeError(
                f"launch plan {plan} disagrees with csrc/p_epoch.cu (bytes, "
                f"rows, tile, stages, gchunk, global state, width = {got})")
        return
    if plan.kernel == "staged":
        got = (lib.p_epoch_staged_smem_bytes(B, J, C),
               lib.p_epoch_staged_warps(B),
               lib.p_epoch_instantiated_classes(C), 0)
    elif plan.kernel == "split":
        if lib.p_epoch_split_guard_floats(J, plan.cluster) != \
                split_guard_floats(J, plan.cluster):
            raise RuntimeError(
                f"split_guard_floats({J}, {plan.cluster}) disagrees with "
                "csrc/p_epoch.cu")
        got = (lib.p_epoch_split_smem_bytes(B, J, C, plan.cluster,
                                            int(not plan.stream),
                                            int(guarded)),
               lib.p_epoch_staged_warps(B),
               lib.p_epoch_instantiated_classes(C),
               lib.p_epoch_split_slice(J, plan.cluster))
    else:
        got = (lib.p_epoch_unstaged_smem_bytes(B, J, C), UNSTAGED_WARPS, 0,
               0)
    if plan.kernel == "split":
        lay = [ctypes.c_int() for _ in range(3)]
        lib.p_epoch_split_layout(B, J, C, plan.cluster, int(not plan.stream),
                                 int(guarded), *map(ctypes.byref, lay))
        got = got[:1] + (lay[2].value,) + got[2:] + (lay[0].value,
                                                      lay[1].value)
    want = (plan.smem_bytes, plan.warps, plan.classes, plan.slice_width)
    if plan.kernel == "split":
        want += (plan.tile, plan.stages)
    if got != want:
        raise RuntimeError(
            f"launch plan {plan} disagrees with csrc/p_epoch.cu "
            f"(bytes, warps, classes, slice[, tile, stages] = {got})")


def p_epoch(p, buf, cv, logits, y_val, positions, valid, lr, momentum, task,
            kernel=None, guard=None, guard_rounds=None, cluster=None,
            split_logits=None):
    """One p-solver epoch; same contract as ``p_epoch_plain``. CPU
    tensors run the plain version; CUDA tensors launch the kernel of
    ``launch_plan`` from ``csrc/p_epoch.cu`` or raise where no plan takes
    the shape. ``guard`` (``aggregate.make_guard``) runs in the kernel's
    epilogue. ``kernel`` forces one of ``KERNELS`` (for measurement; a
    guard runs on a forced kernel too, where the JAX package refuses its
    pinned Pallas kernel with a guard). ``guard_rounds``, an int32 ``(2,)``
    CUDA tensor, receives the simplex's fixed-point rounds summed over the
    epoch's steps and in the step that took most. ``cluster`` forces the
    split kernels' cluster size (for measurement; ``launch_plan``).
    ``split_logits``: ``class_split(logits, k)`` for the class-tiled
    split kernel's plan, made once for many epochs over the same logits
    (``prepare_logits``); without it that kernel's launch makes it
    first."""
    _check(p, buf, cv, logits, y_val, positions, valid, task)
    if p.device.type == "cpu":
        return p_epoch_plain(p, buf, cv, logits, y_val, positions, valid,
                             lr, momentum, task, guard)
    if p.device.type != "cuda":
        raise ValueError(f"p_epoch runs on cpu or cuda, not {p.device}")
    code, radius = guard_code(guard)
    if guard_rounds is not None and (
            guard_rounds.dtype != torch.int32 or guard_rounds.numel() != 2
            or guard_rounds.device != p.device):
        raise ValueError("guard_rounds must be an int32 (2,) tensor on "
                         f"{p.device}")
    S, B = positions.shape
    _, J, C = logits.shape
    k_max = split_max_cluster(p.device.index)
    plan = launch_plan(B, J, C, kernel=kernel, max_cluster=k_max,
                       cluster=cluster, guarded=code != 0)
    if plan is None:
        tiled = min(tiled_layout(B, J, C, k)[0]
                    for k in TILED_CLUSTERS if k <= min(k_max, C))
        raise ValueError(
            f"no p_epoch kernel takes B={B}, J={J}, C={C}: the staged and "
            f"split kernels need B <= {MAX_STAGED_BATCH} and the "
            f"class-tiled split kernel at least {tiled} bytes of shared "
            f"memory a CTA up to a {k_max}-CTA cluster; the unstaged kernel "
            f"{unstaged_smem_bytes(B, J, C)}; a block has "
            f"{cuda_build.SMEM_LIMIT}: run it with kernel_impl='plain'")
    lib = _library()
    _check_plan(lib, plan, B, J, C, code != 0)
    p_out = torch.empty_like(p)
    buf_out = torch.empty_like(buf)
    metrics = torch.empty(3, dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    ptrs = (p.data_ptr(), buf.data_ptr(), cv.data_ptr(), logits.data_ptr(),
            y_val.data_ptr(), positions.data_ptr(), valid.data_ptr(),
            p_out.data_ptr(), buf_out.data_ptr(), metrics.data_ptr(),
            None if guard_rounds is None else guard_rounds.data_ptr())
    is_cls = int(task == "classification")
    scalars = (float(lr), float(momentum), radius, stream)
    if plan.kernel == "staged":
        err = lib.p_epoch_launch_staged(
            *ptrs, S, B, J, C, is_cls, int(bulk_rows(logits)), code,
            *scalars)
    elif plan.kernel == "split":
        err = lib.p_epoch_launch_split(
            *ptrs, S, B, J, C, is_cls, int(bulk_rows(logits)), code,
            plan.cluster, int(not plan.stream), *scalars)
    elif plan.kernel == "split_tiled":
        shape = (plan.cluster, logits.shape[0], J, plan.slice_width)
        if split_logits is None:
            split_logits = class_split(logits, plan.cluster)
        elif (tuple(split_logits.shape) != shape
              or split_logits.dtype != torch.float32
              or split_logits.device != p.device
              or not split_logits.is_contiguous()):
            raise ValueError(
                f"split_logits must be a contiguous float32 {shape} tensor "
                f"on {p.device} (class_split at the plan's cluster), got "
                f"{split_logits.dtype} {tuple(split_logits.shape)}")
        scratch = torch.empty(
            plan.cluster * 3 * _round_up(J, 4) if plan.global_state else 0,
            dtype=torch.float32, device=p.device)
        err = lib.p_epoch_launch_split_tiled(
            *ptrs[:3], split_logits.data_ptr(), *ptrs[4:],
            scratch.data_ptr() or None, S, B, J, C, logits.shape[0], is_cls,
            code, plan.cluster, *scalars)
    else:
        err = lib.p_epoch_launch_unstaged(
            *ptrs, S, B, J, C, is_cls, code, *scalars)
    cuda_build.check(err, "p_epoch launch", lib)
    p_epoch.launches += 1
    p_epoch.launches_by_kernel[plan.kernel] += 1
    return p_out, buf_out, metrics


def reset_counts() -> None:
    """Set ``p_epoch``'s launch counts to 0."""
    p_epoch.launches = 0
    p_epoch.launches_by_kernel = dict.fromkeys(KERNELS, 0)


reset_counts()
