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
and of every row, the partial logits meet through distributed shared
memory in rank order, and each CTA holds its slices of a step's rows in
a two-stage ring when they fit (``stream=False``), else reads them from
global memory in both passes (``stream=True``). Shapes neither takes
(``B > 512`` or ``C > 32``) run the unstaged kernel, the port's first
design (one CTA of 256 threads, five barriers per step). ``launch_plan``
picks the kernel by shape alone.

Every kernel applies the p-guards of ``aggregate.make_guard`` (``clip:R``
and the projection onto the simplex over the valid clients, by
Michelot's fixed point) as an epilogue of its p update, selected at
launch.

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
KERNELS = ("staged", "split", "unstaged")
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


def split_slice(J: int, k: int) -> int:
    """Clients one CTA of a ``k``-cluster owns: ``ceil(J / k)`` rounded up
    to 4, so that every slice of a row starts 16-byte aligned when
    ``J*C`` is a multiple of 4; the last slices may be narrower, or
    empty."""
    per_cta = -(-J // k)
    return -(-per_cta // 4) * 4


def split_smem_bytes(B: int, J: int, C: int, k: int, stream: bool) -> int:
    """Shared memory of one CTA of the split kernel (``split_smem_bytes``
    in ``p_epoch.cu``): two mbarriers per warp, two stages of its slices
    of ``B`` rows (``Jk*C`` floats each) unless it streams them, ``h (B,
    Jk)``, its slices of ``p``, ``buf`` and ``cv``, the per-warp sums and
    two cluster-exchange slots of ``B*C`` floats (at least 2, padded to
    4)."""
    nw, jk = staged_warps(B), split_slice(J, k)
    ring = 0 if stream else 2 * B * jk * C
    xs = -(-max(B * C, 2) // 4) * 4
    return 16 * nw + 4 * (ring + B * jk + 3 * jk + 4 * nw + 2 * xs)


def unstaged_smem_bytes(B: int, J: int, C: int) -> int:
    """Shared memory of the unstaged kernel: the step's ``(B, J, C)``
    block, ``p``, ``buf``, ``cv``, the logits, per-row scratch and the
    guard's per-warp sums."""
    return 4 * (B * J * C + 3 * J + B * C + 3 * B + 4 * UNSTAGED_WARPS) + 4 * B


@dataclasses.dataclass(frozen=True)
class PEpochPlan:
    """How one launch runs: ``kernel`` one of ``KERNELS``, the ``warps``
    of each CTA, the instantiated ``classes`` (0 for the unstaged kernel,
    which takes C at run time) and one CTA's dynamic ``smem_bytes``; for
    the split kernel, the ``cluster`` of CTAs, the ``slice_width`` of J
    each owns and whether it ``stream``s its rows from global memory
    instead of holding them in a ring."""

    kernel: str
    warps: int
    classes: int
    smem_bytes: int
    cluster: int = 1
    slice_width: int = 0
    stream: bool = False


def _split_plan(B: int, J: int, C: int, nc: int, smem_limit: int,
                max_cluster: int) -> PEpochPlan | None:
    """The split kernel's plan: the smallest cluster whose CTAs hold two
    stages of their row slices (fewer CTAs a barrier waits for), else the
    largest whose CTAs fit streaming (the least each reads a step)."""
    sizes = [k for k in SPLIT_CLUSTERS if k <= max_cluster]
    for stream, order in ((False, sizes), (True, sizes[::-1])):
        for k in order:
            smem = split_smem_bytes(B, J, C, k, stream)
            if smem <= smem_limit:
                return PEpochPlan("split", staged_warps(B), nc, smem, k,
                                  split_slice(J, k), stream)
    return None


def launch_plan(B: int, J: int, C: int, kernel: str | None = None,
                smem_limit: int = cuda_build.SMEM_LIMIT,
                max_cluster: int = SPLIT_CLUSTERS[-1]) -> PEpochPlan | None:
    """The kernel for batch ``B``, ``J`` clients and ``C`` classes, by
    shape alone: the staged kernel when ``B <= 512``, ``C <= 32`` and its
    two stages plus ``h`` fit a block's shared memory (``smem_limit``);
    else, with the same bounds on B and C, the split kernel over a
    cluster of at most ``max_cluster`` CTAs (``_split_plan``); else the
    unstaged kernel when its step block fits; else None (no kernel takes
    the shape). ``kernel`` forces one of ``KERNELS``, and ``ValueError``
    says when it does not fit."""
    if B < 1 or J < 1 or C < 1:
        raise ValueError(f"bad shape B={B}, J={J}, C={C}")
    if kernel not in (None,) + KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    fits = {}
    nc = staged_classes(C)
    if B <= MAX_STAGED_BATCH and nc:
        smem = staged_smem_bytes(B, J, C)
        if smem <= smem_limit:
            fits["staged"] = PEpochPlan("staged", staged_warps(B), nc, smem)
        split = _split_plan(B, J, C, nc, smem_limit, max_cluster)
        if split is not None:
            fits["split"] = split
    smem = unstaged_smem_bytes(B, J, C)
    if smem <= smem_limit:
        fits["unstaged"] = PEpochPlan("unstaged", UNSTAGED_WARPS, 0, smem)
    if kernel is not None:
        if kernel not in fits:
            raise ValueError(f"the {kernel} p_epoch kernel does not fit "
                             f"B={B}, J={J}, C={C}; these do: {list(fits)}")
        return fits[kernel]
    return next(iter(fits.values()), None)


def kernel_symbol(plan: PEpochPlan, C: int, guarded: bool = False) -> str:
    """The part of the mangled name that picks out the kernel ``plan``
    runs for ``C`` classes in the compiler's report
    (``cuda_build.ptxas_usage``); the staged kernel has an instantiation
    with the guard epilogue (``guarded``) and one without."""
    if plan.kernel == "unstaged":
        return "23unstaged_p_epoch_kernel"
    name = f"{plan.kernel}_p_epoch_kernel"
    symbol = f"{len(name)}{name}ILi{plan.classes}ELb{int(C in EXACT_CLASSES)}E"
    if plan.kernel == "staged":
        symbol += f"Lb{int(guarded)}E"
    return symbol


def bulk_rows(logits) -> bool:
    """Whether the staged and split kernels copy rows with
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
    ptrs = [ctypes.c_void_p] * 11
    floats = [ctypes.c_float] * 3
    for name, ints in (("staged", 7), ("split", 9), ("unstaged", 6)):
        fn = getattr(lib, f"p_epoch_launch_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ptrs + [ctypes.c_int] * ints + floats + [ctypes.c_void_p]
    for name, nargs in (("p_epoch_staged_smem_bytes", 3),
                        ("p_epoch_unstaged_smem_bytes", 3),
                        ("p_epoch_split_smem_bytes", 5)):
        getattr(lib, name).restype = ctypes.c_size_t
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    for name, nargs in (("p_epoch_staged_warps", 1),
                        ("p_epoch_instantiated_classes", 1),
                        ("p_epoch_split_slice", 2),
                        ("p_epoch_split_max_cluster", 0)):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
    return lib


@functools.lru_cache(maxsize=None)
def split_max_cluster(device_index: int) -> int:
    """The largest cluster the split kernel launches on card
    ``device_index``: 16 where the card schedules a 16-CTA cluster of the
    largest CTA, else 8 (``p_epoch_split_max_cluster``)."""
    with torch.cuda.device(device_index):
        return _library().p_epoch_split_max_cluster()


def _check_plan(lib, plan: PEpochPlan, B: int, J: int, C: int) -> None:
    """The plan's layout must be the kernel's: same shared memory, warps,
    instantiation and, split, slice."""
    if plan.kernel == "staged":
        got = (lib.p_epoch_staged_smem_bytes(B, J, C),
               lib.p_epoch_staged_warps(B),
               lib.p_epoch_instantiated_classes(C), 0)
    elif plan.kernel == "split":
        got = (lib.p_epoch_split_smem_bytes(B, J, C, plan.cluster,
                                            int(not plan.stream)),
               lib.p_epoch_staged_warps(B),
               lib.p_epoch_instantiated_classes(C),
               lib.p_epoch_split_slice(J, plan.cluster))
    else:
        got = (lib.p_epoch_unstaged_smem_bytes(B, J, C), UNSTAGED_WARPS, 0,
               0)
    if got != (plan.smem_bytes, plan.warps, plan.classes, plan.slice_width):
        raise RuntimeError(
            f"launch plan {plan} disagrees with csrc/p_epoch.cu "
            f"(bytes, warps, classes, slice = {got})")


def p_epoch(p, buf, cv, logits, y_val, positions, valid, lr, momentum, task,
            kernel=None, guard=None, guard_rounds=None):
    """One p-solver epoch; same contract as ``p_epoch_plain``. CPU
    tensors run the plain version; CUDA tensors launch the kernel of
    ``launch_plan`` from ``csrc/p_epoch.cu`` or raise where no plan takes
    the shape. ``guard`` (``aggregate.make_guard``) runs in the kernel's
    epilogue. ``kernel`` forces one of ``KERNELS`` (for measurement; a
    guard runs on a forced kernel too, where the JAX package refuses its
    pinned Pallas kernel with a guard). ``guard_rounds``, an int32 ``(2,)``
    CUDA tensor, receives the simplex's fixed-point rounds summed over the
    epoch's steps and in the step that took most."""
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
    plan = launch_plan(B, J, C, kernel=kernel, max_cluster=k_max)
    if plan is None:
        stream = min(split_smem_bytes(B, J, C, k, True)
                     for k in SPLIT_CLUSTERS if k <= k_max)
        raise ValueError(
            f"no p_epoch kernel takes B={B}, J={J}, C={C}: the staged and "
            f"split kernels need B <= {MAX_STAGED_BATCH}, C <= 32 and, "
            f"split, {stream} bytes of shared memory a CTA at a {k_max}-CTA "
            f"cluster; the unstaged kernel "
            f"{unstaged_smem_bytes(B, J, C)}; a block has "
            f"{cuda_build.SMEM_LIMIT}: run it with kernel_impl='plain'")
    lib = _library()
    _check_plan(lib, plan, B, J, C)
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
