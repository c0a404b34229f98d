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

Shapes it cannot take (two stages of rows plus ``h`` beyond shared
memory, ``B > 512`` or ``C > 32``) run the unstaged kernel, the port's
first design (one CTA of 256 threads, five barriers per step).
``launch_plan`` picks the kernel by shape alone.

``p_epoch`` is the wrapper: CPU tensors go to ``p_epoch_plain``, the
plain PyTorch version; CUDA tensors launch the kernel the plan names or
raise. Two cases are refused on the card, before any launch: a shape no
plan takes (ROADMAP.md queue 2 item 3, a J split across a cluster, would
take it), and a guarded epoch (``guard``, the p-guards of
``aggregate.py``: the kernels run the reference's unconstrained update,
as the JAX package's Pallas kernel does; queue 2 item 5). Both run on the
card through ``kernel_impl="plain"``. ``p_epoch.launches`` counts kernel
launches, ``p_epoch.launches_by_kernel`` the same by kernel.
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
KERNELS = ("staged", "unstaged")


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
    when they fit ``client.EPOCH_GATHER_BYTES_LIMIT``, else per step.
    """
    from .client import EPOCH_GATHER_BYTES_LIMIT

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
    """Warps of the staged kernel's CTA: one per row, at most 16."""
    return min(B, MAX_WARPS)


def staged_smem_bytes(B: int, J: int, C: int) -> int:
    """Shared memory of the staged kernel (``staged_smem_bytes`` in
    ``p_epoch.cu``): two mbarriers per warp, two stages of ``B`` rows of
    ``J*C`` floats each padded to 4, ``h (B, J)``, ``p``, ``buf``, ``cv``
    and the per-warp metric sums."""
    nw, jcp = staged_warps(B), -(-J * C // 4) * 4
    return 16 * nw + 4 * (2 * B * jcp + B * J + 3 * J + 2 * nw)


def unstaged_smem_bytes(B: int, J: int, C: int) -> int:
    """Shared memory of the unstaged kernel: the step's ``(B, J, C)``
    block, ``p``, ``buf``, ``cv``, the logits and per-row scratch."""
    return 4 * (B * J * C + 3 * J + B * C + 3 * B) + 4 * B


@dataclasses.dataclass(frozen=True)
class PEpochPlan:
    """How one launch runs: ``kernel`` ``"staged"`` or ``"unstaged"``,
    the ``warps`` of its one CTA, the instantiated ``classes`` (0 for
    the unstaged kernel, which takes C at run time) and its dynamic
    ``smem_bytes``."""

    kernel: str
    warps: int
    classes: int
    smem_bytes: int


def launch_plan(B: int, J: int, C: int, kernel: str | None = None,
                smem_limit: int = cuda_build.SMEM_LIMIT) -> PEpochPlan | None:
    """The kernel for batch ``B``, ``J`` clients and ``C`` classes, by
    shape alone: the staged kernel when ``B <= 512``, ``C <= 32`` and
    its two stages plus ``h`` fit a block's shared memory
    (``smem_limit``); else the unstaged kernel when its step block fits;
    else None (no kernel takes the shape). ``kernel`` forces one of
    ``KERNELS``, and ``ValueError`` says when it does not fit."""
    if B < 1 or J < 1 or C < 1:
        raise ValueError(f"bad shape B={B}, J={J}, C={C}")
    if kernel not in (None,) + KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    fits = {}
    nc = staged_classes(C)
    smem = staged_smem_bytes(B, J, C)
    if B <= MAX_STAGED_BATCH and nc and smem <= smem_limit:
        fits["staged"] = PEpochPlan("staged", staged_warps(B), nc, smem)
    smem = unstaged_smem_bytes(B, J, C)
    if smem <= smem_limit:
        fits["unstaged"] = PEpochPlan("unstaged", UNSTAGED_WARPS, 0, smem)
    if kernel is not None:
        if kernel not in fits:
            raise ValueError(f"the {kernel} p_epoch kernel does not fit "
                             f"B={B}, J={J}, C={C}; these do: {list(fits)}")
        return fits[kernel]
    return next(iter(fits.values()), None)


def kernel_symbol(plan: PEpochPlan, C: int) -> str:
    """The part of the mangled name that picks out the kernel ``plan``
    runs for ``C`` classes in the compiler's report
    (``cuda_build.ptxas_usage``)."""
    if plan.kernel == "staged":
        return (f"21staged_p_epoch_kernelILi{plan.classes}ELb"
                f"{int(C in EXACT_CLASSES)}E")
    return "23unstaged_p_epoch_kernel"


def bulk_rows(logits) -> bool:
    """Whether the staged kernel copies rows with ``cp.async.bulk``: a
    row's ``J*C`` floats a multiple of 16 bytes and the logits 16-byte
    aligned; else it copies them element-wise with ``cp.async``."""
    _, J, C = logits.shape
    return (J * C) % 4 == 0 and logits.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("p_epoch")
    lib.p_epoch_launch_staged.restype = ctypes.c_int
    lib.p_epoch_launch_staged.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.p_epoch_launch_unstaged.restype = ctypes.c_int
    lib.p_epoch_launch_unstaged.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    for name in ("p_epoch_staged_smem_bytes", "p_epoch_unstaged_smem_bytes"):
        getattr(lib, name).restype = ctypes.c_size_t
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
    for name in ("p_epoch_staged_warps", "p_epoch_instantiated_classes"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int]
    return lib


def _check_plan(lib, plan: PEpochPlan, B: int, J: int, C: int) -> None:
    """The plan's layout must be the kernel's: same shared memory, warps
    and instantiation."""
    if plan.kernel == "staged":
        got = (lib.p_epoch_staged_smem_bytes(B, J, C),
               lib.p_epoch_staged_warps(B),
               lib.p_epoch_instantiated_classes(C))
    else:
        got = (lib.p_epoch_unstaged_smem_bytes(B, J, C), UNSTAGED_WARPS, 0)
    if got != (plan.smem_bytes, plan.warps, plan.classes):
        raise RuntimeError(
            f"launch plan {plan} disagrees with csrc/p_epoch.cu "
            f"(bytes, warps, classes = {got})")


def p_epoch(p, buf, cv, logits, y_val, positions, valid, lr, momentum, task,
            kernel=None, guard=None):
    """One p-solver epoch; same contract as ``p_epoch_plain``. CPU
    tensors run the plain version; CUDA tensors launch the kernel of
    ``launch_plan`` from ``csrc/p_epoch.cu`` (one CTA) or raise: a shape
    no plan takes and a ``guard`` are refused there. ``kernel`` forces
    ``"staged"`` or ``"unstaged"`` (for measurement); a forced kernel
    with a guard is refused on every device, as the JAX package refuses
    its pinned Pallas kernel with an active p-guard."""
    _check(p, buf, cv, logits, y_val, positions, valid, task)
    if guard is not None and (kernel is not None or p.device.type == "cuda"):
        raise ValueError(
            "the p_epoch kernel cannot run with an active p_guard (it "
            "implements the reference's unconstrained update; a guard "
            "inside kernel 2 is ROADMAP.md queue 2 item 5): run the guarded "
            "solve with kernel_impl='plain'")
    if p.device.type == "cpu":
        return p_epoch_plain(p, buf, cv, logits, y_val, positions, valid,
                             lr, momentum, task, guard)
    if p.device.type != "cuda":
        raise ValueError(f"p_epoch runs on cpu or cuda, not {p.device}")
    S, B = positions.shape
    _, J, C = logits.shape
    plan = launch_plan(B, J, C, kernel=kernel)
    if plan is None:
        raise ValueError(
            f"p_epoch kernels need {staged_smem_bytes(B, J, C)} (staged) or "
            f"{unstaged_smem_bytes(B, J, C)} (unstaged) bytes of shared "
            f"memory for B={B}, J={J}, C={C}; a block has "
            f"{cuda_build.SMEM_LIMIT} (a J split across a cluster is "
            "ROADMAP.md queue 2 item 3): run it with kernel_impl='plain'")
    lib = _library()
    _check_plan(lib, plan, B, J, C)
    p_out = torch.empty_like(p)
    buf_out = torch.empty_like(buf)
    metrics = torch.empty(3, dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    ptrs = (p.data_ptr(), buf.data_ptr(), cv.data_ptr(), logits.data_ptr(),
            y_val.data_ptr(), positions.data_ptr(), valid.data_ptr(),
            p_out.data_ptr(), buf_out.data_ptr(), metrics.data_ptr())
    is_cls = int(task == "classification")
    if plan.kernel == "staged":
        err = lib.p_epoch_launch_staged(
            *ptrs, S, B, J, C, is_cls, int(bulk_rows(logits)), float(lr),
            float(momentum), stream)
    else:
        err = lib.p_epoch_launch_unstaged(
            *ptrs, S, B, J, C, is_cls, float(lr), float(momentum), stream)
    cuda_build.check(err, "p_epoch launch", lib)
    p_epoch.launches += 1
    p_epoch.launches_by_kernel[plan.kernel] += 1
    return p_out, buf_out, metrics


def reset_counts() -> None:
    """Set ``p_epoch``'s launch counts to 0."""
    p_epoch.launches = 0
    p_epoch.launches_by_kernel = dict.fromkeys(KERNELS, 0)


reset_counts()
