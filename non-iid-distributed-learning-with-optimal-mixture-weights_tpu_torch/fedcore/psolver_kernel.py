"""Kernel 2: one shuffled epoch of FedAMW's mixture-weight (p) SGD.

Replaces the JAX package's Pallas TPU kernel
``fedcore/pallas_psolver.py:_p_epoch_kernel`` (built by
``make_pallas_p_epoch``, wrapped by ``aggregate.py:_make_pallas_solve``).
The hand-written CUDA kernel is ``csrc/p_epoch.cu``: the steps are
serial, so one CTA runs the whole epoch with ``p``, its momentum buffer
and the client-validity mask in shared memory, gathering each step's
``(B, J, C)`` block of the pooled validation logits through
``positions``. One launch per p-epoch.

What bounds it on an H100: bytes, in principle — one read of the
``(n_val, J, C)`` logits per epoch against 4 flops per element — but
those logits fit in L2 and the epoch is S serial steps, each a few
block-wide barriers, so latency bounds it in practice. The design keeps
everything except the gathered rows on chip and stages each step's block
in shared memory with coalesced loads.

``p_epoch`` is the wrapper: CPU tensors go to ``p_epoch_plain``, the
plain PyTorch version; CUDA tensors launch the kernel or raise.
``p_epoch.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build


def p_epoch_plain(p, buf, cv, logits, y_val, positions, valid, lr, momentum,
                  task):
    """The epoch in plain PyTorch.

    ``p, buf, cv (J,)`` mixture weights, momentum buffer and client
    validity; ``logits (n_val, J, C)``; ``y_val (n_val,)`` int32 labels
    or float32 targets; ``positions, valid (S, B)``. Each step:
    ``z = einsum('bjc,j->bc')``, masked-mean CE/MSE, ``g = einsum(
    'bjc,bc->j') * cv``, ``buf = m*buf + g``, ``p -= lr*buf`` (optax /
    torch SGD momentum; no count guard). Returns ``(p, buf, metrics (3,))``
    with ``(sum loss*cnt, sum correct, sum cnt)``.

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


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("p_epoch")
    lib.p_epoch_launch.restype = ctypes.c_int
    lib.p_epoch_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.p_epoch_smem_bytes.restype = ctypes.c_size_t
    lib.p_epoch_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def p_epoch(p, buf, cv, logits, y_val, positions, valid, lr, momentum, task):
    """One p-solver epoch; same contract as ``p_epoch_plain``. CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/p_epoch.cu`` (one CTA) or raise."""
    _check(p, buf, cv, logits, y_val, positions, valid, task)
    if p.device.type == "cpu":
        return p_epoch_plain(p, buf, cv, logits, y_val, positions, valid,
                             lr, momentum, task)
    if p.device.type != "cuda":
        raise ValueError(f"p_epoch runs on cpu or cuda, not {p.device}")
    S, B = positions.shape
    _, J, C = logits.shape
    lib = _library()
    smem = lib.p_epoch_smem_bytes(B, J, C)
    if smem > cuda_build.SMEM_LIMIT:
        raise ValueError(
            f"p_epoch kernel needs {smem} bytes of shared memory for B={B}, "
            f"J={J}, C={C}; a block has {cuda_build.SMEM_LIMIT}")
    p_out = torch.empty_like(p)
    buf_out = torch.empty_like(buf)
    metrics = torch.empty(3, dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.p_epoch_launch(
        p.data_ptr(), buf.data_ptr(), cv.data_ptr(), logits.data_ptr(),
        y_val.data_ptr(), positions.data_ptr(), valid.data_ptr(),
        p_out.data_ptr(), buf_out.data_ptr(), metrics.data_ptr(),
        S, B, J, C, int(task == "classification"), float(lr),
        float(momentum), stream)
    cuda_build.check(err, "p_epoch launch", lib)
    p_epoch.launches += 1
    return p_out, buf_out, metrics


p_epoch.launches = 0
