"""Kernel 1: one local-SGD epoch of every client, bias-free linear model.

Replaces the JAX package's Pallas TPU kernel
``fedcore/pallas_kernel.py:_epoch_kernel`` (built by
``make_pallas_epoch``). The hand-written CUDA kernel is
``csrc/client_epoch.cu``: one CTA per client, one launch per local epoch
for all J clients, the client's ``(C, D)`` weights and the round's prox
anchor resident in shared memory while the CTA loops over the S batch
steps and gathers its own rows of ``X`` through ``rows``.

What bounds it on an H100: the gathered feature rows (bytes) — about
``4 C`` fp32 flops per feature element read, far below the card's fp32
ridge — and, in practice, the serial dependence of one client's steps
(one CTA per client, J of 132 SMs busy). The design keeps W, the anchor
and every per-step intermediate on chip and skips padded rows and empty
steps, so device memory sees only the valid rows' features.

``client_epoch`` is the wrapper: CPU tensors go to ``client_epoch_plain``,
the plain PyTorch version of the same function; CUDA tensors launch the
kernel or raise. ``client_epoch.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build


def client_epoch_plain(W, anchor, X, y, rows, valid, lr, mu, lam, task):
    """The epoch in plain PyTorch, batched over the client axis.

    ``W (J, C, D)`` epoch-start weights, ``anchor (C, D)`` the
    round-incoming weights (the prox anchor of every local epoch,
    ``pallas_kernel.py:55``), ``X (N, D)``, ``y (N,)`` int32 labels or
    float32 targets, ``rows (J, S, B)`` global row ids, ``valid (J, S, B)``
    0/1. Returns ``(W (J, C, D), metrics (J, 3))`` with metrics
    ``(sum loss*cnt, sum correct, sum cnt)`` over the epoch's steps.

    The whole epoch's gathered features ``(J, S, B, D)`` are built in one
    index op when they fit ``client.EPOCH_GATHER_BYTES_LIMIT``, else one
    step's ``(J, B, D)`` at a time.
    """
    from .client import EPOCH_GATHER_BYTES_LIMIT

    J, S, B = rows.shape
    C, D = anchor.shape
    cls = task == "classification"
    rows = rows.long()
    whole = J * S * B * D * X.element_size() <= EPOCH_GATHER_BYTES_LIMIT
    xs = X[rows] if whole else None
    ys = y[rows]
    lr, mu, lam = (torch.tensor(v, dtype=torch.float32, device=W.device)
                   for v in (lr, mu, lam))
    met = torch.zeros((J, 3), dtype=torch.float32, device=W.device)
    for s in range(S):
        xb = xs[:, s] if whole else X[rows[:, s]]           # (J, B, D)
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
        "X": (X, torch.float32, (X.shape[0], D)),
        "y": (y, torch.int32 if task == "classification" else torch.float32,
              (X.shape[0],)),
        "rows": (rows, torch.int32, (J,) + tuple(rows.shape[1:])),
        "valid": (valid, torch.float32, tuple(rows.shape)),
    }
    if W.dtype != torch.float32 or not W.is_contiguous():
        raise ValueError("W must be a contiguous float32 (J, C, D) tensor")
    if rows.dim() != 3:
        raise ValueError(f"rows must be (J, S, B), got {tuple(rows.shape)}")
    for name, (t, dtype, shape) in expect.items():
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device}, W on {W.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("client_epoch")
    lib.client_epoch_launch.restype = ctypes.c_int
    lib.client_epoch_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.client_epoch_smem_bytes.restype = ctypes.c_size_t
    lib.client_epoch_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.client_epoch_max_classes.restype = ctypes.c_int
    return lib


def client_epoch(W, anchor, X, y, rows, valid, lr, mu, lam, task):
    """One local epoch of all J clients; same contract as
    ``client_epoch_plain``. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/client_epoch.cu`` (one CTA per client) or
    raise."""
    _check(W, anchor, X, y, rows, valid, task)
    if W.device.type == "cpu":
        return client_epoch_plain(W, anchor, X, y, rows, valid, lr, mu, lam,
                                  task)
    if W.device.type != "cuda":
        raise ValueError(f"client_epoch runs on cpu or cuda, not {W.device}")
    J, C, D = W.shape
    S, B = rows.shape[1:]
    lib = _library()
    if C > lib.client_epoch_max_classes():
        raise ValueError(f"client_epoch kernel takes at most "
                         f"{lib.client_epoch_max_classes()} classes, got {C}")
    smem = lib.client_epoch_smem_bytes(B, C, D)
    if smem > cuda_build.SMEM_LIMIT:
        raise ValueError(
            f"client_epoch kernel needs {smem} bytes of shared memory for "
            f"C={C}, D={D}, B={B}; a block has {cuda_build.SMEM_LIMIT}")
    W_out = torch.empty_like(W)
    metrics = torch.zeros((J, 3), dtype=torch.float32, device=W.device)
    if J == 0:
        return W_out, metrics
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = lib.client_epoch_launch(
        W.data_ptr(), anchor.data_ptr(), X.data_ptr(), y.data_ptr(),
        rows.data_ptr(), valid.data_ptr(), W_out.data_ptr(),
        metrics.data_ptr(), J, S, B, C, D,
        int(task == "classification"), float(lr), float(mu), float(lam),
        stream)
    cuda_build.check(err, "client_epoch launch", lib)
    client_epoch.launches += 1
    return W_out, metrics


client_epoch.launches = 0
