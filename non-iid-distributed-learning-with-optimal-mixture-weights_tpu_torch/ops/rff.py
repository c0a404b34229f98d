"""Random Fourier Features (Gaussian kernel approximation).

Reference: ``functions/tools.py:15-31``. ``W ~ N(0, sigma)`` of shape
``(d, D)``, ``b ~ U(0, 2*pi)``, and the map
``phi(X) = cos(X W + b) / sqrt(D)``. The draw comes from a
``torch.Generator``; a caller that must reproduce another run's features
injects its ``(W, b)`` instead (``algorithms.prepare_setup(rff=...)``).
The ``(N, d) x (d, D)`` product is a plain ``torch.matmul``;
``rff_map_to`` stores the map narrow (``feature_dtype``), chunk by chunk.

``data_heterogeneity`` / ``heterogeneity_from_parts`` give the driver's
non-IIDness score (reference ``exp.py:66-76``, the JAX package's
``ops/rff.py:103-139``); their Gram products are plain matmuls too.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rff_params(generator: torch.Generator, d: int, D: int, sigma: float):
    """Sample the random projection on the generator's device. ``sigma``
    is the reference's ``kernel_par`` (std of the normal draw,
    ``tools.py:17``)."""
    W = sigma * torch.randn((d, D), generator=generator, dtype=torch.float32)
    b = torch.rand((1, D), generator=generator, dtype=torch.float32) * (
        2.0 * math.pi)
    return W, b


def rff_scale(D: int, device=None) -> torch.Tensor:
    """``sqrt(D)`` as the 0-d float32 tensor ``rff_map`` divides by."""
    scale = torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    return scale if device is None else scale.to(device)


def rff_map(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
            scale: torch.Tensor | None = None) -> torch.Tensor:
    """``phi(X) = cos(X W + b) / sqrt(D)``. ``scale`` is
    ``rff_scale(D, X.device)`` made once by a caller that maps many
    batches (the serving engine), so no call copies it to the card; the
    result is the same bits."""
    if scale is None:
        scale = rff_scale(W.shape[1], X.device)
    return torch.cos(X @ W + b) / scale


def rff_map_to(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype, chunk: int = 65536) -> torch.Tensor:
    """``rff_map`` stored in ``out_dtype`` (the JAX package's
    ``ops/rff.py:rff_map_to``): mapped in row chunks of ``chunk``, each
    written into the narrow result, so only one float32 chunk is live at a
    time and no float32 copy of the whole matrix is built."""
    n = X.shape[0]
    if n <= chunk:
        return rff_map(X, W, b).to(out_dtype)
    out = torch.empty((n, W.shape[1]), dtype=out_dtype, device=X.device)
    for lo in range(0, n, chunk):
        out[lo:lo + chunk] = rff_map(X[lo:lo + chunk], W, b)
    return out


def rff_map_sparse(X_sparse, W, b, chunk: int = 8192) -> np.ndarray:
    """RFF-map a scipy sparse matrix without densifying it (the JAX
    package's ``ops/rff.py:57-81``): ``X @ W`` collapses the input
    dimension, so the sparse product runs on the host in row chunks (CSR
    times dense) and only ``(chunk, D)`` feature blocks are built. ``W``
    and ``b`` are tensors or arrays. Returns a dense float32 numpy array,
    for ``prepare_setup`` with ``kernel_type='linear'`` (the features are
    already mapped)."""
    W_np = W.cpu().numpy() if isinstance(W, torch.Tensor) else np.asarray(W)
    b_np = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    D = W_np.shape[1]
    n = X_sparse.shape[0]
    out = np.empty((n, D), dtype=np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        proj = X_sparse[lo:hi] @ W_np
        out[lo:hi] = np.cos(proj + b_np, dtype=np.float32) / np.sqrt(
            np.float32(D))
    return out


def feature_mapping(X_train: torch.Tensor, X_test: torch.Tensor, draw,
                    kernel_par: float = 10.0, D: int = 200,
                    kernel_type: str = "gaussian"):
    """Map train and test through one RFF draw (reference
    ``tools.py:22-31``, the JAX package's ``ops/rff.py:84-100``); the
    identity for a non-Gaussian ``kernel_type``. ``draw`` is a
    ``torch.Generator`` (``rff_params`` draws ``(W, b)`` from it) or an
    injected ``(W, b)`` pair, where the JAX function takes a key.
    Returns ``(X_train_FM, X_test_FM, (W, b) | None)``."""
    if kernel_type != "gaussian":
        return X_train, X_test, None
    if isinstance(draw, torch.Generator):
        W, b = rff_params(draw, X_train.shape[-1], D, kernel_par)
    else:
        W, b = (torch.as_tensor(np.asarray(t), dtype=torch.float32)
                for t in draw)
    W, b = W.to(X_train.device), b.to(X_train.device)
    return rff_map(X_train, W, b), rff_map(X_test, W, b), (W, b)


@torch.no_grad()
def data_heterogeneity(X: torch.Tensor, idx: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Dataset-level non-IIDness score: ``sum_j (n_j/n) * ||C - C_j||_F``
    with ``C = X^T X / n`` the global second moment and ``C_j`` client
    j's, from packed client index sets ``idx``/``mask`` ``(J, n_max)``.

    One client at a time, so no ``(J, D, D)`` tensor is built. Returns
    a 0-d float32 tensor on ``X``'s device.
    """
    n = X.shape[0]
    C = X.T @ X / n
    total = torch.zeros((), dtype=torch.float32, device=X.device)
    for idx_j, mask_j in zip(idx, mask):
        Xj = X[idx_j] * mask_j[:, None]
        nj = mask_j.sum()
        Cj = Xj.T @ Xj / torch.clamp(nj, min=1.0)
        total = total + nj / n * torch.linalg.norm(C - Cj)
    return total


def heterogeneity_from_parts(X, parts) -> float:
    """``data_heterogeneity`` on FULL client partitions (ragged index
    arrays into the rows of ``X``), as the reference computes it before
    the 80/20 validation split (``exp.py:66-76`` precedes ``:80-99``), so
    the weights ``n_j/n`` sum to 1 over all rows. ``X`` is a tensor (the
    score is computed on its device) or an array."""
    X = torch.as_tensor(X, dtype=torch.float32)
    n_max = max(len(p) for p in parts)
    idx = np.zeros((len(parts), n_max), np.int64)
    mask = np.zeros((len(parts), n_max), np.float32)
    for j, p in enumerate(parts):
        idx[j, : len(p)] = np.asarray(p)
        mask[j, : len(p)] = 1.0
    return float(data_heterogeneity(X, torch.from_numpy(idx).to(X.device),
                                    torch.from_numpy(mask).to(X.device)))
