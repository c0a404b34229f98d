"""Random Fourier Features (Gaussian kernel approximation).

Reference: ``functions/tools.py:15-31``. ``W ~ N(0, sigma)`` of shape
``(d, D)``, ``b ~ U(0, 2*pi)``, and the map
``phi(X) = cos(X W + b) / sqrt(D)``. The draw comes from a
``torch.Generator``; a caller that must reproduce another run's features
injects its ``(W, b)`` instead (``algorithms.prepare_setup(rff=...)``).
The ``(N, d) x (d, D)`` product is a plain ``torch.matmul``.
"""

from __future__ import annotations

import math

import torch


def rff_params(generator: torch.Generator, d: int, D: int, sigma: float):
    """Sample the random projection on the generator's device. ``sigma``
    is the reference's ``kernel_par`` (std of the normal draw,
    ``tools.py:17``)."""
    W = sigma * torch.randn((d, D), generator=generator, dtype=torch.float32)
    b = torch.rand((1, D), generator=generator, dtype=torch.float32) * (
        2.0 * math.pi)
    return W, b


def rff_map(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``phi(X) = cos(X W + b) / sqrt(D)``."""
    D = W.shape[1]
    scale = torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    return torch.cos(X @ W + b) / scale.to(X.device)
