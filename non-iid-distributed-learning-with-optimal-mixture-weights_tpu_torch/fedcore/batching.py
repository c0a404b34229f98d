"""Shared minibatch machinery for shuffled epochs.

Both the client update and the mixture-weight solver iterate
"shuffle -> fixed-count batches -> batch-size-weighted epoch metrics"
(torch ``DataLoader(shuffle=True)`` semantics with the last partial batch
kept, reference ``tools.py:178-179`` / ``exp.py:99``).

The shuffle order is an input: ``epoch_batches`` draws it from a
``torch.Generator``, or takes injected ``positions`` (for instance the
ones the JAX package drew), and ``batch_valid`` derives the validity
mask from the positions alone, so both routes give the same batches.
"""

from __future__ import annotations

import math

import torch


def batch_counts(n: int, batch_size: int) -> tuple[int, int]:
    """(num_batches, pad) for n samples in batches of batch_size."""
    num_batches = max(1, math.ceil(n / batch_size))
    return num_batches, num_batches * batch_size - n


def batch_valid(positions: torch.Tensor, n: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Validity of the slots of ``positions (..., S, B)``.

    Slot ``k`` of the flattened ``(S*B,)`` epoch is padding when
    ``k >= n``; otherwise it is valid when the sample it points at is
    (``mask``, ``(n,)`` or one row per leading index, e.g. ``(J, n)``
    for ``positions (J, E, S, B)``). Float32 0/1.
    """
    S, B = positions.shape[-2:]
    in_range = (torch.arange(S * B, device=positions.device) < n).reshape(S, B)
    valid = in_range.to(torch.float32).expand(positions.shape)
    if mask is None:
        return valid.contiguous()
    lead = mask.shape[:-1]
    flat = positions.reshape(*lead, -1)
    picked = torch.gather(mask, -1, flat).reshape(positions.shape)
    return (picked * valid).contiguous()


def epoch_batches(
    n: int,
    batch_size: int,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    positions: torch.Tensor | None = None,
):
    """One shuffled epoch as static-shape batches.

    Returns ``(positions, valid)`` of shape ``(num_batches, batch_size)``:
    ``positions`` index into the 0..n-1 sample axis (real samples in
    random order first, padding after), ``valid`` flags which slots hold
    real samples. With a ``mask``, masked-out rows sort to the back and
    are never valid. ``positions`` given: used as they are (same
    layout); otherwise drawn from ``generator`` on its device and moved
    to the mask's.
    """
    num_batches, pad = batch_counts(n, batch_size)
    if positions is None:
        if mask is None:
            perm = torch.randperm(n, generator=generator)
        else:
            r = torch.rand(n, generator=generator, dtype=torch.float32)
            key = r + (1.0 - mask.to(r.device)) * 2.0
            perm = torch.argsort(key, stable=True)
        perm = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype)])
        positions = perm.reshape(num_batches, batch_size)
        if mask is not None:
            positions = positions.to(mask.device)
    if tuple(positions.shape) != (num_batches, batch_size):
        raise ValueError(
            f"positions shape {tuple(positions.shape)} != "
            f"{(num_batches, batch_size)} for n={n}, batch={batch_size}")
    positions = positions.long()
    return positions, batch_valid(positions, n, mask)


def weighted_epoch_metrics(losses, corrects, cnts):
    """Meter-style epoch averages: per-batch values weighted by batch
    valid-counts (reference ``tools.py:212-213``). Returns
    ``(avg_loss, acc_percent)``."""
    total = torch.clamp(torch.sum(cnts), min=1.0)
    return torch.sum(losses) / total, 100.0 * torch.sum(corrects) / total
