"""The client update: local SGD of every client of a round, in parallel.

The port of the JAX package's ``fedcore/client.py`` for the flagship
bias-free linear model. Every client starts the round from the same
global parameters (the paper's parallel semantics, the JAX default) and
runs ``epochs`` shuffled epochs; each epoch of all J clients is one call
of ``epoch_kernel.client_epoch`` — on CUDA tensors one launch of the
hand-written kernel, on CPU tensors its plain PyTorch version.

Reference semantics kept exactly (SURVEY.md §2.3):
- the prox anchor is the client's round-incoming parameters for every
  local epoch (``tools.py:180``, ``pallas_kernel.py:55``);
- minibatches are a fresh shuffle each epoch, valid rows first, last
  partial batch kept; the shuffle positions are an input
  (``batching.epoch_batches``) so a caller can inject the JAX run's, or
  are drawn on the device one epoch at a time from a generator;
- the returned loss/accuracy are the LAST epoch's batch-size-weighted
  averages, with penalty terms included in the loss;
- plain SGD, constant lr within the call.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .batching import batch_counts, batch_valid, draw_epoch_positions
from .epoch_kernel import client_epoch, client_epoch_plain

# The largest gathered-batch buffer a plain version builds in one piece:
# a whole epoch's features (J, S, B, D) for the client epoch, a whole
# epoch's logits (S, B, J, C) for the p-solver. Above it the plain
# versions gather step by step. The CUDA kernels gather their rows
# themselves and never build such a buffer, so this bounds only the
# plain path (the CPU, and the reference runs on the card).
EPOCH_GATHER_BYTES_LIMIT = int(1.5e9)


def make_client_round(task: str, epochs: int, batch_size: int, n_max: int,
                      kernel_impl: str = "auto"):
    """Build the parallel client round for the linear model.

    Returns ``round_fn(params, X, y, idx (J, n_max), mask (J, n_max),
    positions, lr, mu, lam) -> (stacked {"w": (J, C, D)}, losses (J,),
    accs (J,))``. ``positions`` is either the injected per-client,
    per-epoch shuffles into the ``n_max`` slots, ``(J, epochs, S, B)``
    (``batching``; a tensor or array, on any device), or a
    ``torch.Generator`` on ``idx``'s device, from which each epoch's
    ``(J, S, B)`` is drawn just before that epoch runs
    (``batching.draw_epoch_positions``). Either way the rows and validity
    are gathered one epoch at a time, so a call of many epochs holds one
    epoch of indices on the device.

    ``kernel_impl``: ``"auto"`` goes through the ``client_epoch`` wrapper
    (the CUDA kernel for CUDA tensors, the plain version for CPU ones);
    ``"plain"`` calls the plain version directly, on any device — the
    reference a kernel run is held against (``cuda_build.kernel_or_plain``).
    """
    epoch_fn = cuda_build.kernel_or_plain(kernel_impl, client_epoch,
                                          client_epoch_plain)
    S, _ = batch_counts(n_max, batch_size)

    def round_fn(params, X, y, idx, mask, positions, lr, mu, lam):
        (key,) = params.keys()
        W0 = params[key]
        J = idx.shape[0]
        C, D = W0.shape
        drawn = isinstance(positions, torch.Generator)
        if not drawn:
            positions = torch.as_tensor(positions)
            want = (J, epochs, S, batch_size)
            if tuple(positions.shape) != want:
                raise ValueError(f"positions shape "
                                 f"{tuple(positions.shape)} != {want}")
        W = W0.expand(J, C, D).contiguous()
        met = None
        for e in range(epochs):
            pos = (draw_epoch_positions(positions, n_max, batch_size, mask,
                                        lead=(J,)) if drawn
                   else positions[:, e].to(idx.device, torch.int64))
            valid = batch_valid(pos, n_max, mask)
            rows = torch.gather(idx, 1, pos.reshape(J, -1))
            rows = rows.reshape(pos.shape).to(torch.int32)
            W, met = epoch_fn(W, W0, X, y, rows, valid, lr, mu, lam, task)
        total = torch.clamp(met[:, 2], min=1.0)
        return {key: W}, met[:, 0] / total, 100.0 * met[:, 1] / total

    return round_fn


def make_local_update(task: str, epochs: int, batch_size: int, n_max: int,
                      kernel_impl: str = "auto"):
    """The single-client view of ``make_client_round``.

    Returns ``local_update(params, X, y, idx (n_max,), mask (n_max,),
    positions, lr, mu, lam) -> (new_params, last_epoch_loss,
    last_epoch_acc)``; ``positions`` is ``(epochs, S, B)`` or a
    ``torch.Generator``, as in ``make_client_round``.
    """
    round_fn = make_client_round(task, epochs, batch_size, n_max,
                                 kernel_impl)

    def local_update(params, X, y, idx, mask, positions, lr, mu, lam):
        if not isinstance(positions, torch.Generator):
            positions = torch.as_tensor(positions)[None]
        stacked, losses, accs = round_fn(params, X, y, idx[None], mask[None],
                                         positions, lr, mu, lam)
        return ({k: v[0] for k, v in stacked.items()}, losses[0], accs[0])

    return local_update
