"""The client update: local SGD of every client of a round.

The port of the JAX package's ``fedcore/client.py`` for the flagship
bias-free linear model. By default every client starts the round from
the same global parameters (the paper's parallel semantics, the JAX
default) and runs ``epochs`` shuffled epochs; each epoch of all J
clients is one call of ``epoch_kernel.client_epoch`` — on CUDA tensors
one launch of the hand-written kernel, on CPU tensors its plain PyTorch
version. ``sequential=True`` is the reference's contamination chain
(``tools.py:341``): client j+1 starts from client j's final weights, so
each epoch of each client is its own J = 1 call, in client order.
``make_bucketed_round`` runs size-bucketed packs, one call per bucket
per epoch at that bucket's own padded size.

Reference semantics kept exactly (SURVEY.md §2.3):
- the prox anchor is the weights the client received for every local
  epoch (``tools.py:180``, ``pallas_kernel.py:55``): the round's global
  weights, or under ``sequential`` the previous client's;
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


def _epoch_rows(pos, idx, mask, n_max):
    """The global row ids (int32) and validity of one epoch's positions
    ``(J, S, B)`` into the clients' ``(J, n_max)`` index sets."""
    J = idx.shape[0]
    valid = batch_valid(pos, n_max, mask)
    rows = torch.gather(idx, 1, pos.reshape(J, -1))
    return rows.reshape(pos.shape).to(torch.int32), valid


def make_client_round(task: str, epochs: int, batch_size: int, n_max: int,
                      kernel_impl: str = "auto", sequential: bool = False,
                      client_block: tuple | None = None):
    """Build the client round for the linear model.

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

    ``sequential=True`` chains the clients in order: client j starts
    from, and is anchored at, client j-1's final weights (the first at
    the round's), and each of its epochs is one J = 1 call. Drawn
    shuffles then come client by client, epoch by epoch, each a ``(1, S,
    B)`` draw; injected ones keep the ``(J, epochs, S, B)`` layout.

    ``client_block=(lo, hi, J)``: the round runs clients ``[lo, hi)`` of a
    ``J``-client axis (a rank's block, ``parallel.client_spec``), and a
    drawn epoch draws the keys of all ``J`` clients and keeps rows
    ``[lo, hi)``, so each client gets the shuffle of the single-process
    draw (the parallel clients only: the sequential chain draws client
    by client, and a round split over ranks refuses it). The JAX
    package's ``shard_factor`` has no counterpart: it
    divides the traced global J for the gather-buffer check, while here a
    rank's round sees only its own clients, so the plain path's buffer
    (``EPOCH_GATHER_BYTES_LIMIT``) is already sized per rank and the
    kernels gather their rows themselves.
    """
    epoch_fn = cuda_build.kernel_or_plain(kernel_impl, client_epoch,
                                          client_epoch_plain)
    S, _ = batch_counts(n_max, batch_size)

    def epoch_positions(positions, mask, e):
        if isinstance(positions, torch.Generator):
            if client_block is not None and not sequential:
                lo, hi, whole = client_block
                return draw_epoch_positions(positions, n_max, batch_size,
                                            mask, lead=(whole,),
                                            rows=slice(lo, hi))
            return draw_epoch_positions(positions, n_max, batch_size, mask,
                                        lead=(mask.shape[0],))
        return positions[:, e].to(mask.device, torch.int64)

    def run_clients(W, anchor, X, y, idx, mask, positions, lr, mu, lam):
        met = None
        for e in range(epochs):
            pos = epoch_positions(positions, mask, e)
            rows, valid = _epoch_rows(pos, idx, mask, n_max)
            W, met = epoch_fn(W, anchor, X, y, rows, valid, lr, mu, lam, task)
        return W, met

    def round_fn(params, X, y, idx, mask, positions, lr, mu, lam):
        (key,) = params.keys()
        W0 = params[key]
        J = idx.shape[0]
        C, D = W0.shape
        if not isinstance(positions, torch.Generator):
            positions = torch.as_tensor(positions)
            want = (J, epochs, S, batch_size)
            if tuple(positions.shape) != want:
                raise ValueError(f"positions shape "
                                 f"{tuple(positions.shape)} != {want}")
        if not sequential:
            W, met = run_clients(W0.expand(J, C, D).contiguous(), W0, X, y,
                                 idx, mask, positions, lr, mu, lam)
        else:
            Ws, mets, carry = [], [], W0.contiguous()
            for j in range(J):
                pos_j = (positions if isinstance(positions, torch.Generator)
                         else positions[j:j + 1])
                Wj, met_j = run_clients(carry[None], carry, X, y,
                                        idx[j:j + 1], mask[j:j + 1], pos_j,
                                        lr, mu, lam)
                Ws.append(Wj)
                mets.append(met_j)
                carry = Wj[0]
            W, met = torch.cat(Ws), torch.cat(mets)
        total = torch.clamp(met[:, 2], min=1.0)
        return {key: W}, met[:, 0] / total, 100.0 * met[:, 1] / total

    return round_fn


def make_bucketed_round(task: str, epochs: int, batch_size: int,
                        n_maxes: tuple, sequential: bool = False,
                        kernel_impl: str = "auto",
                        client_blocks: tuple | None = None):
    """The client round over size-bucketed packs
    (``data.pack.bucket_partitions``; JAX ``client.py:267-325``).

    Returns ``round_fn(params, X, y, idx_tuple, mask_tuple, positions,
    lr, mu, lam)`` with the outputs of ``make_client_round`` concatenated
    in bucket order. Each bucket runs at its own ``n_max``, so its epochs
    are calls at its own step count. ``positions`` is a
    ``torch.Generator`` (each bucket draws from it in turn) or one
    injected array per bucket, ``(J_g, epochs, S_g, B)``; with a single
    bucket a bare array is taken too. ``sequential`` chains across
    buckets as well: bucket g+1's first client starts from bucket g's
    last client's weights. ``client_blocks`` (one ``client_block`` per
    bucket, ``parallel.ClientAxis.blocks``) runs a rank's block of each.
    """
    blocks = client_blocks or (None,) * len(n_maxes)
    fns = [make_client_round(task, epochs, batch_size, m, kernel_impl,
                             sequential, b) for m, b in zip(n_maxes, blocks)]

    def round_fn(params, X, y, idx_tuple, mask_tuple, positions, lr, mu,
                 lam):
        drawn = isinstance(positions, torch.Generator)
        if not drawn and len(fns) == 1 and not isinstance(positions,
                                                          (list, tuple)):
            positions = (positions,)
        if not drawn and len(positions) != len(fns):
            raise ValueError(f"{len(positions)} position arrays for "
                             f"{len(fns)} buckets")
        outs, carry = [], params
        for g, (fn, idx_g, mask_g) in enumerate(zip(fns, idx_tuple,
                                                    mask_tuple)):
            out = fn(carry, X, y, idx_g, mask_g,
                     positions if drawn else positions[g], lr, mu, lam)
            outs.append(out)
            if sequential:
                carry = {k: v[-1] for k, v in out[0].items()}
        if len(outs) == 1:
            return outs[0]
        stacked = {k: torch.cat([o[0][k] for o in outs]) for k in params}
        return (stacked, torch.cat([o[1] for o in outs]),
                torch.cat([o[2] for o in outs]))

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
