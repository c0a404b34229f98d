"""The client update: local SGD of every client of a round.

The port of the JAX package's ``fedcore/client.py``. By default every
client starts the round from the same global parameters (the paper's
parallel semantics, the JAX default) and runs ``epochs`` shuffled
epochs, all J clients of an epoch in one call. The call's route is
chosen from the parameters' structure, by the JAX package's own rule
(``_pallas_compatible``, ``client.py:96-104``):

- the **kernel route** (``route.kernel_route``: a flat dict holding one 2-D
  matrix, the bias-free linear model): each epoch is one call of
  ``epoch_kernel.client_epoch``, on CUDA tensors one launch of the
  hand-written kernel, on CPU tensors its plain PyTorch version; its
  gradient is derived by hand and is exact for that structure only;
- the **autograd route** (every other model of the zoo, ``models/``):
  each SGD step of all J clients is one vectorised call of
  ``torch.func.vmap(torch.func.grad_and_value(training_loss))`` over the
  stacked parameter dict, the JAX package's ``vmap(value_and_grad)``.
  The JAX package trains these models with autodiff too, never with its
  Pallas kernel, so this route replaces no kernel.

``sequential=True`` is the reference's contamination chain
(``tools.py:341``): client j+1 starts from client j's final weights, so
each epoch of each client is its own J = 1 call, in client order.
``make_bucketed_round`` runs size-bucketed packs, one call per bucket
per epoch at that bucket's own padded size.

Reference semantics kept exactly on both routes (SURVEY.md §2.3):
- the prox anchor is the weights the client received for every local
  epoch (``tools.py:180``, ``pallas_kernel.py:55``): the round's global
  weights, or under ``sequential`` the previous client's;
- minibatches are a fresh shuffle each epoch, valid rows first, last
  partial batch kept; the shuffle positions are an input
  (``batching.epoch_batches``) so a caller can inject the JAX run's, or
  are drawn on the device one epoch at a time from a generator;
- a step whose batch holds no valid row leaves the weights as they are;
- the returned loss/accuracy are the LAST epoch's batch-size-weighted
  averages, with penalty terms included in the loss; top-1 takes the
  first maximal class;
- plain SGD, constant lr within the call.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import cuda_build, route
from .aggregate import full_fp32
from .batching import batch_counts, batch_valid, draw_epoch_positions
from .epoch_kernel import client_epoch, client_epoch_plain
from .faults import _bcast

def _epoch_rows(pos, idx, mask, n_max):
    """The global row ids (int32) and validity of one epoch's positions
    ``(J, S, B)`` into the clients' ``(J, n_max)`` index sets."""
    J = idx.shape[0]
    valid = batch_valid(pos, n_max, mask)
    rows = torch.gather(idx, 1, pos.reshape(J, -1))
    return rows.reshape(pos.shape).to(torch.int32), valid


def make_autograd_epoch(apply_fn: Callable, task: str):
    """One local epoch of every client of a call by autograd, for any
    model of the zoo.

    Returns ``epoch(P, anchor, X, y, rows, valid, lr, mu, lam) -> (P,
    metrics (J, 3))``: ``P`` the stacked ``{name: (J, ...)}`` weights at
    the epoch's start, ``anchor`` the unstacked weights the clients
    received (the prox anchor), ``rows``/``valid`` ``(J, S, B)`` as
    ``client_epoch`` takes them, metrics ``(sum loss*cnt, sum correct,
    sum cnt)`` over the steps. Each step is one call of ``vmap(grad_and_
    value(training_loss))`` over the J clients (JAX ``client.py:182-204``):
    ``w -= lr * ok * g`` with ``ok = cnt > 0``, the ridge term on the
    leaves of ndim >= 2 only, the norms' zero subgradient at 0
    (``ops.losses.l2_norm_safe``).

    The whole epoch's gathered rows ``(J, S, B, D)``, in X's dtype, are
    built in one index op when they fit ``route.EPOCH_GATHER_BYTES_LIMIT``,
    else one step's ``(J, B, D)`` at a time; the answer is the same.

    Under ``vmap`` a convolution whose weights carry the client axis
    (``models/conv.py``) runs as one grouped convolution with J groups,
    forward and backward, in place of J convolutions. Each step runs in
    full fp32 (``aggregate.full_fp32``: no TF32 convolutions on the card,
    cuDNN's deterministic algorithms), the arithmetic of the JAX
    package's float32 reference, the same bits on a rerun.
    """
    from ..ops.losses import training_loss
    from ..ops.metrics import top1_correct

    cls = task == "classification"

    def objective(p, anchor, xb, yb, bv, mu, lam):
        return training_loss(p, anchor, apply_fn, xb, yb, bv, task, mu, lam)

    step = torch.func.vmap(
        torch.func.grad_and_value(objective, has_aux=True),
        in_dims=(0, None, 0, 0, 0, None, None))

    def epoch(P, anchor, X, y, rows, valid, lr, mu, lam):
        J, S, B = rows.shape
        rows = rows.long()
        whole = (J * S * B * X.shape[1] * X.element_size()
                 <= route.EPOCH_GATHER_BYTES_LIMIT)
        xs = X[rows] if whole else None
        ys = y[rows]
        met = torch.zeros((J, 3), dtype=torch.float32, device=X.device)
        for s in range(S):
            xb = xs[:, s] if whole else X[rows[:, s]]
            yb, bv = ys[:, s], valid[:, s]
            with full_fp32():
                grads, (loss, (preds, cnt)) = step(P, anchor, xb, yb, bv,
                                                   mu, lam)
            step_lr = lr * (cnt > 0).to(torch.float32)
            P = {k: w - _bcast(step_lr, w.dim()) * grads[k]
                 for k, w in P.items()}
            correct = (torch.sum(top1_correct(preds, yb) * bv, dim=1) if cls
                       else torch.zeros_like(cnt))
            met = met + torch.stack([loss * cnt, correct, cnt], dim=1)
        return P, met

    return epoch


def make_client_round(task: str, epochs: int, batch_size: int, n_max: int,
                      kernel_impl: str = "auto", sequential: bool = False,
                      client_block: tuple | None = None,
                      apply_fn: Callable | None = None):
    """Build the client round (JAX ``client.py:327-386``).

    Returns ``round_fn(params, X, y, idx (J, n_max), mask (J, n_max),
    positions, lr, mu, lam) -> (stacked {name: (J, ...)}, losses (J,),
    accs (J,))``. ``positions`` is either the injected per-client,
    per-epoch shuffles into the ``n_max`` slots, ``(J, epochs, S, B)``
    (``batching``; a tensor or array, on any device), or a
    ``torch.Generator`` on ``idx``'s device, from which each epoch's
    ``(J, S, B)`` is drawn just before that epoch runs
    (``batching.draw_epoch_positions``). Either way the rows and validity
    are gathered one epoch at a time, so a call of many epochs holds one
    epoch of indices on the device.

    ``apply_fn`` is the model's apply (None: the linear model's). The
    route is chosen from ``params`` at each call (``route.kernel_route``): the
    linear model's structure takes the kernel route, any other the
    autograd route (``make_autograd_epoch``) over ``apply_fn``. Both take
    the same positions, ``sequential`` and ``client_block``.

    ``kernel_impl``: ``"auto"`` goes through the ``client_epoch`` wrapper
    (the CUDA kernel for CUDA tensors, the plain version for CPU ones);
    ``"plain"`` calls the plain version directly, on any device — the
    reference a kernel run is held against (``cuda_build.kernel_or_plain``).
    The autograd route has no kernel and ignores it.

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
    (``route.EPOCH_GATHER_BYTES_LIMIT``) is already sized per rank and the
    kernels gather their rows themselves.
    """
    epoch_fn = cuda_build.kernel_or_plain(kernel_impl, client_epoch,
                                          client_epoch_plain)
    if apply_fn is None:
        from ..models.linear import linear_model

        apply_fn = linear_model().apply
    autograd_epoch = make_autograd_epoch(apply_fn, task)
    S, _ = batch_counts(n_max, batch_size)

    def kernel_epoch(P, anchor, X, y, rows, valid, lr, mu, lam):
        (key,) = P
        W, met = epoch_fn(P[key], anchor[key], X, y, rows, valid, lr, mu,
                          lam, task)
        return {key: W}, met

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

    def run_clients(epoch, P, anchor, X, y, idx, mask, positions, lr, mu,
                    lam):
        met = None
        for e in range(epochs):
            pos = epoch_positions(positions, mask, e)
            rows, valid = _epoch_rows(pos, idx, mask, n_max)
            P, met = epoch(P, anchor, X, y, rows, valid, lr, mu, lam)
        return P, met

    def round_fn(params, X, y, idx, mask, positions, lr, mu, lam):
        epoch = (kernel_epoch if route.kernel_route(params)
                 else autograd_epoch)
        J = idx.shape[0]
        if not isinstance(positions, torch.Generator):
            positions = torch.as_tensor(positions)
            want = (J, epochs, S, batch_size)
            if tuple(positions.shape) != want:
                raise ValueError(f"positions shape "
                                 f"{tuple(positions.shape)} != {want}")
        if not sequential:
            P = {k: v.expand((J,) + tuple(v.shape)).contiguous()
                 for k, v in params.items()}
            P, met = run_clients(epoch, P, params, X, y, idx, mask,
                                 positions, lr, mu, lam)
        else:
            outs, mets = [], []
            carry = {k: v.contiguous() for k, v in params.items()}
            for j in range(J):
                pos_j = (positions if isinstance(positions, torch.Generator)
                         else positions[j:j + 1])
                Pj, met_j = run_clients(
                    epoch, {k: v[None] for k, v in carry.items()}, carry, X,
                    y, idx[j:j + 1], mask[j:j + 1], pos_j, lr, mu, lam)
                outs.append(Pj)
                mets.append(met_j)
                carry = {k: v[0] for k, v in Pj.items()}
            P = {k: torch.cat([o[k] for o in outs]) for k in params}
            met = torch.cat(mets)
        total = torch.clamp(met[:, 2], min=1.0)
        return P, met[:, 0] / total, 100.0 * met[:, 1] / total

    return round_fn


def make_bucketed_round(task: str, epochs: int, batch_size: int,
                        n_maxes: tuple, sequential: bool = False,
                        kernel_impl: str = "auto",
                        client_blocks: tuple | None = None,
                        apply_fn: Callable | None = None):
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
    ``apply_fn`` as in ``make_client_round``.
    """
    blocks = client_blocks or (None,) * len(n_maxes)
    fns = [make_client_round(task, epochs, batch_size, m, kernel_impl,
                             sequential, b, apply_fn)
           for m, b in zip(n_maxes, blocks)]

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
                      kernel_impl: str = "auto",
                      apply_fn: Callable | None = None):
    """The single-client view of ``make_client_round`` (JAX
    ``client.py:152-260``).

    Returns ``local_update(params, X, y, idx (n_max,), mask (n_max,),
    positions, lr, mu, lam) -> (new_params, last_epoch_loss,
    last_epoch_acc)``; ``positions`` is ``(epochs, S, B)`` or a
    ``torch.Generator``, as in ``make_client_round``; ``apply_fn`` and
    the route as there.
    """
    round_fn = make_client_round(task, epochs, batch_size, n_max,
                                 kernel_impl, apply_fn=apply_fn)

    def local_update(params, X, y, idx, mask, positions, lr, mu, lam):
        if not isinstance(positions, torch.Generator):
            positions = torch.as_tensor(positions)[None]
        stacked, losses, accs = round_fn(params, X, y, idx[None], mask[None],
                                         positions, lr, mu, lam)
        return ({k: v[0] for k, v in stacked.items()}, losses[0], accs[0])

    return local_update
