"""Server-side aggregation and the FedAMW mixture-weight solver.

The reference's per-key dict loops (``functions/tools.py:345-349``)
become weighted ``tensordot`` reductions over stacked parameters with a
leading client axis. The FedAMW p-solver (``tools.py:441-453``) works on
per-client validation logits computed ONCE per round (the client models
are fixed during the solve) and runs its ``round x |val|/16`` tiny SGD
steps on ``p`` over that cached ``(n_val, J, C)`` tensor; each epoch is
one call of ``psolver_kernel.p_epoch`` — on CUDA tensors one launch of
the hand-written kernel. Mixture weights stay UNCONSTRAINED, as in the
reference (``tools.py:417-423``).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import cuda_build
from .batching import batch_counts, batch_valid, weighted_epoch_metrics
from .psolver_kernel import p_epoch, p_epoch_plain


def weighted_average(stacked_params: dict, p: torch.Tensor) -> dict:
    """``sum_j p_j * theta_j`` over the leading client axis of every leaf
    (reference ``tools.py:345-349``)."""
    return {k: torch.tensordot(p, w, dims=([0], [0]))
            for k, w in stacked_params.items()}


def client_logits(apply_fn: Callable, stacked_params: dict,
                  X: torch.Tensor) -> torch.Tensor:
    """Per-client predictions on a shared matrix, ``(n, J, C)``.

    For the linear model ``apply_fn`` broadcasts over the stacked client
    axis, so this is one batched product — the reference's
    ``matmul(W.permute(2,0,1), data.T)`` (``tools.py:448``) for the whole
    validation set at once.
    """
    preds = apply_fn(stacked_params, X)          # (J, n, C)
    return preds.permute(1, 0, 2).contiguous()


def make_p_solver(
    task: str,
    n_val: int,
    batch_size: int = 16,
    lr_p: float = 1e-3,
    momentum: float = 0.0,
    p_guard: str = "none",
    kernel_impl: str = "auto",
):
    """Build the mixture-weight SGD solver.

    Returns ``(solve, init_opt_state)`` where ``solve(logits (n_val, J,
    C), y_val (n_val,), p (J,), opt_state, positions (num_epochs, S, B),
    client_valid=None) -> (p, opt_state, last_epoch_loss,
    last_epoch_acc)`` runs one shuffled pass over the pooled validation
    set per leading entry of ``positions`` (``batching.epoch_batches``
    with no mask; reference ``DataLoader(16, shuffle=True)``,
    ``exp.py:99``), stepping ``p`` per batch with SGD(momentum) —
    ``buf = m*buf + g; p -= lr*buf``, torch- and optax-identical.

    ``opt_state`` is ``{"trace": buf (J,)}`` with momentum, ``{}``
    without (plain SGD carries nothing between calls). ``client_valid``
    (a ``(J,)`` 0/1 mask) zeroes the gradient, and so the momentum, of
    invalid clients every step.

    ``p_guard`` other than ``"none"`` raises: the simplex and clip guards
    are not ported yet (ROADMAP.md, queue 1). ``kernel_impl`` as in
    ``client.make_client_round``.
    """
    if p_guard != "none":
        raise NotImplementedError(
            f"p_guard={p_guard!r} is not ported yet; only 'none' is (see "
            "ROADMAP.md, queue 1)")
    epoch_fn = cuda_build.kernel_or_plain(kernel_impl, p_epoch, p_epoch_plain)
    S, _ = batch_counts(n_val, batch_size)

    def init_opt_state(p):
        return {"trace": torch.zeros_like(p)} if momentum > 0 else {}

    def solve(logits, y_val, p, opt_state, positions, client_valid=None):
        J = logits.shape[1]
        if positions.dim() != 3 or tuple(positions.shape[1:]) != (S, batch_size):
            raise ValueError(f"positions must be (num_epochs, {S}, "
                             f"{batch_size}), got {tuple(positions.shape)}")
        cv = (torch.ones(J, dtype=torch.float32, device=p.device)
              if client_valid is None
              else client_valid.to(torch.float32).contiguous())
        buf = (opt_state["trace"] if momentum > 0
               else torch.zeros(J, dtype=torch.float32, device=p.device))
        valid = batch_valid(positions, n_val)
        positions = positions.to(torch.int32)
        met = None
        for e in range(positions.shape[0]):
            p, buf, met = epoch_fn(p.contiguous(), buf.contiguous(), cv,
                                   logits, y_val,
                                   positions[e].contiguous(),
                                   valid[e].contiguous(), lr_p, momentum,
                                   task)
        state = {"trace": buf} if momentum > 0 else {}
        return (p, state) + weighted_epoch_metrics(met[0], met[1], met[2])

    return solve, init_opt_state
