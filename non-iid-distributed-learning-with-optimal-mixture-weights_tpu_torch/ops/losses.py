"""Loss functions: CE / MSE with masks, prox and ridge penalties.

The 4-way flag combination of the reference's local objective
(``functions/tools.py:193-209``)::

    loss = data_loss + mu * prox_term + lambda_reg * ridge_term

- data_loss: mean CrossEntropy (classification) or mean MSE (regression)
  over the *valid* samples of a batch (padded slots are masked out);
- prox_term (FedProx): sum over parameter leaves of the *unsquared*
  2-norm ``||w - w_anchor||_2`` (the reference applies ``.norm(2)`` per
  parameter and sums, ``tools.py:195-197``);
- ridge_term (FedAMW): Frobenius norm of every weight matrix (ndim >= 2).

The norms use a zero-subgradient-at-zero form (``l2_norm_safe``), so
autograd gives 0 at ``w == anchor`` (the first FedProx step) instead of
NaN. The client round's autograd route differentiates these functions
for every model of the zoo; the client-epoch kernel derives the same
gradients by hand for the linear model. The penalties visit the leaves
in sorted key order, the JAX package's tree order.
"""

from __future__ import annotations

import torch


def l2_norm_safe(x: torch.Tensor) -> torch.Tensor:
    """2-norm of the flattened tensor with gradient 0 at 0."""
    sq = torch.sum(torch.square(x))
    pos = sq > 0.0
    safe = torch.where(pos, sq, torch.ones_like(sq))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(sq))


def ce_per_example(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with integer labels, per example (``nn.CrossEntropyLoss``
    before the mean reduction)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1))
    return lse - picked[..., 0]


def mse_per_example(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error per example (mean over output dims)."""
    if targets.dim() == preds.dim() - 1:
        targets = targets.unsqueeze(-1)
    return torch.mean(torch.square(preds - targets), dim=-1)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over mask==1 entries; 0 for an all-masked batch."""
    count = torch.sum(mask)
    return torch.sum(values * mask) / torch.clamp(count, min=1.0)


def data_loss(params, apply_fn, x, y, mask, task: str):
    """Masked mean CE or MSE of ``apply_fn(params, x)`` on a batch."""
    preds = apply_fn(params, x)
    if task == "classification":
        per = ce_per_example(preds, y)
    else:
        per = mse_per_example(preds, y)
    return masked_mean(per, mask), preds


def prox_penalty(params: dict, anchor: dict) -> torch.Tensor:
    """FedProx term: sum of per-leaf unsquared 2-norms of (w - anchor),
    the leaves in sorted key order (the JAX package's tree order)."""
    return torch.stack(
        [l2_norm_safe(params[k] - anchor[k]) for k in sorted(params)]).sum()


def ridge_penalty(params: dict) -> torch.Tensor:
    """FedAMW term: sum of Frobenius norms of weight matrices (ndim>=2;
    biases are exempt), in sorted key order."""
    return torch.stack([l2_norm_safe(params[k]) for k in sorted(params)
                        if params[k].dim() >= 2]).sum()


def training_loss(params, anchor, apply_fn, x, y, mask, task: str,
                  mu: float, lam: float):
    """The full local objective (reference ``tools.py:202-209``).

    ``mu`` / ``lam`` of 0 disable the corresponding term. Returns
    ``(loss, (preds, valid_count))``.
    """
    dloss, preds = data_loss(params, apply_fn, x, y, mask, task)
    loss = dloss + mu * prox_penalty(params, anchor) + lam * ridge_penalty(params)
    return loss, (preds, torch.sum(mask))
