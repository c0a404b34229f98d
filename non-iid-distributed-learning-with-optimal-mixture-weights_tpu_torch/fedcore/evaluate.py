"""Evaluation (reference ``test_loop``, ``functions/tools.py:218-237``).

The reference Meter-averages per-batch means weighted by batch size,
which is exactly the full-set mean, so this is one batched forward pass.
Accuracy for regression tasks is reported as 0.0 (SURVEY.md §2.2
component 22).
"""

from __future__ import annotations

from typing import Callable

import torch


def make_evaluator(apply_fn: Callable, task: str):
    """Returns ``evaluate(params, X, y) -> (loss, acc_percent)``, both
    0-d float32 tensors on the data's device."""
    from ..ops.losses import ce_per_example, mse_per_example
    from ..ops.metrics import top1_correct

    @torch.no_grad()
    def evaluate(params, X, y):
        preds = apply_fn(params, X)
        if task == "classification":
            loss = torch.mean(ce_per_example(preds, y))
            acc = 100.0 * torch.mean(top1_correct(preds, y))
        else:
            loss = torch.mean(mse_per_example(preds, y))
            acc = torch.zeros((), dtype=torch.float32, device=X.device)
        return loss, acc

    return evaluate
