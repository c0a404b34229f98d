"""Accuracy primitives, and the reference's metric helpers.

``top1_correct`` is what the evaluator uses. ``comp_accuracy``,
``error_estimate`` and ``Meter`` keep the reference's surface
(``functions/tools.py:64-166``), as the JAX package's ``ops/metrics.py``
does: host-side numpy helpers for logging and analysis.
"""

from __future__ import annotations

import numpy as np
import torch


def top1_correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example 0/1 top-1 correctness (float). On ties the first
    maximal class is the prediction, as ``jnp.argmax`` picks it."""
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent over the ``mask == 1`` entries (the JAX
    package's ``ops/metrics.py:21-24``), a 0-d tensor."""
    correct = top1_correct(logits, labels)
    return 100.0 * torch.sum(correct * mask) / torch.clamp(torch.sum(mask),
                                                           min=1.0)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def comp_accuracy(output, target, topk=(1,)):
    """Top-k accuracies in percent (reference ``tools.py:82-96``), for
    numpy arrays or tensors; a list of floats."""
    output, target = _host(output), _host(target)
    pred = np.argsort(-output, axis=1)[:, :max(topk)]
    correct = pred == target[:, None]
    return [100.0 * float(correct[:, :k].sum()) / target.shape[0]
            for k in topk]


def error_estimate(output, target, task_type: str = "regression"):
    """MSE and top-1 error (reference ``tools.py:64-79``, which never
    calls it). For ``binary``/``multiclass``/``classification`` the MSE
    is against the one-hot ``target`` and the second value is ``1 -
    acc/100``; for ``regression`` both are the plain MSE. Python
    floats."""
    output = _host(output).astype(np.float32)
    target = _host(target)
    if task_type in ("binary", "multiclass", "classification"):
        top1 = comp_accuracy(output, target)[0]
        onehot = np.eye(output.shape[-1], dtype=np.float32)[
            target.astype(np.int64)]
        return float(np.mean((output - onehot) ** 2)), 1.0 - top1 / 100.0
    if task_type == "regression":
        mse = float(np.mean((output - target) ** 2))
        return mse, mse
    raise ValueError(f"Unsupported task type: {task_type}")


class Meter:
    """Streaming mean/std/MAD accumulator (reference ``tools.py:99-166``)."""

    def __init__(self, init_dict=None, ptag="Time", stateful=False,
                 csv_format=True):
        self.reset()
        self.ptag = ptag
        self.stateful = stateful
        self.value_history = [] if stateful else None
        self.csv_format = csv_format
        if init_dict:
            for key, val in init_dict.items():
                setattr(self, key, val)

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.std = 0.0
        self.sqsum = 0.0
        self.mad = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sqsum += (val**2) * n
        if self.count > 1:
            self.std = ((self.sqsum - (self.sum**2) / self.count)
                        / (self.count - 1)) ** 0.5
        if self.stateful:
            self.value_history.append(val)
            self.mad = sum(abs(v - self.avg) for v in self.value_history) / (
                len(self.value_history))

    def __str__(self):
        spread = self.mad if self.stateful else self.std
        if self.csv_format:
            return f"{self.val:.3f},{self.avg:.3f},{spread:.3f}"
        return f"{self.ptag}: {self.val:.3f} ({self.avg:.3f} +- {spread:.3f})"
