"""Accuracy primitives."""

from __future__ import annotations

import torch


def top1_correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example 0/1 top-1 correctness (float). On ties the first
    maximal class is the prediction, as ``jnp.argmax`` picks it."""
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
