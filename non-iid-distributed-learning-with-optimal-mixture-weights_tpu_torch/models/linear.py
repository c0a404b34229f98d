"""The bias-free linear model over RFF features.

The reference's "MLP" (``functions/tools.py:34-40``) is a single
bias-free ``nn.Linear`` — the whole model is one ``(C, D)`` matrix with
Xavier-uniform init. Parameters are a plain dict ``{"w": (C, D)}``; a
stack of client models is ``{"w": (J, C, D)}`` and ``apply`` broadcasts
over that leading axis, which is what ``client_logits`` uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Model:
    """An init/apply pair over a parameter dict."""

    name: str
    init: Callable[[torch.Generator, int, int], dict]
    apply: Callable[[dict, torch.Tensor], torch.Tensor]


def xavier_uniform(generator: torch.Generator,
                   shape: tuple[int, int]) -> torch.Tensor:
    """``nn.init.xavier_uniform_`` for a (fan_out, fan_in) weight, drawn
    from ``generator`` on its device."""
    fan_out, fan_in = shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def _linear_init(generator, d, num_classes):
    return {"w": xavier_uniform(generator, (num_classes, d))}


def _linear_apply(params, x):
    return x @ params["w"].transpose(-1, -2)


def linear_model() -> Model:
    """The reference's bias-free linear classifier (``tools.py:34-40``)."""
    return Model(name="linear", init=_linear_init, apply=_linear_apply)


def get_model(name: str) -> Model:
    """``"linear"``; the other models of the JAX package are not ported
    yet (ROADMAP.md, queue 1)."""
    if name == "linear":
        return linear_model()
    raise NotImplementedError(
        f"model {name!r} is not ported yet; only 'linear' is (see "
        "ROADMAP.md, queue 1)")
