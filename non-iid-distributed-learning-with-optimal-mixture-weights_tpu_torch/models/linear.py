"""The model zoo: init/apply pairs over parameter dicts.

The reference's "MLP" (``functions/tools.py:34-40``) is a single
bias-free ``nn.Linear`` — the whole model is one ``(C, D)`` matrix with
Xavier-uniform init, ``{"w": (C, D)}``; a stack of client models is
``{"w": (J, C, D)}`` and its ``apply`` broadcasts over that leading
axis. That single-matrix structure is what the hand-written client-epoch
kernel trains (``fedcore/client.py`` picks its route by it). ``mlp`` is
the genuinely multi-layer variant (ReLU hidden layers, biases, a
biasless output) and ``conv`` the compact CNN of ``models/conv.py``;
both train by autograd, and every downstream stage (aggregation, the
FedAMW logit stack, checkpoints) iterates the dict's leaves, so any of
them federates. The key names and ``(out, in)`` layouts are the JAX
package's (``models/linear.py``), so its checkpoints carry across
unchanged (``convert.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Model:
    """An init/apply pair over a parameter dict, and ``row_activations(d,
    C)``: the floats one input row's forward keeps for one client, its
    hidden activations and its logits (``aggregate.client_logits`` sizes
    its row blocks by it)."""

    name: str
    init: Callable[[torch.Generator, int, int], dict]
    apply: Callable[[dict, torch.Tensor], torch.Tensor]
    row_activations: Callable[[int, int], int]


def xavier_uniform(generator: torch.Generator,
                   shape: tuple[int, int]) -> torch.Tensor:
    """``nn.init.xavier_uniform_`` for a (fan_out, fan_in) weight, drawn
    from ``generator`` on its device."""
    fan_out, fan_in = shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(generator, shape, bound)


def uniform(generator: torch.Generator, shape: tuple,
            bound: float) -> torch.Tensor:
    """float32 ``U(-bound, bound)`` of ``shape`` from ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def _linear_init(generator, d, num_classes):
    return {"w": xavier_uniform(generator, (num_classes, d))}


# rows of a 2-byte feature matrix widened to float32 at a time
WIDEN_ROWS = 65536


def _linear_apply(params, x):
    """``x @ w^T``. A bfloat16 or float16 ``x`` (``feature_dtype``) is
    widened to float32 for the product, as JAX promotes bf16 x f32, in
    chunks of ``WIDEN_ROWS`` rows: no float32 copy of a large matrix."""
    wt = params["w"].transpose(-1, -2)
    if x.dtype == wt.dtype:
        return x @ wt
    return torch.cat([x[lo:lo + WIDEN_ROWS].to(wt.dtype) @ wt
                      for lo in range(0, x.shape[0], WIDEN_ROWS)], dim=-2)


def linear_model() -> Model:
    """The reference's bias-free linear classifier (``tools.py:34-40``)."""
    return Model(name="linear", init=_linear_init, apply=_linear_apply,
                 row_activations=lambda d, c: c)


def mlp_model(hidden=64) -> Model:
    """A true MLP (ReLU hidden layers, biasless output), the JAX package's
    ``mlp_model`` (``models/linear.py:58-90``).

    ``hidden`` is one width (int) or a sequence of widths for deeper
    stacks. Parameters: ``w{i}`` ``(width_i, fan_in)`` and ``b{i}``
    ``(width_i,)`` (zeros) per hidden layer, then ``w{L+1}`` ``(C,
    width_L)``; the weights are Xavier-uniform, drawn in layer order. A
    2-byte ``x`` is widened to float32, as JAX promotes it in the
    product."""
    widths = (hidden,) if isinstance(hidden, int) else tuple(hidden)
    if not widths or any(w <= 0 for w in widths):
        raise ValueError(f"hidden widths must be positive, got {widths}")
    out = len(widths) + 1

    def init(generator, d, num_classes):
        params = {}
        fan_in = d
        for i, w in enumerate(widths, start=1):
            params[f"w{i}"] = xavier_uniform(generator, (w, fan_in))
            params[f"b{i}"] = torch.zeros((w,), dtype=torch.float32)
            fan_in = w
        params[f"w{out}"] = xavier_uniform(generator, (num_classes, fan_in))
        return params

    def apply(params, x):
        h = x.to(params["w1"].dtype)
        for i in range(1, out):
            h = torch.relu(h @ params[f"w{i}"].transpose(-1, -2)
                           + params[f"b{i}"])
        return h @ params[f"w{out}"].transpose(-1, -2)

    return Model(name="mlp" + "x".join(str(w) for w in widths),
                 init=init, apply=apply,
                 row_activations=lambda d, c: sum(widths) + c)


def get_model(name: str, **kwargs) -> Model:
    """``"linear"``, ``"mlp"`` (default width 64), ``"mlp128"`` /
    ``"mlp128x64"`` (x-separated hidden widths), or ``"conv"`` /
    ``"conv8x16"`` (x-separated conv channels; see ``models/conv.py``),
    as the JAX package's ``get_model`` (``models/linear.py:93-112``)."""
    if name == "linear":
        return linear_model()
    if name.startswith("mlp"):
        spec = name[3:]
        if spec:
            hidden = tuple(int(w) for w in spec.split("x"))
            hidden = hidden[0] if len(hidden) == 1 else hidden
        else:
            hidden = kwargs.pop("hidden", 64)
        return mlp_model(hidden)
    if name.startswith("conv"):
        from .conv import conv_model

        spec = name[4:]
        kw_channels = kwargs.pop("channels", (8, 16))
        channels = (tuple(int(c) for c in spec.split("x")) if spec
                    else kw_channels)
        return conv_model(channels, **kwargs)
    raise ValueError(f"unknown model: {name}")
