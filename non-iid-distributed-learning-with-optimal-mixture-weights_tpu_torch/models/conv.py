"""Small convolutional models for the image datasets.

The counterpart of the JAX package's ``models/conv.py``: a compact CNN
(stride-2 "SAME" convolutions with ReLU, then a biasless linear head)
over flattened square grayscale images ``(B, H*W)``, which ``apply``
folds back to the square image. It drops into any ``prepare_setup``
whose feature dimension is a perfect square with
``kernel_type="linear"`` (identity features: RFF features are not
images), and trains by autograd like every model but the linear one.

The parameters keep the JAX layout, so a checkpoint carries across
either way: ``k{i}`` is HWIO ``(k, k, c_in, c_out)``, ``cb{i}``
``(c_out,)`` and the head ``w`` ``(C, h*h*c_last)`` over the NHWC
flatten. ``apply`` permutes views at call time, and keeps three things
of ``lax.conv_general_dilated`` exactly:

- "SAME" padding at stride 2 is XLA's: ``total = max((ceil(H/2) - 1) * 2
  + k - H, 0)``, ``total // 2`` before and the rest after, so an even
  side pads (0, 1) at k = 3 where ``F.conv2d(padding=1)`` would pad (1,
  1); it pads explicitly and convolves with ``padding=0``;
- the head reads the features in NHWC order (h, w, c), so the
  activations are permuted to NHWC before the flatten;
- both are cross-correlations (no kernel flip): HWIO -> OIHW is only
  ``permute(3, 2, 0, 1)``.

The convolution is ``F.conv2d``: the JAX package computes it with
``lax.conv_general_dilated`` outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .linear import Model, uniform, xavier_uniform


def same_padding(size: int, kernel: int, stride: int = 2) -> tuple[int, int]:
    """(before, after) padding of one spatial side under XLA's "SAME"
    rule."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_model(channels=(8, 16), kernel: int = 3) -> Model:
    """``channels`` conv layers (ReLU, stride-2 downsampling) and a
    biasless linear head — the zoo's smallest genuinely convolutional
    member. Input: flattened square grayscale images ``(B, H*W)``."""
    chans = (channels,) if isinstance(channels, int) else tuple(channels)
    if not chans or any(c <= 0 for c in chans):
        raise ValueError(f"channel counts must be positive, got {chans}")

    def init(generator, d, num_classes):
        side = math.isqrt(d)
        if side * side != d:
            raise ValueError(
                f"conv models need flattened square images; feature "
                f"dimension {d} is not a perfect square. (RFF-mapped "
                "features are not images — use kernel_type='linear'.)")
        params = {}
        fan_in = 1
        for i, c in enumerate(chans, start=1):
            # HWIO layout; xavier on the fan pair, fanned by the window
            rf = kernel * kernel
            bound = math.sqrt(6.0 / (rf * fan_in + rf * c))
            params[f"k{i}"] = uniform(generator, (kernel, kernel, fan_in, c),
                                      bound)
            params[f"cb{i}"] = torch.zeros((c,), dtype=torch.float32)
            fan_in = c
        # head fan-in: each stride-2 conv halves H and W (ceil)
        h = side
        for _ in chans:
            h = -(-h // 2)
        params["w"] = xavier_uniform(generator,
                                     (num_classes, h * h * chans[-1]))
        return params

    def apply(params, x):
        b, d = x.shape
        side = math.isqrt(d)
        # a 2-byte x is widened: the convolution wants matching dtypes,
        # and the compute stays float32, as the matmul models' does
        h = x.to(params["k1"].dtype).reshape(b, 1, side, side)
        for i in range(1, len(chans) + 1):
            lo, hi = same_padding(h.shape[-1], kernel)
            h = F.conv2d(F.pad(h, (lo, hi, lo, hi)),
                         params[f"k{i}"].permute(3, 2, 0, 1), stride=2)
            h = torch.relu(h + params[f"cb{i}"][:, None, None])
        return h.permute(0, 2, 3, 1).reshape(b, -1) @ params["w"].transpose(
            -1, -2)

    def row_activations(d, num_classes):
        # each layer's (ceil(h/2), ceil(h/2), c) output, then the logits
        h, floats = math.isqrt(d), num_classes
        for c in chans:
            h = -(-h // 2)
            floats += h * h * c
        return floats

    return Model(name="conv" + "x".join(str(c) for c in chans),
                 init=init, apply=apply, row_activations=row_activations)
