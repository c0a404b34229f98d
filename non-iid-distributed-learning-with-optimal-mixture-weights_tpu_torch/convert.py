"""Carry weights and experiment state across from the JAX package.

Both functions take numpy arrays (``np.asarray`` of the JAX package's
values) and never import JAX; they are how a run of this package is put
on exactly the inputs of a run of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .algorithms.common import FedSetup
from .device import resolve_device
from .models import get_model


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A flat parameter dict of arrays (any model of the zoo: the linear
    ``{"w": (C, D)}``, an MLP's ``w{i}``/``b{i}``, a CNN's HWIO ``k{i}``,
    ``cb{i}`` and ``w``) -> CPU float32 tensors under the same keys and
    layouts (the algorithms move them to their setup's device)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params.items()}


def features_from_jax(a) -> torch.Tensor:
    """A CPU tensor of a feature matrix in its own dtype: float32 or
    float16 as they are, and bfloat16 (numpy's ``ml_dtypes`` type, which
    torch does not read) moved bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def setup_from_arrays(*, task: str, num_classes: int, X, y, X_val, y_val,
                      X_test, y_test, idx, mask, sizes, p_fixed, rff=None,
                      model: str = "linear", device=None) -> FedSetup:
    """A ``FedSetup`` from numpy copies of a JAX ``FedSetup``'s arrays:
    ``idx``/``mask`` are ``(J, n_max)``, or for a bucketed setup tuples
    of its ``bucket_idx``/``bucket_mask``. ``rff`` is its ``(W, b)`` draw
    or None. The feature matrices keep their dtype (float32, or a JAX
    setup's ``feature_dtype``: bfloat16, float16). ``model`` is any name
    of ``models.get_model``; ``device`` as in ``prepare_setup``."""
    dev = resolve_device(device)
    y_dtype = torch.int32 if task == "classification" else torch.float32

    def put(a, dtype):
        return torch.from_numpy(np.array(a)).to(dev, dtype).contiguous()

    def features(a):
        t = features_from_jax(a)
        if t.dtype not in (torch.bfloat16, torch.float16):
            t = t.to(torch.float32)
        return t.to(dev).contiguous()

    X = features(X)
    bucketed = isinstance(idx, (list, tuple))
    buckets = (tuple(put(a, torch.int64) for a in idx),
               tuple(put(a, torch.float32) for a in mask)) if bucketed else None
    return FedSetup(
        model=get_model(model),
        task=task,
        num_classes=int(num_classes),
        D=int(X.shape[1]),
        X=X,
        y=put(y, y_dtype),
        X_test=features(X_test),
        y_test=put(y_test, y_dtype),
        X_val=features(X_val),
        y_val=put(y_val, y_dtype),
        idx=None if bucketed else put(idx, torch.int64),
        mask=None if bucketed else put(mask, torch.float32),
        sizes=put(sizes, torch.int32),
        p_fixed=put(p_fixed, torch.float32),
        rff=None if rff is None else tuple(put(t, torch.float32) for t in rff),
        bucket_idx=buckets and buckets[0],
        bucket_mask=buckets and buckets[1],
    )
