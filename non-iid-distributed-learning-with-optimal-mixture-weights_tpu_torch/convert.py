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
    """``{"w": (C, D) array}`` -> CPU float32 tensors of the same layout
    (the algorithms move them to their setup's device)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params.items()}


def setup_from_arrays(*, task: str, num_classes: int, X, y, X_val, y_val,
                      X_test, y_test, idx, mask, sizes, p_fixed, rff=None,
                      model: str = "linear", device=None) -> FedSetup:
    """A ``FedSetup`` from numpy copies of a JAX ``FedSetup``'s arrays
    (unbucketed: ``idx``/``mask`` are ``(J, n_max)``). ``rff`` is its
    ``(W, b)`` draw or None. ``device`` as in ``prepare_setup``."""
    dev = resolve_device(device)
    y_dtype = torch.int32 if task == "classification" else torch.float32

    def put(a, dtype):
        return torch.from_numpy(np.array(a)).to(dev, dtype).contiguous()

    X = put(X, torch.float32)
    return FedSetup(
        model=get_model(model),
        task=task,
        num_classes=int(num_classes),
        D=int(X.shape[1]),
        X=X,
        y=put(y, y_dtype),
        X_test=put(X_test, torch.float32),
        y_test=put(y_test, y_dtype),
        X_val=put(X_val, torch.float32),
        y_val=put(y_val, y_dtype),
        idx=put(idx, torch.int64),
        mask=put(mask, torch.float32),
        sizes=put(sizes, torch.int32),
        p_fixed=put(p_fixed, torch.float32),
        rff=None if rff is None else tuple(put(t, torch.float32) for t in rff),
    )
