"""Shared experiment setup: RFF mapping, val split, packing, placement.

``prepare_setup`` performs the reference scripts' preamble
(``exp.py:60-99``): load -> RFF-map once with a single draw -> per-client
80/20 split with the 20% pooled for mixture-weight fitting -> pack the
clients into the dense index layout. Everything lands on the device
once; the algorithms then run there.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..data import FederatedDataset, pack_partitions, split_train_val
from ..device import resolve_device
from ..models import Model, get_model
from ..ops.rff import rff_map, rff_params


@dataclasses.dataclass
class FedSetup:
    """Device-resident experiment state shared by all algorithms."""

    model: Model
    task: str
    num_classes: int
    D: int                       # feature dim the model sees (post-RFF)
    X: torch.Tensor              # (N, D) mapped train features, shared
    y: torch.Tensor              # (N,) int32 labels / float32 targets
    X_test: torch.Tensor
    y_test: torch.Tensor
    X_val: torch.Tensor          # pooled validation (n_val, D)
    y_val: torch.Tensor
    idx: torch.Tensor            # (J, n_max) int64 client row indices
    mask: torch.Tensor           # (J, n_max) float32
    sizes: torch.Tensor          # (J,) int32 true client sizes
    p_fixed: torch.Tensor        # (J,) sample-count mixture weights
    rff: tuple | None = None     # (W, b) draw, for mapping new data

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def num_clients(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.idx.shape[1])


def prepare_setup(
    ds: FederatedDataset,
    D: int = 2000,
    kernel_par: float = 0.1,
    kernel_type: str = "gaussian",
    val_fraction: float = 0.2,
    seed: int = 100,
    model: Model | str = "linear",
    rng: np.random.RandomState | None = None,
    rff: tuple | None = None,
    device=None,
) -> FedSetup:
    """Build the device-resident setup from a loaded dataset.

    ``rng`` drives the per-client val split (``exp.py:28-29,80-86``);
    ``seed`` drives the RFF draw through ``torch.Generator(seed)`` on the
    CPU, so the draw is the same on every device. ``rff=(W, b)`` injects
    a draw instead (arrays or tensors, ``(d, D)`` and ``(1, D)``) — how a
    run reproduces the JAX package's features. Features are stored in
    float32. ``device`` defaults to the CUDA card and raises without one;
    pass ``device="cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.RandomState(seed)
    if isinstance(model, str):
        model = get_model(model)

    X_train = torch.as_tensor(ds.X_train, dtype=torch.float32).to(dev)
    X_test = torch.as_tensor(ds.X_test, dtype=torch.float32).to(dev)
    if kernel_type == "gaussian":
        if rff is None:
            rff = rff_params(torch.Generator().manual_seed(seed), ds.d, D,
                             kernel_par)
        W, b = (torch.as_tensor(np.asarray(t), dtype=torch.float32).to(dev)
                for t in rff)
        X_train = rff_map(X_train, W, b)
        X_test = rff_map(X_test, W, b)
        rff = (W, b)
        feat_dim = W.shape[1]
    else:
        rff = None
        feat_dim = ds.d

    train_parts, val_idx = split_train_val(ds.parts, val_fraction, rng)
    pack = pack_partitions(train_parts)
    y_dtype = (torch.int32 if ds.task_type == "classification"
               else torch.float32)
    y = torch.as_tensor(np.asarray(ds.y_train)).to(dev, y_dtype)
    val = torch.as_tensor(np.asarray(val_idx, np.int64)).to(dev)
    return FedSetup(
        model=model,
        task=ds.task_type,
        num_classes=ds.num_classes,
        D=feat_dim,
        X=X_train,
        y=y,
        X_test=X_test,
        y_test=torch.as_tensor(np.asarray(ds.y_test)).to(dev, y_dtype),
        X_val=X_train[val].contiguous(),
        y_val=y[val].contiguous(),
        idx=torch.as_tensor(pack.idx).to(dev, torch.int64),
        mask=torch.as_tensor(pack.mask).to(dev),
        sizes=torch.as_tensor(pack.sizes).to(dev),
        p_fixed=torch.as_tensor(pack.weights).to(dev),
        rff=rff,
    )


def result_tuple(train_loss, test_loss, test_acc) -> dict[str, Any]:
    """Uniform result record: numpy copies of the metric vectors."""
    return {
        "train_loss": np.asarray(train_loss),
        "test_loss": np.asarray(test_loss),
        "test_acc": np.asarray(test_acc),
    }
