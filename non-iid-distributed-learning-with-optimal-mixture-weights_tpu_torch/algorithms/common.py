"""Shared experiment setup: RFF mapping, val split, packing, placement.

``prepare_setup`` performs the reference scripts' preamble
(``exp.py:60-99``): load -> RFF-map once with a single draw -> per-client
80/20 split with the 20% pooled for mixture-weight fitting -> pack the
clients into the dense index layout, or into size buckets
(``buckets > 1``). Everything lands on the device once; the algorithms
then run there.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..data import FederatedDataset, pack_partitions, split_train_val
from ..data.pack import bucket_partitions
from ..device import resolve_device
from ..models import Model, get_model
from ..ops.rff import rff_map, rff_map_to, rff_params

# the storage dtypes of the feature matrices (``feature_dtype``)
FEATURE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}


@dataclasses.dataclass
class FedSetup:
    """Device-resident experiment state shared by all algorithms."""

    model: Model
    task: str
    num_classes: int
    D: int                       # feature dim the model sees (post-RFF)
    X: torch.Tensor              # (N, D) mapped train features, shared
    #                              (float32, or feature_dtype's 2 bytes)
    y: torch.Tensor              # (N,) int32 labels / float32 targets
    X_test: torch.Tensor
    y_test: torch.Tensor
    X_val: torch.Tensor          # pooled validation (n_val, D)
    y_val: torch.Tensor
    idx: torch.Tensor | None     # (J, n_max) int64 client row indices
    mask: torch.Tensor | None    # (J, n_max) float32 (both None when bucketed)
    sizes: torch.Tensor          # (J,) int32 true client sizes
    p_fixed: torch.Tensor        # (J,) sample-count mixture weights
    rff: tuple | None = None     # (W, b) draw, for mapping new data
    # size-bucketed view (prepare_setup(buckets>1)): clients sorted by
    # size, descending; every client-indexed array above is in that order
    bucket_idx: tuple | None = None   # (J_g, n_max_g) int64 per bucket
    bucket_mask: tuple | None = None
    # the ranks the client axis is split over (parallel.shard_setup): then
    # idx/mask (or each bucket's) hold this rank's block of clients, and
    # every other tensor, the (J,) vectors included, stays whole
    mesh_devices: int = 1
    mesh: Any = None             # parallel.ClientMesh, or None

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def num_clients(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def n_maxes(self) -> tuple[int, ...]:
        """Per-bucket padded capacities (one when unbucketed)."""
        return tuple(int(i.shape[1]) for i in self.round_arrays()[0])

    @property
    def bucket_counts(self) -> tuple[int, ...]:
        return tuple(int(i.shape[0]) for i in self.round_arrays()[0])

    @property
    def n_max(self) -> int:
        return max(self.n_maxes)

    def round_arrays(self) -> tuple[tuple, tuple]:
        """``(idx_tuple, mask_tuple)``, one entry per bucket, for
        ``fedcore.make_bucketed_round``."""
        if self.bucket_idx is None:
            return (self.idx,), (self.mask,)
        return self.bucket_idx, self.bucket_mask

    @property
    def all_train_idx(self) -> torch.Tensor:
        """Every valid train row once, client-major in bucket order: the
        pooled index set of Centralized. ``(n,)`` int64 on the setup's
        device. Over ranks the packs are all-gathered first (a
        collective every rank reaches together, JAX ``common.py:78-100``),
        so every rank gets the whole set."""
        packs = self.round_arrays()
        if self.mesh is not None:
            packs = [[self.mesh.all_gather(a) for a in arrays]
                     for arrays in packs]
        return torch.cat([i.reshape(-1)[m.reshape(-1) > 0]
                          for i, m in zip(*packs)])


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
    pad_clients_to: int | None = None,
    n_max: int | None = None,
    buckets: int = 1,
    client_multiple: int = 1,
    device=None,
    feature_dtype: torch.dtype | None = None,
) -> FedSetup:
    """Build the device-resident setup from a loaded dataset.

    ``rng`` drives the per-client val split (``exp.py:28-29,80-86``);
    ``seed`` drives the RFF draw through ``torch.Generator(seed)`` on the
    CPU, so the draw is the same on every device. ``rff=(W, b)`` injects
    a draw instead (arrays or tensors, ``(d, D)`` and ``(1, D)``) — how a
    run reproduces the JAX package's features. ``device`` defaults to the
    CUDA card and raises without one; pass ``device="cpu"`` to run on the
    CPU.

    ``feature_dtype`` (``torch.bfloat16``, ``torch.float16`` or
    ``torch.float32``; None keeps float32) stores ``X``, ``X_val`` and
    ``X_test`` in that dtype (JAX ``common.py:119,138-168``): mapped in
    row chunks (``ops.rff.rff_map_to``), or, for ``kernel_type="linear"``,
    narrowed as they are. Labels, parameters and all compute stay float32:
    the products widen the rows.

    Packing (JAX ``common.py:106-220``): ``n_max`` forces a larger sample
    padding and ``pad_clients_to`` appends empty clients;
    ``buckets > 1`` packs clients into size buckets (sorted by size,
    descending; every client-indexed array uses that order);
    ``client_multiple > 1`` pads every bucket's client axis (or the one
    unbucketed axis) with empty clients to a multiple of it. Empty
    clients have zero weight and stay inert.
    """
    dev = resolve_device(device)
    if feature_dtype not in (None,) + tuple(FEATURE_DTYPES.values()):
        raise ValueError(f"feature_dtype must be one of "
                         f"{list(FEATURE_DTYPES.values())} or None, got "
                         f"{feature_dtype!r}")
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
        if feature_dtype is None:
            X_train = rff_map(X_train, W, b)
            X_test = rff_map(X_test, W, b)
        else:
            X_train = rff_map_to(X_train, W, b, feature_dtype)
            X_test = rff_map_to(X_test, W, b, feature_dtype)
        rff = (W, b)
        feat_dim = W.shape[1]
    else:
        rff = None
        feat_dim = ds.d
        if feature_dtype is not None:
            X_train = X_train.to(feature_dtype)
            X_test = X_test.to(feature_dtype)

    train_parts, val_idx = split_train_val(ds.parts, val_fraction, rng)

    def put(a, dtype=None):
        return torch.as_tensor(a).to(dev, dtype)

    bucket_idx = bucket_mask = idx = mask = None
    if buckets > 1:
        if pad_clients_to is not None:
            raise ValueError(
                "buckets>1 is incompatible with pad_clients_to; "
                "use client_multiple for mesh-even bucket padding")
        packs, _ = bucket_partitions(train_parts, buckets, client_multiple)
        bucket_idx = tuple(put(p.idx, torch.int64) for p in packs)
        bucket_mask = tuple(put(p.mask) for p in packs)
        sizes = np.concatenate([p.sizes for p in packs])
        weights = (sizes.astype(np.float64) / sizes.sum()).astype(np.float32)
    else:
        if client_multiple > 1:
            j = len(train_parts) if pad_clients_to is None else pad_clients_to
            pad_clients_to = -(-j // client_multiple) * client_multiple
        pack = pack_partitions(train_parts, n_max=n_max,
                               pad_clients_to=pad_clients_to)
        sizes, weights = pack.sizes, pack.weights
        idx, mask = put(pack.idx, torch.int64), put(pack.mask)
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
        idx=idx,
        mask=mask,
        sizes=put(sizes),
        p_fixed=put(weights),
        rff=rff,
        bucket_idx=bucket_idx,
        bucket_mask=bucket_mask,
    )


def result_tuple(train_loss, test_loss, test_acc) -> dict[str, Any]:
    """Uniform result record: numpy copies of the metric vectors."""
    return {
        "train_loss": np.asarray(train_loss),
        "test_loss": np.asarray(test_loss),
        "test_acc": np.asarray(test_acc),
    }
