"""Dataset loading orchestration (reference ``load_full_data``, ``utils.py:124-167``).

Resolution order for a named dataset:

1. image files for ``mnist``/``CIFAR10`` (IDX / CIFAR-binary under
   ``data_dir``, the formats torchvision caches — ``data/images.py``);
2. LIBSVM files ``{data_dir}/{name}`` and ``{data_dir}/{name}.t``
   (train/test, as the reference expects);
3. sklearn's bundled ``digits`` (no download needed);
4. a deterministic synthetic stand-in matching the registry's
   (num_examples, dimensional, num_classes) signature — this box has no
   network egress, so downloads are not an option.

The returned ``FederatedDataset`` carries raw (pre-RFF) features; feature
mapping happens once, downstream, on device (``ops/rff.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import get_parameter
from .images import IMAGE_LOADERS
from .partition import dirichlet_partition, uniform_partition
from .svmlight import is_regression, load_svmlight
from .synthetic import generate_synthetic, synthetic_classification


@dataclasses.dataclass
class FederatedDataset:
    name: str
    task_type: str            # 'classification' | 'regression'
    num_classes: int
    d: int                    # raw feature dimension
    X_train: np.ndarray       # (n, d) float32
    y_train: np.ndarray       # (n,) int32 (classification) / float32
    X_test: np.ndarray
    y_test: np.ndarray
    parts: list               # per-client global index arrays
    class_counts: dict | None = None
    source: str = "file"      # 'file' | 'sklearn' | 'synthetic'

    @property
    def num_partitions(self) -> int:
        return len(self.parts)


def _load_digits():
    from sklearn.datasets import load_digits

    bunch = load_digits()
    X = (bunch.data / 16.0).astype(np.float32)
    y = bunch.target.astype(np.int32)
    # Deterministic 80/20 train/test split (the reference's LIBSVM sets
    # ship pre-split; digits does not).
    rng = np.random.RandomState(7)
    order = rng.permutation(len(y))
    cut = int(len(y) * 0.8)
    tr, te = order[:cut], order[cut:]
    return X[tr], y[tr], X[te], y[te]


def load_dataset(
    name: str,
    num_partitions: int = 10,
    alpha: float = 0.1,
    data_dir: str = "datasets",
    partition_seed: int = 2020,
    rng: np.random.RandomState | None = None,
    synthetic_seed: int = 11,
    verbose: bool = False,
    min_size: int = 10,
) -> FederatedDataset:
    """Load + partition a dataset into simulated non-IID clients.

    ``alpha == -1`` selects the IID uniform split, any other value the
    Dirichlet label-skew partitioner — reference ``utils.py:157-160``.
    ``rng`` drives only the IID split (the reference uses the
    script-seeded global RNG there); the Dirichlet path is seeded by
    ``partition_seed`` exactly as the reference hard-codes 2020.
    """
    params = get_parameter(name)
    # The registry default block says 'classification'; the regression
    # LIBSVM sets (abalone, cadata, ...) have no registry entries, so
    # derive the task from the name list, as the reference's code paths do.
    task_type = "regression" if is_regression(name) else params["task_type"]

    if name == "synthetic_nonlinear":
        return _load_synthetic_regression(
            name, num_partitions, rng or np.random.RandomState(synthetic_seed)
        )

    source = "file"
    try:
        if name in IMAGE_LOADERS:
            X_train, y_train, X_test, y_test = IMAGE_LOADERS[name](data_dir)
            d = X_train.shape[1]
            num_classes = 10
        else:
            X_train, y_train = load_svmlight(name, data_dir)
            X_test, y_test = load_svmlight(name + ".t", data_dir)
            d = X_train.shape[1]
            if X_test.shape[1] != d:  # LIBSVM files can disagree on max index
                w = max(X_test.shape[1], d)
                X_train = _pad_cols(X_train, w)
                X_test = _pad_cols(X_test, w)
                d = w
            num_classes = (
                1 if is_regression(name) else int(len(np.unique(y_train)))
            )
    except FileNotFoundError:
        if name == "digits":
            X_train, y_train, X_test, y_test = _load_digits()
            source = "sklearn"
        else:
            X_train, y_train, X_test, y_test = synthetic_classification(
                params.get("num_examples", 4000),
                params["dimensional"],
                params["num_classes"],
                seed=synthetic_seed,
            )
            source = "synthetic"
        d = X_train.shape[1]
        num_classes = int(params["num_classes"])

    if alpha != -1:
        parts, class_counts = dirichlet_partition(
            y_train, num_partitions, alpha, seed=partition_seed,
            min_size=min_size, verbose=verbose,
        )
    else:
        parts = uniform_partition(len(y_train), num_partitions, rng)
        class_counts = None

    return FederatedDataset(
        name=name,
        task_type=task_type,
        num_classes=num_classes,
        d=d,
        X_train=np.asarray(X_train, np.float32),
        y_train=y_train,
        X_test=np.asarray(X_test, np.float32),
        y_test=y_test,
        parts=parts,
        class_counts=class_counts,
        source=source,
    )


def _pad_cols(X: np.ndarray, width: int) -> np.ndarray:
    if X.shape[1] == width:
        return X
    out = np.zeros((X.shape[0], width), dtype=X.dtype)
    out[:, : X.shape[1]] = X
    return out


def _load_synthetic_regression(name, num_partitions, rng):
    """Reference synthetic branch (``tune.py:58-66``): one pool split evenly."""
    X_tr, y_tr, X_te, y_te, _, _ = generate_synthetic(
        0, 0, 10, 10000, 1, rng=rng
    )
    X = X_tr.reshape(-1, 10).astype(np.float32)
    y = y_tr.reshape(-1).astype(np.float32)
    parts = list(np.array_split(np.arange(len(y)), num_partitions))
    return FederatedDataset(
        name=name,
        task_type="regression",
        num_classes=1,
        d=10,
        X_train=X,
        y_train=y,
        X_test=X_te.astype(np.float32),
        y_test=y_te.astype(np.float32),
        parts=parts,
        source="synthetic",
    )
