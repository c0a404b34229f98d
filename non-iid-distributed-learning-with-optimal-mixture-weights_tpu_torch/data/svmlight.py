"""LIBSVM/svmlight data loading and label canonicalization.

Replicates the data semantics of the reference's ``svmlight_data`` Dataset
(``functions/utils.py:36-65``): features densified to float32, labels
canonicalized by task type. Files are parsed with the repository's
native C++ parser (``native_io.py``) when it builds, else with sklearn's
reader; both give the same float32 values.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import REGRESSION_DATASETS


def is_regression(dataset_name: str) -> bool:
    """Name-list check, reference ``functions/utils.py:32-34``.

    Test-split files are named ``{name}.t``; the suffix is stripped so
    e.g. ``cadata.t`` canonicalizes as regression like its train split.
    """
    if dataset_name.endswith(".t"):
        dataset_name = dataset_name[:-2]
    return dataset_name in REGRESSION_DATASETS


def canonicalize_labels(y: np.ndarray, dataset_name: str) -> np.ndarray:
    """Label canonicalization, reference ``functions/utils.py:39-45``.

    - regression datasets: min-max scaled to [0, 100], float32;
    - binary: min-max to {0, 1} (e.g. a9a's {-1,+1} -> {0,1}), int32;
    - multiclass: shifted so the smallest label is 0, int32.
    """
    y = np.asarray(y)
    if is_regression(dataset_name):
        return (100.0 * (y - y.min()) / (y.max() - y.min())).astype(np.float32)
    n_distinct = len(np.unique(y))
    if n_distinct == 2:
        y = (y - y.min()) / (y.max() - y.min())
    elif n_distinct > 2:
        y = y - y.min()
    return np.rint(y).astype(np.int32)


def _parse_with_sklearn(path: str):
    from sklearn.datasets import load_svmlight_file

    X, y = load_svmlight_file(path)
    return np.asarray(X.todense(), dtype=np.float32), np.asarray(y)


def load_svmlight(dataset_name: str, data_dir: str = "datasets",
                  use_native: bool = True):
    """Load ``{data_dir}/{dataset_name}`` and canonicalize labels.

    Returns ``(X (n, d) float32, y (n,))``. Raises FileNotFoundError if
    the file is absent (callers decide whether to fall back to synthetic
    data). ``use_native`` tries the native parser first (JAX
    ``data/svmlight.py:55-58``).
    """
    path = os.path.join(data_dir, dataset_name)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    X = None
    if use_native:
        from .. import native_io

        try:
            X, y = native_io.load_svmlight(path)
        except (ImportError, OSError):
            X = None
    if X is None:
        X, y = _parse_with_sklearn(path)
    return X, canonicalize_labels(np.asarray(y), dataset_name)
