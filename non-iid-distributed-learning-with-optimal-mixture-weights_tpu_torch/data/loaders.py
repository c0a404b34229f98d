"""Minibatch loaders with a validation split (reference ``load_data``,
``functions/utils.py:86-121``; JAX ``data/loaders.py``).

The reference's drivers never call ``load_data`` (``load_full_data`` is
the entry they use), but it is part of its public surface. A loader here
is a shuffled index-batch stream over resident numpy arrays:
``MinibatchLoader`` yields ``(X, y)`` batches, reshuffling each epoch
like ``DataLoader(shuffle=True)`` and keeping the last partial batch.
Split and batch sizes are the reference's: CIFAR10 45000/5000 with one
5000-row validation batch, mnist 54000/6000 with one 6000-row batch,
LIBSVM 80/20 where the test loader is also the validation loader. The
split comes from a seeded numpy RNG, the same draws as the JAX package's.
"""

from __future__ import annotations

import numpy as np

from .images import IMAGE_LOADERS
from .svmlight import is_regression, load_svmlight


class MinibatchLoader:
    """Shuffled (or ordered) minibatch stream over resident arrays.

    Iterating yields ``(X_batch, y_batch)``; each new iteration draws a
    fresh permutation when ``shuffle=True``. ``len(loader)`` is the
    number of batches per epoch.
    """

    def __init__(self, X: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        if len(X) != len(y):
            raise ValueError(f"X/y length mismatch: {len(X)} vs {len(y)}")
        self.X, self.y = X, y
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return -(-len(self.y) // self.batch_size)

    def __iter__(self):
        order = (self._rng.permutation(len(self.y)) if self.shuffle
                 else np.arange(len(self.y)))
        for start in range(0, len(order), self.batch_size):
            rows = order[start:start + self.batch_size]
            yield self.X[rows], self.y[rows]


def load_data(dataset_name: str, batch_size: int = 32,
              data_dir: str = "datasets", seed: int = 0):
    """Reference ``load_data``: ``(trainloader, validateloader,
    testloader, feature_size, num_classes)``. For LIBSVM names the test
    loader is the validation loader and ``num_classes`` is 1 for the
    regression sets."""
    rng = np.random.RandomState(seed)
    if dataset_name in IMAGE_LOADERS:
        X_train, y_train, X_test, y_test = IMAGE_LOADERS[dataset_name](
            data_dir)
        n_val = {"CIFAR10": 5000, "mnist": 6000}[dataset_name]
        order = rng.permutation(len(y_train))
        val_rows, train_rows = order[:n_val], order[n_val:]
        train = MinibatchLoader(X_train[train_rows], y_train[train_rows],
                                batch_size, shuffle=True, seed=seed)
        validate = MinibatchLoader(X_train[val_rows], y_train[val_rows],
                                   n_val, shuffle=True, seed=seed + 1)
        test = MinibatchLoader(X_test, y_test, 10000, shuffle=False)
        return train, validate, test, X_train.shape[1], 10

    X, y = load_svmlight(dataset_name, data_dir)
    order = rng.permutation(len(y))
    cut = int(len(y) * 0.8)
    train_rows, test_rows = order[:cut], order[cut:]
    train = MinibatchLoader(X[train_rows], y[train_rows], batch_size,
                            shuffle=True, seed=seed)
    test = MinibatchLoader(X[test_rows], y[test_rows],
                           max(len(test_rows), 1), shuffle=True,
                           seed=seed + 1)
    num_classes = 1 if is_regression(dataset_name) else int(
        len(np.unique(y)))
    return train, test, test, X.shape[1], num_classes
