"""Synthetic data generators.

``generate_synthetic`` replicates the reference's FedProx-style non-IID
regression generator (``functions/utils.py:269-312``) with the same RNG
call sequence, so a ``RandomState(seed)`` here matches the reference's
globally-seeded run exactly. ``synthetic_classification`` is our own
fallback for benchmarks/tests on a box with no network egress: it mimics
a named LIBSVM dataset's shape signature (n, d, classes) with separable
Gaussian class clusters plus label noise.
"""

from __future__ import annotations

import numpy as np


def generate_synthetic(
    alpha: float,
    beta: float,
    d: int,
    local_size: int,
    partitions: int,
    rng: np.random.RandomState | None = None,
    verbose: bool = False,
):
    """Non-IID synthetic regression, reference ``functions/utils.py:269-312``.

    Client feature means are drawn ``u_i ~ N(0, alpha)`` (data
    heterogeneity) and client model spreads ``v_i ~ N(0, beta)`` (model
    heterogeneity); targets are ``y = -X @ w_i + N(0, 0.2)`` with
    ``w_i ~ N(1, v_i I)``. Returns
    ``(X_train (J, n, d), y_train (J, n), X_test, y_test, data_hete, model_hete)``.
    """
    if rng is None:
        rng = np.random.RandomState()
    if local_size == 0:
        samples_per_user = rng.lognormal(4, 2, partitions).astype(int) + 50
    else:
        samples_per_user = np.full(partitions, local_size, dtype=int)
    if verbose:
        print(">>> Sample per user: {}".format(samples_per_user.tolist()))

    num_train = int(samples_per_user.sum())
    num_test = num_train // 4
    # Pad to the largest client so the lognormal-sizes branch works too
    # (the reference allocates (J, local_size, d) and its local_size==0
    # branch can never run); fixed local_size keeps the exact shape.
    n_pad = int(samples_per_user.max())
    X_train = np.zeros((partitions, n_pad, d))
    y_train = np.zeros((partitions, n_pad))

    u = rng.normal(0, alpha, partitions)
    v = rng.normal(0, beta, partitions)

    X_test = rng.multivariate_normal(np.zeros(d), np.eye(d), num_test)
    w_target = np.ones(d)
    y_test = -X_test @ w_target

    model_hete = 0.0
    for i in range(partitions):
        xx = rng.multivariate_normal(np.ones(d) * u[i], np.eye(d), samples_per_user[i])
        ww = rng.multivariate_normal(np.ones(d), np.eye(d) * v[i])
        yy = -xx @ ww + rng.normal(0, 0.2, samples_per_user[i])
        model_hete += float(np.linalg.norm(yy - (-xx @ w_target))) / num_train
        X_train[i, : samples_per_user[i]] = xx
        y_train[i, : samples_per_user[i]] = yy

    X_flat = X_train.reshape(-1, d)
    C_global = X_flat.T @ X_flat / X_flat.shape[0]
    data_hete = 0.0
    for i in range(partitions):
        C_local = X_train[i].T @ X_train[i] / X_train[i].shape[0]
        data_hete += float(np.linalg.norm(C_global - C_local)) / partitions
    if verbose:
        print(
            "Data heterogeneity: {}, model heterogeneity: {}".format(
                data_hete, model_hete
            )
        )
    return X_train, y_train, X_test, y_test, data_hete, model_hete


def synthetic_classification(
    num_examples: int,
    dimensional: int,
    num_classes: int,
    seed: int = 0,
    test_fraction: float = 0.25,
    cluster_scale: float = 2.0,
    label_noise: float = 0.05,
):
    """Gaussian-blob classification stand-in for an absent LIBSVM file.

    Returns ``(X_train, y_train, X_test, y_test)`` with float32 features
    and int32 labels in ``[0, num_classes)``. Deterministic in ``seed``.
    """
    rng = np.random.RandomState(seed)
    n_test = int(num_examples * test_fraction)
    n = num_examples + n_test
    centers = rng.normal(0.0, cluster_scale, size=(num_classes, dimensional))
    y = rng.randint(0, num_classes, size=n)
    X = centers[y] + rng.normal(0.0, 1.0, size=(n, dimensional))
    flip = rng.rand(n) < label_noise
    y[flip] = rng.randint(0, num_classes, size=int(flip.sum()))
    X = X.astype(np.float32)
    y = y.astype(np.int32)
    return X[:num_examples], y[:num_examples], X[num_examples:], y[num_examples:]
