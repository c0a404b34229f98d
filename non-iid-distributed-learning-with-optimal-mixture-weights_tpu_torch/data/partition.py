"""Non-IID client partitioning.

``dirichlet_partition`` reproduces the reference's label-skew partitioner
``get_Dirichlet_distribution`` (``functions/utils.py:314-349``) bit-exactly
for the same seed: the legacy NumPy global RNG the reference seeds with
``np.random.seed(2020)`` *is* a ``RandomState``, so driving a
``RandomState(seed)`` through the identical call sequence yields the
identical client index sets. This is the one place where exact
(non-statistical) parity with the torch reference is achievable, and the
parity tests rely on it.
"""

from __future__ import annotations

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_partitions: int,
    alpha: float,
    seed: int = 2020,
    min_size: int = 10,
    verbose: bool = False,
    max_retries: int = 10000,
):
    """Partition sample indices across clients with per-class Dirichlet skew.

    Algorithm (reference ``functions/utils.py:314-349``): per class, draw
    Dirichlet(alpha) proportions over clients, damp clients already at or
    above the average size (``p * (len(idx_j) < N/n)``), add ``1/len(idx_k)``,
    renormalize, and split the shuffled class indices at the cumulative
    proportions. Retry the whole assignment until every client has at
    least ``min_size`` samples (reference hard-codes 10). The reference
    hard-codes ``seed=2020`` (``utils.py:320``); here it is a parameter
    defaulting to the same value.

    ``min_size=0`` disables the retry (needed at scale: with few classes
    and thousands of clients the min-size-10 constraint is unsatisfiable
    and the reference's unbounded loop would spin forever — SURVEY.md
    hard part 1). ``max_retries`` bounds the loop and raises instead of
    hanging.

    Returns ``(parts, class_counts)``: a list of ``num_partitions`` int64
    index arrays (shuffled within each client, as in the reference) and a
    ``{client: {label: count}}`` dict.
    """
    labels = np.asarray(labels)
    n_total = len(labels)
    classes = np.unique(labels)
    rng = np.random.RandomState(seed)

    smallest = -1
    attempts = 0
    idx_batch: list[list[int]] = []
    while smallest < min_size:
        attempts += 1
        if attempts > max_retries:
            raise RuntimeError(
                f"dirichlet_partition: could not satisfy min_size={min_size} "
                f"for {num_partitions} clients over {len(classes)} classes "
                f"after {max_retries} tries; lower min_size (0 disables) or "
                f"num_partitions"
            )
        idx_batch = [[] for _ in range(num_partitions)]
        smallest = 0
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, num_partitions))
            # Balance trick: zero the share of clients already >= average
            # size, then add a uniform floor of one sample's worth.
            under_avg = np.array(
                [len(b) < n_total / num_partitions for b in idx_batch]
            )
            proportions = proportions * under_avg + 1.0 / len(idx_k)
            proportions = proportions / proportions.sum()
            cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for j, split in enumerate(np.split(idx_k, cuts)):
                idx_batch[j] = idx_batch[j] + split.tolist()
            smallest = min(len(b) for b in idx_batch)

    parts = []
    for j in range(num_partitions):
        arr = np.array(idx_batch[j], dtype=np.int64)
        rng.shuffle(arr)
        parts.append(arr)

    class_counts = {}
    for j, part in enumerate(parts):
        uniq, cnt = np.unique(labels[part], return_counts=True)
        class_counts[j] = dict(zip(uniq.tolist(), cnt.tolist()))
    if verbose:
        print("Data statistics: %s" % str(class_counts))
    return parts, class_counts


def uniform_partition(
    n: int, num_partitions: int, rng: np.random.RandomState | None = None
):
    """IID split: shuffled indices in near-equal chunks.

    Reference behavior for ``alpha == -1`` (``functions/utils.py:159-160``).
    """
    if rng is None:
        rng = np.random.RandomState()
    return list(np.array_split(rng.permutation(n), num_partitions))
