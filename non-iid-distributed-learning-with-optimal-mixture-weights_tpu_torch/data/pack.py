"""Ragged clients -> dense, fixed-shape index sets.

The feature matrix lives on the device once as ``(N, D)`` and every
client is an int32 row-index set padded to a common ``N_max`` with a
validity mask (the reference keeps per-client Python lists of tensors,
``exp.py:68-72``). The client-epoch kernel gathers its batch rows through
these indices, so no ``(J, N_max, D)`` copy of the features is ever made;
padded slots contribute zero loss and zero updates through the mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientPack:
    """Fixed-shape client index sets over a shared sample axis."""

    idx: np.ndarray    # (J, N_max) int32 — global row ids, padded with 0
    mask: np.ndarray   # (J, N_max) float32 — 1 for real samples
    sizes: np.ndarray  # (J,) int32 — true per-client sample counts

    @property
    def num_clients(self) -> int:
        return self.idx.shape[0]

    @property
    def n_max(self) -> int:
        return self.idx.shape[1]

    @property
    def weights(self) -> np.ndarray:
        """Fixed sample-count mixture weights p_j = n_j / sum(n)."""
        s = self.sizes.astype(np.float64)
        return (s / s.sum()).astype(np.float32)


def pack_partitions(
    parts: list[np.ndarray],
    n_max: int | None = None,
    pad_clients_to: int | None = None,
) -> ClientPack:
    """Pack ragged per-client index lists into a ``ClientPack``.

    ``n_max`` can force a larger sample padding; ``pad_clients_to``
    appends empty clients. Empty clients have all-zero masks and zero
    aggregation weight.
    """
    sizes = np.array([len(p) for p in parts], dtype=np.int32)
    j = len(parts)
    if pad_clients_to is not None and pad_clients_to > j:
        sizes = np.concatenate([sizes, np.zeros(pad_clients_to - j, np.int32)])
        parts = list(parts) + [np.zeros(0, np.int64)] * (pad_clients_to - j)
        j = pad_clients_to
    # cap >= 1: an all-empty pack still needs a nonzero sample axis for
    # the fixed-shape kernels; the all-zero mask keeps it inert.
    cap = max(1, int(sizes.max()) if n_max is None else int(n_max))
    if cap < int(sizes.max()):
        raise ValueError(f"n_max={cap} < largest client ({int(sizes.max())})")
    idx = np.zeros((j, cap), dtype=np.int32)
    mask = np.zeros((j, cap), dtype=np.float32)
    for i, p in enumerate(parts):
        idx[i, : len(p)] = p
        mask[i, : len(p)] = 1.0
    return ClientPack(idx=idx, mask=mask, sizes=sizes)


def bucket_partitions(
    parts: list[np.ndarray],
    num_buckets: int,
    client_multiple: int = 1,
) -> tuple[list[ClientPack], np.ndarray]:
    """Group clients into size buckets, each packed to its own ``N_max``
    (JAX ``data/pack.py:77-116``).

    Clients are sorted by size, descending and stable, and split into
    ``num_buckets`` contiguous groups of equal count (at most one per
    client). Under heavy Dirichlet skew this keeps the short clients'
    epochs from running the largest client's step count.
    ``client_multiple > 1`` pads every bucket's client axis with empty
    clients up to a multiple of it.

    Returns ``(packs, order)``: one ``ClientPack`` per bucket, and the
    original index of every output slot in concatenated bucket order,
    ``-1`` for padded slots.
    """
    sizes = np.array([len(p) for p in parts])
    order = np.argsort(-sizes, kind="stable")
    num_buckets = max(1, min(num_buckets, len(parts)))
    packs, slots = [], []
    for g in np.array_split(order, num_buckets):
        j_padded = -(-len(g) // client_multiple) * client_multiple
        packs.append(
            pack_partitions([parts[i] for i in g], pad_clients_to=j_padded))
        slots.append(
            np.concatenate([g, np.full(j_padded - len(g), -1, g.dtype)]))
    return packs, np.concatenate(slots)


def split_train_val(
    parts: list[np.ndarray],
    val_fraction: float = 0.2,
    rng: np.random.RandomState | None = None,
):
    """Per-client 80/20 split with the 20% pooled for mixture-weight fitting.

    Reproduces the reference scripts' split (``exp.py:78-99``): for each
    client, shuffle local positions, take ``int(n_i * val_fraction)`` for
    the pooled validation set, keep the rest for training. Returns
    ``(train_parts, val_indices)`` in global row ids; ``val_indices``
    concatenates clients in order, as the reference does.
    """
    if rng is None:
        rng = np.random.RandomState()
    train_parts, val_chunks = [], []
    for p in parts:
        order = np.arange(len(p))
        rng.shuffle(order)
        cut = int(len(p) * val_fraction)
        val_chunks.append(p[order[:cut]])
        train_parts.append(p[order[cut:]])
    val_idx = (
        np.concatenate(val_chunks) if val_chunks else np.zeros(0, np.int64)
    )
    return train_parts, val_idx
