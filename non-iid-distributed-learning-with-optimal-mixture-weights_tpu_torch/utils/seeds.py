"""Splittable sub-seed derivation for composed seeded grammars.

A copy of the JAX package's ``utils/seeds.py``, bit for bit: the same
master seed and label path give the same sub-seed in both packages, so
a fault plan or scenario seeded through the port draws the schedule the
JAX package draws.

Each seeded grammar (a fault spec, a chaos or load spec) owns one
``seed`` and expands it into a reproducible schedule via
``np.random.RandomState(seed)``. Composing several under ONE master
seed needs per-grammar sub-seeds, and ``seed``/``seed+1``/``seed+k``
arithmetic collides: master 7's "chaos" stream would be master 8's
"faults" stream.

:func:`derive_seed` is a keyed hash of ``(master, label path)``:
distinct labels give independent streams under one master, distinct
masters give independent streams under one label, and the derivation
is a pure function of its arguments. The hash is blake2b, truncated to
32 bits because that is the seed domain ``np.random.RandomState``
accepts. The label separator and digest size are spelled out below
rather than left to a library default: changing either changes every
derived stream.
"""

from __future__ import annotations

import hashlib

import numpy as np

#: Byte separating path components inside the hash input. A dedicated
#: separator keeps ("ab", "c") and ("a", "bc") distinct — without it
#: two different label paths could concatenate to one hash input.
_SEP = b"\x1f"

#: RandomState's seed domain: [0, 2**32).
_SEED_BITS = 32


def derive_seed(master: int, *labels) -> int:
    """One 32-bit sub-seed for ``labels`` under ``master``.

    ``labels`` is a path of strings/ints naming the stream (e.g.
    ``("faults",)`` or ``("scenario", 17)``). Deterministic, splittable
    (different paths never share a stream by construction of the
    keyed hash), and valid as a ``np.random.RandomState`` seed.
    """
    master = int(master)
    if master < 0:
        raise ValueError(f"master seed must be >= 0, got {master}")
    if not labels:
        raise ValueError(
            "derive_seed needs at least one label — deriving the "
            "master back out of itself would recreate the shared "
            "stream this helper exists to remove")
    h = hashlib.blake2b(digest_size=_SEED_BITS // 8)
    h.update(str(master).encode("ascii"))
    for lab in labels:
        if not isinstance(lab, (str, int)):
            raise TypeError(
                f"derive_seed labels must be str or int, got "
                f"{type(lab).__name__}")
        h.update(_SEP)
        h.update(str(lab).encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


def derive_rng(master: int, *labels) -> np.random.RandomState:
    """A ``RandomState`` over :func:`derive_seed` — the one-liner the
    scenario plans draw from."""
    return np.random.RandomState(derive_seed(master, *labels))
