"""Local-file image datasets: MNIST (IDX) and CIFAR10 (binary batches).

The reference loads both through torchvision with the ``data_tf``
transform (reference ``functions/utils.py:67-72``: ``x/255``,
normalize to ±1 via ``(x-0.5)/0.5``, flatten) and partitions the full
train split (``utils.py:124-156``). This box has zero network egress,
so instead of torchvision these are direct readers of the on-disk
formats torchvision itself caches:

- MNIST: IDX files (``train-images-idx3-ubyte`` etc., optionally
  ``.gz``), big-endian magic + dims header;
- CIFAR10: the ``cifar-10-batches-bin`` layout (``data_batch_N.bin``,
  ``test_batch.bin``; 1 label byte + 3072 CHW pixel bytes per record).

``data_tf`` parity notes: torchvision hands ``data_tf`` a PIL image, so
MNIST flattens (28, 28) row-major and CIFAR10 flattens **HWC** — the
binary files store CHW, so the reader transposes before flattening to
match the reference's feature order byte for byte.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}


def data_tf(x: np.ndarray) -> np.ndarray:
    """The reference's image transform (``utils.py:67-72``) for a batch:
    ``x/255`` then ``(x-0.5)/0.5``, flattened per sample."""
    x = np.asarray(x, dtype=np.float32) / 255.0
    x = (x - 0.5) / 0.5
    return x.reshape(x.shape[0], -1)


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (the MNIST container format), ``.gz`` or raw."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: not an IDX file (magic {zero:#x} "
                             f"dtype {dtype_code:#x})")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        dtype = _IDX_DTYPES[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path}: payload {data.size} != header {dims}")
    return data.reshape(dims).astype(dtype)


def _find(data_dir: str, names: list[str]) -> str:
    """First existing candidate path (each name also tried with .gz),
    searched in data_dir and the torchvision cache layouts under it."""
    subdirs = ["", "MNIST/raw", "mnist", "cifar-10-batches-bin"]
    for sub in subdirs:
        for name in names:
            for suffix in ("", ".gz"):
                p = os.path.join(data_dir, sub, name + suffix)
                if os.path.exists(p):
                    return p
    raise FileNotFoundError(f"{names[0]} not under {data_dir}")


def load_mnist(data_dir: str = "datasets"):
    """(X_train, y_train, X_test, y_test): 784-dim ±1 floats, int32
    labels — the reference's mnist pipeline (``utils.py:127-140``)."""
    X_train = read_idx(_find(data_dir, ["train-images-idx3-ubyte",
                                        "train-images.idx3-ubyte"]))
    y_train = read_idx(_find(data_dir, ["train-labels-idx1-ubyte",
                                        "train-labels.idx1-ubyte"]))
    X_test = read_idx(_find(data_dir, ["t10k-images-idx3-ubyte",
                                       "t10k-images.idx3-ubyte"]))
    y_test = read_idx(_find(data_dir, ["t10k-labels-idx1-ubyte",
                                       "t10k-labels.idx1-ubyte"]))
    return (
        data_tf(X_train), y_train.astype(np.int32),
        data_tf(X_test), y_test.astype(np.int32),
    )


def _read_cifar_batch(path: str):
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    # stored CHW; reference order is PIL->numpy HWC (see module docstring)
    pixels = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return pixels, labels


def load_cifar10(data_dir: str = "datasets"):
    """(X_train, y_train, X_test, y_test): 3072-dim ±1 floats in HWC
    order, int32 labels — the reference's CIFAR10 pipeline
    (``utils.py:141-156``)."""
    xs, ys = [], []
    for i in range(1, 6):
        X, y = _read_cifar_batch(_find(data_dir, [f"data_batch_{i}.bin"]))
        xs.append(X)
        ys.append(y)
    X_test, y_test = _read_cifar_batch(_find(data_dir, ["test_batch.bin"]))
    return (
        data_tf(np.concatenate(xs)), np.concatenate(ys),
        data_tf(X_test), y_test,
    )


IMAGE_LOADERS = {"mnist": load_mnist, "CIFAR10": load_cifar10}
