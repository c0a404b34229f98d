"""ctypes binding for the repository's native C++ svmlight parser.

The source is the repository's ``native/svmlight_parser.cpp`` (a plain C
interface, no pybind11), the one the JAX package's ``native_io.py``
binds. This package keeps its own copy of the binding and builds its
own library with ``g++`` at first use, into the gitignored
``build/torch_kernels/`` beside the CUDA kernels, named by a hash of the
source and flags so an edited source is rebuilt; it never writes into
``native/``. ``data/svmlight.py`` falls back to sklearn's parser when the
library cannot be built or a parse fails, so this is an accelerator
only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .fedcore.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "svmlight_parser.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsvmlight_parser-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded parser, built first if needed. Raises ImportError when
    it cannot be built or loaded."""
    try:
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError) as e:
        raise ImportError(f"cannot build native svmlight parser: {e}") from e
    lib.svmlight_parse.restype = ctypes.c_int
    lib.svmlight_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.svmlight_free.restype = None
    lib.svmlight_free.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_double)]
    return lib


def load_svmlight(path: str):
    """Parse a LIBSVM file -> ``(X (n, d) float32 dense, y (n,) float64)``.

    Values are read as doubles and rounded to float32, as sklearn's
    reader and ``.astype(np.float32)`` do. Raises ImportError if the
    library cannot be built or loaded, OSError on a parse failure."""
    lib = _load()
    xp = ctypes.POINTER(ctypes.c_float)()
    yp = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.svmlight_parse(str(path).encode(), ctypes.byref(xp),
                            ctypes.byref(yp), ctypes.byref(rows),
                            ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"native svmlight parse failed (rc={rc}): {path}")
    n, d = rows.value, cols.value
    try:
        X = np.ctypeslib.as_array(xp, shape=(n, d)).copy()
        y = np.ctypeslib.as_array(yp, shape=(n,)).copy()
    finally:
        lib.svmlight_free(xp, yp)
    return X, y
