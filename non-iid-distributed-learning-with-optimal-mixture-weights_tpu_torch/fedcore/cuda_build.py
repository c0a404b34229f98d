"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
with ``nvcc`` and no PyTorch headers, into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root. The
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited kernel is rebuilt and a stale library is never loaded. The build happens at first use;
``build()`` starts one ``nvcc`` per source, all at once. Importing this
module builds nothing, and nothing here runs on a machine without a
card (the kernel wrappers only reach it for CUDA tensors).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
KERNEL_SOURCES = ("client_epoch", "p_epoch")
# bytes of dynamic shared memory one block may use on sm_90
SMEM_LIMIT = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by its content
    and that of the headers it may include."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together. Returns seconds per source built (0 for
    one already there). The compiler's resource report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


def check(err: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a launcher returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def kernel_or_plain(kernel_impl: str, wrapper, plain):
    """The epoch function a builder uses: ``"auto"`` is the kernel's
    wrapper (the kernel on CUDA tensors, its plain version on CPU ones),
    ``"plain"`` the plain version on any device — the reference run a
    kernel run is held against."""
    impls = {"auto": wrapper, "plain": plain}
    if kernel_impl not in impls:
        raise ValueError(f"kernel_impl must be 'auto' or 'plain', got "
                         f"{kernel_impl!r}")
    return impls[kernel_impl]
