"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each library of ``BUILDS`` is one ``csrc/<source>.cu`` with a plain C
interface, compiled on its own with ``nvcc``, its flags and no PyTorch
headers, into ``build/torch_kernels/lib<name>-<hash>.so`` at the
repository root; ``client_epoch.cu`` is built once per row type of the
features (float32, bfloat16, float16). The hash covers the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited kernel is
rebuilt and a stale library is never loaded. The build happens at first
use; ``build()`` starts one ``nvcc`` per library, all at once. Importing this
module builds nothing, and nothing here runs on a machine without a
card (the kernel wrappers only reach it for CUDA tensors).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
# each library: its csrc/ source and the nvcc flags it adds
BUILDS = {
    "client_epoch": ("client_epoch", ()),
    "client_epoch_bf16": ("client_epoch", ("-DCLIENT_EPOCH_ROWS_BF16",)),
    "client_epoch_f16": ("client_epoch", ("-DCLIENT_EPOCH_ROWS_F16",)),
    "p_epoch": ("p_epoch", ()),
}
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


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + BUILDS[name][1]


def source_path(name: str) -> Path:
    """The ``csrc/`` source of library ``name``."""
    return CSRC_DIR / f"{BUILDS[name][0]}.cu"


def library_path(name: str) -> Path:
    """Where library ``name`` of ``BUILDS`` goes, keyed by the content of
    its source and of the headers it may include, and by its flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(BUILDS)) -> dict[str, float]:
    """Compile every named library that is missing, all ``nvcc``
    processes started together. Returns seconds per library built (0 for
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
            [nvcc, *_flags(name), "-o", str(tmp), str(source_path(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """Per compiled function of an ``nvcc -Xptxas -v`` log: its
    ``registers``, ``stack_bytes`` and ``spill_bytes`` (spill stores plus
    spill loads), keyed by the mangled name."""
    usage: dict[str, dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        m = m or re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[fn]["stack_bytes"] = int(m.group(1))
            usage[fn]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def ptxas_usage(name: str) -> dict[str, dict[str, int]]:
    """``parse_ptxas`` of the build log of library ``name`` (kept beside
    it by ``build``)."""
    return parse_ptxas(library_path(name).with_suffix(".log").read_text())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` of ``BUILDS``, built first if
    needed."""
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
