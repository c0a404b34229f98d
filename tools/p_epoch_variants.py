#!/usr/bin/env python3
"""Time variants of ``csrc/p_epoch.cu``'s staged kernel against each other.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/p_epoch_variants.py NAME=SOURCE.cu[:INCLUDE_DIR] ...

Each variant is built with ``cuda_build.NVCC_FLAGS`` (plus ``-I
INCLUDE_DIR``, default the source's own directory) into
``build/variants/NAME.so``, all builds at once; the compiler's report for
the staged kernel at C = 10 (registers, stack, spills) is printed per
variant. Then every variant's staged kernel runs, unguarded, on the same
random inputs at the main path's shape (n_val 11983, J 50, C 10, B 16,
S 749), timed with CUDA events over ``--reps`` launches, the variants in
turns (in order, then reversed, ``--rounds`` times). It prints one JSON
object: each variant's readings in ms, sorted. A variant's launcher is
called with the signature its library exports: with a guard argument
when it has ``p_epoch_launch_split``, else the older one without.

To compare a commit's kernel with the working tree's, unpack that
commit's ``csrc/`` into a directory under ``build/`` (``git archive``)
and pass both sources. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", metavar="NAME=SOURCE[:INCLUDE]")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("p_epoch_variants: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import cuda_build
    from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches

    out_dir = cuda_build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        src, _, inc = rest.partition(":")
        sources[name] = (src, inc or os.path.dirname(os.path.abspath(src)))
    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", inc, "-o",
         str(out_dir / f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, inc) in sources.items()}
    report = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"p_epoch_variants: {name} did not build:\n{log}")
        report[name] = {f: u for f, u in cuda_build.parse_ptxas(log).items()
                        if "21staged_p_epoch_kernelILi10ELb1E" in f}

    n_val, J, C, B = 11983, 50, 10, 16
    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    logits = (torch.randn((n_val, J, C), generator=gen) * 0.1).to(dev)
    y = torch.randint(0, C, (n_val,), generator=gen,
                      dtype=torch.int32).to(dev)
    p = torch.full((J,), 1.0 / J, device=dev)
    buf = torch.zeros(J, device=dev)
    cv = torch.ones(J, device=dev)
    pos = epoch_batches(n_val, B, generator=gen)[0]
    valid = batch_valid(pos, n_val).to(dev)
    pos = pos.to(dev, torch.int32)
    S = pos.shape[0]
    outs = [torch.empty(J, device=dev), torch.empty(J, device=dev),
            torch.empty(3, device=dev)]
    ptrs = [t.data_ptr() for t in (p, buf, cv, logits, y, pos, valid, *outs)]
    stream = torch.cuda.current_stream().cuda_stream
    launch = {}
    for name in sources:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = lib.p_epoch_launch_staged
        fn.restype = ctypes.c_int
        if hasattr(lib, "p_epoch_launch_split"):
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            launch[name] = (lambda fn=fn: fn(
                *ptrs, None, S, B, J, C, 1, 1, 0, 1e-3, 0.9, 0.0, stream))
        else:
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            launch[name] = (lambda fn=fn: fn(
                *ptrs, S, B, J, C, 1, 1, 1e-3, 0.9, stream))

    def cuda_ms(fn):
        if fn():
            sys.exit("p_epoch_variants: a launch failed")
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    names = list(sources)
    readings = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            readings[name].append(cuda_ms(launch[name]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({
        "shape": {"n_val": n_val, "J": J, "C": C, "B": B, "S": S},
        "ptxas_staged_C10": report,
        "ms": {name: sorted(r) for name, r in readings.items()}}))


if __name__ == "__main__":
    main()
