#!/usr/bin/env python3
"""Time variants of ``csrc/p_epoch.cu``'s staged, split or class-tiled
split kernel.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/p_epoch_variants.py NAME=SOURCE.cu[:INCLUDE_DIR] ...
    python3 tools/p_epoch_variants.py --kernel split --J 400 \
        NAME=SOURCE.cu[:INCLUDE_DIR]@CLUSTER ...
    python3 tools/p_epoch_variants.py --kernel split_tiled --n-val 1262 \
        --C 105 parent=build/parent/<pkg>_torch/csrc/p_epoch.cu \
        new=<pkg>_torch/csrc/p_epoch.cu

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
``--kernel split`` times the split kernel instead at ``--J``, ``--C``
and ``--n-val`` (with ``--guard``'s p-guard, radius 1 for ``clip``),
each variant on its own cluster (``@CLUSTER``), holding
its row slices where its own layout (``p_epoch_split_smem_bytes``) fits
a block, and adds each one's µs a step and ratio to the byte bound.
``--kernel split_tiled`` times the class-tiled split kernel the same way:
a source with ``p_epoch_launch_split_tiled`` (classes over the cluster)
on the logits in the class-split layout (``psolver_kernel.class_split``)
at the package's plan (or ``@CLUSTER``), an older one (J over the
cluster) through ``p_epoch_launch_split`` at its own first rule (the
smallest of 2, 4, 8, 16 whose CTAs hold their row slices, else the
largest that streams them), or ``@CLUSTER``.

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
    ap.add_argument("--kernel", choices=("staged", "split", "split_tiled"),
                    default="staged")
    ap.add_argument("--n-val", type=int, default=11983)
    ap.add_argument("--J", type=int, default=50)
    ap.add_argument("--C", type=int, default=10)
    ap.add_argument("--guard", choices=("none", "clip", "simplex"),
                    default="none", help="split kernel: the p-guard")
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
    sources, clusters = {}, {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        rest, _, k = rest.partition("@")
        src, _, inc = rest.partition(":")
        sources[name] = (src, inc or os.path.dirname(os.path.abspath(src)))
        clusters[name] = int(k) if k else None
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
        symbol = {"staged": "21staged_p_epoch_kernelILi10ELb1E",
                  "split": "20split_p_epoch_kernel",
                  "split_tiled": "26split_tiled_p_epoch_kernel"}[args.kernel]
        report[name] = {f: u for f, u in cuda_build.parse_ptxas(log).items()
                        if symbol in f}

    n_val, J, C, B = args.n_val, args.J, args.C, 16
    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    if args.kernel != "staged":  # large: drawn on the card
        logits = torch.randn((n_val, J, C), device=dev, generator=torch.
                             Generator(device=dev).manual_seed(args.seed))
        logits /= J ** 0.5
    else:
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
    launch, keep = {}, {}
    code = ("none", "clip", "simplex").index(args.guard)
    for name in sources:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        # a library from before the class-tiled redesign passes its first
        # design's switch (tiled) to the split kernel's launcher and layout
        new_abi = hasattr(lib, "p_epoch_launch_split_tiled")
        old = () if new_abi else (0,)
        lib.p_epoch_split_smem_bytes.restype = ctypes.c_size_t
        lib.p_epoch_split_smem_bytes.argtypes = [ctypes.c_int] * (
            5 + len(old))
        if args.kernel == "split_tiled" and new_abi:
            from fedamw_tpu_torch.fedcore import psolver_kernel as pk
            fn = lib.p_epoch_launch_split_tiled
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            plan = pk.launch_plan(B, J, C, kernel="split_tiled",
                                  max_cluster=pk.split_max_cluster(0),
                                  cluster=clusters[name])
            k = clusters[name] = plan.cluster
            split = pk.class_split(logits, k)
            scratch = torch.empty(k * 3 * (-(-J // 4) * 4), device=dev)
            keep[name] = (split, scratch)
            launch[name] = (lambda fn=fn, k=k, split=split, scratch=scratch:
                            fn(*ptrs[:3], split.data_ptr(), *ptrs[4:], None,
                               scratch.data_ptr(), S, B, J, C, n_val, 1,
                               code, k, 1e-3, 0.9, 1.0, stream))
            continue
        if args.kernel == "split_tiled":
            # the first design: J over the cluster, its own rule
            fn = lib.p_epoch_launch_split
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])

            def fits(k, hold, lib=lib):
                return lib.p_epoch_split_smem_bytes(
                    B, J, C, k, hold, 1) <= cuda_build.SMEM_LIMIT
            k = clusters[name]
            if k is None:
                k = next((k for k in (2, 4, 8, 16) if fits(k, 1)), 16)
            hold = int(fits(k, 1))
            clusters[name] = k
            launch[name] = (lambda fn=fn, k=k, hold=hold: fn(
                *ptrs, None, S, B, J, C, 1, int(logits.data_ptr() % 16 == 0
                                                and J * C % 4 == 0),
                code, k, hold, 1, 1e-3, 0.9, 1.0, stream))
            continue
        if args.kernel == "split":
            fn = lib.p_epoch_launch_split
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 11
                           + [ctypes.c_int] * (9 + len(old))
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            k = clusters[name] = clusters[name] or 2
            hold = int(lib.p_epoch_split_smem_bytes(B, J, C, k, 1, *old)
                       <= cuda_build.SMEM_LIMIT)
            launch[name] = (lambda fn=fn, k=k, hold=hold: fn(
                *ptrs, None, S, B, J, C, 1, 1, code, k, hold, *old, 1e-3, 0.9,
                1.0, stream))
            continue
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
    out = {"kernel": args.kernel, "guard": args.guard,
           "shape": {"n_val": n_val, "J": J, "C": C, "B": B, "S": S},
           "ptxas": report,
           "ms": {name: sorted(r) for name, r in readings.items()}}
    if args.kernel != "staged":
        # the byte bound: logits, labels, positions, valid, p, buf, cv
        bound_ms = 4e3 * (n_val * J * C + n_val + 2 * S * B + 5 * J + 3) \
            / 3.35e12
        mean = {name: sum(r) / len(r) for name, r in readings.items()}
        out.update({
            "cluster": clusters, "bound_ms": bound_ms,
            "us_per_step": {n: 1e3 * v / S for n, v in mean.items()},
            "over_bound": {n: v / bound_ms for n, v in mean.items()}})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
