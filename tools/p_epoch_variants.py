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
``build/variants/p_epoch-<hash of the source and its headers>.so``,
all builds at once, unless a variant or a call before built the same
files; the compiler's report for the kernel timed (registers, stack,
spills) is printed per variant. Then every variant's staged kernel runs on the same
random inputs at the main path's shape (n_val 11983, J 50, C 10, B 16,
S 749), timed with CUDA events over ``--reps`` launches, the variants in
turns (in order, then reversed, ``--rounds`` times). It prints one JSON
object: each variant's readings in ms, sorted. A variant's launcher is
called with the signature its library exports: with a guard argument
when it has ``p_epoch_launch_split``, else the older one without.
``--guard`` takes one or more p-guards (``none``, ``clip`` at radius 1,
``simplex``; every kernel, with ``--lr``): each variant runs under each,
all in turns, and the output adds, per variant and guard, the simplex's
fixed-point rounds a step and in its longest step (one more launch with
the kernel's ``guard_rounds`` counter) and, when ``none`` is among them,
the guard's µs a step (the guarded launch's time less the unguarded one's,
over the steps). ``--kernel split`` times the split kernel instead at
``--J``, ``--C`` and ``--n-val``, each variant on its own cluster
(``@CLUSTER``), holding its row slices where its own layout
(``p_epoch_split_smem_bytes``) fits a block, and adds each one's µs a step
and ratio to the byte bound. ``--kernel split_tiled`` times the
class-tiled split kernel the same way: a source with
``p_epoch_launch_split_tiled`` (classes over the cluster) on the logits in
the class-split layout (``psolver_kernel.class_split``) at the package's
plan (or ``@CLUSTER``), an older one (J over the cluster) through
``p_epoch_launch_split`` at its own first rule (the smallest of 2, 4, 8,
16 whose CTAs hold their row slices, else the largest that streams them),
or ``@CLUSTER``.

To compare a commit's kernel with the working tree's, unpack that
commit's ``csrc/`` into a directory under ``build/`` (``git archive``)
and pass both sources. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
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
    ap.add_argument("--guard", nargs="+", choices=("none", "clip", "simplex"),
                    default=["none"], help="the p-guards, each in turn")
    ap.add_argument("--lr", type=float, default=1e-3)
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
    # one library a source and its headers' contents: a later call with
    # the same files (the same command at another shape) loads it again
    libs, procs = {}, {}
    for name, (src, inc) in sources.items():
        h = hashlib.sha256(open(src, "rb").read())
        for f in sorted(os.listdir(inc)):
            if f.endswith(".cuh"):
                h.update(open(os.path.join(inc, f), "rb").read())
        libs[name] = out_dir / f"p_epoch-{h.hexdigest()[:12]}.so"
        if not libs[name].exists() and libs[name] not in (
                libs[other] for other in procs):
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", inc, "-o",
                 str(libs[name]), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    symbol = {"staged": "21staged_p_epoch_kernel",
              "split": "20split_p_epoch_kernel",
              "split_tiled": "26split_tiled_p_epoch_kernel"}[args.kernel]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"p_epoch_variants: {name} did not build:\n{log}")
        with open(f"{libs[name]}.log", "w") as f:
            f.write(log)
    report = {}
    for name in sources:
        with open(f"{libs[name]}.log") as f:
            report[name] = {k: u for k, u in
                            cuda_build.parse_ptxas(f.read()).items()
                            if symbol in k}

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
    lr = args.lr
    # each launcher takes the guard's code and the guard_rounds pointer
    for name in sources:
        lib = ctypes.CDLL(str(libs[name]))
        # a library from before the class-tiled redesign passes its first
        # design's switch (tiled) to the split kernel's launcher and layout
        new_abi = hasattr(lib, "p_epoch_launch_split_tiled")
        old = () if new_abi else (0,)
        # a library whose split layout holds a guard's gather takes whether
        # the launch is guarded
        gabi = hasattr(lib, "p_epoch_split_guard_floats")
        lib.p_epoch_split_smem_bytes.restype = ctypes.c_size_t
        lib.p_epoch_split_smem_bytes.argtypes = [ctypes.c_int] * (
            5 + len(old) + gabi)
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
            launch[name] = (
                lambda code, rp, fn=fn, k=k, split=split, scratch=scratch:
                fn(*ptrs[:3], split.data_ptr(), *ptrs[4:], rp,
                   scratch.data_ptr(), S, B, J, C, n_val, 1, code, k, lr,
                   0.9, 1.0, stream))
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
            launch[name] = (lambda code, rp, fn=fn, k=k, hold=hold: fn(
                *ptrs, rp, S, B, J, C, 1, int(logits.data_ptr() % 16 == 0
                                              and J * C % 4 == 0),
                code, k, hold, 1, lr, 0.9, 1.0, stream))
            continue
        if args.kernel == "split":
            fn = lib.p_epoch_launch_split
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 11
                           + [ctypes.c_int] * (9 + len(old))
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            k = clusters[name] = clusters[name] or 2
            hold = [int(lib.p_epoch_split_smem_bytes(
                B, J, C, k, 1, *old, *((g,) if gabi else ()))
                <= cuda_build.SMEM_LIMIT) for g in (0, 1)]
            launch[name] = (lambda code, rp, fn=fn, k=k, hold=hold: fn(
                *ptrs, rp, S, B, J, C, 1, 1, code, k, hold[code != 0], *old,
                lr, 0.9, 1.0, stream))
            continue
        fn = lib.p_epoch_launch_staged
        fn.restype = ctypes.c_int
        if hasattr(lib, "p_epoch_launch_split"):
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            launch[name] = (lambda code, rp, fn=fn: fn(
                *ptrs, rp, S, B, J, C, 1, 1, code, lr, 0.9, 1.0, stream))
        else:
            if args.guard != ["none"]:
                sys.exit(f"p_epoch_variants: {name} has no p-guard")
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            launch[name] = (lambda code, rp, fn=fn: fn(
                *ptrs, S, B, J, C, 1, 1, lr, 0.9, stream))

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

    codes = {g: ("none", "clip", "simplex").index(g) for g in args.guard}
    # a reading's key: the variant, and its guard where there are several
    runs = {(name if len(codes) == 1 else f"{name}/{g}"): (name, g)
            for name in sources for g in codes}
    readings = {key: [] for key in runs}
    keys = list(runs)
    for _ in range(args.rounds):
        for key in keys + keys[::-1]:
            name, g = runs[key]
            readings[key].append(cuda_ms(
                lambda: launch[name](codes[g], None)))
    rounds = torch.zeros(2, dtype=torch.int32, device=dev)
    guard_rounds = {}
    for key, (name, g) in runs.items():
        if g == "simplex":
            if launch[name](codes[g], rounds.data_ptr()):
                sys.exit("p_epoch_variants: a launch failed")
            total, most = rounds.tolist()
            guard_rounds[key] = {"per_step": total / S, "max": most}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    mean = {key: sum(r) / len(r) for key, r in readings.items()}
    out = {"kernel": args.kernel, "guard": args.guard, "lr": lr,
           "shape": {"n_val": n_val, "J": J, "C": C, "B": B, "S": S},
           "ptxas": report,
           "ms": {key: sorted(r) for key, r in readings.items()},
           "guard_rounds": guard_rounds}
    if "none" in codes and len(codes) > 1:
        out["guard_us_per_step"] = {
            key: 1e3 * (mean[key] - mean[f"{name}/none"]) / S
            for key, (name, g) in runs.items() if g != "none"}
    if args.kernel != "staged":
        # the byte bound: logits, labels, positions, valid, p, buf, cv
        bound_ms = 4e3 * (n_val * J * C + n_val + 2 * S * B + 5 * J + 3) \
            / 3.35e12
        out.update({
            "cluster": clusters, "bound_ms": bound_ms,
            "us_per_step": {n: 1e3 * v / S for n, v in mean.items()},
            "over_bound": {n: v / bound_ms for n, v in mean.items()}})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
