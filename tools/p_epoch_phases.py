#!/usr/bin/env python3
"""Where one step of ``p_epoch``'s staged, split or class-tiled split
kernel spends its time.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/p_epoch_phases.py [--n-val 11983 --J 50 --C 10 --B 16]
    python3 tools/p_epoch_phases.py --kernel split --J 400 --cluster all
    python3 tools/p_epoch_phases.py --kernel split --J 1024 --C 7 \\
        --n-val 92556 --source build/parent/csrc
    python3 tools/p_epoch_phases.py --kernel split_tiled --n-val 1262 \\
        --C 105 --cluster all
    python3 tools/p_epoch_phases.py --kernel split --J 1024 --C 7 \\
        --n-val 92556 --cluster 4,8,16 --guard simplex --lr 1e-2

It compiles a ``csrc/`` directory's ``p_epoch.cu`` (``--source``, default
the package's) twice, as it is and with ``-DP_EPOCH_PHASE_CLOCKS`` (thread
0 of the staged kernel, or of the split kernel's rank 0, sums ``clock64``
cycles per phase of its steps; the normal build has none of it). It
launches both builds on random inputs (defaults: FedAMW's p-solve at
mnist, J=50, validation batch 16) through the library's own C entry
points, so a source from another commit is measured the same way, and
prints one JSON object: cycles per step in each phase, the clock rate
implied by the instrumented launch's CUDA-event time, each phase in µs
per step, and the instrumented and normal kernels' ms on the same inputs
(the cost of the clocks), in turns. For the split kernel ``--cluster``
takes one size, ``plan`` (the port's launch plan) or ``all`` (every size
whose CTAs fit, each holding its rows where its layout allows); each
size is its own entry. ``--kernel split_tiled`` times the class-tiled
split kernel the same way (rank 0's thread 0; the phase names come from
the library, ``p_epoch_tiled_phase_names``): a source with
``p_epoch_launch_split_tiled`` (classes over the cluster) gets its
logits in the class-split layout (``psolver_kernel.class_split``) and
takes clusters 1 to 16, an older one (J over the cluster) 2 to 16
through ``p_epoch_launch_split``. ``--guard clip|simplex`` launches every
kernel with that p-guard (clip at radius 1; ``--lr`` the step): the
guard is a phase of its own where the library names one
(``p_epoch_phase_names``, ``p_epoch_split_phase_names``; older sources
count it in the update; the split kernel's guard also by its parts, the
loads, the first sum, the rounds and the write,
``guard_parts_us_per_step``), and each entry adds the normal build's
unguarded ms in the same turns, the guard's µs a step (the guarded launch
less the unguarded one, over the steps; any source) and the simplex's
fixed-point rounds a step and in its longest step (the kernel's
``guard_rounds`` counter). ``--cluster`` also takes a comma-separated
list of sizes. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

# the PHASE marks of csrc/p_epoch.cu before the guard had a phase of its
# own (newer libraries name theirs: p_epoch_phase_names), in order (the
# element-wise copy path counts its whole copy issue in "copy")
PHASES = ("copy_expect_tx", "copy_syncwarp", "copy_fence", "copy",
          "prefetch_loads", "valid_count", "wait_rows", "z", "loss", "h",
          "barrier_1", "update", "barrier_2_shift")
# the SPHASE marks of the split kernel, likewise (p_epoch_split_phase_names)
SPLIT_PHASES = ("copy_issue", "row_info", "valid_count", "wait_rows",
                "z", "exchange", "loss", "h", "barrier", "update")
CLUSTERS = (2, 4, 8, 16)
TILED_CLUSTERS = (1, 2, 4, 8, 16)


def _build(cuda_build, src_dir, out_dir):
    """The normal and the clock build of ``src_dir/p_epoch.cu``, both
    compiled at once unless already there; returns their paths."""
    src = os.path.join(src_dir, "p_epoch.cu")
    h = hashlib.sha256()
    for name in sorted(os.listdir(src_dir)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(src_dir, name), "rb") as f:
                h.update(f.read())
    tag = h.hexdigest()[:12]
    paths = {"normal": os.path.join(out_dir, f"p_epoch-{tag}.so"),
             "clocks": os.path.join(out_dir, f"p_epoch-{tag}-phases.so")}
    procs = []
    for kind, path in paths.items():
        if os.path.exists(path):
            continue
        extra = ["-DP_EPOCH_PHASE_CLOCKS"] if kind == "clocks" else []
        procs.append((path, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *extra, "-I",
             src_dir, "-o", path, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"p_epoch_phases: {path} did not build:\n{log}")
        with open(path + ".log", "w") as f:
            f.write(log)
    return paths


def _bind(path):
    lib = ctypes.CDLL(path)
    # a library from before the class-tiled redesign passes its first
    # design's switch (tiled) to the split kernel's launcher and layout
    lib.old_tiled = not hasattr(lib, "p_epoch_launch_split_tiled")
    lib.p_epoch_launch_staged.restype = ctypes.c_int
    lib.p_epoch_launch_staged.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.p_epoch_launch_split.restype = ctypes.c_int
    lib.p_epoch_launch_split.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * (9 + lib.old_tiled)
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    # a library whose split layout holds a guard's gather takes whether the
    # launch is guarded
    lib.guard_abi = hasattr(lib, "p_epoch_split_guard_floats")
    lib.p_epoch_split_smem_bytes.restype = ctypes.c_size_t
    lib.p_epoch_split_smem_bytes.argtypes = [ctypes.c_int] * (
        5 + lib.old_tiled + lib.guard_abi)
    for name in ("p_epoch_phase_clocks", "p_epoch_split_phase_clocks",
                 "p_epoch_tiled_phase_clocks", "p_epoch_guard_part_clocks"):
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("p_epoch_phase_names", "p_epoch_split_phase_names",
                 "p_epoch_tiled_phase_names"):
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_char_p
    if hasattr(lib, "p_epoch_launch_split_tiled"):
        lib.p_epoch_launch_split_tiled.restype = ctypes.c_int
        lib.p_epoch_launch_split_tiled.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return lib


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("staged", "split", "split_tiled"),
                    default="staged")
    ap.add_argument("--n-val", type=int, default=11983)
    ap.add_argument("--J", type=int, default=50)
    ap.add_argument("--C", type=int, default=10)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--cluster", default="plan",
                    help="split kernels: sizes (comma-separated), 'plan' or "
                    "'all'")
    ap.add_argument("--guard", choices=("none", "clip", "simplex"),
                    default="none")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--source", default=None,
                    help="a csrc/ directory (default: the package's)")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("p_epoch_phases: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import cuda_build
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches

    n_val, J, C, B = args.n_val, args.J, args.C, args.B
    src_dir = os.path.abspath(args.source or str(cuda_build.CSRC_DIR))
    out_dir = str(cuda_build.BUILD_DIR.parent / "phases")
    os.makedirs(out_dir, exist_ok=True)
    paths = _build(cuda_build, src_dir, out_dir)
    libs = {kind: _bind(path) for kind, path in paths.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    logits = torch.randn((n_val, J, C), generator=gen,
                         device=dev) / J ** 0.5
    y = torch.randint(0, C, (n_val,), generator=gen, device=dev,
                      dtype=torch.int32)
    p = torch.full((J,), 1.0 / J, device=dev)
    buf = torch.zeros(J, device=dev)
    cv = torch.ones(J, device=dev)
    pos = epoch_batches(n_val, B, generator=torch.Generator().manual_seed(
        args.seed))[0]
    valid = batch_valid(pos, n_val).to(dev)
    pos = pos.to(dev, torch.int32)
    S = pos.shape[0]
    outs = [torch.empty(J, device=dev), torch.empty(J, device=dev),
            torch.empty(3, device=dev)]
    ptrs = [t.data_ptr() for t in (p, buf, cv, logits, y, pos, valid,
                                   *outs)]
    code = ("none", "clip", "simplex").index(args.guard)
    lr = args.lr
    stream = torch.cuda.current_stream().cuda_stream
    bulk = int(pk.bulk_rows(logits))
    k_max = pk.split_max_cluster(0)

    tiled = args.kernel == "split_tiled"
    # classes over the cluster (a launcher of its own), or the first
    # class-tiled design's J over the cluster
    by_class = tiled and hasattr(libs["normal"], "p_epoch_launch_split_tiled")
    sizes = (TILED_CLUSTERS if by_class else CLUSTERS)
    if args.kernel == "staged":
        plan = pk.launch_plan(B, J, C)
        if plan.kernel != "staged":
            sys.exit(f"p_epoch_phases: B={B}, J={J}, C={C} runs {plan}")
        configs = [None]
    elif args.cluster == "plan":
        plan = pk.launch_plan(B, J, C, max_cluster=k_max,
                              kernel="split_tiled" if tiled else None)
        if plan.kernel != args.kernel:
            sys.exit(f"p_epoch_phases: B={B}, J={J}, C={C} runs {plan}")
        configs = [plan.cluster]
    elif args.cluster == "all":
        configs = [k for k in sizes if k <= k_max and (not by_class or k <= C)]
    else:
        configs = [int(v) for v in args.cluster.split(",")]
    layouts = {}

    # a launch of lib's kernel at cluster k with guard g, guard_rounds rp
    def launcher(lib, k, g=code, rp=None):
        if k is None:
            return lambda: lib.p_epoch_launch_staged(
                *ptrs, rp, S, B, J, C, 1, bulk, g, lr, 0.9, 1.0, stream)
        if by_class:
            if k not in layouts:
                plan = pk.launch_plan(B, J, C, kernel="split_tiled",
                                      max_cluster=k_max, cluster=k)
                layouts[k] = (plan, pk.class_split(logits, k),
                              torch.empty(k * 3 * (-(-J // 4) * 4),
                                          device=dev))
            plan, split, scratch = layouts[k]
            return lambda: lib.p_epoch_launch_split_tiled(
                *ptrs[:3], split.data_ptr(), *ptrs[4:], rp,
                scratch.data_ptr(), S, B, J, C, n_val, 1, g, k, lr, 0.9, 1.0,
                stream)
        old = (int(tiled),) if lib.old_tiled else ()
        gx = (int(g != 0),) if lib.guard_abi else ()
        hold = int(lib.p_epoch_split_smem_bytes(
            B, J, C, k, 1, *old, *gx) <= cuda_build.SMEM_LIMIT)
        return lambda: lib.p_epoch_launch_split(
            *ptrs, rp, S, B, J, C, 1, bulk, g, k, hold, *old, lr, 0.9, 1.0,
            stream)

    def cuda_ms(fn):
        if fn():
            sys.exit("p_epoch_phases: a launch failed")
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    names = PHASES if args.kernel == "staged" else SPLIT_PHASES
    read = ("p_epoch_phase_clocks" if args.kernel == "staged"
            else "p_epoch_split_phase_clocks")
    named = ("p_epoch_phase_names" if args.kernel == "staged"
             else "p_epoch_split_phase_names")
    if tiled:
        named, read = "p_epoch_tiled_phase_names", "p_epoch_tiled_phase_clocks"
    if hasattr(libs["clocks"], named):
        names = getattr(libs["clocks"], named)().decode().split(",")
    rounds = torch.zeros(2, dtype=torch.int32, device=dev)
    # the byte bound: logits, labels, positions, valid, p, buf, cv
    nbytes = 4 * (n_val * J * C + n_val + 2 * S * B + 5 * J + 3)
    bound_ms = 1e3 * nbytes / 3.35e12
    entries = []
    for k in configs:
        run = {kind: launcher(lib, k) for kind, lib in libs.items()}
        order = ["clocks", "normal"]
        if code:
            run["unguarded"] = launcher(libs["normal"], k, 0)
            order.append("unguarded")
        ms = {kind: [] for kind in order}
        for kind in order + order[::-1]:
            ms[kind].append(cuda_ms(run[kind]))
        run["clocks"]()
        torch.cuda.synchronize()
        clocks = (ctypes.c_ulonglong * len(names))()
        if getattr(libs["clocks"], read)(ctypes.addressof(clocks)):
            sys.exit("p_epoch_phases: could not read the phase clocks")
        # the clock rate from one thread's phases, which sum to its launch
        # (the producer's, named producer_*, run beside them)
        total = sum(v for n, v in zip(names, clocks)
                    if not n.startswith("producer_"))
        inst_ms = sum(ms["clocks"]) / 2
        normal_ms = sum(ms["normal"]) / 2
        hz = total / (inst_ms * 1e-3)
        entry = {"cycles_per_step": {n: v / S for n, v in zip(names, clocks)},
                 "cycles_per_step_total": total / S,
                 "implied_clock_ghz": hz / 1e9,
                 "us_per_step": {n: 1e6 * v / S / hz
                                 for n, v in zip(names, clocks)},
                 "ms": {"instrumented": inst_ms, "normal": normal_ms},
                 "ms_readings": ms,
                 "normal_us_per_step": 1e3 * normal_ms / S,
                 "bound_ms": bound_ms,
                 "normal_over_bound": normal_ms / bound_ms}
        if code and args.kernel == "split" and hasattr(
                libs["clocks"], "p_epoch_guard_part_clocks"):
            # the guard's parts on rank 0's lane 0, from the same launch
            parts = (ctypes.c_ulonglong * 4)()
            if libs["clocks"].p_epoch_guard_part_clocks(
                    ctypes.addressof(parts)):
                sys.exit("p_epoch_phases: could not read the guard's parts")
            entry["guard_parts_us_per_step"] = {
                n: 1e6 * v / S / hz for n, v in zip(
                    ("load", "first_sum", "rounds", "write"), parts)}
        if code:
            unguarded_ms = sum(ms["unguarded"]) / 2
            if launcher(libs["normal"], k, rp=rounds.data_ptr())():
                sys.exit("p_epoch_phases: a launch failed")
            total_rounds, most = rounds.tolist()
            entry.update({
                "guard": args.guard, "unguarded_ms": unguarded_ms,
                "guard_us_per_step": 1e3 * (normal_ms - unguarded_ms) / S,
                "guard_rounds_per_step": total_rounds / S,
                "guard_rounds_max": most})
        if k is not None:
            entry["cluster"] = k
        if by_class:
            entry["plan"] = dataclasses.asdict(layouts[k][0])
        elif k is not None:
            lib = libs["normal"]
            old = (int(tiled),) if lib.old_tiled else ()
            gx = (int(code != 0),) if lib.guard_abi else ()
            entry["hold"] = bool(lib.p_epoch_split_smem_bytes(
                B, J, C, k, 1, *old, *gx) <= cuda_build.SMEM_LIMIT)
        entries.append(entry)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({
        "kernel": args.kernel, "source": src_dir, "guard": args.guard,
        "lr": lr,
        "shape": {"n_val": n_val, "J": J, "C": C, "B": B, "S": S},
        "bulk_rows": bool(bulk), "bound_bytes": nbytes,
        "by_cluster" if k is not None else "staged":
            entries if k is not None else entries[0],
        "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
