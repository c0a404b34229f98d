#!/usr/bin/env python3
"""Where one step of the staged ``p_epoch`` kernel spends its time.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/p_epoch_phases.py [--n-val 11983 --J 50 --C 10 --B 16]

It compiles ``csrc/p_epoch.cu`` a second time with
``-DP_EPOCH_PHASE_CLOCKS`` (thread 0 of the staged kernel sums
``clock64`` cycles per phase of its steps; the normal build has none of
it), launches that build once on random inputs of the main path's shapes
(defaults: FedAMW's p-solve at mnist, J=50, validation batch 16),
and prints one JSON object: cycles per step in each phase, the clock
rate implied by the instrumented launch's CUDA-event time, each phase in
µs per step, and the instrumented and normal kernels' ms on the same
inputs (the cost of the clocks). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# the PHASE marks of csrc/p_epoch.cu, in order (the element-wise copy path
# counts its whole copy issue in "copy")
PHASES = ("copy_expect_tx", "copy_syncwarp", "copy_fence", "copy",
          "prefetch_loads", "valid_count", "wait_rows", "z", "loss", "h",
          "barrier_1", "update", "barrier_2_shift")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-val", type=int, default=11983)
    ap.add_argument("--J", type=int, default=50)
    ap.add_argument("--C", type=int, default=10)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("p_epoch_phases: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import cuda_build, p_epoch
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches

    n_val, J, C, B = args.n_val, args.J, args.C, args.B
    plan = pk.launch_plan(B, J, C)
    if plan.kernel != "staged":
        sys.exit(f"p_epoch_phases: B={B}, J={J}, C={C} runs {plan}")
    lib_path = cuda_build.library_path("p_epoch").with_name(
        cuda_build.library_path("p_epoch").stem + "-phases.so")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    if not lib_path.exists():
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                        "-DP_EPOCH_PHASE_CLOCKS", "-o", str(lib_path),
                        str(cuda_build.CSRC_DIR / "p_epoch.cu")],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.p_epoch_launch_staged.restype = ctypes.c_int
    lib.p_epoch_launch_staged.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.p_epoch_phase_clocks.restype = ctypes.c_int
    lib.p_epoch_phase_clocks.argtypes = [ctypes.c_void_p]

    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    logits = torch.randn((n_val, J, C), generator=gen).to(dev)
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
    stream = torch.cuda.current_stream().cuda_stream

    def instrumented():
        err = lib.p_epoch_launch_staged(
            p.data_ptr(), buf.data_ptr(), cv.data_ptr(), logits.data_ptr(),
            y.data_ptr(), pos.data_ptr(), valid.data_ptr(),
            *(o.data_ptr() for o in outs), None, S, B, J, C, 1,
            int(pk.bulk_rows(logits)), 0, 1e-3, 0.9, 0.0, stream)
        if err:
            sys.exit(f"p_epoch_phases: launch failed with CUDA error {err}")

    def normal():
        p_epoch(p, buf, cv, logits, y, pos, valid, 1e-3, 0.9,
                "classification")

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    # in turns: instrumented, normal, normal, instrumented
    ms = {"instrumented": [], "normal": []}
    for name in ("instrumented", "normal", "normal", "instrumented"):
        ms[name].append(cuda_ms(instrumented if name == "instrumented"
                                else normal))
    instrumented()
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * len(PHASES))()
    if lib.p_epoch_phase_clocks(ctypes.addressof(clocks)):
        sys.exit("p_epoch_phases: could not read the phase clocks")
    total = sum(clocks)
    inst_ms = sum(ms["instrumented"]) / 2
    hz = total / (inst_ms * 1e-3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({
        "shape": {"n_val": n_val, "J": J, "C": C, "B": B, "S": S},
        "plan": plan.kernel, "bulk_rows": pk.bulk_rows(logits),
        "cycles_per_step": {k: v / S for k, v in zip(PHASES, clocks)},
        "cycles_per_step_total": total / S,
        "implied_clock_ghz": hz / 1e9,
        "us_per_step": {k: 1e6 * v / S / hz for k, v in zip(PHASES, clocks)},
        "ms": {k: sum(v) / len(v) for k, v in ms.items()},
        "ms_readings": ms,
        "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
