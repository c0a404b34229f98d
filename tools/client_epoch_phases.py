#!/usr/bin/env python3
"""Where one step of kernel 1's staged plan (``staged_epoch_kernel``, or
``staged_ring_epoch_kernel`` on 2-byte rows), its wide plan
(``wide_epoch_kernel``) or its class-tiled wide plan
(``wide_tiled_epoch_kernel``) spends its time.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/client_epoch_phases.py [--J 50 --S 150 --D 10000 --C 10
                                          --B 32 --clusters 2,8,16]
    python3 tools/client_epoch_phases.py --kernel staged --D 2000 \
        --dtype bfloat16 --clusters 1,2,4,8
    python3 tools/client_epoch_phases.py --kernel wide_tiled --D 2000 \
        --C 105 --S 20 --clusters 1,2,4,8,16

It compiles ``csrc/client_epoch.cu`` a second time with
``-DCLIENT_EPOCH_PHASE_CLOCKS`` (CTA 0, rank 0 of the client with the most
steps, sums ``clock64`` cycles per phase: consumer thread 0 and producer
lane 0; the normal build has none of it), and on random inputs (N rows of
X, client 0 with S non-empty steps and every other client S // 5, as a
Dirichlet(0.01) split gives the longest client ~5x the mean) launches the
kernel forced at each cluster size that fits, once through that build and
5 times through the normal one. Prints one JSON line a cluster: the
plan's layout, both builds' ms, the clock rate implied by the
instrumented launch's CUDA-event time (from the consumer phases, whose
sum is the longest client's whole launch), and each phase in µs per
step. The staged and class-tiled kernels' phase names come from their
library (``client_epoch_staged_phase_names``,
``client_epoch_tiled_phase_names``; ``producer_`` marks the producer
warp's: the float32 staged kernel has none, its thread 0 packs). A
cluster that does not fit the kernel prints a ``skipped`` line. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# the WPHASE marks of csrc/client_epoch.cu, in order
PHASES = ("wait_batch", "wait_fwd_tiles", "fwd_fma", "warp_sums",
          "cluster_barrier", "exchange_reads", "row_loss", "wait_grad_tiles",
          "grad_fma", "update", "block_sums",
          "producer_wait_empty", "producer_issue", "producer_wait_batch",
          "producer_pack", "producer_cluster")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--J", type=int, default=50)
    ap.add_argument("--S", type=int, default=150)
    ap.add_argument("--D", type=int, default=10000)
    ap.add_argument("--C", type=int, default=10)
    ap.add_argument("--B", type=int, default=32)
    ap.add_argument("--N", type=int, default=20000)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    ap.add_argument("--clusters", default="1,2,4,8,16")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--kernel", choices=("staged", "wide", "wide_tiled"),
                    default="wide")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("client_epoch_phases: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import client_epoch, cuda_build
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek

    dtype = getattr(torch, args.dtype)
    name = ek.ROW_LIBRARIES[dtype]
    normal = cuda_build.load(name)
    base = cuda_build.library_path(name)
    lib_path = base.with_name(base.stem + "-phases.so")
    if not lib_path.exists():
        subprocess.run([cuda_build._nvcc(), *cuda_build._flags(name),
                        "-DCLIENT_EPOCH_PHASE_CLOCKS", "-o", str(lib_path),
                        str(cuda_build.source_path(name))],
                       check=True, capture_output=True)
    clocked = ctypes.CDLL(str(lib_path))
    named = {"staged": "staged", "wide_tiled": "tiled"}.get(args.kernel)
    read_clocks = getattr(clocked, f"client_epoch_{named or 'wide'}"
                                   "_phase_clocks")
    read_clocks.restype = ctypes.c_int
    read_clocks.argtypes = [ctypes.c_void_p]
    phases = PHASES
    if named:
        names = getattr(clocked, f"client_epoch_{named}_phase_names")
        names.restype = ctypes.c_char_p
        phases = tuple(names().decode().split(","))
    consumer = [i for i, p in enumerate(phases)
                if not p.startswith("producer_")]

    J, S, D, C, B, N = args.J, args.S, args.D, args.C, args.B, args.N
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    X = torch.randn((N, D), generator=gen, device=dev).to(dtype)
    y = torch.randint(0, C, (N,), generator=gen, device=dev,
                      dtype=torch.int32)
    rows = torch.randint(0, N, (J, S, B), generator=gen, device=dev,
                         dtype=torch.int32)
    valid = torch.zeros((J, S, B), device=dev)
    valid[0] = 1.0
    valid[1:, :max(1, S // 5)] = 1.0
    w0 = 0.01 * torch.randn((C, D), generator=gen, device=dev)
    W = (w0.expand(J, C, D)
         + 0.01 * torch.randn((J, C, D), generator=gen, device=dev))
    a = (W.contiguous(), w0, X, y, rows, valid, 0.01, 0.05, 0.01,
         "classification")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()

    def event_ms(reps):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            client_epoch(*a, kernel=args.kernel, cluster=k)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    max_k = ek.wide_max_cluster(dev.index or 0, name)
    for k in (int(v) for v in args.clusters.split(",")):
        if k > max_k:
            continue
        try:
            plan = ek.launch_plan(J, B, C, D, sms,
                                  row_bytes=X.element_size(),
                                  kernel=args.kernel, cluster=k,
                                  max_cluster=max_k)
        except ValueError as e:  # this cluster does not fit
            print(json.dumps({"tool": "client_epoch_phases", "cluster": k,
                              "skipped": str(e)}))
            continue
        ek._library.cache_clear()
        client_epoch(*a, kernel=args.kernel, cluster=k)  # warm-up
        ms = event_ms(5)
        saved = cuda_build.load
        cuda_build.load = lambda _n: clocked
        ek._library.cache_clear()
        try:
            client_epoch(*a, kernel=args.kernel, cluster=k)  # warm-up
            ms_clocked = event_ms(1)
        finally:
            cuda_build.load = saved
            ek._library.cache_clear()
        out = (ctypes.c_ulonglong * len(phases))()
        err = read_clocks(out)
        if err:
            sys.exit(f"client_epoch_phases: CUDA error {err}")
        cycles = list(out)
        ghz = sum(cycles[i] for i in consumer) / (ms_clocked * 1e6)
        print(json.dumps({
            "tool": "client_epoch_phases", "card": card,
            "kernel": args.kernel, "J": J, "S": S, "D": D, "C": C, "B": B,
            "rows": args.dtype, "cluster": k,
            "plan": {f: getattr(plan, f) for f in (
                "kernel", "slice_width", "chunk", "tile", "stages", "w_res",
                "rows_res", "smem_bytes", "scratch_bytes")},
            "ms": ms, "ms_clocked": ms_clocked, "clock_ghz": ghz,
            "us_per_step": {p: c / ghz / 1e3 / S
                            for p, c in zip(phases, cycles)}}))
    del normal


if __name__ == "__main__":
    main()
