#!/usr/bin/env python3
"""Time ``p_epoch``'s split kernel at every cluster size, shape by shape.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/p_epoch_clusters.py [--shapes 400x10 1024x7 ...]

For each shape ``JxC`` (validation batch 16, ``--n-val`` rows, random
logits scaled by 1/sqrt(J)) it launches the split kernel through
``psolver_kernel.p_epoch`` with the cluster forced to each size whose
CTAs fit (holding their row slices where the layout allows, else
streaming them), times each with CUDA events over ``--reps`` launches,
the sizes in turns (in order, then reversed), and prints one JSON line a
shape: ms and µs a step by size, each size's layout, the size the launch
plan picks and the fastest. The fitted rule of ``psolver_kernel
._split_cluster`` is held against these readings. Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

SHAPES = ("138x26", "200x26", "356x10", "400x10", "512x10", "800x10",
          "1000x26", "1024x7", "1658x2", "2048x2", "2000x10", "4096x2",
          "4096x10", "4096x26")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--n-val", type=int, default=11983)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("p_epoch_clusters: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import p_epoch
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_val, B = args.n_val, args.B
    pos = epoch_batches(n_val, B, generator=torch.Generator().manual_seed(
        args.seed))[0]
    valid = batch_valid(pos, n_val).to(dev)
    pos = pos.to(dev, torch.int32)
    S = int(pos.shape[0])
    k_max = pk.split_max_cluster(0)

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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for spec in args.shapes:
        J, C = (int(v) for v in spec.split("x"))
        logits = torch.randn((n_val, J, C), generator=gen,
                             device=dev) / J ** 0.5
        y = torch.randint(0, C, (n_val,), generator=gen, device=dev,
                          dtype=torch.int32)
        a = (torch.full((J,), 1.0 / J, device=dev),
             torch.zeros(J, device=dev), torch.ones(J, device=dev), logits,
             y, pos, valid, 1e-3, 0.9, "classification")
        plans = {}
        for k in pk.SPLIT_CLUSTERS:
            if k > k_max:
                continue
            try:
                plans[k] = pk.launch_plan(B, J, C, kernel="split",
                                          max_cluster=k_max, cluster=k)
            except ValueError:
                continue
        readings = {k: [] for k in plans}
        for k in list(plans) + list(plans)[::-1]:
            readings[k].append(cuda_ms(
                lambda: p_epoch(*a, kernel="split", cluster=k)))
        ms = {k: sum(r) / len(r) for k, r in readings.items()}
        chosen = pk.launch_plan(B, J, C, max_cluster=k_max)
        print(json.dumps({
            "shape": {"n_val": n_val, "J": J, "C": C, "B": B, "S": S},
            "ms_by_cluster": {str(k): v for k, v in ms.items()},
            "us_per_step_by_cluster": {str(k): 1e3 * v / S
                                       for k, v in ms.items()},
            "layouts": {str(k): {f: getattr(p, f) for f in (
                "stream", "tile", "stages", "warps", "smem_bytes")}
                for k, p in plans.items()},
            "plan": dataclasses.asdict(chosen),
            "fastest": int(min(ms, key=ms.get)),
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del logits


if __name__ == "__main__":
    main()
