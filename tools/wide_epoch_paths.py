#!/usr/bin/env python3
"""Kernel 1's wide plan (``wide_epoch_kernel``) timed on the main path's
inputs, with each path its plan selects turned on and off.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/wide_epoch_paths.py [--dataset mnist --D 10000 --J 50
                                       --clusters 8,16] [--centralized]
    python3 tools/wide_epoch_paths.py --repo DIR --dataset letter --D 10000

The inputs are those of one local epoch of the main path: the dataset's
Dirichlet(0.01) split into J clients (``load_dataset``; the synthetic
stand-in of its registry shape where the file is absent), its random
Fourier features at D (``prepare_setup``), one epoch's batches of B rows
(``draw_epoch_positions``), W the anchor plus a small jitter under the
strong penalties; ``--centralized`` takes Centralized's launch instead (one
client holding every train row). The default plan is timed first. Then,
for each cluster size, the plan forced there, as planned and with one path
turned off at a time where the plan has it on: the step's rows held in the
ring from pass to pass (``rows_res``), W's and the anchor's slices held in
shared memory (``w_res``), the batch buffer held in shared memory (else
global scratch). CUDA events, each variant in turns (the list, then back).
``--repo`` imports the package of another checkout (an earlier commit;
``--clusters`` only where its plans have these fields). Prints one JSON
line for the default plan and one a cluster. Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--J", type=int, default=50)
    ap.add_argument("--D", type=int, default=10000)
    ap.add_argument("--B", type=int, default=32)
    ap.add_argument("--clusters", default="")
    ap.add_argument("--centralized", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--repo", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wide_epoch_paths: no CUDA device")
    repo = os.path.abspath(args.repo or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    import fedamw_tpu_torch  # noqa: F401  (the alias module of a checkout)
    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore import client_epoch
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.fedcore.batching import (
        batch_valid, draw_epoch_positions)

    prm = get_parameter(args.dataset)
    J, B, D = args.J, args.B, args.D
    ds = load_dataset(args.dataset, num_partitions=J,
                      alpha=prm["alpha_Dirk"])
    setup = prepare_setup(ds, D=D, kernel_par=prm["kernel_par"],
                          seed=args.seed,
                          rng=np.random.RandomState(args.seed))
    dev, C = setup.device, setup.num_classes
    gen = torch.Generator().manual_seed(args.seed)
    dgen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.centralized:
        idx = setup.all_train_idx
        pos = draw_epoch_positions(dgen, int(idx.numel()), B, lead=(1,))
        valid = batch_valid(pos, int(idx.numel()))
        rows = idx[pos].to(torch.int32).contiguous()
        J = 1
    else:
        pos = draw_epoch_positions(dgen, setup.n_max, B, setup.mask,
                                   lead=(J,))
        valid = batch_valid(pos, setup.n_max, setup.mask)
        rows = torch.gather(setup.idx, 1, pos.reshape(J, -1)).reshape(
            pos.shape).to(torch.int32).contiguous()
    w0 = (0.01 * torch.randn((C, D), generator=gen)).to(dev)
    W = (w0.expand(J, C, D) + 0.01 * torch.randn((J, C, D),
                                                 generator=gen).to(dev))
    a = (W.contiguous(), w0, setup.X, setup.y, rows, valid,
         float(prm["lr"]), 0.05, 0.01, "classification")
    steps_max = int(ek.client_order(valid)[1].max())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    head = {"tool": "wide_epoch_paths", "repo": repo, "card": card,
            "dataset": args.dataset, "centralized": args.centralized,
            "J": J, "C": C, "D": D, "B": B, "S": int(rows.shape[1]),
            "steps_max": steps_max}
    ms = cuda_ms(lambda: client_epoch(*a), args.reps)
    print(json.dumps({**head, "plan": "default", "ms": ms,
                      "us_per_step": 1e3 * ms / steps_max,
                      "launches_by_kernel": client_epoch.launches_by_kernel}),
          flush=True)
    if not args.clusters:
        return

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_k = ek.wide_max_cluster(dev.index or 0)
    planned = ek.launch_plan

    def timed(plan):
        ek.launch_plan = lambda *_a, **_k: plan
        try:
            return cuda_ms(lambda: client_epoch(*a), args.reps)
        finally:
            ek.launch_plan = planned

    for k in (int(v) for v in args.clusters.split(",")):
        if k > max_k:
            continue
        plan = planned(J, B, C, D, sms, kernel="wide", cluster=k,
                       max_cluster=max_k)
        hold = plan.scratch_bytes == 0

        def relaid(w_res, hold):
            return dataclasses.replace(
                plan, w_res=w_res,
                smem_bytes=ek.ring_smem_bytes(
                    B, C, D, k, plan.chunk, plan.tile, plan.stages, w_res,
                    hold),
                scratch_bytes=0 if hold else 4 * J * k * ek.wide_batch_floats(
                    B, C))

        variants = {"as planned": plan}
        if plan.rows_res:
            variants["rows_res off"] = dataclasses.replace(plan,
                                                           rows_res=False)
        if plan.w_res:
            variants["w_res off"] = relaid(False, hold)
        if hold:
            variants["batch in scratch"] = relaid(plan.w_res, False)
        turns = {v: [] for v in variants}
        for v in list(variants) + list(variants)[::-1]:
            turns[v].append(timed(variants[v]))
        print(json.dumps({
            **head, "cluster": k, "plan": dataclasses.asdict(plan),
            "ms": {v: sum(t) / len(t) for v, t in turns.items()},
            "us_per_step": {v: 1e3 * sum(t) / len(t) / steps_max
                            for v, t in turns.items()}}), flush=True)


if __name__ == "__main__":
    main()
