#!/usr/bin/env python3
"""Time variants of ``csrc/client_epoch.cu``'s class-tiled wide kernel in
turns, on the inputs of ``chip_smoke.py``'s ``many_classes`` phase.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/client_epoch_variants.py NAME=SOURCE.cu[:INCLUDE][@PLAN] \\
        ... [--shapes sector,aloi,sector_j1] [--clusters 1,2,4,8,16]

Each variant is built with ``cuda_build.NVCC_FLAGS`` (plus ``-I
INCLUDE``, default the source's own directory) into
``build/variants/NAME.so``, all builds at once, and its compiler report
for the class-tiled kernel (registers, spills) is printed. ``PLAN`` says
how a variant is launched: ``dsplit``, the first class-tiled design's
rule (its cluster splitting D: the largest k of 1, 2, 4, 8, 16 whose J k
CTAs fit one wave of SMs, the largest chunk of at most 128 rows whose
double-buffered partial logits fit a block, the batch buffer held where
it fits); by default the working tree's ``launch_plan`` (the cluster by
its measured rule); a number, that rule's layout forced at that
cluster; or ``K/TILE/STAGES/W_RES`` (e.g. ``8/256/2/1``), a layout forced
whole (skipped at a shape where it does not fit a block).

The shapes: ``sector``, the stand-in of LIBSVM's sector set that
``many_classes`` writes from its seed (C = 105, J = 50, B = 32, D =
2,000, its Dirichlet(0.01) clients' first epoch: ``classes_105``);
``aloi``, the same rows with 1,000 classes, 20 steps of random rows, 80%
valid (``classes_1000``); ``sector_j1``, Centralized's one client over
every training row of the stand-in in batches of 32. The variants run in
turns (in order, then reversed, ``--rounds`` times), each reading
``--reps`` launches with CUDA events; the plain PyTorch version is timed
once a shape and each variant's weights are held against its
(``max_abs_err_w``). ``--clusters`` adds the working tree's rule forced
at each cluster to each shape, in the same turns (to the first variant
not launched with ``dsplit``). Prints the card and one JSON
object a shape: each variant's readings in ms, sorted, its plan, its µs
a step of the longest client and its ratio to the shape's bound (the
operations of both passes over every valid row, at 67 TFLOP/s, or the
bytes of the rows, W, the anchor and the outputs at 3.35 TB/s, whichever
is longer). To compare a commit's kernel with the working tree's, unpack
that commit's ``csrc/`` into a directory under ``build/`` (``git
archive``) and pass both sources. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def dsplit_plan(J, B, C, D, sms, smem_limit):
    """The first class-tiled design's launch shape: (k, chunk, hold,
    scratch floats a CTA)."""
    Bp, CP = -(-B // 8) * 8, -(-C // 4) * 4

    def smem(chunk, hold):
        floats = 2 * (4 + chunk * CP) + 2 * chunk + 16
        return 16 + 4 * floats + (4 * Bp * (CP + 2) if hold else 0)

    chunk = next(c for c in range(min(Bp, 128), 0, -8)
                 if smem(c, False) <= smem_limit)
    hold = smem(chunk, True) <= smem_limit
    k = max(k for k in (1, 2, 4, 8, 16) if k == 1 or J * k <= sms)
    return k, chunk, hold, Bp * (CP + 2)


def standin(shape, dev):
    """The epoch arguments of ``shape`` on the card, drawn as
    ``chip_smoke.py``'s ``many_classes`` draws them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore.batching import (
        batch_valid, draw_epoch_positions)

    sec = cs.SECTOR
    with tempfile.TemporaryDirectory(prefix="variants_") as tmp:
        for name, n, seed in (("sector", sec["train"], cs.SEED),
                              ("sector.t", sec["test"], cs.SEED + 1)):
            cs.write_standin(os.path.join(tmp, name), n, sec["d"],
                             sec["classes"], sec["nnz"], seed)
        prm = get_parameter("sector")
        ds = load_dataset("sector", num_partitions=cs.J, alpha=0.01,
                          data_dir=tmp)
        ms = prepare_setup(ds, D=cs.D, kernel_par=prm["kernel_par"],
                           seed=cs.SEED, rng=np.random.RandomState(cs.SEED),
                           device=dev)
    J, B, C, N = cs.J, cs.B, ms.num_classes, int(ms.X.shape[0])
    gen = torch.Generator().manual_seed(cs.SEED)
    dgen = torch.Generator(device=dev).manual_seed(cs.SEED)
    pos = draw_epoch_positions(dgen, ms.n_max, B, ms.mask, lead=(J,))
    valid = batch_valid(pos, ms.n_max, ms.mask)
    rows = torch.gather(ms.idx, 1, pos.reshape(J, -1)).reshape(
        pos.shape).to(torch.int32).contiguous()
    y = ms.y
    if shape == "aloi":
        rows = torch.randint(0, N, (J, cs.ALOI_S, B), generator=dgen,
                             device=dev, dtype=torch.int32)
        valid = (torch.rand((J, cs.ALOI_S, B), generator=dgen, device=dev)
                 < 0.8).float()
        y = torch.randint(0, cs.ALOI_C, (N,), generator=dgen, device=dev,
                          dtype=torch.int32)
        C = cs.ALOI_C
    elif shape == "sector_j1":
        n = int(ms.sizes.sum())
        S = -(-n // B)
        perm = torch.randperm(n, generator=gen).to(dev)
        flat = torch.zeros(S * B, dtype=torch.int32, device=dev)
        flat[:n] = ms.idx[ms.mask.bool()][perm].to(torch.int32)
        rows = flat.reshape(1, S, B).contiguous()
        valid = (torch.arange(S * B, device=dev) < n).float().reshape(
            1, S, B)
        J = 1
    w0 = (0.01 * torch.randn((C, cs.D), generator=gen)).to(dev)
    W = w0.expand(J, C, cs.D) + 0.01 * torch.randn(
        (J, C, cs.D), generator=gen).to(dev)
    return (W.contiguous(), w0, ms.X, y, rows, valid, 0.1, 0.05, 0.01,
            "classification")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+",
                    metavar="NAME=SOURCE[:INCLUDE][@PLAN]")
    ap.add_argument("--shapes", default="sector,aloi")
    ap.add_argument("--clusters", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("client_epoch_variants: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import client_epoch_plain, cuda_build
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek

    out_dir = cuda_build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        rest, _, plan = rest.partition("@")
        src, _, inc = rest.partition(":")
        specs[name] = (src, inc or os.path.dirname(os.path.abspath(src)),
                       plan)
    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", inc, "-o",
         str(out_dir / f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, inc, _) in specs.items()}
    report = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"client_epoch_variants: {name} did not build:\n{log}")
        report[name] = {f: u for f, u in cuda_build.parse_ptxas(log).items()
                        if "wide_tiled_epoch_kernel" in f}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"ptxas": report}), flush=True)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {}
    for name in specs:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.client_epoch_launch_wide.restype = ctypes.c_int
        lib.client_epoch_launch_wide.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    max_k = ek.wide_max_cluster(dev.index or 0)
    active = ek.wide_active_clusters(dev.index or 0)
    stream = torch.cuda.current_stream().cuda_stream

    for shape in args.shapes.split(","):
        a = standin(shape, dev)
        W, anchor, X, y, rows, valid = a[:6]
        J, C, D = W.shape
        S, B = rows.shape[1:]
        order, nsteps = ek.client_order(valid)
        steps = nsteps.tolist()
        W_out = torch.empty_like(W)
        metrics = torch.zeros((J, 3), device=dev)
        ptrs = (W.data_ptr(), anchor.data_ptr(), X.data_ptr(), y.data_ptr(),
                rows.data_ptr(), valid.data_ptr(), order.data_ptr(),
                nsteps.data_ptr(), W_out.data_ptr(), metrics.data_ptr())
        bulk = int((D * X.element_size()) % 16 == 0)
        runs, plans = {}, {}

        def launcher(lib, k, chunk, tile, stages, w_res, scratch_floats):
            scratch = (torch.empty(J * k * scratch_floats, device=dev)
                       if scratch_floats else None)

            def run():
                return lib.client_epoch_launch_wide(
                    *ptrs, None if scratch is None else scratch.data_ptr(),
                    J, S, B, C, D, k, chunk, tile, stages, w_res, 0, bulk, 1,
                    1, 0.1, 0.05, 0.01, stream)
            return run

        def current(name, k=None, layout=None):
            plan = ek.launch_plan(J, B, C, D, sms, kernel="wide_tiled",
                                  cluster=k, max_cluster=max_k,
                                  active_clusters=active, steps=steps)
            if layout is not None:
                tile, stages, w_res = layout
                smem = ek.tiled_smem_bytes(B, C, D, k, plan.chunk, tile,
                                           stages, w_res,
                                           plan.scratch_bytes == 0,
                                           X.element_size())
                if smem > cuda_build.SMEM_LIMIT:
                    return None  # this layout does not fit this shape
                plan = dataclasses.replace(plan, tile=tile, stages=stages,
                                           w_res=w_res, smem_bytes=smem)
            plans[name] = {f: getattr(plan, f) for f in (
                "cluster", "chunk", "tile", "stages", "w_res",
                "smem_bytes", "scratch_bytes")}
            return launcher(libs[name.split("@")[0]], plan.cluster,
                            plan.chunk, plan.tile, plan.stages,
                            int(plan.w_res), plan.scratch_bytes // (
                                4 * plan.ctas))

        for name, (_, _, plan) in specs.items():
            if plan == "dsplit":
                k, chunk, hold, floats = dsplit_plan(
                    J, B, C, D, sms, cuda_build.SMEM_LIMIT)
                plans[name] = {"cluster": k, "chunk": chunk, "hold": hold}
                runs[name] = launcher(libs[name], k, chunk, 0, 0, 0,
                                      0 if hold else floats)
            elif "/" in plan:
                k, tile, stages, w_res = (int(v) for v in plan.split("/"))
                run = current(name, k, (tile, stages, bool(w_res)))
                if run is not None:
                    runs[name] = run
            else:
                runs[name] = current(name, int(plan) if plan else None)
        for k in (int(v) for v in args.clusters.split(",") if v):
            if k <= max_k and k <= C:
                name = next(n for n, s in specs.items() if s[2] != "dsplit")
                runs[f"{name}@{k}"] = current(f"{name}@{k}", k)

        def cuda_ms(fn):
            if fn():
                sys.exit("client_epoch_variants: a launch failed")
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            for _ in range(args.reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / args.reps

        names = list(runs)
        readings = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                readings[name].append(cuda_ms(runs[name]))
        plain = cuda_ms(lambda: client_epoch_plain(*a) and 0)
        # each variant's weights against the plain version's (one launch)
        wp, _ = client_epoch_plain(*a)
        err = {}
        for name in names:
            runs[name]()
            torch.cuda.synchronize()
            err[name] = float((W_out - wp).abs().max())
        n_rows = float(valid.sum())
        n_steps = int((valid.sum(-1) > 0).sum())
        ops = 4 * C * D * n_rows + 12 * C * D * n_steps
        nbytes = 4 * (n_rows * (D + 1) + 2 * J * C * D + C * D
                      + 2 * rows.numel() + 3 * J)
        bound = 1e3 * max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)
        mean = {n: sum(r) / len(r) for n, r in readings.items()}
        print(json.dumps({
            "shape": shape, "card": card,
            "dims": {"J": J, "C": C, "D": D, "B": B, "S": S,
                     "steps_max": max(steps)},
            "ms": {n: sorted(r) for n, r in readings.items()},
            "plan": plans, "plain_ms": plain, "bound_ms": bound,
            "max_abs_err_w": err,
            "us_per_step": {n: 1e3 * v / max(steps)
                            for n, v in mean.items()},
            "over_bound": {n: v / bound for n, v in mean.items()},
            "under_plain": {n: plain / v for n, v in mean.items()}}),
            flush=True)
        del a, W, X, W_out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
