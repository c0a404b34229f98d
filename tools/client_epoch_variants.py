#!/usr/bin/env python3
"""Time variants of ``csrc/client_epoch.cu``'s kernels in turns: the
class-tiled wide kernel on the inputs of ``chip_smoke.py``'s
``many_classes`` phase, the staged and wide kernels on the main path's.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/client_epoch_variants.py NAME=SOURCE.cu[:INCLUDE][@PLAN] \\
        ... [--shapes sector,aloi,sector_j1] [--clusters 1,2,4,8,16]
    python3 tools/client_epoch_variants.py \\
        parent=build/parent/<pkg>_torch/csrc/client_epoch.cu \\
        new=<pkg>_torch/csrc/client_epoch.cu --shapes main,centralized \\
        --dtype bfloat16 [--kernel staged|wide] [--clusters 1,2,4,8]
    python3 tools/client_epoch_variants.py new=<pkg>_torch/csrc/client_epoch.cu \\
        --shapes grid --grid-J 1,5,50,400 --grid-D 784,2000,5376,8704 \\
        --dtype bfloat16 --kernel staged --clusters 1,2,4,8

Each variant is built with ``cuda_build.NVCC_FLAGS`` and the flags of
the ``--dtype`` row type's library (``-DCLIENT_EPOCH_ROWS_BF16`` or
``_F16``; plus ``-I INCLUDE``, default the source's own directory) into
``build/variants/NAME-DTYPE.so``, all builds at once, and its compiler
report for the kernels timed (registers, spills) is printed. ``PLAN``
says how a variant is launched: ``dsplit``, the first class-tiled
design's rule (its cluster splitting D: the largest k of 1, 2, 4, 8, 16
whose J k CTAs fit one wave of SMs, the largest chunk of at most 128 rows
whose double-buffered partial logits fit a block, the batch buffer held
where it fits); by default the working tree's ``launch_plan`` (the
kernel and cluster by its rules, or the kernel ``--kernel`` forces); a
number, that rule's layout forced at that cluster; ``K/STAGES`` for the
staged kernel, its ring of 2-byte rows forced to that depth (0: the
float32 design's kernel, which every build keeps); or
``K/TILE/STAGES/W_RES`` (e.g. ``8/256/2/1``), a class-tiled layout
forced whole (skipped at a shape where it does not fit a block). A
source from before the 2-byte ring (no ``client_epoch_staged_ring_smem_
bytes``) is launched through its own staged interface.

The shapes: ``sector``, the stand-in of LIBSVM's sector set that
``many_classes`` writes from its seed (C = 105, J = 50, B = 32, D =
2,000, its Dirichlet(0.01) clients' first epoch: ``classes_105``);
``aloi``, the same rows with 1,000 classes, 20 steps of random rows, 80%
valid (``classes_1000``); ``sector_j1``, Centralized's one client over
every training row of the stand-in in batches of 32; ``main``, the main
path's first local epoch (the mnist stand-in, J = 50 Dirichlet(0.01)
clients, B = 32, C = 10, D = 2,000, the registry's penalties: the
``client_epoch`` row of ``chip_smoke.py``); ``centralized``, its
Centralized launch (one client over every training row, ~1,501 steps);
``grid``, each J of ``--grid-J`` and D of ``--grid-D``: the mnist
stand-in's Dirichlet(0.01) split into J clients gives each client's
count of full steps (J = 1: every training row), over 20,000 random rows
of D random features. The sector shapes default to the class-tiled
kernel, the others to the working tree's plan. The variants run in turns
(in order, then reversed, ``--rounds`` times), each reading ``--reps``
launches with CUDA events; the plain PyTorch version is timed once a
shape and each variant's weights are held against its
(``max_abs_err_w``; ``--no-plain`` skips both, for a grid).
``--clusters`` adds the working tree's rule forced at each cluster to
each shape, in the same turns (to the first variant not launched with
``dsplit``). Prints the card and one JSON
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


def main_inputs(shape, dev):
    """The epoch arguments of the main path's first local epoch
    (``main``) or of its Centralized launch (``centralized``) on the
    card, drawn as ``chip_smoke.py`` draws its ``client_epoch`` checks."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore.batching import (
        batch_valid, draw_epoch_positions)

    prm = get_parameter("mnist")
    ds = load_dataset("mnist", num_partitions=cs.J, alpha=prm["alpha_Dirk"])
    setup = prepare_setup(ds, D=cs.D, kernel_par=prm["kernel_par"],
                          seed=cs.SEED, rng=np.random.RandomState(cs.SEED),
                          device=dev)
    C = setup.num_classes
    gen = torch.Generator().manual_seed(cs.SEED)
    dgen = torch.Generator(device=dev).manual_seed(cs.SEED)
    w0 = setup.model.init(gen, cs.D, C)["w"].to(dev)
    pos = draw_epoch_positions(dgen, setup.n_max, cs.B, setup.mask,
                               lead=(cs.J,))
    valid = batch_valid(pos, setup.n_max, setup.mask)
    rows = torch.gather(setup.idx, 1, pos.reshape(cs.J, -1)).reshape(
        pos.shape).to(torch.int32).contiguous()
    lr = float(prm["lr"])
    if shape == "main":
        W = w0.expand(cs.J, C, cs.D).contiguous()
        return (W, w0, setup.X, setup.y, rows, valid, lr,
                float(prm["lambda_prox"]), float(prm["lambda_reg"]),
                "classification")
    all_idx = setup.all_train_idx
    n_all = int(all_idx.numel())
    cpos = draw_epoch_positions(dgen, n_all, cs.B, lead=(1,))
    cvalid = batch_valid(cpos, n_all)
    crows = all_idx[cpos].to(torch.int32).contiguous()
    return (w0[None].contiguous(), w0, setup.X, setup.y, crows, cvalid, lr,
            0.0, 0.0, "classification")


def split_steps(J, B):
    """Each client's count of full steps of B rows in the mnist
    stand-in's Dirichlet(0.01) split into J clients (J = 1: every
    training row)."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.data import load_dataset

    setup = prepare_setup(
        load_dataset("mnist", num_partitions=max(J, 2), alpha=0.01), D=16,
        seed=100, rng=np.random.RandomState(100), device="cpu")
    sizes = setup.mask.sum(1)
    if J == 1:
        sizes = sizes.sum()[None]
    return [max(1, int(v)) for v in torch.ceil(sizes / B).tolist()]


def grid_inputs(J, D, dev, B=32, C=10, N=20000, seed=100):
    """Random rows of D features whose clients walk ``split_steps(J)``
    full steps each, classification at C classes, the strong penalties
    of the card tests."""
    import torch

    steps = split_steps(J, B)
    S = max(steps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((N, D), generator=gen, device=dev)
    y = torch.randint(0, C, (N,), generator=gen, device=dev,
                      dtype=torch.int32)
    rows = torch.randint(0, N, (J, S, B), generator=gen, device=dev,
                         dtype=torch.int32)
    valid = (torch.arange(S, device=dev)[None, :]
             < torch.tensor(steps, device=dev)[:, None]).float()
    valid = valid[..., None].expand(J, S, B).contiguous()
    w0 = 0.01 * torch.randn((C, D), generator=gen, device=dev)
    W = w0.expand(J, C, D) + 0.01 * torch.randn((J, C, D), generator=gen,
                                                device=dev)
    return (W.contiguous(), w0, X, y, rows, valid, 0.1, 0.05, 0.01,
            "classification")


TILED_SHAPES = ("sector", "aloi", "sector_j1")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+",
                    metavar="NAME=SOURCE[:INCLUDE][@PLAN]")
    ap.add_argument("--shapes", default="sector,aloi")
    ap.add_argument("--kernel", default=None,
                    choices=("staged", "wide", "wide_tiled"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    ap.add_argument("--grid-J", default="1,5,50,400")
    ap.add_argument("--grid-D", default="784,2000,5376,8704")
    ap.add_argument("--clusters", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-plain", action="store_true",
                    help="skip the plain version's time and the weights' "
                         "check against it (a grid of many shapes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("client_epoch_variants: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.fedcore import client_epoch_plain, cuda_build
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek

    dtype = getattr(torch, args.dtype)
    library = ek.ROW_LIBRARIES[dtype]
    out_dir = cuda_build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        rest, _, plan = rest.partition("@")
        src, _, inc = rest.partition(":")
        specs[name] = (src, inc or os.path.dirname(os.path.abspath(src)),
                       plan)

    def so(name):
        return out_dir / f"{name}-{args.dtype}.so"

    def fresh(name, src, inc):
        # a library built after its source and headers is built again
        # only when they change (several calls of one command share it)
        out = so(name)
        deps = [src] + [os.path.join(inc, f) for f in os.listdir(inc)
                        if f.endswith(".cuh")]
        return (out.exists() and out.with_suffix(".log").exists()
                and all(os.path.getmtime(d) < os.path.getmtime(out)
                        for d in deps))

    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
         *cuda_build.BUILDS[library][1], "-I", inc, "-o", str(so(name)),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, inc, _) in specs.items()
        if not fresh(name, src, inc)}
    report = {}
    for name in specs:
        if name in procs:
            log, _ = procs[name].communicate()
            if procs[name].returncode:
                sys.exit(f"client_epoch_variants: {name} did not build:"
                         f"\n{log}")
            so(name).with_suffix(".log").write_text(log)
        log = so(name).with_suffix(".log").read_text()
        report[name] = {f: u for f, u in cuda_build.parse_ptxas(log).items()
                        if "epoch_kernel" in f}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"ptxas": report, "rows": args.dtype}), flush=True)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs, ring = {}, {}
    for name in specs:
        lib = ctypes.CDLL(str(so(name)))
        # a source with the 2-byte ring passes its depth to the staged
        # launcher; an older one has no such argument
        ring[name] = hasattr(lib, "client_epoch_staged_ring_smem_bytes")
        lib.client_epoch_launch_staged.restype = ctypes.c_int
        lib.client_epoch_launch_staged.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * (9 if ring[name] else 8)
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.client_epoch_launch_wide.restype = ctypes.c_int
        lib.client_epoch_launch_wide.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    max_k = ek.wide_max_cluster(dev.index or 0)
    active = ek.wide_active_clusters(dev.index or 0)
    stream = torch.cuda.current_stream().cuda_stream

    shapes = []
    for shape in args.shapes.split(","):
        if shape == "grid":
            shapes += [("grid", int(Jg), int(Dg))
                       for Jg in args.grid_J.split(",")
                       for Dg in args.grid_D.split(",")]
        else:
            shapes.append((shape, None, None))
    for shape, Jg, Dg in shapes:
        if shape in TILED_SHAPES:
            a = standin(shape, dev)
        elif shape == "grid":
            a = grid_inputs(Jg, Dg, dev)
        else:
            a = main_inputs(shape, dev)
        a = a[:2] + (a[2].to(dtype),) + a[3:]
        W, anchor, X, y, rows, valid = a[:6]
        lr, mu, lam = a[6:9]
        J, C, D = W.shape
        S, B = rows.shape[1:]
        rb = X.element_size()
        kernel = args.kernel or ("wide_tiled" if shape in TILED_SHAPES
                                 else None)
        order, nsteps = ek.client_order(valid)
        steps = nsteps.tolist()
        W_out = torch.empty_like(W)
        metrics = torch.zeros((J, 3), device=dev)
        ptrs = (W.data_ptr(), anchor.data_ptr(), X.data_ptr(), y.data_ptr(),
                rows.data_ptr(), valid.data_ptr(), order.data_ptr(),
                nsteps.data_ptr(), W_out.data_ptr(), metrics.data_ptr())
        bulk = int((D * rb) % 16 == 0)
        runs, plans = {}, {}

        def launcher(name, plan, scratch_floats=0, dsplit=False):
            lib = libs[name.split("@")[0]]
            scratch = (torch.empty(plan.ctas * scratch_floats, device=dev)
                       if scratch_floats else None)
            if plan.kernel == "staged":
                stages = ((plan.stages,) if ring[name.split("@")[0]]
                          else ())

                def run():
                    return lib.client_epoch_launch_staged(
                        *ptrs, J, S, B, C, D, plan.cluster, *stages, 1,
                        bulk, lr, mu, lam, stream)
                return run

            def run():
                return lib.client_epoch_launch_wide(
                    *ptrs, None if scratch is None else scratch.data_ptr(),
                    J, S, B, C, D, plan.cluster, plan.chunk, plan.tile,
                    plan.stages, int(plan.w_res), int(plan.rows_res), bulk,
                    int(plan.kernel == "wide_tiled"), 1, lr, mu, lam,
                    stream)
            return run

        def current(name, k=None, layout=None, stages=None):
            try:
                plan = ek.launch_plan(J, B, C, D, sms, row_bytes=rb,
                                      kernel=kernel, cluster=k,
                                      max_cluster=max_k,
                                      active_clusters=active, steps=steps)
            except ValueError:
                return None  # this cluster does not fit this shape
            if layout is not None:
                tile, nst, w_res = layout
                smem = ek.tiled_smem_bytes(B, C, D, k, plan.chunk, tile,
                                           nst, w_res,
                                           plan.scratch_bytes == 0, rb)
                if smem > cuda_build.SMEM_LIMIT:
                    return None  # this layout does not fit this shape
                plan = dataclasses.replace(plan, tile=tile, stages=nst,
                                           w_res=w_res, smem_bytes=smem)
            if stages is not None:
                if stages and ek.staged_ring_smem_bytes(
                        B, C, D, plan.cluster, stages) > cuda_build.SMEM_LIMIT:
                    return None
                plan = dataclasses.replace(plan, stages=stages)
            plans[name] = {f: getattr(plan, f) for f in (
                "kernel", "cluster", "chunk", "tile", "stages", "w_res",
                "smem_bytes", "scratch_bytes")}
            return launcher(name, plan,
                            plan.scratch_bytes // (4 * plan.ctas))

        for name, (_, _, plan) in specs.items():
            run = None
            if plan == "dsplit":
                k, chunk, hold, floats = dsplit_plan(
                    J, B, C, D, sms, cuda_build.SMEM_LIMIT)
                plans[name] = {"cluster": k, "chunk": chunk, "hold": hold}
                run = launcher(name, ek.EpochPlan(
                    k, D, 0, 0, J * k, "wide_tiled", chunk),
                    0 if hold else floats)
            elif plan.count("/") == 3:
                k, tile, nst, w_res = (int(v) for v in plan.split("/"))
                run = current(name, k, (tile, nst, bool(w_res)))
            elif plan.count("/") == 1:
                k, nst = (int(v) for v in plan.split("/"))
                run = current(name, k, stages=nst)
            else:
                run = current(name, int(plan) if plan else None)
            if run is not None:
                runs[name] = run
        for k in (int(v) for v in args.clusters.split(",") if v):
            if k <= max_k and (kernel != "wide_tiled" or k <= C):
                name = next(n for n, s in specs.items() if s[2] != "dsplit")
                run = current(f"{name}@{k}", k)
                if run is not None:
                    runs[f"{name}@{k}"] = run

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
        plain, err = None, {}
        if not args.no_plain:
            plain = cuda_ms(lambda: client_epoch_plain(*a) and 0)
            # each variant's weights against the plain version's (one
            # launch)
            wp, _ = client_epoch_plain(*a)
            for name in names:
                runs[name]()
                torch.cuda.synchronize()
                err[name] = float((W_out - wp).abs().max())
        n_rows = float(valid.sum())
        n_steps = int((valid.sum(-1) > 0).sum())
        ops = 4 * C * D * n_rows + 12 * C * D * n_steps
        nbytes = (n_rows * (rb * D + 4) + 4 * (2 * J * C * D + C * D
                                                + 2 * rows.numel() + 3 * J))
        bound = 1e3 * max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)
        mean = {n: sum(r) / len(r) for n, r in readings.items()}
        print(json.dumps({
            "shape": shape, "card": card, "rows": args.dtype,
            "dims": {"J": J, "C": C, "D": D, "B": B, "S": S,
                     "steps_max": max(steps)},
            "ms": {n: sorted(r) for n, r in readings.items()},
            "mean_ms": mean,
            "plan": plans, "plain_ms": plain, "bound_ms": bound,
            "max_abs_err_w": err,
            "us_per_step": {n: 1e3 * v / max(steps)
                            for n, v in mean.items()},
            "over_bound": {n: v / bound for n, v in mean.items()},
            "under_plain": {n: plain / v for n, v in mean.items()}
            if plain else None}),
            flush=True)
        del a, W, X, W_out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
