#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``fedamw_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per
source, all at once), holds each kernel against its plain PyTorch version
on the card at the main path's shapes, drives the main path — FedAvg and
FedAMW on the mnist-shaped data (60000 x 784 -> RFF D=2000, 10 classes,
J=50 clients, Dirichlet alpha 0.01, the registry's lr / lr_p / lambda,
3 rounds of 2 local epochs at a constant lr) — through the public entry
points with every launch counter reset just before each algorithm and
read just after, checks that run against the same run through the plain
versions on the card (same seed, so the same shuffles and init) and that
each run learns, profiles one more FedAMW run (device time by kernel and
the device's busy share of the wall time), and times each kernel beside
its plain version and its bound. Output is one JSON object per line; the
line before the last lists the kernels; the last line is the contract
line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 100                 # the JAX package's experiment seed (exp.py)
J, D, ROUNDS, EPOCHS, B, VB = 50, 2000, 3, 2, 32, 16
# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# kernel vs plain tolerances: tests/test_pallas_kernel.py (kernel 1) and
# tests/test_pallas_psolver.py (kernel 2) — both kernels run full fp32
TOL_W = dict(atol=2e-5, rtol=1e-5)
TOL_P = dict(atol=2e-6, rtol=2e-5)
# main path vs the same run on the plain versions: per-round losses to
# 1e-4 relative, accuracy to 0.05 points (~8 of 15000 test rows), final
# weights to 1e-4 — three rounds of lr 0.5 SGD and 9 p-epochs carry the
# summation-order differences of the per-step tolerances above
TOL_RUN = dict(loss_rtol=1e-4, acc_atol=0.05, w_atol=1e-4)
# points of test accuracy above the largest class share a 3-round run
# must reach (PERF.md, section 5, says why this configuration learns slowly)
ACC_MARGIN = 1.5


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def close(a, b, atol, rtol):
    """(ok, max abs err) of a against b under |a-b| <= atol + rtol*|b|."""
    err = (a - b).abs()
    return bool((err <= atol + rtol * b.abs()).all()), float(err.max())


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

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port's kernels on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch.algorithms import FedAMW, FedAvg, prepare_setup
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore import (
        client_epoch, client_epoch_plain, client_logits, p_epoch,
        p_epoch_plain)
    from fedamw_tpu_torch.fedcore import cuda_build
    from fedamw_tpu_torch.fedcore.batching import batch_valid, epoch_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": built, "dir": str(cuda_build.BUILD_DIR)})
    for name in cuda_build.KERNEL_SOURCES:
        log = cuda_build.library_path(name).with_suffix(".log")
        if log.exists():
            used = [ln.strip() for ln in log.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            emit({"phase": "ptxas", "source": f"csrc/{name}.cu",
                  "report": used})

    # -- 2. the main path's data and setup --------------------------------
    prm = get_parameter("mnist")
    t0 = time.perf_counter()
    ds = load_dataset("mnist", num_partitions=J, alpha=prm["alpha_Dirk"])
    setup = prepare_setup(ds, D=D, kernel_par=prm["kernel_par"], seed=SEED,
                          rng=np.random.RandomState(SEED))
    torch.cuda.synchronize()
    emit({"phase": "setup", "source": ds.source, "seconds":
          time.perf_counter() - t0, "N": int(setup.X.shape[0]), "D": D,
          "J": setup.num_clients, "n_max": setup.n_max,
          "n_val": int(setup.X_val.shape[0]),
          "n_test": int(setup.X_test.shape[0])})
    dev = setup.device
    C = setup.num_classes

    # -- 3. each kernel against its plain version, main-path shapes -------
    gen = torch.Generator().manual_seed(SEED)
    w0 = setup.model.init(gen, D, C)["w"].to(dev)
    mask_cpu = setup.mask.cpu()
    pos = torch.stack([epoch_batches(setup.n_max, B, m, generator=gen)[0]
                       for m in mask_cpu]).to(dev)
    valid = batch_valid(pos, setup.n_max, setup.mask)
    rows = torch.gather(setup.idx, 1, pos.reshape(J, -1)).reshape(
        pos.shape).to(torch.int32).contiguous()
    y_reg = torch.randn(setup.X.shape[0], generator=gen).to(dev)
    lr = float(prm["lr"])
    # the registry's penalties (mu 1e-6, lam 5e-6) move W by less than
    # TOL_W over an epoch, so a second case starts every client from its
    # own perturbation of the anchor under penalties large enough to show
    # (those of the cuda-marked test in tests/test_torch_epoch_kernel.py)
    penalties = {"registry": (float(prm["lambda_prox"]),
                              float(prm["lambda_reg"]), 0.0),
                 "strong": (0.05, 0.01, 0.01)}
    k1_in = {}
    for pen, (mu, lam, jitter) in penalties.items():
        for task, y_all, Ct in (("classification", setup.y, C),
                                ("regression", y_reg, 1)):
            anchor = w0[:Ct].contiguous()
            W = anchor.expand(J, Ct, D) + jitter * torch.randn(
                (J, Ct, D), generator=gen).to(dev)
            k1_in[task, pen] = (W.contiguous(), anchor, setup.X, y_all,
                                rows, valid, lr, mu, lam, task)
    k1_err, stacked = 0.0, {}
    for (task, pen), args in k1_in.items():
        wk, mk = client_epoch(*args)
        torch.cuda.synchronize()
        wp, mp = client_epoch_plain(*args)
        ok_w, err_w = close(wk, wp, **TOL_W)
        tot = mp[:, 2].clamp(min=1)
        ok_l, err_l = close(mk[:, 0] / tot, mp[:, 0] / tot, 1e-4, 0)
        ok_a, err_a = close(100 * mk[:, 1] / tot, 100 * mp[:, 1] / tot,
                            1e-3, 0)
        emit({"phase": "kernel_check", "kernel": "client_epoch",
              "task": task, "penalties": pen, "mu": args[7],
              "lam": args[8], "shape": {"J": J, "C": int(wk.shape[1]), "D": D,
                                      "S": int(rows.shape[1]), "B": B},
              "max_abs_err_w": err_w, "max_abs_err_loss": err_l,
              "max_abs_err_acc": err_a, "tol_w": TOL_W,
              "tol_loss_atol": 1e-4, "tol_acc_atol": 1e-3,
              "ok": ok_w and ok_l and ok_a})
        if not (ok_w and ok_l and ok_a):
            fail(f"client_epoch ({task}, {pen} penalties) disagrees with "
                 "its plain version")
        k1_err = max(k1_err, err_w)
        if pen == "registry":
            stacked[task] = wk

    n_val = int(setup.X_val.shape[0])
    ppos = epoch_batches(n_val, VB, generator=gen)[0]
    pvalid = batch_valid(ppos, n_val).to(dev)
    ppos = ppos.to(dev, torch.int32)
    yv_reg = torch.randn(n_val, generator=gen).to(dev)
    cv = (setup.sizes > 0).to(torch.float32)
    p_in = {}
    for task, yv in (("classification", setup.y_val), ("regression", yv_reg)):
        logits = client_logits(setup.model.apply, {"w": stacked[task]},
                               setup.X_val)
        p_in[task] = (setup.p_fixed.contiguous(), torch.zeros_like(
            setup.p_fixed), cv, logits, yv, ppos, pvalid, float(prm["lr_p"]),
            0.9, task)
    k2_err = 0.0
    for task, args in p_in.items():
        pk, bk, mk = p_epoch(*args)
        torch.cuda.synchronize()
        pp, bp, mp = p_epoch_plain(*args)
        ok_p, err_p = close(pk, pp, **TOL_P)
        ok_b, err_b = close(bk, bp, **TOL_P)
        ok_m, err_m = close(mk[:2] / mk[2], mp[:2] / mp[2], 0, 2e-5)
        emit({"phase": "kernel_check", "kernel": "p_epoch", "task": task,
              "shape": {"n_val": n_val, "J": J,
                        "C": int(args[3].shape[2]), "B": VB,
                        "S": int(ppos.shape[0])},
              "max_abs_err_p": err_p, "max_abs_err_buf": err_b,
              "max_abs_err_metrics": err_m, "tol": TOL_P,
              "ok": ok_p and ok_b and ok_m})
        if not (ok_p and ok_b and ok_m):
            fail(f"p_epoch ({task}) disagrees with its plain version")
        k2_err = max(k2_err, err_p, err_b)

    # -- 4. the main path, counted ----------------------------------------
    # lr_mode "constant": over a 3-round cut the reference schedule would
    # divide lr by 10 at round 1 and by 1000 at round 2 (T/2 = 1,
    # 0.75T = 2), leaving one round of real training
    kw = dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, round=ROUNDS,
              seed=SEED, lr_mode="constant", return_state=True)
    amw_kw = dict(kw, lambda_reg=prm["lambda_reg"], lr_p=prm["lr_p"],
                  val_batch_size=VB)
    algos = (("FedAvg", FedAvg, kw), ("FedAMW", FedAMW, amw_kw))

    def timed(fn, **fkw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(setup, **fkw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # the plain reference runs first (they launch no kernel and warm up
    # the library calls both routes share), then the counted kernel runs:
    # every count is set to 0 just before each algorithm and read just after
    refs = {name: timed(fn, kernel_impl="plain", **fkw)
            for name, fn, fkw in algos}
    runs, counted = {}, {}
    for name, fn, fkw in algos:
        client_epoch.launches = 0
        p_epoch.launches = 0
        runs[name] = timed(fn, **fkw)
        counted[name] = {"client_epoch": client_epoch.launches,
                         "p_epoch": p_epoch.launches}
    launches = {k: sum(c[k] for c in counted.values())
                for k in ("client_epoch", "p_epoch")}
    # per round, from the counts: every algorithm runs the client epochs,
    # only FedAMW the p-solver
    per_round = {"client_epoch": launches["client_epoch"]
                 / (ROUNDS * len(algos)),
                 "p_epoch": counted["FedAMW"]["p_epoch"] / ROUNDS}
    emit({"phase": "main_path", "launches": launches,
          "by_algorithm": counted, "launches_per_round": per_round,
          "rounds_per_algorithm": ROUNDS, "local_epochs": EPOCHS})
    if launches["client_epoch"] == 0 or launches["p_epoch"] == 0:
        fail(f"the main path did not go through every kernel: {launches}")
    if counted["FedAvg"]["p_epoch"] != 0:
        fail(f"FedAvg launched the p-solver: {counted['FedAvg']}")
    if not all(float(v).is_integer() for v in per_round.values()):
        fail(f"launches are not a whole number per round: {per_round}")

    # chance is the test set's largest class share: always guessing that
    # class scores it
    chance = 100.0 * float(torch.bincount(setup.y_test.long()).max()
                           / setup.y_test.numel())
    for name, _, _ in algos:
        res, secs = runs[name]
        ref, plain_secs = refs[name]
        finite = all(np.all(np.isfinite(res[k]))
                     for k in ("train_loss", "test_loss", "test_acc"))
        d_loss = max(float(np.max(np.abs(res[k] - ref[k]) / np.abs(ref[k])))
                     for k in ("train_loss", "test_loss"))
        d_acc = float(np.max(np.abs(res["test_acc"] - ref["test_acc"])))
        d_w = float((res["params"]["w"] - ref["params"]["w"]).abs().max())
        ok = (finite and d_loss <= TOL_RUN["loss_rtol"]
              and d_acc <= TOL_RUN["acc_atol"] and d_w <= TOL_RUN["w_atol"])
        acc, tloss = res["test_acc"], res["test_loss"]
        learns = bool(np.all(np.diff(tloss) < 0) and acc[-1] > acc[0]
                      and acc[-1] >= chance + ACC_MARGIN)
        emit({"phase": "main_path", "algorithm": name,
              "train_loss": res["train_loss"].tolist(),
              "test_loss": res["test_loss"].tolist(),
              "test_acc": res["test_acc"].tolist(),
              "seconds": secs, "seconds_plain": plain_secs,
              "round_ms": 1e3 * secs / ROUNDS,
              "p_sum": float(res["p"].sum()),
              "chance_acc": chance, "learns": learns,
              "vs_plain": {"max_rel_loss": d_loss, "max_abs_acc": d_acc,
                           "max_abs_w": d_w}, "tol": TOL_RUN, "ok": ok})
        if not ok:
            fail(f"{name} on the kernels does not match its plain run")
        if not learns:
            fail(f"{name} does not learn: test loss must fall every round "
                 f"and the accuracy rise to {ACC_MARGIN} points above the "
                 f"{chance:.2f}% of the largest test class")

    # -- 5. where a FedAMW run's time goes (device time by kernel) ----------
    from torch.profiler import ProfilerActivity, profile

    saved = (client_epoch.launches, p_epoch.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = timed(FedAMW, **amw_kw)
    client_epoch.launches, p_epoch.launches = saved
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_kernel[ev.key] = (us / 1e3, ev.count)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "algorithm": "FedAMW", "rounds": ROUNDS,
          "wall_ms": 1e3 * secs,
          "device_ms": device_ms if device_ms > 0 else "not measured",
          "device_busy_share": (device_ms / (1e3 * secs) if device_ms > 0
                                else "not measured"),
          "top": [{"kernel": k[:80], "device_ms": ms, "calls": n}
                  for k, (ms, n) in top]})

    # -- 6. times and bounds at the main-path shapes ------------------------
    args = k1_in["classification", "registry"]
    n_rows = float(valid.sum())
    steps = int((valid.sum(-1) > 0).sum())
    k1_bytes = 4 * (n_rows * (D + 1) + 2 * J * C * D + C * D
                    + 2 * rows.numel() + 3 * J)
    k1_ops = 4 * C * D * n_rows + 12 * C * D * steps
    k2 = p_in["classification"]
    S2 = int(ppos.shape[0])
    k2_bytes = 4 * (n_val * J * C + n_val + 2 * S2 * VB + 5 * J + 3)
    k2_ops = 4 * n_val * J * C + 4 * J * S2
    kernels = []
    for name, fn, plain, a, nbytes, ops, err, src, repl in (
            ("client_epoch", client_epoch, client_epoch_plain, args,
             k1_bytes, k1_ops, k1_err, "csrc/client_epoch.cu",
             "non-iid-distributed-learning-with-optimal-mixture-weights_tpu/"
             "fedcore/pallas_kernel.py:40"),
            ("p_epoch", p_epoch, p_epoch_plain, k2, k2_bytes, k2_ops, k2_err,
             "csrc/p_epoch.cu",
             "non-iid-distributed-learning-with-optimal-mixture-weights_tpu/"
             "fedcore/pallas_psolver.py:38")):
        saved = fn.launches
        ms = cuda_ms(lambda: fn(*a), 10)
        fn.launches = saved
        plain_ms = cuda_ms(lambda: plain(*a), 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
        kernels.append({
            "name": name, "route": "cuda",
            "source": "non-iid-distributed-learning-with-optimal-mixture-"
                      f"weights_tpu_torch/{src}",
            "replaces": repl, "launches": launches[name],
            "launches_per_round": int(per_round[name]), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_fp32_ops": ops,
            "library_ms": None})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
