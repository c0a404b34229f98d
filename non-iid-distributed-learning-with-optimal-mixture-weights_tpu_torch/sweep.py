"""Standalone hyper-parameter sweep of FedAMW on the port: the NNI-free
twin of ``config.yml``.

The port's counterpart of the repository's ``sweep.py``: it samples
trials from the same search grid (``config.yml``'s ``searchSpace``),
runs each through the port's ``tune.main`` in process, and writes a
ranked TUNING table. With NNI installed, ``nnictl create --config
non-iid-distributed-learning-with-optimal-mixture-weights_tpu_torch/
config.yml`` is the full TPE path; this module is the zero-dependency
fallback.

Run from the repository root::

    python -m fedamw_tpu_torch.sweep --dataset mnist --trials 12 --round 50
    python -m fedamw_tpu_torch.sweep --device cpu --dataset digits \\
        --trials 2 --round 3 --out /tmp/TUNING.md

The trials run on the card unless ``--device`` names another device.
``--out`` defaults to ``TUNING_torch.md`` in the current directory, so
the committed ``TUNING.md`` is never overwritten.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

from . import tune
from .config import get_parameter
from .registry import BACKENDS

# the reference search space, config.yml:12-17 (verbatim grids)
LR_P_GRID = [0.5, 0.1, 0.01, 0.005, 0.001, 0.0005, 0.0001,
             0.00005, 0.00001, 0.000005, 0.000001]
LAMBDA_REG_GRID = [0.1, 0.01, 0.005, 0.001, 0.0005, 0.0001,
                   0.00005, 0.00001, 0.000005, 0.000001, 0.0000001]


def _is_regression(dataset) -> bool:
    return get_parameter(dataset).get("task_type") == "regression"


def run_sweep(dataset, trials, rounds, seed, backend="port", trial_seed=1,
              device=None):
    """``trials`` picks from the grid, drawn without replacement by
    ``RandomState(seed)``, each run through ``tune.main`` at
    ``seed=trial_seed``; returns the trials ranked best first."""
    rng = np.random.RandomState(seed)
    grid = [(lp, lam) for lp in LR_P_GRID for lam in LAMBDA_REG_GRID]
    picks = [grid[i] for i in rng.choice(len(grid), size=min(trials, len(grid)),
                                         replace=False)]
    results = []
    for i, (lr_p, lam) in enumerate(picks):
        params = vars(tune.get_params())
        # pin the trial seed: --seed is the grid-sampling seed here, and
        # parse_known_args would otherwise pass it on to the trials (the
        # NNI flow runs the trial at its default seed=1)
        params.update(dataset=dataset, lr_p=lr_p, lambda_reg=lam,
                      round=rounds, backend=backend, seed=trial_seed,
                      device=device)
        t0 = time.perf_counter()
        metrics = {}
        acc = tune.main(params, metrics_out=metrics)
        dt = time.perf_counter() - t0
        results.append({"lr_p": lr_p, "lambda_reg": lam,
                        "acc": acc, "loss": metrics["loss"],
                        "wall_s": dt})
        print(f"[trial {i + 1}/{len(picks)}] lr_p={lr_p} lambda_reg={lam} "
              f"-> acc {acc:.2f} loss {metrics['loss']:.5f} ({dt:.1f}s)",
              flush=True)
    if _is_regression(dataset):
        # acc is 0.0 on a regression task: rank by final MSE ascending,
        # a diverged (non-finite) trial last
        return sorted(results,
                      key=lambda r: (not math.isfinite(r["loss"]),
                                     r["loss"]))
    return sorted(results, key=lambda r: -r["acc"])


def _where(device) -> str:
    """The device the trials ran on, by name: the card's when CUDA."""
    import torch

    dev = tune.resolve_device(device)
    if dev.type == "cuda":
        return f"on {torch.cuda.get_device_name(dev)}"
    return f"on the {dev.type.upper()}"


def write_report(results, dataset, rounds, seed, out, trial_seed=1,
                 backend="port", device=None):
    """The TUNING table of ``results`` (ranked by ``run_sweep``) into
    ``out``: the JAX package's report line for line but for its header's
    first two lines, the command (this module and the device) and the
    reference grid's source (its file and lines, without a local
    path)."""
    # the trial loss is the task's own objective: CE for
    # classification, MSE for regression
    loss_label = "final MSE" if _is_regression(dataset) else "final CE"
    dev = "cuda" if device is None else device
    lines = [
        "# TUNING — FedAMW hyperparameter sweep (standalone)",
        "",
        f"`python -m fedamw_tpu_torch.sweep --dataset {dataset} --trials "
        f"{len(results)} --round {rounds} --seed {seed} --trial_seed "
        f"{trial_seed} --backend {backend} --device {dev} --out {out}` "
        f"{_where(device)} — random search over the",
        "reference TPE grid (the reference's `config.yml:12-17`; NNI is",
        "not installed here, so this is the zero-dependency twin of the",
        "`nnictl` flow — `tune.py` is the trial entry in both). 50",
        "clients, Dirichlet alpha=0.01, D=2000 RFF, the registry's",
        "remaining hyperparameters.",
        "",
        f"| rank | lr_p | lambda_reg | final acc | {loss_label} | trial wall (s) |",
        "|---|---|---|---|---|---|",
    ]
    for i, r in enumerate(results):
        lines.append(f"| {i + 1} | {r['lr_p']} | {r['lambda_reg']} | "
                     f"{r['acc']:.2f} | {r.get('loss', float('nan')):.5f} "
                     f"| {r['wall_s']:.1f} |")
    lines += [
        "",
        "The rows above rank this run's sampled trials only. Historical",
        "note: the `digits` registry block (`config.py`) carries the",
        "rank-1 values of the committed digits sweep (adopted in commit",
        "06c7e94), and the parity artifacts (`results_parity/`,",
        "PARITY.md) were regenerated under them. The reference's own",
        "per-dataset blocks were produced the same way at larger trial",
        "counts.",
        "",
    ]
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"report -> {out}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m fedamw_tpu_torch.sweep",
                                 description=__doc__)
    ap.add_argument("--dataset", type=str, default="digits")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--round", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7,
                    help="grid-sampling seed (NOT the trial training seed)")
    ap.add_argument("--trial_seed", type=int, default=1,
                    help="training seed passed to every trial "
                         "(tune's default, matching the NNI flow)")
    ap.add_argument("--backend", type=str, default="port",
                    choices=list(BACKENDS))
    ap.add_argument("--out", type=str, default="TUNING_torch.md",
                    help="report path, resolved against the current "
                         "directory")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device the trials run on (default: the "
                         "CUDA card; 'cpu' runs the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    results = run_sweep(args.dataset, args.trials, args.round, args.seed,
                        args.backend, trial_seed=args.trial_seed,
                        device=args.device)
    write_report(results, args.dataset, args.round, args.seed, args.out,
                 trial_seed=args.trial_seed, backend=args.backend,
                 device=args.device)


if __name__ == "__main__":
    main()
