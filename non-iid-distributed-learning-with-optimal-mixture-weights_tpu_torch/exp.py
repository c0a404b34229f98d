"""The paper's experiment driver on the port: six algorithms on one dataset.

Follows the repository's ``exp.py`` (the reference flow,
``exp.py:753-835``): per repeat ``t``, a ``RandomState(seed + t)``
drives loading and the validation split; the features are RFF-mapped
once; the heterogeneity score is taken on the full partitions; then
Centralized and Distributed (``local_epoch * round`` epochs),
FedAMW_OneShot (the registry's ``lambda_reg_os``/``lr_p_os``), FedAvg,
FedProx and FedAMW (the registry's lr, mu, lambda and lr_p) run in that
order. The result is ``{result_dir}/exp1_{dataset}.pkl`` with exactly
``exp.py``'s keys (``exp.py:476-493``): ``(6, round, n_repeats)`` metric
arrays, the heterogeneity of each repeat, the row names and the task.

Run from the repository root::

    python -m fedamw_tpu_torch.exp --dataset mnist --round 100
    python -m fedamw_tpu_torch.exp --device cpu --dataset digits --D 64 \\
        --num_partitions 4 --round 2

It runs on the CUDA card unless ``--device`` names another device, and
raises without a card rather than falling back to the CPU. The JAX
package's extension flags (sharding, faults, checkpoints, ...) are not
carried yet: each is refused with a pointer to its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

from .algorithms import ALGORITHMS, prepare_setup
from .config import get_parameter
from .data import load_dataset
from .data.svmlight import is_regression
from .device import resolve_device
from .ops.rff import heterogeneity_from_parts

NAMES = ["CL", "DL", "FedAMW_OneShot", "FedAvg", "FedProx", "FedAMW"]

# exp.py's flags that the port does not carry, and the ROADMAP.md item
# that will bring each
_REFUSED = {
    "--shard": "queue 1 item 10 (multi-GPU)",
    "--multihost": "queue 1 item 10 (multi-GPU)",
    "--coordinator": "queue 1 item 10 (multi-GPU)",
    "--num_processes": "queue 1 item 10 (multi-GPU)",
    "--process_id": "queue 1 item 10 (multi-GPU)",
    "--model": "queue 1 items j and 13 (the model zoo)",
    "--participation": "queue 1 item d (partial participation)",
    "--faults": "queue 1 item 8 (faults and defenses)",
    "--robust_agg": "queue 1 item 8 (faults and defenses)",
    "--cohort_shards": "queue 1 item 9 (the cohort plane)",
    "--stream_cohort": "queue 1 item 9 (the cohort plane)",
    "--feature_dtype": "queue 1 item b (bf16 feature storage)",
    "--server_opt": "queue 1 item e (server optimizers)",
    "--server_lr": "queue 1 item e (server optimizers)",
    "--p_guard": "queue 1 item c (p-guards)",
    "--save_models": "queue 1 item 7 (checkpoints)",
    "--publish_every": "queue 1 item 7 (checkpoints)",
    "--resume": "queue 1 item f (round resume)",
    "--profile": "queue 1 item 7 (trace and telemetry)",
    "--trace_dir": "queue 1 item 7 (trace and telemetry)",
    "--sequential": "queue 1 item j (sequential=True)",
}


class _Refused(argparse.Action):
    """A flag the port does not carry: using it is an argparse error that
    names its ROADMAP.md item. It takes an optional value so that
    ``--flag VALUE`` is refused the same way as ``--flag``."""

    def __init__(self, option_strings, dest, item, **kw):
        self.item = item
        super().__init__(option_strings, dest, nargs="?",
                         default=argparse.SUPPRESS,
                         help=f"not ported yet (ROADMAP.md, {item})", **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to fedamw_tpu_torch "
                     f"yet (see ROADMAP.md, {self.item})")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fedamw_tpu_torch.exp",
        description="FedAMW experiment driver (PyTorch + CUDA port)")
    ap.add_argument("--dataset", type=str, default="satimage")
    ap.add_argument("--D", type=int, default=2000)
    ap.add_argument("--num_partitions", type=int, default=50)
    ap.add_argument("--local_epoch", type=int, default=2)
    ap.add_argument("--round", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_repeats", type=int, default=1)
    ap.add_argument("--alpha_Dirk", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--data_dir", type=str, default="datasets")
    ap.add_argument("--result_dir", type=str, default="./results")
    ap.add_argument("--lr_mode", type=str, default="reference",
                    choices=["reference", "paper", "constant"])
    ap.add_argument("--verbose", action="store_true",
                    help="print each round's train loss, test loss and "
                         "accuracy (reference tools.py:236)")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the registry's learning rate")
    ap.add_argument("--lr_p", type=float, default=None,
                    help="override the registry's mixture-weight learning "
                         "rate (FedAMW's p-solver)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    for flag, item in _REFUSED.items():
        ap.add_argument(flag, action=_Refused, item=item)
    return ap.parse_args(argv)


def _task_type(dataset: str, params: dict) -> str:
    """The dataset's task by the data layer's rule
    (``data/datasets.py``): the regression name list wins over the
    registry, whose default block says 'classification'."""
    return "regression" if is_regression(dataset) else params["task_type"]


def run_paper_algorithms(setup, *, rounds, local_epoch, batch_size, seed, lr,
                         lr_p, lr_p_os, mu, lam, lam_os, lr_mode="reference",
                         verbose=False):
    """The six algorithms of one repeat in the driver's row order
    (``NAMES``), with ``exp.py``'s arguments (``exp.py:819-835,902-914``).
    Returns ``[(name, result, wall_seconds), ...]``; each result has come
    back to the host, so its seconds include the device's work."""
    common = dict(batch_size=batch_size, seed=seed)
    long_epoch = local_epoch * rounds
    round_common = dict(common, epoch=local_epoch, round=rounds,
                        lr_mode=lr_mode, verbose=verbose)
    calls = [
        ("CL", "Centralized", dict(common, lr=lr, epoch=long_epoch)),
        ("DL", "Distributed", dict(common, lr=lr, epoch=long_epoch)),
        ("FedAMW_OneShot", "FedAMW_OneShot",
         dict(common, lr=lr, epoch=long_epoch, lambda_reg_if=True,
              lambda_reg=lam_os, round=rounds, lr_p=lr_p_os)),
        ("FedAvg", "FedAvg", dict(round_common, lr=lr)),
        ("FedProx", "FedProx", dict(round_common, lr=lr, prox=True, mu=mu)),
        ("FedAMW", "FedAMW", dict(round_common, lr=lr, lambda_reg_if=True,
                                  lambda_reg=lam, lr_p=lr_p)),
    ]
    out = []
    for name, algo, kw in calls:
        t0 = time.perf_counter()
        res = ALGORITHMS[algo](setup, **kw)
        out.append((name, res, time.perf_counter() - t0))
    return out


def main(argv=None) -> str:
    """Run the experiment and write its pickle; returns the pickle's
    path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    params = get_parameter(args.dataset)
    lr = params["lr"] if args.lr is None else args.lr
    lr_p = params.get("lr_p", 1e-3) if args.lr_p is None else args.lr_p
    R = args.round
    train_mat = np.empty((6, R, args.n_repeats))
    error_mat = np.empty((6, R, args.n_repeats))
    acc_mat = np.empty((6, R, args.n_repeats))
    hete = np.empty(args.n_repeats)
    for t in range(args.n_repeats):
        rng = np.random.RandomState(args.seed + t)
        ds = load_dataset(args.dataset, args.num_partitions, args.alpha_Dirk,
                          data_dir=args.data_dir, rng=rng, verbose=True)
        setup = prepare_setup(ds, D=args.D, kernel_par=params["kernel_par"],
                              kernel_type=params["kernel_type"],
                              seed=args.seed + t, rng=rng, device=device)
        # on the FULL partitions, before the validation split
        # (reference exp.py:66-76)
        hete[t] = heterogeneity_from_parts(setup.X, ds.parts)
        print(f"[repeat {t}] data heterogeneity: {hete[t]:.4f}")
        t0 = time.perf_counter()
        runs = run_paper_algorithms(
            setup, rounds=R, local_epoch=args.local_epoch,
            batch_size=args.batch_size, seed=args.seed + t, lr=lr,
            lr_p=lr_p, lr_p_os=params.get("lr_p_os", lr_p),
            mu=params["lambda_prox"], lam=params["lambda_reg"],
            lam_os=params.get("lambda_reg_os", params["lambda_reg"]),
            lr_mode=args.lr_mode, verbose=args.verbose)
        for row, (name, res, secs) in enumerate(runs):
            train_mat[row, :, t] = res["train_loss"]
            error_mat[row, :, t] = res["test_loss"]
            acc_mat[row, :, t] = res["test_acc"]
            print(f"{name}: final acc {np.ravel(res['test_acc'])[-1]:.2f} "
                  f"({secs:.2f} s)")
        print(f"[repeat {t}] wall time {time.perf_counter() - t0:.1f}s "
              f"(device={device})")

    data_ = {
        "epochs": R,
        "train_loss": train_mat,
        "test_loss": error_mat,
        "test_acc": acc_mat,
        "heterogeneity": hete,
        "name": list(NAMES),
        "task": _task_type(args.dataset, params),
    }
    os.makedirs(args.result_dir, exist_ok=True)
    out = os.path.join(args.result_dir, f"exp1_{args.dataset}.pkl")
    with open(out, "wb") as f:
        pickle.dump(data_, f)
    print(f"results -> {out}")
    return out


if __name__ == "__main__":
    main()
