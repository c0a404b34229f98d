"""One hyper-parameter tuning trial of FedAMW on the port (NNI-compatible).

The port's counterpart of the repository's ``tune.py``: one trial merges
the tuner's proposed parameters over the argparse defaults (the same
flags, defaults and types), runs FedAMW with the registry's remaining
hyper-parameters (50 clients, Dirichlet alpha 0.01, batch 32) and
reports the final test accuracy. NNI is import-gated: without it the
module runs standalone with its flags and prints the metric, so the same
module serves ``nnictl create --config config.yml`` (the port's copy
beside this file) and ``python -m fedamw_tpu_torch.sweep``.

Run from the repository root::

    python -m fedamw_tpu_torch.tune --dataset mnist --round 20 \\
        --lr_p 0.001 --lambda_reg 5e-6
    python -m fedamw_tpu_torch.tune --device cpu --dataset digits --D 64 \\
        --round 2

``--backend`` picks the execution path through ``registry.get_backend``:
``port`` (the default: the CUDA kernels on the card) or ``torch`` (the
plain reference, ``backends.torch_ref``). ``--device`` says where the
trial runs: the card unless it names another device; with no card it
raises rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from .config import get_parameter
from .data import load_dataset
from .device import resolve_device
from .registry import BACKENDS, get_backend

try:
    import nni
    from nni.utils import merge_parameter

    HAS_NNI = True
except ImportError:  # tuner not installed: standalone mode
    HAS_NNI = False

logger = logging.getLogger("Tune Hyperparameters")


def get_params():
    ap = argparse.ArgumentParser(prog="python -m fedamw_tpu_torch.tune",
                                 description="Tuner")
    ap.add_argument("--seed", type=int, default=1, metavar="S")
    ap.add_argument("--dataset", type=str, default="usps")
    ap.add_argument("--backend", type=str, default="port",
                    choices=list(BACKENDS))
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="data heterogeneity parameter (synthetic)")
    ap.add_argument("--beta", type=float, default=0.0,
                    help="model heterogeneity (synthetic)")
    ap.add_argument("--D", type=int, default=2000, metavar="N")
    ap.add_argument("--kernel_par", type=float, default=0.1)
    ap.add_argument("--lambda_reg_os", type=float, default=0.000001)
    ap.add_argument("--lambda_reg", type=float, default=0.000001)
    ap.add_argument("--lambda_prox", type=float, default=0.01)
    ap.add_argument("--data_dir", type=str, default="datasets")
    ap.add_argument("--lr", type=float, default=0.5, metavar="LR")
    ap.add_argument("--lr_p", type=float, default=0.1, metavar="LR_p")
    ap.add_argument("--lr_p_os", type=float, default=0.1, metavar="LR_p")
    ap.add_argument("--local_epoch", type=int, default=2)
    ap.add_argument("--round", type=int, default=100, metavar="N")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    args, _ = ap.parse_known_args()
    return args


def main(args, metrics_out=None):
    # no card and no --device cpu: refuse before the data is loaded
    resolve_device(args["device"])
    dataset = args["dataset"]
    registry_params = get_parameter(dataset)
    num_partitions = 50
    batch_size = 32
    alpha_dirk = 0.01

    rng = np.random.RandomState(args["seed"])
    ds = load_dataset(
        dataset, num_partitions, alpha_dirk,
        data_dir=args["data_dir"], rng=rng,
    )
    backend = get_backend(args["backend"])
    setup = backend.prepare_setup(
        ds,
        D=args["D"],
        kernel_par=registry_params["kernel_par"],
        kernel_type=registry_params["kernel_type"],
        seed=args["seed"],
        rng=rng,
        device=args["device"],
    )
    res = backend.ALGORITHMS["FedAMW"](
        setup,
        lr=registry_params["lr"],
        epoch=int(args["local_epoch"]),
        batch_size=batch_size,
        lambda_reg_if=True,
        lambda_reg=args["lambda_reg"],
        round=args["round"],
        lr_p=args["lr_p"],
        seed=args["seed"],
    )
    acc = float(res["test_acc"][-1])
    loss = float(res["test_loss"][-1])
    logger.info("FedAMW --- Error: %.5f Acc: %.5f", loss, acc)
    print(f"FedAMW final: loss={loss:.5f} acc={acc:.5f}")
    if metrics_out is not None:
        # for in-process callers (the sweep): a regression trial is
        # ranked by its MSE, since its acc is 0.0; NNI gets the acc, as
        # in the JAX package's trial
        metrics_out.update(acc=acc, loss=loss)
    if HAS_NNI:
        nni.report_final_result(acc)
    return acc


def cli():
    """The ``__main__`` flow: the tuner's next parameters merged over
    the flags under NNI, the flags alone without it."""
    try:
        if HAS_NNI:
            tuner_params = nni.get_next_parameter()
            logger.debug(tuner_params)
            params = vars(merge_parameter(get_params(), tuner_params))
        else:
            params = vars(get_params())
        print(params)
        main(params)
    except Exception as exc:
        logger.exception(exc)
        raise


if __name__ == "__main__":
    cli()
