"""Per-dataset hyperparameter registry.

Mirrors the reference registry ``functions/optimal_parameters.py:1-165``:
``get_parameter(dataset)`` returns the tuned hyperparameters the paper's
experiments run with. The values below are the reference's published
numbers verbatim (they are experimental facts, not code); the structure
is a plain table instead of an if/elif chain.

Keys (reference ``optimal_parameters.py``):
  task_type      'classification' | 'regression'
  num_examples   training-set size (used by the synthetic fallback)
  dimensional    raw input dimension d
  num_classes    output dimension C
  kernel_type    'gaussian' (RFF applied) or anything else (identity)
  kernel_par     RFF sigma
  lambda_reg     ridge coefficient for FedAMW local training
  lambda_reg_os  ridge coefficient for the one-shot variant
  lambda_prox    FedProx mu
  alpha_Dirk     Dirichlet concentration for the non-IID partitioner
  lr             local SGD learning rate
  lr_p           mixture-weight learning rate (FedAMW, SGD momentum 0.9)
  lr_p_os        mixture-weight learning rate (one-shot, plain SGD)
  local_update   always 100 (reference ``optimal_parameters.py:164``)
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Datasets treated as regression tasks (reference ``functions/utils.py:32-34``).
REGRESSION_DATASETS = frozenset({"abalone", "cadata", "cpusmall", "space_ga"})

_COMMON = {"kernel_type": "gaussian", "alpha_Dirk": 0.01, "task_type": "classification"}

_REGISTRY: dict[str, dict[str, Any]] = {
    "mnist": {
        **_COMMON,
        "num_examples": 60000,
        "dimensional": 784,
        "num_classes": 10,
        "kernel_par": 0.1,
        "lambda_reg_os": 0.000005,
        "lambda_reg": 0.000005,
        "lambda_prox": 0.000001,
        "lr": 0.5,
        "lr_p_os": 0.001,
        "lr_p": 0.001,
    },
    # The reference block (optimal_parameters.py:18-31) has NO lr_p —
    # its own exp.py:49 (parameter_dic['lr_p']) KeyErrors on this
    # dataset, so the reference never ran its experiment script on its
    # regression task. Every reference value below is kept verbatim;
    # lr_p/lr_p_os (the missing keys) are measured at the exp.py
    # full-defaults operating point (RESULTS.md § regression):
    # FedAMW's final MSE is lr_p-insensitive over [1e-5, 1e-3] but the
    # unconstrained-p MSE solver diverges to NaN at lr_p=1e-3 in 2/5
    # repeats (and always for lr_p >= 0.005, TUNING_regression.md), so
    # lr_p=1e-4 takes a 10x stability margin at equal quality
    # (verified finite on the two diverging seeds); the one-shot
    # solver is stable at 1e-3 and markedly best there (MSE 2.16 vs
    # 4.22 at 5e-4). The reference's NNI flow could not have produced
    # these: it reported accuracy even for regression
    # (reference tune.py:135), so its TPE was blind on this task.
    "synthetic_nonlinear": {
        "task_type": "regression",
        "num_examples": 10000,
        "dimensional": 10,
        "num_classes": 1,
        "kernel_type": "gaussian",
        "kernel_par": 0.1,
        "lambda_reg": 0.000001,
        "lambda_prox": 7e-7,
        "alpha_Dirk": 1,
        "lr": 0.001,
        "lr_p": 0.0001,
        "lr_p_os": 0.001,
    },
    "dna": {
        **_COMMON,
        "num_examples": 2000,
        "dimensional": 180,
        "num_classes": 3,
        "kernel_par": 0.1,
        "lambda_reg_os": 1e-6,
        "lambda_reg": 0.01,
        "lambda_prox": 0.01,
        "lr": 0.5,
        "lr_p_os": 0.1,
        "lr_p": 0.001,
    },
    "letter": {
        **_COMMON,
        "num_examples": 15000,
        "dimensional": 16,
        "num_classes": 26,
        "kernel_par": 0.1,
        "lambda_reg_os": 0.00005,
        "lambda_reg": 0.005,
        "lambda_prox": 0.00005,
        "lr": 0.5,
        "lr_p_os": 0.001,
        "lr_p": 0.0001,
    },
    "pendigits": {
        **_COMMON,
        "num_examples": 7494,
        "dimensional": 16,
        "num_classes": 10,
        "kernel_par": 0.01,
        "lambda_reg_os": 0.005,
        "lambda_reg": 0.01,
        "lambda_prox": 0.001,
        "lr": 0.5,
        "lr_p_os": 0.5,
        "lr_p": 0.0005,
    },
    "satimage": {
        **_COMMON,
        "num_examples": 4435,
        "dimensional": 36,
        "num_classes": 6,
        "kernel_par": 0.1,
        "lambda_reg_os": 0.001,
        "lambda_reg": 0.001,
        "lambda_prox": 0.0005,
        "lr": 0.5,
        "lr_p_os": 0.1,
        "lr_p": 0.00001,
    },
    "usps": {
        **_COMMON,
        "num_examples": 7291,
        "dimensional": 256,
        "num_classes": 10,
        "kernel_par": 0.1,
        "lambda_reg_os": 0.0005,
        "lambda_reg": 0.00005,
        "lambda_prox": 0.0001,
        "lr": 0.5,
        "lr_p_os": 0.005,
        "lr_p": 0.0005,
    },
    # Available with zero downloads: sklearn's bundled 8x8 digits. Our
    # own addition, not in the reference; lambda_reg/lr_p come from the
    # committed sweep (TUNING.md: 16 trials over the reference TPE grid
    # at round=100 — FedAMW 72.8% there, ~80% at the exp.py operating
    # point, vs ~44% under the earlier usps-copied values).
    "digits": {
        **_COMMON,
        "num_examples": 1797,
        "dimensional": 64,
        "num_classes": 10,
        "kernel_par": 0.1,
        "lambda_reg_os": 0.0005,
        "lambda_reg": 0.0005,
        "lambda_prox": 0.0001,
        "lr": 0.5,
        "lr_p_os": 0.005,
        "lr_p": 0.000005,
    },
}

_DEFAULT = {
    "task_type": "classification",
    "num_classes": 10,
    "dimensional": 784,
    "kernel_type": "gaussian",
    "kernel_par": 0.1,
    "lambda_reg": 0.00001,
    "lambda_prox": 7e-7,
    "lr": 0.001,
}


def get_parameter(dataset: str) -> dict[str, Any]:
    """Reference-compatible registry lookup (``optimal_parameters.py:1``).

    Unknown datasets get the reference's default block. Every result has
    ``local_update = 100`` appended, as in the reference.
    """
    out = dict(_REGISTRY.get(dataset, _DEFAULT))
    out["local_update"] = 100
    return out



@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Constants of the main experiment driver (reference ``exp.py:31-41``)."""

    dataset: str = "satimage"
    D: int = 2000                 # RFF feature dimension
    num_partitions: int = 50      # simulated clients
    local_epoch: int = 2
    rounds: int = 100             # communication rounds
    batch_size: int = 32
    n_repeats: int = 1
    alpha_dirichlet: float = 0.01
    seed: int = 100               # torch/np seed in the reference drivers
    partition_seed: int = 2020    # hard-coded in utils.py:320
    val_fraction: float = 0.2     # per-client share pooled for p-learning
    val_batch_size: int = 16      # exp.py:99
    data_dir: str = "datasets"
    result_dir: str = "results"
    # Faithful-vs-fixed switches for the reference's behavioral quirks:
    # parallel client semantics by default (the paper's description; the
    # reference's sequential contamination is an artifact) and the
    # reference's actual compounding LR decay (x1, x0.1, x0.001).
    sequential_clients: bool = False
    lr_schedule: str = "reference"  # 'reference' (x0.001 tail) | 'paper' (x0.01)
    # Fault-tolerance plane (an extension; the reference assumes clean,
    # full-report rounds). `faults` is a fedcore.faults.FaultSpec string
    # ('drop=0.1,corrupt=0.05:nan,seed=7'); `robust_agg` a fedcore.robust
    # spec ('mean' | 'median' | 'trim:K' | 'clip:R', '+'-combinable).
    # None/'mean' keep the reference's exact rounds.
    faults: str | None = None
    robust_agg: str = "mean"
