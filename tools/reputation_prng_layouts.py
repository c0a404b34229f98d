#!/usr/bin/env python3
"""The five red reputation tests' measured values under both PRNG layouts.

``tests/test_reputation.py`` pins values measured on one stream of
``jax.random`` draws. ``jax_threefry_partitionable`` became JAX's default
in 0.5.0, which changes every draw (the initial weights and the shuffles
of the tests' digits runs). This script repeats the calls of the five
tests that are red under the installed default, once in a child process
per layout (``JAX_THREEFRY_PARTITIONABLE=1`` and ``=0``), and prints one
JSON line per layout with the value each test asserts on:

    JAX_PLATFORMS=cpu python tools/reputation_prng_layouts.py

It edits nothing and needs no card (a few minutes on the CPU).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure() -> dict:
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_reputation import KW, lie_plan, sign_plan

    from fedamw_tpu.algorithms import FedAvg, FedNova, prepare_setup
    from fedamw_tpu.data import load_dataset
    from fedamw_tpu.fedcore.faults import FaultPlan
    from fedamw_tpu.utils.reporting import defense_summary

    def setup(alpha):
        return prepare_setup(load_dataset("digits", num_partitions=8,
                                          alpha=alpha),
                             kernel_type="linear", seed=3,
                             rng=np.random.RandomState(3))

    iid, het = setup(100.0), setup(0.5)
    out = {"jax": jax.__version__,
           "threefry_partitionable": bool(
               jax.config.jax_threefry_partitionable)}
    R, J = 10, iid.num_clients
    rep = FedAvg(iid, faults=sign_plan(R, J, 2), robust_agg="rep:0.5:0.2",
                 round=R, **KW)["defense"]["reputation"]
    out["persistent_flipper_honest_min"] = float(np.delete(rep[-1], 2).min())
    rep = FedAvg(iid, faults=sign_plan(R, J, 2, rounds_active=slice(0, 3)),
                 robust_agg="rep:0.5:0.2", round=R,
                 **KW)["defense"]["reputation"]
    out["transient_recovery_rep_last"] = float(rep[-1, 2])
    R, J = 6, het.num_clients
    d = FedNova(het, faults=lie_plan(R, J, 2), robust_agg="rep:0.5:0.2",
                round=R, **KW)["defense"]
    out["lie_attack_frac_clamped"] = d["frac_clamped"].tolist()
    d = FedAvg(het, faults=lie_plan(R, J, 2),
               robust_agg="rep:0.5:0.2+quarantine:auto", round=R,
               **KW)["defense"]
    out["defense_report_total_frac_clamped"] = int(
        defense_summary(d)["total_frac_clamped"])
    R = 12
    z = np.zeros((R, J), np.float32)
    corrupt, scale = z.copy(), np.ones((R, J), np.float32)
    corrupt[:, 2], scale[:, 2] = 1, 2.0
    d = FedAvg(het, faults=FaultPlan(z, z.copy(), corrupt, scale, z.copy(),
                                     z.copy()),
               robust_agg="quarantine:auto", round=R, lr=0.5, epoch=1,
               seed=0, lr_mode="constant")["defense"]
    out["auto_threshold_z_max_0"] = float(d["z_max"][0])
    return out


def main() -> None:
    if os.environ.get("_REPUTATION_PRNG_CHILD"):
        print(json.dumps(measure()), flush=True)
        return
    for layout in ("1", "0"):
        env = dict(os.environ, JAX_THREEFRY_PARTITIONABLE=layout,
                   JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   _REPUTATION_PRNG_CHILD="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.environ.get("PYTHONPATH", "")]))
        res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                             env=env, capture_output=True, text=True,
                             check=True)
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
