#!/usr/bin/env python3
"""Unguarded FedAMW on the zoo's CNN in both packages, on the same draws.

The configuration is ``scale_bench.py:mnist_conv_512`` at its widths
(784 raw pixels, 10 classes, ``conv8x16``, 512 Dirichlet(0.1) clients)
with its rows cut to ``--rows`` so that the JAX package runs it on the
CPU, trained as ``chip_smoke.py``'s zoo phase trains it (lr 0.1
constant, 2 local epochs, batch 32, FedAMW at the JAX package's
defaults: lambda 0.01, lr_p 5e-5, validation batch 16) with no p-guard,
then with the simplex guard. Every draw of the port's run is the JAX
run's, injected as in ``tests/test_torch_options.py``. The JAX package
is run as it is, except that its validation logits are mapped over
blocks of ``--client_block`` clients (``jax.lax.map`` of its own
``jax.vmap``, the same per-client arithmetic): its one ``vmap`` over
512 clients holds every client's activations at once, ~9.5 MB a row.

It prints one JSON line a guard: each package's losses, accuracies, the
largest |w| and the sum and largest |p| after each run, and the port's
largest distance to the JAX run:

    JAX_PLATFORMS=cpu python tools/zoo_unguarded_witness.py --rows 12000

It edits nothing and needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 100


def summary(res) -> dict:
    """The run's trajectory and the size of what it learned."""
    import numpy as np

    def host(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x, np.float64)

    p = host(res["p"])
    return {"train_loss": host(res["train_loss"]).tolist(),
            "test_loss": host(res["test_loss"]).tolist(),
            "test_acc": host(res["test_acc"]).tolist(),
            "w_max_abs": max(float(np.abs(host(v)).max())
                             for v in res["params"].values()),
            "p_sum": float(p.sum()), "p_max_abs": float(np.abs(p).max())}


def distance(rt, rj) -> dict:
    """The port's largest absolute distance to the JAX run, per vector,
    and relative for the losses."""
    import numpy as np

    def host(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x, np.float64)

    out = {k: float(np.abs(host(rt[k]) - host(rj[k])).max())
           for k in ("test_acc", "p")}
    out["rel_loss"] = max(float(np.max(
        np.abs(host(rt[k]) - host(rj[k]))
        / np.maximum(np.abs(host(rj[k])), 1e-30)))
        for k in ("train_loss", "test_loss"))
    out["w"] = max(float(np.abs(host(rt["params"][k])
                                - host(rj["params"][k])).max())
                   for k in rj["params"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12000,
                    help="rows of the stand-in (scale_bench: 60000)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--client_block", type=int, default=16)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import fedamw_tpu.algorithms as J
    import fedamw_tpu.algorithms.core as jcore
    import fedamw_tpu_torch.algorithms as T
    from fedamw_tpu.data import FederatedDataset, dirichlet_partition
    from fedamw_tpu.data.synthetic import synthetic_classification
    from fedamw_tpu_torch.convert import setup_from_arrays
    from test_torch_options import _inject

    def blocked_logits(apply_fn, stacked, X):
        """The JAX package's ``client_logits``, ``lax.map`` over blocks
        of ``--client_block`` clients."""
        nb = args.client_block
        Jn = jax.tree_util.tree_leaves(stacked)[0].shape[0]
        blocks = jax.tree_util.tree_map(
            lambda v: v.reshape((Jn // nb, nb) + v.shape[1:]), stacked)
        preds = jax.lax.map(
            lambda b: jax.vmap(lambda pj: apply_fn(pj, X))(b), blocks)
        preds = preds.reshape((Jn,) + preds.shape[2:])
        return jnp.transpose(preds, (1, 0, 2))

    jcore.client_logits = blocked_logits

    X, y, Xt, yt = synthetic_classification(
        args.rows, 784, 10, seed=13, test_fraction=1 / 6)
    parts, _ = dirichlet_partition(y, 512, alpha=0.1, seed=2020, min_size=0)
    ds = FederatedDataset(
        name="mnist-synth", task_type="classification", num_classes=10,
        d=784, X_train=X, y_train=y, X_test=Xt, y_test=yt, parts=parts,
        source="synthetic")
    sj = J.prepare_setup(ds, D=784, kernel_type="linear", seed=SEED,
                         rng=np.random.RandomState(SEED), model="conv8x16")
    idx, mask = sj.round_arrays()
    st = setup_from_arrays(
        task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
        X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test,
        y_test=sj.y_test, idx=idx[0], mask=mask[0], sizes=sj.sizes,
        p_fixed=sj.p_fixed, rff=None, model="conv8x16", device="cpu")
    inject = _inject(sj, "FedAMW", seed=0, rounds=args.rounds, epochs=2)
    for guard in ("none", "simplex"):
        kw = dict(lr=0.1, epoch=2, batch_size=32, round=args.rounds,
                  seed=0, lr_mode="constant", lambda_reg=0.01, lr_p=5e-5,
                  val_batch_size=16, return_state=True)
        t0 = time.perf_counter()
        os.environ["FEDAMW_P_GUARD"] = guard
        rj = J.FedAMW(sj, **kw)
        jax_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt = T.FedAMW(st, **kw, p_guard=guard, **inject)
        port_s = time.perf_counter() - t0
        print(json.dumps({
            "config": "scale_bench.py:mnist_conv_512 widths, rows cut",
            "rows": args.rows, "J": sj.num_clients, "n_max": st.n_max,
            "n_val": int(sj.X_val.shape[0]), "rounds": args.rounds,
            "p_guard": guard, "jax": summary(rj), "port": summary(rt),
            "port_vs_jax": distance(rt, rj),
            "seconds": {"jax": jax_s, "port": port_s}}), flush=True)


if __name__ == "__main__":
    main()
