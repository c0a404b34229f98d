#!/usr/bin/env python3
"""FedNova under a lie fault alone: both packages' float32 runs against a
float64 run of the same round loop.

The case is ``lie=0.3:0.01,seed=5`` under ``rep:0.5:0.2`` on the
``tests/test_torch_defense.py`` setup (digits, J=6, RFF D=64, 3 rounds of
2 local epochs) with every draw injected from the JAX run. The JAX
package cannot run it in float64 without an edit (its initial weights and
scan carries are float32), so the yardstick is the port's plain path in
float64: :func:`float64_torch` makes every ``torch.float32`` the port
asks for a float64 and widens ``Tensor.float()``, and the run goes
through ``kernel_impl="plain"``. The script prints one JSON line with
each float32 run's largest distance to the float64 run (final weights,
reputation trajectory, losses) and whether its verdicts equal it:

    JAX_PLATFORMS=cpu python tools/fault5_float64.py

It edits nothing and needs no card (about 20 s on the CPU).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASE = ("FedNova", "lie=0.3:0.01,seed=5", "rep:0.5:0.2")
ROUNDS = 3
VERDICTS = ("rep_gated", "frac_clamped")


@contextlib.contextmanager
def float64_torch():
    """Inside the block every ``torch.float32`` the code names is
    ``torch.float64``, ``Tensor.float()`` is ``Tensor.double()`` and new
    floating tensors default to float64; all three are restored after
    it. Constants bound to ``torch.float32`` before the block (a kernel
    wrapper's dtype table) keep it, so a run in the block takes
    ``kernel_impl="plain"``."""
    import torch

    f32, to_float = torch.float32, torch.Tensor.float
    default = torch.get_default_dtype()
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.float32 = f32
        torch.Tensor.float = to_float
        torch.set_default_dtype(default)


def runs(jsetup, tsetup, inject, kwargs):
    """``(port float32, JAX float32, port float64)`` results of the case.
    ``tsetup()`` builds the port's setup afresh (inside the float64 block
    it is a float64 setup)."""
    import fedamw_tpu.algorithms as J
    import fedamw_tpu_torch.algorithms as T

    algo = CASE[0]
    sj = jsetup()
    inj = inject(sj)
    rj = getattr(J, algo)(sj, **kwargs)
    rt = getattr(T, algo)(tsetup(), **kwargs, **inj)
    with float64_torch():
        r64 = getattr(T, algo)(tsetup(), **kwargs, **inj,
                               kernel_impl="plain")
    return rt, rj, r64


def distances(res, ref) -> dict:
    """The largest absolute distance of a float32 result to the float64
    one, per returned vector, and whether every verdict is equal."""
    import numpy as np

    def f64(x):
        return np.asarray(x.numpy() if hasattr(x, "numpy") else x,
                          np.float64)

    out = {k: float(np.abs(f64(res[k]) - f64(ref[k])).max())
           for k in ("train_loss", "test_loss", "test_acc")}
    out["w"] = float(np.abs(f64(res["params"]["w"])
                            - f64(ref["params"]["w"])).max())
    out["reputation"] = float(np.abs(
        f64(res["defense"]["reputation"])
        - f64(ref["defense"]["reputation"])).max())
    out["verdicts_equal"] = bool(
        all(np.array_equal(res["defense"][k], ref["defense"][k])
            for k in VERDICTS)
        and all(np.array_equal(v, ref["fault_counts"][k])
                for k, v in res["fault_counts"].items()))
    return out


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from test_torch_options import _inject, _jsetup, _kwargs, _tsetup

    algo, faults, spec = CASE
    kwargs = _kwargs(algo, "cls10", round=ROUNDS, faults=faults,
                     robust_agg=spec)

    rt, rj, r64 = runs(lambda: _jsetup("cls10"),
                       lambda: _tsetup.__wrapped__("cls10"),
                       lambda sj: _inject(sj, algo, rounds=ROUNDS), kwargs)
    print(json.dumps({
        "case": dict(zip(("algorithm", "faults", "robust_agg"), CASE)),
        "float64_yardstick": "the port's plain path in float64",
        "w_max_abs": float(np.abs(np.asarray(r64["params"]["w"])).max()),
        "port_vs_float64": distances(rt, r64),
        "jax_vs_float64": distances(rj, r64),
        "port_vs_jax": distances(rt, rj),
    }))


if __name__ == "__main__":
    main()
