"""Backend gate: one function registry, two execution paths (the JAX
package's ``registry.py``).

Drivers and the hyper-parameter loop call either path unchanged:

    backend = registry.get_backend("port" | "torch")
    setup = backend.prepare_setup(dataset, D=..., kernel_par=...)
    fn = backend.ALGORITHMS["FedAMW"]
    result = fn(setup, lr=..., round=..., lr_p=...)

``"port"`` is this package's own algorithms (``algorithms``: the CUDA
kernels on the card), the default, in the place the JAX package gives
its ``"jax"`` backend. ``"torch"`` is ``backends.torch_ref``, the
independent plain PyTorch implementation, as in the JAX package. The
port never imports JAX, so ``get_backend("jax")`` raises. Both backends
expose the same algorithm names, keyword surface and result dict
schema. Imports are lazy, so importing the registry loads no algorithm.
"""

from __future__ import annotations

from types import ModuleType

BACKENDS = ("port", "torch")


def get_backend(name: str = "port") -> ModuleType:
    if name == "port":
        from . import algorithms

        return algorithms
    if name == "torch":
        from .backends import torch_ref

        return torch_ref
    if name == "jax":
        raise ValueError(
            "backend 'jax' is the JAX package's (fedamw_tpu); "
            "fedamw_tpu_torch does not import JAX: choose from "
            f"{BACKENDS}")
    raise ValueError(f"unknown backend {name!r}; choose from {BACKENDS}")


def get_algorithm(name: str, backend: str = "port"):
    """Reference-style lookup: ``get_algorithm('FedAvg', 'port')``; an
    unknown name raises ``ValueError`` with the JAX package's message."""
    algos = get_backend(backend).ALGORITHMS
    if name not in algos:
        raise ValueError(f"unknown algorithm {name!r}; choose from {sorted(algos)}")
    return algos[name]


def get_serving() -> ModuleType:
    """The inference side of the registry: drivers obtain the serving
    subsystem the same way they obtain a training backend —
    ``registry.get_serving().ServingEngine.load(ckpt)``; the train→serve
    loop rides the same surface (``get_serving().ModelRegistry``,
    ``get_serving().RolloutController``). Serving runs the port's engine
    (``torch_ref`` is a parity reference, not a serving target)."""
    from . import serving

    return serving
