"""The algorithm registry by name (the JAX package's ``registry.py``).

``get_algorithm(name)`` returns one of the port's seven algorithms
(``algorithms.ALGORITHMS``), as the JAX package's
``get_algorithm(name, backend)`` returns its own for ``tune.py``'s loop.
The serving side (``get_serving``) comes with the serving port.
"""

from __future__ import annotations

from .algorithms import ALGORITHMS


def get_algorithm(name: str):
    """The algorithm registered as ``name`` (``"FedAvg"``, ``"FedAMW"``,
    ...); an unknown name raises ``ValueError`` with the JAX package's
    message."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; choose from "
                         f"{sorted(ALGORITHMS)}")
    return ALGORITHMS[name]
