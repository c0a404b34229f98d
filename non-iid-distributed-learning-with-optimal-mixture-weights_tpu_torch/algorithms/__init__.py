from .common import FedSetup, prepare_setup, result_tuple
from .core import (
    Centralized,
    Distributed,
    FedAMW,
    FedAMW_OneShot,
    FedAvg,
    FedNova,
    FedProx,
)

# Function-per-algorithm registry, mirroring the reference's import
# surface (``from functions.tools import ...``, exp.py:4) and the JAX
# package's names.
ALGORITHMS = {
    "Centralized": Centralized,
    "Distributed": Distributed,
    "FedAMW_OneShot": FedAMW_OneShot,
    "FedAvg": FedAvg,
    "FedProx": FedProx,
    "FedNova": FedNova,
    "FedAMW": FedAMW,
}

__all__ = [
    "FedSetup",
    "prepare_setup",
    "result_tuple",
    "ALGORITHMS",
    "Centralized",
    "Distributed",
    "FedAMW",
    "FedAMW_OneShot",
    "FedAvg",
    "FedNova",
    "FedProx",
]
