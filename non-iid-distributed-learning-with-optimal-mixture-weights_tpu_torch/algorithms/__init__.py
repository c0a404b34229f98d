from .common import FedSetup, prepare_setup, result_tuple
from .core import FedAMW, FedAvg, FedProx

# Function-per-algorithm registry, mirroring the reference's import
# surface (``from functions.tools import ...``, exp.py:4). The JAX
# package's Centralized, Distributed, FedAMW_OneShot and FedNova are not
# ported yet (ROADMAP.md, queue 1).
ALGORITHMS = {
    "FedAvg": FedAvg,
    "FedProx": FedProx,
    "FedAMW": FedAMW,
}

__all__ = [
    "FedSetup",
    "prepare_setup",
    "result_tuple",
    "ALGORITHMS",
    "FedAMW",
    "FedAvg",
    "FedProx",
]
