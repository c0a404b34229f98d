"""Importable alias for the PyTorch + CUDA port of the framework.

The implementation lives in
``non-iid-distributed-learning-with-optimal-mixture-weights_tpu_torch/``,
which is not a valid Python identifier. Importing ``fedamw_tpu_torch``
loads that package under this name, so ``import
fedamw_tpu_torch.algorithms`` etc. work everywhere.
"""

import importlib.util
import os
import sys

_PKG_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "non-iid-distributed-learning-with-optimal-mixture-weights_tpu_torch",
)

_spec = importlib.util.spec_from_file_location(
    "fedamw_tpu_torch",
    os.path.join(_PKG_DIR, "__init__.py"),
    submodule_search_locations=[_PKG_DIR],
)
_mod = importlib.util.module_from_spec(_spec)
# Replace this shim in sys.modules with the real package *before* exec so
# intra-package relative imports resolve against the package.
sys.modules["fedamw_tpu_torch"] = _mod
_spec.loader.exec_module(_mod)
