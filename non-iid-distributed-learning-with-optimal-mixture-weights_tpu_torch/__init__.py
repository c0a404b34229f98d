"""PyTorch + CUDA port of the federated-learning framework with optimal
mixture weights (FedAMW), for an NVIDIA H100.

It sits beside the JAX package (``fedamw_tpu``), which stays the
reference, and imports neither JAX nor anything of that package. Plain
tensor code is PyTorch; the JAX package's two Pallas TPU kernels are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use:

- ``fedcore/epoch_kernel.py`` + ``csrc/client_epoch.cu``: one local-SGD
  epoch of every client of a round (replaces
  ``fedcore/pallas_kernel.py:_epoch_kernel``);
- ``fedcore/psolver_kernel.py`` + ``csrc/p_epoch.cu``: one epoch of
  FedAMW's mixture-weight solver (replaces
  ``fedcore/pallas_psolver.py:_p_epoch_kernel``).

Each kernel has a plain PyTorch version beside it; a wrapper takes that
plain version only for CPU tensors. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.

Import via the repo-root alias module ``fedamw_tpu_torch``.
"""

from . import config, registry  # noqa: F401

__version__ = "0.1.0"
