"""What the client round and the validation logits decide by: which
parameter structure the client-epoch kernel trains, and the largest
buffer a plain version gathers in one piece.

A leaf module: ``client.py``, ``aggregate.py`` and the plain versions of
both kernels read it, and it imports none of them.
"""

from __future__ import annotations

# The largest gathered-batch buffer a plain version builds in one piece:
# a whole epoch's features (J, S, B, D) for the client epoch (either
# route), a whole epoch's logits (S, B, J, C) for the p-solver, the
# activations of one row block of the validation logits. Above it they
# gather step by step (or block by block). The CUDA kernels gather their
# rows themselves and never build such a buffer.
EPOCH_GATHER_BYTES_LIMIT = int(1.5e9)


def kernel_route(params) -> bool:
    """Whether ``params`` has the linear model's structure, the only one
    the client-epoch kernel trains: a flat single-entry dict holding one
    2-D matrix (JAX ``client.py:_pallas_compatible``)."""
    return (isinstance(params, dict) and len(params) == 1
            and all(getattr(v, "ndim", None) == 2 for v in params.values()))
