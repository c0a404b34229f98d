from .launch import spawn
from .mesh import (
    CLIENT_AXIS,
    ClientAxis,
    ClientMesh,
    client_spec,
    initialize_multihost,
    make_mesh,
    replicated,
    shard_client_keys,
    shard_setup,
    validate_cohort_alignment,
)

__all__ = [
    "CLIENT_AXIS",
    "ClientAxis",
    "ClientMesh",
    "client_spec",
    "initialize_multihost",
    "make_mesh",
    "replicated",
    "shard_client_keys",
    "shard_setup",
    "spawn",
    "validate_cohort_alignment",
]
