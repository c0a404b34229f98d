"""The client axis over ranks: ``torch.distributed`` in place of a mesh.

The port of the JAX package's ``parallel/mesh.py``. There, placement plus
``jit`` shards the client axis of the packed index sets over a
``jax.sharding.Mesh`` and lowers the aggregation ``tensordot`` to an
all-reduce. Here the rule is PyTorch's own: one rank per process per
device, in a ``torch.distributed`` process group (NCCL on the card, gloo
on the CPU). Each rank holds a contiguous block of every client axis
(``shard_setup``), runs kernel 1 on its block, and meets the other ranks
in three collectives, all on the compute stream with no host read:

- the mean-family aggregate is the rank's weighted partial sum followed
  by an ``all_reduce`` (``fedcore.aggregate.weighted_average``,
  ``fedcore.hierarchy.two_tier_weighted_average``);
- FedAMW's validation logits and every per-client evidence vector
  (losses, finiteness, delta norms) are all-gathered along the client
  axis, so the p-solve (kernel 2) and every decision run replicated;
- the defenses that need every client's update (reputation's
  coordinate-wise median direction, krum, geomed, the coordinate-wise
  median and trimmed mean) all-gather the stacked updates once a round
  and decide replicated.

What stays whole on every rank: the features, labels and validation and
test sets, the ``(J,)`` vectors (``sizes``, ``p_fixed``, p, the
participation draw, the fault plan's rows), the global weights. Every
random draw is made whole and sliced (``ClientAxis``), so a rank's
clients see the shuffles the single-process run gives them.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

CLIENT_AXIS = "clients"


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device=None, rank: int | None = None) -> torch.device:
    """The device of one rank: ``device`` as given, or on the card
    ``cuda:(LOCAL_RANK, else rank % device_count)``. ``"cpu"`` stays the
    CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    return torch.device("cuda", (rank or 0) % torch.cuda.device_count())


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> int:
    """Join the process group of a multi-rank run and return its world
    size (JAX ``mesh.py:42-71``).

    ``coordinator_address`` (``host:port``) becomes the ``tcp://``
    rendezvous; with all three arguments None they come from the
    environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), as the JAX call takes them from a pod's.
    The backend is NCCL when this rank's device (``_rank_device``) is a
    card, gloo on the CPU. A no-op when a group is already initialized.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    dev = _rank_device(device, int(os.environ.get("RANK", 0))
                      if process_id is None else process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(_backend(dev), init_method=init, **kwargs)
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """The ranks the client axis is split over: ``size`` ranks, this
    process being ``rank`` on ``device``. ``grouped`` is False for the
    one-rank mesh of a process with no process group, whose collectives
    are the identity."""

    size: int
    rank: int
    device: torch.device
    grouped: bool

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        if not self.grouped:
            return t
        out = t.clone()
        dist.all_reduce(out)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if not self.grouped:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim)


def make_mesh(n_devices: int | None = None, device=None) -> ClientMesh:
    """The mesh of this process's group, or of the first ``n_devices``
    ranks of it (JAX ``mesh.py:74-93``, with its two errors). Without a
    group it is one rank, and ``n_devices`` above 1 is refused.
    ``device`` is this rank's (``_rank_device``)."""
    grouped = dist.is_initialized()
    have = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if n_devices is not None:
        if n_devices > have:
            raise ValueError(f"requested {n_devices} devices, have {have}")
        if n_devices < have:
            raise ValueError(
                "truncating the global mesh under multihost would leave "
                "some processes with no addressable devices; use "
                "n_devices=None for the full mesh")
    return ClientMesh(have, rank, _rank_device(device, rank), grouped)


def client_spec(mesh: ClientMesh, num_clients: int) -> slice:
    """This rank's contiguous block of a ``num_clients`` client axis."""
    per = num_clients // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: ClientMesh, num_clients: int) -> slice:
    """The whole axis: what every rank holds of a replicated array."""
    return slice(0, num_clients)


def shard_setup(setup, mesh: ClientMesh):
    """This rank's share of a ``FedSetup`` (JAX ``mesh.py:121-172``): its
    block of the client index pack (or of each size bucket's), every
    other tensor whole, all on the rank's device, with ``mesh_devices``
    and ``mesh`` set.

    Every client axis must divide the rank count evenly; build the setup
    with ``prepare_setup(..., client_multiple=n_devices)`` (or
    ``pad_clients_to``) so inert empty clients make up the difference.
    """
    n_dev = mesh.size

    def check(j, what):
        if j % n_dev != 0:
            raise ValueError(
                f"{what} has {j} clients, not divisible by {n_dev} "
                f"devices; build with prepare_setup(client_multiple="
                f"{n_dev})")

    dev = mesh.device

    def block(a):
        return a[client_spec(mesh, a.shape[0])].to(dev)

    if setup.bucket_idx is not None:
        for g, b in enumerate(setup.bucket_idx):
            check(b.shape[0], f"bucket {g}")
        placed = dict(bucket_idx=tuple(block(b) for b in setup.bucket_idx),
                      bucket_mask=tuple(block(m) for m in setup.bucket_mask))
    else:
        check(setup.idx.shape[0], "the client pack")
        placed = dict(idx=block(setup.idx), mask=block(setup.mask))
    whole = {k: getattr(setup, k).to(dev) for k in (
        "X", "y", "X_test", "y_test", "X_val", "y_val", "sizes", "p_fixed")}
    rff = (None if setup.rff is None
           else tuple(t.to(dev) for t in setup.rff))
    return dataclasses.replace(setup, mesh_devices=n_dev, mesh=mesh, rff=rff,
                               **whole, **placed)


def shard_client_keys(keys, mesh: ClientMesh):
    """This rank's block of a ``(J, ...)`` per-client array: the port
    injects shuffle positions (``(J, epochs, S, B)``), not keys."""
    return keys[client_spec(mesh, keys.shape[0])]


def validate_cohort_alignment(n_shards: int, n_devices: int) -> None:
    """Check that a cohort shard count composes with the ranks (JAX
    ``mesh.py:180-198``): the cohort plane's shards are contiguous and
    ``shard_setup`` gives each rank a contiguous block, so a rank's shard
    partial sums (in-graph) or streamed shards are its own exactly when
    the rank count divides the shard count. A misaligned count is
    refused."""
    if n_devices > 1 and n_shards % n_devices != 0:
        raise ValueError(
            f"cohort_shards={n_shards} does not align with the "
            f"{n_devices}-device client mesh: contiguous shard "
            "boundaries must not straddle devices (each device must "
            "hold a whole number of shards) — use a multiple of "
            f"{n_devices}")


class ClientAxis:
    """A run's view of its setup's client axis: which clients this rank
    holds and how its per-client tensors meet the other ranks'.

    The stacked order is bucket by bucket (one bucket when unbucketed);
    a rank holds its block of each bucket, in that order. ``local``
    takes this rank's entries of a whole ``(J, ...)`` tensor and
    ``gather`` puts every rank's entries back in the whole order;
    ``blocks`` (``(lo, hi, J_g)`` per bucket) tells the client round
    which rows of each whole draw are this rank's. Without a mesh
    (no setup, or ``setup.mesh`` None) both return their argument and
    ``blocks`` is None: the single-process run."""

    def __init__(self, setup=None):
        self.mesh = getattr(setup, "mesh", None)
        self.sharded = self.mesh is not None
        self.blocks = None
        if self.sharded:
            # every bucket's whole client count and this rank's block of it
            self.local_counts = setup.bucket_counts
            self.counts = tuple(c * self.mesh.size for c in self.local_counts)
            self.blocks = tuple(
                (client_spec(self.mesh, j).start,
                 client_spec(self.mesh, j).stop, j) for j in self.counts)

    def local(self, v):
        """This rank's entries of a whole ``(J, ...)`` tensor (None stays
        None)."""
        if not self.sharded or v is None:
            return v
        parts, off = [], 0
        for lo, hi, j in self.blocks:
            parts.append(v[off + lo:off + hi])
            off += j
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def local_positions(self, positions):
        """This rank's block of injected shuffle positions: one
        ``(J_g, ...)`` array per bucket (or a bare array for one)."""
        if not self.sharded:
            return positions
        if isinstance(positions, (list, tuple)):
            return [shard_client_keys(a, self.mesh) for a in positions]
        return shard_client_keys(positions, self.mesh)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every client's entries of this rank's ``x`` along ``dim``, in
        the whole order."""
        if not self.sharded:
            return x
        full = self.mesh.all_gather(x, dim)
        if len(self.counts) == 1:
            return full
        # rank-major chunks of bucket-major blocks -> bucket-major
        chunks = [c.split(self.local_counts, dim)
                  for c in full.split(sum(self.local_counts), dim)]
        return torch.cat([chunks[r][g] for g in range(len(self.counts))
                          for r in range(self.mesh.size)], dim)

    def gather_vectors(self, *vs):
        """Several ``(J_local,)`` vectors gathered in one collective."""
        if not self.sharded:
            return vs
        return tuple(self.gather(torch.stack(vs), dim=1).unbind(0))

    def gather_tree(self, tree: dict) -> dict:
        return {k: self.gather(v) for k, v in tree.items()}
