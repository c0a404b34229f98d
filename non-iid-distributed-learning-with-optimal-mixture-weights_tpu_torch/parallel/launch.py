"""Local ranks for ``--shard N``: one spawned process per rank.

``spawn(fn, nprocs, device, args)`` starts ``nprocs`` processes
(``torch.multiprocessing``, the ``spawn`` start method), each of which
joins one process group through ``mesh.initialize_multihost`` and calls
``fn(rank, *args)``. The rendezvous store is hosted here, bound to port
0 and read back, and the ranks connect to it as clients
(``TORCHELASTIC_USE_AGENT_STORE``), so no port is guessed. Rank ``r``
runs on ``cuda:r`` (NCCL) or, with ``device="cpu"``, on the CPU (gloo)
with one intra-op thread. Imports no JAX: the tests spawn through it too.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import initialize_multihost

HOST = "127.0.0.1"


def _entry(rank, fn, world, port, device, args):
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank)
    initialize_multihost(f"{HOST}:{port}", world, rank, device=dev)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, device="cpu", args=()) -> None:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks of one process group
    and wait for all of them; a failing rank raises here. ``fn`` and
    ``args`` must be picklable (a module-level function)."""
    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False)
    mp.start_processes(_entry, args=(fn, nprocs, store.port, str(device),
                                     tuple(args)),
                       nprocs=nprocs, join=True, start_method="spawn")
