#!/usr/bin/env python3
"""Which process groups torch lets two ranks form on one card.

Spawns two processes, both on ``cuda:0``, once per backend (``gloo``,
then ``nccl``), each joining one group through a store hosted here
(bound to port 0 and read back); each rank runs an ``all_reduce`` and an
``all_gather`` of CUDA tensors and checks the sums. Then one process
joins a one-rank NCCL group through the port's
``parallel.initialize_multihost`` and runs the same two collectives.
Prints one JSON line per attempt (``ok``, or the error text of the rank
that failed) and the card's name and power limit:

    python3 tools/ranks_on_one_card.py

Needs a card; about a minute.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"


def _collectives(rank, world):
    import torch
    import torch.distributed as dist

    t = torch.full((4,), float(rank + 1), device="cuda:0")
    dist.all_reduce(t)
    parts = [torch.empty(2, device="cuda:0") for _ in range(world)]
    dist.all_gather(parts, torch.full((2,), float(rank), device="cuda:0"))
    torch.cuda.synchronize()
    want = world * (world + 1) / 2
    return (bool((t == want).all())
            and [float(p[0]) for p in parts] == list(range(world)))


def _rank(rank, backend, port, out):
    import torch
    import torch.distributed as dist

    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{HOST}:{port}",
                                world_size=2, rank=rank)
        res = {"ok": _collectives(rank, 2)}
        dist.destroy_process_group()
    except Exception as e:  # the refusal is the measurement
        res = {"ok": False, "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-1500:]}
    with open(f"{out}.{backend}.{rank}", "w") as f:
        json.dump(res, f)


def main() -> None:
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    sys.path.insert(0, REPO)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("gloo", "nccl"):
            store = dist.TCPStore(HOST, 0, is_master=True,
                                  wait_for_workers=False)
            procs = mp.start_processes(
                _rank, args=(backend, store.port, f"{tmp}/r"), nprocs=2,
                join=False, start_method="spawn")
            # a refused group may leave one rank waiting on the other
            for p in procs.processes:
                p.join(60)
                if p.is_alive():
                    p.kill()
            ranks = []
            for r in range(2):
                path = f"{tmp}/r.{backend}.{r}"
                ranks.append(json.load(open(path)) if os.path.exists(path)
                             else {"ok": False, "error": "no result (timed "
                                   "out or died)"})
            print(json.dumps({"two_ranks_one_card": backend,
                              "ok": all(r["ok"] for r in ranks),
                              "ranks": ranks}), flush=True)
    import fedamw_tpu_torch  # noqa: F401  (the repo's alias module)
    from fedamw_tpu_torch.parallel import initialize_multihost, make_mesh

    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False)
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    n = initialize_multihost(f"{HOST}:{store.port}", 1, 0, device="cuda:0")
    mesh = make_mesh(1)
    print(json.dumps({"one_rank_group": dist.get_backend(), "world": n,
                      "mesh": [mesh.size, mesh.rank, str(mesh.device)],
                      "ok": _collectives(0, 1)}), flush=True)
    dist.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
