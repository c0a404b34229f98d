"""The spawned side of ``tests/test_torch_ranks.py``: the port's runs on
two gloo ranks and on a one-rank group, with no JAX in any process.

    python tests/torch_ranks_child.py JOB OUT

``JOB`` is a pickle that the test writes: ``setups`` (name ->
``convert.setup_from_arrays`` keywords, numpy arrays) and ``cases`` (name
-> ``(setup name, algorithm, keywords, injected draws)``), plus
``one_rank`` (the case names to run on one rank). The script spawns two
ranks (``fedamw_tpu_torch.parallel.spawn``, the CPU, gloo), each of which
runs every case on its share of the setup (``shard_setup(setup,
make_mesh(2))``) and writes ``OUT.rank{r}``: the results (tensors as
numpy arrays) and the mesh's answers under the group (``make_mesh``'s
errors, ``initialize_multihost`` joined twice). Then this process joins
a one-rank group, runs the ``one_rank`` cases ungrouped and on
``make_mesh(1)``, and writes both to ``OUT.one_rank``.
"""

import os
import pickle
import sys

import torch
import torch.distributed as dist

from fedamw_tpu_torch.algorithms import ALGORITHMS
from fedamw_tpu_torch.convert import setup_from_arrays
from fedamw_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    shard_setup,
    spawn,
)

HOST = "127.0.0.1"


def _host(x):
    """Every tensor of a result as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _load(job_path):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    setups = {k: setup_from_arrays(**v, device="cpu")
              for k, v in job["setups"].items()}
    return job, setups


def _run(setups, case, mesh=None):
    setup_name, algo, kwargs, inject = case
    setup = setups[setup_name]
    if mesh is not None:
        setup = shard_setup(setup, mesh)
    return _host(ALGORITHMS[algo](setup, **kwargs, **inject))


def _errors(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def two_ranks(rank, job_path, out):
    job, setups = _load(job_path)
    mesh = make_mesh(2, device="cpu")
    res = {name: _run(setups, case, mesh)
           for name, case in job["cases"].items()}
    mesh_facts = {
        "size": mesh.size, "rank": mesh.rank, "grouped": mesh.grouped,
        "rejoin": initialize_multihost(),
        "more": _errors(lambda: make_mesh(3, device="cpu")),
        "fewer": _errors(lambda: make_mesh(1, device="cpu")),
        "jax_imported": "jax" in sys.modules,
    }
    with open(f"{out}.rank{rank}", "wb") as f:
        pickle.dump({"results": res, "mesh": mesh_facts}, f)


def one_rank(job_path, out):
    """This process as the one rank of a gloo group, through a store it
    hosts on port 0 and joins as a client."""
    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False)
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    initialize_multihost(f"{HOST}:{store.port}", 1, 0, device="cpu")
    try:
        job, setups = _load(job_path)
        mesh = make_mesh(1, device="cpu")
        res = {name: (_run(setups, job["cases"][name]),
                      _run(setups, job["cases"][name], mesh))
               for name in job["one_rank"]}
    finally:
        dist.destroy_process_group()
    with open(f"{out}.one_rank", "wb") as f:
        pickle.dump({"results": res, "grouped": mesh.grouped}, f)


if __name__ == "__main__":
    job_path, out = sys.argv[1:3]
    torch.set_num_threads(1)
    spawn(two_ranks, 2, "cpu", (job_path, out))
    one_rank(job_path, out)
    assert "jax" not in sys.modules
    print("ranks done")
