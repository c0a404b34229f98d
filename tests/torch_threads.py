"""One intra-op thread for the port's tests.

The tier-1 suite runs in several pytest-xdist workers at once on one
host. PyTorch's CPU operators default to one OpenMP thread per core in
every worker, and the idle OpenMP threads spin between the port's many
small operators, so the workers take each other's cores: a test file ran
several times slower in a loaded suite than alone. Each port test module
imports ``one_torch_thread``; while its tests run, PyTorch (and any
process they spawn, through ``OMP_NUM_THREADS``) uses one thread, and the
previous settings come back after the module. What each test computes
and checks is unchanged.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev_threads = torch.get_num_threads()
    prev_env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        if prev_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev_env
