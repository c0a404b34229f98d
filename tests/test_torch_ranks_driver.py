"""The port's driver over ranks, on CPU processes with gloo.

``--device cpu --shard 2`` spawns two ranks and writes the ``(6, R,
n_repeats)`` pickle within 1e-5 of the single-process driver's;
``--multihost`` with two processes of the same command (as the JAX
package's ``tests/test_multihost.py`` runs its driver) has exactly rank 0
write the pickle and the partial, equal to the single-process pickle
within 1e-5. The rendezvous store is hosted by the test, bound to port 0
and read back, and both ranks connect to it as clients
(``TORCHELASTIC_USE_AGENT_STORE``). ``--shard``/``--multihost`` with
``--sequential`` and a negative ``--shard`` are argparse errors.
The setup is digits in 4 clients (RFF D=64), 2 rounds: 4 divides 2, so
no client is padded and the draws are the single-process run's.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from fedamw_tpu_torch import exp
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--device", "cpu", "--dataset", "digits", "--D", "64",
        "--num_partitions", "4", "--round", "2"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    out = tmp_path_factory.mktemp("solo")
    return _load(exp.main(ARGV + ["--result_dir", str(out)]))


def _assert_same_pickle(got, want):
    assert set(got) == set(want)
    assert got["train_loss"].shape == (6, 2, 1)
    for k in ("train_loss", "test_loss", "test_acc", "heterogeneity"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    for k in ("epochs", "name", "task"):
        assert got[k] == want[k], k


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def test_shard_2_writes_the_single_process_pickle(solo, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "fedamw_tpu_torch.exp", *ARGV, "--shard",
         "2", "--result_dir", str(tmp_path)],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("client axis split over 2 ranks (gloo") == 2
    assert sorted(os.listdir(tmp_path)) == ["exp1_digits.partial.pkl",
                                            "exp1_digits.pkl"]
    _assert_same_pickle(_load(tmp_path / "exp1_digits.pkl"), solo)


def test_multihost_has_rank_0_write_the_pickle(solo, tmp_path):
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    dirs = [tmp_path / f"p{pid}" for pid in range(2)]
    procs = []
    for pid, d in enumerate(dirs):
        d.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fedamw_tpu_torch.exp", *ARGV,
             "--multihost", "--coordinator", f"127.0.0.1:{store.port}",
             "--num_processes", "2", "--process_id", str(pid),
             "--result_dir", str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(TORCHELASTIC_USE_AGENT_STORE="True"), cwd=REPO))
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            pr.kill()
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"process {pid}:\n{out[-3000:]}"
        assert (f"multihost: process {pid}/2, 2 global devices, --shard 2"
                in out)
    assert sorted(os.listdir(dirs[0])) == ["exp1_digits.partial.pkl",
                                           "exp1_digits.pkl"]
    assert os.listdir(dirs[1]) == []
    _assert_same_pickle(_load(dirs[0] / "exp1_digits.pkl"), solo)


@pytest.mark.parametrize("flags,msg", [
    (["--shard", "2", "--sequential"],
     "--shard is incompatible with --sequential"),
    (["--multihost", "--sequential"],
     "--multihost is incompatible with --sequential"),
    (["--shard", "-1"], "--shard must be >= 0"),
])
def test_rank_flags_are_refused_where_jax_refuses_them(flags, msg, capsys):
    with pytest.raises(SystemExit) as err:
        exp.parse_args(ARGV + flags)
    assert err.value.code == 2
    assert msg in capsys.readouterr().err
