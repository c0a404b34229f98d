"""The port's experiment driver (``fedamw_tpu_torch.exp``) on the CPU.

sklearn ``digits``, RFF D=64, J=4 clients, R=2 rounds of 1 local epoch,
one repeat, ``--device cpu``: the pickle has exactly the schema of the
repository's ``exp.py`` and the JAX package's reader takes it, its rows
are the port's algorithms called directly with the driver's arguments,
every JAX-only extension flag is refused with its ROADMAP.md item, and
without a card the driver raises instead of running on the CPU.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fedamw_tpu.utils.reporting import load_results
from fedamw_tpu_torch import exp
from fedamw_tpu_torch.algorithms import ALGORITHMS, prepare_setup
from fedamw_tpu_torch.config import get_parameter
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.ops.rff import heterogeneity_from_parts

REPO = Path(__file__).resolve().parent.parent
R, SEED = 2, 100
ARGV = ["--device", "cpu", "--dataset", "digits", "--D", "64",
        "--num_partitions", "4", "--round", str(R), "--local_epoch", "1",
        "--n_repeats", "1", "--seed", str(SEED)]
# exp.py's result keys (exp.py:476-493)
KEYS = {"epochs", "train_loss", "test_loss", "test_acc", "heterogeneity",
        "name", "task"}


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("res")
    path = exp.main(ARGV + ["--result_dir", str(out)])
    return Path(path)


def test_driver_writes_the_reference_schema(result):
    assert result.name == "exp1_digits.pkl"
    with open(result, "rb") as f:
        data = pickle.load(f)
    assert set(data) == KEYS
    assert data["epochs"] == R
    assert data["name"] == ["CL", "DL", "FedAMW_OneShot", "FedAvg", "FedProx",
                            "FedAMW"]
    assert data["task"] == "classification"
    for k in ("train_loss", "test_loss", "test_acc"):
        assert data[k].shape == (6, R, 1)
        assert np.all(np.isfinite(data[k]))
    assert data["heterogeneity"].shape == (1,)
    assert data["heterogeneity"][0] > 0
    assert load_results(str(result)).keys() == data.keys()


def test_driver_rows_are_the_algorithms_called_directly(result):
    """The same repeat rebuilt by hand: the rows are bitwise the port's
    algorithms with the driver's arguments, and the score is the
    heterogeneity of the full partitions."""
    data = load_results(str(result))
    prm = get_parameter("digits")
    rng = np.random.RandomState(SEED)
    ds = load_dataset("digits", 4, 0.01, rng=rng)
    setup = prepare_setup(ds, D=64, kernel_par=prm["kernel_par"],
                          seed=SEED, rng=rng, device="cpu")
    assert data["heterogeneity"][0] == heterogeneity_from_parts(setup.X,
                                                                ds.parts)
    common = dict(lr=prm["lr"], batch_size=32, seed=SEED)
    rnd = dict(common, epoch=1, round=R)
    direct = [
        ALGORITHMS["Centralized"](setup, epoch=R, **common),
        ALGORITHMS["Distributed"](setup, epoch=R, **common),
        ALGORITHMS["FedAMW_OneShot"](setup, epoch=R, round=R,
                                     lambda_reg=prm["lambda_reg_os"],
                                     lr_p=prm["lr_p_os"], **common),
        ALGORITHMS["FedAvg"](setup, **rnd),
        ALGORITHMS["FedProx"](setup, mu=prm["lambda_prox"], **rnd),
        ALGORITHMS["FedAMW"](setup, lambda_reg=prm["lambda_reg"],
                             lr_p=prm["lr_p"], **rnd),
    ]
    for row, res in enumerate(direct):
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_array_equal(
                data[k][row, :, 0],
                np.broadcast_to(np.float64(res[k]), (R,)),
                err_msg=f"{data['name'][row]} {k}")


@pytest.mark.parametrize("flag", sorted(exp._REFUSED))
def test_extension_flags_are_refused_with_their_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit) as err:
        exp.parse_args(ARGV + [flag, "1"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert flag in msg and "ROADMAP.md" in msg
    assert exp._REFUSED[flag] in msg


def test_refused_flag_without_a_value(capsys):
    with pytest.raises(SystemExit):
        exp.parse_args(["--multihost", "--round", "3"])
    assert "item 10" in capsys.readouterr().err


def test_driver_refuses_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in ARGV if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exp.main(argv + ["--result_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_task_type_follows_the_regression_name_list():
    assert exp._task_type("cadata", get_parameter("cadata")) == "regression"
    assert exp._task_type("digits", get_parameter("digits")) == (
        "classification")


def test_module_entry_point_from_the_repo_root(tmp_path):
    """``python -m fedamw_tpu_torch.exp`` resolves through the alias
    module."""
    res = subprocess.run(
        [sys.executable, "-m", "fedamw_tpu_torch.exp", *ARGV, "--round", "1",
         "--result_dir", str(tmp_path)],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "results ->" in res.stdout
    assert load_results(str(tmp_path / "exp1_digits.pkl"))["epochs"] == 1
