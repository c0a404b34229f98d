"""The port's experiment driver (``fedamw_tpu_torch.exp``) on the CPU.

sklearn ``digits``, RFF D=64, J=4 clients, R=2 rounds of 1 local epoch,
one repeat, ``--device cpu``: the pickle has exactly the schema of the
repository's ``exp.py`` and the JAX package's reader takes it, its rows
are the port's algorithms called directly with the driver's arguments,
the extension flags the port carries reach the algorithms the JAX
driver sends them to (``--model`` trains the zoo on raw features,
``--resume`` continues a partial run bit for bit, ``--save_models``
writes checkpoints the JAX package reads), every flag it does not carry
is refused with its ROADMAP.md item, and without a card the driver
raises instead of running on the CPU.
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
        exp.parse_args(["--publish_every", "--round", "3"])
    assert "item 11" in capsys.readouterr().err


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


# -- the extension flags the port carries ------------------------------------


@pytest.mark.parametrize("flag,value,attr,want", [
    ("--sequential", None, "sequential", True),
    ("--participation", "0.5", "participation", 0.5),
    ("--server_opt", "yogi", "server_opt", "yogi"),
    ("--server_lr", "0.25", "server_lr", 0.25),
    ("--p_guard", "clip:2", "p_guard", "clip:2"),
    ("--save_models", "ckpts", "save_models", "ckpts"),
    ("--resume", None, "resume", True),
    ("--feature_dtype", "bfloat16", "feature_dtype", "bfloat16"),
    ("--feature_dtype", "float16", "feature_dtype", "float16"),
    ("--trace_dir", "tr", "trace_dir", "tr"),
    ("--profile", "prof", "profile", "prof"),
    ("--shard", "2", "shard", 2),
    ("--multihost", None, "multihost", True),
    ("--coordinator", "127.0.0.1:29500", "coordinator", "127.0.0.1:29500"),
    ("--num_processes", "2", "num_processes", 2),
    ("--process_id", "1", "process_id", 1),
    ("--model", "mlp16", "model", "mlp16"),
    ("--model", "conv4x8", "model", "conv4x8")])
def test_ported_flags_parse(flag, value, attr, want):
    args = exp.parse_args(ARGV + [flag] + ([value] if value else []))
    assert getattr(args, attr) == want
    assert flag not in exp._REFUSED


def test_observability_flags_stay_out_of_the_resume_signature():
    """Neither --trace_dir nor --profile shapes a trajectory, so a traced
    run resumes an untraced partial and the reverse."""
    plain = exp.resume_config(exp.parse_args(ARGV))
    traced = exp.resume_config(exp.parse_args(
        ARGV + ["--trace_dir", "tr", "--profile", "prof"]))
    assert traced == plain
    assert not {"trace_dir", "profile"} & set(plain)


@pytest.mark.parametrize("argv,msg", [
    (["--p_guard", "auto"], "expected 'none'"),
    (["--p_guard", "clip:0"], "clip radius"),
    (["--server_opt", "rmsprop"], "invalid choice"),
    (["--feature_dtype", "int8"], "invalid choice"),
    (["--model", "resnet"], "unknown model: resnet"),
    (["--model", "mlpx"], "invalid literal")])
def test_bad_extension_values_are_argparse_errors(argv, msg, capsys):
    with pytest.raises(SystemExit) as err:
        exp.parse_args(ARGV + argv)
    assert err.value.code == 2 and msg in capsys.readouterr().err


def _run(tmp, *extra):
    path = exp.main(ARGV + ["--result_dir", str(tmp), *extra])
    return load_results(path)


def test_extensions_reach_the_algorithms_as_the_jax_driver_sends_them(
        tmp_path):
    """``--sequential`` to all but Centralized, ``--participation`` to
    FedAvg, FedProx and FedAMW, ``--server_opt`` to FedAvg and FedProx,
    ``--p_guard`` to FedAMW and FedAMW_OneShot."""
    flags = ["--sequential", "--server_opt", "adam", "--server_lr", "0.1",
             "--p_guard", "simplex"]
    data = _run(tmp_path, *flags)
    prm = get_parameter("digits")
    rng = np.random.RandomState(SEED)
    ds = load_dataset("digits", 4, 0.01, rng=rng)
    setup = prepare_setup(ds, D=64, kernel_par=prm["kernel_par"],
                          seed=SEED, rng=rng, device="cpu")
    runs = exp.run_paper_algorithms(
        setup, rounds=R, local_epoch=1, batch_size=32, seed=SEED,
        lr=prm["lr"], lr_p=prm["lr_p"], lr_p_os=prm["lr_p_os"],
        mu=prm["lambda_prox"], lam=prm["lambda_reg"],
        lam_os=prm["lambda_reg_os"], sequential=True, server_opt="adam",
        server_lr=0.1, p_guard="simplex")
    for row, (name, res, _) in enumerate(runs):
        np.testing.assert_array_equal(
            data["test_loss"][row, :, 0],
            np.broadcast_to(np.float64(res["test_loss"]), (R,)), err_msg=name)
    plain = _run(tmp_path / "plain")
    # Centralized takes none of them; every other row moved
    np.testing.assert_array_equal(plain["test_loss"][0], data["test_loss"][0])
    for row in range(1, 6):
        assert not np.array_equal(plain["test_loss"][row],
                                  data["test_loss"][row]), row


def test_resume_extends_the_repeats_bitwise(tmp_path):
    """A first run of one repeat, then ``--resume`` with two: the pickle
    is the uninterrupted two-repeat run's, bit for bit, and the finished
    repeat is not run again."""
    full = _run(tmp_path / "full", "--participation", "0.7",
                "--n_repeats", "2")
    _run(tmp_path / "split", "--participation", "0.7")
    partial = tmp_path / "split" / "exp1_digits.partial.pkl"
    with open(partial, "rb") as f:
        part = pickle.load(f)
    assert part["done"] == 1 and part["config"]["participation"] == 0.7
    resumed = _run(tmp_path / "split", "--participation", "0.7",
                   "--n_repeats", "2", "--resume")
    for k in ("train_loss", "test_loss", "test_acc", "heterogeneity"):
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


def test_resume_refuses_a_partial_of_another_configuration(tmp_path,
                                                            capsys):
    _run(tmp_path)
    with pytest.raises(SystemExit) as err:
        _run(tmp_path, "--resume", "--sequential", "--n_repeats", "2")
    assert err.value.code == 2
    assert "different configuration" in capsys.readouterr().err


def test_fresh_run_sets_an_earlier_partial_aside(tmp_path):
    _run(tmp_path)
    _run(tmp_path)
    _run(tmp_path)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["exp1_digits.partial.pkl", "exp1_digits.partial.pkl.bak",
                     "exp1_digits.partial.pkl.bak2", "exp1_digits.pkl"]


def test_save_models_writes_checkpoints_the_jax_package_reads(tmp_path):
    from fedamw_tpu.utils.checkpoint import load_checkpoint

    _run(tmp_path / "res", "--save_models", str(tmp_path / "ck"),
         "--server_opt", "sgd")
    saved = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert saved == [f"digits_{n}_repeat0" for n in
                     ("FedAMW", "FedAvg", "FedProx")]
    amw = load_checkpoint(str(tmp_path / "ck" / "digits_FedAMW_repeat0"))
    assert amw["round"] == R and amw["params"]["w"].shape == (10, 64)
    assert len(amw["p_opt"]) == 1 and amw["rff_W"].shape[1] == 64
    avg = load_checkpoint(str(tmp_path / "ck" / "digits_FedAvg_repeat0"))
    assert avg["server_opt_kind"] == "sgd" and avg["server_opt"] == ()
    data = load_results(str(tmp_path / "res" / "exp1_digits.pkl"))
    assert avg["eval_acc"] == pytest.approx(data["test_acc"][3, -1, 0])


# -- --model: the zoo through the driver -------------------------------------


@pytest.mark.parametrize("model", ["mlp16", "conv4x8"])
def test_zoo_driver_writes_the_schema_and_the_algorithms_rows(
        model, tmp_path, capsys):
    """``--model`` on digits at R=2: the pickle has ``exp.py``'s keys and
    ``(6, R, 1)`` metric arrays (the JAX driver's layout for the same
    flags), finite; the forced ``kernel_type`` is printed as the JAX
    driver prints it; the setup is the model's on raw features, and for
    the MLP each row is the port's algorithm called directly on it, bit
    for bit (the conv goes through the same code; rerunning it doubles
    the file's slowest case under the suite's six workers)."""
    data = _run(tmp_path, "--model", model)
    out = capsys.readouterr().out
    assert (f"--model {model}: forcing kernel_type='linear' (identity "
            "features; the registry's RFF map serves the linear "
            "flagship)") in out
    assert set(data) == KEYS and data["epochs"] == R
    for k in ("train_loss", "test_loss", "test_acc"):
        assert data[k].shape == (6, R, 1)
        assert np.all(np.isfinite(data[k]))
    prm = get_parameter("digits")
    assert prm["kernel_type"] != "linear"
    rng = np.random.RandomState(SEED)
    ds = load_dataset("digits", 4, 0.01, rng=rng)
    setup = prepare_setup(ds, D=64, kernel_par=prm["kernel_par"],
                          kernel_type="linear", model=model, seed=SEED,
                          rng=rng, device="cpu")
    assert setup.model.name == model and setup.D == ds.d
    if model != "mlp16":
        return
    runs = exp.run_paper_algorithms(
        setup, rounds=R, local_epoch=1, batch_size=32, seed=SEED,
        lr=prm["lr"], lr_p=prm["lr_p"], lr_p_os=prm["lr_p_os"],
        mu=prm["lambda_prox"], lam=prm["lambda_reg"],
        lam_os=prm["lambda_reg_os"])
    for row, (name, res, _) in enumerate(runs):
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_array_equal(
                data[k][row, :, 0], np.broadcast_to(np.float64(res[k]), (R,)),
                err_msg=f"{name} {k}")


def test_the_linear_model_prints_no_forcing(tmp_path, capsys):
    _run(tmp_path, "--model", "linear", "--round", "1")
    assert "forcing kernel_type" not in capsys.readouterr().out


def test_model_signs_the_partial_and_a_changed_model_is_refused(tmp_path,
                                                                  capsys):
    assert exp.resume_config(exp.parse_args(ARGV))["model"] == "linear"
    _run(tmp_path, "--model", "mlp16", "--round", "1")
    with open(tmp_path / "exp1_digits.partial.pkl", "rb") as f:
        assert pickle.load(f)["config"]["model"] == "mlp16"
    with pytest.raises(SystemExit) as err:
        _run(tmp_path, "--model", "conv4x8", "--round", "1", "--resume",
             "--n_repeats", "2")
    assert err.value.code == 2
    assert "different configuration" in capsys.readouterr().err


def test_a_partial_without_a_model_resumes_as_linear(tmp_path, capsys):
    """A partial signed before ``--model`` was carried is a linear run
    (the JAX driver's legacy default)."""
    _run(tmp_path, "--round", "1")
    ppath = tmp_path / "exp1_digits.partial.pkl"
    with open(ppath, "rb") as f:
        part = pickle.load(f)
    del part["config"]["model"]
    with open(ppath, "wb") as f:
        pickle.dump(part, f)
    _run(tmp_path, "--round", "1", "--resume")
    assert "1 completed repeat(s) loaded" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        _run(tmp_path, "--round", "1", "--resume", "--model", "mlp16")


@pytest.mark.cuda
def test_p_guard_runs_on_the_card(tmp_path):
    """``--p_guard simplex`` with ``--device cuda`` runs: kernel 2 applies
    the guard in its epilogue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fedamw_tpu_torch.fedcore import p_epoch

    # the mnist-shaped stand-in: the card's machine has no sklearn digits
    argv = ["--device", "cuda", "--dataset", "mnist", "--D", "64",
            "--num_partitions", "8", "--round", "2", "--local_epoch", "1",
            "--seed", str(SEED)]
    before = dict(p_epoch.launches_by_kernel)
    path = exp.main(argv + ["--p_guard", "simplex",
                            "--result_dir", str(tmp_path)])
    data = load_results(path)
    assert np.all(np.isfinite(data["test_acc"]))
    assert p_epoch.launches_by_kernel["staged"] > before["staged"]
