"""The port's tuning loop (``fedamw_tpu_torch.tune`` and ``.sweep``)
against the repository's ``tune.py`` and ``sweep.py``.

- **Flags**: with the same ``sys.argv`` the two trials' and the two
  sweeps' parsers give the same values on every flag but ``backend``
  and ``device`` (and the sweep's default ``--out``, which must not be
  the committed ``TUNING.md``).
- **The trial's calls**: each package's ``load_dataset`` and
  ``get_backend`` replaced by one recording stub; the two ``tune.main``
  make the same calls with the same keyword values (the port adds
  ``device=``), print the same line and fill ``metrics_out`` the same,
  on a classification and a regression dataset.
- **NNI**: a stub ``nni`` module; each trial's ``__main__`` flow merges
  the tuner's parameters and reports the same value.
- **A real trial** on the CPU (digits, D = 64, 2 rounds) is bitwise
  ``FedAMW`` called directly with the trial's arguments, on both
  backends; without a card it raises unless told the CPU.
- **The sweep**: with each package's ``tune.main`` stubbed, the two
  sweeps draw the same picks in the same order, rank them the same and
  write the same report but for its header's command and the reference
  grid's source line; the grids
  are ``config.yml``'s search space, and the port's NNI config runs the
  port's trial on one card.
"""

import importlib.util
import math
import os
import runpy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import fedamw_tpu.data as jdata
import fedamw_tpu.registry as jregistry
import sweep as jsweep
import tune as jtune
import fedamw_tpu_torch.registry as tregistry
from fedamw_tpu_torch import sweep, tune
from fedamw_tpu_torch.backends import torch_ref
from fedamw_tpu_torch.config import get_parameter
from fedamw_tpu_torch.data import load_dataset
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "non-iid-distributed-learning-with-optimal-mixture-weights_tpu_torch"

ARGVS = (
    [],
    ["--dataset", "digits", "--D", "64", "--round", "3", "--lr_p", "0.001",
     "--lambda_reg", "5e-6", "--seed", "4", "--local_epoch", "1"],
    ["--kernel_par", "0.3", "--alpha", "0.2", "--beta", "0.1", "--lr", "0.1",
     "--data_dir", "elsewhere", "--lr_p_os", "0.2", "--lambda_reg_os",
     "0.01", "--lambda_prox", "0.5", "--not_a_flag", "7"],
)


# -- flags -------------------------------------------------------------------

@pytest.mark.parametrize("argv", ARGVS, ids=("defaults", "trial", "rest"))
def test_trial_flags_are_the_jax_trial_flags(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tune", *argv])
    want = vars(jtune.get_params())
    got = vars(tune.get_params())
    assert set(got) == set(want) | {"device"}
    assert {k: v for k, v in got.items() if k not in ("backend", "device")} \
        == {k: v for k, v in want.items() if k != "backend"}
    assert {k: type(v) for k, v in got.items() if k in want} \
        == {k: type(v) for k, v in want.items()}
    assert got["backend"] == "port" and got["device"] is None


def test_trial_backend_and_device_flags(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tune", "--backend", "torch",
                                      "--device", "cpu"])
    got = vars(tune.get_params())
    assert (got["backend"], got["device"]) == ("torch", "cpu")
    monkeypatch.setattr(sys, "argv", ["tune", "--backend", "jax"])
    with pytest.raises(SystemExit):
        tune.get_params()


def _jax_sweep_args(argv, monkeypatch):
    """The root sweep's parsed flags, read from what its ``main`` hands
    ``run_sweep`` and ``write_report``."""
    seen = {}

    def run_sweep(dataset, trials, rounds, seed, backend, trial_seed):
        seen.update(dataset=dataset, trials=trials, round=rounds, seed=seed,
                    backend=backend, trial_seed=trial_seed)
        return []

    def write_report(results, dataset, rounds, seed, out, trial_seed):
        seen.update(out=out)

    monkeypatch.setattr(jsweep, "run_sweep", run_sweep)
    monkeypatch.setattr(jsweep, "write_report", write_report)
    monkeypatch.setattr(sys, "argv", ["sweep.py", *argv])
    jsweep.main()
    return seen


@pytest.mark.parametrize("argv", (
    ["--out", "T.md"],
    ["--dataset", "mnist", "--trials", "4", "--round", "10", "--seed", "3",
     "--trial_seed", "2", "--out", "x/T.md"],
), ids=("defaults", "all"))
def test_sweep_flags_are_the_jax_sweep_flags(argv, monkeypatch):
    want = _jax_sweep_args(argv, monkeypatch)
    got = vars(sweep.parse_args(argv))
    assert set(got) == set(want) | {"device"}
    assert {k: v for k, v in got.items() if k not in ("backend", "device")} \
        == {k: v for k, v in want.items() if k != "backend"}
    assert got["backend"] == "port" and got["device"] is None


def test_sweep_default_report_is_not_the_committed_one(monkeypatch):
    want = _jax_sweep_args([], monkeypatch)
    got = sweep.parse_args([])
    assert want["out"] == "TUNING.md"
    assert got.out == "TUNING_torch.md" and not os.path.isabs(got.out)
    assert sweep.parse_args(["--backend", "torch", "--device", "cpu"]) \
        .backend == "torch"
    with pytest.raises(SystemExit):
        sweep.parse_args(["--backend", "jax"])


# -- the trial's calls ---------------------------------------------------------

class Recorder:
    """Stands for ``load_dataset`` and for a backend: records every call
    with its arguments and returns fixed results."""

    def __init__(self, acc, loss, rounds=3):
        self.calls, self.rngs = [], []
        self.acc, self.loss, self.rounds = acc, loss, rounds
        self.ALGORITHMS = {"FedAMW": self.fedamw}

    def _norm(self, kw):
        out = dict(kw)
        if isinstance(out.get("rng"), np.random.RandomState):
            self.rngs.append(out["rng"])
            state = out["rng"].get_state()
            out["rng"] = ("RandomState", tuple(state[1][:4]), state[2])
        return out

    def load_dataset(self, *args, **kw):
        self.calls.append(("load_dataset", args, self._norm(kw)))
        return "dataset"

    def get_backend(self, name):
        self.calls.append(("get_backend", (name,), {}))
        return self

    def prepare_setup(self, ds, **kw):
        self.calls.append(("prepare_setup", (ds,), self._norm(kw)))
        return "setup"

    def fedamw(self, setup, **kw):
        self.calls.append(("FedAMW", (setup,), dict(kw)))
        ramp = np.linspace(0.5, 1.0, self.rounds)
        return {"test_acc": self.acc * ramp, "test_loss": self.loss / ramp,
                "train_loss": self.loss / ramp}


def _patch_jax(monkeypatch, rec):
    monkeypatch.setattr(jdata, "load_dataset", rec.load_dataset)
    monkeypatch.setattr(jregistry, "get_backend", rec.get_backend)


def _patch_port(monkeypatch, rec, module=tune):
    monkeypatch.setattr(module, "load_dataset", rec.load_dataset)
    monkeypatch.setattr(module, "get_backend", rec.get_backend)


def _params(dataset, backend, device="cpu"):
    return dict(seed=3, dataset=dataset, backend=backend, alpha=0.0,
                beta=0.0, D=48, kernel_par=0.1, lambda_reg_os=1e-6,
                lambda_reg=5e-4, lambda_prox=0.01, data_dir="datasets",
                lr=0.5, lr_p=2e-3, lr_p_os=0.1, local_epoch=1, round=3,
                device=device)


def _port_calls(calls, device):
    """The port's calls with its additions taken out: the backend's name
    and prepare_setup's ``device``."""
    out = []
    for name, args, kw in calls:
        if name == "prepare_setup":
            assert kw.pop("device") == device
        out.append((name, args, kw))
    return out


@pytest.mark.parametrize("dataset,acc,loss", (
    ("digits", 71.25, 0.83125), ("synthetic_nonlinear", 0.0, 0.0421875),
    ("synthetic_nonlinear", 0.0, float("nan"))),
    ids=("classification", "regression", "regression-diverged"))
@pytest.mark.parametrize("backends", (("jax", "port"), ("torch", "torch")),
                         ids=("kernel-path", "torch-ref"))
def test_trial_makes_the_jax_trial_calls(dataset, acc, loss, backends,
                                         monkeypatch, capsys):
    jrec, trec = Recorder(acc, loss), Recorder(acc, loss)
    _patch_jax(monkeypatch, jrec)
    _patch_port(monkeypatch, trec)
    jm, tm = {}, {}
    jacc = jtune.main(_params(dataset, backends[0]), metrics_out=jm)
    jout = capsys.readouterr().out
    tacc = tune.main(_params(dataset, backends[1]), metrics_out=tm)
    tout = capsys.readouterr().out
    assert jout == tout and tout.startswith("FedAMW final: loss=")
    assert jacc == tacc and set(jm) == set(tm) == {"acc", "loss"}
    assert jm["acc"] == tm["acc"]
    assert jm["loss"] == tm["loss"] or (math.isnan(jm["loss"])
                                        and math.isnan(tm["loss"]))
    want = [(n, (backends[1],) if n == "get_backend" else a, kw)
            for n, a, kw in jrec.calls]
    assert _port_calls(trec.calls, "cpu") == want
    assert [c[0] for c in want] == ["load_dataset", "get_backend",
                                    "prepare_setup", "FedAMW"]
    # one RandomState drives the load and the setup, in both packages
    for rec in (jrec, trec):
        assert len(rec.rngs) == 2 and rec.rngs[0] is rec.rngs[1]
    prm = get_parameter(dataset)
    assert want[2][2]["kernel_type"] == prm["kernel_type"]
    assert want[3][2]["lr"] == prm["lr"]


# -- NNI -----------------------------------------------------------------------

def _nni_stub(reported, proposed):
    nni = types.ModuleType("nni")
    utils = types.ModuleType("nni.utils")
    nni.get_next_parameter = lambda: dict(proposed)
    nni.report_final_result = reported.append

    def merge_parameter(base, override):
        for k, v in override.items():
            setattr(base, k, type(getattr(base, k))(v))
        return base

    utils.merge_parameter = merge_parameter
    nni.utils = utils
    return nni, utils


def _load_fresh(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nni_trial_reports_what_the_jax_trial_reports(monkeypatch, capsys):
    reported = {"jax": [], "port": []}
    proposed = {"lr_p": 0.0005, "lambda_reg": 1e-05}
    for pkg in reported:
        nni, utils = _nni_stub(reported[pkg], proposed)
        monkeypatch.setitem(sys.modules, "nni", nni)
        monkeypatch.setitem(sys.modules, "nni.utils", utils)
        rec = Recorder(64.5, 1.25)
        monkeypatch.setattr(sys, "argv", ["tune", "--dataset", "digits",
                                          "--round", "3", "--device", "cpu"])
        if pkg == "jax":
            _patch_jax(monkeypatch, rec)
            mod = _load_fresh("_tune_under_nni", REPO / "tune.py")
        else:
            mod = _load_fresh("fedamw_tpu_torch._tune_under_nni",
                              PKG / "tune.py")
            _patch_port(monkeypatch, rec, mod)
        assert mod.HAS_NNI
        # the module's __main__ flow: the tuner's proposal over the flags
        if pkg == "jax":
            runpy.run_path(str(REPO / "tune.py"), run_name="__main__")
        else:
            mod.cli()
        fed = [kw for n, _, kw in rec.calls if n == "FedAMW"][0]
        assert (fed["lr_p"], fed["lambda_reg"]) == (0.0005, 1e-05)
        assert mod.main(vars(mod.get_params())) == 64.5
    capsys.readouterr()
    assert reported["jax"] == reported["port"] == [64.5, 64.5]


# -- a real trial --------------------------------------------------------------

TRIAL = dict(_params("digits", "port"), D=64, round=2, seed=1,
             lr_p=5e-6, lambda_reg=5e-4, local_epoch=2)


def _direct(backend_mod, p, device="cpu"):
    """FedAMW called directly on a setup built by hand with the trial's
    arguments."""
    prm = get_parameter(p["dataset"])
    rng = np.random.RandomState(p["seed"])
    ds = load_dataset(p["dataset"], 50, 0.01, data_dir=p["data_dir"],
                      rng=rng)
    setup = backend_mod.prepare_setup(
        ds, D=p["D"], kernel_par=prm["kernel_par"],
        kernel_type=prm["kernel_type"], seed=p["seed"], rng=rng,
        device=device)
    return backend_mod.ALGORITHMS["FedAMW"](
        setup, lr=prm["lr"], epoch=p["local_epoch"], batch_size=32,
        lambda_reg_if=True, lambda_reg=p["lambda_reg"], round=p["round"],
        lr_p=p["lr_p"], seed=p["seed"])


@pytest.mark.parametrize("backend", ("port", "torch"))
def test_real_trial_is_fedamw_called_directly(backend, capsys):
    m = {}
    acc = tune.main(dict(TRIAL, backend=backend), metrics_out=m)
    res = _direct(tregistry.get_backend(backend), TRIAL)
    assert math.isfinite(m["acc"]) and math.isfinite(m["loss"])
    assert acc == m["acc"] == float(res["test_acc"][-1])
    assert m["loss"] == float(res["test_loss"][-1])
    assert capsys.readouterr().out == (
        f"FedAMW final: loss={m['loss']:.5f} acc={m['acc']:.5f}\n")


def test_real_trial_backends_are_the_two_registry_paths(monkeypatch):
    used = []
    for name, mod in (("port", tregistry.get_backend("port")),
                      ("torch", torch_ref)):
        real = mod.ALGORITHMS["FedAMW"]

        def spy(setup, _real=real, _name=name, **kw):
            used.append(_name)
            return _real(setup, **kw)

        monkeypatch.setitem(mod.ALGORITHMS, "FedAMW", spy)
    tune.main(dict(TRIAL, backend="torch", round=1))
    tune.main(dict(TRIAL, backend="port", round=1))
    assert used == ["torch", "port"]


def test_trial_without_a_card_raises_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded = []
    monkeypatch.setattr(tune, "load_dataset",
                        lambda *a, **k: loaded.append(a))
    for backend in ("port", "torch"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tune.main(dict(TRIAL, backend=backend, device=None))
    # refused before any data is loaded
    assert loaded == []


@pytest.mark.cuda
def test_trial_on_the_card_is_fedamw_called_directly():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # satimage is a synthetic stand-in: the card's machine has no sklearn
    p = dict(TRIAL, dataset="satimage", D=256, round=3, lr_p=1e-5,
             lambda_reg=1e-3, device=None)
    m = {}
    tune.main(p, metrics_out=m)
    res = _direct(tregistry.get_backend("port"), p, device=None)
    assert m["acc"] == float(res["test_acc"][-1])
    assert m["loss"] == float(res["test_loss"][-1])


# -- the sweep ---------------------------------------------------------------

def _fake_metrics(dataset, lr_p, lam):
    """A deterministic trial outcome of the pick, with ties and, on the
    regression task, diverged trials."""
    k = int(round(-math.log10(lr_p))) + 2 * int(round(-math.log10(lam)))
    if get_parameter(dataset).get("task_type") == "regression":
        loss = (float("nan"), float("inf"), 0.5 + (k % 5) / 8)[k % 3]
        return 0.0, loss
    return 40.0 + (k % 4) * 5.0, 2.0 - (k % 4) / 4


def _stub_trials(monkeypatch, module, log):
    def main(params, metrics_out=None):
        log.append({k: params[k] for k in ("dataset", "lr_p", "lambda_reg",
                                           "round", "seed", "backend")})
        acc, loss = _fake_metrics(params["dataset"], params["lr_p"],
                                  params["lambda_reg"])
        metrics_out.update(acc=acc, loss=loss)
        return acc

    monkeypatch.setattr(module, "main", main)


def _ranked(results):
    return [(r["lr_p"], r["lambda_reg"], r["acc"], repr(r["loss"]))
            for r in results]


@pytest.mark.parametrize("dataset,trials,seed", (
    ("digits", 12, 7), ("digits", 121, 0), ("synthetic_nonlinear", 16, 3)),
    ids=("classification", "whole-grid", "regression"))
def test_sweeps_pick_rank_and_report_alike(dataset, trials, seed,
                                           monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(sys, "argv", ["sweep"])
    jlog, tlog = [], []
    _stub_trials(monkeypatch, jtune, jlog)
    _stub_trials(monkeypatch, tune, tlog)
    jres = jsweep.run_sweep(dataset, trials, 5, seed, trial_seed=2)
    tres = sweep.run_sweep(dataset, trials, 5, seed, trial_seed=2,
                           device="cpu")
    capsys.readouterr()
    assert len(jlog) == min(trials, 121)
    assert [{**e, "backend": None} for e in jlog] \
        == [{**e, "backend": None} for e in tlog]
    assert {e["seed"] for e in tlog} == {2} and {e["round"] for e in tlog} \
        == {5}
    assert {e["backend"] for e in tlog} == {"port"}
    assert _ranked(jres) == _ranked(tres)
    if dataset == "synthetic_nonlinear":
        finite = [math.isfinite(r["loss"]) for r in tres]
        assert finite == sorted(finite, reverse=True) and not all(finite)
    else:
        assert [r["acc"] for r in tres] == sorted(
            (r["acc"] for r in tres), reverse=True)
    # the same table: every line equal but the header's command and the
    # grid's source, which the port cites without a local path
    for r in tres:
        r["wall_s"] = 1.25
    jout, tout = tmp_path / "TUNING.md", tmp_path / "TUNING_torch.md"
    jsweep.write_report(tres, dataset, 5, seed, str(jout), trial_seed=2)
    sweep.write_report(tres, dataset, 5, seed, str(tout), trial_seed=2,
                       device="cpu")
    capsys.readouterr()
    jl, tl = jout.read_text().splitlines(), tout.read_text().splitlines()
    assert len(jl) == len(tl)
    differ = [i for i, (a, b) in enumerate(zip(jl, tl)) if a != b]
    assert differ == [2, 3]
    tail = "config.yml:12-17`; NNI is"
    assert jl[3].startswith("reference TPE grid (") and jl[3].endswith(tail)
    assert tl[3] == f"reference TPE grid (the reference's `{tail}"
    assert tl[2].startswith(f"`python -m fedamw_tpu_torch.sweep --dataset "
                            f"{dataset} --trials {len(tres)} --round 5 "
                            f"--seed {seed} --trial_seed 2 --backend port "
                            f"--device cpu --out {tout}` on the CPU — ")
    rows = [ln for ln in tl if ln.startswith("| ") and ln[2].isdigit()]
    assert [int(r.split("|")[1]) for r in rows] == list(
        range(1, len(tres) + 1))


def test_sweep_runs_real_trials_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["sweep"])
    out = tmp_path / "T.md"
    sweep.main(["--dataset", "digits", "--trials", "2", "--round", "2",
                "--device", "cpu", "--out", str(out)])
    capsys.readouterr()
    rows = [ln for ln in out.read_text().splitlines()
            if ln.startswith("| 1 |") or ln.startswith("| 2 |")]
    assert len(rows) == 2
    accs = [float(r.split("|")[4]) for r in rows]
    assert accs[0] >= accs[1]


def test_grids_are_the_search_space_and_the_port_config_runs_the_port():
    with open(REPO / "config.yml") as f:
        root = yaml.safe_load(f)
    with open(PKG / "config.yml") as f:
        port = yaml.safe_load(f)
    for cfg in (root, port):
        assert sweep.LR_P_GRID == cfg["searchSpace"]["lr_p"]["_value"]
        assert sweep.LAMBDA_REG_GRID \
            == cfg["searchSpace"]["lambda_reg"]["_value"]
    assert (sweep.LR_P_GRID, sweep.LAMBDA_REG_GRID) \
        == (jsweep.LR_P_GRID, jsweep.LAMBDA_REG_GRID)
    assert port["trialCommand"] == (
        "python3 -m fedamw_tpu_torch.tune --dataset satimage --D 2000 "
        "--round 100 --backend port")
    assert port["trialGpuNumber"] == 1
    assert {k: v for k, v in port.items()
            if k not in ("trialCommand", "trialGpuNumber",
                         "trialCodeDirectory", "trainingService")} \
        == {k: v for k, v in root.items()
            if k not in ("trialCommand", "trialGpuNumber",
                         "trainingService")}
    assert (PKG / port["trialCodeDirectory"]).resolve() == REPO
