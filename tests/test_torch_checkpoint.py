"""The port's checkpoints (``fedamw_tpu_torch.utils.checkpoint``) and the
round resume that goes through them, against the JAX package.

A checkpoint moves both ways: one the port saves is read by the JAX
package's ``load_checkpoint`` and resumes a JAX run, and one the JAX
package saves in its pickle layout (orbax hidden from its import, as on
a machine without orbax) resumes a port run. Either way the split run
matches the uninterrupted JAX run at 1e-5 absolute and relative (the
same float32 arithmetic in two summation orders), with every random
input injected as in ``tests/test_torch_options.py``. The port's own
split run through a checkpoint is the uninterrupted run bit for bit.
An orbax layout is refused with ``CheckpointError``.
"""

import pickle
import sys

import numpy as np
import pytest
import torch

import fedamw_tpu.algorithms as J
from fedamw_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from fedamw_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch.utils import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from test_torch_options import (
    TOL,
    _assert_state,
    _inject,
    _jsetup,
    _kwargs,
    _tsetup,
)

STATE_KEYS = ("params", "p", "p_opt", "server_opt", "server_opt_kind")
# (algorithm, extra keyword arguments): FedAMW carries its p momentum,
# FedAvg its server optimizer's moments and counter
CASES = [("FedAMW", {}), ("FedAvg", {"server_opt": "adam", "server_lr": 0.1}),
         ("FedNova", {"server_opt": "adagrad", "server_lr": 0.3})]


def _extra(res):
    return {k: res[k] for k in ("p_opt", "server_opt", "server_opt_kind")
            if k in res}


def _metrics(*parts):
    return {k: np.concatenate([np.asarray(p[k]) for p in parts])
            for k in ("train_loss", "test_loss", "test_acc")}


def test_roundtrip(tmp_path):
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    p = torch.tensor([0.25, 0.75])
    opt = (torch.tensor(3, dtype=torch.int32), torch.ones(3, 4),
           torch.zeros(3, 4))
    rff = (np.ones((2, 4), np.float32), np.zeros((1, 4), np.float32))
    where = save_checkpoint(str(tmp_path / "ck"), params, p=p, round_idx=7,
                            extra={"server_opt": opt,
                                   "server_opt_kind": "adam"}, rff=rff)
    assert where.endswith("state.pkl")
    state = load_checkpoint(str(tmp_path / "ck"))
    np.testing.assert_array_equal(state["params"]["w"], params["w"].numpy())
    np.testing.assert_array_equal(state["p"], p.numpy())
    assert state["round"] == 7 and state["server_opt_kind"] == "adam"
    assert isinstance(state["server_opt"], tuple)
    assert state["server_opt"][0].dtype == np.int32
    np.testing.assert_array_equal(state["rff_W"], rff[0])
    # the same bytes are the JAX package's checkpoint
    jstate = jload_checkpoint(str(tmp_path / "ck"))
    assert set(jstate) == set(state)


@pytest.mark.parametrize("algo,extra", CASES)
def test_port_checkpoint_resumes_the_jax_run(algo, extra, tmp_path):
    """Rounds [0, 1) on the port, its state saved here and loaded by the
    JAX package, rounds [1, 3) in JAX: the uninterrupted JAX run."""
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    kw = _kwargs(algo, "cls10", round=3, **extra)
    full = getattr(J, algo)(sj, **kw)
    inject = _inject(sj, algo, rounds=3)
    first = getattr(T, algo)(st, **kw, stop_round=1, **inject)
    save_checkpoint(str(tmp_path / "ck"), first["params"], p=first["p"],
                    round_idx=1, extra=_extra(first))
    state = jload_checkpoint(str(tmp_path / "ck"))
    second = getattr(J, algo)(sj, **kw, start_round=1, resume_from=state)
    got = _metrics(first, second)
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(full[k]), **TOL, err_msg=k)
    for k in ("params", "p"):
        np.testing.assert_allclose(
            np.asarray(second[k]["w"] if k == "params" else second[k]),
            np.asarray(full[k]["w"] if k == "params" else full[k]), **TOL)


@pytest.mark.parametrize("algo,extra", CASES)
def test_jax_pickle_checkpoint_resumes_the_port_run(algo, extra, tmp_path,
                                                    monkeypatch):
    """Rounds [0, 1) in JAX, saved in its pickle layout, loaded here,
    rounds [1, 3) on the port: the uninterrupted JAX run."""
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    kw = _kwargs(algo, "cls10", round=3, **extra)
    full = getattr(J, algo)(sj, **kw)
    first = getattr(J, algo)(sj, **kw, stop_round=1)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    where = jsave_checkpoint(str(tmp_path / "ck"), first["params"],
                             p=first["p"], round_idx=1, extra=_extra(first))
    monkeypatch.undo()
    assert where.endswith("state.pkl")
    state = load_checkpoint(str(tmp_path / "ck"))
    second = getattr(T, algo)(st, **kw, start_round=1, resume_from=state,
                              **_inject(sj, algo, rounds=3))
    got = _metrics(first, second)
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(full[k]), **TOL, err_msg=k)
    _assert_state(second, full)


@pytest.mark.parametrize("algo,extra", CASES)
def test_split_run_through_a_checkpoint_is_bitwise(algo, extra, tmp_path):
    st = _tsetup("cls3")
    kw = _kwargs(algo, "cls3", round=3, seed=11, **extra)
    full = getattr(T, algo)(st, **kw)
    first = getattr(T, algo)(st, **kw, stop_round=2)
    save_checkpoint(str(tmp_path / "ck"), first["params"], p=first["p"],
                    round_idx=2, extra=_extra(first))
    second = getattr(T, algo)(st, **kw, start_round=2,
                              resume_from=load_checkpoint(str(tmp_path /
                                                              "ck")))
    for k, v in _metrics(first, second).items():
        np.testing.assert_array_equal(v, full[k])
    for k in STATE_KEYS:
        if k not in full:
            continue
        a, b = full[k], second[k]
        if k == "params":
            a, b = a["w"], b["w"]
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), k
        else:
            assert a == b


def test_orbax_layout_is_refused_by_name(tmp_path):
    """The JAX package saves with orbax where it can; the port reads no
    orbax and says so."""
    pytest.importorskip("orbax.checkpoint")
    params = {"w": np.ones((2, 3), np.float32)}
    where = jsave_checkpoint(str(tmp_path / "ck"), params)
    assert "orbax" in where
    with pytest.raises(CheckpointError, match="orbax layout") as err:
        load_checkpoint(str(tmp_path / "ck"))
    assert err.value.path == str(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="orbax layout"):
        load_checkpoint(where)


def test_port_save_removes_a_stale_orbax_layout(tmp_path):
    """A pickle saved over an orbax checkpoint must not be shadowed by
    it in the JAX package's loader, which prefers orbax."""
    pytest.importorskip("orbax.checkpoint")
    jsave_checkpoint(str(tmp_path / "ck"), {"w": np.zeros((2, 3),
                                                          np.float32)})
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(2, 3)})
    np.testing.assert_array_equal(
        np.asarray(jload_checkpoint(str(tmp_path / "ck"))["params"]["w"]),
        np.ones((2, 3)))
    np.testing.assert_array_equal(
        load_checkpoint(str(tmp_path / "ck"))["params"]["w"], np.ones((2, 3)))


def test_corrupt_and_missing_checkpoints(tmp_path):
    (tmp_path / "bad").mkdir()
    good = pickle.dumps({"params": {"w": np.ones(3)}})
    (tmp_path / "bad" / "state.pkl").write_bytes(good[: len(good) // 2])
    with pytest.raises(CheckpointError, match="state.pkl") as err:
        load_checkpoint(str(tmp_path / "bad"))
    assert err.value.path.endswith("state.pkl")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nothing_here"))
