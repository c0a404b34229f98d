"""The cohort plane's streamed shards in the port, on the CPU: the stream,
the streamed round against the JAX package's, its refusals, and the
driver's ``--cohort_shards`` and ``--stream_cohort``.

``CohortShardStream`` visits every shard once, in order, one shard ahead
of the compute, and refuses a ragged split with the JAX package's message.
Streamed FedAvg, FedProx and FedNova and the defended streamed FedAvg
(``quarantine:5``: the shard-local z-test) run on
``tests/test_torch_options.py``'s ``digits`` setup (J=6, RFF D=64, 2
rounds of 2 local epochs) on the JAX run's draws: its initial weights and
each client's shuffles, sliced shard by shard (the JAX streamed round
draws from the same per-client keys as the flat one). Every float is held
at ``TOL`` (1e-5 absolute and relative), ``fault_counts`` and the
``streamed`` record exactly. On the same injected shuffles the streamed
run is the port's flat run at ``TOL``. Every refusal of the streamed
surface raises the JAX package's exception with its message.

The driver's flags: parsed, refused at the flag boundary with the JAX
driver's messages, signing the partial, and a 2-round run with each.
The ``cuda``-marked test checks the two device buffers on the card.
"""

import contextlib
import functools
import io
import pickle
import sys

import numpy as np
import pytest
import torch

import fedamw_tpu.algorithms as J
from fedamw_tpu.data import CohortShardStream as JCohortShardStream
import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch import exp
from fedamw_tpu_torch.algorithms import core
from fedamw_tpu_torch.data import CohortShardStream
from test_torch_options import TOL, _inject, _jsetup, _kwargs, _tsetup

DATA = "cls10"
FAULTS = "drop=0.2,corrupt=0.1:scale:25,seed=3"


# -- the stream -------------------------------------------------------------


def _rows(J_=8, n_max=3):
    idx = np.arange(J_ * n_max, dtype=np.int64).reshape(J_, n_max)
    mask = np.ones((J_, n_max), np.float32)
    sizes = np.full(J_, n_max, np.int32)
    p = np.full(J_, 1.0 / J_, np.float32)
    return idx, mask, sizes, p


def test_stream_visits_every_shard_once_in_order():
    idx, mask, sizes, p = _rows()
    stream = CohortShardStream(4, idx=idx, mask=mask, sizes=sizes,
                               p_fixed=p, device="cpu")
    rows = np.arange(8, dtype=np.float32)
    fault_rows = tuple(rows + i for i in range(5))
    positions = np.arange(8 * 2 * 1 * 4).reshape(8, 2, 1, 4)
    seen = []
    for s, shard in stream.round_shards(fault_rows=fault_rows,
                                        positions=positions):
        sl = slice(2 * s, 2 * s + 2)
        np.testing.assert_array_equal(shard["idx"].numpy(), idx[sl])
        np.testing.assert_array_equal(shard["mask"].numpy(), mask[sl])
        np.testing.assert_array_equal(shard["sizes"].numpy(), sizes[sl])
        np.testing.assert_array_equal(shard["p_fixed"].numpy(), p[sl])
        assert len(shard["fault_rows"]) == 5
        for i, r in enumerate(shard["fault_rows"]):
            np.testing.assert_array_equal(r.numpy(), fault_rows[i][sl])
        np.testing.assert_array_equal(shard["positions"].numpy(),
                                      positions[sl])
        seen.append(s)
    assert seen == [0, 1, 2, 3]
    assert (stream.n_shards, stream.shard_clients, stream.num_clients) == (
        4, 2, 8)
    assert stream.copy_wait_ms() == 0.0


def test_stream_holds_at_most_two_shards(monkeypatch):
    """While shard s is out, shard s + 1 has been put and no later one:
    one shard of lookahead, so two shards at most."""
    stream = CohortShardStream(5, *_rows(10), device="cpu")
    put, real = [], stream._put
    monkeypatch.setattr(stream, "_put",
                        lambda s, rows: put.append(s) or real(s, rows))
    for s, _ in stream.round_shards():
        assert put[-1] == min(s + 1, 4) and len(put) == min(s + 2, 5)
    assert put == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("n", [4, 0])
def test_stream_refuses_a_ragged_split_as_jax(n):
    idx = np.zeros((10, 2), np.int64)
    args = dict(idx=idx, mask=np.zeros((10, 2)), sizes=np.zeros(10),
                p_fixed=np.zeros(10))
    with pytest.raises(ValueError) as jerr:
        JCohortShardStream(n, **args)
    with pytest.raises(ValueError) as err:
        CohortShardStream(n, **args)
    # the port's message ends where the JAX one names its compiled program
    assert str(err.value).split(" so every")[0] == str(jerr.value).split(
        " so every")[0]


@pytest.mark.cuda
def test_stream_double_buffers_on_the_card():
    """Two device buffers, alternating shard by shard, each shard's rows
    right; the compute stream's waits are measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy stream and pinned rows")
    idx, mask, sizes, p = _rows(12)
    stream = CohortShardStream(4, idx=idx, mask=mask, sizes=sizes,
                               p_fixed=p, device="cuda")
    ptrs = []
    for s, shard in stream.round_shards(
            fault_rows=[np.arange(12, dtype=np.float32)] * 5):
        ptrs.append(shard["idx"].data_ptr())
        assert shard["idx"].is_cuda
        np.testing.assert_array_equal(shard["idx"].cpu().numpy(),
                                      idx[3 * s:3 * s + 3])
    assert len(set(ptrs)) == 2 and ptrs[0] == ptrs[2] != ptrs[1] == ptrs[3]
    assert stream.copy_wait_ms() >= 0.0


# -- streamed runs against the JAX package's --------------------------------


@functools.lru_cache(maxsize=None)
def _run(pkg, algo, **kw):
    kwargs = _kwargs(algo, DATA, stream_cohort=True, **kw)
    if pkg == "jax":
        return getattr(J, algo)(_jsetup(DATA), **kwargs)
    return getattr(T, algo)(_tsetup(DATA), **kwargs,
                            **_inject(_jsetup(DATA), algo))


def _assert_match(rt, rj):
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL,
                                   err_msg=k)
        assert np.all(np.isfinite(rt[k])), k
    np.testing.assert_allclose(rt["params"]["w"].numpy(),
                               np.asarray(rj["params"]["w"]), **TOL)
    assert {k: rt["streamed"][k] for k in ("cohort_shards", "shard_clients")
            } == {k: rj["streamed"][k] for k in ("cohort_shards",
                                                  "shard_clients")}
    np.testing.assert_array_equal(rt["streamed"]["present"],
                                  rj["streamed"]["present"])
    assert set(rt) == set(rj)


@pytest.mark.parametrize("algo,shards", [("FedAvg", 3), ("FedProx", 2),
                                         ("FedNova", 2)])
def test_streamed_run_matches_jax(algo, shards):
    _assert_match(_run("torch", algo, cohort_shards=shards),
                  _run("jax", algo, cohort_shards=shards))


def test_streamed_defended_run_matches_jax():
    kw = dict(cohort_shards=2, faults=FAULTS, robust_agg="quarantine:5")
    rt, rj = _run("torch", "FedAvg", **kw), _run("jax", "FedAvg", **kw)
    _assert_match(rt, rj)
    for k, v in rj["fault_counts"].items():
        np.testing.assert_array_equal(rt["fault_counts"][k], v, err_msg=k)
    # the plan corrupts, and the shards' z-tests (three clients each here)
    # quarantine, in both packages alike
    assert rt["fault_counts"]["corrupted"].sum() > 0
    assert rt["fault_counts"]["quarantined"].sum() > 0


@pytest.mark.parametrize("algo", ["FedAvg", "FedNova"])
def test_streamed_run_is_the_flat_run_on_the_same_shuffles(algo):
    st = _run("torch", algo, cohort_shards=3)
    flat = T.FedAvg if algo == "FedAvg" else T.FedNova
    ref = flat(_tsetup(DATA), **_kwargs(algo, DATA),
               **_inject(_jsetup(DATA), algo))
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(st[k], ref[k], **TOL, err_msg=k)
    np.testing.assert_allclose(st["params"]["w"].numpy(),
                               ref["params"]["w"].numpy(), **TOL)


def test_streamed_run_draws_its_own_shuffles_deterministically():
    """With nothing injected the shards draw from the round's generator in
    turn: the same seed repeats bitwise, and the run stays near the flat
    run of the same seed (another draw order, so not bitwise)."""
    st = _tsetup(DATA)
    kw = dict(lr=0.5, epoch=2, round=2, seed=4, lr_mode="constant")
    a = T.FedAvg(st, cohort_shards=3, stream_cohort=True, **kw)
    b = T.FedAvg(st, cohort_shards=3, stream_cohort=True, **kw)
    flat = T.FedAvg(st, **kw)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_allclose(a["test_loss"], flat["test_loss"], rtol=0.05)


def test_the_shard_tier_is_memoized_across_runs():
    """One tier per configuration: fault plans, round counts and shard
    counts reuse it; a different defense builds another."""
    st = _tsetup(DATA)
    kw = dict(lr=0.5, epoch=1, seed=0, lr_mode="constant",
              stream_cohort=True, robust_agg="quarantine:5")
    T.FedAvg(st, cohort_shards=2, faults=FAULTS, round=2, **kw)
    tier = core._LAST_SHARD_TIER
    T.FedAvg(st, cohort_shards=3, faults="drop=0.3,seed=11", round=3, **kw)
    assert core._LAST_SHARD_TIER is tier
    T.FedAvg(st, cohort_shards=2, faults=FAULTS, round=2,
             **dict(kw, robust_agg="clip:1+quarantine:5"))
    assert core._LAST_SHARD_TIER is not tier


# name -> (algorithm, keywords, setup buckets)
REFUSALS = {
    "learned": ("FedAMW", dict(cohort_shards=2, stream_cohort=True), 1),
    "no shards": ("FedAvg", dict(stream_cohort=True), 1),
    "negative": ("FedAvg", dict(cohort_shards=-1, stream_cohort=True), 1),
    "too many": ("FedAvg", dict(cohort_shards=7, stream_cohort=True), 1),
    "rep": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                           robust_agg="rep:0.9:0.2"), 1),
    "median": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                              robust_agg="median"), 1),
    "auto": ("FedNova", dict(cohort_shards=2, stream_cohort=True,
                             robust_agg="quarantine:auto"), 1),
    "sequential": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                                  sequential=True), 1),
    "participation": ("FedProx", dict(cohort_shards=2, stream_cohort=True,
                                      participation=0.5), 1),
    "server_opt": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                                  server_opt="adam"), 1),
    "stop_round": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                                  stop_round=1), 1),
    "resume": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                              start_round=1, resume_from={"params": None}),
               1),
    "analyze_memory": ("FedAvg", dict(cohort_shards=2, stream_cohort=True,
                                      analyze_memory=True), 1),
    "buckets": ("FedAvg", dict(cohort_shards=2, stream_cohort=True), 2),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_streamed_refusals_match_jax(case):
    algo, kw, buckets = REFUSALS[case]
    kwargs = dict(lr=0.5, epoch=1, round=2, seed=0, **kw)
    msgs = []
    for pkg, setup in ((J, _jsetup(DATA, buckets)),
                       (T, _tsetup(DATA, buckets))):
        with pytest.raises(ValueError) as err:
            getattr(pkg, algo)(setup, **kwargs)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- the driver -------------------------------------------------------------

ARGV = ["--device", "cpu", "--dataset", "digits", "--D", "64",
        "--num_partitions", "4", "--round", "2", "--local_epoch", "1",
        "--seed", "100"]


@pytest.mark.parametrize("extra", [["--cohort_shards", "2"],
                                   ["--cohort_shards", "4",
                                    "--stream_cohort"]])
def test_cohort_flags_parse(extra):
    args = exp.parse_args(ARGV + extra)
    assert args.cohort_shards == int(extra[1])
    assert args.stream_cohort == ("--stream_cohort" in extra)
    assert not {"--cohort_shards", "--stream_cohort"} & set(exp._REFUSED)


BAD_FLAGS = {
    "negative": ["--cohort_shards", "-1"],
    "no shards": ["--stream_cohort"],
    "sequential": ["--cohort_shards", "2", "--stream_cohort",
                   "--sequential"],
    "participation": ["--cohort_shards", "2", "--stream_cohort",
                      "--participation", "0.5"],
    "server_opt": ["--cohort_shards", "2", "--stream_cohort",
                   "--server_opt", "adam"],
    "cap": ["--cohort_shards", "65", "--stream_cohort"],
    "median": ["--cohort_shards", "2", "--stream_cohort", "--robust_agg",
               "median"],
    "rep": ["--cohort_shards", "2", "--stream_cohort", "--robust_agg",
            "rep:0.5:0.2"],
}


def _jax_parse_error(argv, monkeypatch, capsys):
    """The JAX driver's argparse error for ``argv`` (its ``parse_args``
    reads ``sys.argv``)."""
    import importlib.util
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_exp_driver", os.path.join(here, "exp.py"))
    jexp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexp)
    monkeypatch.setattr(sys, "argv", ["exp.py"] + argv)
    with pytest.raises(SystemExit):
        jexp.parse_args()
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("case", sorted(BAD_FLAGS))
def test_bad_cohort_flags_are_argparse_errors_as_jax(case, monkeypatch,
                                                     capsys):
    argv = BAD_FLAGS[case]
    with pytest.raises(SystemExit) as err:
        exp.parse_args(ARGV + argv)
    assert err.value.code == 2
    ours = capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]
    theirs = _jax_parse_error(argv, monkeypatch, capsys)
    # the cap's message ends by pointing at each package's own entry
    # points; the rest is the JAX driver's
    cut = "; use <=" if case == "cap" else None
    assert ours.split(cut)[0] == theirs.split(cut)[0]


def test_the_cohort_flags_sign_the_partial():
    plain = exp.resume_config(exp.parse_args(ARGV))
    assert plain["cohort_shards"] == 0 and plain["stream_cohort"] is False
    sharded = exp.resume_config(exp.parse_args(
        ARGV + ["--cohort_shards", "2", "--stream_cohort"]))
    assert sharded["cohort_shards"] == 2 and sharded["stream_cohort"] is True
    rest = ("cohort_shards", "stream_cohort")
    assert {k: v for k, v in sharded.items() if k not in rest} == {
        k: v for k, v in plain.items() if k not in rest}


def test_a_partial_without_the_cohort_keys_resumes_as_flat(tmp_path):
    """A partial written before the flags existed is a flat run: it
    resumes a flat run and refuses a sharded one."""
    res = str(tmp_path / "res")
    with contextlib.redirect_stdout(io.StringIO()):
        exp.main(ARGV + ["--result_dir", res])
    path = tmp_path / "res" / "exp1_digits.partial.pkl"
    part = pickle.loads(path.read_bytes())
    for k in ("cohort_shards", "stream_cohort"):
        part["config"].pop(k)
    path.write_bytes(pickle.dumps(part))
    with contextlib.redirect_stdout(io.StringIO()) as log:
        exp.main(ARGV + ["--result_dir", res, "--resume"])
    assert "1 completed repeat(s) loaded" in log.getvalue()
    with pytest.raises(SystemExit) as err:
        with contextlib.redirect_stdout(io.StringIO()):
            exp.main(ARGV + ["--result_dir", res, "--resume",
                             "--cohort_shards", "2"])
    assert err.value.code == 2


@pytest.mark.parametrize("extra", [["--cohort_shards", "2"],
                                   ["--cohort_shards", "2",
                                    "--stream_cohort"]])
def test_driver_runs_with_each_flag(extra, tmp_path, monkeypatch):
    """A 2-round run: the pickle's schema, the banner, and each round-loop
    algorithm given the flags the JAX driver gives it (exp.py:855-869)."""
    seen = {}
    real = T.ALGORITHMS.copy()

    def spy(name):
        def call(setup, **kw):
            seen[name] = {k: kw.get(k) for k in ("cohort_shards",
                                                 "stream_cohort")}
            return real[name](setup, **kw)
        return call

    for name in ("FedAvg", "FedProx", "FedAMW"):
        monkeypatch.setitem(exp.ALGORITHMS, name, spy(name))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        path = exp.main(ARGV + extra + ["--result_dir", str(tmp_path)])
    with open(path, "rb") as f:
        data = pickle.load(f)
    assert data["test_acc"].shape == (6, 2, 1)
    assert np.all(np.isfinite(data["test_loss"]))
    streamed = "--stream_cohort" in extra
    assert ("FedAvg/FedProx stream 2 client shards" in log.getvalue()) == (
        streamed)
    assert seen["FedAvg"] == seen["FedProx"] == {"cohort_shards": 2,
                                                 "stream_cohort": streamed}
    assert seen["FedAMW"] == {"cohort_shards": 2, "stream_cohort": None}
