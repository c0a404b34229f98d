"""The client axis over ranks in the port against its single-process run
and against the JAX package's sharded run, on CPU processes.

One spawned group per module (``tests/torch_ranks_child.py``, which
imports no JAX): two gloo ranks run every case on their blocks of the
setup (``shard_setup(setup, make_mesh(2))``), then the child's own
process runs a few cases ungrouped and on a one-rank group. The setups are sklearn
``digits`` in J=8 clients (alpha 0.5, RFF D=64), flat and in 4 size
buckets padded to an even count (``client_multiple=2``); 2 rounds of 2
local epochs, 3 rounds under faults. Every random input is the JAX run's,
injected as in ``tests/test_torch_options.py`` and
``tests/test_torch_paper.py``, and each rank takes its block of the
injected shuffles.

The cases, on the JAX run's draws: FedAvg, FedProx, FedNova, FedAMW,
FedAMW on 4 buckets,
FedAMW under participation 0.5, FedAvg with ``server_opt`` adam,
FedAMW_OneShot, Centralized, Distributed, the faults
``drop=0.1,corrupt=0.05:nan,seed=7`` under ``quarantine:3`` (FedAvg),
with krum folded into FedAMW's present mask and with reputation and the
coordinate-wise median (FedNova), FedAMW under non-finite corruption with
``quarantine:auto+rep``, ``cohort_shards=4`` (FedAvg, FedAMW), and the
streamed cohort at 4 shards (FedAvg; FedNova under the faults with
``quarantine:3``). And on the port's own draws (each rank draws the
whole axis's keys and keeps its block): FedAvg on 4 buckets under
participation 0.5, FedAMW, FedAMW_OneShot and the streamed FedAvg,
held against the single-process run only. Two cases run the zoo on raw
features (``kernel_type="linear"``): FedAMW on ``mlp16`` (a multi-leaf
aggregate all-reduced, the zoo's validation logits all-gathered) and
FedAvg on ``conv4x8`` under the faults with ``quarantine:3+krum`` (the
stacked multi-leaf updates all-gathered).

Held: the two-rank run equals the port's single-process run and the JAX
package's run on its 2-device virtual mesh within 1e-5 absolute and
relative on every returned float, and exactly on every integer
(``fault_counts``, the defense verdicts, ``shard_present``); the two
ranks return the same bits (p, the weights, every metric); a one-rank
group equals the ungrouped run bit for bit; ``make_mesh`` refuses more
ranks than the group has and a truncated group with the JAX package's
messages.
"""

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fedamw_tpu.algorithms as J
from fedamw_tpu.algorithms.core import _keys
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.parallel import make_mesh as jmake_mesh
from fedamw_tpu.parallel import shard_setup as jshard_setup
from fedamw_tpu_torch.algorithms import ALGORITHMS
from fedamw_tpu_torch.convert import setup_from_arrays
from test_torch_options import _inject

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SEED, LE, B, VB = 0, 2, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)
FAULTS = "drop=0.1,corrupt=0.05:nan,seed=7"
ONESHOT = ("Centralized", "Distributed", "FedAMW_OneShot")
# name -> (setup: buckets, or a zoo model's name, algorithm, rounds,
# keywords)
CASES = {
    "avg": (1, "FedAvg", 2, {}),
    "prox": (1, "FedProx", 2, {}),
    "nova": (1, "FedNova", 2, {}),
    "amw": (1, "FedAMW", 2, {}),
    "amw-buckets4": (4, "FedAMW", 2, {}),
    "amw-part": (1, "FedAMW", 2, {"participation": 0.5}),
    "avg-adam": (1, "FedAvg", 2, {"server_opt": "adam", "server_lr": 0.1}),
    "oneshot": (1, "FedAMW_OneShot", 2, {}),
    "central": (1, "Centralized", 2, {}),
    "dist": (1, "Distributed", 2, {}),
    "avg-quarantine": (1, "FedAvg", 3, {"faults": FAULTS,
                                        "robust_agg": "quarantine:3"}),
    "amw-krum": (1, "FedAMW", 3, {"faults": FAULTS,
                                  "robust_agg": "quarantine:3+krum"}),
    "nova-rep-median": (1, "FedNova", 3, {"faults": FAULTS,
                                          "robust_agg": "rep:0.5:0.2+median"}),
    "amw-nan-auto-rep": (1, "FedAMW", 3, {
        "faults": "drop=0.1,straggle=0.2:0.5,corrupt=0.15:nan,seed=7",
        "robust_agg": "quarantine:auto+rep:0.5:0.2"}),
    "avg-cohort4": (1, "FedAvg", 2, {"cohort_shards": 4}),
    "amw-cohort4": (1, "FedAMW", 2, {"cohort_shards": 4}),
    "avg-stream4": (1, "FedAvg", 2, {"cohort_shards": 4,
                                     "stream_cohort": True}),
    "nova-stream4-quarantine": (1, "FedNova", 3, {
        "cohort_shards": 4, "stream_cohort": True, "faults": FAULTS,
        "robust_agg": "quarantine:3"}),
    "mlp-amw": ("mlp16", "FedAMW", 2, {}),
    "conv-avg-krum": ("conv4x8", "FedAvg", 3, {
        "faults": FAULTS, "robust_agg": "quarantine:3+krum"}),
}
# the setups' names in the job, by their CASES key
SETUPS = {1: "b1", 4: "b4", "mlp16": "mlp16", "conv4x8": "conv4x8"}
# the port's own draws (nothing injected): each rank draws the whole
# axis's keys and keeps its block, the streamed rank drops the draws of
# the shards before its own; held against the single-process run only
DRAWN = {
    "avg-drawn": (4, "FedAvg", 2, {"participation": 0.5}),
    "amw-drawn": (1, "FedAMW", 2, {}),
    "oneshot-drawn": (1, "FedAMW_OneShot", 2, {}),
    "avg-stream4-drawn": (1, "FedAvg", 2, {"cohort_shards": 4,
                                           "stream_cohort": True}),
}
ONE_RANK = ("amw", "amw-buckets4", "amw-krum", "amw-cohort4", "oneshot")


@functools.lru_cache(maxsize=None)
def _jsetup(key):
    """The JAX setup of a ``SETUPS`` key: RFF features in ``key`` size
    buckets, or a zoo model's name on raw features."""
    ds = jload_dataset("digits", num_partitions=8, alpha=0.5)
    if isinstance(key, str):
        return J.prepare_setup(ds, D=64, kernel_type="linear", seed=3,
                               rng=np.random.RandomState(3), model=key,
                               client_multiple=2)
    return J.prepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3),
                           buckets=key, client_multiple=2)


def _arrays(key) -> dict:
    """``setup_from_arrays`` keywords of the JAX setup, as numpy."""
    sj = _jsetup(key)
    idx, mask = sj.round_arrays()
    buckets = len(idx)
    if buckets == 1:
        idx, mask = idx[0], mask[0]
    np_ = np.asarray
    return dict(model=sj.model.name,
        task=sj.task, num_classes=sj.num_classes, X=np_(sj.X), y=np_(sj.y),
        X_val=np_(sj.X_val), y_val=np_(sj.y_val), X_test=np_(sj.X_test),
        y_test=np_(sj.y_test),
        idx=tuple(map(np_, idx)) if buckets > 1 else np_(idx),
        mask=tuple(map(np_, mask)) if buckets > 1 else np_(mask),
        sizes=np_(sj.sizes), p_fixed=np_(sj.p_fixed),
        rff=None if sj.rff is None else tuple(map(np_, sj.rff)))


def _kwargs(algo, rounds, extra):
    if algo in ONESHOT:
        kw = dict(lr=0.5, epoch=LE * rounds, seed=SEED)
        if algo == "FedAMW_OneShot":
            kw.update(lambda_reg=5e-4, lr_p=5e-3, round=rounds)
        return kw
    kw = dict(lr=0.5, epoch=LE, round=rounds, seed=SEED, lr_mode="constant",
              return_state=True, **extra)
    if algo == "FedProx":
        kw["mu"] = 0.01
    if algo == "FedAMW":
        kw.update(lambda_reg=5e-4, lr_p=5e-3)
    return kw


def _oneshot_inject(sj, algo, rounds):
    """The JAX one-shot runs' draws (``tests/test_torch_paper.py``)."""
    Jn, n_max = sj.idx.shape
    epochs = LE * rounds
    base = _inject(sj, "FedAvg", rounds=rounds)
    params0 = base["params0"]
    if algo == "Centralized":
        n = int(sj.all_train_idx.shape[0])
        return dict(params0=params0, client_positions=np.stack([
            np.asarray(jepoch_batches(k, n, B, jnp.ones(n, jnp.float32))[0])
            for k in jax.random.split(jax.random.PRNGKey(SEED), epochs)]))
    keys = _keys(SEED, Jn)
    pos = np.stack([[np.asarray(jepoch_batches(k, n_max, B, sj.mask[j])[0])
                     for k in jax.random.split(keys[j], epochs)]
                    for j in range(Jn)])
    out = dict(params0=params0, client_positions=pos)
    if algo == "FedAMW_OneShot":
        n_val = sj.X_val.shape[0]
        out["p_positions"] = np.stack([
            [np.asarray(jepoch_batches(k, n_val, VB)[0])
             for k in jax.random.split(key_t, 1)]
            for key_t in jax.random.split(jax.random.PRNGKey(SEED + 1),
                                          rounds)])
    return out


@functools.lru_cache(maxsize=None)
def _case(name):
    """``(setup name, algorithm, keywords, injected draws)`` of a case."""
    buckets, algo, rounds, extra = {**CASES, **DRAWN}[name]
    sj = _jsetup(buckets)
    if name in DRAWN:
        inject = {}
    elif algo in ONESHOT:
        inject = _oneshot_inject(sj, algo, rounds)
    else:
        inject = _inject(sj, algo, rounds=rounds,
                         participation=extra.get("participation"))
    return SETUPS[buckets], algo, _kwargs(algo, rounds, extra), inject


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case on two gloo ranks and the ``ONE_RANK`` cases on one, in
    one spawned group."""
    tmp = tmp_path_factory.mktemp("ranks")
    job = {"setups": {name: _arrays(key) for key, name in SETUPS.items()},
           "cases": {name: _case(name) for name in {**CASES, **DRAWN}},
           "one_rank": ONE_RANK}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_ranks_child.py"),
         str(tmp / "job.pkl"), str(tmp / "out")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = {}
    for key in ("rank0", "rank1", "one_rank"):
        with open(tmp / f"out.{key}", "rb") as f:
            out[key] = pickle.load(f)
    return out


@functools.lru_cache(maxsize=None)
def _single(name):
    """The port's single-process run of a case."""
    setup_name, algo, kwargs, inject = _case(name)
    key = next(k for k, v in SETUPS.items() if v == setup_name)
    setup = setup_from_arrays(**_arrays(key), device="cpu")
    return ALGORITHMS[algo](setup, **kwargs, **inject)


@functools.lru_cache(maxsize=None)
def _jax_sharded(name):
    """The JAX package's run of a case on its 2-device virtual mesh."""
    buckets, algo, _, _ = CASES[name]
    _, _, kwargs, _ = _case(name)
    sharded = jshard_setup(_jsetup(buckets), jmake_mesh(2))
    return getattr(J, algo)(sharded, **kwargs)


def _flat(res, prefix="") -> dict:
    """Every leaf of a result by path: arrays (tensors and JAX arrays as
    numpy), the optimizer states as their leaves, strings as they are."""
    out = {}
    for k in sorted(res):
        v, path = res[k], f"{prefix}{k}"
        if k in ("p_opt", "server_opt"):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(v)):
                out[f"{path}/{i}"] = np.asarray(leaf)
        elif isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        elif isinstance(v, str):
            out[path] = v
        else:
            out[path] = np.asarray(v)
    return out


def _assert_close(got, want):
    """Floats within ``TOL``; integers (the verdicts), booleans and
    strings exactly."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        elif np.issubdtype(w.dtype, np.floating):
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, **TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_bitwise(a, b):
    a, b = _flat(a), _flat(b)
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, str):
            assert v == b[k], k
        else:
            np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("case", sorted({**CASES, **DRAWN}))
def test_two_ranks_match_the_single_process_run(case, spawned):
    _assert_close(spawned["rank0"]["results"][case], _single(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_the_jax_sharded_run(case, spawned):
    _assert_close(spawned["rank0"]["results"][case], _jax_sharded(case))


@pytest.mark.parametrize("case", sorted({**CASES, **DRAWN}))
def test_the_ranks_return_the_same_bits(case, spawned):
    _assert_bitwise(spawned["rank0"]["results"][case],
                    spawned["rank1"]["results"][case])


@pytest.mark.parametrize("case", ONE_RANK)
def test_a_one_rank_group_is_the_ungrouped_run(case, spawned):
    assert spawned["one_rank"]["grouped"]
    ungrouped, grouped = spawned["one_rank"]["results"][case]
    _assert_bitwise(grouped, ungrouped)


def test_the_faulty_cases_reach_their_defenses(spawned):
    """Facts of these inputs, the same in every run: the plans drop
    clients, the non-finite quarantine fires on the corrupted ones, krum
    picks one client a round, reputation is kept and the hierarchy counts
    each shard's clients."""
    res = spawned["rank0"]["results"]
    assert res["avg-quarantine"]["fault_counts"]["dropped"].sum() > 0
    fc = res["amw-nan-auto-rep"]["fault_counts"]
    assert fc["quarantined"].sum() == fc["corrupted"].sum() > 0
    assert res["amw-krum"]["defense"]["krum_selected"].sum(1).tolist() == [
        1, 1, 1]
    assert "reputation" in res["nova-rep-median"]["defense"]
    np.testing.assert_array_equal(
        res["avg-cohort4"]["hierarchy"]["shard_present"], [[2] * 4] * 2)


@pytest.mark.parametrize("rank", [0, 1])
def test_the_mesh_under_a_group(rank, spawned):
    facts = spawned[f"rank{rank}"]["mesh"]
    assert (facts["size"], facts["rank"], facts["grouped"]) == (2, rank,
                                                               True)
    assert facts["rejoin"] == 2         # initialize_multihost: a no-op
    assert facts["more"] == "requested 3 devices, have 2"
    with pytest.raises(ValueError) as want:
        jmake_mesh(9)
    assert want.value.args[0] == "requested 9 devices, have 8"
    assert facts["fewer"].startswith(
        "truncating the global mesh under multihost")
    assert not facts["jax_imported"]
