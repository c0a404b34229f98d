"""The cohort plane's in-graph sharding in the port against the JAX package,
on the CPU.

The port's ``fedcore/hierarchy.py`` (shard ids, the count's validation,
the two-tier reduction, its per-shard partials and the presence
histogram) array for array against the JAX package's, then
``cohort_shards=S`` runs of FedAvg, FedProx, FedNova and FedAMW on
``tests/test_torch_options.py``'s ``digits`` setup (J=6, RFF D=64, 2
rounds of 2 local epochs; 3 where a run is split) with every random input
injected as there, against the JAX package's sharded runs: clean, under
faults with the z-score quarantine, under reputation gating, with the
order-statistic aggregators (which keep the flat reduction), and composed
with buckets and a server optimizer.

Tolerance: ``TOL`` (1e-5 absolute and relative) on every float the runs
return, as in ``tests/test_torch_options.py``; every verdict
(``fault_counts``, ``z_quarantined``, ``rep_gated``, ``krum_selected``)
and every ``shard_present`` entry exactly. The reductions are held at
2e-6 relative and 1e-6 absolute, the JAX test's tolerance
(``tests/test_hierarchy.py``). ``cohort_shards=0`` is the flat run bit
for bit, and a sharded ``rep`` run split through a checkpoint is the
uninterrupted run bit for bit; a split across the packages is held at
``TOL``.
"""

import functools
import sys
import warnings

import numpy as np
import pytest
import torch

import fedamw_tpu.algorithms as J
from fedamw_tpu.fedcore.aggregate import (
    segment_weighted_sums as jsegment_weighted_sums)
from fedamw_tpu.fedcore.hierarchy import (
    resolve_cohort_shards as jresolve_cohort_shards,
    shard_histogram as jshard_histogram,
    shard_ids as jshard_ids,
    two_tier_weighted_average as jtwo_tier_weighted_average,
)
from fedamw_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from fedamw_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch.fedcore import (
    MAX_COHORT_SHARDS,
    resolve_cohort_shards,
    segment_weighted_sums,
    shard_histogram,
    shard_ids,
    two_tier_weighted_average,
    weighted_average,
)
from fedamw_tpu_torch.utils import load_checkpoint, save_checkpoint
from test_torch_options import TOL, _inject, _jsetup, _kwargs, _tsetup

DATA = "cls10"
SHARDS = 3
FAULTS = "drop=0.2,corrupt=0.1:scale:25,seed=3"
RED_TOL = dict(rtol=2e-6, atol=1e-6)
VERDICTS = ("z_quarantined", "rep_gated", "krum_selected")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the reductions ---------------------------------------------------------


@pytest.mark.parametrize("J_,S", [(8, 4), (10, 3), (5, 1), (12, 12),
                                  (1000192, 256)])
def test_shard_ids_match_jax(J_, S):
    ids = shard_ids(J_, S).numpy()
    np.testing.assert_array_equal(ids, np.asarray(jshard_ids(J_, S)))
    assert ids.dtype == np.int32 and (np.diff(ids) >= 0).all()
    counts = np.bincount(ids, minlength=S)
    assert counts.max() - counts.min() <= 1


@pytest.mark.parametrize("args", [(0, 8), (4, 8), (-1, 8), (9, 8),
                                  (MAX_COHORT_SHARDS + 1,
                                   10 * MAX_COHORT_SHARDS),
                                  (MAX_COHORT_SHARDS + 1,
                                   10 * MAX_COHORT_SHARDS, True)])
def test_resolve_cohort_shards_matches_jax(args):
    outcome = []
    for fn in (jresolve_cohort_shards, resolve_cohort_shards):
        try:
            outcome.append(fn(*args))
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]


def _stacked(seed, J_):
    rng = np.random.RandomState(seed)
    return ({"w": rng.randn(J_, 5, 3).astype(np.float32),
             "b": rng.randn(J_, 3).astype(np.float32)},
            rng.rand(J_).astype(np.float32))


@pytest.mark.parametrize("S", [1, 3, 4, 12])
def test_two_tier_matches_jax_and_the_flat_average(S):
    stacked, w = _stacked(0, 12)
    ts = {k: torch.from_numpy(v) for k, v in stacked.items()}
    tw = torch.from_numpy(w)
    two = two_tier_weighted_average(ts, tw, shard_ids(12, S))
    jtwo = jtwo_tier_weighted_average(stacked, w, jshard_ids(12, S))
    flat = weighted_average(ts, tw)
    for k in stacked:
        np.testing.assert_allclose(two[k].numpy(), np.asarray(jtwo[k]),
                                   **RED_TOL)
        np.testing.assert_allclose(two[k].numpy(), flat[k].numpy(),
                                   **RED_TOL)


def test_segment_weighted_sums_partials_match_jax():
    stacked, w = _stacked(1, 8)
    ts = {k: torch.from_numpy(v) for k, v in stacked.items()}
    parts = segment_weighted_sums(ts, torch.from_numpy(w), shard_ids(8, 4),
                                  MAX_COHORT_SHARDS)
    jparts = jsegment_weighted_sums(stacked, w, jshard_ids(8, 4),
                                    MAX_COHORT_SHARDS)
    for k in stacked:
        assert parts[k].shape == (MAX_COHORT_SHARDS,) + stacked[k].shape[1:]
        np.testing.assert_allclose(parts[k].numpy(), np.asarray(jparts[k]),
                                   **RED_TOL)
        # rows past the shard count are exactly 0
        assert not parts[k][4:].any()


def test_shard_histogram_matches_jax():
    v = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    h = shard_histogram(torch.from_numpy(v), shard_ids(8, 4)).numpy()
    np.testing.assert_array_equal(h, np.asarray(
        jshard_histogram(v, jshard_ids(8, 4))))
    np.testing.assert_array_equal(h[:4], [1, 2, 1, 2])
    assert h.shape == (MAX_COHORT_SHARDS,) and h[4:].sum() == 0


# -- sharded runs against the JAX package's ---------------------------------


@functools.lru_cache(maxsize=None)
def _run(pkg, algo, buckets=1, **kw):
    """One run of ``pkg`` ("jax" or "torch") on the shared setup, the port
    on the JAX run's draws; cached for the module."""
    kwargs = _kwargs(algo, DATA, **kw)
    if pkg == "jax":
        return getattr(J, algo)(_jsetup(DATA, buckets), **kwargs)
    inject = _inject(_jsetup(DATA, buckets), algo,
                     rounds=kwargs["round"],
                     participation=kw.get("participation"))
    return getattr(T, algo)(_tsetup(DATA, buckets), **kwargs, **inject)


def _pair(algo, buckets=1, **kw):
    return _run("torch", algo, buckets, **kw), _run("jax", algo, buckets, **kw)


def _assert_floats(rt, rj):
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL,
                                   err_msg=k)
        assert np.all(np.isfinite(rt[k])), k
    np.testing.assert_allclose(_np(rt["params"]["w"]),
                               np.asarray(rj["params"]["w"]), **TOL)
    np.testing.assert_allclose(_np(rt["p"]), np.asarray(rj["p"]), **TOL)
    for k in ("p_entropy", "p_max"):
        if "mixture" in rj:
            np.testing.assert_allclose(rt["mixture"][k],
                                       np.asarray(rj["mixture"][k]), **TOL)
    if "reputation" in rj.get("defense", {}):
        np.testing.assert_allclose(rt["defense"]["reputation"],
                                   np.asarray(rj["defense"]["reputation"]),
                                   **TOL)


def _assert_decisions(rt, rj):
    assert rt["hierarchy"]["cohort_shards"] == rj["hierarchy"][
        "cohort_shards"]
    np.testing.assert_array_equal(rt["hierarchy"]["shard_present"],
                                  rj["hierarchy"]["shard_present"])
    assert set(rt.get("fault_counts", {})) == set(rj.get("fault_counts", {}))
    for k, v in rj.get("fault_counts", {}).items():
        np.testing.assert_array_equal(rt["fault_counts"][k], v, err_msg=k)
    for k in VERDICTS:
        assert (k in rt.get("defense", {})) == (k in rj.get("defense", {}))
        if k in rj.get("defense", {}):
            np.testing.assert_array_equal(rt["defense"][k],
                                          rj["defense"][k], err_msg=k)


@pytest.mark.parametrize("algo", ["FedAvg", "FedProx", "FedNova", "FedAMW"])
def test_sharded_run_matches_jax(algo):
    rt, rj = _pair(algo, cohort_shards=SHARDS)
    _assert_floats(rt, rj)
    _assert_decisions(rt, rj)
    sp = rt["hierarchy"]["shard_present"]
    assert sp.shape == (2, SHARDS)
    assert (sp.sum(1) == int((_tsetup(DATA).sizes > 0).sum())).all()


@pytest.mark.parametrize("algo", ["FedAvg", "FedNova", "FedAMW"])
def test_sharded_decisions_under_faults_match_jax(algo):
    rt, rj = _pair(algo, cohort_shards=SHARDS, faults=FAULTS,
                   robust_agg="quarantine:5")
    _assert_floats(rt, rj)
    _assert_decisions(rt, rj)
    assert rt["fault_counts"]["corrupted"].sum() > 0


def test_sharded_reputation_gating_matches_jax():
    rt, rj = _pair("FedAvg", cohort_shards=2,
                   faults="corrupt=0.25:sign,seed=1",
                   robust_agg="rep:0.5:0.2")
    _assert_floats(rt, rj)
    _assert_decisions(rt, rj)
    np.testing.assert_allclose(_np(rt["reputation"]),
                               np.asarray(rj["reputation"]), **TOL)


@pytest.mark.parametrize("spec", ["mkrum:3", "median"])
def test_order_statistic_aggregators_run_sharded_as_jax(spec):
    """median and krum fold over every client: the hierarchy keeps their
    flat reduction, and the port's sharded run is the JAX package's."""
    rt, rj = _pair("FedAvg", cohort_shards=SHARDS,
                   faults="corrupt=0.2:sign,seed=2", robust_agg=spec)
    _assert_floats(rt, rj)
    _assert_decisions(rt, rj)
    flat = T.FedAvg(_tsetup(DATA), **_kwargs(
        "FedAvg", DATA, faults="corrupt=0.2:sign,seed=2", robust_agg=spec),
        **_inject(_jsetup(DATA), "FedAvg"))
    np.testing.assert_array_equal(rt["test_loss"], flat["test_loss"])


@pytest.mark.parametrize("case", ["buckets", "server_opt"])
def test_sharded_run_composes_as_jax(case):
    """The shard ids follow the stacked order (bucket by bucket), and the
    two-tier aggregate feeds the server optimizer."""
    if case == "buckets":
        rt, rj = _pair("FedAMW", buckets=2, cohort_shards=SHARDS)
    else:
        rt, rj = _pair("FedAvg", cohort_shards=SHARDS, server_opt="adam",
                       server_lr=0.1)
    _assert_floats(rt, rj)
    _assert_decisions(rt, rj)


def test_cohort_shards_zero_is_the_flat_run_bitwise():
    kw = _kwargs("FedAMW", DATA)
    inject = _inject(_jsetup(DATA), "FedAMW")
    a = T.FedAMW(_tsetup(DATA), **kw, **inject)
    b = T.FedAMW(_tsetup(DATA), **kw, cohort_shards=0, **inject)
    assert "hierarchy" not in a and "hierarchy" not in b
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])
    assert torch.equal(a["params"]["w"], b["params"]["w"])
    assert torch.equal(a["p"], b["p"])


REP = dict(faults="corrupt=0.25:sign,seed=1", robust_agg="rep:0.5:0.2",
           cohort_shards=4, round=3)


def _rep_state(res):
    return dict(extra={"p_opt": res["p_opt"]} if "p_opt" in res else {},
                reputation=res["reputation"])


def test_sharded_rep_split_run_is_bitwise(tmp_path):
    """Rounds [0, 1) and [1, 3) through a checkpoint with the reputation:
    the uninterrupted sharded run, bit for bit."""
    st, sj = _tsetup(DATA), _jsetup(DATA)
    kw = _kwargs("FedAvg", DATA, **REP)
    inject = _inject(sj, "FedAvg", rounds=3)
    full = T.FedAvg(st, **kw, **inject)
    first = T.FedAvg(st, **kw, stop_round=1, **inject)
    save_checkpoint(str(tmp_path / "ck"), first["params"], p=first["p"],
                    round_idx=1, **_rep_state(first))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        second = T.FedAvg(st, **kw, start_round=1, **inject,
                          resume_from=load_checkpoint(str(tmp_path / "ck")))
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(
            np.concatenate([first[k], second[k]]), full[k])
    np.testing.assert_array_equal(
        np.concatenate([first["hierarchy"]["shard_present"],
                        second["hierarchy"]["shard_present"]]),
        full["hierarchy"]["shard_present"])
    np.testing.assert_array_equal(
        np.concatenate([first["defense"]["reputation"],
                        second["defense"]["reputation"]]),
        full["defense"]["reputation"])
    assert torch.equal(second["params"]["w"], full["params"]["w"])
    np.testing.assert_array_equal(second["reputation"], full["reputation"])


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_sharded_rep_checkpoint_crosses_packages(direction, tmp_path,
                                                 monkeypatch):
    """Round [0, 1) in one package, saved with its reputation and loaded
    by the other, rounds [1, 3) there: the uninterrupted sharded JAX run
    at TOL."""
    st, sj = _tsetup(DATA), _jsetup(DATA)
    kw = _kwargs("FedAvg", DATA, **REP)
    inject = _inject(sj, "FedAvg", rounds=3)
    full = _run("jax", "FedAvg", **REP)
    where = str(tmp_path / "ck")
    if direction == "port->jax":
        first = T.FedAvg(st, **kw, stop_round=1, **inject)
        save_checkpoint(where, first["params"], p=first["p"], round_idx=1,
                        **_rep_state(first))
        second = J.FedAvg(sj, **kw, start_round=1,
                          resume_from=jload_checkpoint(where))
    else:
        first = J.FedAvg(sj, **kw, stop_round=1)
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
        jsave_checkpoint(where, first["params"], p=first["p"], round_idx=1,
                         reputation=first["reputation"])
        monkeypatch.undo()
        second = T.FedAvg(st, **kw, start_round=1, **inject,
                          resume_from=load_checkpoint(where))
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(
            np.concatenate([np.asarray(first[k]), np.asarray(second[k])]),
            np.asarray(full[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(
        np.concatenate([first["hierarchy"]["shard_present"],
                        second["hierarchy"]["shard_present"]]),
        full["hierarchy"]["shard_present"])
    np.testing.assert_allclose(_np(second["reputation"]),
                               np.asarray(full["reputation"]), **TOL)
