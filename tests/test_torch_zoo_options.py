"""The round loop's options on the zoo in the port against the JAX package,
on the CPU.

The setups, draws and comparison of ``tests/test_torch_zoo_rounds.py``
(sklearn ``digits`` in J=6 clients on raw features, ``mlp16`` and
``conv4x8``, 2 rounds of 2 local epochs, every draw injected), each
option alone against the JAX package at 1e-5 absolute and relative on
every returned float and exactly on every verdict: ``sequential``, 3
size buckets, participation 0.5, adam, in-graph ``cohort_shards=2``, the
streamed cohort, and under fault plans one defended run
(``quarantine:2+krum``), one clipped run and the coordinate-wise median,
the trimmed mean and the geometric median. A split at round 1 equals the whole run bit for
bit, also through a checkpoint the JAX package reads; the streamed
tier's memo is the model's own.
"""

import numpy as np
import pytest
import torch

import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch.algorithms import core
from test_torch_options import _inject
from test_torch_zoo_rounds import (
    MODELS,
    _assert_match,
    _jax_run,
    _jsetup,
    _kwargs,
    _np,
    _port_run,
    _tsetup,
)

FAULTS = "drop=0.1,corrupt=0.2:nan,seed=7"
# name -> (algorithm, model, buckets, keywords)
OPTIONS = {
    "sequential": ("FedAvg", "conv4x8", 1, {"sequential": True}),
    "buckets3": ("FedAMW", "mlp16", 3, {}),
    "participation": ("FedAMW", "conv4x8", 1, {"participation": 0.5}),
    "adam": ("FedProx", "mlp16", 1, {"server_opt": "adam",
                                     "server_lr": 0.1}),
    "cohort2": ("FedNova", "conv4x8", 1, {"cohort_shards": 2}),
    "stream2": ("FedAvg", "mlp16", 1, {"cohort_shards": 2,
                                       "stream_cohort": True}),
    "defended-krum": ("FedAMW", "conv4x8", 1, {
        "faults": FAULTS, "robust_agg": "quarantine:2+krum"}),
    "clipped": ("FedAvg", "mlp16", 1, {
        "faults": "corrupt=0.3:scale:10,seed=8", "robust_agg": "clip:0.5"}),
    # the order statistics over every leaf of the zoo's parameters
    "median": ("FedAvg", "conv4x8", 1, {
        "faults": "corrupt=0.3:sign,seed=3", "robust_agg": "median"}),
    "trim": ("FedProx", "mlp16", 1, {
        "faults": "corrupt=0.2:inf,seed=9", "robust_agg": "trim:1"}),
    "geomed": ("FedNova", "mlp16", 1, {
        "faults": "straggle=0.4:0.5,seed=6", "robust_agg": "geomed:4"}),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_option_matches_jax(case):
    algo, model, buckets, extra = OPTIONS[case]
    rj = _jax_run(algo, model, buckets, **extra)
    rt = _port_run(algo, model, buckets, **extra)
    _assert_match(rt, rj)


def test_the_defended_and_clipped_runs_decide_something():
    """The fault plans reach the defenses: corrupted reports are
    quarantined, krum picks, the clip moves the aggregate."""
    algo, model, buckets, extra = OPTIONS["defended-krum"]
    rt = _port_run(algo, model, buckets, **extra)
    assert rt["fault_counts"]["quarantined"].sum() > 0
    assert rt["defense"]["krum_selected"].sum() > 0
    algo, model, buckets, extra = OPTIONS["clipped"]
    clipped = _port_run(algo, model, buckets, **extra)
    loose = _port_run(algo, model, buckets, faults=extra["faults"])
    assert not np.allclose(clipped["test_loss"], loose["test_loss"])


@pytest.mark.parametrize("model", MODELS)
def test_split_at_round_one_is_the_whole_run_bitwise(model):
    st, sj = _tsetup(model), _jsetup(model)
    kw = _kwargs("FedAMW")
    inject = _inject(sj, "FedAMW")
    whole = T.FedAMW(st, **kw, **inject)
    first = T.FedAMW(st, **kw, stop_round=1, **inject)
    rest = T.FedAMW(st, **kw, start_round=1, resume_from=first, **inject)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(
            np.concatenate([first[k], rest[k]]), whole[k], err_msg=k)
    for k, v in whole["params"].items():
        assert torch.equal(rest["params"][k], v), k
    assert torch.equal(rest["p"], whole["p"])


def test_split_through_a_checkpoint_crosses_packages(tmp_path):
    """A conv FedAMW run split at round 1 through a checkpoint file: the
    JAX package reads the port's checkpoint (same keys, HWIO layouts and
    values), and the port resumed from it is the whole run bit for bit."""
    from fedamw_tpu.utils.checkpoint import load_checkpoint as jload

    from fedamw_tpu_torch.utils import load_checkpoint, save_checkpoint

    st, sj = _tsetup("conv4x8"), _jsetup("conv4x8")
    kw = _kwargs("FedAMW")
    inject = _inject(sj, "FedAMW")
    whole = T.FedAMW(st, **kw, **inject)
    first = T.FedAMW(st, **kw, stop_round=1, **inject)
    path = str(tmp_path / "ck")
    save_checkpoint(path, first["params"], p=first["p"], round_idx=1,
                    extra={"p_opt": first["p_opt"]})
    jck = jload(path)
    assert set(jck["params"]) == set(first["params"])
    for k, v in first["params"].items():
        np.testing.assert_array_equal(np.asarray(jck["params"][k]), _np(v))
    rest = T.FedAMW(st, **kw, start_round=1, resume_from=load_checkpoint(path),
                    **inject)
    for k, v in whole["params"].items():
        assert torch.equal(rest["params"][k], v), k
    np.testing.assert_array_equal(rest["test_loss"], whole["test_loss"][1:])


def test_streamed_tier_is_keyed_on_the_model():
    """The memoized shard tier of a streamed run is the model's own: the
    same configuration on another model builds another tier."""
    kw = _kwargs("FedAvg", round=1, cohort_shards=2, stream_cohort=True)
    T.FedAvg(_tsetup("mlp16"), **kw)
    tier = core._LAST_SHARD_TIER
    T.FedAvg(_tsetup("mlp16"), **kw)
    assert core._LAST_SHARD_TIER is tier
    T.FedAvg(_tsetup("conv4x8"), **kw)
    assert core._LAST_SHARD_TIER is not tier


