"""The port's main path end to end against the JAX package, on the CPU.

FedAvg, FedProx and FedAMW on sklearn's ``digits`` (RFF D=64, J=4
clients, 2 rounds of 2 local epochs). Everything random is taken from
the JAX run and injected into the port: the RFF draw (through the
setup's arrays), the initial weights (``core._derive_params``), every
client's per-epoch shuffle (``core._keys`` -> ``split(key, epochs)`` ->
``epoch_batches``, as ``client.py:221,260`` draw them) and every
p-solver epoch's shuffle (``split(PRNGKey(seed + 1), rounds)`` ->
``split(pkey_t, rounds)`` -> ``epoch_batches``, ``core.py:420`` and
``aggregate.py:366``). The JAX side runs once with its XLA kernels and
once with both Pallas kernels in interpret mode.

Tolerance: both sides do the same float32 arithmetic and differ only in
summation order, so per-round losses, accuracies, final weights and
mixture weights must agree to 1e-5 (absolute and relative) — about 40
float32 ulps of the O(1) losses; observed differences are a few ulps.

A ``cuda``-marked case does the same at the main path's configuration
(the mnist-shaped stand-in, D=2000, J=50, Dirichlet 0.01, 3 rounds) with
the port on the card, through its kernels, and the JAX package on the
CPU; it prints both runs' metrics as one JSON line (``pytest -s``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from fedamw_tpu.algorithms import FedAMW as JFedAMW
from fedamw_tpu.algorithms import FedAvg as JFedAvg
from fedamw_tpu.algorithms import FedProx as JFedProx
from fedamw_tpu.algorithms import prepare_setup as jprepare_setup
from fedamw_tpu.algorithms.core import _derive_params, _keys
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.config import get_parameter
from fedamw_tpu_torch.algorithms import FedAMW, FedAvg, FedProx
from fedamw_tpu_torch.convert import params_from_jax, setup_from_arrays

SEED, ROUNDS, EPOCHS, B, VB = 0, 2, 2, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)

ALGOS = {
    "FedAvg": (JFedAvg, FedAvg, dict(lr=0.5)),
    "FedProx": (JFedProx, FedProx, dict(lr=0.5, mu=0.01)),
    "FedAMW": (JFedAMW, FedAMW, dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3)),
}


def _pair(sj, seed, rounds, epochs, device):
    """The port's setup on ``device`` built from the JAX setup ``sj``'s
    arrays, and every random input of a JAX run re-derived for injection:
    ``(st, inject, p_positions)``."""
    J, n_max = sj.idx.shape
    n_val = sj.X_val.shape[0]
    params0 = _derive_params(sj.model.init, seed, sj.D, sj.num_classes)
    keys = _keys(seed, rounds, J)
    client_pos = np.stack([[
        [np.asarray(jepoch_batches(k, n_max, B, sj.mask[j])[0])
         for k in jax.random.split(keys[t, j], epochs)]
        for j in range(J)] for t in range(rounds)])
    pkeys = jax.random.split(jax.random.PRNGKey(seed + 1), rounds)
    p_pos = np.stack([
        [np.asarray(jepoch_batches(k, n_val, VB)[0])
         for k in jax.random.split(pkeys[t], rounds)]
        for t in range(rounds)])
    st = setup_from_arrays(
        task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
        X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test, y_test=sj.y_test,
        idx=sj.idx, mask=sj.mask, sizes=sj.sizes, p_fixed=sj.p_fixed,
        rff=sj.rff, device=device)
    inject = dict(params0=params_from_jax(params0), client_positions=client_pos)
    return st, inject, p_pos


@pytest.fixture(scope="module")
def pair():
    ds = jload_dataset("digits", num_partitions=4, alpha=0.5)
    sj = jprepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3))
    return (sj,) + _pair(sj, SEED, ROUNDS, EPOCHS, "cpu")


@pytest.mark.parametrize("jax_kernels", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_port_round_loop_matches_jax(pair, algo, jax_kernels, monkeypatch):
    sj, st, inject, p_pos = pair
    jfn, tfn, kw = ALGOS[algo]
    kw = dict(kw, epoch=EPOCHS, round=ROUNDS, seed=SEED, return_state=True)
    monkeypatch.setenv("FEDAMW_KERNEL", jax_kernels)
    monkeypatch.setenv("FEDAMW_PSOLVER", jax_kernels)
    rj = jfn(sj, **kw)
    if algo == "FedAMW":
        inject = dict(inject, p_positions=p_pos)
    rt = tfn(st, **kw, **inject)
    for k in ("train_loss", "test_loss", "test_acc"):
        assert rt[k].shape == (ROUNDS,)
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(rt["params"]["w"].numpy(),
                               np.asarray(rj["params"]["w"]), **TOL)
    np.testing.assert_allclose(rt["p"].numpy(), np.asarray(rj["p"]), **TOL)
    assert ("mixture" in rt) == ("mixture" in rj) == (algo == "FedAMW")
    if algo == "FedAMW":
        for k in ("p_entropy", "p_max"):
            np.testing.assert_allclose(rt["mixture"][k],
                                       np.asarray(rj["mixture"][k]), **TOL,
                                       err_msg=k)
        # the learned p moved away from the sample-count weights
        assert not np.allclose(rt["p"].numpy(), st.p_fixed.numpy())
        np.testing.assert_allclose(
            rt["p_opt"][0].numpy(),
            np.asarray(jax.tree_util.tree_leaves(rj["p_opt"])[0]), **TOL)


def test_port_draws_its_own_randomness_deterministically(pair):
    """With nothing injected the port seeds torch generators: the same
    seed repeats bit for bit, another seed differs."""
    _, st, _, _ = pair
    kw = dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3, epoch=1, round=2)
    a = FedAMW(st, seed=5, **kw)
    b = FedAMW(st, seed=5, **kw)
    c = FedAMW(st, seed=6, **kw)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])
        assert np.all(np.isfinite(a[k]))
    assert not np.array_equal(a["test_loss"], c["test_loss"])


@pytest.mark.parametrize("opt,value", [
    ("cohort_shards", 2), ("stream_cohort", True)])
def test_waiting_options_raise(pair, opt, value):
    """The cohort plane's options are carried now: set alone, a shard count
    past the cohort and streaming without a shard count still raise, with
    the JAX package's messages."""
    _, st, _, _ = pair
    bad = {"cohort_shards": st.num_clients + value,
           "stream_cohort": value}[opt]
    msg = {"cohort_shards": "exceeds the cohort",
           "stream_cohort": "needs cohort_shards >= 1"}[opt]
    with pytest.raises(ValueError, match=msg):
        FedAvg(st, round=1, **{opt: bad})


def test_unknown_option_is_a_type_error(pair):
    _, st, _, _ = pair
    with pytest.raises(TypeError, match="no_such_option"):
        FedAMW(st, round=1, no_such_option=1)


@pytest.mark.cuda
def test_port_on_card_matches_jax_at_main_config():
    """FedAvg and FedAMW as ``chip_smoke.py`` runs them (the mnist-shaped
    stand-in, RFF D=2000, J=50, Dirichlet 0.01, the registry's lr / lr_p
    / lambda, 3 rounds of 2 epochs at a constant lr, seed 100): the port
    on the card, through both kernels, against the JAX package on the
    CPU with every random input injected. Tolerance is ``chip_smoke.py``'s
    ``TOL_RUN`` — per-round losses 1e-4 relative, accuracy 0.05 points,
    final weights and p 1e-4 — since three rounds of lr-0.5 SGD and nine
    p-epochs carry two fp32 routes' summation-order differences."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    from fedamw_tpu_torch.fedcore import client_epoch, p_epoch

    seed, rounds, epochs = 100, 3, 2
    prm = get_parameter("mnist")
    ds = jload_dataset("mnist", num_partitions=50, alpha=prm["alpha_Dirk"])
    sj = jprepare_setup(ds, D=2000, kernel_par=prm["kernel_par"], seed=seed,
                        rng=np.random.RandomState(seed))
    st, inject, p_pos = _pair(sj, seed, rounds, epochs, "cuda")
    kw = dict(lr=prm["lr"], epoch=epochs, batch_size=B, round=rounds,
              seed=seed, lr_mode="constant", return_state=True)
    runs = {"FedAvg": (JFedAvg, FedAvg, kw, inject),
            "FedAMW": (JFedAMW, FedAMW,
                       dict(kw, lambda_reg=prm["lambda_reg"],
                            lr_p=prm["lr_p"], val_batch_size=VB),
                       dict(inject, p_positions=p_pos))}
    report = {"source": ds.source}
    for name, (jfn, tfn, akw, inj) in runs.items():
        rj = jfn(sj, **akw)
        before = (client_epoch.launches, p_epoch.launches)
        rt = tfn(st, **akw, **inj)
        torch.cuda.synchronize()
        launched = (client_epoch.launches - before[0],
                    p_epoch.launches - before[1])
        assert launched == (rounds * epochs,
                            rounds * rounds if name == "FedAMW" else 0)
        side = {}
        for k in ("train_loss", "test_loss", "test_acc"):
            side[k] = {"jax": np.asarray(rj[k]).tolist(),
                       "port": rt[k].tolist()}
        side["p_sum"] = {"jax": float(np.sum(rj["p"])),
                         "port": float(rt["p"].sum())}
        report[name] = side
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=1e-4,
                                       atol=0, err_msg=k)
        np.testing.assert_allclose(rt["test_acc"], np.asarray(rj["test_acc"]),
                                   rtol=0, atol=0.05)
        np.testing.assert_allclose(rt["params"]["w"].cpu().numpy(),
                                   np.asarray(rj["params"]["w"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(rt["p"].cpu().numpy(), np.asarray(rj["p"]),
                                   rtol=0, atol=1e-4)
        if name == "FedAMW":
            for k in ("p_entropy", "p_max"):
                np.testing.assert_allclose(rt["mixture"][k],
                                           np.asarray(rj["mixture"][k]),
                                           rtol=1e-4, atol=0, err_msg=k)
    print(json.dumps({"main_config_vs_jax": report}), flush=True)
