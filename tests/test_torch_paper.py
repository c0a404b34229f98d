"""The rest of the paper's experiment in the port against the JAX package,
on the CPU: Centralized, Distributed, FedAMW_OneShot and FedNova, and
what they are built from (FedNova's weights, the heterogeneity score,
the pooled train index set, the device shuffle draw).

Size: sklearn ``digits``, RFF D=64, J=4 clients, R=2 rounds of 2 local
epochs, so the one-shot phase and Centralized run 4 epochs. Every random
input is taken from the JAX run and injected: the RFF draw (through the
setup's arrays), the initial weights (``core._derive_params``), the
one-shot local phase's shuffles (``_keys(seed, J)`` -> ``split(key_j,
epoch)`` -> ``epoch_batches``), Centralized's (``PRNGKey(seed)`` ->
``split(., epoch)`` -> ``epoch_batches`` over all ``n`` pooled rows with
an all-ones mask), FedAMW_OneShot's p-epochs (``split(PRNGKey(seed + 1),
R)`` -> ``split(key_t, 1)`` -> ``epoch_batches``) and FedNova's rounds
(as ``tests/test_torch_slice.py`` derives them). The JAX side runs once
with its XLA kernels and once with both Pallas kernels in interpret
mode.

Tolerance: 1e-5 absolute and relative on every returned vector, as in
``tests/test_torch_slice.py`` (the same float32 arithmetic in another
summation order).

A ``cuda``-marked case runs the four algorithms on the card, through the
kernels, against the JAX package on the CPU at the main configuration.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.algorithms import Centralized as JCentralized
from fedamw_tpu.algorithms import Distributed as JDistributed
from fedamw_tpu.algorithms import FedAMW_OneShot as JFedAMW_OneShot
from fedamw_tpu.algorithms import FedNova as JFedNova
from fedamw_tpu.algorithms import prepare_setup as jprepare_setup
from fedamw_tpu.algorithms.core import _keys
from fedamw_tpu.config import get_parameter
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.fedcore.aggregate import (
    fednova_effective_weights as jfednova_effective_weights)
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.ops.rff import heterogeneity_from_parts as jheterogeneity
from fedamw_tpu_torch.algorithms import (
    ALGORITHMS,
    Centralized,
    Distributed,
    FedAMW_OneShot,
    FedNova,
    prepare_setup,
)
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.fedcore import (
    fednova_effective_weights,
    make_client_round,
    make_local_update,
)
from fedamw_tpu_torch.fedcore.batching import (
    batch_counts,
    batch_valid,
    draw_epoch_positions,
    epoch_batches,
)
from fedamw_tpu_torch.ops.rff import (
    data_heterogeneity,
    heterogeneity_from_parts,
)
from test_torch_slice import _pair
from torch_threads import one_torch_thread  # noqa: F401

SEED, R, LE, B, VB = 0, 2, 2, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)
ONESHOT = ("Centralized", "Distributed", "FedAMW_OneShot")

ALGOS = {
    "Centralized": (JCentralized, Centralized, dict(lr=0.5)),
    "Distributed": (JDistributed, Distributed, dict(lr=0.5)),
    "FedAMW_OneShot": (JFedAMW_OneShot, FedAMW_OneShot,
                       dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3, round=R)),
    "FedNova": (JFedNova, FedNova, dict(lr=0.5, round=R, epoch=LE)),
}


def _injections(sj, seed, rounds, local_epochs):
    """Every random input of the JAX runs of the four algorithms, derived
    from their keys: ``{algorithm: port keyword arguments}`` beside the
    port's setup on the CPU."""
    J, n_max = sj.idx.shape
    n_val = sj.X_val.shape[0]
    epochs = local_epochs * rounds
    st, inject, _ = _pair(sj, seed, rounds, local_epochs, "cpu")
    params0 = inject["params0"]
    keys = _keys(seed, J)
    oneshot_pos = np.stack([
        [np.asarray(jepoch_batches(k, n_max, B, sj.mask[j])[0])
         for k in jax.random.split(keys[j], epochs)] for j in range(J)])
    n = int(sj.all_train_idx.shape[0])
    central_pos = np.stack([
        np.asarray(jepoch_batches(k, n, B, jnp.ones(n, jnp.float32))[0])
        for k in jax.random.split(jax.random.PRNGKey(seed), epochs)])
    p_pos = np.stack([
        [np.asarray(jepoch_batches(k, n_val, VB)[0])
         for k in jax.random.split(key_t, 1)]
        for key_t in jax.random.split(jax.random.PRNGKey(seed + 1), rounds)])
    return st, {
        "Centralized": dict(params0=params0, client_positions=central_pos),
        "Distributed": dict(params0=params0, client_positions=oneshot_pos),
        "FedAMW_OneShot": dict(params0=params0, client_positions=oneshot_pos,
                               p_positions=p_pos),
        "FedNova": inject,
    }


@pytest.fixture(scope="module")
def pair():
    ds = jload_dataset("digits", num_partitions=4, alpha=0.5)
    sj = jprepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3))
    return (sj,) + _injections(sj, SEED, R, LE)


def _kwargs(algo):
    _, _, kw = ALGOS[algo]
    return dict(kw, seed=SEED, **({"epoch": LE * R} if algo in ONESHOT
                                  else {}))


@pytest.mark.parametrize("jax_kernels", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_paper_algorithm_matches_jax(pair, algo, jax_kernels, monkeypatch):
    sj, st, inject = pair
    jfn, tfn, _ = ALGOS[algo]
    kw = _kwargs(algo)
    monkeypatch.setenv("FEDAMW_KERNEL", jax_kernels)
    monkeypatch.setenv("FEDAMW_PSOLVER", jax_kernels)
    rj = jfn(sj, **kw)
    rt = tfn(st, **kw, **inject[algo])
    shape = () if algo in ("Centralized", "Distributed") else (R,)
    for k in ("train_loss", "test_loss", "test_acc"):
        want = shape if k != "train_loss" or algo == "FedNova" else ()
        assert rt[k].shape == want, (k, rt[k].shape)
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL, err_msg=k)


def test_fednova_state_matches_jax(pair):
    """FedNova's final weights, and its returned p (the sample-count
    weights, as the JAX package returns them)."""
    sj, st, inject = pair
    kw = dict(_kwargs("FedNova"), return_state=True)
    rj = JFedNova(sj, **kw)
    rt = FedNova(st, **kw, **inject["FedNova"])
    np.testing.assert_allclose(rt["params"]["w"].numpy(),
                               np.asarray(rj["params"]["w"]), **TOL)
    np.testing.assert_allclose(rt["p"].numpy(), np.asarray(rj["p"]), **TOL)


def test_one_shot_learned_weights_move(pair):
    """FedAMW_OneShot's p-epochs change the aggregate: its test loss is
    not Distributed's after the first p-epoch, and moves between
    iterations."""
    _, st, inject = pair
    os_ = FedAMW_OneShot(st, **_kwargs("FedAMW_OneShot"),
                         **inject["FedAMW_OneShot"])
    dl = Distributed(st, **dict(_kwargs("Distributed"), lambda_reg_if=True,
                                lambda_reg=5e-4),
                     **inject["Distributed"])
    assert not np.isclose(os_["test_loss"][0], dl["test_loss"])
    assert os_["test_loss"][0] != os_["test_loss"][1]


@pytest.mark.parametrize("tau_frac", [None, [1.0, 0.5, 1.0, 0.25, 0.0]])
def test_fednova_effective_weights_match_jax(tau_frac):
    """Including a padded client (size 0, weight 0) and a tau_frac row
    whose zero entry makes a client inert."""
    sizes = np.array([40, 0, 13, 7, 22], np.int32)
    p = np.array([0.5, 0.0, 0.2, 0.1, 0.2], np.float32)
    tf = None if tau_frac is None else np.asarray(tau_frac, np.float32)
    want = jfednova_effective_weights(jnp.asarray(sizes), jnp.asarray(p), 2,
                                      32, None if tf is None
                                      else jnp.asarray(tf))
    got = fednova_effective_weights(torch.from_numpy(sizes),
                                    torch.from_numpy(p), 2, 32,
                                    None if tf is None
                                    else torch.from_numpy(tf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert got[1] == 0
    assert np.all(np.isfinite(got.numpy()))


@pytest.mark.parametrize("J,alpha", [(4, 0.5), (7, 0.01)])
def test_heterogeneity_matches_jax(J, alpha):
    """On the mapped features of a digits setup and the FULL partitions
    (before the validation split), as the driver computes it."""
    ds = load_dataset("digits", J, alpha)
    st = prepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3),
                       device="cpu")
    want = jheterogeneity(st.X.numpy(), ds.parts)
    got = heterogeneity_from_parts(st.X, ds.parts)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_data_heterogeneity_is_zero_for_one_client_holding_all():
    X = torch.from_numpy(np.random.RandomState(0).randn(30, 5)
                         .astype(np.float32))
    idx = torch.arange(30)[None]
    mask = torch.ones(1, 30)
    assert float(data_heterogeneity(X, idx, mask)) < 1e-6


def test_all_train_idx_matches_jax(pair):
    sj, st, _ = pair
    got = st.all_train_idx
    assert got.dtype == torch.int64 and got.device == st.device
    np.testing.assert_array_equal(got.numpy(), np.asarray(sj.all_train_idx))
    assert got.numel() == int(st.sizes.sum())


@pytest.mark.parametrize("n,Bs,lead", [(10, 4, (3,)), (64, 32, (5,)),
                                       (53, 16, (2, 3)), (7, 32, (4,))])
def test_draw_epoch_positions_invariants(n, Bs, lead):
    """Every entry is one ``epoch_batches`` epoch: each valid row exactly
    once, valid rows first, masked rows after them, padding zeros at the
    back; the validity ``batch_valid`` derives is [1]*k + [0]*rest, as the
    per-row ``epoch_batches`` draw gives."""
    r = np.random.RandomState(n)
    mask = torch.from_numpy((r.rand(*lead, n) < 0.6).astype(np.float32))
    mask.reshape(-1, n)[:, 0] = 1.0
    pos = draw_epoch_positions(torch.Generator().manual_seed(1), n, Bs, mask,
                               lead=lead)
    S, pad = batch_counts(n, Bs)
    assert pos.shape == (*lead, S, Bs) and pos.dtype == torch.int64
    valid = batch_valid(pos, n, mask)
    for m, p, v in zip(mask.reshape(-1, n), pos.reshape(-1, S * Bs),
                       valid.reshape(-1, S * Bs)):
        k = int(m.sum())
        keep = torch.nonzero(m).flatten().sort().values
        drop = torch.nonzero(m == 0).flatten().sort().values
        assert torch.equal(p[:k].sort().values, keep)
        assert torch.equal(p[k:n].sort().values, drop)
        assert torch.all(p[n:] == 0) and p[n:].numel() == pad
        assert v.tolist() == [1.0] * k + [0.0] * (S * Bs - k)
        p1, v1 = epoch_batches(n, Bs, m,
                               generator=torch.Generator().manual_seed(2))
        assert torch.equal(p1.reshape(-1)[:k].sort().values, keep)
        assert torch.equal(v1.reshape(-1), v)


def test_draw_epoch_positions_without_mask_is_a_permutation():
    pos = draw_epoch_positions(torch.Generator().manual_seed(3), 50, 16,
                               lead=(4,))
    for p in pos.reshape(4, -1):
        assert torch.equal(p[:50].sort().values, torch.arange(50))
        assert torch.all(p[50:] == 0)


def test_draw_epoch_positions_repeat_from_their_seed():
    mask = torch.ones(3, 40)
    a, b, c = (draw_epoch_positions(torch.Generator().manual_seed(s), 40, 8,
                                    mask, lead=(3,)) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the clients of one draw are shuffled independently
    assert not torch.equal(a[0], a[1])


def test_client_round_draws_each_epoch_as_injected_positions_would(pair):
    """A generator draws epoch e's (J, S, B) just before epoch e: the same
    as injecting the stack of those draws, bit for bit."""
    _, st, _ = pair
    J, n_max = st.idx.shape
    epochs = 3
    round_fn = make_client_round(st.task, epochs, B, n_max)
    w0 = {"w": torch.zeros(st.num_classes, st.D)}
    gen = torch.Generator().manual_seed(9)
    stacked = torch.stack([draw_epoch_positions(gen, n_max, B, st.mask,
                                                lead=(J,))
                           for _ in range(epochs)], dim=1)
    a = round_fn(w0, st.X, st.y, st.idx, st.mask,
                 torch.Generator().manual_seed(9), 0.5, 0.0, 0.0)
    b = round_fn(w0, st.X, st.y, st.idx, st.mask, stacked, 0.5, 0.0, 0.0)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert torch.equal(a[0]["w"], b[0]["w"])
    with pytest.raises(ValueError, match="positions shape"):
        round_fn(w0, st.X, st.y, st.idx, st.mask, stacked[:, :2], 0.5, 0.0,
                 0.0)


def test_local_update_takes_a_generator(pair):
    _, st, _ = pair
    n = st.n_max
    lu = make_local_update(st.task, 2, B, n)
    w0 = {"w": torch.zeros(st.num_classes, st.D)}
    args = (st.X, st.y, st.idx[0], st.mask[0])
    gen = torch.Generator().manual_seed(4)
    pos = torch.cat([draw_epoch_positions(gen, n, B, st.mask[0][None],
                                          lead=(1,)) for _ in range(2)])
    a = lu(w0, *args, torch.Generator().manual_seed(4), 0.5, 0.0, 0.0)
    b = lu(w0, *args, pos, 0.5, 0.0, 0.0)
    assert torch.equal(a[0]["w"], b[0]["w"]) and a[1] == b[1]


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_paper_algorithm_draws_its_own_randomness_deterministically(pair,
                                                                    algo):
    """With nothing injected, the same seed repeats bit for bit and
    another seed differs."""
    _, st, _ = pair
    _, tfn, _ = ALGOS[algo]
    kw = dict(_kwargs(algo), epoch=2 if algo in ONESHOT else 1)
    kw.pop("seed")
    a, b, c = (tfn(st, seed=s, **kw) for s in (5, 5, 6))
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])
        assert np.all(np.isfinite(a[k]))
    assert not np.array_equal(a["train_loss"], c["train_loss"])


@pytest.mark.parametrize("algo", ONESHOT)
@pytest.mark.parametrize("opt,value,exc", [
    ("participation", 0.5, ValueError), ("faults", "drop=0.1", ValueError),
    ("robust_agg", "median", ValueError),
    ("no_such_option", 1, TypeError)])
def test_one_shot_options_are_refused(pair, algo, opt, value, exc):
    _, st, _ = pair
    with pytest.raises(exc):
        ALGOS[algo][1](st, epoch=1, **{opt: value})


@pytest.mark.parametrize("algo", ONESHOT)
@pytest.mark.parametrize("opt,value", [("cohort_shards", 2),
                                       ("stream_cohort", True)])
def test_one_shot_algorithms_ignore_the_cohort_plane(pair, algo, opt, value):
    """The cohort plane is a round-loop option: the one-shot algorithms
    take it and run as without it, as the JAX package's swallow it."""
    _, st, _ = pair
    fn = ALGOS[algo][1]
    kw = dict(epoch=1, seed=3, **({"round": 2} if algo == "FedAMW_OneShot"
                                  else {}))
    a = fn(st, **kw)
    b = fn(st, **kw, **{opt: value})
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])


def test_registry_holds_all_seven_jax_names():
    from fedamw_tpu.algorithms import ALGORITHMS as JALGORITHMS

    assert set(ALGORITHMS) == set(JALGORITHMS) == {
        "Centralized", "Distributed", "FedAMW_OneShot", "FedAvg", "FedProx",
        "FedNova", "FedAMW"}


@pytest.mark.cuda
def test_paper_algorithms_on_card_match_jax_at_main_config():
    """Centralized, Distributed, FedAMW_OneShot and FedNova as
    ``chip_smoke.py``'s ``paper_algorithms`` phase runs them (the
    mnist-shaped stand-in, RFF D=2000, J=50, Dirichlet 0.01, the
    registry's hyper-parameters, R=3 and local_epoch 2, seed 100): the
    port on the card, through both kernels, against the JAX package on
    the CPU with every random input injected. Tolerance is
    ``chip_smoke.py``'s ``TOL_RUN``: losses 1e-4 relative, accuracy 0.05
    points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    from fedamw_tpu_torch.convert import setup_from_arrays

    seed, rounds, local = 100, 3, 2
    prm = get_parameter("mnist")
    ds = jload_dataset("mnist", num_partitions=50, alpha=prm["alpha_Dirk"])
    sj = jprepare_setup(ds, D=2000, kernel_par=prm["kernel_par"], seed=seed,
                        rng=np.random.RandomState(seed))
    _, inject = _injections(sj, seed, rounds, local)
    st = setup_from_arrays(
        task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
        X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test, y_test=sj.y_test,
        idx=sj.idx, mask=sj.mask, sizes=sj.sizes, p_fixed=sj.p_fixed,
        rff=sj.rff, device="cuda")
    epochs = local * rounds
    runs = {
        "Centralized": dict(lr=prm["lr"], epoch=epochs),
        "Distributed": dict(lr=prm["lr"], epoch=epochs),
        "FedAMW_OneShot": dict(lr=prm["lr"], epoch=epochs,
                               lambda_reg=prm["lambda_reg_os"],
                               lr_p=prm["lr_p_os"], round=rounds),
        "FedNova": dict(lr=prm["lr"], epoch=local, round=rounds,
                        lr_mode="constant"),
    }
    report = {"source": ds.source}
    for name, kw in runs.items():
        jfn, tfn, _ = ALGOS[name]
        rj = jfn(sj, seed=seed, **kw)
        rt = tfn(st, seed=seed, **kw, **inject[name])
        report[name] = {k: {"jax": np.asarray(rj[k]).tolist(),
                            "port": rt[k].tolist()}
                        for k in ("train_loss", "test_loss", "test_acc")}
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=1e-4,
                                       atol=0, err_msg=f"{name} {k}")
        np.testing.assert_allclose(rt["test_acc"], np.asarray(rj["test_acc"]),
                                   rtol=0, atol=0.05, err_msg=name)
    print(json.dumps({"paper_algorithms_vs_jax": report}), flush=True)
