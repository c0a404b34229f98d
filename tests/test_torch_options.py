"""The round loop's options in the port against the JAX package, on the CPU.

``sequential=True`` (the reference's client chain), size buckets
(``prepare_setup(buckets=)``), the p-guards, ``participation < 1``, the
server optimizers and round resume, on three small setups: sklearn
``digits`` (10 classes, J=6, RFF D=64), the ``dna`` stand-in (3
classes, J=5, D=32) and ``synthetic_nonlinear`` (regression, J=4,
D=32), 2 rounds of 2 local epochs (3 rounds where a run is split).

Every random input is taken from the JAX run and injected, as in
``tests/test_torch_slice.py``: the RFF draw (through the setup's
arrays), the initial weights, each client's per-epoch shuffle
(``_keys(seed, R, J)[t, j]`` -> ``split(., epoch)`` -> ``epoch_batches``,
in bucket order and with each bucket's own ``n_max`` on a bucketed
setup, one array per bucket), FedAMW's p-epoch shuffles and the
participation draws (``split(PRNGKey(seed + 2), R)`` -> ``uniform(key_t,
(J,)) < participation``, ``core.py:253-300``). The JAX runs use their
XLA kernels: the Pallas kernels are held in ``tests/test_torch_slice.py``
and a guarded solve never reaches them.

Tolerance: 1e-5 absolute and relative on every returned vector (as in
``tests/test_torch_slice.py``); a split run is held to the uninterrupted
run bit for bit. The ``cuda``-marked case runs each option on the card
at the main configuration against the JAX package on the CPU.
"""

import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fedamw_tpu.algorithms as J
from fedamw_tpu.algorithms.core import _derive_params, _keys
from fedamw_tpu.config import get_parameter
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.data.pack import bucket_partitions as jbucket_partitions
from fedamw_tpu.fedcore.aggregate import (
    participation_weights as jparticipation_weights,
    project_simplex as jproject_simplex,
    resolve_p_guard as jresolve_p_guard,
)
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch.algorithms.core import round_seed
from fedamw_tpu_torch.convert import params_from_jax, setup_from_arrays
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.data.pack import bucket_partitions
from fedamw_tpu_torch.fedcore import (
    ServerOptimizer,
    p_epoch,
    participation_weights,
    project_simplex,
    resolve_p_guard,
)
from fedamw_tpu_torch.fedcore.aggregate import make_guard
from fedamw_tpu_torch.fedcore.batching import batch_valid
from torch_threads import one_torch_thread  # noqa: F401

SEED, R, LE, B, VB = 0, 2, 2, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)
ROUND_LOOP = ("FedAvg", "FedProx", "FedNova", "FedAMW")
# name -> (dataset, J, alpha, D, lr)
DATA = {"cls10": ("digits", 6, 0.5, 64, 0.5),
        "cls3": ("dna", 5, 0.5, 32, 0.5),
        "reg": ("synthetic_nonlinear", 4, 1.0, 32, 1e-3)}


@functools.lru_cache(maxsize=None)
def _jsetup(data, buckets=1):
    name, Jn, alpha, D, _ = DATA[data]
    ds = jload_dataset(name, num_partitions=Jn, alpha=alpha)
    return J.prepare_setup(ds, D=D, seed=3, rng=np.random.RandomState(3),
                           buckets=buckets)


@functools.lru_cache(maxsize=None)
def _tsetup(data, buckets=1):
    sj = _jsetup(data, buckets)
    idx, mask = sj.round_arrays()
    if buckets == 1:
        idx, mask = idx[0], mask[0]
    return setup_from_arrays(
        task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
        X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test, y_test=sj.y_test,
        idx=idx, mask=mask, sizes=sj.sizes, p_fixed=sj.p_fixed, rff=sj.rff,
        device="cpu")


def _client_positions(sj, seed, rounds, epochs):
    """One ``(rounds, J_g, epochs, S_g, B)`` array per bucket, from the
    JAX run's round keys in bucket order."""
    keys = _keys(seed, rounds, sj.num_clients)
    out, off = [], 0
    for idx_g, mask_g in zip(*sj.round_arrays()):
        Jg, n_g = idx_g.shape
        out.append(np.stack([[
            [np.asarray(jepoch_batches(k, n_g, B, mask_g[j])[0])
             for k in jax.random.split(keys[t, off + j], epochs)]
            for j in range(Jg)] for t in range(rounds)]))
        off += Jg
    return out


def _p_positions(sj, seed, rounds, per_round):
    n_val = sj.X_val.shape[0]
    return np.stack([
        [np.asarray(jepoch_batches(k, n_val, VB)[0])
         for k in jax.random.split(key_t, per_round)]
        for key_t in jax.random.split(jax.random.PRNGKey(seed + 1), rounds)])


def _participation_masks(sj, seed, rounds, participation):
    return np.stack([
        np.asarray(jax.random.uniform(k, (sj.num_clients,)) < participation)
        for k in jax.random.split(jax.random.PRNGKey(seed + 2), rounds)])


def _inject(sj, algo, seed=SEED, rounds=R, epochs=LE, participation=None):
    """The port's keyword arguments that put it on the JAX run's draws."""
    kw = dict(params0=params_from_jax(_derive_params(
        sj.model.init, seed, sj.D, sj.num_classes)),
        client_positions=_client_positions(sj, seed, rounds, epochs))
    if algo == "FedAMW":
        kw["p_positions"] = _p_positions(sj, seed, rounds, rounds)
    if participation is not None:
        kw["participation_masks"] = _participation_masks(
            sj, seed, rounds, participation)
    return kw


def _kwargs(algo, data, **extra):
    lr = DATA[data][4]
    kw = dict(lr=lr, epoch=LE, round=R, seed=SEED, lr_mode="constant",
              return_state=True)
    if algo == "FedProx":
        kw["mu"] = 0.01
    if algo == "FedAMW":
        kw.update(lambda_reg=5e-4, lr_p=5e-3 if lr > 0.1 else 1e-5)
    kw.update(extra)
    return kw


def _leaves(x):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(x)]


def _assert_match(rt, rj):
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL,
                                   err_msg=k)
        assert np.all(np.isfinite(rt[k])), k
    _assert_mixture(rt, rj)
    _assert_state(rt, rj)


def _assert_mixture(rt, rj):
    """FedAMW's per-round mixture record, where the JAX run has one."""
    assert ("mixture" in rt) == ("mixture" in rj)
    if "mixture" in rj:
        assert set(rt["mixture"]) == set(rj["mixture"]) == {"p_entropy",
                                                            "p_max"}
        for k, v in rj["mixture"].items():
            assert rt["mixture"][k].shape == np.shape(v), k
            np.testing.assert_allclose(rt["mixture"][k], np.asarray(v),
                                       **TOL, err_msg=k)


def _assert_state(rt, rj):
    np.testing.assert_allclose(rt["params"]["w"].numpy(),
                               np.asarray(rj["params"]["w"]), **TOL)
    np.testing.assert_allclose(rt["p"].numpy(), np.asarray(rj["p"]), **TOL)
    for key in ("p_opt", "server_opt"):
        assert (key in rt) == (key in rj), key
        if key in rt:
            for a, b in zip(_leaves(rj[key]), rt[key]):
                np.testing.assert_allclose(b.numpy(), a, **TOL, err_msg=key)


def _both(algo, data, buckets=1, participation=None, **extra):
    """The JAX run and the port's on the same draws."""
    sj, st = _jsetup(data, buckets), _tsetup(data, buckets)
    kw = _kwargs(algo, data, **extra)
    if participation is not None:
        kw["participation"] = participation
    rj = getattr(J, algo)(sj, **kw)
    inject = _inject(sj, algo, participation=participation)
    rt = getattr(T, algo)(st, **kw, **inject)
    return rt, rj


# -- j. sequential=True ----------------------------------------------------


@pytest.mark.parametrize("data", ["cls10", "reg"])
@pytest.mark.parametrize("algo", ROUND_LOOP)
def test_sequential_round_loop_matches_jax(algo, data):
    rt, rj = _both(algo, data, sequential=True)
    _assert_match(rt, rj)


def test_sequential_chains_clients():
    """Under the chain the clients' final weights differ from the
    parallel round's, and each client's local run is one J = 1 call per
    epoch: client j's weights are what a one-client round from client
    j-1's weights gives."""
    st = _tsetup("cls10")
    kw = _kwargs("FedAvg", "cls10", round=1)
    par = T.FedAvg(st, **kw)
    seq = T.FedAvg(st, sequential=True, **kw)
    assert not np.allclose(par["test_loss"], seq["test_loss"])

    from fedamw_tpu_torch.fedcore import make_client_round

    Jn, n_max = st.idx.shape
    pos = torch.as_tensor(_client_positions(_jsetup("cls10"), SEED, 1,
                                            LE)[0][0])
    w0 = {"w": torch.zeros(st.num_classes, st.D)}
    chain = make_client_round(st.task, LE, B, n_max, sequential=True)
    one = make_client_round(st.task, LE, B, n_max)
    stacked, losses, _ = chain(w0, st.X, st.y, st.idx, st.mask, pos, 0.5,
                               0.01, 0.0)
    carry = w0
    for j in range(Jn):
        s_j, l_j, _ = one(carry, st.X, st.y, st.idx[j:j + 1],
                          st.mask[j:j + 1], pos[j:j + 1], 0.5, 0.01, 0.0)
        assert torch.equal(s_j["w"][0], stacked["w"][j])
        assert torch.equal(l_j[0], losses[j])
        carry = {"w": s_j["w"][0]}


@pytest.mark.parametrize("algo", ["Distributed", "FedAMW_OneShot"])
def test_sequential_one_shot_matches_jax(algo):
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    kw = dict(lr=0.5, epoch=2, seed=SEED, sequential=True)
    if algo == "FedAMW_OneShot":
        kw.update(lambda_reg=5e-4, lr_p=5e-3, round=R)
    rj = getattr(J, algo)(sj, **kw)
    keys = _keys(SEED, sj.num_clients)
    pos = np.stack([
        [np.asarray(jepoch_batches(k, sj.idx.shape[1], B, sj.mask[j])[0])
         for k in jax.random.split(keys[j], 2)]
        for j in range(sj.num_clients)])
    inject = dict(params0=params_from_jax(_derive_params(
        sj.model.init, SEED, sj.D, sj.num_classes)), client_positions=pos)
    if algo == "FedAMW_OneShot":
        inject["p_positions"] = _p_positions(sj, SEED, R, 1)
    rt = getattr(T, algo)(st, **kw, **inject)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL,
                                   err_msg=k)
    plain = getattr(T, algo)(st, **dict(kw, sequential=False), **inject)
    assert not np.allclose(plain["test_loss"], rt["test_loss"])


def test_centralized_takes_sequential_and_ignores_it():
    st = _tsetup("cls10")
    a = T.Centralized(st, lr=0.5, epoch=1, seed=4)
    b = T.Centralized(st, lr=0.5, epoch=1, seed=4, sequential=True)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])


def test_sequential_refuses_partial_participation():
    st = _tsetup("cls10")
    with pytest.raises(ValueError, match="cannot compose with participation"):
        T.FedAvg(st, round=1, sequential=True, participation=0.5)


# -- a. buckets ------------------------------------------------------------


@pytest.mark.parametrize("num_buckets,multiple", [(1, 1), (2, 1), (3, 1),
                                                  (3, 2), (9, 4)])
def test_bucket_partitions_match_jax(num_buckets, multiple):
    r = np.random.RandomState(num_buckets)
    parts = [np.arange(n) + 100 * i for i, n in
             enumerate(r.randint(0, 40, size=7))]
    a, sa = jbucket_partitions(parts, num_buckets, multiple)
    b, sb = bucket_partitions(parts, num_buckets, multiple)
    np.testing.assert_array_equal(sa, sb)
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        for f in ("idx", "mask", "sizes"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))


@pytest.mark.parametrize("buckets,multiple", [(3, 1), (2, 4), (1, 4)])
def test_bucketed_setup_matches_jax(buckets, multiple):
    ds = load_dataset("digits", 6, 0.5)
    jds = jload_dataset("digits", num_partitions=6, alpha=0.5)
    sj = J.prepare_setup(jds, D=16, seed=3, rng=np.random.RandomState(3),
                         buckets=buckets, client_multiple=multiple)
    st = T.prepare_setup(ds, D=16, seed=3, rng=np.random.RandomState(3),
                         buckets=buckets, client_multiple=multiple,
                         device="cpu")
    assert st.n_maxes == sj.n_maxes
    assert st.bucket_counts == sj.bucket_counts
    for a, b in zip(sj.round_arrays(), st.round_arrays()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(sj.sizes), st.sizes.numpy())
    np.testing.assert_array_equal(np.asarray(sj.p_fixed), st.p_fixed.numpy())
    np.testing.assert_array_equal(np.asarray(sj.all_train_idx),
                                  st.all_train_idx.numpy())
    assert (st.bucket_idx is None) == (buckets == 1)


def test_bucketed_setup_refuses_client_padding():
    ds = load_dataset("digits", 6, 0.5)
    with pytest.raises(ValueError, match="incompatible with pad_clients_to"):
        T.prepare_setup(ds, D=16, buckets=2, pad_clients_to=8, device="cpu")


def test_setup_pads_clients_and_samples_like_jax():
    ds = load_dataset("digits", 5, 0.5)
    jds = jload_dataset("digits", num_partitions=5, alpha=0.5)
    sj = J.prepare_setup(jds, D=16, seed=3, rng=np.random.RandomState(3),
                         pad_clients_to=7, n_max=400)
    st = T.prepare_setup(ds, D=16, seed=3, rng=np.random.RandomState(3),
                         pad_clients_to=7, n_max=400, device="cpu")
    assert st.idx.shape == sj.idx.shape == (7, 400)
    np.testing.assert_array_equal(np.asarray(sj.mask), st.mask.numpy())
    np.testing.assert_array_equal(np.asarray(sj.p_fixed), st.p_fixed.numpy())


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("algo", ROUND_LOOP)
def test_buckets_match_jax(algo, sequential):
    rt, rj = _both(algo, "cls10", buckets=3, sequential=sequential)
    _assert_match(rt, rj)


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("algo", ["Distributed", "FedAMW_OneShot"])
def test_buckets_one_shot_matches_jax(algo, sequential):
    """The one-shot phase on a bucketed setup: each bucket's shuffles
    from ``_keys(seed, J)`` in bucket order, one array per bucket."""
    sj, st = _jsetup("cls10", 3), _tsetup("cls10", 3)
    kw = dict(lr=0.5, epoch=2, seed=SEED, sequential=sequential)
    if algo == "FedAMW_OneShot":
        kw.update(lambda_reg=5e-4, lr_p=5e-3, round=R)
    rj = getattr(J, algo)(sj, **kw)
    keys = _keys(SEED, sj.num_clients)
    pos, off = [], 0
    for idx_g, mask_g in zip(*sj.round_arrays()):
        Jg, n_g = idx_g.shape
        pos.append(np.stack([
            [np.asarray(jepoch_batches(k, n_g, B, mask_g[j])[0])
             for k in jax.random.split(keys[off + j], 2)]
            for j in range(Jg)]))
        off += Jg
    inject = dict(params0=params_from_jax(_derive_params(
        sj.model.init, SEED, sj.D, sj.num_classes)), client_positions=pos)
    if algo == "FedAMW_OneShot":
        inject["p_positions"] = _p_positions(sj, SEED, R, 1)
    rt = getattr(T, algo)(st, **kw, **inject)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL,
                                   err_msg=k)


def test_bucketed_round_runs_each_bucket_at_its_own_size(monkeypatch):
    """One epoch call per bucket per local epoch, each at that bucket's
    step count."""
    from fedamw_tpu_torch.fedcore import client as client_mod

    st = _tsetup("cls10", 3)
    seen = []
    plain = client_mod.client_epoch

    def spy(W, anchor, X, y, rows, *a, **kw):
        seen.append(tuple(rows.shape))
        return plain(W, anchor, X, y, rows, *a, **kw)

    monkeypatch.setattr(client_mod, "client_epoch", spy)
    T.FedAvg(st, lr=0.5, epoch=2, round=1, seed=1)
    want = [(Jg, -(-n // B), B) for Jg, n in zip(st.bucket_counts,
                                                st.n_maxes)
            for _ in range(2)]
    assert seen == want
    assert len(set(st.n_maxes)) > 1


# -- c. p-guards -----------------------------------------------------------


@pytest.mark.parametrize("guard", ["simplex", "clip", "clip:0.5"])
@pytest.mark.parametrize("algo", ["FedAMW", "FedAMW_OneShot"])
def test_p_guard_matches_jax(algo, guard, monkeypatch):
    """The JAX package takes the guard from ``FEDAMW_P_GUARD``; the port
    as an argument."""
    sj, st = _jsetup("cls3"), _tsetup("cls3")
    monkeypatch.setenv("FEDAMW_P_GUARD", guard)
    if algo == "FedAMW":
        rt, rj = _both(algo, "cls3", p_guard=guard)
        _assert_match(rt, rj)
        p = rt["p"].numpy()
    else:
        kw = dict(lr=0.5, epoch=2, seed=SEED, lambda_reg=5e-4, lr_p=5e-2,
                  round=R)
        rj = J.FedAMW_OneShot(sj, **kw)
        keys = _keys(SEED, sj.num_clients)
        pos = np.stack([
            [np.asarray(jepoch_batches(k, sj.idx.shape[1], B,
                                       sj.mask[j])[0])
             for k in jax.random.split(keys[j], 2)]
            for j in range(sj.num_clients)])
        rt = T.FedAMW_OneShot(
            st, p_guard=guard, **kw, client_positions=pos,
            p_positions=_p_positions(sj, SEED, R, 1),
            params0=params_from_jax(_derive_params(
                sj.model.init, SEED, sj.D, sj.num_classes)))
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL)
        p = None
    if p is not None and guard == "simplex":
        assert np.all(p >= 0) and abs(p.sum() - 1) < 1e-6
    if p is not None and guard.startswith("clip"):
        radius = float(guard.split(":")[1]) if ":" in guard else 1.0
        assert np.linalg.norm(p) <= radius * (1 + 1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_project_simplex_matches_jax(seed):
    r = np.random.RandomState(seed)
    v = (r.randn(9) * 2).astype(np.float32)
    valid = (r.rand(9) < 0.7).astype(np.float32)
    valid[0] = 1.0
    for vm in (None, valid):
        want = np.asarray(jproject_simplex(
            jnp.asarray(v), None if vm is None else jnp.asarray(vm)))
        got = project_simplex(torch.from_numpy(v), None if vm is None
                              else torch.from_numpy(vm)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert abs(got.sum() - 1) < 1e-6 and np.all(got >= 0)
        if vm is not None:
            assert np.all(got[vm == 0] == 0)


@pytest.mark.parametrize("value", ["none", "simplex", "clip", "clip:2.5",
                                   "auto", "clip:0", "clip:-1", "clip:nan",
                                   "clip:inf", "clip:x", "box"])
def test_resolve_p_guard_like_jax(value, monkeypatch):
    """Accepted and refused as the JAX package does; ``"auto"`` (its
    environment-variable sentinel) is refused here, since the port reads
    no environment variable."""
    monkeypatch.delenv("FEDAMW_P_GUARD", raising=False)
    if value == "auto":
        with pytest.raises(ValueError, match="expected 'none'"):
            resolve_p_guard(value)
        return
    try:
        want = jresolve_p_guard(value)
    except ValueError as e:
        msg = str(e).split(": ")[-1] if "radius" in str(e) else str(e)
        with pytest.raises(ValueError) as err:
            resolve_p_guard(value)
        assert msg.split(";")[-1] in str(err.value)
        return
    assert resolve_p_guard(value) == want


def test_guarded_epoch_refuses_a_forced_kernel():
    """Not refused any more, on purpose unlike the JAX package, which
    refuses its pinned Pallas kernel with an active p-guard: every p_epoch
    kernel runs the guards in its epilogue, so a forced kernel with a
    guard runs. On CPU tensors the forced kernel is the plain version:
    the same epoch as the unforced call, bit for bit, on the simplex."""
    Jn, n_val = 4, 20
    logits = torch.randn(n_val, Jn, 3)
    pos = torch.arange(32).reshape(2, 16) % n_val
    args = (torch.full((Jn,), 0.25), torch.zeros(Jn), torch.ones(Jn), logits,
            torch.zeros(n_val, dtype=torch.int32), pos.to(torch.int32),
            batch_valid(pos, n_val), 0.1, 0.9, "classification")
    guard = make_guard("simplex")
    forced = p_epoch(*args, kernel="staged", guard=guard)
    p, _, _ = p_epoch(*args, guard=guard)
    assert torch.equal(forced[0], p)
    assert abs(float(p.sum()) - 1) < 1e-6


# -- d. participation < 1 --------------------------------------------------


@pytest.mark.parametrize("data", ["cls10", "reg"])
@pytest.mark.parametrize("algo", ROUND_LOOP)
def test_participation_matches_jax(algo, data):
    rt, rj = _both(algo, data, participation=0.5)
    _assert_match(rt, rj)
    masks = _participation_masks(_jsetup(data), SEED, R, 0.5)
    assert 0 < masks.sum() < masks.size  # a partial draw, not all or none
    if algo == "FedAMW":
        absent = ~masks[-1].astype(bool)
        assert np.all(rt["p"].numpy()[absent] == 0)
        assert np.all(rt["p_opt"][0].numpy()[absent] == 0)


@pytest.mark.parametrize("algo", ["FedAvg", "FedAMW"])
def test_all_absent_round_keeps_the_model(algo):
    """With nobody present in round 1, round 1 ends where round 0 did."""
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    inject = _inject(sj, algo, participation=0.5)
    masks = np.ones((R, sj.num_clients), bool)
    masks[1] = False
    inject["participation_masks"] = masks
    kw = _kwargs(algo, "cls10", participation=0.5)
    full = getattr(T, algo)(st, **kw, **inject)
    first = getattr(T, algo)(st, **dict(kw, round=R), stop_round=1,
                             **inject)
    assert full["test_loss"][1] == full["test_loss"][0]
    assert torch.equal(full["params"]["w"], first["params"]["w"])
    assert torch.equal(full["p"], first["p"])


def test_participation_weights_match_jax():
    r = np.random.RandomState(0)
    w = r.rand(7).astype(np.float32)
    for part in (np.array([1, 0, 1, 1, 0, 0, 1], np.float32),
                 np.zeros(7, np.float32), np.ones(7, np.float32)):
        want = np.asarray(jparticipation_weights(jnp.asarray(w),
                                                 jnp.asarray(part)))
        got = participation_weights(torch.from_numpy(w),
                                    torch.from_numpy(part)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("value", [0.0, -0.1, 1.5])
def test_participation_out_of_range_is_refused(value):
    with pytest.raises(ValueError, match=r"participation must be in \(0, 1\]"):
        T.FedAvg(_tsetup("cls10"), round=1, participation=value)


def test_participation_draws_come_from_the_seed_plus_two_stream():
    """Without injected masks the round's draw is ``rand(J) <
    participation`` from a generator seeded ``round_seed(seed + 2, t)``:
    injecting those draws gives the same run bit for bit."""
    st = _tsetup("cls10")
    kw = dict(lr=0.5, epoch=1, round=2, seed=5, participation=0.5,
              return_state=True)
    drawn = T.FedAvg(st, **kw)
    masks = np.stack([
        (torch.rand(st.num_clients, generator=torch.Generator().manual_seed(
            round_seed(5 + 2, t))) < 0.5).numpy() for t in range(2)])
    injected = T.FedAvg(st, participation_masks=masks, **kw)
    assert torch.equal(drawn["params"]["w"], injected["params"]["w"])


# -- e. server optimizers --------------------------------------------------


@pytest.mark.parametrize("opt,lr", [("sgd", 1.0), ("sgd", 0.5),
                                    ("adam", 0.1), ("yogi", 0.1),
                                    ("adagrad", 0.3)])
@pytest.mark.parametrize("algo", ["FedAvg", "FedNova"])
def test_server_opt_matches_jax(algo, opt, lr):
    rt, rj = _both(algo, "cls10", server_opt=opt, server_lr=lr)
    _assert_match(rt, rj)
    assert rt["server_opt_kind"] == opt


@pytest.mark.parametrize("opt", ["adam", "yogi"])
def test_server_opt_regression_matches_jax(opt):
    rt, rj = _both("FedProx", "reg", server_opt=opt, server_lr=0.05)
    _assert_match(rt, rj)


@pytest.mark.parametrize("opt", ["sgd", "adam", "yogi", "adagrad"])
def test_server_opt_steps_match_optax(opt):
    """Five steps on random pseudo-gradients, state leaves in optax's
    order."""
    r = np.random.RandomState(1)
    w = {"w": r.randn(3, 5).astype(np.float32)}
    tx = {"sgd": optax.sgd(0.3),
          "adam": optax.adam(0.3, b1=0.9, b2=0.99, eps=1e-3),
          "yogi": optax.yogi(0.3, b1=0.9, b2=0.99, eps=1e-3),
          "adagrad": optax.adagrad(0.3)}[opt]
    so = ServerOptimizer(opt, 0.3)
    pj, sj_ = {"w": jnp.asarray(w["w"])}, None
    sj_ = tx.init(pj)
    pt = {"w": torch.from_numpy(w["w"])}
    st = so.init(pt)
    for a, b in zip(_leaves(sj_), st):
        np.testing.assert_array_equal(b.numpy(), a)
    for _ in range(5):
        agg = r.randn(3, 5).astype(np.float32)
        g = jax.tree.map(jnp.subtract, pj, {"w": jnp.asarray(agg)})
        u, sj_ = tx.update(g, sj_, pj)
        pj = optax.apply_updates(pj, u)
        pt, st = so.step(pt, {"w": torch.from_numpy(agg)}, st)
        np.testing.assert_allclose(pt["w"].numpy(), np.asarray(pj["w"]),
                                   rtol=1e-6, atol=1e-6)
    for a, b in zip(_leaves(sj_), st):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)
        assert b.dtype == torch.from_numpy(np.array(a)).dtype


def test_server_opt_is_refused_for_fedamw_and_unknown_names():
    st = _tsetup("cls10")
    with pytest.raises(ValueError, match="server_opt applies to FedAvg"):
        T.FedAMW(st, round=1, server_opt="adam")
    with pytest.raises(ValueError, match="none|sgd|adam|yogi|adagrad"):
        T.FedAvg(st, round=1, server_opt="rmsprop")


@pytest.mark.parametrize("algo", ["Centralized", "Distributed",
                                  "FedAMW_OneShot"])
def test_one_shot_ignores_server_opt(algo):
    """As the JAX one-shot algorithms ignore it (``core.py:906-921``)."""
    st = _tsetup("cls10")
    kw = dict(lr=0.5, epoch=1, seed=2)
    if algo == "FedAMW_OneShot":
        kw.update(round=2, lr_p=5e-3)
    a = getattr(T, algo)(st, **kw)
    b = getattr(T, algo)(st, server_opt="adam", server_lr=0.1, **kw)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(a[k], b[k])


# -- f. round resume -------------------------------------------------------


def _split(fn, st, kw, k, through=None):
    """Rounds [0, k) then [k, R') from the first part's state, passed
    through ``through`` (a checkpoint round trip, say)."""
    first = fn(st, **kw, stop_round=k)
    state = {key: first[key] for key in ("params", "p", "p_opt",
                                         "server_opt", "server_opt_kind")
             if key in first}
    if through is not None:
        state = through(state)
    second = fn(st, **kw, start_round=k, resume_from=state)
    return first, second


@pytest.mark.parametrize("algo,extra", [
    ("FedAMW", {}), ("FedAMW", {"participation": 0.6}),
    ("FedAMW", {"p_guard": "simplex"}),
    ("FedAvg", {"server_opt": "adam", "server_lr": 0.1}),
    ("FedNova", {"server_opt": "yogi", "server_lr": 0.1}),
    ("FedProx", {"sequential": True})])
def test_split_run_is_bitwise_the_uninterrupted_run(algo, extra):
    st = _tsetup("cls10")
    kw = _kwargs(algo, "cls10", round=3, seed=7, **extra)
    full = getattr(T, algo)(st, **kw)
    first, second = _split(getattr(T, algo), st, kw, 2)
    for key in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(
            np.concatenate([first[key], second[key]]), full[key])
    assert torch.equal(second["params"]["w"], full["params"]["w"])
    assert torch.equal(second["p"], full["p"])
    for key in ("p_opt", "server_opt"):
        for a, b in zip(full.get(key, ()), second.get(key, ())):
            assert torch.equal(a, b)


@pytest.mark.parametrize("algo,extra", [
    ("FedAMW", {}), ("FedAvg", {"server_opt": "adam", "server_lr": 0.1}),
    ("FedAMW", {"participation": 0.5})])
def test_split_port_run_matches_the_uninterrupted_jax_run(algo, extra):
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    kw = _kwargs(algo, "cls10", round=3, **extra)
    rj = getattr(J, algo)(sj, **kw)
    inject = _inject(sj, algo, rounds=3,
                     participation=extra.get("participation"))
    first, second = _split(
        lambda s, **a: getattr(T, algo)(s, **a, **inject), st, kw, 1)
    for key in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(
            np.concatenate([first[key], second[key]]), np.asarray(rj[key]),
            **TOL)
    _assert_state(second, rj)


def test_resume_validations_match_jax():
    st = _tsetup("cls10")
    with pytest.raises(ValueError, match="start_round > 0 requires"):
        T.FedAvg(st, round=3, start_round=1)
    for start, stop in ((2, 2), (0, 4), (-1, 2)):
        with pytest.raises(ValueError, match="need 0 <= start_round"):
            T.FedAvg(st, round=3, start_round=start, stop_round=stop,
                     resume_from={"params": {"w": np.zeros((10, 64))}})
    state = T.FedAvg(st, round=2, stop_round=1, server_opt="adam",
                     return_state=True)
    resume = {k: state[k] for k in ("params", "server_opt",
                                    "server_opt_kind")}
    with pytest.raises(ValueError, match="saved under server_opt='adam'"):
        T.FedAvg(st, round=2, start_round=1, server_opt="yogi",
                 resume_from=resume)
    untagged = dict(resume)
    del untagged["server_opt_kind"]
    with pytest.warns(UserWarning, match="no 'server_opt_kind' tag"):
        T.FedAvg(st, round=2, start_round=1, server_opt="adam",
                 resume_from=untagged)
    with pytest.warns(UserWarning, match="without 'server_opt'"):
        T.FedAvg(st, round=2, start_round=1, server_opt="adam",
                 resume_from={"params": resume["params"]})
    amw = T.FedAMW(st, round=2, stop_round=1, return_state=True)
    with pytest.warns(UserWarning, match="without 'p_opt'"):
        T.FedAMW(st, round=2, start_round=1,
                 resume_from={"params": amw["params"], "p": amw["p"]})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.FedAMW(st, round=2, start_round=1,
                 resume_from={k: amw[k] for k in ("params", "p", "p_opt")})


def test_return_state_keys_match_jax():
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    for algo, extra in (("FedAvg", {}), ("FedAvg", {"server_opt": "sgd"}),
                        ("FedNova", {"server_opt": "adagrad"}),
                        ("FedAMW", {})):
        kw = dict(lr=0.5, epoch=1, round=1, return_state=True, **extra)
        rj = getattr(J, algo)(sj, **kw)
        rt = getattr(T, algo)(st, **kw)
        state = {"params", "p", "p_opt", "server_opt", "server_opt_kind"}
        assert set(rt) & state == set(rj) & state, algo
        for key in ("p_opt", "server_opt"):
            if key in rt:
                assert [tuple(a.shape) for a in rt[key]] == [
                    a.shape for a in _leaves(rj[key])]


# -- g. FedAMW's mixture record --------------------------------------------


@pytest.mark.parametrize("data", sorted(DATA))
def test_mixture_matches_jax(data):
    rt, rj = _both("FedAMW", data)
    assert rt["mixture"]["p_entropy"].shape == (R,)
    _assert_mixture(rt, rj)


@pytest.mark.parametrize("data", ["cls10", "reg"])
def test_mixture_with_participation_matches_jax(data):
    """Absent clients end a round with p exactly 0; their term of the
    entropy is exactly 0, not ``0 * log 0``."""
    rt, rj = _both("FedAMW", data, participation=0.5)
    _assert_mixture(rt, rj)
    p = rt["p"].numpy().astype(np.float64)
    assert np.any(p == 0)
    pos = p[p > 0]
    assert np.all(np.isfinite(rt["mixture"]["p_entropy"]))
    np.testing.assert_allclose(rt["mixture"]["p_entropy"][-1],
                               -np.sum(pos * np.log(pos)), rtol=1e-6)
    np.testing.assert_allclose(rt["mixture"]["p_max"][-1], p.max(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("sequential", [False, True])
def test_mixture_on_buckets_matches_jax(sequential):
    rt, rj = _both("FedAMW", "cls10", buckets=3, sequential=sequential)
    _assert_mixture(rt, rj)


def test_mixture_on_the_sequential_chain_matches_jax():
    rt, rj = _both("FedAMW", "cls3", sequential=True)
    _assert_mixture(rt, rj)


@pytest.mark.parametrize("extra", [{}, {"participation": 0.5}],
                         ids=["plain", "participation"])
def test_mixture_of_a_split_run(extra):
    """Each segment records its own rounds [start, stop): together they
    are the uninterrupted port run bit for bit, and the JAX run to 1e-5."""
    sj, st = _jsetup("cls10"), _tsetup("cls10")
    kw = _kwargs("FedAMW", "cls10", round=3, **extra)
    rj = J.FedAMW(sj, **kw)
    inject = _inject(sj, "FedAMW", rounds=3,
                     participation=extra.get("participation"))
    full = T.FedAMW(st, **kw, **inject)
    first, second = _split(lambda s, **a: T.FedAMW(s, **a, **inject), st,
                           kw, 1)
    assert first["mixture"]["p_entropy"].shape == (1,)
    assert second["mixture"]["p_entropy"].shape == (2,)
    for k in ("p_entropy", "p_max"):
        joined = np.concatenate([first["mixture"][k], second["mixture"][k]])
        np.testing.assert_array_equal(joined, full["mixture"][k])
        np.testing.assert_allclose(joined, np.asarray(rj["mixture"][k]),
                                   **TOL)


@pytest.mark.parametrize("algo", ["Centralized", "Distributed",
                                  "FedAMW_OneShot", "FedAvg", "FedProx",
                                  "FedNova", "FedAMW"])
def test_only_fedamw_carries_a_mixture_record_as_in_jax(algo):
    sj, st = _jsetup("cls3"), _tsetup("cls3")
    kw = dict(lr=0.5, epoch=1)
    if algo not in ("Centralized", "Distributed"):
        kw["round"] = 2
    rj = getattr(J, algo)(sj, **kw)
    rt = getattr(T, algo)(st, **kw)
    assert ("mixture" in rt) == ("mixture" in rj) == (algo == "FedAMW")


@pytest.mark.parametrize("seed", range(3))
def test_mixture_stats_match_the_jax_formula(seed):
    """Unconstrained p: negative and zero entries add exactly 0 to the
    entropy, as the JAX package's double where makes them."""
    from fedamw_tpu_torch.algorithms.core import _mixture_stats

    r = np.random.RandomState(seed)
    p = (r.rand(9) - 0.2).astype(np.float32)
    p[r.rand(9) < 0.3] = 0.0
    pj = jnp.asarray(p)
    safe = jnp.where(pj > 0, pj, 1.0)
    want = (-jnp.sum(jnp.where(pj > 0, pj * jnp.log(safe), 0.0)),
            jnp.max(pj))
    got = _mixture_stats(torch.from_numpy(p))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, atol=0)
    zeros = _mixture_stats(torch.tensor([0.5, 0.0, 0.5]))
    assert zeros[0].item() == _mixture_stats(torch.tensor([0.5, 0.5]))[
        0].item()


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
def test_options_on_card_match_jax_at_main_config():
    """Each option as ``chip_smoke.py``'s ``options`` phase runs it (the
    mnist-shaped stand-in, RFF D=2000, J=50, Dirichlet 0.01, the
    registry's lr / lr_p / lambda, 2 rounds of 2 epochs at a constant lr,
    seed 100): the port on the card, through its kernels, against the
    JAX package on the CPU with every random input injected. The guarded
    case is refused on the kernels and runs on the plain versions. Tolerance
    is ``chip_smoke.py``'s ``TOL_RUN``: losses 1e-4 relative, accuracy
    0.05 points, final weights and p 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    seed, rounds = 100, 2
    prm = get_parameter("mnist")
    ds = jload_dataset("mnist", num_partitions=50, alpha=prm["alpha_Dirk"])
    base = dict(lr=prm["lr"], epoch=LE, batch_size=B, round=rounds,
                seed=seed, lr_mode="constant", return_state=True)
    amw = dict(base, lambda_reg=prm["lambda_reg"], lr_p=prm["lr_p"],
               val_batch_size=VB)
    cases = {
        "FedAvg sequential": ("FedAvg", 1, dict(base, sequential=True)),
        "FedAMW buckets=4": ("FedAMW", 4, amw),
        "FedAMW participation=0.5": ("FedAMW", 1,
                                     dict(amw, participation=0.5)),
        "FedAvg server_opt=adam": ("FedAvg", 1,
                                   dict(base, server_opt="adam",
                                        server_lr=0.1)),
        "FedProx server_opt=yogi": ("FedProx", 1,
                                    dict(base, mu=prm["lambda_prox"],
                                         server_opt="yogi", server_lr=0.1)),
        "FedAMW p_guard=simplex": ("FedAMW", 1, dict(amw, p_guard="simplex")),
    }
    report = {"source": ds.source}
    for name, (algo, buckets, kw) in cases.items():
        sj = J.prepare_setup(ds, D=2000, kernel_par=prm["kernel_par"],
                             seed=seed, rng=np.random.RandomState(seed),
                             buckets=buckets)
        idx, mask = sj.round_arrays()
        if buckets == 1:
            idx, mask = idx[0], mask[0]
        st = setup_from_arrays(
            task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
            X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test,
            y_test=sj.y_test, idx=idx, mask=mask, sizes=sj.sizes,
            p_fixed=sj.p_fixed, rff=sj.rff, device="cuda")
        jkw = dict(kw)
        guard = jkw.pop("p_guard", None)
        with pytest.MonkeyPatch.context() as mp:
            if guard:
                mp.setenv("FEDAMW_P_GUARD", guard)
            rj = getattr(J, algo)(sj, **jkw)
        inject = _inject(sj, algo, seed=seed, rounds=rounds,
                         participation=kw.get("participation"))
        # a guarded solve runs in kernel 2's epilogue like any other
        rt = getattr(T, algo)(st, **kw, **inject)
        report[name] = {k: {"jax": np.asarray(rj[k]).tolist(),
                            "port": rt[k].tolist()}
                        for k in ("train_loss", "test_loss", "test_acc")}
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=1e-4,
                                       atol=0, err_msg=f"{name} {k}")
        np.testing.assert_allclose(rt["test_acc"], np.asarray(rj["test_acc"]),
                                   rtol=0, atol=0.05, err_msg=name)
        np.testing.assert_allclose(rt["params"]["w"].cpu().numpy(),
                                   np.asarray(rj["params"]["w"]), rtol=0,
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(rt["p"].cpu().numpy(), np.asarray(rj["p"]),
                                   rtol=0, atol=1e-4, err_msg=name)
    print(json.dumps({"options_vs_jax": report}), flush=True)
