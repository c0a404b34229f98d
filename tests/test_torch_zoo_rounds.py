"""The zoo's rounds in the port against the JAX package, on the CPU.

sklearn ``digits`` (8 x 8 images, 10 classes) in J=6 clients (Dirichlet
0.5) on raw features (``kernel_type="linear"``), with ``mlp16`` and
``conv4x8``: the client round takes the autograd route
(``fedcore/client.py``), FedAMW's p-solve runs kernel 2's plain version
on the zoo's logits. 2 rounds of 2 local epochs. Every random input is
the JAX run's, injected as in ``tests/test_torch_options.py``: the
initial weights (``_derive_params`` of the model's init), each client's
per-epoch shuffles, FedAMW's p-epoch shuffles and the participation
draws; the one-shot phases' and Centralized's shuffles as in
``tests/test_torch_paper.py``.

Held, at 1e-5 absolute and relative on every returned float (the same
float32 arithmetic in another summation order; the conv runs hold it
too, so no float64 yardstick is needed): FedAvg, FedProx, FedNova and
FedAMW (the JAX p-solver as ``xla`` and as ``pallas_interpret``) and
Centralized, Distributed and FedAMW_OneShot, every parameter leaf, p,
its momentum, ``mixture``. A linear run still goes through
``client_epoch`` and is bitwise the kernel route's epochs; a zoo run
never reaches it. The round loop's options on the zoo are
``tests/test_torch_zoo_options.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedamw_tpu.algorithms as J
from fedamw_tpu.algorithms.core import _keys
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch.convert import setup_from_arrays
from fedamw_tpu_torch.fedcore import client as tclient
from fedamw_tpu_torch.fedcore import client_epoch, make_client_round
from test_torch_options import _inject

SEED, R, LE, B, VB = 0, 2, 2, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)
MODELS = ("mlp16", "conv4x8")
ONESHOT = ("Centralized", "Distributed", "FedAMW_OneShot")


@functools.lru_cache(maxsize=None)
def _jsetup(model, buckets=1):
    ds = jload_dataset("digits", num_partitions=6, alpha=0.5)
    return J.prepare_setup(ds, D=64, kernel_type="linear", seed=3,
                           rng=np.random.RandomState(3), model=model,
                           buckets=buckets)


@functools.lru_cache(maxsize=None)
def _tsetup(model, buckets=1):
    sj = _jsetup(model, buckets)
    idx, mask = sj.round_arrays()
    if buckets == 1:
        idx, mask = idx[0], mask[0]
    return setup_from_arrays(
        task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
        X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test, y_test=sj.y_test,
        idx=idx, mask=mask, sizes=sj.sizes, p_fixed=sj.p_fixed, rff=None,
        model=model, device="cpu")


def _kwargs(algo, **extra):
    if algo in ONESHOT:
        kw = dict(lr=0.5, epoch=LE, seed=SEED)
        if algo == "FedAMW_OneShot":
            kw.update(lambda_reg=5e-4, lr_p=5e-3, round=R)
        return kw
    kw = dict(lr=0.5, epoch=LE, round=R, seed=SEED, lr_mode="constant",
              return_state=True)
    if algo == "FedProx":
        kw["mu"] = 0.01
    if algo == "FedAMW":
        kw.update(lambda_reg=5e-4, lr_p=5e-3)
    kw.update(extra)
    return kw


def _oneshot_inject(sj, algo):
    """The JAX one-shot runs' draws (``tests/test_torch_paper.py``)."""
    Jn, n_max = sj.idx.shape
    params0 = _inject(sj, "FedAvg")["params0"]
    if algo == "Centralized":
        n = int(sj.all_train_idx.shape[0])
        return dict(params0=params0, client_positions=np.stack([
            np.asarray(jepoch_batches(k, n, B, jnp.ones(n, jnp.float32))[0])
            for k in jax.random.split(jax.random.PRNGKey(SEED), LE)]))
    keys = _keys(SEED, Jn)
    out = dict(params0=params0, client_positions=np.stack([
        [np.asarray(jepoch_batches(k, n_max, B, sj.mask[j])[0])
         for k in jax.random.split(keys[j], LE)] for j in range(Jn)]))
    if algo == "FedAMW_OneShot":
        n_val = sj.X_val.shape[0]
        out["p_positions"] = np.stack([
            [np.asarray(jepoch_batches(k, n_val, VB)[0])
             for k in jax.random.split(key_t, 1)]
            for key_t in jax.random.split(jax.random.PRNGKey(SEED + 1), R)])
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(algo, model, buckets=1, jax_kernels="xla", **extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEDAMW_KERNEL", jax_kernels)
        mp.setenv("FEDAMW_PSOLVER", jax_kernels)
        return getattr(J, algo)(_jsetup(model, buckets),
                                **_kwargs(algo, **extra))


def _port_run(algo, model, buckets=1, **extra):
    sj = _jsetup(model, buckets)
    inject = (_oneshot_inject(sj, algo) if algo in ONESHOT else _inject(
        sj, algo, participation=extra.get("participation")))
    return getattr(T, algo)(_tsetup(model, buckets), **_kwargs(algo, **extra),
                            **inject)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_match(rt, rj):
    """Every float of the JAX result within ``TOL``, every verdict and
    count exactly, every parameter leaf by name."""
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL,
                                   err_msg=k)
        assert np.all(np.isfinite(rt[k])), k
    if "params" in rj:
        assert set(rt["params"]) == set(rj["params"])
        for k, v in rj["params"].items():
            assert tuple(rt["params"][k].shape) == np.shape(v), k
            np.testing.assert_allclose(_np(rt["params"][k]), np.asarray(v),
                                       **TOL, err_msg=k)
        np.testing.assert_allclose(_np(rt["p"]), np.asarray(rj["p"]), **TOL)
    for key in ("p_opt", "server_opt"):
        assert (key in rt) == (key in rj), key
        if key in rj:
            for a, b in zip(jax.tree_util.tree_leaves(rj[key]), rt[key]):
                np.testing.assert_allclose(_np(b), np.asarray(a), **TOL,
                                           err_msg=key)
    assert ("mixture" in rt) == ("mixture" in rj)
    for k, v in rj.get("mixture", {}).items():
        np.testing.assert_allclose(rt["mixture"][k], np.asarray(v), **TOL,
                                   err_msg=k)
    for k, v in rj.get("fault_counts", {}).items():
        np.testing.assert_array_equal(rt["fault_counts"][k], v, err_msg=k)
    assert set(rt.get("defense", {})) == set(rj.get("defense", {}))
    for k, v in rj.get("defense", {}).items():
        if k in ("z_max", "z_threshold", "reputation", "geomed_residual"):
            np.testing.assert_allclose(rt["defense"][k], np.asarray(v),
                                       **TOL, err_msg=k)
        elif k == "robust_agg":
            assert rt["defense"][k] == v
        else:
            np.testing.assert_array_equal(rt["defense"][k], v, err_msg=k)
    for rec, keys in (("hierarchy", ("cohort_shards", "shard_present")),
                      ("streamed", ("cohort_shards", "shard_clients",
                                    "present"))):
        assert (rec in rt) == (rec in rj), rec
        for k in keys if rec in rj else ():
            np.testing.assert_array_equal(rt[rec][k], rj[rec][k], err_msg=k)


BASE = [(algo, "xla") for algo in ("FedAvg", "FedProx", "FedNova",
                                   "FedAMW")] + [("FedAMW",
                                                  "pallas_interpret")]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("algo,jax_kernels", BASE)
def test_round_loop_matches_jax(algo, jax_kernels, model):
    rj = _jax_run(algo, model, jax_kernels=jax_kernels)
    rt = _port_run(algo, model)
    _assert_match(rt, rj)
    assert rt["train_loss"].shape == (R,)
    assert set(rt["params"]) == set(_tsetup(model).model.init(
        torch.Generator(), 64, 10))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("algo", ONESHOT)
def test_one_shot_algorithms_match_jax(algo, model):
    rj = _jax_run(algo, model)
    rt = _port_run(algo, model)
    _assert_match(rt, rj)
    want = () if algo != "FedAMW_OneShot" else (R,)
    assert np.shape(rt["test_loss"]) == want


# -- the routes ------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Calls of kernel 1's wrapper and of its plain version by the client
    round."""
    calls = {"client_epoch": 0, "client_epoch_plain": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(tclient, name, counting(name,
                                                    getattr(tclient, name)))
    return calls


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kernel_impl", ["auto", "plain"])
def test_a_zoo_run_never_reaches_client_epoch(model, kernel_impl, counted):
    T.FedAvg(_tsetup(model), lr=0.5, epoch=1, round=1, seed=1,
             kernel_impl=kernel_impl)
    T.Centralized(_tsetup(model), lr=0.5, epoch=1, seed=1,
                  kernel_impl=kernel_impl)
    assert counted == {"client_epoch": 0, "client_epoch_plain": 0}


def test_a_linear_run_goes_through_client_epoch(counted):
    from test_torch_options import _tsetup as linear_setup

    st = linear_setup("cls10")
    T.FedAvg(st, lr=0.5, epoch=2, round=2, seed=1)
    assert counted == {"client_epoch": 2 * 2, "client_epoch_plain": 0}
    T.FedAvg(st, lr=0.5, epoch=2, round=2, seed=1, kernel_impl="plain")
    assert counted["client_epoch_plain"] == 2 * 2


@pytest.mark.parametrize("sequential", [False, True])
def test_the_linear_round_is_bitwise_its_kernel_epochs(sequential):
    """The kernel route is the epochs of ``client_epoch`` on the stacked
    ``(J, C, D)`` weights, anchored at the received weights, bit for bit
    (parallel, and the J = 1 chain)."""
    from test_torch_options import _client_positions, _jsetup as jlinear
    from test_torch_options import _tsetup as linear_setup

    st = linear_setup("cls10")
    pos = torch.as_tensor(_client_positions(jlinear("cls10"), SEED, 1,
                                            LE)[0][0]).long()
    Jn, n_max = st.idx.shape
    w0 = st.model.init(torch.Generator().manual_seed(2), st.D,
                       st.num_classes)["w"]
    args = (st.X, st.y)
    stacked, losses, accs = make_client_round(
        st.task, LE, B, n_max, sequential=sequential)(
        {"w": w0}, *args, st.idx, st.mask, pos, 0.5, 0.01, 0.001)

    def epochs(W, anchor, idx, mask, p):
        for e in range(LE):
            rows, valid = tclient._epoch_rows(p[:, e], idx, mask, n_max)
            W, met = client_epoch(W, anchor, *args, rows, valid, 0.5, 0.01,
                                  0.001, st.task)
        return W, met

    if not sequential:
        W, met = epochs(w0.expand(Jn, *w0.shape).contiguous(), w0, st.idx,
                        st.mask, pos)
    else:
        Ws, mets, carry = [], [], w0.contiguous()
        for j in range(Jn):
            Wj, mj = epochs(carry[None], carry, st.idx[j:j + 1],
                            st.mask[j:j + 1], pos[j:j + 1])
            Ws.append(Wj)
            mets.append(mj)
            carry = Wj[0]
        W, met = torch.cat(Ws), torch.cat(mets)
    total = torch.clamp(met[:, 2], min=1.0)
    assert torch.equal(stacked["w"], W)
    assert torch.equal(losses, met[:, 0] / total)
    assert torch.equal(accs, 100.0 * met[:, 1] / total)


@functools.lru_cache(maxsize=None)
def _jsynthetic(model):
    """A digits-sized synthetic set (the card's machine has no sklearn):
    3,000 x 64, 10 classes, J=6 Dirichlet(0.5) clients, raw features."""
    from fedamw_tpu.data import FederatedDataset, dirichlet_partition
    from fedamw_tpu.data.synthetic import synthetic_classification

    X, y, Xt, yt = synthetic_classification(3000, 64, 10, seed=5)
    parts, _ = dirichlet_partition(y, 6, alpha=0.5, seed=2020, min_size=0)
    ds = FederatedDataset(name="synthetic", task_type="classification",
                          num_classes=10, d=64, X_train=X, y_train=y,
                          X_test=Xt, y_test=yt, parts=parts,
                          source="synthetic")
    return J.prepare_setup(ds, D=64, kernel_type="linear", seed=3,
                           rng=np.random.RandomState(3), model=model)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,model", [("FedAvg", "mlp16"),
                                        ("FedAMW", "conv4x8")])
def test_zoo_on_the_card_matches_jax(algo, model):
    """The zoo on the card (the autograd route, kernel 2's CUDA kernel on
    the zoo's logits) against the JAX package on the CPU, every draw
    injected, at ``chip_smoke.py``'s ``TOL_RUN`` (two fp32 routes'
    summation orders over two rounds): kernel 1 is never launched. The lr
    is ``scale_bench.py``'s 0.1: at 0.5 on this set a hidden unit's sign
    flips within float32 noise in the second local epoch and the two
    packages part by ~1e-3 on the CPU too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    from fedamw_tpu_torch.fedcore import p_epoch

    sj = _jsynthetic(model)
    st = setup_from_arrays(
        task=sj.task, num_classes=sj.num_classes, X=sj.X, y=sj.y,
        X_val=sj.X_val, y_val=sj.y_val, X_test=sj.X_test, y_test=sj.y_test,
        idx=sj.idx, mask=sj.mask, sizes=sj.sizes, p_fixed=sj.p_fixed,
        rff=None, model=model, device="cuda")
    kw = _kwargs(algo, lr=0.1)
    rj = getattr(J, algo)(sj, **kw)
    before = (client_epoch.launches, p_epoch.launches)
    rt = getattr(T, algo)(st, **kw, **_inject(sj, algo))
    torch.cuda.synchronize()
    assert (client_epoch.launches - before[0],
            p_epoch.launches - before[1]) == (
        0, R * R if algo == "FedAMW" else 0)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=1e-4,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(rt["test_acc"], np.asarray(rj["test_acc"]),
                               rtol=0, atol=0.05)
    for k, v in rj["params"].items():
        np.testing.assert_allclose(rt["params"][k].cpu().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)
