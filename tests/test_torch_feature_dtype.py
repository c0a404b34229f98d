"""Narrow feature storage (``feature_dtype``) in the port, against the JAX
package.

``prepare_setup(feature_dtype=torch.bfloat16)`` stores the feature
matrices in 2 bytes; compute stays float32. The JAX package's
``tests/test_bf16.py`` checks, on the port: the storage dtypes, FedAvg at
bf16 within 3 points of float32 on ``digits`` and above 50%, and FedAMW on
two size buckets at bf16 staying finite. Then against the JAX package on
the CPU:

- ``rff_map_to`` against JAX's: the two float32 maps differ at ~1e-7, so
  their bf16 roundings may differ by one bf16 ulp where a value sits at a
  rounding boundary; at most one ulp is allowed, and the share of entries
  that differ at all is printed;
- FedAvg and FedAMW at bf16 with the JAX package's own bf16 feature
  matrices injected (and every random input, as ``test_torch_slice.py``
  does) match it at 1e-5, the port's parity tolerance: widening bf16 to
  float32 is exact, so nothing looser is justified;
- the driver with ``--feature_dtype bfloat16 --device cpu``: its pickle,
  the checkpoint marker the JAX package's ``load_checkpoint`` reads, and
  ``--resume`` bit for bit.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedamw_tpu.algorithms import FedAMW as JFedAMW
from fedamw_tpu.algorithms import FedAvg as JFedAvg
from fedamw_tpu.algorithms import prepare_setup as jprepare_setup
from fedamw_tpu.algorithms.core import _derive_params, _keys
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.fedcore.batching import epoch_batches as jepoch_batches
from fedamw_tpu.ops.rff import rff_map_to as jrff_map_to
from fedamw_tpu.ops.rff import rff_params as jrff_params
from fedamw_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from fedamw_tpu.utils.reporting import load_results
from fedamw_tpu_torch import exp
from fedamw_tpu_torch.algorithms import (
    FedAMW, FedAvg, FedNova, Centralized, Distributed, FedAMW_OneShot,
    FedProx, prepare_setup)
from fedamw_tpu_torch.convert import (
    features_from_jax, params_from_jax, setup_from_arrays)
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.ops.rff import rff_map, rff_map_to
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SEED, ROUNDS, EPOCHS, B, VB = 0, 2, 2, 32, 16
NARROW = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


@pytest.fixture(scope="module")
def ds():
    return load_dataset("digits", num_partitions=8, alpha=0.5)


def _setup(ds, dtype, **kw):
    # raw features (kernel_type="linear") learn fast on digits, as in
    # tests/test_bf16.py
    return prepare_setup(ds, kernel_type="linear", seed=100,
                         rng=np.random.RandomState(100), feature_dtype=dtype,
                         device="cpu", **kw)


# -- tests/test_bf16.py, on the port ------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_storage_dtypes(ds, dtype):
    s = _setup(ds, dtype)
    assert s.X.dtype == dtype
    assert s.X_test.dtype == dtype
    assert s.X_val.dtype == dtype
    assert s.y.dtype == torch.int32
    assert s.p_fixed.dtype == torch.float32
    g = prepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3),
                      feature_dtype=dtype, device="cpu")
    assert g.X.dtype == dtype and g.rff[0].dtype == torch.float32
    f32 = prepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3),
                        device="cpu")
    # the narrow map is the float32 map rounded once
    assert torch.equal(g.X, f32.X.to(dtype))


def test_bf16_fedavg_accuracy_close_to_f32(ds):
    kw = dict(lr=0.5, epoch=1, round=5, seed=0, lr_mode="constant")
    acc32 = FedAvg(_setup(ds, None), **kw)["test_acc"][-1]
    acc16 = FedAvg(_setup(ds, torch.bfloat16), **kw)["test_acc"][-1]
    assert abs(float(acc32) - float(acc16)) < 3.0
    assert float(acc16) > 50.0  # it actually learned


def test_bf16_fedamw_bucketed(ds):
    s = _setup(ds, torch.bfloat16, buckets=2)
    res = FedAMW(s, lr=0.5, epoch=1, round=2, lambda_reg=1e-4,
                 lr_p=1e-3, seed=0, lr_mode="constant")
    assert np.all(np.isfinite(res["test_loss"]))


@pytest.mark.parametrize("algo,kw", [
    (Centralized, dict(epoch=2)),
    (Distributed, dict(epoch=2)),
    (FedAMW_OneShot, dict(epoch=2, round=2, lambda_reg=1e-4, lr_p=1e-3)),
    (FedNova, dict(epoch=1, round=2)),
    (FedProx, dict(epoch=1, round=2, mu=0.01, sequential=True)),
    (FedAvg, dict(epoch=1, round=2, participation=0.5, server_opt="adam",
                  server_lr=0.1)),
    (FedAMW, dict(epoch=1, round=2, lambda_reg=1e-4, lr_p=1e-3,
                  p_guard="simplex")),
])
def test_every_algorithm_runs_on_a_narrow_setup(ds, algo, kw):
    """The seven algorithms and the round loop's options run unchanged
    on 2-byte features, and each equals the same run on the float32
    widening of those features (widening is exact, so bit for bit)."""
    narrow = _setup(ds, torch.bfloat16)
    wide = _setup(ds, torch.bfloat16)
    for name in ("X", "X_val", "X_test"):
        setattr(wide, name, getattr(wide, name).float())
    kw = dict(kw, lr=0.5, seed=0)
    a, b = algo(narrow, **kw), algo(wide, **kw)
    for k in ("train_loss", "test_loss", "test_acc"):
        assert np.all(np.isfinite(a[k]))
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(NARROW))
def test_rff_map_to_matches_jax(dtype):
    """The same draw mapped by both packages into a 2-byte dtype, with a
    small chunk so that several chunks run: at most one ulp of the narrow
    type apart (the float32 maps differ at ~1e-7)."""
    tdt, jdt = NARROW[dtype]
    rng = np.random.RandomState(0)
    X = rng.randn(300, 20).astype(np.float32)
    W, b = jrff_params(jax.random.PRNGKey(1), 20, 256, 0.5)
    want = features_from_jax(jrff_map_to(jnp.asarray(X), W, b, jdt,
                                         chunk=128)).float()
    Wt, bt = torch.from_numpy(np.array(W)), torch.from_numpy(np.array(b))
    got = rff_map_to(torch.from_numpy(X), Wt, bt, tdt, chunk=128)
    assert got.dtype == tdt and got.shape == (300, 256)
    assert torch.equal(got, rff_map(torch.from_numpy(X), Wt, bt).to(tdt))
    got = got.float()
    # one ulp of the narrow type at each entry's magnitude
    ulp = torch.finfo(tdt).eps * torch.maximum(got.abs(), want.abs())
    ulp = torch.maximum(ulp, torch.full_like(ulp, torch.finfo(tdt).tiny))
    assert bool(((got - want).abs() <= ulp).all())
    print(json.dumps({"rff_map_to_vs_jax": {
        "dtype": dtype, "entries": got.numel(),
        "share_differing": float((got != want).float().mean())}}))


def _pair(sj, seed, rounds, epochs):
    """The port's CPU setup from the JAX setup ``sj``'s arrays (its
    features in their own dtype) and the JAX run's random inputs."""
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
        rff=sj.rff, device="cpu")
    inject = dict(params0=params_from_jax(params0),
                  client_positions=client_pos)
    return st, inject, p_pos


@pytest.fixture(scope="module", params=sorted(NARROW))
def narrow_pair(request):
    jdt = NARROW[request.param][1]
    d = jload_dataset("digits", num_partitions=4, alpha=0.5)
    sj = jprepare_setup(d, D=64, seed=3, rng=np.random.RandomState(3),
                        feature_dtype=jdt)
    return (request.param, sj) + _pair(sj, SEED, ROUNDS, EPOCHS)


@pytest.mark.parametrize("jax_kernels", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("algo", ["FedAvg", "FedAMW"])
def test_narrow_run_matches_jax(narrow_pair, algo, jax_kernels,
                                monkeypatch):
    """FedAvg and FedAMW on the JAX package's own 2-byte features, every
    random input injected: 1e-5, as at float32."""
    dtype, sj, st, inject, p_pos = narrow_pair
    assert st.X.dtype == NARROW[dtype][0] and st.X_val.dtype == st.X.dtype
    monkeypatch.setenv("FEDAMW_KERNEL", jax_kernels)
    monkeypatch.setenv("FEDAMW_PSOLVER", jax_kernels)
    kw = dict(lr=0.5, epoch=EPOCHS, round=ROUNDS, seed=SEED,
              return_state=True)
    if algo == "FedAMW":
        kw.update(lambda_reg=5e-4, lr_p=5e-3)
        inject = dict(inject, p_positions=p_pos)
    rj = (JFedAMW if algo == "FedAMW" else JFedAvg)(sj, **kw)
    rt = (FedAMW if algo == "FedAMW" else FedAvg)(st, **kw, **inject)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(rt["params"]["w"].numpy(),
                               np.asarray(rj["params"]["w"]), **TOL)
    np.testing.assert_allclose(rt["p"].numpy(), np.asarray(rj["p"]), **TOL)


# -- the driver -----------------------------------------------------------------

ARGV = ["--device", "cpu", "--dataset", "digits", "--D", "64",
        "--num_partitions", "4", "--round", "2", "--local_epoch", "1",
        "--seed", "100", "--feature_dtype", "bfloat16"]


def test_driver_round_trip_at_bf16(tmp_path):
    """The driver at bf16: exp.py's pickle, read by the JAX package's
    reader; checkpoints whose ``feature_dtype`` marker the JAX package's
    ``load_checkpoint`` reads; a partial signed with the dtype, so
    ``--resume`` extends it bit for bit and a float32 run may not."""
    whole = load_results(exp.main(ARGV + [
        "--n_repeats", "2", "--result_dir", str(tmp_path / "whole"),
        "--save_models", str(tmp_path / "ck")]))
    for k in ("train_loss", "test_loss", "test_acc"):
        assert whole[k].shape == (6, 2, 2) and np.all(np.isfinite(whole[k]))
    state = jload_checkpoint(str(tmp_path / "ck" / "digits_FedAMW_repeat0"))
    assert state["feature_dtype"] == "bfloat16"
    assert np.asarray(state["params"]["w"]).shape[1] == 64
    split = tmp_path / "split"
    exp.main(ARGV + ["--n_repeats", "1", "--result_dir", str(split)])
    with open(split / "exp1_digits.partial.pkl", "rb") as f:
        assert pickle.load(f)["config"]["feature_dtype"] == "bfloat16"
    resumed = load_results(exp.main(ARGV + [
        "--n_repeats", "2", "--resume", "--result_dir", str(split)]))
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)
    wide = [a for a in ARGV if a not in ("--feature_dtype", "bfloat16")]
    with pytest.raises(SystemExit) as err:
        exp.main(wide + ["--n_repeats", "2", "--resume", "--result_dir",
                         str(split)])
    assert err.value.code == 2


def test_setup_refuses_other_dtypes(ds):
    with pytest.raises(ValueError, match="feature_dtype must be one of"):
        _setup(ds, torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_narrow_run_matches_its_plain_run(dtype):
    """On the card at bf16 and f16: FedAvg and FedAMW through kernel 1's
    2-byte rows match the same runs on the plain versions (chip_smoke.py's
    TOL_RUN: losses 1e-4 relative, accuracy 0.05 points, weights 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fedamw_tpu_torch.fedcore import client_epoch, p_epoch

    # the mnist-shaped stand-in: the card's machine has no sklearn digits
    d = load_dataset("mnist", num_partitions=8, alpha=0.5)
    s = prepare_setup(d, D=256, seed=3, rng=np.random.RandomState(3),
                      feature_dtype=dtype)
    assert s.X.dtype == dtype and s.X.is_cuda
    for algo, kw in ((FedAvg, {}), (FedAMW, dict(lambda_reg=1e-4,
                                                 lr_p=1e-3))):
        kw = dict(kw, lr=0.5, epoch=2, round=3, seed=0,
                  lr_mode="constant", return_state=True)
        ref = algo(s, kernel_impl="plain", **kw)
        before = (client_epoch.launches, p_epoch.launches)
        res = algo(s, **kw)
        assert client_epoch.launches - before[0] == 6
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(res[k], ref[k], rtol=1e-4, atol=0)
        np.testing.assert_allclose(res["test_acc"], ref["test_acc"],
                                   rtol=0, atol=0.05)
        torch.testing.assert_close(res["params"]["w"], ref["params"]["w"],
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_main_configuration_runs_the_two_byte_ring(dtype):
    """At the main configuration (the mnist stand-in's 50 Dirichlet(0.01)
    clients, D = 2,000) every local epoch of FedAvg on 2-byte features
    runs the staged kernel of 2-byte rows at the cluster its measured rule
    picks with the split's steps (8 CTAs), and the run matches its plain
    run (chip_smoke.py's TOL_RUN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fedamw_tpu_torch.fedcore import client_epoch
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek

    d = load_dataset("mnist", num_partitions=50, alpha=0.01)
    s = prepare_setup(d, D=2000, seed=100, rng=np.random.RandomState(100),
                      feature_dtype=dtype)
    steps = torch.ceil(s.mask.sum(1) / 32).int().tolist()
    dev = torch.cuda.current_device()
    plan = ek.launch_plan(
        50, 32, s.num_classes, 2000,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        row_bytes=2, max_cluster=ek.wide_max_cluster(dev),
        active_clusters=ek.wide_active_clusters(dev), steps=steps)
    assert (plan.kernel, plan.cluster) == ("staged", 8) and plan.stages
    kw = dict(lr=0.5, epoch=2, round=2, seed=0, lr_mode="constant",
              return_state=True)
    ref = FedAvg(s, kernel_impl="plain", **kw)
    before = client_epoch.launches_by_kernel["staged"]
    res = FedAvg(s, **kw)
    assert client_epoch.launches_by_kernel["staged"] - before == 4
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-4, atol=0)
    np.testing.assert_allclose(res["test_acc"], ref["test_acc"], rtol=0,
                               atol=0.05)
    torch.testing.assert_close(res["params"]["w"], ref["params"]["w"],
                               rtol=0, atol=1e-4)
