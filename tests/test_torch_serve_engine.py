"""The port's serving engine against the JAX package's, and every engine
contract of the JAX package held on the port's engine, on the CPU.

**Against JAX** (``ServingEngine`` of both packages on one checkpoint,
written by the JAX package's ``save_checkpoint`` in its pickle layout
with ``orbax`` poisoned, loaded by the port's ``ServingEngine.load``):
the linear model on pre-mapped RFF rows, the fused RFF map on raw rows,
``mlp16``, ``conv4x8`` (with ``input_dim``) and bfloat16 features, at
1e-5 absolute and relative (the same float32 products in another
summation order; bf16 features cast from the same float32 rows), and the
fused map cast to bf16 at ``BF16_FUSED`` (the reason is beside it).

**The port's own contracts** (``tests/test_serving.py:41-266`` and the
engine half of ``tests/test_rollout.py``/``tests/test_ladder.py``): the
rung rule, model inference, the checkpoint round trip served bitwise
equal to ``model.apply`` and at the evaluator's exact accuracy, the
feature-dtype marker, inert padding, single-row and chunked requests,
the shape count flat across a mixed stream, swaps and rung
install/retire, every swap refusal, the serving mesh of 4 CPU slices
(rungs rounded up, logits equal to one device's), and the refusals of
what is refused (``aot=`` on an eager engine, a missing artifact, orbax
checkpoints, a state with no params, no card). ``cuda`` cases hold the engine on the card against
its CPU run.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from fedamw_tpu.serving import ServingEngine as JServingEngine
from fedamw_tpu.utils.checkpoint import save_checkpoint as jsave
from fedamw_tpu_torch.algorithms import FedAMW, FedAvg, prepare_setup
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.fedcore import make_evaluator
from fedamw_tpu_torch.models import conv_model, get_model
from fedamw_tpu_torch.parallel import make_serving_mesh
from fedamw_tpu_torch.serving import (ServingEngine as _ServingEngine,
                                      ServingService, bucket_for,
                                      infer_model)
from fedamw_tpu_torch.utils import CheckpointError, save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# A row served at another rung (another row count) or in another slice
# of a mesh goes through another CPU product kernel (the BLAS blocks by
# the row count), so its sum order, and so its last bit, may change:
# held at this tolerance, with the argmax equal. At one rung and one
# position the logits are bitwise, and that is pinned too.
ROWS = dict(rtol=1e-5, atol=1e-6)
# The fused map then the bf16 cast: where the two packages' float32 cos
# differ in the last bit and the value sits on a bf16 rounding boundary,
# the feature lands one bf16 step (2^-8 of it, features up to 1/sqrt(D))
# apart, and a logit moves by that step times the feature's weight (here
# ~1e-3 at most; 3 of 210 logits on these inputs).
BF16_FUSED = dict(rtol=0, atol=2e-3)
D, C = 16, 3


class ServingEngine(_ServingEngine):
    """The port's engine on the CPU (its entry points run on the card
    unless told otherwise)."""

    def __init__(self, *a, device=None, **kw):
        super().__init__(*a, device=device or "cpu", **kw)


def _poison_orbax(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _jax_params(model, d, seed=0):
    import jax

    from fedamw_tpu.models import get_model as jget_model

    params = jget_model(model).init(jax.random.PRNGKey(seed), d, C)
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_draw(d, Dm, seed=0):
    import jax

    from fedamw_tpu.ops.rff import rff_params

    W, b = rff_params(jax.random.PRNGKey(seed), d, Dm, 0.5)
    return np.asarray(W), np.asarray(b)


# name -> (checkpoint keywords, engine keywords, row width, tolerance)
def _case(name):
    rng = np.random.RandomState(7)
    if name == "linear-rff-rows":
        return dict(params={"w": rng.randn(C, 32).astype(np.float32)}), {}, \
            32, TOL
    if name == "fused-rff":
        return dict(params={"w": rng.randn(C, 32).astype(np.float32)},
                    rff=_jax_draw(D, 32)), {}, D, TOL
    if name == "mlp16":
        return dict(params=_jax_params("mlp16", D)), {}, D, TOL
    if name == "conv4x8":
        return dict(params=_jax_params("conv4x8", 64)), dict(
            model="conv4x8", input_dim=64), 64, TOL
    if name == "bf16":
        return dict(params={"w": rng.randn(C, 32).astype(np.float32)},
                    feature_dtype="bfloat16"), {}, 32, TOL
    if name == "bf16-fused":
        return dict(params={"w": rng.randn(C, 32).astype(np.float32)},
                    rff=_jax_draw(D, 32), feature_dtype="bfloat16"), {}, D, \
            BF16_FUSED
    raise KeyError(name)


@pytest.mark.parametrize("name", ["linear-rff-rows", "fused-rff", "mlp16",
                                  "conv4x8", "bf16", "bf16-fused"])
def test_engine_matches_jax_on_the_same_checkpoint(name, tmp_path,
                                                   monkeypatch):
    ck, eng_kw, width, tol = _case(name)
    _poison_orbax(monkeypatch)
    path = str(tmp_path / "ck")
    assert jsave(path, **ck).endswith("state.pkl")
    jmodel = eng_kw.get("model", "auto")
    if jmodel != "auto":
        from fedamw_tpu.models import get_model as jget_model

        jmodel = jget_model(jmodel)
    jeng = JServingEngine.load(path, buckets=(8, 64), model=jmodel,
                               input_dim=eng_kw.get("input_dim"))
    teng = ServingEngine.load(path, buckets=(8, 64), **eng_kw)
    assert teng.input_dim == jeng.input_dim == width
    assert teng.num_classes == jeng.num_classes == C
    assert str(teng.feature_dtype) == str(jeng.feature_dtype)
    X = np.random.RandomState(3).randn(70, width).astype(np.float32)
    got, want = teng.predict(X), jeng.predict(X)
    assert got.shape == want.shape == (70, C)
    np.testing.assert_allclose(got, want, **tol)


# -- rung ladder ----------------------------------------------------------

def test_bucket_for_picks_smallest_rung():
    assert bucket_for(1, (1, 8, 64)) == 1
    assert bucket_for(2, (1, 8, 64)) == 8
    assert bucket_for(8, (1, 8, 64)) == 8
    assert bucket_for(9, (1, 8, 64)) == 64
    with pytest.raises(ValueError, match="exceeds"):
        bucket_for(65, (1, 8, 64))
    with pytest.raises(ValueError, match="at least one"):
        bucket_for(0, (1, 8, 64))


def test_infer_model_from_params():
    assert infer_model({"w": np.zeros((3, 5))}).name == "linear"
    m = infer_model({"w1": np.zeros((16, 5)), "b1": np.zeros(16),
                     "w2": np.zeros((3, 16))})
    assert m.name == "mlp16"
    with pytest.raises(ValueError, match="explicitly"):
        infer_model({"conv1": np.zeros((3, 3, 1, 8))})


def test_conv_model_serves_with_explicit_input_dim():
    model = conv_model((4,))
    d = 64  # 8x8 images
    params = model.init(torch.Generator().manual_seed(0), d, C)
    engine = ServingEngine(params, model=model, input_dim=d, buckets=(8,))
    assert engine.input_dim == d
    X = np.random.RandomState(9).randn(6, d).astype(np.float32)
    np.testing.assert_array_equal(
        engine.predict(X),
        model.apply(params, torch.from_numpy(X)).numpy())


# -- checkpoint -> engine parity ------------------------------------------

def _trained(kernel_type="linear", D=64, seed=3):
    ds = load_dataset("digits", num_partitions=4, alpha=0.5)
    setup = prepare_setup(ds, D=D, kernel_type=kernel_type, kernel_par=0.1,
                          seed=seed, rng=np.random.RandomState(seed),
                          device="cpu")
    res = FedAvg(setup, lr=0.5, epoch=1, round=2, seed=0,
                 lr_mode="constant", return_state=True)
    return ds, setup, res


def _accuracy(logits, y):
    """The evaluator's accuracy expression on served logits."""
    from fedamw_tpu_torch.ops.metrics import top1_correct

    return float(100.0 * torch.mean(top1_correct(torch.from_numpy(logits),
                                                 y)))


def test_checkpoint_roundtrip_serving_parity(tmp_path):
    """save_checkpoint -> ServingEngine.load -> logits bitwise the
    in-memory model's on the same rows, accuracy the evaluator's."""
    ds, setup, res = _trained()
    save_checkpoint(str(tmp_path / "ck"), res["params"], p=res["p"])
    engine = ServingEngine.load(str(tmp_path / "ck"), buckets=(1, 8, 512))
    X = setup.X_test.numpy()
    got = engine.predict(X)
    want = setup.model.apply(res["params"], setup.X_test).numpy()
    np.testing.assert_array_equal(got, want)
    _, acc = make_evaluator(setup.model.apply, setup.task)(
        res["params"], setup.X_test, setup.y_test)
    assert _accuracy(got, setup.y_test) == float(acc)


def test_fused_rff_serving_matches_evaluate(tmp_path):
    """A checkpoint saved with the RFF draw serves RAW rows through the
    fused map, bitwise the in-memory map then apply."""
    ds, setup, res = _trained(kernel_type="gaussian", D=128)
    save_checkpoint(str(tmp_path / "ck"), res["params"], p=res["p"],
                    rff=setup.rff)
    engine = ServingEngine.load(str(tmp_path / "ck"), buckets=(512,))
    assert engine.rff is not None
    assert engine.input_dim == ds.d
    got = engine.predict(np.asarray(ds.X_test, np.float32))
    want = setup.model.apply(res["params"], setup.X_test).numpy()
    np.testing.assert_array_equal(got, want)


def test_fedamw_checkpoint_serving_accuracy_parity(tmp_path):
    """A FedAMW checkpoint with its RFF draw (what the driver's
    --save_models writes) served through the engine reproduces the
    evaluator's test accuracy exactly, and p round-trips."""
    from fedamw_tpu_torch.utils import load_checkpoint

    ds = load_dataset("digits", num_partitions=4, alpha=0.5)
    setup = prepare_setup(ds, D=128, kernel_par=0.1, seed=5,
                          rng=np.random.RandomState(5), device="cpu")
    res = FedAMW(setup, lr=0.5, epoch=1, round=2, lambda_reg=1e-4,
                 lr_p=1e-2, seed=0, lr_mode="constant", return_state=True)
    save_checkpoint(str(tmp_path / "amw"), res["params"], p=res["p"],
                    round_idx=2, rff=setup.rff)
    engine = ServingEngine.load(str(tmp_path / "amw"))
    _, acc = make_evaluator(setup.model.apply, setup.task)(
        res["params"], setup.X_test, setup.y_test)
    logits = engine.predict(np.asarray(ds.X_test, np.float32))
    assert _accuracy(logits, setup.y_test) == float(acc)
    state = load_checkpoint(str(tmp_path / "amw"))
    np.testing.assert_array_equal(state["p"], res["p"].numpy())


def test_feature_dtype_matches_narrow_feature_training():
    """The bf16 cast applies after the fused map and on pre-mapped rows,
    bitwise the training side's ``rff_map_to``, and it changes the
    result against float32 features."""
    from fedamw_tpu_torch.ops.rff import rff_map_to, rff_params

    rng = np.random.RandomState(8)
    W, b = rff_params(torch.Generator().manual_seed(0), 16, 32, 1.0)
    params = {"w": rng.randn(3, 32).astype(np.float32)}
    X = rng.randn(20, 16).astype(np.float32)
    eng = ServingEngine(params, rff=(W, b), buckets=(64,),
                        feature_dtype=torch.bfloat16)
    feats = rff_map_to(torch.from_numpy(X), W, b, torch.bfloat16)
    want = (feats.float() @ torch.from_numpy(params["w"]).T).numpy()
    np.testing.assert_array_equal(eng.predict(X), want)
    f32 = ServingEngine(params, rff=(W, b), buckets=(64,))
    assert not np.array_equal(eng.predict(X), f32.predict(X))
    pre = ServingEngine(params, buckets=(64,), feature_dtype="bfloat16")
    np.testing.assert_array_equal(pre.predict(feats.float().numpy()), want)


def test_feature_dtype_marker_round_trips_through_checkpoint(tmp_path):
    from fedamw_tpu_torch.ops.rff import rff_map_to, rff_params

    rng = np.random.RandomState(10)
    W, b = rff_params(torch.Generator().manual_seed(2), 16, 32, 1.0)
    params = {"w": rng.randn(3, 32).astype(np.float32)}
    save_checkpoint(str(tmp_path / "ck"), params, rff=(W, b),
                    feature_dtype=torch.bfloat16)
    eng = ServingEngine.load(str(tmp_path / "ck"), buckets=(64,))
    assert str(eng.feature_dtype) == "bfloat16"
    X = rng.randn(12, 16).astype(np.float32)
    feats = rff_map_to(torch.from_numpy(X), W, b, torch.bfloat16)
    want = (feats.float() @ torch.from_numpy(params["w"]).T).numpy()
    np.testing.assert_array_equal(eng.predict(X), want)


def test_checkpoint_refusals(tmp_path):
    """No params: CheckpointError naming the path. An orbax layout:
    CheckpointError (this package reads the pickle layout only)."""
    import pickle

    bad = tmp_path / "noparams"
    bad.mkdir()
    with open(bad / "state.pkl", "wb") as f:
        pickle.dump({"p": np.ones(2)}, f)
    with pytest.raises(CheckpointError, match="no 'params'"):
        ServingEngine.load(str(bad))
    orbax = tmp_path / "orbax_ck"
    (orbax / "orbax").mkdir(parents=True)
    with pytest.raises(CheckpointError, match="orbax"):
        ServingEngine.load(str(orbax))


# -- padding, chunking, shapes ----------------------------------------------

def test_padding_rows_are_inert():
    """What fills the rest of a rung never changes a valid row: bitwise
    at one rung, and at ``ROWS`` across rungs."""
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(3, 16).astype(np.float32)}
    engine = ServingEngine(params, buckets=(8, 64))
    X = rng.randn(5, 16).astype(np.float32)  # pads 5 -> 8 with zeros
    got = engine.predict(X)
    filled = np.concatenate([X, 1e3 * rng.randn(3, 16).astype(np.float32)])
    np.testing.assert_array_equal(got, engine.predict(filled)[:5])
    across = engine.predict(np.concatenate([X, X]))[:5]  # rung 64
    np.testing.assert_allclose(got, across, **ROWS)
    np.testing.assert_array_equal(got.argmax(-1), across.argmax(-1))


def test_single_row_and_oversized_requests():
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(3, 16).astype(np.float32)}
    engine = ServingEngine(params, buckets=(1, 8))
    row = rng.randn(16).astype(np.float32)
    out = engine.predict(row)
    assert out.shape == (3,)
    np.testing.assert_array_equal(out, engine.predict(row[None, :])[0])
    X = rng.randn(20, 16).astype(np.float32)  # > max rung 8: chunked
    assert engine.predict(X).shape == (20, 3)
    np.testing.assert_array_equal(engine.predict(X)[3:7],
                                  engine.predict(X[3:7]))
    with pytest.raises(ValueError, match="expected"):
        engine.predict(rng.randn(4, 7))


def test_warmed_engine_serves_mixed_stream_with_zero_new_shapes():
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(4, 32).astype(np.float32)}
    engine = ServingEngine(params, buckets=(1, 8, 64))
    warm = engine.warmup()
    assert warm == engine.compile_count == 3  # one shape per rung
    for n in (1, 2, 3, 7, 8, 9, 33, 64, 64, 5, 150, 1):
        engine.predict(rng.randn(n, 32).astype(np.float32))
    assert engine.compile_count == warm


def test_engine_on_serving_mesh_matches_single_device():
    """Weights on every slice, the rung's rows split over 4 CPU slices:
    rungs round UP to multiples of 4, logits equal one device's."""
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(3, 16).astype(np.float32)}
    mesh = make_serving_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.axis_name == "batch"
    sharded = ServingEngine(params, buckets=(1, 8, 63), mesh=mesh)
    assert sharded.buckets == (4, 8, 64)
    plain = ServingEngine(params, buckets=(4, 8, 64))
    for n in (1, 5, 40, 64, 70):
        X = rng.randn(n, 16).astype(np.float32)
        got, want = sharded.predict(X), plain.predict(X)
        np.testing.assert_allclose(got, want, **ROWS)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert sharded.warmup() == 3
    assert sharded.install_rung(10) == 12


def test_batch_spec_places_equal_slices():
    from fedamw_tpu_torch.parallel import batch_spec, replicated

    mesh = make_serving_mesh(4, device="cpu")
    parts = batch_spec(mesh).place(np.arange(16, dtype=np.float32)
                                   .reshape(8, 2))
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy().ravel(),
                                  np.arange(16))
    assert replicated(mesh) == mesh.devices
    with pytest.raises(ValueError, match="evenly"):
        batch_spec(mesh).place(np.zeros((6, 2), np.float32))


# -- versioned weight store ---------------------------------------------

def _engine(buckets=(1, 8, 32), rff=False, **kw):
    rng = np.random.RandomState(1)
    r = None
    if rff:
        r = (rng.randn(8, D).astype(np.float32),
             rng.randn(D).astype(np.float32))
        kw.setdefault("params", {"w": rng.randn(C, D).astype(np.float32)})
    params = kw.pop("params", _base(seed=0))
    e = ServingEngine(params, rff=r, buckets=buckets, **kw)
    e.warmup()
    return e


def _base(scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (scale * rng.randn(C, D)).astype(np.float32)}


def test_swap_same_shapes_and_output_flip():
    engine = _engine()
    cc = engine.compile_count
    X = np.random.RandomState(2).randn(5, D).astype(np.float32)
    before = engine.predict(X)
    for k in range(3):
        v = engine.swap_weights(_base(scale=2.0 + k, seed=9))
        assert v == k + 1 and engine.version == v
    after = engine.predict(X)
    assert not np.array_equal(before, after)
    np.testing.assert_allclose(after, X @ _base(4.0, 9)["w"].T, **TOL)
    assert engine.compile_count == cc  # flat across three swaps
    assert engine.swap_count == 3
    assert engine.versions_installed == [3]  # replaced versions retired


def test_swap_rejects_incompatible_and_leaves_live_serving():
    engine = _engine()
    X = np.random.RandomState(3).randn(4, D).astype(np.float32)
    live = engine.predict(X)
    with pytest.raises(ValueError, match="shape or dtype"):
        engine.swap_weights({"w": np.zeros((C, D + 1), np.float32)})
    with pytest.raises(ValueError, match="shape or dtype"):
        engine.swap_weights({"w": np.zeros((C, D), np.float16)})
    with pytest.raises(ValueError, match="structure"):
        engine.swap_weights({"w": np.zeros((C, D), np.float32),
                             "b": np.zeros(C, np.float32)})
    with pytest.raises(ValueError, match="rff-ness"):
        engine.swap_weights(_base(), rff=(np.zeros((4, D), np.float32),
                                          np.zeros(D, np.float32)))
    fused = _engine(rff=True)
    with pytest.raises(ValueError, match="RFF draw shape"):
        fused.swap_weights(fused.params, rff=(
            np.zeros((9, D), np.float32), np.zeros(D, np.float32)))
    with pytest.raises(ValueError, match="rff-ness"):
        fused.swap_weights(fused.params)
    with pytest.raises(ValueError, match="needs params or version"):
        engine.swap_weights()
    assert engine.version == 0 and engine.swap_count == 0
    np.testing.assert_array_equal(engine.predict(X), live)


def test_auto_version_swap_never_clobbers_staged_candidate():
    engine = _engine()
    engine.install_weights(1, _base(seed=4))
    v = engine.swap_weights(_base(seed=5))
    assert v == 2  # past the staged slot, not live+1
    assert engine.versions_installed == [1, 2]
    X = np.random.RandomState(4).randn(3, D).astype(np.float32)
    np.testing.assert_allclose(engine.predict(X, version=1),
                               X @ _base(seed=4)["w"].T, **TOL)


def test_install_retire_and_explicit_version_dispatch():
    engine = _engine()
    X = np.random.RandomState(5).randn(6, D).astype(np.float32)
    live = engine.predict(X)
    engine.install_weights(7, _base(seed=6))
    assert engine.versions_installed == [0, 7]
    np.testing.assert_array_equal(engine.predict(X), live)  # not routed
    cand = engine.predict(X, version=7)
    np.testing.assert_allclose(cand, X @ _base(seed=6)["w"].T, **TOL)
    with pytest.raises(ValueError, match="already installed"):
        engine.install_weights(7, _base(seed=6))
    with pytest.raises(ValueError, match="is live"):
        engine.install_weights(0, _base(seed=6))
    assert engine.swap_weights(version=7) == 7
    np.testing.assert_array_equal(engine.predict(X), cand)
    with pytest.raises(ValueError, match="is live"):
        engine.retire(7)
    engine.retire(0)
    with pytest.raises(KeyError, match="not installed"):
        engine.retire(0)
    with pytest.raises(KeyError, match="not installed"):
        engine.predict(X, version=0)
    with pytest.raises(KeyError, match="not installed"):
        engine.swap_weights(version=3)


def test_swap_explicit_version_refuses_installed_slot():
    engine = _engine()
    engine.install_weights(2, _base(seed=7))
    with pytest.raises(ValueError, match="already installed"):
        engine.swap_weights(_base(seed=8), version=2)
    with pytest.raises(ValueError, match="is live"):
        engine.swap_weights(_base(seed=8), version=0)
    assert engine.versions_installed == [0, 2] and engine.version == 0


def test_timings_record_bucket_version_and_pop_clears():
    engine = _engine()
    engine.pop_timings()
    engine.predict(np.zeros((3, D), np.float32))
    t = engine.pop_timings()
    assert t["bucket"] == 8 and t["version"] == 0
    assert t["pad_s"] >= 0 and t["dispatch_s"] > 0
    assert engine.pop_timings() is None
    engine.predict(np.zeros((3, D), np.float32), record_timings=False)
    assert engine.pop_timings() is None


def test_concurrent_predict_and_swaps_serve_one_version_each():
    """Under concurrent dispatch and rapid swaps every output is EXACTLY
    one version's (the weights and the fused draw never mix), and the
    shape count stays flat."""
    engine = _engine(rff=True)
    cc = engine.compile_count
    X = np.random.RandomState(6).randn(5, 8).astype(np.float32)
    versions = {0: engine.predict(X)}
    rng = np.random.RandomState(11)
    staged = [({"w": rng.randn(C, D).astype(np.float32)},
               (rng.randn(8, D).astype(np.float32),
                rng.randn(D).astype(np.float32))) for _ in range(4)]
    for k, (p, r) in enumerate(staged, start=1):
        ref = ServingEngine(p, rff=r, buckets=(8,))
        versions[k] = ref.predict(X)
    outs, stop = [], threading.Event()

    def pump():
        while not stop.is_set():
            outs.append(engine.predict(X))

    th = threading.Thread(target=pump)
    th.start()
    for p, r in staged:
        engine.swap_weights(p, rff=r)
        time.sleep(0.005)
    stop.set()
    th.join(timeout=30)
    assert outs
    for o in outs:
        assert any(np.array_equal(o, v) for v in versions.values())
    assert engine.compile_count == cc


# -- rung lifecycle ---------------------------------------------------------

def test_install_rung_prewarms_and_serves_without_a_new_shape():
    engine = _engine(buckets=(1, 8))
    assert engine.compile_count == 2
    engine.install_rung(4)
    assert engine.buckets == (1, 4, 8)
    cc = engine.compile_count
    assert cc == 3  # the install's one warm dispatch, paid upfront
    out = engine.predict(np.random.RandomState(0).randn(3, D)
                         .astype(np.float32))
    assert out.shape == (3, C)
    assert engine.compile_count == cc
    with pytest.raises(ValueError, match="already a ladder rung"):
        engine.install_rung(4)
    with pytest.raises(ValueError, match="positive"):
        engine.install_rung(0)


def test_retire_rung_keeps_shapes_and_floor():
    engine = _engine(buckets=(1, 8, 64))
    cc = engine.compile_count
    engine.retire_rung(8)
    assert engine.buckets == (1, 64)
    engine.predict(np.random.RandomState(1).randn(5, D).astype(np.float32))
    assert engine.compile_count == cc
    with pytest.raises(KeyError):
        engine.retire_rung(8)
    engine.retire_rung(1)
    with pytest.raises(ValueError, match="last rung"):
        engine.retire_rung(64)


def test_predict_latched_ladder_survives_concurrent_retire():
    engine = _engine(buckets=(1, 8, 64))
    cc = engine.compile_count
    weights = engine._resolve(None)
    ladder = engine.buckets
    engine.retire_rung(64)
    timings = {"pad_s": 0.0, "dispatch_s": 0.0}
    out = engine._run(np.zeros((40, D), np.float32), weights, timings,
                      ladder)
    assert out.shape == (40, C)
    assert timings["bucket"] == 64
    assert engine.compile_count == cc


def test_offthread_install_race_with_live_traffic():
    engine = _engine(buckets=(1, 8, 64))
    rng = np.random.RandomState(3)
    payloads = [rng.randn(k, D).astype(np.float32)
                for k in (1, 3, 5, 8, 13, 40)]
    want = [engine.predict(x) for x in payloads]
    stop, errors, served = threading.Event(), [], [0]

    def pump(svc):
        k = 0
        try:
            while not stop.is_set():
                i = k % len(payloads)
                out = svc.submit(payloads[i]).result(timeout=30)
                # the ladder changes under the request: another rung
                np.testing.assert_allclose(out, want[i], **ROWS)
                served[0] += 1
                k += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with ServingService(engine, mode="continuous") as svc:
        th = threading.Thread(target=pump, args=(svc,))
        th.start()
        time.sleep(0.02)
        for b in (4, 16, 32):
            engine.install_rung(b)
        cc_after_installs = engine.compile_count
        engine.retire_rung(64)
        time.sleep(0.05)
        stop.set()
        th.join(timeout=30)
    assert errors == [] and served[0] > 0
    assert engine.buckets == (1, 4, 8, 16, 32)
    assert cc_after_installs == 6 and engine.compile_count == 6


# -- the artifact plane's refusals, and no silent CPU ------------------------

def test_artifact_plane_is_refused_with_its_roadmap_item():
    """The artifact plane is ported (``tests/test_torch_serve_artifacts.py``);
    what it refuses here is the JAX engine's: ``aot=`` on an eager
    engine (a ``ValueError``, the ladder untouched) and a directory that
    holds no artifact (typed)."""
    from fedamw_tpu_torch.serving import ArtifactIncompatible

    engine = _engine(buckets=(1, 8))
    with pytest.raises(ValueError, match="artifact-loaded engines"):
        engine.install_rung(4, aot=lambda x, p, r: x)
    assert engine.buckets == (1, 8)
    with pytest.raises(ArtifactIncompatible, match="manifest"):
        ServingEngine.from_artifact("nowhere", device="cpu")


def test_engine_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = _base()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ServingEngine(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_mesh()
    assert _ServingEngine(params, device="cpu").device.type == "cpu"


def test_engine_runs_conv_in_full_fp32(monkeypatch):
    """The forward runs under full_fp32: TF32 off for the products and
    cuDNN while it runs, restored after."""
    from fedamw_tpu_torch.fedcore import aggregate

    seen = []
    model = get_model("conv4")
    params = model.init(torch.Generator().manual_seed(1), 64, C)
    real = model.apply

    def spy(p, x):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cudnn.allow_tf32))
        return real(p, x)

    import dataclasses

    eng = ServingEngine(params, model=dataclasses.replace(model, apply=spy),
                        input_dim=64, buckets=(8,))
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)
    eng.predict(np.zeros((3, 64), np.float32))
    assert seen == [("highest", False)]
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32) == prev
    assert aggregate._FP32_HOLD["depth"] == 0


def test_full_fp32_pins_deterministic_convolutions():
    """Inside ``full_fp32`` cuDNN runs its deterministic algorithms (a
    rerun of a convolution's backward gives the same bits), restored
    after the last block, nested or not."""
    from fedamw_tpu_torch.fedcore.aggregate import full_fp32

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        with full_fp32():
            assert torch.backends.cudnn.deterministic is True
            with full_fp32():
                assert torch.backends.cudnn.deterministic is True
            assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.deterministic is False
    finally:
        torch.backends.cudnn.deterministic = prev


def test_full_fp32_holds_under_concurrent_threads():
    """More threads than cores entering and leaving ``full_fp32`` at
    once, with a short switch interval: inside a block the settings are
    always full fp32, and the last block out restores the caller's."""
    import os

    from fedamw_tpu_torch.fedcore.aggregate import full_fp32

    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    seen, errors = [], []
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker():
        try:
            for _ in range(200):
                with full_fp32():
                    seen.append((torch.get_float32_matmul_precision(),
                                 torch.backends.cudnn.allow_tf32))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert errors == []
        assert len(seen) == 200 * len(threads)
        assert set(seen) == {("highest", False)}
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32) == ("high", True)
    finally:
        sys.setswitchinterval(old_interval)
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused-rff", "mlp16", "conv4x8", "bf16",
                                  "bf16-fused"])
def test_engine_on_the_card_matches_its_cpu_run(name, tmp_path, monkeypatch):
    """The same checkpoint served on the card and on the CPU, on every
    default rung: within 1e-5 (another product algorithm a shape); the
    fused bf16 case at ``BF16_FUSED`` (the card's cos and the CPU's may
    differ in the last bit before the cast, as the two packages' do)."""
    _card()
    ck, eng_kw, width, tol = _case(name)
    _poison_orbax(monkeypatch)
    path = str(tmp_path / "ck")
    jsave(path, **ck)
    card = _ServingEngine.load(path, **eng_kw)
    cpu = _ServingEngine.load(path, device="cpu", **eng_kw)
    assert card.warmup() == 5
    X = np.random.RandomState(4).randn(5000, width).astype(np.float32)
    for n in (1, 7, 64, 300, 5000):
        np.testing.assert_allclose(card.predict(X[:n]), cpu.predict(X[:n]),
                                   **tol)
    assert card.compile_count == 5


@pytest.mark.cuda
def test_engine_on_the_card_swaps_with_no_new_shape():
    _card()
    rng = np.random.RandomState(5)
    card = _ServingEngine(_base(), buckets=(1, 8, 64))
    assert card.warmup() == 3
    X = rng.randn(20, D).astype(np.float32)
    for k in range(3):
        card.swap_weights(_base(seed=10 + k))
        np.testing.assert_allclose(card.predict(X),
                                   X @ _base(seed=10 + k)["w"].T, **TOL)
    assert card.compile_count == 3
