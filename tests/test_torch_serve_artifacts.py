"""The port's cold-start plane: exported ladders and their typed
compatibility contract, case for case after ``tests/test_artifacts.py``
in this package's currency (one ``torch.export`` program a rung,
``rung_<b>.pt2``, and no native executable), on the CPU.

- **Manifest round trip**: ``export_ladder`` writes an
  ``ArtifactManifest`` whose JSON reloads field for field, and
  ``load_ladder`` on the same host validates it clean.
- **Typed incompatibility**: a manifest mismatched on any host field
  (torch or CUDA version, platform, device kind, compute capability,
  machine, CPU features, dtype, device count, program format, a native
  executable), an unknown schema, a tampered bucket set, a missing,
  altered or damaged rung program, a damaged manifest, or a weight
  signature the ladder was not exported against raises
  ``ArtifactIncompatible`` naming the field — never a fallback to
  tracing the model again.
- **from_artifact parity**: the artifact engine's logits are bitwise
  the eager engine's at every rung and pad position (the same products
  on the same rows), with ``compile_count`` 0 throughout, directly and
  through a checkpoint directory, for the linear model with and without
  the fused RFF map, ``mlp16``, ``conv4x8`` and bfloat16 features (the
  zoo's weights from the JAX package's init through
  ``convert.params_from_jax``, its answers within 1e-5 of the JAX
  engine's); a swap adds no shape.
- **Watcher and retention**: ``CheckpointWatcher(artifact_dir=...)``
  exports beside every published checkpoint; ``prune_artifacts`` keeps
  the protected versions and the newest, as the JAX package's does on
  the same directories; and the three contracts whose JAX tests are red
  under the repository's ``conftest.py`` (its 8 forced XLA:CPU devices
  and persistent cache break the JAX export's self-check; the file
  passes 27 of 27 with ``--noconftest``): retention never drops the
  protected versions, ``artifact_keep=0`` is refused, and a raising
  ``artifact_protect`` is counted and not fatal.

A ``cuda`` case exports and loads on the card, bitwise.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fedamw_tpu_torch.convert import params_from_jax
from fedamw_tpu_torch.serving import (ArtifactIncompatible,
                                      ArtifactManifest, CheckpointWatcher,
                                      ModelRegistry, ServingEngine,
                                      export_ladder, load_ladder,
                                      prune_artifacts)
from fedamw_tpu_torch.serving.artifacts import (ARTIFACT_SCHEMA,
                                                host_fingerprint,
                                                load_portable,
                                                validate_weights)
from fedamw_tpu_torch.utils.checkpoint import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

D, C = 12, 3
BUCKETS = (1, 4, 8)
CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


def make_engine(rff=True, seed=1, buckets=BUCKETS, **kw):
    rng = np.random.RandomState(seed)
    if rff:
        kw["rff"] = (rng.randn(6, D).astype(np.float32),
                     rng.randn(D).astype(np.float32))
    e = ServingEngine({"w": rng.randn(C, D).astype(np.float32)},
                      buckets=buckets, device=CPU, **kw)
    e.warmup()
    return e


def host_weights(engine):
    params = {k: v.numpy() for k, v in engine.params.items()}
    rff = engine.rff
    if rff is not None:
        rff = (rff[0].numpy(), rff[1].numpy())
    return params, rff


def _tamper(art_dir, mutate):
    path = os.path.join(art_dir, "manifest.json")
    with open(path) as f:
        obj = json.load(f)
    mutate(obj)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One exported ladder, copied afresh for each test that edits it."""
    engine = make_engine()
    d = str(tmp_path_factory.mktemp("art") / "ladder")
    export_ladder(engine, d, model_version=7, round_idx=42)
    return engine, d


@pytest.fixture
def art(exported, tmp_path):
    engine, src = exported
    dst = str(tmp_path / "ladder")
    shutil.copytree(src, dst)
    return engine, dst


# -- manifest ----------------------------------------------------------------

def test_manifest_round_trips_field_for_field(exported):
    engine, d = exported
    m = ArtifactManifest.load(d)
    assert m.schema == ARTIFACT_SCHEMA
    assert m.model_version == 7 and m.round_idx == 42
    assert m.buckets == list(BUCKETS) and m.input_dim == 6
    assert m.num_classes == C and m.model == "linear"
    assert m.host == host_fingerprint(CPU)
    assert m.program_format == "torch.export"
    assert m.native_executable is None
    assert m.param_sig == {"w": [[C, D], "float32"]}
    assert m.rff_sig == {"W": [[6, D], "float32"], "b": [[D], "float32"]}
    assert sorted(m.rungs) == [str(b) for b in sorted(BUCKETS)]
    for b, rec in m.rungs.items():
        assert rec["program"] == f"rung_{b}.pt2" and rec["bytes"] > 0
        assert os.path.getsize(os.path.join(d, rec["program"])) == \
            rec["bytes"]
    again = ArtifactManifest.from_json(json.loads(json.dumps(m.to_json())))
    assert again == m
    # no weight is in the artifact: the programs are saved without the
    # inputs they were traced on (the exporting version's weights)
    assert load_portable(d, 8).example_inputs is None


def test_load_ladder_clean_on_exporting_host(exported):
    engine, d = exported
    manifest, rungs = load_ladder(d, device=CPU)
    assert sorted(rungs) == sorted(BUCKETS)
    params, rff, _ = engine._resolve(None)
    X = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    with torch.inference_mode():
        out = rungs[4](torch.from_numpy(X), params[0], rff[0]).numpy()
    np.testing.assert_array_equal(out, engine.predict(X))


@pytest.mark.parametrize("field, mutate", [
    ("torch_version",
     lambda o: o["host"].__setitem__("torch_version", "9.9.9")),
    ("cuda_version",
     lambda o: o["host"].__setitem__("cuda_version", "99.9")),
    ("platform", lambda o: o["host"].__setitem__("platform", "cuda")),
    ("device_kind",
     lambda o: o["host"].__setitem__("device_kind", "NVIDIA H100")),
    ("compute_capability",
     lambda o: o["host"].__setitem__("compute_capability", "9.0")),
    ("machine", lambda o: o["host"].__setitem__("machine", "armv7l")),
    ("dtype", lambda o: o.__setitem__("dtype", "bfloat16")),
    ("n_devices", lambda o: o.__setitem__("n_devices", 8)),
    ("program_format",
     lambda o: o.__setitem__("program_format", "stablehlo")),
    ("native_executable",
     lambda o: o.__setitem__("native_executable", "rung_4.so")),
])
def test_each_host_field_mismatch_raises_typed(art, field, mutate):
    engine, d = art
    _tamper(d, mutate)
    params, rff = host_weights(engine)
    with pytest.raises(ArtifactIncompatible) as ei:
        ServingEngine.from_artifact(d, params=params, rff=rff, device=CPU)
    assert [f for f, _, _ in ei.value.mismatches] == [field]


def test_cpu_feature_mismatch_raises_typed(art):
    _, d = art
    if ArtifactManifest.load(d).host["cpu_features"] is None:
        pytest.skip("host CPU features not fingerprintable here")
    _tamper(d, lambda o: o["host"].__setitem__("cpu_features", "beef"))
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert any(f == "cpu_features" for f, _, _ in ei.value.mismatches)


def test_unknown_schema_and_missing_field_refused_typed(art):
    _, d = art
    with open(os.path.join(d, "manifest.json")) as f:
        clean = f.read()
    for schema in ("SERVE_ARTIFACT_TORCH.v2", "SERVE_ARTIFACT.v1"):
        _tamper(d, lambda o: o.__setitem__("schema", schema))
        with pytest.raises(ArtifactIncompatible) as ei:
            ArtifactManifest.load(d)
        assert [f for f, _, _ in ei.value.mismatches] == ["schema"]
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write(clean)
    _tamper(d, lambda o: o.pop("param_sig"))
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert any("malformed" in str(a) for _, a, _ in ei.value.mismatches)


def test_bucket_tamper_and_missing_rung_raise_typed(art):
    _, d = art
    _tamper(d, lambda o: o["rungs"].__setitem__(
        "64", {"program": "rung_64.pt2", "bytes": 1, "sha256": "0"}))
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert [f for f, _, _ in ei.value.mismatches] == ["rung[64]"]
    # a bucket set that names a rung the artifact does not hold
    _tamper(d, lambda o: (o["rungs"].pop("64"),
                          o.__setitem__("buckets", [1, 4, 8, 16])))
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert [f for f, _, _ in ei.value.mismatches] == ["rungs"]


def test_damaged_manifest_and_program_raise_typed(art):
    _, d = art
    rec = ArtifactManifest.load(d).rungs
    # a rewritten program whose bytes are not the manifest's
    with open(os.path.join(d, "rung_4.pt2"), "r+b") as f:
        f.seek(200)
        f.write(b"\x00" * 16)
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert [f for f, _, _ in ei.value.mismatches] == ["rung[4]"]
    assert "sha256" in ei.value.mismatches[0][1]
    # another rung's valid program under rung 4's name (its sha256 too):
    # the signature check names it
    shutil.copy(os.path.join(d, "rung_8.pt2"), os.path.join(d, "rung_4.pt2"))
    _tamper(d, lambda o: o["rungs"]["4"].__setitem__(
        "sha256", rec["8"]["sha256"]))
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert [f for f, _, _ in ei.value.mismatches] == ["rung[4]"]
    assert "signature" in ei.value.mismatches[0][1]
    # a truncated program, its sha256 rewritten to match: the loader's
    # own failure, typed
    with open(os.path.join(d, "rung_4.pt2"), "wb") as f:
        f.write(b"PK\x03\x04corrupt")
    import hashlib

    _tamper(d, lambda o: o["rungs"]["4"].__setitem__(
        "sha256", hashlib.sha256(b"PK\x03\x04corrupt").hexdigest()))
    with pytest.raises(ArtifactIncompatible) as ei:
        load_ladder(d, device=CPU)
    assert "loadable torch.export program" in ei.value.mismatches[0][2]
    # a manifest that is not JSON, and a directory with none
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(ArtifactIncompatible):
        load_ladder(d, device=CPU)
    with pytest.raises(ArtifactIncompatible):
        load_ladder(os.path.join(d, "nowhere"), device=CPU)


def test_weight_signature_mismatch_raises_typed(exported):
    engine, d = exported
    params, rff = host_weights(engine)
    rng = np.random.RandomState(9)
    with pytest.raises(ArtifactIncompatible) as ei:
        ServingEngine.from_artifact(
            d, params={"w": rng.randn(C, D + 1).astype(np.float32)},
            rff=rff, device=CPU)
    assert any(f.startswith("param[") for f, _, _ in ei.value.mismatches)
    with pytest.raises(ArtifactIncompatible):
        ServingEngine.from_artifact(
            d, params={"w": params["w"].astype(np.float64)}, rff=rff,
            device=CPU)
    with pytest.raises(ArtifactIncompatible) as ei:
        ServingEngine.from_artifact(d, params=params, rff=None, device=CPU)
    assert any(f == "rff_fused" for f, _, _ in ei.value.mismatches)
    with pytest.raises(ArtifactIncompatible) as ei:
        validate_weights(ArtifactManifest.load(d),
                         {"w": params["w"], "b1": params["w"]}, rff)
    assert any(f == "param_keys" for f, _, _ in ei.value.mismatches)


# -- from_artifact parity and zero compiles ------------------------------------

def test_from_artifact_parity_and_zero_compiles(exported):
    engine, d = exported
    params, rff = host_weights(engine)
    a = ServingEngine.from_artifact(d, params=params, rff=rff, device=CPU)
    assert a.compile_count == 0
    assert a.warmup() == 0 and a.compile_count == 0
    assert a.buckets == engine.buckets
    assert a.artifact_manifest == ArtifactManifest.load(d)
    rng = np.random.RandomState(3)
    # every rung, every pad position, single rows, a chunked batch
    for n in [1, 2, 3, 4, 5, 6, 7, 8, 3, 1, 20]:
        X = rng.randn(n, 6).astype(np.float32)
        np.testing.assert_array_equal(a.predict(X), engine.predict(X))
    np.testing.assert_array_equal(a.predict(X[0]), engine.predict(X[0]))
    assert a.compile_count == 0  # served every rung, dispatched no shape


def test_from_artifact_via_checkpoint_dir(tmp_path):
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(C, D).astype(np.float32)}
    rff = (rng.randn(6, D).astype(np.float32),
           rng.randn(D).astype(np.float32))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, params, p=np.ones(2) / 2, round_idx=3, rff=rff)
    engine = ServingEngine.load(ckpt, buckets=BUCKETS, device=CPU)
    art_dir = str(tmp_path / "artifact")
    export_ladder(engine, art_dir, round_idx=3)
    a = ServingEngine.from_artifact(art_dir, checkpoint=ckpt, device=CPU)
    X = rng.randn(7, 6).astype(np.float32)
    np.testing.assert_array_equal(a.predict(X), engine.predict(X))
    assert a.compile_count == 0
    with pytest.raises(ValueError, match="not both"):
        ServingEngine.from_artifact(art_dir, checkpoint=ckpt,
                                    params=params, device=CPU)
    with pytest.raises(ValueError, match="weight source"):
        ServingEngine.from_artifact(art_dir, device=CPU)


def test_artifact_engine_swaps_with_no_new_shape(exported):
    engine, d = exported
    params, rff = host_weights(engine)
    a = ServingEngine.from_artifact(d, params=params, rff=rff, device=CPU)
    rng = np.random.RandomState(7)
    X = rng.randn(5, 6).astype(np.float32)
    base = a.predict(X)
    w2 = {"w": rng.randn(C, D).astype(np.float32)}
    a.install_weights(1, w2, rff=rff)
    cand = a.predict(X, version=1)
    assert not np.array_equal(cand, base)
    a.swap_weights(version=1)
    np.testing.assert_array_equal(a.predict(X), cand)
    ref = ServingEngine(w2, rff=rff, buckets=BUCKETS, device=CPU)
    np.testing.assert_array_equal(cand, ref.predict(X))
    v = a.swap_weights({"w": -w2["w"]}, rff=rff)
    assert a.version == v
    assert a.compile_count == 0
    with pytest.raises(ValueError, match="swap-incompatible"):
        a.swap_weights({"w": rng.randn(C, D + 2).astype(np.float32)},
                       rff=rff)


def test_portable_rung_round_trips_and_matches(exported):
    engine, d = exported
    program = load_portable(d, 4)
    params, rff, _ = engine._resolve(None)
    X = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    with torch.inference_mode():
        out = program.module()(torch.from_numpy(X), params[0]["w"],
                               *rff[0]).numpy()
    np.testing.assert_array_equal(out, engine.predict(X))
    with pytest.raises(ArtifactIncompatible):
        load_portable(d, 4096)


def test_export_refuses_mesh_engines(tmp_path):
    engine = make_engine()
    engine.mesh = object()
    with pytest.raises(ValueError, match="single-device"):
        export_ladder(engine, str(tmp_path))


def test_pre_mapped_engine_exports_without_rff(tmp_path):
    engine = make_engine(rff=False)
    m = export_ladder(engine, str(tmp_path))
    assert m.rff_sig is None
    params, _ = host_weights(engine)
    a = ServingEngine.from_artifact(str(tmp_path), params=params,
                                    device=CPU)
    X = np.random.RandomState(2).randn(3, D).astype(np.float32)
    np.testing.assert_array_equal(a.predict(X), engine.predict(X))
    assert a.compile_count == 0


def _jax_params(model, d, seed=0):
    import jax

    from fedamw_tpu.models import get_model as jget_model

    params = jget_model(model).init(jax.random.PRNGKey(seed), d, C)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("case", ["mlp16", "conv4x8", "bf16-fused"])
def test_zoo_and_bf16_ladders_serve_bitwise_and_as_jax(case, tmp_path):
    """A checkpoint of the zoo (weights from the JAX package's init,
    through ``params_from_jax``) or with bf16 features: exported,
    cold-started from the checkpoint alone (``model="auto"`` takes the
    manifest's zoo name, conv included), bitwise the eager engine at
    every rung, and within 1e-5 of the JAX engine on the same rows
    (the fused map cast to bf16 within one bf16 step, as in
    ``tests/test_torch_serve_engine.py``)."""
    import fedamw_tpu.serving as jserving

    rng = np.random.RandomState(4)
    kw, jkw, tol = {}, {}, TOL
    if case == "bf16-fused":
        params = {"w": rng.randn(C, 32).astype(np.float32)}
        kw["rff"] = (rng.randn(16, 32).astype(np.float32),
                     rng.randn(32).astype(np.float32))
        kw["feature_dtype"] = "bfloat16"
        width, tol = 16, dict(rtol=0, atol=2e-3)
    else:
        width = 64 if case == "conv4x8" else 16
        params = {k: v.numpy() for k, v in params_from_jax(
            _jax_params(case, width)).items()}
    if case == "conv4x8":
        from fedamw_tpu.models import get_model as jget_model

        jkw = {"model": jget_model(case), "input_dim": width}
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, params, **kw)
    engine = ServingEngine.load(ckpt, buckets=(1, 8), device=CPU,
                                **({"model": case, "input_dim": width}
                                   if case == "conv4x8" else {}))
    export_ladder(engine, str(tmp_path / "art"))
    a = ServingEngine.from_artifact(str(tmp_path / "art"), checkpoint=ckpt,
                                    device=CPU)
    assert a.model.name == engine.model.name
    jeng = jserving.ServingEngine(params, buckets=(1, 8),
                                  rff=kw.get("rff"),
                                  feature_dtype=kw.get("feature_dtype"),
                                  **jkw)
    for n in (1, 5, 8, 13):
        X = rng.randn(n, width).astype(np.float32)
        got = a.predict(X)
        np.testing.assert_array_equal(got, engine.predict(X))
        np.testing.assert_allclose(got, jeng.predict(X), **tol)
    assert a.compile_count == 0


def test_install_rung_from_a_re_exported_ladder(tmp_path):
    """Re-bucketing an artifact engine adds no shape: the new rung comes
    from a re-exported ladder's program (``aot=``), runs once at
    install, and serves; an install without it, a program of another
    rung, and ``aot=`` on an eager engine are refused."""
    engine = make_engine(buckets=(1, 8))
    export_ladder(engine, str(tmp_path / "a"))
    params, rff = host_weights(engine)
    a = ServingEngine.from_artifact(str(tmp_path / "a"), params=params,
                                    rff=rff, device=CPU)
    wider = make_engine(buckets=(1, 4, 8))
    export_ladder(wider, str(tmp_path / "b"))
    _, rungs = load_ladder(str(tmp_path / "b"), device=CPU)
    with pytest.raises(ValueError, match="aot="):
        a.install_rung(4)
    with pytest.raises(ValueError, match="not rung 4"):
        a.install_rung(4, aot=rungs[8])
    assert a.install_rung(4, aot=rungs[4]) == 4
    assert a.buckets == (1, 4, 8)
    X = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    np.testing.assert_array_equal(a.predict(X), wider.predict(X))
    assert a.compile_count == 0
    with pytest.raises(ValueError, match="artifact-loaded"):
        engine.install_rung(4, aot=rungs[4])
    assert engine.buckets == (1, 8)


def test_from_artifact_refuses_to_fall_back_to_the_cpu(exported,
                                                       monkeypatch):
    engine, d = exported
    params, rff = host_weights(engine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_artifact(d, params=params, rff=rff)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_ladder(d)


# -- watcher and retention ---------------------------------------------------

def _publish_ckpt(dirpath, seed=11):
    rng = np.random.RandomState(seed)
    save_checkpoint(str(dirpath), {"w": rng.randn(C, D).astype(
        np.float32)}, p=np.ones(2) / 2, round_idx=seed)


def test_watcher_publishes_artifacts_beside_checkpoints(tmp_path):
    watch, art_root = tmp_path / "ckpts", tmp_path / "artifacts"
    watch.mkdir()
    _publish_ckpt(watch / "v0001", seed=1)
    _publish_ckpt(watch / "v0002", seed=2)
    w = CheckpointWatcher(ModelRegistry(), str(watch),
                          artifact_dir=str(art_root),
                          artifact_buckets=(1, 4), device=CPU)
    assert w.poll_once() == [1, 2]
    assert [n for n, _ in w.artifacts] == ["v0001", "v0002"]
    assert w.errors == 0
    for name, art_dir in w.artifacts:
        eng = ServingEngine.from_artifact(art_dir,
                                          checkpoint=str(watch / name),
                                          device=CPU)
        assert eng.compile_count == 0 and eng.buckets == (1, 4)
        assert ArtifactManifest.load(art_dir).model_version == \
            dict(w.published)[name]


def test_prune_artifacts_keeps_protected_and_newest_as_jax(tmp_path):
    from fedamw_tpu.serving.artifacts import (
        prune_artifacts as jprune_artifacts)

    removed = {}
    for pkg, prune in (("torch", prune_artifacts),
                       ("jax", jprune_artifacts)):
        art = tmp_path / pkg
        for i in range(1, 7):
            (art / f"v{i:04d}").mkdir(parents=True)
        (art / "not_a_version").mkdir()
        got = [prune(str(art), keep=3, protect=(2, "v0003")),
               sorted(os.listdir(art)), prune(str(art), keep=3),
               prune(str(tmp_path / "never_exported"), 1),
               prune(str(art), keep=1, protect="v0002"),
               sorted(os.listdir(art))]
        with pytest.raises(ValueError, match="keep must be >= 0"):
            prune(str(art), keep=-1)
        removed[pkg] = got
    assert removed["torch"] == removed["jax"]
    assert removed["torch"][0] == ["v0001", "v0004", "v0005"]
    assert removed["torch"][-1] == ["not_a_version", "v0002"]


def test_watcher_artifact_retention_never_drops_protected(tmp_path):
    """``artifact_keep=N``: each export prunes to N, always keeping the
    just-exported ladder plus whatever ``artifact_protect()`` pins."""
    watch, art_root = tmp_path / "ckpts", tmp_path / "artifacts"
    watch.mkdir()
    for i in (1, 2, 3):
        _publish_ckpt(watch / f"v{i:04d}", seed=i)
    protected = ["v0001"]
    w = CheckpointWatcher(ModelRegistry(), str(watch),
                          artifact_dir=str(art_root), artifact_buckets=(1,),
                          artifact_keep=1,
                          artifact_protect=lambda: tuple(protected),
                          device=CPU)
    assert w.poll_once() == [1, 2, 3]
    assert w.errors == 0
    assert sorted(os.listdir(art_root)) == ["v0001", "v0003"]
    assert w.artifacts_pruned == ["v0002"]
    eng = ServingEngine.from_artifact(str(art_root / "v0001"),
                                      checkpoint=str(watch / "v0001"),
                                      device=CPU)
    assert eng.compile_count == 0
    protected.clear()
    _publish_ckpt(watch / "v0004", seed=4)
    assert w.poll_once() == [4]
    assert sorted(os.listdir(art_root)) == ["v0004"]
    assert w.artifacts_pruned == ["v0002", "v0001", "v0003"]


def test_watcher_artifact_keep_validations(tmp_path):
    """keep=0 would delete the export that just landed — refused at
    construction; a raising protect callable counts in errors and never
    takes the publish or the export down."""
    watch = tmp_path / "ckpts"
    watch.mkdir()
    _publish_ckpt(watch / "v0001")
    with pytest.raises(ValueError, match="artifact_keep"):
        CheckpointWatcher(ModelRegistry(), str(watch),
                          artifact_dir=str(tmp_path / "a"),
                          artifact_keep=0, device=CPU)

    def broken_protect():
        raise RuntimeError("controller gone")

    w = CheckpointWatcher(ModelRegistry(), str(watch),
                          artifact_dir=str(tmp_path / "a"),
                          artifact_buckets=(1,), artifact_keep=1,
                          artifact_protect=broken_protect, device=CPU)
    assert w.poll_once() == [1]
    assert [n for n, _ in w.artifacts] == ["v0001"]
    assert w.errors == 1 and w.artifacts_pruned == []


def test_watcher_artifact_failure_counts_not_fatal(tmp_path):
    watch = tmp_path / "ckpts"
    watch.mkdir()
    _publish_ckpt(watch / "v0001")
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where a directory must go")
    w = CheckpointWatcher(ModelRegistry(), str(watch),
                          artifact_dir=str(blocked / "sub"),
                          artifact_buckets=(1,), device=CPU)
    assert w.poll_once() == [1]
    assert w.errors == 1 and w.artifacts == []


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused", "mlp16", "conv4x8", "bf16"])
def test_artifact_on_the_card_is_bitwise_its_engine(case, tmp_path):
    """Exported on the card and loaded there: every rung and pad
    position bitwise the eager engine on the card, ``compile_count`` 0,
    and the manifest names the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(6)
    kw, width = {}, 16
    if case in ("fused", "bf16"):
        params = {"w": rng.randn(C, 64).astype(np.float32)}
        kw["rff"] = (rng.randn(16, 64).astype(np.float32),
                     rng.randn(64).astype(np.float32))
        if case == "bf16":
            kw["feature_dtype"] = "bfloat16"
    else:
        width = 64 if case == "conv4x8" else 16
        params = {k: v.numpy() for k, v in params_from_jax(
            _jax_params(case, width)).items()}
        if case == "conv4x8":
            kw.update(model=case, input_dim=width)
    engine = ServingEngine(params, buckets=(1, 8, 64), **kw)
    engine.warmup()
    m = export_ladder(engine, str(tmp_path))
    assert m.host["platform"] == "cuda"
    assert m.host["device_kind"] == torch.cuda.get_device_name(0)
    a = ServingEngine.from_artifact(str(tmp_path), params=params,
                                    rff=kw.get("rff"))
    for n in (1, 3, 8, 9, 64, 100):
        X = rng.randn(n, width).astype(np.float32)
        np.testing.assert_array_equal(a.predict(X), engine.predict(X))
    assert a.compile_count == 0
