"""The port's cold-start export CLI (``python -m
fedamw_tpu_torch.export_artifacts``) against the repository's
``tools/export_artifacts.py``.

- As a subprocess on the CPU (``--device cpu``) on a port checkpoint with
  its RFF draw: exit 0, the summary line has exactly the JAX CLI's keys
  (read from that script's source), the ``SERVE_ARTIFACT_TORCH.v1``
  schema, ``check.compile_count == 0`` and bitwise parity; the artifact
  then cold-starts in process and serves bitwise as the engine.
- A checkpoint that does not load: exit 1, a ``#`` line on stderr and no
  summary, as the JAX CLI answers the same directory in process.
- Each failure of ``--check`` (a typed ``ArtifactIncompatible``, a rung
  whose logits differ, an eager dispatch at load) exits 1 with a ``#``
  line and no summary, in the port's CLI and in the JAX CLI driven
  through the same stubs; the refusal names the port's CLI.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import fedamw_tpu.serving as jserving
import fedamw_tpu.serving.artifacts as jartifacts
import fedamw_tpu.utils.checkpoint as jcheckpoint
from fedamw_tpu_torch import export_artifacts
from fedamw_tpu_torch.serving import ArtifactIncompatible, ServingEngine
from fedamw_tpu_torch.serving.artifacts import ARTIFACT_SCHEMA
from fedamw_tpu_torch.utils import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_CLI = REPO / "tools" / "export_artifacts.py"
C, D, RAW = 3, 16, 6


def _jax_summary_keys():
    """The keys of the JAX CLI's summary and of its ``check`` entry, from
    its source: the dict literal bound to ``summary`` and the one stored
    under ``summary["check"]``."""
    tree = ast.parse(JAX_CLI.read_text())
    top = check = None
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Dict):
            continue
        keys = [k.value for k in node.value.keys]
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "summary":
            top = keys
        elif (isinstance(target, ast.Subscript)
              and isinstance(target.value, ast.Name)
              and target.value.id == "summary"):
            check = keys
    assert top and check
    return top, check


def _checkpoint(path):
    rng = np.random.RandomState(4)
    rff = (rng.randn(RAW, D).astype(np.float32),
           rng.randn(D).astype(np.float32))
    save_checkpoint(str(path), {"w": rng.randn(C, D).astype(np.float32)},
                    p=np.ones(2) / 2, round_idx=5, rff=rff)
    return str(path)


def _run_cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "fedamw_tpu_torch.export_artifacts", *args],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)


def test_cli_exports_and_checks_with_the_jax_summary(tmp_path):
    ck = _checkpoint(tmp_path / "ck")
    art = tmp_path / "artifact"
    out = _run_cli(ck, str(art), "--buckets", "1,4", "--check",
                   "--version", "3", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    top, check = _jax_summary_keys()
    assert list(summary) == top + ["check"]
    assert list(summary["check"]) == check
    assert summary["schema"] == ARTIFACT_SCHEMA == "SERVE_ARTIFACT_TORCH.v1"
    assert summary["check"]["compile_count"] == 0
    assert summary["check"]["parity"] == "bitwise"
    assert (summary["rungs"], summary["buckets"]) == (2, [1, 4])
    assert summary["bytes"] == sum(
        os.path.getsize(art / f"rung_{b}.pt2") for b in (1, 4))
    assert (summary["round_idx"], summary["model_version"]) == (5, 3)
    assert summary["host"]["platform"] == "cpu"
    assert summary["artifact"] == str(art.resolve())
    assert out.stderr.strip().splitlines()[-1].startswith("# exported 2 rungs")
    # the artifact the CLI wrote cold-starts here and serves bitwise
    loaded = ServingEngine.from_artifact(str(art), checkpoint=ck,
                                         device="cpu")
    engine = ServingEngine.load(ck, buckets=(1, 4), device="cpu")
    X = np.random.RandomState(1).randn(4, RAW).astype(np.float32)
    assert np.array_equal(loaded.predict(X), engine.predict(X))
    assert loaded.compile_count == 0


def _jax_cli_main():
    spec = importlib.util.spec_from_file_location("_jax_export_cli",
                                                  JAX_CLI)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _refusal(rc, out, err):
    """(exit code, the first ``#`` line's words before its detail, the
    stdout summary lines)."""
    lines = [ln for ln in err.splitlines() if ln.startswith("#")]
    head = lines[0].split(":")[:2] if lines else None
    return rc, head, [ln for ln in out.splitlines() if ln.startswith("{")]


def test_unloadable_checkpoint_is_refused_as_the_jax_cli_refuses_it(
        tmp_path, capsys):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "state.pkl").write_bytes(b"not a pickle")
    out = _run_cli(str(bad), str(tmp_path / "a"), "--device", "cpu")
    got = _refusal(out.returncode, out.stdout, out.stderr)
    rc = _jax_cli_main()([str(bad), str(tmp_path / "b")])
    cap = capsys.readouterr()
    want = _refusal(rc, cap.out, cap.err)
    assert got == want == (1, ["# export_artifacts",
                               " cannot load checkpoint"], [])
    assert str(bad / "state.pkl") in out.stderr
    assert not (tmp_path / "a").exists()


class _Engine:
    """Stands for a served engine: its buckets, width, logits and
    eager-dispatch count."""

    def __init__(self, buckets=(1, 4), shift=0.0, compile_count=0):
        self.buckets, self.input_dim = buckets, RAW
        self.shift, self.compile_count = shift, compile_count

    def predict(self, X):
        return X[:, :C] * 2.0 + self.shift


def _manifest(schema):
    return types.SimpleNamespace(
        schema=schema, buckets=[1, 4], rungs={"1": {"bytes": 8},
                                              "4": {"bytes": 8}},
        host={"platform": "cpu"}, round_idx=5, model_version=None)


def _failing_check(case, incompatible):
    def from_artifact(*a, **k):
        if case == "incompatible":
            raise incompatible("art", [("device_kind", "a", "b")])
        if case == "rung differs":
            return _Engine(shift=1e-7)
        return _Engine(compile_count=1)

    return from_artifact


@pytest.mark.parametrize("case", ("incompatible", "rung differs",
                                  "eager dispatch"))
def test_failed_checks_exit_1_as_the_jax_cli_does(case, tmp_path,
                                                  monkeypatch, capsys):
    argv = [str(tmp_path / "ck"), str(tmp_path / "art"), "--check"]
    state = {"params": {}, "round": 5}
    results = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            engine_cls, mod = jserving.ServingEngine, jartifacts
            monkeypatch.setattr(jcheckpoint, "load_checkpoint",
                                lambda path: state)
            incompatible = jartifacts.ArtifactIncompatible
            main = _jax_cli_main()
        else:
            engine_cls, mod = ServingEngine, export_artifacts
            monkeypatch.setattr(export_artifacts, "load_checkpoint",
                                lambda path: state)
            incompatible = ArtifactIncompatible
            main = export_artifacts.main
            argv = argv + ["--device", "cpu"]
        monkeypatch.setattr(engine_cls, "load",
                            classmethod(lambda cls, *a, **k: _Engine()))
        monkeypatch.setattr(engine_cls, "from_artifact", classmethod(
            lambda cls, *a, **k: _failing_check(case, incompatible)()))
        monkeypatch.setattr(mod, "export_ladder",
                            lambda *a, **k: _manifest(pkg))
        rc = main(argv)
        cap = capsys.readouterr()
        results[pkg] = _refusal(rc, cap.out, cap.err)
        if pkg == "port" and case == "incompatible":
            assert "python -m fedamw_tpu_torch.export_artifacts" in cap.err
    assert results["jax"] == results["port"] == (
        1, ["# export_artifacts", " check FAILED"], [])


def test_incompatible_artifact_names_the_port_cli(tmp_path):
    ck = _checkpoint(tmp_path / "ck")
    engine = ServingEngine.load(ck, buckets=(1,), device="cpu")
    from fedamw_tpu_torch.serving.artifacts import export_ladder

    art = tmp_path / "art"
    export_ladder(engine, str(art))
    manifest = json.loads((art / "manifest.json").read_text())
    manifest["host"]["torch_version"] = "0.0"
    (art / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ArtifactIncompatible) as ei:
        ServingEngine.from_artifact(str(art), checkpoint=ck, device="cpu")
    assert str(ei.value).endswith(
        "re-export on (or for) this host class with python -m "
        "fedamw_tpu_torch.export_artifacts")


def test_cli_without_a_card_raises_unless_told_the_cpu(tmp_path,
                                                       monkeypatch):
    ck = _checkpoint(tmp_path / "ck")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_artifacts.main([ck, str(tmp_path / "art")])
    assert not (tmp_path / "art").exists()


@pytest.mark.cuda
def test_cli_on_the_card_checks_bitwise(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck = _checkpoint(tmp_path / "ck")
    out = _run_cli(ck, str(tmp_path / "art"), "--buckets", "1,8,64",
                   "--check")
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["host"]["platform"] == "cuda"
    assert summary["check"] == {**summary["check"], "compile_count": 0,
                                "parity": "bitwise"}
