"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback.

Every module of the package (the serving modules included: ``serving``'s
host planes are copies of the JAX package's, never imports of it) imports
with no JAX in the process, and no source file names JAX. Every entry
point that places data or weights raises without a card unless it is
told ``device="cpu"``: the setups, the driver, ``ServingEngine`` and
``make_serving_mesh``.

The repository's root ``conftest.py`` imports JAX into this process, so
the import check runs in a fresh interpreter.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "non-iid-distributed-learning-with-optimal-mixture-weights_tpu_torch"
CHIP_SMOKE = REPO / "chip_smoke.py"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        out.append(".".join(["fedamw_tpu_torch", *parts]))
    return out


def test_every_module_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'fedamw_tpu' or "
        "m.startswith('fedamw_tpu.'))\n"
        "print('LOADED', len([m for m in sys.modules "
        "if m.startswith('fedamw_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO), env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split("LOADED")[1]) >= len(_modules())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [CHIP_SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "fedamw_tpu"), (
            f"{path.name} imports {name}")


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.convert import setup_from_arrays
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = load_dataset("digits", 4, 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_setup(ds, D=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda:0")
    z = np.zeros((2, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_from_arrays(task="classification", num_classes=2, X=z,
                          y=np.zeros(2, np.int32), X_val=z,
                          y_val=np.zeros(2, np.int32), X_test=z,
                          y_test=np.zeros(2, np.int32),
                          idx=np.zeros((1, 2), np.int32), mask=z[:1],
                          sizes=np.ones(1, np.int32),
                          p_fixed=np.ones(1, np.float32))
    assert prepare_setup(ds, D=16, device="cpu").device.type == "cpu"


def test_serving_refuses_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    from fedamw_tpu_torch.parallel import make_serving_mesh
    from fedamw_tpu_torch.serving import ServingEngine
    from fedamw_tpu_torch.utils import save_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"w": np.zeros((3, 4), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params)
    save_checkpoint(str(tmp_path / "ck"), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.load(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_mesh()
    assert ServingEngine(params, device="cpu").device.type == "cpu"
    assert make_serving_mesh(2, device="cpu").size == 2


def test_serving_modules_are_the_port_own():
    """The serving package's modules load from this package's own
    directory (that importing them loads no JAX is the fresh-interpreter
    test at the top of this file)."""
    import fedamw_tpu_torch.serving as serving

    for name in ("engine", "batcher", "metrics", "control", "rollout",
                 "registry", "service", "artifacts", "chaos", "ladder",
                 "replica", "transport"):
        mod = sys.modules[f"fedamw_tpu_torch.serving.{name}"]
        assert Path(mod.__file__).resolve().parent == PKG / "serving"
    assert serving.__name__ == "fedamw_tpu_torch.serving"


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, str(CHIP_SMOKE)],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
