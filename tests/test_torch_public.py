"""The public names the port carries beside the JAX package's, each held
against its JAX function on the CPU.

``ops.rff.rff_map_sparse`` (a scipy CSR matrix in row chunks) and
``ops.feature_mapping`` (train and test through one draw, the identity
for a non-Gaussian kernel; the port takes the JAX run's ``(W, b)`` draw
where the JAX function takes a key), ``ops.masked_accuracy``,
``ops.update_learning_rate``, the ``fedcore`` exports of the reputation
plane's ``directional_scores``, ``reputation_update`` and
``trust_bounded_work_frac``, ``registry.get_algorithm``, and the
``serving`` package's ``__all__``, name for name the JAX package's; the
registry's surface (``BACKENDS``, ``get_backend``, ``get_serving``); and
for every module of the JAX package its counterpart in the port with
every public name it defines (the Pallas kernels' modules map to their
CUDA twins' wrappers; the XLA lowering knobs in ``NOT_PORTED`` stay
out). Tolerance: 1e-6 on the features and the reputation plane's floats (one
float32 product or reduction each); accuracies, rates and verdicts
exactly.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse
import torch

import fedamw_tpu.fedcore as jfedcore
import fedamw_tpu.ops as jops
from fedamw_tpu import registry as jregistry
from fedamw_tpu.ops.rff import rff_map_sparse as jrff_map_sparse
import fedamw_tpu_torch.fedcore as tfedcore
import fedamw_tpu_torch.ops as tops
from fedamw_tpu_torch import registry
from fedamw_tpu_torch.algorithms import ALGORITHMS
from fedamw_tpu_torch.ops.rff import rff_map_sparse
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _draw(d, D, seed=0):
    W, b = jops.rff_params(jax.random.PRNGKey(seed), d, D, 0.5)
    return np.array(W), np.array(b)


@pytest.mark.parametrize("chunk", [7, 8192])
def test_rff_map_sparse_matches_jax(chunk):
    X = scipy.sparse.random(50, 300, density=0.02, format="csr",
                            random_state=1, dtype=np.float32)
    W, b = _draw(300, 16)
    got = rff_map_sparse(X, torch.from_numpy(W), torch.from_numpy(b),
                         chunk=chunk)
    want = jrff_map_sparse(X, W, b, chunk=chunk)
    assert got.dtype == np.float32 and got.shape == (50, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, tops.rff_map(
        torch.from_numpy(X.toarray()), torch.from_numpy(W),
        torch.from_numpy(b)).numpy(), **TOL)


@pytest.mark.parametrize("kernel_type", ["gaussian", "linear"])
def test_feature_mapping_matches_jax(kernel_type):
    rng = np.random.RandomState(0)
    Xtr = rng.randn(20, 6).astype(np.float32)
    Xte = rng.randn(7, 6).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jtr, jte, jdraw = jops.feature_mapping(Xtr, Xte, key, kernel_par=0.5,
                                           D=12, kernel_type=kernel_type)
    draw = (None if jdraw is None
            else tuple(np.asarray(a) for a in jdraw))
    ttr, tte, tdraw = tops.feature_mapping(
        torch.from_numpy(Xtr), torch.from_numpy(Xte), draw, kernel_par=0.5,
        D=12, kernel_type=kernel_type)
    assert (tdraw is None) == (jdraw is None)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), **TOL)
    np.testing.assert_allclose(tte.numpy(), np.asarray(jte), **TOL)
    if kernel_type == "gaussian":
        # a generator draws its own (W, b): the shapes of the JAX draw
        _, _, own = tops.feature_mapping(
            torch.from_numpy(Xtr), torch.from_numpy(Xte),
            torch.Generator().manual_seed(0), kernel_par=0.5, D=12)
        assert [tuple(a.shape) for a in own] == [a.shape for a in draw]


def test_masked_accuracy_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(40, 5).astype(np.float32)
    logits[3] = 1.0                          # a tie: the first class wins
    labels = rng.randint(0, 5, 40).astype(np.int32)
    for mask in (rng.rand(40) > 0.4, np.zeros(40)):
        mask = mask.astype(np.float32)
        got = tops.masked_accuracy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(mask))
        assert float(got) == float(jops.masked_accuracy(logits, labels,
                                                        mask))


@pytest.mark.parametrize("T", [1, 4, 10, 100])
def test_update_learning_rate_matches_jax(T):
    for epoch in range(T + 2):
        assert tops.update_learning_rate(epoch, 0.3, T) == (
            jops.update_learning_rate(epoch, 0.3, T))


def _reputation_inputs():
    rng = np.random.RandomState(5)
    g = rng.randn(3, 4).astype(np.float32)
    s = (g[None] + 0.1 * rng.randn(6, 3, 4)).astype(np.float32)
    s[2] = 2 * g - s[2]                      # a sign flip
    present = np.array([1, 1, 1, 0, 1, 1], np.float32)
    return g, s, present


def test_fedcore_exports_the_reputation_plane_as_jax():
    for name in ("directional_scores", "reputation_update",
                 "trust_bounded_work_frac"):
        assert name in tfedcore.__all__ and name in jfedcore.__all__
    g, s, present = _reputation_inputs()
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    cos = tfedcore.directional_scores({"w": t(g)}, {"w": t(s)}, t(present))
    jcos = jfedcore.directional_scores({"w": g}, {"w": s}, present)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    norms = np.linalg.norm((s - g).reshape(6, -1), axis=1).astype(
        np.float32)
    claim = np.array([1, 0.5, 0.01, 1, 1, 0.7], np.float32)
    rep = np.array([1, 0.9, 0.5, 1, 0.3, 1], np.float32)
    tw, tn = tfedcore.trust_bounded_work_frac(t(norms), t(claim), t(present),
                                              t(rep))
    jw, jn = jfedcore.trust_bounded_work_frac(norms, claim, present, rep)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert float(tn) == float(jn)
    z = np.array([0, 1, 7, 0, 2, 0.5], np.float32)
    new = tfedcore.reputation_update(t(rep), t(present), t(present), cos,
                                     t(present), t(z), 3.0, 0.5)
    jnew = jfedcore.reputation_update(rep, present, present, jcos, present,
                                      z, 3.0, 0.5)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **TOL)


def test_registry_get_algorithm_matches_jax():
    for name in ALGORITHMS:
        assert registry.get_algorithm(name) is ALGORITHMS[name]
        assert jregistry.get_algorithm(name, "jax").__name__ == name
    msgs = []
    for get in (registry.get_algorithm,
                lambda n: jregistry.get_algorithm(n, "jax")):
        with pytest.raises(ValueError) as err:
            get("FedSGD")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_serving_exports_every_name_of_the_jax_package():
    import fedamw_tpu.serving as jserving
    import fedamw_tpu_torch.serving as tserving

    assert tserving.__all__ == jserving.__all__
    for name in tserving.__all__:
        got = getattr(tserving, name)
        assert got is not None
        mod = getattr(got, "__module__", None)
        assert mod is None or not mod.startswith("fedamw_tpu."), name


def test_registry_carries_the_jax_registry_surface():
    """``BACKENDS``, ``get_backend``, ``get_algorithm(name, backend)`` and
    ``get_serving`` (the port's names for the backends: ``"port"`` in
    the JAX package's ``"jax"`` place, ``"torch"`` the same); the
    package imports ``registry`` and ``config`` as the JAX package's
    does, and ``config.ExperimentConfig`` is there."""
    import fedamw_tpu
    import fedamw_tpu_torch
    import fedamw_tpu_torch.serving as tserving
    from fedamw_tpu_torch import config
    from fedamw_tpu_torch.backends import torch_ref

    for name in ("BACKENDS", "get_backend", "get_algorithm", "get_serving"):
        assert hasattr(jregistry, name) and hasattr(registry, name), name
    assert len(registry.BACKENDS) == len(jregistry.BACKENDS)
    assert "torch" in registry.BACKENDS and "torch" in jregistry.BACKENDS
    assert registry.get_backend("torch") is torch_ref
    assert registry.get_serving() is tserving
    assert registry.get_algorithm("FedAMW", "torch") is torch_ref.FedAMW
    assert fedamw_tpu_torch.registry is registry
    assert fedamw_tpu_torch.config is config
    assert fedamw_tpu.registry is jregistry
    assert hasattr(config, "ExperimentConfig")


JAX_PKG = Path(jregistry.__file__).resolve().parent
PORT_PKG = Path(registry.__file__).resolve().parent

# the JAX package's XLA and Pallas lowering knobs, not ported: the port
# chooses a route with `fedcore/route.py` and the `kernel_impl` argument
# (ROADMAP.md lists each with its counterpart)
NOT_PORTED = {
    "fedcore/client.py": {"resolve_kernel_impl", "SGD_SCAN_UNROLL",
                          "scan_unroll", "EPOCH_GATHER_BYTES_LIMIT",
                          "epoch_gather_bytes"},
    "fedcore/aggregate.py": {"P_SCAN_UNROLL", "resolve_psolver_impl"},
}
# the two Pallas kernels' modules: their CUDA twins' wrappers
KERNEL_MODULES = {"fedcore/pallas_kernel.py": "fedcore/epoch_kernel.py",
                  "fedcore/pallas_psolver.py": "fedcore/psolver_kernel.py"}


def _defined_names(path):
    """The public names a module defines at its top level (functions,
    classes, assignments; imported names left out)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_has_its_counterpart_with_its_names(rel):
    port = PORT_PKG / KERNEL_MODULES.get(rel, rel)
    assert port.is_file(), f"no counterpart of {rel} in the port"
    if rel in KERNEL_MODULES:
        return
    missing = (_defined_names(JAX_PKG / rel) - _defined_names(port)
               - NOT_PORTED.get(rel, set()))
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"
    for name in NOT_PORTED.get(rel, ()):
        assert name in _defined_names(JAX_PKG / rel), name
