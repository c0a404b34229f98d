"""The port's native svmlight parser, loaders and metric helpers.

``fedamw_tpu_torch.native_io`` binds the repository's
``native/svmlight_parser.cpp``, built with ``g++`` into the port's build
directory. On files the tests write themselves it must give sklearn's
float32 features and labels bit for bit, and the JAX package's native
parser's; ``data.load_svmlight`` goes through it and falls back to
sklearn when it cannot build. ``MinibatchLoader``/``load_data`` and
``comp_accuracy``/``error_estimate``/``Meter`` are held against the JAX
package's on the same inputs.
"""

from pathlib import Path

import numpy as np
import pytest

from fedamw_tpu import native_io as jnative_io
from fedamw_tpu.data import load_data as jload_data
from fedamw_tpu.ops import metrics as jmetrics
from fedamw_tpu_torch import native_io
from fedamw_tpu_torch.data import MinibatchLoader, load_data, load_svmlight
from fedamw_tpu_torch.ops import Meter, comp_accuracy, error_estimate

sk = pytest.importorskip("sklearn.datasets")
REPO = Path(__file__).resolve().parent.parent


def _random_svmlight_file(path, n=200, d=40, seed=0, density=0.2):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        label = rng.choice([-1.0, 1.0, 2.5])
        nnz = rng.binomial(d, density)
        idxs = np.sort(rng.choice(d, size=max(nnz, 1), replace=False)) + 1
        feats = " ".join(f"{i}:{rng.randn() * 10 ** rng.randint(-8, 8):.9g}"
                         for i in idxs)
        lines.append(f"{label:g} {feats}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("seed,n,d", [(0, 200, 40), (1, 31, 7), (2, 5, 300)])
def test_native_matches_sklearn_bitwise(tmp_path, seed, n, d):
    path = tmp_path / "rand.svm"
    _random_svmlight_file(path, n=n, d=d, seed=seed)
    X, y = native_io.load_svmlight(str(path))
    X_sk, y_sk = sk.load_svmlight_file(str(path))
    X_sk = np.asarray(X_sk.todense(), dtype=np.float32)
    assert X.dtype == np.float32 and X.shape == X_sk.shape
    np.testing.assert_array_equal(X, X_sk)
    np.testing.assert_array_equal(y, y_sk)
    Xj, yj = jnative_io.load_svmlight(str(path))
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_native_handles_comments_and_blanks(tmp_path):
    path = tmp_path / "messy.svm"
    path.write_text("# header comment\n\n2 1:0.5 3:1.25\n\n1 2:-2.0\n")
    X, y = native_io.load_svmlight(str(path))
    np.testing.assert_array_equal(X, [[0.5, 0.0, 1.25], [0.0, -2.0, 0.0]])
    np.testing.assert_array_equal(y, [2.0, 1.0])


def test_native_missing_file(tmp_path):
    with pytest.raises(OSError):
        native_io.load_svmlight(str(tmp_path / "not_here.svm"))


def test_library_is_built_beside_the_kernels_never_in_native():
    """The committed ``native/`` tree is left as it is; the port's build
    lands in its own gitignored directory."""
    native_io._load()
    lib = native_io.library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "torch_kernels"
    assert native_io.SOURCE == REPO / "native" / "svmlight_parser.cpp"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "build/torch_kernels/" in ignored


def test_data_layer_uses_native_and_canonicalizes(tmp_path, monkeypatch):
    path = tmp_path / "toy"
    path.write_text("3 1:0.5 4:1.5\n1 2:2.0\n2 1:-1.0 4:0.25\n")
    calls = []
    parse = native_io.load_svmlight
    monkeypatch.setattr(native_io, "load_svmlight",
                        lambda p: calls.append(p) or parse(p))
    X, y = load_svmlight("toy", str(tmp_path))
    assert calls and X.shape == (3, 4)
    np.testing.assert_array_equal(y, [2, 0, 1])
    calls.clear()
    X2, y2 = load_svmlight("toy", str(tmp_path), use_native=False)
    assert not calls
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(y, y2)


def test_data_layer_falls_back_to_sklearn(tmp_path, monkeypatch):
    path = tmp_path / "abalone"
    path.write_text("\n".join(f"{i / 5.0} 1:{i} 2:{i * 0.5}"
                              for i in range(10)) + "\n")

    def no_library(p):
        raise ImportError("no compiler")

    monkeypatch.setattr(native_io, "load_svmlight", no_library)
    X, y = load_svmlight("abalone", str(tmp_path))
    assert X.shape == (10, 2) and y.dtype == np.float32
    np.testing.assert_allclose([y.min(), y.max()], [0.0, 100.0])


def test_minibatch_loader_matches_jax():
    from fedamw_tpu.data import MinibatchLoader as JMinibatchLoader

    X = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.int32)
    for shuffle in (True, False):
        a = MinibatchLoader(X, y, batch_size=6, shuffle=shuffle, seed=3)
        b = JMinibatchLoader(X, y, batch_size=6, shuffle=shuffle, seed=3)
        assert len(a) == len(b) == 4
        for _ in range(2):  # a fresh permutation per epoch
            for (xa, ya), (xb, yb) in zip(a, b):
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError, match="length mismatch"):
        MinibatchLoader(X, y[:3], 4)


@pytest.mark.parametrize("name", ["toy", "abalone"])
def test_load_data_svmlight_branch_matches_jax(tmp_path, name):
    lines = [f"{i % 3} 1:{i / 10.0} 2:{1.0 - i / 10.0}" for i in range(25)]
    (tmp_path / name).write_text("\n".join(lines) + "\n")
    got = load_data(name, batch_size=4, data_dir=str(tmp_path), seed=1)
    want = jload_data(name, batch_size=4, data_dir=str(tmp_path), seed=1)
    assert got[3:] == want[3:]
    assert got[1] is got[2]
    for la, lb in zip(got[:3], want[:3]):
        for (xa, ya), (xb, yb) in zip(la, lb):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_load_data_mnist_branch(tmp_path):
    from tests.test_images import write_idx

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, size=(30, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, size=30, dtype=np.uint8)
    write_idx(str(tmp_path / "train-images-idx3-ubyte"), imgs)
    write_idx(str(tmp_path / "train-labels-idx1-ubyte"), labels)
    write_idx(str(tmp_path / "t10k-images-idx3-ubyte"), imgs[:7])
    write_idx(str(tmp_path / "t10k-labels-idx1-ubyte"), labels[:7])
    train, validate, test, d, num_classes = load_data(
        "mnist", batch_size=8, data_dir=str(tmp_path), seed=0)
    assert d == 784 and num_classes == 10
    n = sum(len(yb) for loader in (train, validate) for _, yb in loader)
    assert n == 30 and sum(len(yb) for _, yb in test) == 7


@pytest.mark.parametrize("task", ["multiclass", "classification",
                                  "regression"])
def test_error_estimate_and_comp_accuracy_match_jax(task):
    import torch

    r = np.random.RandomState(4)
    out = r.randn(12, 5).astype(np.float32)
    if task == "regression":
        out, tgt = out[:, 0], r.randn(12).astype(np.float32)
    else:
        tgt = r.randint(0, 5, size=12)
        assert comp_accuracy(out, tgt, (1, 3)) == jmetrics.comp_accuracy(
            out, tgt, (1, 3))
        assert comp_accuracy(torch.from_numpy(out), torch.from_numpy(tgt),
                             (2,)) == jmetrics.comp_accuracy(out, tgt, (2,))
    assert error_estimate(out, tgt, task) == jmetrics.error_estimate(
        out, tgt, task)
    with pytest.raises(ValueError, match="Unsupported task type"):
        error_estimate(out, tgt, "nope")


@pytest.mark.parametrize("stateful,csv", [(False, True), (True, False)])
def test_meter_matches_jax(stateful, csv):
    a = Meter(ptag="Loss", stateful=stateful, csv_format=csv)
    b = jmetrics.Meter(ptag="Loss", stateful=stateful, csv_format=csv)
    for v, n in ((0.5, 3), (1.25, 1), (0.75, 4)):
        a.update(v, n)
        b.update(v, n)
    assert vars(a) == vars(b)
    assert str(a) == str(b)
    a.reset()
    assert a.count == 0 and a.avg == 0.0
