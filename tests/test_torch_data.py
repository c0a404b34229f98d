"""The port's data layer and registry against the JAX package: bitwise.

These modules are numpy-only on both sides, and the port keeps its own
copies (it may not import the JAX package); the partitioner, the val
split, the packer, the synthetic generator and the dataset loader must
therefore give exactly the same arrays for the same seeds (partition
seed 2020, as the reference hard-codes it).
"""

import numpy as np
import pytest

import fedamw_tpu.config as jconfig
import fedamw_tpu.data as jdata
import fedamw_tpu_torch.config as tconfig
import fedamw_tpu_torch.data as tdata
from torch_threads import one_torch_thread  # noqa: F401


def _labels(n=600, classes=6, seed=0):
    return np.random.RandomState(seed).randint(0, classes, n)


@pytest.mark.parametrize("num_partitions,alpha,min_size", [
    (10, 0.01, 10), (10, 0.5, 10), (25, 0.1, 0), (4, 100.0, 10)])
def test_dirichlet_partition_bitwise(num_partitions, alpha, min_size):
    y = _labels()
    pj, cj = jdata.dirichlet_partition(y, num_partitions, alpha,
                                       min_size=min_size)
    pt, ct = tdata.dirichlet_partition(y, num_partitions, alpha,
                                       min_size=min_size)
    assert len(pj) == len(pt) == num_partitions
    for a, b in zip(pj, pt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert cj == ct


def test_uniform_partition_bitwise():
    pj = jdata.uniform_partition(101, 7, np.random.RandomState(4))
    pt = tdata.uniform_partition(101, 7, np.random.RandomState(4))
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("val_fraction", [0.2, 0.5])
def test_split_train_val_bitwise(val_fraction):
    parts, _ = jdata.dirichlet_partition(_labels(), 8, 0.3)
    tj, vj = jdata.split_train_val(parts, val_fraction,
                                   np.random.RandomState(9))
    tt, vt = tdata.split_train_val(parts, val_fraction,
                                   np.random.RandomState(9))
    np.testing.assert_array_equal(vj, vt)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"n_max": 200}, {"pad_clients_to": 12}])
def test_pack_partitions_bitwise(kw):
    parts, _ = jdata.dirichlet_partition(_labels(), 8, 0.3)
    a = jdata.pack_partitions(parts, **kw)
    b = tdata.pack_partitions(parts, **kw)
    for f in ("idx", "mask", "sizes", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_synthetic_classification_bitwise():
    a = jdata.synthetic_classification(500, 12, 4, seed=3)
    b = tdata.synthetic_classification(500, 12, 4, seed=3)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_generate_synthetic_bitwise():
    a = jdata.generate_synthetic(0.5, 0.0, 5, 20, 3,
                                 rng=np.random.RandomState(1))
    b = tdata.generate_synthetic(0.5, 0.0, 5, 20, 3,
                                 rng=np.random.RandomState(1))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,num_partitions,alpha", [
    ("digits", 10, 0.5), ("mnist", 50, 0.01), ("synthetic_nonlinear", 5, 1)])
def test_load_dataset_bitwise(name, num_partitions, alpha):
    a = jdata.load_dataset(name, num_partitions, alpha)
    b = tdata.load_dataset(name, num_partitions, alpha)
    for f in ("name", "task_type", "num_classes", "d", "source",
              "class_counts"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("X_train", "y_train", "X_test", "y_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)
    for p, q in zip(a.parts, b.parts):
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("name", sorted(jconfig._REGISTRY) + ["unknown"])
def test_get_parameter_matches(name):
    assert tconfig.get_parameter(name) == jconfig.get_parameter(name)
    assert tconfig.REGRESSION_DATASETS == jconfig.REGRESSION_DATASETS


def test_label_canonicalization_matches():
    y = np.array([-1.0, 1.0, 1.0, -1.0])
    np.testing.assert_array_equal(
        tdata.canonicalize_labels(y, "a9a"), jdata.canonicalize_labels(y, "a9a"))
    y = np.array([3.0, 7.5, 1.0])
    np.testing.assert_array_equal(
        tdata.canonicalize_labels(y, "cadata.t"),
        jdata.canonicalize_labels(y, "cadata.t"))
