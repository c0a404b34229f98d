"""More than 32 classes: the port against the JAX package on the CPU.

A 40-class LIBSVM pair (400 train and 160 test rows, 30 raw features,
about 8 non-zeros a row, written here from a seed) is loaded by both
packages' ``load_dataset`` (C read from the file, the registry's default
block for an unregistered name) and split over 4 Dirichlet(0.5) clients.
FedAvg and FedAMW (RFF D=64, 2 rounds of 2 local epochs) run through the
JAX package, with its XLA kernels and with both Pallas kernels in
interpret mode, and through the port with every random input injected
(the RFF draw through the setup's arrays, the initial weights, every
client and p-solver shuffle: ``test_torch_slice._pair``). Every returned
vector agrees to 1e-5, absolute and relative, as in
``tests/test_torch_slice.py``. On the card the same shapes run kernel 1's
class-tiled wide plan and kernel 2's class-tiled split plan
(``chip_smoke.py``'s ``many_classes`` phase holds them there).

The port's driver (``--device cpu``) on the same files writes exp.py's
six-row pickle.
"""

import pickle

import numpy as np
import pytest

from fedamw_tpu.algorithms import FedAMW as JFedAMW
from fedamw_tpu.algorithms import FedAvg as JFedAvg
from fedamw_tpu.algorithms import prepare_setup as jprepare_setup
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu_torch import exp
from fedamw_tpu_torch.algorithms import FedAMW, FedAvg
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.fedcore import epoch_kernel as ek
from fedamw_tpu_torch.fedcore import psolver_kernel as pk
from test_torch_slice import _pair
from torch_threads import one_torch_thread  # noqa: F401

NAME, CLASSES, N_TRAIN, N_TEST, RAW_D, NNZ = "many40", 40, 400, 160, 30, 8
J, ALPHA, D, SEED, ROUNDS, EPOCHS = 4, 0.5, 64, 0, 2, 2
TOL = dict(rtol=1e-5, atol=1e-5)

ALGOS = {
    "FedAvg": (JFedAvg, FedAvg, dict(lr=0.5)),
    "FedAMW": (JFedAMW, FedAMW, dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3)),
}


def _write(path, n, seed):
    """``n`` LIBSVM rows: labels 1..CLASSES, each on n // CLASSES rows;
    NNZ sorted features a row, the first drawn from the label's own block
    of features; positive values of unit norm a row; feature RAW_D on the
    first row, so both files parse to RAW_D columns."""
    rng = np.random.RandomState(seed)
    y = np.arange(n) % CLASSES
    rng.shuffle(y)
    block = RAW_D // CLASSES or 1
    lines = []
    for i in range(n):
        cols = set(rng.choice(RAW_D, NNZ - 1, replace=False).tolist())
        cols.add(min(y[i] * block, RAW_D - 1))
        if i == 0:
            cols.add(RAW_D - 1)
        cols = sorted(cols)
        v = rng.exponential(1.0, len(cols))
        v /= np.sqrt(np.square(v).sum())
        lines.append(f"{y[i] + 1} " + " ".join(
            f"{c + 1}:{x:.6g}" for c, x in zip(cols, v)))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("many_classes")
    _write(d / NAME, N_TRAIN, 1)
    _write(d / f"{NAME}.t", N_TEST, 2)
    return d


@pytest.fixture(scope="module")
def pair(data_dir):
    ds = jload_dataset(NAME, num_partitions=J, alpha=ALPHA,
                       data_dir=str(data_dir))
    assert (ds.source, ds.num_classes) == ("file", CLASSES)
    sj = jprepare_setup(ds, D=D, seed=3, rng=np.random.RandomState(3))
    return (sj,) + _pair(sj, SEED, ROUNDS, EPOCHS, "cpu")


def test_port_loads_the_file_as_the_jax_package(data_dir):
    """C from the file, the same features, labels and Dirichlet parts."""
    dj = jload_dataset(NAME, num_partitions=J, alpha=ALPHA,
                       data_dir=str(data_dir))
    dt = load_dataset(NAME, num_partitions=J, alpha=ALPHA,
                      data_dir=str(data_dir))
    assert (dt.source, dt.num_classes, dt.d) == ("file", CLASSES, RAW_D)
    assert dt.num_classes == dj.num_classes and dt.d == dj.d
    for k in ("X_train", "y_train", "X_test", "y_test"):
        np.testing.assert_array_equal(getattr(dt, k), np.asarray(
            getattr(dj, k)))
    for a, b in zip(dt.parts, dj.parts):
        np.testing.assert_array_equal(a, b)


def test_shapes_take_the_tiled_plans():
    """On the card kernel 1 runs these shapes on its class-tiled wide
    plan; kernel 2's validation batch at J = 4 (which the unstaged kernel
    took before the class-tiled split kernel measured faster) and at the
    main configuration's J = 50 with 105 classes take the class-tiled
    split plan."""
    assert ek.launch_plan(J, 32, CLASSES, D, 132).kernel == "wide_tiled"
    assert pk.launch_plan(16, J, CLASSES).kernel == "split_tiled"
    assert pk.launch_plan(16, 50, 105).kernel == "split_tiled"


@pytest.mark.parametrize("jax_kernels", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_port_matches_jax_past_32_classes(pair, algo, jax_kernels,
                                          monkeypatch):
    sj, st, inject, p_pos = pair
    jfn, tfn, kw = ALGOS[algo]
    kw = dict(kw, epoch=EPOCHS, round=ROUNDS, seed=SEED, return_state=True)
    monkeypatch.setenv("FEDAMW_KERNEL", jax_kernels)
    monkeypatch.setenv("FEDAMW_PSOLVER", jax_kernels)
    rj = jfn(sj, **kw)
    if algo == "FedAMW":
        inject = dict(inject, p_positions=p_pos)
    rt = tfn(st, **kw, **inject)
    for k in ("train_loss", "test_loss", "test_acc"):
        assert rt[k].shape == (ROUNDS,)
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), **TOL, err_msg=k)
    assert rt["params"]["w"].shape == (CLASSES, D)
    np.testing.assert_allclose(rt["params"]["w"].numpy(),
                               np.asarray(rj["params"]["w"]), **TOL)
    np.testing.assert_allclose(rt["p"].numpy(), np.asarray(rj["p"]), **TOL)
    if algo == "FedAMW":
        for k in ("p_entropy", "p_max"):
            np.testing.assert_allclose(rt["mixture"][k],
                                       np.asarray(rj["mixture"][k]), **TOL,
                                       err_msg=k)


def test_driver_writes_six_rows(data_dir, tmp_path, capsys):
    """``python -m fedamw_tpu_torch.exp --dataset many40`` on the CPU:
    the six algorithms over the 40-class files, exp.py's pickle."""
    path = exp.main(["--device", "cpu", "--dataset", NAME, "--data_dir",
                     str(data_dir), "--D", str(D), "--num_partitions",
                     str(J), "--round", str(ROUNDS), "--result_dir",
                     str(tmp_path)])
    with open(path, "rb") as f:
        data = pickle.load(f)
    assert data["name"] == exp.NAMES and data["task"] == "classification"
    for k in ("train_loss", "test_loss", "test_acc"):
        assert data[k].shape == (6, ROUNDS, 1), k
        assert np.all(np.isfinite(data[k])), k
    assert "many40" in capsys.readouterr().out
