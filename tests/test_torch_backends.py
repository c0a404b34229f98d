"""The port's registry, ``config.ExperimentConfig`` and the plain PyTorch
reference backend (``backends.torch_ref``), against the JAX package's.

``fedamw_tpu_torch.backends.torch_ref`` is the JAX package's
``backends/torch_ref.py`` with an explicit device: every random draw
stays on a CPU generator and is moved to the setup's device, so on
``device="cpu"`` it is the JAX package's module bit for bit
(``assert_array_equal`` on every returned vector) for all seven
algorithms and the options (participation, every ``server_opt``,
``sequential``, FedNova's weights with an empty client, the proximal
and ridge terms, the paper's lr schedule), and its refusals raise with
the JAX messages. Tiny shapes: digits over 4 clients, D = 16, 2 rounds.
Cuda-marked: the card run against the CPU run at ``chip_smoke.py``'s
``TOL_RUN`` (losses to 1e-4 relative, accuracy to 0.05 points), on
the synthetic satimage stand-in.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fedamw_tpu.config as jconfig
from fedamw_tpu import registry as jregistry
from fedamw_tpu.backends import torch_ref as jref
from fedamw_tpu.data import load_dataset as jload
import fedamw_tpu_torch
import fedamw_tpu_torch.algorithms as talgorithms
import fedamw_tpu_torch.serving as tserving
from fedamw_tpu_torch import config, registry
from fedamw_tpu_torch.backends import torch_ref
from fedamw_tpu_torch.data import load_dataset
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("Centralized", "Distributed", "FedAMW_OneShot", "FedAvg",
         "FedProx", "FedNova", "FedAMW")
KEYS = ("train_loss", "test_loss", "test_acc")

RUN = dict(lr=0.2, epoch=1, round=2, seed=1, lr_mode="constant",
           lr_p=0.01, lambda_reg=5e-4)


def _setups(dataset="digits", seed=3, **kw):
    ds_j = jload(dataset, 4, 0.5)
    ds_t = load_dataset(dataset, 4, 0.5)
    args = dict(D=16, kernel_par=0.5, seed=seed, **kw)
    js = jref.prepare_setup(ds_j, rng=np.random.RandomState(seed), **args)
    ts = torch_ref.prepare_setup(ds_t, rng=np.random.RandomState(seed),
                                 device="cpu", **args)
    return js, ts


@pytest.fixture(scope="module")
def setups():
    return _setups()


def _same(a, b):
    assert set(a) == set(b) == set(KEYS)
    for k in KEYS:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the registry and the driver's constants -------------------------------------

def test_registry_names_and_errors():
    assert registry.BACKENDS == ("port", "torch")
    assert registry.get_backend() is talgorithms
    assert registry.get_backend("port") is talgorithms
    assert registry.get_backend("torch") is torch_ref
    assert registry.get_serving() is tserving
    assert fedamw_tpu_torch.registry is registry
    assert set(talgorithms.ALGORITHMS) == set(torch_ref.ALGORITHMS) \
        == set(jref.ALGORITHMS) == set(NAMES)
    for name in NAMES:
        assert registry.get_algorithm(name) is talgorithms.ALGORITHMS[name]
        assert (registry.get_algorithm(name, "torch")
                is torch_ref.ALGORITHMS[name])
    with pytest.raises(ValueError, match="does not import JAX"):
        registry.get_backend("jax")
    with pytest.raises(ValueError, match="unknown backend 'tensorflow'"):
        registry.get_backend("tensorflow")
    with pytest.raises(ValueError, match="unknown backend 'tensorflow'"):
        jregistry.get_backend("tensorflow")
    for backend in ("port", "torch"):
        msgs = []
        for get in (lambda n: registry.get_algorithm(n, backend),
                    lambda n: jregistry.get_algorithm(n, "torch")):
            with pytest.raises(ValueError) as err:
                get("FedSGD")
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_experiment_config_equals_the_jax_config():
    assert (dataclasses.asdict(config.ExperimentConfig())
            == dataclasses.asdict(jconfig.ExperimentConfig()))
    assert ([f.name for f in dataclasses.fields(config.ExperimentConfig)]
            == [f.name for f in dataclasses.fields(jconfig.ExperimentConfig)])
    cfg = config.ExperimentConfig(dataset="mnist", rounds=3)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.rounds = 4
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig.ExperimentConfig(dataset="mnist", rounds=3))


# -- torch_ref on the CPU: the JAX package's module bit for bit ----------------

def test_prepare_setup_equals_the_jax_setup(setups):
    js, ts = setups
    assert ts.device.type == "cpu"
    for k in ("X", "y", "X_test", "y_test", "X_val", "y_val"):
        assert torch.equal(getattr(ts, k), getattr(js, k)), k
    assert len(ts.parts) == len(js.parts)
    for a, b in zip(ts.parts, js.parts):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ts.sizes, js.sizes)
    assert torch.equal(ts.p_fixed, js.p_fixed)
    assert (ts.task, ts.num_classes, ts.D) == (js.task, js.num_classes, js.D)


@pytest.mark.parametrize("name", NAMES)
def test_algorithm_equals_the_jax_module_bitwise(setups, name):
    js, ts = setups
    _same(torch_ref.ALGORITHMS[name](ts, **RUN),
          jref.ALGORITHMS[name](js, **RUN))


OPTIONS = [
    ("FedAvg", dict(participation=0.5)),
    ("FedProx", dict(participation=0.6)),
    ("FedNova", dict(participation=0.5, server_opt="adam")),
    ("FedAvg", dict(server_opt="sgd", server_lr=0.5)),
    ("FedAvg", dict(server_opt="adam", server_lr=0.05)),
    ("FedProx", dict(server_opt="yogi", server_lr=0.05)),
    ("FedNova", dict(server_opt="adagrad", server_lr=0.1)),
    ("FedAvg", dict(sequential=True)),
    ("Distributed", dict(sequential=True, prox=True, lambda_reg_if=True)),
    ("FedAMW", dict(sequential=True)),
    ("FedAMW", dict(prox=True, mu=0.05, lambda_reg_if=False)),
    ("FedAvg", dict(lr_mode="paper", round=4)),
    ("FedAvg", dict(lr_mode="reference", round=4)),
]


@pytest.mark.parametrize("name,kw", OPTIONS,
                         ids=[f"{n}-{'-'.join(k)}" for n, k in OPTIONS])
def test_options_equal_the_jax_module_bitwise(setups, name, kw):
    js, ts = setups
    run = dict(RUN, **kw)
    _same(torch_ref.ALGORITHMS[name](ts, **run),
          jref.ALGORITHMS[name](js, **run))


def test_fednova_weights_with_an_empty_client_equal_the_jax_module():
    js, ts = _setups(seed=5, kernel_type="linear")
    for s in (js, ts):
        s.parts.append(torch.zeros(0, dtype=torch.long))
        s.sizes = np.append(s.sizes, 0)
    for kw in ({}, dict(participation=0.5)):
        run = dict(RUN, **kw)
        a = torch_ref.FedNova(ts, **run)
        _same(a, jref.FedNova(js, **run))
        assert np.all(np.isfinite(a["test_acc"]))


def test_regression_task_equals_the_jax_module():
    js, ts = _setups(dataset="synthetic_nonlinear")
    assert ts.task == "regression"
    for name in ("FedAvg", "FedAMW", "Centralized"):
        _same(torch_ref.ALGORITHMS[name](ts, **RUN),
              jref.ALGORITHMS[name](js, **RUN))


REFUSALS = [
    ("Centralized", dict(participation=0.5)),
    ("Distributed", dict(participation=0.5)),
    ("FedAMW_OneShot", dict(participation=0.5)),
    ("FedAMW", dict(participation=0.5)),
    ("FedAMW", dict(server_opt="adam")),
    ("FedAvg", dict(server_opt="lamb")),
    ("FedAvg", dict(participation=0.0)),
    ("FedProx", dict(participation=1.5)),
    ("FedNova", dict(participation=0.5, sequential=True)),
]


@pytest.mark.parametrize("name,kw", REFUSALS,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in REFUSALS])
def test_refusals_raise_with_the_jax_messages(setups, name, kw):
    js, ts = setups
    with pytest.raises(ValueError) as ej:
        jref.ALGORITHMS[name](js, **dict(RUN, **kw))
    with pytest.raises(ValueError) as et:
        torch_ref.ALGORITHMS[name](ts, **dict(RUN, **kw))
    assert str(et.value) == str(ej.value)


def test_torch_ref_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = load_dataset("digits", 4, 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_ref.prepare_setup(ds, D=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.get_backend("torch").prepare_setup(ds, D=16)


# -- on the card ---------------------------------------------------------------

TOL_RUN = dict(loss_rtol=1e-4, acc_atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_torch_ref_on_the_card_matches_its_cpu_run(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = load_dataset("satimage", 4, 0.5)   # synthetic: no sklearn needed
    card = torch_ref.prepare_setup(ds, D=16, kernel_par=0.5, seed=3,
                                   rng=np.random.RandomState(3))
    cpu = torch_ref.prepare_setup(ds, D=16, kernel_par=0.5, seed=3,
                                  rng=np.random.RandomState(3),
                                  device="cpu")
    assert card.device.type == "cuda"
    a = torch_ref.ALGORITHMS[name](card, **RUN)
    b = torch_ref.ALGORITHMS[name](cpu, **RUN)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(a[k], b[k], rtol=TOL_RUN["loss_rtol"],
                                   atol=0)
    np.testing.assert_allclose(a["test_acc"], b["test_acc"], rtol=0,
                               atol=TOL_RUN["acc_atol"])
