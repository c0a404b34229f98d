"""The port's host utilities against the JAX package's, on the CPU:
``utils/reporting.py`` (every function gives the same string or dict on
the same inputs), ``utils/seeds.py`` (bit for bit over a grid of masters
and label paths), ``utils/flops.py`` (equal counts on linear and
MLP-shaped parameters; a conv model's count from ``FlopCounterMode``
against its analytic count) and the round loop's ``analyze_memory`` (its
keys and byte counts on the CPU).
"""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fedamw_tpu.utils.flops as jflops
import fedamw_tpu.utils.reporting as jrep
import fedamw_tpu.utils.seeds as jseeds
import fedamw_tpu_torch.utils.flops as tflops
import fedamw_tpu_torch.utils.reporting as trep
import fedamw_tpu_torch.utils.seeds as tseeds
from fedamw_tpu_torch import utils as tutils
from fedamw_tpu_torch.algorithms import (
    Centralized, Distributed, FedAMW, FedAMW_OneShot, FedAvg, FedNova,
    FedProx, prepare_setup)
from fedamw_tpu_torch.algorithms.core import _nbytes
from fedamw_tpu_torch.data import load_dataset
from torch_threads import one_torch_thread  # noqa: F401

# -- reporting ---------------------------------------------------------------

R = np.random.RandomState(7)
MATRIX = R.rand(4, 11) * 10 + np.arange(4)[:, None]
FAULTS = {"dropped": [0, 2, 1], "straggled": [1, 0, 0],
          "corrupted": [0, 0, 3], "quarantined": [0, 0, 3]}
DEFENSE = {
    "robust_agg": "clip:5.0+quarantine:auto+rep:0.9:0.2+mkrum:2",
    "z_quarantined": np.array([0, 1, 2]), "z_max": np.array([1.5, 4.2, 7.0]),
    "z_threshold": np.array([5.0, 4.4, 4.1]),
    "reputation": np.array([[1.0, 1.0, 0.9, 0.0], [0.9, 0.5, 0.8, 0.0],
                            [0.95, 0.25, 0.7, 0.0]]),
    "rep_gated": np.array([0, 1, 1]), "frac_clamped": np.array([0, 2, 0]),
    "krum_pick_counts": np.array([3, 0, 2, 0]),
    "client_valid": np.array([1, 1, 1, 0]),
    "geomed_residual": np.array([1e-3, 5e-5, 2e-6]),
}
SPANS = [
    {"name": "train_scan", "kind": "span", "dur_s": 0.3},
    {"name": "round", "kind": "span", "dur_s": 0.1},
    {"name": "round", "kind": "span", "dur_s": 0.12},
    {"name": "round", "kind": "span", "dur_s": 0.08},
    {"name": "retry", "kind": "annotation", "dur_s": 0.0},
    {"name": "retry", "kind": "annotation", "dur_s": 0.0},
]
ROLLOUT = {"mode": "canary", "swaps": 3, "swap_p50_ms": 1.5,
           "swap_max_ms": 4.0, "canary": "pass", "canary_ms": 12,
           "rollback_drill": "ok", "inflight_p95_ms": 3.3,
           "recompiles_during_swaps": 0, "final_version": 4,
           "staleness_rounds": 1}
CHAOS = {"replicas": 3, "kills_observed": 2, "kills_planned": 2,
         "requeues": 5, "hedge_wins": 1, "hedges": 4, "resolved_ok": 97,
         "deadline_exceeded": 3, "requests": 100, "lost": 0,
         "p95_ms_chaos": 9.1, "p95_ms_clean": 4.2,
         "recompiles_during_chaos": 0}
OVERLOAD = {"fleets": {"autoscaled": {"good_per_replica_s": 31.5,
                                      "attainment": {"interactive": 0.99},
                                      "replicas_peak": 4},
                       "fixed_2": {"good_per_replica_s": 20.0},
                       "fixed_4": {"good_per_replica_s": 18.5}},
            "autoscaled_beats_every_fixed": True, "batch_shed": 12,
            "scale_ups": 2, "lost_accepted": 0,
            "recompiles_during_overload": 0}

REPORTING = {
    "check_significance_gap": ("check_significance",
                               (MATRIX[0], MATRIX[3])),
    "check_significance_tie": ("check_significance", (MATRIX[1], MATRIX[1])),
    "check_significance_const": ("check_significance",
                                 (np.ones(5), np.ones(5) * 2)),
    "print_acc": ("print_acc", (MATRIX,)),
    "print_acc_close": ("print_acc", (MATRIX[:2] * 0 + MATRIX[0],)),
    "print_time": ("print_time", (MATRIX,)),
    "fault_summary": ("fault_summary", (FAULTS,)),
    "fault_summary_lied": ("fault_summary", (dict(FAULTS, lied=[0, 1, 1]),)),
    "format_fault_report": ("format_fault_report", ("FedAMW", FAULTS)),
    "format_fault_report_lied": ("format_fault_report",
                                 ("FedAvg", dict(FAULTS, lied=[2, 0, 0]))),
    "defense_summary": ("defense_summary", (DEFENSE,)),
    "format_defense_report": ("format_defense_report", ("FedAMW", DEFENSE)),
    "format_defense_report_bare": ("format_defense_report",
                                   ("FedAvg", {"robust_agg": "median"})),
    "trace_stage_summary": ("trace_stage_summary", (SPANS,)),
    "format_trace_summary": ("format_trace_summary", ("exp1_mnist", SPANS)),
    "format_trace_summary_empty": ("format_trace_summary", ("run", [])),
    "format_rollout_report": ("format_rollout_report", (ROLLOUT,)),
    "format_failover_report": ("format_failover_report", (CHAOS,)),
    "format_overload_report": ("format_overload_report", (OVERLOAD,)),
}


@pytest.mark.parametrize("case", sorted(REPORTING))
def test_reporting_matches_jax(case):
    fn, args = REPORTING[case]
    got = getattr(trep, fn)(*args)
    want = getattr(jrep, fn)(*args)
    assert type(got) is type(want)
    assert got == want


def test_load_results_and_logger_match_jax(tmp_path):
    path = tmp_path / "exp1_x.pkl"
    with open(path, "wb") as f:
        pickle.dump({"epochs": 3, "test_acc": MATRIX}, f)
    got, want = trep.load_results(str(path)), jrep.load_results(str(path))
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["test_acc"], want["test_acc"])
    for mod, name in ((trep, "t.log"), (jrep, "j.log")):
        log = mod.Logger(str(tmp_path / name))
        log.write("line 1\n")
        log.write("line 2\n")
        log.log.close()
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text()
    assert trep.T_THRESHOLD == jrep.T_THRESHOLD


def test_utils_exports_what_the_jax_package_exports():
    import fedamw_tpu.utils as jutils

    assert set(jutils.__all__) <= set(tutils.__all__)
    assert {"load_checkpoint", "save_checkpoint"} <= set(tutils.__all__)


# -- seeds -------------------------------------------------------------------

LABEL_PATHS = [("faults",), ("chaos",), ("scenario", 17), ("scenario", "17"),
               ("a", "bc"), ("ab", "c"), ("déjà", 0), (0,), ("x",) * 5]


@pytest.mark.parametrize("master", [0, 1, 7, 8, 100, 2**31 + 5, 10**12])
def test_derive_seed_is_bit_for_bit(master):
    for labels in LABEL_PATHS:
        got = tseeds.derive_seed(master, *labels)
        assert got == jseeds.derive_seed(master, *labels)
        assert 0 <= got < 2**32
    np.testing.assert_array_equal(
        tseeds.derive_rng(master, "faults").rand(16),
        jseeds.derive_rng(master, "faults").rand(16))


@pytest.mark.parametrize("args,err", [((-1, "x"), ValueError),
                                      ((3,), ValueError),
                                      ((3, 1.5), TypeError)])
def test_derive_seed_refuses_like_jax(args, err):
    with pytest.raises(err):
        jseeds.derive_seed(*args)
    with pytest.raises(err):
        tseeds.derive_seed(*args)


# -- flops -------------------------------------------------------------------

SHAPES = {"linear": {"w": (10, 2000)},
          "mlp": {"w1": (784, 64), "b1": (64,), "w2": (64, 32), "b2": (32,),
                  "w3": (32, 10), "b3": (10,)},
          "nested": {"layers": [{"w": (16, 8), "b": (8,)},
                                {"w": (8, 3), "b": (3,)}]}}


def _params(shapes, make):
    if isinstance(shapes, dict):
        return {k: _params(v, make) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_params(v, make) for v in shapes]
    return make(shapes)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_gemm_flops_equal_jax(name):
    tp = _params(SHAPES[name], lambda s: torch.zeros(s))
    jp = _params(SHAPES[name], lambda s: jnp.zeros(s))
    got = tflops.fwd_flops_per_sample(tp, with_provenance=True)
    assert got == jflops.fwd_flops_per_sample(jp, with_provenance=True)
    assert got[1] == "gemm-formula"
    assert tflops.fwd_flops_per_sample(tp) == got[0]
    assert tflops.client_update_flops(got[0], 2, 123.4) == (
        jflops.client_update_flops(got[0], 2, 123.4))


def test_the_port_models_count_like_jax():
    from fedamw_tpu.models import linear_model as jlinear
    from fedamw_tpu_torch.models import linear_model

    import jax

    tp = linear_model().init(torch.Generator().manual_seed(0), 2000, 10)
    jp = jlinear().init(jax.random.PRNGKey(0), 2000, 10)
    assert tflops.fwd_flops_per_sample(tp) == jflops.fwd_flops_per_sample(
        jp) == 2 * 2000 * 10


# a conv model written by hand: x (1, 1*12*12) -> conv 3x3, 4 channels,
# stride 1, no padding -> ReLU -> flatten -> head to 5 classes
CONV = dict(c_in=1, hw=12, c_out=4, k=3, classes=5)


def _conv_params():
    c, hw, o, k, n = (CONV[x] for x in ("c_in", "hw", "c_out", "k",
                                         "classes"))
    out = hw - k + 1
    g = torch.Generator().manual_seed(0)
    return {"conv": torch.randn((o, c, k, k), generator=g),
            "head": torch.randn((n, o * out * out), generator=g)}


def _conv_apply(params, x):
    c, hw = CONV["c_in"], CONV["hw"]
    h = F.relu(F.conv2d(x.reshape(-1, c, hw, hw), params["conv"]))
    return h.flatten(1) @ params["head"].T


def test_conv_flops_from_the_flop_counter_match_the_analytic_count():
    c, hw, o, k, n = (CONV[x] for x in ("c_in", "hw", "c_out", "k",
                                         "classes"))
    out = hw - k + 1
    analytic = 2 * o * out * out * c * k * k + 2 * o * out * out * n
    got = tflops.fwd_flops_per_sample(_conv_params(), _conv_apply,
                                      d=c * hw * hw, with_provenance=True)
    assert got == (analytic, "torch-flop-counter")


@pytest.mark.parametrize("name,side,classes,want", [
    # tests/test_ops.py:296-297's hand count: 2*9*1*8*14*14 +
    # 2*9*8*16*7*7 + 2*784*10
    ("conv8x16", 28, 10, 156_800),
    ("conv4x8", 8, 10, 2 * 9 * 1 * 4 * 4 * 4 + 2 * 9 * 4 * 8 * 2 * 2
     + 2 * 32 * 10),
    ("conv4", 7, 3, 2 * 9 * 1 * 4 * 4 * 4 + 2 * 64 * 3)])
def test_the_ports_conv_model_counts_its_forward(name, side, classes, want):
    """The port's own ``conv_model`` under the flop counter: exactly the
    analytic count of its convolutions and head (the padding and ReLU
    are not counted)."""
    from fedamw_tpu_torch.models import get_model

    m = get_model(name)
    params = m.init(torch.Generator().manual_seed(0), side * side, classes)
    assert tflops.fwd_flops_per_sample(
        params, m.apply, d=side * side, with_provenance=True) == (
        want, "torch-flop-counter")


@pytest.mark.parametrize("name,d,classes", [("mlp64", 54, 7),
                                            ("mlp128x64", 784, 10)])
def test_the_ports_mlps_count_like_jax(name, d, classes):
    """The MLPs keep the GEMM formula, equal to the JAX package's count
    on its own ``mlp_model``."""
    import jax

    from fedamw_tpu.models import get_model as jget_model
    from fedamw_tpu_torch.models import get_model

    m = get_model(name)
    tp = m.init(torch.Generator().manual_seed(0), d, classes)
    jp = jget_model(name).init(jax.random.PRNGKey(0), d, classes)
    got = tflops.fwd_flops_per_sample(tp, m.apply, d=d, with_provenance=True)
    assert got == jflops.fwd_flops_per_sample(jp, with_provenance=True)
    assert got[1] == "gemm-formula"


def test_conv_without_apply_is_the_labelled_undercount():
    params = _conv_params()
    flops, basis = tflops.fwd_flops_per_sample(params, with_provenance=True)
    assert basis == "gemm-formula-undercount"
    assert flops == 2 * params["head"].numel()  # the head alone
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    assert jflops.fwd_flops_per_sample(jp, with_provenance=True) == (
        flops, basis)


def test_a_forward_the_counter_cannot_see_warns_and_undercounts():
    params = _conv_params()

    def apply_fn(p, x):  # elementwise only: no matmul, no convolution
        return x * 2.0

    with pytest.warns(RuntimeWarning, match="UNDERCOUNTS"):
        got = tflops.fwd_flops_per_sample(params, apply_fn, d=144,
                                          with_provenance=True)
    assert got == (2 * params["head"].numel(), "gemm-formula-undercount")


def test_gemm_models_ignore_apply_fn():
    tp = _params(SHAPES["mlp"], lambda s: torch.zeros(s))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tflops.fwd_flops_per_sample(
            tp, lambda p, x: x, d=784, with_provenance=True)[1] == (
            "gemm-formula")


# -- analyze_memory ----------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return prepare_setup(load_dataset("digits", 4, 0.5), D=32, device="cpu")


def _round_bytes(s, learned):
    idx, mask = s.round_arrays()
    tensors = [s.X, s.y, idx, mask, s.X_test, s.y_test, s.sizes, s.p_fixed]
    if learned:
        tensors += [s.X_val, s.y_val]
    return _nbytes(*tensors)


@pytest.mark.parametrize("algo,learned", [(FedAvg, False), (FedProx, False),
                                          (FedNova, False), (FedAMW, True)])
def test_analyze_memory_reports_one_rounds_bytes(setup, algo, learned):
    got = algo(setup, round=3, epoch=1, analyze_memory=True)
    # on the CPU the measured keys (peak, temp) are left out
    assert set(got) == {"argument_size_in_bytes", "output_size_in_bytes"}
    w = 4 * setup.num_classes * setup.D
    p = 4 * setup.num_clients
    n_metrics = 5 if learned else 3
    assert got["argument_size_in_bytes"] == (
        _round_bytes(setup, learned) + w + (p if learned else 0))
    assert got["output_size_in_bytes"] == w + p + 4 * n_metrics


def test_analyze_memory_runs_a_single_round(setup, monkeypatch):
    import fedamw_tpu_torch.algorithms.core as core

    seen = []
    real = core.make_evaluator

    def counting(*a, **kw):
        ev = real(*a, **kw)

        def evaluate(*b):
            seen.append(1)
            return ev(*b)

        return evaluate

    monkeypatch.setattr(core, "make_evaluator", counting)
    FedAMW(setup, round=5, epoch=1, analyze_memory=True)
    assert len(seen) == 1


def test_analyze_memory_counts_a_bucketed_setup():
    s = prepare_setup(load_dataset("digits", 6, 0.5), D=32, buckets=2,
                      device="cpu")
    got = FedAvg(s, round=2, epoch=1, analyze_memory=True)
    assert got["argument_size_in_bytes"] == (
        _round_bytes(s, False) + 4 * s.num_classes * s.D)


@pytest.mark.parametrize("algo", [Centralized, Distributed, FedAMW_OneShot])
def test_one_shot_algorithms_ignore_analyze_memory(setup, algo):
    kw = dict(epoch=1) if algo is not FedAMW_OneShot else dict(epoch=1,
                                                               round=2)
    got = algo(setup, analyze_memory=True, **kw)
    want = algo(setup, **kw)
    assert set(got) == {"train_loss", "test_loss", "test_acc"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.cuda
def test_analyze_memory_measures_the_peak_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the peak is read from the allocator")
    s = prepare_setup(load_dataset("mnist", 10, 0.5), D=256)
    got = FedAMW(s, round=2, analyze_memory=True)
    assert set(got) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "peak_memory_in_bytes"}
    assert got["peak_memory_in_bytes"] >= got["argument_size_in_bytes"]
    assert got["temp_size_in_bytes"] == max(
        0, got["peak_memory_in_bytes"] - got["argument_size_in_bytes"]
        - got["output_size_in_bytes"])
