"""The port's scenario plane against the JAX package's, on the CPU.

``fedamw_tpu_torch.scenario`` is the JAX package's ``scenario`` package
on the port's modules: ``spec``, ``campaign`` and ``search`` are copies
(numpy; the same seeded streams), ``oracle`` runs its train leg on the
port's ``fedcore`` on the oracle's device and its serve leg on the port's
``serving`` pod. Held here: every spec of the campaign grids and of the
committed regressions expands to the JAX package's plans exactly, array
for array (the schedule digest hashes their bytes); the parse errors are
the same; ``OracleEngine.predict`` is bitwise; the train leg's global
model is within 1e-6 of the JAX leg's (exact in practice: selections,
masks and one scale); verdicts, counts and shrinks equal; the
announce-gap story on the port's ``PodWorker``; the committed
``CAMPAIGN_r16.json`` and ``CAMPAIGN_r18.json`` re-derived by the port;
the runner ``python -m fedamw_tpu_torch.scenario``. Cuda-marked: the
train leg and the verdicts on the card against the CPU.
"""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import fedamw_tpu.scenario as jscn
import fedamw_tpu.scenario.oracle as joracle
import fedamw_tpu_torch.scenario as tscn
import fedamw_tpu_torch.scenario.oracle as toracle
from fedamw_tpu.scenario.campaign import scenario_grid as jgrid
from fedamw_tpu.scenario.search import hunt_grid as jhunt
from fedamw_tpu_torch.scenario import (OracleEngine, PropertyOracle,
                                       ScenarioSpec, Verdict,
                                       load_regression, run_campaign,
                                       run_search, shrink,
                                       write_regression)
from fedamw_tpu_torch.scenario.campaign import (campaign_digest,
                                                scenario_grid)
from fedamw_tpu_torch.scenario.search import (actual_signature, hunt_grid,
                                              near_miss_streams,
                                              predicted_signature,
                                              search_digest)
from fedamw_tpu_torch.serving.transport import PodWorker
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG_DIR = os.path.join(REPO, "campaigns", "regressions")

TOL_W = dict(rtol=0, atol=1e-6)


def _oracle(**kw):
    return PropertyOracle(device="cpu", **kw)


def _committed_specs():
    out = []
    for name in sorted(os.listdir(REG_DIR)):
        if name.endswith(".json"):
            out.append(load_regression(os.path.join(REG_DIR, name))["spec"])
    return out


HAND_SPECS = [
    "seed=7,rounds=2,clients=4,replicas=6,requests=16,faults=0.3,chaos=0,"
    "load=0,net=0.1,swaps=2,kills=1,scales=0,announce_restarts=1,forges=2,"
    "mut=events@1+net@2",
    "seed=11,rounds=2,clients=4,replicas=2,requests=16,faults=0.2,"
    "chaos=0.1,net=0.1,swaps=2,kills=1,scales=2",
    "seed=3,rounds=1,clients=4,replicas=2,requests=8",
    "seed=13,rounds=2,clients=8,replicas=2,requests=16,faults=0.5,chaos=0.2,"
    "load=0.4,net=0.3",
]


def _all_specs():
    texts = list(HAND_SPECS) + _committed_specs()
    for seed in (0, 1, 5, 16):
        texts += [s.canonical() for s in jgrid(seed, 6)]
    for seed in (4, 18):
        texts += [s.canonical() for s in jhunt(seed, 6)]
    return texts


SPECS = _all_specs()


# -- the grammar ------------------------------------------------------------

def test_scenario_exports_every_name_of_the_jax_package():
    assert tscn.__all__ == jscn.__all__
    for name in tscn.__all__:
        got = getattr(tscn, name)
        mod = getattr(got, "__module__", None)
        assert mod is None or not mod.startswith("fedamw_tpu."), name
    assert toracle.INVARIANTS == joracle.INVARIANTS
    assert toracle.RACY_CODES == joracle.RACY_CODES
    assert toracle.INJECTABLE == joracle.INJECTABLE
    assert tscn.COVERAGE_AXES == jscn.COVERAGE_AXES


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 8), (5, 6), (16, 7)])
def test_grids_equal_the_jax_grids(seed, n):
    assert ([s.canonical() for s in scenario_grid(seed, n)]
            == [s.canonical() for s in jgrid(seed, n)])
    assert ([s.canonical() for s in hunt_grid(seed, n)]
            == [s.canonical() for s in jhunt(seed, n)])


def _plan_arrays(plan):
    fp = plan.fault_plan
    out = {f"fault.{k}": getattr(fp, k)
           for k in ("drop", "straggle", "corrupt", "scale", "poison",
                     "fill", "report", "lie")}
    out["chaos.roles"] = plan.chaos_plan.roles
    out["net.roles"] = plan.net_plan.roles
    out["gaps"] = plan.gaps
    return out


@pytest.mark.parametrize("text", SPECS)
def test_spec_expands_to_the_jax_plans_bitwise(text):
    t, j = ScenarioSpec.parse(text), jscn.ScenarioSpec.parse(text)
    assert t.canonical() == j.canonical()
    assert ScenarioSpec.parse(t.canonical()) == t
    tp, jp = t.expand(), j.expand()
    ta, ja = _plan_arrays(tp), _plan_arrays(jp)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        assert ta[k].shape == ja[k].shape, k
        assert ta[k].tobytes() == ja[k].tobytes(), k
    for attr in ("wedge_s", "slow_mult"):
        assert getattr(tp.chaos_plan, attr) == getattr(jp.chaos_plan, attr)
    for attr in ("partition_s", "lag_s", "kills", "announce_restarts",
                 "forges"):
        assert getattr(tp.net_plan, attr) == getattr(jp.net_plan, attr)
    assert tp.classes == jp.classes
    assert ([(e.at, e.kind, e.arg) for e in tp.events]
            == [(e.at, e.kind, e.arg) for e in jp.events])
    assert t.schedule_digest() == j.schedule_digest() == tp.digest()
    assert predicted_signature(t) == jscn.search.predicted_signature(j)


MALFORMED = [
    "seed", "seed=7,bogus=1", "seed=x", "faults=1.5", "seed=-1",
    "clients=1", "kills=1,replicas=1", "swaps=1,requests=4",
    "mut=events", "mut=wire@1", "mut=events@0",
    "announce_restarts=1,swaps=0", "announce_restarts=1,swaps=1,replicas=1",
    "forges=1,replicas=3", "rounds=0", "requests=2.5",
]


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_specs_raise_as_in_the_jax_package(text):
    with pytest.raises(Exception) as ej:
        jscn.ScenarioSpec.parse(text)
    with pytest.raises(Exception) as et:
        ScenarioSpec.parse(text)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_events_and_unknown_tokens_raise_as_in_the_jax_package():
    for make in (lambda m: m.ScenarioEvent(at=1, kind="nuke"),
                 lambda m: m.ScenarioEvent(at=-1, kind="kill"),
                 lambda m: m.Violation("MADE_UP", "nope"),
                 lambda m: m.PropertyOracle(inject=("made_up",),
                                            **({"device": "cpu"}
                                               if m is tscn else {})),
                 lambda m: m.PropertyOracle(latency_slo=0.5,
                                            **({"device": "cpu"}
                                               if m is tscn else {}))):
        with pytest.raises(ValueError) as ej:
            make(jscn)
        with pytest.raises(ValueError) as et:
            make(tscn)
        assert str(et.value) == str(ej.value)


# -- the oracle ---------------------------------------------------------------

def test_oracle_engine_predicts_as_the_jax_engine():
    W = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    t, j = OracleEngine(W), jscn.OracleEngine(W)
    assert t.warmup() == j.warmup() == 0
    X = np.random.RandomState(1).randn(40, 8).astype(np.float32)
    for n in (1, 3, 8, 20, 32, 33, 40):
        assert t.predict(X[:n]).tobytes() == j.predict(X[:n]).tobytes()
    assert t.compile_count == j.compile_count == 2
    assert t.swap_weights({"w": W + 1}) == j.swap_weights({"w": W + 1}) == 1
    with pytest.raises(ValueError, match="shape"):
        t.swap_weights({"w": np.zeros((2, 2), np.float32)})


def _spec_with_mode(mode, clients=8):
    """The first seed whose fault spec corrupts in ``mode`` and whose
    plan has a corrupt cell."""
    for seed in range(500):
        spec = ScenarioSpec(seed=seed, rounds=4, clients=clients,
                            replicas=2, requests=8, faults=1.0)
        if (spec.fault_spec().corrupt_mode == mode
                and spec.expand().fault_plan.corrupt.any()):
            return spec
    raise AssertionError(mode)


TRAIN_SPECS = ([HAND_SPECS[0], HAND_SPECS[3]]
               + [s.canonical() for s in jgrid(1, 8)]
               + [_spec_with_mode(m).canonical()
                  for m in ("nan", "inf", "sign", "scale")])


def _train(oracle, spec_mod, text):
    spec = spec_mod.ScenarioSpec.parse(text)
    violations = []
    W = oracle._run_train(spec, spec.expand(), violations)
    return W, violations


@pytest.mark.parametrize("text", TRAIN_SPECS)
def test_train_leg_matches_the_jax_train_leg(text):
    tw, tv = _train(_oracle(), tscn, text)
    jw, jv = _train(jscn.PropertyOracle(), jscn, text)
    assert tw.dtype == np.float32 and tw.shape == jw.shape
    np.testing.assert_allclose(tw, jw, **TOL_W)
    assert tv == [] and jv == []


def test_nonfinite_aggregate_is_caught_as_in_the_jax_package():
    # with the quarantine patched out, a NaN report of one of two
    # clients reaches the median: both packages flag NONFINITE_AGG with
    # the same detail
    text = _spec_with_mode("nan", clients=2).canonical()

    def passthrough(params, stacked, losses):
        n = losses.shape[0]
        ones = (torch.ones(n) if isinstance(losses, torch.Tensor)
                else np.ones(n, np.float32))
        return stacked, losses, ones

    import fedamw_tpu.fedcore.robust as jrobust
    with mock.patch.object(toracle, "sanitize_updates", passthrough):
        tw, tv = _train(_oracle(), tscn, text)
    with mock.patch.object(jrobust, "sanitize_updates", passthrough), \
            mock.patch.object(joracle, "_STEP", None):
        jw, jv = _train(jscn.PropertyOracle(), jscn, text)
    assert [v.code for v in tv] == [v.code for v in jv] == ["NONFINITE_AGG"]
    assert tv[0].detail == jv[0].detail
    np.testing.assert_array_equal(tw, jw)  # both fall back to W0


VERDICT_CASES = [
    (HAND_SPECS[2], ()),
    ("seed=7,rounds=2,clients=4,replicas=2,requests=12,faults=0.3,"
     "chaos=0.2,load=0.3,net=0.1", ()),
    (HAND_SPECS[1], ()),
    (HAND_SPECS[0], ()),
    (HAND_SPECS[2], ("lose_request",)),
    (HAND_SPECS[2], ("dup_span",)),
    (HAND_SPECS[2], ("recompile",)),
]


@pytest.mark.parametrize("text,inject", VERDICT_CASES)
def test_verdicts_equal_the_jax_verdicts(text, inject):
    kw = dict(inject=inject, lost_wait_s=0.5, request_timeout_s=2.0) \
        if inject else {}
    t = _oracle(**kw).run(text)
    j = jscn.PropertyOracle(**kw).run(text)
    assert t.to_record() == j.to_record()
    assert t.codes() == j.codes()
    assert bool(inject) == (not t.ok)
    for k in Verdict._STABLE_COUNTS:
        assert t.counts.get(k) == j.counts.get(k), k
    assert (t.counts["served"] + t.counts["typed_failures"]
            + t.counts["lost"] == t.counts["requests"])


def test_announce_gap_regression_story_on_the_port_pod():
    # a swap broadcast while a worker is down, the rejoin after: with
    # the sync handshake disabled the rejoiner serves stale weights,
    # with it the pod converges
    spec = ScenarioSpec(seed=7, rounds=1, clients=4, replicas=2,
                        requests=16, swaps=1, kills=1)
    with mock.patch.object(PodWorker, "resync",
                           lambda self, timeout_s=5.0: None):
        pre = _oracle().run(spec)
    assert pre.codes() == ("VERSION_DISAGREEMENT",), pre.violations
    post = _oracle().run(spec)
    assert post.ok, post.violations


def test_shrink_equals_the_jax_shrink():
    text = ("seed=13,rounds=2,clients=8,replicas=2,requests=16,"
            "faults=0.5,chaos=0.2,load=0.4,net=0.3")
    tmin, ttrace = shrink(text, _oracle(inject=("recompile",)))
    jmin, jtrace = jscn.shrink(text, jscn.PropertyOracle(
        inject=("recompile",)))
    assert tmin.canonical() == jmin.canonical()
    assert ttrace == jtrace
    assert [t["action"] for t in ttrace] == [t["action"] for t in jtrace]
    assert tmin.clients == 2 and tmin.requests == 1
    with pytest.raises(ValueError, match="failing scenario"):
        shrink(HAND_SPECS[2], _oracle())


def test_regressions_load_across_the_packages(tmp_path):
    spec = ScenarioSpec(seed=7, rounds=1, clients=2, replicas=2,
                        requests=8, swaps=1, kills=1)
    trace = [{"action": "zero:swaps", "spec": spec.canonical(),
              "codes": [], "kept": False}]
    tpath = write_regression(str(tmp_path / "t"), spec,
                             ["VERSION_DISAGREEMENT"], trace,
                             campaign_seed=7, note="port")
    jpath = jscn.write_regression(
        str(tmp_path / "j"), jscn.ScenarioSpec.parse(spec.canonical()),
        ["VERSION_DISAGREEMENT"], trace, campaign_seed=7, note="port")
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert open(tpath).read() == open(jpath).read()
    assert load_regression(jpath) == jscn.load_regression(tpath)
    broken = dict(load_regression(tpath), schema="WRONG.v1")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(broken))
    for load in (load_regression, jscn.load_regression):
        with pytest.raises(ValueError, match="schema"):
            load(str(bad))


# -- campaigns ----------------------------------------------------------------

def _cbs():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import check_bench_schema
    return check_bench_schema


def test_campaign_artifact_validates_and_equals_the_jax_campaign():
    art = run_campaign(2, 3, oracle=_oracle())
    assert _cbs().check_campaign_artifact(art, "CAMPAIGN_x.json") == []
    verdicts = [Verdict(spec=v["spec"], digest=v["digest"],
                        violations=(), counts={})
                for v in art["verdicts"]]
    assert campaign_digest(verdicts) == art["digest"]
    jart = jscn.run_campaign(2, 3, oracle=jscn.PropertyOracle())
    art.pop("wall_s"), jart.pop("wall_s")
    assert art == jart


def test_search_artifact_validates_under_v2_rules():
    art = run_search(4, 3, oracle=_oracle())
    assert _cbs().check_campaign_artifact(art, "CAMPAIGN_x.json") == []
    entries = [(Verdict(spec=v["spec"], digest=v["digest"],
                        violations=(), counts={}),
                v["origin"], tuple(v["signature"]))
               for v in art["verdicts"]]
    assert search_digest(entries) == art["digest"]


@pytest.mark.parametrize("name,run", [("CAMPAIGN_r16.json", run_campaign),
                                      ("CAMPAIGN_r18.json", run_search)])
def test_committed_campaign_artifacts_rederive_on_the_port(name, run):
    committed = json.load(open(os.path.join(REPO, name)))
    art = run(committed["seed"], committed["budget"], oracle=_oracle())
    assert art["schema"] == committed["schema"]
    assert art["digest"] == committed["digest"]
    assert art["verdicts"] == committed["verdicts"]
    if "coverage" in committed:
        assert art["coverage"] == committed["coverage"]


def test_signatures_and_near_miss_streams_equal_the_jax_ones():
    spec = ScenarioSpec.parse(HAND_SPECS[0])
    jspec = jscn.ScenarioSpec.parse(HAND_SPECS[0])
    for counts, codes in (({"kills": 1, "restarts": 1, "resyncs": 1,
                            "swaps_applied": 1}, ()),
                          ({"stale_refused": 1}, ()),
                          ({"resyncs": 1, "forge_rejected": 1,
                            "swaps_applied": 1}, ("SPAN_MISSING",))):
        viol = tuple(tscn.Violation(c, "x") for c in codes)
        jviol = tuple(jscn.Violation(c, "x") for c in codes)
        v = Verdict(spec="s", digest="d", violations=viol, counts=counts)
        jv = jscn.Verdict(spec="s", digest="d", violations=jviol,
                          counts=counts)
        assert actual_signature(spec, v) == jscn.actual_signature(jspec, jv)
        assert (near_miss_streams(spec, v)
                == jscn.search.near_miss_streams(jspec, jv))


def test_runner_writes_the_campaign_artifact(tmp_path, capsys):
    from fedamw_tpu_torch.scenario.__main__ import main

    out = tmp_path / "c.json"
    rc = main(["--seed", "2", "--budget", "2", "--device", "cpu", "--out",
               str(out), "--regressions", str(tmp_path / "reg"),
               "--quiet"])
    assert rc == 0
    art = json.loads(out.read_text())
    assert art["schema"] == "CAMPAIGN.v1" and art["scenarios"] == 2
    assert _cbs().check_campaign_artifact(art, "CAMPAIGN_x.json") == []
    assert "2 scenario(s), 0 with violations" in capsys.readouterr().out
    out2 = tmp_path / "s.json"
    assert main(["--seed", "4", "--budget", "2", "--device", "cpu",
                 "--search", "--out", str(out2), "--quiet"]) == 0
    assert json.loads(out2.read_text())["schema"] == "CAMPAIGN.v2"


def test_scenario_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PropertyOracle()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_campaign(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_search(1, 1)


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("text", TRAIN_SPECS)
def test_train_leg_on_the_card_matches_its_cpu_run(text):
    _card()
    cw, cv = _train(PropertyOracle(device="cuda"), tscn, text)
    hw, hv = _train(_oracle(), tscn, text)
    np.testing.assert_allclose(cw, hw, **TOL_W)
    assert cv == hv == []


@pytest.mark.cuda
def test_verdicts_on_the_card_equal_the_cpu_verdicts():
    _card()
    for text, inject in VERDICT_CASES:
        kw = dict(inject=inject, lost_wait_s=0.5, request_timeout_s=2.0) \
            if inject else {}
        card = PropertyOracle(device="cuda", **kw).run(text)
        assert card.to_record() == _oracle(**kw).run(text).to_record()
    committed = json.load(open(os.path.join(REPO, "CAMPAIGN_r16.json")))
    art = run_campaign(committed["seed"], committed["budget"],
                       oracle=PropertyOracle(device="cuda"))
    assert art["digest"] == committed["digest"]
    assert art["verdicts"] == committed["verdicts"]
