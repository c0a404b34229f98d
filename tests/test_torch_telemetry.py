"""The port's telemetry plane (``fedamw_tpu_torch.utils.telemetry``)
against the JAX package's, on the CPU.

- On an injected clock, the same instrument calls on a registry of each
  package give an equal ``dump()`` (``TELEMETRY.v1``), identical
  Prometheus text, equal window reads and SLO evaluations, and equal
  OTLP exports of spans and metrics.
- ``parse_profiler_trace`` reads hand-written ``torch.profiler`` Chrome
  traces: with GPU events (kernels, copies and memsets on two streams,
  beside CPU operators and a GPU annotation it must not count), gzipped,
  and without GPU events (``None``, a CPU-only capture).
- ``attribute_device_time`` on the CPU degrades to ``source="none"`` with
  its reason; on the card (``cuda``-marked) it reads the profiler.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

import fedamw_tpu.utils.telemetry as jtel
import fedamw_tpu_torch.utils.telemetry as ttel


class Clock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _registry(mod, clock, **kw):
    reg = mod.Registry(clock=clock, **kw)
    reg.anchor = {"unix_s": 1.7e9, "mono_s": 100.0}  # both wall-free
    return reg


def _script_basic(mod, clock):
    reg = _registry(mod, clock)
    c = reg.counter("fed_rounds_total", "rounds run", labels={"agg": "x"})
    g = reg.gauge("fed_test_loss", "per-round test loss",
                  labels={"agg": "learned"})
    h = reg.histogram("serve_request_latency_seconds", "latency",
                      labels={"class": "interactive"})
    for i in range(6):
        clock.t += 1.5
        c.inc(2)
        g.set(1.0 / (i + 1))
        h.observe(0.004 * (i + 1))
    h.observe_many([0.03, 0.2, 7.0, 20.0])
    reg.gauge("fed_nan", labels={"agg": 'q"uote'}).set(float("nan"))
    reg.counter("fed_rounds_total", labels={"agg": "y"}).inc(0.5, t=50.0)
    reads = [c.rate(4.0), c.value, g.window_stats(5.0), g.value,
             h.percentile(50), h.percentile(95, window_s=3.0), h.count,
             round(h.sum, 12), h.bucket_counts(), reg.points_recorded(),
             reg.snapshot()]
    return reg, reads


def _script_ring(mod, clock):
    reg = _registry(mod, clock, capacity=4)
    c = reg.counter("fed_events_total")
    for i in range(10):
        clock.t += 1.0
        c.inc()
    g = reg.gauge("fed_p_max", labels={"agg": "learned"})
    for i in range(7):
        clock.t += 0.25
        g.set(i)
    reads = [c.rate(2.0), c.rate(100.0), c.series.dropped, len(c.series),
             g.window_stats(1.0), reg.points_recorded()]
    return reg, reads


def _script_disabled(mod, clock):
    reg = _registry(mod, clock, enabled=False)
    reg.counter("fed_a_total").inc(3)
    reg.histogram("lat", bounds=(0.1, 1.0)).observe(0.5)
    return reg, [reg.points_recorded(), reg.snapshot()]


def _script_slo(mod, clock):
    reg = _registry(mod, clock)
    for cls, vals in (("interactive", [0.01, 0.02, 0.2, 0.04]),
                      ("batch", [0.1, 0.9, 0.3])):
        h = reg.histogram("serve_request_latency_seconds",
                          labels={"class": cls})
        for v in vals:
            clock.t += 10.0
            h.observe(v)
    clock.t += 1.0
    reg.counter("serve_deadline_misses_total",
                labels={"class": "batch"}).inc(1)
    ev = mod.SloEvaluator(reg, windows_s=(30.0, 300.0))
    out = [ev.evaluate(), ev.burn_rates(), ev.burn_rates(60.0),
           mod.SloClass("x", threshold_ms=20.0).timeout_s(),
           mod.SloClass("y", 5.0, 0.9, default_timeout_s=1.5).timeout_s()]
    return reg, out


SCRIPTS = {"basic": _script_basic, "ring": _script_ring,
           "disabled": _script_disabled, "slo": _script_slo}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_dump_and_prometheus_match_jax(name):
    jreg, jreads = SCRIPTS[name](jtel, Clock())
    treg, treads = SCRIPTS[name](ttel, Clock())
    assert json.dumps(treads, sort_keys=True) == json.dumps(jreads,
                                                            sort_keys=True)
    jd, td = jreg.dump(), treg.dump()
    assert td["schema"] == jd["schema"] == "TELEMETRY.v1"
    assert json.dumps(td) == json.dumps(jd)
    assert ttel.render_prometheus(treg) == jtel.render_prometheus(jreg)
    # either package renders and parses the other's dump
    assert ttel.render_prometheus(jd) == jtel.render_prometheus(td)
    text = ttel.render_prometheus(treg)
    # NaN never equals itself: compare the parsed samples as JSON text
    assert json.dumps(ttel.parse_prometheus(text)) == json.dumps(
        jtel.parse_prometheus(text))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_otlp_matches_jax(name):
    jreg, _ = SCRIPTS[name](jtel, Clock())
    treg, _ = SCRIPTS[name](ttel, Clock())
    assert json.dumps(ttel.registry_to_otlp(treg)) == json.dumps(
        jtel.registry_to_otlp(jreg))


@pytest.mark.parametrize("anchor", [None, {"unix_s": 1.7e9, "mono_s": 5.0}])
def test_spans_otlp_matches_jax(anchor):
    spans = [
        {"name": "train_scan", "kind": "span", "trace_id": "run-1",
         "span_id": "s-2", "parent_id": None, "start_s": 5.0,
         "dur_s": 0.5, "attrs": {"aggregation": "learned", "rounds": 3,
                                  "faults": False, "p": float("nan")}},
        {"name": "round", "kind": "span", "trace_id": "run-1",
         "span_id": "s-3", "parent_id": "s-2", "start_s": 5.0,
         "dur_s": 0.25, "attrs": {"round": 0, "p_max": 0.5}},
        {"name": "retry", "kind": "annotation", "trace_id": "run-1",
         "span_id": "s-4", "parent_id": "s-3", "start_s": 5.1,
         "dur_s": 0.0, "attrs": {}},
    ]
    got = ttel.spans_to_otlp(spans, anchor=anchor)
    assert json.dumps(got) == json.dumps(jtel.spans_to_otlp(spans,
                                                            anchor=anchor))
    assert got["resourceSpans"][0]["scopeSpans"][0]["spans"][1][
        "parentSpanId"] == got["resourceSpans"][0]["scopeSpans"][0][
        "spans"][0]["spanId"]


@pytest.mark.parametrize("call", [
    lambda m: m.Registry().gauge("bad name"),
    lambda m: m.Registry(capacity=0),
    lambda m: m.TimeSeries(0),
    lambda m: m.SloClass("x", threshold_ms=1.0, objective=1.0),
    lambda m: m.SloEvaluator(m.Registry(), classes=()),
    lambda m: m.render_prometheus({"no": "metrics"}),
    lambda m: m.parse_prometheus("lonely"),
    lambda m: m.Registry().counter("c").inc(-1),
], ids=["name", "capacity", "series", "objective", "classes", "render",
        "parse", "counter"])
def test_bad_inputs_raise_like_jax(call):
    with pytest.raises(ValueError):
        call(jtel)
    with pytest.raises(ValueError):
        call(ttel)


def test_one_name_one_kind_like_jax():
    for mod in (jtel, ttel):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(TypeError, match="one name, one type"):
            reg.gauge("x")
        reg.histogram("h", bounds=(1.0, 2.0))
        with pytest.raises(ValueError, match="different bounds"):
            reg.histogram("h", labels={"a": 1}, bounds=(1.0, 3.0))


def test_global_registry_resets():
    reg = ttel.reset_registry(capacity=8)
    assert ttel.get_registry() is reg and reg.capacity == 8
    fresh = ttel.reset_registry()
    assert ttel.get_registry() is fresh and fresh is not reg


# -- device-time attribution -------------------------------------------------


def _event(cat, name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def _torch_trace(gpu=True):
    """A Chrome trace shaped like ``torch.profiler``'s export: CPU
    operators and runtime calls on the host's lanes, and (``gpu``)
    kernels, a copy and a memset on two CUDA streams of device 0 with a
    GPU annotation spanning two kernels."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 123,
         "args": {"name": "python3"}},
        _event("cpu_op", "aten::mm", 0.0, 50.0, pid=123, tid=123),
        _event("cuda_runtime", "cudaLaunchKernel", 5.0, 3.0, pid=123,
               tid=123),
        _event("python_function", "train", 0.0, 400.0, pid=123, tid=123),
    ]
    if gpu:
        events += [
            _event("kernel", "void staged_p_epoch_kernel<10, true, false>"
                   "(Args, Ext)", 10.0, 100.0),
            _event("kernel", "void staged_epoch_kernel<10>(Args)", 120.0,
                   40.5),
            _event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 170.0,
                   2.0, tid=9),
            _event("gpu_memset", "Memset (Device)", 180.0, 1.5, tid=9),
            _event("gpu_user_annotation", "round", 10.0, 150.5),
            {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
             "ts": 10.0, "id": 1},
        ]
    return {"schemaVersion": 1, "traceEvents": events}


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_parse_profiler_trace_sums_the_gpu_events(tmp_path, gz):
    sub = tmp_path / "worker"
    sub.mkdir()
    if gz:
        with gzip.open(sub / "host.123.pt.trace.json.gz", "wt") as f:
            json.dump(_torch_trace(), f)
    else:
        (sub / "host.123.pt.trace.json").write_text(
            json.dumps(_torch_trace()))
    got = ttel.parse_profiler_trace(str(tmp_path))
    assert got == {"device_busy_s": pytest.approx(144e-6, rel=1e-12),
                   "device_events": 4, "device_lanes": 2}


def test_parse_profiler_trace_without_gpu_events_is_none(tmp_path):
    (tmp_path / "cpu.pt.trace.json").write_text(
        json.dumps(_torch_trace(gpu=False)))
    assert ttel.parse_profiler_trace(str(tmp_path)) is None


def test_parse_profiler_trace_reads_the_newest_capture(tmp_path):
    old, new = tmp_path / "a.pt.trace.json", tmp_path / "b.pt.trace.json"
    new.write_text(json.dumps(_torch_trace(gpu=False)))
    old.write_text(json.dumps(_torch_trace()))
    os.utime(new, (time.time() + 10, time.time() + 10))
    assert ttel.parse_profiler_trace(str(tmp_path)) is None
    os.utime(old, (time.time() + 20, time.time() + 20))
    assert ttel.parse_profiler_trace(str(tmp_path))["device_events"] == 4


@pytest.mark.parametrize("content", [None, "{not json", "[]"],
                         ids=["missing", "corrupt", "not_an_object"])
def test_parse_profiler_trace_never_raises(tmp_path, content):
    if content is not None:
        (tmp_path / "x.pt.trace.json").write_text(content)
    assert ttel.parse_profiler_trace(str(tmp_path)) is None


def test_parse_profiler_trace_reads_a_real_cpu_capture(tmp_path):
    """A capture of this process's CPU work, exported by torch.profiler:
    CPU operators only, so no GPU event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.export_chrome_trace(str(tmp_path / "cpu.pt.trace.json"))
    with open(tmp_path / "cpu.pt.trace.json") as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
    assert "cpu_op" in cats and not cats & set(ttel.GPU_EVENT_CATEGORIES)
    assert ttel.parse_profiler_trace(str(tmp_path)) is None


def test_attribute_device_time_on_the_cpu_degrades_with_its_reason(
        tmp_path):
    calls = []

    def dispatch():
        t0 = time.perf_counter()
        torch.ones(32, 32) @ torch.ones(32, 32)
        calls.append(1)
        return time.perf_counter() - t0

    got = ttel.attribute_device_time(dispatch, reps=3,
                                     trace_dir=str(tmp_path))
    assert got["source"] == "none" and "no GPU event" in got["reason"]
    assert got["reps"] == 3 and len(calls) == 3 and got["dispatch_s"] >= 0
    # the JAX function's degrade carries the same keys
    want = jtel.attribute_device_time(lambda: 0.0, reps=1)
    assert set(got) == set(want) and want["source"] == "none"
    assert list(tmp_path.glob("*.pt.trace.json"))  # the capture is kept


def test_attribute_device_time_names_a_failing_dispatch():
    def dispatch():
        raise RuntimeError("boom")

    got = ttel.attribute_device_time(dispatch, reps=2)
    assert got == {"source": "none", "reason": "RuntimeError: boom",
                   "reps": 2, "dispatch_s": 0.0}


@pytest.mark.cuda
def test_attribute_device_time_reads_the_profiler_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture has no GPU lane here")
    a = torch.randn(2048, 2048, device="cuda")

    def dispatch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dispatch()
    got = ttel.attribute_device_time(dispatch, reps=4)
    assert got["source"] == "profiler", got
    assert 0 < got["compute_fraction"] <= 1
    assert got["device_events"] >= 16 and got["device_lanes"] >= 1
    np.testing.assert_allclose(
        got["device_compute_s"] + got["xla_queue_s"], got["dispatch_s"],
        atol=2e-6)
