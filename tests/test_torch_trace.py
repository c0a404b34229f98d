"""The port's trace plane (``fedamw_tpu_torch.utils.trace``) against the
JAX package's, and the round loop's records, on the CPU.

- The tracer: the same operations on a tracer of each package give the
  same records once the times of spans the tracer timed itself are set
  aside (ids are counters in both and compare equal).
- The ``TRACE.v1`` JSONL written by either package is read by the
  other's ``read_jsonl``, in-memory exports and streamed parts alike.
- A FedAvg and a FedAMW run of each package, traced, with every random
  input of the JAX run injected into the port (``tests/test_torch_slice.py``'s
  ``_pair``): the same span names, counts, parenting and attrs (float
  attrs to 1e-5, the slice tests' tolerance on the same metrics), and
  the same telemetry series; an untraced run records nothing.
- The port's driver with ``--trace_dir`` (``--device cpu``): its two
  files are converted by ``tools/obs_export.py`` (a subprocess) to OTLP
  with both ``resourceSpans`` and ``resourceMetrics``.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import fedamw_tpu.utils.telemetry as jtelemetry
import fedamw_tpu.utils.trace as jtrace
from fedamw_tpu.algorithms import FedAMW as JFedAMW
from fedamw_tpu.algorithms import FedAvg as JFedAvg
from fedamw_tpu.algorithms import prepare_setup as jprepare_setup
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu_torch import exp
from fedamw_tpu_torch.algorithms import FedAMW, FedAvg
import fedamw_tpu_torch.utils.telemetry as ttelemetry
import fedamw_tpu_torch.utils.trace as ttrace
from test_torch_slice import _pair
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SEED, ROUNDS, EPOCHS = 0, 2, 2
TOL = dict(rtol=1e-5, atol=1e-5)


# -- the tracer --------------------------------------------------------------


def _ops_bounded(mod, tmp):
    tr = mod.Tracer(max_spans=4)
    out = [tr.new_id("req"), tr.new_id()]
    out.append(tr.emit("stage", "t-1", 1.0, 0.25, queue=3))
    out.append(tr.emit("stage", "t-1", 2.0, 0.5, parent_id="s-3",
                       attrs={"a": 1}, b=2.5))
    out.append(tr.annotate("retry", "t-1", parent_id="s-3", attempt=2))
    with tr.span("body", "t-2", k="v") as sp:
        pass
    out.append(sp.span_id)
    out.append(tr.emit("over", "t-3", 3.0, 0.1))  # past the bound
    out += [tr.dropped, len(tr)]
    return out, tr.records()


def _ops_error_span(mod, tmp):
    tr = mod.Tracer()
    with pytest.raises(KeyError):
        with tr.span("failing", "t-1", stage="load"):
            raise KeyError("x")
    tr.clear()
    out = [len(tr), tr.dropped]
    with tr.span("after", "t-2"):
        pass
    with pytest.raises(ValueError, match="max_spans"):
        mod.Tracer(max_spans=0)
    return out, tr.records()


def _ops_disabled(mod, tmp):
    tr = mod.Tracer(enabled=False)
    out = [tr.emit("x", "t", 0.0, 1.0), tr.annotate("y", "t"),
           tr.span("z", "t") is tr.span("w", "t"), len(tr), tr.new_id(),
           mod.NULL_TRACER.enabled]
    return out, tr.records()


def _ops_streaming(mod, tmp):
    writer = mod.RotatingJsonlWriter(str(tmp), max_spans_per_file=2)
    tr = mod.Tracer(writer=writer)
    out = [tr.emit("s", "t-1", float(i), 0.5, i=i) for i in range(5)]
    out += [writer.spans_written, [Path(p).name for p in writer.paths],
            len(tr)]
    with pytest.raises(ValueError, match="streaming"):
        tr.export_jsonl(str(tmp / "x.jsonl"))
    writer.close()
    out.append(tr.emit("late", "t-2", 9.0, 0.1))  # closed: dropped
    out.append(tr.dropped)
    parts = [mod.read_jsonl(p) for p in writer.paths]
    return out, parts


def _ops_configure(mod, tmp):
    try:
        a = mod.configure()
        out = [a.enabled, mod.get_tracer() is a, a.max_spans]
        b = mod.configure(stream_dir=str(tmp / "stream"), rotate_spans=3)
        b.emit("s", "t", 0.0, 1.0)
        out += [mod.get_tracer() is b, b.writer.spans_written]
        out.append(mod.configure(False) is mod.NULL_TRACER)
        out.append(b.emit("after", "t", 0.0, 1.0))  # its writer closed
    finally:
        mod.configure(False)
    return out, []


TRACER_OPS = {"bounded": _ops_bounded, "error_span": _ops_error_span,
              "disabled": _ops_disabled, "streaming": _ops_streaming,
              "configure": _ops_configure}


def _timeless(recs):
    """Span records with the times the tracer took itself set aside."""
    out = []
    for r in recs:
        if isinstance(r, tuple):  # a (header, spans) part
            out.append((r[0], _timeless(r[1])))
            continue
        r = dict(r)
        if r["name"] in ("retry", "body", "failing", "after"):
            r.pop("start_s")
            r.pop("dur_s")
        out.append(r)
    return out


@pytest.mark.parametrize("case", sorted(TRACER_OPS))
def test_tracer_matches_jax(case, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jout, jrecs = TRACER_OPS[case](jtrace, tmp_path / "j")
    tout, trecs = TRACER_OPS[case](ttrace, tmp_path / "t")
    assert tout == jout
    assert _timeless(trecs) == _timeless(jrecs)


def test_error_span_records_the_exception_name():
    tr = ttrace.Tracer()
    with pytest.raises(KeyError):
        with tr.span("failing", "t-1", stage="load"):
            raise KeyError("x")
    (rec,) = tr.records()
    assert rec["attrs"] == {"stage": "load", "error": "KeyError"}


@pytest.mark.parametrize("writer,reader", [(ttrace, jtrace), (jtrace, ttrace)],
                         ids=["port_to_jax", "jax_to_port"])
def test_jsonl_is_read_by_the_other_package(writer, reader, tmp_path):
    tr = writer.Tracer()
    tr.emit("train_scan", "run-1", 10.0, 2.0, aggregation="learned",
            faults=False)
    tr.emit("round", "run-1", 10.0, 1.0, parent_id="s-1", round=0,
            p_entropy=3.9)
    tr.annotate("note", "run-1", why="x")
    path = tmp_path / "trace.jsonl"
    assert tr.export_jsonl(str(path)) == 3
    header, spans = reader.read_jsonl(str(path))
    assert header["schema"] == reader.TRACE_SCHEMA == "TRACE.v1"
    assert header["spans"] == 3 and header["dropped"] == 0
    assert {"anchor_unix_s", "anchor_mono_s"} <= set(header)
    assert spans == tr.records()
    assert list(spans[0]) == list(reader.SPAN_FIELDS)


@pytest.mark.parametrize("writer,reader", [(ttrace, jtrace), (jtrace, ttrace)],
                         ids=["port_to_jax", "jax_to_port"])
def test_streamed_parts_are_read_by_the_other_package(writer, reader,
                                                      tmp_path):
    w = writer.RotatingJsonlWriter(str(tmp_path), max_spans_per_file=2)
    tr = writer.Tracer(writer=w)
    for i in range(3):
        tr.emit("s", "t", float(i), 1.0, i=i)
    w.close()
    got = [reader.read_jsonl(p) for p in w.paths]
    assert [h["part"] for h, _ in got] == [1, 2]
    assert all(h["streaming"] for h, _ in got)
    assert [s["attrs"]["i"] for _, spans in got for s in spans] == [0, 1, 2]


def test_read_jsonl_refuses_a_non_trace_file(tmp_path):
    path = tmp_path / "x.jsonl"
    path.write_text(json.dumps({"schema": "TELEMETRY.v1"}) + "\n")
    with pytest.raises(ValueError, match="TRACE"):
        ttrace.read_jsonl(str(path))


@pytest.mark.parametrize("trace_id,span_id", [("req-1", "s-2"),
                                              ("run-7", None)])
def test_context_propagation_matches_jax(trace_id, span_id):
    jc = jtrace.inject_context(trace_id, span_id)
    tc = ttrace.inject_context(trace_id, span_id)
    assert tc == jc
    assert ttrace.format_context(tc) == jtrace.format_context(jc)
    for carrier in (tc, ttrace.format_context(tc)):
        got = ttrace.extract_context(carrier)
        want = jtrace.extract_context(carrier)
        assert (got.trace_id, got.parent_id) == (want.trace_id,
                                                 want.parent_id)


@pytest.mark.parametrize("bad", [
    "TRACECTX.v0;a;b", "TRACECTX.v1;a", {"schema": "x", "trace_id": "a"},
    {"schema": "TRACECTX.v1", "trace_id": ""}, 42])
def test_malformed_carriers_raise_like_jax(bad):
    with pytest.raises(ValueError):
        jtrace.extract_context(bad)
    with pytest.raises(ValueError):
        ttrace.extract_context(bad)


@pytest.mark.parametrize("args", [("", None), ("a;b", None), ("a", "b;c")])
def test_bad_injections_raise_like_jax(args):
    with pytest.raises(ValueError):
        jtrace.inject_context(*args)
    with pytest.raises(ValueError):
        ttrace.inject_context(*args)


# -- the round loop's records ------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    ds = jload_dataset("digits", num_partitions=4, alpha=0.5)
    sj = jprepare_setup(ds, D=64, seed=3, rng=np.random.RandomState(3))
    return (sj,) + _pair(sj, SEED, ROUNDS, EPOCHS, "cpu")


@pytest.fixture
def planes():
    """Both packages' global tracer and registry, fresh, put back to the
    disabled tracer afterwards."""
    yield (jtrace.configure(), jtelemetry.reset_registry(),
           ttrace.configure(), ttelemetry.reset_registry())
    jtrace.configure(False)
    ttrace.configure(False)
    jtelemetry.reset_registry()
    ttelemetry.reset_registry()


RUNS = {
    "FedAvg": (JFedAvg, FedAvg, dict(lr=0.5)),
    "FedAMW": (JFedAMW, FedAMW, dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3)),
    "FedAMW_participation": (JFedAMW, FedAMW,
                             dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3,
                                  participation=0.5)),
}


def _traced_pair(pair, name):
    import jax

    sj, st, inject, p_pos = pair
    jfn, tfn, kw = RUNS[name]
    kw = dict(kw, epoch=EPOCHS, round=ROUNDS, seed=SEED)
    inject = dict(inject)
    if tfn is FedAMW:
        inject["p_positions"] = p_pos
    if "participation" in kw:
        inject["participation_masks"] = np.stack([
            np.asarray(jax.random.uniform(k, (sj.num_clients,)) < 0.5)
            for k in jax.random.split(jax.random.PRNGKey(SEED + 2),
                                      ROUNDS)])
    rj = jfn(sj, **kw)
    rt = tfn(st, **kw, **inject)
    return rj, rt


def _assert_attrs(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
        else:
            assert got[k] == v and type(got[k]) is type(v), k


@pytest.mark.parametrize("name", sorted(RUNS))
def test_traced_run_emits_the_jax_records(pair, planes, name):
    jtr, jreg, ttr, treg = planes
    rj, rt = _traced_pair(pair, name)
    jrecs, trecs = jtr.records(), ttr.records()
    assert [r["name"] for r in trecs] == [r["name"] for r in jrecs] == (
        ["train_scan"] + ["round"] * ROUNDS)
    for recs in (jrecs, trecs):
        scan = recs[0]
        assert scan["parent_id"] is None and scan["kind"] == "span"
        assert all(r["parent_id"] == scan["span_id"]
                   and r["trace_id"] == scan["trace_id"] for r in recs[1:])
        # rounds tile the scan span uniformly
        np.testing.assert_allclose(sum(r["dur_s"] for r in recs[1:]),
                                   scan["dur_s"], rtol=1e-9)
    for t, j in zip(trecs, jrecs):
        _assert_attrs(t["attrs"], j["attrs"])
    if "FedAMW" in name:
        for k in ("p_entropy", "p_max"):
            np.testing.assert_allclose(rt["mixture"][k], rj["mixture"][k],
                                       **TOL)
    # the registry series: same families, labels and values
    jd, td = jreg.dump(), treg.dump()
    assert [(m["name"], m["kind"], m["help"], m["labels"])
            for m in td["metrics"]] == [
        (m["name"], m["kind"], m["help"], m["labels"])
        for m in jd["metrics"]]
    for tm, jm in zip(td["metrics"], jd["metrics"]):
        np.testing.assert_allclose([v for _, v in tm["series"]],
                                   [v for _, v in jm["series"]], **TOL)
        assert len(tm["series"]) == ROUNDS


def test_split_run_records_its_own_rounds(pair, planes):
    """A resumed segment's records cover rounds [start, stop), as the JAX
    package's do."""
    _, _, ttr, _ = planes
    _, st, inject, p_pos = pair
    kw = dict(lr=0.5, lambda_reg=5e-4, lr_p=5e-3, epoch=EPOCHS, round=ROUNDS,
              seed=SEED, return_state=True, p_positions=p_pos, **inject)
    first = FedAMW(st, **kw, stop_round=1)
    FedAMW(st, **kw, start_round=1,
           resume_from={k: first[k] for k in ("params", "p", "p_opt")})
    recs = ttr.records()
    scans = [r for r in recs if r["name"] == "train_scan"]
    assert [(s["attrs"]["start_round"], s["attrs"]["rounds"])
            for s in scans] == [(0, 1), (1, 1)]
    assert [r["attrs"]["round"] for r in recs if r["name"] == "round"] == [
        0, 1]


def test_untraced_run_records_nothing(pair):
    _, st, inject, p_pos = pair
    assert not ttrace.get_tracer().enabled
    reg = ttelemetry.reset_registry()
    res = FedAMW(st, lr=0.5, lambda_reg=5e-4, lr_p=5e-3, epoch=EPOCHS,
                 round=ROUNDS, seed=SEED, p_positions=p_pos, **inject)
    assert ttrace.get_tracer() is ttrace.NULL_TRACER
    assert len(ttrace.NULL_TRACER) == 0
    assert reg.points_recorded() == 0 and not reg.instruments()
    assert res["mixture"]["p_entropy"].shape == (ROUNDS,)


# -- the driver --------------------------------------------------------------

ARGV = ["--device", "cpu", "--dataset", "digits", "--D", "64",
        "--num_partitions", "8", "--round", "3", "--local_epoch", "1",
        "--seed", "100"]


@pytest.fixture(scope="module")
def traced_driver(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drv")
    path = exp.main(ARGV + ["--result_dir", str(tmp / "res"),
                            "--trace_dir", str(tmp / "tr")])
    return tmp, path


def test_driver_trace_dir_writes_the_jax_files(traced_driver, capsys):
    tmp, _ = traced_driver
    header, spans = jtrace.read_jsonl(str(tmp / "tr" /
                                          "exp1_digits_trace.jsonl"))
    assert header["schema"] == "TRACE.v1" and header["spans"] == 12
    scans = {s["span_id"]: s for s in spans if s["name"] == "train_scan"}
    assert sorted(s["attrs"]["aggregation"] for s in scans.values()) == [
        "fixed", "fixed", "learned"]
    rounds = [s for s in spans if s["name"] == "round"]
    assert len(rounds) == 9 and all(r["parent_id"] in scans for r in rounds)
    with open(tmp / "tr" / "exp1_digits_telemetry.json") as f:
        dump = json.load(f)
    assert dump["schema"] == "TELEMETRY.v1"
    series = {(m["name"], m["labels"]["agg"]): len(m["series"])
              for m in dump["metrics"]}
    assert series[("fed_p_entropy", "learned")] == 3
    assert series[("fed_test_acc", "fixed")] == 6  # FedAvg and FedProx
    prom = (tmp / "tr" / "exp1_digits_telemetry.prom").read_text()
    assert jtelemetry.render_prometheus(dump) == prom
    # the driver leaves the process's tracer disabled
    assert ttrace.get_tracer() is ttrace.NULL_TRACER


def test_traced_driver_pickle_equals_the_untraced(traced_driver, tmp_path):
    _, traced = traced_driver
    plain = exp.main(ARGV + ["--result_dir", str(tmp_path)])
    with open(traced, "rb") as f:
        a = pickle.load(f)
    with open(plain, "rb") as f:
        b = pickle.load(f)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("fmt,key", [("otlp", "resourceSpans"),
                                     ("prometheus", None)])
def test_obs_export_converts_the_driver_files(traced_driver, fmt, key):
    tmp, _ = traced_driver
    tr = tmp / "tr"
    out = tmp / f"out.{fmt}"
    inputs = ([str(tr / "exp1_digits_trace.jsonl")] if fmt == "otlp"
              else []) + [str(tr / "exp1_digits_telemetry.json")]
    res = subprocess.run(
        [sys.executable, "tools/obs_export.py", *inputs, "--format", fmt,
         "-o", str(out)], capture_output=True, text=True, cwd=str(REPO),
        timeout=120)
    assert res.returncode == 0, res.stderr
    if fmt == "otlp":
        doc = json.loads(out.read_text())
        assert {"resourceSpans", "resourceMetrics"} <= set(doc)
        spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert len(spans) == 12
        names = {m["name"] for m in
                 doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
        assert {"fed_p_entropy", "fed_p_max", "fed_train_loss"} <= names
    else:
        text = out.read_text()
        assert 'fed_p_entropy{agg="learned"}' in text


def test_driver_profile_writes_a_chrome_trace(tmp_path, capsys):
    exp.main(ARGV + ["--round", "1", "--result_dir", str(tmp_path / "res"),
                     "--profile", str(tmp_path / "prof")])
    assert f"profiler trace -> {tmp_path / 'prof'}" in capsys.readouterr().out
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # a CPU-only capture holds no GPU event
    assert ttelemetry.parse_profiler_trace(str(tmp_path / "prof")) is None


def test_driver_writes_the_trace_when_a_repeat_raises(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("repeat failed")

    monkeypatch.setattr(exp, "run_paper_algorithms", boom)
    with pytest.raises(RuntimeError, match="repeat failed"):
        exp.main(ARGV + ["--result_dir", str(tmp_path / "res"),
                         "--trace_dir", str(tmp_path / "tr"),
                         "--profile", str(tmp_path / "prof")])
    header, spans = ttrace.read_jsonl(str(tmp_path / "tr" /
                                          "exp1_digits_trace.jsonl"))
    assert header["spans"] == 0 and spans == []
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert ttrace.get_tracer() is ttrace.NULL_TRACER
