"""Telemetry plane: typed time-series metrics, SLO signals,
standard-wire exporters, and device-time attribution.

A copy of the JAX package's ``utils/telemetry.py`` with the same names,
instrument semantics and ``TELEMETRY.v1`` dump, so the same instrument
calls give the same dump and the same Prometheus and OTLP text in both
packages, and ``tools/obs_export.py`` converts the port's files
unchanged. Only the device-time attribution is the port's own: it reads
``torch.profiler`` captures. ``torch`` is imported inside those two
functions; the rest of the module is stdlib-only.

Four pieces:

- :class:`Registry` — a thread-safe typed instrument registry.
  ``counter`` / ``gauge`` / ``histogram``, each addressed by name +
  label set (one instrument per distinct label set, Prometheus-style).
  Every instrument is backed by a fixed-capacity **ring buffer** of
  ``(monotonic_t, value)`` samples (:class:`TimeSeries`): past the
  capacity the OLDEST samples are overwritten — for metrics the newest
  window is the one that matters, the opposite degradation from the
  trace collector's keep-oldest (span accounting needs every id;
  a rate needs the recent tail). ``Registry(enabled=False)`` keeps
  cumulative values but skips the series appends.
- :class:`SloEvaluator` — per-class attainment and error-budget burn
  rate over configurable rolling windows, computed from a latency
  histogram's raw sample series. Burn rate is the standard SRE signal
  (``(1 - attainment) / (1 - objective)``): 1.0 burns the budget
  exactly at the objective's rate, >1 is the admission-control /
  autoscaling trigger.
- Exporters: :func:`render_prometheus` (text exposition format) and
  :func:`spans_to_otlp` / :func:`registry_to_otlp` (OTLP-shaped JSON —
  the ``resourceSpans`` / ``resourceMetrics`` envelope, hex ids,
  typed attribute values — so any OTLP-speaking collector ingests the
  traces and metrics without a custom shim).
  ``tools/obs_export.py`` is the CLI over both.
- Device-time attribution: :func:`parse_profiler_trace` reads the
  Chrome-format trace a ``torch.profiler`` capture exported and sums
  the GPU work in it (kernels, copies, memsets);
  :func:`attribute_device_time` correlates that with host-timed
  dispatch to split the blocking time into device compute and
  launch/queue residency. A capture with no GPU event (a CPU-only run)
  degrades to ``source == "none"`` with the reason — never a guess
  dressed as a measurement.

The process-global registry (:func:`get_registry` /
:func:`reset_registry`) mirrors the tracer's configure path: the
training side (``algorithms/core.py``) records per-round series into it
when the global tracer is enabled (``python -m fedamw_tpu_torch.exp
--trace_dir``), so one flag turns on the whole plane.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import hashlib
import json
import os
import threading
import time

#: Schema tag of a serialized registry dump (``Registry.dump``); bumped
#: on incompatible record changes, same discipline as TRACE.v1.
TELEMETRY_SCHEMA = "TELEMETRY.v1"

#: Default ring-buffer capacity per instrument: at one sample per
#: round/request event this holds the recent tail every rolling-window
#: computation needs at a few KB per instrument.
DEFAULT_CAPACITY = 4096

#: Default histogram bucket bounds, in SECONDS (latency-shaped:
#: sub-millisecond through tens of seconds, Prometheus-style).
DEFAULT_BOUNDS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_KINDS = ("counter", "gauge", "histogram")


class TimeSeries:
    """Fixed-capacity ring buffer of ``(t, value)`` samples.

    O(1) append; past ``capacity`` the oldest sample is overwritten and
    counted (``dropped``) — a metrics window wants the newest tail.
    NOT internally locked: the owning instrument serializes access.
    """

    __slots__ = ("capacity", "_t", "_v", "_total")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._t: list[float] = [0.0] * self.capacity
        self._v: list[float] = [0.0] * self.capacity
        self._total = 0

    def append(self, t: float, v: float) -> None:
        i = self._total % self.capacity
        self._t[i] = t
        self._v[i] = v
        self._total += 1

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    @property
    def dropped(self) -> int:
        """Samples overwritten at the ring boundary (0 until wrap)."""
        return max(0, self._total - self.capacity)

    def items(self) -> list[tuple[float, float]]:
        """Snapshot copy, oldest -> newest."""
        n = len(self)
        if self._total <= self.capacity:
            return list(zip(self._t[:n], self._v[:n]))
        start = self._total % self.capacity
        idx = list(range(start, self.capacity)) + list(range(start))
        return [(self._t[i], self._v[i]) for i in idx]

    def window(self, t_min: float) -> list[tuple[float, float]]:
        """Samples with ``t >= t_min``, oldest -> newest."""
        return [(t, v) for t, v in self.items() if t >= t_min]


class _Instrument:
    """Shared machinery: identity, lock, ring-buffer series."""

    kind = "abstract"
    __slots__ = ("name", "labels", "series", "_registry", "_lock")

    def __init__(self, registry: "Registry", name: str,
                 labels: tuple):
        self.name = name
        self.labels = labels  # sorted (key, value) tuple, hashable
        self.series = TimeSeries(registry.capacity)
        self._registry = registry
        self._lock = threading.Lock()

    def _now(self, t: float | None) -> float:
        return self._registry.clock() if t is None else float(t)

    @property
    def label_dict(self) -> dict:
        return dict(self.labels)

    def series_state(self) -> tuple[list, int]:
        """Locked snapshot ``(items, dropped)`` of the ring series —
        the ONE sanctioned way for readers outside this instrument
        (``Registry.dump``) to see it; an unlocked ``series.items()``
        racing an append across the wrap boundary could pair a fresh
        timestamp with a stale value."""
        with self._lock:
            return self.series.items(), self.series.dropped

    def series_counts(self) -> tuple[int, int]:
        """Locked ``(retained, dropped)`` sizes — the O(1) read for
        counting (``Registry.points_recorded``), no snapshot copy."""
        with self._lock:
            return len(self.series), self.series.dropped


class Counter(_Instrument):
    """Monotonic cumulative count. The series stores the CUMULATIVE
    value at each increment, so a window rate is two lookups."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0, t: float | None = None) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {n})")
        with self._lock:
            self._value += n
            if self._registry.enabled:
                self.series.append(self._now(t), self._value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def rate(self, window_s: float, now: float | None = None) -> float:
        """Increments per second over the trailing window — the
        cumulative value now minus the cumulative value at the window
        start, over the window. With no samples before the window (and
        none dropped) the base is an honest zero; after ring wraparound
        the oldest RETAINED sample bounds what is knowable and the rate
        degrades to the observable delta (never an overestimate)."""
        with self._lock:
            now = self._now(now)
            cutoff = now - float(window_s)
            base = None
            for t, v in self.series.items():
                if t <= cutoff:
                    base = v
                else:
                    break
            if base is None:
                if self.series.dropped:
                    items = self.series.items()
                    base = items[0][1] if items else 0.0
                else:
                    base = 0.0
            return max(0.0, self._value - base) / float(window_s)


class Gauge(_Instrument):
    """Last-write-wins value; the series is its trajectory."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def set(self, v: float, t: float | None = None) -> None:
        with self._lock:
            self._value = float(v)
            if self._registry.enabled:
                self.series.append(self._now(t), self._value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def window_stats(self, window_s: float,
                     now: float | None = None) -> dict:
        """min/mean/max/last over the trailing window (None-valued when
        the window holds no samples)."""
        with self._lock:
            now = self._now(now)
            vals = [v for _, v in self.series.window(now - window_s)]
        if not vals:
            return {"n": 0, "min": None, "mean": None, "max": None,
                    "last": None}
        return {"n": len(vals), "min": min(vals),
                "mean": sum(vals) / len(vals), "max": max(vals),
                "last": vals[-1]}


class Histogram(_Instrument):
    """Bucketed distribution + raw-sample ring series.

    The cumulative count/sum/bucket counts are the Prometheus/OTLP
    export surface; the raw series is what rolling-window percentiles
    and SLO attainment read (exact over the retained tail)."""

    kind = "histogram"
    __slots__ = ("bounds", "_bucket_counts", "_count", "_sum")

    def __init__(self, registry, name, labels,
                 bounds=DEFAULT_BOUNDS_S):
        super().__init__(registry, name, labels)
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing, got {bounds!r}")
        self.bounds = b
        self._bucket_counts = [0] * (len(b) + 1)  # +Inf tail
        self._count = 0
        self._sum = 0.0

    def _observe_locked(self, v: float, now: float) -> None:
        self._count += 1
        self._sum += v
        self._bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        if self._registry.enabled:
            self.series.append(now, v)

    def observe(self, v: float, t: float | None = None) -> None:
        with self._lock:
            self._observe_locked(float(v), self._now(t))

    def observe_many(self, values, t: float | None = None) -> None:
        """Observe a batch of values under ONE lock round-trip (and
        one clock read) — the serving metrics record whole micro-
        batches, and per-value locking was a measurable slice of the
        plane's cost under continuous batching's many small batches.
        Series samples share the batch timestamp, which is also the
        honest shape: they were observed together."""
        with self._lock:
            now = self._now(t)
            for v in values:
                self._observe_locked(float(v), now)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> list[int]:
        with self._lock:
            return list(self._bucket_counts)

    def window_values(self, window_s: float,
                      now: float | None = None) -> list[float]:
        with self._lock:
            now = self._now(now)
            return [v for _, v in self.series.window(now - window_s)]

    def percentile(self, q: float, window_s: float | None = None,
                   now: float | None = None) -> float | None:
        """Nearest-rank percentile over the raw series (whole retained
        tail, or the trailing ``window_s``); None with no samples."""
        with self._lock:
            now = self._now(now)
            if window_s is None:
                vals = [v for _, v in self.series.items()]
            else:
                vals = [v for _, v in self.series.window(now - window_s)]
        if not vals:
            return None
        vals.sort()
        idx = min(len(vals) - 1,
                  max(0, -(-q * len(vals) // 100) - 1))
        return vals[int(idx)]


class Registry:
    """Thread-safe instrument registry with label sets.

    One instrument per ``(kind, name, label set)``; re-requesting the
    same triple returns the SAME instrument (the idempotent
    Prometheus-client contract — callers never cache children to stay
    correct, they just ask again). A name re-used under a different
    kind raises: one name, one type, or every exporter lies.

    ``enabled=False`` keeps cumulative values exact but skips every
    ring-buffer append — the "plane off" mode an overhead measurement
    compares against. ``clock`` is
    injectable (tests drive synthetic monotonic time); default is
    ``time.monotonic``.
    """

    def __init__(self, enabled: bool = True,
                 capacity: int = DEFAULT_CAPACITY, clock=time.monotonic):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.clock = clock
        # wall/monotonic anchor pair: exporters map the monotonic
        # series timestamps onto the unix epoch with it (spans stay
        # wall-clock-free; the anchor lives HERE, at the edge)
        self.anchor = {"unix_s": time.time(), "mono_s": clock()}
        self._lock = threading.Lock()
        self._instruments: dict[tuple, _Instrument] = {}
        self._help: dict[str, str] = {}
        self._kinds: dict[str, str] = {}
        self._bounds: dict[str, tuple] = {}

    # -- creation -----------------------------------------------------
    def _get(self, kind: str, name: str, help: str, labels: dict | None,
             bounds=None) -> _Instrument:
        if not name or any(c in name for c in '{}" \n'):
            raise ValueError(f"bad instrument name {name!r}")
        key_labels = tuple(sorted((str(k), str(v))
                                  for k, v in (labels or {}).items()))
        key = (name, key_labels)
        with self._lock:
            prev_kind = self._kinds.get(name)
            if prev_kind is not None and prev_kind != kind:
                raise TypeError(
                    f"instrument {name!r} is a {prev_kind}, requested "
                    f"as a {kind} — one name, one type")
            if bounds is not None and name in self._bounds \
                    and tuple(float(b) for b in bounds) != \
                    self._bounds[name]:
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    "different bounds — label sets of one family "
                    "share one bucket layout")
            inst = self._instruments.get(key)
            if inst is None:
                if kind == "counter":
                    inst = Counter(self, name, key_labels)
                elif kind == "gauge":
                    inst = Gauge(self, name, key_labels)
                else:
                    b = (self._bounds.get(name)
                         or tuple(float(x) for x in
                                  (bounds or DEFAULT_BOUNDS_S)))
                    inst = Histogram(self, name, key_labels, b)
                    self._bounds[name] = inst.bounds
                self._instruments[key] = inst
                self._kinds[name] = kind
                if help:
                    self._help[name] = help
            elif help and name not in self._help:
                self._help[name] = help
            return inst

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get("counter", name, help, labels)

    def lookup(self, name: str,
               labels: dict | None = None) -> _Instrument | None:
        """The non-creating read: the instrument for ``(name, label
        set)`` or None when nothing has registered it — what read-only
        consumers (the SLO evaluator) use, so polling can never mint
        phantom empty families into the export surface."""
        key_labels = tuple(sorted((str(k), str(v))
                                  for k, v in (labels or {}).items()))
        with self._lock:
            return self._instruments.get((name, key_labels))

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None,
                  bounds=None) -> Histogram:
        return self._get("histogram", name, help, labels, bounds=bounds)

    # -- introspection ------------------------------------------------
    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return sorted(self._instruments.values(),
                          key=lambda i: (i.name, i.labels))

    def help_text(self, name: str) -> str:
        with self._lock:
            return self._help.get(name, "")

    def points_recorded(self) -> int:
        """Total ring-buffer samples currently retained + overwritten —
        how much series data the plane actually produced."""
        total = 0
        for inst in self.instruments():
            retained, dropped = inst.series_counts()
            total += retained + dropped
        return total

    def snapshot(self) -> dict:
        """Flat ``{"name{k=v,...}": value}`` view — counters/gauges by
        value, histograms as ``{count, sum}``."""
        out = {}
        for inst in self.instruments():
            key = inst.name
            if inst.labels:
                key += "{" + ",".join(f"{k}={v}"
                                      for k, v in inst.labels) + "}"
            if inst.kind == "histogram":
                out[key] = {"count": inst.count,
                            "sum": round(inst.sum, 9)}
            else:
                out[key] = inst.value
        return out

    def dump(self) -> dict:
        """Serializable full state (``TELEMETRY.v1``): every
        instrument with its cumulative value and retained series.
        ``tools/obs_export.py`` converts this to OTLP JSON or
        Prometheus text offline."""
        metrics = []
        for inst in self.instruments():
            items, dropped = inst.series_state()
            rec = {
                "name": inst.name,
                "kind": inst.kind,
                "help": self.help_text(inst.name),
                "labels": inst.label_dict,
                "series": [[round(t, 9), v] for t, v in items],
                "series_dropped": dropped,
            }
            if inst.kind == "histogram":
                rec["count"] = inst.count
                rec["sum"] = inst.sum
                rec["bounds"] = list(inst.bounds)
                rec["bucket_counts"] = inst.bucket_counts()
            else:
                rec["value"] = inst.value
            metrics.append(rec)
        return {"schema": TELEMETRY_SCHEMA, "anchor": dict(self.anchor),
                "metrics": metrics}


# ---------------------------------------------------------------------
# SLO evaluation
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SloClass:
    """One service class: a request is GOOD iff its latency lands at or
    under ``threshold_ms``; ``objective`` is the target good-fraction
    (0.99 = 1% error budget).

    ``default_timeout_s``: the request DEADLINE this class implies —
    what a serving front end applies when a submit names the class but
    hand-picks no ``timeout_s``. None derives it as ``4 x threshold_ms``:
    a request that has already quadrupled its SLO bound is SLO-bad whatever
    happens next, so holding the caller longer only burns queue
    residency the control plane charges against everyone else. The
    vocabulary owning the timeout is what lets callers stop picking
    deadlines per call; an explicit ``timeout_s=`` still wins."""

    name: str
    threshold_ms: float
    objective: float = 0.99
    default_timeout_s: float | None = None

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective} "
                f"(1.0 leaves a zero error budget — burn rate would "
                "divide by zero)")
        if self.threshold_ms <= 0:
            raise ValueError(
                f"threshold_ms must be positive, got {self.threshold_ms}")
        if self.default_timeout_s is not None \
                and self.default_timeout_s <= 0:
            raise ValueError(
                f"default_timeout_s must be positive when set, got "
                f"{self.default_timeout_s}")

    def timeout_s(self) -> float:
        """The class's request deadline, in seconds: the explicit
        ``default_timeout_s`` when set, else ``4 x threshold_ms``."""
        return (self.default_timeout_s
                if self.default_timeout_s is not None
                else 4.0 * self.threshold_ms / 1e3)


#: The default service classes:
#: interactive traffic against a tight bound, batch against a loose one.
DEFAULT_SLO_CLASSES = (SloClass("interactive", threshold_ms=50.0,
                                objective=0.99),
                       SloClass("batch", threshold_ms=500.0,
                                objective=0.95))


class SloEvaluator:
    """Per-class SLO attainment + error-budget burn rate over rolling
    windows, read from a latency histogram family in ``registry``
    (label ``class=<name>``, values in SECONDS — the family
    ``ServeMetrics`` records) plus the per-class deadline-miss counter
    family (``miss_metric``): a request whose deadline expired
    UNSERVED is SLO-bad regardless of how long it waited — judging it
    by its waited time would read a 50ms death as "good" under a
    100ms threshold, hiding overload from the burn signal exactly
    when callers run deadlines tighter than the class objective.

    ``evaluate()`` is a pure read (no instrument mutation): safe to
    poll from any thread at any cadence — the admission-control /
    autoscaler consumers this plane exists for.
    """

    def __init__(self, registry: Registry,
                 metric: str = "serve_request_latency_seconds",
                 classes=DEFAULT_SLO_CLASSES,
                 windows_s=(60.0, 300.0),
                 miss_metric: str = "serve_deadline_misses_total"):
        if not classes:
            raise ValueError("need at least one SloClass")
        if not windows_s or any(w <= 0 for w in windows_s):
            raise ValueError(f"windows must be positive, got {windows_s}")
        self.registry = registry
        self.metric = metric
        self.miss_metric = miss_metric
        self.classes = tuple(classes)
        self.windows_s = tuple(float(w) for w in windows_s)

    def _window_record(self, cls: SloClass, window_s: float,
                       now: float) -> dict:
        """ONE class x window evaluation — the single definition both
        :meth:`evaluate` and :meth:`burn_rates` share (two copies of
        this arithmetic would let the admission controller and the
        SLO export disagree about the same window). ``total`` counts
        served requests PLUS deadline misses; only served
        under-threshold requests are ``good``."""
        hist = self.registry.lookup(self.metric,
                                    labels={"class": cls.name})
        vals = (hist.window_values(window_s, now=now)
                if isinstance(hist, Histogram) else [])
        miss = self.registry.lookup(self.miss_metric,
                                    labels={"class": cls.name})
        missed = (int(round(miss.rate(window_s, now=now) * window_s))
                  if isinstance(miss, Counter) else 0)
        total = len(vals) + missed
        thr_s = cls.threshold_ms / 1e3
        good = sum(1 for v in vals if v <= thr_s)
        budget = 1.0 - cls.objective
        if total:
            att = good / total
            err = 1.0 - att
            burn = err / budget
        else:
            att = err = burn = None
        return {
            "total": total, "good": good, "missed": missed,
            "attainment": None if att is None else round(att, 6),
            "error_rate": None if err is None else round(err, 6),
            "budget": round(budget, 6),
            "burn_rate": None if burn is None else round(burn, 4),
        }

    def evaluate(self, now: float | None = None) -> dict:
        """``{"schema": "SLO.v1", "classes": {name: {objective,
        threshold_ms, windows: {"60s": {total, good, attainment,
        error_rate, budget, burn_rate}}}}}``.

        ``attainment``/``burn_rate`` are None over an empty window (no
        traffic is not 100% good — an autoscaler must see "no data",
        not a perfect score)."""
        now = self.registry.clock() if now is None else float(now)
        out: dict = {"schema": "SLO.v1", "now_s": round(now, 6),
                     "metric": self.metric, "classes": {}}
        for cls in self.classes:
            # non-creating lookups throughout (_window_record):
            # evaluating a class that has seen no traffic must not
            # register a phantom empty family into every subsequent
            # export (evaluate() is a pure read)
            rec: dict = {"objective": cls.objective,
                         "threshold_ms": cls.threshold_ms,
                         "windows": {}}
            for w in self.windows_s:
                rec["windows"][f"{int(w)}s"] = \
                    self._window_record(cls, w, now)
            out["classes"][cls.name] = rec
        return out

    def burn_rates(self, window_s: float | None = None,
                   now: float | None = None) -> dict:
        """One window's records only — ``{class_name: window_record}``
        with the same fields ``evaluate`` emits (``total`` / ``good`` /
        ``attainment`` / ``burn_rate`` ...), over ``window_s`` (default:
        the evaluator's first configured window). The admission
        controller and autoscaler poll exactly one window per tick;
        computing every configured window there would be wasted work
        on the submit path."""
        w = self.windows_s[0] if window_s is None else float(window_s)
        if w <= 0:
            raise ValueError(f"window must be positive, got {window_s}")
        now = self.registry.clock() if now is None else float(now)
        return {cls.name: self._window_record(cls, w, now)
                for cls in self.classes}


# ---------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------

def _prom_labels(labels) -> str:
    if not labels:
        return ""
    items = labels.items() if isinstance(labels, dict) else labels
    parts = []
    for k, v in items:
        escaped = str(v).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{escaped}"')
    return "{" + ",".join(parts) + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    if f != f:  # NaN — a diverging run's loss gauge must still render
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(source) -> str:
    """Prometheus text exposition of a :class:`Registry` (or a
    ``Registry.dump()`` dict): ``# HELP`` / ``# TYPE`` headers per
    family, one sample line per label set, histograms as the standard
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet with a
    cumulative ``+Inf`` bucket."""
    dump = source.dump() if isinstance(source, Registry) else source
    if not isinstance(dump, dict) or "metrics" not in dump:
        raise ValueError("render_prometheus needs a Registry or a "
                         f"{TELEMETRY_SCHEMA} dump dict")
    by_name: dict[str, list[dict]] = {}
    for rec in dump["metrics"]:
        by_name.setdefault(rec["name"], []).append(rec)
    lines: list[str] = []
    for name in sorted(by_name):
        recs = by_name[name]
        kind = recs[0]["kind"]
        help_text = recs[0].get("help") or ""
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for rec in recs:
            labels = rec.get("labels") or {}
            if kind == "histogram":
                cum = 0
                bounds = rec["bounds"]
                for b, n in zip(bounds, rec["bucket_counts"]):
                    cum += n
                    le = dict(labels, le=_prom_num(b))
                    lines.append(f"{name}_bucket{_prom_labels(le)} {cum}")
                cum += rec["bucket_counts"][len(bounds)]
                le = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_prom_labels(le)} {cum}")
                lines.append(f"{name}_sum{_prom_labels(labels)} "
                             f"{_prom_num(rec['sum'])}")
                lines.append(f"{name}_count{_prom_labels(labels)} "
                             f"{rec['count']}")
            else:
                lines.append(f"{name}{_prom_labels(labels)} "
                             f"{_prom_num(rec['value'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Minimal inverse of :func:`render_prometheus` (the round-trip
    check the tests pin, and a debugging convenience): ``{sample_name
    {labels}: float}`` — histogram bucket/sum/count lines appear under
    their suffixed names."""
    out: dict[str, float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        try:
            key, val = ln.rsplit(None, 1)
        except ValueError:
            raise ValueError(f"unparseable exposition line {ln!r}")
        out[key] = float(val)
    return out


# ---------------------------------------------------------------------
# OTLP-shaped JSON
# ---------------------------------------------------------------------

def _otlp_value(v) -> dict:
    """An OTLP ``AnyValue``: typed wrapper keyed by JSON type."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP JSON carries 64-bit as str
    if isinstance(v, float):
        return {"doubleValue": _otlp_double(v)}
    return {"stringValue": str(v)}


def _otlp_double(f: float):
    """proto3 JSON spells non-finite doubles as strings — a bare NaN
    in the output would be invalid JSON to every OTLP collector (and a
    diverging run's loss IS NaN)."""
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "Infinity" if f > 0 else "-Infinity"
    return f


def _otlp_attrs(d: dict) -> list[dict]:
    return [{"key": str(k), "value": _otlp_value(v)}
            for k, v in d.items()]


def _otlp_trace_id(raw: str) -> str:
    """Deterministic 16-byte hex trace id from a repo-native id
    (``req-42``): OTLP requires fixed-width binary ids, the repo uses
    readable counters — a keyed hash maps one onto the other stably,
    and the raw id rides along as an attribute."""
    return hashlib.md5(raw.encode()).hexdigest()


def _otlp_span_id(raw: str) -> str:
    return hashlib.md5(raw.encode()).hexdigest()[:16]


def _nanos(mono_s: float, anchor: dict | None) -> str:
    """Monotonic seconds -> unix nanos via the wall/monotonic anchor
    pair; with no anchor, the monotonic value maps directly (a
    RELATIVE timeline — ordering and durations exact, epoch arbitrary,
    and the output says so via the caller's resource attrs)."""
    if anchor:
        mono_s = (float(anchor["unix_s"])
                  + (mono_s - float(anchor["mono_s"])))
    return str(max(0, int(mono_s * 1e9)))


def spans_to_otlp(spans, anchor: dict | None = None,
                  service_name: str = "fedamw_tpu") -> dict:
    """TRACE.v1 span records -> an OTLP-shaped ``resourceSpans``
    envelope: hex trace/span/parent ids (raw ids preserved as
    attributes), unix-nano timestamps via ``anchor`` (the
    ``{"unix_s", "mono_s"}`` pair the trace export header carries),
    attrs as typed OTLP attributes. Annotations (zero-duration point
    events) ride as zero-length spans with ``kind_raw=annotation``."""
    out_spans = []
    for r in spans:
        attrs = dict(r.get("attrs") or {})
        attrs["id_raw"] = r["span_id"]
        attrs["trace_id_raw"] = r["trace_id"]
        if r.get("kind") and r["kind"] != "span":
            attrs["kind_raw"] = r["kind"]
        start = float(r["start_s"])
        end = start + float(r["dur_s"])
        out_spans.append({
            "traceId": _otlp_trace_id(r["trace_id"]),
            "spanId": _otlp_span_id(r["span_id"]),
            "parentSpanId": (_otlp_span_id(r["parent_id"])
                             if r.get("parent_id") else ""),
            "name": r["name"],
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": _nanos(start, anchor),
            "endTimeUnixNano": _nanos(end, anchor),
            "attributes": _otlp_attrs(attrs),
        })
    resource_attrs = {"service.name": service_name,
                      "telemetry.sdk.name": "fedamw_tpu.utils.trace",
                      "fedamw.timeline": ("unix" if anchor
                                          else "monotonic-relative")}
    return {"resourceSpans": [{
        "resource": {"attributes": _otlp_attrs(resource_attrs)},
        "scopeSpans": [{
            "scope": {"name": "fedamw_tpu.utils.trace",
                      "version": "TRACE.v1"},
            "spans": out_spans,
        }],
    }]}


def registry_to_otlp(source, service_name: str = "fedamw_tpu") -> dict:
    """A :class:`Registry` (or its ``dump()``) -> an OTLP-shaped
    ``resourceMetrics`` envelope. Counters and gauges export their full
    retained SERIES (one data point per ring sample — the whole point
    of the time-series plane); histograms export their cumulative
    bucketed state as one data point."""
    dump = source.dump() if isinstance(source, Registry) else source
    if not isinstance(dump, dict) or "metrics" not in dump:
        raise ValueError("registry_to_otlp needs a Registry or a "
                         f"{TELEMETRY_SCHEMA} dump dict")
    anchor = dump.get("anchor")
    # one OTLP metric per FAMILY: the label sets of one name merge
    # into one entry's dataPoints (collectors tolerate repeated names,
    # but the protocol's shape is one metric, many attributed points)
    metrics: list[dict] = []
    by_name: dict[str, dict] = {}
    for rec in dump["metrics"]:
        attrs = _otlp_attrs(rec.get("labels") or {})
        m = by_name.get(rec["name"])
        if m is None:
            m = by_name[rec["name"]] = {
                "name": rec["name"],
                "description": rec.get("help") or ""}
            metrics.append(m)
        if rec["kind"] == "histogram":
            body = m.setdefault("histogram", {
                "aggregationTemporality": 2,  # CUMULATIVE
                "dataPoints": []})
            body["dataPoints"].append({
                "attributes": attrs,
                "timeUnixNano": _nanos(
                    rec["series"][-1][0] if rec["series"]
                    else (anchor or {}).get("mono_s", 0.0), anchor),
                "count": str(rec["count"]),
                "sum": _otlp_double(float(rec["sum"])),
                "bucketCounts": [str(n) for n in rec["bucket_counts"]],
                "explicitBounds": list(rec["bounds"]),
            })
        else:
            series = rec["series"] or [[
                (anchor or {}).get("mono_s", 0.0), rec["value"]]]
            points = [{"attributes": attrs,
                       "timeUnixNano": _nanos(t, anchor),
                       "asDouble": _otlp_double(float(v))}
                      for t, v in series]
            if rec["kind"] == "counter":
                body = m.setdefault("sum", {
                    "aggregationTemporality": 2,
                    "isMonotonic": True, "dataPoints": []})
            else:
                body = m.setdefault("gauge", {"dataPoints": []})
            body["dataPoints"].extend(points)
    resource_attrs = {"service.name": service_name,
                      "fedamw.timeline": ("unix" if anchor
                                          else "monotonic-relative")}
    return {"resourceMetrics": [{
        "resource": {"attributes": _otlp_attrs(resource_attrs)},
        "scopeMetrics": [{
            "scope": {"name": "fedamw_tpu.utils.telemetry",
                      "version": TELEMETRY_SCHEMA},
            "metrics": metrics,
        }],
    }]}


# ---------------------------------------------------------------------
# Device-time attribution (torch.profiler correlation)
# ---------------------------------------------------------------------

#: Chrome-trace categories of GPU work in a ``torch.profiler`` export:
#: kernels, copies and memsets, each on the lane of its CUDA stream.
#: ``gpu_user_annotation`` is left out: it spans kernels already counted.
GPU_EVENT_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: File names of the Chrome traces ``torch.profiler`` exports
#: (``export_chrome_trace``, ``tensorboard_trace_handler``), plain or
#: gzipped.
_TRACE_GLOBS = ("*.pt.trace.json", "*.json.gz")


def parse_profiler_trace(trace_dir: str) -> dict | None:
    """Read the newest Chrome-format trace a ``torch.profiler`` capture
    exported under ``trace_dir`` (``*.pt.trace.json``, or ``*.json.gz``
    where gzipped) and sum the GPU work in it: the ``"X"`` events of
    :data:`GPU_EVENT_CATEGORIES`. CPU operators and CUDA runtime calls
    are deliberately excluded: host time is not device compute.

    Returns ``{"device_busy_s", "device_events", "device_lanes"}``
    (``device_lanes``: the distinct ``(pid, tid)`` pairs carrying such
    events, one per CUDA stream) or **None** when the capture holds no
    GPU event — which is exactly what a CPU-only capture looks like,
    and is the graceful-fallback signal :func:`attribute_device_time`
    turns into ``source="none"``. Raises nothing for a missing or
    corrupt capture either: attribution is an optional refinement,
    never a crash source.
    """
    paths = sorted(
        {p for pattern in _TRACE_GLOBS
         for p in glob.glob(os.path.join(trace_dir, "**", pattern),
                            recursive=True)},
        key=os.path.getmtime)
    if not paths:
        return None
    opener = gzip.open if paths[-1].endswith(".gz") else open
    try:
        with opener(paths[-1], "rt") as f:
            trace = json.load(f)
    except (OSError, ValueError):
        return None
    events = (trace.get("traceEvents") or []) if isinstance(trace, dict) \
        else []
    busy_us = 0.0
    n = 0
    lanes = set()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in GPU_EVENT_CATEGORIES:
            busy_us += float(e.get("dur") or 0.0)
            n += 1
            lanes.add((e.get("pid"), e.get("tid")))
    if not n:
        return None
    return {"device_busy_s": busy_us / 1e6, "device_events": n,
            "device_lanes": len(lanes)}


def attribute_device_time(dispatch, reps: int = 8,
                          trace_dir: str | None = None) -> dict:
    """Correlate a ``torch.profiler`` capture with host-timed dispatch
    to split the blocking time of a unit of work into device compute and
    launch/queue residency.

    ``dispatch`` is a zero-arg callable running ONE unit of work (a
    round, a request) and returning its host-blocking seconds (it must
    end in a device synchronisation for that to mean anything). The
    callable runs ``reps`` times under one profiler capture (CPU and,
    where a card is present, CUDA activity), exported as a Chrome trace
    into ``trace_dir`` (a scratch directory when None); GPU busy time
    from the capture is divided by the host total:

    - GPU events present: ``source="profiler"``, ``compute_fraction``
      in [0, 1], ``xla_queue_s`` = host blocking time not accounted by
      device busy time (the JAX package's key, kept for the schema:
      here it is launch and queue time).
    - no GPU event (a CPU-only run), profiler unavailable, or any
      capture failure: ``source="none"`` with the reason — the tested
      graceful fallback.
    """
    import shutil
    import tempfile

    scratch = None
    if trace_dir is None:
        trace_dir = scratch = tempfile.mkdtemp(prefix="fedamw_devattr_")
    host_s = 0.0
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(max(1, int(reps))):
                host_s += float(dispatch())
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"devattr_{os.getpid()}_{time.time_ns()}"
            ".pt.trace.json"))
        parsed = parse_profiler_trace(trace_dir)
    except Exception as e:
        # attribution must never take the caller down: a broken
        # profiler degrades to the unsplit time, with the reason named
        return {"source": "none", "reason": f"{type(e).__name__}: {e}",
                "reps": int(reps), "dispatch_s": round(host_s, 6)}
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    if parsed is None:
        return {"source": "none",
                "reason": "profiler capture holds no GPU event "
                          "(CPU-only run)",
                "reps": int(reps), "dispatch_s": round(host_s, 6)}
    busy = min(parsed["device_busy_s"], host_s)
    frac = busy / host_s if host_s > 0 else 0.0
    return {
        "source": "profiler",
        "reps": int(reps),
        "dispatch_s": round(host_s, 6),
        "device_compute_s": round(busy, 6),
        "xla_queue_s": round(max(0.0, host_s - busy), 6),
        "compute_fraction": round(frac, 6),
        "device_events": parsed["device_events"],
        "device_lanes": parsed["device_lanes"],
    }


# ---------------------------------------------------------------------
# Process-global registry (the tracer-configure-path twin)
# ---------------------------------------------------------------------

_global_registry = Registry()
_global_lock = threading.Lock()


def get_registry() -> Registry:
    """The process-global registry the training side records into
    (``algorithms/core.py``, gated behind the global tracer being
    enabled — the driver's one ``--trace_dir`` flag turns on the
    plane)."""
    return _global_registry


def reset_registry(enabled: bool = True,
                   capacity: int = DEFAULT_CAPACITY) -> Registry:
    """Swap in a fresh process-global registry (the driver isolates a
    traced run with this; tests isolate cases). Returns the new
    registry."""
    global _global_registry
    with _global_lock:
        _global_registry = Registry(enabled=enabled, capacity=capacity)
        return _global_registry
