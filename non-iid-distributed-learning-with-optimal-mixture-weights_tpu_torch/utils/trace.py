"""Trace plane: monotonic-clock spans with ids, stdlib-only.

A copy of the JAX package's ``utils/trace.py`` (``fedamw_tpu``), kept
stdlib-only and with the same names, record layout and ``TRACE.v1``
JSONL header, so a trace written by either package is read by the
other's :func:`read_jsonl` and converted by ``tools/obs_export.py``.

Design:

- A **span** is one timed interval: ``name``, a ``trace_id`` grouping
  every span of one request/run, its own ``span_id``, an optional
  ``parent_id``, a monotonic ``start_s`` (``time.perf_counter`` basis —
  durations are exact, wall-clock is deliberately absent), ``dur_s``,
  and a flat ``attrs`` dict. A **kind** of ``"annotation"`` marks a
  zero-duration point event attached to the same trace id.
- :class:`Tracer` is a thread-safe bounded collector. Past
  ``max_spans`` it DROPS new spans and counts them (``dropped``):
  keeping the oldest keeps the "every id appears exactly once"
  accounting intact where a ring-buffer overwrite would break it.
- Disabled mode is free: ``Tracer(enabled=False)`` (or the shared
  :data:`NULL_TRACER`) makes ``emit``/``annotate`` immediate returns
  and ``span()`` hand back one process-wide no-op context manager —
  no per-call allocation.
- Export is JSONL (one span object per line, ``schema`` in a leading
  header line that also carries a wall/monotonic anchor pair) via
  :meth:`Tracer.export_jsonl`; :func:`read_jsonl` round-trips it.
- **Streaming** mode (:class:`RotatingJsonlWriter` passed as
  ``Tracer(writer=...)``) is for long-lived loops: spans are written
  straight to a rotating JSONL file set instead of accumulating in
  memory, so a process that runs for days holds O(1) trace memory.
  Each part file carries the same schema header (``read_jsonl`` reads
  any part); rotation is by span count.

The process-global tracer (:func:`configure` / :func:`get_tracer`) is
how the training side opts in without threading a tracer through every
algorithm signature: ``python -m fedamw_tpu_torch.exp --trace_dir``
configures it, and ``algorithms/core.py`` emits per-round records when
it is enabled — host-timed from just before the first round to the
metrics' copy to the host, with the per-round duration attributed
uniformly (measuring each round's end would need a device
synchronisation per round, which would change the timing being traced;
the records say so via ``attrs["timing"] == "uniform"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time

#: JSONL header schema tag (bumped on incompatible record changes).
TRACE_SCHEMA = "TRACE.v1"

#: Record keys every exported span carries, in export order.
SPAN_FIELDS = ("name", "kind", "trace_id", "span_id", "parent_id",
               "start_s", "dur_s", "attrs")


class _NullSpan:
    """The shared no-op context manager disabled tracers hand out.

    One process-wide instance (:data:`_NULL_SPAN`): ``span()`` on a
    disabled tracer must not allocate per call — serving's submit path
    runs it per request.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager recording one span on exit (success or raise)."""

    __slots__ = ("_tracer", "name", "trace_id", "parent_id", "attrs",
                 "_t0", "span_id")

    def __init__(self, tracer, name, trace_id, parent_id, attrs):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.span_id = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if exc_type is not None:
            # a failed stage is the span you want most; never swallow
            self.attrs = dict(self.attrs, error=exc_type.__name__)
        self.span_id = self._tracer.emit(
            self.name, self.trace_id, self._t0, dur,
            parent_id=self.parent_id, **self.attrs)
        return False


class RotatingJsonlWriter:
    """Span sink for long-lived loops: JSONL part files rotated by
    span count, each opening with the ``TRACE.v1`` schema header so
    :func:`read_jsonl` reads any part standalone.

    Rotation keeps every part boundable (ship/delete parts while the
    service keeps running) and the writer itself holds no spans — the
    memory the in-memory collector would otherwise grow without bound.
    Thread-safe: the serving worker and a publisher thread may emit
    concurrently. ``close()`` is idempotent; writing after close
    raises (a silent drop would break the exactly-once accounting its
    consumers count on).
    """

    def __init__(self, directory: str, max_spans_per_file: int = 50_000,
                 prefix: str = "trace"):
        if max_spans_per_file <= 0:
            raise ValueError("max_spans_per_file must be positive, got "
                             f"{max_spans_per_file}")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_spans_per_file = int(max_spans_per_file)
        self.prefix = prefix
        self._lock = threading.Lock()
        self._file = None
        # resume numbering PAST any parts already in the directory: a
        # restarted process (the crash case this writer's per-span
        # flush exists for) must never truncate the previous run's
        # trace-00001 — those are exactly the spans worth keeping
        tag = f"{prefix}-"
        existing = [f[len(tag):-len(".jsonl")]
                    for f in os.listdir(directory)
                    if f.startswith(tag) and f.endswith(".jsonl")]
        self._part = max((int(s) for s in existing if s.isdigit()),
                         default=0)
        self._in_part = 0
        self._written = 0
        self._closed = False
        self.paths: list[str] = []

    def _rotate_locked(self) -> None:
        if self._file is not None:
            self._file.close()
        self._part += 1
        self._in_part = 0
        path = os.path.join(
            self.directory, f"{self.prefix}-{self._part:05d}.jsonl")
        self._file = open(path, "w")
        # parts are standalone trace files: same schema family header
        # export_jsonl writes, marked streaming (span count unknowable
        # upfront, and dropped is structurally zero — nothing buffers)
        self._file.write(json.dumps({
            "schema": TRACE_SCHEMA, "streaming": True,
            "part": self._part}) + "\n")
        self.paths.append(path)

    def write(self, rec: dict) -> None:
        """Append one span record (the :data:`SPAN_FIELDS` subset),
        rotating first when the current part is full."""
        line = json.dumps({k: rec[k] for k in SPAN_FIELDS})
        with self._lock:
            if self._closed:
                # a dedicated flag, not `_file is None`: closing
                # BEFORE the first span leaves no file either, and
                # the lazy open below must not silently resurrect a
                # closed writer (the consumer already counted
                # paths/spans_written)
                raise ValueError("RotatingJsonlWriter is closed")
            if self._file is None:
                self._rotate_locked()
            if self._in_part >= self.max_spans_per_file:
                self._rotate_locked()
            self._file.write(line + "\n")
            # flush per span: this mode exists for processes that die
            # without close() (OOM, preemption) and for shippers
            # tailing the live part — buffered tails would lose the
            # last spans and hand readers a truncated JSON line
            self._file.flush()
            self._in_part += 1
            self._written += 1

    @property
    def spans_written(self) -> int:
        with self._lock:
            return self._written

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Tracer:
    """Thread-safe bounded span collector with a free disabled mode.

    ``writer`` (a :class:`RotatingJsonlWriter`) switches the tracer to
    streaming: completed spans go straight to the writer's rotating
    JSONL files and the in-memory list stays empty — ``records()``
    returns nothing and :meth:`export_jsonl` refuses (the spans are
    already on disk). ``max_spans``/``dropped`` do not apply; the
    writer counts via ``spans_written``.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 100_000,
                 writer: "RotatingJsonlWriter | None" = None):
        if max_spans <= 0:
            raise ValueError(f"max_spans must be positive, got {max_spans}")
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self.writer = writer
        self._spans: list[dict] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    # -- ids ----------------------------------------------------------
    def new_id(self, prefix: str = "t") -> str:
        """A fresh process-unique trace/request id (``prefix-N``).
        Cheap and monotonic; handed out even when disabled, so callers
        (serving's submit) never branch on tracer state for identity."""
        return f"{prefix}-{next(self._ids)}"

    # -- recording ----------------------------------------------------
    def emit(self, name: str, trace_id: str, start_s: float,
             dur_s: float, parent_id: str | None = None,
             kind: str = "span", attrs: dict | None = None,
             **kw) -> str | None:
        """Record one completed span; returns its span id (None when
        disabled or dropped at the bound). Attributes go in ``attrs``
        (the caller's dict is taken as-is — the hot-path spelling; the
        serving loop emits one span per request) or as keyword
        arguments (the convenient spelling); both at once merge, kw
        winning."""
        if not self.enabled:
            return None
        if attrs is None:
            attrs = kw
        elif kw:
            attrs = {**attrs, **kw}
        rec = {
            "name": name,
            "kind": kind,
            "trace_id": trace_id,
            "span_id": None,  # assigned under the lock, below
            "parent_id": parent_id,
            "start_s": float(start_s),
            "dur_s": float(dur_s),
            "attrs": attrs,
        }
        if self.writer is not None:
            # streaming: the id counter is already thread-safe
            # (itertools.count) and the writer locks internally, so no
            # collector lock is taken — the span never lands in memory
            rec["span_id"] = f"s-{next(self._ids)}"
            try:
                self.writer.write(rec)
            except (ValueError, OSError):
                # a SUPERSEDED tracer whose writer was closed by a
                # reconfigure, or a writer whose disk just filled
                # (ENOSPC on the per-span flush) — either way, degrade
                # like the bounded collector: count the span as
                # dropped instead of raising into the emitting thread
                # (which could be the serving worker, whose death
                # would strand every queued future)
                with self._lock:
                    self._dropped += 1
                return None
            return rec["span_id"]
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self._dropped += 1
                return None
            rec["span_id"] = f"s-{next(self._ids)}"
            self._spans.append(rec)
        return rec["span_id"]

    def annotate(self, name: str, trace_id: str,
                 parent_id: str | None = None, **attrs) -> str | None:
        """A zero-duration point event (retry, deadline verdict) on an
        existing trace — rendered alongside its spans on export."""
        if not self.enabled:  # skip even the perf_counter call
            return None
        return self.emit(name, trace_id, time.perf_counter(), 0.0,
                         parent_id=parent_id, kind="annotation", **attrs)

    def span(self, name: str, trace_id: str,
             parent_id: str | None = None, **attrs):
        """Context manager timing its body into one span. Disabled
        tracers return the shared no-op instance (zero allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, trace_id, parent_id, attrs)

    # -- introspection / export ---------------------------------------
    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def records(self) -> list[dict]:
        """Snapshot copy of the collected spans, in emit order."""
        with self._lock:
            return [dict(r) for r in self._spans]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def export_jsonl(self, path: str) -> int:
        """Write ``{schema header}\\n{span}\\n...``; returns the span
        count written (header excluded)."""
        if self.writer is not None:
            raise ValueError(
                "streaming tracer: spans were already exported to "
                f"{self.writer.directory!r} as they were emitted "
                "(writer.paths lists the part files)")
        recs = self.records()
        with open(path, "w") as f:
            # the wall/monotonic anchor pair lands in the HEADER only
            # (spans stay wall-clock-free by design): exporters that
            # need epoch timestamps (tools/obs_export.py -> OTLP) map
            # the monotonic span times through it
            f.write(json.dumps({"schema": TRACE_SCHEMA,
                                "spans": len(recs),
                                "dropped": self.dropped,
                                "anchor_unix_s": time.time(),
                                "anchor_mono_s": time.perf_counter()
                                }) + "\n")
            for r in recs:
                f.write(json.dumps({k: r[k] for k in SPAN_FIELDS}) + "\n")
        return len(recs)


def read_jsonl(path: str) -> tuple[dict, list[dict]]:
    """Inverse of :meth:`Tracer.export_jsonl`:
    ``(header, spans)``. Raises ``ValueError`` on a non-trace file —
    the header line must carry the ``TRACE.`` schema family."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or not str(lines[0].get("schema", "")).startswith("TRACE."):
        raise ValueError(f"{path}: not a trace JSONL (missing "
                         f"{TRACE_SCHEMA!r}-family header line)")
    return lines[0], lines[1:]


# ---------------------------------------------------------------------
# Trace-context propagation (one trace id across a process boundary)
# ---------------------------------------------------------------------

#: Version tag of the serialized context carrier. Distinct from
#: TRACE_SCHEMA: the carrier crosses a process boundary between
#: possibly different builds, so its compatibility is its own contract.
TRACECTX_SCHEMA = "TRACECTX.v1"

#: The string-header spelling's field separator; ids are generated by
#: :meth:`Tracer.new_id` (``prefix-N``) and never contain it.
_CTX_SEP = ";"


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The minimal cross-process span identity: which trace a remote
    hop belongs to, and which span is its parent. A receiving process
    emits its spans as ``tracer.span(name, ctx.trace_id,
    parent_id=ctx.parent_id)`` — one request, one trace id, spans on
    both sides of the boundary, exactly the "one span per request
    across the DCN hop" contract direction 1 lands on."""

    trace_id: str
    parent_id: str | None = None


def inject_context(trace_id: str, span_id: str | None = None) -> dict:
    """Serialize a span identity for a process boundary: a flat
    JSON-safe dict (``{"schema", "trace_id", "parent_id"}``). The
    CURRENT span's id becomes the remote side's ``parent_id`` — the
    remote spans hang under the local dispatch span."""
    if not trace_id or not isinstance(trace_id, str):
        raise ValueError(f"trace_id must be a non-empty string, got "
                         f"{trace_id!r}")
    for v in (trace_id, span_id):
        if v is not None and _CTX_SEP in v:
            raise ValueError(
                f"id {v!r} contains the carrier separator "
                f"{_CTX_SEP!r} — not a Tracer.new_id-shaped id")
    return {"schema": TRACECTX_SCHEMA, "trace_id": trace_id,
            "parent_id": span_id}


def format_context(carrier: dict) -> str:
    """The one-line header spelling of an injected carrier
    (``TRACECTX.v1;trace_id;parent_id``) for transports that carry
    strings, not dicts. Empty parent serializes as an empty field."""
    if carrier.get("schema") != TRACECTX_SCHEMA:
        raise ValueError(f"not a {TRACECTX_SCHEMA} carrier: "
                         f"{carrier!r}")
    return _CTX_SEP.join((TRACECTX_SCHEMA, carrier["trace_id"],
                          carrier.get("parent_id") or ""))


def extract_context(carrier) -> SpanContext:
    """Inverse of :func:`inject_context` / :func:`format_context`:
    accepts the dict or the string-header spelling, returns a
    :class:`SpanContext`. Malformed carriers raise ``ValueError``
    naming what is wrong — a dropped trace context on a cross-process
    hop must be a loud bug, not a silently-orphaned span tree."""
    if isinstance(carrier, str):
        parts = carrier.split(_CTX_SEP)
        if len(parts) != 3 or parts[0] != TRACECTX_SCHEMA:
            raise ValueError(
                f"malformed trace-context header {carrier!r} "
                f"(expected '{TRACECTX_SCHEMA};trace_id;parent_id')")
        _, trace_id, parent = parts
    elif isinstance(carrier, dict):
        if carrier.get("schema") != TRACECTX_SCHEMA:
            raise ValueError(
                f"carrier schema {carrier.get('schema')!r} is not "
                f"{TRACECTX_SCHEMA}")
        trace_id = carrier.get("trace_id")
        parent = carrier.get("parent_id")
    else:
        raise ValueError(
            f"carrier must be a dict or header string, got "
            f"{type(carrier).__name__}")
    if not trace_id:
        raise ValueError(f"carrier {carrier!r} has no trace_id")
    return SpanContext(trace_id=trace_id, parent_id=parent or None)


#: The shared disabled tracer: emit/annotate are immediate returns and
#: span() is the no-op singleton. Module-level so hot paths can default
#: to it without constructing anything.
NULL_TRACER = Tracer(enabled=False)

_global_tracer: Tracer = NULL_TRACER
_global_lock = threading.Lock()


def configure(enabled: bool = True, max_spans: int = 1_000_000,
              stream_dir: str | None = None,
              rotate_spans: int = 50_000) -> Tracer:
    """Install (and return) the process-global tracer — how ``exp.py
    --trace_dir`` turns on per-round training spans without threading a
    tracer through every algorithm signature. ``configure(False)``
    restores the free :data:`NULL_TRACER`. ``stream_dir`` makes the
    tracer stream spans to a :class:`RotatingJsonlWriter` there (the
    long-lived-loop mode: O(1) trace memory; ``rotate_spans`` bounds
    each part file)."""
    global _global_tracer
    with _global_lock:
        # build the incoming tracer FIRST: if its writer cannot open
        # (unwritable stream_dir), the old tracer must stay fully
        # functional — closing it before a failed swap would leave a
        # process-wide tracer that raises on every emit
        if not enabled:
            new = NULL_TRACER
        else:
            writer = (RotatingJsonlWriter(stream_dir, rotate_spans)
                      if stream_dir else None)
            new = Tracer(enabled=True, max_spans=max_spans,
                         writer=writer)
        old, _global_tracer = _global_tracer, new
        if old.writer is not None:
            # the outgoing streaming tracer's part file would stay
            # open forever otherwise — one leaked fd per reconfigure
            old.writer.close()
        return _global_tracer


def get_tracer() -> Tracer:
    """The process-global tracer (:data:`NULL_TRACER` until
    :func:`configure`); emitters must treat it as possibly disabled."""
    return _global_tracer
