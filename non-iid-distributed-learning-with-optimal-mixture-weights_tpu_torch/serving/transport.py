"""Dispatch transports: the process-boundary seam of the serving plane.

A copy of the JAX package's ``serving/transport.py`` (stdlib and numpy;
its names, signatures, exception types, messages and wire format: the
same arrays make the same frame bytes and the same
:func:`weights_fingerprint` in both packages). The frame layer works on
numpy bytes on the host; a tensor crosses to numpy at the engine
boundary (the worker's ``sync`` reply, the client's ``swap`` announce),
never inside the frame code. ``worker_main`` takes one more argument,
``device``, the device its engine serves from (the card when None).

``FailoverRouter`` dispatches by direct call within one process. This
module extracts that call into a typed :class:`DispatchTransport`
interface and adds a second implementation that crosses a real process
boundary over a real wire, so "replica" can become "host" with the
router, the chaos plane, and the whole control stack unchanged:

- :class:`InProcessTransport` — the extracted direct-call path.
  ``dispatch`` is ``engine.predict`` verbatim; a :class:`~serving.
  replica.Replica` built without an explicit transport gets one, so
  every pre-existing replica/chaos/control/rollout behavior is
  byte-identical.
- :class:`SocketTransport` — a stdlib-TCP client speaking the
  length-prefixed frame protocol below to a :class:`PodWorker`
  process. Each dispatch carries the batch, the model version pin,
  the REMAINING deadline budget (connect/read timeouts are derived
  from it — a request whose caller gave up must not hold a socket
  open), and a ``TRACECTX.v1`` header (``utils.trace.inject_context``
  finally gets its consumer: the worker's spans join the router-side
  request trace, one request still landing exactly one ``"request"``
  span). Connection loss triggers reconnect-with-backoff: a failed
  connect opens a fast-fail window that doubles up to a cap, so a
  dead worker costs the failover walk microseconds, not a connect
  timeout per dispatch.
- :class:`PodWorker` — the server side: a worker process hosting an
  engine (an exported ladder, ``ServingEngine.from_artifact`` —
  ``compile_count`` 0),
  serving dispatch frames, answering ``hello``/``stats`` metadata
  queries, and accepting the ``swap`` version-announce control frame
  so a mid-stream ``swap_weights`` propagates to every pod worker
  under ONE agreed version number (the cross-process half of the
  registry).
- :class:`PodClientEngine` — the engine-interface facade the router
  and service see over a worker pod: metadata from the worker
  handshake, a ``pop_timings`` slot the socket transports stamp (so
  spans carry the version the WIRE reported), and the broadcasting
  ``swap_weights``.

**Failure taxonomy.** Transport failures classify into the existing
serving taxonomy — nothing downstream grows a socket-aware special
case:

========================  ============================================
wire failure              classified as
========================  ============================================
connect refused / reset   :class:`TransportRefused` (transient
                          ``ConnectionError``): the router's circuit
                          breaker counts it and the failover walk
                          requeues the in-flight batch — exactly the
                          ``ReplicaUnavailable`` path
read timeout / partition  :class:`TransportTimeout` (transient): same
                          requeue; the connection is dropped (a
                          half-open socket must not poison the next
                          dispatch)
budget exhausted          :class:`TransportTimeout` BEFORE any I/O —
                          the deadline contract crosses the hop
malformed frame           :class:`FrameError` (``ValueError``):
                          PERMANENT and loud — truncated, oversized,
                          or garbage frames are protocol bugs, and
                          the service's transient classifier
                          deliberately refuses to retry ValueErrors
========================  ============================================

When every survivor fails a pass the router still raises its own
transient ``ReplicaUnavailable`` / terminal ``NoReplicasAvailable`` —
the failover-and-autoscale machinery works across processes
without modification.

**Frame protocol** (version :data:`FRAME_SCHEMA`)::

    +------+------------+-------------+----------------+---------+
    | b"FW1" magic (4)  | !I hdr_len  | !I payload_len | header  |
    | + version byte    |             |                | JSON    |
    +------+------------+-------------+----------------+---------+
    | payload bytes (raw little-endian array / npz weights)      |
    +------------------------------------------------------------+

Header kinds: ``dispatch`` (rows/cols/dtype/version/budget_s/trace)
-> ``result`` (rows/cols/dtype/version/worker) or ``error``
(message + transient flag); ``hello``/``stats`` -> ``meta``;
``swap`` (version + npz payload) -> ``ok``. Both sides bound frames
at ``max_frame_bytes`` and reject violations loudly.

**Network chaos.** A seeded :class:`~serving.chaos.NetChaosPlan`
(grammar ``partition=/refuse=/lag=RATE[:MS]/kill_host=H@K`` — same
same-seed-bitwise-same-schedule contract as ``ChaosSpec``/``LoadSpec``)
injects at THIS layer, per ``(host, dispatch)`` cell: refuse fails the
connect, partition hangs then times out exactly like a blackholed
route, lag stretches the hop, and a scripted kill SIGKILLs the worker
process through the ``kill_cb`` hook — real failure modes on the real
wire, where the in-process ``ChaosFault`` plane could only pantomime
them.
"""

from __future__ import annotations

import abc
import hashlib
import io
import json
import os
import socket
import struct
import threading
import time

import numpy as np

from ..utils.trace import extract_context, format_context, get_tracer
from .chaos import (NET_LAG, NET_PARTITION, NET_REFUSE,
                    resolve_net_chaos)

#: Frame-protocol version tag (rides every header; bumped on
#: incompatible changes — the two sides of the wire may be different
#: builds, so compatibility is checked per frame, loudly).
FRAME_SCHEMA = "PODFRAME.v1"

#: Wire magic: 3 protocol bytes + the protocol generation. A frame not
#: opening with this is garbage (a stray client, a port collision) and
#: must fail loudly, never be length-interpreted.
FRAME_MAGIC = b"FW1\x01"

#: ``(magic, header_len, payload_len)`` prefix.
_PREFIX = struct.Struct("!4sII")

#: Default per-frame bound. A 4096-row float32 batch at width 1024 is
#: ~16 MiB; 64 MiB leaves headroom for weight announces while keeping
#: a corrupt length prefix from allocating gigabytes.
MAX_FRAME_BYTES = 64 * 1024 * 1024


class TransportError(ConnectionError):
    """A TRANSIENT wire failure (reset, refused, timeout, EOF
    mid-frame). A ``ConnectionError`` on purpose: the service's
    transient classifier and the router's circuit breaker treat it
    exactly like the in-process ``ChaosFault``/``ReplicaUnavailable``
    failures it stands in for — the requeue/retry machinery needs no
    socket-aware special case."""


class TransportRefused(TransportError):
    """Connect refused / connection reset — the worker is not
    answering RIGHT NOW (dead, restarting, or chaos-refused). Feeds
    the circuit breaker; the failover walk moves to a survivor."""


class TransportTimeout(TransportError):
    """The dispatch outlived its bounded timeout (a partitioned route,
    a wedged worker) or its deadline budget was exhausted before any
    I/O. The connection is dropped — a half-open exchange must never
    leak a stale response into the NEXT dispatch's read."""


class SyncTimeout(TransportTimeout):
    """A rejoin ``sync`` peer accepted the connection but never
    answered within its bounded budget — the wedged (dead-but-
    accepting) peer. Typed so the resync loop can COUNT it and move to
    the next peer instead of letting one wedged process stall a
    rejoining worker's pre-serve handshake indefinitely (the rejoin
    path must come up in bounded time whatever one peer does)."""


class FrameError(ValueError):
    """A malformed frame: bad magic, truncated prefix/body, a length
    past ``max_frame_bytes``, or an undecodable header. PERMANENT and
    loud (``ValueError`` — the service's transient classifier refuses
    to retry it): a protocol violation is a bug, and retrying the same
    bytes can only fail the same way, slower."""


# ---------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise: a clean EOF before the first
    byte is a :class:`TransportError` (the peer closed between frames
    — ordinary worker death), EOF mid-``what`` is a :class:`FrameError`
    (a TRUNCATED frame — the protocol violation the tests pin)."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except socket.timeout as e:
            raise TransportTimeout(
                f"timed out reading {what} ({got}/{n} bytes)") from e
        except OSError as e:
            raise TransportError(
                f"connection lost reading {what}: {e}") from e
        if not chunk:
            if got == 0 and what == "frame prefix":
                raise TransportError(
                    "peer closed the connection (EOF at frame "
                    "boundary)")
            raise FrameError(
                f"truncated frame: EOF after {got}/{n} bytes of {what}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def write_frame(sock: socket.socket, header: dict,
                payload: bytes = b"",
                max_frame_bytes: int = MAX_FRAME_BYTES) -> None:
    """Serialize one frame onto ``sock``. The sender enforces the same
    bound the receiver does — an oversized batch must fail HERE, in
    the caller's stack, not as a peer-side rejection."""
    hdr = json.dumps({"schema": FRAME_SCHEMA, **header}).encode()
    if len(hdr) + len(payload) > max_frame_bytes:
        raise FrameError(
            f"frame of {len(hdr) + len(payload)} bytes exceeds the "
            f"{max_frame_bytes}-byte bound")
    try:
        sock.sendall(_PREFIX.pack(FRAME_MAGIC, len(hdr), len(payload))
                     + hdr + payload)
    except socket.timeout as e:
        raise TransportTimeout(f"timed out sending frame: {e}") from e
    except OSError as e:
        raise TransportError(f"connection lost sending frame: {e}") \
            from e


def read_frame(sock: socket.socket,
               max_frame_bytes: int = MAX_FRAME_BYTES) -> tuple:
    """Read one ``(header, payload)`` frame. Violations are loud and
    typed (:class:`FrameError`): bad magic, a length past the bound,
    truncation, or an undecodable header — never silently skipped,
    never length-interpreted garbage."""
    prefix = _recv_exact(sock, _PREFIX.size, "frame prefix")
    magic, hdr_len, pay_len = _PREFIX.unpack(prefix)
    if magic != FRAME_MAGIC:
        raise FrameError(
            f"bad frame magic {magic!r} (expected {FRAME_MAGIC!r}) — "
            "not a pod frame stream")
    if hdr_len + pay_len > max_frame_bytes:
        raise FrameError(
            f"frame of {hdr_len + pay_len} bytes exceeds the "
            f"{max_frame_bytes}-byte bound")
    hdr_bytes = _recv_exact(sock, hdr_len, "frame header")
    payload = _recv_exact(sock, pay_len, "frame payload") if pay_len \
        else b""
    try:
        header = json.loads(hdr_bytes)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"undecodable frame header: {e}") from None
    if not isinstance(header, dict) \
            or header.get("schema") != FRAME_SCHEMA:
        raise FrameError(
            f"frame header schema {header.get('schema') if isinstance(header, dict) else header!r} "
            f"is not {FRAME_SCHEMA!r}")
    return header, payload


def pack_batch(X: np.ndarray) -> tuple[dict, bytes]:
    """``(header fields, payload)`` of one dispatch batch: raw
    C-contiguous bytes plus the shape/dtype the receiver needs to
    reconstruct it exactly."""
    X = np.ascontiguousarray(X)
    return ({"rows": int(X.shape[0]), "cols": int(X.shape[1]),
             "dtype": str(X.dtype)}, X.tobytes())


def unpack_batch(header: dict, payload: bytes) -> np.ndarray:
    """Inverse of :func:`pack_batch`; size disagreements between the
    header and the payload are a loud :class:`FrameError`."""
    try:
        rows, cols = int(header["rows"]), int(header["cols"])
        dtype = np.dtype(str(header["dtype"]))
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"malformed batch header: {e}") from None
    want = rows * cols * dtype.itemsize
    if want != len(payload):
        raise FrameError(
            f"batch payload of {len(payload)} bytes disagrees with "
            f"header ({rows}x{cols} {dtype} = {want} bytes)")
    return np.frombuffer(payload, dtype=dtype).reshape(rows, cols)


def _host_array(v) -> np.ndarray:
    """One weight leaf as a host numpy array: a torch tensor (on any
    device) is copied to the host, anything else goes through
    ``np.asarray``."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _host_weights(params: dict, rff=None) -> tuple:
    """The engine boundary: ``(params, rff)`` as host numpy arrays, so
    the frame layer below sees numpy bytes only."""
    params = {k: _host_array(v) for k, v in params.items()}
    if rff is not None:
        rff = (_host_array(rff[0]), _host_array(rff[1]))
    return params, rff


def pack_weights(params: dict, rff=None) -> bytes:
    """Serialize a weight set for the ``swap`` version-announce frame:
    one npz blob, params under ``p:<key>``, the RFF pair (when fused)
    under ``r:W``/``r:b``."""
    arrays = {f"p:{k}": np.asarray(v) for k, v in params.items()}
    if rff is not None:
        arrays["r:W"] = np.asarray(rff[0])
        arrays["r:b"] = np.asarray(rff[1])
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_weights(blob: bytes) -> tuple:
    """Inverse of :func:`pack_weights`: ``(params, rff_or_None)``."""
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            params = {k[2:]: z[k] for k in z.files
                      if k.startswith("p:")}
            rff = ((z["r:W"], z["r:b"])
                   if "r:W" in z.files and "r:b" in z.files else None)
    except Exception as e:
        raise FrameError(f"undecodable weight payload: {e}") from None
    if not params:
        raise FrameError("weight payload carries no parameters")
    return params, rff


def weights_fingerprint(params: dict, rff=None,
                        version: int = 0) -> str:
    """Content fingerprint of one weight set under one version, the
    sync/announce-frame analogue of the artifact
    ``host_fingerprint``: sha256 over the version number plus every
    array's name, dtype, shape, and raw bytes, in sorted name order.

    Computed over CONTENT, never over the npz blob — ``np.savez``
    embeds zip member timestamps, so byte-hashing the blob would make
    the same weights fingerprint differently across packings. Two
    workers serving the same weights under the same version agree on
    this string whatever process packed the frame; a byzantine peer
    serving forged weights under a stolen version cannot match an
    honest quorum's fingerprint without the honest bytes."""
    h = hashlib.sha256()
    h.update(f"v{int(version)}".encode())
    arrays = {f"p:{k}": np.asarray(v) for k, v in params.items()}
    if rff is not None:
        arrays["r:W"] = np.asarray(rff[0])
        arrays["r:b"] = np.asarray(rff[1])
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"|{name}:{a.dtype.str}:{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------
# the transport interface
# ---------------------------------------------------------------------

class DispatchTransport(abc.ABC):
    """One replica's dispatch boundary, as the router sees it:
    ``dispatch(X, version=, deadline=, trace_ctx=, record_timings=)``
    returns the logits or raises into the serving failure taxonomy
    (transient ``ConnectionError`` family -> circuit breaker +
    requeue; ``ValueError`` family -> permanent, fail fast). The
    deadline is an absolute ``perf_counter`` time — implementations
    derive their timeouts from what REMAINS of it. An abstract base
    here (the JAX package's raises at call time): a transport without
    ``dispatch`` cannot be built."""

    @abc.abstractmethod
    def dispatch(self, X, version: int | None = None,
                 deadline: float | None = None, trace_ctx=None,
                 record_timings: bool = True):
        """The logits of ``X`` (see the class docstring)."""

    def close(self) -> None:
        """Release any held connection (idempotent)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class InProcessTransport(DispatchTransport):
    """The extracted direct-call path: exactly the ``engine.predict``
    invocation ``FailoverRouter`` made before this seam existed —
    byte-identical behavior, which is what lets every pre-existing
    replica/chaos/control/rollout test pass unchanged. ``deadline``
    and ``trace_ctx`` are accepted and unused: an in-process call
    cannot be usefully bounded mid-dispatch, and its spans already
    share the caller's process-local tracer."""

    def __init__(self, engine):
        self.engine = engine

    def dispatch(self, X, version: int | None = None,
                 deadline: float | None = None, trace_ctx=None,
                 record_timings: bool = True):
        return self.engine.predict(X, version=version,
                                   record_timings=record_timings)


class SocketTransport(DispatchTransport):
    """TCP dispatch to one :class:`PodWorker` (module docstring).

    ``client`` (a :class:`PodClientEngine`, optional): the shared
    facade whose single-consumer ``pop_timings`` slot a timed dispatch
    stamps — how the wire-reported model version reaches request
    spans. ``chaos``/``host_index``/``kill_cb``: the seeded network
    fault plane (``serving.chaos.NetChaosPlan`` or spec string),
    consulted once per dispatch at THIS host's row; a scripted kill
    invokes ``kill_cb(host_index)`` (``chip_smoke.py`` passes a
    SIGKILL) and then dispatches into the dying worker — the real
    mid-batch death.

    Reconnect-with-backoff: a failed connect opens a fast-fail window
    (``backoff_ms`` doubling to ``backoff_cap_ms``) during which
    dispatches raise :class:`TransportRefused` immediately instead of
    paying a connect timeout each — the failover walk stays fast while
    a worker is down, and one successful connect resets the window.
    """

    def __init__(self, address, client=None, host_index: int = 0,
                 chaos=None, kill_cb=None,
                 connect_timeout_s: float = 1.0,
                 io_timeout_s: float = 10.0,
                 backoff_ms: float = 25.0,
                 backoff_cap_ms: float = 1000.0,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 n_hosts: int | None = None):
        host, port = address
        self.address = (str(host), int(port))
        self.client = client
        self.host_index = int(host_index)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.backoff_s = backoff_ms / 1e3
        self.backoff_cap_s = backoff_cap_ms / 1e3
        self.max_frame_bytes = int(max_frame_bytes)
        self._plan = resolve_net_chaos(
            chaos, (self.host_index + 1 if n_hosts is None
                    else int(n_hosts)))
        self._kill_cb = kill_cb
        self._kills_fired: set[int] = set()
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()        # counters / backoff state
        self._io_lock = threading.Lock()     # one exchange per socket
        self._dispatches = 0
        self._connect_failures = 0
        self._connected_once = False
        self._next_attempt = 0.0
        self.reconnects = 0
        self.faults_injected = {"partition": 0, "refuse": 0, "lag": 0,
                                "kill": 0}

    # -- stats ---------------------------------------------------------
    @property
    def dispatches(self) -> int:
        with self._lock:
            return self._dispatches

    def stats(self) -> dict:
        with self._lock:
            return {"address": list(self.address),
                    "dispatches": self._dispatches,
                    "reconnects": self.reconnects,
                    "connect_failures": self._connect_failures,
                    "faults_injected": dict(self.faults_injected)}

    # -- connection management ----------------------------------------
    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass  # already torn down; the drop is what matters
            self._sock = None

    def close(self) -> None:
        with self._io_lock:
            self._drop_locked()

    def _ensure_conn(self, timeout_s: float) -> socket.socket:
        """The held connection, or a fresh one — fast-failing inside
        the reconnect-backoff window so a dead worker costs the
        failover walk microseconds per pass."""
        if self._sock is not None:
            return self._sock
        now = time.perf_counter()
        with self._lock:
            if now < self._next_attempt:
                raise TransportRefused(
                    f"worker {self.address} in reconnect backoff "
                    f"({self._next_attempt - now:.3f}s left)")
        try:
            sock = socket.create_connection(
                self.address, timeout=min(timeout_s,
                                          self.connect_timeout_s))
        except OSError as e:
            with self._lock:
                self._connect_failures += 1
                delay = min(self.backoff_cap_s, self.backoff_s
                            * (2 ** min(self._connect_failures - 1, 8)))
                self._next_attempt = time.perf_counter() + delay
            raise TransportRefused(
                f"connect to worker {self.address} failed: {e}") from e
        with self._lock:
            self._connect_failures = 0
            self._next_attempt = 0.0
            if self._connected_once:
                # only a connect AFTER a drop is a reconnect — the
                # first lazy connect must not inflate the recovery
                # evidence a pod run records
                self.reconnects += 1
            self._connected_once = True
        self._sock = sock
        return sock

    # -- chaos ---------------------------------------------------------
    def _inject(self, k: int, budget_s: float | None) -> None:
        """Consult the network-chaos plan for dispatch ``k`` — BEFORE
        any I/O, where a real route failure would land."""
        plan = self._plan
        if plan is None:
            return
        if self._kill_cb is not None:
            kill_at = plan.kill_at(self.host_index)
            with self._lock:
                # check-and-mark atomically: a concurrent dispatch
                # (the off-thread probe) must not double-fire the kill
                fire = (kill_at is not None and k >= kill_at
                        and kill_at not in self._kills_fired)
                if fire:
                    self._kills_fired.add(kill_at)
                    self.faults_injected["kill"] += 1
            if fire:
                # SIGKILL the worker, then dispatch into the corpse:
                # the send/read below fails with reset/EOF — the real
                # mid-batch worker death, not a simulated one
                self._kill_cb(self.host_index)
        role = plan.role(self.host_index, k)
        if role == NET_REFUSE:
            with self._lock:
                self.faults_injected["refuse"] += 1
            with self._io_lock:
                self._drop_locked()
            raise TransportRefused(
                f"net-chaos refused connect to worker {self.address} "
                f"(dispatch {k})")
        if role == NET_PARTITION:
            with self._lock:
                self.faults_injected["partition"] += 1
            with self._io_lock:
                # a partitioned route wedges the established
                # connection too: drop it so the next dispatch
                # reconnects instead of reading a dead socket
                self._drop_locked()
            stall = plan.partition_s if budget_s is None \
                else min(plan.partition_s, budget_s)
            time.sleep(max(0.0, stall))
            raise TransportTimeout(
                f"net-chaos partition: worker {self.address} "
                f"unreachable for {stall:.3f}s (dispatch {k})")
        if role == NET_LAG:
            with self._lock:
                self.faults_injected["lag"] += 1
            time.sleep(plan.lag_s)

    # -- dispatch ------------------------------------------------------
    def dispatch(self, X, version: int | None = None,
                 deadline: float | None = None, trace_ctx=None,
                 record_timings: bool = True):
        with self._lock:
            k = self._dispatches
            self._dispatches += 1
        budget = (None if deadline is None
                  else deadline - time.perf_counter())
        self._inject(k, budget)
        if deadline is not None:
            # re-read AFTER injection: a lag stall spends real budget,
            # and a stale pre-stall read would let work whose caller
            # already gave up cross the wire with a positive-looking
            # budget_s header
            budget = deadline - time.perf_counter()
        if budget is not None and budget <= 0:
            # the deadline contract crosses the hop: a request whose
            # caller already gave up must not spend wire time
            raise TransportTimeout(
                "deadline budget exhausted before dispatch")
        timeout = self.io_timeout_s if budget is None \
            else max(1e-3, min(self.io_timeout_s, budget))
        X = np.asarray(X, np.float32)
        single = X.ndim == 1
        if single:
            # same row/batch duality as engine.predict: a (d,) row
            # crosses the wire as (1, d) and comes back as a row
            X = X[None, :]
        hdr, payload = pack_batch(X)
        hdr.update(kind="dispatch", version=version, budget_s=budget)
        if trace_ctx is not None:
            hdr["trace"] = (trace_ctx if isinstance(trace_ctx, str)
                            else format_context(trace_ctx))
        t0 = time.perf_counter()
        # the exchange region holds the I/O lock across the socket
        # round-trip BY DESIGN: one in-flight exchange per connection
        # IS the frame protocol (a second thread's interleaved frames
        # would corrupt both exchanges); contention is the off-thread
        # shadow probe only, and the socket timeout bounds the hold
        self._io_lock.acquire()
        try:
            sock = self._ensure_conn(timeout)
            try:
                sock.settimeout(timeout)
                write_frame(sock, hdr, payload, self.max_frame_bytes)
                resp, body = read_frame(sock, self.max_frame_bytes)
            except (TransportError, FrameError):
                # either way the exchange is dead: a half-open socket
                # (request sent, response unread) must never leak a
                # stale response into the next dispatch's read
                self._drop_locked()
                raise
        finally:
            self._io_lock.release()
        if resp.get("kind") == "error":
            msg = f"worker {self.address}: {resp.get('error')}"
            if resp.get("transient", True):
                raise TransportError(msg)
            raise RuntimeError(msg)
        if resp.get("kind") != "result":
            raise FrameError(
                f"unexpected response kind {resp.get('kind')!r} to a "
                "dispatch frame")
        out = unpack_batch(resp, body)
        if resp.get("ndim") == 1:
            # the worker's engine answered 1-D: restore the rank the
            # wire's (rows, cols) framing flattened into a column
            out = out.reshape(-1)
        if single:
            out = out[0]
        if record_timings and self.client is not None:
            # the wire-reported version (what the WORKER served), not
            # a client-side guess — post-swap spans must not lie
            self.client._timings = {
                "pad_s": 0.0,
                "dispatch_s": time.perf_counter() - t0,
                "bucket": int(resp.get("bucket", 0)),
                "version": resp.get("version"),
            }
        return out


# ---------------------------------------------------------------------
# the engine facade over a pod
# ---------------------------------------------------------------------

class PodClientEngine:
    """The engine interface the router/service see over a worker pod:
    static metadata (buckets/input_dim/num_classes) from the worker
    handshake, a single-consumer ``pop_timings`` slot the socket
    transports stamp, ``compile_count`` structurally zero (the client
    dispatches no shape — each worker's count is its own, read via
    ``stats`` frames), and a broadcasting
    ``swap_weights`` (the version-announce control frame): one agreed
    version number announced to every endpoint, so the pod swaps in
    agreement instead of each worker auto-numbering its own."""

    def __init__(self, endpoints, connect_timeout_s: float = 5.0,
                 max_frame_bytes: int = MAX_FRAME_BYTES):
        self.endpoints = [(str(h), int(p)) for h, p in endpoints]
        if not self.endpoints:
            raise ValueError("PodClientEngine needs >= 1 endpoint")
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_frame_bytes = int(max_frame_bytes)
        self._timings: dict | None = None
        self.last_announce: dict | None = None
        #: optional per-endpoint announce observer, called as
        #: ``on_announce(endpoint, ok)`` after EACH announce attempt
        #: (inside the swap critical section). The scenario oracle
        #: uses it to script the mid-announce rejoin race — a worker
        #: restarting between two attempts of ONE announce.
        self.on_announce = None
        errs = []
        meta = None
        for ep in self.endpoints:
            try:
                meta, _ = self.control(ep, {"kind": "hello"})
                break
            except (TransportError, FrameError, OSError) as e:
                errs.append(f"{ep}: {e}")
        if meta is None:
            raise TransportRefused(
                "no pod worker answered the hello handshake: "
                + "; ".join(errs))
        self.buckets = tuple(int(b) for b in meta["buckets"])
        self.input_dim = int(meta["input_dim"])
        self.num_classes = int(meta["num_classes"])
        self._version = int(meta["version"])
        # announce epoch fence: a fresh client joins at the
        # pod's last-seen epoch so its first announce outranks every
        # announce the pod already heard; absent in a pre-epoch
        # worker's hello -> 0, byte-compatible both ways
        self._epoch = int(meta.get("epoch", 0))
        self._vlock = threading.Lock()
        # serializes whole announces (pick -> broadcast -> commit):
        # two concurrent swaps racing into one version number would
        # hand different weight sets the same identity — the exact
        # divergence the announce frame exists to prevent
        self._swap_lock = threading.Lock()

    # -- engine-interface surface -------------------------------------
    @property
    def version(self) -> int:
        with self._vlock:
            return self._version

    @property
    def compile_count(self) -> int:
        return 0  # the client dispatches no shape; workers report theirs

    def warmup(self) -> int:
        """Workers warmed themselves (artifact-loaded: warmed at
        load). The client has no ladder to warm."""
        return 0

    def pop_timings(self) -> dict | None:
        t, self._timings = self._timings, None
        return t

    def predict(self, X, version=None, record_timings=True):
        """Deliberately unroutable: dispatch goes through the
        replicas' transports (the router fronts this facade). A direct
        call reaching here is a wiring bug worth failing loudly."""
        raise TypeError(
            "PodClientEngine does not dispatch; route through a "
            "FailoverRouter over SocketTransport replicas")

    # -- control frames ------------------------------------------------
    def control(self, endpoint, header: dict,
                payload: bytes = b"") -> tuple:
        """One short-lived control exchange (hello/stats/swap/stop) on
        its OWN connection — control must never interleave with an
        in-flight dispatch exchange on a transport's socket."""
        with socket.create_connection(
                endpoint, timeout=self.connect_timeout_s) as sock:
            sock.settimeout(self.connect_timeout_s)
            write_frame(sock, header, payload, self.max_frame_bytes)
            return read_frame(sock, self.max_frame_bytes)

    def worker_stats(self) -> list:
        """Per-endpoint ``stats`` metadata for the workers that
        answer; unreachable workers report ``{"dead": True}`` — the
        caller reads survivor ``compile_count`` through this."""
        out = []
        for ep in self.endpoints:
            try:
                meta, _ = self.control(ep, {"kind": "stats"})
                out.append(meta)
            except (TransportError, FrameError, OSError) as e:
                out.append({"endpoint": list(ep), "dead": True,
                            "error": str(e)})
        return out

    def swap_weights(self, params=None, rff=None,
                     version: int | None = None) -> int:
        """The version-announce broadcast: pick ONE new version number
        (explicit, or announced-live + 1), pack the weights once, and
        announce to every endpoint. Returns the agreed version once at
        least one worker acked; dead workers are skipped (their
        circuits are open anyway — a worker that rejoins catches up
        itself via the ``sync`` handshake: ``PodWorker(peers=...)``
        re-requests the agreed version from the pod on start, closing
        the announce gap without operator re-feeding).
        Raises :class:`TransportError` when NO worker
        acked — an announce nobody heard must not bump the client's
        notion of live.

        Hardening, byte-compatible on clean paths: the
        announce header carries a MONOTONIC EPOCH (one per announce,
        fenced worker-side — a replayed or out-of-order announce is
        refused loudly) and the :func:`weights_fingerprint` of the
        announced content (a worker verifies the unpacked bytes match
        before installing). After a first pass with at least one ack,
        failed endpoints get ONE straggler re-pass: a worker that
        restarted mid-announce (the ``restart_during_announce`` race)
        is back by then and either installs the version or refuses it
        as stale because its rejoin sync already delivered it —
        either way the pod converges on one version without waiting
        for the next announce."""
        if params is None:
            raise ValueError(
                "pod swap_weights needs params (flip-only version= "
                "swaps need the cross-process registry, not yet here)")
        params, rff = _host_weights(params, rff)
        # the WHOLE announce is one critical section — version pick,
        # broadcast, commit. Released piecemeal, two concurrent swaps
        # would both pick live+1 and interleave their broadcasts:
        # each worker accepts whichever arrives first and rejects the
        # other, so the pod serves DIFFERENT weights under one agreed
        # number. Holding a lock across the socket round-trips is the
        # invariant, not an accident (as artifacts._EXPORT_LOCK
        # serializes exports): swaps are operator-cadence rare and never the
        # dispatch path — dispatch transports have their own sockets.
        self._swap_lock.acquire()
        try:
            with self._vlock:
                v = (self._version + 1 if version is None
                     else int(version))
            epoch = getattr(self, "_epoch", 0) + 1
            blob = pack_weights(params, rff)
            header = {"kind": "swap", "version": v, "epoch": epoch,
                      "fingerprint": weights_fingerprint(params, rff,
                                                         v)}
            hook = getattr(self, "on_announce", None)
            acks, failed = 0, []
            for ep in self.endpoints:
                ok = False
                try:
                    resp, _ = self.control(ep, header, blob)
                except (TransportError, FrameError, OSError) as e:
                    failed.append((ep, f"{ep}: {e}"))
                else:
                    if resp.get("kind") == "ok":
                        acks += 1
                        ok = True
                    else:
                        failed.append((ep,
                                       f"{ep}: {resp.get('error')}"))
                if hook is not None:
                    hook(ep, ok)
            if not acks:
                raise TransportError(
                    f"version announce v{v} reached no worker: "
                    + "; ".join(msg for _, msg in failed))
            if failed:
                # the straggler re-pass (never when NOBODY acked: a
                # fully dark pod is the caller's error above). One
                # bounded retry per first-pass failure; a still-dead
                # endpoint keeps its original failure entry
                still = []
                for ep, msg in failed:
                    try:
                        resp, _ = self.control(ep, header, blob)
                    except (TransportError, FrameError, OSError):
                        still.append((ep, msg))
                        continue
                    if resp.get("kind") == "ok":
                        acks += 1
                    else:
                        still.append((ep,
                                      f"{ep}: {resp.get('error')}"))
                failed = still
            with self._vlock:
                self._version = v
            self._epoch = epoch
            self.last_announce = {"version": v, "acks": acks,
                                  "failures": [msg for _, msg
                                               in failed]}
            return v
        finally:
            self._swap_lock.release()


# ---------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------

class PodWorker:
    """One serving process of the pod: accepts frame connections and
    serves ``dispatch``/``hello``/``stats``/``swap``/``stop`` frames
    over the engine it hosts (``worker_main`` loads an exported ladder,
    so ``compile_count`` stays 0; tests host stubs). One handler thread per connection — the router holds
    one long-lived dispatch connection per replica, control frames
    arrive on their own short-lived ones.

    With an enabled ``tracer``, every served dispatch lands one
    ``"pod_dispatch"`` span under the TRACECTX the frame carried —
    the worker's side of the one-trace-across-the-hop contract (the
    router-side ``"request"`` span count stays exactly one per
    request; these are its remote children)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 worker_id: int = 0, tracer=None,
                 max_frame_bytes: int = MAX_FRAME_BYTES, peers=None,
                 forge_sync=None):
        """``peers`` (the announce-gap fix): pod endpoints
        this worker re-requests the agreed weight version from on
        :meth:`start`. A worker rejoining after SIGKILL restarts from
        its checkpoint — STALE weights under a stale version — and
        version announces only reach workers alive at announce time,
        so without the handshake the rejoiner serves old weights under
        the pod's name until an operator re-feeds it. With peers set,
        ``start`` syncs BEFORE accepting connections: the worker asks
        each peer (``sync`` frame), installs the newest version found,
        and only then serves.

        ``forge_sync`` (test-only byzantine mode): when set
        to an integer version, this worker answers ``sync`` requests
        with FORGED weights — same-shape garbage drawn from a PRNG
        keyed on the forged version, claimed under that version. The
        scenario fuzzer uses it to model a byzantine sync peer; honest
        deployments never set it."""
        self.engine = engine
        self.worker_id = int(worker_id)
        self.peers = [(str(h), int(p)) for h, p in (peers or [])]
        self.forge_sync = None if forge_sync is None else int(forge_sync)
        self.resyncs = 0
        self.sync_timeouts = 0
        self.stale_refused = 0
        self.forge_rejected = 0
        # the announce fence: highest announce epoch this
        # worker has accepted (or adopted via rejoin sync), and the
        # content fingerprint it installed under it
        self._epoch = 0
        self._last_fingerprint = None
        self.tracer = tracer if tracer is not None else get_tracer()
        self.max_frame_bytes = int(max_frame_bytes)
        # capability check once, like ServingService does: whether the
        # hosted engine's predict takes version=/record_timings= (a
        # test stub may take neither)
        import inspect
        try:
            sig = inspect.signature(engine.predict).parameters
            self._predict_version = "version" in sig
            self._predict_untimed = "record_timings" in sig
        except (TypeError, ValueError):
            self._predict_version = False
            self._predict_untimed = False
        self._listener = socket.create_server((host, int(port)))
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set = set()
        self._lock = threading.Lock()
        self.dispatches = 0
        self.swaps = 0
        self.errors = 0
        self.frame_errors = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "PodWorker":
        if self.peers:
            # sync BEFORE serve: a rejoiner must not answer dispatches
            # with checkpoint-stale weights while the agreed version
            # is one frame away
            self.resync()
        t = threading.Thread(target=self._accept_loop,
                             name=f"pod-worker-{self.worker_id}",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown BEFORE close: on Linux, closing a listening
            # socket does not wake a thread blocked in accept() —
            # shutdown does (the accepter sees EINVAL and exits)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never connected / already down
        try:
            self._listener.close()
        except OSError:
            pass  # listener already down — stop is idempotent
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for conn in conns:
            # wake every handler blocked in read_frame: a stop must
            # not wait out idle keep-alive connections
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closing on its own
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _sync_one(self, ep, timeout_s: float) -> tuple:
        """One peer's ``sync`` exchange on its own short-lived
        connection, bounded by ``timeout_s``. A peer that accepted the
        connection but never answers within the budget — the wedged
        dead-but-accepting process — raises :class:`SyncTimeout` so
        the resync loop can COUNT it and move on instead of stalling
        the rejoiner's pre-serve handshake behind one bad peer."""
        try:
            with socket.create_connection(ep, timeout=timeout_s) as sock:
                sock.settimeout(timeout_s)
                write_frame(sock, {"kind": "sync"})
                return read_frame(sock, self.max_frame_bytes)
        except socket.timeout as e:
            raise SyncTimeout(
                f"sync peer {ep[0]}:{ep[1]} accepted but never "
                f"answered within {timeout_s:.1f}s") from e
        except TransportTimeout as e:
            raise SyncTimeout(
                f"sync peer {ep[0]}:{ep[1]} timed out mid-frame: "
                f"{e}") from e

    def resync(self, timeout_s: float = 5.0) -> int | None:
        """Re-request the pod's agreed weight version from ``peers``.

        Asks every peer (each on its own short-lived connection, the
        control-frame discipline), then installs the NEWEST version
        found when it is newer than what this worker serves — newest,
        not first-answering, because a pod mid-announce has peers on
        two versions and joining the older side would re-open the gap
        one announce later. Unreachable or weightless peers are
        skipped: a lone survivor restarting a dead pod has nobody to
        ask and must still come up.

        ``timeout_s`` is the TOTAL handshake budget, not a per-peer
        one: each peer gets at most the budget's remainder, a wedged
        peer raises (and counts) :class:`SyncTimeout` instead of
        hanging, and a spent budget ends the loop — the rejoiner comes
        up in bounded time whatever its peers do.

        Byzantine hardening, in trust order: a reply
        carrying a ``fingerprint`` that does not hash its own payload
        is dropped outright (a corrupt or lazily-forged peer); then,
        when a strict majority of the fingerprinted replies agree on
        one fingerprint, every disagreeing fingerprinted reply is
        dropped too — a self-consistent forger hashes its own garbage
        correctly, so only quorum unmasks it. Without a strict
        majority (two honest peers mid-announce legitimately disagree)
        nothing is dropped and the newest ``(version, epoch)`` wins as
        before. Legacy replies without fingerprints never enter the
        quorum. Returns the installed version, or None when nothing
        newer was found."""
        my_v = int(getattr(self.engine, "version", 0))
        deadline = time.monotonic() + float(timeout_s)
        replies = []  # (version, epoch, fingerprint|None, payload)
        for ep in self.peers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break  # budget spent: serve with the best found so far
            try:
                resp, payload = self._sync_one(ep, remaining)
            except SyncTimeout:
                with self._lock:
                    self.sync_timeouts += 1
                continue  # wedged peer: ask the next one
            except (TransportError, FrameError, OSError):
                continue  # dead/refusing peer: ask the next one
            if resp.get("kind") != "weights":
                continue  # peer hosts nothing exportable
            v = int(resp.get("version", 0))
            epoch = int(resp.get("epoch", 0))
            fp = resp.get("fingerprint")
            if fp is not None:
                params, rff = unpack_weights(payload)
                if weights_fingerprint(params, rff, v) != str(fp):
                    # the reply disowns its own payload: corrupt wire
                    # or a forger too lazy to re-hash — drop it loudly
                    with self._lock:
                        self.forge_rejected += 1
                    continue
                fp = str(fp)
            replies.append((v, epoch, fp, payload))
        fingerprinted = [r for r in replies if r[2] is not None]
        if fingerprinted:
            tally = {}
            for _, _, fp, _ in fingerprinted:
                tally[fp] = tally.get(fp, 0) + 1
            top_fp = max(tally, key=lambda k: (tally[k], k))
            if tally[top_fp] * 2 > len(fingerprinted):
                # strict majority: the pod agrees on one content hash,
                # so a self-consistent minority reply is a forgery
                # (or hopelessly stale) — reject, count, move on
                rejected = [r for r in fingerprinted if r[2] != top_fp]
                if rejected:
                    with self._lock:
                        self.forge_rejected += len(rejected)
                replies = [r for r in replies
                           if r[2] is None or r[2] == top_fp]
        best = None
        for v, epoch, _, payload in replies:
            if v <= my_v:
                continue
            if best is None or (v, epoch) > (best[0], best[1]):
                best = (v, epoch, payload)
        if best is None:
            return None
        best_v, best_epoch, best_payload = best
        params, rff = unpack_weights(best_payload)
        v = self.engine.swap_weights(params, rff=rff, version=best_v)
        with self._lock:
            self.resyncs += 1
            if best_epoch > self._epoch:
                # adopt the pod's announce epoch: the fence must hold
                # across a rejoin, or the next stale announce would
                # look fresh to this worker
                self._epoch = best_epoch
        return int(v)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._conns.add(conn)
                # prune finished handlers as connections arrive:
                # control frames open one short-lived connection
                # each, and a long-lived worker polled for stats
                # would otherwise grow one dead Thread object per
                # poll, forever. Under the lock: stop() snapshots
                # this list concurrently
                self._threads = [th for th in self._threads
                                 if th.is_alive()]
                self._threads.append(t)
            t.start()

    # -- the serve loop ------------------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        """One connection's request/response loop until EOF. A
        malformed frame answers a loud error frame and DROPS the
        connection (resynchronizing inside a corrupt byte stream is
        guesswork); handler failures answer typed error frames and the
        loop continues — a worker thread must never die silently."""
        try:
            self._serve_conn_loop(conn)
        finally:
            with self._lock:
                self._conns.discard(conn)

    def _serve_conn_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    header, payload = read_frame(conn,
                                                 self.max_frame_bytes)
                except TransportError:
                    return  # peer closed / reset: normal end of stream
                except FrameError as e:
                    with self._lock:
                        self.frame_errors += 1
                    try:
                        write_frame(conn, {
                            "kind": "error", "error": str(e),
                            "transient": False})
                    except (TransportError, FrameError):
                        pass  # peer is gone; the count above stands
                    return
                try:
                    resp, body = self._handle(header, payload)
                except Exception as e:
                    with self._lock:
                        self.errors += 1
                    resp, body = {"kind": "error",
                                  "error": f"{type(e).__name__}: {e}",
                                  "transient": not isinstance(
                                      e, (ValueError, TypeError,
                                          KeyError))}, b""
                try:
                    write_frame(conn, resp, body, self.max_frame_bytes)
                except (TransportError, FrameError):
                    return  # peer gone mid-response; nothing to save
                if header.get("kind") == "stop":
                    self._stop.set()
                    for sock in (self._listener,):
                        try:
                            sock.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass  # never connected
                        try:
                            sock.close()
                        except OSError:
                            pass  # accept loop exits either way
                    return

    def _meta(self) -> dict:
        with self._lock:
            served = self.dispatches
            swaps = self.swaps
            errors = self.errors
            resyncs = self.resyncs
            sync_timeouts = self.sync_timeouts
            stale_refused = self.stale_refused
            forge_rejected = self.forge_rejected
            epoch = self._epoch
        return {
            "kind": "meta", "worker": self.worker_id,
            "epoch": epoch,
            "resyncs": resyncs,
            "sync_timeouts": sync_timeouts,
            "stale_refused": stale_refused,
            "forge_rejected": forge_rejected,
            "buckets": [int(b) for b in self.engine.buckets],
            "input_dim": int(self.engine.input_dim),
            "num_classes": int(self.engine.num_classes),
            "version": int(getattr(self.engine, "version", 0)),
            "compile_count": int(getattr(self.engine,
                                         "compile_count", 0)),
            "dispatches": served, "swaps": swaps, "errors": errors,
            "pid": os.getpid(),
        }

    def _handle(self, header: dict, payload: bytes) -> tuple:
        kind = header.get("kind")
        if kind in ("hello", "stats", "ping"):
            return self._meta(), b""
        if kind == "stop":
            return {"kind": "ok"}, b""
        if kind == "swap":
            return self._handle_swap(header, payload)
        if kind == "sync":
            return self._handle_sync()
        if kind == "dispatch":
            return self._handle_dispatch(header, payload)
        raise FrameError(f"unknown frame kind {kind!r}")

    def _handle_swap(self, header: dict, payload: bytes) -> tuple:
        """The version-announce control frame: install the announced
        weights under the ANNOUNCED version number and make them live
        — every worker of the pod lands on the same number, so
        post-swap dispatches report one agreed ``model_version``
        whichever worker serves them.

        Hardened, optional-field byte-compatible: an
        announce carrying an ``epoch`` at or below the last accepted
        one is REFUSED loudly (a replayed/stale announce installing
        old weights over new is exactly the announce-race corruption;
        the refusal is a permanent typed error, never a silent drop),
        and an announce carrying a ``fingerprint`` is verified against
        the unpacked content before anything installs. Frames from a
        pre-epoch client carry neither field and behave as before."""
        version = header.get("version")
        if not isinstance(version, int):
            raise FrameError(
                f"swap frame needs an integer version, got {version!r}")
        epoch = header.get("epoch")
        if epoch is not None:
            epoch = int(epoch)
            with self._lock:
                stale = epoch <= self._epoch
                if stale:
                    self.stale_refused += 1
                    last = self._epoch
            if stale:
                return {"kind": "error", "transient": False,
                        "error": f"stale announce epoch {epoch} "
                                 f"refused: worker {self.worker_id} "
                                 f"already accepted epoch {last} — "
                                 "re-announce from the live client"
                        }, b""
        params, rff = unpack_weights(payload)
        claimed = header.get("fingerprint")
        if claimed is not None:
            actual = weights_fingerprint(params, rff, version)
            if actual != str(claimed):
                with self._lock:
                    self.forge_rejected += 1
                return {"kind": "error", "transient": False,
                        "error": f"announce v{version} fingerprint "
                                 f"mismatch: header claims "
                                 f"{str(claimed)[:12]}.., payload "
                                 f"hashes {actual[:12]}.. — refusing "
                                 "to install unverifiable weights"
                        }, b""
        v = self.engine.swap_weights(params, rff=rff, version=version)
        with self._lock:
            self.swaps += 1
            if epoch is not None:
                self._epoch = epoch
            if claimed is not None:
                self._last_fingerprint = str(claimed)
        return {"kind": "ok", "version": int(v),
                "worker": self.worker_id}, b""

    def _handle_sync(self) -> tuple:
        """A rejoining peer's weight request (:meth:`resync`): serve
        the LIVE weights under their version so the rejoiner lands on
        the pod's agreed state without operator involvement. A worker
        whose engine exports no weight pytree answers its meta instead
        — the rejoiner skips it and asks the next peer.

        A worker in ``forge_sync`` byzantine mode (test-only) serves
        same-shape garbage under the forged version instead: weights
        drawn from a PRNG keyed on that version, so the forgery is
        deterministic per scenario and structurally indistinguishable
        from an honest reply without content verification.

        Hardened replies also carry the announce ``epoch``
        and a content ``fingerprint`` computed LIVE over the served
        payload. The forger computes a SELF-CONSISTENT fingerprint
        over its forged weights — content hashing alone cannot unmask
        it, which is exactly why :meth:`resync` also runs the
        strict-majority quorum over fingerprints."""
        params = getattr(self.engine, "params", None)
        if params is None:
            return self._meta(), b""
        rff = getattr(self.engine, "rff", None)
        params, rff = _host_weights(params, rff)
        version = int(getattr(self.engine, "version", 0))
        if self.forge_sync is not None:
            params, version = self._forge_params(params), self.forge_sync
        blob = pack_weights(params, rff)
        with self._lock:
            epoch = self._epoch
        return {"kind": "weights",
                "version": version,
                "epoch": epoch,
                "fingerprint": weights_fingerprint(params, rff, version),
                "worker": self.worker_id}, blob

    def _forge_params(self, params) -> dict:
        rng = np.random.RandomState(int(self.forge_sync) % (2 ** 32))
        return {k: rng.standard_normal(np.shape(v)).astype(
                    np.asarray(v).dtype)
                for k, v in params.items()}

    def _handle_dispatch(self, header: dict, payload: bytes) -> tuple:
        budget = header.get("budget_s")
        if budget is not None and float(budget) <= 0:
            # the deadline crossed the wire: refuse work nobody waits
            # for (transient — the router sheds/retries, not us)
            return {"kind": "error", "transient": True,
                    "error": "deadline budget exhausted at the "
                             "worker"}, b""
        X = unpack_batch(header, payload)
        version = header.get("version")
        t0 = time.perf_counter()
        kw = {}
        if self._predict_version:
            kw["version"] = version
        if self._predict_untimed:
            # out-of-band: concurrent connections (router dispatch +
            # an off-thread probe) must not race the hosted engine's
            # single-consumer timing slot
            kw["record_timings"] = False
        out = self.engine.predict(X, **kw)
        dur = time.perf_counter() - t0
        served_ver = (int(version) if version is not None
                      else int(getattr(self.engine, "version", 0)))
        with self._lock:
            self.dispatches += 1
        if self.tracer.enabled:
            ctx_raw = header.get("trace")
            if ctx_raw:
                # the TRACECTX consumer: this span joins the
                # router-side request trace — same trace id across
                # the process boundary, parented under the dispatch
                ctx = extract_context(ctx_raw)
                self.tracer.emit(
                    "pod_dispatch", ctx.trace_id, t0, dur,
                    parent_id=ctx.parent_id,
                    attrs={"worker": self.worker_id,
                           "rows": int(X.shape[0]),
                           "model_version": served_ver})
        resp = {"kind": "result", "worker": self.worker_id,
                "version": served_ver,
                "rows": int(out.shape[0]),
                "cols": int(out.shape[1]) if out.ndim == 2 else 1,
                # carry the rank: a hosted engine returning 1-D
                # predictions must come back 1-D on the client, or
                # the two transports stop being shape-equivalent
                "ndim": int(out.ndim),
                "dtype": str(out.dtype)}
        # .tobytes() serializes any layout C-ordered — engines return
        # host ndarrays, so no extra conversion (or device sync) here
        return resp, out.tobytes()


def worker_main(port_file: str, artifact_dir: str | None = None,
                checkpoint: str | None = None, host: str = "127.0.0.1",
                worker_id: int = 0, trace_dir: str | None = None,
                buckets=None, engine=None, peers=None,
                device=None) -> None:
    """Subprocess entry: host one pod worker until killed or told to
    ``stop``. ``artifact_dir`` loads an exported ladder
    (``ServingEngine.from_artifact`` — ``compile_count`` 0);
    ``checkpoint`` alone builds and warms an engine
    (``ServingEngine.load``); ``engine`` injects one directly (tests).
    ``device``: where a built engine serves (the card when None,
    ``"cpu"`` for the CPU). Start it in a FRESH interpreter (the
    ``spawn`` context or a subprocess): a process that has touched CUDA
    cannot fork a child that uses it, and each worker owns its own CUDA
    context. The bound port is published by writing ``port_file``
    ATOMICALLY (tmp + rename) once the listener is up — the spawner
    polls it. ``trace_dir`` streams the worker's spans through a
    rotating JSONL writer (O(1) memory; parts named
    ``podworker<id>-*``). ``peers`` lists pod endpoints to re-request
    the agreed weight version from before serving (the rejoin handshake
    — pass the surviving workers when respawning a killed one)."""
    tracer = None
    if trace_dir:
        from ..utils.trace import RotatingJsonlWriter, Tracer
        tracer = Tracer(writer=RotatingJsonlWriter(
            trace_dir, prefix=f"podworker{worker_id}"))
    if engine is None:
        from .engine import ServingEngine
        if artifact_dir:
            engine = ServingEngine.from_artifact(artifact_dir,
                                                 checkpoint=checkpoint,
                                                 device=device)
        elif checkpoint:
            engine = ServingEngine.load(
                checkpoint, device=device,
                **({} if buckets is None
                   else {"buckets": tuple(buckets)}))
            engine.warmup()
        else:
            raise ValueError(
                "worker_main needs artifact_dir, checkpoint, or "
                "engine=")
    worker = PodWorker(engine, host=host, worker_id=worker_id,
                       tracer=tracer, peers=peers)
    worker.start()
    tmp = f"{port_file}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{worker.port}\n")
    os.replace(tmp, port_file)
    # serve until SIGKILLed (the chaos plane's exit) or stopped by a
    # control frame; the accept thread is the worker's lifetime
    while not worker._stop.wait(0.2):
        pass
