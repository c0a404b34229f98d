"""Dynamic micro-batching: coalesce queued requests into one bucket.

Requests arrive as independent ``(k_i, d)`` (or single-row) arrays; the
engine wants one padded bucket per dispatch. A copy of the JAX
package's ``serving/batcher.py`` (pure numpy and ``queue``). The split is
deliberate: :func:`coalesce`/:func:`split_results` are pure functions
over request lists (trivially testable), :func:`admit`/:func:`drain`
are the queue-side accumulation policies, and ``service.py`` owns the
thread that glues them to a live queue.

Two admission policies, one holdover contract:

- :func:`admit` — **continuous batching** (the default):
  take everything already queued, NEVER wait for stragglers. Occupancy
  comes from pipelining, not lingering: while the previous dispatch
  occupied the engine, new arrivals accumulated in the queue, and the
  moment the rung frees the worker admits all of them into the next
  dispatch. Under load batches fill themselves; at low rates a request
  flies solo immediately instead of idling ``max_wait`` first.
- :func:`drain` — the legacy fixed-micro-batch policy (grab what's
  waiting, linger up to ``max_wait`` for more, aim at the LARGEST
  bucket). Kept as the explicitly-selectable baseline that continuous
  batching is measured against: the wait bound
  trades tail latency for batch occupancy, and that trade is exactly
  what continuous admission deletes.
"""

from __future__ import annotations

import queue
import time
from typing import Sequence

import numpy as np


def request_rows(x: np.ndarray) -> int:
    """Row count of one request payload (single rows count as 1)."""
    return 1 if x.ndim == 1 else int(x.shape[0])


def coalesce(payloads: Sequence[np.ndarray]) -> tuple[np.ndarray, list]:
    """Stack request payloads into one ``(sum k_i, d)`` matrix.

    Returns ``(X, spans)`` where ``spans[i] = (lo, hi, single)`` maps
    request ``i`` back to its output rows (``single`` restores the
    1-D shape of a bare-row request).
    """
    rows, spans, lo = [], [], 0
    for x in payloads:
        x = np.asarray(x, dtype=np.float32)
        single = x.ndim == 1
        if single:
            x = x[None, :]
        rows.append(x)
        spans.append((lo, lo + x.shape[0], single))
        lo += x.shape[0]
    return np.concatenate(rows, axis=0), spans


def split_results(out: np.ndarray, spans: list) -> list:
    """Inverse of :func:`coalesce` over the stacked logits."""
    return [out[lo] if single else out[lo:hi]
            for lo, hi, single in spans]


def drain(q: "queue.Queue", first, max_rows: int,
          max_wait: float = 0.002, clock=time.monotonic) -> tuple:
    """Accumulate a batch starting from ``first``.

    Takes everything already queued, then waits up to ``max_wait``
    seconds (from now) for more, stopping early once adding the NEXT
    request would exceed ``max_rows`` — that request is never split (a
    request is the atomic unit; the engine chunks oversized single
    requests itself) and is returned as the HOLDOVER, which the caller
    must seed the next batch with. Returns ``(batch, holdover)`` where
    ``holdover`` is None when the drain ended on timeout/budget-exact.

    Handing the over-budget request back (rather than re-queueing it at
    the tail) bounds its extra delay to one batch: at the tail, a large
    request under a sustained stream of small ones could be bounced
    behind fresh arrivals indefinitely, until its deadline sheds it.
    """
    batch = [first]
    rows = request_rows(first.x) if hasattr(first, "x") else \
        request_rows(first)
    deadline = clock() + max_wait
    while rows < max_rows:
        remaining = deadline - clock()
        try:
            nxt = q.get_nowait() if remaining <= 0 else q.get(
                timeout=remaining)
        except queue.Empty:
            break
        n = request_rows(nxt.x) if hasattr(nxt, "x") else \
            request_rows(nxt)
        if rows + n > max_rows:
            return batch, nxt
        batch.append(nxt)
        rows += n
    return batch, None


def admit(q: "queue.Queue", seed, max_rows: int) -> tuple:
    """Continuous-batching admission: accumulate a batch from ``seed``
    (one request, or the worker's carried list of deferred requests)
    plus everything ALREADY queued, without ever waiting.

    The pipelining twin of :func:`drain`: the worker calls this the
    moment the previous dispatch returns, so the "wait" for batch
    occupancy is the previous rung's dispatch time — requests that
    arrived during it are admitted now, and an empty queue dispatches
    the seed alone immediately. The holdover contract is identical to
    :func:`drain`: the request that would exceed ``max_rows`` is never
    split and is handed back to seed the NEXT batch, bounding its extra
    delay to one dispatch.
    """
    batch = list(seed) if isinstance(seed, list) else [seed]
    rows = sum(request_rows(r.x) if hasattr(r, "x") else
               request_rows(r) for r in batch)
    while rows < max_rows:
        try:
            nxt = q.get_nowait()
        except queue.Empty:
            break
        n = request_rows(nxt.x) if hasattr(nxt, "x") else \
            request_rows(nxt)
        if rows + n > max_rows:
            return batch, nxt
        batch.append(nxt)
        rows += n
    return batch, None


def rung_cut(rows_list, rungs) -> int:
    """Rung-aware batch cut: how many leading requests of an admitted
    batch to dispatch NOW so the dispatch lands near a ladder rung
    instead of padding deep into the next one.

    An eagerly-admitted batch totalling just past a rung (e.g. 271
    rows against a ``256/512`` ladder) would pad nearly double its
    rows; cutting it back to the longest prefix fitting the rung BELOW
    the total serves those rows almost pad-free, and the deferred tail
    seeds the immediately-following dispatch — one batch of extra
    delay, the holdover bound. The cut only fires when the lower rung
    covers at least HALF the total (``2 * lower >= total``): cutting
    deeper would trade a little padding for a mostly-empty dispatch,
    which costs more throughput than the padding did. Returns an index
    in ``[1, len(rows_list)]`` (never 0 — the head request always
    dispatches, requests are never split).
    """
    total = sum(rows_list)
    lower = None
    for b in rungs:
        if b > total:
            break
        if b == total:
            return len(rows_list)  # exact fill: nothing to trim
        lower = b
    if lower is None or 2 * lower < total:
        return len(rows_list)
    rows = cut = 0
    for n in rows_list:
        if rows + n > lower:
            break
        rows += n
        cut += 1
    return cut if cut >= 1 else len(rows_list)


def edf_order(batch) -> list:
    """Deadline scheduling for an over-full admitted batch:
    soonest-deadline-first, submit-time FIFO among equals, requests
    with NO deadline last (infinitely patient by definition).

    Applied by the continuous worker only UNDER PRESSURE — when the
    admitted batch cannot fit one dispatch, so somebody must wait a
    cycle — because that is the only time order matters: the deferred
    tail is chosen from the latest deadlines instead of whoever
    arrived last. The sort is stable and keys on ``(deadline,
    t_submit)``, so an all-deadline-free batch comes back in exactly
    its FIFO/carry order (the clean-load path is byte-identical), and
    a deadline'd request can never be starved by later-deadline
    traffic — its absolute deadline eventually sorts first.
    """
    inf = float("inf")

    def key(r):
        d = getattr(r, "deadline", None)
        return (d if d is not None else inf,
                getattr(r, "t_submit", 0.0))

    return sorted(batch, key=key)


def partition(requests, predicate) -> tuple[list, list]:
    """One-pass split of a micro-batch into ``(matching, rest)``,
    order preserved on both sides — how the service carves the rollout
    candidate's slice out of a batch (``predicate`` is the
    deterministic per-request-id assignment,
    ``rollout.assigned_to_candidate``). A request lands on exactly one
    side; the batch is never reordered, so queue-wait attribution
    stays per-request exact."""
    hit, miss = [], []
    for r in requests:
        (hit if predicate(r) else miss).append(r)
    return hit, miss


class MicroBatcher:
    """Convenience wrapper: one engine dispatch for many requests."""

    def __init__(self, engine):
        self.engine = engine

    def run(self, payloads: Sequence[np.ndarray]) -> list:
        """Serve all payloads in a single coalesced engine call and
        hand each request its own logits back."""
        if not payloads:
            return []
        X, spans = coalesce(payloads)
        return split_results(self.engine.predict(X), spans)
