"""Rollout controller: shadow/A-B traffic splitting with gated promote.

A copy of the JAX package's ``serving/rollout.py``, driving this
package's ``ServingEngine``.

The registry (``serving/registry.py``) says what models exist; this
module decides which one SERVES. A candidate version walks one
irreversible-free path:

  stage(v):   install next to the live weights (same compiled ladder,
              zero recompiles) -> offline parity gate — the candidate's
              served accuracy must reproduce the training-side
              evaluation accuracy recorded at publish (the
              ``engine_acc == evaluate_acc`` check a serving run
              makes on the live model). Fail -> retire, done.
  canary:     the micro-batcher splits live traffic by a DETERMINISTIC
              per-request-id hash (``assigned_to_candidate``):
              *shadow* mode dispatches the candidate on the assigned
              requests but answers every caller from the live version
              (dark launch — the probe runs on the
              service's dedicated probe thread, so candidate warm
              dispatch no longer serializes behind live traffic on
              the worker; probes past the bounded probe queue are
              shed and COUNTED, never blocking); *ab* mode answers the
              assigned slice from the candidate, falling back to the
              live version on any candidate dispatch failure so a bad
              canary degrades to the old model, never to an error.
  promote:    after >= ``min_requests`` candidate dispatches with
              errors <= ``error_budget`` (and, when configured, a
              live-traffic prediction agreement floor), the candidate
              takes 100% via ``engine.swap_weights(version=...)`` —
              one pointer flip, the prior version kept installed for
              ``revert()``.
  rollback:   any gate failure clears the split and retires the
              candidate; the prior version never stopped serving.

Determinism of the split is load-bearing twice: a request id is
assigned the same arm on every retry (no flapping mid-request), and a
test can pin exactly which ids land on the candidate.

The controller is the service's ``router``: the worker thread calls
``split()`` per batch and ``observe()`` after candidate dispatches;
both are cheap and lock-bounded. Promotion/rollback therefore happen
ON the worker thread, which is what makes them atomic with respect to
batch dispatch — no request can be mid-flight across the flip.
"""

from __future__ import annotations

import collections
import threading
import time
import zlib

import numpy as np

#: Rollout event-log bound: a continuous publish->promote loop appends
#: a few events per cycle, and a days-long service must hold O(1)
#: controller memory — the same rationale as the rotating trace writer
#: and the engine's live+prior weight bound. Old events roll off.
MAX_EVENTS = 512

#: Hash-split resolution: request-id -> bucket in [0, 1) with ~1e-9
#: granularity (crc32 is stable across processes and runs — unlike
#: Python's salted hash() — which is what makes assignment
#: deterministic evidence, not a per-process accident).
_SPLIT_DENOM = float(2 ** 32)


def split_key(request_id: str) -> float:
    """Deterministic position of a request id on the unit interval."""
    return zlib.crc32(str(request_id).encode()) / _SPLIT_DENOM


def assigned_to_candidate(request_id: str, fraction: float) -> bool:
    """Whether this id's traffic belongs to the candidate arm at the
    given split fraction. Monotone in ``fraction``: growing the canary
    keeps every already-assigned id on the candidate (the standard
    ramp property)."""
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    return split_key(request_id) < fraction


class RolloutController:
    """Gated candidate rollout over a ``ServingService`` (see module
    docstring). Attaches itself as ``service.router``."""

    MODES = ("shadow", "ab")

    def __init__(self, service, registry, mode: str = "shadow",
                 fraction: float = 0.1, min_requests: int = 50,
                 error_budget: int = 0, min_agreement: float | None = None,
                 parity_data=None, parity_tol: float = 1e-4,
                 ramp_every: int | None = None, ramp_factor: float = 2.0,
                 max_fraction: float = 1.0):
        """``parity_data``: ``(X, y)`` — the SAME raw test rows and
        labels training evaluated on when it recorded the candidate's
        ``metadata['eval_acc']`` (for ``exp.py --publish_every``
        checkpoints, the dataset's own test split). The gate is the
        EXACT-parity check (``engine_acc == evaluate_acc`` within
        ``parity_tol``, default 1e-4): the served pipeline must
        reproduce training's number on training's rows bit-for-bit-
        in-accuracy. A *different* held-out split differs by sampling
        noise and would roll back every healthy candidate at the
        default tolerance — for such data, widen ``parity_tol`` to
        the noise scale or rely on ``min_agreement`` + the error
        budget instead. Without parity data (or a recorded eval_acc),
        staging records the gate as unchecked and relies on the
        live-traffic budget alone.

        ``min_agreement``: optional live-traffic gate — the fraction
        of shadow rows whose candidate argmax matches the live
        version's must stay at or above this before promotion (the
        online complement of the offline parity check). Shadow-only:
        ab mode answers the assigned slice FROM the candidate, so
        there are no paired live outputs to compare — configuring the
        floor there would silently never be enforced, so it is
        refused instead.

        ``ramp_every``: the FRACTIONAL RAMP — grow
        the candidate split on observed error budget instead of
        serving a fixed per-stage fraction: every ``ramp_every``
        candidate dispatches, a window that stayed error-FREE
        multiplies ``fraction`` by ``ramp_factor`` (capped at
        ``max_fraction``); a window with any error holds the current
        fraction (the budget check still rolls the whole canary back
        when exceeded — the ramp only decides how fast exposure
        GROWS, never whether the candidate survives). The hash split
        is monotone in the fraction (``assigned_to_candidate``), so
        every already-assigned request id stays on the candidate
        through each growth step — no flapping. ``None`` (default)
        keeps the fixed-fraction behavior. ``fraction`` is then the
        ramp's STARTING exposure; each ``stage()`` restarts from it.
        """
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        if min_agreement is not None and mode != "shadow":
            raise ValueError(
                "min_agreement is a shadow-mode gate (ab mode serves "
                "the candidate's answers directly — there are no "
                "paired live outputs to measure agreement against); "
                "use shadow mode, or rely on the parity gate + error "
                "budget for ab")
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        if min_requests < 0 or error_budget < 0:
            raise ValueError("min_requests/error_budget must be >= 0")
        if ramp_every is not None and ramp_every < 1:
            raise ValueError(f"ramp_every must be >= 1 (dispatches per "
                             f"ramp window), got {ramp_every}")
        if ramp_factor <= 1.0:
            raise ValueError(f"ramp_factor must be > 1 (the ramp grows "
                             f"exposure), got {ramp_factor}")
        if not fraction <= max_fraction <= 1.0:
            raise ValueError(
                f"need fraction <= max_fraction <= 1, got "
                f"fraction={fraction} max_fraction={max_fraction}")
        self.service = service
        self.engine = service.engine
        self.registry = registry
        self.mode = mode
        self.fraction = float(fraction)
        self.base_fraction = float(fraction)  # each stage() restarts here
        self.ramp_every = None if ramp_every is None else int(ramp_every)
        self.ramp_factor = float(ramp_factor)
        self.max_fraction = float(max_fraction)
        self._ramp_served = 0   # candidate dispatches this ramp window
        self._ramp_errors = 0   # candidate errors this ramp window
        self.min_requests = int(min_requests)
        self.error_budget = int(error_budget)
        self.min_agreement = (None if min_agreement is None
                              else float(min_agreement))
        self.parity_data = parity_data
        self.parity_tol = float(parity_tol)
        self._lock = threading.Lock()
        self._candidate: int | None = None
        self._staging = False  # reserves the rollout slot during stage()
        self._promoting = False  # holds the slot through promote's flip
        self._served = 0
        self._errors = 0
        self._agree_rows = 0
        self._agree_hits = 0
        self.prior_version: int | None = None
        self.events: collections.deque = collections.deque(
            maxlen=MAX_EVENTS)
        if getattr(service, "router", None) is not None:
            # the router slot is singular: silently replacing an
            # attached controller would orphan its in-flight rollout
            # (staged weights never promoted OR retired)
            raise ValueError(
                "service already has a router attached; detach() the "
                "existing controller first")
        service.router = self
        # live staleness for the snapshot: without this, a service
        # that stops swapping would report staleness 0 forever while
        # training publishes past it
        service.metrics.staleness_of = self.staleness_rounds

    def detach(self) -> None:
        """Release the service's router slot: rolls back any in-flight
        candidate (staged weights retired), then clears the router and
        staleness hooks so another controller can attach."""
        self.rollback("detached")
        if getattr(self.service, "router", None) is self:
            self.service.router = None
        if self.service.metrics.staleness_of == self.staleness_rounds:
            self.service.metrics.staleness_of = None

    # -- service-facing (worker thread) -------------------------------
    def split(self):
        """Atomic snapshot of the active traffic split:
        ``(candidate_version, fraction, mode)`` or None. Read once per
        micro-batch by the service worker."""
        with self._lock:
            if self._candidate is None:
                return None
            return self._candidate, self.fraction, self.mode

    def staleness_rounds(self, version) -> int:
        """Rounds the registry's newest publish is ahead of
        ``version`` — the span/metrics dimension.
        ``ModelRegistry.staleness_rounds`` is total (unknown versions
        and missing round markers report 0), so no guard here; the
        service keeps its own boundary guard for foreign routers."""
        return self.registry.staleness_rounds(version)

    def observe(self, version: int, served: int = 0, errors: int = 0,
                agreement: tuple | None = None) -> None:
        """Candidate-arm outcome report from the worker: ``served``
        candidate dispatch successes, ``errors`` candidate dispatch
        failures (requests that FELL BACK to live in ab mode — the
        caller never saw them), ``agreement`` as ``(matching_rows,
        total_rows)`` from a shadow/A-B comparison. Drives the
        promote/rollback decision inline."""
        promote = rollback_reason = ramped_to = None
        with self._lock:
            if self._candidate != version:
                return  # a stale report from before a rollback
            self._served += int(served)
            self._errors += int(errors)
            if agreement is not None:
                self._agree_hits += int(agreement[0])
                self._agree_rows += int(agreement[1])
            if self.ramp_every is not None:
                # fractional ramp: an error-free window grows the
                # split; a window with any error holds it (the budget
                # check below still decides survival). Mutated under
                # the lock split() reads the fraction through, so the
                # worker's next batch sees the grown split atomically.
                # Window progress counts DISPATCHES (successes and
                # errors both) — an erroring candidate must not take
                # longer to close its window than a healthy one. A
                # batched report can close SEVERAL windows: each is
                # consumed with its residual carried (a reset-to-zero
                # would silently stretch the configured schedule), and
                # the batch's errors land on the earliest open window.
                self._ramp_served += int(served) + int(errors)
                self._ramp_errors += int(errors)
                while self._ramp_served >= self.ramp_every:
                    self._ramp_served -= self.ramp_every
                    if (self._ramp_errors == 0
                            and self.fraction < self.max_fraction):
                        self.fraction = min(
                            self.max_fraction,
                            self.fraction * self.ramp_factor)
                        ramped_to = self.fraction
                    self._ramp_errors = 0
            if self._errors > self.error_budget:
                rollback_reason = (
                    f"error budget exceeded: {self._errors} candidate "
                    f"dispatch errors > budget {self.error_budget}")
            elif self._served >= self.min_requests:
                agree = self._agreement_locked()
                if (self.min_agreement is not None and agree is not None
                        and agree < self.min_agreement):
                    rollback_reason = (
                        f"live-traffic agreement {agree:.4f} below the "
                        f"{self.min_agreement} floor")
                else:
                    promote = True
        if ramped_to is not None and not rollback_reason:
            self._event("ramped", version=version, fraction=ramped_to)
        if rollback_reason:
            # expected= pins the action to the candidate the decision
            # was ABOUT: if another thread rolled back and staged a
            # NEW candidate in this gap, neither verdict may land on
            # it (a promote would bypass its budget from zero
            # observations)
            self.rollback(rollback_reason, expected=version)
        elif promote:
            try:
                self.promote(expected=version)
            except RuntimeError:
                # the candidate was rolled back (or replaced) by
                # another thread between the decision (under the
                # lock) and this call — benign, but letting it escape
                # would kill the serving WORKER thread (observe runs
                # there) and hang every queued request
                pass

    def _agreement_locked(self) -> float | None:
        if self._agree_rows == 0:
            return None
        return self._agree_hits / self._agree_rows

    # -- gates / transitions ------------------------------------------
    def _event(self, kind: str, **attrs) -> dict:
        ev = {"event": kind, "t": time.time(), **attrs}
        with self._lock:
            self.events.append(ev)
        return ev

    def _parity_gate(self, version: int) -> dict:
        """Offline gate: the staged candidate, served through the
        compiled ladder, must reproduce its own training-evaluation
        accuracy on held-out rows — the same check a serving run
        makes on the live model. Unchecked (no parity data, or
        the publisher recorded no eval_acc) passes but says so."""
        entry = self.registry.get(version)
        if self.parity_data is None or entry.eval_acc is None:
            return {"checked": False, "match": True}
        X, y = self.parity_data
        # out-of-band dispatch: this runs on the controller's thread
        # while the serving worker may be mid-batch — it must not
        # bill its timing/version into the worker's pop slot. The
        # service already probed whether the engine's predict supports
        # record_timings (custom engines may not); without it, pop
        # and discard, same as the shadow probe.
        X = np.asarray(X, np.float32)
        if getattr(self.service, "_predict_untimed", False):
            logits = self.engine.predict(X, version=version,
                                         record_timings=False)
        else:
            logits = self.engine.predict(X, version=version)
            pop = getattr(self.engine, "pop_timings", None)
            if pop is not None:
                pop()
        acc = 100.0 * float(np.mean(
            np.argmax(logits, -1) == np.asarray(y)))
        return {"checked": True,
                "engine_acc": round(acc, 6),
                "evaluate_acc": round(entry.eval_acc, 6),
                "match": abs(acc - entry.eval_acc) < self.parity_tol}

    def stage(self, version: int) -> bool:
        """Install a registry version as the candidate and open the
        traffic split — after the offline parity gate. Returns whether
        the candidate went live-in-canary; on gate failure the
        candidate is retired and the prior (still-serving) version is
        untouched. With ``min_requests == 0`` the candidate promotes
        immediately (the direct-deploy spelling)."""
        with self._lock:
            # reserve the rollout slot under ONE lock hold: the
            # candidate is published ~below, and a check-then-act gap
            # here would let two concurrent stage() calls both pass
            # the single-rollout guard (one's installed weights would
            # leak, never retired)
            if (self._candidate is not None or self._staging
                    or self._promoting):
                raise RuntimeError(
                    "a rollout is already in flight; promote or "
                    "rollback first")
            self._staging = True
        try:
            entry = self.registry.get(version)
            live = self.engine.version
            if version == live:
                raise ValueError(f"version {version} is already live")
            self.engine.install_weights(version, entry.params,
                                        entry.rff)
            try:
                gate = self._parity_gate(version)
            except Exception:
                # a gate that cannot run (transient backend error,
                # malformed parity data) must not leak the installed
                # candidate: retire so a later retry can re-stage the
                # same version number
                self.engine.retire(version)
                raise
            if not gate["match"]:
                self.engine.retire(version)
                self._event("rollback", version=version, stage="parity",
                            reason="parity gate failed", gate=gate)
                self.service.metrics.record_rollback()
                return False
            with self._lock:
                self._candidate = version
                self._served = self._errors = 0
                self._agree_hits = self._agree_rows = 0
                # the ramp restarts from the configured base exposure
                # for every new candidate (a prior rollout's grown
                # fraction is ITS earned trust, not this one's)
                self.fraction = self.base_fraction
                self._ramp_served = self._ramp_errors = 0
        finally:
            with self._lock:
                self._staging = False
        self._event("staged", version=version, mode=self.mode,
                    fraction=self.fraction, gate=gate)
        if self.min_requests == 0:
            try:
                # expected= pins this to OUR candidate: if the worker
                # already promoted it and someone staged a NEW one in
                # the gap, this trailing promote must not flip that
                # candidate live past its own canary gate
                self.promote(expected=version)
            except RuntimeError:
                # under live traffic the worker's observe() may win
                # the promote race the moment the candidate publishes
                # (min_requests == 0 is satisfiable by zero
                # observations) — either winner leaves the candidate
                # live, which is all this branch promises
                pass
        return True

    def promote(self, expected: int | None = None) -> int:
        """Candidate takes 100% of traffic: one atomic live-pointer
        flip on the engine (the weights are already device-resident
        and the ladder compiled — swap latency is the pointer write).
        The prior version stays installed for :meth:`revert`; anything
        older is retired — a continuous publish->promote loop must
        hold at most live + one prior on device, not every version it
        ever served (the long-lived-loop memory bound, same rationale
        as ``ModelRegistry.prune``). ``expected`` re-verifies under
        the lock that the candidate is still the one the caller
        decided about (observe's cross-thread guard)."""
        with self._lock:
            v = self._candidate
            if v is None:
                raise RuntimeError("no candidate staged")
            if expected is not None and v != expected:
                raise RuntimeError(
                    f"candidate changed (now {v}, decided about "
                    f"{expected})")
            served, errors = self._served, self._errors
            agree = self._agreement_locked()
            self._candidate = None
            # the slot stays held until the flip LANDS: releasing it
            # here would let a concurrent stage()+promote interleave
            # between our candidate-clear and our swap, and this
            # promote's delayed flip would then put the OLDER version
            # back live behind the new rollout's back
            self._promoting = True
        try:
            prior = self.engine.version
            self.engine.swap_weights(version=v)
            old_prior, self.prior_version = self.prior_version, prior
            if old_prior is not None and old_prior not in (v, prior):
                # two generations back: no revert() path reaches it
                try:
                    self.engine.retire(old_prior)
                except (KeyError, ValueError):
                    pass  # already gone, or (post-revert) live again
        finally:
            with self._lock:
                self._promoting = False
        stale = self.staleness_rounds(v)
        self.service.metrics.record_swap(v, stale)
        self._event("promoted", version=v, prior=prior,
                    served=served, errors=errors, agreement=agree,
                    staleness_rounds=stale)
        return v

    def rollback(self, reason: str = "operator",
                 expected: int | None = None) -> None:
        """Abort the canary: clear the split, retire the candidate's
        weights. The live version never stopped serving, so there is
        nothing else to undo. ``expected``: only roll back if the
        candidate is still the named one (a no-op otherwise — the
        verdict belongs to a rollout that already ended)."""
        with self._lock:
            v = self._candidate
            if expected is not None and v != expected:
                return
            self._candidate = None
        if v is None:
            return
        self.engine.retire(v)
        self.service.metrics.record_rollback()
        self._event("rollback", version=v, stage="canary",
                    reason=reason)

    def revert(self) -> int:
        """Post-promotion escape hatch: flip live back to the prior
        version (still installed), retiring the version being left —
        the live + one-prior device-memory bound holds through
        reverts too. One-shot: the prior slot is consumed (a second
        revert has nowhere to go and raises rather than recording a
        phantom swap)."""
        if self.prior_version is None:
            raise RuntimeError("no prior version recorded")
        left = self.engine.version
        if left == self.prior_version:
            raise RuntimeError(
                f"already serving the prior version {left}")
        v = self.engine.swap_weights(version=self.prior_version)
        self.prior_version = None
        try:
            self.engine.retire(left)
        except (KeyError, ValueError):
            pass
        self.service.metrics.record_swap(v, self.staleness_rounds(v))
        self._event("reverted", version=v, retired=left)
        return v

    def status(self) -> dict:
        with self._lock:
            return {
                "live_version": self.engine.version,
                "candidate": self._candidate,
                "mode": self.mode,
                "fraction": self.fraction,
                "ramp_every": self.ramp_every,
                "max_fraction": self.max_fraction,
                "served": self._served,
                "errors": self._errors,
                "agreement": self._agreement_locked(),
                "prior_version": self.prior_version,
                "events": len(self.events),
            }
