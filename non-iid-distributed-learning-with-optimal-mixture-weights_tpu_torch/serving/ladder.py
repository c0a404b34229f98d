"""Traffic-learned bucket ladders: replace the hand-picked rung set
with one learned from observed request sizes.

A copy of the JAX package's ``serving/ladder.py`` (stdlib only), over this
package's engine and telemetry registry. The fixed ``1/8/64/512/4096``
ladder is the serving twin of FedAvg's fixed ``n_j/n`` mixture weights: a
reasonable prior, hand-picked once, paying real cost (pad waste) wherever
traffic disagrees with it. This module makes the same move the source
paper makes with FedAMW — learn the weighting from held-out evidence,
with the cost charged explicitly:

- the EVIDENCE is the ``serve_request_rows`` histogram series the
  telemetry registry records for every served request
  (``ServeMetrics.record_batch`` writes it) — a ring buffer of raw
  per-request row counts, newest tail retained;
- the OBJECTIVE is an explicit pad-waste cost model: a rung set ``R``
  charges each request ``s`` the padded excess ``rung(s) - s`` rows
  (requests above the top rung chunk there, and only the remainder
  pads), plus ``program_cost`` rows per rung — the knob that prices one
  more rung (one more shape the engine dispatches, ``compile_count``)
  against the rows it saves;
- the BUDGETS are explicit: at most ``max_rungs`` rungs ever, and at
  most ``recompile_budget`` rung installs over the learner's lifetime —
  each install is one deliberate off-hot-path warm-up of a new shape,
  charged against the no-new-shape pin, and a learner whose budget is
  spent is FROZEN (``propose`` returns None, forever). The names keep
  the JAX package's "recompile", where one shape is one compiled
  program.

:func:`learn_ladder` is an exact dynamic program over the distinct
observed sizes (optimal rungs always sit AT observed sizes — sliding a
rung down to the largest size it serves never adds waste), so with a
rung budget at least the fixed ladder's size, the learned ladder's
sampled pad waste is <= the fixed ladder's by construction.

Applying a proposal never warms a shape on the serving hot path:
:func:`apply_proposal` walks ``ServingEngine.install_rung`` — each new
rung is warmed on the CALLER's thread (run it anywhere but the serving
worker) and published as one atomic tuple swap — or, on an
artifact-loaded engine, installed from an exported rung program
(``serving.artifacts``). Retired rungs stay counted, so in-flight
dispatches against the old ladder add no shape.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

#: Default bound on rungs (the fixed ladder uses 5; one
#: extra rung buys resolution where traffic actually concentrates).
DEFAULT_MAX_RUNGS = 6


def ladder_waste(sizes: Sequence[int], rungs: Sequence[int]) -> dict:
    """The explicit pad-waste cost model, evaluated: total padded
    excess rows the ``rungs`` ladder charges the ``sizes`` sample.

    A request of ``s`` rows pads to the smallest rung >= s; above the
    top rung it chunks there (full chunks are exact) and only the
    remainder pads — mirroring ``ServingEngine.predict``. Returns
    ``{"rows", "padded_rows", "waste_rows", "waste_fraction"}``.
    """
    ladder = sorted(int(b) for b in rungs)
    if not ladder or ladder[0] <= 0:
        raise ValueError(f"bad ladder {rungs!r}")
    top = ladder[-1]
    rows = padded = 0
    for s in sizes:
        s = int(s)
        if s <= 0:
            raise ValueError(f"request sizes must be positive, got {s}")
        rows += s
        full, rem = divmod(s, top) if s > top else (0, s)
        padded += full * top
        if rem:
            padded += next(b for b in ladder if rem <= b)
    waste = padded - rows
    return {"rows": rows, "padded_rows": padded, "waste_rows": waste,
            "waste_fraction": round(waste / rows, 6) if rows else 0.0}


def learn_ladder(sizes: Sequence[int], max_rungs: int,
                 program_cost: float = 0.0) -> tuple:
    """Optimal rung set for an observed size sample: minimize
    ``waste_rows + program_cost * len(rungs)`` over ladders of at most
    ``max_rungs`` rungs, by exact DP over the distinct observed sizes.

    The top rung is always the observed max (so every sampled request
    fits unchunked), rungs are strictly increasing, and the rung count
    never exceeds ``max_rungs`` — the bounded-program-count contract.
    ``program_cost`` (rows per rung) is the explicit price of one more
    rung; 0 spends the whole rung budget whenever it saves
    any padding.
    """
    if max_rungs < 1:
        raise ValueError(f"max_rungs must be >= 1, got {max_rungs}")
    counts: dict[int, int] = {}
    for s in sizes:
        s = int(s)
        if s <= 0:
            raise ValueError(f"request sizes must be positive, got {s}")
        counts[s] = counts.get(s, 0) + 1
    if not counts:
        raise ValueError("need at least one observed size")
    cand = sorted(counts)
    m = len(cand)
    # prefix count/sum over candidates: cost of covering candidates
    # (i, j] with rung cand[j] is rung * n(i, j] - sum(i, j]
    pc = [0] * (m + 1)
    ps = [0] * (m + 1)
    for i, c in enumerate(cand):
        pc[i + 1] = pc[i] + counts[c]
        ps[i + 1] = ps[i] + counts[c] * c

    def seg(i: int, j: int) -> int:
        # waste of sizes in cand(i..j] served by rung cand[j] (0-based
        # inclusive j, exclusive i: candidates i+1..j)
        return cand[j] * (pc[j + 1] - pc[i + 1]) - (ps[j + 1] - ps[i + 1])

    INF = float("inf")
    k_max = min(int(max_rungs), m)
    # dp[k][j]: min waste covering cand[0..j] with exactly k rungs,
    # cand[j] the top one — O(k m^2), m is DISTINCT sizes (hundreds at
    # most); back[k][j] is the previous rung's candidate index
    dp = [[INF] * m for _ in range(k_max + 1)]
    back = [[-1] * m for _ in range(k_max + 1)]
    for j in range(m):
        dp[1][j] = seg(-1, j)
    for k in range(2, k_max + 1):
        for j in range(k - 1, m):
            best, arg = INF, -1
            for i in range(k - 2, j):
                c = dp[k - 1][i] + seg(i, j)
                if c < best:
                    best, arg = c, i
            dp[k][j] = best
            back[k][j] = arg
    # top rung pinned at the observed max (j = m-1); pick the rung
    # count minimizing waste + program_cost * k (more rungs never add
    # waste, so program_cost is the only brake on spending the budget)
    best_k, best_cost = 1, dp[1][m - 1] + float(program_cost)
    for k in range(2, k_max + 1):
        cost = dp[k][m - 1] + float(program_cost) * k
        if cost < best_cost:
            best_k, best_cost = k, cost
    rungs, j = [], m - 1
    for k in range(best_k, 0, -1):
        rungs.append(cand[j])
        j = back[k][j]
    out = tuple(sorted(rungs))
    assert (len(out) == best_k and out[-1] == cand[-1]
            and len(out) <= k_max)
    return out


@dataclasses.dataclass(frozen=True)
class LadderProposal:
    """One re-bucketing decision, costs attached: the full proposed
    rung set, the delta against the current ladder, and the pad-waste
    evidence (proposed vs current, on the SAME sampled histogram) that
    justifies paying ``len(install)`` recompiles for it."""

    rungs: tuple
    install: tuple              # new rungs to pre-warm + publish
    retire: tuple               # current rungs the proposal drops
    sample_count: int           # sizes the decision was learned from
    observed_max: int
    waste_fraction: float       # proposed ladder, on the sample
    baseline_waste_fraction: float  # current ladder, on the sample
    recompiles_charged: int     # == len(install), the explicit cost


class LadderLearner:
    """Learn rung proposals from the telemetry registry's request-rows
    series, under explicit rung and recompile budgets (module
    docstring). Thread-safe; ``propose`` is a pure read of the
    registry, ``charge``/``freeze`` mutate the budget."""

    def __init__(self, registry, metric: str = "serve_request_rows",
                 max_rungs: int = DEFAULT_MAX_RUNGS,
                 recompile_budget: int = 8, min_samples: int = 64,
                 program_cost: float = 0.0):
        if recompile_budget < 0 or min_samples < 1:
            raise ValueError("recompile_budget must be >= 0 and "
                             "min_samples >= 1")
        self.registry = registry
        self.metric = metric
        self.max_rungs = int(max_rungs)
        self.recompile_budget = int(recompile_budget)
        self.min_samples = int(min_samples)
        self.program_cost = float(program_cost)
        self._lock = threading.Lock()
        self._spent = 0
        self._frozen = False
        self.last_reason: str | None = None

    @property
    def recompiles_spent(self) -> int:
        with self._lock:
            return self._spent

    @property
    def budget_remaining(self) -> int:
        with self._lock:
            return self.recompile_budget - self._spent

    @property
    def frozen(self) -> bool:
        """Whether the learner may still propose: explicitly frozen
        (``freeze()``) or out of recompile budget — either way,
        ``propose`` returns None from here on and the ladder is PINNED
        (the state the zero-recompile-after-freeze bench pin
        measures)."""
        with self._lock:
            return self._frozen or self._spent >= self.recompile_budget

    def freeze(self) -> None:
        with self._lock:
            self._frozen = True

    def charge(self, n_rungs: int = 1) -> None:
        """Account ``n_rungs`` installed rungs against the recompile
        budget (``apply_proposal`` calls this per install). Charging
        past the budget raises — the budget is a hard pin, not a
        suggestion."""
        with self._lock:
            if self._spent + int(n_rungs) > self.recompile_budget:
                raise RuntimeError(
                    f"recompile budget exhausted: {self._spent} spent "
                    f"+ {n_rungs} > budget {self.recompile_budget}")
            self._spent += int(n_rungs)

    def observed_sizes(self, window_s: float | None = None) -> list:
        """Raw request-row samples from the registry's histogram
        series (the retained ring tail, or the trailing ``window_s``).
        Empty when the family was never recorded — a learner wired to
        a series-disabled registry honestly sees no evidence."""
        hist = self.registry.lookup(self.metric)
        if hist is None:
            return []
        if window_s is None:
            items, _ = hist.series_state()
            vals = [v for _, v in items]
        else:
            vals = hist.window_values(window_s)
        return [int(v) for v in vals if v >= 1]

    def propose(self, current: Sequence[int],
                window_s: float | None = None) -> LadderProposal | None:
        """A re-bucketing proposal against the ``current`` ladder, or
        None (with ``last_reason`` saying why): learner frozen, not
        enough evidence, no waste improvement, or the install list
        would overdraw the remaining recompile budget."""
        if self.frozen:
            self.last_reason = "frozen (recompile budget spent)"
            return None
        sizes = self.observed_sizes(window_s)
        if len(sizes) < self.min_samples:
            self.last_reason = (f"{len(sizes)} samples < min_samples "
                                f"{self.min_samples}")
            return None
        rungs = learn_ladder(sizes, self.max_rungs,
                             program_cost=self.program_cost)
        cur = tuple(sorted(int(b) for b in current))
        install = tuple(b for b in rungs if b not in cur)
        retire = tuple(b for b in cur if b not in rungs)
        proposed = ladder_waste(sizes, rungs)
        baseline = ladder_waste(sizes, cur)
        if not install and not retire:
            self.last_reason = "current ladder already optimal"
            return None
        if proposed["waste_rows"] >= baseline["waste_rows"]:
            self.last_reason = (
                f"no waste improvement ({proposed['waste_rows']} vs "
                f"{baseline['waste_rows']} rows)")
            return None
        if len(install) > self.budget_remaining:
            self.last_reason = (
                f"{len(install)} installs > remaining recompile "
                f"budget {self.budget_remaining}")
            return None
        self.last_reason = None
        return LadderProposal(
            rungs=rungs, install=install, retire=retire,
            sample_count=len(sizes), observed_max=max(sizes),
            waste_fraction=proposed["waste_fraction"],
            baseline_waste_fraction=baseline["waste_fraction"],
            recompiles_charged=len(install))


def apply_proposal(engine, proposal: LadderProposal,
                   learner: LadderLearner | None = None,
                   aot_rungs: dict | None = None) -> tuple:
    """Install a proposal's rungs on a live engine — pre-warmed on the
    CALLER's thread (run this anywhere but the serving worker;
    ``ServingEngine.install_rung`` publishes each rung only after it
    has run once) — then retire the dropped rungs.

    Mesh engines round rungs up to a device multiple, so proposed
    rungs are rounded HERE first: one that rounds onto an existing
    rung installs nothing (and charges nothing), and a current rung
    that is some proposed rung's rounded image is never retired — the
    proposal's coverage survives the rounding. The ``learner``'s
    recompile budget is charged BEFORE each install: the charge is
    the cheap check, the install is the warm-up of a new shape, and a
    budget overdraw must fail before the install runs, not after
    (``recompiles_spent`` therefore never undercounts new shapes).
    ``aot_rungs``: rung -> rung program for artifact-loaded engines
    (``serving.artifacts.load_ladder`` of a re-exported ladder).
    Returns the engine's new ladder."""
    n_dev = getattr(engine, "_n_dev", 1)

    def rounded(b):
        return -(-int(b) // n_dev) * n_dev

    present = set(engine.buckets)
    for b in proposal.install:
        if rounded(b) in present:
            continue  # rounds onto an existing rung: nothing to do
        if learner is not None:
            learner.charge(1)
        kw = {}
        if aot_rungs is not None:
            kw["aot"] = aot_rungs[b]
        present.add(engine.install_rung(b, **kw))
    keep = {rounded(b) for b in proposal.rungs}
    for b in proposal.retire:
        if int(b) in keep:
            continue  # a proposed rung's rounded image: still wanted
        engine.retire_rung(b)
    return tuple(engine.buckets)
