"""Coverage-guided scenario hunting.

A copy of the JAX package's ``scenario/search.py``: the same pool,
rarity schedule, mutation lineage and ``CAMPAIGN.v2`` artifact.

:func:`run_campaign` sweeps a blind grid: scenario ``i`` runs because
it is scenario ``i``. This module replaces the draw order with a HUNT:

- **coverage signatures** — every oracle run is summarized into the
  set of :data:`COVERAGE_AXES` it touched (schedule-determined
  telemetry only: kills, rejoin resyncs, stale-epoch refusals, forged
  -sync rejections, swap announces, scale events, armed grammars, and
  each violation code). A campaign-wide tally counts how often each
  axis has been exercised.
- **a rarity scheduler** — candidates are drawn into a pool up front
  (:func:`hunt_grid`, a WIDER grid than the v1 campaign's: replicas
  reach far enough to arm the byzantine quorum, and the two carried
  pod fault classes are drawn in), then run in rarity order: each step
  picks the pending candidate whose PREDICTED signature
  (:func:`predicted_signature`, a pure function of the spec) scores
  highest under ``sum(1 / (1 + tally[axis]))`` — scenarios promising
  underrepresented paths run first, and every completed run re-prices
  the pool. Ties break deterministically (mutants first, then enqueue
  order), so one search seed is one bitwise artifact.
- **near-miss mutation** — a violation-free run that ENGAGED a defense
  edge (a rejoin resync raced a version announce; a stale epoch was
  refused; a forged sync was rejected) came within one event of an
  invariant. Instead of redrawing, the hunter re-enqueues the SAME
  scenario with its offending sub-grammar stream re-keyed
  (``ScenarioSpec.mut`` — every other stream stays bitwise), up to
  :data:`MAX_MUTATION_DEPTH` re-keyings deep. Mutation lineage is
  recorded per verdict (``origin``), so an artifact shows which
  scenarios were hunted rather than drawn.
- **a wall budget** — ``wall_budget_s`` bounds the hunt by clock
  (the nightly's ``CAMPAIGN_WALL_S``), marking the artifact
  ``truncated`` exactly like the v1 ``time_budget_s``; the scenario
  BUDGET stays the determinism unit.

The result is a ``CAMPAIGN.v2`` artifact: the v1 layout plus
``coverage`` (the final axis tally), ``wall_budget_s``, and per
-verdict ``origin`` + ``signature``. Its digest covers the same
timing-free facts as v1 PLUS origin and signature — same search seed,
same budget, same digest, bitwise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

from ..utils.seeds import derive_rng, derive_seed
from .campaign import _INTENSITIES, shrink
from .oracle import PropertyOracle, Verdict
from .spec import ScenarioSpec

#: Coverage-guided artifact schema (supersets ``CAMPAIGN.v1``).
CAMPAIGN_SCHEMA_V2 = "CAMPAIGN.v2"

#: How many times one scenario may be re-keyed along mutation lineage.
#: Depth 2 keeps the hunt moving: a near-miss's mutant may near-miss
#: again, but its grand-mutant returns the slot to the scheduler.
MAX_MUTATION_DEPTH = 2

#: Verdict-count keys -> coverage axis names. Only SCHEDULE-DETERMINED
#: counters may appear here: the tally steers the scheduler and lands
#: in the artifact digest, so a timing-racy axis (shed/requeue splits,
#: circuit half-opens) would make one seed hunt two different orders
#: on two machines. Racy telemetry stays in the verdict records for
#: humans; it steers nothing.
_COUNT_AXES = (
    ("kills", "kill"),
    ("restarts", "restart"),
    ("resyncs", "resync"),
    ("sync_timeouts", "sync_timeout"),
    ("stale_refused", "stale_refused"),
    ("forge_rejected", "forge_rejected"),
    ("swaps_applied", "swap"),
    ("scale_ups", "scale_up"),
    ("scale_downs", "scale_down"),
    ("lost", "lost"),
)

#: The full axis menu (documentation + checker cross-reference).
COVERAGE_AXES = tuple(sorted(
    {name for _, name in _COUNT_AXES}
    | {"faults", "chaos", "load", "net",
       "announce_restart", "forge", "mutant"}))


# ---------------------------------------------------------------------
# the candidate pool
# ---------------------------------------------------------------------

def hunt_grid(campaign_seed: int, n: int) -> list:
    """The hunter's candidate pool: like ``scenario_grid`` but drawn
    from its own streams (``"hunt"``/``"scenario-hunt"`` — a hunt and
    a sweep under one seed never share grammar randomness) and over a
    WIDER structural range: replicas reach 6 so a draw can satisfy the
    byzantine quorum floor (``replicas >= 2*forges + 2``), swaps may
    carry a mid-announce restart race, and sync forgers arm whenever
    the fleet is large enough."""
    if n < 1:
        raise ValueError(f"hunt pool size must be >= 1, got {n}")
    out = []
    for i in range(int(n)):
        rng = derive_rng(campaign_seed, "hunt", i)
        replicas = int(rng.randint(2, 7))
        swaps = int(rng.randint(0, 3))
        announce_restarts = (int(rng.randint(0, 2))
                             if swaps > 0 and replicas >= 2 else 0)
        forges = (int(rng.randint(0, 2))
                  if replicas >= 4 else 0)
        kills = int(rng.randint(0, 2))
        if forges and kills == 0 and announce_restarts == 0:
            # a forger nobody ever syncs from is dead weight in the
            # pool: arm the rejoin path it exists to attack
            kills = 1
        out.append(ScenarioSpec(
            seed=derive_seed(campaign_seed, "scenario-hunt", i),
            rounds=int(rng.randint(2, 5)),
            clients=int(rng.randint(4, 9)),
            replicas=replicas,
            requests=int(rng.randint(12, 33)),
            faults=float(rng.choice(_INTENSITIES)),
            chaos=float(rng.choice(_INTENSITIES)),
            load=float(rng.choice(_INTENSITIES)),
            net=float(rng.choice(_INTENSITIES)),
            swaps=swaps,
            kills=kills,
            scales=int(rng.randint(0, 3)),
            announce_restarts=announce_restarts,
            forges=forges,
        ))
    return out


# ---------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------

def predicted_signature(spec: ScenarioSpec) -> frozenset:
    """The axes a spec PROMISES to touch — a pure function of the
    spec, priced by the scheduler before the scenario ever runs."""
    axes = set()
    for knob in ("faults", "chaos", "load", "net"):
        if getattr(spec, knob) > 0:
            axes.add(knob)
    if spec.kills:
        axes.update(("kill", "restart", "resync"))
    if spec.swaps:
        axes.add("swap")
    if spec.scales:
        axes.update(("scale_up", "scale_down"))
    if spec.announce_restarts:
        axes.update(("announce_restart", "kill", "restart", "resync"))
    if spec.forges:
        axes.add("forge")
    if spec.mut:
        axes.add("mutant")
    return frozenset(axes)


def actual_signature(spec: ScenarioSpec, verdict: Verdict) -> tuple:
    """The axes a completed run ACTUALLY touched, sorted — built from
    the schedule-determined counters plus the armed grammars plus
    every stable violation code."""
    axes = {name for key, name in _COUNT_AXES
            if verdict.counts.get(key, 0) > 0}
    for knob in ("faults", "chaos", "load", "net"):
        if getattr(spec, knob) > 0:
            axes.add(knob)
    if spec.announce_restarts:
        axes.add("announce_restart")
    if spec.forges:
        axes.add("forge")
    if spec.mut:
        axes.add("mutant")
    for code in verdict.codes():
        axes.add(f"code:{code}")
    return tuple(sorted(axes))


def near_miss_streams(spec: ScenarioSpec, verdict: Verdict) -> tuple:
    """Which sub-grammar streams to perturb after a VIOLATION-FREE run
    that engaged an invariant edge — empty when the run stayed far
    from every edge (mutating it would be a redraw with extra steps).

    - a rejoin resync in a scenario that also announced versions: the
      rejoin and the announce windows are event-placement away from
      racing, so the ``events`` stream (timing jitter + host draws)
      is the offending one;
    - a stale-epoch refusal or a forged-sync rejection: the epoch
      fence / fingerprint quorum fired, meaning the attack REACHED
      the defense — re-keying the ``net`` stream hunts the draw that
      slips past it.
    """
    if verdict.codes():
        return ()
    streams = []
    c = verdict.counts
    engaged_announce = c.get("swaps_applied", 0) or spec.swaps
    if c.get("resyncs", 0) and engaged_announce:
        streams.append("events")
    if c.get("stale_refused", 0) or c.get("forge_rejected", 0):
        streams.append("net")
    return tuple(streams)


# ---------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------

def _rarity(axes, tally: dict) -> float:
    """Rarer axes are worth more; an axis never touched is worth 1."""
    return sum(1.0 / (1.0 + tally.get(a, 0)) for a in axes)


def search_digest(entries) -> str:
    """SHA-256 over the deterministic facts of a hunt, in run order:
    the v1 triple (canonical spec, schedule digest, stable codes)
    plus each verdict's origin and actual signature."""
    h = hashlib.sha256()
    for verdict, origin, signature in entries:
        h.update(json.dumps(
            [verdict.spec, verdict.digest, list(verdict.codes()),
             origin, list(signature)],
            separators=(",", ":"), sort_keys=True).encode("utf-8"))
        h.update(b"\x1e")
    return h.hexdigest()


def run_search(campaign_seed: int, budget: int,
               oracle: PropertyOracle | None = None,
               shrink_failures: bool = True,
               wall_budget_s: float | None = None,
               progress=None) -> dict:
    """Hunt ``budget`` scenarios under one search seed; return the
    ``CAMPAIGN.v2`` artifact dict (module docstring). The scheduling
    loop below is the hunt: price the pool by rarity, run the best
    candidate, fold its signature into the tally, enqueue mutants of
    near-misses."""
    oracle = oracle if oracle is not None else PropertyOracle()
    if wall_budget_s is not None and wall_budget_s <= 0:
        raise ValueError(
            f"wall_budget_s={wall_budget_s} must be positive or None")
    t0 = time.monotonic()
    # pending: (enqueue_idx, origin, spec); enqueue order is the
    # deterministic tie-break and mutants outrank grid draws at equal
    # rarity (they exist because evidence, not chance, priced them)
    pending = [(i, {"kind": "grid", "index": i}, spec)
               for i, spec in enumerate(hunt_grid(campaign_seed,
                                                  budget))]
    next_idx = len(pending)
    tally: dict = {}
    entries = []          # (verdict, origin, signature), run order
    failures = []
    truncated = False
    while pending and len(entries) < budget:
        if wall_budget_s is not None \
                and time.monotonic() - t0 > wall_budget_s:
            truncated = True
            break
        pending.sort(key=lambda item: (
            -_rarity(predicted_signature(item[2]), tally),
            0 if item[1]["kind"] == "mutation" else 1,
            item[0]))
        idx, origin, spec = pending.pop(0)
        verdict = oracle.run(spec)
        signature = actual_signature(spec, verdict)
        for axis in signature:
            tally[axis] = tally.get(axis, 0) + 1
        run_i = len(entries)
        entries.append((verdict, origin, signature))
        if progress is not None:
            tag = (",".join(verdict.codes()) or "ok")
            if verdict.racy_codes():
                tag += f" (racy: {','.join(verdict.racy_codes())})"
            progress(f"[{run_i + 1}/{budget}] {origin['kind']} "
                     f"{spec.canonical()} -> {tag}")
        if verdict.codes():
            failure = {"index": run_i, "origin": origin,
                       "verdict": verdict.to_record()}
            if shrink_failures:
                minimal, trace = shrink(spec, oracle,
                                        codes=verdict.codes())
                failure["shrunk"] = {
                    "spec": minimal.canonical(),
                    "codes": list(verdict.codes()),
                    "steps": len(trace),
                    "trace": trace,
                }
            failures.append(failure)
            continue
        if len(spec.mut) >= MAX_MUTATION_DEPTH:
            continue
        for stream in near_miss_streams(spec, verdict):
            attempt = 1 + sum(1 for s, _ in spec.mut if s == stream)
            mutant = dataclasses.replace(
                spec, mut=spec.mut + ((stream, attempt),))
            pending.append((next_idx,
                            {"kind": "mutation", "parent": run_i,
                             "stream": stream, "attempt": attempt},
                            mutant))
            next_idx += 1
    return {
        "schema": CAMPAIGN_SCHEMA_V2,
        "seed": int(campaign_seed),
        "budget": int(budget),
        "scenarios": len(entries),
        "failures": len(failures),
        "truncated": truncated,
        "wall_budget_s": (None if wall_budget_s is None
                          else float(wall_budget_s)),
        "digest": search_digest(entries),
        "coverage": {k: tally[k] for k in sorted(tally)},
        "verdicts": [dict(v.to_record(), origin=origin,
                          signature=list(sig))
                     for v, origin, sig in entries],
        "violations": failures,
        "wall_s": round(time.monotonic() - t0, 3),
    }
