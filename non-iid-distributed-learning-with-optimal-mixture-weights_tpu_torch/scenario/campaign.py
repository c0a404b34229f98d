"""Campaign search over composed scenarios, with shrinking.

A copy of the JAX package's ``scenario/campaign.py``: the same grid,
digest, shrinker and ``CAMPAIGN.v1``/``CAMPAIGN_REGRESSION.v1`` files, so
a regression written by either package loads and replays in the other.

:func:`run_campaign` sweeps a deterministic seed/intensity grid —
every scenario's master seed and knob setting derived from ONE
campaign seed via ``utils.seeds.derive_seed`` — through a
:class:`~.oracle.PropertyOracle`, and distills the result into a
``CAMPAIGN.v1`` artifact (validated by ``tools/check_bench_schema``).
The artifact's ``digest`` covers each scenario's canonical spec,
schedule digest and violation CODES — the timing-free facts — so the
acceptance contract is one string compare: same campaign seed, same
digest, bitwise.

On a violation the campaign does not stop at "seed 1729 fails": it
:func:`shrink`\\ s — greedy knob-at-a-time reduction (zero an
intensity, drop an event count, halve a structural dimension), keeping
each step only when the reduced scenario STILL fails with the original
violation codes — and emits the fixpoint as a minimal-repro JSON
(:func:`write_regression`). Committed under
``campaigns/regressions/``, a pytest collector replays every repro as
a tier-1 regression test asserting the once-failing spec now runs
clean: the shrunk scenario is the bug's permanent regression fence.

A campaign's scenario count is its budget (**count**, not wall time —
a wall-clock budget would make the artifact depend on machine speed
and break the digest contract); ``time_budget_s`` exists for CI
hygiene and marks the artifact ``truncated`` when it fires.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

from ..utils.seeds import derive_rng, derive_seed
from .oracle import PropertyOracle, Verdict
from .spec import ScenarioSpec

#: Campaign artifact schema (``CAMPAIGN_*.json``, repo-root artifacts).
CAMPAIGN_SCHEMA = "CAMPAIGN.v1"

#: Minimal-repro schema (``campaigns/regressions/*.json``).
REGRESSION_SCHEMA = "CAMPAIGN_REGRESSION.v1"

#: The intensity menu the grid draws from. Deliberately coarse: a
#: campaign explores COMBINATIONS of grammars, and the shrinker owns
#: finding the minimal intensity once a combination fails.
_INTENSITIES = (0.0, 0.2, 0.5, 0.8)


# ---------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------

def scenario_grid(campaign_seed: int, n: int) -> list:
    """The campaign's first ``n`` scenarios, derived — every field —
    from ``campaign_seed``. Scenario ``i`` gets its own master seed
    (``derive_seed(campaign_seed, "scenario", i)``: distinct scenarios
    never share grammar streams) and a knob draw from its own grid
    stream, so the walk visits mixed-grammar combinations immediately
    instead of sweeping one axis at a time."""
    if n < 1:
        raise ValueError(f"campaign budget must be >= 1, got {n}")
    out = []
    for i in range(int(n)):
        rng = derive_rng(campaign_seed, "grid", i)
        replicas = int(rng.randint(2, 4))
        requests = int(rng.randint(12, 33))
        out.append(ScenarioSpec(
            seed=derive_seed(campaign_seed, "scenario", i),
            rounds=int(rng.randint(2, 5)),
            clients=int(rng.randint(4, 9)),
            replicas=replicas,
            requests=requests,
            faults=float(rng.choice(_INTENSITIES)),
            chaos=float(rng.choice(_INTENSITIES)),
            load=float(rng.choice(_INTENSITIES)),
            net=float(rng.choice(_INTENSITIES)),
            swaps=int(rng.randint(0, 3)),
            kills=int(rng.randint(0, 2)),
            scales=int(rng.randint(0, 3)),
        ))
    return out


def campaign_digest(verdicts) -> str:
    """SHA-256 over the deterministic facts of a verdict sequence:
    canonical spec, schedule digest, violation codes — in campaign
    order. Latencies, retry counts and wall-clock stay out."""
    h = hashlib.sha256()
    for v in verdicts:
        h.update(json.dumps(
            [v.spec, v.digest, list(v.codes())],
            separators=(",", ":")).encode("utf-8"))
        h.update(b"\x1e")
    return h.hexdigest()


# ---------------------------------------------------------------------
# the shrinker
# ---------------------------------------------------------------------

def _reduce(spec: ScenarioSpec, **kw) -> ScenarioSpec:
    """``dataclasses.replace`` plus the coupled-knob clamps: a
    reduction of ``swaps`` or ``replicas`` drags ``announce_restarts``
    down with it (the grammar requires one swap per race and one host
    per race), so every candidate the shrinker proposes is a VALID
    spec rather than a ``ValueError`` mid-shrink."""
    swaps = kw.get("swaps", spec.swaps)
    replicas = kw.get("replicas", spec.replicas)
    ar = kw.get("announce_restarts", spec.announce_restarts)
    kw["announce_restarts"] = min(ar, swaps, replicas)
    return dataclasses.replace(spec, **kw)


def _reductions(spec: ScenarioSpec):
    """Candidate one-knob reductions of ``spec``, most-drastic first
    per knob — yielded as ``(action, reduced_spec)``. Ordering puts
    whole-grammar drops before structural halving: losing an entire
    grammar from the repro teaches more than losing two clients."""
    for knob in ("faults", "chaos", "load", "net"):
        v = getattr(spec, knob)
        if v > 0:
            yield (f"drop:{knob}",
                   dataclasses.replace(spec, **{knob: 0.0}))
    if spec.mut:
        # a mutant's minimal repro should stand without its lineage
        # when the parent streams already fail
        yield "drop:mut", dataclasses.replace(spec, mut=())
    for knob in ("swaps", "kills", "scales", "announce_restarts",
                 "forges"):
        v = getattr(spec, knob)
        if v > 0:
            yield f"zero:{knob}", _reduce(spec, **{knob: 0})
            if v > 1:
                yield (f"halve:{knob}",
                       _reduce(spec, **{knob: v // 2}))
    if spec.rounds > 1:
        yield ("halve:rounds",
               dataclasses.replace(spec,
                                   rounds=max(1, spec.rounds // 2)))
    if spec.clients > 2:
        yield ("halve:clients",
               dataclasses.replace(spec,
                                   clients=max(2, spec.clients // 2)))
    floor = 2 if (spec.kills > 0 or spec.announce_restarts > 0) else 1
    if spec.forges > 0:
        # the quorum contract: a shrink below 2*forges+2 replicas
        # would measure a lost pod, not the byzantine defense
        floor = max(floor, 2 * spec.forges + 2)
    if spec.replicas > floor:
        yield ("halve:replicas",
               _reduce(spec, replicas=max(floor, spec.replicas // 2)))
    min_requests = 8 if (spec.swaps or spec.kills or spec.scales) else 1
    if spec.requests > min_requests:
        yield ("halve:requests",
               dataclasses.replace(
                   spec,
                   requests=max(min_requests, spec.requests // 2)))


def shrink(spec, oracle: PropertyOracle, codes=None,
           max_steps: int = 64) -> tuple:
    """Greedy fixpoint reduction of a failing scenario.

    Re-runs ``spec`` to establish the target ``codes`` (unless
    given), then repeatedly tries one-knob reductions, keeping a
    reduction exactly when the reduced scenario still fails with
    every target code. Terminates at a spec no single reduction can
    shrink — the minimal repro — or at ``max_steps`` oracle runs
    (recorded in the trace, never silent).

    Returns ``(minimal_spec, trace)``; ``trace`` is the full decision
    log (one entry per attempted reduction: action, candidate spec,
    its codes, kept or not), which :func:`write_regression` commits
    alongside the repro — the reviewer of a regression sees WHY every
    surviving knob survived.
    """
    if isinstance(spec, str):
        spec = ScenarioSpec.parse(spec)
    trace = []
    if codes is None:
        codes = oracle.run(spec).codes()
    target = frozenset(codes)
    if not target:
        raise ValueError(
            "shrink needs a failing scenario (target codes empty) — "
            "shrinking a passing spec would minimize nothing")
    steps = 0
    progressed = True
    while progressed and steps < max_steps:
        progressed = False
        for action, cand in _reductions(spec):
            if steps >= max_steps:
                trace.append({"action": "stop:max_steps",
                              "spec": spec.canonical(),
                              "codes": sorted(target), "kept": False})
                break
            verdict = oracle.run(cand)
            steps += 1
            kept = target <= set(verdict.codes())
            trace.append({"action": action,
                          "spec": cand.canonical(),
                          "codes": list(verdict.codes()),
                          "kept": kept})
            if kept:
                spec = cand
                progressed = True
                break  # restart the reduction menu from the new spec
    return spec, trace


# ---------------------------------------------------------------------
# regressions on disk
# ---------------------------------------------------------------------

def write_regression(dirpath: str, spec: ScenarioSpec, codes,
                     shrink_trace, campaign_seed: int,
                     note: str = "") -> str:
    """Commit a shrunk repro as ``<dir>/<codes>-<seed>.json``. The
    file records the minimal spec, the codes it failed with WHEN
    CAPTURED (``fixed_codes`` — the collector asserts they stay
    fixed: the spec must now run clean), and the full shrink trace
    for provenance. Returns the path written."""
    codes = sorted(set(codes))
    if not codes:
        raise ValueError("a regression needs >= 1 violation code")
    record = {
        "schema": REGRESSION_SCHEMA,
        "campaign_seed": int(campaign_seed),
        "spec": spec.canonical(),
        "fixed_codes": codes,
        "shrink_trace": list(shrink_trace),
        "note": str(note),
    }
    os.makedirs(dirpath, exist_ok=True)
    slug = "-".join(c.lower() for c in codes)
    path = os.path.join(dirpath, f"{slug}-{spec.seed}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_regression(path: str) -> dict:
    """Read + validate one committed repro; raises ``ValueError`` on
    any shape problem (a malformed regression must fail the collector
    loudly, not skip silently)."""
    with open(path) as f:
        record = json.load(f)
    if record.get("schema") != REGRESSION_SCHEMA:
        raise ValueError(
            f"{path}: schema {record.get('schema')!r} != "
            f"{REGRESSION_SCHEMA!r}")
    for key in ("campaign_seed", "spec", "fixed_codes",
                "shrink_trace"):
        if key not in record:
            raise ValueError(f"{path}: missing {key!r}")
    if not isinstance(record["fixed_codes"], list) \
            or not record["fixed_codes"]:
        raise ValueError(f"{path}: fixed_codes must be a non-empty "
                         "list")
    ScenarioSpec.parse(record["spec"])  # must still parse
    return record


# ---------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------

def run_campaign(campaign_seed: int, budget: int,
                 oracle: PropertyOracle | None = None,
                 shrink_failures: bool = True,
                 time_budget_s: float | None = None,
                 progress=None) -> dict:
    """Run ``budget`` grid scenarios under one campaign seed; return
    the ``CAMPAIGN.v1`` artifact dict (see module docstring for the
    determinism scope). ``progress`` (callable of one string) gets a
    line per scenario — the CLI wires it to stderr."""
    oracle = oracle if oracle is not None else PropertyOracle()
    t0 = time.monotonic()
    specs = scenario_grid(campaign_seed, budget)
    verdicts: list[Verdict] = []
    failures = []
    truncated = False
    for i, spec in enumerate(specs):
        if time_budget_s is not None \
                and time.monotonic() - t0 > time_budget_s:
            truncated = True
            break
        verdict = oracle.run(spec)
        verdicts.append(verdict)
        if progress is not None:
            tag = (",".join(verdict.codes()) or "ok")
            if verdict.racy_codes():
                tag += f" (racy: {','.join(verdict.racy_codes())})"
            progress(f"[{i + 1}/{len(specs)}] {spec.canonical()}"
                     f" -> {tag}")
        # gate on the STABLE codes: a racy-only verdict (latency
        # property) is reported in its record's ``racy`` key but
        # neither fails the campaign nor feeds the shrinker — there
        # is no deterministic repro to shrink toward
        if not verdict.codes():
            continue
        failure = {"index": i, "verdict": verdict.to_record()}
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
    return {
        "schema": CAMPAIGN_SCHEMA,
        "seed": int(campaign_seed),
        "budget": int(budget),
        "scenarios": len(verdicts),
        "failures": len(failures),
        "truncated": truncated,
        "digest": campaign_digest(verdicts),
        "verdicts": [v.to_record() for v in verdicts],
        "violations": failures,
        "wall_s": round(time.monotonic() - t0, 3),
    }
