"""Run a scenario-fuzzing campaign and write the CAMPAIGN artifact.

Usage (from the repository root)::

    python -m fedamw_tpu_torch.scenario --seed 7 --budget 200
    python -m fedamw_tpu_torch.scenario --seed 7 --budget 200 \
        --out CAMPAIGN_fuzz.json --regressions campaigns/regressions
    python -m fedamw_tpu_torch.scenario --seed 7 --budget 500 --search \
        --wall-budget-s 900
    python -m fedamw_tpu_torch.scenario --seed 1 --budget 8 --device cpu

The port's counterpart of ``tools/run_campaign.py``, with its flags,
exit status and artifact, plus ``--device``: where the oracle's train
leg runs (the card by default; ``cpu`` to run without one). Sweeps
``--budget`` composed scenarios (all derived from ``--seed``; see
``fedamw_tpu_torch.scenario``) through the property oracle, writes the
campaign artifact (validated by ``tools/check_bench_schema.py``), and —
when a scenario violates an invariant — shrinks it and drops the minimal
repro into ``--regressions``, where the regression tests replay it.

``--search`` swaps the blind grid sweep for the coverage-guided hunter
(``run_search``): rarity-scheduled candidates, near-miss mutation, a
``CAMPAIGN.v2`` artifact with coverage accounting and mutation lineage.
``--wall-budget-s`` (or the ``CAMPAIGN_WALL_S`` environment variable)
bounds the hunt by wall-clock; the artifact is marked ``truncated`` when
it fires.

Exit status: 0 when every scenario ran clean, 1 when any violated an
invariant (the artifact and repro files are written either way).

The artifact is deterministic per seed modulo ``wall_s`` and
``truncated``: the time budgets exist for CI hygiene, but a truncated
campaign's digest covers only the scenarios that ran — compare digests
between runs only at equal scenario counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import (PropertyOracle, ScenarioSpec, run_campaign, run_search,
               write_regression)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fedamw_tpu_torch.scenario",
        description="seeded scenario-fuzzing campaign")
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign master seed (default 0)")
    ap.add_argument("--budget", type=int, default=200,
                    help="scenarios to run (default 200)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default CAMPAIGN_fuzz.json in "
                         "the current directory)")
    ap.add_argument("--regressions", default=None,
                    help="directory for shrunk minimal repros "
                         "(default campaigns/regressions)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="record violations without shrinking "
                         "(faster triage sweeps)")
    ap.add_argument("--time-budget-s", type=float, default=None,
                    help="stop starting new scenarios after this many "
                         "seconds (artifact is marked truncated)")
    ap.add_argument("--search", action="store_true",
                    help="coverage-guided hunt (run_search, "
                         "CAMPAIGN.v2) instead of the grid sweep")
    ap.add_argument("--wall-budget-s", type=float, default=None,
                    help="with --search: wall-clock hunt budget "
                         "(defaults to the CAMPAIGN_WALL_S env var "
                         "when set)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-scenario progress lines")
    ap.add_argument("--device", default=None,
                    help="device of the oracle's train leg (default: "
                         "the CUDA card; 'cpu' to run without one)")
    args = ap.parse_args(argv)

    out = args.out or "CAMPAIGN_fuzz.json"
    reg_dir = args.regressions or os.path.join("campaigns", "regressions")
    progress = None if args.quiet else (
        lambda line: print(line, file=sys.stderr, flush=True))
    oracle = PropertyOracle(device=args.device)
    if args.search:
        wall = args.wall_budget_s
        if wall is None and os.environ.get("CAMPAIGN_WALL_S"):
            wall = float(os.environ["CAMPAIGN_WALL_S"])
        artifact = run_search(
            args.seed, args.budget, oracle=oracle,
            shrink_failures=not args.no_shrink,
            wall_budget_s=wall, progress=progress)
    else:
        artifact = run_campaign(
            args.seed, args.budget, oracle=oracle,
            shrink_failures=not args.no_shrink,
            time_budget_s=args.time_budget_s, progress=progress)

    written = []
    for failure in artifact["violations"]:
        shrunk = failure.get("shrunk")
        if shrunk is None:
            continue
        written.append(write_regression(
            reg_dir, ScenarioSpec.parse(shrunk["spec"]),
            shrunk["codes"], shrunk["trace"], campaign_seed=args.seed,
            note=f"campaign seed {args.seed}, scenario index "
                 f"{failure['index']}"))
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, out)

    n, bad = artifact["scenarios"], artifact["failures"]
    print(f"{n} scenario(s), {bad} with violations "
          f"({artifact['wall_s']}s) -> {out}")
    for path in written:
        print(f"  minimal repro: {path}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
