"""Scenario fuzzing over the composed fault grammars (the JAX package's
``scenario`` package on the port).

The repo owns four seeded adversity grammars, each proven in
isolation: ``fedcore.faults.FaultSpec`` (the train-side client fault
plane), ``serving.chaos.ChaosSpec`` (replica chaos), ``LoadSpec``
(offered-load shapes) and ``NetChaosSpec`` (the wire). This package
composes them: one :class:`ScenarioSpec` draws all four — plus
mid-stream weight swaps, worker kills/rejoins and scripted autoscale
events — from ONE master seed via splittable sub-seed derivation
(``utils.seeds.derive_seed``), a :class:`PropertyOracle` runs the
composed scenario end-to-end (train leg through the port's fault and
defense plane on the oracle's device, serve leg through a
socket-transport pod behind the failover router and admission control
on the host) and asserts the repo's standing invariants as typed
:class:`Violation` records, and :func:`run_campaign` sweeps seeds and
intensities under a budget, shrinking any failure (:func:`shrink`) to a
minimal reproduction a pytest collector replays as a regression test
(``campaigns/regressions/*.json``).

Determinism contract (the same one every grammar carries): the same
master seed expands to the bitwise-identical scenario schedule, and a
campaign at one seed produces the identical ``CAMPAIGN.v1`` artifact
modulo wall-clock fields — in this package and the JAX package alike,
so the committed ``CAMPAIGN_r16.json`` and ``CAMPAIGN_r18.json``
re-derive here.

:func:`run_search` replaces blind grid order with coverage-guided
scheduling (rarity-priced candidate pool over :data:`COVERAGE_AXES`,
near-miss mutation along the offending sub-grammar stream, an optional
wall budget) and emits the ``CAMPAIGN.v2`` artifact — the v1 layout plus
coverage accounting and per-verdict mutation lineage — under the same
bitwise-per-seed contract.

Run a campaign with ``python -m fedamw_tpu_torch.scenario --seed 7
--budget 200`` (``--device cpu`` without a card).
"""

from .campaign import (CAMPAIGN_SCHEMA, REGRESSION_SCHEMA,
                       load_regression, run_campaign, shrink,
                       write_regression)
from .oracle import (INVARIANTS, RACY_CODES, OracleEngine,
                     PropertyOracle, Verdict, Violation)
from .search import (CAMPAIGN_SCHEMA_V2, COVERAGE_AXES,
                     actual_signature, hunt_grid, predicted_signature,
                     run_search)
from .spec import ScenarioEvent, ScenarioPlan, ScenarioSpec

__all__ = [
    "CAMPAIGN_SCHEMA",
    "CAMPAIGN_SCHEMA_V2",
    "COVERAGE_AXES",
    "INVARIANTS",
    "OracleEngine",
    "PropertyOracle",
    "RACY_CODES",
    "REGRESSION_SCHEMA",
    "ScenarioEvent",
    "ScenarioPlan",
    "ScenarioSpec",
    "Verdict",
    "Violation",
    "actual_signature",
    "hunt_grid",
    "load_regression",
    "predicted_signature",
    "run_campaign",
    "run_search",
    "shrink",
    "write_regression",
]
