"""Replay every committed campaign regression through the port's oracle.

``campaigns/regressions/*.json`` holds minimal repros shrunk from
scenario-fuzzing campaign failures (written by ``tools/run_campaign.py``
or ``python -m fedamw_tpu_torch.scenario``). Each records a spec that
once violated the invariant codes in ``fixed_codes``; here each replays
through ``fedamw_tpu_torch.scenario.PropertyOracle`` on the CPU (the
train leg on the port's defense plane, the serve leg on the port's
pod) and must run clean, as it does through the JAX package's oracle
(``tests/test_campaign_regressions.py``).
"""

import glob
import os

import pytest

from fedamw_tpu_torch.scenario import PropertyOracle, load_regression
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG_DIR = os.path.join(REPO, "campaigns", "regressions")
REG_FILES = sorted(glob.glob(os.path.join(REG_DIR, "*.json")))


def test_regression_directory_is_nonempty():
    # the collector below parametrizes over files; an emptied directory
    # would pass silently
    assert REG_FILES, f"no committed regressions under {REG_DIR}"


@pytest.mark.parametrize(
    "path", REG_FILES, ids=[os.path.basename(p) for p in REG_FILES])
def test_committed_regression_replays_clean_on_the_port(path):
    rec = load_regression(path)
    verdict = PropertyOracle(device="cpu").run(rec["spec"])
    assert verdict.ok, (
        f"{os.path.basename(path)} regressed on the port: the shrunk "
        f"repro {rec['spec']!r} violates {verdict.codes()} again "
        f"(originally fixed: {rec['fixed_codes']}) — "
        f"{verdict.violations}")
    assert verdict.spec == rec["spec"]
