"""The port's driver as the train side of the train->serve loop, on the
CPU: ``--publish_every N`` with ``--save_models DIR``.

sklearn ``digits``, RFF D=64, J=4 clients, R=3 rounds of 1 local epoch,
``--device cpu``. Held: the segmented run's pickle is bitwise the
unsegmented run's (every segment resumes the last one's state, and every
per-round stream is drawn for the whole horizon); each round-based
algorithm publishes ``DIR/digits_{algo}_repeat0/v0001..v0003`` (and
``v0002``, ``v0003`` at N=2, the last segment short); every version
carries the params, p, round, ``eval_acc``, the RFF draw and, under
``--feature_dtype``, its marker, and the last one is bitwise the
unsegmented run's ``--save_models`` checkpoint; the JAX package's
``ModelRegistry`` and ``CheckpointWatcher`` read the versions, and so
do the port's, whose engine serves each with the evaluator's accuracy.
The refusals, message for message against the JAX driver, are
``tests/test_torch_exp.py``.
"""

import pickle

import numpy as np
import pytest
import torch

from fedamw_tpu_torch import exp
from fedamw_tpu_torch.serving import (CheckpointWatcher, ModelRegistry,
                                      ServingEngine)
from fedamw_tpu_torch.utils import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

R = 3
ARGV = ["--device", "cpu", "--dataset", "digits", "--D", "64",
        "--num_partitions", "4", "--round", str(R), "--local_epoch", "1",
        "--n_repeats", "1", "--seed", "100"]
ROUND_BASED = ("FedAvg", "FedProx", "FedAMW")


def _run(tmp, *extra):
    with open(exp.main(ARGV + ["--result_dir", str(tmp), *extra]),
              "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plain run with --save_models, and the same run published
    every round."""
    root = tmp_path_factory.mktemp("publish")
    plain = _run(root / "plain", "--save_models", str(root / "ck_plain"))
    seg = _run(root / "seg", "--save_models", str(root / "ck_seg"),
               "--publish_every", "1")
    return root, plain, seg


def test_segmented_pickle_is_the_plain_run_bitwise(runs):
    _, plain, seg = runs
    assert set(plain) == set(seg)
    for k in ("train_loss", "test_loss", "test_acc", "heterogeneity"):
        np.testing.assert_array_equal(seg[k], plain[k], err_msg=k)
    assert seg["name"] == plain["name"]


@pytest.mark.parametrize("algo", ROUND_BASED)
def test_every_boundary_publishes_a_servable_version(runs, algo):
    root, _, _ = runs
    base = root / "ck_seg" / f"digits_{algo}_repeat0"
    assert sorted(p.name for p in base.iterdir()) == [
        "v0001", "v0002", "v0003"]
    for k in (1, 2, 3):
        state = load_checkpoint(str(base / f"v{k:04d}"))
        assert state["round"] == k
        assert {"params", "p", "rff_W", "rff_b", "eval_acc"} <= set(state)
    # the last boundary IS the final state: the plain run's checkpoint
    final = load_checkpoint(str(base / "v0003"))
    whole = load_checkpoint(str(root / "ck_plain" / f"digits_{algo}_repeat0"))
    assert set(final) == set(whole)
    for k, v in whole["params"].items():
        np.testing.assert_array_equal(final["params"][k], v)
    for k in ("p", "rff_W", "rff_b"):
        np.testing.assert_array_equal(final[k], whole[k])
    assert final["eval_acc"] == whole["eval_acc"]
    assert not (root / "ck_seg" / f"digits_{algo}_repeat0" /
                "state.pkl").exists()


def test_the_jax_registry_reads_the_published_versions(runs):
    """The JAX package's watcher ingests the port's versions in round
    order, with their markers."""
    from fedamw_tpu.serving import CheckpointWatcher as JWatcher
    from fedamw_tpu.serving import ModelRegistry as JRegistry

    root, _, seg = runs
    reg = JRegistry()
    w = JWatcher(reg, str(root / "ck_seg" / "digits_FedAMW_repeat0"),
                 poll_interval_s=0.02)
    out = w.poll_once()
    assert [n for n, _ in w.published] == ["v0001", "v0002", "v0003"]
    assert [reg.get(v).round_idx for v in out] == [1, 2, 3]
    assert reg.latest().eval_acc == pytest.approx(
        float(seg["test_acc"][5, -1, 0]))
    assert reg.get(out[0]).rff is not None
    assert reg.staleness_rounds(out[0]) == 2


def test_the_port_registry_serves_the_published_versions(runs):
    """The port's watcher ingests them, and its engine serves each
    version with the accuracy the driver recorded for it."""
    from fedamw_tpu_torch.data import load_dataset

    root, _, seg = runs
    reg = ModelRegistry()
    w = CheckpointWatcher(reg, str(root / "ck_seg" / "digits_FedAvg_repeat0"),
                          poll_interval_s=0.02)
    versions = w.poll_once()
    assert [reg.get(v).round_idx for v in versions] == [1, 2, 3]
    rng = np.random.RandomState(100)
    ds = load_dataset("digits", 4, 0.01, rng=rng)
    y = torch.as_tensor(ds.y_test)
    engine = None
    for k, v in enumerate(versions):
        entry = reg.get(v)
        if engine is None:
            engine = ServingEngine(entry.params, rff=entry.rff,
                                   buckets=(8, 512), version=v, device="cpu")
            cc = engine.warmup()
        else:
            engine.swap_weights(entry.params, rff=entry.rff, version=v)
        logits = torch.from_numpy(engine.predict(
            np.asarray(ds.X_test, np.float32)))
        acc = float(100.0 * torch.mean((logits.argmax(-1) == y).float()))
        assert acc == pytest.approx(entry.eval_acc, abs=1e-4)
        assert entry.eval_acc == pytest.approx(
            float(seg["test_acc"][3, k, 0]))
    assert engine.compile_count == cc


def test_uneven_segments_and_the_feature_dtype_marker(tmp_path, capsys):
    """N=2 over R=3: versions at rounds 2 and 3, each announced; the
    pickle is the plain run's, and --feature_dtype's marker rides every
    version."""
    seg = _run(tmp_path / "seg", "--save_models", str(tmp_path / "ck"),
               "--publish_every", "2", "--feature_dtype", "bfloat16")
    out = capsys.readouterr().out
    for algo in ROUND_BASED:
        for rnd in (2, 3):
            assert f"{algo}: published round-{rnd} model ->" in out
        assert f"{algo}: final model already published ->" in out
    assert "checkpoint ->" not in out
    plain = _run(tmp_path / "plain", "--feature_dtype", "bfloat16")
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(seg[k], plain[k], err_msg=k)
    base = tmp_path / "ck" / "digits_FedProx_repeat0"
    assert sorted(p.name for p in base.iterdir()) == ["v0002", "v0003"]
    for name, rnd in (("v0002", 2), ("v0003", 3)):
        state = load_checkpoint(str(base / name))
        assert state["round"] == rnd
        assert state["feature_dtype"] == "bfloat16"


def test_publish_every_zero_keeps_the_single_checkpoint():
    """0 (the default) is the unsegmented run: no round_algo, one
    checkpoint at the end."""
    args = exp.parse_args(ARGV + ["--save_models", "ck"])
    assert args.publish_every == 0
    args = exp.parse_args(ARGV + ["--save_models", "ck", "--publish_every",
                                  "0", "--resume"])
    assert args.publish_every == 0 and args.resume
