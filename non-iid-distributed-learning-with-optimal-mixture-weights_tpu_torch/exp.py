"""The paper's experiment driver on the port: six algorithms on one dataset.

Follows the repository's ``exp.py`` (the reference flow,
``exp.py:753-835``): per repeat ``t``, a ``RandomState(seed + t)``
drives loading and the validation split; the features are RFF-mapped
once; the heterogeneity score is taken on the full partitions; then
Centralized and Distributed (``local_epoch * round`` epochs),
FedAMW_OneShot (the registry's ``lambda_reg_os``/``lr_p_os``), FedAvg,
FedProx and FedAMW (the registry's lr, mu, lambda and lr_p) run in that
order. The result is ``{result_dir}/exp1_{dataset}.pkl`` with exactly
``exp.py``'s keys (``exp.py:476-493``): ``(6, round, n_repeats)`` metric
arrays, the heterogeneity of each repeat, the row names and the task.

Run from the repository root::

    python -m fedamw_tpu_torch.exp --dataset mnist --round 100
    python -m fedamw_tpu_torch.exp --device cpu --dataset digits --D 64 \\
        --num_partitions 4 --round 2

It runs on the CUDA card unless ``--device`` names another device, and
raises without a card rather than falling back to the CPU.

The JAX driver's round-loop extensions are carried with its semantics:
``--sequential`` (every algorithm but Centralized), ``--participation``
(FedAvg, FedProx, FedAMW), ``--server_opt``/``--server_lr`` (FedAvg,
FedProx), ``--p_guard`` (FedAMW and FedAMW_OneShot, passed as an
argument: the port reads no ``FEDAMW_P_GUARD``; on the card kernel 2
applies it), ``--feature_dtype`` (the feature matrices stored in
bfloat16, float16 or float32; compute stays float32), ``--save_models
DIR`` (a checkpoint of each round-based algorithm's final state per
repeat, ``utils/checkpoint.py``'s pickle layout, with the
``feature_dtype`` marker and a defended run's ``reputation`` and
``defense_state``) and ``--resume``: after every
repeat the driver writes ``exp1_{dataset}.partial.pkl`` with the
finished repeats and the run's configuration signature, and
``--resume`` continues from it (a mismatched signature is an error); a
fresh run sets an earlier partial aside as ``.bak``. The observability
flags: ``--trace_dir DIR`` turns on the trace plane (``utils.trace``)
and the telemetry registry (``utils.telemetry``) for the run and writes
``DIR/exp1_{dataset}_trace.jsonl`` (one ``train_scan`` span per
round-based algorithm, one ``round`` record per round), a per-stage
summary on stdout, and, where the registry recorded points,
``DIR/exp1_{dataset}_telemetry.json`` (``TELEMETRY.v1``) with its
Prometheus rendering beside it (``.prom``); ``tools/obs_export.py``
converts both to OTLP. ``--profile DIR`` captures a ``torch.profiler``
trace of the whole run (CPU activity, and CUDA activity on the card)
into ``DIR/exp1_{dataset}.pt.trace.json``, a Chrome trace. Both are
written even when a repeat raises; neither enters the partial's
signature. The fault and defense flags: ``--faults SPEC``
(``fedcore.faults``; the plan's seed offset by the repeat, ``seed + t``)
and ``--robust_agg SPEC`` (``fedcore.robust``) go to FedAvg, FedProx and
FedAMW, as in the JAX driver; both are validated when the flags are
parsed, sign the partial pickle, and a fault and a defense report is
printed after each of those algorithms. The cohort plane:
``--cohort_shards S`` splits the client axis into ``S`` contiguous shards
and aggregates FedAvg, FedProx and FedAMW in two tiers
(``fedcore.hierarchy``); with ``--stream_cohort`` FedAvg and FedProx
stream their client shards from the host (``data.stream``) while FedAMW
stays in-graph sharded, as in the JAX driver. Both are validated when the
flags are parsed (the streamed surface's refusals included) and sign the
partial pickle. The client axis over ranks (``parallel``): ``--shard N``
spawns N local ranks (``parallel.spawn``: rank ``r`` on ``cuda:r`` with
NCCL, or on the CPU with gloo under ``--device cpu``), each holding a
block of the clients of a setup padded to a multiple of N
(``prepare_setup(client_multiple=N)``); ``--multihost`` makes this
process one rank of a group joined through ``--coordinator HOST:PORT``,
``--num_processes`` and ``--process_id`` (or the environment), with
``--shard`` defaulting to the world size. Only rank 0 writes the pickle,
the partial, the checkpoints, the trace and the telemetry; rank 0's
``--resume`` verdict is broadcast so every rank runs the same repeats.
``--model NAME`` trains any model of the zoo (``models.get_model``:
``linear``, ``mlp64``, ``mlp128x64``, ``conv8x16``, ...); a model other
than the linear one forces ``kernel_type="linear"`` (identity features)
and says so, as the JAX driver does, and the name signs the partial.
``--publish_every N`` (with ``--save_models DIR``) runs FedAvg, FedProx
and FedAMW in N-round segments, each resumed from the last one's state,
and publishes a servable checkpoint at every boundary,
``DIR/{dataset}_{algorithm}_repeat{t}/vNNNN`` — the train side of the
train->serve loop (``serving.CheckpointWatcher`` feeds a
``serving.ModelRegistry`` from it); the stitched metrics and so the
pickle are the unsegmented run's, bit for bit. It is refused where the
JAX driver refuses it, with its messages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .algorithms import ALGORITHMS, prepare_setup
from .algorithms.common import FEATURE_DTYPES
from .config import get_parameter
from .data import load_dataset
from .data.svmlight import is_regression
from .device import resolve_device
from .fedcore.aggregate import resolve_p_guard
from .fedcore.faults import FaultSpec
from .fedcore.hierarchy import MAX_COHORT_SHARDS
from .fedcore.robust import parse_robust_spec
from .fedcore.server_opt import SERVER_OPTS
from .models import get_model
from .ops.rff import heterogeneity_from_parts
from .parallel import initialize_multihost, make_mesh, shard_setup, spawn
from .utils import telemetry as telemetry_mod
from .utils import trace as trace_mod
from .utils.checkpoint import save_checkpoint
from .utils.reporting import (format_defense_report, format_fault_report,
                              format_trace_summary)

NAMES = ["CL", "DL", "FedAMW_OneShot", "FedAvg", "FedProx", "FedAMW"]
# the driver's round-based algorithms: checkpointed by --save_models,
# segmented by --publish_every
ROUND_BASED = ("FedAvg", "FedProx", "FedAMW")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fedamw_tpu_torch.exp",
        description="FedAMW experiment driver (PyTorch + CUDA port)")
    ap.add_argument("--dataset", type=str, default="satimage")
    ap.add_argument("--D", type=int, default=2000)
    ap.add_argument("--num_partitions", type=int, default=50)
    ap.add_argument("--local_epoch", type=int, default=2)
    ap.add_argument("--round", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_repeats", type=int, default=1)
    ap.add_argument("--alpha_Dirk", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--data_dir", type=str, default="datasets")
    ap.add_argument("--result_dir", type=str, default="./results")
    ap.add_argument("--lr_mode", type=str, default="reference",
                    choices=["reference", "paper", "constant"])
    ap.add_argument("--verbose", action="store_true",
                    help="print each round's train loss, test loss and "
                         "accuracy (reference tools.py:236)")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the registry's learning rate")
    ap.add_argument("--lr_p", type=float, default=None,
                    help="override the registry's mixture-weight learning "
                         "rate (FedAMW's p-solver)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--sequential", action="store_true",
                    help="the reference's client-contamination chain: "
                         "client j+1 starts from client j's weights")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-round Bernoulli client sampling for FedAvg, "
                         "FedProx and FedAMW (FedAMW's p-solve runs "
                         "masked over the present clients)")
    ap.add_argument("--server_opt", type=str, default="none",
                    choices=list(SERVER_OPTS),
                    help="FedOpt server optimizer on the pseudo-gradient "
                         "for FedAvg/FedProx (none = the reference's "
                         "overwrite rule)")
    ap.add_argument("--server_lr", type=float, default=1.0)
    ap.add_argument("--p_guard", type=str, default="none",
                    metavar="none|simplex|clip[:R]",
                    help="opt-in mixture-weight guard for FedAMW and "
                         "FedAMW_OneShot (projected SGD on p); default "
                         "keeps the reference's unconstrained update")
    ap.add_argument("--feature_dtype", type=str, default=None,
                    choices=list(FEATURE_DTYPES),
                    help="store the mapped feature matrices in this dtype "
                         "(the dominant device resident halves at 2 "
                         "bytes; compute stays float32); the name is kept "
                         "in --save_models checkpoints")
    ap.add_argument("--faults", type=str, default=None, metavar="SPEC",
                    help="deterministic per-round fault injection for "
                         "FedAvg/FedProx/FedAMW — 'drop=0.1,straggle=0.2:"
                         "0.5,corrupt=0.05:nan,lie=0.1:0.01,seed=7' "
                         "(fedcore.faults; rates per kind, straggle takes "
                         "an update fraction, corrupt a mode "
                         "nan|inf|sign|scale[:S], lie a falsely REPORTED "
                         "work fraction — the FedNova tau inflation "
                         "attack the rep defense clamps). The plan seed "
                         "is offset per repeat; per-round fault and "
                         "quarantine counts are reported after each "
                         "algorithm")
    ap.add_argument("--robust_agg", type=str, default="mean",
                    metavar="mean|median|trim:K|krum|mkrum:M|geomed[:T]"
                            "|clip:R|quarantine:Z|auto"
                            "|rep[:decay[:floor]][+...]",
                    help="robust aggregation for FedAvg/FedProx/FedAMW "
                         "(fedcore.robust) — non-finite reports are "
                         "always quarantined under faults; this adds norm "
                         "clipping, z-score quarantine of finite outliers "
                         "(quarantine:Z, or quarantine:auto to tune Z from "
                         "the observed clean-round z distribution), "
                         "cross-round per-client reputation "
                         "(rep[:decay[:floor]]: directional + norm "
                         "evidence EWMA, soft down-weighting, hard gating "
                         "below the floor, trust-bounded work fractions), "
                         "and/or a Byzantine-robust reduction "
                         "(coordinate-wise trimmed mean/median, "
                         "krum/multi-Krum, geometric median) in place of "
                         "the weighted average; defense telemetry (with "
                         "reputation trajectories) is reported after each "
                         "algorithm")
    ap.add_argument("--save_models", type=str, default=None, metavar="DIR",
                    help="checkpoint each round-based algorithm's final "
                         "weights, p and optimizer state under "
                         "DIR/{dataset}_{algorithm}_repeat{t}")
    ap.add_argument("--publish_every", type=int, default=0, metavar="N",
                    help="(requires --save_models) run the round-based "
                         "algorithms in N-round segments and publish a "
                         "model checkpoint at every boundary "
                         "(DIR/{dataset}_{algo}_repeatT/vNNNN) — the "
                         "train side of the online train->serve loop: "
                         "each version is ingestible by "
                         "serving.ModelRegistry. 0 = one checkpoint at "
                         "the end")
    ap.add_argument("--resume", action="store_true",
                    help="load exp1_{dataset}.partial.pkl (written after "
                         "every completed repeat) and skip the finished "
                         "repeats; a partial written under another "
                         "configuration is an error")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run to DIR "
                         "(a Chrome trace; CUDA activity on the card)")
    ap.add_argument("--trace_dir", type=str, default=None, metavar="DIR",
                    help="emit per-round trace span records (utils.trace "
                         "JSONL; one train_scan span per round-based "
                         "algorithm run + one round record per round) to "
                         "DIR/exp1_{dataset}_trace.jsonl and the telemetry "
                         "registry's dump beside it, with a per-stage "
                         "summary printed at the end")
    ap.add_argument("--cohort_shards", type=int, default=0, metavar="S",
                    help="split the client axis into S contiguous shards "
                         "and aggregate in two tiers (fedcore.hierarchy): "
                         "per-shard partial sums folded globally; "
                         "aggregates match the flat run to float "
                         "tolerance, quarantine and gating decisions are "
                         "bitwise the same. 0 = the flat round")
    ap.add_argument("--stream_cohort", action="store_true",
                    help="(requires --cohort_shards) stream the client "
                         "shards host->device double-buffered "
                         "(data.stream.CohortShardStream), one shard tier "
                         "per shard, so cohort size is bounded by host "
                         "memory, not the card's. FedAvg/FedProx run "
                         "streamed; FedAMW stays in-graph sharded (its "
                         "p-solve needs every client's logits). Supports "
                         "the mean-family defenses (clip:R, quarantine:Z), "
                         "whose evidence is shard-local")
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="split the client axis over N local ranks (one "
                         "spawned process each: cuda:r with NCCL, or the "
                         "CPU with gloo under --device cpu); the setup is "
                         "padded to a multiple of N with inert clients. "
                         "0 = one process")
    ap.add_argument("--multihost", action="store_true",
                    help="make this process one rank of a multi-process "
                         "group (parallel.initialize_multihost); launch "
                         "the SAME command on every rank; --shard defaults "
                         "to the world size")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="the rendezvous HOST:PORT of --multihost (rank 0 "
                         "hosts it); omitted, it comes from the "
                         "environment (MASTER_ADDR, MASTER_PORT)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--model", type=str, default="linear",
                    help="any zoo member (linear | mlp64 | mlp128x64 | "
                         "conv8x16 ...; models.get_model): every algorithm "
                         "runs it unchanged. A model other than the linear "
                         "one forces kernel_type='linear' (identity "
                         "features: RFF-mapped features are not raw "
                         "inputs; conv also needs square images)")
    args = ap.parse_args(argv)
    try:  # validated here, not after hours of repeats
        resolve_p_guard(args.p_guard)
        if args.faults is not None:
            FaultSpec.parse(args.faults)
        spec = parse_robust_spec(args.robust_agg)
        get_model(args.model)
    except ValueError as e:
        ap.error(str(e))
    _check_cohort_flags(ap, args, spec)
    _check_publish_flags(ap, args)
    _check_rank_flags(ap, args)
    return args


def _check_publish_flags(ap, args) -> None:
    """``--publish_every`` refused where the JAX driver refuses it
    (``exp.py:311-337``), with its messages. The JAX driver's refusal of
    a non-JAX backend has no counterpart here."""
    if not args.publish_every:
        return
    if args.publish_every < 0:
        ap.error(f"--publish_every must be >= 0, got {args.publish_every}")
    if not args.save_models:
        ap.error("--publish_every needs --save_models DIR: the "
                 "published versions ARE checkpoints under it")
    if args.multihost:
        ap.error("--publish_every is single-host for now (the "
                 "publisher is the serving loop's feeder; "
                 "multihost runs write checkpoints once at the "
                 "end)")
    if args.faults is not None or args.robust_agg != "mean":
        ap.error("--publish_every currently composes with the "
                 "clean path only: the per-round fault/defense "
                 "telemetry is not stitched across segments yet "
                 "(use --resume for preemption durability of "
                 "defended runs)")
    if args.resume:
        ap.error("--publish_every and --resume do not compose: "
                 "segmented runs already checkpoint every N "
                 "rounds; resume from the newest vNNNN instead")


def _check_rank_flags(ap, args) -> None:
    """``--shard``/``--multihost`` refused where the JAX driver refuses them
    (``exp.py:214-224,337-346``)."""
    if args.shard < 0:
        ap.error(f"--shard must be >= 0, got {args.shard}")
    if args.shard and args.sequential:
        ap.error("--shard is incompatible with --sequential: the "
                 "reference's contamination chain threads one model "
                 "through every client in order, which is serial by "
                 "construction")
    if args.multihost and args.sequential:
        ap.error("--multihost is incompatible with --sequential (the "
                 "contamination chain is serial by construction; it "
                 "cannot shard over hosts)")


def _check_cohort_flags(ap, args, spec) -> None:
    """The cohort plane's flags, refused at the flag boundary as the JAX
    driver refuses them (``exp.py:262-310``), not mid-run after earlier
    algorithms finished."""
    if args.cohort_shards < 0:
        ap.error(f"--cohort_shards must be >= 0, got {args.cohort_shards}")
    if not args.stream_cohort:
        return
    if not args.cohort_shards:
        ap.error("--stream_cohort needs --cohort_shards S >= 1 (the "
                 "host->device shard size is the streaming knob)")
    if args.sequential:
        ap.error("--stream_cohort is incompatible with --sequential (the "
                 "contamination chain is serial by construction; shards "
                 "stream independently)")
    if args.participation < 1.0:
        ap.error("--stream_cohort does not support --participation < 1 "
                 "yet; model dropout through --faults drop= instead")
    if args.server_opt != "none":
        ap.error("--stream_cohort does not compose with --server_opt yet")
    if args.publish_every:
        ap.error("--stream_cohort does not support segmented "
                 "--publish_every runs yet")
    if args.cohort_shards > MAX_COHORT_SHARDS:
        ap.error(f"--stream_cohort --cohort_shards {args.cohort_shards}: "
                 f"FedAMW falls back to in-graph sharding (its p-solve "
                 f"needs global logits), which caps at MAX_COHORT_SHARDS="
                 f"{MAX_COHORT_SHARDS}; use <= {MAX_COHORT_SHARDS} shards, "
                 "or drive the streamed algorithms alone through their "
                 "entry points")
    if spec.agg != "mean" or spec.rep_decay is not None or spec.zscore_auto:
        ap.error(f"--stream_cohort supports the mean-family defenses "
                 f"(clip:R, quarantine:Z); --robust_agg "
                 f"{args.robust_agg!r} needs global statistics — use "
                 "in-graph --cohort_shards without --stream_cohort")


def _task_type(dataset: str, params: dict) -> str:
    """The dataset's task by the data layer's rule
    (``data/datasets.py``): the regression name list wins over the
    registry, whose default block says 'classification'."""
    return "regression" if is_regression(dataset) else params["task_type"]


def run_paper_algorithms(setup, *, rounds, local_epoch, batch_size, seed, lr,
                         lr_p, lr_p_os, mu, lam, lam_os, lr_mode="reference",
                         verbose=False, sequential=False, participation=1.0,
                         server_opt="none", server_lr=1.0, p_guard="none",
                         faults=None, robust_agg="mean", cohort_shards=0,
                         stream_cohort=False, return_state=False,
                         round_algo=None):
    """The six algorithms of one repeat in the driver's row order
    (``NAMES``), with ``exp.py``'s arguments (``exp.py:813-914``): the
    extensions go where the JAX driver sends them (module docstring);
    ``faults`` and ``robust_agg`` to FedAvg, FedProx and FedAMW;
    ``cohort_shards`` to the same three, ``stream_cohort`` to FedAvg and
    FedProx only (``exp.py:855-869``). ``round_algo(fn, name, **kw)``
    runs the three round-based algorithms in place of ``fn(setup,
    **kw)`` (``--publish_every``'s segmented loop, ``_run_segmented``).
    Returns ``[(name, result, wall_seconds), ...]``; each result has come
    back to the host, so its seconds include the device's work."""
    common = dict(batch_size=batch_size, seed=seed, sequential=sequential)
    long_epoch = local_epoch * rounds
    round_common = dict(common, epoch=local_epoch, round=rounds,
                        lr_mode=lr_mode, verbose=verbose,
                        participation=participation,
                        return_state=return_state, faults=faults,
                        robust_agg=robust_agg)
    round_common["cohort_shards"] = cohort_shards
    fixed = dict(round_common, server_opt=server_opt, server_lr=server_lr,
                 stream_cohort=stream_cohort)
    calls = [
        ("CL", "Centralized", dict(common, lr=lr, epoch=long_epoch)),
        ("DL", "Distributed", dict(common, lr=lr, epoch=long_epoch)),
        ("FedAMW_OneShot", "FedAMW_OneShot",
         dict(common, lr=lr, epoch=long_epoch, lambda_reg_if=True,
              lambda_reg=lam_os, round=rounds, lr_p=lr_p_os,
              p_guard=p_guard)),
        ("FedAvg", "FedAvg", dict(fixed, lr=lr)),
        ("FedProx", "FedProx", dict(fixed, lr=lr, prox=True, mu=mu)),
        ("FedAMW", "FedAMW", dict(round_common, lr=lr, lambda_reg_if=True,
                                  lambda_reg=lam, lr_p=lr_p,
                                  p_guard=p_guard)),
    ]
    out = []
    for name, algo, kw in calls:
        t0 = time.perf_counter()
        if round_algo is not None and algo in ROUND_BASED:
            res = round_algo(ALGORITHMS[algo], name, **kw)
        else:
            res = ALGORITHMS[algo](setup, **kw)
        out.append((name, res, time.perf_counter() - t0))
    return out


def resume_config(args) -> dict:
    """The configuration a partial result file is valid under: every flag
    that shapes a repeat's trajectory, with the JAX driver's keys
    (``exp.py:581-612``) for the flags this driver takes. ``backend``
    names this package, so a partial of the JAX driver (other random
    streams) is never continued here, nor the reverse. The guard is
    canonical (``clip`` is ``clip:1.0``); ``feature_dtype`` is None for
    float32 features unasked, as in the JAX driver's partials; the device
    is left out, as the JAX driver leaves out ``--shard``."""
    guard = resolve_p_guard(args.p_guard)
    if guard.startswith("clip"):
        guard = f"clip:{float(guard.split(':', 1)[1]) if ':' in guard else 1.0}"
    cfg = {k: getattr(args, k) for k in (
        "dataset", "D", "num_partitions", "local_epoch", "round",
        "batch_size", "alpha_Dirk", "seed", "lr_mode", "sequential",
        "participation", "server_opt", "server_lr", "data_dir", "lr",
        "lr_p")}
    cfg.update(backend="fedamw_tpu_torch", model=args.model, p_guard=guard,
               feature_dtype=args.feature_dtype, faults=args.faults,
               robust_agg=args.robust_agg,
               cohort_shards=args.cohort_shards,
               stream_cohort=args.stream_cohort)
    return cfg


def _resume_start(args, partial_path, mats, hete, mesh=None) -> int:
    """Where the repeat loop starts (``_load_partial``). Over ranks rank 0
    alone reads and moves the partial, and its verdict (the start, or a
    refused signature, which exits every rank with status 2) is broadcast
    so every rank runs the same repeats (JAX ``exp.py:615-680``); only
    rank 0's matrices, which it alone writes, hold the loaded repeats."""
    if mesh is None:
        return _load_partial(args, partial_path, mats, hete)
    verdict = [0, False]
    if mesh.rank == 0:
        try:
            verdict[0] = _load_partial(args, partial_path, mats, hete)
        except SystemExit:
            verdict[1] = True
    dist.broadcast_object_list(verdict, src=0)
    if verdict[1]:
        raise SystemExit(2)
    return verdict[0]


def _load_partial(args, partial_path, mats, hete) -> int:
    """Where the repeat loop starts (JAX ``exp.py:615-665``): under
    ``--resume`` the finished repeats of a partial with this run's
    signature are copied into ``mats``/``hete``; a partial under another
    signature exits with status 2; without ``--resume`` an existing
    partial is moved aside to a fresh ``.bak`` name."""
    if not args.resume and os.path.exists(partial_path):
        bak, n = partial_path + ".bak", 1
        while os.path.exists(bak):
            n += 1
            bak = f"{partial_path}.bak{n}"
        os.replace(partial_path, bak)
        print(f"warning: {partial_path} exists from an earlier "
              "(interrupted?) run but --resume was not given; moved it "
              f"to {bak} so this fresh run cannot clobber that "
              "progress", file=sys.stderr)
        return 0
    if not args.resume:
        return 0
    if not os.path.exists(partial_path):
        print(f"--resume: no partial file at {partial_path}; "
              "starting fresh")
        return 0
    with open(partial_path, "rb") as f:
        part = pickle.load(f)
    # a partial written before --model, --feature_dtype, --faults,
    # --robust_agg, --cohort_shards and --stream_cohort were carried is a
    # linear, float32, clean, mean-aggregated, flat run
    saved = {"model": "linear", "feature_dtype": None, "faults": None,
             "robust_agg": "mean", "cohort_shards": 0,
             "stream_cohort": False, **part["config"]}
    if saved != resume_config(args):
        print(f"--resume: {partial_path} was written under a "
              f"different configuration\n  saved: {saved}\n"
              f"  now:   {resume_config(args)}\nRemove the partial "
              "file to start over.", file=sys.stderr)
        raise SystemExit(2)
    k = min(int(part["done"]), args.n_repeats)
    for key, mat in zip(("train_loss", "test_loss", "test_acc"), mats):
        mat[:, :, :k] = part[key][:, :, :k]
    hete[:k] = part["heterogeneity"][:k]
    print(f"--resume: {k} completed repeat(s) loaded from "
          f"{partial_path}; continuing at repeat {k}")
    return k


def _ckpt_extra(res) -> dict:
    """The checkpoint ``extra`` of one round-based result (JAX
    ``exp.py:682-692``): the optimizer state that makes a resume exact
    and the final evaluation accuracy the serving rollout's parity gate
    checks against."""
    extra = {k: res[k] for k in ("p_opt", "server_opt", "server_opt_kind")
             if k in res}
    extra["eval_acc"] = float(np.asarray(res["test_acc"])[-1])
    return extra


def _write_checkpoint(path, res, round_idx, rff, feature_dtype) -> str:
    """One round-based result's state under ``path``: the weights, p, the
    round, ``_ckpt_extra``, the RFF draw (serving takes raw rows), the
    ``feature_dtype`` marker and the defense state (``reputation``,
    ``zq``) — ONE writer for ``--save_models`` and every
    ``--publish_every`` boundary, so the two cannot drift."""
    return save_checkpoint(
        path, res["params"], p=res["p"], round_idx=round_idx,
        extra=_ckpt_extra(res), rff=rff, feature_dtype=feature_dtype,
        reputation=res.get("reputation"),
        defense_state={"zq": res["zq"]} if "zq" in res else None)


def _save_models(args, setup, name, res, t) -> None:
    """``--save_models``: one round-based algorithm's final state (JAX
    ``exp.py:927-960``)."""
    where = _write_checkpoint(
        os.path.join(args.save_models, f"{args.dataset}_{name}_repeat{t}"),
        res, args.round, setup.rff, args.feature_dtype)
    print(f"{name}: checkpoint -> {where}")


def _run_segmented(algo_fn, name, setup, publish_every, R, rff,
                   feat_dtype, save_dir, dataset, repeat, writer=True,
                   **kwargs):
    """``--publish_every``: one round-based algorithm as a PUBLISHING
    round loop (JAX ``exp.py:695-750``) — N-round segments, a checkpoint
    at every boundary (``DIR/{dataset}_{name}_repeat{T}/vNNNN``, rank 0's
    alone over ranks). Segment k resumes from segment k-1's returned
    state (params, p, optimizer state, reputation, zq), and every
    per-round stream is drawn for the whole horizon and sliced, so the
    stitched metrics are the uninterrupted run's."""
    kwargs = dict(kwargs)
    kwargs.pop("round", None)
    kwargs.pop("return_state", None)
    base = os.path.join(save_dir, f"{dataset}_{name}_repeat{repeat}")
    state = None
    chunks = []
    res = None
    for k0 in range(0, R, publish_every):
        k1 = min(R, k0 + publish_every)
        res = algo_fn(setup, round=R, start_round=k0, stop_round=k1,
                      resume_from=state, return_state=True, **kwargs)
        # only the per-round metric streams of each segment are kept
        chunks.append({k: np.asarray(res[k]) for k in
                       ("train_loss", "test_loss", "test_acc")})
        state = {k: res[k] for k in ("params", "p", "p_opt",
                                     "server_opt", "server_opt_kind",
                                     "reputation", "zq") if k in res}
        final_path = os.path.join(base, f"v{k1:04d}")
        if writer:
            where = _write_checkpoint(final_path, res, k1, rff, feat_dtype)
            print(f"{name}: published round-{k1} model -> {where}")
    out = dict(res)
    for key in ("train_loss", "test_loss", "test_acc"):
        out[key] = np.concatenate([c[key] for c in chunks])
    # where the last boundary's (== final) checkpoint lives
    out["published_final"] = final_path
    return out


def _start_profiler(device):
    """``--profile``: a started ``torch.profiler`` capture of the whole
    run, with CUDA activity when the run is on the card. A profiler that
    cannot start raises: the run was asked to be profiled."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _write_trace(args) -> None:
    """``--trace_dir``: the run's spans as ``TRACE.v1`` JSONL, their
    per-stage summary, and the telemetry registry's ``TELEMETRY.v1`` dump
    and Prometheus rendering where it recorded points (JAX
    ``exp.py:440-473``)."""
    tracer = trace_mod.get_tracer()
    os.makedirs(args.trace_dir, exist_ok=True)
    tpath = os.path.join(args.trace_dir, f"exp1_{args.dataset}_trace.jsonl")
    n_spans = tracer.export_jsonl(tpath)
    print(format_trace_summary(f"exp1_{args.dataset}", tracer.records()))
    print(f"trace ({n_spans} spans) -> {tpath}")
    reg = telemetry_mod.get_registry()
    if reg.points_recorded():
        mpath = os.path.join(args.trace_dir,
                             f"exp1_{args.dataset}_telemetry.json")
        with open(mpath, "w") as f:
            json.dump(reg.dump(), f)
        with open(mpath[:-len(".json")] + ".prom", "w") as f:
            f.write(telemetry_mod.render_prometheus(reg))
        print(f"telemetry ({len(reg.instruments())} series, "
              f"{reg.points_recorded()} points) -> {mpath} (+ .prom)")


def main(argv=None) -> str:
    """Run the experiment and write its pickle; returns the pickle's
    path.

    ``--trace_dir`` installs a fresh process-global tracer and registry
    for the run and puts the disabled tracer back when it ends, so a
    process that calls ``main`` again, traced or not, starts clean.
    ``--shard N`` runs the experiment on N spawned ranks and returns when
    they are done; ``--multihost`` runs this process's rank, leaving the
    process group as it found it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.multihost:
        return _multihost_main(args)
    if args.shard:
        device = resolve_device(args.device)
        if (device.type == "cuda"
                and args.shard > torch.cuda.device_count()):
            raise ValueError(f"requested {args.shard} devices, have "
                             f"{torch.cuda.device_count()}")
        spawn(_rank_main, args.shard, device, (argv,))
        return os.path.join(args.result_dir, f"exp1_{args.dataset}.pkl")
    return _run(args)


def _rank_main(rank, argv) -> None:
    """One spawned rank of ``--shard N`` (``parallel.spawn`` has joined
    the group)."""
    args = parse_args(argv)
    _run(args, make_mesh(args.shard, device=args.device))


def _multihost_main(args) -> str:
    """``--multihost``: join the group as one rank (JAX ``exp.py:375-390``)
    and run the experiment over the mesh of ``--shard`` ranks."""
    joined = not dist.is_initialized()
    n_global = initialize_multihost(args.coordinator, args.num_processes,
                                    args.process_id, device=args.device)
    try:
        if args.shard == 0:
            args.shard = n_global
        print(f"multihost: process {dist.get_rank()}/{n_global}, "
              f"{n_global} global devices, --shard {args.shard}")
        return _run(args, make_mesh(args.shard, device=args.device))
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, mesh=None) -> str:
    """The experiment on one process: the whole client axis, or over
    ranks (``mesh``) this rank's block of it, rank 0 the only writer."""
    writer = mesh is None or mesh.rank == 0
    device = resolve_device(args.device) if mesh is None else mesh.device
    params = get_parameter(args.dataset)
    lr = params["lr"] if args.lr is None else args.lr
    lr_p = params.get("lr_p", 1e-3) if args.lr_p is None else args.lr_p
    R = args.round
    train_mat = np.empty((6, R, args.n_repeats))
    error_mat = np.empty((6, R, args.n_repeats))
    acc_mat = np.empty((6, R, args.n_repeats))
    hete = np.empty(args.n_repeats)
    partial_path = os.path.join(args.result_dir,
                                f"exp1_{args.dataset}.partial.pkl")
    start = _resume_start(args, partial_path,
                          (train_mat, error_mat, acc_mat), hete, mesh)
    if args.trace_dir:
        trace_mod.configure()
        telemetry_mod.reset_registry()
    prof = None
    try:
        if args.profile and writer:
            prof = _start_profiler(device)
        _run_repeats(args, device, params, lr, lr_p, start, partial_path,
                     (train_mat, error_mat, acc_mat), hete, mesh)
    finally:
        # written even when a repeat raises: the trace of a failing run is
        # the one you want most
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.profile, f"exp1_{args.dataset}.pt.trace.json"))
            print(f"profiler trace -> {args.profile}")
        if args.trace_dir:
            try:
                if writer:
                    _write_trace(args)
            finally:
                trace_mod.configure(False)

    data_ = {
        "epochs": R,
        "train_loss": train_mat,
        "test_loss": error_mat,
        "test_acc": acc_mat,
        "heterogeneity": hete,
        "name": list(NAMES),
        "task": _task_type(args.dataset, params),
    }
    out = os.path.join(args.result_dir, f"exp1_{args.dataset}.pkl")
    if not writer:
        return out
    os.makedirs(args.result_dir, exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(data_, f)
    print(f"results -> {out}")
    # the partial is kept: it carries the configuration signature the
    # result pickle cannot, so a later --resume with a larger
    # --n_repeats extends the experiment
    return out


def _run_repeats(args, device, params, lr, lr_p, start, partial_path, mats,
                 hete, mesh=None) -> None:
    """Repeats ``start .. n_repeats - 1``: each one's data, setup,
    heterogeneity and six algorithms into ``mats``/``hete``, then the
    partial pickle that ``--resume`` reads (rank 0's alone over ranks,
    whose setups are padded to a multiple of the ranks and split)."""
    writer = mesh is None or mesh.rank == 0
    train_mat, error_mat, acc_mat = mats
    R = args.round
    kernel_type = params["kernel_type"]
    if args.model != "linear":
        # the zoo's deeper models consume raw features — the RFF map
        # exists to linearize the kernel for the single-matrix model
        if kernel_type != "linear":
            print(f"--model {args.model}: forcing kernel_type='linear' "
                  "(identity features; the registry's RFF map serves "
                  "the linear flagship)")
        kernel_type = "linear"
    for t in range(start, args.n_repeats):
        rng = np.random.RandomState(args.seed + t)
        ds = load_dataset(args.dataset, args.num_partitions, args.alpha_Dirk,
                          data_dir=args.data_dir, rng=rng, verbose=True)
        setup = prepare_setup(ds, D=args.D, kernel_par=params["kernel_par"],
                              kernel_type=kernel_type, model=args.model,
                              seed=args.seed + t, rng=rng, device=device,
                              feature_dtype=FEATURE_DTYPES.get(
                                  args.feature_dtype),
                              client_multiple=1 if mesh is None
                              else mesh.size)
        if mesh is not None:
            setup = shard_setup(setup, mesh)
            if t == start:
                print(f"client axis split over {mesh.size} ranks "
                      f"({dist.get_backend()}, this rank {mesh.rank} on "
                      f"{device})")
        # on the FULL partitions, before the validation split
        # (reference exp.py:66-76)
        hete[t] = heterogeneity_from_parts(setup.X, ds.parts)
        print(f"[repeat {t}] data heterogeneity: {hete[t]:.4f}")
        faults = None
        if args.faults is not None:
            # repeats see independent fault draws, deterministically
            spec = FaultSpec.parse(args.faults)
            faults = dataclasses.replace(spec, seed=spec.seed + t)
        if args.cohort_shards and t == 0:
            print(f"cohort plane: FedAvg/FedProx stream {args.cohort_shards} "
                  "client shards host->device; FedAMW runs in-graph sharded"
                  if args.stream_cohort else
                  "cohort plane: in-graph two-tier aggregation over "
                  f"{args.cohort_shards} client shards")
        round_algo = None
        if args.publish_every:
            def round_algo(fn, name, **kw):
                return _run_segmented(
                    fn, name, setup, args.publish_every, R, setup.rff,
                    args.feature_dtype, args.save_models, args.dataset, t,
                    writer=writer, **kw)
        t0 = time.perf_counter()
        runs = run_paper_algorithms(
            setup, rounds=R, local_epoch=args.local_epoch,
            batch_size=args.batch_size, seed=args.seed + t, lr=lr,
            lr_p=lr_p, lr_p_os=params.get("lr_p_os", lr_p),
            mu=params["lambda_prox"], lam=params["lambda_reg"],
            lam_os=params.get("lambda_reg_os", params["lambda_reg"]),
            lr_mode=args.lr_mode, verbose=args.verbose,
            sequential=args.sequential, participation=args.participation,
            server_opt=args.server_opt, server_lr=args.server_lr,
            p_guard=args.p_guard, faults=faults, robust_agg=args.robust_agg,
            cohort_shards=args.cohort_shards,
            stream_cohort=args.stream_cohort,
            return_state=bool(args.save_models), round_algo=round_algo)
        for row, (name, res, secs) in enumerate(runs):
            train_mat[row, :, t] = res["train_loss"]
            error_mat[row, :, t] = res["test_loss"]
            acc_mat[row, :, t] = res["test_acc"]
            print(f"{name}: final acc {np.ravel(res['test_acc'])[-1]:.2f} "
                  f"({secs:.2f} s)")
            if "fault_counts" in res:
                print(format_fault_report(name, res["fault_counts"]))
            if "defense" in res:
                print(format_defense_report(name, res["defense"]))
            if "params" in res and writer and "published_final" in res:
                # the final state IS the last published version
                print(f"{name}: final model already published -> "
                      f"{res['published_final']}")
            elif "params" in res and writer:
                _save_models(args, setup, name, res, t)
        print(f"[repeat {t}] wall time {time.perf_counter() - t0:.1f}s "
              f"(device={device})")
        if not writer:
            continue
        # every finished repeat is recoverable through --resume (each
        # repeat reseeds from seed + t, so skipping finished ones is exact)
        os.makedirs(args.result_dir, exist_ok=True)
        tmp = partial_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"config": resume_config(args), "done": t + 1,
                         "train_loss": train_mat[:, :, :t + 1].copy(),
                         "test_loss": error_mat[:, :, :t + 1].copy(),
                         "test_acc": acc_mat[:, :, :t + 1].copy(),
                         "heterogeneity": hete[:t + 1].copy()}, f)
        os.replace(tmp, partial_path)


if __name__ == "__main__":
    main()
