#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``fedamw_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per
library, all at once: kernel 1 once per row type), holds each kernel
against its plain PyTorch version on the card at the main path's shapes
(kernel 1 also at Centralized's one-client shape and with bfloat16 and
float16 rows; kernel 2 also on its split plan at J = 400, 1000 and 4096,
and with each p-guard on each plan), and drives the paper's experiment
through the public
entry points on the mnist-shaped data (60000 x 784 -> RFF D=2000, 10
classes, J=50 clients, Dirichlet alpha 0.01, the registry's
hyper-parameters), every launch counter reset just before each algorithm
and read just after:

- ``main_path``: FedAvg and FedAMW, 3 rounds of 2 local epochs at a
  constant lr, each held against the same run through the plain versions
  on the card (same seed, so the same init and shuffles; FedAMW's
  per-round ``mixture`` record too) and required to learn; FedAvg's
  FLOPs per client-update and achieved GFLOP/s by ``bench.py``'s
  definition, with the counting basis;
- ``paper_algorithms``: Centralized, Distributed, FedAMW_OneShot (one
  local phase of 6 epochs) and FedNova (3 rounds), each held against its
  plain run and its launch counts checked, with Centralized's launch
  shape (``centralized_plan``: cluster, steps, time per step, spills,
  time at every cluster size);
- ``driver``: ``fedamw_tpu_torch.exp.main`` at R=3, its pickle checked
  against ``exp.py``'s schema;
- ``observability``: the driver again at R=3 with ``--trace_dir``, then
  with ``--trace_dir --profile``, each pickle bitwise the untraced one;
  the trace's spans (3 ``train_scan``, 9 ``round`` under them), the
  telemetry dump's ``fed_p_entropy`` points, the profile read by
  ``utils.telemetry.parse_profiler_trace`` (busy seconds, GPU events
  against the launch counters, the trace's event categories);
  ``attribute_device_time`` over one FedAMW round (it must read the
  profiler); FedAMW's ``analyze_memory`` at the main configuration; the
  three driver runs' seconds;
- ``options``: the round loop's options at the main configuration, 2
  rounds (3 where a run is split), each held against its plain run and
  its launches counted by kernel: FedAvg ``sequential=True`` (one J = 1
  launch per client and epoch), FedAMW on 4 size buckets (one launch per
  bucket and epoch), FedAMW at ``participation=0.5`` (absent clients end
  every round with p exactly 0), FedAvg with ``server_opt="adam"`` and
  FedProx with ``"yogi"``, FedAMW split at round 2 through a checkpoint
  (bitwise the uninterrupted run) and the driver's ``--resume`` (a
  one-repeat run continued to two, bitwise the uninterrupted two-repeat
  pickle); FedAMW with ``p_guard="simplex"`` (the guard in kernel 2's
  epilogue; p required on the simplex) and FedAMW at 400 partitions
  (kernel 2's split plan);
- ``faults``: the fault and defense planes at the main configuration,
  ``OPT_ROUNDS`` rounds a case, each against its plain run with every
  verdict (fault counts, z-quarantines, reputation gates, clamped work
  fractions, krum selections) required equal (the margins printed where
  one differs) and its launches counted by kernel: FedAvg with drops,
  stragglers and NaN reports under ``mean``; FedNova with lying clients
  under ``rep``; FedAMW under ``quarantine:auto+rep`` (kernel 2 over a
  ``cv`` that changes every round, recorded in a replay); FedAMW with
  drops and the simplex guard; FedAvg under ``clip:R+median`` (R the
  median delta norm of the first round's clean updates), ``trim:5``,
  ``mkrum:10`` and ``geomed:8``; FedAMW with ``krum``; the defended
  FedAMW run split at round 1 through a checkpoint with its defense
  state (bitwise); the driver with ``--faults`` and ``--robust_agg``
  (reports and pickle); then a clean FedAMW round beside the defended
  one and the host synchronisations of each
  (``torch.cuda.set_sync_debug_mode``);
- ``cohort``: the cohort plane. (a) In-graph ``cohort_shards`` at S = 1,
  5 and 50 for FedAvg, FedNova and FedAMW under drops, NaN reports and
  ``quarantine:3``, ``OPT_ROUNDS`` rounds, each against its plain run and
  against the flat kernel run: every verdict and ``shard_present`` equal,
  the aggregate at ``TOL_RUN``, the launches by kernel the flat run's, and
  no library built or loaded across S; (b) FedAMW under
  ``quarantine:auto+rep`` at S = 5 split at round 1 through a checkpoint
  (bitwise); (c) streamed FedAvg and FedNova at S = 5 and the defended
  streamed FedAvg (``clip:R+quarantine:3`` against 25x attackers), each
  against its plain run, one kernel 1 launch per shard and epoch; (d) the
  driver at R=3 with ``--cohort_shards 5 --stream_cohort`` (its launches
  counted); (e) the 1M-client streamed round of ``scale_bench.py``'s
  cohort leg (J = 1,000,000 padded to 256 shards of 3,907, 2 samples a
  client, D=16, C=10, one epoch, drops, 25x attackers, ``quarantine:5``),
  built directly with the features on the card and the client rows on
  the host: its time, client-updates/s, the allocator's peak above the
  round's entry (against the cohort's stacked weights), the compute
  stream's wait on shard copies, and the round against its plain run;
- ``ranks``: the client axis over ranks (``parallel``). (a) FedAvg and
  FedAMW at the main configuration on a one-rank NCCL group
  (``initialize_multihost``, ``make_mesh(1)``, ``shard_setup``), bitwise
  the ungrouped kernel runs with the same launches by kernel, round ms
  beside the ungrouped run's and the ``all_reduce``/``all_gather`` ms a
  round (CUDA events around each collective; NCCL's communicator built
  and timed first); (b) the driver at R=3 with
  ``--shard 1`` (one spawned rank) and ``--multihost --num_processes 1
  --process_id 0``, each pickle bitwise the ``driver`` phase's; (c) two
  ranks sharing the card in a gloo group, J/2 clients each, FedAvg,
  FedAMW, FedAMW under drops, NaN reports and ``quarantine:3+krum``, and
  FedAvg streamed at S = 10 (each rank streams its 5 shards), each
  within ``TOL_RUN`` of the single-process run with every verdict equal
  and the two ranks bitwise equal, kernel 1's cluster size on each rank
  ((c) runs last, after ``paper_run``);
- ``feature_dtype``: FedAvg and FedAMW on the main configuration with the
  features stored in bfloat16 (kernel 1 reads 2-byte rows), 3 rounds,
  each against its plain run, round ms beside the float32 main path's
  and the feature matrices' bytes;
- ``wide_d``: kernel 1's wide plan, the main configuration mapped to
  D = 10,000 (past the staged kernel's 5,376 at C = 10): the kernel
  against its plain version at J = 50 with float32 rows (the registry's
  and the strong penalties) and bfloat16 rows, at the reference
  tolerances, two launches bitwise equal; FedAvg and FedAMW 2 rounds of
  2 local epochs and Centralized 2 epochs (J = 1), each against its plain
  run at ``TOL_RUN``, counted, every kernel-1 launch the wide kernel's;
- ``many_classes``: more than 32 classes, on a stand-in of LIBSVM's
  ``sector`` (6,412 + 3,207 rows, 55,197 raw features, 105 classes, 160
  non-zeros a row, written from ``SEED``; the registry's default block)
  parsed by the native parser, at the main configuration: kernel 1's
  class-tiled wide plan against its plain version at C = 33 and 105 (the
  registry's and the strong penalties), C = 1,000, C = 105 at
  D = 10,000 and with bfloat16 and float16 rows, and the tie case (every
  logit equal: the first maximum class 0), two launches bitwise each,
  and at C = 105 and 1,000 forced at every cluster the card takes;
  every instantiation of the class-tiled kernel without spills; kernel
  2's class-tiled split plan at C = 53, 105 and 1,000, unguarded and with
  the simplex guard, the tie case and J = 400 at C = 1,000 (streaming
  tiles of clients), bitwise on repeat, its time on its class-split
  logits at each cluster of six shapes and against the unstaged kernel
  in turns at six (C = 33–105), its ptxas report (no spill); FedAvg,
  FedAMW (2 rounds) and Centralized (2 epochs) on the stand-in against
  their plain runs, every launch on a tiled plan; the driver with ``--dataset sector`` in
  a subprocess; the four ``classes_*`` rows of the ``kernels`` line
  (``client_epoch.classes_*``: ``ms_by_cluster``, the plan's layout,
  registers and spills of the instantiation each row type launches;
  ``classes_105``'s ``ms_forced_c32``: the instantiated and the
  class-tiled wide kernel forced at 32 classes, in turns, the former's
  plan and its 0 spills);
- ``profile``: the device shuffle draw of one round alone
  (``draw_ms_per_round``, CUDA events), then one profiled FedAMW run
  (device time by kernel, the device's busy share of the wall time,
  printed beside ``attribute_device_time``'s compute fraction);
- the ``kernels`` line: each kernel timed beside its plain version and
  its bound. ``client_epoch``'s entry also shows its critical path: the
  largest client's non-empty steps (``steps_max``), ``us_per_step``, the
  launch plan's ``cluster`` size, the compiler's ``spill_bytes`` for the
  instantiation that runs (it must be 0), and its time at every cluster
  size that fits (``ms_by_cluster``). ``p_epoch``'s entry shows its
  serial steps (``steps``, ``us_per_step``), the launch plan (``plan``:
  the staged kernel on the main path, which the counted runs must have
  launched), the staged kernel's registers and ``spill_bytes`` (it must
  be 0), and the staged and the unstaged kernel timed on the same inputs
  (``ms_by_plan``: staged, split and unstaged at J = 50); rows of their
  own for the split plan (J = 400, C = 10, and J = 4096, C = 2; at each
  split shape its ``us_per_step``, ratio to the byte bound, ring (tile,
  stages, warps), registers and spills, which must be 0, and
  ``ms_by_cluster``, each size forced, in turns), the
  guarded epochs (clip and simplex at J = 50 and 400, with the simplex's
  fixed-point rounds per step), kernel 1's bfloat16 rows
  (``ms_by_dtype`` beside float32 and float16 at the main shape and at
  Centralized's) and kernel 1's wide plan at ``wide_d``'s shape
  (``client_epoch.wide``: ``us_per_step``, the plan's cluster, chunk,
  ring and shared memory, spills, the byte bound, ``ms_by_cluster``, the
  kernel forced at each cluster the card takes in turns at J = 50 and at
  Centralized's J = 1, ``ms_bfloat16`` and ``ms_boundary``, the staged
  and the forced wide plan in turns at D = 5,376; a ``wide_d`` line of
  its own gives the bytes a CTA moves a step by the layout's arithmetic
  and every wide instantiation's registers and spills), each launch
  count from the run of its own path; a
  ``p_solve_100_epochs_ms`` line times ``make_p_solver``'s solve over 100
  epochs (the p-solve of one round of the paper's 100-round run);
- ``paper_run``: the driver's six algorithms at the paper's length (100
  rounds of 2 local epochs, one repeat), each one's wall seconds beside
  the card's name and power limit, with no plain reference;
- ``zoo``: the model zoo at ``scale_bench.py``'s widths, built by the
  port's own data layer from seeds. (a) ``covtype_1024``: mlp64 on the
  464,809 x 54, 7-class stand-in over 1024 Dirichlet(0.1) clients; (b)
  ``mnist_conv_512``: conv8x16 on the 60,000 x 784, 10-class stand-in
  over 512 clients. FedAvg and FedAMW (lr 0.1, 2 local epochs, batch 32,
  2 rounds; FedAMW at the JAX defaults with the simplex p-guard)
  against their plain runs: round ms, client-updates/s, the
  allocator's peak above each run's entry, launches by kernel (kernel 1
  never: the zoo trains by autograd; kernel 2 twice a round on its
  split plan), the client FLOPs a client-update with their basis and the
  achieved GFLOP/s, whether test accuracy rises; kernel 2 at each
  configuration's shape against its plain version and its bound (its
  ``by_shape`` cells in the ``p_epoch.split`` row); (b)'s autograd step
  of all 512 clients (grouped convolutions) against the same step client
  by client; (c) the driver with ``--model conv8x16`` and ``--model
  mlp64x32`` on the mnist stand-in at R=2 and one local epoch, the
  zoo's lr and p-guard (``(6, R, 1)`` pickles, the
  forced ``kernel_type`` printed, launches counted); (d) FedAMW on (a)'s
  mlp64 under drops and NaN reports with ``quarantine:3+krum``, 2 rounds,
  every verdict equal to its plain run's. Its launches are
  ``launches_by_path.zoo`` in the ``kernels`` line.
- ``serve``: serving on the card (``fedamw_tpu_torch.serving``; no
  kernel of its own: the forward is ``rff_map`` and the model's
  ``apply``). (a) FedAMW's ``main_path`` checkpoint with its RFF draw,
  ``ServingEngine.load`` on the default ladder (1, 8, 64, 512, 4096)
  serving raw 784-wide rows: ``warmup()`` 5 and ``compile_count`` 5
  throughout; the logits of every test row against ``model.apply`` on
  the evaluator's features (bitwise, or within ``TOL_SERVE`` with the
  same argmax, the largest difference reported) and the accuracy against
  ``fedcore.make_evaluator``'s exactly; padding inert and a chunked
  request its parts, bitwise; per rung p50/p99 (``LatencyHistogram``),
  rows/s and ``pop_timings``' pad/dispatch split; ``device_attribution``
  of the middle rung (it must read the profiler). (b) ``ServingService``
  in continuous mode: 2,000 requests of 1..4,096 rows from 4 threads,
  every future against ``predict`` of its rows, no shed, no retry,
  p50/p99, requests/s, rows/s and the queue/pad/device split. (c) the
  driver at R=3 with ``--save_models --publish_every 1`` (pickle bitwise
  the ``driver`` phase's; its launches are ``launches_by_path.serve`` in
  the ``kernels`` line), a ``CheckpointWatcher`` publishing
  v0001..v0003 into a ``ModelRegistry``, three ``swap_weights`` under
  live traffic with ``compile_count`` flat (swap p50), a
  ``RolloutController`` shadow stage promoted, a sign-flipped candidate
  rolled back by the parity gate. (d) ``zoo`` (a)'s mlp64 and (b)'s
  conv8x16 FedAvg weights served as in (a).
- ``fleet``: the rest of the serving plane on the card, on (a)'s
  checkpoint (after ``serve``; no kernel of its own, its launches
  ``launches_by_path.fleet``, 0 expected). (a) the ladder exported
  (``serving.export_ladder``: one ``torch.export`` program a rung) and
  cold-started by ``ServingEngine.from_artifact`` in a freshly spawned
  process: load seconds beside ``ServingEngine.load`` + ``warmup`` of the
  checkpoint in that process, ``compile_count`` 0, the two engines'
  logits bitwise at every rung and pad position; a manifest field and a
  ``.pt2`` rewritten in two copies, each refused with
  ``ArtifactIncompatible``. (b) a hedged round-robin ``FailoverRouter``
  over 4 ``Replica``s of one engine behind ``ServingService`` under a
  scripted ``ChaosPlan`` (``FLEET_CHAOS``: a kill, two 50 ms wedges,
  flaky and slow cells, every one required to fire), 1,000 mixed
  requests from 4 threads with 8 in flight each: requests/s, rows/s,
  p50/p99, failovers, hedges, kills and retries by replica, every answer
  within ``TOL_SERVE`` of ``predict`` with the argmax equal and every
  unanswered request a typed router outcome. (c) two ``worker_main``
  processes spawned on the card from (a)'s artifact, ``SocketTransport``
  replicas and a ``PodClientEngine`` behind the router: dispatch p50
  over the socket against in process at rungs 64 and 4096 and the bytes
  on the wire, one ``swap_weights`` announce of FedAvg's weights under
  one version, then 300 requests with worker 0 SIGKILLed at its 20th
  dispatch, every request answered by the survivor within its deadline.
  (d) a ``LadderLearner`` on (b)'s request sizes, its proposal applied
  through ``install_rung`` on a fresh engine: pad waste of the fixed
  ladder against the learned one, ``compile_count`` up by exactly the
  rungs installed.

- ``scenario``: the scenario plane (``fedamw_tpu_torch.scenario``) with
  the oracle's train leg on the card (``PropertyOracle(device="cuda")``;
  the serve leg is host threads and loopback sockets, as in the JAX
  package). (a) every ``campaigns/regressions/*.json`` replayed clean;
  (b) ``run_campaign`` at ``CAMPAIGN_r16.json``'s seed and budget and (c)
  ``run_search`` at ``CAMPAIGN_r18.json``'s, each equal to the committed
  artifact in digest and verdicts ((c) in coverage too); (d) each of
  (b)'s scenarios' train-leg model on the card against the CPU oracle's
  (within 1e-6); (e) each injectable harness bug caught on the card and
  shrunk to the CPU's minimal spec. The seconds of each part; launches
  0 (``launches_by_path.scenario``).
- ``torch_ref``: the plain PyTorch reference backend
  (``registry.get_backend("torch")``) at the main configuration on the
  card and on the CPU: FedAvg and FedAMW at ``main_path``'s cut, the
  one-shot algorithms one local phase of 2 epochs, FedProx and FedNova
  one round; each card run within ``TOL_RUN`` of its CPU run (the same
  CPU generators' draws), FedAvg's test loss falling every round, the
  seconds of each beside ``main_path``'s final accuracy; launches 0
  (``launches_by_path.torch_ref``).
- ``tune``: the tuning loop and the export CLI through their module
  entry points at the main configuration's width. (a) ``python -m
  fedamw_tpu_torch.tune --dataset mnist --round 20 --lr_p 0.001
  --lambda_reg 5e-6`` in a subprocess, the same parameters through
  ``tune.main`` in process (the printed line equal) and FedAMW called
  directly on a setup built by hand with the trial's arguments (within
  ``TOL_RUN``, bitwise or not reported); (b) ``sweep.run_sweep("mnist",
  trials=4, rounds=10, seed=7)`` and its report parsed back; (c)
  ``python -m fedamw_tpu_torch.export_artifacts`` on ``main_path``'s
  FedAMW checkpoint with ``--check`` (``compile_count`` 0, bitwise),
  then the artifact serving rung 4096 bitwise as the engine. A trial of
  R rounds launches kernel 1 2R times and kernel 2 R*R times
  (``launches_by_path.tune``: (a)'s two in-process runs and (b)'s four
  trials).

Output is one JSON object per line; the line before the last lists the
kernels; the last line is the contract line ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that line. Without a CUDA
card it exits 1 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

SEED = 100                 # the JAX package's experiment seed (exp.py)
J, D, ROUNDS, EPOCHS, B, VB = 50, 2000, 3, 2, 32, 16
PAPER_ROUNDS = 100         # the paper's run length (exp.py --round)
OPT_ROUNDS = 2             # rounds of an options case
MANY_CLIENTS = 400         # more clients than one CTA of kernel 2 holds at C=10
# kernel 2's split plan: (J, C) past one CTA (B = VB, the main n_val)
SPLIT_SHAPES = ((MANY_CLIENTS, 10), (1000, 26), (4096, 2))
GUARDS = ("clip", "clip:0.5", "simplex")
# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# kernel vs plain tolerances: tests/test_pallas_kernel.py (kernel 1) and
# tests/test_pallas_psolver.py (kernel 2) — both kernels run full fp32
TOL_W = dict(atol=2e-5, rtol=1e-5)
TOL_P = dict(atol=2e-6, rtol=2e-5)
# main path vs the same run on the plain versions: per-round losses to
# 1e-4 relative, accuracy to 0.05 points (~8 of 15000 test rows), final
# weights to 1e-4 — three rounds of lr 0.5 SGD and 9 p-epochs carry the
# summation-order differences of the per-step tolerances above
TOL_RUN = dict(loss_rtol=1e-4, acc_atol=0.05, w_atol=1e-4)
# points of test accuracy above the largest class share a 3-round run
# must reach (PERF.md, section 5, says why this configuration learns slowly)
ACC_MARGIN = 1.5


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def close(a, b, atol, rtol):
    """(ok, max abs err) of a against b under |a-b| <= atol + rtol*|b|."""
    err = (a - b).abs()
    return bool((err <= atol + rtol * b.abs()).all()), float(err.max())


def counts():
    """Launches of both wrappers since their last reset, in all and by
    kernel."""
    from fedamw_tpu_torch.fedcore import client_epoch, p_epoch

    return {"client_epoch": client_epoch.launches,
            "p_epoch": p_epoch.launches,
            "client_epoch_by_kernel": dict(client_epoch.launches_by_kernel),
            "p_epoch_by_kernel": dict(p_epoch.launches_by_kernel)}


def reset_counts():
    from fedamw_tpu_torch.fedcore import epoch_kernel, psolver_kernel

    epoch_kernel.reset_counts()
    psolver_kernel.reset_counts()


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def options(ds, setup, prm, kw, amw_kw, timed, vs_plain, card):
    """The ``options`` phase: each case is run on the plain versions and
    then counted on the kernels (counts reset just before, read just
    after), held against its plain run at ``TOL_RUN``, and its launches
    checked, by kernel where a case names the p-epoch kernel it must run
    (the guard in the staged kernel's epilogue, 400 clients on the split
    plan)."""
    import numpy as np
    import torch

    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.algorithms import (
        FedAMW, FedAvg, FedProx, prepare_setup)
    from fedamw_tpu_torch.algorithms.core import round_seed
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.utils import load_checkpoint, save_checkpoint

    dev = setup.device
    R2 = OPT_ROUNDS
    base = dict(kw, round=R2)
    amw = dict(amw_kw, round=R2)

    def build(**opts):
        t0 = time.perf_counter()
        s = prepare_setup(opts.pop("ds", ds), D=D,
                          kernel_par=prm["kernel_par"], seed=SEED,
                          rng=np.random.RandomState(SEED), **opts)
        return s, time.perf_counter() - t0

    bucketed, bucket_s = build(buckets=4)
    many_ds = load_dataset("mnist", num_partitions=MANY_CLIENTS,
                           alpha=prm["alpha_Dirk"])
    many, many_s = build(ds=many_ds)
    emit({"phase": "options_setup", "buckets": {
        "n_maxes": list(bucketed.n_maxes),
        "clients": list(bucketed.bucket_counts), "seconds": bucket_s},
        "many_clients": {"J": many.num_clients, "n_max": many.n_max,
                         "seconds": many_s}})

    # name, algorithm, setup, keywords, expected client_epoch and
    # p_epoch launches (and, where named, the kernel every p-epoch runs)
    cases = [
        ("FedAvg sequential", FedAvg, setup, dict(base, sequential=True),
         (R2 * J * EPOCHS, 0)),
        ("FedAMW buckets=4", FedAMW, bucketed, amw,
         (R2 * 4 * EPOCHS, R2 * R2)),
        ("FedAMW participation=0.5", FedAMW, setup,
         dict(amw, participation=0.5), (R2 * EPOCHS, R2 * R2)),
        ("FedAvg server_opt=adam", FedAvg, setup,
         dict(base, server_opt="adam", server_lr=0.01), (R2 * EPOCHS, 0)),
        ("FedProx server_opt=yogi", FedProx, setup,
         dict(base, mu=prm["lambda_prox"], server_opt="yogi",
              server_lr=0.01), (R2 * EPOCHS, 0)),
        ("FedAMW resume", FedAMW, setup, dict(amw_kw, round=3),
         (3 * EPOCHS, 9)),
        ("FedAMW p_guard=simplex", FedAMW, setup,
         dict(amw, p_guard="simplex"), (R2 * EPOCHS, R2 * R2, "staged")),
        (f"FedAMW num_partitions={MANY_CLIENTS}", FedAMW, many, amw,
         (R2 * EPOCHS, R2 * R2, "split")),
    ]
    runs, launched = {}, {}
    for name, fn, s, fkw, want in cases:
        ref, plain_secs = timed(fn, s, kernel_impl="plain", **fkw)
        reset_counts()
        res, secs = timed(fn, s, **fkw)
        c = counts()
        runs[name], launched[name] = res, c
        got = (c["client_epoch"], c["p_epoch"])
        ok, diffs = vs_plain(res, ref)
        p = res["p"]
        row = {"phase": "options", "case": name, "card": card,
               "seconds": secs, "seconds_plain": plain_secs,
               "round_ms": 1e3 * secs / len(res["test_loss"]),
               "round_ms_plain": 1e3 * plain_secs / len(ref["test_loss"]),
               "launches": c, "expected": {
                   "client_epoch": want[0], "p_epoch": want[1]},
               "test_acc": res["test_acc"].tolist(),
               "test_loss": res["test_loss"].tolist(),
               "p_sum": float(p.sum()), "p_min": float(p.min()),
               "vs_plain": diffs, "tol": TOL_RUN, "ok": ok}
        if len(want) > 2:
            # every p-epoch of the run went through the named kernel: none
            # took a plain route on the card
            row["p_epoch_kernel"] = want[2]
            row["p_epochs_not_on_it"] = want[1] - c["p_epoch_by_kernel"][
                want[2]]
            ok = ok and row["p_epochs_not_on_it"] == 0
        if "simplex" in name:
            ok = ok and float(p.min()) >= 0 and abs(float(p.sum()) - 1) <= 1e-5
        row["ok"] = ok
        emit(row)
        if not ok:
            fail(f"options case {name!r} does not match its plain run, or "
                 f"its p-epochs did not all run {want[2:]}, or its guarded "
                 f"p is off the simplex: {diffs}, {c}")
        if got != want[:2]:
            fail(f"options case {name!r} launched {c}, expected {want}")

    # partial participation, round by round: absent clients end every
    # round with p exactly 0, and the replay is the counted run bitwise
    valid = (setup.sizes > 0).to(torch.float32)
    state, absent_p, n_absent = None, [], []
    for t in range(R2):
        r = FedAMW(setup, **dict(amw, participation=0.5), start_round=t,
                   stop_round=t + 1, resume_from=state)
        drawn = torch.rand(valid.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(round_seed(SEED + 2, t))) < 0.5
        absent = (valid * drawn) == 0
        n_absent.append(int(absent.sum()))
        absent_p.append(float(r["p"][absent].abs().max()))
        state = {k: r[k] for k in ("params", "p", "p_opt")}
    same = (torch.equal(state["p"], runs["FedAMW participation=0.5"]["p"])
            and torch.equal(state["params"]["w"],
                            runs["FedAMW participation=0.5"]["params"]["w"]))
    emit({"phase": "options", "case": "participation by round",
          "absent_clients": n_absent, "max_abs_p_absent": absent_p,
          "replay_bitwise": same, "ok": same and not any(absent_p)})
    if any(absent_p) or not same:
        fail(f"participation: absent clients' p {absent_p}, replay "
             f"bitwise {same}")

    # round resume through a checkpoint: rounds [0, 2), saved and loaded
    # through utils/checkpoint.py, then [2, 3): the uninterrupted run
    full = runs["FedAMW resume"]
    rkw = dict(amw_kw, round=3)
    first = FedAMW(setup, **rkw, stop_round=2)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, first["params"], p=first["p"], round_idx=2,
                        extra={"p_opt": first["p_opt"]})
        second = FedAMW(setup, **rkw, start_round=2,
                        resume_from=load_checkpoint(tmp))
    split_ok = (all(np.array_equal(np.concatenate([first[k], second[k]]),
                                   full[k])
                    for k in ("train_loss", "test_loss", "test_acc"))
                and torch.equal(second["params"]["w"], full["params"]["w"])
                and torch.equal(second["p"], full["p"])
                and torch.equal(second["p_opt"][0], full["p_opt"][0]))
    emit({"phase": "options", "case": "resume split at round 2",
          "bitwise": split_ok, "ok": split_ok})
    if not split_ok:
        fail("a FedAMW run split at round 2 through a checkpoint is not "
             "the uninterrupted run bit for bit")

    # the driver's --resume: one repeat, then continued to two, against
    # an uninterrupted two-repeat run
    def drive(out, *extra):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            path = exp.main(["--dataset", "mnist", "--round", str(ROUNDS),
                             "--seed", str(SEED), "--result_dir", out,
                             *extra])
        with open(path, "rb") as f:
            return pickle.load(f)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        whole = drive(os.path.join(tmp, "whole"), "--n_repeats", "2")
        drive(os.path.join(tmp, "split"), "--n_repeats", "1")
        resumed = drive(os.path.join(tmp, "split"), "--n_repeats", "2",
                        "--resume")
    drv_ok = set(whole) == set(resumed) and all(
        np.array_equal(whole[k], resumed[k]) if isinstance(whole[k],
                                                           np.ndarray)
        else whole[k] == resumed[k] for k in whole)
    emit({"phase": "options", "case": "driver --resume",
          "seconds": time.perf_counter() - t0, "repeats": 2,
          "bitwise": drv_ok, "ok": drv_ok})
    if not drv_ok:
        fail("the driver's --resume pickle is not the uninterrupted "
             "two-repeat run's")
    return launched


# the fault and defense phase: case 1's faults (the non-finite quarantine
# alone under "mean") and the defended FedAMW spec of cases 3 and 7
FAULTS = "drop=0.1,straggle=0.2:0.5,corrupt=0.05:nan,seed=7"
DEFENDED = "quarantine:auto+rep:0.5:0.2"
VERDICTS = ("z_quarantined", "rep_gated", "frac_clamped", "krum_selected")
# the defense's floats against the plain run (the relative loss tolerance,
# with an absolute floor for the entries near 0)
TOL_DEFENSE = dict(rtol=TOL_RUN["loss_rtol"], atol=1e-5)


def verdicts(res):
    """A run's verdicts: its fault counts and the defense's decisions."""
    import numpy as np

    out = {f"fault_counts.{k}": np.asarray(v).tolist()
           for k, v in res.get("fault_counts", {}).items()}
    d = res.get("defense", {})
    out.update({k: np.asarray(d[k]).tolist() for k in VERDICTS if k in d})
    return out


def krum_margins(fn, s, fkw):
    """Every krum/mkrum selection of a run with the scores it ranked (the
    summed squared distances to the q closest present peers), from a
    replay with ``krum_select`` recorded."""
    import torch

    from fedamw_tpu_torch.algorithms import core
    from fedamw_tpu_torch.fedcore import robust

    seen, real = [], robust.krum_select

    def record(params, stacked, present, m):
        x = robust._flat_deltas(params, stacked)
        sq = (x * x).sum(1)
        d2 = (sq[:, None] + sq[None, :] - 2 * x @ x.T).clamp(min=0)
        pb = present > 0
        eye = torch.eye(len(sq), dtype=torch.bool, device=x.device)
        d2 = torch.where(pb[:, None] & pb[None, :] & ~eye, d2, float("inf"))
        n = int(present.sum())
        q = max(1, min(n - max((n - 3) // 2, 0) - 2, len(sq) - 1))
        seen.append(torch.sort(d2, 1).values[:, :q].sum(1).tolist())
        return real(params, stacked, present, m)

    core.krum_select = robust.krum_select = record
    try:
        fn(s, **fkw)
    finally:
        core.krum_select = robust.krum_select = real
    return seen


def faults(ds, setup, prm, kw, amw_kw, timed, vs_plain, card):
    """The ``faults`` phase: the fault and defense planes at the main
    configuration, ``OPT_ROUNDS`` rounds per case, each case run on the
    plain versions and then counted on the kernels (counts reset just
    before, read just after), its floats held at ``TOL_RUN`` and every
    verdict (fault counts, z-quarantines, reputation gates, clamped work
    fractions, krum selections) required equal, the margins printed where
    one differs. Then the defense's cost (a clean FedAMW round beside case
    3's, in turns) and the host synchronisations of each. Returns the
    phase's launches."""
    import traceback
    import warnings

    import numpy as np
    import torch

    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.algorithms import FedAMW, FedAvg, FedNova
    from fedamw_tpu_torch.algorithms.core import (
        _init_params, _round_generator)
    from fedamw_tpu_torch.fedcore import aggregate as agg_mod
    from fedamw_tpu_torch.fedcore import make_bucketed_round
    from fedamw_tpu_torch.fedcore.robust import client_delta_norms
    from fedamw_tpu_torch.utils import load_checkpoint, save_checkpoint

    R2 = OPT_ROUNDS
    base = dict(kw, round=R2, faults=FAULTS)
    amw = dict(amw_kw, round=R2)
    valid = setup.sizes > 0

    # case 5's clip radius: the median delta norm of case 1's first round's
    # clean client updates (the local epochs before any fault)
    round_fn = make_bucketed_round(setup.task, EPOCHS, B, setup.n_maxes,
                                   False, "auto")
    params0 = _init_params(setup, SEED, None)
    idx_t, mask_t = setup.round_arrays()
    stacked, _, _ = round_fn(params0, setup.X, setup.y, idx_t, mask_t,
                             _round_generator(setup, SEED, 0),
                             float(prm["lr"]), 0.0, 0.0)
    radius = float(client_delta_norms(params0, stacked)[valid].median())

    # name, algorithm, keywords, the p-epoch kernel every p-epoch must run
    cases = [
        ("1 FedAvg faults, mean", FedAvg, base, None),
        ("2 FedNova lie, rep", FedNova,
         dict(kw, round=R2, faults="lie=0.1:0.01,seed=7",
              robust_agg="rep:0.5:0.2"), None),
        ("3 FedAMW faults, auto+rep", FedAMW,
         dict(amw, faults=FAULTS, robust_agg=DEFENDED), "staged"),
        ("4 FedAMW drop, simplex", FedAMW,
         dict(amw, faults="drop=0.2,seed=3", p_guard="simplex"), "staged"),
        ("5 FedAvg clip+median", FedAvg,
         dict(base, robust_agg=f"clip:{radius}+median"), None),
        ("5 FedAvg trim:5", FedAvg, dict(base, robust_agg="trim:5"), None),
        ("5 FedAvg mkrum:10", FedAvg, dict(base, robust_agg="mkrum:10"),
         None),
        ("5 FedAvg geomed:8", FedAvg, dict(base, robust_agg="geomed:8"),
         None),
        ("6 FedAMW krum", FedAMW, dict(amw, robust_agg="krum"), "staged"),
    ]
    runs, launched = {}, {"client_epoch": 0, "p_epoch": 0}
    for name, fn, fkw, kern in cases:
        ref, plain_secs = timed(fn, kernel_impl="plain", **fkw)
        reset_counts()
        res, secs = timed(fn, **fkw)
        c = counts()
        runs[name] = res
        for k in launched:
            launched[k] += c[k]
        want = (R2 * EPOCHS, R2 * R2 if fn is FedAMW else 0)
        ok, diffs = vs_plain(res, ref)
        d, dr = res.get("defense", {}), ref.get("defense", {})
        for k in ("z_max", "z_threshold", "reputation", "geomed_residual"):
            if k in dr:
                a, b = np.asarray(d[k]), np.asarray(dr[k])
                diffs[f"max_abs_{k}"] = float(np.max(np.abs(a - b)))
                ok = ok and bool(np.allclose(a, b, **TOL_DEFENSE))
        vk, vp = verdicts(res), verdicts(ref)
        row = {"phase": "faults", "case": name, "card": card,
               "robust_agg": fkw.get("robust_agg", "mean"),
               "faults": fkw.get("faults"),
               "round_ms": 1e3 * secs / R2,
               "round_ms_plain": 1e3 * plain_secs / R2, "launches": c,
               "expected": {"client_epoch": want[0], "p_epoch": want[1]},
               "verdict_totals": {k: int(np.sum(v)) for k, v in vk.items()},
               "verdicts_equal": vk == vp,
               "test_acc": res["test_acc"].tolist(), "vs_plain": diffs,
               "tol": TOL_RUN, "tol_defense": TOL_DEFENSE, "ok": ok}
        if "clip" in name:
            row["clip_radius"] = radius
        if kern is not None:
            row["p_epochs_not_on_" + kern] = (
                c["p_epoch"] - c["p_epoch_by_kernel"][kern])
            ok = ok and row["p_epochs_not_on_" + kern] == 0
        if "simplex" in name:
            p = res["p"]
            row["p_sum"], row["p_min"] = float(p.sum()), float(p.min())
            ok = ok and float(p.min()) >= 0 and abs(float(p.sum()) - 1) <= 1e-5
        if "6 FedAMW krum" in name:
            row["krum_selected_per_round"] = np.sum(
                d["krum_selected"], axis=1).tolist()
            ok = ok and row["krum_selected_per_round"] == [1] * R2
        row["ok"] = ok
        if vk != vp:
            # the margins of the verdicts that differ: z against its
            # threshold, reputation against the floor, krum's scores
            row["margins"] = {
                "kernels": {k: np.asarray(d[k]).tolist() for k in (
                    "z_max", "z_threshold", "reputation") if k in d},
                "plain": {k: np.asarray(dr[k]).tolist() for k in (
                    "z_max", "z_threshold", "reputation") if k in dr}}
            if "krum_selected" in d:
                row["margins"]["krum_scores"] = {
                    "kernels": krum_margins(fn, setup, fkw),
                    "plain": krum_margins(fn, setup,
                                          dict(fkw, kernel_impl="plain"))}
            row["verdicts"] = {"kernels": vk, "plain": vp}
        emit(row)
        if vk != vp:
            fail(f"faults case {name!r}: a verdict differs from the plain "
                 f"run's (margins above)")
        if not ok:
            fail(f"faults case {name!r} does not match its plain run or "
                 f"its checks: {diffs}")
        if (c["client_epoch"], c["p_epoch"]) != want:
            fail(f"faults case {name!r} launched {c}, expected {want}")

    # case 3's p-solve: kernel 2 with a cv that changes over the rounds,
    # zeros among the live clients (drops, quarantines, gates), recorded
    # in a replay whose launches are not counted
    c3 = cases[2][2]
    cvs, real = [], agg_mod.p_epoch
    saved = counts()

    def record(p, buf, cv, *a, **k):
        cvs.append(cv.clone())
        return real(p, buf, cv, *a, **k)

    agg_mod.p_epoch = record
    try:
        FedAMW(setup, **c3)
    finally:
        agg_mod.p_epoch = real
    from fedamw_tpu_torch.fedcore import p_epoch
    p_epoch.launches = saved["p_epoch"]
    p_epoch.launches_by_kernel = saved["p_epoch_by_kernel"]
    per_round = [cv for cv in cvs[::R2]]
    masked_live = [int(((cv == 0) & valid).sum()) for cv in per_round]
    distinct = len({tuple(cv.tolist()) for cv in per_round})
    cv_ok = (len(cvs) == R2 * R2 and distinct == R2
             and all(m > 0 for m in masked_live))
    emit({"phase": "faults", "case": "3 kernel 2's cv by round",
          "p_epochs": len(cvs), "live_clients_masked": masked_live,
          "distinct_cv": distinct, "ok": cv_ok})
    if not cv_ok:
        fail(f"case 3 did not run kernel 2 over a cv that changes every "
             f"round with live clients masked: {masked_live}, {distinct}")

    # case 7: the defended FedAMW run split at round 1 through a
    # checkpoint with the defense state, against case 3's run
    full = runs[cases[2][0]]
    first = FedAMW(setup, **c3, stop_round=1)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, first["params"], p=first["p"], round_idx=1,
                        extra={"p_opt": first["p_opt"]},
                        reputation=first["reputation"],
                        defense_state={"zq": first["zq"]})
        second = FedAMW(setup, **c3, start_round=1,
                        resume_from=load_checkpoint(tmp))
    split_ok = (
        all(np.array_equal(np.concatenate([first[k], second[k]]), full[k])
            for k in ("train_loss", "test_loss", "test_acc"))
        and all(np.array_equal(np.concatenate(
            [first["defense"][k], second["defense"][k]]), full["defense"][k])
            for k in ("reputation", "z_threshold", "z_max"))
        and torch.equal(second["params"]["w"], full["params"]["w"])
        and torch.equal(second["p"], full["p"])
        and torch.equal(second["p_opt"][0], full["p_opt"][0])
        and np.array_equal(second["reputation"], full["reputation"])
        and np.array_equal(second["zq"], full["zq"]))
    emit({"phase": "faults", "case": "7 split at round 1, defended",
          "bitwise": split_ok, "ok": split_ok})
    if not split_ok:
        fail("the defended FedAMW run split at round 1 through a checkpoint "
             "is not the uninterrupted run bit for bit")

    # case 8: the driver with both flags
    log = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(log):
            path = exp.main(["--dataset", "mnist", "--round", str(ROUNDS),
                             "--seed", str(SEED), "--result_dir", tmp,
                             "--faults", FAULTS, "--robust_agg", DEFENDED])
        with open(path, "rb") as f:
            data = pickle.load(f)
    drv_secs = time.perf_counter() - t0
    text = log.getvalue()
    reports = {n: (text.count(f"\n{n} faults: "),
                   text.count(f"\n{n} defense [{DEFENDED}]"))
               for n in ("FedAvg", "FedProx", "FedAMW")}
    drv_ok = (all(v == (1, 1) for v in reports.values())
              and data["test_acc"].shape == (6, ROUNDS, 1)
              and bool(np.all(np.isfinite(data["test_loss"]))))
    emit({"phase": "faults", "case": "8 driver --faults --robust_agg",
          "seconds": drv_secs, "reports": reports,
          "report_lines": [ln for ln in text.splitlines()
                           if " faults: " in ln or " defense [" in ln],
          "final_acc": dict(zip(data["name"],
                                data["test_acc"][:, -1, 0].tolist())),
          "ok": drv_ok})
    if not drv_ok:
        fail(f"the driver's fault and defense reports or pickle: {reports}")

    # the defense's cost: a clean FedAMW round beside case 3's, in turns
    reads = {"clean": [], "defended": []}
    for which in ("clean", "defended", "defended", "clean"):
        _, secs = timed(FedAMW, **(amw if which == "clean" else c3))
        reads[which].append(1e3 * secs / R2)

    # where the defense's cost goes: device compute against the host's
    # dispatch of one round, each (torch.profiler, three calls)
    from fedamw_tpu_torch.utils.telemetry import attribute_device_time
    attr = {}
    for which, fkw in (("clean", amw), ("defended", c3)):
        attr[which] = attribute_device_time(
            lambda fkw=fkw: timed(FedAMW, **fkw, stop_round=1)[1], reps=3)

    # host synchronisations, by the sync debug mode: a whole one-round
    # call and the increment of a second round, each call after a warm-up
    # one; two turns, the fewer of each kept (a process's first counted
    # call may synchronise once more), every call site named
    def syncs(fkw, rounds):
        FedAMW(setup, **fkw, stop_round=rounds)
        torch.cuda.synchronize()
        hits = []

        def hook(message, *args, **kwargs):
            if "synchroniz" in str(message):
                frames = [f for f in traceback.extract_stack()[:-1]
                          if not f.filename.endswith("warnings.py")][-3:]
                hits.append(" < ".join(f"{os.path.basename(f.filename)}:"
                                       f"{f.lineno}" for f in frames[::-1]))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                FedAMW(setup, **fkw, stop_round=rounds)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return hits

    reads_sync = {"clean": [], "defended": []}
    for _ in range(2):
        for which, fkw in (("clean", amw), ("defended", c3)):
            reads_sync[which].append((syncs(fkw, 1), syncs(fkw, 2)))
    sync = {}
    for which, turns in reads_sync.items():
        one = min(len(a) for a, _ in turns)
        two = min(len(b) for _, b in turns)
        sync[which] = {"one_round_call": one, "per_round": two - one,
                       "counts": [[len(a), len(b)] for a, b in turns],
                       "sites": sorted({h for a, b in turns
                                        for h in a + b})}
    sync_ok = (sync["defended"]["one_round_call"]
               <= sync["clean"]["one_round_call"]
               and sync["defended"]["per_round"] <= sync["clean"]["per_round"])
    emit({"phase": "faults", "case": "defense cost", "card": card,
          "round_ms_clean": sum(reads["clean"]) / 2,
          "round_ms_defended": sum(reads["defended"]) / 2,
          "round_ms_readings": reads, "robust_agg": DEFENDED,
          "faults": FAULTS, "attribute_device_time": attr,
          "host_syncs": sync, "ok": sync_ok})
    if not sync_ok:
        fail(f"the defended FedAMW round adds host synchronisations: {sync}")
    return launched


# the cohort phase: in-graph shard counts (1, 5, one client a shard), the
# defended split run and the streamed cases, at the main configuration,
# then the 1M-client streamed round of scale_bench.py's cohort leg
COHORT_SHARDS = (1, 5, J)
COHORT_FAULTS = "drop=0.1,corrupt=0.05:nan,seed=7"
STREAM_SHARDS = 5
STREAM_FAULTS = "corrupt=0.2:scale:25,seed=2"
# scale_bench.py:246-283: J clients of 2 samples padded to a multiple of
# the shard count, D=16, C=10, batch 32, one local epoch, one round
MILLION = dict(clients=1_000_000, shards=256, k=2, D=16, C=10,
               faults="drop=0.01,corrupt=0.001:scale:25,seed=0",
               robust_agg="quarantine:5")


def cohort_verdicts(res):
    """``verdicts`` plus the per-shard present counts of the hierarchy
    record or the streamed record's present count per round."""
    import numpy as np

    out = verdicts(res)
    if "hierarchy" in res:
        out["shard_present"] = res["hierarchy"]["shard_present"].tolist()
    if "streamed" in res:
        out["present"] = np.asarray(res["streamed"]["present"]).tolist()
    return out


def million_client_round(card, vs_plain, dev):
    """Case (e): the streamed round at the 1M-client shape, built directly
    as ``scale_bench.py``'s ``cohort_stream`` builds it (the features,
    labels and test rows on the card, the client rows on the host), one
    warm-up round, then one counted round: its time, client-updates/s,
    the allocator's peak above the round's entry, the compute stream's
    wait on shard copies, and the round against its plain run."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.algorithms import FedAvg
    from fedamw_tpu_torch.algorithms import core
    from fedamw_tpu_torch.algorithms.common import FedSetup
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.models import get_model

    m = MILLION
    Jm, S, k, Dm, Cm = m["clients"], m["shards"], m["k"], m["D"], m["C"]
    t0 = time.perf_counter()
    N = Jm * k
    rng = np.random.RandomState(7)
    X = rng.randn(N, Dm).astype(np.float32)
    w_true = rng.randn(Dm, Cm).astype(np.float32)
    y = np.argmax(X @ w_true + 0.5 * rng.randn(N, Cm).astype(np.float32),
                  axis=1).astype(np.int32)
    n_eval = min(4096, N)
    J_pad = -(-Jm // S) * S
    idx = np.zeros((J_pad, k), np.int64)
    idx[:Jm] = np.arange(N, dtype=np.int64).reshape(Jm, k)
    mask = np.zeros((J_pad, k), np.float32)
    mask[:Jm] = 1.0
    sizes = np.zeros(J_pad, np.int32)
    sizes[:Jm] = k
    weights = (sizes.astype(np.float64) / sizes.sum()).astype(np.float32)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    setup = FedSetup(
        model=get_model("linear"), task="classification", num_classes=Cm,
        D=Dm, X=Xd, y=yd, X_test=Xd[:n_eval], y_test=yd[:n_eval],
        X_val=Xd[:256], y_val=yd[:256], idx=torch.from_numpy(idx),
        mask=torch.from_numpy(mask), sizes=torch.from_numpy(sizes),
        p_fixed=torch.from_numpy(weights))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(lr=0.2, epoch=1, batch_size=B, seed=0, lr_mode="constant",
              cohort_shards=S, stream_cohort=True, faults=m["faults"],
              robust_agg=m["robust_agg"], round=1, return_state=True)

    def run(**extra):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = FedAvg(setup, **kw, **extra)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    run()                                   # warm-up round
    tier = core._LAST_SHARD_TIER
    torch.cuda.synchronize()
    entry = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, secs = run()
    c = counts()
    peak = torch.cuda.max_memory_allocated() - entry
    wait_ms = core._LAST_STREAM.copy_wait_ms()
    memoized = tier is core._LAST_SHARD_TIER
    ref, plain_secs = run(kernel_impl="plain")
    ok, diffs = vs_plain(res, ref)
    vk, vp = cohort_verdicts(res), cohort_verdicts(ref)
    J_s = J_pad // S
    # one shard's streamed rows (idx int64, mask, sizes, p_fixed and the
    # five plan rows) and its stacked client weights
    shard_rows = J_s * (k * 8 + k * 4 + 4 + 4 + 5 * 4)
    shard_w = J_s * Cm * Dm * 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ek.launch_plan(J_s, B, Cm, Dm, sms)
    row = {"phase": "cohort", "case": "e 1M-client streamed round",
           "card": card, "clients": Jm, "padded_clients": J_pad,
           "shards": S, "shard_clients": J_s, "samples_per_client": k,
           "D": Dm, "C": Cm, "setup_seconds": setup_s,
           "round_seconds": secs, "round_seconds_plain": plain_secs,
           "client_updates_per_s": Jm / secs,
           "peak_alloc_bytes_above_entry": peak,
           "shard_rows_bytes": shard_rows, "shard_weights_bytes": shard_w,
           "cohort_weights_bytes": J_pad * Cm * Dm * 4,
           "copy_wait_ms": wait_ms, "launches": c,
           "expected": {"client_epoch": S, "p_epoch": 0},
           "kernel1_plan": dataclasses.asdict(plan),
           "fault_counts": {k2: int(np.sum(v))
                            for k2, v in res["fault_counts"].items()},
           "test_acc": res["test_acc"].tolist(),
           "verdicts_equal": vk == vp, "vs_plain": diffs, "tol": TOL_RUN,
           "tier_memoized": memoized}
    ok = (ok and vk == vp and c["client_epoch"] == S and c["p_epoch"] == 0
          and peak < J_pad * Cm * Dm * 4 and memoized)
    row["ok"] = ok
    emit(row)
    if not ok:
        fail(f"the 1M-client streamed round: launches {c}, peak {peak} B, "
             f"verdicts equal {vk == vp}, against its plain run {diffs}")
    return c


def cohort(setup, kw, amw_kw, timed, vs_plain, card):
    """The ``cohort`` phase: (a) in-graph ``cohort_shards`` at S = 1, 5
    and 50 for FedAvg, FedNova and FedAMW under the non-finite and z-score
    quarantines, each against its plain run and against the flat kernel
    run (every decision and ``shard_present`` equal, the aggregate at
    ``TOL_RUN``, the launches by kernel the flat run's, no library built
    across S); (b) the defended FedAMW run at S = 5 split at round 1
    through a checkpoint, bitwise; (c) streamed FedAvg and FedNova at S =
    5 and the defended streamed FedAvg, each against its plain run; (d)
    the driver with ``--cohort_shards 5 --stream_cohort``; (e) the
    1M-client streamed round. Counts are reset just before each counted
    run and read just after. Returns the phase's launches."""
    import numpy as np
    import torch

    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.algorithms import FedAMW, FedAvg, FedNova
    from fedamw_tpu_torch.algorithms.core import _init_params, _round_generator
    from fedamw_tpu_torch.fedcore import cuda_build, make_bucketed_round
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.robust import client_delta_norms
    from fedamw_tpu_torch.utils import load_checkpoint, save_checkpoint

    R2 = OPT_ROUNDS
    launched = {"client_epoch": 0, "p_epoch": 0}

    def counted(fn, **fkw):
        reset_counts()
        res, secs = timed(fn, **fkw)
        c = counts()
        for k in launched:
            launched[k] += c[k]
        return res, secs, c

    def libraries():
        return (sorted(p.name for p in cuda_build.BUILD_DIR.glob("*.so")),
                cuda_build.load.cache_info().currsize,
                ek._library.cache_info().currsize,
                pk._library.cache_info().currsize)

    # (a) in-graph shard counts against the flat kernel run; the libraries
    # loaded after each flat run must be those after its sharded runs
    libs = {}
    fkw_a = dict(faults=COHORT_FAULTS, robust_agg="quarantine:3")
    for name, fn, base in (("FedAvg", FedAvg, kw), ("FedNova", FedNova, kw),
                           ("FedAMW", FedAMW, amw_kw)):
        fkw = dict(base, round=R2, **fkw_a)
        flat, flat_secs, c_flat = counted(fn, **fkw)
        libs[name] = [libraries()]
        for S in COHORT_SHARDS:
            ref, plain_secs = timed(fn, kernel_impl="plain",
                                    cohort_shards=S, **fkw)
            res, secs, c = counted(fn, cohort_shards=S, **fkw)
            ok_p, d_plain = vs_plain(res, ref)
            ok_f, d_flat = vs_plain(res, flat)
            v, v_flat, v_plain = (cohort_verdicts(r)
                                  for r in (res, flat, ref))
            sp = np.asarray(v.pop("shard_present"))
            present_ok = (sp.shape == (R2, S) and v_plain.pop(
                "shard_present") == sp.tolist())
            ok = (ok_p and ok_f and present_ok and v == v_flat == v_plain
                  and c == c_flat)
            emit({"phase": "cohort", "case": f"a {name} cohort_shards={S}",
                  "card": card, "round_ms": 1e3 * secs / R2,
                  "round_ms_flat": 1e3 * flat_secs / R2,
                  "round_ms_plain": 1e3 * plain_secs / R2,
                  "launches": c, "launches_flat": c_flat,
                  "shard_present_per_round": sp.sum(1).tolist(),
                  "verdicts_equal_flat": v == v_flat,
                  "verdict_totals": {k: int(np.sum(x)) for k, x in v.items()},
                  "vs_flat": d_flat, "vs_plain": d_plain, "tol": TOL_RUN,
                  "ok": ok})
            if not ok:
                fail(f"in-graph {name} at cohort_shards={S}: verdicts equal "
                     f"{v == v_flat == v_plain}, shard_present {present_ok}, "
                     f"launches {c} against the flat run's {c_flat}, "
                     f"{d_flat}, {d_plain}")
        libs[name].append(libraries())
    libs_ok = all(a == b for a, b in libs.values())
    emit({"phase": "cohort", "case": "a libraries across S",
          "after_flat_and_after_shards": libs, "ok": libs_ok})
    if not libs_ok:
        fail(f"changing cohort_shards built or loaded a library: {libs}")

    # (b) the defended FedAMW run at S = 5 split at round 1
    c3 = dict(amw_kw, round=R2, faults=COHORT_FAULTS, robust_agg=DEFENDED,
              cohort_shards=STREAM_SHARDS)
    ref, _ = timed(FedAMW, kernel_impl="plain", **c3)
    full, secs, c = counted(FedAMW, **c3)
    ok_p, d_plain = vs_plain(full, ref)
    first = FedAMW(setup, **c3, stop_round=1)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, first["params"], p=first["p"], round_idx=1,
                        extra={"p_opt": first["p_opt"]},
                        reputation=first["reputation"],
                        defense_state={"zq": first["zq"]})
        second = FedAMW(setup, **c3, start_round=1,
                        resume_from=load_checkpoint(tmp))
    split_ok = (
        all(np.array_equal(np.concatenate([first[k], second[k]]), full[k])
            for k in ("train_loss", "test_loss", "test_acc"))
        and np.array_equal(np.concatenate(
            [first["hierarchy"]["shard_present"],
             second["hierarchy"]["shard_present"]]),
            full["hierarchy"]["shard_present"])
        and all(np.array_equal(np.concatenate(
            [first["defense"][k], second["defense"][k]]), full["defense"][k])
            for k in ("reputation", "z_threshold", "z_max"))
        and torch.equal(second["params"]["w"], full["params"]["w"])
        and torch.equal(second["p"], full["p"])
        and np.array_equal(second["reputation"], full["reputation"]))
    ok = split_ok and ok_p and cohort_verdicts(full) == cohort_verdicts(ref)
    emit({"phase": "cohort", "case": "b FedAMW defended S=5 split at round 1",
          "card": card, "robust_agg": DEFENDED, "faults": COHORT_FAULTS,
          "bitwise": split_ok, "launches": c, "vs_plain": d_plain,
          "ok": ok})
    if not ok:
        fail(f"the defended sharded FedAMW run: split bitwise {split_ok}, "
             f"against its plain run {d_plain}")

    # (c) streamed FedAvg and FedNova, and the defended streamed FedAvg
    # under clip:R (R the median delta norm of the first round's clean
    # updates) + quarantine:3
    round_fn = make_bucketed_round(setup.task, EPOCHS, B, setup.n_maxes,
                                   False, "auto")
    params0 = _init_params(setup, SEED, None)
    idx_t, mask_t = setup.round_arrays()
    stacked, _, _ = round_fn(params0, setup.X, setup.y, idx_t, mask_t,
                             _round_generator(setup, SEED, 0),
                             float(kw["lr"]), 0.0, 0.0)
    radius = float(client_delta_norms(params0, stacked)[
        setup.sizes > 0].median())
    st = dict(kw, round=R2, cohort_shards=STREAM_SHARDS, stream_cohort=True)
    for name, fn, fkw in (
            ("FedAvg", FedAvg, st), ("FedNova", FedNova, st),
            ("FedAvg defended", FedAvg,
             dict(st, faults=STREAM_FAULTS,
                  robust_agg=f"clip:{radius}+quarantine:3"))):
        ref, plain_secs = timed(fn, kernel_impl="plain", **fkw)
        res, secs, c = counted(fn, **fkw)
        ok, diffs = vs_plain(res, ref)
        vk, vp = cohort_verdicts(res), cohort_verdicts(ref)
        want = R2 * EPOCHS * STREAM_SHARDS
        ok = ok and vk == vp and c["client_epoch"] == want and not c[
            "p_epoch"]
        emit({"phase": "cohort", "case": f"c streamed {name} S=5",
              "card": card, "robust_agg": fkw.get("robust_agg", "mean"),
              "faults": fkw.get("faults"), "round_ms": 1e3 * secs / R2,
              "round_ms_plain": 1e3 * plain_secs / R2, "launches": c,
              "expected": {"client_epoch": want, "p_epoch": 0},
              "verdicts": vk, "verdicts_equal": vk == vp,
              "test_acc": res["test_acc"].tolist(), "vs_plain": diffs,
              "tol": TOL_RUN, "ok": ok})
        if not ok:
            fail(f"streamed {name}: launches {c}, verdicts equal "
                 f"{vk == vp}, against its plain run {diffs}")

    # (d) the driver at R=3 with --cohort_shards 5 --stream_cohort
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(log):
            path = exp.main(["--dataset", "mnist", "--round", str(ROUNDS),
                             "--seed", str(SEED), "--result_dir", tmp,
                             "--cohort_shards", str(STREAM_SHARDS),
                             "--stream_cohort"])
        with open(path, "rb") as f:
            data = pickle.load(f)
    drv_secs = time.perf_counter() - t0
    c = counts()
    for k in launched:
        launched[k] += c[k]
    long = EPOCHS * ROUNDS
    # CL, DL and FedAMW_OneShot: one launch an epoch; FedAvg and FedProx
    # one a shard and epoch; FedAMW one an epoch (in-graph)
    want = {"client_epoch": 3 * long + 2 * STREAM_SHARDS * long + long,
            "p_epoch": ROUNDS + ROUNDS * ROUNDS}
    got = {k: c[k] for k in want}
    drv_ok = (data["test_acc"].shape == (6, ROUNDS, 1)
              and bool(np.all(np.isfinite(data["test_loss"])))
              and "cohort plane: FedAvg/FedProx stream" in log.getvalue()
              and got == want)
    emit({"phase": "cohort", "case": "d driver --cohort_shards 5 "
          "--stream_cohort", "seconds": drv_secs, "launches": got,
          "expected": want, "final_acc": dict(zip(
              data["name"], data["test_acc"][:, -1, 0].tolist())),
          "ok": drv_ok})
    if not drv_ok:
        fail(f"the driver with --cohort_shards --stream_cohort: launches "
             f"{got}, expected {want}")

    # (e) the 1M-client streamed round
    c = million_client_round(card, vs_plain, setup.device)
    for k in launched:
        launched[k] += c[k]
    return launched


# the ranks phase: the client axis over ranks (parallel/mesh.py) — the
# faults of its defended case and the spec (krum gathers every update)
RANK_FAULTS = "drop=0.1,corrupt=0.05:nan,seed=7"
RANK_DEFENDED = "quarantine:3+krum"
RANK_STREAM_SHARDS = 10    # 5 a rank of two: each rank streams its own
HOST = "127.0.0.1"


def _host_tree(x):
    """A result with every tensor moved to the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    return x


def _leaves(res, prefix=""):
    """Every array of a result by path, as numpy."""
    import numpy as np
    import torch

    out = {}
    for k in sorted(res):
        v, path = res[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path + "/"))
        elif isinstance(v, (list, tuple)):
            out.update(_leaves(dict(enumerate(v)), path + "/"))
        elif isinstance(v, torch.Tensor):
            out[path] = v.cpu().numpy()
        elif not isinstance(v, str):
            out[path] = np.asarray(v)
    return out


def bitwise(a, b) -> bool:
    """Two results hold the same bits in every returned array."""
    import numpy as np

    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(
        np.array_equal(la[k], lb[k]) for k in la)


@contextlib.contextmanager
def fd_stdout_to(path):
    """The process's file descriptor 1 (what spawned ranks inherit) into
    ``path`` inside the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _agent_store():
    """A rendezvous store bound to port 0 and read back; ranks joining
    through ``tcp://HOST:port`` connect to it as clients."""
    import torch.distributed as dist

    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    return dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False)


def rank_cases(kw, amw_kw):
    """The runs of two ranks on one card: ``(name, algorithm,
    keywords)``."""
    from fedamw_tpu_torch.algorithms import FedAMW, FedAvg

    return (("FedAvg", FedAvg, kw), ("FedAMW", FedAMW, amw_kw),
            ("FedAMW defended", FedAMW, dict(
                amw_kw, faults=RANK_FAULTS, robust_agg=RANK_DEFENDED)),
            ("FedAvg streamed", FedAvg, dict(
                kw, cohort_shards=RANK_STREAM_SHARDS, stream_cohort=True)))


def _one_card_rank(rank, port, out):
    """One of two ranks sharing ``cuda:0`` in a gloo group (the ranks
    phase's (c)): the main setup, this rank's J/2 clients, the runs of
    ``rank_cases``, each counted after a barrier (the two ranks build
    their setups apart); results, launches and kernel 1's plan at J/2 to
    ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fedamw_tpu_torch.algorithms import FedAvg, prepare_setup
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.parallel import make_mesh, shard_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{HOST}:{port}",
                            world_size=2, rank=rank)
    mesh = make_mesh(2, device="cuda:0")
    for op in (mesh.all_gather, mesh.all_reduce):   # the first collectives
        op(torch.zeros(1, device="cuda:0"))
    prm = get_parameter("mnist")
    ds = load_dataset("mnist", num_partitions=J, alpha=prm["alpha_Dirk"])
    setup = shard_setup(prepare_setup(
        ds, D=D, kernel_par=prm["kernel_par"], seed=SEED,
        rng=np.random.RandomState(SEED), device="cuda:0"), mesh)
    kw = dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, round=ROUNDS,
              seed=SEED, lr_mode="constant", return_state=True)
    amw_kw = dict(kw, lambda_reg=prm["lambda_reg"], lr_p=prm["lr_p"],
                  val_batch_size=VB)
    # this process's first kernel launches load the kernels' libraries:
    # one uncounted round first, so the timed runs time the rounds
    FedAvg(setup, **dict(kw, round=1))
    res = {}
    for name, fn, fkw in rank_cases(kw, amw_kw):
        reset_counts()
        torch.cuda.synchronize()
        dist.barrier()      # both ranks start the timed run together
        t0 = time.perf_counter()
        r = fn(setup, **fkw)
        torch.cuda.synchronize()
        res[name] = {"result": _host_tree(r), "counts": counts(),
                     "seconds": time.perf_counter() - t0}
    J_rank = setup.idx.shape[0]
    plan = ek.launch_plan(J_rank, B, setup.num_classes, D,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump({"runs": res, "clients": J_rank,
                     "cluster": plan.cluster}, f)
    dist.destroy_process_group()


def ranks(setup, kw, amw_kw, timed, vs_plain, card, driver_data):
    """The ``ranks`` phase, the client axis over ranks: (a) FedAvg and
    FedAMW at the main configuration on a one-rank NCCL group
    (``initialize_multihost``, ``make_mesh(1)``, ``shard_setup``) against
    the ungrouped kernel runs, bitwise, launches by kernel equal, round ms
    of each and the ``all_reduce``/``all_gather`` ms a round (CUDA events
    around each collective); (b) the driver at R=3 with ``--shard 1`` and
    with ``--multihost --num_processes 1 --process_id 0``, each pickle
    bitwise the driver phase's ((c), two ranks on the card, runs last:
    ``two_ranks_one_card``). Counts are reset just before each counted
    run and read just after; returns the phase's launches and the
    ungrouped runs, which (c) is held against."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.algorithms import FedAMW, FedAvg
    from fedamw_tpu_torch.parallel import (
        initialize_multihost, make_mesh, shard_setup)

    launched = {"client_epoch": 0, "p_epoch": 0}

    def counted(fn, s=None, **fkw):
        reset_counts()
        res, secs = timed(fn, s, **fkw)
        c = counts()
        for k in launched:
            launched[k] += c[k]
        return res, secs, c

    # (a) the one-rank NCCL group against the ungrouped runs
    store = _agent_store()
    try:
        world = initialize_multihost(f"{HOST}:{store.port}", 1, 0)
    finally:
        del os.environ["TORCHELASTIC_USE_AGENT_STORE"]
    backend = dist.get_backend()
    grouped = shard_setup(setup, make_mesh(1))
    # NCCL builds its communicator at the group's first collective: one
    # of each here, timed apart, so the rounds below time the collectives
    t0 = time.perf_counter()
    for op in (grouped.mesh.all_gather, grouped.mesh.all_reduce):
        op(torch.zeros(1, device=setup.device))
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    events = {"all_reduce": [], "all_gather": []}
    real = {k: getattr(dist, k) for k in events}

    def on_events(name):
        def call(*a, **k):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            out = real[name](*a, **k)
            stop.record()
            events[name].append((start, stop))
            return out
        return call

    flat_runs = {}
    for name, fn, fkw in (("FedAvg", FedAvg, kw), ("FedAMW", FedAMW,
                                                    amw_kw)):
        flat, flat_secs, c_flat = counted(fn, **fkw)
        flat_runs[name] = flat
        for k in events:
            events[k].clear()
            setattr(dist, k, on_events(k))
        try:
            res, secs, c = counted(fn, grouped, **fkw)
        finally:
            for k in events:
                setattr(dist, k, real[k])
        torch.cuda.synchronize()
        same = bitwise(res, flat)
        ok = same and c == c_flat and world == 1 and backend == "nccl"
        emit({"phase": "ranks", "case": f"a {name} one-rank group",
              "card": card, "backend": backend, "world": world,
              "bitwise": same, "communicator_startup_s": startup_s,
              "launches": c, "launches_ungrouped": c_flat,
              "round_ms": 1e3 * secs / ROUNDS,
              "round_ms_ungrouped": 1e3 * flat_secs / ROUNDS,
              "collective_ms_per_round": {
                  k: sum(a.elapsed_time(b) for a, b in v) / ROUNDS
                  for k, v in events.items()},
              "collectives_per_round": {k: len(v) / ROUNDS
                                        for k, v in events.items()},
              "ok": ok})
        if not ok:
            fail(f"{name} on a one-rank {backend} group is not the ungrouped "
                 f"run: bitwise {same}, launches {c} against {c_flat}")
    dist.destroy_process_group()

    # (b) the driver over one rank: spawned (--shard 1) and in this
    # process (--multihost), each pickle the driver phase's
    argv = ["--dataset", "mnist", "--round", str(ROUNDS), "--seed",
            str(SEED)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with fd_stdout_to(f"{tmp}/shard.log"):
            with contextlib.redirect_stdout(io.StringIO()):
                p_shard = exp.main(argv + ["--shard", "1", "--result_dir",
                                           f"{tmp}/shard"])
        shard_secs = time.perf_counter() - t0
        store = _agent_store()
        log = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                p_multi = exp.main(argv + [
                    "--multihost", "--coordinator", f"{HOST}:{store.port}",
                    "--num_processes", "1", "--process_id", "0",
                    "--result_dir", f"{tmp}/multi"])
        finally:
            del os.environ["TORCHELASTIC_USE_AGENT_STORE"]
        multi_secs = time.perf_counter() - t0
        with open(f"{tmp}/shard.log") as f:
            shard_log = f.read()
        pickles = {}
        for name, path in (("shard 1", p_shard), ("multihost", p_multi)):
            with open(path, "rb") as f:
                pickles[name] = pickle.load(f)
    same = {name: all(np.array_equal(d[k], driver_data[k]) for k in (
                "train_loss", "test_loss", "test_acc", "heterogeneity"))
            for name, d in pickles.items()}
    ok = (all(same.values()) and not dist.is_initialized()
          and "client axis split over 1 ranks (nccl" in shard_log
          and "multihost: process 0/1, 1 global devices, --shard 1"
          in log.getvalue())
    emit({"phase": "ranks", "case": "b driver over one rank", "card": card,
          "bitwise_driver_pickle": same, "seconds": {
              "shard 1": shard_secs, "multihost": multi_secs},
          "ok": ok})
    if not ok:
        fail(f"the driver over one rank: bitwise {same}; logs "
             f"{shard_log[-500:]} {log.getvalue()[-500:]}")

    return launched, flat_runs


def two_ranks_one_card(setup, kw, amw_kw, timed, vs_plain, card,
                       flat_runs):
    """The ``ranks`` phase's (c), run last: two ranks sharing the card in
    a gloo group (``_one_card_rank``), J/2 clients each, the runs of
    ``rank_cases`` (FedAvg, FedAMW, FedAMW under ``RANK_FAULTS`` and
    ``RANK_DEFENDED``, FedAvg streamed at ``RANK_STREAM_SHARDS``) against
    the single-process kernel runs at ``TOL_RUN``, every verdict equal,
    the two ranks bitwise equal, kernel 1's cluster on each rank."""
    import torch
    import torch.multiprocessing as mp

    from fedamw_tpu_torch.fedcore import epoch_kernel as ek

    refs = dict(flat_runs)
    for name, fn, fkw in rank_cases(kw, amw_kw):
        if name not in refs:
            refs[name], _ = timed(fn, **fkw)
    store = _agent_store()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            mp.start_processes(_one_card_rank, args=(store.port, tmp),
                               nprocs=2, join=True, start_method="spawn")
            spawn_secs = time.perf_counter() - t0
            out = []
            for r in range(2):
                with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                    out.append(pickle.load(f))
    finally:
        del os.environ["TORCHELASTIC_USE_AGENT_STORE"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    whole_plan = ek.launch_plan(J, B, setup.num_classes, D, sms).cluster
    for name, ref in refs.items():
        got = [o["runs"][name] for o in out]
        ok_p, diffs = vs_plain(got[0]["result"], _host_tree(ref))
        same_ranks = bitwise(got[0]["result"], got[1]["result"])
        v_ok = verdicts(got[0]["result"]) == verdicts(ref)
        ok = ok_p and same_ranks and v_ok
        emit({"phase": "ranks", "case": f"c {name} two ranks on one card",
              "card": card, "backend": "gloo",
              "clients_per_rank": [o["clients"] for o in out],
              "kernel1_cluster_per_rank": [o["cluster"] for o in out],
              "kernel1_cluster_single_process": whole_plan,
              "launches_per_rank": [g["counts"] for g in got],
              "round_ms_per_rank": [1e3 * g["seconds"] / ROUNDS
                                    for g in got],
              "ranks_bitwise": same_ranks, "verdicts_equal": v_ok,
              "verdicts": verdicts(ref), "vs_single_process": diffs,
              "tol": TOL_RUN, "spawn_seconds": spawn_secs, "ok": ok})
        if not ok:
            fail(f"{name} on two ranks of one card: within TOL_RUN {ok_p} "
                 f"{diffs}, ranks bitwise {same_ranks}, verdicts {v_ok}")


# the zoo phase: scale_bench.py's two zoo configurations uncut, each the
# synthetic stand-in of its dataset's shape (rows, features, classes,
# data seed, test fraction) over Dirichlet(0.1) clients, with
# run_config's lr 0.1, 2 local epochs and batch 32 (scale_bench.py:56-58)
ZOO = {
    "a covtype_1024": dict(source="scale_bench.py:148-162", rows=464809,
                           d=54, classes=7, data_seed=11,
                           test_fraction=0.25, clients=1024,
                           model="mlp64"),
    "b mnist_conv_512": dict(source="scale_bench.py:165-185", rows=60000,
                             d=784, classes=10, data_seed=13,
                             test_fraction=1 / 6, clients=512,
                             model="conv8x16"),
}
ZOO_LR = 0.1
# FedAMW on the zoo: the JAX package's defaults (lr_p 5e-5, ridge 0.01)
# with the simplex p-guard (kernel 2's epilogue). Unguarded, FedAMW over
# (b)'s 512 CNNs diverges in the JAX package as in the port, on the same
# draws, to NaN by round 3 (tools/zoo_unguarded_witness.py, at (b)'s
# widths with its rows cut); on the simplex the aggregate is a convex
# combination of the clients
ZOO_AMW = dict(lambda_reg=0.01, lr_p=5e-5, val_batch_size=VB,
               p_guard="simplex")
# rounds of (a)'s and (b)'s runs and of (c)'s drivers, cut to 2 for the
# script's time limit
ZOO_ROUNDS = 2
# (c): the driver's --model on the mnist stand-in, one repeat
ZOO_DRIVER_MODELS = ("conv8x16", "mlp64x32")
# the driver's lr and p-guard are the zoo's: the registry's mnist lr 0.5
# is for RFF features, and on the raw 784-pixel stand-in every
# algorithm's MLP diverges to NaN at it (a run on the CPU). One local
# epoch: Centralized's 3 serial epochs of 1,500 autograd steps are most
# of a driver run (~60 s of the ~130 s at 2 epochs)
# (d): FedAMW on (a)'s mlp64 under drops and NaN reports, quarantine and
# krum, 2 rounds
ZOO_FAULTS = "drop=0.1,corrupt=0.05:nan,seed=7"
ZOO_DEFENDED = "quarantine:3+krum"
ZOO_DEFENSE_ROUNDS = 2


def zoo_setup(cfg):
    """``scale_bench.py``'s dataset and setup of a ``ZOO`` configuration,
    from the port's own data layer: raw features (``kernel_type="linear"``)
    and the configuration's model."""
    import numpy as np

    from fedamw_tpu_torch.algorithms import prepare_setup
    from fedamw_tpu_torch.data import (FederatedDataset, dirichlet_partition,
                                       synthetic_classification)

    X, y, Xt, yt = synthetic_classification(
        cfg["rows"], cfg["d"], cfg["classes"], seed=cfg["data_seed"],
        test_fraction=cfg["test_fraction"])
    parts, _ = dirichlet_partition(y, cfg["clients"], alpha=0.1, seed=2020,
                                   min_size=0)
    ds = FederatedDataset(
        name=cfg["model"], task_type="classification",
        num_classes=cfg["classes"], d=cfg["d"], X_train=X, y_train=y,
        X_test=Xt, y_test=yt, parts=parts, source="synthetic")
    return prepare_setup(ds, D=cfg["d"], kernel_type="linear", seed=SEED,
                         rng=np.random.RandomState(SEED), model=cfg["model"])


def zoo_driver(model, rounds):
    """``python -m fedamw_tpu_torch.exp --model MODEL --local_epoch 1
    --lr 0.1 --p_guard simplex`` on the mnist stand-in at R = ``rounds``,
    one repeat, counted: ``(row, launches)``."""
    import numpy as np

    from fedamw_tpu_torch import exp

    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            path = exp.main(["--dataset", "mnist", "--model", model,
                             "--round", str(rounds), "--n_repeats", "1",
                             "--local_epoch", "1", "--lr", str(ZOO_LR),
                             "--p_guard", ZOO_AMW["p_guard"],
                             "--seed", str(SEED), "--result_dir", tmp])
        secs = time.perf_counter() - t0
        c = counts()
        with open(path, "rb") as f:
            data = pickle.load(f)
    shapes = {k: list(data[k].shape)
              for k in ("train_loss", "test_loss", "test_acc")}
    finite = all(bool(np.all(np.isfinite(data[k]))) for k in shapes)
    forced = (f"--model {model}: forcing kernel_type='linear' (identity "
              "features; the registry's RFF map serves the linear flagship)"
              in log.getvalue())
    # FedAMW's R p-epochs a round and FedAMW_OneShot's one an iteration
    want = {"client_epoch": 0, "p_epoch": rounds * rounds + rounds}
    got = {k: c[k] for k in want}
    ok = (all(s == [6, rounds, 1] for s in shapes.values()) and finite
          and forced and got == want and data["name"] == exp.NAMES)
    return {"phase": "zoo", "case": f"c driver --model {model}",
            "seconds": secs, "shapes": shapes, "finite": finite,
            "forced_kernel_type_printed": forced, "launches": got,
            "launches_expected": want,
            "p_epoch_by_kernel": c["p_epoch_by_kernel"],
            "final_acc": dict(zip(data["name"],
                                  data["test_acc"][:, -1, 0].tolist())),
            "ok": ok}, got


def zoo(timed, vs_plain, card):
    """The ``zoo`` phase: (a) ``covtype_1024`` (mlp64, 1024 clients) and
    (b) ``mnist_conv_512`` (conv8x16, 512 clients) at full width, FedAvg
    and FedAMW ``ZOO_ROUNDS`` rounds each against their plain runs, with
    round ms, client-updates/s, the allocator's peak above the run's
    entry, launches by kernel (kernel 1 never, kernel 2 ``ZOO_ROUNDS`` a
    round on its split plan), the client FLOPs with their basis, and
    kernel 2 at the configuration's shape against its plain version and
    its bound; (b) also one autograd step of all 512 clients (grouped
    convolutions) against the same step client by client; (c) the driver
    with ``--model``; (d) a defended FedAMW on (a), every verdict equal to
    its plain run's. Counts are set to 0 just before each counted run and
    read just after. Returns the phase's launches and kernel 2's rows by
    shape."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.algorithms import FedAMW, FedAvg
    from fedamw_tpu_torch.fedcore import (client_logits, cuda_build,
                                          make_guard, p_epoch,
                                          p_epoch_plain)
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.batching import (batch_valid,
                                                   draw_epoch_positions)
    from fedamw_tpu_torch.fedcore.client import (_epoch_rows,
                                                 make_autograd_epoch)
    from fedamw_tpu_torch.utils.flops import (client_update_flops,
                                              fwd_flops_per_sample)

    launches = {"client_epoch": 0, "p_epoch": 0}
    by_shape = {}
    zoo_served = {}

    def counted(fn, s, **fkw):
        """A run on the kernels, counted, with the allocator's peak above
        its entry."""
        torch.cuda.synchronize()
        entry = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res, secs = timed(fn, s, **fkw)
        c = counts()
        return res, secs, c, torch.cuda.max_memory_allocated() - entry

    for name, cfg in ZOO.items():
        t0 = time.perf_counter()
        s = zoo_setup(cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        dev = s.device
        J, C = s.num_clients, s.num_classes
        n_val = int(s.X_val.shape[0])
        plan = pk.launch_plan(VB, J, C,
                              max_cluster=pk.split_max_cluster(dev.index
                                                               or 0))
        init = s.model.init(torch.Generator().manual_seed(0), s.D, C)
        fwd, basis = fwd_flops_per_sample(init, s.model.apply, d=s.D,
                                          with_provenance=True)
        # n_mean over every client, as scale_bench.py counts it
        flops_upd = client_update_flops(fwd, EPOCHS,
                                        float(s.sizes.float().mean()))
        emit({"phase": "zoo", "case": f"{name} setup",
              "source": cfg["source"], "model": cfg["model"],
              "seconds": setup_s, "N": int(s.X.shape[0]), "D": s.D, "J": J,
              "C": C, "n_max": s.n_max, "n_val": n_val,
              "n_test": int(s.X_test.shape[0]),
              "p_epoch_plan": dataclasses.asdict(plan),
              "fwd_flops_per_sample": fwd, "flops_basis": basis})
        # kernel 2 at this shape: every client a perturbation of the
        # initial weights, their validation logits, one p-epoch from the
        # sample-count weights, against the plain version
        gen = torch.Generator(device=dev).manual_seed(SEED)
        stacked = {k: v.to(dev)[None] + 0.01 * torch.randn(
            (J,) + tuple(v.shape), generator=gen, device=dev)
            for k, v in init.items()}
        t0 = time.perf_counter()
        logits = client_logits(s.model.apply, stacked, s.X_val,
                               s.model.row_activations(s.D, C))
        torch.cuda.synchronize()
        logits_s = time.perf_counter() - t0
        pos = draw_epoch_positions(gen, n_val, VB)
        valid = batch_valid(pos, n_val)
        cv = (s.sizes > 0).to(torch.float32)
        a = (s.p_fixed.contiguous(), torch.zeros_like(s.p_fixed), cv, logits,
             s.y_val, pos.to(torch.int32), valid, ZOO_AMW["lr_p"], 0.9,
             "classification")
        # unguarded (the by_shape cells' epoch) and with the runs' guard,
        # whose fixed-point rounds the kernel counts
        guard = make_guard(ZOO_AMW["p_guard"])
        saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
        errs, oks, times = [], [], {}
        rounds = torch.zeros(2, dtype=torch.int32, device=dev)
        for label, g in (("ms", None), ("ms_simplex", guard)):
            pk_, bk, mk = p_epoch(*a, guard=g,
                                  guard_rounds=rounds if g else None)
            torch.cuda.synchronize()
            times[label] = cuda_ms(lambda: p_epoch(*a, guard=g), 5)
            # the plain version, seconds a call: timed once, by CUDA events
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            pp, bp, mp = p_epoch_plain(*a, guard=g)
            t1.record()
            torch.cuda.synchronize()
            times["plain_" + label] = t0.elapsed_time(t1)
            for ok_e, err_e in (close(pk_, pp, **TOL_P),
                                close(bk, bp, **TOL_P),
                                close(mk[:2] / mk[2], mp[:2] / mp[2], 0,
                                      2e-5)):
                oks.append(ok_e)
                errs.append(err_e)
        p_epoch.launches, p_epoch.launches_by_kernel = saved
        used = [u for f, u in cuda_build.ptxas_usage("p_epoch").items()
                if pk.kernel_symbol(plan, C) in f]
        if len(used) != 1 or used[0]["spill_bytes"] != 0:
            fail(f"p_epoch's {plan} at J={J}, C={C}: ptxas {used}")
        # the guarded instantiation the zoo's FedAMW runs
        used_g = [u for f, u in cuda_build.ptxas_usage("p_epoch").items()
                  if pk.kernel_symbol(plan, C, guarded=True) in f]
        if len(used_g) != 1 or used_g[0]["spill_bytes"] != 0:
            fail(f"p_epoch's guarded {plan} at J={J}, C={C}: ptxas {used_g}")
        S2 = int(pos.shape[0])
        nbytes = 4 * (n_val * J * C + n_val + 2 * S2 * VB + 5 * J + 3)
        ops = 4 * n_val * J * C + 4 * J * S2
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
        total, most = rounds.tolist()
        cell = {**times, "n_val": n_val, "S": S2,
                "us_per_step": 1e3 * times["ms"] / S2,
                # the guard's cost: the guarded launch less the unguarded
                # one, a step; and the simplex's rounds a step
                "guard_us_per_step": 1e3 * (times["ms_simplex"]
                                            - times["ms"]) / S2,
                "guard_rounds_per_step": total / S2,
                "guard_rounds_max": most,
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bound_bytes": nbytes,
                "over_bound": times["ms"] / (1e3 * max(t_b, t_o)),
                "cluster": plan.cluster, "slice": plan.slice_width,
                "stream": plan.stream, "tile": plan.tile,
                "stages": plan.stages, "warps": plan.warps,
                "smem_bytes": plan.smem_bytes,
                "registers": used[0]["registers"],
                "spill_bytes": used[0]["spill_bytes"],
                "registers_guarded": used_g[0]["registers"],
                "spill_bytes_guarded": used_g[0]["spill_bytes"],
                "max_abs_err": max(errs[0], errs[1], errs[3], errs[4]),
                "logits_bytes": logits.numel() * 4,
                "client_logits_seconds": logits_s,
                "launches": ZOO_ROUNDS * ZOO_ROUNDS,
                "launches_path": f"zoo: {name} FedAMW"}
        by_shape[f"J={J} C={C}"] = cell
        emit({"phase": "zoo", "case": f"{name} p_epoch", "card": card,
              **cell, "tol": TOL_P, "ok": all(oks)})
        if not all(oks):
            fail(f"p_epoch at the zoo's J={J}, C={C} disagrees with its "
                 "plain version")
        del logits, stacked, a

        kw = dict(lr=ZOO_LR, epoch=EPOCHS, batch_size=B, round=ZOO_ROUNDS,
                  seed=0, lr_mode="constant", return_state=True)
        amw = None
        for algo, fn, fkw in (("FedAvg", FedAvg, kw),
                              ("FedAMW", FedAMW, dict(kw, **ZOO_AMW))):
            ref, plain_secs = timed(fn, s, kernel_impl="plain", **fkw)
            res, secs, c, peak = counted(fn, s, **fkw)
            ok, diffs = vs_plain(res, ref)
            want = {"client_epoch": 0, "p_epoch": (
                ZOO_ROUNDS * ZOO_ROUNDS if algo == "FedAMW" else 0)}
            got = {k: c[k] for k in want}
            on_plan = c["p_epoch_by_kernel"].get(plan.kernel, 0)
            ups = J * ZOO_ROUNDS / secs
            acc = res["test_acc"]
            row = {"phase": "zoo", "case": f"{name} {algo}", "card": card,
                   "model": cfg["model"], "J": J,
                   "train_loss": res["train_loss"].tolist(),
                   "test_loss": res["test_loss"].tolist(),
                   "test_acc": acc.tolist(),
                   "accuracy_rises": bool(acc[-1] > acc[0]),
                   "seconds": secs, "seconds_plain": plain_secs,
                   "round_ms": 1e3 * secs / ZOO_ROUNDS,
                   "round_ms_plain": 1e3 * plain_secs / ZOO_ROUNDS,
                   "client_updates_per_s": ups,
                   "allocator_peak_bytes_above_entry": peak,
                   "flops_per_update": flops_upd, "flops_basis": basis,
                   "achieved_gflops": ups * flops_upd / 1e9,
                   "launches": got, "launches_expected": want,
                   "p_epoch_by_kernel": c["p_epoch_by_kernel"],
                   "p_epoch_plan": plan.kernel, "vs_plain": diffs,
                   "w_max_abs": max(float(v.abs().max())
                                    for v in ref["params"].values()),
                   "p_sum": float(res["p"].sum()),
                   "tol": TOL_RUN, "ok": ok}
            if algo == "FedAvg":
                # the weights the serve phase's (d) serves
                zoo_served[name] = (res["params"], s.X_test, s.y_test,
                                    cfg["model"])
            if algo == "FedAMW":
                row["flops_note"] = "client local SGD only"
                row["mixture"] = {k: v.tolist()
                                  for k, v in res["mixture"].items()}
                amw = res
            emit(row)
            if not ok:
                fail(f"zoo {name} {algo} on the kernels does not match its "
                     f"plain run: {diffs}")
            if got != want or on_plan != want["p_epoch"]:
                fail(f"zoo {name} {algo} launched {c}, expected {want} "
                     f"on the {plan.kernel} plan")
            for k in launches:
                launches[k] += got[k]

        if cfg["model"].startswith("conv"):
            # what the grouped convolution costs: one autograd step of all
            # J clients (vmap: J-group convolutions) against the same step
            # one client at a time, CUDA events
            n_max = s.n_max
            step_pos = draw_epoch_positions(gen, n_max, B, s.mask,
                                            lead=(J,))[:, :1]
            rows, svalid = _epoch_rows(step_pos, s.idx, s.mask, n_max)
            epoch = make_autograd_epoch(s.model.apply, s.task)
            P = {k: v.expand((J,) + tuple(v.shape)).contiguous()
                 for k, v in amw["params"].items()}
            step_args = (s.X, s.y, rows, svalid, ZOO_LR, 0.0, 0.01)
            grouped_ms = cuda_ms(
                lambda: epoch(P, amw["params"], *step_args), 5)
            looped_ms = cuda_ms(lambda: [epoch(
                {k: v[j:j + 1] for k, v in P.items()}, amw["params"], s.X,
                s.y, rows[j:j + 1], svalid[j:j + 1], ZOO_LR, 0.0, 0.01)
                for j in range(J)], 1)
            emit({"phase": "zoo", "case": f"{name} grouped conv step",
                  "card": card, "J": J, "batch": B,
                  "vmap_step_ms": grouped_ms,
                  "client_by_client_step_ms": looped_ms,
                  "speedup": looped_ms / grouped_ms})

        if name.startswith("a "):
            # (d) a defended FedAMW round on mlp64, every verdict equal
            dkw = dict(kw, **ZOO_AMW, round=ZOO_DEFENSE_ROUNDS,
                       faults=ZOO_FAULTS, robust_agg=ZOO_DEFENDED)
            ref, plain_secs = timed(FedAMW, s, kernel_impl="plain", **dkw)
            res, secs, c, peak = counted(FedAMW, s, **dkw)
            ok, diffs = vs_plain(res, ref)
            same = verdicts(res) == verdicts(ref)
            want = {"client_epoch": 0,
                    "p_epoch": ZOO_DEFENSE_ROUNDS * ZOO_DEFENSE_ROUNDS}
            got = {k: c[k] for k in want}
            emit({"phase": "zoo", "case": f"d {name[2:]} FedAMW "
                  f"{ZOO_FAULTS} {ZOO_DEFENDED}", "card": card,
                  "train_loss": res["train_loss"].tolist(),
                  "test_loss": res["test_loss"].tolist(),
                  "test_acc": res["test_acc"].tolist(),
                  "round_ms": 1e3 * secs / ZOO_DEFENSE_ROUNDS,
                  "round_ms_plain": 1e3 * plain_secs / ZOO_DEFENSE_ROUNDS,
                  "allocator_peak_bytes_above_entry": peak,
                  "verdicts": verdicts(res), "verdicts_equal": same,
                  "launches": got, "launches_expected": want,
                  "vs_plain": diffs,
                  "ok": ok and same and got == want})
            if not (ok and same and got == want):
                fail(f"the defended zoo FedAMW run differs from its plain "
                     f"run (verdicts equal: {same}, launches {got}): "
                     f"{diffs}")
            for k in launches:
                launches[k] += got[k]
        del s, amw
        torch.cuda.empty_cache()

    # (c) the driver: --model through exp.main on the mnist stand-in
    for model in ZOO_DRIVER_MODELS:
        row, got = zoo_driver(model, ZOO_ROUNDS)
        row["card"] = card
        emit(row)
        if not row["ok"]:
            fail(f"the driver with --model {model}: {row}")
        for k in launches:
            launches[k] += got[k]
    return launches, by_shape, zoo_served


# -- the serve phase ---------------------------------------------------------
SERVE_REQUESTS = 2000   # (b): requests in the mixed stream
SERVE_THREADS = 4       # (b): its submitting threads
SERVE_WINDOW = 8        # (b): futures each thread keeps in flight
SERVE_MAX_ROWS = 4096   # (b): the largest request, the top rung
# A row served at another rung, or inside a coalesced batch, is another
# row count for cuBLAS, which may choose another algorithm and so another
# sum order; every comparison across rungs reports whether it was
# bitwise and its largest difference, and is held at this tolerance and
# to the same argmax. At one rung and one position the logits must be
# bitwise. Accuracy against the evaluator is held exactly.
TOL_SERVE = dict(atol=1e-5, rtol=1e-5)


def logits_diff(a, b):
    """(max abs difference, bitwise, within TOL_SERVE with equal argmax)
    of two numpy logit arrays of one shape."""
    import numpy as np

    if a.shape != b.shape:
        return float("inf"), False, False
    d = float(np.max(np.abs(a - b))) if a.size else 0.0
    near = bool(np.allclose(a, b, **TOL_SERVE)
                and np.array_equal(a.argmax(-1), b.argmax(-1)))
    return d, bool(np.array_equal(a, b)), near


def rung_numbers(engine, X):
    """Per rung of ``engine``: p50/p99 of ``predict``'s wall time
    (``serving.LatencyHistogram``), rows/s, and ``pop_timings``' split
    into padding and dispatch (the copy in, the forward, the copy out),
    the rung's first rows of ``X`` repeated, after one warm call."""
    from fedamw_tpu_torch.serving import LatencyHistogram

    out = {}
    for b in engine.buckets:
        Xb = X[:b].copy()
        reps = 50 if b <= 512 else 20
        engine.predict(Xb)
        engine.pop_timings()
        hist = LatencyHistogram()
        pad = disp = wall = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.predict(Xb)
            dt = time.perf_counter() - t0
            hist.record(dt)
            wall += dt
            t = engine.pop_timings()
            pad += t["pad_s"]
            disp += t["dispatch_s"]
        out[str(b)] = {**hist.percentiles((50, 99)), "reps": reps,
                       "rows_per_s": b * reps / wall,
                       "pad_ms": 1e3 * pad / reps,
                       "dispatch_ms": 1e3 * disp / reps,
                       "h2d_bytes": int(Xb.nbytes)}
    return out


def serve_engine(label, engine, X, y, model, params, X_eval, card):
    """The checks of one engine on the card (the ``serve`` phase's (a)
    and (d)): the warmed ladder's shape count, the logits on every test
    row against ``model.apply`` under ``full_fp32`` on the evaluator's
    features and the accuracy against ``fedcore.make_evaluator``'s
    exactly, inert padding and chunked requests bitwise, the per-rung
    numbers and ``device_attribution`` of the middle rung (it must read
    the profiler). ``X``/``y``: the raw test rows (numpy) and labels (on
    the card); ``X_eval``: the evaluator's feature matrix on the card.
    Returns the row it emitted."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.fedcore import make_evaluator
    from fedamw_tpu_torch.fedcore.aggregate import full_fp32
    from fedamw_tpu_torch.ops.metrics import top1_correct

    warm = engine.warmup()
    t0 = time.perf_counter()
    served = engine.predict(X)
    served_s = time.perf_counter() - t0
    with torch.no_grad(), full_fp32():
        ref = model.apply(params, X_eval).cpu().numpy()
    d_apply, bit_apply, near_apply = logits_diff(served, ref)
    _, acc = make_evaluator(model.apply, "classification")(
        params, X_eval, y)
    served_acc = float(100.0 * torch.mean(top1_correct(
        torch.from_numpy(served).to(y.device), y)))
    # padding: the same rung with other rows in the pad (bitwise), and a
    # larger rung (across rungs)
    x5 = X[:5]
    alone = engine.predict(x5)
    filled = engine.predict(X[:8])[:5]
    across = engine.predict(X[:40])[:5]
    d_pad, bit_pad_rung, _ = logits_diff(alone, filled)
    d_across, bit_across, near_across = logits_diff(alone, across)
    # chunking: 5000 rows are two top-rung dispatches, each bitwise its
    # own request's
    top = engine.buckets[-1]
    X5k = np.resize(X, (top + 904, X.shape[1]))  # rows repeat if too few
    whole = engine.predict(X5k)
    parts = np.concatenate([engine.predict(X5k[:top]),
                            engine.predict(X5k[top:])])
    _, bit_chunk, _ = logits_diff(whole, parts)
    numbers = rung_numbers(engine, X)
    attr = engine.device_attribution()
    row = {"phase": "serve", "case": label, "card": card,
           "buckets": list(engine.buckets), "warmup_shapes": warm,
           "compile_count": engine.compile_count,
           "rows": int(X.shape[0]), "input_dim": engine.input_dim,
           "serve_all_rows_s": served_s,
           "logits_vs_apply": {"max_abs": d_apply, "bitwise": bit_apply,
                               "within_tol": near_apply},
           "accuracy_served": served_acc, "accuracy_evaluator": float(acc),
           "padding_bitwise_at_one_rung": bit_pad_rung,
           "padding_max_abs_at_one_rung": d_pad,
           "across_rungs": {"max_abs": d_across, "bitwise": bit_across,
                            "within_tol": near_across},
           "chunked_equals_parts_bitwise": bit_chunk,
           "per_rung": numbers,
           "device_attribution": {k: attr.get(k) for k in (
               "source", "bucket", "compute_fraction", "reason",
               "device_busy_s", "host_s")},
           "tol": TOL_SERVE}
    row["ok"] = (warm == len(engine.buckets) == 5
                 and engine.compile_count == 5
                 and (bit_apply or near_apply)
                 and served_acc == float(acc)
                 and bit_pad_rung and (bit_across or near_across)
                 and bit_chunk and attr.get("source") == "profiler")
    emit(row)
    if not row["ok"]:
        fail(f"serve {label}: {row}")
    return row


def serve_stream(engine, X):
    """(b): ``ServingService`` in continuous mode under ``SERVE_THREADS``
    submitting threads, each with ``SERVE_WINDOW`` futures in flight:
    ``SERVE_REQUESTS`` requests of 1..``SERVE_MAX_ROWS`` rows (log-uniform)
    sliced from ``X``. Every future against ``engine.predict`` of its
    rows alone; no shed and no retry; the snapshot's latency, throughput
    and stage split."""
    import collections
    import threading

    import numpy as np

    from fedamw_tpu_torch.serving import ServingService

    rng = np.random.RandomState(SEED)
    sizes = np.clip(np.exp(rng.uniform(0, np.log(SERVE_MAX_ROWS),
                                       SERVE_REQUESTS)).astype(int),
                    1, SERVE_MAX_ROWS)
    offs = rng.randint(0, X.shape[0] - sizes + 1)
    reqs = [X[o:o + n] for o, n in zip(offs, sizes)]
    cc = engine.compile_count
    results, errors = {}, []
    with ServingService(engine, max_queue=4 * SERVE_THREADS * SERVE_WINDOW,
                        mode="continuous") as svc:
        def client(k):
            window = collections.deque()
            try:
                for i in range(k, SERVE_REQUESTS, SERVE_THREADS):
                    window.append((i, svc.submit(reqs[i])))
                    if len(window) >= SERVE_WINDOW:
                        j, f = window.popleft()
                        results[j] = f.result(timeout=120)
                while window:
                    j, f = window.popleft()
                    results[j] = f.result(timeout=120)
            except Exception as e:  # reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        snap = svc.metrics.snapshot(engine)
    worst, bitwise, near = 0.0, 0, 0
    for i, x in enumerate(reqs):
        if i not in results:
            continue
        d, bit, ok = logits_diff(results[i], engine.predict(x))
        worst = max(worst, d)
        bitwise += bit
        near += bit or ok
    stages = {k: v for k, v in snap.items()
              if k.split("_")[0] in ("queue", "pad", "device")
              and k.endswith("_ms")}
    row = {"phase": "serve", "case": "b service continuous",
           "requests": SERVE_REQUESTS, "threads": SERVE_THREADS,
           "in_flight_per_thread": SERVE_WINDOW,
           "rows": int(sizes.sum()), "rows_min": int(sizes.min()),
           "rows_max": int(sizes.max()), "wall_s": wall,
           "requests_per_s": SERVE_REQUESTS / wall,
           "rows_per_s": float(sizes.sum()) / wall,
           "p50_ms": snap.get("p50_ms"), "p99_ms": snap.get("p99_ms"),
           "batches": snap["batches"],
           "mean_batch_rows": snap["mean_batch_rows"],
           "sheds": {k: snap[k] for k in ("shed_deadline", "shed_overload",
                                          "shed_shutdown",
                                          "shed_admission")},
           "retries": snap["retries"], "stages_ms": stages,
           "vs_predict": {"max_abs": worst, "bitwise": bitwise,
                          "within_tol": near, "of": len(results)},
           "compile_count": engine.compile_count, "errors": errors[:3]}
    row["ok"] = (not errors and len(results) == SERVE_REQUESTS
                 and near == SERVE_REQUESTS
                 and snap["requests"] == SERVE_REQUESTS
                 and not any(row["sheds"].values())
                 and snap["retries"] == 0 and engine.compile_count == cc)
    emit(row)
    if not row["ok"]:
        fail(f"serve (b): {row}")


def serve(ds, setup, amw_res, driver_data, card, zoo_served):
    """The ``serve`` phase: (a) FedAMW's ``main_path`` checkpoint with its
    RFF draw, loaded by ``ServingEngine.load`` on the default ladder and
    serving raw 784-wide rows; (b) ``ServingService`` under a mixed
    stream; (c) the driver at R=3 with ``--save_models --publish_every
    1`` (its pickle bitwise the ``driver`` phase's, its launches counted),
    a ``CheckpointWatcher`` publishing v0001..v0003 into a
    ``ModelRegistry``, three swaps under live traffic, a shadow rollout
    promoted and a sign-flipped candidate rolled back by the parity gate;
    (d) the zoo's FedAvg weights (mlp64, conv8x16) served. Returns the
    launches of (c)'s driver run."""
    import threading

    import numpy as np
    import torch

    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.models import get_model
    from fedamw_tpu_torch.serving import (CheckpointWatcher, ModelRegistry,
                                          RolloutController, ServingEngine,
                                          ServingService)
    from fedamw_tpu_torch.utils import save_checkpoint

    t_phase = time.perf_counter()
    X_raw = np.ascontiguousarray(np.asarray(ds.X_test, np.float32))
    y = setup.y_test
    eval_acc = float(np.asarray(amw_res["test_acc"])[-1])
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the main configuration's checkpoint at full width
        ck = os.path.join(tmp, "main_FedAMW")
        save_checkpoint(ck, amw_res["params"], p=amw_res["p"],
                        round_idx=ROUNDS, rff=setup.rff,
                        extra={"eval_acc": eval_acc})
        t0 = time.perf_counter()
        engine = ServingEngine.load(ck)
        load_s = time.perf_counter() - t0
        row = serve_engine("a main FedAMW (mnist, RFF D=2000)", engine,
                           X_raw, y, setup.model, amw_res["params"],
                           setup.X_test, card)
        if engine.rff is None or engine.input_dim != X_raw.shape[1]:
            fail(f"serve (a): the engine does not map raw rows: "
                 f"{engine.input_dim}")
        emit({"phase": "serve", "case": "a load", "seconds": load_s,
              "weights_bytes": sum(int(v.numel()) * 4 for v in
                                   engine.params.values()),
              "rff_bytes": sum(int(t.numel()) * 4 for t in engine.rff)})

        # (b) the service under a mixed stream
        serve_stream(engine, X_raw)

        # (c) the train->serve loop
        ckdir = os.path.join(tmp, "published")
        reset_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            path = exp.main(["--dataset", "mnist", "--round", str(ROUNDS),
                             "--seed", str(SEED), "--result_dir",
                             os.path.join(tmp, "res"), "--save_models",
                             ckdir, "--publish_every", "1"])
        drv_s = time.perf_counter() - t0
        c = counts()
        launches = {k: c[k] for k in ("client_epoch", "p_epoch")}
        want = {"client_epoch": 6 * EPOCHS * ROUNDS,
                "p_epoch": ROUNDS * ROUNDS + ROUNDS}
        with open(path, "rb") as f:
            seg = pickle.load(f)
        same = all(np.array_equal(seg[k], driver_data[k])
                   for k in ("train_loss", "test_loss", "test_acc",
                             "heterogeneity"))
        reg = ModelRegistry()
        watcher = CheckpointWatcher(
            reg, os.path.join(ckdir, "mnist_FedAMW_repeat0"),
            poll_interval_s=0.05)
        with watcher:
            deadline = time.time() + 60
            while len(watcher.published) < ROUNDS and time.time() < deadline:
                time.sleep(0.05)
        names = [n for n, _ in watcher.published]
        versions = [v for _, v in watcher.published]
        rounds = [reg.get(v).round_idx for v in versions]

        # three swaps under live traffic, then a shadow rollout promoted
        # and a sign-flipped candidate rolled back
        cc = engine.compile_count
        stop, served, errors = threading.Event(), [0], []
        swap_ms = []
        with ServingService(engine, max_queue=64) as svc:
            def traffic():
                rng = np.random.RandomState(1)
                try:
                    while not stop.is_set():
                        n = int(rng.randint(1, 600))
                        o = int(rng.randint(0, X_raw.shape[0] - n))
                        svc.submit(X_raw[o:o + n]).result(timeout=60)
                        served[0] += 1
                except Exception as e:  # reported below
                    errors.append(repr(e))

            th = threading.Thread(target=traffic)
            th.start()
            time.sleep(0.2)
            for v in versions:
                entry = reg.get(v)
                t0 = time.perf_counter()
                engine.swap_weights(entry.params, rff=entry.rff, version=v)
                swap_ms.append(1e3 * (time.perf_counter() - t0))
                svc.metrics.record_swap(
                    v, staleness_rounds=reg.staleness_rounds(v))
                time.sleep(0.2)
            live_after_swaps = engine.version
            cand = reg.publish({k: v.cpu().numpy() for k, v in
                                amw_res["params"].items()},
                               rff=tuple(t.cpu().numpy()
                                         for t in setup.rff),
                               round_idx=ROUNDS,
                               metadata={"eval_acc": eval_acc})
            ctl = RolloutController(svc, reg, mode="shadow", fraction=1.0,
                                    min_requests=20, error_budget=0,
                                    parity_data=(X_raw, y.cpu().numpy()))
            staged = ctl.stage(cand)
            deadline = time.time() + 60
            while engine.version != cand and time.time() < deadline:
                time.sleep(0.05)
            promoted = engine.version == cand
            live = reg.get(cand)
            flipped = reg.publish({k: -v for k, v in live.params.items()},
                                  rff=live.rff, round_idx=ROUNDS,
                                  metadata={"eval_acc": eval_acc})
            flip_staged = ctl.stage(flipped)
            stop.set()
            th.join(timeout=120)
            snap = svc.metrics.snapshot(engine)
        ctl.detach()
        gate = ctl.events[-1]
    row = {"phase": "serve", "case": "c train->serve loop", "card": card,
           "driver_seconds": drv_s, "pickle_bitwise_driver_phase": same,
           "published": names, "registry_rounds": rounds,
           "launches": launches, "launches_expected": want,
           "swaps": len(swap_ms), "swap_p50_ms": float(np.median(swap_ms)),
           "swap_ms": swap_ms, "live_after_swaps": live_after_swaps,
           "requests_during": served[0], "traffic_errors": errors[:3],
           "compile_count_before": cc, "compile_count": engine.compile_count,
           "shadow_staged": staged, "shadow_promoted": promoted,
           "shadow_requests": snap["shadow_requests"],
           "flipped_staged": flip_staged, "rollback_event": gate.get("event"),
           "flipped_gate": gate.get("gate"),
           "rollbacks": snap["rollbacks"],
           "installed_after": engine.versions_installed}
    row["ok"] = (same and names == ["v0001", "v0002", "v0003"]
                 and rounds == [1, 2, 3] and launches == want
                 and len(swap_ms) == 3 and live_after_swaps == versions[-1]
                 and not errors and served[0] > 0
                 and engine.compile_count == cc and staged and promoted
                 and not flip_staged and gate.get("event") == "rollback"
                 and flipped not in engine.versions_installed)
    emit(row)
    if not row["ok"]:
        fail(f"serve (c): {row}")

    # (d) the zoo's engines
    for name, (params, X_zoo, y_zoo, model_name) in zoo_served.items():
        model = get_model(model_name)
        kw = ({"model": model_name, "input_dim": int(X_zoo.shape[1])}
              if model_name.startswith("conv") else {})
        zeng = ServingEngine({k: v for k, v in params.items()}, **kw)
        serve_engine(f"d {name} FedAvg ({model_name})", zeng,
                     X_zoo.cpu().numpy(), y_zoo, model, params, X_zoo, card)
        del zeng
    del engine
    torch.cuda.empty_cache()
    emit({"phase": "serve", "case": "total",
          "seconds": time.perf_counter() - t_phase})
    return launches


# -- the fleet phase ---------------------------------------------------------
FLEET_REQUESTS = 1000   # (b): requests in the mixed stream
FLEET_REPLICAS = 4      # (b): replicas over the one engine
# (b): the JAX serve bench's chaos schedule in shape (a kill, two wedges,
# flaky and slow runs), at dispatch indices a stream of a few hundred
# coalesced batches reaches on every replica of a round-robin fleet;
# the phase fails unless every scheduled cell fired
FLEET_CHAOS = dict(kills={0: 15}, wedges={1: [6, 20]},
                   flaky={2: [3, 10, 18]}, slow={3: list(range(2, 16))},
                   wedge_s=0.05, slow_mult=3.0)
FLEET_HEDGE_FLOOR_MS = 20.0  # (b): above a clean top rung, below a wedge
POD_REQUESTS = 300      # (c): requests over the two socket workers
POD_KILL_AT = 20        # (c): worker 0's dispatch that SIGKILLs it
POD_RUNGS = (64, 4096)  # (c): rungs timed over the socket and in process
FLEET_ERRORS = ("DeadlineExceeded", "ReplicaUnavailable",
                "NoReplicasAvailable")  # the JAX router's typed outcomes


def fleet_cold_start(art_dir, ckpt, x_path, out_path):
    """(a) in a freshly spawned process on the card: ``from_artifact``
    (timed: the manifest, five rung programs, the checkpoint's weights
    and each rung's run at load) beside ``ServingEngine.load`` +
    ``warmup`` of the same checkpoint, then both engines at every rung
    and pad position on the same rows. Writes its findings and the
    artifact engine's full-rung logits to ``out_path`` (npz)."""
    import numpy as np
    import torch

    import fedamw_tpu_torch  # noqa: F401
    from fedamw_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    # the program loader's modules, imported on a process's first load
    t0 = time.perf_counter()
    import torch._export.serde.serialize  # noqa: F401
    loader_import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = ServingEngine.from_artifact(art_dir, checkpoint=ckpt)
    load_s = time.perf_counter() - t0
    cc_loaded = art.compile_count
    t0 = time.perf_counter()
    eager = ServingEngine.load(ckpt)
    warm = eager.warmup()
    eager_s = time.perf_counter() - t0
    X = np.load(x_path)
    cells, full = [], {}
    prev = 0
    for b in art.buckets:
        for n in sorted({prev + 1, (prev + 1 + b) // 2, b}):
            a, e = art.predict(X[:n]), eager.predict(X[:n])
            cells.append((b, n, bool(np.array_equal(a, e)),
                          float(np.max(np.abs(a - e)))))
        full[f"rung_{b}"] = art.predict(X[:b])
        prev = b
    np.savez(out_path, summary=json.dumps({
        "pid": os.getpid(), "context_s": context_s,
        "loader_import_s": loader_import_s, "load_s": load_s,
        "eager_load_warmup_s": eager_s, "eager_warmup_shapes": warm,
        "compile_count_at_load": cc_loaded,
        "compile_count_after_serving": art.compile_count,
        "cells": cells}), **full)


def _spawn(target, **kw):
    """One process in a fresh interpreter (the ``spawn`` context: this
    process holds a CUDA context, which a forked child cannot use)."""
    import multiprocessing

    p = multiprocessing.get_context("spawn").Process(target=target,
                                                     kwargs=kw)
    p.start()
    return p


def _mixed_sizes(rng, n):
    """``n`` request sizes of 1..``SERVE_MAX_ROWS`` rows, log-uniform
    (the ``serve`` phase's mix)."""
    import numpy as np

    return np.clip(np.exp(rng.uniform(0, np.log(SERVE_MAX_ROWS),
                                      n)).astype(int), 1, SERVE_MAX_ROWS)


def _drive_stream(svc, reqs, threads, window, timeout_s):
    """Submit ``reqs`` from ``threads`` threads with ``window`` futures
    each in flight; returns ({index: logits}, {index: error type name},
    wall seconds)."""
    import threading

    results, errors = {}, {}

    def client(k):
        pending = collections.deque()

        def settle():
            j, f = pending.popleft()
            try:
                results[j] = f.result(timeout=120)
            except Exception as e:  # the typed outcome, checked after
                errors[j] = type(e).__name__

        for i in range(k, len(reqs), threads):
            try:
                pending.append((i, svc.submit(reqs[i],
                                              timeout_s=timeout_s)))
            except Exception as e:
                errors[i] = type(e).__name__
            if len(pending) >= window:
                settle()
        while pending:
            settle()

    t0 = time.perf_counter()
    ths = [threading.Thread(target=client, args=(k,))
           for k in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
    return results, errors, time.perf_counter() - t0


def _vs_predict(engine, reqs, results):
    """(worst abs difference, answers bitwise, answers within TOL_SERVE
    with the argmax equal) of the answered requests against
    ``engine.predict`` of each request alone."""
    worst, bitwise, near = 0.0, 0, 0
    for i, out in results.items():
        d, bit, ok = logits_diff(out, engine.predict(reqs[i]))
        worst = max(worst, d)
        bitwise += bit
        near += bit or ok
    return {"max_abs": worst, "bitwise": bitwise, "within_tol": near,
            "of": len(results)}


def fleet(ds, setup, amw_res, avg_res, card):
    """The ``fleet`` phase: FedAMW's ``main_path`` checkpoint (its RFF
    draw and head) on the default ladder. (a) its ladder exported and
    cold-started in a freshly spawned process; two tampered copies
    refused. (b) a hedged ``FailoverRouter`` over 4 replicas of one
    engine under a scripted ``ChaosPlan`` behind ``ServingService``, the
    mixed stream. (c) two spawned ``worker_main`` processes on the
    artifact behind ``SocketTransport`` replicas and ``PodClientEngine``:
    socket against in-process dispatch, a ``swap_weights`` announce, a
    SIGKILL mid-stream. (d) a ``LadderLearner`` on (b)'s request sizes,
    applied through ``install_rung``. Returns the phase's kernel
    launches (none expected)."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.serving import (ServingEngine, export_ladder,
                                          worker_main)
    from fedamw_tpu_torch.utils import save_checkpoint

    reset_counts()
    t_phase = time.perf_counter()
    X_raw = np.ascontiguousarray(np.asarray(ds.X_test, np.float32))
    procs = []
    ok_all = True
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "main_FedAMW")
        save_checkpoint(ck, amw_res["params"], p=amw_res["p"],
                        round_idx=ROUNDS, rff=setup.rff)
        engine = ServingEngine.load(ck)
        engine.warmup()
        # (a) export, then the cold start in a fresh process; the two
        # socket workers of (c) start at the same time, on the artifact
        art = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        manifest = export_ladder(engine, art, round_idx=ROUNDS)
        export_s = time.perf_counter() - t0
        x_path = os.path.join(tmp, "rows.npy")
        np.save(x_path, X_raw[:max(engine.buckets)])
        out_path = os.path.join(tmp, "cold.npz")
        try:
            cold = _spawn(fleet_cold_start, art_dir=art, ckpt=ck,
                          x_path=x_path, out_path=out_path)
            procs.append(cold)
            ports = [os.path.join(tmp, f"port{i}") for i in range(2)]
            workers = [_spawn(worker_main, port_file=f, artifact_dir=art,
                              checkpoint=ck, worker_id=i)
                       for i, f in enumerate(ports)]
            procs += workers
            ok_all &= fleet_a(engine, art, ck, manifest, export_s, cold,
                              out_path, X_raw, card)
            # (b) the hedged fleet under scripted chaos
            ok_b, registry, sizes = fleet_b(engine, X_raw, card)
            ok_all &= ok_b
            # (c) the pod over TCP
            ok_all &= fleet_c(engine, ports, workers, X_raw, avg_res,
                              setup, card)
            # (d) the learned ladder on (b)'s sizes
            ok_all &= fleet_d(ck, registry, sizes, X_raw, card)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
    del engine
    torch.cuda.empty_cache()
    c = counts()
    launches = {k: c[k] for k in ("client_epoch", "p_epoch")}
    emit({"phase": "fleet", "case": "total", "card": card,
          "seconds": time.perf_counter() - t_phase, "launches": launches,
          "processes_left": [p.pid for p in procs if p.is_alive()]})
    if not ok_all or any(p.is_alive() for p in procs):
        fail("fleet: a check failed (see the rows above)")
    return launches


def fleet_a(engine, art, ck, manifest, export_s, cold, out_path, X_raw,
            card):
    """(a) the cold start's findings, the parent's eager logits against
    the child's artifact logits at each full rung, and two tampered
    copies (one manifest field, one ``.pt2``), each refused typed."""
    import shutil

    import numpy as np

    from fedamw_tpu_torch.serving import ArtifactIncompatible, ServingEngine

    cold.join(timeout=300)
    got = np.load(out_path) if cold.exitcode == 0 else None
    summary = json.loads(str(got["summary"])) if got is not None else {}
    vs_parent = {}
    for b in engine.buckets:
        if got is not None:
            d, bit, _ = logits_diff(got[f"rung_{b}"],
                                    engine.predict(X_raw[:b]))
            vs_parent[str(b)] = {"bitwise": bit, "max_abs": d}
    refused = {}
    for name, edit in (("manifest device_kind", "manifest"),
                       ("rung_64.pt2 rewritten", "program")):
        bad = f"{art}_{edit}"
        shutil.copytree(art, bad)
        if edit == "manifest":
            path = os.path.join(bad, "manifest.json")
            with open(path) as f:
                obj = json.load(f)
            obj["host"]["device_kind"] = "NVIDIA A100-SXM4-80GB"
            with open(path, "w") as f:
                json.dump(obj, f)
        else:
            path = os.path.join(bad, "rung_64.pt2")
            with open(path, "r+b") as f:
                f.seek(256)
                f.write(b"\xff" * 32)
        try:
            ServingEngine.from_artifact(bad, checkpoint=ck)
            refused[name] = "loaded"
        except ArtifactIncompatible as e:
            refused[name] = [m[0] for m in e.mismatches]
    cells = summary.get("cells", [])
    row = {"phase": "fleet", "case": "a cold start", "card": card,
           "export_s": export_s,
           "artifact_bytes": sum(r["bytes"] for r in
                                 manifest.rungs.values()),
           "rungs": {k: r["bytes"] for k, r in manifest.rungs.items()},
           "manifest_host": manifest.host, "child_exit": cold.exitcode,
           **{k: summary.get(k) for k in (
               "pid", "context_s", "loader_import_s", "load_s",
               "eager_load_warmup_s",
               "eager_warmup_shapes", "compile_count_at_load",
               "compile_count_after_serving")},
           "cells": len(cells),
           "cells_bitwise": sum(1 for c in cells if c[2]),
           "cells_max_abs": max((c[3] for c in cells), default=None),
           "vs_parent_eager_full_rungs": vs_parent,
           "tampered_refused": refused}
    row["ok"] = (cold.exitcode == 0 and summary.get("pid") != os.getpid()
                 and summary.get("compile_count_at_load") == 0
                 and summary.get("compile_count_after_serving") == 0
                 and len(cells) > 0 and all(c[2] for c in cells)
                 and all(v != "loaded" and v for v in refused.values()))
    emit(row)
    return row["ok"]


def fleet_b(engine, X_raw, card):
    """(b) 4 replicas of one engine, hedged, round-robin, under the
    scripted plan, behind ``ServingService``: the mixed stream of
    ``FLEET_REQUESTS`` requests from ``SERVE_THREADS`` threads with
    ``SERVE_WINDOW`` in flight each. Returns (ok, the service's
    telemetry registry, the request sizes) for (d)."""
    import numpy as np

    from fedamw_tpu_torch.serving import (ChaosPlan, FailoverRouter,
                                          ReplicaSet, ServingService)

    rng = np.random.RandomState(SEED + 1)
    sizes = _mixed_sizes(rng, FLEET_REQUESTS)
    offs = rng.randint(0, X_raw.shape[0] - sizes + 1)
    reqs = [X_raw[o:o + n] for o, n in zip(offs, sizes)]
    cc = engine.compile_count
    plan = ChaosPlan.scripted(FLEET_REPLICAS, **FLEET_CHAOS)
    with FailoverRouter(ReplicaSet(engine, FLEET_REPLICAS, chaos=plan),
                        policy="round_robin", hedge=True,
                        hedge_min_samples=8,
                        hedge_floor_ms=FLEET_HEDGE_FLOOR_MS) as router:
        with ServingService(router, max_queue=4 * SERVE_THREADS
                            * SERVE_WINDOW, mode="continuous") as svc:
            results, errors, wall = _drive_stream(
                svc, reqs, SERVE_THREADS, SERVE_WINDOW, 30.0)
            snap = svc.metrics.snapshot(router)
        stats = router.replica_stats()
        reps = list(router.replicas)
    fired = {}
    for role, cells in (("kill", {0: [FLEET_CHAOS["kills"][0]]}),
                        ("wedge", FLEET_CHAOS["wedges"]),
                        ("flaky", FLEET_CHAOS["flaky"]),
                        ("slow", FLEET_CHAOS["slow"])):
        for r, idx in cells.items():
            fired[f"{role} replica {r}"] = {
                "scheduled": len(idx),
                "fired": sum(1 for i in idx if reps[r].dispatches > i)}
    vs = _vs_predict(engine, reqs, results)
    by_replica = {rid: {k: v[k] for k in ("routed", "ok", "failed",
                                          "requeued", "cancelled",
                                          "state", "ewma_ms")}
                  for rid, v in stats["replicas"].items()}
    row = {"phase": "fleet", "case": "b failover", "card": card,
           "replicas": FLEET_REPLICAS, "requests": FLEET_REQUESTS,
           "rows": int(sizes.sum()), "wall_s": wall,
           "requests_per_s": len(results) / wall,
           "rows_per_s": float(sum(sizes[i] for i in results)) / wall,
           "p50_ms": snap.get("p50_ms"), "p99_ms": snap.get("p99_ms"),
           "batches": snap["batches"], "retries": snap["retries"],
           "answered": len(results),
           "errors": dict(collections.Counter(errors.values())),
           "requeues": stats["requeues"], "hedges": stats["hedges"],
           "hedge_wins": stats["hedge_wins"],
           "hedges_cancelled": stats["hedges_cancelled"],
           "dead_replicas": stats["dead_replicas"],
           "dispatches": [r.dispatches for r in reps],
           "by_replica": by_replica, "cells_fired": fired,
           "vs_predict": vs, "compile_count": engine.compile_count,
           "chaos": {k: (v if not isinstance(v, dict) else
                         {str(r): list(i) if not isinstance(i, int) else i
                          for r, i in v.items()})
                     for k, v in FLEET_CHAOS.items()}, "tol": TOL_SERVE}
    row["ok"] = (len(results) + len(errors) == FLEET_REQUESTS
                 and all(e in FLEET_ERRORS for e in errors.values())
                 and vs["within_tol"] == len(results) > 0
                 and all(f["fired"] == f["scheduled"]
                         for f in fired.values())
                 and stats["dead_replicas"] == 1 and stats["requeues"] >= 1
                 and engine.compile_count == cc)
    emit(row)
    return row["ok"], svc.metrics.registry, sizes


def _wait_ports(files, procs, limit_s=300):
    deadline = time.perf_counter() + limit_s
    while not all(os.path.exists(f) for f in files):
        if time.perf_counter() > deadline or not all(
                p.is_alive() for p in procs):
            return None
        time.sleep(0.05)
    eps = []
    for f in files:
        with open(f) as fh:
            eps.append(("127.0.0.1", int(fh.read().strip())))
    return eps


def fleet_c(engine, ports, workers, X_raw, avg_res, setup, card):
    """(c) two spawned ``worker_main`` processes on the artifact: the
    dispatch p50 over the socket against in process at ``POD_RUNGS``,
    the bytes on the wire a rung, one ``swap_weights`` announce of
    FedAvg's weights to both, then ``POD_REQUESTS`` requests through a
    router over both with worker 0 SIGKILLed at its ``POD_KILL_AT``-th
    dispatch."""
    import signal

    import numpy as np

    from fedamw_tpu_torch.serving import (
        FailoverRouter, InProcessTransport, LatencyHistogram, NetChaosPlan,
        PodClientEngine, Replica, ServingService, SocketTransport)
    from fedamw_tpu_torch.serving import transport as tr

    t0 = time.perf_counter()
    eps = _wait_ports(ports, workers)
    up_s = time.perf_counter() - t0
    if eps is None:
        emit({"phase": "fleet", "case": "c pod", "ok": False,
              "error": "a worker never came up",
              "exitcodes": [w.exitcode for w in workers]})
        return False
    client = PodClientEngine(eps)
    timing = {}
    with SocketTransport(eps[1]) as sock:
        local = InProcessTransport(engine)
        for b in POD_RUNGS:
            Xb = np.ascontiguousarray(X_raw[:b])
            cell = {}
            for name, t in (("socket", sock), ("in_process", local)):
                for _ in range(3):
                    t.dispatch(Xb, record_timings=False)
                hist = LatencyHistogram()
                reps = 40 if b <= 512 else 15
                for _ in range(reps):
                    t1 = time.perf_counter()
                    t.dispatch(Xb, record_timings=False)
                    hist.record(time.perf_counter() - t1)
                cell[name] = hist.percentiles((50, 99))
            hdr, payload = tr.pack_batch(Xb)
            hdr.update(kind="dispatch", version=None, budget_s=None)
            req = tr._PREFIX.size + len(json.dumps(
                {"schema": tr.FRAME_SCHEMA, **hdr}).encode()) + len(payload)
            resp = {"kind": "result", "worker": 1, "version": 0,
                    "rows": b, "cols": engine.num_classes, "ndim": 2,
                    "dtype": "float32"}
            back = tr._PREFIX.size + len(json.dumps(
                {"schema": tr.FRAME_SCHEMA, **resp}).encode()) \
                + b * engine.num_classes * 4
            cell.update(request_bytes=req, response_bytes=back)
            d, same, _ = logits_diff(sock.dispatch(Xb), engine.predict(Xb))
            cell.update(socket_vs_in_process_bitwise=same, max_abs=d)
            timing[str(b)] = cell
    # the announce: FedAvg's weights under one version on both workers
    params = {k: v.cpu().numpy() for k, v in avg_res["params"].items()}
    rff = tuple(t.cpu().numpy() for t in setup.rff)
    t1 = time.perf_counter()
    v = client.swap_weights(params, rff=rff)
    swap_ms = 1e3 * (time.perf_counter() - t1)
    announce = dict(client.last_announce)
    versions = [s.get("version") for s in client.worker_stats()]
    engine.swap_weights(params, rff=rff, version=v)

    def kill(host):
        os.kill(workers[host].pid, signal.SIGKILL)
        workers[host].join(timeout=30)

    rng = np.random.RandomState(SEED + 2)
    sizes = _mixed_sizes(rng, POD_REQUESTS)
    offs = rng.randint(0, X_raw.shape[0] - sizes + 1)
    reqs = [X_raw[o:o + n] for o, n in zip(offs, sizes)]
    victim = SocketTransport(eps[0], client=client, host_index=0,
                             chaos=NetChaosPlan.scripted(
                                 2, kills={0: POD_KILL_AT}),
                             kill_cb=kill)
    reps = [Replica(0, client, transport=victim),
            Replica(1, client, transport=SocketTransport(
                eps[1], client=client, host_index=1))]
    with FailoverRouter(reps, policy="round_robin") as router:
        with ServingService(router, max_queue=64,
                            mode="continuous") as svc:
            results, errors, wall = _drive_stream(svc, reqs, 2,
                                                  SERVE_WINDOW, 10.0)
            snap = svc.metrics.snapshot(router)
        stats = router.replica_stats()
    survivor = client.worker_stats()
    vs = _vs_predict(engine, reqs, results)
    try:
        client.control(eps[1], {"kind": "stop"})
    except (OSError, tr.TransportError, tr.FrameError):
        pass  # joined or killed by the caller either way
    workers[1].join(timeout=30)
    row = {"phase": "fleet", "case": "c pod over TCP", "card": card,
           "workers_up_s": up_s, "dispatch_p50_ms": timing,
           "swap_version": v, "swap_ms": swap_ms, "announce": announce,
           "worker_versions_after_swap": versions,
           "requests": POD_REQUESTS, "answered": len(results),
           "errors": dict(collections.Counter(errors.values())),
           "wall_s": wall, "requests_per_s": len(results) / wall,
           "p50_ms": snap.get("p50_ms"), "p99_ms": snap.get("p99_ms"),
           "requeues": stats["requeues"],
           "by_replica": {rid: {k: r[k] for k in ("routed", "ok",
                                                 "failed", "requeued",
                                                 "state")}
                          for rid, r in stats["replicas"].items()},
           "kill_fired": victim.faults_injected["kill"],
           "victim_exitcode": workers[0].exitcode,
           "survivor": [{k: s.get(k) for k in ("dead", "version",
                                               "compile_count",
                                               "dispatches", "pid")}
                        for s in survivor],
           "vs_predict": vs, "tol": TOL_SERVE}
    row["ok"] = (announce["acks"] == 2 and versions == [v, v]
                 and len(results) == POD_REQUESTS and not errors
                 and vs["within_tol"] == POD_REQUESTS
                 and victim.faults_injected["kill"] == 1
                 and workers[0].exitcode == -signal.SIGKILL
                 and stats["requeues"] >= 1
                 and survivor[1].get("compile_count") == 0
                 and survivor[1].get("version") == v
                 and all(c["socket_vs_in_process_bitwise"]
                         for c in timing.values()))
    emit(row)
    return row["ok"]


def fleet_d(ck, registry, sizes, X_raw, card):
    """(d) a ``LadderLearner`` on the request sizes (b)'s service
    recorded, its proposal applied through ``install_rung`` on a fresh
    engine of the checkpoint: the pad waste of the fixed ladder against
    the learned one, and ``compile_count`` risen by exactly the rungs
    installed."""
    import numpy as np

    from fedamw_tpu_torch.serving import (LadderLearner, ServingEngine,
                                          apply_proposal, ladder_waste)

    engine = ServingEngine.load(ck)
    engine.warmup()
    fixed = tuple(engine.buckets)
    cc0 = engine.compile_count
    learner = LadderLearner(registry, max_rungs=6, recompile_budget=8,
                            min_samples=64)
    observed = learner.observed_sizes()
    prop = learner.propose(fixed)
    if prop is None:
        emit({"phase": "fleet", "case": "d learned ladder", "ok": False,
              "reason": learner.last_reason})
        return False
    t0 = time.perf_counter()
    ladder = apply_proposal(engine, prop, learner)
    apply_s = time.perf_counter() - t0
    cc1 = engine.compile_count
    stream = [int(s) for s in sizes]
    waste = {"fixed": ladder_waste(stream, fixed),
             "learned": ladder_waste(stream, ladder)}
    worst = 0.0
    for n in sorted(set(prop.rungs)):
        x = X_raw[:n]
        d, _, near = logits_diff(engine.predict(x), engine.predict(
            np.concatenate([x, x]))[:n])
        worst = max(worst, d if near else float("inf"))
    row = {"phase": "fleet", "case": "d learned ladder", "card": card,
           "samples": len(observed), "fixed": list(fixed),
           "learned": list(ladder), "installed": list(prop.install),
           "retired": list(prop.retire), "apply_s": apply_s,
           "waste_fraction_sample": {
               "fixed": prop.baseline_waste_fraction,
               "learned": prop.waste_fraction},
           "waste_stream": waste,
           "compile_count_before": cc0, "compile_count_after": cc1,
           "compile_count_after_serving": engine.compile_count,
           "recompiles_spent": learner.recompiles_spent,
           "rung_rows_max_abs": worst}
    row["ok"] = (cc1 == cc0 + len(prop.install)
                 and engine.compile_count == cc1
                 and waste["learned"]["waste_rows"]
                 <= waste["fixed"]["waste_rows"]
                 and ladder == prop.rungs and bool(np.isfinite(worst)))
    emit(row)
    return row["ok"]


def trace_categories(trace_dir):
    """``{category: count}`` of the complete (``"X"``) events in the Chrome
    trace under ``trace_dir``, and the kernel events of each hand kernel
    by name, read here independently of ``parse_profiler_trace``."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats, by_kernel = {}, {"client_epoch": 0, "p_epoch": 0}
    for e in events:
        if e.get("ph") != "X":
            continue
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        name = str(e.get("name", ""))
        if e.get("cat") == "kernel" and "epoch_kernel" in name:
            by_kernel["p_epoch" if "p_epoch_kernel" in name
                      else "client_epoch"] += 1
    return cats, by_kernel


def observability(setup, amw_kw, untraced, untraced_secs, timed, card):
    """The ``observability`` phase: the driver at R=3 traced, then traced
    and profiled, each pickle bitwise the untraced run's (``untraced``);
    the trace, telemetry and profile files checked; then
    ``attribute_device_time`` over one FedAMW round and FedAMW's
    ``analyze_memory``. Returns the compute fraction."""
    import numpy as np

    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.algorithms import FedAMW
    from fedamw_tpu_torch.utils import read_jsonl
    from fedamw_tpu_torch.utils.telemetry import (
        attribute_device_time, parse_profiler_trace)

    def same(a, b):
        return set(a) == set(b) and all(
            np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
            else a[k] == b[k] for k in a)

    row = {"phase": "observability", "card": card, "rounds": ROUNDS,
           "seconds": {"untraced": untraced_secs}}
    with tempfile.TemporaryDirectory() as tmp:
        for run, extra in (("traced", ["--trace_dir", "tr1"]),
                           ("profiled", ["--trace_dir", "tr2",
                                         "--profile", "prof"])):
            extra = [os.path.join(tmp, a) if a in ("tr1", "tr2", "prof")
                     else a for a in extra]
            log = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                path = exp.main(["--dataset", "mnist", "--round",
                                 str(ROUNDS), "--seed", str(SEED),
                                 "--result_dir", os.path.join(tmp, run),
                                 *extra])
            row["seconds"][run] = time.perf_counter() - t0
            c = counts()
            row.setdefault("launches", {})[run] = {
                k: c[k] for k in ("client_epoch", "p_epoch")}
            with open(path, "rb") as f:
                row.setdefault("pickle_bitwise", {})[run] = same(
                    pickle.load(f), untraced)
            tdir = extra[1]
            header, spans = read_jsonl(
                os.path.join(tdir, "exp1_mnist_trace.jsonl"))
            scans = {r["span_id"]: r for r in spans
                     if r["name"] == "train_scan"}
            rounds = [r for r in spans if r["name"] == "round"]
            with open(os.path.join(tdir, "exp1_mnist_telemetry.json")) as f:
                dump = json.load(f)
            entropy = [m for m in dump["metrics"]
                       if m["name"] == "fed_p_entropy"]
            row.setdefault("trace", {})[run] = {
                "schema": header["schema"], "spans": len(spans),
                "train_scan": [r["attrs"]["aggregation"]
                               for r in scans.values()],
                "round": len(rounds),
                "rounds_parented": sum(r["parent_id"] in scans
                                       for r in rounds),
                "telemetry_schema": dump["schema"],
                "fed_p_entropy_points": [len(m["series"]) for m in entropy]}
            if run == "profiled":
                pdir = extra[3]
                parsed = parse_profiler_trace(pdir)
                cats, by_kernel = trace_categories(pdir)
                row["profile"] = {
                    "parsed": parsed, "categories": cats,
                    "kernel_events_by_kernel": by_kernel,
                    "device_busy_share": (
                        parsed["device_busy_s"] / row["seconds"][run]
                        if parsed else "not measured")}
        log_tail = log.getvalue().splitlines()[-6:]
    row["log_tail"] = log_tail
    tr = row["trace"]
    checks = {
        "pickles_bitwise": all(row["pickle_bitwise"].values()),
        "spans": all(t["schema"] == "TRACE.v1" and sorted(t["train_scan"])
                     == ["fixed", "fixed", "learned"] and t["round"] == 3
                     * ROUNDS and t["rounds_parented"] == 3 * ROUNDS
                     for t in tr.values()),
        "telemetry": all(t["telemetry_schema"] == "TELEMETRY.v1"
                         and t["fed_p_entropy_points"] == [ROUNDS]
                         for t in tr.values()),
        "profile_parsed": row["profile"]["parsed"] is not None,
    }
    if checks["profile_parsed"]:
        launched = row["launches"]["profiled"]
        checks["kernel_events_cover_launches"] = (
            row["profile"]["parsed"]["device_events"]
            >= launched["client_epoch"] + launched["p_epoch"]
            and all(row["profile"]["kernel_events_by_kernel"][k]
                    >= launched[k] for k in launched))

    # device-time attribution over one FedAMW round (round 0 of the main
    # path's 3-round run: its 3 p-epochs)
    def one_round():
        return timed(FedAMW, **amw_kw, stop_round=1)[1]

    attr = attribute_device_time(one_round, reps=3)
    row["attribute_device_time"] = attr
    frac = attr.get("compute_fraction")
    checks["attribution_from_profiler"] = (
        attr["source"] == "profiler" and frac is not None and 0 < frac <= 1)

    # FedAMW's measured memory footprint of one round at the main config
    mem = FedAMW(setup, **amw_kw, analyze_memory=True)
    row["analyze_memory"] = mem
    checks["analyze_memory"] = (
        set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                     "temp_size_in_bytes", "peak_memory_in_bytes"}
        and mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0)
    row["checks"] = checks
    row["ok"] = all(checks.values())
    emit(row)
    if not row["ok"]:
        fail(f"observability: {checks}")
    return frac


# -- the scenario phase -------------------------------------------------------
# the shrink starts of (e): the richer spec for the two instant bugs, the
# plain one for the lost request (each of its runs waits out the lost
# future's deadline)
SCENARIO_PLAIN = "seed=3,rounds=1,clients=4,replicas=2,requests=8"
SCENARIO_RICH = ("seed=13,rounds=2,clients=8,replicas=2,requests=16,"
                 "faults=0.5,chaos=0.2,load=0.4,net=0.3")
SCENARIO_SHRINK = {"lose_request": SCENARIO_PLAIN,
                   "dup_span": SCENARIO_RICH, "recompile": SCENARIO_RICH}
SCENARIO_CODES = {"lose_request": "LOST_REQUEST", "dup_span": "SPAN_DUPLICATE",
                  "recompile": "RECOMPILE"}
# (e)'s oracle timeouts: the lost future is declared after 0.7 s
SCENARIO_INJECT_KW = dict(lost_wait_s=0.2, request_timeout_s=0.5)
TOL_SCENARIO_W = 1e-6


def scenario(card):
    """The ``scenario`` phase: the scenario plane with the oracle's train
    leg on the card (``PropertyOracle(device="cuda")``; the serve leg is
    a pod of host threads and loopback sockets, as in the JAX package).
    (a) every ``campaigns/regressions/*.json`` replayed, each verdict
    ``ok``; (b) ``run_campaign`` at ``CAMPAIGN_r16.json``'s seed and
    budget, its digest and verdicts the committed ones; (c)
    ``run_search`` at ``CAMPAIGN_r18.json``'s, digest, verdicts and
    coverage the committed ones; (d) for each scenario of (b) the train
    leg's global model on the card against ``device="cpu"``; (e) each
    injectable harness bug caught on the card and shrunk to the minimal
    spec the CPU oracle shrinks it to. Returns the phase's launches (0:
    the train leg is selections, masks and a median, no kernel)."""
    import glob

    import numpy as np

    from fedamw_tpu_torch.scenario import (PropertyOracle, ScenarioSpec,
                                           load_regression, run_campaign,
                                           run_search, shrink)
    from fedamw_tpu_torch.scenario.oracle import INJECTABLE

    repo = os.path.dirname(os.path.abspath(__file__))
    reset_counts()
    t_phase = time.perf_counter()
    on_card = PropertyOracle(device="cuda")
    on_cpu = PropertyOracle(device="cpu")
    secs, failures = {}, []

    t0 = time.perf_counter()
    regs = {}
    for path in sorted(glob.glob(os.path.join(repo, "campaigns",
                                              "regressions", "*.json"))):
        v = on_card.run(load_regression(path)["spec"])
        regs[os.path.basename(path)] = list(v.codes()) if v.codes() else "ok"
    secs["a_regressions"] = time.perf_counter() - t0
    if not regs or any(c != "ok" for c in regs.values()):
        failures.append(f"(a) regressions {regs}")

    committed, wants = {}, {}
    for key, name, run in (("b", "CAMPAIGN_r16.json", run_campaign),
                           ("c", "CAMPAIGN_r18.json", run_search)):
        with open(os.path.join(repo, name)) as f:
            want = wants[name] = json.load(f)
        t0 = time.perf_counter()
        art = run(want["seed"], want["budget"], oracle=on_card)
        secs[f"{key}_{name}"] = time.perf_counter() - t0
        same = {k: art[k] == want[k] for k in ("digest", "verdicts",
                                                "coverage") if k in want}
        committed[name] = {"seed": want["seed"], "budget": want["budget"],
                           "scenarios": art["scenarios"],
                           "failures": art["failures"],
                           "digest": art["digest"], "equal": same,
                           "wall_s": art["wall_s"]}
        if not all(same.values()):
            failures.append(f"({key}) {name} not re-derived: {same}")

    t0 = time.perf_counter()
    train_diff = 0.0
    for rec in wants["CAMPAIGN_r16.json"]["verdicts"]:
        spec = ScenarioSpec.parse(rec["spec"])
        legs = []
        for oracle in (on_card, on_cpu):
            viol = []
            legs.append((oracle._run_train(spec, spec.expand(), viol),
                         viol))
        (wc, vc), (wh, vh) = legs
        if wc.dtype != np.float32 or [v.code for v in vc] != [
                v.code for v in vh]:
            failures.append(f"(d) {rec['spec']}: {vc} against {vh}")
        train_diff = max(train_diff, float(np.max(np.abs(wc - wh))))
    secs["d_train_leg"] = time.perf_counter() - t0
    if not train_diff <= TOL_SCENARIO_W:
        failures.append(f"(d) train leg {train_diff} > {TOL_SCENARIO_W}")

    t0 = time.perf_counter()
    injected = {}
    for bug in INJECTABLE:
        code = SCENARIO_CODES[bug]
        kw = dict(SCENARIO_INJECT_KW, inject=(bug,))
        caught = PropertyOracle(device="cuda", **kw).run(
            SCENARIO_PLAIN).codes()
        mins = {}
        for dev in ("cuda", "cpu"):
            minimal, trace = shrink(SCENARIO_SHRINK[bug],
                                    PropertyOracle(device=dev, **kw))
            mins[dev] = (minimal.canonical(), [t["action"] for t in trace])
        injected[bug] = {"caught": list(caught), "minimal": mins["cuda"][0],
                         "shrink_steps": len(mins["cuda"][1]),
                         "same_as_cpu": mins["cuda"] == mins["cpu"]}
        if code not in caught or mins["cuda"] != mins["cpu"]:
            failures.append(f"(e) {bug}: {injected[bug]} against "
                            f"{mins['cpu']}")
    secs["e_inject_shrink"] = time.perf_counter() - t0
    c = counts()
    launches = {k: c[k] for k in ("client_epoch", "p_epoch")}
    row = {"phase": "scenario", "card": card, "regressions": regs,
           "committed": committed, "train_leg_max_abs_diff": train_diff,
           "tol": TOL_SCENARIO_W, "injected": injected, "seconds": secs,
           "phase_seconds": time.perf_counter() - t_phase,
           "launches": launches, "failures": failures, "ok": not failures}
    emit(row)
    if failures or any(launches.values()):
        fail(f"scenario: {failures}, launches {launches}")
    return launches


# -- the torch_ref phase ------------------------------------------------------
# the plain PyTorch reference backend (backends/torch_ref.py) at the main
# configuration: FedAvg and FedAMW at main_path's cut, the other five cut
# for the phase's time (the one-shot algorithms to one local phase of
# EPOCHS epochs, FedProx and FedNova to TORCH_REF_SHORT rounds)
TORCH_REF_SHORT = 1


def torch_ref_phase(ds, prm, runs, card):
    """The ``torch_ref`` phase: ``registry.get_backend("torch")`` at full
    width (the mnist stand-in, RFF D = 2000, J = 50, seed 100, the
    registry's hyper-parameters) on the card and on the CPU, each of the
    seven algorithms held card against CPU at ``TOL_RUN`` (the draws are
    the same CPU generators' on both, so only summation orders differ);
    FedAvg's test loss must fall every round. The seconds of each, and
    the final accuracy of the kernel path's ``main_path`` run beside
    FedAvg's and FedAMW's (information: the draws differ). Returns the
    phase's launches (0: the module is plain PyTorch by definition)."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.registry import get_backend

    ref = get_backend("torch")
    reset_counts()
    t_phase = time.perf_counter()
    setups, setup_s = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        setups[dev] = ref.prepare_setup(
            ds, D=D, kernel_par=prm["kernel_par"], seed=SEED,
            rng=np.random.RandomState(SEED), device=dev)
        torch.cuda.synchronize()
        setup_s[dev] = time.perf_counter() - t0
    base = dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, seed=SEED,
                lr_mode="constant")
    rounds = dict(base, round=ROUNDS)
    short = dict(base, round=TORCH_REF_SHORT)
    cases = (
        ("FedAvg", rounds),
        ("FedAMW", dict(rounds, lambda_reg=prm["lambda_reg"],
                        lr_p=prm["lr_p"], val_batch_size=VB)),
        ("Centralized", base),
        ("Distributed", base),
        ("FedAMW_OneShot", dict(base, lambda_reg=prm["lambda_reg_os"],
                                lr_p=prm["lr_p_os"], val_batch_size=VB,
                                round=ROUNDS)),
        ("FedProx", dict(short, prox=True, mu=prm["lambda_prox"])),
        ("FedNova", short),
    )
    rows, failures = [], []
    for name, fkw in cases:
        res, secs = {}, {}
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[dev] = ref.ALGORITHMS[name](setups[dev], **fkw)
            torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        a, b = res["cuda"], res["cpu"]
        finite = all(np.all(np.isfinite(a[k])) for k in a)
        d = {"max_rel_loss": max(
                float(np.max(np.abs(a[k] - b[k])
                             / np.maximum(np.abs(b[k]), 1e-30)))
                for k in ("train_loss", "test_loss")),
             "max_abs_acc": float(np.max(np.abs(a["test_acc"]
                                                - b["test_acc"])))}
        ok = (finite and d["max_rel_loss"] <= TOL_RUN["loss_rtol"]
              and d["max_abs_acc"] <= TOL_RUN["acc_atol"])
        row = {"algorithm": name,
               "rounds": fkw.get("round"), "local_epochs": fkw["epoch"],
               "seconds": secs["cuda"], "seconds_cpu": secs["cpu"],
               **{k: np.ravel(a[k]).tolist()
                  for k in ("train_loss", "test_loss", "test_acc")},
               "vs_cpu": d, "ok": ok}
        if name in runs:
            row["main_path_final_acc"] = float(
                np.ravel(runs[name][0]["test_acc"])[-1])
        if name == "FedAvg":
            row["learns"] = bool(np.all(np.diff(a["test_loss"]) < 0))
            ok = ok and row["learns"]
        rows.append(row)
        if not ok:
            failures.append(f"{name}: {d}, learns {row.get('learns')}")
    c = counts()
    launches = {k: c[k] for k in ("client_epoch", "p_epoch")}
    # the process's other threads and PyTorch's CPU threads: this phase
    # is bound by host dispatch, so both bear on its seconds
    import threading

    emit({"phase": "torch_ref", "card": card, "setup_seconds": setup_s,
          "threads_alive": sorted(t.name for t in threading.enumerate()),
          "torch_cpu_threads": torch.get_num_threads(),
          "cuts": {"FedAvg/FedAMW rounds": ROUNDS,
                   "FedProx/FedNova rounds": TORCH_REF_SHORT,
                   "local_epochs": EPOCHS,
                   "one-shot local epochs": EPOCHS},
          "algorithms": rows, "tol": {k: TOL_RUN[k] for k in
                                      ("loss_rtol", "acc_atol")},
          "phase_seconds": time.perf_counter() - t_phase,
          "launches": launches, "ok": not failures})
    if failures or any(launches.values()):
        fail(f"torch_ref: {failures}, launches {launches}")
    return launches



# -- the tune phase -----------------------------------------------------------
# the tuning loop and the export CLI through their module entry points, at
# the main configuration's width (the mnist stand-in, RFF D = 2000, J = 50,
# Dirichlet alpha 0.01, the registry's kernel_par): (a) one trial, (b) the
# sweep, (c) the cold-start export of main_path's FedAMW checkpoint
TUNE_ROUNDS = 20            # (a): rounds of the module trial
TUNE_ARGS = ("--dataset", "mnist", "--round", str(TUNE_ROUNDS),
             "--lr_p", "0.001", "--lambda_reg", "5e-6")   # the registry's
TUNE_SWEEP = dict(trials=4, rounds=10, seed=7)            # (b)
TUNE_BUCKETS = "1,8,64,512,4096"                          # (c)


def trial_launches(rounds, trials=1):
    """Kernel launches of ``trials`` FedAMW trials of ``rounds`` rounds:
    2 local epochs a round (kernel 1) and ``rounds`` p-epochs a round
    (kernel 2)."""
    return {"client_epoch": trials * EPOCHS * rounds,
            "p_epoch": trials * rounds * rounds}


def _module(args, timeout=300):
    """``python -m fedamw_tpu_torch.<args>`` from the repository root:
    (completed process, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    return out, time.perf_counter() - t0


def tune_phase(ds, setup, amw_res, prm, card):
    """The ``tune`` phase. (a) ``python -m fedamw_tpu_torch.tune`` in a
    subprocess (exit 0, its printed line parsed); the same parameters
    through ``tune.main`` in process (the printed values to their 5
    decimals, launches 2R and R*R) and ``ALGORITHMS["FedAMW"]`` called
    directly on a setup built by hand with the trial's arguments (within
    ``TOL_RUN``; bitwise or not is reported). (b)
    ``sweep.run_sweep("mnist", trials=4, rounds=10, seed=7)`` in process
    (every trial finite or ranked last, launches per trial as (a)'s) and
    its report written and parsed back. (c) ``python -m
    fedamw_tpu_torch.export_artifacts CKPT OUT --buckets ... --check`` on
    ``main_path``'s FedAMW checkpoint (exit 0, ``compile_count`` 0,
    bitwise parity), then ``ServingEngine.from_artifact`` serving rung
    4096 bitwise as the engine. Returns the phase's launches: (a)'s two
    in-process runs and (b)'s trials (the subprocesses' launches are
    their own)."""
    import math

    import numpy as np
    import torch

    from fedamw_tpu_torch import sweep, tune
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.registry import get_backend
    from fedamw_tpu_torch.serving import ServingEngine
    from fedamw_tpu_torch.serving.artifacts import ARTIFACT_SCHEMA
    from fedamw_tpu_torch.utils import save_checkpoint

    t_phase = time.perf_counter()
    failures = []
    total = {"client_epoch": 0, "p_epoch": 0}

    def counted(fn, *a, **kw):
        """fn(*a, **kw) with every count set to 0 just before and read
        just after: (result, synchronised seconds, launches, stdout)."""
        log = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = fn(*a, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = counts()
        got = {k: c[k] for k in ("client_epoch", "p_epoch")}
        for k in total:
            total[k] += got[k]
        return res, secs, got, log.getvalue()

    # (a) one trial through the module, in process, and FedAMW directly
    out, module_s = _module(["fedamw_tpu_torch.tune", *TUNE_ARGS])
    printed = [ln for ln in out.stdout.splitlines()
               if ln.startswith("FedAMW final: ")]
    parsed = None
    if out.returncode == 0 and len(printed) == 1:
        loss_s, acc_s = (f.split("=")[1] for f in printed[0].split()[2:4])
        parsed = {"loss": loss_s, "acc": acc_s}
    else:
        failures.append(f"a: the module trial exited {out.returncode}: "
                        f"{out.stderr[-1500:]}")
    old_argv = sys.argv
    sys.argv = ["tune", *TUNE_ARGS]
    try:
        params = vars(tune.get_params())
    finally:
        sys.argv = old_argv
    m = {}
    _, inproc_s, inproc_l, inproc_out = counted(tune.main, params,
                                                metrics_out=m)
    same_line = (parsed is not None and f"{m['loss']:.5f}" == parsed["loss"]
                 and f"{m['acc']:.5f}" == parsed["acc"])
    backend = get_backend(params["backend"])
    rng = np.random.RandomState(params["seed"])
    t0 = time.perf_counter()
    ds_t = load_dataset(params["dataset"], 50, 0.01,
                        data_dir=params["data_dir"], rng=rng)
    setup_t = backend.prepare_setup(
        ds_t, D=params["D"], kernel_par=prm["kernel_par"],
        kernel_type=prm["kernel_type"], seed=params["seed"], rng=rng)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    direct, direct_s, direct_l, _ = counted(
        backend.ALGORITHMS["FedAMW"], setup_t, lr=prm["lr"],
        epoch=params["local_epoch"], batch_size=32, lambda_reg_if=True,
        lambda_reg=params["lambda_reg"], round=params["round"],
        lr_p=params["lr_p"], seed=params["seed"])
    del setup_t, ds_t
    d_loss, d_acc = (float(np.ravel(direct[k])[-1])
                     for k in ("test_loss", "test_acc"))
    vs_direct = {"rel_loss": abs(m["loss"] - d_loss) / max(abs(d_loss),
                                                          1e-30),
                 "abs_acc": abs(m["acc"] - d_acc)}
    bitwise = m["loss"] == d_loss and m["acc"] == d_acc
    want = trial_launches(TUNE_ROUNDS)
    ok_a = (parsed is not None and same_line
            and all(math.isfinite(v) for v in m.values())
            and vs_direct["rel_loss"] <= TOL_RUN["loss_rtol"]
            and vs_direct["abs_acc"] <= TOL_RUN["acc_atol"]
            and inproc_l == want and direct_l == want)
    emit({"phase": "tune", "case": "a trial", "card": card,
          "args": list(TUNE_ARGS), "module_exit": out.returncode,
          "module_printed": printed, "in_process_printed":
          inproc_out.strip().splitlines()[-1:], "metrics": m,
          "direct": {"loss": d_loss, "acc": d_acc},
          "printed_line_equal": same_line, "vs_direct": vs_direct,
          "bitwise_vs_direct": bitwise,
          "seconds": {"module_subprocess": module_s,
                      "in_process": inproc_s, "direct_setup": setup_s,
                      "direct_fedamw": direct_s},
          "launches": {"in_process": inproc_l, "direct": direct_l},
          "launches_expected": want, "ok": ok_a})
    if not ok_a:
        failures.append(f"a: line {same_line}, {vs_direct}, launches "
                        f"{inproc_l}/{direct_l} (expected {want})")

    # (b) the sweep in process, its report written and parsed back
    ranked, sweep_s, sweep_l, sweep_out = counted(
        sweep.run_sweep, "mnist", TUNE_SWEEP["trials"],
        TUNE_SWEEP["rounds"], TUNE_SWEEP["seed"])
    want_b = trial_launches(TUNE_SWEEP["rounds"], TUNE_SWEEP["trials"])
    finite = [math.isfinite(r["acc"]) and math.isfinite(r["loss"])
              for r in ranked]
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "TUNING_torch.md")
        with contextlib.redirect_stdout(io.StringIO()):
            sweep.write_report(ranked, "mnist", TUNE_SWEEP["rounds"],
                               TUNE_SWEEP["seed"], report)
        with open(report) as f:
            text = f.read()
    rows = [[c.strip() for c in ln.split("|")[1:-1]]
            for ln in text.splitlines() if ln.startswith("| ")
            and ln[2].isdigit()]
    parses = (len(rows) == len(ranked) == TUNE_SWEEP["trials"] and all(
        int(r[0]) == i + 1 and float(r[1]) == t["lr_p"]
        and float(r[2]) == t["lambda_reg"] and r[3] == f"{t['acc']:.2f}"
        for i, (r, t) in enumerate(zip(rows, ranked)))
        and "python -m fedamw_tpu_torch.sweep" in text
        and torch.cuda.get_device_name(0) in text)
    ok_b = (finite == sorted(finite, reverse=True) and parses
            and sweep_l == want_b
            and [r["acc"] for r in ranked] == sorted(
                (r["acc"] for r in ranked), reverse=True))
    emit({"phase": "tune", "case": "b sweep", "card": card, **TUNE_SWEEP,
          "trials_ranked": ranked, "finite": finite,
          "report_parses": parses, "seconds": sweep_s,
          "trial_seconds": [r["wall_s"] for r in ranked],
          "launches": sweep_l, "launches_expected": want_b, "ok": ok_b})
    if not ok_b:
        failures.append(f"b: finite {finite}, parses {parses}, launches "
                        f"{sweep_l} (expected {want_b})")

    # (c) the export CLI on main_path's FedAMW checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "main_FedAMW")
        save_checkpoint(ck, amw_res["params"], p=amw_res["p"],
                        round_idx=ROUNDS, rff=setup.rff)
        art = os.path.join(tmp, "artifact")
        out, export_s = _module(["fedamw_tpu_torch.export_artifacts", ck,
                                 art, "--buckets", TUNE_BUCKETS, "--check"])
        summary = None
        try:
            summary = json.loads(out.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            pass
        buckets = [int(b) for b in TUNE_BUCKETS.split(",")]
        ok_c = (out.returncode == 0 and summary is not None
                and summary.get("schema") == ARTIFACT_SCHEMA
                and summary.get("buckets") == buckets
                and summary.get("check", {}).get("compile_count") == 0
                and summary["check"].get("parity") == "bitwise")
        served = {}
        if ok_c:
            top = max(buckets)
            X = np.ascontiguousarray(np.asarray(ds.X_test[:top], np.float32))
            t0 = time.perf_counter()
            loaded = ServingEngine.from_artifact(art, checkpoint=ck)
            load_s = time.perf_counter() - t0
            engine = ServingEngine.load(ck, buckets=tuple(buckets))
            a, e = loaded.predict(X), engine.predict(X)
            served = {"rows": top, "bitwise": bool(np.array_equal(a, e)),
                      "max_abs": float(np.max(np.abs(a - e))),
                      "from_artifact_s": load_s,
                      "compile_count": loaded.compile_count}
            ok_c = served["bitwise"] and loaded.compile_count == 0
            del loaded, engine
    emit({"phase": "tune", "case": "c export CLI", "card": card,
          "buckets": TUNE_BUCKETS, "exit": out.returncode,
          "summary": summary, "served_top_rung": served,
          "seconds": export_s, "stderr_tail": out.stderr[-600:],
          "ok": ok_c})
    if not ok_c:
        failures.append(f"c: exit {out.returncode}, {summary}, {served}: "
                        f"{out.stderr[-1500:]}")
    torch.cuda.empty_cache()
    emit({"phase": "tune", "case": "total", "card": card,
          "seconds": time.perf_counter() - t_phase, "launches": total,
          "ok": not failures})
    if failures:
        fail(f"tune: {failures}")
    return total


WIDE_D = 10000             # wide_d: past the staged kernel's 5,376 at C = 10
WIDE_BOUNDARY_D = 5376     # the staged kernel's widest float32 D at C = 10
WIDE_ROUNDS = 2


def wide_d(ds, prm, kw, amw_kw, timed, vs_plain, card, sms):
    """The ``wide_d`` phase: kernel 1's wide plan at the main
    configuration with ``--D 10000``. (a) The kernel against its plain
    version at J = 50 (float32 rows under the registry's and the strong
    penalties, bfloat16 rows under the strong ones) at the reference
    tolerances, two launches bitwise equal; (b) FedAvg and FedAMW for
    ``WIDE_ROUNDS`` rounds of ``EPOCHS`` local epochs and Centralized for
    ``EPOCHS`` epochs (J = 1), each against its plain run at ``TOL_RUN``,
    every count set to 0 just before each and read just after, every
    kernel-1 launch the wide kernel's; (c) its time, beside the plain
    version's and its bound, ``ms_by_cluster`` (the kernel forced at each
    cluster the card takes, in turns, at J = 50 and at Centralized's J = 1
    launch), the staged and the forced wide plan in turns at
    D = ``WIDE_BOUNDARY_D``, and bfloat16 rows; a line of its own gives
    the bytes a CTA moves a step by the layout's arithmetic at each
    cluster and the compiler's registers and spills of every wide
    instantiation. Returns the ``client_epoch.wide`` row of the
    ``kernels`` line."""
    import numpy as np
    import torch

    from fedamw_tpu_torch.algorithms import (
        Centralized, FedAMW, FedAvg, prepare_setup)
    from fedamw_tpu_torch.fedcore import (
        client_epoch, client_epoch_plain, cuda_build)
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.fedcore.batching import (
        batch_valid, draw_epoch_positions)

    t_phase = time.perf_counter()
    wide = prepare_setup(ds, D=WIDE_D, kernel_par=prm["kernel_par"],
                         seed=SEED, rng=np.random.RandomState(SEED))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    dev, C = wide.device, wide.num_classes
    gen = torch.Generator().manual_seed(SEED)
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    w0 = wide.model.init(gen, WIDE_D, C)["w"].to(dev)
    pos = draw_epoch_positions(dgen, wide.n_max, B, wide.mask, lead=(J,))
    valid = batch_valid(pos, wide.n_max, wide.mask)
    rows = torch.gather(wide.idx, 1, pos.reshape(J, -1)).reshape(
        pos.shape).to(torch.int32).contiguous()
    lr = float(prm["lr"])

    def epoch_args(mu, lam, jitter, X=None):
        W = w0.expand(J, C, WIDE_D) + jitter * torch.randn(
            (J, C, WIDE_D), generator=gen).to(dev)
        return (W.contiguous(), w0, wide.X if X is None else X, wide.y,
                rows, valid, lr, mu, lam, "classification")

    def plan_of(a, **kw):
        name = ek.ROW_LIBRARIES[a[2].dtype]
        return ek.launch_plan(
            int(a[0].shape[0]), int(a[4].shape[2]), C, int(a[0].shape[2]),
            sms, row_bytes=a[2].element_size(),
            max_cluster=ek.wide_max_cluster(dev.index or 0, name),
            active_clusters=ek.wide_active_clusters(dev.index or 0, name),
            steps=ek.client_order(a[5])[1].tolist(), **kw)

    # (a) the kernel against its plain version, two launches bitwise
    cases = {"registry": epoch_args(float(prm["lambda_prox"]),
                                    float(prm["lambda_reg"]), 0.0),
             "strong": epoch_args(0.05, 0.01, 0.01)}
    cases["strong bfloat16"] = (cases["strong"][:2]
                                + (wide.X.to(torch.bfloat16),)
                                + cases["strong"][3:])
    errs = {}
    for label, a in cases.items():
        plan = plan_of(a)
        w1, m1 = client_epoch(*a)
        w2, m2 = client_epoch(*a)
        torch.cuda.synchronize()
        wp, mp = client_epoch_plain(*a)
        ok_w, err_w = close(w1, wp, **TOL_W)
        tot = mp[:, 2].clamp(min=1)
        ok_l, err_l = close(m1[:, 0] / tot, mp[:, 0] / tot, 1e-4, 0)
        ok_a, err_a = close(100 * m1[:, 1] / tot, 100 * mp[:, 1] / tot,
                            1e-3, 0)
        bitwise = bool(torch.equal(w1, w2) and torch.equal(m1, m2))
        row = {"phase": "kernel_check", "kernel": "client_epoch.wide",
               "case": label, "rows": str(a[2].dtype).removeprefix("torch."),
               "plan": dataclasses.asdict(plan),
               "shape": {"J": J, "C": C, "D": WIDE_D,
                         "S": int(rows.shape[1]), "B": B},
               "max_abs_err_w": err_w, "max_abs_err_loss": err_l,
               "max_abs_err_acc": err_a, "tol_w": TOL_W,
               "tol_loss_atol": 1e-4, "tol_acc_atol": 1e-3,
               "two_launches_bitwise": bitwise,
               "ok": ok_w and ok_l and ok_a and bitwise
               and plan.kernel == "wide"}
        emit(row)
        if not row["ok"]:
            fail(f"the wide client_epoch plan ({label}) disagrees with its "
                 "plain version, is not deterministic or did not run")
        errs[label] = err_w

    # (b) the algorithms as exp.py calls them, counted
    wkw = dict(kw, round=WIDE_ROUNDS)
    algos = (
        ("FedAvg", FedAvg, wkw, (EPOCHS * WIDE_ROUNDS, 0)),
        ("FedAMW", FedAMW, dict(amw_kw, round=WIDE_ROUNDS),
         (EPOCHS * WIDE_ROUNDS, WIDE_ROUNDS * WIDE_ROUNDS)),
        ("Centralized", Centralized,
         dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, seed=SEED),
         (EPOCHS, 0)))
    by_algorithm = {}
    for name, fn, fkw, want in algos:
        ref, plain_s = timed(fn, wide, kernel_impl="plain", **fkw)
        reset_counts()
        res, secs = timed(fn, wide, **fkw)
        c = counts()
        ok, diffs = vs_plain(res, ref)
        got = (c["client_epoch"], c["p_epoch"])
        by_algorithm[name] = c["client_epoch_by_kernel"]
        emit({"phase": "wide_d", "algorithm": name, "D": WIDE_D,
              "card": card, "seconds": secs, "seconds_plain": plain_s,
              "test_acc": np.ravel(res["test_acc"]).tolist(),
              "test_loss": np.ravel(res["test_loss"]).tolist(),
              "launches": c, "launches_expected": {
                  "client_epoch": want[0], "p_epoch": want[1]},
              "vs_plain": diffs, "tol": TOL_RUN, "ok": ok})
        if not ok or got != want or c["client_epoch_by_kernel"]["wide"] != \
                got[0]:
            fail(f"{name} at D={WIDE_D} launched {c} (expected {want}, "
                 f"every kernel-1 launch wide) or does not match its plain "
                 f"run: {diffs}")
    launches = sum(c["wide"] for c in by_algorithm.values())

    # (c) times: the wide plan beside its plain version and its bound; the
    # staged and the forced wide plan in turns at the staged kernel's
    # widest D; bfloat16 rows
    a = cases["strong"]
    plan = plan_of(a)
    saved = client_epoch.launches, dict(client_epoch.launches_by_kernel)
    ms = cuda_ms(lambda: client_epoch(*a), 10)
    plain_ms = cuda_ms(lambda: client_epoch_plain(*a), 2)
    Db = WIDE_BOUNDARY_D
    ab = (a[0][..., :Db].contiguous(), a[1][:, :Db].contiguous(),
          a[2][:, :Db].contiguous()) + a[3:]
    turns = {"staged": [], "wide": []}
    for kern in ("staged", "wide", "wide", "staged"):
        turns[kern].append(cuda_ms(lambda: client_epoch(*ab, kernel=kern), 10))
    a16 = cases["strong bfloat16"]
    ms16 = cuda_ms(lambda: client_epoch(*a16), 10)
    # every cluster the card takes, in turns (up, then down), at J = 50 and
    # at Centralized's launch: one client holding every train row, the
    # registry's lr, no penalties
    max_k = ek.wide_max_cluster(dev.index or 0)
    ks = [k for k in ek.WIDE_CLUSTERS if k <= max_k]
    all_idx = wide.all_train_idx
    cpos = draw_epoch_positions(dgen, int(all_idx.numel()), B, lead=(1,))
    cvalid = batch_valid(cpos, int(all_idx.numel()))
    crows = all_idx[cpos].to(torch.int32).contiguous()
    a1 = (w0[None].contiguous(), w0, wide.X, wide.y, crows, cvalid, lr, 0.0,
          0.0, "classification")
    by_cluster = {}
    for label, args, reps in (("J=50", a, 5), ("J=1", a1, 2)):
        t = {k: [] for k in ks}
        for k in ks + ks[::-1]:
            t[k].append(cuda_ms(lambda: client_epoch(
                *args, kernel="wide", cluster=k), reps))
        by_cluster[label] = {str(k): sum(v) / 2 for k, v in t.items()}
    client_epoch.launches, client_epoch.launches_by_kernel = saved
    plan1 = plan_of(a1)
    steps1 = int(ek.client_order(cvalid)[1].max())
    plan16 = plan_of(a16)
    used = {}
    for lib, p_ in (("client_epoch", plan), ("client_epoch_bf16", plan16)):
        u = [v for f, v in cuda_build.ptxas_usage(lib).items()
             if ek.kernel_symbol(p_, C) in f]
        if len(u) != 1 or u[0]["spill_bytes"] != 0:
            fail(f"the wide plan's instantiation in {lib}: ptxas {u}")
        used[lib] = u[0]
    n_rows = float(valid.sum())
    steps = int((valid.sum(-1) > 0).sum())
    steps_max = int(ek.client_order(valid)[1].max())
    step_bytes = {}
    for k in ks:
        p_ = plan_of(a, kernel="wide", cluster=k)
        step_bytes[str(k)] = ek.wide_step_bytes(B, C, WIDE_D, k, p_.w_res,
                                                p_.rows_res)
    wide_usage = {
        lib: {f.split("wide_epoch_kernel")[1][:12]: v
              for f, v in cuda_build.ptxas_usage(lib).items()
              if "17wide_epoch_kernel" in f}
        for lib in ("client_epoch", "client_epoch_bf16", "client_epoch_f16")}
    nbytes = 4 * (n_rows * (WIDE_D + 1) + 2 * J * C * WIDE_D + C * WIDE_D
                  + 2 * rows.numel() + 3 * J)
    ops = 4 * C * WIDE_D * n_rows + 12 * C * WIDE_D * steps
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
    row = {"name": "client_epoch.wide", "route": "cuda",
           "source": "non-iid-distributed-learning-with-optimal-mixture-"
                     "weights_tpu_torch/csrc/client_epoch.cu",
           "replaces": "non-iid-distributed-learning-with-optimal-mixture-"
                       "weights_tpu/fedcore/pallas_kernel.py:40",
           "launches": launches,
           "launches_path": "wide_d (FedAvg, FedAMW, Centralized)",
           "launches_by_algorithm": by_algorithm,
           "max_abs_err": max(errs.values()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "bound_bytes": nbytes, "bound_fp32_ops": ops,
           "library_ms": None, "card": card,
           "shape": {"J": J, "C": C, "D": WIDE_D, "B": B,
                     "S": int(rows.shape[1])},
           "steps_max": steps_max, "us_per_step": 1e3 * ms / steps_max,
           "cluster": plan.cluster, "max_cluster": max_k,
           "active_clusters": ek.wide_active_clusters(dev.index or 0),
           "chunk": plan.chunk, "tile": plan.tile, "stages": plan.stages,
           "w_res": plan.w_res, "rows_res": plan.rows_res,
           "smem_bytes": plan.smem_bytes,
           "scratch_bytes": plan.scratch_bytes,
           "ms_by_cluster": by_cluster,
           "us_per_step_by_cluster": {
               label: {k: 1e3 * v / n for k, v in t.items()}
               for (label, t), n in zip(by_cluster.items(),
                                        (steps_max, steps1))},
           "centralized": {"steps": steps1, "cluster": plan1.cluster,
                           "ms": by_cluster["J=1"][str(plan1.cluster)],
                           "tile": plan1.tile, "stages": plan1.stages,
                           "w_res": plan1.w_res,
                           "rows_res": plan1.rows_res},
           "registers": used["client_epoch"]["registers"],
           "spill_bytes": used["client_epoch"]["spill_bytes"],
           "ms_bfloat16": ms16, "cluster_bfloat16": plan16.cluster,
           "registers_bfloat16": used["client_epoch_bf16"]["registers"],
           "spill_bytes_bfloat16": used["client_epoch_bf16"]["spill_bytes"],
           "ms_boundary": {"D": Db, **{k: sum(v) / 2
                                      for k, v in turns.items()},
                           "cluster": {k: plan_of(ab, kernel=k).cluster
                                       for k in turns}},
           "setup_seconds": setup_s,
           "phase_seconds": time.perf_counter() - t_phase}
    emit({"phase": "wide_d", "layout": {
        "step_bytes_per_cta": step_bytes, "n_rows": B,
        "by": "the layout's arithmetic (epoch_kernel.wide_step_bytes), "
              "not measured"},
          "wide_kernel_ptxas": wide_usage})
    emit({"phase": "wide_d", "kernel_row": row})
    del wide, cases, a, ab, a16, a1
    torch.cuda.empty_cache()
    return row


# LIBSVM's sector set (its multiclass page): train and test rows, raw
# features, classes; the stand-in's non-zeros a row are a choice (the real
# file's density is not known here)
SECTOR = dict(train=6412, test=3207, d=55197, classes=105, nnz=160)
MANY_C = (33, 105)         # kernel 1's class counts on the stand-in's shapes
ALOI_C = 1000              # aloi's class count (LIBSVM's multiclass page)
ALOI_S = 20                # steps of kernel 1's C = 1,000 case
MANY_WIDE_D = 10000        # past the staged plan's D
MANY_ROUNDS = 2
RCV1_C = 53                # LIBSVM's rcv1.multiclass: kernel 2 by plan
RCV1_NVAL = 3113           # 20% of its 15,564 training rows (S = 195)
STREAM_P = (400, ALOI_C, 200)  # kernel 2 streaming client tiles: J, C, n_val
# kernel 2's cluster sweep (J, C, n_val; n_val None: the stand-in's), and
# the shapes the unstaged kernel held before the class-tiled one, timed
# against it in turns
TILED_SWEEP = ((50, 33, None), (50, RCV1_C, None), (50, 105, None),
               (50, ALOI_C, None), (10, 105, None), (400, 105, None))
UNSTAGED_TURNS = ((50, 33, RCV1_NVAL), (50, RCV1_C, RCV1_NVAL),
                  (50, 70, RCV1_NVAL), (10, 105, None), (4, 40, None),
                  (2, 40, None))


def write_standin(path, n, d, classes, nnz, seed):
    """A LIBSVM file of ``n`` rows at ``path``: labels 1..``classes``, each
    class on ``n // classes`` rows or one more; about ``nnz`` sorted
    feature indices a row in 1..``d``, half drawn from the label's own
    block of ``d // classes`` features and half from all ``d``; positive
    values scaled to a unit norm a row (tf-idf-like); index ``d`` on the
    first row, so that both files of a pair parse to ``d`` columns."""
    import numpy as np

    rng = np.random.RandomState(seed)
    y = np.arange(n) % classes
    rng.shuffle(y)
    block = d // classes
    own = rng.randint(0, block, (n, nnz // 2)) + (y * block)[:, None]
    anywhere = rng.randint(0, d, (n, nnz - nnz // 2))
    cols = np.concatenate([own, anywhere], 1)
    cols[0, -1] = d - 1
    lines = []
    for i in range(n):
        c = np.unique(cols[i])
        v = rng.exponential(1.0, c.size)
        v /= np.sqrt(np.square(v).sum())
        lines.append(f"{y[i] + 1} " + " ".join(
            f"{a + 1}:{b:.6g}" for a, b in zip(c.tolist(), v.tolist())))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def many_classes(timed, vs_plain, card, sms):
    """The ``many_classes`` phase: more than 32 classes on the card, on a
    stand-in of LIBSVM's ``sector`` (``SECTOR``'s counts, written from
    ``SEED``) at the main configuration (RFF D = 2,000, J = 50,
    Dirichlet 0.01, batch 32/16, seed 100, the registry's default block).
    (a) The stand-in pair, parsed by the native parser (no fallback). (b)
    Kernel 1's class-tiled wide plan against its plain version at the
    reference tolerances: the stand-in's shape at C = 33 and 105 under the
    registry's and strong penalties, C = 1,000 at S = ``ALOI_S``, C = 105
    at D = 10,000 and with bfloat16 and float16 rows, two launches bitwise
    equal, and the tie case (W = anchor = 0: every logit equal, the first
    maximum class 0, so each client's hits are its label-0 rows). (c) Kernel 2's
    class-tiled split plan against its plain version at ``TOL_P``: the
    stand-in's n_val, J = 50, B = 16, C = 105 and 1,000, unguarded and
    with the simplex guard, two launches bitwise, and also at ``RCV1_C``
    classes by plan, the tie case (logits constant over the classes: every
    first maximum is class 0, so the hits are the valid label-0 rows,
    exactly) and ``STREAM_P`` (the ring streams tiles of clients). (d)
    FedAvg and FedAMW
    ``MANY_ROUNDS`` rounds of ``EPOCHS`` local epochs and Centralized
    ``EPOCHS`` epochs on the stand-in against their plain runs at
    ``TOL_RUN``, counted, every kernel-1 launch the wide tiled plan and
    every kernel-2 launch the split tiled plan. (e) ``python -m
    fedamw_tpu_torch.exp --dataset sector --data_dir ... --round 2`` in a
    subprocess, exit 0 and its (6, 2, 1) pickle. (f) Each tiled plan's
    time beside its plain version and its bound at C = 105 and 1,000;
    kernel 1's forced at each cluster the card takes (held against its
    plain version at the reference tolerances, and timed), the ptxas
    report of the instantiation each row type launches, and a failure on
    any spill of the class-tiled kernel's instantiations; kernel 2's
    class-tiled kernel timed on its class-split logits (made once, as a
    p-solve does; ``class_split_ms`` apart), forced to each cluster at
    ``TILED_SWEEP``'s shapes (``ms_by_cluster``), against the unstaged
    kernel in turns at ``UNSTAGED_TURNS`` (``ms_vs_unstaged``), its ptxas
    report and a failure on a spill. Returns the four rows of the
    ``kernels`` line."""
    import numpy as np
    import torch

    from fedamw_tpu_torch import native_io
    from fedamw_tpu_torch.algorithms import (
        Centralized, FedAMW, FedAvg, prepare_setup)
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore import (
        client_epoch, client_epoch_plain, cuda_build, make_guard, p_epoch,
        p_epoch_plain)
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.batching import (
        batch_valid, draw_epoch_positions)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="many_classes_") as tmp:
        native_io._load()  # the native parser, or fail: no sklearn here
        t0 = time.perf_counter()
        for name, n, seed in (("sector", SECTOR["train"], SEED),
                              ("sector.t", SECTOR["test"], SEED + 1)):
            write_standin(os.path.join(tmp, name), n, SECTOR["d"],
                          SECTOR["classes"], SECTOR["nnz"], seed)
        write_s = time.perf_counter() - t0
        prm = get_parameter("sector")
        t0 = time.perf_counter()
        ds = load_dataset("sector", num_partitions=J, alpha=0.01,
                          data_dir=tmp)
        load_s = time.perf_counter() - t0
        if (ds.source, ds.num_classes, ds.d, len(ds.y_train),
                len(ds.y_test)) != ("file", SECTOR["classes"], SECTOR["d"],
                                    SECTOR["train"], SECTOR["test"]):
            fail(f"the sector stand-in loaded as {ds.source}, C = "
                 f"{ds.num_classes}, d = {ds.d}")
        t0 = time.perf_counter()
        ms = prepare_setup(ds, D=D, kernel_par=prm["kernel_par"], seed=SEED,
                           rng=np.random.RandomState(SEED))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        emit({"phase": "many_classes", "part": "setup", "card": card,
              "rows": {"train": SECTOR["train"], "test": SECTOR["test"]},
              "d": ds.d, "classes": ds.num_classes, "nnz_a_row": SECTOR["nnz"],
              "n_max": ms.n_max, "n_val": int(ms.X_val.shape[0]),
              "client_rows": [int(ms.sizes.min()), int(ms.sizes.max())],
              "write_s": write_s, "load_s": load_s, "setup_s": setup_s})

        dev, N, C = ms.device, int(ms.X.shape[0]), ms.num_classes
        gen = torch.Generator().manual_seed(SEED)
        dgen = torch.Generator(device=dev).manual_seed(SEED)
        pos = draw_epoch_positions(dgen, ms.n_max, B, ms.mask, lead=(J,))
        valid = batch_valid(pos, ms.n_max, ms.mask)
        rows = torch.gather(ms.idx, 1, pos.reshape(J, -1)).reshape(
            pos.shape).to(torch.int32).contiguous()
        lr = float(prm["lr"])

        def epoch_args(Ck, D_, mu, lam, jitter, lr_, X=None, y=None,
                       rows_=rows, valid_=valid, zero=False):
            w0 = (torch.zeros((Ck, D_)) if zero else 0.01 * torch.randn(
                (Ck, D_), generator=gen)).to(dev)
            W = w0.expand(J, Ck, D_) + jitter * torch.randn(
                (J, Ck, D_), generator=gen).to(dev)
            if y is None:
                y = ms.y if Ck == C else (ms.y % Ck).to(torch.int32)
            return (W.contiguous(), w0, ms.X if X is None else X, y, rows_,
                    valid_, lr_, mu, lam, "classification")

        def plan1(a, **kw):
            lib = ek.ROW_LIBRARIES[a[2].dtype]
            return ek.launch_plan(
                J, B, int(a[0].shape[1]), int(a[0].shape[2]), sms,
                row_bytes=a[2].element_size(),
                max_cluster=ek.wide_max_cluster(dev.index or 0, lib),
                active_clusters=ek.wide_active_clusters(dev.index or 0, lib),
                steps=ek.client_order(a[5])[1].tolist(), **kw)

        # (b) kernel 1
        k1 = {}
        for Ck in MANY_C:
            k1[f"C={Ck} registry"] = epoch_args(
                Ck, D, float(prm["lambda_prox"]), float(prm["lambda_reg"]),
                0.0, lr)
            k1[f"C={Ck} strong"] = epoch_args(Ck, D, 0.05, 0.01, 0.01, 0.1)
        rows_a = torch.randint(0, N, (J, ALOI_S, B), generator=dgen,
                               device=dev, dtype=torch.int32)
        valid_a = (torch.rand((J, ALOI_S, B), generator=dgen, device=dev)
                   < 0.8).float()
        y_a = torch.randint(0, ALOI_C, (N,), generator=dgen, device=dev,
                            dtype=torch.int32)
        k1[f"C={ALOI_C} strong"] = epoch_args(
            ALOI_C, D, 0.05, 0.01, 0.01, 0.1, y=y_a, rows_=rows_a,
            valid_=valid_a)
        X_wide = torch.randn((N, MANY_WIDE_D), generator=dgen,
                             device=dev) / MANY_WIDE_D ** 0.5
        k1[f"C={C} D={MANY_WIDE_D} strong"] = epoch_args(
            C, MANY_WIDE_D, 0.05, 0.01, 0.01, 0.1, X=X_wide)
        a = k1[f"C={C} strong"]
        for dt in (torch.bfloat16, torch.float16):
            k1[f"C={C} strong {str(dt).removeprefix('torch.')}"] = (
                a[:2] + (a[2].to(dt),) + a[3:])
        k1[f"C={C} tie"] = epoch_args(
            C, D, 0.05, 0.01, 0.0, 0.1, rows_=rows[:, :1].contiguous(),
            valid_=valid[:, :1].contiguous(), zero=True)
        k1_err = {}
        for label, a in k1.items():
            plan = plan1(a)
            w1, m1 = client_epoch(*a)
            w2, m2 = client_epoch(*a)
            torch.cuda.synchronize()
            wp, mp = client_epoch_plain(*a)
            ok_w, err_w = close(w1, wp, **TOL_W)
            tot = mp[:, 2].clamp(min=1)
            ok_l, err_l = close(m1[:, 0] / tot, mp[:, 0] / tot, 1e-4, 0)
            ok_a, err_a = close(100 * m1[:, 1] / tot, 100 * mp[:, 1] / tot,
                                1e-3, 0)
            bitwise = bool(torch.equal(w1, w2) and torch.equal(m1, m2))
            row = {"phase": "kernel_check", "kernel": "client_epoch.tiled",
                   "case": label, "rows": str(a[2].dtype).removeprefix(
                       "torch."), "plan": dataclasses.asdict(plan),
                   "shape": {"J": J, "C": int(a[0].shape[1]),
                             "D": int(a[0].shape[2]),
                             "S": int(a[4].shape[1]), "B": B},
                   "max_abs_err_w": err_w, "max_abs_err_loss": err_l,
                   "max_abs_err_acc": err_a, "tol_w": TOL_W,
                   "tol_loss_atol": 1e-4, "tol_acc_atol": 1e-3,
                   "two_launches_bitwise": bitwise,
                   "ok": ok_w and ok_l and ok_a and bitwise
                   and plan.kernel == "wide_tiled"}
            if label.endswith("tie"):
                # every logit 0: the first maximum is class 0, so a
                # client's hits are its valid label-0 rows, exactly
                zeros = ((a[3][a[4][:, 0].long()] == 0).float()
                         * a[5][:, 0]).sum(-1)
                row["hits"] = float(m1[:, 1].sum())
                row["label0_rows"] = float(zeros.sum())
                row["ok"] = row["ok"] and bool(torch.equal(m1[:, 1], zeros))
            emit(row)
            if not row["ok"]:
                fail(f"the tiled client_epoch plan ({label}) disagrees with "
                     "its plain version, is not deterministic or did not run")
            k1_err[label] = err_w

        # (c) kernel 2
        n_val = int(ms.X_val.shape[0])
        ppos = draw_epoch_positions(dgen, n_val, VB)
        pvalid = batch_valid(ppos, n_val)
        ppos = ppos.to(torch.int32)
        S2 = int(ppos.shape[0])

        def p_args(Ck, J_=J, n=None):
            """One p-epoch's inputs at Ck classes and J_ clients over the
            stand-in's validation shuffle, or one of ``n`` rows."""
            pos_, valid_ = ppos, pvalid
            if n is not None:
                pos_ = draw_epoch_positions(dgen, n, VB)
                valid_ = batch_valid(pos_, n)
                pos_ = pos_.to(torch.int32)
            n_ = n or n_val
            logits = torch.randn((n_, J_, Ck), generator=dgen,
                                 device=dev) / J_ ** 0.5
            y2 = torch.randint(0, Ck, (n_,), generator=dgen, device=dev,
                               dtype=torch.int32)
            p0 = torch.rand(J_, generator=dgen, device=dev)
            cv2 = torch.ones(J_, device=dev)
            cv2[::9] = 0.0
            return ((3.0 * p0 / p0.norm()).contiguous(), torch.zeros_like(p0),
                    cv2, logits, y2, pos_, valid_,
                    float(prm.get("lr_p", 1e-3)), 0.9, "classification")

        k2 = {Ck: p_args(Ck) for Ck in (C, ALOI_C, RCV1_C)}
        tie = list(p_args(C))
        tie[3] = tie[3][:, :, :1].expand(-1, -1, C).contiguous()
        tie[4] = torch.where(torch.arange(n_val, device=dev) % 3 == 0, 0,
                             tie[4]).to(torch.int32)
        cases2 = {f"C={Ck}": (a, (None, "simplex")) for Ck, a in k2.items()}
        cases2[f"C={C} tie"] = (tuple(tie), (None,))
        Js, Cs, ns = STREAM_P
        cases2[f"J={Js} C={Cs} streamed"] = (p_args(Cs, Js, ns),
                                             (None, "simplex"))
        k_max = pk.split_max_cluster(dev.index or 0)
        k2_err, k2_plans = {}, {}
        for label, (a, guards) in cases2.items():
            Jk, Ck = int(a[3].shape[1]), int(a[3].shape[2])
            for guard in guards:
                g = make_guard(guard) if guard else None
                plan = pk.launch_plan(VB, Jk, Ck, max_cluster=k_max)
                p1 = p_epoch(*a, guard=g)
                p2 = p_epoch(*a, guard=g)
                torch.cuda.synchronize()
                pp, bp, mp = p_epoch_plain(*a, guard=g)
                ok_p, err_p = close(p1[0], pp, **TOL_P)
                ok_b, err_b = close(p1[1], bp, **TOL_P)
                ok_m, err_m = close(p1[2][:2] / p1[2][2], mp[:2] / mp[2], 0,
                                    2e-5)
                bitwise = all(bool(torch.equal(u, v)) for u, v in zip(p1, p2))
                row = {"phase": "kernel_check", "kernel": "p_epoch.tiled",
                       "case": label, "guard": guard or "none",
                       "shape": {"n_val": int(a[3].shape[0]), "J": Jk,
                                 "C": Ck, "B": VB, "S": int(a[5].shape[0])},
                       "plan": dataclasses.asdict(plan),
                       "max_abs_err_p": err_p, "max_abs_err_buf": err_b,
                       "max_abs_err_metrics": err_m, "tol": TOL_P,
                       "p_sum": float(p1[0].sum()),
                       "two_launches_bitwise": bitwise,
                       "ok": ok_p and ok_b and ok_m and bitwise
                       and plan.kernel == "split_tiled"}
                if label.endswith("tie"):
                    # every z row flat: the first maximum over all C is
                    # class 0 (rank 0's), so the hits are the valid label-0
                    # rows, exactly
                    zeros = float(((a[4][a[5].long()] == 0).float()
                                   * a[6]).sum())
                    row["hits"], row["label0_rows"] = float(p1[2][1]), zeros
                    row["ok"] = row["ok"] and row["hits"] == zeros
                if label.endswith("streamed"):
                    row["ok"] = row["ok"] and plan.stream
                if g is not None:
                    # the guard's cost (the guarded launch less the
                    # unguarded one, a step) and the simplex's rounds
                    saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
                    rounds = torch.zeros(2, dtype=torch.int32, device=dev)
                    p_epoch(*a, guard=g, guard_rounds=rounds)
                    ms_g = cuda_ms(lambda: p_epoch(*a, guard=g), 3)
                    ms_u = cuda_ms(lambda: p_epoch(*a), 3)
                    p_epoch.launches, p_epoch.launches_by_kernel = saved
                    S_ = int(a[5].shape[0])
                    row.update({
                        "ms": ms_g, "ms_unguarded": ms_u,
                        "guard_us_per_step": 1e3 * (ms_g - ms_u) / S_,
                        "guard_rounds_per_step": rounds[0].item() / S_,
                        "guard_rounds_max": rounds[1].item()})
                emit(row)
                if not row["ok"]:
                    fail(f"the tiled p_epoch plan ({label}, guard {guard}) "
                         "disagrees with its plain version, is not "
                         "deterministic or did not run as planned")
                k2_err[label] = max(k2_err.get(label, 0.0), err_p, err_b)
                k2_plans[label] = plan

        # (d) the algorithms on the stand-in, counted
        kw = dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, round=MANY_ROUNDS,
                  seed=SEED, lr_mode="constant", return_state=True)
        algos = (
            ("FedAvg", FedAvg, kw, (EPOCHS * MANY_ROUNDS, 0)),
            ("FedAMW", FedAMW, dict(kw, lambda_reg=prm["lambda_reg"],
                                    lr_p=prm.get("lr_p", 1e-3),
                                    val_batch_size=VB),
             (EPOCHS * MANY_ROUNDS, MANY_ROUNDS * MANY_ROUNDS)),
            ("Centralized", Centralized,
             dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, seed=SEED),
             (EPOCHS, 0)))
        by_algorithm = {}
        for name, fn, fkw, want in algos:
            ref, plain_s = timed(fn, ms, kernel_impl="plain", **fkw)
            reset_counts()
            res, secs = timed(fn, ms, **fkw)
            c = counts()
            ok, diffs = vs_plain(res, ref)
            got = (c["client_epoch"], c["p_epoch"])
            tiled = (c["client_epoch_by_kernel"]["wide_tiled"],
                     c["p_epoch_by_kernel"]["split_tiled"])
            by_algorithm[name] = c
            emit({"phase": "many_classes", "algorithm": name, "C": C,
                  "card": card, "seconds": secs, "seconds_plain": plain_s,
                  "test_acc": np.ravel(res["test_acc"]).tolist(),
                  "test_loss": np.ravel(res["test_loss"]).tolist(),
                  "launches": c, "launches_expected": {
                      "client_epoch": want[0], "p_epoch": want[1]},
                  "vs_plain": diffs, "tol": TOL_RUN, "ok": ok})
            if not ok or got != want or tiled != got:
                fail(f"{name} at C={C} launched {c} (expected {want}, every "
                     f"launch on a tiled plan) or does not match its plain "
                     f"run: {diffs}")

        # (e) the driver on the stand-in pair
        out_dir = os.path.join(tmp, "results")
        drv, drv_s = _module(["fedamw_tpu_torch.exp", "--dataset", "sector",
                              "--data_dir", tmp, "--round", str(MANY_ROUNDS),
                              "--result_dir", out_dir])
        shapes, finite = {}, False
        if drv.returncode == 0:
            with open(os.path.join(out_dir, "exp1_sector.pkl"), "rb") as f:
                data = pickle.load(f)
            shapes = {k: list(np.shape(data[k]))
                      for k in ("train_loss", "test_loss", "test_acc")}
            finite = all(bool(np.all(np.isfinite(data[k]))) for k in shapes)
        drv_ok = (drv.returncode == 0 and finite and all(
            v == [6, MANY_ROUNDS, 1] for v in shapes.values()))
        emit({"phase": "many_classes", "part": "driver", "seconds": drv_s,
              "returncode": drv.returncode, "shapes": shapes,
              "finite": finite, "stdout_tail": drv.stdout.splitlines()[-6:],
              "stderr_tail": drv.stderr.splitlines()[-6:], "ok": drv_ok})
        if not drv_ok:
            fail("the driver on the sector stand-in did not exit 0 with its "
                 "(6, R, 1) pickle")

        # (f) times, bounds, plans
        def ptxas(library, symbol):
            u = [v for f, v in cuda_build.ptxas_usage(library).items()
                 if symbol in f]
            return u[0] if len(u) == 1 else {}

        # every instantiation of the class-tiled kernel (a row type and a
        # source of W each) must build without spills
        tiled_usage = {lib: {f: u for f, u in cuda_build.ptxas_usage(
            lib).items() if "wide_tiled_epoch_kernel" in f}
            for lib in ek.ROW_LIBRARIES.values()}
        if any(len(v) != 3 or any(u.get("spill_bytes") != 0
                                  for u in v.values())
               for v in tiled_usage.values()):
            fail(f"the class-tiled kernel's instantiations: ptxas "
                 f"{tiled_usage}")

        launches1 = sum(c["client_epoch_by_kernel"]["wide_tiled"]
                        for c in by_algorithm.values())
        launches2 = sum(c["p_epoch_by_kernel"]["split_tiled"]
                        for c in by_algorithm.values())
        src = "non-iid-distributed-learning-with-optimal-mixture-weights_tpu"
        rows_out = []
        for Ck, label in ((C, f"C={C} strong"), (ALOI_C, f"C={ALOI_C} strong")):
            a = k1[label]
            plan = plan1(a)
            saved = client_epoch.launches, dict(client_epoch.launches_by_kernel)
            t_ms = cuda_ms(lambda: client_epoch(*a), 5)
            # each cluster the card takes, forced, held against the plain
            # version and timed
            by_cluster, err_by_cluster = {}, {}
            wp, _ = client_epoch_plain(*a)
            for k in ek.WIDE_CLUSTERS:
                if k > ek.wide_max_cluster(dev.index or 0) or k > Ck:
                    continue
                wk, _ = client_epoch(*a, kernel="wide_tiled", cluster=k)
                ok_k, err_by_cluster[k] = close(wk, wp, **TOL_W)
                if not ok_k:
                    fail(f"the tiled client_epoch plan at C={Ck} forced at "
                         f"cluster {k} disagrees with its plain version")
                by_cluster[k] = cuda_ms(
                    lambda: client_epoch(*a, kernel="wide_tiled", cluster=k),
                    5)
            client_epoch.launches, client_epoch.launches_by_kernel = saved
            p_ms = cuda_ms(lambda: client_epoch_plain(*a), 2)
            n_rows = float(a[5].sum())
            steps = int((a[5].sum(-1) > 0).sum())
            steps_max = int(ek.client_order(a[5])[1].max())
            nbytes = 4 * (n_rows * (D + 1) + 2 * J * Ck * D + Ck * D
                          + 2 * a[4].numel() + 3 * J)
            ops = 4 * Ck * D * n_rows + 12 * Ck * D * steps
            t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
            used = ptxas("client_epoch", ek.kernel_symbol(plan, Ck))
            # the plan and the instantiation each row type launches here
            by_dtype = {}
            for dt, lib in ek.ROW_LIBRARIES.items():
                plan_dt = plan1(a[:2] + (a[2].to(dt),) + a[3:])
                by_dtype[str(dt).removeprefix("torch.")] = {
                    "cluster": plan_dt.cluster, "w_res": plan_dt.w_res,
                    **ptxas(lib, ek.kernel_symbol(plan_dt, Ck))}
            rows_out.append({
                "name": f"client_epoch.classes_{Ck}", "route": "cuda",
                "source": f"{src}_torch/csrc/client_epoch.cu",
                "replaces": f"{src}/fedcore/pallas_kernel.py:40",
                "launches": launches1,
                "launches_path": "many_classes (FedAvg, FedAMW, Centralized "
                                 f"at C = {C})",
                "max_abs_err": k1_err[label], "ms": t_ms, "plain_ms": p_ms,
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bound_bytes": nbytes, "bound_fp32_ops": ops,
                "library_ms": None, "card": card,
                "shape": {"J": J, "C": Ck, "D": D, "B": B,
                          "S": int(a[4].shape[1])},
                "steps_max": steps_max, "us_per_step": 1e3 * t_ms / steps_max,
                "plan": dataclasses.asdict(plan),
                "ms_by_cluster": by_cluster,
                "max_abs_err_by_cluster": err_by_cluster,
                "registers": used.get("registers"),
                "spill_bytes": used.get("spill_bytes"),
                "ptxas_by_dtype": by_dtype})
        # at 32 classes the instantiated wide kernel (the rounded 32, its
        # class loops stopping at C) and the class-tiled one, forced, in
        # turns on the same inputs
        a = epoch_args(32, D, 0.05, 0.01, 0.01, 0.1)
        saved = client_epoch.launches, dict(client_epoch.launches_by_kernel)
        turns = {"wide": [], "wide_tiled": []}
        for kern in ("wide", "wide_tiled", "wide_tiled", "wide"):
            turns[kern].append(cuda_ms(lambda: client_epoch(*a, kernel=kern),
                                       5))
        client_epoch.launches, client_epoch.launches_by_kernel = saved
        rows_out[0]["ms_forced_c32"] = {k: sum(v) / 2
                                        for k, v in turns.items()}
        plan32 = plan1(a, kernel="wide")
        used32 = ptxas("client_epoch", ek.kernel_symbol(plan32, 32))
        rows_out[0]["forced_c32_plan"] = {
            "cluster": plan32.cluster, "chunk": plan32.chunk,
            "smem_bytes": plan32.smem_bytes, **used32}
        if used32.get("spill_bytes") != 0:
            fail(f"the wide kernel's 32-class instantiation: ptxas {used32}")
        # kernel 2: each size of TILED_SWEEP's shapes forced, on its own
        # class-split logits; then the unstaged kernel against the
        # class-tiled one, in turns, where the unstaged kernel took the
        # shape before
        saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
        sweep = {}
        for Jk, Ck, n in TILED_SWEEP:
            a = (k2[Ck] if Jk == J and Ck in k2 and n is None
                 else p_args(Ck, Jk, n))
            by_k = {}
            for k in pk.TILED_CLUSTERS:
                if k > min(k_max, Ck):
                    continue
                prep = pk.class_split(a[3], k)
                by_k[k] = cuda_ms(lambda: p_epoch(
                    *a, kernel="split_tiled", cluster=k,
                    split_logits=prep), 3)
                del prep
            plan = pk.launch_plan(VB, Jk, Ck, max_cluster=k_max)
            sweep[f"J={Jk} C={Ck}"] = {
                "n_val": int(a[3].shape[0]), "ms_by_cluster": by_k,
                "plan_cluster": plan.cluster,
                "fastest": min(by_k, key=by_k.get)}
        vs_unstaged = {}
        for Jk, Ck, n in UNSTAGED_TURNS:
            a = p_args(Ck, Jk, n)
            plan = pk.launch_plan(VB, Jk, Ck, max_cluster=k_max)
            prep = pk.class_split(a[3], plan.cluster)
            run = {"unstaged": lambda: p_epoch(*a, kernel="unstaged"),
                   "split_tiled": lambda: p_epoch(*a, split_logits=prep)}
            turns = {"unstaged": [], "split_tiled": []}
            for kern in ("unstaged", "split_tiled", "split_tiled",
                         "unstaged"):
                turns[kern].append(cuda_ms(run[kern], 3))
            vs_unstaged[f"J={Jk} C={Ck}"] = {
                "n_val": int(a[3].shape[0]), "S": int(a[5].shape[0]),
                "plan": plan.kernel, "cluster": plan.cluster,
                **{kern: sum(v) / 2 for kern, v in turns.items()}}
            del a, prep
        p_epoch.launches, p_epoch.launches_by_kernel = saved
        emit({"phase": "many_classes", "part": "p_epoch tiled sweep",
              "card": card, "B": VB, "ms_by_cluster": sweep,
              "ms_vs_unstaged": vs_unstaged})
        for label, Ck in ((f"C={C}", C), (f"C={ALOI_C}", ALOI_C)):
            a = k2[Ck]
            plan = k2_plans[label]
            prep = pk.class_split(a[3], plan.cluster)
            saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
            t_ms = cuda_ms(lambda: p_epoch(*a, split_logits=prep), 5)
            split_ms = cuda_ms(lambda: pk.class_split(a[3], plan.cluster), 2)
            p_epoch.launches, p_epoch.launches_by_kernel = saved
            p_ms = cuda_ms(lambda: p_epoch_plain(*a), 2)
            nbytes = 4 * (n_val * J * Ck + n_val + 2 * S2 * VB + 5 * J + 3)
            ops = 4 * n_val * J * Ck + 4 * J * S2
            t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
            used = ptxas("p_epoch", pk.kernel_symbol(plan, Ck))
            used_g = ptxas("p_epoch", pk.kernel_symbol(plan, Ck, guarded=True))
            if used.get("spill_bytes") != 0 or used_g.get("spill_bytes") != 0:
                fail(f"the class-tiled split kernel: ptxas {used}, guarded "
                     f"{used_g}")
            rows_out.append({
                "name": f"p_epoch.classes_{Ck}", "route": "cuda",
                "source": f"{src}_torch/csrc/p_epoch.cu",
                "replaces": f"{src}/fedcore/pallas_psolver.py:38",
                "launches": launches2,
                "launches_path": f"many_classes (FedAMW at C = {C})",
                "max_abs_err": k2_err[label], "ms": t_ms, "plain_ms": p_ms,
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bound_bytes": nbytes, "bound_fp32_ops": ops,
                "library_ms": None, "card": card,
                "shape": {"n_val": n_val, "J": J, "C": Ck, "B": VB, "S": S2},
                "us_per_step": 1e3 * t_ms / S2,
                "class_split_ms": split_ms,
                "plan": dataclasses.asdict(plan),
                "ms_by_cluster": sweep[f"J={J} C={Ck}"]["ms_by_cluster"],
                "registers": used.get("registers"),
                "spill_bytes": used.get("spill_bytes"),
                "registers_guarded": used_g.get("registers"),
                "spill_bytes_guarded": used_g.get("spill_bytes")})
            del prep
        rows_out[-2]["ms_by_shape_and_cluster"] = sweep
        rows_out[-2]["ms_vs_unstaged"] = vs_unstaged
        emit({"phase": "many_classes", "kernel_rows": rows_out,
              "phase_seconds": time.perf_counter() - t_phase})
    del ms, k1, k2, cases2, tie, X_wide, a
    torch.cuda.empty_cache()
    return rows_out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port's kernels on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fedamw_tpu_torch  # noqa: F401  (the alias module of this repo)
    from fedamw_tpu_torch import exp
    from fedamw_tpu_torch.algorithms import (
        Centralized, Distributed, FedAMW, FedAMW_OneShot, FedAvg, FedNova,
        prepare_setup)
    from fedamw_tpu_torch.config import get_parameter
    from fedamw_tpu_torch.data import load_dataset
    from fedamw_tpu_torch.fedcore import (
        client_epoch, client_epoch_plain, client_logits, make_p_solver,
        p_epoch, p_epoch_plain)
    from fedamw_tpu_torch.fedcore import cuda_build, make_guard
    from fedamw_tpu_torch.fedcore import epoch_kernel as ek
    from fedamw_tpu_torch.fedcore import psolver_kernel as pk
    from fedamw_tpu_torch.fedcore.batching import (
        batch_valid, draw_epoch_positions)
    from fedamw_tpu_torch.utils.flops import (
        client_update_flops, fwd_flops_per_sample)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": built, "dir": str(cuda_build.BUILD_DIR)})
    for name in cuda_build.BUILDS:
        usage = cuda_build.ptxas_usage(name)
        spills = {f: u for f, u in usage.items() if u.get("spill_bytes")}
        emit({"phase": "ptxas", "library": name,
              "source": f"csrc/{cuda_build.source_path(name).name}",
              "flags": list(cuda_build.BUILDS[name][1]),
              "kernels": len(usage), "max_registers": max(
                  (u.get("registers", 0) for u in usage.values()),
                  default=0), "spilling": spills})

    # -- 2. the main path's data and setup --------------------------------
    prm = get_parameter("mnist")
    t0 = time.perf_counter()
    ds = load_dataset("mnist", num_partitions=J, alpha=prm["alpha_Dirk"])
    setup = prepare_setup(ds, D=D, kernel_par=prm["kernel_par"], seed=SEED,
                          rng=np.random.RandomState(SEED))
    torch.cuda.synchronize()
    emit({"phase": "setup", "source": ds.source, "seconds":
          time.perf_counter() - t0, "N": int(setup.X.shape[0]), "D": D,
          "J": setup.num_clients, "n_max": setup.n_max,
          "n_val": int(setup.X_val.shape[0]),
          "n_test": int(setup.X_test.shape[0])})
    dev = setup.device
    C = setup.num_classes

    # -- 3. each kernel against its plain version, main-path shapes -------
    gen = torch.Generator().manual_seed(SEED)
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    w0 = setup.model.init(gen, D, C)["w"].to(dev)
    pos = draw_epoch_positions(dgen, setup.n_max, B, setup.mask, lead=(J,))
    valid = batch_valid(pos, setup.n_max, setup.mask)
    rows = torch.gather(setup.idx, 1, pos.reshape(J, -1)).reshape(
        pos.shape).to(torch.int32).contiguous()
    y_reg = torch.randn(setup.X.shape[0], generator=gen).to(dev)
    lr = float(prm["lr"])
    # the registry's penalties (mu 1e-6, lam 5e-6) move W by less than
    # TOL_W over an epoch, so a second case starts every client from its
    # own perturbation of the anchor under penalties large enough to show
    # (those of the cuda-marked test in tests/test_torch_epoch_kernel.py)
    penalties = {"registry": (float(prm["lambda_prox"]),
                              float(prm["lambda_reg"]), 0.0),
                 "strong": (0.05, 0.01, 0.01)}
    k1_in = {}
    for pen, (mu, lam, jitter) in penalties.items():
        for task, y_all, Ct in (("classification", setup.y, C),
                                ("regression", y_reg, 1)):
            anchor = w0[:Ct].contiguous()
            W = anchor.expand(J, Ct, D) + jitter * torch.randn(
                (J, Ct, D), generator=gen).to(dev)
            k1_in[task, pen] = (W.contiguous(), anchor, setup.X, y_all,
                                rows, valid, lr, mu, lam, task)
    # Centralized's launch: one client holding every valid train row
    # (J=1, S ~ 1501 steps), no penalties
    all_idx = setup.all_train_idx
    n_all = int(all_idx.numel())
    cpos = draw_epoch_positions(dgen, n_all, B, lead=(1,))
    cvalid = batch_valid(cpos, n_all)
    crows = all_idx[cpos].to(torch.int32).contiguous()
    k1_in["classification", "centralized"] = (
        w0[None].contiguous(), w0, setup.X, setup.y, crows, cvalid, lr, 0.0,
        0.0, "classification")
    k1_err, stacked = 0.0, {}
    for (task, pen), args in k1_in.items():
        wk, mk = client_epoch(*args)
        torch.cuda.synchronize()
        wp, mp = client_epoch_plain(*args)
        ok_w, err_w = close(wk, wp, **TOL_W)
        tot = mp[:, 2].clamp(min=1)
        ok_l, err_l = close(mk[:, 0] / tot, mp[:, 0] / tot, 1e-4, 0)
        ok_a, err_a = close(100 * mk[:, 1] / tot, 100 * mp[:, 1] / tot,
                            1e-3, 0)
        emit({"phase": "kernel_check", "kernel": "client_epoch",
              "task": task, "penalties": pen, "mu": args[7],
              "lam": args[8], "shape": {"J": int(wk.shape[0]),
                                      "C": int(wk.shape[1]), "D": D,
                                      "S": int(args[4].shape[1]), "B": B},
              "max_abs_err_w": err_w, "max_abs_err_loss": err_l,
              "max_abs_err_acc": err_a, "tol_w": TOL_W,
              "tol_loss_atol": 1e-4, "tol_acc_atol": 1e-3,
              "ok": ok_w and ok_l and ok_a})
        if not (ok_w and ok_l and ok_a):
            fail(f"client_epoch ({task}, {pen} penalties) disagrees with "
                 "its plain version")
        k1_err = max(k1_err, err_w)
        if pen == "registry":
            stacked[task] = wk

    # kernel 1 with 2-byte rows (feature_dtype): the main shape and
    # Centralized's, against the plain version on the same narrow rows
    k1_narrow_err = {}
    for dtype in (torch.bfloat16, torch.float16):
        Xn = setup.X.to(dtype)
        for shape in (("classification", "registry"),
                      ("classification", "centralized")):
            args = k1_in[shape]
            args = args[:2] + (Xn,) + args[3:]
            wk, mk = client_epoch(*args)
            torch.cuda.synchronize()
            wp, mp = client_epoch_plain(*args)
            ok_w, err_w = close(wk, wp, **TOL_W)
            tot = mp[:, 2].clamp(min=1)
            ok_l, err_l = close(mk[:, 0] / tot, mp[:, 0] / tot, 1e-4, 0)
            ok_a, err_a = close(100 * mk[:, 1] / tot, 100 * mp[:, 1] / tot,
                                1e-3, 0)
            name = str(dtype).removeprefix("torch.")
            emit({"phase": "kernel_check", "kernel": "client_epoch",
                  "rows": name, "case": shape[1],
                  "shape": {"J": int(wk.shape[0]), "C": C, "D": D,
                            "S": int(args[4].shape[1]), "B": B},
                  "max_abs_err_w": err_w, "max_abs_err_loss": err_l,
                  "max_abs_err_acc": err_a, "tol_w": TOL_W,
                  "ok": ok_w and ok_l and ok_a})
            if not (ok_w and ok_l and ok_a):
                fail(f"client_epoch with {name} rows ({shape[1]}) disagrees "
                     "with its plain version")
            k1_narrow_err[name] = max(k1_narrow_err.get(name, 0.0), err_w)

    n_val = int(setup.X_val.shape[0])
    ppos = draw_epoch_positions(dgen, n_val, VB)
    pvalid = batch_valid(ppos, n_val)
    ppos = ppos.to(torch.int32)
    yv_reg = torch.randn(n_val, generator=gen).to(dev)
    cv = (setup.sizes > 0).to(torch.float32)
    # a third case: momentum 0 and a few more clients masked out
    cv_masked = cv.clone()
    cv_masked[::7] = 0.0
    p_in = {}
    for task, yv in (("classification", setup.y_val), ("regression", yv_reg)):
        logits = client_logits(setup.model.apply, {"w": stacked[task]},
                               setup.X_val)
        p_in[task, "momentum 0.9"] = (
            setup.p_fixed.contiguous(), torch.zeros_like(setup.p_fixed), cv,
            logits, yv, ppos, pvalid, float(prm["lr_p"]), 0.9, task)
    p_in["classification", "momentum 0, cv masked"] = (
        p_in["classification", "momentum 0.9"][:2] + (cv_masked,)
        + p_in["classification", "momentum 0.9"][3:8] + (0.0,
                                                          "classification"))
    k2_err = 0.0
    for (task, case), args in p_in.items():
        pk_, bk, mk = p_epoch(*args)
        torch.cuda.synchronize()
        pp, bp, mp = p_epoch_plain(*args)
        ok_p, err_p = close(pk_, pp, **TOL_P)
        ok_b, err_b = close(bk, bp, **TOL_P)
        ok_m, err_m = close(mk[:2] / mk[2], mp[:2] / mp[2], 0, 2e-5)
        frozen = bool((pk_[args[2] == 0] == args[0][args[2] == 0]).all())
        emit({"phase": "kernel_check", "kernel": "p_epoch", "task": task,
              "case": case, "clients_masked": int((args[2] == 0).sum()),
              "shape": {"n_val": n_val, "J": J,
                        "C": int(args[3].shape[2]), "B": VB,
                        "S": int(ppos.shape[0])},
              "plan": pk.launch_plan(VB, J, int(args[3].shape[2])).kernel,
              "max_abs_err_p": err_p, "max_abs_err_buf": err_b,
              "max_abs_err_metrics": err_m, "tol": TOL_P,
              "masked_clients_frozen": frozen,
              "ok": ok_p and ok_b and ok_m and frozen})
        if not (ok_p and ok_b and ok_m and frozen):
            fail(f"p_epoch ({task}, {case}) disagrees with its plain version")
        k2_err = max(k2_err, err_p, err_b)

    # kernel 2 past one CTA (the split plan) and with each p-guard on each
    # plan: random logits scaled by 1/sqrt(J) (an SGD step stays well
    # conditioned at every J), labels of C classes, every ninth client
    # masked, the main path's shuffle; p starts at norm 3, off the
    # simplex and past both clip radii, so every guard acts from the first
    # step
    k_max = pk.split_max_cluster(dev.index or 0)

    def p_case(J2, C2):
        logits = torch.randn((n_val, J2, C2), generator=dgen,
                             device=dev) / J2 ** 0.5
        y2 = torch.randint(0, C2, (n_val,), generator=dgen, device=dev,
                           dtype=torch.int32)
        p0 = torch.rand(J2, generator=dgen, device=dev)
        cv2 = torch.ones(J2, device=dev)
        cv2[::9] = 0.0
        return ((3.0 * p0 / p0.norm()).contiguous(), torch.zeros_like(p0),
                cv2, logits, y2, ppos, pvalid, float(prm["lr_p"]), 0.9,
                "classification")

    def p_check(args, label, kernel=None, guard=None):
        g = make_guard(guard) if guard else None
        pk_, bk, mk = p_epoch(*args, kernel=kernel, guard=g)
        torch.cuda.synchronize()
        pp, bp, mp = p_epoch_plain(*args, guard=g)
        ok_p, err_p = close(pk_, pp, **TOL_P)
        ok_b, err_b = close(bk, bp, **TOL_P)
        ok_m, err_m = close(mk[:2] / mk[2], mp[:2] / mp[2], 0, 2e-5)
        _, J2, C2 = args[3].shape
        plan = pk.launch_plan(VB, J2, C2, kernel=kernel, max_cluster=k_max,
                              guarded=g is not None)
        row = {"phase": "kernel_check", "kernel": "p_epoch", "case": label,
               "guard": guard or "none",
               "shape": {"n_val": n_val, "J": J2, "C": C2, "B": VB,
                         "S": int(ppos.shape[0])},
               "plan": dataclasses.asdict(plan),
               "max_abs_err_p": err_p, "max_abs_err_buf": err_b,
               "max_abs_err_metrics": err_m, "tol": TOL_P,
               "p_sum": float(pk_.sum()), "p_norm": float(pk_.norm()),
               "ok": ok_p and ok_b and ok_m}
        emit(row)
        if not row["ok"]:
            fail(f"p_epoch ({label}, guard {guard}) disagrees with its "
                 "plain version")
        return max(err_p, err_b), plan

    split_in, split_plans = {}, {}
    for J2, C2 in SPLIT_SHAPES:
        split_in[J2, C2] = p_case(J2, C2)
        err, split_plans[J2, C2] = p_check(split_in[J2, C2],
                                           f"split J={J2} C={C2}")
        if split_plans[J2, C2].kernel != "split":
            fail(f"J={J2}, C={C2} does not run the split plan: "
                 f"{split_plans[J2, C2]}")
        k2_err = max(k2_err, err)
    guard_in = {"staged": p_case(J, C), "split": split_in[MANY_CLIENTS, C],
                "unstaged": None}
    guard_in["unstaged"] = guard_in["staged"]
    k2_guard_err = 0.0
    for kern, args in guard_in.items():
        for guard in GUARDS:
            err, _ = p_check(args, f"{kern} guarded", kernel=kern,
                             guard=guard)
            k2_guard_err = max(k2_guard_err, err)

    # -- 4. the main path, counted ----------------------------------------
    # lr_mode "constant": over a 3-round cut the reference schedule would
    # divide lr by 10 at round 1 and by 1000 at round 2 (T/2 = 1,
    # 0.75T = 2), leaving one round of real training
    kw = dict(lr=prm["lr"], epoch=EPOCHS, batch_size=B, round=ROUNDS,
              seed=SEED, lr_mode="constant", return_state=True)
    amw_kw = dict(kw, lambda_reg=prm["lambda_reg"], lr_p=prm["lr_p"],
                  val_batch_size=VB)
    algos = (("FedAvg", FedAvg, kw), ("FedAMW", FedAMW, amw_kw))

    def timed(fn, s=None, **fkw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(setup if s is None else s, **fkw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # the plain reference runs first (they launch no kernel and warm up
    # the library calls both routes share), then the counted kernel runs:
    # every count is set to 0 just before each algorithm and read just after
    refs = {name: timed(fn, kernel_impl="plain", **fkw)
            for name, fn, fkw in algos}
    runs, counted, p_by_kernel = {}, {}, {}
    for name, fn, fkw in algos:
        reset_counts()
        runs[name] = timed(fn, **fkw)
        c = counts()
        counted[name] = {k: c[k] for k in ("client_epoch", "p_epoch")}
        p_by_kernel[name] = c["p_epoch_by_kernel"]
    launches = {k: sum(c[k] for c in counted.values())
                for k in ("client_epoch", "p_epoch")}
    # per round, from the counts: every algorithm runs the client epochs,
    # only FedAMW the p-solver
    per_round = {"client_epoch": launches["client_epoch"]
                 / (ROUNDS * len(algos)),
                 "p_epoch": counted["FedAMW"]["p_epoch"] / ROUNDS}
    emit({"phase": "main_path", "launches": launches,
          "by_algorithm": counted, "launches_per_round": per_round,
          "p_epoch_by_kernel": p_by_kernel,
          "rounds_per_algorithm": ROUNDS, "local_epochs": EPOCHS})
    if launches["client_epoch"] == 0 or launches["p_epoch"] == 0:
        fail(f"the main path did not go through every kernel: {launches}")
    if p_by_kernel["FedAMW"]["staged"] != counted["FedAMW"]["p_epoch"]:
        fail(f"FedAMW's p-epochs did not all run the staged kernel: "
             f"{p_by_kernel}")
    if counted["FedAvg"]["p_epoch"] != 0:
        fail(f"FedAvg launched the p-solver: {counted['FedAvg']}")
    if not all(float(v).is_integer() for v in per_round.values()):
        fail(f"launches are not a whole number per round: {per_round}")

    # chance is the test set's largest class share: always guessing that
    # class scores it
    chance = 100.0 * float(torch.bincount(setup.y_test.long()).max()
                           / setup.y_test.numel())
    def vs_plain(res, ref):
        """(ok, {max_rel_loss, max_abs_acc, max_abs_w}) of a kernel run
        against its plain run under TOL_RUN; the weights only where the
        algorithm returns them."""
        finite = all(np.all(np.isfinite(res[k]))
                     for k in ("train_loss", "test_loss", "test_acc"))
        # relative to the plain run's losses, an exact 0 of both (a
        # FedAMW round whose present clients all carry zero mass) a 0
        d = {"max_rel_loss": max(
                float(np.max(np.abs(res[k] - ref[k])
                             / np.maximum(np.abs(ref[k]), 1e-30)))
                for k in ("train_loss", "test_loss")),
             "max_abs_acc": float(np.max(np.abs(res["test_acc"]
                                                - ref["test_acc"])))}
        ok = (finite and d["max_rel_loss"] <= TOL_RUN["loss_rtol"]
              and d["max_abs_acc"] <= TOL_RUN["acc_atol"])
        if "params" in res:
            # every leaf of the model's parameters (the linear model's one)
            d["max_abs_w"] = max(float((res["params"][k]
                                        - ref["params"][k]).abs().max())
                                 for k in ref["params"])
            ok = ok and d["max_abs_w"] <= TOL_RUN["w_atol"]
        if "mixture" in ref:
            # FedAMW's per-round entropy and largest mass of p, relative
            # like the losses
            d["max_rel_mixture"] = max(float(np.max(
                np.abs(res["mixture"][k] - ref["mixture"][k])
                / np.maximum(np.abs(ref["mixture"][k]), 1e-30)))
                for k in ref["mixture"])
            ok = ok and d["max_rel_mixture"] <= TOL_RUN["loss_rtol"]
        return ok, d

    # FedAvg's client-update FLOPs by bench.py's definition (bench.py:
    # 685-712): the forward from the model's parameters, n_mean over all
    # J clients' partitions x 0.8 for the validation split, fwd + bwd
    fwd, basis = fwd_flops_per_sample(setup.model.init(
        torch.Generator().manual_seed(0), D, C), with_provenance=True)
    flops_upd = client_update_flops(
        fwd, EPOCHS, 0.8 * float(np.mean([len(q) for q in ds.parts])))
    for name, _, _ in algos:
        res, secs = runs[name]
        ref, plain_secs = refs[name]
        ok, diffs = vs_plain(res, ref)
        acc, tloss = res["test_acc"], res["test_loss"]
        learns = bool(np.all(np.diff(tloss) < 0) and acc[-1] > acc[0]
                      and acc[-1] >= chance + ACC_MARGIN)
        row = {"phase": "main_path", "algorithm": name, "card": card,
               "train_loss": res["train_loss"].tolist(),
               "test_loss": res["test_loss"].tolist(),
               "test_acc": res["test_acc"].tolist(),
               "seconds": secs, "seconds_plain": plain_secs,
               "round_ms": 1e3 * secs / ROUNDS,
               "p_sum": float(res["p"].sum()),
               "chance_acc": chance, "learns": learns,
               "vs_plain": diffs, "tol": TOL_RUN, "ok": ok}
        if name == "FedAMW":
            ok = ok and set(res["mixture"]) == {"p_entropy", "p_max"} and all(
                v.shape == (ROUNDS,) for v in res["mixture"].values())
            row["mixture"] = {k: v.tolist() for k, v in res["mixture"].items()}
            row["ok"] = ok
        else:
            ups = J * ROUNDS / secs
            row.update({"client_updates_per_s": ups,
                        "flops_per_update": flops_upd, "flops_basis": basis,
                        "achieved_gflops": ups * flops_upd / 1e9})
        emit(row)
        if not ok:
            fail(f"{name} on the kernels does not match its plain run")
        if not learns:
            fail(f"{name} does not learn: test loss must fall every round "
                 f"and the accuracy rise to {ACC_MARGIN} points above the "
                 f"{chance:.2f}% of the largest test class")

    # -- 5. the rest of the paper's experiment, counted --------------------
    # Centralized (J=1 over every train row), Distributed and
    # FedAMW_OneShot (one local phase of EPOCHS * ROUNDS epochs) and
    # FedNova (the round loop), each held against its plain run with the
    # same seed; counts set to 0 just before each and read just after
    long_kw = dict(lr=prm["lr"], epoch=EPOCHS * ROUNDS, batch_size=B,
                   seed=SEED)
    paper = (
        ("Centralized", Centralized, long_kw, (EPOCHS * ROUNDS, 0)),
        ("Distributed", Distributed, long_kw, (EPOCHS * ROUNDS, 0)),
        ("FedAMW_OneShot", FedAMW_OneShot,
         dict(long_kw, lambda_reg=prm["lambda_reg_os"], round=ROUNDS,
              lr_p=prm["lr_p_os"], val_batch_size=VB),
         (EPOCHS * ROUNDS, ROUNDS)),
        ("FedNova", FedNova, kw, (EPOCHS * ROUNDS, 0)),
    )
    paper_counted, paper_rows = {}, []
    for name, fn, fkw, want in paper:
        ref, plain_secs = timed(fn, kernel_impl="plain", **fkw)
        reset_counts()
        res, secs = timed(fn, **fkw)
        c = counts()
        got = (c["client_epoch"], c["p_epoch"])
        staged = c["p_epoch_by_kernel"]["staged"]
        paper_counted[name] = {"client_epoch": got[0], "p_epoch": got[1]}
        ok, diffs = vs_plain(res, ref)
        paper_rows.append({
            "algorithm": name,
            **{k: np.ravel(res[k]).tolist()
               for k in ("train_loss", "test_loss", "test_acc")},
            "seconds": secs, "seconds_plain": plain_secs,
            "launches": paper_counted[name], "launches_expected":
            {"client_epoch": want[0], "p_epoch": want[1]},
            "p_epoch_staged": staged, "vs_plain": diffs, "ok": ok})
        if not ok:
            fail(f"{name} on the kernels does not match its plain run: "
                 f"{diffs}")
        if got != want or staged != got[1]:
            fail(f"{name} launched {got} kernels ({staged} staged p-epochs), "
                 f"expected {want}, all staged")
    # Centralized's launch shape: one client over every valid train row
    cargs = k1_in["classification", "centralized"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cplan = ek.launch_plan(1, B, C, D, sms)
    csteps = int(ek.client_order(cargs[5])[1].max())
    cusage = [u for f, u in cuda_build.ptxas_usage("client_epoch").items()
              if ek.kernel_symbol(cplan, C) in f]
    saved = client_epoch.launches
    c_ms = cuda_ms(lambda: client_epoch(*cargs), 5)
    c_by_cluster = {k: cuda_ms(lambda: client_epoch(*cargs, cluster=k), 5)
                    for k in (1, 2, 4, 8) if ek.staged_smem_bytes(
                        B, C, D, k) <= cuda_build.SMEM_LIMIT}
    client_epoch.launches = saved
    central = {"J": 1, "rows": n_all, "S": int(cargs[4].shape[1]),
               "cluster": cplan.cluster, "ctas": cplan.ctas,
               "steps_max": csteps, "ms": c_ms,
               "us_per_step": 1e3 * c_ms / csteps,
               "ms_by_cluster": c_by_cluster,
               "spill_bytes": cusage[0]["spill_bytes"] if len(cusage) == 1
               else None}
    emit({"phase": "paper_algorithms", "rounds": ROUNDS,
          "local_epochs": EPOCHS, "algorithms": paper_rows,
          "centralized_plan": central, "tol": TOL_RUN})
    if len(cusage) != 1 or cusage[0]["spill_bytes"] != 0:
        fail(f"Centralized's client_epoch plan {cplan}: ptxas {cusage}")

    # -- 6. the driver: exp.py's six algorithms and result pickle ---------
    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            path = exp.main(["--dataset", "mnist", "--round", str(ROUNDS),
                             "--seed", str(SEED), "--result_dir", tmp])
        drv_secs = time.perf_counter() - t0
        with open(path, "rb") as f:
            data = pickle.load(f)
    keys = {"epochs", "train_loss", "test_loss", "test_acc",
            "heterogeneity", "name", "task"}
    shapes = {k: list(data[k].shape) for k in
              ("train_loss", "test_loss", "test_acc", "heterogeneity")}
    finite = all(bool(np.all(np.isfinite(data[k]))) for k in shapes)
    drv_ok = (set(data) == keys and data["name"] == exp.NAMES
              and data["task"] == "classification" and finite
              and all(shapes[k] == [6, ROUNDS, 1]
                      for k in ("train_loss", "test_loss", "test_acc"))
              and shapes["heterogeneity"] == [1])
    emit({"phase": "driver", "seconds": drv_secs, "keys": sorted(data),
          "shapes": shapes, "name": data["name"], "task": data["task"],
          "heterogeneity": data["heterogeneity"].tolist(),
          "final_acc": dict(zip(data["name"],
                                data["test_acc"][:, -1, 0].tolist())),
          "finite": finite, "log_tail": log.getvalue().splitlines()[-8:],
          "ok": drv_ok})
    if not drv_ok:
        fail("the driver's pickle is not exp.py's (6, R, 1) schema")

    # -- 6b. the observability plane: the driver traced and profiled ------
    obs_frac = observability(setup, amw_kw, data, drv_secs, timed, card)

    # -- 7. the round loop's options, each against its plain run ----------
    option_launches = options(ds, setup, prm, kw, amw_kw, timed, vs_plain,
                              card)

    # -- 7a. faults and defenses, each against its plain run ----------------
    fault_launches = faults(ds, setup, prm, kw, amw_kw, timed, vs_plain,
                            card)

    # -- 7b. the cohort plane: in-graph shards, streamed shards, 1M clients --
    cohort_launches = cohort(setup, kw, amw_kw, timed, vs_plain, card)

    # -- 7d. the client axis over ranks: one-rank NCCL group, the driver
    # over one rank, two ranks sharing the card ------------------------------
    rank_launches, rank_refs = ranks(setup, kw, amw_kw, timed, vs_plain,
                                     card, data)

    # -- 7c. the features stored in bfloat16 (feature_dtype) ---------------
    # the main configuration's setup with its features mapped into
    # bfloat16 (the same draw: each entry the float32 map rounded once);
    # FedAvg and FedAMW against their plain runs on that setup, counted
    t0 = time.perf_counter()
    narrow = prepare_setup(ds, D=D, kernel_par=prm["kernel_par"], seed=SEED,
                           rng=np.random.RandomState(SEED),
                           feature_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    narrow_s = time.perf_counter() - t0

    def feature_bytes(s):
        return sum(t.numel() * t.element_size()
                   for t in (s.X, s.X_val, s.X_test))

    narrow_launches = {}
    for name, fn, fkw in algos:
        ref, plain_secs = timed(fn, narrow, kernel_impl="plain", **fkw)
        reset_counts()
        res, secs = timed(fn, narrow, **fkw)
        c = counts()
        narrow_launches[name] = c
        ok, diffs = vs_plain(res, ref)
        want = (ROUNDS * EPOCHS, ROUNDS * ROUNDS if name == "FedAMW" else 0)
        got = (c["client_epoch"], c["p_epoch"])
        emit({"phase": "feature_dtype", "algorithm": name,
              "feature_dtype": "bfloat16", "card": card,
              "setup_seconds": narrow_s,
              "feature_bytes": feature_bytes(narrow),
              "feature_bytes_float32": feature_bytes(setup),
              "round_ms": 1e3 * secs / ROUNDS,
              "round_ms_float32": 1e3 * runs[name][1] / ROUNDS,
              "round_ms_plain": 1e3 * plain_secs / ROUNDS,
              "test_acc": res["test_acc"].tolist(),
              "test_acc_float32": runs[name][0]["test_acc"].tolist(),
              "launches": c, "vs_plain": diffs, "tol": TOL_RUN, "ok": ok})
        if not ok or got != want:
            fail(f"{name} at bfloat16 launched {got} (expected {want}) or "
                 f"does not match its plain run: {diffs}")

    # -- 7e. kernel 1's wide plan: the main configuration at D = 10,000 ----
    wide_row = wide_d(ds, prm, kw, amw_kw, timed, vs_plain, card, sms)
    # -- 7f. more than 32 classes: the tiled plans on a sector stand-in -----
    many_rows = many_classes(timed, vs_plain, card, sms)

    # -- 8. where a FedAMW run's time goes (device time by kernel) ----------
    # the device shuffle draw of one round, alone and before the profiler
    # starts: EPOCHS client draws of all J clients and one p-solve's draw
    # (ROUNDS epochs; 100 at the paper's length), CUDA events
    def round_draw(p_epochs):
        for _ in range(EPOCHS):
            draw_epoch_positions(dgen, setup.n_max, B, setup.mask, lead=(J,))
        draw_epoch_positions(dgen, n_val, VB, lead=(p_epochs,))

    draw_ms = cuda_ms(lambda: round_draw(ROUNDS), 10)
    draw_ms_r100 = cuda_ms(lambda: round_draw(100), 10)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    saved = (client_epoch.launches, p_epoch.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = timed(FedAMW, **amw_kw)
    client_epoch.launches, p_epoch.launches = saved
    # the device rows only (kernels, copies): an operator row's self
    # device time is that of the kernels it launched, which have rows of
    # their own, so summing every row counts those kernels twice
    by_kernel, all_rows_ms = {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        all_rows_ms += us / 1e3
        if us > 0 and ev.device_type == DeviceType.CUDA:
            by_kernel[ev.key] = (us / 1e3, ev.count)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "algorithm": "FedAMW", "rounds": ROUNDS,
          "card": card,
          "wall_ms": 1e3 * secs, "draw_ms_per_round": draw_ms,
          "draw_ms_per_round_p_epochs_100": draw_ms_r100,
          "device_ms": device_ms if device_ms > 0 else "not measured",
          "device_ms_all_rows": all_rows_ms,
          "device_busy_share": (device_ms / (1e3 * secs) if device_ms > 0
                                else "not measured"),
          "attribute_device_time_compute_fraction": obs_frac,
          "top": [{"kernel": k[:80], "device_ms": ms, "calls": n}
                  for k, (ms, n) in top]})

    # -- 9. times and bounds at the main-path shapes ------------------------
    args = k1_in["classification", "registry"]
    n_rows = float(valid.sum())
    steps = int((valid.sum(-1) > 0).sum())
    k1_bytes = 4 * (n_rows * (D + 1) + 2 * J * C * D + C * D
                    + 2 * rows.numel() + 3 * J)
    k1_ops = 4 * C * D * n_rows + 12 * C * D * steps
    k2 = p_in["classification", "momentum 0.9"]
    S2 = int(ppos.shape[0])
    k2_bytes = 4 * (n_val * J * C + n_val + 2 * S2 * VB + 5 * J + 3)
    k2_ops = 4 * n_val * J * C + 4 * J * S2
    # the critical path of kernel 1: the largest client's non-empty steps,
    # the cluster the launch plan gives the main path, and the compiler's
    # spills of the instantiation it runs
    steps_max = int(ek.client_order(valid)[1].max())
    plan = ek.launch_plan(J, B, C, D, sms)
    symbol = ek.kernel_symbol(plan, C)
    usage = [u for f, u in cuda_build.ptxas_usage("client_epoch").items()
             if symbol in f]
    if len(usage) != 1:
        fail(f"no single ptxas entry for {symbol}: {usage}")
    # kernel 2's plan at the main path's shapes and the compiler's report
    # of the staged instantiation it runs
    plan2 = pk.launch_plan(VB, J, C)
    symbol2 = pk.kernel_symbol(plan2, C)
    usage2 = [u for f, u in cuda_build.ptxas_usage("p_epoch").items()
              if symbol2 in f]
    if len(usage2) != 1:
        fail(f"no single ptxas entry for {symbol2}: {usage2}")
    # launches of every counted run: the main path and the paper's
    # other algorithms
    paper_launches = {k: sum(c[k] for c in paper_counted.values())
                      for k in ("client_epoch", "p_epoch")}
    launches_all = {k: launches[k] + paper_launches[k]
                    for k in ("client_epoch", "p_epoch")}
    kernels = []
    for name, fn, plain, a, nbytes, ops, err, src, repl in (
            ("client_epoch", client_epoch, client_epoch_plain, args,
             k1_bytes, k1_ops, k1_err, "csrc/client_epoch.cu",
             "non-iid-distributed-learning-with-optimal-mixture-weights_tpu/"
             "fedcore/pallas_kernel.py:40"),
            ("p_epoch", p_epoch, p_epoch_plain, k2, k2_bytes, k2_ops, k2_err,
             "csrc/p_epoch.cu",
             "non-iid-distributed-learning-with-optimal-mixture-weights_tpu/"
             "fedcore/pallas_psolver.py:38")):
        saved = fn.launches
        ms = cuda_ms(lambda: fn(*a), 10)
        fn.launches = saved
        plain_ms = cuda_ms(lambda: plain(*a), 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
        kernels.append({
            "name": name, "route": "cuda",
            "source": "non-iid-distributed-learning-with-optimal-mixture-"
                      f"weights_tpu_torch/{src}",
            "replaces": repl, "launches": launches_all[name],
            "launches_by_path": {"main_path": launches[name],
                                 "paper_algorithms": paper_launches[name],
                                 "faults": fault_launches[name],
                                 "cohort": cohort_launches[name],
                                 "ranks": rank_launches[name]},
            "launches_per_round": int(per_round[name]), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_fp32_ops": ops,
            "library_ms": None})
    k1 = kernels[0]
    saved = client_epoch.launches
    by_cluster = {k: cuda_ms(lambda: client_epoch(*args, cluster=k), 10)
                  for k in (1, 2, 4, 8)
                  if ek.staged_smem_bytes(B, C, D, k) <= cuda_build.SMEM_LIMIT}
    # the staged, unstaged and wide kernels forced on the same inputs, in
    # turns (each order, then reversed): the mean of each one's two
    # readings (the unstaged kernel holds W and the anchor whole here)
    saved_by = dict(client_epoch.launches_by_kernel)
    readings1 = {kern: [] for kern in ("staged", "unstaged", "wide")}
    for kern in list(readings1) + list(readings1)[::-1]:
        readings1[kern].append(cuda_ms(
            lambda: client_epoch(*args, kernel=kern), 10))
    by_plan1 = {kern: sum(r) / len(r) for kern, r in readings1.items()}
    client_epoch.launches = saved
    client_epoch.launches_by_kernel = saved_by
    k1.update({"steps_max": steps_max, "us_per_step": 1e3 * k1["ms"]
               / steps_max, "cluster": plan.cluster,
               "spill_bytes": usage[0]["spill_bytes"],
               "registers": usage[0]["registers"],
               "smem_bytes": plan.smem_bytes, "ctas": plan.ctas,
               "ms_by_cluster": by_cluster, "ms_by_plan": by_plan1})
    if plan.cluster == 0 or usage[0]["spill_bytes"] != 0:
        fail(f"client_epoch main path: plan {plan}, ptxas {usage[0]}")
    k2e = kernels[1]
    # the three kernels on the same inputs, in turns (staged, split,
    # unstaged, unstaged, split, staged): the mean of each one's two
    # readings; the split plan forced at J = 50 is its smallest cluster
    saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
    readings = {kern: [] for kern in pk.KERNELS}
    for kern in pk.KERNELS + pk.KERNELS[::-1]:
        readings[kern].append(cuda_ms(lambda: p_epoch(*k2, kernel=kern), 10))
    by_plan = {kern: sum(r) / len(r) for kern, r in readings.items()}
    p_epoch.launches, p_epoch.launches_by_kernel = saved
    k2e.update({"steps": S2, "us_per_step": 1e3 * k2e["ms"] / S2,
                "plan": dataclasses.asdict(plan2),
                "bulk_rows": pk.bulk_rows(k2[3]),
                "spill_bytes": usage2[0]["spill_bytes"],
                "registers": usage2[0]["registers"],
                "ms_by_plan": by_plan})
    if plan2.kernel != "staged" or usage2[0]["spill_bytes"] != 0:
        fail(f"p_epoch main path: plan {plan2}, ptxas {usage2[0]}")

    def p_bound(J2, C2):
        """(bytes, fp32 ops, bound ms, by) of one p-epoch at (J2, C2):
        the logits, labels, positions, valid, p, buf, cv in and out."""
        nbytes = 4 * (n_val * J2 * C2 + n_val + 2 * S2 * VB + 5 * J2 + 3)
        ops = 4 * n_val * J2 * C2 + 4 * J2 * S2
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
        return nbytes, ops, 1e3 * max(t_b, t_o), (
            "bytes" if t_b >= t_o else "operations")

    def spill(library, symbol):
        used = [u for f, u in cuda_build.ptxas_usage(library).items()
                if symbol in f]
        if len(used) != 1:
            fail(f"no single ptxas entry for {symbol} in {library}: {used}")
        return used[0]

    def timed_row(name, fn, plain, a, nbytes, ops, launches, err,
                  replaces, src, reps=10, **extra):
        saved = fn.launches, dict(fn.launches_by_kernel)
        ms = cuda_ms(lambda: fn(*a, **extra), reps)
        fn.launches, fn.launches_by_kernel = saved
        plain_ms = cuda_ms(lambda: plain(*a, **{
            k: v for k, v in extra.items() if k == "guard"}), 2)
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
        return {"name": name, "route": "cuda",
                "source": "non-iid-distributed-learning-with-optimal-"
                          f"mixture-weights_tpu_torch/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bound_bytes": nbytes, "bound_fp32_ops": ops,
                "library_ms": None}

    # kernel 2's split plan: launches from the 400-partition options run;
    # timed at each split shape, the row's own time at J = 400, C = 10; at
    # each shape also every cluster size forced (the plan's layout at that
    # size, holding or streaming), the sizes in turns
    many = f"FedAMW num_partitions={MANY_CLIENTS}"
    by_shape = {}
    for (J2, C2), a in split_in.items():
        plan_s = split_plans[J2, C2]
        saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
        ms = cuda_ms(lambda: p_epoch(*a), 5)
        sizes = [k for k in pk.SPLIT_CLUSTERS if k <= k_max]
        reads = {k: [] for k in sizes}
        for k in sizes + sizes[::-1]:
            reads[k].append(cuda_ms(
                lambda: p_epoch(*a, kernel="split", cluster=k), 3))
        p_epoch.launches, p_epoch.launches_by_kernel = saved
        nbytes, ops, bound, by = p_bound(J2, C2)
        used = spill("p_epoch", pk.kernel_symbol(plan_s, C2))
        by_shape[f"J={J2} C={C2}"] = {
            "ms": ms, "us_per_step": 1e3 * ms / S2, "bound_ms": bound,
            "bound_by": by, "over_bound": ms / bound,
            "cluster": plan_s.cluster, "slice": plan_s.slice_width,
            "stream": plan_s.stream, "tile": plan_s.tile,
            "stages": plan_s.stages, "warps": plan_s.warps,
            "smem_bytes": plan_s.smem_bytes,
            "registers": used["registers"],
            "spill_bytes": used["spill_bytes"],
            "ms_by_cluster": {str(k): sum(r) / len(r)
                              for k, r in reads.items()},
            "stream_by_cluster": {str(k): pk.launch_plan(
                VB, J2, C2, kernel="split", max_cluster=k_max,
                cluster=k).stream for k in sizes}}
        if used["spill_bytes"] != 0:
            fail(f"the split kernel spills at J={J2}, C={C2}: {used}")
    nbytes, ops, _, _ = p_bound(MANY_CLIENTS, C)
    split_row = timed_row(
        "p_epoch.split", p_epoch, p_epoch_plain, split_in[MANY_CLIENTS, C],
        nbytes, ops, option_launches[many]["p_epoch_by_kernel"]["split"],
        k2_err, k2e["replaces"], "csrc/p_epoch.cu", reps=5)
    split_row.update({"launches_path": f"options: {many}",
                      "max_cluster": k_max, "by_shape": by_shape})

    # the guarded epochs: launches from the simplex options run (staged);
    # timed with each guard on the staged plan (J = 50) and the split plan
    # (J = 400), the simplex's fixed-point rounds per step read from the
    # kernel's counter
    guarded, rounds = {}, torch.zeros(2, dtype=torch.int32, device=dev)
    for kern, a in (("staged", guard_in["staged"]),
                    ("split", guard_in["split"])):
        J2 = a[3].shape[1]
        cell = {}
        for guard in (None, "clip", "simplex"):
            g = make_guard(guard) if guard else None
            saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
            cell[guard or "none"] = cuda_ms(lambda: p_epoch(*a, guard=g), 5)
            if guard == "simplex":
                p_epoch(*a, guard=g, guard_rounds=rounds)
                total, most = rounds.tolist()
                cell["simplex_rounds_per_step"] = total / S2
                cell["simplex_rounds_max"] = most
            p_epoch.launches, p_epoch.launches_by_kernel = saved
        # each guard's cost: its launch less the unguarded one, a step
        cell["guard_us_per_step"] = {
            guard: 1e3 * (cell[guard] - cell["none"]) / S2
            for guard in ("clip", "simplex")}
        guarded[f"{kern} J={J2}"] = cell
    nbytes, ops, _, _ = p_bound(J, C)
    guard_row = timed_row(
        "p_epoch.guarded", p_epoch, p_epoch_plain, guard_in["staged"],
        nbytes, ops,
        option_launches["FedAMW p_guard=simplex"]["p_epoch_by_kernel"][
            "staged"], k2_guard_err, k2e["replaces"], "csrc/p_epoch.cu",
        reps=5, guard=make_guard("simplex"))
    used_g = spill("p_epoch", pk.kernel_symbol(plan2, C, guarded=True))
    # the split plan's guarded instantiation at J = 400
    split_g = spill("p_epoch", pk.kernel_symbol(
        split_plans[MANY_CLIENTS, C], C, guarded=True))
    if split_g["spill_bytes"] != 0:
        fail(f"the guarded split p_epoch kernel spills: {split_g}")
    guard_row.update({"launches_path": "options: FedAMW p_guard=simplex",
                      "split_registers": split_g["registers"],
                      "guard": "simplex", "registers": used_g["registers"],
                      "spill_bytes": used_g["spill_bytes"],
                      "ms_by_plan_and_guard": guarded})
    if used_g["spill_bytes"] != 0:
        fail(f"the guarded staged p_epoch kernel spills: {used_g}")

    # kernel 1 with bfloat16 rows: launches from the feature_dtype phase;
    # the bound counts 2 bytes a feature; ms_by_dtype times float32,
    # bfloat16 and float16 rows on the same steps, in turns, at the main
    # shape and at Centralized's
    narrow_args = args[:2] + (setup.X.to(torch.bfloat16),) + args[3:]
    n16 = (n_rows * (2 * D + 4) + 4 * (2 * J * C * D + C * D)
           + 4 * (2 * rows.numel() + 3 * J))
    bf16_row = timed_row(
        "client_epoch.bf16", client_epoch, client_epoch_plain, narrow_args,
        n16, k1_ops, sum(c["client_epoch"] for c in narrow_launches.values()),
        k1_narrow_err["bfloat16"], k1["replaces"], "csrc/client_epoch.cu")
    by_dtype = {}
    for shape, a in (("main", args),
                     ("centralized", k1_in["classification", "centralized"])):
        xs = {"float32": a[2], "bfloat16": a[2].to(torch.bfloat16),
              "float16": a[2].to(torch.float16)}
        reads = {k: [] for k in xs}
        saved = client_epoch.launches, dict(client_epoch.launches_by_kernel)
        for k in list(xs) + list(xs)[::-1]:
            aa = a[:2] + (xs[k],) + a[3:]
            reads[k].append(cuda_ms(lambda: client_epoch(*aa), 5))
        client_epoch.launches, client_epoch.launches_by_kernel = saved
        Jx = int(a[0].shape[0])
        by_dtype[shape] = {k: {
            "ms": sum(r) / 2,
            "cluster": ek.launch_plan(Jx, B, C, D, sms, row_bytes=xs[
                k].element_size()).cluster} for k, r in reads.items()}
    plan16 = ek.launch_plan(J, B, C, D, sms, row_bytes=2)
    used16 = spill("client_epoch_bf16", ek.kernel_symbol(plan16, C))
    usedf16 = spill("client_epoch_f16", ek.kernel_symbol(plan16, C))
    saved = client_epoch.launches, dict(client_epoch.launches_by_kernel)
    by_cluster16 = {k: cuda_ms(lambda: client_epoch(*narrow_args, cluster=k),
                               10)
                    for k in (1, 2, 4, 8) if ek.staged_smem_bytes(
                        B, C, D, k, row_bytes=2) <= cuda_build.SMEM_LIMIT}
    client_epoch.launches, client_epoch.launches_by_kernel = saved
    bf16_row.update({"launches_path": "feature_dtype (FedAvg, FedAMW)",
                     "cluster": plan16.cluster,
                     "smem_bytes": plan16.smem_bytes,
                     "registers": used16["registers"],
                     "spill_bytes": used16["spill_bytes"],
                     "registers_float16": usedf16["registers"],
                     "spill_bytes_float16": usedf16["spill_bytes"],
                     "ms_by_cluster": by_cluster16, "ms_by_dtype": by_dtype})
    if used16["spill_bytes"] != 0 or usedf16["spill_bytes"] != 0:
        fail(f"client_epoch with 2-byte rows spills: {used16}, {usedf16}")
    kernels += [split_row, guard_row, bf16_row, wide_row, *many_rows]
    for row in kernels[2:]:
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path "
                 f"({row['launches_path']})")

    # the p-solve of one round of the paper's 100-round run: 100 epochs
    # (algorithms/core.py draws `rounds` p-epochs per round) through
    # make_p_solver on the main path's logits, CUDA events
    solve, init_opt = make_p_solver("classification", n_val, VB,
                                    float(prm["lr_p"]), momentum=0.9)
    ppos100 = draw_epoch_positions(dgen, n_val, VB, lead=(100,))
    solve_args = (k2[3], k2[4], k2[0], init_opt(k2[0]), ppos100)
    saved = p_epoch.launches, dict(p_epoch.launches_by_kernel)
    solve_ms = cuda_ms(lambda: solve(*solve_args, client_valid=cv), 2)
    p_epoch.launches, p_epoch.launches_by_kernel = saved
    emit({"phase": "p_solve_100_epochs_ms", "ms": solve_ms,
          "epochs": 100, "ms_per_epoch": solve_ms / 100,
          "shape": {"n_val": n_val, "J": J, "C": C, "B": VB, "S": S2},
          "plan": plan2.kernel})

    # -- 10. the paper's run: the driver's six algorithms at R=100 --------
    # one repeat at the paper's length (100 rounds of 2 local epochs, the
    # reference lr schedule) on the main setup, with no plain reference:
    # what a user's run costs on the card. Counted over the six at once.
    reset_counts()
    t0 = time.perf_counter()
    paper_runs = exp.run_paper_algorithms(
        setup, rounds=PAPER_ROUNDS, local_epoch=EPOCHS, batch_size=B,
        seed=SEED, lr=prm["lr"], lr_p=prm["lr_p"], lr_p_os=prm["lr_p_os"],
        mu=prm["lambda_prox"], lam=prm["lambda_reg"],
        lam_os=prm["lambda_reg_os"])
    total = time.perf_counter() - t0
    c = counts()
    run_launches = {k: c[k] for k in ("client_epoch", "p_epoch")}
    # client epochs: 2R for each of the six (Centralized's at J=1); p-epochs:
    # R per round for FedAMW, one per iteration for FedAMW_OneShot
    want = {"client_epoch": 6 * EPOCHS * PAPER_ROUNDS,
            "p_epoch": PAPER_ROUNDS * PAPER_ROUNDS + PAPER_ROUNDS}
    finite = all(bool(np.all(np.isfinite(res[k])))
                 for _, res, _ in paper_runs
                 for k in ("train_loss", "test_loss", "test_acc"))
    emit({"phase": "paper_run", "rounds": PAPER_ROUNDS,
          "local_epochs": EPOCHS, "card": card,
          "seconds": {name: secs for name, _, secs in paper_runs},
          "total_seconds": total,
          "final_test_acc": {name: float(np.ravel(res["test_acc"])[-1])
                             for name, res, _ in paper_runs},
          "launches": run_launches, "launches_expected": want,
          "finite": finite})
    if run_launches != want or not finite:
        fail(f"the paper run launched {run_launches} (expected {want}) "
             f"or gave non-finite metrics (finite={finite})")

    # -- 10b. the model zoo at scale_bench.py's widths ---------------------
    zoo_launches, zoo_shapes, zoo_served = zoo(timed, vs_plain, card)
    for row in kernels[:2]:
        row["launches_by_path"]["zoo"] = zoo_launches[row["name"]]
    split_row["by_shape"].update(zoo_shapes)
    # every zoo FedAMW runs the simplex guard (ZOO_AMW): its kernel-2
    # launches are guarded epochs too
    guard_row["launches_guarded_by_path"] = {
        "options: FedAMW p_guard=simplex": guard_row["launches"],
        "zoo": zoo_launches["p_epoch"]}

    # -- 10c. serving: checkpoint -> engine -> service, train -> serve -----
    serve_launches = serve(ds, setup, runs["FedAMW"][0], data, card,
                           zoo_served)
    del zoo_served
    for row in kernels[:2]:
        row["launches_by_path"]["serve"] = serve_launches[row["name"]]

    # -- 10d. the serving fleet: artifacts, failover, pod, ladder ----------
    fleet_launches = fleet(ds, setup, runs["FedAMW"][0], runs["FedAvg"][0],
                           card)
    for row in kernels[:2]:
        row["launches_by_path"]["fleet"] = fleet_launches[row["name"]]

    # -- 10e. the scenario plane, the oracle's train leg on the card -------
    scenario_launches = scenario(card)
    # -- 10f. the plain PyTorch reference backend at full width ------------
    ref_launches = torch_ref_phase(ds, prm, runs, card)
    # -- 10g. the tuning loop and the export CLI ----------------------------
    tune_launches = tune_phase(ds, setup, runs["FedAMW"][0], prm, card)
    for row in kernels[:2]:
        row["launches_by_path"]["scenario"] = scenario_launches[row["name"]]
        row["launches_by_path"]["torch_ref"] = ref_launches[row["name"]]
        row["launches_by_path"]["tune"] = tune_launches[row["name"]]

    # -- 11. two ranks sharing the card (the ranks phase's (c)) -------------
    two_ranks_one_card(setup, kw, amw_kw, timed, vs_plain, card, rank_refs)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
