"""The paper's seven algorithms on the bias-free linear model.

Reference registry (``functions/tools.py``): ``Centralized`` (:240),
``Distributed`` (:258), ``FedAMW_OneShot`` (:279), ``FedAvg`` (:329),
``FedProx`` (:356), ``FedNova`` (:383), ``FedAMW`` (:413). Each keeps the
JAX package's keyword surface (``prox``/``mu``, ``lambda_reg_if``/
``lambda_reg``, ``round``, ``lr_p``) and returns the same
``(train_loss, test_loss, test_acc)`` record: a scalar row for
Centralized and Distributed, ``(round,)`` vectors for the others.

- The round loop (FedAvg, FedProx, FedNova, FedAMW): one round = {all
  clients' local epochs (kernel 1) -> FedAMW's validation logits and
  p-solve (kernel 2) -> weighted aggregate -> evaluation}, the JAX
  package's ``_round_based`` with its options: ``sequential`` (the
  reference's client chain), size buckets (``prepare_setup(buckets=)``),
  ``participation < 1``, a server optimizer (``server_opt``, not with
  FedAMW), FedAMW's ``p_guard``, and round resume (``start_round``,
  ``stop_round``, ``resume_from``, ``return_state``) with its state keys
  ``params``, ``p``, ``p_opt``, ``server_opt`` and ``server_opt_kind``,
  and ``analyze_memory`` (a measured memory footprint of one round).
  FedAMW's result carries the learned mixture's per-round entropy and
  largest mass (``out["mixture"]``), and a traced run (``utils.trace``
  configured) records one ``train_scan`` span, one ``round`` record per
  round and the per-round telemetry series (``_emit_round_spans``). It
  lacks the fault, robust-aggregation and cohort planes.
- The one-shot phase (Distributed, FedAMW_OneShot): every client trains
  ``epoch`` epochs from one init (kernel 1, one launch per epoch, or per
  client and epoch under ``sequential``), then a fixed-weight aggregate,
  or ``round`` iterations of one plain-SGD p-epoch each (kernel 2), each
  followed by an aggregate and an evaluation. The reference's ``p[0]``
  aliasing bug is not reproduced (MIGRATION.md deviation 2).
- Centralized: one client holding every valid train row
  (``FedSetup.all_train_idx``), no prox and no ridge, a constant lr.

Passing an option the port does not carry raises (ROADMAP.md, queue 1);
the one-shot algorithms refuse partial participation, faults and robust
aggregation with ``ValueError`` and ignore ``server_opt``/``server_lr``
and ``analyze_memory``, as the JAX package does.

Randomness. ``jax.random`` cannot be reproduced in torch, so every
random input is injectable: ``params0`` (initial weights);
``client_positions`` (each client's per-epoch shuffle,
``batching.epoch_batches`` layout): ``(rounds, J, epoch, S, B)`` for the
round loop, ``(J, epoch, S, B)`` for the one-shot phase, ``(epoch, S,
B)`` for Centralized; on a bucketed setup a list with one such array
per bucket, each with that bucket's clients and its own ``S``;
``p_positions`` (the p-solver's per-epoch shuffles): ``(rounds, rounds,
S_val, val_batch_size)`` for FedAMW, ``(round, 1, S_val,
val_batch_size)`` for FedAMW_OneShot; ``participation_masks`` (each
round's 0/1 draw of present clients, ``(rounds, J)``). The round loop's
arrays span the whole ``round`` horizon and are read at the absolute
round index, so a resumed run takes the same arrays. What is not
injected is drawn from seeded ``torch.Generator`` streams:

- the initial weights from a CPU generator seeded ``seed``, so every
  device starts from the same weights;
- the round loop's draws from one generator per round on the setup's
  device, seeded from ``(s, t)`` by ``round_seed`` for round ``t`` of
  stream ``s``: the client shuffles (``s = seed``; one
  ``batching.draw_epoch_positions`` call per local epoch for all
  clients of a bucket, or per client and epoch under ``sequential``),
  the p-solver's (``s = seed + 1``, one call per solve) and the
  participation draw (``s = seed + 2``, ``rand(J) < participation``).
  A run resumed at round ``k`` therefore draws round ``k``'s shuffles
  with no generator state to carry, as the JAX package slices its
  per-round keys;
- the one-shot phase's and Centralized's shuffles from one generator on
  the setup's device seeded ``seed``, one call per epoch, and
  FedAMW_OneShot's p-shuffles from one seeded ``seed + 1``.

No shuffle is drawn on the host.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..fedcore import (
    client_logits,
    fednova_effective_weights,
    make_bucketed_round,
    make_evaluator,
    make_local_update,
    make_p_solver,
    participation_weights,
    weighted_average,
)
from ..fedcore.batching import draw_epoch_positions
from ..fedcore.server_opt import ServerOptimizer, check_server_opt
from ..ops.schedule import lr_schedule_array
from ..utils.telemetry import get_registry
from ..utils.trace import get_tracer
from .common import FedSetup, result_tuple

# The JAX package's options this port does not carry yet, with the value
# that means "off". Passing another value raises.
_WAITING = {
    "faults": None,
    "robust_agg": "mean",
    "cohort_shards": 0,
    "stream_cohort": False,
}
# round-loop options the one-shot algorithms take and ignore, as the JAX
# package's do (they swallow every keyword, core.py:906-921)
_ROUND_LOOP_ONLY = ("server_opt", "server_lr", "analyze_memory")
# the robust-aggregation spec every round of the port runs, in the JAX
# package's canonical spelling (parse_robust_spec("mean").canonical())
_ROBUST_CANONICAL = "mean"


def _reject_waiting(algo: str, opts: dict, ignored=()) -> None:
    for k, v in opts.items():
        if k in ignored:
            continue
        if k not in _WAITING:
            raise TypeError(f"{algo}() got an unexpected keyword argument "
                            f"{k!r}")
        if v is not _WAITING[k] and v != _WAITING[k]:
            raise NotImplementedError(
                f"{algo}: {k}={v!r} is not ported yet (see ROADMAP.md, "
                "queue 1)")


def _reject_oneshot(algo: str, participation, faults, robust_agg) -> None:
    """The one-shot algorithms have no rounds to sample clients in, inject
    faults into or aggregate robustly over (the JAX package's
    ``_reject_partial``/``_reject_faults``): a silently ignored option
    would mislabel the run."""
    if participation != 1.0:
        raise ValueError(
            f"{algo} assumes full participation (it has no communication "
            f"rounds to sample clients in); got participation="
            f"{participation}")
    if faults is not None or robust_agg != "mean":
        raise ValueError(
            f"{algo} has no communication rounds to inject faults into "
            f"or robustly aggregate over; faults=/robust_agg= apply to "
            f"FedAvg/FedProx/FedNova/FedAMW")


def round_seed(seed: int, t: int) -> int:
    """The seed of round ``t``'s generator in the stream seeded ``seed``
    (a 64-bit word of ``numpy.random.SeedSequence([seed, t])``)."""
    words = np.random.SeedSequence([seed % 2**64, t]).generate_state(
        1, np.uint64)
    return int(words[0])


def _round_generator(setup: FedSetup, seed, t) -> torch.Generator:
    return torch.Generator(device=setup.device).manual_seed(
        round_seed(seed, t))


def _device_generator(setup: FedSetup, seed) -> torch.Generator:
    return torch.Generator(device=setup.device).manual_seed(seed)


def _tensor(v, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, array or array-like (numpy
    arrays of a checkpoint, say); keeps its dtype unless one is given."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device, dtype)


def _init_params(setup: FedSetup, seed, params0) -> dict:
    if params0 is None:
        params0 = setup.model.init(torch.Generator().manual_seed(seed),
                                   setup.D, setup.num_classes)
    return {k: _tensor(v, setup.device, torch.float32)
            for k, v in params0.items()}


def _at(injected, t):
    """Entry ``t`` of an injected array, or of each bucket's."""
    if isinstance(injected, (list, tuple)):
        return [a[t] for a in injected]
    return injected[t]


def _f32(v) -> float:
    return float(np.float32(v))


def _scalar_row(train_loss, test_loss, test_acc) -> dict:
    m = torch.stack([train_loss, test_loss, test_acc]).cpu().numpy()
    return result_tuple(m[0], m[1], m[2])


def _finite_reports(params, stacked, losses):
    """The JAX package's ``sanitize_updates``: clients whose weights or
    loss are not finite are replaced by the incoming weights and a zero
    loss, and flagged 0 in the returned ``(J,)`` mask."""
    ok = torch.isfinite(losses)
    for w in stacked.values():
        ok = ok & torch.isfinite(w).flatten(1).all(1)
    clean = {k: torch.where(ok.reshape(-1, *[1] * (w.dim() - 1)), w,
                            params[k]) for k, w in stacked.items()}
    return clean, torch.where(ok, losses, 0.0), ok.to(torch.float32)


def _where(cond, new: dict, old: dict) -> dict:
    return {k: torch.where(cond, new[k], old[k]) for k in new}


def _mixture_stats(p):
    """The learned mixture's entropy and largest mass, as 0-d tensors on
    p's device (JAX ``core.py:546-555``): ``-sum p log p`` with the double
    where, so a client of zero mass (absent under participation) adds an
    exact 0 rather than ``0 * log 0``."""
    pos = p > 0
    entropy = -torch.sum(torch.where(
        pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0))
    return entropy, torch.max(p)


def _nbytes(*values) -> int:
    """Bytes of the tensors in ``values`` (tensors, or lists, tuples and
    dicts of them)."""
    total = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, dict):
            total += _nbytes(*v.values())
        elif isinstance(v, (list, tuple)):
            total += _nbytes(*v)
    return total


def _memory_analysis(setup, learned, round_inputs, params, p, n_metrics,
                     entry):
    """``analyze_memory``'s dict, under the JAX package's keys (its
    ``memory_analysis`` of the compiled round program, ``core.py:1269-1281``)
    that a measurement can fill:

    - ``argument_size_in_bytes``: the tensors one round reads — the
      setup's features, labels and index arrays (``round_inputs``), the
      test set, the sizes and fixed weights, the params, and on FedAMW
      the validation set and p;
    - ``output_size_in_bytes``: the params, p and one row of metrics;
    - on the card, ``peak_memory_in_bytes``: the argument bytes plus
      ``torch.cuda.max_memory_allocated`` above the allocation at entry
      (``entry``; the peak stats reset there), so the tensors already
      resident count once, as arguments;
    - ``temp_size_in_bytes``: the peak less the other two, floored at 0.

    ``alias_size_in_bytes`` and ``generated_code_size_in_bytes`` have no
    measured counterpart and are left out, as the JAX package leaves out
    the keys its analysis does not fill; so are peak and temp on the
    CPU."""
    args = [setup.X, setup.y, round_inputs, setup.X_test, setup.y_test,
            setup.sizes, setup.p_fixed, params]
    if learned:
        args += [setup.X_val, setup.y_val, p]
    out = {"argument_size_in_bytes": _nbytes(*args),
           "output_size_in_bytes": _nbytes(params, p) + 4 * n_metrics}
    if entry is not None:
        torch.cuda.synchronize(setup.device)
        peak = (out["argument_size_in_bytes"]
                + torch.cuda.max_memory_allocated(setup.device) - entry)
        out["temp_size_in_bytes"] = max(
            0, peak - out["argument_size_in_bytes"]
            - out["output_size_in_bytes"])
        out["peak_memory_in_bytes"] = peak
    return out


def _resume_state(resume_from, learned, server_opt, device):
    """``(params, p or None, optimizer state leaves or None)`` of a
    resume dict, with the JAX package's checks and warnings
    (``core.py:1136-1199``)."""
    params = {k: _tensor(v, device, torch.float32)
              for k, v in resume_from["params"].items()}
    opt_key = "p_opt" if learned else "server_opt"
    opt0 = p0 = None
    if resume_from.get(opt_key) is not None:
        saved_kind = resume_from.get("server_opt_kind")
        if (opt_key == "server_opt" and saved_kind is not None
                and str(saved_kind) != server_opt):
            raise ValueError(
                f"checkpoint's server_opt state was saved under "
                f"server_opt={str(saved_kind)!r} but this run uses "
                f"server_opt={server_opt!r}; resume with the same "
                f"server optimizer (or drop 'server_opt' from the "
                f"checkpoint to restart the optimizer)")
        if opt_key == "server_opt" and saved_kind is None:
            warnings.warn(
                "resuming with 'server_opt' state but no "
                "'server_opt_kind' tag: cannot verify the state was "
                f"produced by server_opt={server_opt!r} (adam/yogi "
                "states are structurally interchangeable); carry "
                "res['server_opt_kind'] through the checkpoint to "
                "make cross-optimizer drift detectable", stacklevel=4)
        opt0 = tuple(_tensor(x, device) for x in resume_from[opt_key])
    if learned:
        if resume_from.get("p") is not None:
            p0 = _tensor(resume_from["p"], device, torch.float32)
        if opt0 is None:
            warnings.warn(
                "resuming FedAMW from a checkpoint without 'p_opt': "
                "the p-optimizer momentum buffer restarts at zero, "
                "so the resumed run only approximates the "
                "uninterrupted one (save with return_state=True and "
                "pass res['p_opt'] through the checkpoint for exact "
                "resume)", stacklevel=4)
    elif server_opt != "none" and opt0 is None:
        warnings.warn(
            f"resuming with server_opt={server_opt!r} from a "
            "checkpoint without 'server_opt': the server optimizer's "
            "moments and bias-correction count restart at the resume "
            "boundary, so the resumed run only approximates the "
            "uninterrupted one (save res['server_opt'] through the "
            "checkpoint for exact resume)", stacklevel=4)
    return params, p0, opt0


def _round_based(
    setup: FedSetup,
    aggregation: str,
    lr,
    epoch,
    batch_size,
    rounds,
    mu,
    lam,
    lr_p=5e-5,
    val_batch_size=16,
    seed=0,
    lr_mode="reference",
    sequential=False,
    verbose=False,
    return_state=False,
    participation=1.0,
    start_round=0,
    stop_round=None,
    resume_from=None,
    server_opt="none",
    server_lr=1.0,
    p_guard="none",
    params0=None,
    client_positions=None,
    p_positions=None,
    participation_masks=None,
    kernel_impl="auto",
    analyze_memory=False,
):
    """Common skeleton of FedAvg/FedProx/FedNova/FedAMW
    (``tools.py:337-352``; JAX ``core.py:_round_based``).

    ``aggregation`` is ``"fixed"`` (sample-count weights ``p_fixed``),
    ``"nova"`` (FedNova: ``train_loss`` weighs the clients' losses with
    ``p_fixed``, the aggregate uses ``fednova_effective_weights``; the
    JAX package's ``core.py:607-611,691-693``) or ``"learned"`` (FedAMW:
    ``train_loss`` weighs the clients' losses with the p of BEFORE the
    solve, then ``round`` p-solver epochs with momentum 0.9, then the
    aggregate with the new p; ``core.py:529-535``).

    ``participation < 1``: every client trains, a Bernoulli draw picks
    the present ones and absent clients get zero aggregate weight
    (``participation_weights``); FedAMW's p-solve runs masked over the
    present clients, an absent client's p and momentum zeroed first. A
    round with nobody present leaves the global weights (and FedAMW's p)
    as they were. ``server_opt`` (fixed weights only) steps the global
    weights on ``w_t - aggregate_t`` (``fedcore.server_opt``).
    ``start_round``/``stop_round`` run rounds ``[start, stop)`` of the
    ``rounds`` horizon, from ``resume_from``'s state when ``start > 0``;
    the lr schedule, the draws and the injected arrays are those of the
    whole horizon, so a split run equals the uninterrupted one bit for
    bit. ``kernel_impl``: ``"auto"`` runs the kernels' wrappers (CUDA
    kernels on the card), ``"plain"`` their plain versions on any device
    (the reference run).

    FedAMW's result carries ``mixture``: the per-round entropy and
    largest mass of the p each round ends with (``_mixture_stats``),
    computed on the device and copied to the host with the other metrics.
    ``analyze_memory=True`` runs round ``start_round`` alone and returns
    ``_memory_analysis``'s dict instead of the result: a measurement, not
    the JAX package's ahead-of-time estimate of the compiled program.
    """
    if not 0.0 < participation <= 1.0:
        raise ValueError(f"participation must be in (0, 1], got "
                         f"{participation}")
    learned = aggregation == "learned"
    if learned and server_opt != "none":
        raise ValueError(
            "FedAMW aggregates with LEARNED mixture weights; composing "
            "a FedOpt server optimizer on top is undefined — "
            "server_opt applies to FedAvg/FedProx/FedNova")
    stop = rounds if stop_round is None else int(stop_round)
    if not 0 <= start_round < stop <= rounds:
        raise ValueError(f"need 0 <= start_round < stop_round <= round, "
                         f"got start={start_round} stop={stop} "
                         f"round={rounds}")
    if start_round > 0 and resume_from is None:
        raise ValueError("start_round > 0 requires resume_from (a dict "
                         "with 'params' — utils.checkpoint."
                         "load_checkpoint's layout)")
    if sequential and participation < 1.0:
        raise ValueError(
            "sequential=True cannot compose with participation<1 (an "
            "absent client has no defined place in the reference's "
            "sequential contamination chain); use parallel semantics "
            "(sequential=False) for partial participation")
    check_server_opt(server_opt)

    dev = setup.device
    entry = None
    if analyze_memory:
        stop = start_round + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            entry = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    params = _init_params(setup, seed, params0)
    p, opt0 = setup.p_fixed, None
    if resume_from is not None:
        params, p_saved, opt0 = _resume_state(resume_from, learned,
                                              server_opt, dev)
        if p_saved is not None:
            p = p_saved
    round_fn = make_bucketed_round(setup.task, epoch, batch_size,
                                   setup.n_maxes, sequential, kernel_impl)
    idx_t, mask_t = setup.round_arrays()
    evaluate = make_evaluator(setup.model.apply, setup.task)
    lrs = lr_schedule_array(lr, rounds, lr_mode)
    mu, lam = _f32(mu), _f32(lam)
    valid = (setup.sizes > 0).to(torch.float32)
    agg_w = (fednova_effective_weights(setup.sizes, setup.p_fixed, epoch,
                                       batch_size)
             if aggregation == "nova" else setup.p_fixed)
    server = server_state = None
    if server_opt != "none":
        server = ServerOptimizer(server_opt, server_lr)
        server_state = server.init(params) if opt0 is None else opt0
    if learned:
        n_val = int(setup.X_val.shape[0])
        solve, init_opt = make_p_solver(setup.task, n_val, val_batch_size,
                                        lr_p, momentum=0.9, p_guard=p_guard,
                                        kernel_impl=kernel_impl)
        opt_state = init_opt(p) if opt0 is None else {"trace": opt0[0]}

    metrics = {"train_loss": [], "test_loss": [], "test_acc": []}
    if learned:
        metrics.update(p_entropy=[], p_max=[])
    t_scan0 = time.perf_counter()
    for t in range(start_round, stop):
        pos_t = (_round_generator(setup, seed, t) if client_positions is None
                 else _at(client_positions, t))
        stacked, losses, _ = round_fn(
            params, setup.X, setup.y, idx_t, mask_t, pos_t, float(lrs[t]),
            mu, lam)
        part = None
        if participation < 1.0:
            drawn = (torch.rand(valid.shape, device=dev,
                                generator=_round_generator(setup, seed + 2,
                                                           t))
                     < participation if participation_masks is None
                     else _tensor(participation_masks[t], dev) > 0)
            part = valid * drawn.to(torch.float32)
        if learned:
            ppos_t = (draw_epoch_positions(_round_generator(setup, seed + 1,
                                                            t),
                                           n_val, val_batch_size,
                                           lead=(rounds,))
                      if p_positions is None else _tensor(p_positions[t], dev))
            if part is None:
                train_loss_t = torch.sum(p * losses)  # current p (tools.py:434)
                logits = client_logits(setup.model.apply, stacked,
                                       setup.X_val)
                p, opt_state, _, _ = solve(logits, setup.y_val, p, opt_state,
                                           ppos_t, client_valid=valid)
                params = weighted_average(stacked, p)
            else:
                # absent clients carry exactly zero mixture mass: p and
                # its momentum are masked before the solve and the
                # masked gradient keeps both at zero (core.py:445-530)
                stacked, losses, ok = _finite_reports(params, stacked, losses)
                present = part * ok
                p_m = p * present
                train_loss_t = torch.sum(p_m * losses)
                logits = client_logits(setup.model.apply, stacked,
                                       setup.X_val)
                p_s, opt_s, _, _ = solve(
                    logits, setup.y_val, p_m,
                    {"trace": opt_state["trace"] * present}, ppos_t,
                    client_valid=present)
                any_p = torch.sum(present) > 0
                p = torch.where(any_p, p_s, p)
                opt_state = _where(any_p, opt_s, opt_state)
                w_t = participation_weights(p_s, present)
                params = _where(torch.sum(torch.abs(w_t)) > 0,
                                weighted_average(stacked, w_t), params)
        else:
            if part is None:
                train_loss_t = torch.sum(setup.p_fixed * losses)
                agg = weighted_average(stacked, agg_w)
            else:
                train_loss_t = torch.sum(
                    participation_weights(setup.p_fixed, part) * losses)
                agg = _where(torch.sum(part) > 0, weighted_average(
                    stacked, participation_weights(agg_w, part)), params)
            if server is None:
                params = agg
            else:
                params, server_state = server.step(params, agg, server_state)
        if learned:
            # the p this round ends with (the carried p of core.py:552-555)
            for k, v in zip(("p_entropy", "p_max"), _mixture_stats(p)):
                metrics[k].append(v)
        tl, ta = evaluate(params, setup.X_test, setup.y_test)
        if verbose:
            print(f"[round {t:3d}] train loss {float(train_loss_t):8.5f} | "
                  f"test loss {float(tl):8.5f} | test acc {float(ta):5.1f}%",
                  flush=True)
        metrics["train_loss"].append(train_loss_t)
        metrics["test_loss"].append(tl)
        metrics["test_acc"].append(ta)

    if analyze_memory:
        return _memory_analysis(setup, learned, (idx_t, mask_t), params, p,
                                len(metrics), entry)
    # one host copy of every metric of every round
    host = dict(zip(metrics, torch.stack(
        [torch.stack(v) for v in metrics.values()]).cpu().numpy()))
    scan_s = time.perf_counter() - t_scan0
    out = result_tuple(host["train_loss"], host["test_loss"],
                       host["test_acc"])
    if learned:
        out["mixture"] = {"p_entropy": host["p_entropy"],
                          "p_max": host["p_max"]}
    _emit_round_spans(out, host, aggregation, start_round, stop, t_scan0,
                      scan_s)
    if return_state:
        out["params"] = params
        out["p"] = p
        if learned:
            out["p_opt"] = (opt_state["trace"],)
        elif server is not None:
            out["server_opt"] = server_state
            out["server_opt_kind"] = server_opt
    return out


def _emit_round_spans(out, metrics, aggregation, start_round, stop, t_scan0,
                      scan_s):
    """The training side of the trace plane (JAX ``core.py:1548-1653``):
    when the process-global tracer is enabled (the driver's
    ``--trace_dir`` configures it), emit one ``"train_scan"`` span from
    just before the first round to the metrics' host copy, and one
    ``"round"`` record per round under it, carrying the round's metrics
    (and FedAMW's mixture entropy and largest mass) as attributes. The
    same per-round values land in the process-global telemetry registry
    as gauges (``fed_train_loss``, ``fed_test_loss``, ``fed_test_acc``,
    ``fed_p_entropy``, ``fed_p_max``, labelled ``{"agg": aggregation}``).

    The rounds are queued on the device without a synchronisation between
    them, so the host cannot see round boundaries: each round's duration
    is the span's attributed uniformly, and every record says so
    (``attrs["timing"] == "uniform"``). Measuring each boundary would add
    a device synchronisation per round and change the timing of the path
    being traced. Fault and defense counters join with those planes."""
    tracer = get_tracer()
    if not tracer.enabled:
        return
    n_r = stop - start_round
    run_id = tracer.new_id("run")
    scan_id = tracer.emit(
        "train_scan", run_id, t_scan0, scan_s,
        aggregation=aggregation, rounds=n_r, start_round=start_round,
        robust_agg=_ROBUST_CANONICAL, faults=False, timing="host")
    per = scan_s / max(1, n_r)
    mix = out.get("mixture", {})
    registry = get_registry()
    labels = {"agg": aggregation}
    gauges = {
        k: registry.gauge(f"fed_{k}", h, labels=labels)
        for k, h in (("train_loss", "per-round training loss"),
                     ("test_loss", "per-round test loss"),
                     ("test_acc", "per-round test accuracy"))}
    mix_gauges = {
        k: registry.gauge(f"fed_{k}", "FedAMW learned-mixture dynamics",
                          labels=labels)
        for k in mix}
    # round timestamps on the REGISTRY's clock basis: the run ended
    # "now", rounds attributed uniformly backwards — the same uniform
    # attribution as the spans, stated in their timing attr
    t_end = registry.clock()
    for i in range(n_r):
        attrs = {
            "round": start_round + i,
            "train_loss": float(metrics["train_loss"][i]),
            "test_loss": float(metrics["test_loss"][i]),
            "test_acc": float(metrics["test_acc"][i]),
            "timing": "uniform",
        }
        t_i = t_end - scan_s + (i + 1) * per
        for k, g in gauges.items():
            g.set(attrs[k], t=t_i)
        for k, g in mix_gauges.items():
            v = float(mix[k][i])
            attrs[k] = v
            g.set(v, t=t_i)
        tracer.emit("round", run_id, t_scan0 + i * per, per,
                    parent_id=scan_id, **attrs)


def _oneshot_local_phase(setup: FedSetup, epoch, batch_size, sequential,
                         seed, lr, mu, lam, params0, client_positions,
                         kernel_impl):
    """Every client trains ``epoch`` epochs from the same init
    (``tools.py:261-267``), chained under ``sequential``. Returns
    ``(stacked, losses)``."""
    params = _init_params(setup, seed, params0)
    round_fn = make_bucketed_round(setup.task, epoch, batch_size,
                                   setup.n_maxes, sequential, kernel_impl)
    positions = (_device_generator(setup, seed) if client_positions is None
                 else client_positions)
    idx_t, mask_t = setup.round_arrays()
    stacked, losses, _ = round_fn(params, setup.X, setup.y, idx_t, mask_t,
                                  positions, _f32(lr), _f32(mu), _f32(lam))
    return stacked, losses


def Centralized(setup: FedSetup, lr=0.01, epoch=200, batch_size=32, seed=0,
                sequential=False, participation=1.0, faults=None,
                robust_agg="mean", params0=None, client_positions=None,
                kernel_impl="auto", **waiting):
    """Upper-bound baseline (``tools.py:240-255``; the driver calls it
    with ``local_epoch * round`` epochs): all clients' train rows pooled
    into one client, one long local run at a constant lr with no prox or
    ridge term, then the last epoch's train loss and one evaluation.
    ``sequential`` is taken and has no effect (one client has no chain),
    as in the JAX package. ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("Centralized", participation, faults, robust_agg)
    _reject_waiting("Centralized", waiting, _ROUND_LOOP_ONLY)
    all_idx = setup.all_train_idx
    n = int(all_idx.shape[0])
    local_update = make_local_update(setup.task, epoch, batch_size, n,
                                     kernel_impl)
    positions = (_device_generator(setup, seed) if client_positions is None
                 else client_positions)
    params, train_loss, _ = local_update(
        _init_params(setup, seed, params0), setup.X, setup.y, all_idx,
        torch.ones(n, dtype=torch.float32, device=setup.device), positions,
        _f32(lr), 0.0, 0.0)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    return _scalar_row(train_loss,
                       *evaluate(params, setup.X_test, setup.y_test))


def Distributed(setup: FedSetup, lr=0.01, epoch=200, batch_size=32,
                prox=False, mu=0.1, lambda_reg_if=False, lambda_reg=0.01,
                seed=0, sequential=False, participation=1.0, faults=None,
                robust_agg="mean", params0=None, client_positions=None,
                kernel_impl="auto", **waiting):
    """One-shot FL with fixed sample-count weights (``tools.py:258-276``):
    the one-shot local phase, then one ``p_fixed`` aggregate and one
    evaluation. ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("Distributed", participation, faults, robust_agg)
    _reject_waiting("Distributed", waiting, _ROUND_LOOP_ONLY)
    stacked, losses = _oneshot_local_phase(
        setup, epoch, batch_size, sequential, seed, lr, mu if prox else 0.0,
        lambda_reg if lambda_reg_if else 0.0, params0, client_positions,
        kernel_impl)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    return _scalar_row(
        torch.sum(setup.p_fixed * losses),
        *evaluate(weighted_average(stacked, setup.p_fixed), setup.X_test,
                  setup.y_test))


def FedAMW_OneShot(setup: FedSetup, lr=0.01, epoch=200, batch_size=32,
                   prox=False, mu=0.1, lambda_reg_if=True, lambda_reg=0.01,
                   round=100, lr_p=5e-5, val_batch_size=16, seed=0,
                   sequential=False, participation=1.0, faults=None,
                   robust_agg="mean", p_guard="none", params0=None,
                   client_positions=None, p_positions=None,
                   kernel_impl="auto", **waiting):
    """The one-shot local phase, then ``round`` iterations of one
    mixture-weight SGD epoch each (plain, no momentum — ``tools.py:301``)
    over the validation logits computed once, re-aggregating and
    evaluating after each (``tools.py:279-326``). ``train_loss`` is
    ``sum(p_fixed * losses)``. ``p_guard`` as in ``FedAMW``;
    ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("FedAMW_OneShot", participation, faults, robust_agg)
    _reject_waiting("FedAMW_OneShot", waiting, _ROUND_LOOP_ONLY)
    stacked, losses = _oneshot_local_phase(
        setup, epoch, batch_size, sequential, seed, lr, mu if prox else 0.0,
        lambda_reg if lambda_reg_if else 0.0, params0, client_positions,
        kernel_impl)
    p = setup.p_fixed
    train_loss = torch.sum(p * losses)
    logits = client_logits(setup.model.apply, stacked, setup.X_val)
    n_val = int(setup.X_val.shape[0])
    solve, init_opt = make_p_solver(setup.task, n_val, val_batch_size, lr_p,
                                    momentum=0.0, p_guard=p_guard,
                                    kernel_impl=kernel_impl)
    opt_state = init_opt(p)
    client_valid = (setup.sizes > 0).to(torch.float32)
    p_shuffles = _device_generator(setup, seed + 1)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    test_loss, test_acc = [], []
    for t in range(round):
        ppos_t = (draw_epoch_positions(p_shuffles, n_val, val_batch_size,
                                       lead=(1,))
                  if p_positions is None
                  else _tensor(p_positions[t], setup.device))
        p, opt_state, _, _ = solve(logits, setup.y_val, p, opt_state, ppos_t,
                                   client_valid=client_valid)
        tl, ta = evaluate(weighted_average(stacked, p), setup.X_test,
                          setup.y_test)
        test_loss.append(tl)
        test_acc.append(ta)
    return result_tuple(train_loss.cpu().numpy(),
                        torch.stack(test_loss).cpu().numpy(),
                        torch.stack(test_acc).cpu().numpy())


def FedAvg(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
           mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
           lr_mode="reference", sequential=False, verbose=False,
           return_state=False, participation=1.0, start_round=0,
           stop_round=None, resume_from=None, server_opt="none",
           server_lr=1.0, params0=None, client_positions=None,
           participation_masks=None, kernel_impl="auto",
           analyze_memory=False, **waiting):
    """Standard FedAvg (``tools.py:329-353``), with the round loop's
    options (``_round_based``).

    ``kernel_impl="plain"`` exists to build the reference run a kernel run
    is held against (``chip_smoke.py``); leave it at ``"auto"``.
    ``analyze_memory=True`` returns the measured memory footprint of one
    round instead of training (``_memory_analysis``).
    """
    _reject_waiting("FedAvg", waiting)
    return _round_based(
        setup, "fixed", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        params0=params0, client_positions=client_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)


def FedProx(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=True,
            mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", sequential=False, verbose=False,
            return_state=False, participation=1.0, start_round=0,
            stop_round=None, resume_from=None, server_opt="none",
            server_lr=1.0, params0=None, client_positions=None,
            participation_masks=None, kernel_impl="auto",
            analyze_memory=False, **waiting):
    """FedAvg skeleton + proximal term (``tools.py:356-380``); options
    and ``kernel_impl`` as in ``FedAvg``."""
    _reject_waiting("FedProx", waiting)
    return _round_based(
        setup, "fixed", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        params0=params0, client_positions=client_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)


def FedNova(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
            mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", sequential=False, verbose=False,
            return_state=False, participation=1.0, start_round=0,
            stop_round=None, resume_from=None, server_opt="none",
            server_lr=1.0, params0=None, client_positions=None,
            participation_masks=None, kernel_impl="auto",
            analyze_memory=False, **waiting):
    """Normalized averaging (``tools.py:383-410``): the FedAvg round with
    ``fednova_effective_weights`` as the aggregation weights; options
    and ``kernel_impl`` as in ``FedAvg``."""
    _reject_waiting("FedNova", waiting)
    return _round_based(
        setup, "nova", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        params0=params0, client_positions=client_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)


def FedAMW(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
           mu=0.1, lambda_reg_if=True, lambda_reg=0.01, round=100, lr_p=5e-5,
           val_batch_size=16, seed=0, lr_mode="reference", sequential=False,
           verbose=False, return_state=False, participation=1.0,
           start_round=0, stop_round=None, resume_from=None,
           server_opt="none", server_lr=1.0, p_guard="none", params0=None,
           client_positions=None, p_positions=None, participation_masks=None,
           kernel_impl="auto", analyze_memory=False, **waiting):
    """The paper's algorithm (``tools.py:413-463``): ridge-regularized
    local training; per round, ``round`` epochs of mixture-weight SGD
    (momentum 0.9) on the pooled validation set over cached per-client
    logits; aggregate with the learned, unconstrained p.

    ``p_guard`` (``"none"``, ``"simplex"``, ``"clip"`` or ``"clip:R"``;
    ``fedcore.aggregate.resolve_p_guard``) projects p after every p step
    (over the present clients under partial participation); on the card
    the p-solver kernel applies it in its epilogue. The round loop's
    other options as in ``FedAvg``; ``server_opt`` is refused.

    ``kernel_impl="plain"`` runs the plain versions of both kernels on any
    device: the reference run a kernel run is held against
    (``chip_smoke.py``).
    """
    _reject_waiting("FedAMW", waiting)
    return _round_based(
        setup, "learned", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        lr_p=lr_p, val_batch_size=val_batch_size, seed=seed,
        lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        p_guard=p_guard, params0=params0, client_positions=client_positions,
        p_positions=p_positions, participation_masks=participation_masks,
        kernel_impl=kernel_impl, analyze_memory=analyze_memory)
