"""The paper's seven algorithms, on any model of the zoo (``models/``).

Reference registry (``functions/tools.py``): ``Centralized`` (:240),
``Distributed`` (:258), ``FedAMW_OneShot`` (:279), ``FedAvg`` (:329),
``FedProx`` (:356), ``FedNova`` (:383), ``FedAMW`` (:413). Each keeps the
JAX package's keyword surface (``prox``/``mu``, ``lambda_reg_if``/
``lambda_reg``, ``round``, ``lr_p``) and returns the same
``(train_loss, test_loss, test_acc)`` record: a scalar row for
Centralized and Distributed, ``(round,)`` vectors for the others.

- The round loop (FedAvg, FedProx, FedNova, FedAMW): one round = {all
  clients' local epochs (kernel 1 on the linear model, the autograd
  route on the others: ``fedcore.client``) -> FedAMW's validation logits
  and p-solve (kernel 2) -> weighted aggregate -> evaluation}, the JAX
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
  round and the per-round telemetry series (``_emit_round_spans``). The
  fault and defense planes (``faults=``, ``robust_agg=``;
  ``fedcore.faults``, ``fedcore.robust``) run between the local epochs
  and the aggregate (``_Defense``). The cohort plane
  (``fedcore.hierarchy``): ``cohort_shards=S`` re-associates the round's
  mean reductions into per-shard partial sums (``hierarchy`` in the
  result), and ``stream_cohort=True`` streams the client rows from the
  host shard by shard (``_streamed_round_based``; not FedAMW). Every
  path also runs on a setup split over ranks (``parallel.shard_setup``):
  each rank trains its block of clients and meets the others in
  all-reduces and all-gathers (``parallel.ClientAxis``).
- The one-shot phase (Distributed, FedAMW_OneShot): every client trains
  ``epoch`` epochs from one init (kernel 1, one launch per epoch, or per
  client and epoch under ``sequential``), then a fixed-weight aggregate,
  or ``round`` iterations of one plain-SGD p-epoch each (kernel 2), each
  followed by an aggregate and an evaluation. The reference's ``p[0]``
  aliasing bug is not reproduced (MIGRATION.md deviation 2).
- Centralized: one client holding every valid train row
  (``FedSetup.all_train_idx``), no prox and no ridge, a constant lr.

The one-shot algorithms refuse partial participation, faults and robust
aggregation with ``ValueError`` and ignore ``server_opt``/``server_lr``,
``analyze_memory``, ``cohort_shards`` and ``stream_cohort``, as the JAX
package does.

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

import dataclasses
import functools
import time
import warnings

import numpy as np
import torch

from ..data.stream import CohortShardStream
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
from ..fedcore.client import make_client_round
from ..fedcore.faults import inject_fault_row, resolve_fault_plan
from ..fedcore.hierarchy import (
    fold_summaries,
    make_shard_tier,
    resolve_cohort_shards,
    shard_histogram,
    shard_ids,
    two_tier_weighted_average,
)
from ..fedcore.robust import (
    Z_AUTO_BETA,
    Z_AUTO_INIT,
    Z_AUTO_MARGIN,
    Z_AUTO_MAX,
    Z_AUTO_MIN,
    Z_EVIDENCE_REF,
    client_delta_norms,
    clip_update_norms,
    directional_scores,
    krum_select,
    make_robust_aggregator,
    parse_robust_spec,
    reputation_update,
    sanitize_updates,
    trimmed_clean_basis,
    trust_bounded_work_frac,
    zscore_quarantine,
)
from ..fedcore.server_opt import ServerOptimizer, check_server_opt
from ..ops.schedule import lr_schedule_array
from ..parallel.mesh import ClientAxis, validate_cohort_alignment
from ..utils.telemetry import get_registry
from ..utils.trace import get_tracer
from .common import FedSetup, result_tuple

# round-loop options the one-shot algorithms take and ignore, as the JAX
# package's do (they swallow every keyword, core.py:906-921)
_ROUND_LOOP_ONLY = ("server_opt", "server_lr", "analyze_memory",
                    "cohort_shards", "stream_cohort")


def _reject_unknown(algo: str, opts: dict) -> None:
    for k in opts:
        if k not in _ROUND_LOOP_ONLY:
            raise TypeError(f"{algo}() got an unexpected keyword argument "
                            f"{k!r}")


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


def _where(cond, new: dict, old: dict) -> dict:
    return {k: torch.where(cond, new[k], old[k]) for k in new}


# the client axis of a single-process run (ClientAxis without a mesh)
_FLAT = ClientAxis()


class _Defense:
    """The round loop's fault and defense stages, shared by the fixed,
    nova and learned paths (JAX ``core.py:188-391``): the static flags of
    the ``robust_agg`` spec, the cross-round state, ``guard`` (the fault
    and quarantine prologue of a round) and ``aggregate`` (clip, robust
    reduction, the all-absent gate). Everything is device tensors; no
    stage reads a value on the host."""

    def __init__(self, robust_agg, aggregation: str, faults_on: bool):
        spec = parse_robust_spec(robust_agg)
        self.spec = spec
        self.canonical = spec.canonical()
        self.on = not spec.is_default
        self.faults_on = faults_on
        self.rep_on = spec.rep_decay is not None
        self.zauto_on = spec.zscore_auto
        self.quarantine = spec.zscore is not None or self.zauto_on
        # krum/mkrum on the learned path folds its selection into the
        # present mask before the p-solve, and the aggregate stays the
        # learned weighted average over the selected set
        self.sel_m = spec.select_m if aggregation == "learned" else None
        self.agg_spec = (dataclasses.replace(spec, agg="mean", mkrum_m=0)
                         if self.sel_m is not None else spec)
        self.reduce = make_robust_aggregator(self.agg_spec)
        # the spec reads every client's update: reputation's directional
        # channel (a coordinate-wise median), krum, the order statistics;
        # over ranks the stacked updates are then all-gathered in guard
        self.every_update = (self.rep_on or self.agg_spec.agg != "mean"
                             or self.sel_m is not None)

    def init_state(self, num_clients: int, device, rep0=None,
                   zq0=None) -> dict:
        """The state carried across rounds (JAX ``core.py:228-251``):
        ``rep`` (every client fully trusted, or ``rep0``), the krum
        verdicts ``ksel``/``kcand`` that feed the next round's reputation,
        and ``quarantine:auto``'s estimate ``zq`` (or ``zq0``). Empty for
        a memoryless spec."""
        st = {}
        if self.rep_on:
            st["rep"] = (torch.ones(num_clients, device=device)
                         if rep0 is None else rep0)
            if self.spec.select_m is not None:
                st["ksel"] = torch.ones(num_clients, device=device)
                st["kcand"] = torch.zeros(num_clients, device=device)
        if self.zauto_on:
            st["zq"] = (torch.full((), Z_AUTO_INIT, device=device)
                        if zq0 is None else zq0)
        return st

    def guard(self, params, stacked, losses, present, drawn, row, dstate,
              axis=_FLAT):
        """The JAX package's ``guard_faults`` (``core.py:253-368``), in its
        order: (1) participation, drops and the non-finite quarantine
        decide who reported and who is finite; (2) the carried reputation
        gates distrusted clients out of this round's statistics; (3) the
        reported work fraction is trust-clamped; (4) the z-test runs on
        work-normalized norms, scored over every finite reporter under
        ``rep``; (5) reputation steps and its new verdict gates the
        present mask. Returns ``(stacked, losses, present, aux, state,
        work_frac)``; ``aux`` holds the round's defense telemetry.

        Over ranks (``axis``) ``stacked`` and ``losses`` come in as this
        rank's block: the faults and the non-finite quarantine act on it,
        then the losses, the finiteness verdicts and the delta norms of
        every client are all-gathered in one collective, and under a spec
        that reads every update (``every_update``) so are the stacked
        updates. Every decision then runs replicated on whole vectors;
        ``losses`` goes out whole, ``stacked`` whole or as the block."""
        spec = self.spec
        if drawn is not None:
            present = present * drawn.to(torch.float32)
        if self.faults_on:
            stacked, losses = inject_fault_row(
                params, stacked, losses, *map(axis.local, row[1:4]))
            present = present * (1.0 - row[0])
        reported = present
        stacked, losses, ok = sanitize_updates(params, stacked, losses)
        need_norms = self.quarantine or self.rep_on
        if need_norms:
            losses, ok, norms = axis.gather_vectors(
                losses, ok, client_delta_norms(params, stacked))
        else:
            (losses, ok), norms = axis.gather_vectors(losses, ok), None
        if self.every_update:
            stacked = axis.gather_tree(stacked)
        present = present * ok
        aux = {}
        if self.faults_on:
            aux["quarantined"] = torch.sum(reported * (1.0 - ok))
        state = dict(dstate)
        work_frac = row[4] if self.faults_on else None
        rep_prev = dstate.get("rep")
        # the finite reporters: reputation collects evidence over them
        scoreable = reported * ok
        if self.rep_on:
            present = present * torch.where(rep_prev >= spec.rep_floor,
                                            1.0, 0.0)
        if self.rep_on and self.faults_on:
            work_frac, aux["frac_clamped"] = trust_bounded_work_frac(
                norms, work_frac, present, rep_prev)
        z, z_ref = None, Z_EVIDENCE_REF
        if need_norms:
            if self.zauto_on:
                z_ref = torch.clamp(Z_AUTO_MARGIN * dstate["zq"],
                                    Z_AUTO_MIN, Z_AUTO_MAX)
            elif spec.zscore is not None:
                z_ref = spec.zscore
            zok, z = zscore_quarantine(
                params, stacked, present, z_ref, work_frac=work_frac,
                norms=norms, score_mask=scoreable if self.rep_on else None)
            if self.quarantine:
                aux["z_quarantined"] = torch.sum(present * (1.0 - zok))
                # over the quarantine's decision set only (rep scores
                # gated clients too)
                aux["z_max"] = torch.max(z * present)
                if self.zauto_on:
                    aux["z_threshold"] = z_ref
                    clean = present * zok
                    zq = dstate["zq"]
                    q_t = torch.where(torch.sum(clean) > 0,
                                      trimmed_clean_basis(z, clean, zq), zq)
                    state["zq"] = ((1.0 - Z_AUTO_BETA) * zq
                                   + Z_AUTO_BETA * q_t)
                    aux["zq"] = state["zq"]
                present = present * zok
        if self.rep_on:
            rep_new = reputation_update(
                rep_prev, reported, scoreable,
                directional_scores(params, stacked, present), present, z,
                z_ref, spec.rep_decay, sel=dstate.get("ksel"),
                sel_cand=dstate.get("kcand"))
            gate = torch.where(rep_new >= spec.rep_floor, 1.0, 0.0)
            aux["rep_gated"] = torch.sum(reported * (1.0 - gate))
            aux["reputation"] = rep_new
            state["rep"] = rep_new
            present = present * gate
        return stacked, losses, present, aux, state, work_frac

    def aggregate(self, params, stacked, w_t, present, mean):
        """Clip, the robust reduction and the all-absent no-op gate (JAX
        ``core.py:370-391``): on weight mass for the mean, on headcount for
        the order statistics. The mean is ``mean(stacked, w_t)`` (the flat
        weighted average, in-graph ``cohort_shards``' two-tier partial
        sums, or over ranks a partial sum and its all-reduce); the order
        statistics fold over every client as they are. Returns ``(params,
        aux)``."""
        if self.spec.clip is not None:
            stacked = clip_update_norms(params, stacked, self.spec.clip)
        if self.agg_spec.agg == "mean":
            agg, aux = mean(stacked, w_t), {}
        else:
            agg, aux = self.reduce(params, stacked, w_t, present)
        ok_round = (torch.sum(torch.abs(w_t)) > 0
                    if self.agg_spec.agg == "mean"
                    else torch.sum(present) > 0)
        return _where(ok_round, agg, params), aux


def _client_val_logits(setup: FedSetup, stacked: dict) -> torch.Tensor:
    """``client_logits`` of the setup's model on its validation split,
    row blocks sized by the model's ``row_activations``."""
    m = setup.model
    return client_logits(m.apply, stacked, setup.X_val, m.row_activations(
        int(setup.X_val.shape[1]), setup.num_classes))


def _mixture_stats(p):
    """The learned mixture's entropy and largest mass, as 0-d tensors on
    p's device (JAX ``core.py:546-555``): ``-sum p log p`` with the double
    where, so a client of zero mass (absent under participation) adds an
    exact 0 rather than ``0 * log 0``."""
    pos = p > 0
    entropy = -torch.sum(torch.where(
        pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0))
    return entropy, torch.max(p)


def _check_ranks(setup: FedSetup, sequential: bool) -> None:
    """A client axis split over ranks runs the clients in parallel: the
    contamination chain threads one model through every client in order
    (the JAX driver refuses ``--shard`` with ``--sequential``)."""
    if sequential and setup.mesh_devices > 1:
        raise ValueError(
            "sequential=True cannot run over a client axis split across "
            f"{setup.mesh_devices} ranks: the reference's contamination "
            "chain threads one model through every client in order, "
            "which is serial by construction")


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
                     entry, defense_inputs=()):
    """``analyze_memory``'s dict, under the JAX package's keys (its
    ``memory_analysis`` of the compiled round program, ``core.py:1269-1281``)
    that a measurement can fill:

    - ``argument_size_in_bytes``: the tensors one round reads — the
      setup's features, labels and index arrays (``round_inputs``), the
      test set, the sizes and fixed weights, the params, on FedAMW the
      validation set and p, and under faults or a stateful defense the
      plan rows and the resumed defense state (``defense_inputs``);
    - ``output_size_in_bytes``: the params, p and one round's metrics
      (``n_metrics`` float32 values);
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
            setup.sizes, setup.p_fixed, params, defense_inputs]
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


def _resume_defense(resume_from, spec, num_clients: int, device):
    """``(rep0, zq0)``, the defense state a resume continues from, or
    None each, with the JAX package's warnings and checks
    (``core.py:1197-1248``): ``reputation`` under a ``rep`` spec (shape
    ``(num_clients,)``), and ``quarantine:auto``'s ``zq`` from a
    checkpoint's ``defense_state`` or a result's top-level ``zq`` (a
    scalar)."""
    rep0 = zq0 = None
    if resume_from is None:
        return rep0, zq0
    if spec.rep_decay is not None:
        rep_saved = resume_from.get("reputation")
        if rep_saved is None:
            warnings.warn(
                "resuming a rep-defended run from a checkpoint without "
                "'reputation': every client restarts fully trusted, so "
                "the resumed run only approximates the uninterrupted "
                "one (save with return_state=True and pass "
                "res['reputation'] through the checkpoint — exp.py "
                "--save_models does)", stacklevel=4)
        else:
            rep0 = _tensor(rep_saved, device, torch.float32)
            if tuple(rep0.shape) != (num_clients,):
                raise ValueError(
                    f"checkpoint 'reputation' has shape {tuple(rep0.shape)}; "
                    f"this run's cohort needs ({num_clients},) — "
                    "resuming across a cohort change is undefined")
    if spec.zscore_auto:
        saved_ds = resume_from.get("defense_state") or {}
        zq_saved = saved_ds.get("zq", resume_from.get("zq"))
        if zq_saved is None:
            warnings.warn(
                "resuming a quarantine:auto run from a checkpoint "
                "without a 'zq' defense state: the auto threshold "
                "re-tunes from the Z=5 start instead of continuing the "
                "carried estimate (save with return_state=True and "
                "pass res['zq'] through save_checkpoint("
                "defense_state={'zq': ...}) — exp.py --save_models "
                "does)", stacklevel=4)
        else:
            zq0 = _tensor(zq_saved, device, torch.float32)
            if zq0.numel() != 1:
                raise ValueError(
                    f"checkpoint 'zq' must be a scalar threshold "
                    f"estimate, got shape {tuple(zq0.shape)}")
            zq0 = zq0.reshape(())
    return rep0, zq0


def _host_metrics(metrics: dict, extra: dict | None = None) -> dict:
    """Every per-round metric in one host copy: ``{name: (rounds,)`` or
    ``(rounds, J)`` array``}``, and the tensors of ``extra`` under their
    own names in the same copy."""
    stacked = {k: torch.stack(v) for k, v in metrics.items()}
    stacked.update(extra or {})
    flat = torch.cat([v.reshape(-1) for v in stacked.values()]).cpu().numpy()
    out, off = {}, 0
    for k, v in stacked.items():
        out[k] = flat[off:off + v.numel()].reshape(tuple(v.shape))
        off += v.numel()
    return out


def _defense_record(host, defense: _Defense) -> dict:
    """``out["defense"]``: the verdicts and telemetry the spec emitted per
    round, with ``robust_agg`` and ``client_valid`` (JAX
    ``core.py:1307-1350``); empty when the spec emitted none."""
    rec = {}
    if "z_quarantined" in host:
        rec["z_quarantined"] = np.rint(host["z_quarantined"]).astype(int)
        rec["z_max"] = host["z_max"]
    if "z_threshold" in host:
        rec["z_threshold"] = host["z_threshold"]
    if "reputation" in host:
        rec["reputation"] = host["reputation"]
        rec["rep_gated"] = np.rint(host["rep_gated"]).astype(int)
    if "frac_clamped" in host:
        rec["frac_clamped"] = np.rint(host["frac_clamped"]).astype(int)
    if "krum_selected" in host:
        sel = np.rint(host["krum_selected"]).astype(int)
        rec["krum_selected"] = sel
        rec["krum_pick_counts"] = sel.sum(axis=0)
    if "geomed_residual" in host:
        rec["geomed_residual"] = host["geomed_residual"]
    if rec:
        rec["robust_agg"] = defense.canonical
        # padded clients are never present: per-client statistics mask
        # them out with this
        rec["client_valid"] = host["client_valid"].astype(int)
    return rec


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
    faults=None,
    robust_agg="mean",
    cohort_shards=0,
    stream_cohort=False,
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

    ``faults`` (None, a spec string, a ``FaultSpec`` or a ``FaultPlan``;
    ``fedcore.faults``) injects the plan's faults into each round's
    reports after local training; ``robust_agg`` (``fedcore.robust``)
    picks the defense. With either on, a round runs ``_Defense.guard``
    (participation, drops, the non-finite and z-score quarantines, the
    reputation gate) and ``_Defense.aggregate`` (clip, the robust
    reduction); FedNova's tau takes the plan's trust-clamped work
    fraction; FedAMW's p-solve runs masked over the clients still
    present (krum's selection folded in) and its aggregate weighs the
    survivors by reputation. The plan's rows go to the device once,
    before the first round. The result then carries ``fault_counts``
    (per round: dropped, straggled, corrupted, lied, quarantined) and
    ``defense`` (the spec's verdicts, ``_defense_record``), and
    ``return_state`` adds the final ``reputation`` and ``zq``, which a
    resume continues from. With ``faults=None`` and ``robust_agg="mean"``
    the round is the one without the planes.

    ``cohort_shards=S`` (the cohort plane, ``fedcore.hierarchy``; JAX
    ``core.py:1057-1085``) splits the client axis into ``S`` contiguous
    shards and routes every mean-family weighted reduction through the
    two-tier partial sums (``two_tier_weighted_average``); the evidence
    and every decision are the flat round's, and the result carries
    ``hierarchy`` (``cohort_shards`` and the per-round present clients of
    each shard, ``shard_present``). ``stream_cohort=True`` runs
    ``_streamed_round_based`` instead (not FedAMW).

    Over ranks (a ``parallel.shard_setup`` setup, ``setup.mesh``) each
    rank runs kernel 1 on its block of clients, with its rows of each
    whole draw or of the injected positions (``ClientAxis``); the losses,
    FedAMW's validation logits and the guard's evidence are all-gathered,
    so every decision and the p-solve run replicated on whole vectors;
    the mean-family aggregate is the rank's weighted partial sum and an
    all-reduce (``reduce_mean``); a spec that reads every update gathers
    the stacked updates in the guard (``_Defense.every_update``).
    ``cohort_shards`` must be a multiple of the ranks, and
    ``sequential`` is refused.

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
    n_shards = resolve_cohort_shards(cohort_shards, setup.num_clients,
                                     streamed=bool(stream_cohort))
    _check_ranks(setup, sequential)
    if n_shards and setup.mesh_devices > 1:
        # JAX core.py:1082-1085: each rank's shards are its own
        validate_cohort_alignment(n_shards, setup.mesh_devices)
    if stream_cohort:
        if n_shards == 0:
            raise ValueError(
                "stream_cohort=True needs cohort_shards >= 1 (the "
                "host->device shard size is the streaming knob)")
        if learned:
            raise ValueError(
                "stream_cohort=True does not compose with FedAMW's "
                "learned mixture weights yet: the p-solve consumes the "
                "(n_val, J, C) logit tensor globally, which is exactly "
                "the O(J) x O(n_val C) buffer streaming exists to "
                "avoid — use in-graph cohort_shards for FedAMW "
                "(ROADMAP follow-on)")
        return _streamed_round_based(
            setup, aggregation, lr, epoch, batch_size, rounds, mu, lam,
            n_shards, seed=seed, lr_mode=lr_mode, verbose=verbose,
            return_state=return_state, participation=participation,
            sequential=sequential, start_round=start_round,
            stop_round=stop_round, resume_from=resume_from,
            server_opt=server_opt, analyze_memory=analyze_memory,
            faults=faults, robust_agg=robust_agg, params0=params0,
            client_positions=client_positions, kernel_impl=kernel_impl)
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
    plan = resolve_fault_plan(faults, rounds, setup.num_clients)
    defense = _Defense(robust_agg, aggregation, plan is not None)
    # the rounds that run the fault and defense stages: every FedAMW round
    # under partial participation too (its p-solve runs masked)
    guarded = (defense.faults_on or defense.on
               or (learned and participation < 1.0))

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
    rep0, zq0 = _resume_defense(resume_from, defense.spec,
                                setup.num_clients, dev)
    axis = ClientAxis(setup)
    round_fn = make_bucketed_round(setup.task, epoch, batch_size,
                                   setup.n_maxes, sequential, kernel_impl,
                                   client_blocks=axis.blocks,
                                   apply_fn=setup.model.apply)
    idx_t, mask_t = setup.round_arrays()
    evaluate = make_evaluator(setup.model.apply, setup.task)
    lrs = lr_schedule_array(lr, rounds, lr_mode)
    mu, lam = _f32(mu), _f32(lam)
    valid = (setup.sizes > 0).to(torch.float32)
    agg_w = (fednova_effective_weights(setup.sizes, setup.p_fixed, epoch,
                                       batch_size)
             if aggregation == "nova" else setup.p_fixed)
    # the shard of each client (in-graph cohort_shards), in the stacked
    # order: bucket by bucket on a bucketed setup
    ids = shard_ids(setup.num_clients, n_shards, dev) if n_shards else None

    def reduce_mean(stacked, w, full):
        """The mean-family aggregate: of every client's updates (``full``),
        or of this rank's block, whose weighted partial sum is
        all-reduced over the ranks."""
        if full:
            return (two_tier_weighted_average(stacked, w, ids)
                    if ids is not None else weighted_average(stacked, w))
        if ids is not None:
            return two_tier_weighted_average(stacked, axis.local(w),
                                             axis.local(ids), setup.mesh)
        return weighted_average(stacked, axis.local(w), setup.mesh)

    def val_logits(stacked, full):
        """FedAMW's ``(n_val, J, C)`` validation logits of every client,
        all-gathered along the client axis from a rank's block."""
        logits = _client_val_logits(setup, stacked)
        return logits if full else axis.gather(logits, dim=1)
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
    # the run's plan rows, on the device before the first round
    fault_rows = (plan.rows(start_round, stop, dev)
                  if defense.faults_on else None)
    dstate = defense.init_state(setup.num_clients, dev, rep0, zq0)

    metrics = {"train_loss": [], "test_loss": [], "test_acc": []}
    if learned:
        metrics.update(p_entropy=[], p_max=[])
    t_scan0 = time.perf_counter()
    for t in range(start_round, stop):
        pos_t = (_round_generator(setup, seed, t) if client_positions is None
                 else axis.local_positions(_at(client_positions, t)))
        # this rank's clients (every client in a single-process run)
        stacked, losses, _ = round_fn(
            params, setup.X, setup.y, idx_t, mask_t, pos_t, float(lrs[t]),
            mu, lam)
        drawn = None
        if participation < 1.0:
            drawn = (torch.rand(valid.shape, device=dev,
                                generator=_round_generator(setup, seed + 2,
                                                           t))
                     < participation if participation_masks is None
                     else _tensor(participation_masks[t], dev) > 0)
        row = (None if fault_rows is None
               else tuple(a[t - start_round] for a in fault_rows))
        dfaux = {}
        # is `stacked` every client's? (over ranks: only where the guard
        # gathered it)
        full = not axis.sharded
        if guarded:
            (stacked, losses, present, dfaux, dstate,
             work_frac) = defense.guard(params, stacked, losses, valid,
                                        drawn, row, dstate, axis)
            full = full or defense.every_update
        else:
            losses = axis.gather(losses)
        mean = functools.partial(reduce_mean, full=full)
        if learned:
            ppos_t = (draw_epoch_positions(_round_generator(setup, seed + 1,
                                                            t),
                                           n_val, val_batch_size,
                                           lead=(rounds,))
                      if p_positions is None else _tensor(p_positions[t], dev))
            if not guarded:
                train_loss_t = torch.sum(p * losses)  # current p (tools.py:434)
                p, opt_state, _, _ = solve(val_logits(stacked, full),
                                           setup.y_val, p, opt_state,
                                           ppos_t, client_valid=valid)
                params = mean(stacked, p)
            else:
                if defense.sel_m is not None:
                    # krum's selection folds into the present mask: the
                    # deselected carry zero mixture mass this round
                    selected = krum_select(params, stacked, present,
                                           defense.sel_m)
                    if defense.rep_on:
                        dstate = dict(dstate, ksel=selected, kcand=present)
                    present = present * selected
                    dfaux["krum_selected"] = selected
                # absent clients carry exactly zero mixture mass: p and
                # its momentum are masked before the solve and the
                # masked gradient keeps both at zero (core.py:492-525)
                p_m = p * present
                train_loss_t = torch.sum(p_m * losses)
                p_s, opt_s, _, _ = solve(
                    val_logits(stacked, full), setup.y_val, p_m,
                    {"trace": opt_state["trace"] * present}, ppos_t,
                    client_valid=present)
                # an all-absent round is a full no-op
                any_p = torch.sum(present) > 0
                p = torch.where(any_p, p_s, p)
                opt_state = _where(any_p, opt_s, opt_state)
                w_t = participation_weights(p_s, present,
                                            trust=dstate.get("rep"))
                params, agg_aux = defense.aggregate(params, stacked, w_t,
                                                    present, mean)
                dfaux.update(agg_aux)
        else:
            if guarded:
                # FedNova's tau from the work each client reports (trust-
                # clamped under rep): straggler-exact (core.py:647-657)
                agg_w_t = (fednova_effective_weights(
                    setup.sizes, setup.p_fixed, epoch, batch_size,
                    tau_frac=work_frac)
                    if aggregation == "nova" and defense.faults_on
                    else agg_w)
                w_t = participation_weights(agg_w_t, present,
                                            trust=dstate.get("rep"))
                agg, agg_aux = defense.aggregate(params, stacked, w_t,
                                                 present, mean)
                if defense.rep_on and defense.agg_spec.select_m is not None:
                    # the krum verdict feeds the next round's reputation
                    dstate = dict(dstate, ksel=agg_aux["krum_selected"],
                                  kcand=present)
                dfaux.update(agg_aux)
                train_loss_t = torch.sum(
                    participation_weights(setup.p_fixed, present) * losses)
            elif drawn is None:
                train_loss_t = torch.sum(setup.p_fixed * losses)
                agg = mean(stacked, agg_w)
            else:
                part = valid * drawn.to(torch.float32)
                train_loss_t = torch.sum(
                    participation_weights(setup.p_fixed, part) * losses)
                agg = _where(torch.sum(part) > 0, mean(
                    stacked, participation_weights(agg_w, part)), params)
            if server is None:
                params = agg
            else:
                params, server_state = server.step(params, agg, server_state)
        if ids is not None:
            # the present clients of each shard (core.py:536-541,694-698):
            # (MAX_COHORT_SHARDS,), the first n_shards rows real
            dfaux["shard_present"] = shard_histogram(
                present if guarded else valid if drawn is None
                else valid * drawn.to(torch.float32), ids)
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
        for k, v in dfaux.items():
            metrics.setdefault(k, []).append(v)

    if analyze_memory:
        return _memory_analysis(
            setup, learned, (idx_t, mask_t), params, p,
            sum(v[0].numel() for v in metrics.values()), entry,
            (fault_rows, rep0, zq0))
    # under the planes the valid-client mask rides the same host copy
    host = _host_metrics(metrics, {"client_valid": valid}
                         if defense.faults_on or defense.on else None)
    scan_s = time.perf_counter() - t_scan0
    out = result_tuple(host["train_loss"], host["test_loss"],
                       host["test_acc"])
    if defense.faults_on:
        # the roles are plan facts over the real clients; quarantined is
        # the non-finite quarantine's verdict
        valid_np = host["client_valid"].astype(np.float64)
        sl = slice(start_round, stop)
        out["fault_counts"] = {
            "dropped": (plan.drop[sl] * valid_np).sum(1).astype(int),
            "straggled": (plan.straggle[sl] * valid_np).sum(1).astype(int),
            "corrupted": (plan.corrupt[sl] * valid_np).sum(1).astype(int),
            "lied": (plan.lie[sl] * valid_np).sum(1).astype(int),
            "quarantined": np.rint(host["quarantined"]).astype(int),
        }
    if ids is not None:
        out["hierarchy"] = {
            "cohort_shards": n_shards,
            "shard_present": np.rint(
                host["shard_present"][:, :n_shards]).astype(int)}
    record = _defense_record(host, defense)
    if record:
        out["defense"] = record
    if learned:
        out["mixture"] = {"p_entropy": host["p_entropy"],
                          "p_max": host["p_max"]}
    _emit_round_spans(out, host, aggregation, defense.canonical,
                      defense.faults_on, start_round, stop, t_scan0, scan_s)
    if return_state:
        out["params"] = params
        out["p"] = p
        if learned:
            out["p_opt"] = (opt_state["trace"],)
        elif server is not None:
            out["server_opt"] = server_state
            out["server_opt_kind"] = server_opt
        # the final reputation and auto-threshold estimate (the last rows
        # of their streams), checkpointable so a resume continues them
        for k in ("reputation", "zq"):
            if k in host:
                out[k] = host[k][-1]
    return out


# The streamed tier and stream of the most recent streamed run (the JAX
# package's _LAST_SHARD_TIER): tests pin the memoized tier across runs,
# and the stream's copy_wait_ms reads how long the compute waited on
# shard copies.
_LAST_SHARD_TIER = None
_LAST_STREAM = None


@functools.lru_cache(maxsize=64)
def _cached_shard_tier(apply_fn, task, epoch, batch_size, n_max, aggregation,
                       robust_canonical, faults_on, kernel_impl):
    """The memoized streamed shard tier (JAX ``core.py:1393-1405``): one
    tier serves every shard of every round of every run of the same
    configuration, the model's ``apply_fn`` part of the key (a linear
    tier is never reused for another model). Its guard is
    ``_Defense.guard`` on the shard's slice (stateless specs only: no
    carried state), its quarantine count the non-finite reports under a
    fault plan plus the z-test's."""
    defense = _Defense(robust_canonical, aggregation, faults_on)

    def guard(params, stacked, losses, present, row):
        stacked, losses, present, aux, _, work_frac = defense.guard(
            params, stacked, losses, present, None, row, {})
        quar = aux.get("quarantined", 0.0) + aux.get("z_quarantined", 0.0)
        return stacked, losses, present, quar, work_frac

    round_fn = make_client_round(task, epoch, batch_size, n_max,
                                 kernel_impl, apply_fn=apply_fn)
    return make_shard_tier(round_fn, epoch, batch_size, aggregation, guard,
                           defense.spec.clip)


def _streamed_round_based(setup, aggregation, lr, epoch, batch_size,
                          rounds, mu, lam, n_shards, seed=0,
                          lr_mode="reference", verbose=False,
                          return_state=False, participation=1.0,
                          sequential=False, start_round=0, stop_round=None,
                          resume_from=None, server_opt="none",
                          analyze_memory=False, faults=None,
                          robust_agg="mean", params0=None,
                          client_positions=None, kernel_impl="auto"):
    """The streamed cohort driver (``stream_cohort=True``; JAX
    ``core.py:1408-1528``): a host round loop over
    ``CohortShardStream``'s double-buffered client shards, each through
    the memoized shard tier (``_cached_shard_tier``: kernel 1 at ``J/S``
    clients per local epoch, then ``_Defense.guard`` on the shard) into a
    fixed-shape ``ShardSummary``; ``fold_summaries`` is the global tier.
    Cohort size is bounded by host memory (the ``O(J)`` rows), not the
    card's.

    Each shard's shuffles come from the round's device generator, the
    shards drawing in turn (so under the port's own draws a streamed run
    matches the flat run statistically, not bitwise), or are sliced from
    the injected ``client_positions``. The round's metrics stay on the
    device until one host copy after the last round.

    Over ranks (a ``parallel.shard_setup`` setup) a rank streams the
    ``S/N`` contiguous shards its block of clients falls in (the count is
    aligned, ``validate_cohort_alignment``), drawing its shards' shuffles
    after dropping the draws of the shards of the ranks before it, so
    each shard draws what it draws in one process; the folded partials
    and masses are all-reduced (``fold_summaries``).

    Supported surface, everything else refused as the JAX package refuses
    it: the fixed-weight aggregations with the stateless mean-family
    defenses (``clip:R``, ``quarantine:Z``; their evidence is
    shard-local), full participation, parallel clients, the single-pack
    layout, no server optimizer, no split runs. The result carries
    ``streamed`` (``cohort_shards``, ``shard_clients`` and each round's
    present count) and, under faults, ``fault_counts``.
    """
    if sequential:
        raise ValueError(
            "stream_cohort=True cannot compose with sequential=True "
            "(the contamination chain threads one model through every "
            "client in order; shards stream independently)")
    if participation < 1.0:
        raise ValueError(
            "stream_cohort=True does not support participation<1 yet; "
            "model dropout through the fault plane's drop= instead")
    if server_opt != "none":
        raise ValueError(
            "stream_cohort=True does not compose with a FedOpt server "
            "optimizer yet (server_opt applies to the flat and "
            "in-graph paths)")
    if start_round != 0 or stop_round is not None or resume_from is not None:
        raise ValueError(
            "stream_cohort=True does not support segmented/resumed "
            "runs yet (start_round/stop_round/resume_from)")
    if analyze_memory:
        raise ValueError(
            "analyze_memory reports one fused program's AOT footprint; "
            "the streamed path is a host loop over shard programs — "
            "measure the shard tier directly instead")
    if setup.bucket_idx is not None:
        raise ValueError(
            "stream_cohort=True needs the single-pack layout "
            "(prepare_setup(buckets=1)): the bucketed view re-sorts "
            "clients and has per-bucket shapes, so contiguous "
            "equal-shape shards cannot be sliced from it")
    rspec = parse_robust_spec(robust_agg)
    if (rspec.agg != "mean" or rspec.rep_decay is not None
            or rspec.zscore_auto):
        raise ValueError(
            f"stream_cohort=True supports the mean-family defenses "
            f"(clip:R, quarantine:Z) whose evidence is shard-local; "
            f"robust_agg={rspec.canonical()!r} needs global statistics "
            "— use the in-graph cohort_shards mode")

    dev = setup.device
    axis = ClientAxis(setup)
    stream = CohortShardStream(n_shards // setup.mesh_devices, setup.idx,
                               setup.mask, axis.local(setup.sizes),
                               axis.local(setup.p_fixed), device=dev)
    # the shard draws that come before this rank's shards in one process
    n_max = int(setup.idx.shape[1])
    skipped = (setup.mesh.rank * stream.n_shards * epoch if axis.sharded
               else 0)
    plan = resolve_fault_plan(faults, rounds, setup.num_clients)
    faults_on = plan is not None
    tier = _cached_shard_tier(setup.model.apply, setup.task, epoch,
                              batch_size, n_max, aggregation,
                              rspec.canonical(), faults_on, kernel_impl)
    global _LAST_SHARD_TIER, _LAST_STREAM
    _LAST_SHARD_TIER, _LAST_STREAM = tier, stream

    params = _init_params(setup, seed, params0)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    lrs = lr_schedule_array(lr, rounds, lr_mode)
    mu, lam = _f32(mu), _f32(lam)
    plan_rows = None
    if faults_on:
        # the whole plan's rows on the host once, pinned on the card; each
        # round streams its row shard by shard
        plan_rows = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            plan.drop, plan.scale, plan.poison, plan.fill, plan.report)]
        if dev.type == "cuda":
            plan_rows = [r.pin_memory() for r in plan_rows]
    positions = client_positions
    if isinstance(positions, (list, tuple)):
        (positions,) = positions        # the single pack's one array

    metrics = {"train_loss": [], "test_loss": [], "test_acc": [],
               "present": []}
    if faults_on:
        metrics["quarantined"] = []
    t_scan0 = time.perf_counter()
    for t in range(rounds):
        gen = _round_generator(setup, seed, t) if positions is None else None
        for _ in range(skipped if gen is not None else 0):
            # one epoch's keys of one shard, as the shard tier draws them
            torch.rand((stream.shard_clients, n_max), generator=gen,
                       dtype=torch.float32, device=gen.device)
        summaries = []
        for _, shard in stream.round_shards(
                fault_rows=(None if plan_rows is None
                            else [axis.local(r[t]) for r in plan_rows]),
                positions=(None if positions is None
                           else axis.local_positions(positions[t]))):
            summaries.append(tier(
                params, setup.X, setup.y, shard["idx"], shard["mask"],
                shard.get("positions", gen), float(lrs[t]), mu, lam,
                shard["sizes"], shard["p_fixed"], shard.get("fault_rows")))
        params, train_loss_t, n_present, n_quar = fold_summaries(
            params, summaries, aggregation, setup.mesh)
        tl, ta = evaluate(params, setup.X_test, setup.y_test)
        if verbose:
            print(f"[round {t:3d}] train loss {float(train_loss_t):8.5f} | "
                  f"test loss {float(tl):8.5f} | test acc {float(ta):5.1f}%",
                  flush=True)
        metrics["train_loss"].append(train_loss_t)
        metrics["test_loss"].append(tl)
        metrics["test_acc"].append(ta)
        metrics["present"].append(n_present)
        if faults_on:
            metrics["quarantined"].append(n_quar)

    host = _host_metrics(metrics)
    scan_s = time.perf_counter() - t_scan0
    out = result_tuple(host["train_loss"], host["test_loss"],
                       host["test_acc"])
    out["streamed"] = {"cohort_shards": n_shards,
                       "shard_clients": stream.shard_clients,
                       "present": host["present"]}
    if faults_on:
        valid_np = (setup.sizes > 0).cpu().numpy().astype(np.float64)
        out["fault_counts"] = {
            "dropped": (plan.drop * valid_np).sum(1).astype(int),
            "straggled": (plan.straggle * valid_np).sum(1).astype(int),
            "corrupted": (plan.corrupt * valid_np).sum(1).astype(int),
            "lied": (plan.lie * valid_np).sum(1).astype(int),
            "quarantined": np.rint(host["quarantined"]).astype(int),
        }
    _emit_round_spans(out, host, aggregation, rspec.canonical(), faults_on,
                      0, rounds, t_scan0, scan_s)
    if return_state:
        out["params"] = params
        out["p"] = setup.p_fixed
    return out


def _emit_round_spans(out, metrics, aggregation, robust_canonical,
                      faults_on, start_round, stop, t_scan0, scan_s):
    """The training side of the trace plane (JAX ``core.py:1548-1653``):
    when the process-global tracer is enabled (the driver's
    ``--trace_dir`` configures it), emit one ``"train_scan"`` span from
    just before the first round to the metrics' host copy, carrying the
    run's ``robust_agg`` and ``faults``, and one ``"round"`` record per
    round under it, carrying the round's metrics, fault counts, defense
    verdicts (and FedAMW's mixture entropy and largest mass) as
    attributes. The same per-round values land in the process-global
    telemetry registry (labelled ``{"agg": aggregation}``): the gauges
    ``fed_train_loss``, ``fed_test_loss``, ``fed_test_acc``,
    ``fed_p_entropy``, ``fed_p_max``, ``fed_reputation_mean`` and
    ``fed_reputation_min`` (over the real clients), and the counters
    ``fed_faults_total`` and ``fed_defense_total`` (by ``kind``).

    The rounds are queued on the device without a synchronisation between
    them, so the host cannot see round boundaries: each round's duration
    is the span's attributed uniformly, and every record says so
    (``attrs["timing"] == "uniform"``). Measuring each boundary would add
    a device synchronisation per round and change the timing of the path
    being traced."""
    tracer = get_tracer()
    if not tracer.enabled:
        return
    n_r = stop - start_round
    run_id = tracer.new_id("run")
    scan_id = tracer.emit(
        "train_scan", run_id, t_scan0, scan_s,
        aggregation=aggregation, rounds=n_r, start_round=start_round,
        robust_agg=robust_canonical, faults=bool(faults_on), timing="host")
    per = scan_s / max(1, n_r)
    fc = out.get("fault_counts", {})
    dfz = out.get("defense", {})
    mix = out.get("mixture", {})
    registry = get_registry()
    labels = {"agg": aggregation}
    gauges = {
        k: registry.gauge(f"fed_{k}", h, labels=labels)
        for k, h in (("train_loss", "per-round training loss"),
                     ("test_loss", "per-round test loss"),
                     ("test_acc", "per-round test accuracy"))}
    fault_counters = {
        k: registry.counter("fed_faults_total",
                            "per-round fault-plane counts, by kind",
                            labels={**labels, "kind": k})
        for k in fc}
    defense_counters = {
        k: registry.counter("fed_defense_total",
                            "per-round defense verdicts, by kind",
                            labels={**labels, "kind": k})
        for k in ("z_quarantined", "rep_gated", "frac_clamped")
        if k in dfz}
    rep = dfz.get("reputation")
    if rep is not None:
        rep_valid = np.asarray(
            dfz.get("client_valid", np.ones(rep.shape[1])), bool)
        rep_mean = registry.gauge("fed_reputation_mean",
                                  "mean reputation of real clients",
                                  labels=labels)
        rep_min = registry.gauge("fed_reputation_min",
                                 "least-trusted real client's score",
                                 labels=labels)
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
        for k in ("dropped", "straggled", "corrupted", "lied",
                  "quarantined"):
            if k in fc:
                attrs[k] = int(fc[k][i])
        for k, c in fault_counters.items():
            c.inc(int(fc[k][i]), t=t_i)
        for k in ("z_quarantined", "rep_gated", "frac_clamped"):
            if k in dfz:
                attrs[k] = int(dfz[k][i])
        for k, c in defense_counters.items():
            c.inc(int(dfz[k][i]), t=t_i)
        if rep is not None:
            row = np.asarray(rep[i], float)[rep_valid]
            if row.size:
                rep_mean.set(float(row.mean()), t=t_i)
                rep_min.set(float(row.min()), t=t_i)
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
    ``(stacked, losses, axis)``: over ranks ``stacked`` is this rank's
    block and ``losses`` every client's."""
    _check_ranks(setup, sequential)
    axis = ClientAxis(setup)
    params = _init_params(setup, seed, params0)
    round_fn = make_bucketed_round(setup.task, epoch, batch_size,
                                   setup.n_maxes, sequential, kernel_impl,
                                   client_blocks=axis.blocks,
                                   apply_fn=setup.model.apply)
    positions = (_device_generator(setup, seed) if client_positions is None
                 else axis.local_positions(client_positions))
    idx_t, mask_t = setup.round_arrays()
    stacked, losses, _ = round_fn(params, setup.X, setup.y, idx_t, mask_t,
                                  positions, _f32(lr), _f32(mu), _f32(lam))
    return stacked, axis.gather(losses), axis


def Centralized(setup: FedSetup, lr=0.01, epoch=200, batch_size=32, seed=0,
                sequential=False, participation=1.0, faults=None,
                robust_agg="mean", params0=None, client_positions=None,
                kernel_impl="auto", **ignored):
    """Upper-bound baseline (``tools.py:240-255``; the driver calls it
    with ``local_epoch * round`` epochs): all clients' train rows pooled
    into one client, one long local run at a constant lr with no prox or
    ridge term, then the last epoch's train loss and one evaluation.
    ``sequential`` is taken and has no effect (one client has no chain),
    as in the JAX package. ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("Centralized", participation, faults, robust_agg)
    _reject_unknown("Centralized", ignored)
    all_idx = setup.all_train_idx
    n = int(all_idx.shape[0])
    local_update = make_local_update(setup.task, epoch, batch_size, n,
                                     kernel_impl, setup.model.apply)
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
                kernel_impl="auto", **ignored):
    """One-shot FL with fixed sample-count weights (``tools.py:258-276``):
    the one-shot local phase, then one ``p_fixed`` aggregate and one
    evaluation. ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("Distributed", participation, faults, robust_agg)
    _reject_unknown("Distributed", ignored)
    stacked, losses, axis = _oneshot_local_phase(
        setup, epoch, batch_size, sequential, seed, lr, mu if prox else 0.0,
        lambda_reg if lambda_reg_if else 0.0, params0, client_positions,
        kernel_impl)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    return _scalar_row(
        torch.sum(setup.p_fixed * losses),
        *evaluate(weighted_average(stacked, axis.local(setup.p_fixed),
                                   setup.mesh),
                  setup.X_test, setup.y_test))


def FedAMW_OneShot(setup: FedSetup, lr=0.01, epoch=200, batch_size=32,
                   prox=False, mu=0.1, lambda_reg_if=True, lambda_reg=0.01,
                   round=100, lr_p=5e-5, val_batch_size=16, seed=0,
                   sequential=False, participation=1.0, faults=None,
                   robust_agg="mean", p_guard="none", params0=None,
                   client_positions=None, p_positions=None,
                   kernel_impl="auto", **ignored):
    """The one-shot local phase, then ``round`` iterations of one
    mixture-weight SGD epoch each (plain, no momentum — ``tools.py:301``)
    over the validation logits computed once, re-aggregating and
    evaluating after each (``tools.py:279-326``). ``train_loss`` is
    ``sum(p_fixed * losses)``. ``p_guard`` as in ``FedAMW``;
    ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("FedAMW_OneShot", participation, faults, robust_agg)
    _reject_unknown("FedAMW_OneShot", ignored)
    stacked, losses, axis = _oneshot_local_phase(
        setup, epoch, batch_size, sequential, seed, lr, mu if prox else 0.0,
        lambda_reg if lambda_reg_if else 0.0, params0, client_positions,
        kernel_impl)
    p = setup.p_fixed
    train_loss = torch.sum(p * losses)
    logits = axis.gather(_client_val_logits(setup, stacked), dim=1)
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
        tl, ta = evaluate(weighted_average(stacked, axis.local(p),
                                           setup.mesh),
                          setup.X_test, setup.y_test)
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
           server_lr=1.0, faults=None, robust_agg="mean", cohort_shards=0,
           stream_cohort=False, params0=None, client_positions=None,
           participation_masks=None, kernel_impl="auto",
           analyze_memory=False):
    """Standard FedAvg (``tools.py:329-353``), with the round loop's
    options (``_round_based``): ``faults=``, ``robust_agg=`` and the
    cohort plane's ``cohort_shards=`` and ``stream_cohort=`` among them.

    ``kernel_impl="plain"`` exists to build the reference run a kernel run
    is held against (``chip_smoke.py``); leave it at ``"auto"``.
    ``analyze_memory=True`` returns the measured memory footprint of one
    round instead of training (``_memory_analysis``).
    """
    return _round_based(
        setup, "fixed", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        faults=faults, robust_agg=robust_agg, cohort_shards=cohort_shards,
        stream_cohort=stream_cohort, params0=params0,
        client_positions=client_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)


def FedProx(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=True,
            mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", sequential=False, verbose=False,
            return_state=False, participation=1.0, start_round=0,
            stop_round=None, resume_from=None, server_opt="none",
            server_lr=1.0, faults=None, robust_agg="mean", cohort_shards=0,
            stream_cohort=False, params0=None, client_positions=None,
            participation_masks=None, kernel_impl="auto",
            analyze_memory=False):
    """FedAvg skeleton + proximal term (``tools.py:356-380``); options
    and ``kernel_impl`` as in ``FedAvg``."""
    return _round_based(
        setup, "fixed", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        faults=faults, robust_agg=robust_agg, cohort_shards=cohort_shards,
        stream_cohort=stream_cohort, params0=params0,
        client_positions=client_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)


def FedNova(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
            mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", sequential=False, verbose=False,
            return_state=False, participation=1.0, start_round=0,
            stop_round=None, resume_from=None, server_opt="none",
            server_lr=1.0, faults=None, robust_agg="mean", cohort_shards=0,
            stream_cohort=False, params0=None, client_positions=None,
            participation_masks=None, kernel_impl="auto",
            analyze_memory=False):
    """Normalized averaging (``tools.py:383-410``): the FedAvg round with
    ``fednova_effective_weights`` as the aggregation weights; options
    and ``kernel_impl`` as in ``FedAvg``."""
    return _round_based(
        setup, "nova", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        faults=faults, robust_agg=robust_agg, cohort_shards=cohort_shards,
        stream_cohort=stream_cohort, params0=params0,
        client_positions=client_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)


def FedAMW(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
           mu=0.1, lambda_reg_if=True, lambda_reg=0.01, round=100, lr_p=5e-5,
           val_batch_size=16, seed=0, lr_mode="reference", sequential=False,
           verbose=False, return_state=False, participation=1.0,
           start_round=0, stop_round=None, resume_from=None,
           server_opt="none", server_lr=1.0, p_guard="none", faults=None,
           robust_agg="mean", cohort_shards=0, stream_cohort=False,
           params0=None, client_positions=None, p_positions=None,
           participation_masks=None, kernel_impl="auto",
           analyze_memory=False):
    """The paper's algorithm (``tools.py:413-463``): ridge-regularized
    local training; per round, ``round`` epochs of mixture-weight SGD
    (momentum 0.9) on the pooled validation set over cached per-client
    logits; aggregate with the learned, unconstrained p.

    ``p_guard`` (``"none"``, ``"simplex"``, ``"clip"`` or ``"clip:R"``;
    ``fedcore.aggregate.resolve_p_guard``) projects p after every p step
    (over the present clients under partial participation); on the card
    the p-solver kernel applies it in its epilogue. ``cohort_shards``
    runs in-graph (the p-solve stays global, the aggregate goes through
    the two-tier sums); ``stream_cohort=True`` is refused, as in the JAX
    package. The round loop's other options as in ``FedAvg``;
    ``server_opt`` is refused.

    ``kernel_impl="plain"`` runs the plain versions of both kernels on any
    device: the reference run a kernel run is held against
    (``chip_smoke.py``).
    """
    return _round_based(
        setup, "learned", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        lr_p=lr_p, val_batch_size=val_batch_size, seed=seed,
        lr_mode=lr_mode, sequential=sequential, verbose=verbose,
        return_state=return_state, participation=participation,
        start_round=start_round, stop_round=stop_round,
        resume_from=resume_from, server_opt=server_opt, server_lr=server_lr,
        faults=faults, robust_agg=robust_agg, cohort_shards=cohort_shards,
        stream_cohort=stream_cohort, p_guard=p_guard, params0=params0,
        client_positions=client_positions, p_positions=p_positions,
        participation_masks=participation_masks, kernel_impl=kernel_impl,
        analyze_memory=analyze_memory)
