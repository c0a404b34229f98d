"""Two-tier hierarchical aggregation over a sharded client axis.

The port of the JAX package's ``fedcore/hierarchy.py``, the cohort plane.
The client axis splits into ``S`` contiguous shards and the round's
server work into two tiers:

- **shard tier**: each shard of ``J/S`` clients computes its own evidence
  (delta norms, finiteness, and under streaming shard-local z-scores) and
  pre-aggregates its clients into fixed-shape summaries: a weighted
  partial parameter sum and a few scalar masses. Per-shard work is
  ``O(J/S)``; a summary is ``O(P)`` however many clients the shard holds.
- **global tier**: folds the shard summaries (partial sums for the
  fixed-weight algorithms; the global present mask, trusted weights and
  FedAMW's masked p-solve for the learned one) into the round's
  aggregate, touching ``O(S P)`` partials and ``O(J)`` score vectors.

Two modes share this machinery.

**In-graph sharding** (``cohort_shards=S`` on the round loop): the
stacked ``(J, ...)`` client axis stays whole on the device and every
mean-family weighted reduction is re-associated into per-shard partial
sums (``two_tier_weighted_average``) over the shard ids of
``shard_ids``. The partial buffers are ``(MAX_COHORT_SHARDS, ...)``
whatever ``S`` is, and ``S`` reaches no kernel: changing it builds and
launches nothing new. Evidence (norms, z-scores, reputation) is computed
per client exactly as in the flat round and the global statistics
(median/MAD, quantiles) fold over the whole ``(J,)`` score vectors, so
every quarantine and gating decision is bitwise the flat round's, and
the re-associated aggregate matches the flat one to float tolerance.
The order-statistic aggregators (median, trimmed mean, krum, geomed)
fold globally by definition and keep the flat reduction.

**Streamed sharding** (``stream_cohort=True``): the cohort's client rows
stay on the host (``data.stream.CohortShardStream`` copies one shard
ahead of the compute) and ``make_shard_tier``'s tier runs once per shard,
emitting a :class:`ShardSummary`; :func:`fold_summaries` is the global
tier. Cohort size is then bounded by host memory (the ``O(J)`` rows), not
the card's (one shard's stacked parameters). Statistics under streaming
are shard-local by construction: the z-test's median and MAD come from
the shard's own clients. The streamed driver is
``algorithms.core._streamed_round_based``.

FedAMW under in-graph sharding: the masked p-solve is global-tier work.
It consumes every client's validation logits and the globally folded
present mask, so quarantined, gated and deselected clients keep exactly
zero learned mass with no new code path; only the final aggregate with
the learned p goes through the two-tier partial sums.

Nothing here is a kernel: the partial sums are one fp32 matrix product
(``aggregate.segment_weighted_sums``), the rest plain tensor reductions,
all on the setup's device and none with atomics, so a rerun gives the
same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .aggregate import segment_weighted_sums
from .robust import clip_update_norms

#: Capacity of the shard axis for IN-GRAPH sharding: the partial buffers
#: are ``(MAX_COHORT_SHARDS, ...)`` whatever the shard count. Streamed
#: sharding has no such cap (its shard loop runs on the host).
MAX_COHORT_SHARDS = 64


def resolve_cohort_shards(cohort_shards: int, num_clients: int,
                          streamed: bool = False) -> int:
    """Validate ``cohort_shards`` (JAX ``hierarchy.py:resolve_cohort_shards``):
    0 turns the hierarchy off (the flat round); otherwise the count must
    fit the cohort, and in-graph sharding must also fit
    ``MAX_COHORT_SHARDS``."""
    s = int(cohort_shards)
    if s < 0:
        raise ValueError(f"cohort_shards must be >= 0, got {s}")
    if s == 0:
        return 0
    if s > num_clients:
        raise ValueError(
            f"cohort_shards={s} exceeds the cohort ({num_clients} "
            f"clients); a shard needs at least one client")
    if not streamed and s > MAX_COHORT_SHARDS:
        raise ValueError(
            f"cohort_shards={s} exceeds MAX_COHORT_SHARDS="
            f"{MAX_COHORT_SHARDS} for in-graph sharding; use "
            f"stream_cohort=True for host-loop shard counts")
    return s


def shard_ids(num_clients: int, n_shards: int, device=None) -> torch.Tensor:
    """Contiguous balanced shard assignment: client ``j`` belongs to shard
    ``floor(j * S / J)``, ``(J,)`` int32 on ``device``. Contiguity keeps
    each shard a slice of the client axis."""
    j = torch.arange(num_clients, dtype=torch.int64, device=device)
    return ((j * int(n_shards)) // num_clients).to(torch.int32)


def two_tier_weighted_average(stacked: dict, w: torch.Tensor,
                              ids: torch.Tensor, mesh=None) -> dict:
    """``sum_j w_j theta_j`` re-associated into shard partial sums: the
    shard tier's ``(MAX_COHORT_SHARDS, ...)`` partials
    (``segment_weighted_sums``), then the global tier's fold over the
    shard axis. ``aggregate.weighted_average`` to float tolerance.

    Over ranks (``mesh``) ``stacked``, ``w`` and ``ids`` are this rank's
    block, whose shards are its own (``parallel.validate_cohort_alignment``):
    the rank folds its shards' partials, and the fold over the ranks is
    the all-reduce."""
    partials = segment_weighted_sums(stacked, w, ids, MAX_COHORT_SHARDS)
    out = {k: torch.sum(v, dim=0) for k, v in partials.items()}
    if mesh is not None:
        out = {k: mesh.all_reduce(v) for k, v in out.items()}
    return out


def shard_histogram(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-shard totals of a ``(J,)`` vector, ``(MAX_COHORT_SHARDS,)``: the
    round's hierarchy telemetry (present clients per shard). A masked
    sum per shard row, no atomics."""
    seg = torch.arange(MAX_COHORT_SHARDS, device=v.device)
    return torch.where(ids[None, :] == seg[:, None], v[None, :],
                       0.0).sum(dim=1)


# -- streamed shard tier ------------------------------------------------


@dataclasses.dataclass
class ShardSummary:
    """The fixed-shape output of one streamed shard's tier: every field
    is ``O(P)`` or a 0-d tensor, so the stacked ``(J_s, P)`` client
    parameters never leave the shard tier.

    ``partial`` holds ``sum_{j in shard} u_j present_j theta_j`` with
    ``u`` the algorithm's unnormalised per-client weight (FedAvg and
    FedProx: the fixed sample-count weight; FedNova: ``p_j / tau_j``,
    whose global ``tau_eff`` is a scalar the fold applies). The scalar
    masses are what the global tier needs to renormalise over the
    cohort-wide present set as ``aggregate.participation_weights``
    does."""

    partial: dict                # {name: P-shaped partial sum}
    u_all: torch.Tensor          # sum of u over the shard's real clients
    u_present: torch.Tensor      # sum of u over the shard's present set
    tau_p: torch.Tensor          # sum of tau_j p_j (FedNova's tau_eff part)
    loss_num: torch.Tensor       # sum of p_fixed_j present_j loss_j
    p_all: torch.Tensor          # sum of p_fixed over real clients
    p_present: torch.Tensor      # sum of p_fixed over the present set
    n_present: torch.Tensor      # present-client count
    n_quarantined: torch.Tensor  # clients the shard's guard quarantined


def make_shard_tier(round_fn: Callable, epochs: int, batch_size: int,
                    aggregation: str, guard: Callable,
                    clip: float | None = None):
    """The per-shard tier of STREAMED rounds (JAX
    ``hierarchy.py:make_shard_tier``).

    ``round_fn`` is the client round (``client.make_client_round``).
    ``guard(params, stacked, losses, present, fault_row) -> (stacked,
    losses, present, n_quarantined, work_frac)`` is the round loop's
    fault and quarantine prologue run on the shard's slice: it injects
    the shard's slice of the fault plan, quarantines the non-finite
    reports and applies the SHARD-LOCAL z-test (the shard's own median
    and MAD); ``work_frac`` is the plan's reported work fraction, or
    None. ``clip`` then bounds the update norms.

    Returns ``shard_tier(params, X, y, idx_s, mask_s, positions, lr, mu,
    lam, sizes_s, p_fixed_s, fault_row=None) -> ShardSummary``;
    ``positions`` is the round's generator (each shard draws from it in
    turn) or the shard's injected shuffles.
    """
    nova = aggregation == "nova"

    def shard_tier(params, X, y, idx_s, mask_s, positions, lr, mu, lam,
                   sizes_s, p_fixed_s, fault_row=None):
        stacked, losses, _ = round_fn(params, X, y, idx_s, mask_s,
                                      positions, lr, mu, lam)
        valid = (sizes_s > 0).to(torch.float32)
        stacked, losses, present, quar, work_frac = guard(
            params, stacked, losses, valid, fault_row)
        if clip is not None:
            stacked = clip_update_norms(params, stacked, clip)
        if nova:
            tau = sizes_s.to(torch.float32) * epochs / batch_size
            if work_frac is not None:
                tau = tau * work_frac
            safe = torch.where(tau > 0, tau, 1.0)
            u = torch.where(tau > 0, p_fixed_s / safe, 0.0)
            tau_p = torch.sum(tau * p_fixed_s)
        else:
            u = p_fixed_s * valid
            tau_p = torch.zeros((), device=valid.device)
        up = u * present
        return ShardSummary(
            partial={k: torch.tensordot(up, s, dims=([0], [0]))
                     for k, s in stacked.items()},
            u_all=torch.sum(u * valid),
            u_present=torch.sum(up),
            tau_p=tau_p,
            loss_num=torch.sum(p_fixed_s * present * losses),
            p_all=torch.sum(p_fixed_s * valid),
            p_present=torch.sum(p_fixed_s * present),
            n_present=torch.sum(present),
            n_quarantined=torch.as_tensor(quar, dtype=torch.float32,
                                          device=valid.device),
        )

    return shard_tier


_MASSES = ("u_all", "u_present", "tau_p", "loss_num", "p_all",
           "p_present", "n_present", "n_quarantined")


def fold_summaries(params: dict, summaries: list, aggregation: str,
                   mesh=None):
    """The streamed GLOBAL tier (JAX ``hierarchy.py:fold_summaries``): fold
    the shards' summaries into the round's aggregate and train loss.

    The fold reproduces ``participation_weights``' cohort-wide
    renormalisation from the shard masses alone: the final weight of
    client ``j`` is ``u_j present_j * (sum u_all / sum u_present)`` (times
    FedNova's global ``tau_eff = sum tau_j p_j``). An all-absent round
    keeps the incoming params (the flat round's no-op gate). Over ranks
    (``mesh``) ``summaries`` are this rank's shards: their partial sums
    and masses are folded here and summed over the ranks by an
    ``all_reduce`` (one for the masses, one a leaf for the partials).

    Returns ``(new_params, train_loss, n_present, n_quarantined)``, all on
    the device.
    """
    # each field stacked over the shards and summed once: two launches a
    # field, not one per shard
    partial = {k: torch.stack([s.partial[k] for s in summaries]).sum(0)
               for k in summaries[0].partial}
    totals = [torch.stack([getattr(s, f) for s in summaries]).sum()
              for f in _MASSES]
    if mesh is not None:
        partial = {k: mesh.all_reduce(v) for k, v in partial.items()}
        totals = mesh.all_reduce(torch.stack(totals)).unbind(0)
    total = dict(zip(_MASSES, totals))
    u_all, u_present = total["u_all"], total["u_present"]
    p_all, p_present = total["p_all"], total["p_present"]
    scale = torch.where(u_present > 0,
                        u_all / torch.clamp(u_present, min=1e-30), 0.0)
    if aggregation == "nova":
        scale = scale * total["tau_p"]
    ok_round = u_present > 0
    new_params = {k: torch.where(ok_round, scale * partial[k], params[k])
                  for k in params}
    loss_scale = torch.where(p_present > 0,
                             p_all / torch.clamp(p_present, min=1e-30), 0.0)
    return (new_params, loss_scale * total["loss_num"], total["n_present"],
            total["n_quarantined"])
