"""First-principles FLOPs accounting, the JAX package's ``utils/flops.py``
definition over the port's parameter dicts of tensors.

The client local-SGD cost of one *client-update* (= one client's full
local training for one communication round) is

    3 · fwd_flops_per_sample(...) · epochs · n_mean

with bwd ≈ 2× fwd (`x^T g` for the weight grad plus the input-side
grad). The forward count has two regimes: GEMM-only models (every
weight leaf 2-D — the linear model and the MLPs) use the weight-shape
formula 2·in·out per GEMM, equal to the JAX package's count; models with
higher-rank weight leaves (conv kernels) count a one-sample forward
under ``torch.utils.flop_counter.FlopCounterMode`` where the JAX package
asks XLA's cost model, because parameter shapes cannot express a conv's
output-size-proportional work. This counts the client forward/backward
ONLY — FedAMW's p-solver and logit cache are excluded (callers must
label such records).
"""

from __future__ import annotations

import warnings

import numpy as np


def _leaves(params) -> list:
    """The tensors of a parameter dict (nested dicts and sequences
    flattened in key order)."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in _leaves(v)]
    return [params]


def fwd_flops_per_sample(params, apply_fn=None, d=None,
                         with_provenance=False):
    """Forward FLOPs for one sample.

    GEMM-only models (every weight leaf 2-D): 2·(in·out) summed over
    the weight matrices (bias adds are negligible and skipped) — the
    JAX package's formula, so the two packages give equal counts.

    Models with higher-rank weight leaves (conv kernels): parameter
    shapes alone cannot give the cost — a conv does work proportional to
    its OUTPUT spatial size, reusing each kernel weight across positions
    — so when ``apply_fn``/``d`` are provided the count is
    ``FlopCounterMode``'s over ``apply_fn(params, zeros(1, d))`` (the
    matmuls and convolutions of that forward; elementwise work is not
    counted).

    ``with_provenance=True`` returns ``(flops, basis)`` instead of the
    bare count, where ``basis`` is the counting method actually used:
    ``'torch-flop-counter'`` (the counter over the one-sample forward;
    the JAX package's basis here is ``'xla-cost-model'``, which also
    counts elementwise work, so the two are not directly comparable),
    ``'gemm-formula'`` (the matmul-only 2·in·out count, exact regime for
    all-2-D models), or ``'gemm-formula-undercount'`` (the formula
    applied to a model with conv leaves, because no ``apply_fn``/``d``
    was given or the counter saw no work). Emitters must attach the
    basis to EVERY record they write; the undercount case additionally
    warns when the counter was asked and found nothing.
    """
    leaves = _leaves(params)
    has_high_rank = any(np.ndim(w) > 2 for w in leaves)
    basis = "gemm-formula"
    if apply_fn is not None and d is not None and has_high_rank:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        first = next(w for w in leaves if isinstance(w, torch.Tensor))
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            apply_fn(params, torch.zeros((1, int(d)), dtype=torch.float32,
                                         device=first.device))
        flops = counter.get_total_flops()
        if flops:
            return ((int(flops), "torch-flop-counter") if with_provenance
                    else int(flops))
        # the GEMM formula below is WRONG for >2-D leaves (it would
        # count only the linear head, a ~10x undercount for convs) —
        # never degrade silently
        warnings.warn(
            "fwd_flops_per_sample: FlopCounterMode counted no work in the "
            "forward; falling back to the 2-D GEMM formula, which "
            "UNDERCOUNTS models with conv kernels — treat the FLOPs "
            "fields of this record as a lower bound",
            RuntimeWarning, stacklevel=2)
        basis = "gemm-formula-undercount"
    elif has_high_rank:
        # no apply_fn/d to run: same undercount, same contract
        basis = "gemm-formula-undercount"
    flops = sum(
        2 * int(np.prod(tuple(w.shape)))
        for w in leaves
        if np.ndim(w) == 2
    )
    return (flops, basis) if with_provenance else flops


def client_update_flops(fwd_per_sample: float, epochs: int,
                        n_mean: float) -> float:
    """FLOPs of one client-update (fwd+bwd ≈ 3× fwd, `epochs` passes
    over a mean shard of `n_mean` samples). `n_mean` must average over
    the SAME client population the updates/s rate counts (padded/empty
    clients contribute 0 samples but still count as updates)."""
    return 3.0 * fwd_per_sample * epochs * n_mean
