"""FedAvg, FedProx and FedAMW as a loop over communication rounds.

Reference registry (``functions/tools.py``): ``FedAvg`` (:329),
``FedProx`` (:356), ``FedAMW`` (:413). Each keeps the reference's keyword
surface (``prox``/``mu``, ``lambda_reg_if``/``lambda_reg``, ``round``,
``lr_p``) and returns the same ``(train_loss, test_loss, test_acc)``
vectors. One round = {all clients' local epochs (kernel 1) -> FedAMW's
validation logits and p-solve (kernel 2) -> weighted aggregate ->
evaluation}, the JAX package's ``_round_based`` without its
participation, fault, robust, cohort, server-optimizer and resume
planes; passing one of those options raises (ROADMAP.md, queue 1).

Randomness. ``jax.random`` cannot be reproduced in torch, so every
random input is injectable: ``params0`` (initial weights),
``client_positions`` ``(rounds, J, epoch, S, B)`` (each client's
per-epoch shuffle, ``batching.epoch_batches`` layout) and, for FedAMW,
``p_positions`` ``(rounds, round, S_val, val_batch_size)`` (the
p-solver's per-epoch shuffles). Whatever is not injected is drawn from
``torch.Generator`` on the CPU: ``seed`` for the init and the client
shuffles, ``seed + 1`` for the p-solver's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fedcore import (
    client_logits,
    make_client_round,
    make_evaluator,
    make_p_solver,
    weighted_average,
)
from ..fedcore.batching import epoch_batches
from ..ops.schedule import lr_schedule_array
from .common import FedSetup, result_tuple

# The JAX package's options this port does not carry yet, with the value
# that means "off". Passing another value raises.
_WAITING = {
    "sequential": False,
    "participation": 1.0,
    "analyze_memory": False,
    "start_round": 0,
    "stop_round": None,
    "resume_from": None,
    "server_opt": "none",
    "server_lr": 1.0,
    "faults": None,
    "robust_agg": "mean",
    "cohort_shards": 0,
    "stream_cohort": False,
}


def _reject_waiting(algo: str, opts: dict) -> None:
    for k, v in opts.items():
        if k not in _WAITING:
            raise TypeError(f"{algo}() got an unexpected keyword argument "
                            f"{k!r}")
        if v is not _WAITING[k] and v != _WAITING[k]:
            raise NotImplementedError(
                f"{algo}: {k}={v!r} is not ported yet (see ROADMAP.md, "
                "queue 1)")


def _draw_client_positions(gen, mask_cpu, epochs, batch_size):
    """``(J, epochs, S, B)`` fresh shuffles, valid rows first."""
    n_max = mask_cpu.shape[1]
    return torch.stack([
        torch.stack([epoch_batches(n_max, batch_size, m, generator=gen)[0]
                     for _ in range(epochs)])
        for m in mask_cpu])


def _draw_p_positions(gen, n_val, num_epochs, batch_size):
    """``(num_epochs, S, B)`` fresh shuffles of the pooled validation set."""
    return torch.stack([epoch_batches(n_val, batch_size, generator=gen)[0]
                        for _ in range(num_epochs)])


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
    verbose=False,
    return_state=False,
    params0=None,
    client_positions=None,
    p_positions=None,
    kernel_impl="auto",
):
    """Common skeleton of FedAvg/FedProx/FedAMW (``tools.py:337-352``).

    ``aggregation`` is ``"fixed"`` (sample-count weights ``p_fixed``,
    ``core.py:691-693`` of the JAX package) or ``"learned"`` (FedAMW:
    ``train_loss`` weighs the clients' losses with the p of BEFORE the
    solve, then ``round`` p-solver epochs with momentum 0.9, then the
    aggregate with the new p; ``core.py:529-535``). ``kernel_impl``:
    ``"auto"`` runs the kernels' wrappers (CUDA kernels on the card),
    ``"plain"`` their plain versions on any device (the reference run).
    """
    dev = setup.device
    learned = aggregation == "learned"
    gen = torch.Generator().manual_seed(seed)
    if params0 is None:
        params0 = setup.model.init(gen, setup.D, setup.num_classes)
    params = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
              for k, v in params0.items()}
    round_fn = make_client_round(setup.task, epoch, batch_size, setup.n_max,
                                 kernel_impl)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    lrs = lr_schedule_array(lr, rounds, lr_mode)
    mu, lam = float(np.float32(mu)), float(np.float32(lam))
    mask_cpu = setup.mask.cpu()
    p = setup.p_fixed
    if learned:
        n_val = int(setup.X_val.shape[0])
        solve, init_opt = make_p_solver(setup.task, n_val, val_batch_size,
                                        lr_p, momentum=0.9,
                                        kernel_impl=kernel_impl)
        opt_state = init_opt(p)
        client_valid = (setup.sizes > 0).to(torch.float32)
        pgen = torch.Generator().manual_seed(seed + 1)

    train_loss, test_loss, test_acc = [], [], []
    for t in range(rounds):
        pos_t = (client_positions[t] if client_positions is not None else
                 _draw_client_positions(gen, mask_cpu, epoch, batch_size))
        stacked, losses, _ = round_fn(
            params, setup.X, setup.y, setup.idx, setup.mask,
            torch.as_tensor(pos_t).to(dev), float(lrs[t]), mu, lam)
        train_loss_t = torch.sum(p * losses)  # current p (tools.py:434)
        if learned:
            logits = client_logits(setup.model.apply, stacked, setup.X_val)
            ppos_t = (p_positions[t] if p_positions is not None else
                      _draw_p_positions(pgen, n_val, rounds, val_batch_size))
            p, opt_state, _, _ = solve(logits, setup.y_val, p, opt_state,
                                       torch.as_tensor(ppos_t).to(dev),
                                       client_valid=client_valid)
        params = weighted_average(stacked, p)
        tl, ta = evaluate(params, setup.X_test, setup.y_test)
        if verbose:
            print(f"[round {t:3d}] train loss {float(train_loss_t):8.5f} | "
                  f"test loss {float(tl):8.5f} | test acc {float(ta):5.1f}%",
                  flush=True)
        train_loss.append(train_loss_t)
        test_loss.append(tl)
        test_acc.append(ta)

    out = result_tuple(*(torch.stack(m).cpu().numpy()
                         for m in (train_loss, test_loss, test_acc)))
    if return_state:
        out["params"] = params
        out["p"] = p
        if learned:
            out["p_opt"] = opt_state
    return out


def FedAvg(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
           mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
           lr_mode="reference", verbose=False, return_state=False,
           params0=None, client_positions=None, kernel_impl="auto",
           **waiting):
    """Standard FedAvg (``tools.py:329-353``).

    ``kernel_impl="plain"`` exists to build the reference run a kernel run
    is held against (``chip_smoke.py``); leave it at ``"auto"``.
    """
    _reject_waiting("FedAvg", waiting)
    return _round_based(
        setup, "fixed", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, verbose=verbose,
        return_state=return_state, params0=params0,
        client_positions=client_positions, kernel_impl=kernel_impl)


def FedProx(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=True,
            mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", verbose=False, return_state=False,
            params0=None, client_positions=None, kernel_impl="auto",
            **waiting):
    """FedAvg skeleton + proximal term (``tools.py:356-380``);
    ``kernel_impl`` as in ``FedAvg``."""
    _reject_waiting("FedProx", waiting)
    return _round_based(
        setup, "fixed", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        seed=seed, lr_mode=lr_mode, verbose=verbose,
        return_state=return_state, params0=params0,
        client_positions=client_positions, kernel_impl=kernel_impl)


def FedAMW(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
           mu=0.1, lambda_reg_if=True, lambda_reg=0.01, round=100, lr_p=5e-5,
           val_batch_size=16, seed=0, lr_mode="reference", verbose=False,
           return_state=False, params0=None, client_positions=None,
           p_positions=None, kernel_impl="auto", **waiting):
    """The paper's algorithm (``tools.py:413-463``): ridge-regularized
    local training; per round, ``round`` epochs of mixture-weight SGD
    (momentum 0.9) on the pooled validation set over cached per-client
    logits; aggregate with the learned, unconstrained p.

    ``kernel_impl="plain"`` exists to build the reference run a kernel run
    is held against (``chip_smoke.py``); leave it at ``"auto"``.
    """
    _reject_waiting("FedAMW", waiting)
    return _round_based(
        setup, "learned", lr, epoch, batch_size, round,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
        lr_p=lr_p, val_batch_size=val_batch_size, seed=seed,
        lr_mode=lr_mode, verbose=verbose, return_state=return_state,
        params0=params0, client_positions=client_positions,
        p_positions=p_positions, kernel_impl=kernel_impl)
