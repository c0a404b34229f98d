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
  package's ``_round_based`` without its participation, fault, robust,
  cohort, server-optimizer and resume planes.
- The one-shot phase (Distributed, FedAMW_OneShot): every client trains
  ``epoch`` epochs from one init (kernel 1, one launch per epoch), then
  a fixed-weight aggregate, or ``round`` iterations of one plain-SGD
  p-epoch each (kernel 2), each followed by an aggregate and an
  evaluation. The reference's ``p[0]`` aliasing bug is not reproduced
  (MIGRATION.md deviation 2).
- Centralized: one client holding every valid train row
  (``FedSetup.all_train_idx``), no prox and no ridge, a constant lr.

Passing an option the port does not carry raises (ROADMAP.md, queue 1);
the one-shot algorithms refuse partial participation, faults and robust
aggregation with ``ValueError``, as the JAX package does.

Randomness. ``jax.random`` cannot be reproduced in torch, so every
random input is injectable: ``params0`` (initial weights);
``client_positions`` (each client's per-epoch shuffle,
``batching.epoch_batches`` layout): ``(rounds, J, epoch, S, B)`` for the
round loop, ``(J, epoch, S, B)`` for the one-shot phase, ``(epoch, S,
B)`` for Centralized; ``p_positions`` (the p-solver's per-epoch
shuffles): ``(rounds, rounds, S_val, val_batch_size)`` for FedAMW,
``(round, 1, S_val, val_batch_size)`` for FedAMW_OneShot. What is not
injected is drawn from seeded ``torch.Generator`` streams:

- the initial weights from a CPU generator seeded ``seed``, so every
  device starts from the same weights;
- the client shuffles from a generator on the setup's device seeded
  ``seed``: one ``batching.draw_epoch_positions`` call per local epoch,
  for all clients at once, just before that epoch's launch;
- the p-solver's shuffles from a generator on the setup's device seeded
  ``seed + 1``: one call per solve, for all of its epochs.

No shuffle is drawn on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fedcore import (
    client_logits,
    fednova_effective_weights,
    make_client_round,
    make_evaluator,
    make_local_update,
    make_p_solver,
    weighted_average,
)
from ..fedcore.batching import draw_epoch_positions
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


def _init_params(setup: FedSetup, seed, params0) -> dict:
    if params0 is None:
        params0 = setup.model.init(torch.Generator().manual_seed(seed),
                                   setup.D, setup.num_classes)
    return {k: torch.as_tensor(v, dtype=torch.float32).to(setup.device)
            for k, v in params0.items()}


def _device_generator(setup: FedSetup, seed) -> torch.Generator:
    return torch.Generator(device=setup.device).manual_seed(seed)


def _f32(v) -> float:
    return float(np.float32(v))


def _scalar_row(train_loss, test_loss, test_acc) -> dict:
    m = torch.stack([train_loss, test_loss, test_acc]).cpu().numpy()
    return result_tuple(m[0], m[1], m[2])


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
    """Common skeleton of FedAvg/FedProx/FedNova/FedAMW
    (``tools.py:337-352``).

    ``aggregation`` is ``"fixed"`` (sample-count weights ``p_fixed``),
    ``"nova"`` (FedNova: ``train_loss`` weighs the clients' losses with
    ``p_fixed``, the aggregate uses ``fednova_effective_weights``; the
    JAX package's ``core.py:607-611,691-693``) or ``"learned"`` (FedAMW:
    ``train_loss`` weighs the clients' losses with the p of BEFORE the
    solve, then ``round`` p-solver epochs with momentum 0.9, then the
    aggregate with the new p; ``core.py:529-535``). ``kernel_impl``:
    ``"auto"`` runs the kernels' wrappers (CUDA kernels on the card),
    ``"plain"`` their plain versions on any device (the reference run).
    """
    dev = setup.device
    learned = aggregation == "learned"
    params = _init_params(setup, seed, params0)
    round_fn = make_client_round(setup.task, epoch, batch_size, setup.n_max,
                                 kernel_impl)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    lrs = lr_schedule_array(lr, rounds, lr_mode)
    mu, lam = _f32(mu), _f32(lam)
    shuffles = _device_generator(setup, seed)
    p = setup.p_fixed
    agg_w = (fednova_effective_weights(setup.sizes, p, epoch, batch_size)
             if aggregation == "nova" else p)
    if learned:
        n_val = int(setup.X_val.shape[0])
        solve, init_opt = make_p_solver(setup.task, n_val, val_batch_size,
                                        lr_p, momentum=0.9,
                                        kernel_impl=kernel_impl)
        opt_state = init_opt(p)
        client_valid = (setup.sizes > 0).to(torch.float32)
        p_shuffles = _device_generator(setup, seed + 1)

    train_loss, test_loss, test_acc = [], [], []
    for t in range(rounds):
        pos_t = (shuffles if client_positions is None
                 else client_positions[t])
        stacked, losses, _ = round_fn(
            params, setup.X, setup.y, setup.idx, setup.mask, pos_t,
            float(lrs[t]), mu, lam)
        train_loss_t = torch.sum(p * losses)  # current p (tools.py:434)
        if learned:
            logits = client_logits(setup.model.apply, stacked, setup.X_val)
            ppos_t = (draw_epoch_positions(p_shuffles, n_val, val_batch_size,
                                           lead=(rounds,))
                      if p_positions is None
                      else torch.as_tensor(p_positions[t]).to(dev))
            p, opt_state, _, _ = solve(logits, setup.y_val, p, opt_state,
                                       ppos_t, client_valid=client_valid)
            agg_w = p
        params = weighted_average(stacked, agg_w)
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


def _oneshot_local_phase(setup: FedSetup, epoch, batch_size, seed, lr, mu,
                         lam, params0, client_positions, kernel_impl):
    """Every client trains ``epoch`` epochs from the same init
    (``tools.py:261-267``). Returns ``(stacked, losses)``."""
    params = _init_params(setup, seed, params0)
    round_fn = make_client_round(setup.task, epoch, batch_size, setup.n_max,
                                 kernel_impl)
    positions = (_device_generator(setup, seed) if client_positions is None
                 else client_positions)
    stacked, losses, _ = round_fn(params, setup.X, setup.y, setup.idx,
                                  setup.mask, positions, _f32(lr), _f32(mu),
                                  _f32(lam))
    return stacked, losses


def Centralized(setup: FedSetup, lr=0.01, epoch=200, batch_size=32, seed=0,
                participation=1.0, faults=None, robust_agg="mean",
                params0=None, client_positions=None, kernel_impl="auto",
                **waiting):
    """Upper-bound baseline (``tools.py:240-255``; the driver calls it
    with ``local_epoch * round`` epochs): all clients' train rows pooled
    into one client, one long local run at a constant lr with no prox or
    ridge term, then the last epoch's train loss and one evaluation.
    ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("Centralized", participation, faults, robust_agg)
    _reject_waiting("Centralized", waiting)
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
    _reject_waiting("Distributed", dict(waiting, sequential=sequential))
    stacked, losses = _oneshot_local_phase(
        setup, epoch, batch_size, seed, lr, mu if prox else 0.0,
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
                   robust_agg="mean", params0=None, client_positions=None,
                   p_positions=None, kernel_impl="auto", **waiting):
    """The one-shot local phase, then ``round`` iterations of one
    mixture-weight SGD epoch each (plain, no momentum — ``tools.py:301``)
    over the validation logits computed once, re-aggregating and
    evaluating after each (``tools.py:279-326``). ``train_loss`` is
    ``sum(p_fixed * losses)``. ``kernel_impl`` as in ``FedAvg``."""
    _reject_oneshot("FedAMW_OneShot", participation, faults, robust_agg)
    _reject_waiting("FedAMW_OneShot", dict(waiting, sequential=sequential))
    stacked, losses = _oneshot_local_phase(
        setup, epoch, batch_size, seed, lr, mu if prox else 0.0,
        lambda_reg if lambda_reg_if else 0.0, params0, client_positions,
        kernel_impl)
    p = setup.p_fixed
    train_loss = torch.sum(p * losses)
    logits = client_logits(setup.model.apply, stacked, setup.X_val)
    n_val = int(setup.X_val.shape[0])
    solve, init_opt = make_p_solver(setup.task, n_val, val_batch_size, lr_p,
                                    momentum=0.0, kernel_impl=kernel_impl)
    opt_state = init_opt(p)
    client_valid = (setup.sizes > 0).to(torch.float32)
    p_shuffles = _device_generator(setup, seed + 1)
    evaluate = make_evaluator(setup.model.apply, setup.task)
    test_loss, test_acc = [], []
    for t in range(round):
        ppos_t = (draw_epoch_positions(p_shuffles, n_val, val_batch_size,
                                       lead=(1,))
                  if p_positions is None
                  else torch.as_tensor(p_positions[t]).to(setup.device))
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


def FedNova(setup: FedSetup, lr=0.01, epoch=2, batch_size=32, prox=False,
            mu=0.1, lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", verbose=False, return_state=False,
            params0=None, client_positions=None, kernel_impl="auto",
            **waiting):
    """Normalized averaging (``tools.py:383-410``): the FedAvg round with
    ``fednova_effective_weights`` as the aggregation weights;
    ``kernel_impl`` as in ``FedAvg``."""
    _reject_waiting("FedNova", waiting)
    return _round_based(
        setup, "nova", lr, epoch, batch_size, round,
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
