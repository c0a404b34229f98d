"""The plain PyTorch reference backend (``registry.get_backend("torch")``).

A copy of the JAX package's ``backends/torch_ref.py`` on the port's
``data.split_train_val`` and ``ops.schedule.lr_schedule_array``: a
from-scratch torch implementation of the same seven algorithms, kept
behind the backend registry so the drivers run either path unchanged.
It serves two purposes:

1. the plain PyTorch baseline a benchmark of the port measures the
   kernel path against, on the same card (the reference repo itself is
   not importable here and is never copied);
2. an independent same-semantics implementation for statistical
   accuracy-parity tests: it launches none of the port's kernels.

``prepare_setup(..., device=None)`` places the setup on the card unless
told ``"cpu"``. Every random draw stays on a CPU ``torch.Generator`` (the
RFF draw, the initial weights, each shuffle, the participation mask) and
is moved to the setup's device explicitly, so a card run consumes the
same streams as a CPU run, and a CPU run is the JAX package's
``torch_ref`` bit for bit. It reads each step's loss on the host: a
reference, slow by design.

Unlike the reference it shares one local-SGD routine and one round
scaffold across algorithms, uses raw weight tensors + autograd instead
of nn.Module machinery, and defaults to parallel client semantics
(``sequential=True`` restores the reference's client-contamination
artifact, as in the JAX path). Reference behaviors reproduced: the loss
surface (``functions/tools.py:193-209``), last-epoch Meter averaging
(:187-213), unconstrained mixture weights with SGD momentum 0.9 (:423),
the compounding LR decay (:43-61), sample-count aggregation weights.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..data import FederatedDataset, split_train_val
from ..device import resolve_device
from ..ops.schedule import lr_schedule_array


@dataclasses.dataclass
class TorchSetup:
    task: str
    num_classes: int
    D: int
    X: torch.Tensor              # (N, D) mapped features
    y: torch.Tensor
    X_test: torch.Tensor
    y_test: torch.Tensor
    X_val: torch.Tensor
    y_val: torch.Tensor
    parts: list                  # per-client index tensors
    sizes: np.ndarray

    @property
    def num_clients(self) -> int:
        return len(self.parts)

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def p_fixed(self) -> torch.Tensor:
        s = torch.tensor(self.sizes, dtype=torch.float64)
        return (s / s.sum()).float().to(self.device)


def prepare_setup(
    ds: FederatedDataset,
    D: int = 2000,
    kernel_par: float = 0.1,
    kernel_type: str = "gaussian",
    val_fraction: float = 0.2,
    seed: int = 100,
    rng: np.random.RandomState | None = None,
    device=None,
    **_,
) -> TorchSetup:
    """Torch analog of ``algorithms.prepare_setup`` (RFF once, 80/20 val
    pool, same index-set client layout), on ``device`` (the card unless
    ``"cpu"``)."""
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.RandomState(seed)
    g = torch.Generator().manual_seed(seed)
    X = torch.tensor(ds.X_train).to(dev)
    X_test = torch.tensor(ds.X_test).to(dev)
    if kernel_type == "gaussian":
        W = torch.normal(0.0, kernel_par, size=(ds.d, D),
                         generator=g).to(dev)
        b = (2 * math.pi * torch.rand(1, D, generator=g)).to(dev)
        X = torch.cos(X @ W + b) / math.sqrt(D)
        X_test = torch.cos(X_test @ W + b) / math.sqrt(D)
        feat_dim = D
    else:
        feat_dim = ds.d

    train_parts, val_idx = split_train_val(ds.parts, val_fraction, rng)
    y = torch.tensor(
        ds.y_train,
        dtype=torch.long if ds.task_type == "classification" else torch.float32,
    ).to(dev)
    vi = torch.tensor(np.asarray(val_idx), dtype=torch.long).to(dev)
    return TorchSetup(
        task=ds.task_type,
        num_classes=ds.num_classes,
        D=feat_dim,
        X=X,
        y=y,
        X_test=X_test,
        y_test=torch.tensor(
            ds.y_test,
            dtype=torch.long if ds.task_type == "classification" else torch.float32,
        ).to(dev),
        X_val=X[vi],
        y_val=y[vi],
        parts=[torch.tensor(np.asarray(p), dtype=torch.long).to(dev)
               for p in train_parts],
        sizes=np.array([len(p) for p in train_parts]),
    )


def _init_weights(setup: TorchSetup, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed * 7919 + 13)
    bound = math.sqrt(6.0 / (setup.D + setup.num_classes))
    return ((torch.rand(setup.num_classes, setup.D, generator=g) * 2 - 1)
            * bound).to(setup.device)


def _objective(w, anchor, xb, yb, task, mu, lam):
    out = xb @ w.T
    if task == "classification":
        loss = F.cross_entropy(out, yb)
    else:
        loss = F.mse_loss(out, yb.reshape(-1, 1))
    if mu:
        loss = loss + mu * (w - anchor).norm(2)
    if lam:
        loss = loss + lam * w.norm("fro")
    return loss, out


def _local_sgd(w0, setup, part, lr, epochs, batch_size, mu, lam, generator):
    """One client's local training; returns (weights, last-epoch loss/acc)."""
    X, y, task = setup.X, setup.y, setup.task
    w = w0.clone().requires_grad_(True)
    anchor = w0.clone()
    n = len(part)
    if n == 0:  # padded/empty client: inert (matches the JAX kernel)
        return w0.clone(), 0.0, 0.0
    ep_loss = ep_acc = 0.0
    for _ in range(epochs):
        order = part[torch.randperm(n, generator=generator).to(part.device)]
        loss_sum = correct = count = 0.0
        for start in range(0, n, batch_size):
            rows = order[start : start + batch_size]
            xb, yb = X[rows], y[rows]
            loss, out = _objective(w, anchor, xb, yb, task, mu, lam)
            (grad,) = torch.autograd.grad(loss, w)
            with torch.no_grad():
                w -= lr * grad
            bs = len(rows)
            loss_sum += float(loss.detach()) * bs
            if task == "classification":
                correct += float((out.argmax(1) == yb).sum())
            count += bs
        ep_loss = loss_sum / count
        ep_acc = 100.0 * correct / count
    return w.detach(), ep_loss, ep_acc


def _evaluate(w, setup: TorchSetup):
    with torch.no_grad():
        out = setup.X_test @ w.T
        if setup.task == "classification":
            loss = float(F.cross_entropy(out, setup.y_test))
            acc = 100.0 * float((out.argmax(1) == setup.y_test).float().mean())
        else:
            loss = float(F.mse_loss(out, setup.y_test.reshape(-1, 1)))
            acc = 0.0
    return loss, acc


def _client_pass(setup, w_global, lr, epochs, batch_size, mu, lam, generator,
                 sequential=False, active=None):
    """All clients' local updates for one round.

    ``active`` (optional 0/1 mask) skips absent clients' training
    entirely — their stacked entry is the unchanged input weights and
    their loss 0, both of which the caller multiplies by a zero
    aggregation weight. Unlike the JAX scan (static shapes force dense
    compute there), this Python loop recovers the ~1/participation
    speedup; a skipped client does not advance the sequential
    contamination chain (it never trained).
    """
    stacked, losses, accs = [], [], []
    w_in = w_global
    for j, part in enumerate(setup.parts):
        if active is not None and not bool(active[j]):
            stacked.append(w_in.clone())
            losses.append(0.0)
            accs.append(0.0)
            continue
        w_j, l_j, a_j = _local_sgd(
            w_in, setup, part, lr, epochs, batch_size, mu, lam, generator
        )
        stacked.append(w_j)
        losses.append(l_j)
        accs.append(a_j)
        if sequential:
            w_in = w_j  # reference contamination artifact (tools.py:341)
    dev = w_global.device
    return (torch.stack(stacked), torch.tensor(losses, device=dev),
            torch.tensor(accs, device=dev))


def _weighted_average(stacked: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.einsum("j...,j->...", stacked, p)


def _solve_p(logits, y_val, p, buf, lr_p, momentum, batch_size, epochs, task,
             generator):
    """Mixture-weight SGD over cached per-client val logits (same design
    as the JAX solver). Returns (p, momentum_buffer)."""
    n = len(y_val)
    p = p.clone().requires_grad_(True)
    for _ in range(epochs):
        order = torch.randperm(n, generator=generator).to(logits.device)
        for start in range(0, n, batch_size):
            rows = order[start : start + batch_size]
            out = torch.einsum("bjc,j->bc", logits[rows], p)
            if task == "classification":
                loss = F.cross_entropy(out, y_val[rows])
            else:
                loss = F.mse_loss(out, y_val[rows].reshape(-1, 1))
            (grad,) = torch.autograd.grad(loss, p)
            with torch.no_grad():
                if momentum:
                    buf = momentum * buf + grad
                    p -= lr_p * buf
                else:
                    p -= lr_p * grad
    return p.detach(), buf



def _reject_partial(participation, algo: str):
    """Mirror of algorithms.core._reject_partial: one-shot algorithms
    have no per-round participation concept; refuse rather than silently
    ignore the option."""
    if participation != 1.0:
        raise ValueError(
            f"{algo} assumes full participation (it has no communication "
            f"rounds to sample clients in); got participation="
            f"{participation}")


def Centralized(setup, lr=0.01, epoch=200, batch_size=32, seed=0,
                participation=1.0, **_):
    _reject_partial(participation, "Centralized")
    g = torch.Generator().manual_seed(seed)
    all_idx = torch.cat(setup.parts)
    w, train_loss, _ = _local_sgd(
        _init_weights(setup, seed), setup, all_idx, lr, epoch, batch_size,
        0.0, 0.0, g,
    )
    test_loss, test_acc = _evaluate(w, setup)
    return _result(train_loss, test_loss, test_acc)


def Distributed(setup, lr=0.01, epoch=200, batch_size=32, prox=False, mu=0.1,
                lambda_reg_if=False, lambda_reg=0.01, seed=0,
                sequential=False, participation=1.0, **_):
    _reject_partial(participation, "Distributed")
    g = torch.Generator().manual_seed(seed)
    stacked, losses, _ = _client_pass(
        setup, _init_weights(setup, seed), lr, epoch, batch_size,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0, g,
        sequential,
    )
    p = setup.p_fixed
    w = _weighted_average(stacked, p)
    test_loss, test_acc = _evaluate(w, setup)
    return _result(float((p * losses).sum()), test_loss, test_acc)


def FedAMW_OneShot(setup, lr=0.01, epoch=200, batch_size=32, prox=False,
                   mu=0.1, lambda_reg_if=True, lambda_reg=0.01, round=100,
                   lr_p=5e-5, val_batch_size=16, seed=0, sequential=False,
                   participation=1.0, **_):
    _reject_partial(participation, "FedAMW_OneShot")
    g = torch.Generator().manual_seed(seed)
    stacked, losses, _ = _client_pass(
        setup, _init_weights(setup, seed), lr, epoch, batch_size,
        mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0, g,
        sequential,
    )
    p = setup.p_fixed
    train_loss = float((p * losses).sum())
    with torch.no_grad():
        logits = torch.einsum("jcd,nd->njc", stacked, setup.X_val)
    buf = torch.zeros_like(p)
    test_loss = np.zeros(round)
    test_acc = np.zeros(round)
    for t in range(round):
        p, buf = _solve_p(logits, setup.y_val, p, buf, lr_p, 0.0,
                          val_batch_size, 1, setup.task, g)
        w = _weighted_average(stacked, p)
        test_loss[t], test_acc[t] = _evaluate(w, setup)
    return _result(train_loss, test_loss, test_acc)


def _participation_weights(agg_w, part):
    """Aggregation weights restricted to a participation mask, subset
    rescaled to the full original mass (mirrors the JAX
    fedcore.aggregate.participation_weights)."""
    masked = agg_w * part
    total = float(masked.sum())
    if total <= 0:
        return torch.zeros_like(agg_w)
    return masked * (float(agg_w.sum()) / total)


def _rounds(setup, aggregation, lr, epoch, batch_size, rounds, mu, lam,
            lr_p=5e-5, val_batch_size=16, seed=0, lr_mode="reference",
            sequential=False, verbose=False, participation=1.0,
            server_opt="none", server_lr=1.0):
    if server_opt not in ("none", "sgd", "adam", "yogi", "adagrad"):
        raise ValueError(f"server_opt must be none|sgd|adam|yogi|adagrad, "
                         f"got {server_opt!r}")
    if aggregation == "learned" and server_opt != "none":
        raise ValueError(
            "FedAMW aggregates with LEARNED mixture weights; composing "
            "a FedOpt server optimizer on top is undefined — "
            "server_opt applies to FedAvg/FedProx/FedNova")
    if not 0.0 < participation <= 1.0:
        raise ValueError(f"participation must be in (0, 1], got "
                         f"{participation}")
    if sequential and participation < 1.0:
        # same rejection as the JAX backend (algorithms/core.py): an
        # absent client has no defined place in the sequential chain
        raise ValueError(
            "sequential=True cannot compose with participation<1 (an "
            "absent client has no defined place in the reference's "
            "sequential contamination chain); use parallel semantics "
            "(sequential=False) for partial participation")
    g = torch.Generator().manual_seed(seed)
    w = _init_weights(setup, seed)
    p = setup.p_fixed
    lrs = lr_schedule_array(lr, rounds, lr_mode)
    if aggregation == "nova":
        tau = torch.tensor(setup.sizes * epoch / batch_size,
                           dtype=torch.float32, device=setup.device)
        # empty clients (tau=0, p=0) stay inert instead of poisoning 0/0
        safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
        agg_w = torch.where(tau > 0, p * (tau * p).sum() / safe_tau,
                            torch.zeros_like(p))
    else:
        agg_w = p
    buf = torch.zeros_like(p)
    # FedOpt server-optimizer state (extension; mirrors the JAX
    # backend's optax formulas exactly, including bias correction and
    # optax's accumulator initializations: adam 0, yogi 1e-6,
    # adagrad 0.1)
    srv_init = {"yogi": 1e-6, "adagrad": 0.1}.get(server_opt, 0.0)
    srv_m = torch.full_like(w, srv_init)
    srv_v = torch.full_like(w, srv_init)
    train_loss = np.zeros(rounds)
    test_loss = np.zeros(rounds)
    test_acc = np.zeros(rounds)
    valid = (torch.tensor(np.asarray(setup.sizes),
                          device=setup.device) > 0).float()
    for t in range(rounds):
        part = None
        if participation < 1.0:
            # partial participation (extension; reference trains every
            # client every round): per-round Bernoulli mask over the
            # real (non-empty) clients — an empty client has zero
            # aggregation weight, so letting it "participate" alone
            # would pass a headcount gate yet zero the global model —
            # weights renormalized over participants; all-absent round
            # = no-op. Mirrors the JAX path's `valid` mask
            # (algorithms/core.py). Drawn BEFORE the client pass so
            # absent clients skip local training entirely; drawn on the
            # CPU generator and moved, so every device sees one stream.
            part = valid * (
                torch.rand(len(p), generator=g) < participation).float().to(
                    setup.device)
        stacked, losses, _ = _client_pass(
            setup, w, float(lrs[t]), epoch, batch_size, mu, lam, g,
            sequential, active=part,
        )
        if part is not None:
            train_loss[t] = float(
                (_participation_weights(p, part) * losses).sum())
            if float((agg_w * part).sum()) > 0:
                agg = _weighted_average(stacked,
                                        _participation_weights(agg_w, part))
            else:
                agg = w  # all-absent round: zero pseudo-gradient
        elif aggregation == "learned":
            train_loss[t] = float((p * losses).sum())
            with torch.no_grad():
                logits = torch.einsum("jcd,nd->njc", stacked, setup.X_val)
            p, buf = _solve_p(logits, setup.y_val, p, buf, lr_p, 0.9,
                              val_batch_size, rounds, setup.task, g)
            agg = _weighted_average(stacked, p)
        else:
            train_loss[t] = float((p * losses).sum())
            agg = _weighted_average(stacked, agg_w)
        if server_opt == "none":
            w = agg
        elif server_opt == "sgd":
            w = w - server_lr * (w - agg)
        elif server_opt == "adagrad":
            # optax.adagrad: sum-of-squares (init 0.1), eps=1e-7 inside
            # the rsqrt, zero-gated on empty accumulators
            g_t = w - agg
            srv_v = srv_v + g_t * g_t
            inv = torch.where(srv_v > 0, torch.rsqrt(srv_v + 1e-7),
                              torch.zeros_like(srv_v))
            w = w - server_lr * g_t * inv
        else:  # adam / yogi on the pseudo-gradient g_t = w - agg
            b1, b2, eps = 0.9, 0.99, 1e-3
            g_t = w - agg
            srv_m = b1 * srv_m + (1 - b1) * g_t
            if server_opt == "yogi":
                g2 = g_t * g_t
                srv_v = srv_v - (1 - b2) * torch.sign(srv_v - g2) * g2
            else:
                srv_v = b2 * srv_v + (1 - b2) * g_t * g_t
            m_hat = srv_m / (1 - b1 ** (t + 1))
            v_hat = srv_v / (1 - b2 ** (t + 1))
            w = w - server_lr * m_hat / (torch.sqrt(v_hat) + eps)
        test_loss[t], test_acc[t] = _evaluate(w, setup)
        if verbose:  # reference per-round eval print (tools.py:236)
            print(f"[round {t:3d}] train loss {train_loss[t]:8.5f} | "
                  f"test loss {test_loss[t]:8.5f} | "
                  f"test acc {test_acc[t]:5.1f}%", flush=True)
    return _result(train_loss, test_loss, test_acc)


def FedAvg(setup, lr=0.01, epoch=2, batch_size=32, prox=False, mu=0.1,
           lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
           lr_mode="reference", sequential=False, verbose=False,
           participation=1.0, server_opt="none", server_lr=1.0, **_):
    return _rounds(setup, "fixed", lr, epoch, batch_size, round,
                   mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
                   seed=seed, lr_mode=lr_mode, sequential=sequential,
                   verbose=verbose, participation=participation,
                   server_opt=server_opt, server_lr=server_lr)


def FedProx(setup, lr=0.01, epoch=2, batch_size=32, prox=True, mu=0.1,
            lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", sequential=False, verbose=False,
            participation=1.0, server_opt="none", server_lr=1.0, **_):
    return _rounds(setup, "fixed", lr, epoch, batch_size, round,
                   mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
                   seed=seed, lr_mode=lr_mode, sequential=sequential,
                   verbose=verbose, participation=participation,
                   server_opt=server_opt, server_lr=server_lr)


def FedNova(setup, lr=0.01, epoch=2, batch_size=32, prox=False, mu=0.1,
            lambda_reg_if=False, lambda_reg=0.01, round=100, seed=0,
            lr_mode="reference", sequential=False, verbose=False,
            participation=1.0, server_opt="none", server_lr=1.0, **_):
    return _rounds(setup, "nova", lr, epoch, batch_size, round,
                   mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
                   seed=seed, lr_mode=lr_mode, sequential=sequential,
                   verbose=verbose, participation=participation,
                   server_opt=server_opt, server_lr=server_lr)


def FedAMW(setup, lr=0.01, epoch=2, batch_size=32, prox=False, mu=0.1,
           lambda_reg_if=True, lambda_reg=0.01, round=100, lr_p=5e-5,
           val_batch_size=16, seed=0, lr_mode="reference",
           sequential=False, verbose=False, participation=1.0,
           server_opt="none", server_lr=1.0, **_):
    if participation < 1.0:  # same contract as the JAX backend
        raise ValueError(
            "FedAMW assumes full participation; partial participation is "
            "supported for FedAvg/FedProx/FedNova only"
        )
    return _rounds(setup, "learned", lr, epoch, batch_size, round,
                   mu if prox else 0.0, lambda_reg if lambda_reg_if else 0.0,
                   lr_p=lr_p, val_batch_size=val_batch_size, seed=seed,
                   lr_mode=lr_mode, sequential=sequential, verbose=verbose,
                   server_opt=server_opt, server_lr=server_lr)


def _result(train_loss, test_loss, test_acc):
    return {
        "train_loss": np.asarray(train_loss),
        "test_loss": np.asarray(test_loss),
        "test_acc": np.asarray(test_acc),
    }


ALGORITHMS = {
    "Centralized": Centralized,
    "Distributed": Distributed,
    "FedAMW_OneShot": FedAMW_OneShot,
    "FedAvg": FedAvg,
    "FedProx": FedProx,
    "FedNova": FedNova,
    "FedAMW": FedAMW,
}
