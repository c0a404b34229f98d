"""Server-side aggregation and the FedAMW mixture-weight solver.

The reference's per-key dict loops (``functions/tools.py:345-349``)
become weighted ``tensordot`` reductions over stacked parameters with a
leading client axis. The FedAMW p-solver (``tools.py:441-453``) works on
per-client validation logits computed ONCE per round (the client models
are fixed during the solve) and runs its ``round x |val|/16`` tiny SGD
steps on ``p`` over that cached ``(n_val, J, C)`` tensor; each epoch is
one call of ``psolver_kernel.p_epoch`` — on CUDA tensors one launch of
the hand-written kernel. Mixture weights stay UNCONSTRAINED, as in the
reference (``tools.py:417-423``), unless the caller opts into a p-guard
(``resolve_p_guard``): a projection of p after every step, run by the
kernels' epilogue on the card and by the plain p-epoch on CPU tensors.
The guard is an explicit argument; the JAX package's ``FEDAMW_P_GUARD``
environment variable is not read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable

import torch

from . import cuda_build, psolver_kernel, route
from .batching import batch_counts, batch_valid, weighted_epoch_metrics
from .psolver_kernel import p_epoch, p_epoch_plain


def weighted_average(stacked_params: dict, p: torch.Tensor,
                     mesh=None) -> dict:
    """``sum_j p_j * theta_j`` over the leading client axis of every leaf
    (reference ``tools.py:345-349``). Over ranks (``mesh``, a
    ``parallel.ClientMesh``) ``stacked_params`` and ``p`` are this rank's
    block and its slice of p, and the partial sum is all-reduced."""
    out = {k: torch.tensordot(p, w, dims=([0], [0]))
           for k, w in stacked_params.items()}
    if mesh is not None:
        out = {k: mesh.all_reduce(v) for k, v in out.items()}
    return out


# the settings are process-global: blocks entered from several threads at
# once (the serving worker and its shadow-probe thread) share one hold,
# set by the first to enter and restored by the last to leave
_FP32_LOCK = threading.Lock()
_FP32_HOLD = {"depth": 0, "prev": None}


@contextlib.contextmanager
def full_fp32():
    """Full fp32 products and convolutions inside the block (no TF32 on
    the card: matmul precision ``"highest"``, cuDNN without TF32, which
    PyTorch allows for convolutions by default), on cuDNN's
    deterministic algorithms (by default it may pick a convolution
    backward that adds with atomics, and a rerun of the same step then
    differs in its last bits, which three rounds of FedAMW over the zoo's
    CNNs carry past the plain route's tolerance), the previous settings
    restored after it. Safe to enter from several threads at once and to
    nest: the settings hold until the last open block ends."""
    with _FP32_LOCK:
        if _FP32_HOLD["depth"] == 0:
            _FP32_HOLD["prev"] = (torch.get_float32_matmul_precision(),
                                  torch.backends.cudnn.allow_tf32,
                                  torch.backends.cudnn.deterministic)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        _FP32_HOLD["depth"] += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_HOLD["depth"] -= 1
            if _FP32_HOLD["depth"] == 0:
                prev = _FP32_HOLD["prev"]
                torch.set_float32_matmul_precision(prev[0])
                torch.backends.cudnn.allow_tf32 = prev[1]
                torch.backends.cudnn.deterministic = prev[2]


def segment_weighted_sums(stacked_params: dict, p: torch.Tensor,
                          ids: torch.Tensor, num_segments: int) -> dict:
    """Per-shard partial weighted sums (JAX ``aggregate.py:45-63``): leaf
    ``(J, ...)`` becomes ``(num_segments, ...)`` whose row ``s`` is
    ``sum_{j: ids_j == s} p_j * theta_j``, the shard tier of the two-tier
    reduction (``fedcore.hierarchy``). Rows past the last shard are
    exactly 0.

    One product of the ``(num_segments, J)`` matrix holding ``p_j`` where
    ``ids_j == s`` (0 elsewhere) with the ``(J, P)`` leaf, in full fp32
    (``full_fp32``): no atomics, so the card adds in one fixed order
    and a rerun gives the same bits (``index_add_`` would add in any
    order). Folding the partials over their leading axis is
    ``weighted_average`` up to float re-association."""
    seg = torch.arange(num_segments, device=p.device)
    weights = torch.where(ids[None, :] == seg[:, None], p[None, :], 0.0)
    J = p.shape[0]
    with full_fp32():
        return {k: (weights @ w.reshape(J, -1)).reshape(
                    (num_segments,) + tuple(w.shape[1:]))
                for k, w in stacked_params.items()}


def fednova_effective_weights(sizes: torch.Tensor, p: torch.Tensor,
                              epochs: int, batch_size: int,
                              tau_frac: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """FedNova normalized-averaging weights (reference ``tools.py:388-405``,
    the JAX package's ``fedcore/aggregate.py:66-92``).

    ``tau_j = n_j * epochs / batch_size`` (float, the reference's exact
    expression, not the true step count), ``tau_eff = sum_j tau_j p_j``;
    the effective weight is ``p_j tau_eff / tau_j``. ``tau_frac`` (a
    ``(J,)`` fraction of the local work each client completed) rescales
    each tau; ``None`` is full work. Padded clients (``tau = 0``) get
    weight 0 instead of 0/0.
    """
    tau = sizes.to(torch.float32) * epochs / batch_size
    if tau_frac is not None:
        tau = tau * tau_frac
    tau_eff = torch.sum(tau * p)
    safe_tau = torch.where(tau > 0, tau, 1.0)
    return torch.where(tau > 0, p * tau_eff / safe_tau, 0.0)


def participation_weights(agg_w: torch.Tensor, part: torch.Tensor,
                          trust: torch.Tensor | None = None) -> torch.Tensor:
    """Aggregation weights restricted to a participation mask (the JAX
    package's ``aggregate.py:95-123``): the weights of absent clients are
    zeroed and the rest rescaled to carry the full mass ``sum(agg_w)``.
    ``trust`` (a per-client ``[0, 1]`` reputation) scales each survivor's
    weight before the rescale, so only relative trust moves mass; None
    keeps the weights without it. An all-absent round returns all zeros
    (callers keep the old global weights then)."""
    masked = agg_w * part
    if trust is not None:
        masked = masked * trust
    total = torch.sum(masked)
    scale = torch.where(total > 0,
                        torch.sum(agg_w) / torch.clamp(total, min=1e-30), 0.0)
    return masked * scale


def client_logits(apply_fn: Callable, stacked_params: dict,
                  X: torch.Tensor, row_floats: int | None = None
                  ) -> torch.Tensor:
    """Per-client predictions on a shared matrix, ``(n, J, C)`` (JAX
    ``aggregate.py:125-132``).

    For the linear model (one stacked ``(J, C, D)`` leaf) ``apply_fn``
    broadcasts over the stacked client axis, so this is one batched
    product — the reference's ``matmul(W.permute(2,0,1), data.T)``
    (``tools.py:448``) for the whole validation set at once; a 2-byte
    ``X`` (``feature_dtype``) is widened to float32 chunk by chunk inside
    ``apply_fn``.

    Any other model is mapped over all J clients at once
    (``torch.func.vmap``, as the JAX package's ``jax.vmap``) in full fp32
    (``full_fp32``), in row blocks: ``row_floats`` is what one row's
    forward keeps for one client, its hidden activations and logits
    (the model's ``row_activations(d, C)``), and a block takes as many
    rows as keep ``J * row_floats`` floats a row under
    ``route.EPOCH_GATHER_BYTES_LIMIT`` (the forward's temporaries, a
    padded copy or a bias sum, come on top). The result is the same
    whatever the blocks.
    """
    J = next(iter(stacked_params.values())).shape[0]
    if route.kernel_route({k: v[0] for k, v in stacked_params.items()}):
        preds = apply_fn(stacked_params, X)          # (J, n, C)
        return preds.permute(1, 0, 2).contiguous()
    if row_floats is None:
        raise ValueError("client_logits of a model other than the linear "
                         "one needs row_floats (Model.row_activations) to "
                         "bound its row blocks")
    n = X.shape[0]
    rows = max(1, route.EPOCH_GATHER_BYTES_LIMIT // (4 * J * row_floats))
    fwd = torch.func.vmap(apply_fn, in_dims=(0, None))
    out = None
    with torch.no_grad(), full_fp32():
        for r0 in range(0, n, rows):
            part = fwd(stacked_params, X[r0:r0 + rows]).permute(1, 0, 2)
            if out is None:
                out = part.new_empty((n,) + tuple(part.shape[1:]))
            out[r0:r0 + rows] = part
    return out


def resolve_p_guard(p_guard: str = "none") -> str:
    """Validate the opt-in mixture-weight guard: ``"none"`` (the
    reference's unconstrained p), ``"simplex"`` (Euclidean projection
    onto the probability simplex after every p step) or ``"clip"`` /
    ``"clip:R"`` (rescale p to L2 norm <= R, default 1, when above it).
    Raises ``ValueError`` for anything else, with the JAX package's
    messages (``aggregate.py:176-216``)."""
    if p_guard.startswith("clip:"):
        try:
            radius = float(p_guard.split(":", 1)[1])
        except ValueError:
            radius = -1.0
        if not (radius > 0) or math.isinf(radius):
            raise ValueError(
                f"p_guard={p_guard!r}: the clip radius must be a positive "
                "finite number, e.g. 'clip:2.5'")
    elif p_guard not in ("none", "simplex", "clip"):
        raise ValueError(
            f"p_guard={p_guard!r}; expected 'none', 'simplex', 'clip' "
            "or 'clip:R'")
    return p_guard


def project_simplex(v: torch.Tensor, valid=None) -> torch.Tensor:
    """Euclidean projection of ``v (J,)`` onto the probability simplex
    (sort-based). With a 0/1 ``valid`` mask it runs over the valid
    entries only: invalid ones project to exactly 0 and the valid ones
    sum to 1 (``aggregate.py:219-241`` of the JAX package)."""
    J = v.shape[0]
    if valid is None:
        valid = torch.ones_like(v)
    u = torch.sort(torch.where(valid > 0, v, -math.inf),
                   descending=True).values
    finite = torch.isfinite(u)
    css = torch.cumsum(torch.where(finite, u, 0.0), 0)
    k = torch.arange(1, J + 1, dtype=v.dtype, device=v.device)
    rho = torch.sum((u + (1.0 - css) / k > 0) & finite)
    # a gather, not css[rho - 1]: a 0-d tensor index reads it on the host
    last = torch.gather(css, 0, torch.clamp(rho - 1, min=0).reshape(1))[0]
    theta = (last - 1.0) / torch.clamp(rho.to(v.dtype), min=1.0)
    return torch.where(valid > 0, torch.clamp(v - theta, min=0.0), 0.0)


def project_simplex_fixed_point(v: torch.Tensor, valid=None) -> torch.Tensor:
    """``project_simplex`` by Michelot's fixed point, the algorithm of the
    kernels' guard epilogue (``csrc/p_epoch.cu:apply_guard``), kept beside
    the sort-based one to hold the kernels' arithmetic: ``theta`` from
    every valid entry, then ``theta = (sum of the support - 1) /
    |support|`` with ``support = {valid j : v_j > theta}`` until its size
    stops changing, and ``max(v - theta, 0)`` on the valid entries. The
    final ``theta`` is the sort-based formula over the same support. The
    support's size is read on the host every round."""
    if valid is None:
        valid = torch.ones_like(v)
    ok = valid > 0
    m = torch.sum(ok.to(v.dtype))
    if float(m) == 0:
        return torch.zeros_like(v)
    theta = (torch.sum(torch.where(ok, v, 0.0)) - 1.0) / m
    prev, rounds = float(m), 0
    while rounds <= v.shape[0]:
        sup = ok & (v > theta)
        c = torch.sum(sup.to(v.dtype))
        rounds += 1
        if float(c) in (prev, 0.0):
            break
        theta = (torch.sum(torch.where(sup, v, 0.0)) - 1.0) / c
        prev = float(c)
    return torch.where(ok, torch.clamp(v - theta, min=0.0), 0.0)


@dataclasses.dataclass(frozen=True)
class PGuard:
    """A p-guard, ``guard(p, valid) -> p``, applied after every p step
    (projected SGD): ``kind`` ``"clip"`` (rescale p to L2 norm ``radius``
    when above it, the norm over every client) or ``"simplex"``
    (``project_simplex`` over the valid clients). The kernels run the
    same guard in their epilogue (``psolver_kernel.guard_code``)."""

    kind: str
    radius: float = 1.0

    def __call__(self, p, valid=None):
        if self.kind == "simplex":
            return project_simplex(p, valid)
        norm = torch.sqrt(torch.sum(torch.square(p)))
        return p * torch.clamp(self.radius / torch.clamp(norm, min=1e-30),
                               max=1.0)


def make_guard(p_guard: str) -> PGuard | None:
    """None for ``"none"``; else the ``PGuard`` of ``p_guard``."""
    p_guard = resolve_p_guard(p_guard)
    if p_guard == "none":
        return None
    if p_guard == "simplex":
        return PGuard("simplex")
    return PGuard("clip", float(p_guard.split(":", 1)[1])
                  if ":" in p_guard else 1.0)


def make_p_solver(
    task: str,
    n_val: int,
    batch_size: int = 16,
    lr_p: float = 1e-3,
    momentum: float = 0.0,
    p_guard: str = "none",
    kernel_impl: str = "auto",
):
    """Build the mixture-weight SGD solver.

    Returns ``(solve, init_opt_state)`` where ``solve(logits (n_val, J,
    C), y_val (n_val,), p (J,), opt_state, positions (num_epochs, S, B),
    client_valid=None) -> (p, opt_state, last_epoch_loss,
    last_epoch_acc)`` runs one shuffled pass over the pooled validation
    set per leading entry of ``positions`` (``batching.epoch_batches``
    with no mask; reference ``DataLoader(16, shuffle=True)``,
    ``exp.py:99``), stepping ``p`` per batch with SGD(momentum) —
    ``buf = m*buf + g; p -= lr*buf``, torch- and optax-identical.

    ``opt_state`` is ``{"trace": buf (J,)}`` with momentum, ``{}``
    without (plain SGD carries nothing between calls). ``client_valid``
    (a ``(J,)`` 0/1 mask) zeroes the gradient, and so the momentum, of
    invalid clients every step.

    ``p_guard`` (``resolve_p_guard``) projects p after every step, with
    ``client_valid`` as the simplex's mask: in the kernel's epilogue on
    the card, in the plain p-epoch on CPU tensors or with
    ``kernel_impl="plain"``. ``kernel_impl`` as in
    ``client.make_client_round``.
    """
    guard = make_guard(p_guard)
    epoch_fn = cuda_build.kernel_or_plain(kernel_impl, p_epoch, p_epoch_plain)
    S, _ = batch_counts(n_val, batch_size)

    def init_opt_state(p):
        return {"trace": torch.zeros_like(p)} if momentum > 0 else {}

    def solve(logits, y_val, p, opt_state, positions, client_valid=None):
        J = logits.shape[1]
        if positions.dim() != 3 or tuple(positions.shape[1:]) != (S, batch_size):
            raise ValueError(f"positions must be (num_epochs, {S}, "
                             f"{batch_size}), got {tuple(positions.shape)}")
        cv = (torch.ones(J, dtype=torch.float32, device=p.device)
              if client_valid is None
              else client_valid.to(torch.float32).contiguous())
        buf = (opt_state["trace"] if momentum > 0
               else torch.zeros(J, dtype=torch.float32, device=p.device))
        valid = batch_valid(positions, n_val)
        positions = positions.to(torch.int32)
        # the class-tiled split kernel's layout of the logits, once for
        # every epoch of the solve
        split = (psolver_kernel.prepare_logits(logits, batch_size)
                 if kernel_impl == "auto" else None)
        extra = {} if split is None else {"split_logits": split}
        met = None
        for e in range(positions.shape[0]):
            p, buf, met = epoch_fn(p.contiguous(), buf.contiguous(), cv,
                                   logits, y_val,
                                   positions[e].contiguous(),
                                   valid[e].contiguous(), lr_p, momentum,
                                   task, guard=guard, **extra)
        state = {"trace": buf} if momentum > 0 else {}
        return (p, state) + weighted_epoch_metrics(met[0], met[1], met[2])

    return solve, init_opt_state
