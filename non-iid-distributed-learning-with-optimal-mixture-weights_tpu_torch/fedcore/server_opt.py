"""Server optimizers on the round's pseudo-gradient (FedOpt).

The JAX package's round loop (``algorithms/core.py:570-596``) can replace
the reference's "the aggregate is the new global model" rule by one
optimizer step on the pseudo-gradient ``g = w_t - aggregate_t`` (Reddi
et al. 2021), with optax's ``sgd``, ``adam``/``yogi`` (``b1=0.9,
b2=0.99, eps=1e-3``, the FedOpt paper's defaults) or ``adagrad``. The
card has no optax, so the rules are written here in torch with optax's
semantics: the moment updates ``(1 - b) * g + b * m``, the bias
correction ``m / (1 - b**count)`` with ``count`` an int32 counter
incremented before it is used, ``eps`` outside the square root, yogi's
and adagrad's accumulators starting at optax's values (1e-6 and 0.1),
adagrad's ``rsqrt(sum_sq + 1e-7)`` (0 where the sum is 0), and the step
``w + (-lr) * update``.

The state is a tuple of tensors in the order of ``jax.tree.leaves`` of
the optax state, so a checkpoint moves between the two packages:
``()`` for sgd, ``(count, mu, nu)`` for adam and yogi, ``(sum_sq,)``
for adagrad, one tensor per parameter leaf (sorted by key) for each
moment.
"""

from __future__ import annotations

import torch

SERVER_OPTS = ("none", "sgd", "adam", "yogi", "adagrad")
B1, B2, EPS = 0.9, 0.99, 1e-3          # adam and yogi (core.py:579-586)
YOGI_INIT = 1e-6                       # optax.scale_by_yogi's accumulators
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7  # optax.adagrad's defaults


def check_server_opt(kind: str) -> None:
    if kind not in SERVER_OPTS:
        raise ValueError(f"server_opt must be none|sgd|adam|yogi|adagrad, "
                         f"got {kind!r}")


class ServerOptimizer:
    """``init(params) -> state`` and ``step(params, aggregate, state) ->
    (params, state)`` for one of ``SERVER_OPTS`` other than ``"none"``.
    ``params`` and ``aggregate`` are ``{name: tensor}`` dicts."""

    def __init__(self, kind: str, lr: float):
        check_server_opt(kind)
        if kind == "none":
            raise ValueError("server_opt='none' has no optimizer")
        self.kind, self.lr = kind, float(lr)

    def init(self, params: dict) -> tuple:
        leaves = [params[k] for k in sorted(params)]
        if self.kind == "sgd":
            return ()
        if self.kind == "adagrad":
            return tuple(torch.full_like(w, ADAGRAD_INIT) for w in leaves)
        fill = 0.0 if self.kind == "adam" else YOGI_INIT
        count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        # (count, mu..., nu...): both moments start at ``fill``
        return (count,) + tuple(torch.full_like(w, fill)
                                for w in leaves + leaves)

    def step(self, params: dict, aggregate: dict, state: tuple):
        keys = sorted(params)
        n = len(keys)
        grads = [params[k] - aggregate[k] for k in keys]
        if self.kind == "sgd":
            updates, state = grads, ()
        elif self.kind == "adagrad":
            sos = [torch.square(g) + s for g, s in zip(grads, state)]
            updates = [torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS), 0.0)
                       * g for g, s in zip(grads, sos)]
            state = tuple(sos)
        else:
            count, mu, nu = state[0], state[1:1 + n], state[1 + n:]
            mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, mu)]
            if self.kind == "adam":
                nu = [(1 - B2) * torch.square(g) + B2 * v
                      for g, v in zip(grads, nu)]
            else:
                nu = [v - (1 - B2) * torch.sign(v - torch.square(g))
                      * torch.square(g) for g, v in zip(grads, nu)]
            count = torch.where(count < torch.iinfo(torch.int32).max,
                                count + 1, count)
            c = count.to(torch.float32)
            bc1, bc2 = 1 - B1 ** c, 1 - B2 ** c
            updates = [(m / bc1) / (torch.sqrt(v / bc2) + EPS)
                       for m, v in zip(mu, nu)]
            state = (count,) + tuple(mu) + tuple(nu)
        new = {k: params[k] + updates[i] * (-self.lr)
               for i, k in enumerate(keys)}
        return new, state
