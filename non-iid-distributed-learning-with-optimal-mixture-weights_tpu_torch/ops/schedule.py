"""Learning-rate schedules.

The reference's ``update_learning_rate`` (``functions/tools.py:43-61``)
is reassigned every round — ``lr = update_learning_rate(t, lr, T)`` —
so its two decays COMPOUND: the effective schedule is x1 until T/2,
x0.1 until 0.75T, then x0.001 (not x0.01 as its comment implies); see
SURVEY.md §2.3. ``mode='reference'`` reproduces that recurrence exactly
(including the T/2 == 0.75T edge where the first branch short-circuits);
``mode='paper'`` gives the presumably-intended x0.1 / x0.01 steps.
"""

from __future__ import annotations

import numpy as np


def lr_schedule_array(
    base_lr: float, total_rounds: int, mode: str = "reference"
) -> np.ndarray:
    """Per-round learning rates, shape ``(total_rounds,)`` float32.

    Precomputed on the host; round ``t`` reads entry ``t``.
    """
    half = int(total_rounds / 2)
    three_q = int(total_rounds * 0.75)
    out = np.empty(total_rounds, dtype=np.float32)
    if mode == "reference":
        lr = base_lr
        for t in range(total_rounds):
            if t == half:
                lr = lr / 10
            elif t == three_q:
                lr = lr / 100
            out[t] = lr
    elif mode == "paper":
        for t in range(total_rounds):
            if t >= three_q and three_q > half:
                out[t] = base_lr / 100
            elif t >= half:
                out[t] = base_lr / 10
            else:
                out[t] = base_lr
    elif mode == "constant":
        out[:] = base_lr
    else:
        raise ValueError(f"unknown lr schedule mode: {mode}")
    return out


def update_learning_rate(epoch: int, target_lr: float, T: int) -> float:
    """The reference's one-step update (``tools.py:43-61``; the JAX
    package's ``ops/schedule.py:51-57``): a tenth at ``int(T/2)``, a
    hundredth at ``int(0.75 T)``, else ``target_lr``; reassigning it every
    round compounds the decays (``lr_schedule_array``'s ``"reference"``
    mode)."""
    if epoch == int(T / 2):
        return target_lr / 10
    if epoch == int(T * 0.75):
        return target_lr / 100
    return target_lr
