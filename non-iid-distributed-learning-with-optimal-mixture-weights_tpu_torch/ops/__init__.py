from .losses import (
    ce_per_example,
    data_loss,
    l2_norm_safe,
    masked_mean,
    mse_per_example,
    prox_penalty,
    ridge_penalty,
    training_loss,
)
from .metrics import top1_correct
from .rff import rff_map, rff_params
from .schedule import lr_schedule_array

__all__ = [
    "ce_per_example",
    "data_loss",
    "l2_norm_safe",
    "masked_mean",
    "mse_per_example",
    "prox_penalty",
    "ridge_penalty",
    "training_loss",
    "top1_correct",
    "rff_map",
    "rff_params",
    "lr_schedule_array",
]
