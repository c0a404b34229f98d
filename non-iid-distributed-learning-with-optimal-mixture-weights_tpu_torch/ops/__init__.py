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
from .metrics import (
    Meter,
    comp_accuracy,
    error_estimate,
    masked_accuracy,
    top1_correct,
)
from .rff import (
    data_heterogeneity,
    feature_mapping,
    heterogeneity_from_parts,
    rff_map,
    rff_params,
)
from .schedule import lr_schedule_array, update_learning_rate

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
    "masked_accuracy",
    "Meter",
    "comp_accuracy",
    "error_estimate",
    "data_heterogeneity",
    "feature_mapping",
    "heterogeneity_from_parts",
    "rff_map",
    "rff_params",
    "lr_schedule_array",
    "update_learning_rate",
]
