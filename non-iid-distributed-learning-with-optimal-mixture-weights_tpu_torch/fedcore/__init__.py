from .aggregate import (
    client_logits,
    fednova_effective_weights,
    make_guard,
    make_p_solver,
    participation_weights,
    project_simplex,
    project_simplex_fixed_point,
    resolve_p_guard,
    weighted_average,
)
from .client import make_bucketed_round, make_client_round, make_local_update
from .epoch_kernel import client_epoch, client_epoch_plain
from .evaluate import make_evaluator
from .faults import FaultPlan, FaultSpec, inject_fault_row, resolve_fault_plan
from .psolver_kernel import p_epoch, p_epoch_plain
from .robust import (
    RobustSpec,
    clip_update_norms,
    coordinatewise_median,
    coordinatewise_trimmed_mean,
    geometric_median,
    krum_aggregate,
    krum_select,
    make_robust_aggregator,
    parse_robust_spec,
    sanitize_updates,
    zscore_quarantine,
)
from .server_opt import SERVER_OPTS, ServerOptimizer

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "RobustSpec",
    "SERVER_OPTS",
    "ServerOptimizer",
    "client_epoch",
    "client_epoch_plain",
    "client_logits",
    "clip_update_norms",
    "coordinatewise_median",
    "coordinatewise_trimmed_mean",
    "fednova_effective_weights",
    "geometric_median",
    "inject_fault_row",
    "krum_aggregate",
    "krum_select",
    "make_bucketed_round",
    "make_client_round",
    "make_evaluator",
    "make_guard",
    "make_local_update",
    "make_p_solver",
    "make_robust_aggregator",
    "p_epoch",
    "p_epoch_plain",
    "parse_robust_spec",
    "participation_weights",
    "project_simplex",
    "project_simplex_fixed_point",
    "resolve_fault_plan",
    "resolve_p_guard",
    "sanitize_updates",
    "weighted_average",
    "zscore_quarantine",
]
