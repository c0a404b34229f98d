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
from .psolver_kernel import p_epoch, p_epoch_plain
from .server_opt import SERVER_OPTS, ServerOptimizer

__all__ = [
    "SERVER_OPTS",
    "ServerOptimizer",
    "client_epoch",
    "client_epoch_plain",
    "client_logits",
    "fednova_effective_weights",
    "make_bucketed_round",
    "make_client_round",
    "make_evaluator",
    "make_guard",
    "make_local_update",
    "make_p_solver",
    "p_epoch",
    "p_epoch_plain",
    "participation_weights",
    "project_simplex",
    "project_simplex_fixed_point",
    "resolve_p_guard",
    "weighted_average",
]
