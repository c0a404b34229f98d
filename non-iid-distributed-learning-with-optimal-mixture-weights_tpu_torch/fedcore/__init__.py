from .aggregate import client_logits, make_p_solver, weighted_average
from .client import make_client_round, make_local_update
from .epoch_kernel import client_epoch, client_epoch_plain
from .evaluate import make_evaluator
from .psolver_kernel import p_epoch, p_epoch_plain

__all__ = [
    "client_epoch",
    "client_epoch_plain",
    "client_logits",
    "make_client_round",
    "make_evaluator",
    "make_local_update",
    "make_p_solver",
    "p_epoch",
    "p_epoch_plain",
    "weighted_average",
]
