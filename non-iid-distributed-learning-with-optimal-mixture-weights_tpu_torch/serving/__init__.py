"""Inference serving over trained checkpoints, on the card.

The port of the JAX package's ``serving/`` package: ``engine``
(checkpoint -> one predictor, the RFF map fused with the model head,
padded to a rung ladder, mesh-replicable, with a versioned weight store
for hot swaps and atomic rung install/retire), ``batcher``
(continuous-batching admission plus the fixed-micro-batch drain),
``service`` (a stdlib thread+queue request loop with deadlines, overload
shedding, deadline-ordered dispatch under pressure and rollout-aware
traffic splitting), ``control`` (burn-rate class-aware admission control
and a hysteresis autoscaler), ``metrics`` (latency percentiles,
throughput, shed counters, model-version and staleness dimensions),
``registry`` (the versioned model store of the train->serve loop, and a
checkpoint-watching publisher thread) and ``rollout`` (the shadow/A-B
canary controller with a parity gate, an error budget and automatic
rollback). Every module but ``engine`` is a copy of the JAX package's,
stdlib and numpy only; ``engine`` is PyTorch.

Not carried yet (ROADMAP.md queue 1 item 11): ``ladder``, ``replica``,
``chaos``, ``transport`` and ``artifacts``.
"""

from .batcher import (MicroBatcher, admit, coalesce, drain, edf_order,
                      partition, rung_cut, split_results)
from .control import (DEFAULT_SHED_ORDER, AdmissionController,
                      AdmissionShed, Autoscaler, admission_shed_rate)
from .engine import DEFAULT_BUCKETS, ServingEngine, bucket_for, infer_model
from .metrics import LatencyHistogram, ServeMetrics
from .registry import CheckpointWatcher, ModelRegistry, ModelVersion
from .rollout import RolloutController, assigned_to_candidate, split_key
from .service import (DeadlineExceeded, Overloaded, ServiceStopped,
                      ServingService)

__all__ = [
    "AdmissionController",
    "AdmissionShed",
    "Autoscaler",
    "CheckpointWatcher",
    "DEFAULT_BUCKETS",
    "DEFAULT_SHED_ORDER",
    "DeadlineExceeded",
    "LatencyHistogram",
    "MicroBatcher",
    "ModelRegistry",
    "ModelVersion",
    "Overloaded",
    "RolloutController",
    "ServeMetrics",
    "ServiceStopped",
    "ServingEngine",
    "ServingService",
    "admission_shed_rate",
    "admit",
    "assigned_to_candidate",
    "bucket_for",
    "coalesce",
    "drain",
    "edf_order",
    "infer_model",
    "partition",
    "rung_cut",
    "split_key",
    "split_results",
]
