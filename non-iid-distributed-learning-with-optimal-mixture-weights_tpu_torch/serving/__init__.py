"""Inference serving over trained checkpoints, on the card.

The port of the JAX package's ``serving/`` package, every module and
every public name: ``engine`` (checkpoint -> one predictor, the RFF map
fused with the model head, padded to a rung ladder, mesh-replicable,
with a versioned weight store for hot swaps and atomic rung
install/retire), ``batcher`` (continuous-batching admission plus the
fixed-micro-batch drain), ``ladder`` (rung sets learned from the
telemetry registry's request-size series under explicit pad-waste and
recompile budgets), ``service`` (a stdlib thread+queue request loop
with deadlines, overload shedding, deadline-ordered dispatch under
pressure and rollout-aware traffic splitting), ``control`` (burn-rate
class-aware admission control and a hysteresis autoscaler),
``metrics`` (latency percentiles, throughput, shed counters,
model-version and staleness dimensions), ``registry`` (the versioned
model store of the train->serve loop, and a checkpoint-watching
publisher thread), ``rollout`` (the shadow/A-B canary controller with a
parity gate, an error budget and automatic rollback),
``replica``/``chaos`` (N replicas over one engine behind a
health-gating failover router with dead-replica requeue and hedged
dispatch, under seeded deterministic chaos), ``artifacts`` (the
cold-start plane: each rung exported as a ``torch.export`` program
behind a typed artifact/host compatibility contract) and ``transport``
(the process-boundary seam: the in-process path and a stdlib-TCP frame
protocol with ``PodWorker`` processes and the ``PodClientEngine``
facade, under the seeded ``NetChaosSpec`` network fault grammar).
``engine`` and ``artifacts`` are PyTorch; every other module is a copy
of the JAX package's, stdlib and numpy only.
"""

from .artifacts import (ArtifactIncompatible, ArtifactManifest,
                        export_ladder, load_ladder, prune_artifacts)
from .batcher import (MicroBatcher, admit, coalesce, drain, edf_order,
                      partition, rung_cut, split_results)
from .chaos import (ChaosFault, ChaosPlan, ChaosSpec, LoadSpec,
                    NetChaosPlan, NetChaosSpec, resolve_chaos_plan,
                    resolve_net_chaos)
from .control import (DEFAULT_SHED_ORDER, AdmissionController,
                      AdmissionShed, Autoscaler, admission_shed_rate)
from .engine import DEFAULT_BUCKETS, ServingEngine, bucket_for, infer_model
from .ladder import (LadderLearner, LadderProposal, apply_proposal,
                     ladder_waste, learn_ladder)
from .metrics import LatencyHistogram, ServeMetrics
from .registry import CheckpointWatcher, ModelRegistry, ModelVersion
from .replica import (FailoverRouter, NoReplicasAvailable, Replica,
                      ReplicaDead, ReplicaSet, ReplicaUnavailable)
from .rollout import RolloutController, assigned_to_candidate, split_key
from .service import (DeadlineExceeded, Overloaded, ServiceStopped,
                      ServingService)
from .transport import (DispatchTransport, FrameError,
                        InProcessTransport, PodClientEngine, PodWorker,
                        SocketTransport, SyncTimeout, TransportError,
                        TransportRefused, TransportTimeout,
                        pack_weights, unpack_weights,
                        weights_fingerprint, worker_main)

__all__ = [
    "AdmissionController",
    "AdmissionShed",
    "ArtifactIncompatible",
    "ArtifactManifest",
    "Autoscaler",
    "ChaosFault",
    "ChaosPlan",
    "ChaosSpec",
    "CheckpointWatcher",
    "DEFAULT_BUCKETS",
    "DEFAULT_SHED_ORDER",
    "DeadlineExceeded",
    "DispatchTransport",
    "FailoverRouter",
    "FrameError",
    "InProcessTransport",
    "LadderLearner",
    "LadderProposal",
    "LatencyHistogram",
    "LoadSpec",
    "MicroBatcher",
    "ModelRegistry",
    "ModelVersion",
    "NetChaosPlan",
    "NetChaosSpec",
    "NoReplicasAvailable",
    "Overloaded",
    "PodClientEngine",
    "PodWorker",
    "Replica",
    "ReplicaDead",
    "ReplicaSet",
    "ReplicaUnavailable",
    "RolloutController",
    "ServeMetrics",
    "ServiceStopped",
    "ServingEngine",
    "ServingService",
    "SocketTransport",
    "SyncTimeout",
    "TransportError",
    "TransportRefused",
    "TransportTimeout",
    "admission_shed_rate",
    "admit",
    "apply_proposal",
    "assigned_to_candidate",
    "bucket_for",
    "coalesce",
    "drain",
    "edf_order",
    "export_ladder",
    "infer_model",
    "ladder_waste",
    "learn_ladder",
    "load_ladder",
    "pack_weights",
    "partition",
    "prune_artifacts",
    "resolve_chaos_plan",
    "resolve_net_chaos",
    "rung_cut",
    "split_key",
    "split_results",
    "unpack_weights",
    "weights_fingerprint",
    "worker_main",
]
