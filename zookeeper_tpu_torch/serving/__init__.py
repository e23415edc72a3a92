"""Classifier serving: bucketed engine, micro-batcher, metrics, config,
and the checkpoint watcher. LM decode serving lives in
``zookeeper_tpu_torch.serving.decode``, disaggregated prefill/decode in
``zookeeper_tpu_torch.serving.disagg``, the overload guard, brown-out and
circuit breaker in ``serving.guardrails`` and the fleet router in
``serving.fleet`` (all exported here too: every name of the JAX
package's ``zookeeper_tpu.serving``)."""

from zookeeper_tpu_torch.serving.batcher import (
    DeadlineExpiredError,
    MicroBatcher,
    PendingResult,
    RejectedError,
    WorkerCrashedError,
)
from zookeeper_tpu_torch.serving.engine import CheckpointWatcher, InferenceEngine
from zookeeper_tpu_torch.serving.metrics import ServingMetrics
from zookeeper_tpu_torch.serving.service import ServingConfig
from zookeeper_tpu_torch.serving.guardrails import (  # noqa: I001  (after the base modules)
    BrownOut,
    CircuitBreaker,
    OverloadGuard,
    PredictedMissError,
)
from zookeeper_tpu_torch.serving.decode import (
    DecodeEngine,
    DecodeMetrics,
    DecodeScheduler,
    DecodeStream,
    LMServingConfig,
    SpeculativeDecoding,
)
from zookeeper_tpu_torch.serving.disagg import (
    DisaggPartitioner,
    DisaggScheduler,
    DisaggServingConfig,
    PageTransfer,
    PageTransferError,
)
from zookeeper_tpu_torch.serving.fleet import (
    FleetMetrics,
    FleetResponse,
    FleetRouter,
    FleetUnavailableError,
    ReplicaHandle,
)

__all__ = [
    "BrownOut",
    "CheckpointWatcher",
    "CircuitBreaker",
    "DeadlineExpiredError",
    "DecodeEngine",
    "DecodeMetrics",
    "DecodeScheduler",
    "DecodeStream",
    "DisaggPartitioner",
    "DisaggScheduler",
    "DisaggServingConfig",
    "FleetMetrics",
    "FleetResponse",
    "FleetRouter",
    "FleetUnavailableError",
    "InferenceEngine",
    "LMServingConfig",
    "MicroBatcher",
    "OverloadGuard",
    "PageTransfer",
    "PageTransferError",
    "PendingResult",
    "PredictedMissError",
    "RejectedError",
    "ReplicaHandle",
    "ServingConfig",
    "ServingMetrics",
    "SpeculativeDecoding",
    "WorkerCrashedError",
]
