"""Classifier serving: bucketed engine, micro-batcher, metrics, config,
and the checkpoint watcher. LM decode serving lives in
``zookeeper_tpu_torch.serving.decode``, disaggregated prefill/decode in
``zookeeper_tpu_torch.serving.disagg`` (exported here too)."""

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
from zookeeper_tpu_torch.serving.disagg import (  # noqa: I001  (after the base modules)
    DisaggPartitioner,
    DisaggScheduler,
    DisaggServingConfig,
    PageTransfer,
    PageTransferError,
)

__all__ = [
    "CheckpointWatcher",
    "DeadlineExpiredError",
    "DisaggPartitioner",
    "DisaggScheduler",
    "DisaggServingConfig",
    "InferenceEngine",
    "MicroBatcher",
    "PageTransfer",
    "PageTransferError",
    "PendingResult",
    "RejectedError",
    "ServingConfig",
    "ServingMetrics",
    "WorkerCrashedError",
]
