"""Classifier serving: bucketed engine, micro-batcher, metrics, config.
LM decode serving lives in ``zookeeper_tpu_torch.serving.decode``."""

from zookeeper_tpu_torch.serving.batcher import (
    DeadlineExpiredError,
    MicroBatcher,
    PendingResult,
    RejectedError,
    WorkerCrashedError,
)
from zookeeper_tpu_torch.serving.engine import InferenceEngine
from zookeeper_tpu_torch.serving.metrics import ServingMetrics
from zookeeper_tpu_torch.serving.service import ServingConfig

__all__ = [
    "DeadlineExpiredError",
    "InferenceEngine",
    "MicroBatcher",
    "PendingResult",
    "RejectedError",
    "ServingConfig",
    "ServingMetrics",
    "WorkerCrashedError",
]
