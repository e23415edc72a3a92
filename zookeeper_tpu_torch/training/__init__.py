"""Training: state, schedules, optimizers, steps, the experiment loop,
distillation, checkpoint and resume, and the model-only export."""

from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN
from zookeeper_tpu_torch.training.async_checkpoint import AsyncCheckpointWriter
from zookeeper_tpu_torch.training.checkpoint import (
    Checkpointer,
    CheckpointUnreadableError,
    finalized_steps,
    load_exported_model,
    load_inference_model,
    load_model,
    save_model,
    select_inference_weights,
)
from zookeeper_tpu_torch.training.distill import DistillationExperiment
from zookeeper_tpu_torch.training.experiment import (
    EvalExperiment,
    Experiment,
    TrainingExperiment,
)
from zookeeper_tpu_torch.training.optimizer import (
    Adam,
    AdamW,
    Bop,
    Lamb,
    Lars,
    Momentum,
    Optimizer,
    Rmsprop,
    Sgd,
    scale_by_bop,
)
from zookeeper_tpu_torch.training.schedule import (
    ConstantSchedule,
    CosineDecay,
    LinearWarmup,
    PolynomialDecay,
    Schedule,
    StepDecay,
    WarmupCosine,
)
from zookeeper_tpu_torch.training.state import TrainState
from zookeeper_tpu_torch.training.step import (
    accuracy,
    host_snapshot,
    kd_divergence,
    make_eval_step,
    make_train_step,
    smoothed_softmax_cross_entropy,
    softmax_cross_entropy,
    top_k_accuracy,
)

__all__ = [
    "Adam",
    "AdamW",
    "AsyncCheckpointWriter",
    "BINARY_KERNEL_PATTERN",
    "Bop",
    "CheckpointUnreadableError",
    "Checkpointer",
    "ConstantSchedule",
    "CosineDecay",
    "DistillationExperiment",
    "EvalExperiment",
    "Experiment",
    "Lamb",
    "Lars",
    "LinearWarmup",
    "Momentum",
    "Optimizer",
    "PolynomialDecay",
    "Rmsprop",
    "Schedule",
    "Sgd",
    "StepDecay",
    "TrainState",
    "TrainingExperiment",
    "WarmupCosine",
    "accuracy",
    "finalized_steps",
    "host_snapshot",
    "kd_divergence",
    "load_exported_model",
    "load_inference_model",
    "load_model",
    "make_eval_step",
    "make_train_step",
    "save_model",
    "scale_by_bop",
    "select_inference_weights",
    "smoothed_softmax_cross_entropy",
    "softmax_cross_entropy",
    "top_k_accuracy",
]
