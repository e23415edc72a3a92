"""Training: state, schedules, optimizers, steps and the experiment loop."""

from zookeeper_tpu_torch.training.experiment import Experiment, TrainingExperiment
from zookeeper_tpu_torch.training.optimizer import Adam, AdamW, Optimizer
from zookeeper_tpu_torch.training.schedule import (
    ConstantSchedule,
    CosineDecay,
    Schedule,
    WarmupCosine,
)
from zookeeper_tpu_torch.training.state import TrainState
from zookeeper_tpu_torch.training.step import (
    accuracy,
    make_eval_step,
    make_train_step,
    smoothed_softmax_cross_entropy,
    softmax_cross_entropy,
    top_k_accuracy,
)

__all__ = [
    "Adam",
    "AdamW",
    "ConstantSchedule",
    "CosineDecay",
    "Experiment",
    "Optimizer",
    "Schedule",
    "TrainState",
    "TrainingExperiment",
    "WarmupCosine",
    "accuracy",
    "make_eval_step",
    "make_train_step",
    "smoothed_softmax_cross_entropy",
    "softmax_cross_entropy",
    "top_k_accuracy",
]
