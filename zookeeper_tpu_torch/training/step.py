"""Train and eval step builders.

The port of ``zookeeper_tpu/training/step.py``: ``make_train_step``
returns ``(state, batch) -> (state, metrics)``, one eager forward and
backward of the module in train mode (batch-statistics BatchNorms that
update their running statistics in place) and one optimizer update.
Metrics stay 0-d tensors on the device, so the caller decides when to
pay the readback. The remat policies, the non-finite-loss policies,
distillation, EMA and the flip ratio are not ported yet (ROADMAP.md).
"""

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from zookeeper_tpu_torch.training.optimizer import global_norm
from zookeeper_tpu_torch.training.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in float32, over
    the last axis of ``logits`` and every leading position (an LM's
    ``[b, s, vocab]`` against ``[b, s]`` targets), as optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``."""
    logits = logits.to(torch.float32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.long().reshape(-1))


def smoothed_softmax_cross_entropy(smoothing: float):
    """Label-smoothed cross-entropy: targets ``(1 - smoothing)`` on the
    true class plus ``smoothing / num_classes`` everywhere (optax's
    ``smooth_labels``). ``smoothing=0`` is the plain integer-label loss."""
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(
            f"label smoothing {smoothing} outside [0, 1): 0 disables; "
            "1.0 would erase the labels entirely."
        )
    if smoothing == 0.0:
        return softmax_cross_entropy

    def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = logits.to(torch.float32)
        num_classes = logits.shape[-1]
        targets = F.one_hot(labels.long(), num_classes).to(torch.float32)
        targets = targets * (1.0 - smoothing) + smoothing / num_classes
        return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()

    return loss_fn


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels.long()).to(torch.float32).mean()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of examples whose true label is in the top-k logits."""
    top = torch.topk(logits.to(torch.float32), k, dim=-1).indices
    return (top == labels.long()[..., None]).any(dim=-1).to(torch.float32).mean()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; it is queued in ROADMAP.md."
    )


def make_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = softmax_cross_entropy,
    *,
    flip_ratio_pattern: Optional[str] = None,
    distill: Optional[Tuple] = None,
    ema_decay: Optional[float] = None,
    remat: str = "none",
    nan_policy: str = "ignore",
) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """Build the train step. It updates ``state`` in place (parameters,
    BatchNorm statistics, optimizer state, ``step``) and returns it with
    ``{"loss", "accuracy", "grad_norm"}``."""
    if remat != "none":
        raise _not_ported(f"remat={remat!r}")
    if nan_policy != "ignore":
        raise _not_ported(f"nan_policy={nan_policy!r}")
    if distill is not None:
        raise _not_ported("Distillation")
    if ema_decay is not None:
        raise _not_ported("The parameter EMA")
    if flip_ratio_pattern is not None:
        raise _not_ported("The flip-ratio metric")

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        module = state.module.train()
        params = state.params
        logits = module(batch["input"])
        loss = loss_fn(logits, batch["target"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grad_norm = global_norm(grads.values())
        state.apply_gradients(grads)
        metrics = {
            "loss": loss.detach(),
            "accuracy": accuracy(logits.detach(), batch["target"]),
            "grad_norm": grad_norm,
        }
        return state, metrics

    return train_step


def make_eval_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = softmax_cross_entropy,
    *,
    top5: bool = False,
) -> Callable[[TrainState, Batch], Metrics]:
    """Build the eval step: the module in eval mode (running statistics),
    no gradient. ``top5`` adds top-5 accuracy."""

    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        module = state.module.eval()
        with torch.no_grad():
            logits = module(batch["input"])
            metrics = {
                "loss": loss_fn(logits, batch["target"]),
                "accuracy": accuracy(logits, batch["target"]),
            }
            if top5:
                metrics["top5_accuracy"] = top_k_accuracy(logits, batch["target"], k=5)
        return metrics

    return eval_step
