"""Train and eval step builders.

The port of ``zookeeper_tpu/training/step.py``: ``make_train_step``
returns ``(state, batch) -> (state, metrics)``, one eager forward and
backward of the module in train mode (batch-statistics BatchNorms that
update their running statistics in place) and one optimizer update.
Metrics stay 0-d tensors on the device, so the caller decides when to
pay the readback. The step's options are the JAX step's: distillation
from a frozen teacher, the parameter EMA, the flip ratio of the binary
kernels, a non-finite-loss policy (selected on the card, no readback)
and a rematerialization policy (``torch.utils.checkpoint``).
:func:`host_snapshot` is the async checkpointer's copy of the state.
"""

import contextlib
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from zookeeper_tpu_torch.ops.layers import remat_scope
from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.training.optimizer import (
    counts_to_device,
    global_norm,
    select_,
    state_tensors,
)
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


def kd_divergence(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Hinton's knowledge-distillation loss: ``T^2`` times KL(teacher ||
    student) over the temperature-softened distributions, in float32."""
    sl = student_logits.to(torch.float32) / temperature
    tl = teacher_logits.to(torch.float32) / temperature
    p_t = F.softmax(tl, dim=-1)
    kl = (p_t * (F.log_softmax(tl, dim=-1) - F.log_softmax(sl, dim=-1))).sum(-1)
    return (temperature**2) * kl.mean()


REMAT_POLICIES = ("none", "dots", "full", "quant")
NAN_POLICIES = ("ignore", "skip", "halt")

#: The matmuls with no batch dimension: what "dots" saves (JAX's
#: ``dots_with_no_batch_dims_saveable``; convolutions recompute).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_if(ops):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _apply_model(remat: str) -> Callable[[torch.nn.Module, torch.Tensor], torch.Tensor]:
    """``(module, x) -> module(x)`` under the remat policy: "none" keeps
    every activation; the others run the forward inside one
    ``torch.utils.checkpoint`` region, as JAX's ``jax.checkpoint`` wraps
    the whole apply, and recompute it for the backward, "full" saving
    nothing, "dots" the matmuls with no batch dimension, "quant" only the
    tagged quantized activations (``ops.layers.tag_quant_act``). The
    recompute leaves the BatchNorm statistics as one forward does."""
    if remat == "none":
        return lambda module, x: module(x)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    tag = remat == "quant"
    saved = {"dots": _DOTS,
             "quant": (torch.ops.zookeeper_tpu_torch.quant_act.default,)}.get(remat)

    def contexts():
        forward, recompute = remat_scope(tag=tag), remat_scope(tag=tag, recompute=True)
        if saved is None:
            return forward, recompute
        sac_forward, sac_recompute = create_selective_checkpoint_contexts(_save_if(saved))
        return _both(forward, sac_forward), _both(recompute, sac_recompute)

    return lambda module, x: checkpoint(module, x, use_reentrant=False, context_fn=contexts)


def _bn_statistics(module: torch.nn.Module):
    return [b for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


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
    BatchNorm statistics, optimizer state, EMA, ``step``) and returns it
    with ``{"loss", "accuracy", "grad_norm"}`` and, as the options add
    them, ``kd_loss``, ``flip_ratio`` and ``skipped_steps``.

    - ``distill``: ``(teacher_fn, alpha, temperature)``. ``teacher_fn(x)``
      runs under ``torch.no_grad()``; the loss becomes ``alpha * loss +
      (1 - alpha) * kd_divergence``.
    - ``ema_decay``: keep ``ema = d * ema + (1 - d) * params`` (the state
      must be created with ``ema=True``).
    - ``flip_ratio_pattern``: a regex over flax paths
      (``BINARY_KERNEL_PATTERN``); reports the share of the matched
      weights whose sign changed this step. A pattern that matches no
      parameter raises.
    - ``nan_policy``: "ignore"; "skip" keeps the pre-step parameters,
      optimizer state, EMA and BatchNorm statistics where the loss or the
      gradient norm is not finite, selected on the card, while
      ``state.step`` advances; "halt" does the same and the experiment
      raises at its next readback. Both report ``skipped_steps`` (0/1)
      and keep the optimizer's counts on the card.
    - ``remat``: "none", "dots", "full" or "quant" (see
      ``_apply_model``); every policy computes the same bits as "none".

    The active ``FaultPlan``'s ``nan_at_step`` is read here, once: the
    step whose counter (``state.step`` before it) equals it multiplies
    its loss by NaN, which poisons every gradient as a real blow-up does.
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy {remat!r}; choose none/dots/full/quant.")
    if nan_policy not in NAN_POLICIES:
        raise ValueError(f"Unknown nan_policy {nan_policy!r}; choose ignore/skip/halt.")
    flip_paths = re.compile(flip_ratio_pattern) if flip_ratio_pattern is not None else None
    apply_model = _apply_model(remat)
    guard = nan_policy != "ignore"
    plan = faults.active()
    nan_at_step = plan.nan_at_step if plan is not None else None

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        module = state.module.train()
        params = state.params
        names = list(params)
        if ema_decay is not None and state.ema_params is None:
            raise ValueError(
                "ema_decay is set but the TrainState has no ema_params; "
                "build it with TrainState.create(..., ema=True)."
            )
        flipped = []
        if flip_paths is not None:
            flipped = [n for n in names if flip_paths.search(state.flax_paths[n])]
            if not flipped:
                raise ValueError(
                    f"flip_ratio_pattern {flip_paths.pattern!r} matched no "
                    "parameter path. Is the model actually binarized "
                    "(Quant* layers), or is the pattern misspelled? "
                    f"Available paths: {sorted(state.flax_paths.values())[:8]}..."
                )
            old_signs = [torch.sign(params[n].detach()) for n in flipped]
        if guard:
            counts_to_device(state.opt_state, params[names[0]].device)
            kept = (list(params.values()) + state_tensors(state.opt_state)
                    + list((state.ema_params or {}).values()) + _bn_statistics(module))
            olds = [t.detach().clone() for t in kept]
        logits = apply_model(module, batch["input"])
        loss = loss_fn(logits, batch["target"])
        if nan_at_step is not None and state.step == nan_at_step:
            loss = loss * float("nan")
        kd = None
        if distill is not None:
            teacher_fn, alpha, temperature = distill
            with torch.no_grad():
                t_logits = teacher_fn(batch["input"])
            kd = kd_divergence(logits, t_logits, temperature)
            loss = alpha * loss + (1.0 - alpha) * kd
        grads = dict(zip(names, torch.autograd.grad(loss, list(params.values()))))
        grad_norm = global_norm(grads.values())
        state.apply_gradients(grads)
        with torch.no_grad():
            if ema_decay is not None:
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [params[n].detach() for n in names], 1.0 - ema_decay))
            if guard:
                ok = torch.isfinite(loss.detach()) & torch.isfinite(grad_norm)
                select_(ok, [t.detach() for t in kept], olds)
        metrics = {
            "loss": loss.detach(),
            "accuracy": accuracy(logits.detach(), batch["target"]),
            "grad_norm": grad_norm,
        }
        if guard:
            metrics["skipped_steps"] = (~ok).to(torch.float32)
        if kd is not None:
            metrics["kd_loss"] = kd.detach()
        if flip_paths is not None:
            flips = sum((torch.sign(params[n].detach()) != s).sum() for n, s in zip(flipped, old_signs))
            total = sum(params[n].numel() for n in flipped)
            metrics["flip_ratio"] = flips.to(torch.float32) / torch.tensor(
                float(total), dtype=torch.float32, device=flips.device)
        return state, metrics

    return train_step


def make_eval_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = softmax_cross_entropy,
    *,
    use_ema: bool = False,
    top5: bool = False,
) -> Callable[[TrainState, Batch], Metrics]:
    """Build the eval step: the module in eval mode (running statistics),
    no gradient. ``use_ema`` scores the EMA weights (the ones that ship)
    instead of the parameters; ``top5`` adds top-5 accuracy."""

    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        module = state.module.eval()
        if use_ema and state.ema_params is None:
            raise ValueError(
                "use_ema=True but the TrainState has no ema_params; "
                "build it with TrainState.create(..., ema=True)."
            )
        with torch.no_grad():
            if use_ema:
                logits = torch.func.functional_call(module, state.ema_params, (batch["input"],))
            else:
                logits = module(batch["input"])
            metrics = {
                "loss": loss_fn(logits, batch["target"]),
                "accuracy": accuracy(logits, batch["target"]),
            }
            if top5:
                metrics["top5_accuracy"] = top_k_accuracy(logits, batch["target"], k=5)
        return metrics

    return eval_step


def host_snapshot(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """A copy of a nested dict of tensors (and host ints) that owns its
    bytes, for a checkpoint written while training goes on: every card
    tensor is copied into pinned host memory by a non-blocking copy on
    the current stream, the stream the step runs on, so the next step's
    in-place writes queue behind the copies; a CPU tensor is cloned.
    Returns ``(copy, event)``, the event recorded after the copies (None
    when no tensor lies on a card): wait on it before reading the copy."""
    devices = []

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type != "cuda":
            return x.clone()
        devices.append(x.device)
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    out = copy(tree)
    event = None
    if devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(devices[0]))
    return out, event
