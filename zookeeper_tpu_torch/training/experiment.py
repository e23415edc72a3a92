"""Experiment components: the configurable training loop.

The port of ``zookeeper_tpu/training/experiment.py``'s ``Experiment``
and a trimmed ``TrainingExperiment``::

    loader.batches() --prefetch--> device tensors
    state = TrainState(module, optimizer state)
    for epoch: for batch: state, metrics = train_step(state, batch)

One host readback per epoch (or per ``log_every`` steps) pulls the
step metrics. ``run()`` returns ``{"train": [...], "validation":
[...]}``, one dict of metric means per epoch. Checkpointing,
partitioners and multi-GPU, multi-step slabs, observability, EMA,
distillation and early stopping are not ported yet (ROADMAP.md).
"""

import time
from typing import Any, Dict, List

import torch

from zookeeper_tpu_torch.core import ComponentField, Field, component, pretty_print
from zookeeper_tpu_torch.data.pipeline import DataLoader
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.ops.device import resolve_device
from zookeeper_tpu_torch.training.optimizer import Adam, Optimizer
from zookeeper_tpu_torch.training.state import TrainState
from zookeeper_tpu_torch.training.step import (
    make_eval_step,
    make_train_step,
    smoothed_softmax_cross_entropy,
)


@component
class Experiment:
    """Abstract experiment: subclasses implement run()."""

    def run(self) -> Any:
        raise NotImplementedError("Experiment subclasses must implement run().")


def _host_means(accum: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per-key means of a list of 0-d metric tensors, read back in one
    device-to-host copy."""
    if not accum:
        return {}
    keys = list(accum[0])
    stacked = torch.stack([torch.stack([m[k] for m in accum]) for k in keys])
    host = stacked.to(torch.float64).cpu()
    return {k: float(host[i].mean()) for i, k in enumerate(keys)}


def run_weighted_eval(loader, split, eval_step, state, device, epoch=0) -> Dict[str, float]:
    """Eval loop: per-batch metric means weighted by the batch's example
    count, accumulated on the device, read back once. ``{}`` when the
    split yields no batches."""
    accum = None
    examples = 0
    for batch in loader.batches(split, device=device, epoch=epoch, training=False):
        n = int(batch["target"].shape[0])
        m = eval_step(state, batch)
        weighted = {k: v.to(torch.float64) * n for k, v in m.items()}
        accum = weighted if accum is None else {k: accum[k] + weighted[k] for k in accum}
        examples += n
    if not examples:
        return {}
    return {k: float(v.cpu()) / examples for k, v in accum.items()}


@component
class TrainingExperiment(Experiment):
    """Supervised-classification training loop. ``batch_size`` set here
    is inherited by the loader through scoped field inheritance."""

    loader: DataLoader = ComponentField(DataLoader)
    model: Model = ComponentField()
    optimizer: Optimizer = ComponentField(Adam)

    epochs: int = Field(1)
    batch_size: int = Field(32)
    seed: int = Field(0)
    #: Cap on steps per epoch; -1 = the full epoch.
    steps_per_epoch: int = Field(-1)
    validate: bool = Field(True)
    #: Label smoothing of the loss (0 = off); validation scores the same
    #: smoothed loss.
    label_smoothing: float = Field(0.0)
    #: Also report top-5 accuracy in validation (needs >= 5 classes).
    track_top5: bool = Field(False)
    #: Steps between progress lines; 0 = epoch lines only.
    log_every: int = Field(0)
    verbose: bool = Field(True)
    #: Where the model trains: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")

    @Field
    def num_classes(self) -> int:
        return int(self.loader.dataset.resolved_num_classes())

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def _steps_per_epoch(self) -> int:
        spe = self.loader.steps_per_epoch("train")
        if self.steps_per_epoch > 0:
            spe = min(spe, self.steps_per_epoch)
        return spe

    def build_state(self, device: torch.device) -> TrainState:
        """Build and initialize the module from ``seed`` on ``device``,
        and the optimizer over the run's steps."""
        input_shape = self.loader.preprocessing.input_shape
        module = self.model.build(input_shape, self.num_classes)
        self.model.initialize(module, seed=self.seed)
        module.to(device)
        tx = self.optimizer.build(total_steps=max(1, self._steps_per_epoch() * self.epochs))
        return TrainState.create(module, tx)

    def _train_step_fn(self):
        return make_train_step(smoothed_softmax_cross_entropy(self.label_smoothing))

    def run(self) -> Dict[str, List[Dict[str, float]]]:
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(f"label_smoothing={self.label_smoothing} outside [0, 1).")
        if self.track_top5 and self.num_classes < 5:
            raise ValueError(
                f"track_top5=True needs >= 5 classes (dataset has {self.num_classes})."
            )
        device = resolve_device(self.device)
        self._log(pretty_print(self))
        state = self.build_state(device)
        train_step = self._train_step_fn()
        eval_step = make_eval_step(
            smoothed_softmax_cross_entropy(self.label_smoothing), top5=self.track_top5
        )
        spe = self._steps_per_epoch()
        history: Dict[str, List[Dict[str, float]]] = {"train": [], "validation": []}
        has_val_split = self.validate and self.loader.dataset.validation() is not None
        for epoch in range(self.epochs):
            t0 = time.perf_counter()
            accum: List[Dict[str, torch.Tensor]] = []
            batches = self.loader.batches(
                "train", device=device, epoch=epoch, max_batches=spe
            )
            try:
                for step_idx, batch in enumerate(batches):
                    state, metrics = train_step(state, batch)
                    accum.append(metrics)
                    if self.log_every and (step_idx + 1) % self.log_every == 0:
                        row = _host_means([metrics])
                        self._log(
                            f"  step {step_idx + 1}/{spe} "
                            f"loss={row['loss']:.4f} acc={row['accuracy']:.4f}"
                        )
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            epoch_metrics = _host_means(accum)  # the epoch's one readback
            dt = time.perf_counter() - t0
            epoch_metrics["examples_per_sec"] = (
                len(accum) * self.loader.batch_size / dt if dt > 0 else 0.0
            )
            history["train"].append(epoch_metrics)
            line = (
                f"epoch {epoch + 1}/{self.epochs} "
                f"loss={epoch_metrics.get('loss', float('nan')):.4f} "
                f"acc={epoch_metrics.get('accuracy', float('nan')):.4f} "
                f"({epoch_metrics['examples_per_sec']:.0f} ex/s)"
            )
            if has_val_split:
                vmetrics = run_weighted_eval(
                    self.loader, "validation", eval_step, state, device, epoch=epoch
                )
                if vmetrics:
                    history["validation"].append(vmetrics)
                    line += (
                        f" | val_loss={vmetrics.get('loss', float('nan')):.4f} "
                        f"val_acc={vmetrics.get('accuracy', float('nan')):.4f}"
                    )
            self._log(line)
        self.final_state = state
        return history
