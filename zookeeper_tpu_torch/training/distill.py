"""Knowledge distillation (the Real-to-Binary recipe).

The port of ``zookeeper_tpu/training/distill.py``. Binary nets reach
their published accuracies with a full-precision teacher;
``DistillationExperiment`` adds a frozen teacher whose
temperature-softened logits join the loss::

    loss = alpha * CE(student, labels)
         + (1 - alpha) * T^2 * KL(teacher_T || student_T)

The teacher is any ``Model`` loaded from a model-only export
(``TrainingExperiment.export_model_to`` writes one), so the staged recipe
is two CLI calls::

    python -m zookeeper_tpu_torch.training TrainImageNet model=ResNet50 \\
        export_model_to=/ckpt/teacher
    python -m zookeeper_tpu_torch.training DistillImageNet \\
        teacher_checkpoint=/ckpt/teacher alpha=0.4 temperature=2.0
"""

from typing import Optional

import torch

from zookeeper_tpu_torch.core import ComponentField, Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.parallel.distributed import local_device
from zookeeper_tpu_torch.training.checkpoint import load_exported_model
from zookeeper_tpu_torch.training.experiment import TrainingExperiment
from zookeeper_tpu_torch.training.step import make_train_step

__all__ = ["DistillationExperiment"]


@component
class DistillationExperiment(TrainingExperiment):
    """``TrainingExperiment`` plus a frozen teacher's distillation loss.
    The teacher runs on the student's device, in eval mode (running
    statistics, never updated), in its own compute dtype, under
    ``torch.no_grad()``. It is loaded from its export on every run (a
    resumed run too) and is never part of the student's checkpoint."""

    teacher: Model = ComponentField()
    #: The teacher's model-only export. None trains against a random
    #: teacher, which must be asked for with ``allow_random_teacher``.
    teacher_checkpoint: Optional[str] = Field(None)
    allow_random_teacher: bool = Field(False)
    #: Weight of the hard-label loss (1 - alpha goes to the KD term).
    alpha: float = Field(0.5)
    temperature: float = Field(2.0)

    def _validate_teacher_config(self) -> None:
        if self.teacher_checkpoint is None and not self.allow_random_teacher:
            raise ValueError(
                "DistillationExperiment: teacher_checkpoint is not set — "
                "distilling from a randomly initialized teacher is almost "
                "never intended. Export the teacher with "
                "export_model_to=... on its training run, or set "
                "allow_random_teacher=True to proceed anyway."
            )

    def run(self):
        self._validate_teacher_config()
        return super().run()

    def _teacher_fn(self) -> torch.nn.Module:
        """The teacher: built, loaded, on this rank's device, in eval mode."""
        self._validate_teacher_config()
        input_shape = self.loader.preprocessing.input_shape
        module = self.teacher.build(input_shape, self.num_classes)
        if self.teacher_checkpoint is not None:
            load_exported_model(self.teacher_checkpoint, module)
        else:
            self.teacher.initialize(module, seed=self.seed)
        return module.to(local_device(self.device)).eval().requires_grad_(False)

    def _train_step_fn(self):
        return make_train_step(
            **self._train_step_kwargs(),
            distill=(self._teacher_fn(), self.alpha, self.temperature),
        )
