"""The ImageNet-scale training task, the port of
``examples/imagenet_experiment.py``'s ``TrainImageNet``::

    python -m zookeeper_tpu_torch.training TrainImageNet \\
        model=QuickNetLarge model.binary_compute=int8 \\
        model.pack_residuals=True batch_size=128

QuickNet in bfloat16 on synthetic ImageNet-shaped data with the
Inception RandomResizedCrop recipe, Adam under a warmup-cosine schedule
and label smoothing 0.1; ``model=`` takes any model of the zoo
(``BiRealNet``, ``BinaryResNetE18``, ``RealToBinaryNet``, ``ReActNet``,
``XNORNet``, ``DoReFaNet``, ``ResNet50``, ...). It trains on the card
unless ``device=cpu`` is passed. ``partitioner`` defaults to
``DataParallelPartitioner``: under ``python -m torch.distributed.run
--nproc-per-node N`` each rank trains on its rows of every global batch,
with the gradients averaged and the BatchNorm moments taken over the
global batch; without a launcher, one card.

``DistillImageNet`` is the Real-to-Binary staged recipe (Martinez et al.
2020): train a full-precision teacher and export it, then distill the
binary student from it::

    python -m zookeeper_tpu_torch.training TrainImageNet model=ResNet50 \
        export_model_to=/tmp/teacher
    python -m zookeeper_tpu_torch.training DistillImageNet \
        teacher_checkpoint=/tmp/teacher alpha=0.4 temperature=2.0 \
        optimizer=Bop track_flip_ratio=True ema_decay=0.999
"""

from zookeeper_tpu_torch.core import ComponentField, Field, PartialComponent, task
from zookeeper_tpu_torch.data import (
    DataLoader,
    ImageClassificationPreprocessing,
    SyntheticImageNet,
)
from zookeeper_tpu_torch.models import Model, QuickNet, RealToBinaryNet, ResNet50
from zookeeper_tpu_torch.parallel import DataParallelPartitioner, Partitioner
from zookeeper_tpu_torch.training.distill import DistillationExperiment
from zookeeper_tpu_torch.training.experiment import TrainingExperiment
from zookeeper_tpu_torch.training.optimizer import Adam, Optimizer
from zookeeper_tpu_torch.training.schedule import WarmupCosine

ImageNetPreprocessing = PartialComponent(
    ImageClassificationPreprocessing,
    height=224, width=224, channels=3, augment=True,
    random_resized_crop=True,
)


@task
class TrainImageNet(TrainingExperiment):
    loader: DataLoader = ComponentField(
        DataLoader,
        dataset=SyntheticImageNet,
        preprocessing=ImageNetPreprocessing,
        num_workers=8,
    )
    model: Model = ComponentField(QuickNet, compute_dtype="bfloat16")
    optimizer: Optimizer = ComponentField(
        Adam, schedule=PartialComponent(WarmupCosine, base_lr=1e-2)
    )
    partitioner: Partitioner = ComponentField(DataParallelPartitioner)
    epochs: int = Field(120)
    batch_size: int = Field(256)
    label_smoothing: float = Field(0.1)
    track_top5: bool = Field(True)


@task
class DistillImageNet(DistillationExperiment):
    """A ``RealToBinaryNet`` student distilled from a ``ResNet50``
    teacher's export (``teacher_checkpoint``), both in bfloat16."""

    loader: DataLoader = ComponentField(
        DataLoader,
        dataset=SyntheticImageNet,
        preprocessing=ImageNetPreprocessing,
        num_workers=8,
    )
    model: Model = ComponentField(RealToBinaryNet, compute_dtype="bfloat16")
    teacher: Model = ComponentField(ResNet50, compute_dtype="bfloat16")
    optimizer: Optimizer = ComponentField(
        Adam, schedule=PartialComponent(WarmupCosine, base_lr=2.5e-3)
    )
    partitioner: Partitioner = ComponentField(DataParallelPartitioner)
    epochs: int = Field(75)
    batch_size: int = Field(256)
    track_top5: bool = Field(True)
