"""The CIFAR-scale binary-network task, the port of
``examples/cifar_experiment.py``'s ``TrainCifar`` (BASELINE config 1's
CIFAR form)::

    python -m zookeeper_tpu_torch.training TrainCifar epochs=100 \\
        optimizer=Bop track_flip_ratio=True ema_decay=0.999 \\
        export_model_to=/tmp/cifar_float

``BinaryNet`` with features (128, 128, 256, 256) and one dense layer of
512 on synthetic CIFAR-10-shaped data (``loader.dataset=MemmapDataset
loader.dataset.directory=...`` reads a store instead), pad-and-crop
augmentation by 4 pixels, Adam, batch 128. It trains on the card unless
``device=cpu`` is passed. ``ConvertPacked`` turns the export into the
packed deployment that ``LatencyBench`` and ``ServingConfig`` serve.
"""

from zookeeper_tpu_torch.core import ComponentField, Field, PartialComponent, task
from zookeeper_tpu_torch.data import (
    DataLoader,
    ImageClassificationPreprocessing,
    SyntheticCifar10,
)
from zookeeper_tpu_torch.models import BinaryNet, Model
from zookeeper_tpu_torch.training.experiment import TrainingExperiment
from zookeeper_tpu_torch.training.optimizer import Adam, Optimizer

CifarPreprocessing = PartialComponent(
    ImageClassificationPreprocessing,
    height=32, width=32, channels=3, augment=True, pad_pixels=4,
)


@task
class TrainCifar(TrainingExperiment):
    loader: DataLoader = ComponentField(
        DataLoader, dataset=SyntheticCifar10, preprocessing=CifarPreprocessing
    )
    model: Model = ComponentField(
        BinaryNet, features=(128, 128, 256, 256), dense_units=(512,)
    )
    optimizer: Optimizer = ComponentField(Adam)
    epochs: int = Field(100)
    batch_size: int = Field(128)
