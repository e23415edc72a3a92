"""The MNIST-scale training task (BASELINE config 1), the port of
``examples/mnist_experiment.py``'s ``TrainMnist``::

    python -m zookeeper_tpu_torch.training TrainMnist epochs=2 batch_size=64
    python -m zookeeper_tpu_torch.training TrainMnist model=Mlp "model.hidden_units=(256,)"

``SimpleCnn`` on synthetic MNIST-shaped data (28x28x1, 10 classes) with
Adam. It trains on the card unless ``device=cpu`` is passed. The
binary-net recipe at MNIST scale: export a teacher, distill a
``BinaryNet`` from it, score the student's export::

    python -m zookeeper_tpu_torch.training TrainMnist export_model_to=/tmp/teacher
    python -m zookeeper_tpu_torch.training DistillMnist teacher_checkpoint=/tmp/teacher \
        alpha=0.4 temperature=2.0 optimizer=Bop track_flip_ratio=True \
        ema_decay=0.999 export_model_to=/tmp/student
    python -m zookeeper_tpu_torch.training EvaluateMnist checkpoint=/tmp/student \
        model=BinaryNet
"""

from zookeeper_tpu_torch.core import ComponentField, Field, PartialComponent, task
from zookeeper_tpu_torch.data import DataLoader, ImageClassificationPreprocessing, SyntheticMnist
from zookeeper_tpu_torch.models import BinaryNet, Model, SimpleCnn
from zookeeper_tpu_torch.training.distill import DistillationExperiment
from zookeeper_tpu_torch.training.experiment import EvalExperiment, TrainingExperiment

MnistPreprocessing = PartialComponent(
    ImageClassificationPreprocessing, height=28, width=28, channels=1
)


@task
class TrainMnist(TrainingExperiment):
    loader: DataLoader = ComponentField(
        DataLoader, dataset=SyntheticMnist, preprocessing=MnistPreprocessing
    )
    model: Model = ComponentField(SimpleCnn)
    epochs: int = Field(2)
    batch_size: int = Field(64)


@task
class DistillMnist(DistillationExperiment):
    """The recipe's second stage: distill a ``BinaryNet`` from an exported
    teacher (``TrainMnist export_model_to=...`` first)."""

    loader: DataLoader = ComponentField(
        DataLoader, dataset=SyntheticMnist, preprocessing=MnistPreprocessing
    )
    model: Model = ComponentField(BinaryNet)
    teacher: Model = ComponentField(SimpleCnn)
    epochs: int = Field(2)
    batch_size: int = Field(64)


@task
class EvaluateMnist(EvalExperiment):
    """Score an export (``TrainMnist export_model_to=...``)."""

    loader: DataLoader = ComponentField(
        DataLoader, dataset=SyntheticMnist, preprocessing=MnistPreprocessing
    )
    model: Model = ComponentField(SimpleCnn)
