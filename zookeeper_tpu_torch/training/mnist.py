"""The MNIST-scale training task (BASELINE config 1), the port of
``examples/mnist_experiment.py``'s ``TrainMnist``::

    python -m zookeeper_tpu_torch.training TrainMnist epochs=2 batch_size=64
    python -m zookeeper_tpu_torch.training TrainMnist model=Mlp "model.hidden_units=(256,)"

``SimpleCnn`` on synthetic MNIST-shaped data (28x28x1, 10 classes) with
Adam. It trains on the card unless ``device=cpu`` is passed.
"""

from zookeeper_tpu_torch.core import ComponentField, Field, PartialComponent, task
from zookeeper_tpu_torch.data import DataLoader, ImageClassificationPreprocessing, SyntheticMnist
from zookeeper_tpu_torch.models import Model, SimpleCnn
from zookeeper_tpu_torch.training.experiment import TrainingExperiment

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
