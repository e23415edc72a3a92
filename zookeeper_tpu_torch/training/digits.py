"""The real-digits training task, the port of
``examples/digits_experiment.py``'s ``TrainDigits``: real handwritten
digits with no download (``SklearnDigits``, scikit-learn's bundled 8x8
scans; scikit-learn is needed)::

    python -m zookeeper_tpu_torch.training TrainDigits export_model_to=/tmp/digits
    python -m zookeeper_tpu_torch.training TrainDigits model=BinaryNet \\
        "model.features=(32,32)" "model.dense_units=(64,)" optimizer=Bop
    python -m zookeeper_tpu_torch.training TrainDigits \\
        loader.dataset.train_fraction=0.1 loader.dataset.label_noise_fraction=0.3

``SimpleCnn`` at 8x8x1 with Adam, batch 64, five epochs. It trains on
the card unless ``device=cpu`` is passed. Serve the export with
``python -m zookeeper_tpu_torch.serving ServeDigits checkpoint=/tmp/digits``.
"""

from zookeeper_tpu_torch.core import ComponentField, Field, PartialComponent, task
from zookeeper_tpu_torch.data import DataLoader, ImageClassificationPreprocessing, SklearnDigits
from zookeeper_tpu_torch.models import Model, SimpleCnn
from zookeeper_tpu_torch.training.experiment import TrainingExperiment

DigitsPreprocessing = PartialComponent(
    ImageClassificationPreprocessing, height=8, width=8, channels=1
)


@task
class TrainDigits(TrainingExperiment):
    loader: DataLoader = ComponentField(
        DataLoader, dataset=SklearnDigits, preprocessing=DigitsPreprocessing
    )
    model: Model = ComponentField(SimpleCnn)
    epochs: int = Field(5)
    batch_size: int = Field(64)
