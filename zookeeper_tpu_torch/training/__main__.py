"""``python -m zookeeper_tpu_torch.training TASK key=value ...``, TASK one of
TrainImageNet, DistillImageNet, TrainMnist, DistillMnist, EvaluateMnist,
TrainLM, TrainDigits, TrainCifar, ConvertPacked."""

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets by name)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models by name)
import zookeeper_tpu_torch.training  # noqa: F401  (schedules and optimizers)
from zookeeper_tpu_torch.core import cli
from zookeeper_tpu_torch.training.cifar import TrainCifar  # noqa: F401  (a task)
from zookeeper_tpu_torch.training.convert_packed import ConvertPacked  # noqa: F401  (a task)
from zookeeper_tpu_torch.training.digits import TrainDigits  # noqa: F401  (a task)
from zookeeper_tpu_torch.training.imagenet import DistillImageNet, TrainImageNet  # noqa: F401
from zookeeper_tpu_torch.training.lm import TrainLM  # noqa: F401  (a task)
from zookeeper_tpu_torch.training.mnist import (  # noqa: F401  (tasks)
    DistillMnist,
    EvaluateMnist,
    TrainMnist,
)

if __name__ == "__main__":
    cli()
