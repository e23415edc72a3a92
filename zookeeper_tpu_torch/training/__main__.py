"""``python -m zookeeper_tpu_torch.training TrainImageNet|TrainLM key=value ...``"""

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets by name)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models by name)
import zookeeper_tpu_torch.training  # noqa: F401  (schedules and optimizers)
from zookeeper_tpu_torch.core import cli
from zookeeper_tpu_torch.training.imagenet import TrainImageNet  # noqa: F401  (a task)
from zookeeper_tpu_torch.training.lm import TrainLM  # noqa: F401  (a task)

if __name__ == "__main__":
    cli()
