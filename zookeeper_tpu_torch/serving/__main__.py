"""``python -m zookeeper_tpu_torch.serving TASK key=value ...``, TASK one of
ServingConfig, ServeDigits, LatencyBench, ServeFleet. Under ``python -m
torch.distributed.run --nproc_per_node N`` every rank runs the same task
(``partitioner=...``: ``ServingConfig`` serves its share on the same
seeded stream) and only the chief prints."""

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets by name)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models by name)
from zookeeper_tpu_torch.core import cli
from zookeeper_tpu_torch.serving import ServingConfig  # noqa: F401  (a task)
from zookeeper_tpu_torch.serving.classifier import ServeDigits  # noqa: F401  (a task)
from zookeeper_tpu_torch.serving.latency import LatencyBench  # noqa: F401  (a task)
from zookeeper_tpu_torch.serving.serve_fleet import ServeFleet  # noqa: F401  (a task)

if __name__ == "__main__":
    cli()
