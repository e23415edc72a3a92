"""``python -m zookeeper_tpu_torch.serving.decode LMServingConfig model.d_model=512 ...``,
or ``DisaggServingConfig`` (disaggregated prefill/decode) with the same keys.

Under ``python -m torch.distributed.run --nproc_per_node N`` every rank
runs the same ``run()`` on the same seeded stream under ``partitioner=...``
and only the chief prints the JSON line."""

import zookeeper_tpu_torch.models  # noqa: F401  (registers the models by name)
from zookeeper_tpu_torch.core import cli
from zookeeper_tpu_torch.serving.decode import LMServingConfig  # noqa: F401  (a task)
from zookeeper_tpu_torch.serving.disagg import DisaggServingConfig  # noqa: F401  (a task)

if __name__ == "__main__":
    cli()
