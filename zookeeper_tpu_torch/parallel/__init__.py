"""Distribution: process groups, meshes and partitioners.

The port of ``zookeeper_tpu/parallel`` over ``torch.distributed``, one
process per card (NCCL), or per CPU rank (gloo) when a run is asked for
the CPU. A ``Partitioner`` component owns the mesh over the ranks, each
rank's share of every global batch and the collectives the train step
needs: data parallelism (``DataParallelPartitioner``: rows of the
batch, gradient and metric means, global BatchNorm moments) and
sequence parallelism (``SequenceParallelPartitioner``: sequence columns
too, with ring, ring-flash or Ulysses attention across the ranks of a
data index). The partition rules, FSDP, tensor parallelism and the
activation-sharding scope are not ported yet (ROADMAP.md).
"""

from zookeeper_tpu_torch.parallel.distributed import (
    DistributedRuntime,
    initialize_distributed,
    is_distributed_initialized,
)
from zookeeper_tpu_torch.parallel.partitioner import (
    BatchSlice,
    DataParallelPartitioner,
    FsdpPartitioner,
    MeshPartitioner,
    Partitioner,
    ReplicaGroup,
    SingleDevicePartitioner,
)
from zookeeper_tpu_torch.parallel.sequence import SequenceParallelPartitioner

__all__ = [
    "BatchSlice",
    "DataParallelPartitioner",
    "DistributedRuntime",
    "FsdpPartitioner",
    "MeshPartitioner",
    "Partitioner",
    "ReplicaGroup",
    "SequenceParallelPartitioner",
    "SingleDevicePartitioner",
    "initialize_distributed",
    "is_distributed_initialized",
]
