"""Distribution: process groups, meshes and partitioners.

The port of ``zookeeper_tpu/parallel`` over ``torch.distributed``, one
process per card (NCCL), or per CPU rank (gloo) when a run is asked for
the CPU. A ``Partitioner`` component owns the mesh over the ranks, each
rank's share of every global batch and the collectives the train step
needs: data parallelism (``DataParallelPartitioner``: rows of the
batch, gradient and metric means, global BatchNorm moments) and
sequence parallelism (``SequenceParallelPartitioner``: sequence columns
too, with ring, ring-flash or Ulysses attention across the ranks of a
data index), sharded parameters (``FsdpPartitioner``: ZeRO-3 over one
``fsdp`` axis; ``MeshPartitioner`` with a ``model`` axis and partition
rules: tensor parallelism, ``parallel.shards``) and the activation-
sharding scope (``parallel.sharding``).
"""

from zookeeper_tpu_torch.parallel.distributed import (
    DistributedRuntime,
    initialize_distributed,
    is_distributed_initialized,
)
from zookeeper_tpu_torch.parallel.partitioner import (
    BatchSlice,
    DataParallelPartitioner,
    ForwardPlan,
    FsdpPartitioner,
    MeshPartitioner,
    Partitioner,
    ReplicaGroup,
    SingleDevicePartitioner,
)
from zookeeper_tpu_torch.parallel.rules import (
    PartitionRule,
    PartitionSpec,
    auto_fsdp_rules,
    conv_model_tp_rules,
    decode_cache_rules,
    match_partition_rules,
    page_pool_rules,
    transformer_tp_rules,
)
from zookeeper_tpu_torch.parallel.sequence import SequenceParallelPartitioner
from zookeeper_tpu_torch.parallel.sharding import (
    activation_sharding_scope,
    constrain_batch_sharded,
    current_activation_scope,
)

__all__ = [
    "activation_sharding_scope",
    "auto_fsdp_rules",
    "BatchSlice",
    "constrain_batch_sharded",
    "conv_model_tp_rules",
    "current_activation_scope",
    "decode_cache_rules",
    "DataParallelPartitioner",
    "DistributedRuntime",
    "ForwardPlan",
    "FsdpPartitioner",
    "MeshPartitioner",
    "PartitionRule",
    "PartitionSpec",
    "Partitioner",
    "page_pool_rules",
    "ReplicaGroup",
    "SequenceParallelPartitioner",
    "SingleDevicePartitioner",
    "initialize_distributed",
    "is_distributed_initialized",
    "match_partition_rules",
    "transformer_tp_rules",
]
