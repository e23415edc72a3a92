"""Partitioner components: who owns the mesh and each rank's share.

The port of ``zookeeper_tpu/parallel/partitioner.py`` over
``torch.distributed``, one process per card. Where JAX's GSPMD derives
every collective from sharding annotations, a rank here holds its slice
of each global batch and the partitioner names the collectives the step
needs:

- ``SingleDevicePartitioner``: one card, no mesh;
- ``DataParallelPartitioner``: a 1-D ``data`` mesh over every rank;
  each rank takes its rows of every global batch, the state replicates,
  the gradients and the step metrics are averaged over the ranks and
  train-mode BatchNorms take the moments of the global batch
  (``ops.layers.global_batch_stats``), as JAX's synced BatchNorm does;
- ``MeshPartitioner``: the N-D form, with data axes only in this slice.

The mesh is ``torch.distributed.device_mesh.init_device_mesh`` over the
ranks in JAX's row-major axis order: on a ``("data", "sp")`` mesh rank
r sits at ``(r // sp, r % sp)``. Without a process group (no launcher,
world size 1) there is no mesh and no collective is ever called, so a
single-card run is the run it was before partitioners existed, to the
bit. ``FsdpPartitioner``, partition ``rules`` and a ``model`` axis are
not ported yet (ROADMAP.md) and raise.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.parallel import distributed

_NOT_PORTED = "is not in the PyTorch port yet; it is queued in ROADMAP.md (Queue 1 item 3)."


@dataclass(frozen=True)
class BatchSlice:
    """A rank's share of every global batch (or slab): the rows of data
    index ``data_index`` of ``data_count`` and, for token batches under
    sequence parallelism, the sequence columns of index ``seq_index`` of
    ``seq_count`` (``data.pipeline.batch_iterator``'s ``host_index``/
    ``host_count`` and ``seq_index``/``seq_count``)."""

    data_index: int
    data_count: int
    seq_index: int = 0
    seq_count: int = 1


class ReplicaGroup:
    """The ranks that hold one copy of the parameters (every rank of the
    mesh) and, inside them, the data group whose global batch the
    BatchNorms normalise over. What the train step and the eval loop ask
    of the ranks: means, sums and the BatchNorm scope."""

    def __init__(self, size: int, data_group: Any, data_size: int):
        self.size = size
        self.data_group = data_group
        self.data_size = data_size

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum ``tensors`` over the ranks, in place: one all-reduce per
        dtype and device, over a flat copy."""
        buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
        for t in tensors:
            buckets.setdefault((t.dtype, t.device), []).append(t)
        for group in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat)
            torch._foreach_copy_(group, [v.view_as(t) for v, t in
                                         zip(flat.split([t.numel() for t in group]), group)])

    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average ``tensors`` over the ranks, in place."""
        tensors = list(tensors)
        self.sum_(tensors)
        torch._foreach_div_(tensors, float(self.size))

    def batch_stats(self):
        """The scope in which train-mode BatchNorms take the moments of
        the global batch (a no-op when the data group is one rank)."""
        from zookeeper_tpu_torch.ops.layers import global_batch_stats

        if self.data_size == 1:
            return contextlib.nullcontext()
        return global_batch_stats(self.data_group)

    def barrier(self) -> None:
        dist.barrier()


def _mesh_sizes(axis_sizes: Sequence[int], axis_names: Sequence[str], n: int) -> List[int]:
    """``axis_sizes`` with a -1 inferred from ``n`` ranks (as reshape
    does); the JAX package's checks and messages."""
    sizes = list(axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"mesh_shape {tuple(sizes)} and mesh_axes {tuple(axis_names)} differ in length.")
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1.")
    known = 1
    for s in sizes:
        if s != -1:
            known *= s
    if -1 in sizes:
        if n % known != 0:
            raise ValueError(f"Device count {n} not divisible by fixed axes {known}.")
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(
            f"Mesh {dict(zip(axis_names, sizes))} needs {total} devices, have {n}."
        )
    return sizes


def _coordinates(sizes: Sequence[int], rank: int) -> List[int]:
    """Rank ``rank``'s row-major coordinates on a mesh of ``sizes``."""
    coords = []
    for s in reversed(sizes):
        coords.append(rank % s)
        rank //= s
    return coords[::-1]


@component
class Partitioner:
    """Abstract distribution strategy."""

    def setup(self) -> None:
        """Create the mesh (if any). Idempotent."""

    @property
    def mesh(self) -> Any:
        """The ``DeviceMesh`` over the ranks; None without a process
        group."""
        return None

    @property
    def mesh_sizes(self) -> Dict[str, int]:
        """``{axis: size}`` of the mesh (JAX's ``mesh.shape``); empty for
        a single device."""
        return {}

    def process_span(self) -> int:
        """How many ranks the mesh spans (1 when meshless)."""
        return 1

    @property
    def is_chief(self) -> bool:
        """Whether this rank writes what one copy of the run writes (logs,
        metrics files, checkpoints, the export): rank 0."""
        return distributed.rank() == 0

    def prepare_model(self, model: Any) -> None:
        """Hook called before ``model.build()``: a partitioner that owns
        part of the model's program wires it here (the sequence-parallel
        attention). Default: no-op."""

    def batch_sharding(self) -> Optional[BatchSlice]:
        """This rank's share of every global batch (and of every
        ``[unroll, batch, ...]`` slab: it is taken from each batch before
        the slab is stacked; JAX's ``slab_sharding``); None = the whole
        batch."""
        return None

    def shard_state(self, state: Any) -> Any:
        """Place the freshly initialized state (identity without ranks)."""
        return state

    def replicas(self) -> Optional[ReplicaGroup]:
        """The ranks that average the gradients and the step metrics;
        None when there is one."""
        return None

    def check_same_step(self, step: int) -> None:
        """Raise unless every rank holds the state of step ``step`` (after
        a restore). No-op without ranks."""


@component
class SingleDevicePartitioner(Partitioner):
    """One card: the default placement, no collective."""


@component
class MeshPartitioner(Partitioner):
    """General N-D mesh partitioner over the ranks.

    ``mesh_shape``/``mesh_axes`` define the mesh (e.g. ``(-1,)`` with
    ``('data',)``); ``data_axes`` names the axes the batch is split over.
    Every axis is a data axis in this slice: a ``model`` axis and
    partition rules raise."""

    mesh_shape: Sequence[int] = Field((-1,))
    mesh_axes: Sequence[str] = Field(("data",))
    data_axes: Sequence[str] = Field(("data",))
    #: Ranks the mesh spans; -1 = every rank of the group.
    num_devices: int = Field(-1)

    _mesh: Any = None
    _sizes: Optional[Dict[str, int]] = None

    def with_rules(self, rules: Sequence[Any]) -> "MeshPartitioner":
        """Partition rules (programmatic): the empty list replicates every
        parameter, which is what the port does; sharded parameters are not
        ported yet."""
        if list(rules):
            raise NotImplementedError(f"Partition rules (sharded parameters) {_NOT_PORTED}")
        return self

    def _axes(self) -> Tuple[List[int], List[str]]:
        """The mesh's sizes and axis names (subclasses derive them)."""
        return list(self.mesh_shape), list(self.mesh_axes)

    def _check_axes(self, axes: Sequence[str]) -> None:
        unknown = [a for a in self.data_axes if a not in axes]
        if unknown:
            raise ValueError(f"data_axes {unknown} are not mesh axes {tuple(axes)}.")
        model = [a for a in axes if a not in self.data_axes]
        if model:
            raise NotImplementedError(
                f"Mesh axes {model} that do not carry the batch (tensor "
                f"parallelism, a 'model' axis) {_NOT_PORTED}"
            )

    def setup(self) -> None:
        if self._sizes is not None:
            return
        sizes, axes = self._axes()
        self._check_axes(axes)
        world = distributed.world_size()
        if self.num_devices > 0 and self.num_devices != world:
            raise ValueError(
                f"Requested {self.num_devices} devices, have {world} ranks: a "
                "mesh spans every rank of the group (one process per card)."
            )
        sizes = _mesh_sizes(sizes, axes, world)
        mesh = None
        if distributed.is_distributed_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            mesh = init_device_mesh(kind, tuple(sizes), mesh_dim_names=tuple(axes))
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_sizes", dict(zip(axes, sizes)))

    @property
    def mesh(self) -> Any:
        self.setup()
        return self._mesh

    @property
    def mesh_sizes(self) -> Dict[str, int]:
        self.setup()
        return dict(self._sizes)

    def process_span(self) -> int:
        n = 1
        for s in self.mesh_sizes.values():
            n *= s
        return n

    def coordinates(self) -> Dict[str, int]:
        """This rank's index on each mesh axis (row-major over the ranks)."""
        shape = self.mesh_sizes
        return dict(zip(shape, _coordinates(list(shape.values()), distributed.rank())))

    def _data_share(self) -> Tuple[int, int]:
        """``(index, count)`` of this rank's rows: row-major over the data
        axes."""
        shape, coords = self.mesh_sizes, self.coordinates()
        index, count = 0, 1
        for a in self.data_axes:
            index = index * shape[a] + coords[a]
            count *= shape[a]
        return index, count

    def batch_sharding(self) -> BatchSlice:
        return BatchSlice(*self._data_share())

    def _data_group(self) -> Any:
        """The process group of this rank's data axes."""
        if tuple(self.data_axes) == tuple(self.mesh_sizes):
            return dist.group.WORLD
        (axis,) = self.data_axes
        return self.mesh.get_group(axis)

    def replicas(self) -> Optional[ReplicaGroup]:
        if self.process_span() == 1:
            return None
        return ReplicaGroup(self.process_span(), self._data_group(), self._data_share()[1])

    def shard_state(self, state: Any) -> Any:
        """Every rank built the same state from the same seed; at world
        size > 1 rank 0's copy is broadcast all the same (parameters,
        buffers, optimizer state, EMA), so the replicas start equal to the
        bit whatever each rank's initialization did."""
        if self.process_span() == 1:
            return state
        from zookeeper_tpu_torch.training.optimizer import state_tensors

        with torch.no_grad():
            for t in _state_tensors(state, state_tensors):
                dist.broadcast(t, src=0)
        return state

    def check_same_step(self, step: int) -> None:
        if self.process_span() == 1:
            return
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, int(step))
        if len(set(seen)) != 1:
            raise RuntimeError(
                f"The ranks restored different steps {seen}: every rank must "
                "resume from the same checkpoint step."
            )


def _state_tensors(state: Any, state_tensors) -> List[torch.Tensor]:
    tensors = list(state.module.parameters()) + list(state.module.buffers())
    tensors += state_tensors(state.opt_state)
    tensors += list((state.ema_params or {}).values())
    return [t.data if isinstance(t, torch.nn.Parameter) else t for t in tensors]


@component
class DataParallelPartitioner(MeshPartitioner):
    """Pure DP: a 1-D mesh, batch rows on 'data', everything replicated
    (the MeshPartitioner defaults, under the name users reach for)."""


@component
class FsdpPartitioner(MeshPartitioner):
    """Turnkey FSDP (batch and large weights sharded over one ``fsdp``
    axis), with the JAX package's fields; not ported yet, so ``setup``
    raises."""

    mesh_shape: Sequence[int] = Field((-1,))
    mesh_axes: Sequence[str] = Field(("fsdp",))
    data_axes: Sequence[str] = Field(("fsdp",))
    min_weight_size: int = Field(2**15)
    replicate_patterns: Sequence[str] = Field(())

    def setup(self) -> None:
        raise NotImplementedError(f"FsdpPartitioner (sharded parameters) {_NOT_PORTED}")
