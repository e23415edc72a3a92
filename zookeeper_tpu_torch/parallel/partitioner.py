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
- ``MeshPartitioner``: the N-D form: data axes that split the batch
  and model axes that do not, with partition ``rules`` (``with_rules``)
  that shard parameters over any of them;
- ``FsdpPartitioner``: one ``fsdp`` axis that splits the batch and, by
  ``auto_fsdp_rules`` derived from each state, the large weights.

The mesh is ``torch.distributed.device_mesh.init_device_mesh`` over the
ranks in JAX's row-major axis order: on a ``("data", "sp")`` mesh rank
r sits at ``(r // sp, r % sp)``. ``shard_state`` keeps each rank's
block of every tensor the rules shard (``parallel.shards``: the layers
that can compute on their shard do, over the model group; every other
sharded parameter is all-gathered before the forward and its gradient
reduce-scattered). The gradients of what every rank of a model
coordinate holds alike are averaged over those ranks (the replica
group, ``ReplicaGroup``). Without a process group (no launcher, world
size 1) there is no mesh, no shard and no collective, so a single-card
run is the run it was before partitioners existed, to the bit.

Serving takes the layout a model trained with, as JAX's partitioners
promise it: ``variables_sharding``, ``decode_cache_sharding`` and
``page_pool_sharding`` give the specs of an inference variables tree,
a KV cache and a page pool (flax paths, as ``state_sharding``);
``plan_variables`` shards a served module by the training rules
(``parallel.shards.plan_inference``); and ``compile_forward`` is the
per-bucket plan of JAX's compiled forward (:class:`ForwardPlan`): a
bucket whose rows divide the data-axis product runs each rank on its
share of the rows, any other runs replicated. PyTorch compiles nothing,
so the plan is what the engine consults for each dispatch.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.parallel.rules import (
    PartitionRule,
    decode_cache_rules,
    match_partition_rules,
    page_pool_rules,
    spec_for,
)
from zookeeper_tpu_torch.parallel.shards import MeshGroups, plan_state


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


@dataclass(frozen=True)
class ForwardPlan:
    """One batch bucket's inference forward on this rank (JAX's
    ``compile_forward``): ``rows`` the bucket; ``split`` whether each rank
    of the data group (``group``, ``count`` ranks, this one ``index``) runs
    its ``rows / count`` rows, the outputs then gathered over the group;
    otherwise every rank runs the whole bucket. ``scope`` is the
    activation scope a split bucket runs in (None for none)."""

    rows: int
    split: bool = False
    index: int = 0
    count: int = 1
    group: Any = None
    scope: Optional[Tuple[Any, Tuple[str, ...], Tuple[str, ...]]] = None

    @property
    def local_rows(self) -> int:
        return self.rows // self.count if self.split else self.rows

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the bucket's batch."""
        if not self.split:
            return x
        n = self.local_rows
        return x[self.index * n:(self.index + 1) * n]

    def assemble(self, y: torch.Tensor) -> torch.Tensor:
        """The bucket's outputs from this rank's (one all-gather of the
        rows over the data group when split)."""
        if not self.split:
            return y
        from zookeeper_tpu_torch.parallel.shards import all_gather_stack

        stacked = all_gather_stack(y, self.group, self.count)
        return stacked.reshape(self.count * y.shape[0], *y.shape[1:])

    def activation_scope(self):
        from zookeeper_tpu_torch.parallel.sharding import activation_sharding_scope

        if not self.split or self.scope is None:
            return contextlib.nullcontext()
        return activation_sharding_scope(*self.scope, rows=self.local_rows)


class ReplicaGroup:
    """The ranks that hold one copy of the parameters (``group``, ``size``
    of them: every rank of the mesh with this rank's model coordinates)
    and, inside them, the data group whose global batch the BatchNorms
    normalise over. What the train step and the eval loop ask of the
    ranks: means, sums, the BatchNorm scope and the activation scope
    (``scope``: ``(mesh, data_axes, model_axes)``, None for none)."""

    def __init__(self, size: int, data_group: Any, data_size: int, group: Any = None,
                 scope: Optional[Tuple[Any, Tuple[str, ...], Tuple[str, ...]]] = None):
        self.size = size
        self.data_group = data_group
        self.data_size = data_size
        self.group = group
        self.scope = scope

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum ``tensors`` over the ranks, in place: one all-reduce per
        dtype and device, over a flat copy."""
        buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
        for t in tensors:
            buckets.setdefault((t.dtype, t.device), []).append(t)
        for group in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.group)
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

    def activation_scope(self, rows: int):
        """The partitioner's activation-sharding scope for a batch of which
        this rank holds ``rows`` (``parallel.sharding``)."""
        from zookeeper_tpu_torch.parallel.sharding import activation_sharding_scope

        if self.scope is None:
            return contextlib.nullcontext()
        return activation_sharding_scope(*self.scope, rows=rows)

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

    def decode_cache_axes(self) -> Tuple[Tuple[str, ...], Optional[str]]:
        """``(data_axes, model_axis)`` a decode KV cache shards over
        (``parallel.rules.decode_cache_rules``); nothing without a mesh.
        The one derivation the cache placement and the sharded decode
        attention both read."""
        return (), None

    def variables_sharding(self, variables: Any) -> Any:
        """Specs of an inference variables tree (``{"params": ...,
        "batch_stats": ...}``, no optimizer state): the training rules
        matched on the same paths, so a model serves under the layout it
        trained with. None = default placement."""
        return None

    def decode_cache_sharding(self, cache: Any) -> Any:
        """Specs of a decode engine's KV cache (a per-layer tuple of
        ``{"k", "v"}`` ``[slots, capacity, heads, head_dim]``): slots over
        the data axes, heads over the model axis. The engine checks that
        they divide and otherwise keeps the cache replicated. None =
        default placement."""
        return None

    def page_pool_sharding(self, pool: Any) -> Any:
        """Specs of a decode engine's page pool: pages replicated (any slot
        reads any page), heads over the model axis (int8 scales too). None
        = default placement."""
        return None

    def compile_forward(self, batch_rows: Optional[int] = None) -> ForwardPlan:
        """The forward plan of a ``batch_rows`` bucket (see
        :class:`ForwardPlan`): without a mesh, the whole bucket here."""
        return ForwardPlan(int(batch_rows or 0))

    def plan_variables(self, module: Any) -> Any:
        """The ``parallel.shards.ShardPlan`` of a served module by the
        rules (None: nothing shards)."""
        return None

    def group_of(self, axes: Sequence[str]) -> Any:
        """This rank's group over ``axes`` as a
        ``parallel.shards.TensorParallel`` (group, index, size); None
        without a mesh."""
        return None

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

    ``mesh_shape``/``mesh_axes`` define the mesh (e.g. ``(-1, 8)`` with
    ``('data', 'model')``); ``data_axes`` names the axes the batch is
    split over (the others are model axes: every rank of one data index
    sees the same rows); ``rules`` maps state paths to PartitionSpecs
    (empty: every tensor replicates)."""

    mesh_shape: Sequence[int] = Field((-1,))
    mesh_axes: Sequence[str] = Field(("data",))
    data_axes: Sequence[str] = Field(("data",))
    #: Ranks the mesh spans; -1 = every rank of the group.
    num_devices: int = Field(-1)

    _mesh: Any = None
    _sizes: Optional[Dict[str, int]] = None
    _groups: Optional[MeshGroups] = None
    _rules: List[PartitionRule] = []

    def with_rules(self, rules: Sequence[PartitionRule]) -> "MeshPartitioner":
        """Set the partition rules (programmatic, since PartitionSpecs are
        not CLI-expressible). Returns self for chaining."""
        object.__setattr__(self, "_rules_override", list(rules))
        return self

    @property
    def rules(self) -> List[PartitionRule]:
        return getattr(self, "_rules_override", self._rules)

    def _axes(self) -> Tuple[List[int], List[str]]:
        """The mesh's sizes and axis names (subclasses derive them)."""
        return list(self.mesh_shape), list(self.mesh_axes)

    def _check_axes(self, axes: Sequence[str]) -> None:
        unknown = [a for a in self.data_axes if a not in axes]
        if unknown:
            raise ValueError(f"data_axes {unknown} are not mesh axes {tuple(axes)}.")

    def _model_axes(self) -> Tuple[str, ...]:
        """The axes a tensor-parallel layer may compute its shard over:
        those that do not split the batch."""
        return tuple(a for a in self.mesh_sizes if a not in self.data_axes)

    def _replica_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks hold the same replicated parameters and
        average their gradients."""
        return tuple(self.data_axes)

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
        if mesh is not None:
            object.__setattr__(self, "_groups", MeshGroups(self._sizes, dist.get_rank()))

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
        return self._groups.group(self.data_axes)

    def _scope(self) -> Optional[Tuple[Any, Tuple[str, ...], Tuple[str, ...]]]:
        return self.mesh, tuple(self.data_axes), self._model_axes()

    def replicas(self) -> Optional[ReplicaGroup]:
        if self.process_span() == 1:
            return None
        axes = self._replica_axes()
        return ReplicaGroup(self._groups.size(axes), self._data_group(),
                            self._data_share()[1], self._groups.group(axes), self._scope())

    def _rules_for(self, state: Any) -> List[PartitionRule]:
        """The rules that lay out ``state`` (FSDP derives them from it)."""
        return self.rules

    def state_sharding(self, state: Any) -> Dict[str, Any]:
        """The spec of every tensor of ``state`` as a flax-layout tree
        ``{"params": ..., "model_state": {"batch_stats": ...}}`` (JAX's
        ``state_sharding``); each parameter's optimizer state and EMA
        copy have its spec. Specs name flax dimensions."""
        from zookeeper_tpu_torch.models.convert import flax_state_layouts, unflatten_tree

        rules = self._rules_for(state)
        return unflatten_tree({path: spec_for(rules, path) for path, _ in
                               flax_state_layouts(state.module).values()})

    def shard_state(self, state: Any) -> Any:
        """Every rank built the same state from the same seed; at world
        size > 1 rank 0's copy is broadcast all the same (parameters,
        buffers, optimizer state, EMA), so the replicas start equal to the
        bit whatever each rank's initialization did. Then, in a process
        group, each rank keeps its block of every tensor the rules shard
        (``parallel.shards.ShardPlan``; ``state.shards``)."""
        if self.mesh is None:
            return state
        if self.process_span() > 1:
            from zookeeper_tpu_torch.training.optimizer import state_tensors

            with torch.no_grad():
                for t in _state_tensors(state, state_tensors):
                    dist.broadcast(t, src=0)
        plan = plan_state(state.module, self._rules_for(state), self._groups,
                          self._model_axes(), self._replica_axes())
        return state if plan is None else plan.apply(state)

    def decode_cache_axes(self) -> Tuple[Tuple[str, ...], Optional[str]]:
        # From the mesh_axes field, as the JAX package derives it (a
        # partitioner that builds its mesh from other fields keeps the
        # field's default).
        model = [a for a in self.mesh_axes if a not in self.data_axes]
        return tuple(self.data_axes), (model[0] if model else None)

    def _variables_rules(self, variables: Any) -> List[PartitionRule]:
        return self.rules

    def variables_sharding(self, variables: Any) -> Any:
        # The training rules: an inference dict's ``params/...`` and
        # ``batch_stats/...`` paths are the training state's prefixes.
        return match_partition_rules(self._variables_rules(variables), variables)

    def decode_cache_sharding(self, cache: Any) -> Any:
        return match_partition_rules(decode_cache_rules(*self.decode_cache_axes()), cache)

    def page_pool_sharding(self, pool: Any) -> Any:
        return match_partition_rules(page_pool_rules(*self.decode_cache_axes()), pool)

    def compile_forward(self, batch_rows: Optional[int] = None) -> ForwardPlan:
        rows = int(batch_rows or 0)
        if self.mesh is None:
            return ForwardPlan(rows)
        index, count = self._data_share()
        if count == 1 or rows % count != 0:
            # A bucket that cannot split over the data axes (the 1-row
            # bucket on a wide mesh) runs replicated, with no activation
            # scope, as JAX's compile_forward does.
            return ForwardPlan(rows)
        return ForwardPlan(rows, True, index, count, self._data_group(), self._scope())

    def _module_rules(self, module: Any) -> List[PartitionRule]:
        """The rules that lay out a served module (FSDP derives them)."""
        return self.rules

    def plan_variables(self, module: Any) -> Any:
        from zookeeper_tpu_torch.parallel.shards import plan_inference

        if self.mesh is None:
            return None
        rules = self._module_rules(module)
        if not rules:
            return None  # every tensor replicates (pure data parallelism)
        plan = plan_inference(module, rules, self._groups, self._model_axes())
        if plan is not None:
            plan.apply_module(module)
        return plan

    def group_of(self, axes: Sequence[str]) -> Any:
        from zookeeper_tpu_torch.parallel.shards import TensorParallel

        if self.mesh is None:
            return None
        members = self._groups.members(axes)
        return TensorParallel(self._groups.group(axes), members.index(distributed.rank()),
                              len(members))

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
    """Turnkey FSDP: a 1-D mesh, the batch and the large weights split over
    the same ``fsdp`` axis (ZeRO-3, ``parallel.rules.auto_fsdp_rules``):
    each rank holds its block of every sharded weight and of its optimizer
    state and EMA, all-gathers the weights before the forward and
    reduce-scatters their gradients. The rules derive from each state's
    parameters on every call; an explicit ``with_rules``, even an empty
    one, wins."""

    mesh_shape: Sequence[int] = Field((-1,))
    mesh_axes: Sequence[str] = Field(("fsdp",))
    data_axes: Sequence[str] = Field(("fsdp",))
    #: Parameters below this many elements replicate (biases, BN).
    min_weight_size: int = Field(2**15)
    #: Regexes over params-relative paths forced to replicate regardless
    #: of size (``auto_fsdp_rules``).
    replicate_patterns: Sequence[str] = Field(())

    def _auto_rules(self, params: Any) -> List[PartitionRule]:
        from zookeeper_tpu_torch.parallel.rules import auto_fsdp_rules

        axis = tuple(self.mesh_axes)[0]
        return auto_fsdp_rules(params, axis_size=self.mesh_sizes[axis], fsdp_axis=axis,
                               min_weight_size=self.min_weight_size,
                               replicate_patterns=tuple(self.replicate_patterns))

    def _module_rules(self, module: Any, plan: Any = None) -> List[PartitionRule]:
        if getattr(self, "_rules_override", None) is not None:
            return self._rules_override
        from zookeeper_tpu_torch.models.convert import flax_state_layouts, unflatten_tree

        tensors = module.state_dict()
        params = {}
        for name, (path, axes) in flax_state_layouts(module).items():
            if path.startswith("params/"):
                shape = (plan.layouts[name].shape if plan is not None and name in plan.layouts
                         else tuple(tensors[name].shape))
                params[path[len("params/"):]] = _Shape(shape[a] for a in axes)
        return self._auto_rules(unflatten_tree(params))

    def _rules_for(self, state: Any) -> List[PartitionRule]:
        return self._module_rules(state.module, getattr(state, "shards", None))

    def _variables_rules(self, variables: Any) -> List[PartitionRule]:
        # Serving under FSDP: the same auto layout, derived from the
        # inference dict's params (suffix-anchored rules, so the tree's
        # paths match like the training state's).
        if getattr(self, "_rules_override", None) is not None:
            return self._rules_override
        return self._auto_rules(variables["params"])


class _Shape:
    """A leaf that has only a ``shape`` (what ``auto_fsdp_rules`` reads)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
