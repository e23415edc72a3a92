"""Sequence parallelism as a config-native Partitioner.

The port of ``zookeeper_tpu/parallel/sequence.py``: the dp x sp
ring-flash LM recipe, the repo's long-context flagship, driven from the
``key=value`` CLI::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m zookeeper_tpu_torch.training TrainLM \\
        partitioner=SequenceParallelPartitioner partitioner.sp=4 ...

:class:`SequenceParallelPartitioner` owns the ``("data", "sp")`` mesh,
gives each rank the rows of its data index and the sequence columns of
its sp index of every global token batch, and injects the selected
sequence-parallel attention into the model through ``prepare_model``.
Ranks of one data index form a ring over their sp group; the model
adds its positional table at the shard's global offset
(:meth:`SequenceParallelAttention.sequence_offset`). Everything between
attention calls is rank-local; the parameters replicate over every rank
of a model index and their gradients are averaged over those ranks.

``tp > 1`` adds a trailing ``model`` axis (rank r at ``(r // (sp * tp),
r // tp % sp, r % tp)``) with ``transformer_tp_rules`` by default: each
block holds its heads' rows of ``qkv`` and ``up`` and the matching
columns of ``proj`` and ``down``, attends over its own heads (the ring
or all-to-all then runs at ``heads / tp``) and sums the row-parallel
outputs over the model group (``models.transformer``).
"""

from typing import Any, List, Sequence, Tuple

from zookeeper_tpu_torch.core import Field, component, configured_field_names
from zookeeper_tpu_torch.parallel.partitioner import BatchSlice, MeshPartitioner
from zookeeper_tpu_torch.parallel.rules import PartitionRule, transformer_tp_rules

#: The attention flavors the ``attention`` Field selects.
SP_ATTENTION_FLAVORS = ("ring_flash", "ring", "ulysses")


class SequenceParallelAttention:
    """The injected attention: ``(q, k, v, *, causal, scale) -> out`` over
    this rank's sequence shard ``[b, s/sp, h, d]``, the partitioner's
    flavor bound to its mesh, and the shard's global position offset."""

    def __init__(self, partitioner: "SequenceParallelPartitioner"):
        self.partitioner = partitioner

    def sequence_offset(self, local_len: int) -> int:
        """The global position of this rank's first token: its sp index
        times the shard length."""
        return self.partitioner.coordinates()["sp"] * int(local_len)

    def __call__(self, q, k, v, *, causal=False, scale=None):
        from zookeeper_tpu_torch.ops import attention as ops

        part = self.partitioner
        mesh = part.mesh
        batch_axis = "data" if q.shape[0] % part.mesh_sizes["data"] == 0 else None
        kw = dict(mesh=mesh, seq_axis="sp", batch_axis=batch_axis, causal=causal, scale=scale)
        if part.attention == "ring_flash":
            return ops.ring_flash_attention(q, k, v, overlap=part.overlap, **kw)
        if part.attention == "ring":
            return ops.ring_attention(q, k, v, overlap=part.overlap, **kw)
        return ops.all_to_all_attention(q, k, v, local_attention=part.ulysses_local, **kw)


@component
class SequenceParallelPartitioner(MeshPartitioner):
    """dp x sp partitioner for sequence-parallel attention models.

    ``sp`` is the sequence-parallel degree (the ring or all-to-all group);
    ``dp`` the data-parallel degree (-1 infers it from the world size).
    Rank r sits at ``(data, sp) = (r // sp, r % sp)``. Batches split as
    ``[batch, seq]`` over ``("data", "sp")`` on the host, so no rank
    copies a global batch to its card; parameters and optimizer state
    replicate over every rank.

    Contract: the model exposes ``set_attention_override`` (the
    TransformerLM family does); the global sequence length divides ``sp``
    and the global batch divides ``dp``. ``tp > 1`` adds the trailing
    ``model`` axis (see the module docstring); ``with_rules`` replaces its
    default ``transformer_tp_rules``.
    """

    #: Sequence-parallel degree; -1 = all ranks not taken by dp/tp.
    sp: int = Field(-1)
    #: Data-parallel degree; -1 = inferred from the world size.
    dp: int = Field(-1)
    #: Tensor-parallel degree over a trailing "model" axis (1 = off).
    tp: int = Field(1)
    #: "ring_flash" (flash kernels inside the ring, the long-context
    #: default), "ring" (dense block compute) or "ulysses" (all-to-all
    #: head re-shard; needs heads % sp == 0).
    attention: str = Field("ring_flash")
    #: Ulysses' per-rank compute: "flash" or "dense".
    ulysses_local: str = Field("flash")
    #: Ring schedule: True issues the next rotation before each block's
    #: compute and waits after it; False rotates after the compute. The
    #: same bits either way.
    overlap: bool = Field(True)

    data_axes: Sequence[str] = Field(("data",))

    def _axes(self):
        ignored = {"mesh_shape", "mesh_axes", "data_axes"} & set(configured_field_names(self))
        if ignored:
            raise ValueError(
                f"SequenceParallelPartitioner derives its mesh from "
                f"sp/dp/tp; the configured {sorted(ignored)} would be "
                "ignored. Set partitioner.sp / partitioner.dp / "
                "partitioner.tp instead (or use MeshPartitioner for an "
                "arbitrary layout)."
            )
        if self.attention not in SP_ATTENTION_FLAVORS:
            raise ValueError(
                f"partitioner.attention={self.attention!r} unknown; "
                f"choose one of {'/'.join(SP_ATTENTION_FLAVORS)}."
            )
        if self.ulysses_local not in ("flash", "dense"):
            raise ValueError(
                f"partitioner.ulysses_local={self.ulysses_local!r} "
                "unknown; choose flash/dense."
            )
        explicit = set(configured_field_names(self))
        if self.attention == "ulysses" and "overlap" in explicit:
            raise ValueError(
                "partitioner.overlap only applies to the ring flavors; "
                "attention=ulysses has no ring schedule to overlap."
            )
        if self.attention != "ulysses" and "ulysses_local" in explicit:
            raise ValueError(
                f"partitioner.ulysses_local only applies to "
                f"attention=ulysses (got attention={self.attention!r})."
            )
        if self.tp < 1:
            raise ValueError(f"tp={self.tp} must be >= 1.")
        if self.sp == 0 or self.sp < -1 or self.dp == 0 or self.dp < -1:
            raise ValueError(
                f"sp={self.sp} / dp={self.dp}: expected a positive "
                "degree or -1 (infer)."
            )
        dp, sp = self.dp, self.sp
        if dp == -1 and sp == -1:
            # Wholly unspecified: everything onto the sequence axis.
            dp = 1
        if self.tp > 1:
            return [dp, sp, self.tp], ["data", "sp", "model"]
        return [dp, sp], ["data", "sp"]

    def _check_axes(self, axes) -> None:
        """The sp axis carries the sequence, not a model shard."""

    @property
    def rules(self) -> List[PartitionRule]:
        override = getattr(self, "_rules_override", None)
        if override is not None:
            return override
        return transformer_tp_rules() if self.tp > 1 else []

    def _model_axes(self) -> Tuple[str, ...]:
        return ("model",) if "model" in self.mesh_sizes else ()

    def _replica_axes(self) -> Tuple[str, ...]:
        return ("data", "sp")

    def _scope(self):
        # No activation scope, as in the JAX package: the sequence-parallel
        # attention owns the sequence-sharded layout.
        return None

    def batch_sharding(self) -> BatchSlice:
        index, count = self._data_share()
        return BatchSlice(index, count, self.coordinates()["sp"], self.mesh_sizes["sp"])

    def attention_callable(self) -> SequenceParallelAttention:
        """The injected attention: the Field-selected flavor bound to this
        partitioner's mesh (see :class:`SequenceParallelAttention`)."""
        self.setup()
        return SequenceParallelAttention(self)

    def prepare_model(self, model: Any) -> None:
        hook = getattr(model, "set_attention_override", None)
        if hook is None:
            raise ValueError(
                f"SequenceParallelPartitioner requires a model with an "
                f"attention-injection seam (set_attention_override); "
                f"{type(model).__name__} has none. Sequence parallelism "
                "shards the sequence dimension of attention — it cannot "
                "apply to the CNN zoo; use DataParallelPartitioner there."
            )
        hook(self.attention_callable())

