"""Regex partition rules: state path -> PartitionSpec.

The port of ``zookeeper_tpu/parallel/rules.py``: rules are (regex,
PartitionSpec) pairs matched with ``re.search`` against the "/"-joined
flax path of each leaf of a state (``params/QuantConv_0/kernel``,
``model_state/batch_stats/BatchNorm_2/mean``); the first match wins and
an unmatched leaf replicates. The functions and their regexes are the
JAX package's, so a rule table written for it gives every leaf of the
port's state the same spec (``models.convert.flax_state_layouts`` names
the port's tensors by those paths). A spec names flax dimensions;
``parallel.shards`` maps it onto the port's layouts (OIHW fp conv
kernels, ``[out, in]`` dense weights).

:class:`PartitionSpec` is the port's own: a tuple with one entry per
dimension, each an axis name, a tuple of axis names or None (replicated
along that dimension), built as ``PartitionSpec(None, "model")``.
"""

import re
from math import prod
from typing import Any, Dict, List, Mapping, Sequence, Tuple


class PartitionSpec(tuple):
    """How a tensor's dimensions lie over the mesh axes: one entry per
    (leading) dimension, an axis name, a tuple of axis names (the
    dimension split over their product, the first major) or None;
    missing trailing entries replicate."""

    def __new__(cls, *parts):
        # A one-axis tuple is that axis, as JAX normalises it.
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PartitionRule = Tuple[str, PartitionSpec]


def conv_model_tp_rules(model_axis: str = "model") -> List[PartitionRule]:
    """Tensor-parallel rules for the conv model zoo (QuickNet, Bi-Real-Net,
    BinaryNet, SimpleCnn, ResNet): every conv/dense kernel shards its
    output-feature dim over ``model_axis``, per-channel BatchNorm params
    and statistics co-shard on the same axis, depthwise kernels
    replicate (first match wins). In the port each such layer computes
    its output-channel shard and all-gathers the channels before it
    returns (``ops.layers``)."""
    P = PartitionSpec
    return [
        (r"QuantDepthwiseConv_\d+/", P()),
        # Packed binary kernels [kh, kw, ci_words, co]: shard co.
        (r"kernel_packed$", P(None, None, None, model_axis)),
        (r"kernel_scale$", P(model_axis)),
        # HWIO conv kernels: shard output features.
        (r"(QuantConv|Conv)_\d+/kernel$", P(None, None, None, model_axis)),
        # Dense kernels [in, out]: shard out (incl. the classifier head).
        (r"(QuantDense|Dense)_\d+/kernel$", P(None, model_axis)),
        (r"(QuantDense|Dense)_\d+/bias$", P(model_axis)),
        (r"BatchNorm_\d+/(scale|bias)$", P(model_axis)),
        (r"batch_stats/.*/(mean|var)$", P(model_axis)),
    ]


def transformer_tp_rules(model_axis: str = "model") -> List[PartitionRule]:
    """Megatron-style tensor-parallel rules for the TransformerLM family:
    the fused qkv and MLP up projections column-parallel (output features
    over ``model_axis``), the attention output and MLP down projections
    row-parallel (input features over ``model_axis``); embeddings and
    RMSNorm scales replicate. Segment-anchored (``(^|/)``), so a layer
    merely ending in one of these names is not captured."""
    P = PartitionSpec
    return [
        (r"(^|/)(qkv|up)/kernel$", P(None, model_axis)),
        (r"(^|/)(proj|down)/kernel$", P(model_axis, None)),
    ]


def decode_cache_rules(
    data_axes: Sequence[str] = ("data",),
    model_axis: str = None,
) -> List[PartitionRule]:
    """Partition rules for a decode engine's KV-cache state tree: the
    per-layer ``k``/``v`` buffers ``[slots, capacity, heads, head_dim]``
    shard slots over the data axes and heads over ``model_axis`` (when
    there is one, co-sharded with the column-parallel qkv kernel);
    everything else replicates."""
    P = PartitionSpec
    return [
        (r"(^|/)(k|v)$", P(tuple(data_axes), None, model_axis, None)),
    ]


def page_pool_rules(
    data_axes: Sequence[str] = ("data",),
    model_axis: str = None,
) -> List[PartitionRule]:
    """Partition rules for a decode engine's shared page-pool state tree:
    the per-layer ``k``/``v`` pools ``[num_pages, page_size, heads,
    head_dim]`` replicate their pages (any slot may read any page) and
    shard heads over ``model_axis``; the int8 scale arrays ``[num_pages,
    page_size, heads]`` co-shard their heads. ``data_axes`` is accepted
    for signature parity (the q/lengths/table operands shard over it)."""
    P = PartitionSpec
    return [
        (r"(^|/)(k|v)$", P(None, None, model_axis, None)),
        (r"(^|/)(k_scale|v_scale)$", P(None, None, model_axis)),
    ]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested mapping as ``{"a/b/c": leaf}``."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, f"{path}/"))
        else:
            flat[path] = value
    return flat


def auto_fsdp_rules(
    params: Any,
    axis_size: int,
    fsdp_axis: str = "fsdp",
    min_weight_size: int = 2**15,
    replicate_patterns: Sequence[str] = (),
) -> List[PartitionRule]:
    """ZeRO-3-style weight-sharding rules from a params tree (nested
    mappings whose leaves have a ``shape`` in flax layout).

    Each parameter with at least ``min_weight_size`` elements and rank
    >= 2 shards its largest ``axis_size``-divisible dimension over
    ``fsdp_axis`` (ties prefer the trailing dim); everything else
    replicates. ``replicate_patterns`` are regexes over params-relative
    paths forced to replicate. Every param gets its own
    ``(^|/)``-anchored, suffix rule, deepest first, so optimizer moments
    and EMA copies match their parameter's rule and a nested path is
    never captured by a shallower param's rule."""
    replicate_res = [re.compile(p) for p in replicate_patterns]
    rules: List[PartitionRule] = []
    for path, leaf in _flatten(params).items():
        shape = tuple(getattr(leaf, "shape", ()))
        size = prod(shape) if shape else 0
        spec = PartitionSpec()
        forced = any(r.search(path) for r in replicate_res)
        if not forced and size >= min_weight_size and len(shape) >= 2:
            best = None
            for i, d in enumerate(shape):
                if d % axis_size == 0 and (best is None or d >= shape[best]):
                    best = i
            if best is not None:
                spec = PartitionSpec(*[fsdp_axis if i == best else None
                                       for i in range(len(shape))])
        rules.append(((r"(^|/)" + re.escape(path) + "$"), spec))
    rules.sort(key=lambda r: -r[0].count("/"))
    return rules


def spec_for(rules: Sequence[PartitionRule], path: str) -> PartitionSpec:
    """The spec of the first rule whose regex searches ``path``; an
    unmatched path replicates."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return PartitionSpec(*spec)
    return PartitionSpec()


def match_partition_rules(rules: Sequence[PartitionRule], tree: Any) -> Any:
    """Map every leaf of ``tree`` (nested mappings, lists and tuples) to
    the spec of the first rule whose regex searches its "/"-joined path
    (sequence positions as their index); unmatched leaves replicate."""

    def assign(node, path):
        if isinstance(node, Mapping):
            return {k: assign(v, f"{path}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(assign(v, f"{path}{i}/") for i, v in enumerate(node))
        return spec_for(rules, path[:-1])

    return assign(tree, "")
