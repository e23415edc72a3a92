"""Packed-weight deployment: convert a float params tree to packed form.

The port of ``zookeeper_tpu/ops/packed.py``'s converter. It works on the
flax-layout tree (nested dicts of arrays under flax's scope names, as
``models/convert.py`` reads and writes), so a JAX checkpoint and a port
model convert alike. Converted leaves are CPU torch tensors; other
leaves pass through unchanged. :func:`quantized_param_view` maps the
latent sign-read kernels to the values the forward computes with.
"""

import re
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from zookeeper_tpu_torch.ops.binary_compute import (
    pack_conv_kernel,
    pack_dense_kernel,
)
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN, _apply_clip
from zookeeper_tpu_torch.ops.quantizers import get_quantizer

_PACK_SCOPES = {
    re.compile(r"^QuantConv_\d+$"): 4,
    re.compile(r"^QuantDense_\d+$"): 2,
}
_PACKED_SCOPE = re.compile(r"^Quant(Conv|Dense)_\d+$")
_BN_SCOPE = re.compile(r"^BatchNorm_\d+$")


def _f32(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def pack_quantconv_params(
    params: Mapping[str, Any],
    kernel_quantizer: Union[str, Callable] = "ste_sign",
    kernel_clip: bool = True,
    template: Optional[Mapping[str, Any]] = None,
    fold_bn: bool = False,
    batch_stats: Optional[Mapping[str, Any]] = None,
    bn_eps: float = 1e-5,
    fold_order: Optional[Mapping[str, Any]] = None,
) -> Any:
    """Convert a float params tree to the packed-weights structure.

    Every 4-D ``kernel`` under ``QuantConv_*`` and 2-D ``kernel`` under
    ``QuantDense_*`` is quantized (``kernel_quantizer`` after the layer's
    read-time clip) and replaced by ``kernel_packed``/``kernel_scale``.
    ``template`` (the deployment model's params structure) limits packing
    to the layers that declare ``kernel_packed``.

    ``fold_bn=True`` (needs ``batch_stats``) folds each packed layer's
    FOLLOWING BatchNorm — the next scope in creation order — into the
    conv epilogue: ``a = scale/sqrt(var + eps)``, ``kernel_scale *= a``,
    ``bias = a*bias + (shift - mean*a)``; it returns ``(params,
    remaining_batch_stats)``. ``fold_order``: a tree whose key order is
    the creation order, for params whose keys were re-sorted by storage.
    """
    if fold_bn and batch_stats is None:
        raise ValueError(
            "fold_bn=True requires the trained batch_stats (the eval-mode "
            "mean/var being folded)."
        )
    k_q = get_quantizer(kernel_quantizer)
    if k_q is None:
        raise ValueError("pack_quantconv_params requires a kernel quantizer.")
    n_converted = 0

    def convert(node: Any, want_ndim: int, tnode: Any) -> Any:
        nonlocal n_converted
        if not isinstance(node, Mapping):
            return node
        out = {}
        for key, child in node.items():
            child_ndim = want_ndim
            for scope, ndim in _PACK_SCOPES.items():
                if scope.match(key):
                    child_ndim = ndim
            tchild = tnode.get(key) if isinstance(tnode, Mapping) else None
            want_packed = template is None or (
                isinstance(tnode, Mapping) and "kernel_packed" in tnode
            )
            if (
                want_ndim
                and key == "kernel"
                and np.ndim(child) == want_ndim
                and want_packed
            ):
                q = k_q(_apply_clip(_f32(child), kernel_clip))
                pack = pack_conv_kernel if want_ndim == 4 else pack_dense_kernel
                out["kernel_packed"], out["kernel_scale"] = pack(q)
                n_converted += 1
            else:
                out[key] = convert(child, child_ndim, tchild)
        return out

    out = convert(params, 0, template)
    if fold_bn:
        if fold_order is not None:
            out = _reorder_like(out, fold_order)
        out, remaining_stats = _fold_bn_pass(out, batch_stats, bn_eps)
    if template is not None:
        expected = sum(
            1 for path in _flat_keys(template) if path.endswith("kernel_packed")
        )
        if n_converted != expected:
            raise ValueError(
                f"Template declares {expected} packed kernel(s) but "
                f"{n_converted} were converted — the template does not "
                "structurally match the params."
            )
    return (out, remaining_stats) if fold_bn else out


def _reorder_like(tree: Mapping[str, Any], order: Mapping[str, Any]) -> dict:
    """Recursively reorder ``tree``'s keys to ``order``'s key order (keys
    absent from ``order`` keep their position at the end of a level)."""
    ordered = [k for k in order if k in tree]
    ordered += [k for k in tree if k not in order]
    out = {}
    for k in ordered:
        child = tree[k]
        sub_order = order.get(k) if isinstance(order, Mapping) else None
        if isinstance(child, Mapping) and isinstance(sub_order, Mapping):
            out[k] = _reorder_like(child, sub_order)
        else:
            out[k] = child
    return out


def _fold_bn_pass(packed: Mapping[str, Any], batch_stats: Mapping[str, Any], eps: float):
    """Fold each packed layer's following BatchNorm into
    ``kernel_scale``/``bias`` and drop it from params and stats. Raises
    when a packed layer has no following BN over its output width."""

    def walk(node: Mapping[str, Any], stats_node: Mapping[str, Any]):
        keys = list(node)
        out, stats_out, skip = {}, {}, set()
        for i, key in enumerate(keys):
            if key in skip:
                continue
            child = node[key]
            if (
                isinstance(child, Mapping)
                and _PACKED_SCOPE.match(key)
                and "kernel_packed" in child
            ):
                nxt = keys[i + 1] if i + 1 < len(keys) else None
                if nxt is None or not _BN_SCOPE.match(nxt):
                    raise ValueError(
                        f"fold_bn: packed layer {key!r} is not followed by a "
                        f"BatchNorm (next scope: {nxt!r}) — cannot fold."
                    )
                bn = node[nxt]
                bstats = (stats_node or {}).get(nxt)
                if bstats is None:
                    raise ValueError(
                        f"fold_bn: no batch_stats for {nxt!r} — pass the "
                        "trained model_state's batch_stats subtree."
                    )
                co = int(np.shape(child["kernel_scale"])[0])
                bn_c = int(np.shape(bstats["var"])[0])
                if bn_c != co:
                    raise ValueError(
                        f"fold_bn: packed layer {key!r} ({co} output "
                        f"channels) is followed by {nxt!r} over {bn_c} "
                        "channels — that BatchNorm does not normalize this "
                        "conv's output. Cannot fold."
                    )
                var, mean = _f32(bstats["var"]), _f32(bstats["mean"])
                scale = _f32(bn.get("scale", 1.0))
                shift = _f32(bn.get("bias", 0.0))
                # The square root of the fp32 sum, correctly rounded as
                # JAX's is: PyTorch's vectorized fp32 sqrt on the CPU can be
                # one ulp off, and the fp64 root rounds to the exact one.
                a = scale / torch.sqrt((var + eps).double()).float()
                b = shift - mean * a
                folded = dict(child)
                folded["kernel_scale"] = _f32(child["kernel_scale"]) * a
                folded["bias"] = a * _f32(child.get("bias", 0.0)) + b
                out[key] = folded
                skip.add(nxt)
                if isinstance(stats_node, Mapping) and key in stats_node:
                    stats_out[key] = stats_node[key]
            elif isinstance(child, Mapping):
                sub_stats = (
                    (stats_node or {}).get(key)
                    if isinstance(stats_node, Mapping)
                    else None
                )
                out[key], folded_stats = walk(child, sub_stats or {})
                if isinstance(stats_node, Mapping) and key in stats_node:
                    stats_out[key] = folded_stats
            else:
                out[key] = child
                if isinstance(stats_node, Mapping) and key in stats_node:
                    stats_out[key] = stats_node[key]
        if isinstance(stats_node, Mapping):
            for key, sval in stats_node.items():
                if key not in stats_out and key not in skip and key not in node:
                    stats_out[key] = sval
        return out, stats_out

    return walk(packed, batch_stats)


def quantized_param_view(
    params: Mapping[str, Any],
    kernel_quantizer: Union[str, Callable] = "ste_sign",
    kernel_clip: bool = True,
) -> dict:
    """A params tree whose latent sign-read kernels (the paths matching
    ``BINARY_KERNEL_PATTERN``, "/"-joined flax scope names) are replaced
    by the values the forward computes with, ``quantizer(clip(latent))``
    as CPU float32 tensors; every other leaf passes through unchanged
    (larq's ``quantized_scope``, as a tree transform)."""
    k_q = get_quantizer(kernel_quantizer)
    if k_q is None:
        raise ValueError("quantized_param_view requires a kernel quantizer.")
    pattern = re.compile(BINARY_KERNEL_PATTERN)

    def walk(node: Mapping[str, Any], prefix: str) -> dict:
        out = {}
        for key, child in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(child, Mapping):
                out[key] = walk(child, path)
            elif pattern.search(path):
                out[key] = k_q(_apply_clip(_f32(child), kernel_clip))
            else:
                out[key] = child
        return out

    return walk(params, "")


def _flat_keys(tree: Mapping[str, Any], prefix: str = ""):
    for key, child in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(child, Mapping):
            yield from _flat_keys(child, path)
        else:
            yield path
