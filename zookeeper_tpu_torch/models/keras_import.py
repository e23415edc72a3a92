"""Keras/larq checkpoint migration: reference weights into the port.

The port of ``zookeeper_tpu/models/keras_import.py``.
:func:`import_keras_weights` maps a built ``tf.keras`` model's variables
onto a port module by ALIGNED ORDER with strict shape checks: the i-th
weight-bearing Keras layer fills the i-th weight slot of the module's
flax-layout tree (``models/convert.py``; the port creates its layers in
flax's call order), conv kernels HWIO and dense kernels [in, out] on both
sides. A slot is a kernel (``kernel`` or ``kernel_fp``, with an optional
``bias``) or a BatchNorm (``scale``/``bias`` and its running statistics).
Every assignment shape-checks, and leftover slots or layers on either
side, or a leaf that fits no slot (RSign/RPReLU shifts, packed kernels),
are loud errors, so a mismatched architecture cannot import silently.

The one layout exception is ``Conv2DTranspose``: Keras stores its kernel
``(kh, kw, out, in)`` with gradient-of-conv semantics, while the port's
``QuantConvTranspose`` uses JAX's un-flipped ``(kh, kw, in, out)``;
:func:`keras_transpose_kernel` converts, and the import applies it to
every Keras layer of that kind.

The functions take a Keras model object; they never import tensorflow.
"""

from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import numpy as np
from torch import nn

from zookeeper_tpu_torch.models.convert import from_flax_variables, to_flax_variables

__all__ = ["import_keras_weights", "keras_transpose_kernel"]

_KERNEL_KEYS = ("kernel", "kernel_fp")


def keras_transpose_kernel(kernel: np.ndarray) -> np.ndarray:
    """Convert a Keras ``Conv2DTranspose``/``Conv1DTranspose`` kernel
    ``(*spatial, out, in)`` (gradient-of-conv semantics) to the
    ``(*spatial, in, out)`` un-flipped convention."""
    kernel = np.asarray(kernel)
    flipped = np.flip(kernel, axis=tuple(range(kernel.ndim - 2)))
    return np.swapaxes(flipped, -1, -2)


def _slots(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]]) -> List[dict]:
    """Ordered weight slots of a flax-layout params tree: kernel slots
    (with an optional bias) and BN slots (scale/bias and the running
    statistics). A leaf that fits neither raises."""
    slots: List[dict] = []
    unmapped: List[str] = []

    def visit(node, stats_node, path):
        if not isinstance(node, Mapping):
            unmapped.append(path)
            return
        kernel_key = next((k for k in _KERNEL_KEYS if k in node), None)
        if kernel_key is not None:
            unmapped.extend(f"{path}/{k}" for k in sorted(set(node) - {kernel_key, "bias"}))
            slots.append({"kind": "kernel", "path": path, "node": node,
                          "kernel_key": kernel_key})
            return
        if "scale" in node and "bias" in node:
            unmapped.extend(f"{path}/{k}" for k in sorted(set(node) - {"scale", "bias"}))
            slots.append({"kind": "bn", "path": path, "node": node,
                          "stats": stats_node if isinstance(stats_node, Mapping) else None})
            return
        for key, child in node.items():
            visit(child, (stats_node or {}).get(key) if stats_node else None,
                  f"{path}/{key}" if path else key)

    visit(params, batch_stats, "")
    if unmapped:
        raise ValueError(
            "Params tree has leaves the order-aligned Keras import cannot "
            f"map (not conv/dense kernels or BatchNorm scale/bias): "
            f"{unmapped[:8]}{'...' if len(unmapped) > 8 else ''}. Models "
            "with custom learnables (e.g. RSign/RPReLU shifts) or packed "
            "deployment params need a hand-written mapping."
        )
    return slots


def _assign(node: Dict[str, Any], key: str, value: Any, what: str) -> None:
    template = node[key]
    value = np.asarray(value)
    if tuple(template.shape) != tuple(value.shape):
        raise ValueError(
            f"{what}: keras weight shape {tuple(value.shape)} does not match "
            f"template {tuple(template.shape)}."
        )
    node[key] = value.astype(template.dtype)


def import_keras_weights(keras_model: Any, module: nn.Module) -> nn.Module:
    """Load a built Keras model's weights into the port ``module`` in
    place (on the devices its tensors lie on) and return it. Raises with
    both sides named on any count or shape mismatch; the module is left
    untouched then."""
    params, state = to_flax_variables(module)
    slots = _slots(params, state.get("batch_stats"))
    slot_iter = iter(slots)
    for layer in keras_model.layers:
        weights = layer.get_weights()
        if not weights:
            continue
        cls = type(layer).__name__
        try:
            slot = next(slot_iter)
        except StopIteration:
            raise ValueError(
                f"Keras layer {layer.name!r} ({cls}) has no remaining "
                "flax weight slot — architectures differ."
            ) from None
        what = f"keras {layer.name!r} ({cls}) -> flax {slot['path']!r}"
        if cls == "BatchNormalization":
            if slot["kind"] != "bn" or len(weights) != 4:
                raise ValueError(
                    f"{what}: expected a BatchNorm slot and 4 weights (gamma, beta, "
                    "moving_mean, moving_var; scale and center enabled), got slot kind "
                    f"{slot['kind']!r} and {len(weights)} weights."
                )
            gamma, beta, mean, var = weights
            _assign(slot["node"], "scale", gamma, what)
            _assign(slot["node"], "bias", beta, what)
            if slot["stats"] is None:
                raise ValueError(f"{what}: the module has no running statistics for "
                                 "this BatchNorm.")
            _assign(slot["stats"], "mean", mean, what)
            _assign(slot["stats"], "var", var, what)
            continue
        if slot["kind"] != "kernel" or len(weights) not in (1, 2):
            raise ValueError(
                f"{what}: expected a kernel slot and 1-2 weights (kernel[, bias]), "
                f"got slot kind {slot['kind']!r} and {len(weights)} weights."
            )
        kernel = weights[0]
        if "Transpose" in cls:
            kernel = keras_transpose_kernel(kernel)
        _assign(slot["node"], slot["kernel_key"], kernel, what)
        if len(weights) == 2:
            if "bias" not in slot["node"]:
                raise ValueError(f"{what}: keras layer has a bias but the flax layer "
                                 "does not (use_bias mismatch).")
            _assign(slot["node"], "bias", weights[1], what)
        elif "bias" in slot["node"]:
            raise ValueError(f"{what}: flax layer has a bias but the keras layer does "
                             "not (use_bias mismatch).")
    leftover = [s["path"] for s in slot_iter]
    if leftover:
        raise ValueError(
            f"Keras model exhausted but flax slots remain: {leftover} — "
            "architectures differ."
        )
    module.load_state_dict(from_flax_variables(params, state))
    return module
