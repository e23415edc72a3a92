"""Carry weights between a flax variables tree and the port's modules.

A JAX/flax QuickNet tree — nested dicts of arrays under flax's
auto-numbered scopes (``Conv_i``, ``BatchNorm_i``, ``QuantConv_i``,
``Dense_0``) — maps to the port's ``state_dict`` by name, since the
port's modules carry the same names in the same order. Layouts change
only where PyTorch holds a weight differently: fp conv kernels HWIO ->
OIHW (grouped convs included) and the dense kernel [in, out] -> [out,
in]. BN ``scale``/``bias`` become ``weight``/``bias`` and ``batch_stats``
``mean``/``var`` become ``running_mean``/``running_var``. QuantConv
leaves (``kernel``, ``kernel_packed``, ``kernel_scale``, ``bias``) keep
the JAX layout. A folded BN (deployment with ``fold_bn``) has no
parameters and maps to nothing. Conversion is in memory only.
"""

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_CONV = re.compile(r"^Conv_\d+$")
_BN = re.compile(r"^BatchNorm_\d+$")
_DENSE = re.compile(r"^Dense_\d+$")
_QUANT = re.compile(r"^QuantConv_\d+$")

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def from_flax_variables(
    params: Mapping[str, Any], model_state: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``model_state`` holding ``batch_stats``) ->
    the port's ``state_dict`` (CPU tensors; load with
    ``module.load_state_dict``)."""
    stats = dict((model_state or {}).get("batch_stats", {}))
    out: Dict[str, torch.Tensor] = {}
    for scope, leaves in params.items():
        if _CONV.match(scope):
            out[f"{scope}.weight"] = _tensor(leaves["kernel"]).permute(3, 2, 0, 1).contiguous()
        elif _DENSE.match(scope):
            out[f"{scope}.weight"] = _tensor(leaves["kernel"]).t().contiguous()
            out[f"{scope}.bias"] = _tensor(leaves["bias"])
        elif _BN.match(scope):
            for flax_name, name in _BN_PARAMS.items():
                out[f"{scope}.{name}"] = _tensor(leaves[flax_name])
        elif _QUANT.match(scope):
            for name, leaf in leaves.items():
                out[f"{scope}.{name}"] = _tensor(leaf)
        else:
            raise ValueError(f"from_flax_variables: unknown scope {scope!r}.")
    for scope, leaves in stats.items():
        if not _BN.match(scope):
            raise ValueError(f"from_flax_variables: unknown stats scope {scope!r}.")
        for flax_name, name in _BN_STATS.items():
            out[f"{scope}.{name}"] = _tensor(leaves[flax_name])
    return out


def to_flax_variables(module: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port module's weights as flax ``(params, {"batch_stats":
    ...})`` nested dicts of numpy arrays, scopes in module creation
    order (the inverse of :func:`from_flax_variables`)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    for scope, child in module.named_children():
        leaves = {k: v.detach().cpu().numpy() for k, v in child.state_dict().items()}
        if _CONV.match(scope):
            params[scope] = {"kernel": leaves["weight"].transpose(2, 3, 1, 0)}
        elif _DENSE.match(scope):
            params[scope] = {"kernel": leaves["weight"].T, "bias": leaves["bias"]}
        elif _BN.match(scope):
            params[scope] = {k: leaves[v] for k, v in _BN_PARAMS.items()}
            stats[scope] = {k: leaves[v] for k, v in _BN_STATS.items()}
        elif _QUANT.match(scope):
            params[scope] = leaves
        else:
            raise ValueError(f"to_flax_variables: unknown scope {scope!r}.")
    return params, {"batch_stats": stats}
