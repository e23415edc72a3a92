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

A TransformerLM tree maps with :func:`from_flax_lm_variables` and its
inverse :func:`to_flax_lm_variables`: ``embed``, ``pos``, ``block{i}``
scopes of ``RMSNorm_0``, ``qkv``, ``proj``, ``RMSNorm_1``, ``up`` and
``down``, and the final ``RMSNorm_0``; each ``nn.Dense`` kernel ``[in,
out]`` becomes a ``weight`` ``[out, in]``.

A training state carries across too: :func:`flax_train_state` and
:func:`load_flax_train_state` move the step, params, ``batch_stats`` and
optax Adam's ``count``/``mu``/``nu`` (whose trees have the params'
structure, so they convert leaf for leaf like the params) between the
port's ``TrainState`` and numpy trees, for QuickNet and for
TransformerLM states (an LM has no ``batch_stats``).
"""

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from zookeeper_tpu_torch.models.transformer import TransformerLMModule

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


_LM_BLOCK = re.compile(r"^block\d+$")
_LM_NORMS = ("RMSNorm_0", "RMSNorm_1")
_LM_DENSES = ("qkv", "proj", "up", "down")


def from_flax_lm_variables(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``TransformerLMModule`` params tree -> the port module's
    ``state_dict`` (CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for scope, leaves in params.items():
        if scope in ("embed", "pos"):
            out[scope] = _tensor(leaves)
        elif scope == "RMSNorm_0":
            out["RMSNorm_0.scale"] = _tensor(leaves["scale"])
        elif _LM_BLOCK.match(scope):
            for name, sub in leaves.items():
                if name in _LM_NORMS:
                    out[f"{scope}.{name}.scale"] = _tensor(sub["scale"])
                elif name in _LM_DENSES:
                    out[f"{scope}.{name}.weight"] = _tensor(sub["kernel"]).t().contiguous()
                else:
                    raise ValueError(f"from_flax_lm_variables: unknown scope {scope}/{name!r}.")
        else:
            raise ValueError(f"from_flax_lm_variables: unknown scope {scope!r}.")
    return out


def to_flax_lm_variables(module: nn.Module) -> Dict[str, Any]:
    """The port LM module's weights as a flax params tree of numpy arrays
    (the inverse of :func:`from_flax_lm_variables`)."""
    return _flax_lm_tree(module.state_dict())


def _flax_lm_tree(named: Mapping[str, Any]) -> Dict[str, Any]:
    """``{state_dict name: tensor}`` of an LM -> a flax params tree."""
    params: Dict[str, Any] = {}
    for name, value in named.items():
        leaf = _tensor(value).numpy()
        parts = name.split(".")
        if parts[0] in ("embed", "pos"):
            params[parts[0]] = leaf
        elif parts == ["RMSNorm_0", "scale"]:
            params["RMSNorm_0"] = {"scale": leaf}
        elif _LM_BLOCK.match(parts[0]) and parts[1] in _LM_NORMS:
            params.setdefault(parts[0], {})[parts[1]] = {"scale": leaf}
        elif _LM_BLOCK.match(parts[0]) and parts[1] in _LM_DENSES:
            params.setdefault(parts[0], {})[parts[1]] = {"kernel": leaf.T.copy()}
        else:
            raise ValueError(f"to_flax_lm_variables: unknown parameter {name!r}.")
    return params


def _flax_param_leaves(scope: str, leaves: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One scope's parameter leaves (state_dict names, numpy) in flax's
    names and layouts."""
    if _CONV.match(scope):
        return {"kernel": leaves["weight"].transpose(2, 3, 1, 0)}
    if _DENSE.match(scope):
        return {"kernel": leaves["weight"].T, "bias": leaves["bias"]}
    if _BN.match(scope):
        return {k: leaves[v] for k, v in _BN_PARAMS.items() if v in leaves}
    if _QUANT.match(scope):
        return dict(leaves)
    raise ValueError(f"to_flax_variables: unknown scope {scope!r}.")


def _by_scope(named: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """``{"Scope.leaf": tensor}`` -> ``{scope: {leaf: numpy}}``, in order."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, value in named.items():
        scope, leaf = name.split(".", 1)
        out.setdefault(scope, {})[leaf] = _tensor(value).numpy()
    return out


def to_flax_variables(module: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port module's weights as flax ``(params, {"batch_stats":
    ...})`` nested dicts of numpy arrays, scopes in module creation
    order (the inverse of :func:`from_flax_variables`)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    for scope, leaves in _by_scope(module.state_dict()).items():
        params[scope] = _flax_param_leaves(scope, leaves)
        if _BN.match(scope):
            stats[scope] = {k: leaves[v] for k, v in _BN_STATS.items()}
    return params, {"batch_stats": stats}


def _is_lm(module: nn.Module) -> bool:
    return isinstance(module, TransformerLMModule)


def _flax_cnn_tree(named: Mapping[str, Any]) -> Dict[str, Any]:
    return {s: _flax_param_leaves(s, v) for s, v in _by_scope(named).items()}


def flax_train_state(state: Any) -> Dict[str, Any]:
    """A port ``TrainState`` as numpy trees in the JAX package's layout:
    ``{"step", "params", "model_state", "adam": {"count", "mu", "nu"}}``
    (the Adam moments as params-shaped trees; ``model_state`` holds the
    ``batch_stats`` of a CNN and is empty for an LM)."""
    if _is_lm(state.module):
        params, model_state, tree = to_flax_lm_variables(state.module), {}, _flax_lm_tree
    else:
        (params, model_state), tree = to_flax_variables(state.module), _flax_cnn_tree
    opt = state.opt_state
    return {
        "step": np.int32(state.step),
        "params": params,
        "model_state": model_state,
        "adam": {
            "count": np.int32(opt["count"]),
            "mu": tree(opt["mu"]),
            "nu": tree(opt["nu"]),
        },
    }


def load_flax_train_state(
    state: Any,
    *,
    step: Any,
    params: Mapping[str, Any],
    model_state: Mapping[str, Any],
    adam: Mapping[str, Any],
) -> Any:
    """Load a JAX train state (numpy trees, as :func:`flax_train_state`
    returns them; ``adam`` holds optax's ``ScaleByAdamState`` leaves) into
    the port's ``TrainState`` in place, on the devices its tensors lie
    on; an LM state's trees go through :func:`from_flax_lm_variables`.
    Returns ``state``."""
    if _is_lm(state.module):
        if model_state:
            raise ValueError(
                f"load_flax_train_state: an LM has no model state, got {sorted(model_state)}."
            )
        convert = from_flax_lm_variables
        state.module.load_state_dict(convert(params))
    else:
        convert = from_flax_variables
        state.module.load_state_dict(convert(params, model_state))
    state.step = int(step)
    opt = state.opt_state
    opt["count"] = int(adam["count"])
    for key in ("mu", "nu"):
        moments = convert(adam[key])
        if set(moments) != set(opt[key]):
            raise ValueError(
                f"load_flax_train_state: Adam {key} leaves {sorted(moments)} "
                f"do not match the model's parameters {sorted(opt[key])}."
            )
        for name, value in moments.items():
            opt[key][name].copy_(value)
    return state
