"""Carry weights between a flax variables tree and the port's modules.

A JAX/flax tree of the CNN zoo — nested dicts of arrays under flax's
auto-numbered scopes — maps to the port's ``state_dict`` by name, since
the port's modules carry the same names in the same order. Layer scopes
are ``Conv_i``, ``BatchNorm_i``, ``Dense_i``, ``QuantConv_i``,
``QuantDense_i`` (and every other ``Quant*_i`` that holds leaves:
``QuantConvTranspose_0``, ``QuantLocallyConnected2D_0``), ``RSign_i`` and
``RPReLU_i``; any other ``Name_i`` scope, and a scope of scopes, is a
block (``_BiRealBlock_3``, ``_MeliusDenseBlock_0``,
``QuantDepthwiseConv_0``) and is walked into, its layers' names joined with dots
(``_BiRealBlock_3.QuantConv_0.kernel``). Layouts change only where
PyTorch holds a weight differently: fp conv kernels HWIO -> OIHW
(grouped convs included) and the dense kernel [in, out] -> [out, in]. BN
``scale``/``bias`` become ``weight``/``bias`` and ``batch_stats``
``mean``/``var`` become ``running_mean``/``running_var``. Quant* leaves
(``kernel`` or ``kernel_fp``, ``kernel_packed``, ``kernel_scale``,
``bias``) and the RSign/RPReLU leaves (``alpha``; ``gamma``, ``zeta``,
``beta``) keep the JAX layout. A folded BN (deployment with ``fold_bn``)
has no parameters and maps to nothing. Conversion is in memory only.

A TransformerLM tree maps with :func:`from_flax_lm_variables` and its
inverse :func:`to_flax_lm_variables`: ``embed``, ``pos``, ``block{i}``
scopes of ``RMSNorm_0``, ``qkv``, ``proj``, ``RMSNorm_1``, ``up`` and
``down``, and the final ``RMSNorm_0``; each ``nn.Dense`` kernel ``[in,
out]`` becomes a ``weight`` ``[out, in]``.

A training state carries across too: :func:`flax_train_state` and
:func:`load_flax_train_state` move the step, params, ``batch_stats``,
the parameter EMA (``ema_params``) and the optimizer state between the
port's ``TrainState`` and numpy trees, for the CNN zoo and for
TransformerLM states (an LM has no ``batch_stats``). The optimizer state
keeps optax's names: Adam's ``count``/``mu``/``nu`` under ``adam``, any
other optimizer's state (Bop's ``gradient_memory`` and ``count`` under
``binary``, its fp optimizer's under ``fp``; ``trace``; ``MultiSteps``'
``mini_step``, ``gradient_step``, ``acc_grads`` and ``inner_opt_state``)
under ``opt_state``. Its per-parameter trees have the params' structure
(or a part of it: each side of Bop's split holds its own leaves) and
convert leaf for leaf like the params. :func:`flax_param_paths` names
each parameter's flax path ("/"-joined), and :func:`flatten_tree` /
:func:`unflatten_tree` move between nested trees and such paths.

A sharded state (``TrainState.shards``, ``parallel.shards``) converts as
the global state it is a block of: :func:`flax_train_state` gathers every
block (collectives: every rank calls it), the head-aligned ``qkv`` rows
included, so the trees are the JAX package's layout under every
partitioner; :func:`load_flax_train_state` keeps each rank's block.
:func:`flax_state_layouts` names every tensor's flax state path and
which port dimension each flax dimension is, what a partition rule is
matched against and mapped through.
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
#: Layers whose leaves keep the flax names and layouts (every Quant*
#: layer that holds its own leaves; one that wraps others, as
#: ``QuantDepthwiseConv_0`` wraps ``QuantConv_0``, is walked into).
_AS_IS = re.compile(r"^(Quant[A-Za-z0-9]*|RSign|RPReLU)_\d+$")
#: A block scope (a flax submodule holding layers), walked into.
_BLOCK = re.compile(r"^_?[A-Za-z][A-Za-z0-9]*_\d+$")

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _is_layer(scope: str, leaves: Any) -> bool:
    if isinstance(leaves, Mapping) and any(isinstance(v, Mapping) for v in leaves.values()):
        return False  # a scope of scopes: a block
    return any(p.match(scope) for p in (_CONV, _BN, _DENSE, _AS_IS))


def _port_param_leaves(scope: str, leaves: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One layer scope's flax parameter leaves in the port's names and
    layouts."""
    if _CONV.match(scope):
        out = {"weight": _tensor(leaves["kernel"]).permute(3, 2, 0, 1).contiguous()}
        if "bias" in leaves:
            out["bias"] = _tensor(leaves["bias"])
        return out
    if _DENSE.match(scope):
        return {"weight": _tensor(leaves["kernel"]).t().contiguous(),
                "bias": _tensor(leaves["bias"])}
    if _BN.match(scope):
        return {name: _tensor(leaves[flax_name]) for flax_name, name in _BN_PARAMS.items()}
    return {name: _tensor(leaf) for name, leaf in leaves.items()}


def _walk(tree: Mapping[str, Any], what: str, layer_fn, prefix: str = ""):
    """``layer_fn(scope, leaves)`` of every layer scope of a flax tree,
    walking into block scopes; yields ``("Block.Layer", its dict)``."""
    for scope, leaves in tree.items():
        if _is_layer(scope, leaves):
            yield f"{prefix}{scope}", layer_fn(scope, leaves)
        elif _BLOCK.match(scope) and isinstance(leaves, Mapping):
            yield from _walk(leaves, what, layer_fn, f"{prefix}{scope}.")
        else:
            raise ValueError(f"{what}: unknown scope {prefix}{scope!r}.")


def from_flax_variables(
    params: Mapping[str, Any], model_state: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``model_state`` holding ``batch_stats``) ->
    the port's ``state_dict`` (CPU tensors; load with
    ``module.load_state_dict``)."""
    stats = (model_state or {}).get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for path, leaves in _walk(params, "from_flax_variables", _port_param_leaves):
        out.update({f"{path}.{name}": leaf for name, leaf in leaves.items()})

    def bn_stats(scope: str, leaves: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        if not _BN.match(scope):
            raise ValueError(f"from_flax_variables: unknown stats scope {scope!r}.")
        return {name: _tensor(leaves[flax_name]) for flax_name, name in _BN_STATS.items()}

    for path, leaves in _walk(stats, "from_flax_variables", bn_stats):
        out.update({f"{path}.{name}": leaf for name, leaf in leaves.items()})
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


def _numpy(value: Any) -> np.ndarray:
    return _tensor(value).numpy()


def _flax_lm_tree(named: Mapping[str, Any], leaf_fn=_numpy) -> Dict[str, Any]:
    """``{state_dict name: tensor}`` of an LM -> a flax params tree, each
    tensor through ``leaf_fn`` (numpy by default)."""
    params: Dict[str, Any] = {}
    for name, value in named.items():
        leaf = leaf_fn(value)
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
    """One layer scope's parameter leaves (state_dict names, numpy) in
    flax's names and layouts."""
    if _CONV.match(scope):
        out = {"kernel": leaves["weight"].transpose(2, 3, 1, 0)}
        if "bias" in leaves:
            out["bias"] = leaves["bias"]
        return out
    if _DENSE.match(scope):
        return {"kernel": leaves["weight"].T, "bias": leaves["bias"]}
    if _BN.match(scope):
        return {k: leaves[v] for k, v in _BN_PARAMS.items() if v in leaves}
    if _AS_IS.match(scope):
        return dict(leaves)
    raise ValueError(f"to_flax_variables: unknown scope {scope!r}.")


def _by_layer(named: Mapping[str, Any], leaf_fn=_numpy) -> Dict[Tuple[str, ...], Dict[str, Any]]:
    """``{"Block.Layer.leaf": tensor}`` -> ``{("Block", "Layer"): {leaf:
    leaf_fn(tensor)}}`` (numpy by default), in order."""
    out: Dict[Tuple[str, ...], Dict[str, Any]] = {}
    for name, value in named.items():
        *path, leaf = name.split(".")
        out.setdefault(tuple(path), {})[leaf] = leaf_fn(value)
    return out


def _nest(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for scope in path[:-1]:
        tree = tree.setdefault(scope, {})
    tree[path[-1]] = value


def to_flax_variables(
    module: nn.Module, named: Optional[Mapping[str, Any]] = None, leaf_fn=_numpy
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port module's weights as flax ``(params, {"batch_stats":
    ...})`` nested dicts of numpy arrays (each tensor through
    ``leaf_fn``), scopes in module creation order (the inverse of
    :func:`from_flax_variables`). ``named`` (a ``state_dict``-like
    mapping) stands in for the module's tensors."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for path, leaves in _by_layer(module.state_dict() if named is None else named,
                                  leaf_fn).items():
        _nest(params, path, _flax_param_leaves(path[-1], leaves))
        if _BN.match(path[-1]):
            _nest(stats, path, {k: leaves[v] for k, v in _BN_STATS.items()})
    return params, {"batch_stats": stats}


def _is_lm(module: nn.Module) -> bool:
    return isinstance(module, TransformerLMModule)


def _flax_cnn_tree(named: Mapping[str, Any], leaf_fn=_numpy) -> Dict[str, Any]:
    """``{state_dict name: tensor}`` of a CNN -> a flax params tree (the
    BatchNorm statistics left out), each tensor through ``leaf_fn``."""
    tree: Dict[str, Any] = {}
    for path, leaves in _by_layer(named, leaf_fn).items():
        _nest(tree, path, _flax_param_leaves(path[-1], leaves))
    return tree


def flax_param_tree(module: nn.Module, leaf_fn=_numpy) -> Dict[str, Any]:
    """The module's parameters (no BatchNorm statistics) as a flax params
    tree, each tensor through ``leaf_fn`` (numpy by default; a shape
    stand-in reads a module built on the ``meta`` device)."""
    tree = _flax_lm_tree if _is_lm(module) else _flax_cnn_tree
    return tree(module.state_dict(), leaf_fn)


class _Layout:
    """A tensor's stand-in in a flax tree: the port's name for it and, for
    each flax dimension, the port dimension it is (``axes``). It passes
    through the layout changes as the tensor would (``transpose``, ``.T``),
    so the tree maps each flax path to the port's name and dimensions."""

    def __init__(self, name: str, axes: Tuple[int, ...]):
        self.name, self.axes = name, tuple(axes)

    def transpose(self, *axes):
        return _Layout(self.name, tuple(self.axes[a] for a in axes))

    @property
    def T(self):
        return _Layout(self.name, self.axes[::-1])

    def copy(self):
        return self


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested tree as ``{"a/b/c": leaf}``."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, f"{path}/"))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` as a nested tree (the inverse of
    :func:`flatten_tree`)."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        _nest(tree, tuple(path.split("/")), value)
    return tree


def flax_param_paths(module: nn.Module) -> Dict[str, str]:
    """``{parameter name: its "/"-joined flax path}`` (``QuantConv_3.kernel``
    -> ``QuantConv_3/kernel``, ``BatchNorm_0.weight`` ->
    ``BatchNorm_0/scale``), from :func:`flax_param_tree`'s naming."""
    named = {n: _Layout(n, tuple(range(p.dim()))) for n, p in module.named_parameters()}
    tree = (_flax_lm_tree if _is_lm(module) else _flax_cnn_tree)(named, lambda x: x)
    return {leaf.name: path for path, leaf in flatten_tree(tree).items()}


def flax_state_layouts(module: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """``{state_dict name: (flax state path, axes)}`` for every tensor of
    the module: parameters (and the packed kernels a deployed layer holds
    as buffers) under ``params/``, BatchNorm statistics under
    ``model_state/batch_stats/`` (``.../mean``, ``.../var``), the paths a
    JAX ``TrainState`` gives the same leaves. ``axes[i]`` is the port
    dimension of flax dimension ``i`` (an OIHW conv weight: ``(2, 3, 1,
    0)``), what maps a ``PartitionSpec`` over flax dimensions onto the
    port's tensor."""
    named = {n: _Layout(n, tuple(range(t.dim()))) for n, t in module.state_dict().items()}
    lm = _is_lm(module)
    tree = (_flax_lm_tree if lm else _flax_cnn_tree)(named, lambda x: x)
    out = {leaf.name: (f"params/{path}", leaf.axes) for path, leaf in flatten_tree(tree).items()}
    if not lm:
        for path, leaves in _by_layer(named, lambda x: x).items():
            if _BN.match(path[-1]):
                for flax_name, name in _BN_STATS.items():
                    leaf = leaves[name]
                    out[leaf.name] = ("model_state/batch_stats/" + "/".join(path)
                                      + f"/{flax_name}", leaf.axes)
    return out


#: The optimizer-state keys that hold a tree shaped like (part of) the
#: params, and those that hold a count (``training.optimizer.COUNT_KEYS``).
_PER_PARAM = ("mu", "nu", "trace", "gradient_memory", "acc_grads")
COUNT_KEYS = ("count", "mini_step", "gradient_step")


def _opt_to_flax(opt: Mapping[str, Any], tree) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in opt.items():
        if key in _PER_PARAM:
            out[key] = tree(value)
        elif key in COUNT_KEYS:
            out[key] = np.int32(int(value))
        else:
            out[key] = _opt_to_flax(value, tree)
    return out


def _opt_from_flax(opt: Dict[str, Any], flax: Mapping[str, Any], convert, where: str) -> None:
    if set(opt) != set(flax):
        raise ValueError(
            f"load_flax_train_state: optimizer state {where or '/'} holds "
            f"{sorted(flax)}, the port's {sorted(opt)}."
        )
    for key, value in opt.items():
        if key in _PER_PARAM:
            leaves = convert(flax[key])
            if set(leaves) != set(value):
                raise ValueError(
                    f"load_flax_train_state: {where}{key} leaves {sorted(leaves)} "
                    f"do not match the model's parameters {sorted(value)}."
                )
            for name, t in leaves.items():
                value[name].copy_(t)
        elif key in COUNT_KEYS:
            if isinstance(value, torch.Tensor):
                value.fill_(int(flax[key]))
            else:
                opt[key] = int(flax[key])
        else:
            _opt_from_flax(value, flax[key], convert, f"{where}{key}/")


def _is_adam(opt: Mapping[str, Any]) -> bool:
    return set(opt) == {"count", "mu", "nu"}


def flax_train_state(state: Any) -> Dict[str, Any]:
    """A port ``TrainState`` as numpy trees in the JAX package's layout:
    ``{"step", "params", "model_state"}``, then ``"adam": {"count", "mu",
    "nu"}`` (the Adam moments as params-shaped trees) for an Adam state or
    ``"opt_state"`` (optax's names, see the module docstring) for any
    other, and ``"ema_params"`` when the state keeps the EMA.
    ``model_state`` holds the ``batch_stats`` of a CNN and is empty for an
    LM. A sharded state's blocks are gathered first."""
    named, opt, ema = dict(state.module.state_dict()), state.opt_state, state.ema_params
    if getattr(state, "shards", None) is not None:
        full = state.shards.gather_tree({"module": named, "opt_state": opt, "ema_params": ema})
        named, opt, ema = full["module"], full["opt_state"], full["ema_params"]
    if _is_lm(state.module):
        params, model_state, tree = _flax_lm_tree(named), {}, _flax_lm_tree
    else:
        (params, model_state), tree = to_flax_variables(state.module, named), _flax_cnn_tree
    out = {
        "step": np.int32(state.step),
        "params": params,
        "model_state": model_state,
        ("adam" if _is_adam(opt) else "opt_state"): _opt_to_flax(opt, tree),
    }
    if ema is not None:
        out["ema_params"] = tree(ema)
    return out


def load_flax_train_state(
    state: Any,
    *,
    step: Any,
    params: Mapping[str, Any],
    model_state: Mapping[str, Any],
    adam: Optional[Mapping[str, Any]] = None,
    opt_state: Optional[Mapping[str, Any]] = None,
    ema_params: Optional[Mapping[str, Any]] = None,
) -> Any:
    """Load a JAX train state (numpy trees, as :func:`flax_train_state`
    returns them: ``adam`` holds optax's ``ScaleByAdamState`` leaves,
    ``opt_state`` any other optimizer's state under optax's names) into
    the port's ``TrainState`` in place, on the devices its tensors lie
    on; an LM state's trees go through :func:`from_flax_lm_variables`.
    ``ema_params`` fills the state's EMA, which must exist. A sharded
    state keeps this rank's block of each tensor. Returns ``state``."""
    plan = getattr(state, "shards", None)
    if _is_lm(state.module):
        if model_state:
            raise ValueError(
                f"load_flax_train_state: an LM has no model state, got {sorted(model_state)}."
            )
        to_port = from_flax_lm_variables
        named = to_port(params)
    else:
        to_port = from_flax_variables
        named = to_port(params, model_state)
    if plan is not None:
        def convert(tree):
            return {n: plan.shard(n, t) for n, t in to_port(tree).items()}
        named = {n: plan.shard(n, t) for n, t in named.items()}
    else:
        convert = to_port
    state.module.load_state_dict(named)
    state.step = int(step)
    if (adam is None) == (opt_state is None):
        raise ValueError("load_flax_train_state: pass exactly one of adam= and opt_state=.")
    _opt_from_flax(state.opt_state, adam if adam is not None else opt_state, convert, "")
    if ema_params is not None:
        if state.ema_params is None:
            raise ValueError(
                "load_flax_train_state: ema_params given but the state keeps no "
                "EMA; build it with TrainState.create(..., ema=True)."
            )
        leaves = convert(ema_params)
        if set(leaves) != set(state.ema_params):
            raise ValueError(
                f"load_flax_train_state: ema_params leaves {sorted(leaves)} do not "
                f"match the model's parameters {sorted(state.ema_params)}."
            )
        for name, t in leaves.items():
            state.ema_params[name].copy_(t)
    return state
