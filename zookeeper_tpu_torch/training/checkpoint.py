"""The model-only export: save, load and pick the weights to serve.

The port of ``zookeeper_tpu/training/checkpoint.py``'s ``save_model``,
``load_model``, ``load_exported_model``, ``select_inference_weights``,
``CheckpointUnreadableError`` and ``load_inference_model``, in the
port's own format (no orbax): one ``torch.save`` file of
``{"params": {flax path: tensor}, "model_state": {flax path: tensor}}``,
the "/"-joined flax paths, layouts and dtypes of the JAX package's
export of the same model (``models.convert``: HWIO conv kernels,
``[in, out]`` dense kernels, ``batch_stats/.../mean``). ``save_model``
writes it as ``model.pt`` in the directory it is given (to a temporary
name, then renamed); the loaders take that directory or the file
itself, and read it with ``torch.load(weights_only=True)``. The full
``Checkpointer`` (training states, resume, retention) is not ported yet
(ROADMAP.md): a ``Checkpointer`` directory raises.
"""

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from zookeeper_tpu_torch.models.convert import (
    _flax_lm_tree,
    _is_lm,
    flatten_tree,
    from_flax_lm_variables,
    from_flax_variables,
    to_flax_variables,
    unflatten_tree,
)

#: The file a ``save_model`` directory holds.
EXPORT_FILE = "model.pt"
Flat = Dict[str, torch.Tensor]


class CheckpointUnreadableError(ValueError):
    """No restorable checkpoint bytes at the requested path: nothing
    there, an empty directory, or a file ``torch.load`` cannot read. A
    ``ValueError``, told apart from the configuration errors (a structure
    mismatch, ``weights="ema"`` without an EMA) by its type."""


def _not_ported_checkpointer(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path!r} is a Checkpointer directory (numbered training steps); the "
        "full Checkpointer is not in the PyTorch port yet, it is queued in "
        "ROADMAP.md. Export the model with export_model_to=... instead."
    )


def _torch_tree(tree: Mapping[str, Any]) -> Flat:
    """A nested tree of numpy leaves as ``{path: contiguous CPU tensor}``
    (copies)."""
    return {path: torch.tensor(np.asarray(leaf)) for path, leaf in flatten_tree(tree).items()}


def export_trees(module: nn.Module, params: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Tuple[Flat, Flat]:
    """The module's weights as the export's ``(params, model_state)``:
    ``{flax path: CPU tensor}`` in flax layouts. ``params`` (``{name:
    tensor}``, the EMA) stands in for the module's parameters."""
    named = dict(module.state_dict())
    if params is not None:
        named.update({n: t.detach() for n, t in params.items()})
    if _is_lm(module):
        return _torch_tree(_flax_lm_tree(named)), {}
    flax_params, model_state = to_flax_variables(module, named)
    return _torch_tree(flax_params), _torch_tree(model_state)


def save_model(path: str, params: Mapping[str, torch.Tensor],
               model_state: Mapping[str, torch.Tensor]) -> str:
    """Save a model-only export (parameters and BatchNorm statistics, no
    optimizer state): ``path/model.pt``, replacing an earlier export.
    ``params`` and ``model_state`` are ``{flax path: tensor}``
    (:func:`export_trees`). Returns the file's path."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, EXPORT_FILE)
    tmp = f"{target}.tmp-{os.getpid()}"
    cpu = lambda tree: {k: t.detach().cpu() for k, t in tree.items()}  # noqa: E731
    torch.save({"params": cpu(params), "model_state": cpu(model_state)}, tmp)
    os.replace(tmp, target)
    return target


def _read(path: str) -> Dict[str, Any]:
    path = os.path.abspath(os.path.expanduser(path))
    target = path
    if os.path.isdir(path):
        target = os.path.join(path, EXPORT_FILE)
        if not os.path.isfile(target) and any(
            name.isdigit() and os.path.isdir(os.path.join(path, name))
            for name in os.listdir(path)
        ):
            raise _not_ported_checkpointer(path)
    try:
        restored = torch.load(target, map_location="cpu", weights_only=True)
    except Exception as e:
        raise CheckpointUnreadableError(
            f"No restorable checkpoint at {path!r} (expected a save_model "
            f"export). Original error: {e}"
        ) from e
    if not isinstance(restored, dict) or "params" not in restored:
        raise ValueError(
            f"Checkpoint at {path!r} has no 'params' tree — not a "
            "save_model export."
        )
    return restored


def _structure_mismatch_error(path: str, err: str) -> ValueError:
    return ValueError(
        f"Checkpoint at {path!r} does not match the target model "
        "structure: the restoring model must be built with the SAME "
        "architecture configuration as the exporting run (layer counts, "
        f"features, packed_weights, ...). {err}"
    )


def _check_like(path: str, got: Mapping[str, torch.Tensor], like: Mapping[str, Any],
                what: str) -> None:
    """The paths and each leaf's shape must match the target's (dtypes
    stay lenient: loading casts to the module's)."""
    if set(got) != set(like):
        missing, extra = sorted(set(like) - set(got)), sorted(set(got) - set(like))
        raise _structure_mismatch_error(
            path, f"{what}: missing {missing[:4]}, unexpected {extra[:4]}.")
    bad = [f"{p} {tuple(got[p].shape)} where the model expects {tuple(like[p].shape)}"
           for p in like if tuple(got[p].shape) != tuple(like[p].shape)]
    if bad:
        raise _structure_mismatch_error(
            path, f"{what} leaf shape mismatch: " + "; ".join(bad[:4])
            + (" ..." if len(bad) > 4 else ""))


def select_inference_weights(params: Any, ema_params: Optional[Any], weights: str = "auto"):
    """The one weight-selection policy of serving and eval
    (``ServingConfig.weights``, ``EvalExperiment.weights``): "raw" the
    parameters, "ema" the EMA (an error when absent), "auto" the EMA when
    present, else the parameters."""
    if weights == "raw":
        return params
    if weights == "ema":
        if ema_params is None:
            raise ValueError(
                "weights='ema' but the checkpoint carries no ema_params: "
                "it was trained without ema_decay, or it is a model-only "
                "export (save_model ships ONE set of weights — already "
                "the EMA when the exporting run had ema_decay on). Use "
                "weights='auto' or 'raw'."
            )
        return ema_params
    if weights == "auto":
        return params if ema_params is None else ema_params
    raise ValueError(f"weights={weights!r} unknown; choose auto/ema/raw.")


def load_model(path: str, params_like: Mapping[str, Any], model_state_like: Mapping[str, Any]
               ) -> Tuple[Flat, Flat]:
    """Read a ``save_model`` export, checked against the target's
    ``{flax path: tensor}`` trees (:func:`export_trees` of the built
    model); returns ``(params, model_state)``. A mismatched structure
    raises a clear ``ValueError``."""
    restored = _read(path)
    params, model_state = restored["params"], restored.get("model_state") or {}
    _check_like(path, params, params_like, "params")
    _check_like(path, model_state, model_state_like, "model_state")
    return params, model_state


def load_into_module(module: nn.Module, params: Mapping[str, torch.Tensor],
                     model_state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy export trees into the module's parameters and statistics."""
    if _is_lm(module):
        named = from_flax_lm_variables(unflatten_tree(params))
    else:
        named = from_flax_variables(unflatten_tree(params), unflatten_tree(model_state))
    module.load_state_dict(named)
    return module


def load_exported_model(path: str, module: nn.Module) -> Tuple[Flat, Flat]:
    """Load a ``save_model`` export into a freshly built ``module``,
    checked against its structure: the restore flow of the teacher.
    Returns the trees read."""
    params, model_state = load_model(path, *export_trees(module))
    load_into_module(module, params, model_state)
    return params, model_state


def load_inference_model(path: str, *, weights: str = "auto",
                         params_like: Optional[Mapping[str, Any]] = None,
                         model_state_like: Optional[Mapping[str, Any]] = None,
                         step: Optional[int] = None) -> Tuple[Flat, Flat]:
    """Load the weights to serve or score from a ``save_model`` export,
    EMA or raw as :func:`select_inference_weights` picks them, checked
    against ``params_like``/``model_state_like`` when given. Returns
    ``(params, model_state)`` as ``{flax path: tensor}``. A training
    step of a ``Checkpointer`` directory (``step``) is not ported yet."""
    if step is not None:
        raise _not_ported_checkpointer(path)
    restored = _read(path)
    params = select_inference_weights(restored["params"], restored.get("ema_params"), weights)
    model_state = restored.get("model_state") or {}
    if params_like is not None:
        _check_like(path, params, params_like, "params")
    if model_state_like is not None:
        _check_like(path, model_state, model_state_like, "model_state")
    return params, model_state
