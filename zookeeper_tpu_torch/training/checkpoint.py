"""Checkpoint and resume, and the model-only export.

The port of ``zookeeper_tpu/training/checkpoint.py`` in the port's own
format (no orbax):

- :class:`Checkpointer`: the training state saved on a step or epoch
  cadence and restored for an exact resume. Each step is a directory
  ``<directory>/<step>/`` holding ``state.pt`` (one ``torch.save`` of the
  module's ``state_dict``, every optimizer's state with its counts, the
  EMA and the host ``step``, read back with ``weights_only=True``) and
  ``metrics.json`` (the step's metrics, which ``keep_best_metric``
  ranks). A step is written under a temporary name in the same
  directory (``<step>.tmp-<pid>-<n>``), its files and the directory are
  fsynced, and ``os.rename`` finalizes it, so a bare numbered directory
  is always a finalized step; listings ignore the remnants of writes
  that died, and the next save's retention removes them. In async mode
  the training thread only takes the device-to-host snapshot
  (:func:`host_snapshot`) and a background writer
  (``training.async_checkpoint``) writes it. ``restore_state`` walks the
  retained steps of both tiers newest first and copies the first that
  reads into the built state's own tensors.
- ``save_model`` / ``load_model`` / ``load_exported_model``: the
  model-only export, one ``torch.save`` file of ``{"params": {flax path:
  tensor}, "model_state": {flax path: tensor}}``, the "/"-joined flax
  paths, layouts and dtypes of the JAX package's export of the same
  model (``models.convert``: HWIO conv kernels, ``[in, out]`` dense
  kernels, ``batch_stats/.../mean``). ``save_model`` writes it as
  ``model.pt`` in the directory it is given (to a temporary name, then
  renamed).
- ``load_inference_model``: the weights to serve or score, from either
  an export or a ``Checkpointer`` directory (its latest step, or
  ``step=``), as the same ``{flax path: tensor}`` trees.

Under data or sequence parallelism (:meth:`Checkpointer.set_replicas`)
the state is replicated: rank 0 writes it and every rank passes a
barrier after the rename (a sync save) or after the writer drains
(``wait``), so every rank restores the same step. A sharded state
(``state.shards``) is gathered by every rank before rank 0 writes it, so
the file holds the global tensors in the format above (the ``qkv`` rows
in their global order) under every partitioner, and a restore keeps
each rank's block of them.

The per-host sharded protocol (``sharded_per_host``, the JAX package's
on-disk layout): on a run of several processes each process writes only
its own blocks of the state (a replicated tensor whole), as raw bytes
and an index manifest, into ``<directory>/<step>.zkhost/host_<pid>/``
(``data.npz`` of uint8 arrays, ``manifest.json``), written under a
temporary name and finalized by rename; process 0 writes the step's
``COMMIT.json`` only once every host's directory is there (within
``host_commit_timeout_s``). A step without a commit record does not
exist for a restore, so a group save torn on one host is never half
restored. ``restore_state`` walks committed steps with the others and,
across processes, agrees on the step through a ``FileCoordinator``
(``resilience.coordination``): a step any host finds torn is skipped by
every host. No collective runs in this mode's save or restore. A block
of a dimension split with interleave ``k > 1`` (the head-aligned
``qkv``) is recorded in the ``[k, members, rest]`` view of its global
shape, so every block is a box; readers that need the global tensor
(a one-process restore of a group's step, ``load_inference_model``)
fold it back in the order ``ShardPlan.gather`` gives. At
``process_count == 1`` the mode is the layout above, byte for byte.

Observability (``observability.trace``, one flag check each while
tracing is off), keyed by the step as the JAX package's: the spans
``ckpt_snapshot`` (the async snapshot, or the per-host extraction) and
``ckpt_sync_save`` around a save, ``restore_step`` around each read;
the events ``restore_skip{tier, reason}`` and ``restore_done{tier}`` of
the restore walk; under the per-host protocol the gauge
``zk_ckpt_host_finalized{pid}`` and the events ``ckpt_host_finalized``,
``ckpt_group_committed`` and ``ckpt_group_commit_abandoned``.
"""

import itertools
import json
import logging
import os
import random
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.convert import (
    COUNT_KEYS,
    _flax_lm_tree,
    _is_lm,
    flatten_tree,
    from_flax_lm_variables,
    from_flax_variables,
    to_flax_variables,
    unflatten_tree,
)
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import default_registry
from zookeeper_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)

#: The file a ``save_model`` directory holds.
EXPORT_FILE = "model.pt"
#: The files of a ``Checkpointer`` step directory.
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
#: Walk order among tiers holding the same step: the per-host sharded
#: local tier (this host reads its own files), the local tier, then the
#: durable ones.
_TIER_PRIORITY = {"hosts": 3, "local": 2, "hosts-durable": 1, "durable": 0}
#: The per-host payload's marker (``_write_state`` routes it).
_HOST_SHARD_KIND = "zkhost-shards-v1"
#: Suffix of a per-host sharded step directory: not a bare step number, so
#: the bare layout's listings never see it.
_HOST_STEP_SUFFIX = ".zkhost"
_KEYSTR_SEGMENT_RE = re.compile(r"\['([^']*)'\]")
#: A step written under its temporary name, not yet finalized.
_REMNANT = re.compile(r"^\d+\.tmp-")
Flat = Dict[str, torch.Tensor]


class CheckpointUnreadableError(ValueError):
    """No restorable checkpoint bytes at the requested path: nothing
    there, an empty directory, or a file ``torch.load`` cannot read. A
    ``ValueError``, told apart from the configuration errors (a structure
    mismatch, ``weights="ema"`` without an EMA) by its type."""


class _BFloat16Bits(np.ndarray):
    """A bfloat16 tensor's bits as int16 (numpy has no bfloat16); the flax
    layouts' transposes keep the type, so the bits come back as bfloat16."""


def _leaf_numpy(t: Any) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BFloat16Bits)
    return t.numpy()


def _torch_tree(tree: Mapping[str, Any]) -> Flat:
    """A nested tree of numpy leaves as ``{path: contiguous CPU tensor}``
    (copies; a :class:`_BFloat16Bits` leaf as bfloat16)."""
    out = {}
    for path, leaf in flatten_tree(tree).items():
        t = torch.tensor(np.asarray(leaf))
        out[path] = t.view(torch.bfloat16) if isinstance(leaf, _BFloat16Bits) else t
    return out


def export_trees(module: nn.Module, params: Optional[Mapping[str, torch.Tensor]] = None,
                 shards: Any = None) -> Tuple[Flat, Flat]:
    """The module's weights as the export's ``(params, model_state)``:
    ``{flax path: CPU tensor}`` in flax layouts. ``params`` (``{name:
    tensor}``, the EMA) stands in for the module's parameters. ``shards``
    (a sharded state's plan) gathers the global tensors first: every rank
    calls it."""
    named = dict(module.state_dict())
    if params is not None:
        named.update({n: t.detach() for n, t in params.items()})
    if shards is not None:
        named = shards.gather_tree({"module": named})["module"]
    return _named_trees(named, _is_lm(module))


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


def _restore_skip(step: int, tier: str, reason: str) -> None:
    """The restore walk passed over ``step``: the ``restore_skip`` event."""
    _trace.event("restore_skip", step=step, attrs={"tier": tier, "reason": reason})


def _step_names(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    return [n for n in names if n.isdigit() and os.path.isdir(os.path.join(path, n))]


def _bare_steps(path: str) -> List[int]:
    """The bare numbered (finalized) step directories, ascending."""
    return sorted(int(n) for n in _step_names(path))


def _sharded_step_dirs(root: str) -> List[Tuple[int, str]]:
    """The committed per-host sharded steps under ``root``, newest first,
    as ``(step, step_dir)``: a step directory without ``COMMIT.json`` (a
    host never finalized) is not listed."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        stem = name[: -len(_HOST_STEP_SUFFIX)]
        if name.endswith(_HOST_STEP_SUFFIX) and stem.isdigit():
            path = os.path.join(root, name)
            if os.path.isfile(os.path.join(path, "COMMIT.json")):
                out.append((int(stem), path))
    return sorted(out, reverse=True)


def finalized_steps(path: str) -> List[int]:
    """The finalized steps of a ``Checkpointer`` directory, ascending: its
    bare numbered directories and its committed per-host sharded steps. A
    write in flight, or one that died, lives under a temporary name until
    its rename (a sharded step until its commit record) and is never
    listed. Empty when ``path`` is missing or holds no step."""
    path = os.path.abspath(os.path.expanduser(path))
    return sorted(set(_bare_steps(path)) | {s for s, _ in _sharded_step_dirs(path)})


def _checkpointer_step_dir(path: str, step: Optional[int] = None) -> Optional[str]:
    """When ``path`` is a ``Checkpointer`` directory, its latest (or the
    requested) step's directory; None when it holds no step (an export)."""
    steps = _step_names(path)
    if not steps:
        return None
    if step is None:
        return os.path.join(path, max(steps, key=int))
    if str(int(step)) not in steps:
        # IO-shaped, not a ValueError: a step can vanish between listing
        # and loading (retention racing a reader).
        raise FileNotFoundError(
            f"Checkpoint step {step} not found under {path!r} "
            f"(available: {sorted(int(s) for s in steps)}): deleted by "
            "retention since it was listed?"
        )
    return os.path.join(path, str(int(step)))


def _load_state_file(step_dir: str) -> Dict[str, Any]:
    """A step's ``state.pt``, read to the CPU; a missing or torn file
    raises ``CheckpointUnreadableError``."""
    try:
        tree = torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                          weights_only=True)
    except Exception as e:
        raise CheckpointUnreadableError(
            f"No restorable checkpoint at {step_dir!r}. Original error: {e}"
        ) from e
    if not isinstance(tree, dict) or "module" not in tree or "opt_state" not in tree:
        raise CheckpointUnreadableError(
            f"{step_dir!r} holds no training state (module, opt_state)."
        )
    return tree


def _named_trees(named: Mapping[str, torch.Tensor], lm: bool) -> Tuple[Flat, Flat]:
    """A ``state_dict`` as the export's ``(params, model_state)``."""
    if lm:
        return _torch_tree(_flax_lm_tree(named, _leaf_numpy)), {}
    flax_params, model_state = to_flax_variables(None, named, _leaf_numpy)
    return _torch_tree(flax_params), _torch_tree(model_state)


def _export_view(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A training state read from a step as the export's trees
    (``{flax path: tensor}``), the EMA beside the raw parameters; the
    optimizer state is dropped."""
    named = tree["module"]
    params, model_state = _named_trees(named, bool(tree.get("lm")))
    out = {"params": params, "model_state": model_state}
    if tree.get("ema_params") is not None:
        out["ema_params"] = _named_trees({**named, **tree["ema_params"]}, bool(tree.get("lm")))[0]
    return out


def _zkhost_step_dir(path: str, step: Optional[int]) -> Optional[str]:
    """The committed ``<step>.zkhost`` directory to read, or None when the
    bare layout serves the read: an explicit ``step`` is read from the
    layout that holds it (the bare one when both do), no ``step`` from
    the newest finalized step of either layout."""
    sharded = dict(_sharded_step_dirs(path))
    if not sharded:
        return None
    if step is not None:
        if os.path.isdir(os.path.join(path, str(int(step)))):
            return None
        return sharded.get(int(step))
    bare = _bare_steps(path)
    if bare and bare[-1] >= max(sharded):
        return None
    return sharded[max(sharded)]


def _read(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """An export's trees, or those of a ``Checkpointer`` directory's latest
    (or ``step``'s) training state, either layout."""
    path = os.path.abspath(os.path.expanduser(path))
    zkhost_dir = _zkhost_step_dir(path, step) if os.path.isdir(path) else None
    if zkhost_dir is not None:
        return _export_view(_restore_zkhost_tree(zkhost_dir))
    step_dir = _checkpointer_step_dir(path, step) if os.path.isdir(path) else None
    if step_dir is not None:
        return _export_view(_load_state_file(step_dir))
    target = os.path.join(path, EXPORT_FILE) if os.path.isdir(path) else path
    try:
        restored = torch.load(target, map_location="cpu", weights_only=True)
    except Exception as e:
        raise CheckpointUnreadableError(
            f"No restorable checkpoint at {path!r} (expected a save_model "
            f"export or a Checkpointer directory). Original error: {e}"
        ) from e
    if not isinstance(restored, dict) or "params" not in restored:
        raise ValueError(
            f"Checkpoint at {path!r} has no 'params' tree — not a "
            "save_model export or Checkpointer state."
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


def module_state_from_trees(module: nn.Module, params: Mapping[str, torch.Tensor],
                            model_state: Mapping[str, torch.Tensor]) -> Flat:
    """Export trees as ``module``'s ``state_dict`` (global tensors)."""
    if _is_lm(module):
        return from_flax_lm_variables(unflatten_tree(params))
    return from_flax_variables(unflatten_tree(params), unflatten_tree(model_state))


def load_into_module(module: nn.Module, params: Mapping[str, torch.Tensor],
                     model_state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy export trees into the module's parameters and statistics."""
    module.load_state_dict(module_state_from_trees(module, params, model_state))
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
    """Load the weights to serve or score from either artifact: a
    ``save_model`` export, or a ``Checkpointer`` directory (its latest
    step, or ``step``: the parameters, the EMA and the BatchNorm
    statistics; the optimizer state is dropped). EMA or raw as
    :func:`select_inference_weights` picks them, checked against
    ``params_like``/``model_state_like`` when given. Returns ``(params,
    model_state)`` as ``{flax path: tensor}``, the same trees for both."""
    restored = _read(path, step)
    params = select_inference_weights(restored["params"], restored.get("ema_params"), weights)
    model_state = restored.get("model_state") or {}
    if params_like is not None:
        _check_like(path, params, params_like, "params")
    if model_state_like is not None:
        _check_like(path, model_state, model_state_like, "model_state")
    return params, model_state


# -- the Checkpointer -------------------------------------------------------


def _state_tree(state: Any) -> Dict[str, Any]:
    """The persistable part of a ``TrainState``: the module's parameters
    and statistics, the optimizer state (with its counts), the EMA, the
    host ``step``, and whether the module is an LM (the flax layout of
    ``load_inference_model``); a sharded state's blocks as they are."""
    tree = {
        "step": int(state.step),
        "module": dict(state.module.state_dict()),
        "opt_state": state.opt_state,
        "lm": _is_lm(state.module),
    }
    if state.ema_params is not None:
        tree["ema_params"] = state.ema_params
    return tree


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _check_tree(path: str, saved: Any, live: Any, where: str) -> None:
    """``saved`` must have ``live``'s structure: the same keys at every
    level, and each tensor's shape; a count may be a host int or a 0-d
    tensor on either side (a ``nan_policy`` moves the counts to the
    card)."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise _structure_mismatch_error(
                path, f"{where or '/'} holds {got} where the run has {sorted(live)}.")
        for key, value in live.items():
            _check_tree(path, saved[key], value, f"{where}{key}/")
    elif where.rstrip("/").split("/")[-1] in COUNT_KEYS:
        if not isinstance(saved, (int, torch.Tensor)) or getattr(saved, "ndim", 0) != 0:
            raise _structure_mismatch_error(path, f"{where} is not a count.")
    elif not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(live.shape):
        got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
        raise _structure_mismatch_error(
            path, f"{where} is {got} where the model expects {tuple(live.shape)}.")


def _copy_into(live: Dict[str, Any], saved: Mapping[str, Any]) -> None:
    """Copy ``saved`` into ``live``'s own tensors (their device and
    dtype), so every reference to them stays valid; host counts are
    replaced."""
    for key, value in live.items():
        src = saved[key]
        if isinstance(value, dict):
            _copy_into(value, src)
        elif isinstance(value, torch.Tensor):
            value.copy_(torch.as_tensor(src))
        else:
            live[key] = int(src)


# -- the per-host sharded layout ---------------------------------------------


def _keystr(keys: Tuple[str, ...]) -> str:
    """A leaf's path as the manifest writes it (``['module']['w']``, the
    JAX package's ``keystr`` form)."""
    return "".join(f"['{k}']" for k in keys)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype (``float32``, ``bfloat16``, ``int64``)."""
    return str(dtype).replace("torch.", "")


class _Named:
    """A state tensor tagged with its ``state_dict`` name (the key of its
    ``ShardPlan`` layout)."""

    __slots__ = ("name", "tensor")

    def __init__(self, name: str, tensor: torch.Tensor):
        self.name, self.tensor = name, tensor


def _flat_leaves(tree: Mapping[str, Any], keys: Tuple[str, ...] = ()):
    """``(keys, leaf)`` of every non-dict value of a nested dict, in order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat_leaves(value, keys + (str(key),))
        else:
            yield keys + (str(key),), value


def _named_tree(state: Any, tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with every named state tensor of a sharded state wrapped in
    :class:`_Named` (no-op without shards)."""
    if state.shards is None:
        return tree
    return state.shards.map_tree(tree, _Named)


def _box(shape: Tuple[int, ...], layout: Any, coords: Dict[str, int],
         sizes: Dict[str, int]) -> Tuple[List[int], List[List[int]]]:
    """``layout.box`` (``parallel.shards.Layout.box``) of a sharded
    tensor; the whole ``shape`` of one that is not."""
    if layout is None:
        return [int(n) for n in shape], [[0, int(n)] for n in shape]
    return layout.box(coords, sizes)


def _token(index) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(a), int(b)) for a, b in index)


class _HostFiles:
    """The manifests and data of one committed sharded step's host
    directories, opened on demand; close it after use."""

    def __init__(self, step_root: str, hosts: List[str]):
        self.step_root, self.hosts = step_root, hosts
        self._open: Dict[str, Tuple[Dict[str, Dict[Any, Any]], Any]] = {}

    def table(self, host: str) -> Dict[str, Dict[Any, Any]]:
        """``{path: {box token: (key, meta)}}`` of ``host``'s manifest."""
        if host not in self._open:
            host_dir = os.path.join(self.step_root, host)
            with open(os.path.join(host_dir, "manifest.json")) as f:
                manifest = json.load(f)
            npz = np.load(os.path.join(host_dir, "data.npz"))
            table: Dict[str, Dict[Any, Any]] = {}
            for akey, meta in manifest.items():
                table.setdefault(meta["path"], {})[_token(meta["index"])] = (akey, meta)
            self._open[host] = (table, npz)
        return self._open[host][0]

    def read(self, host: str, akey: str, meta: Mapping[str, Any]) -> torch.Tensor:
        """One box's tensor (``shard_shape``, the saved dtype), from its
        raw bytes: a bfloat16 box round-trips bit for bit."""
        raw = torch.from_numpy(self._open[host][1][akey])
        return raw.view(getattr(torch, meta["dtype"])).reshape(meta["shard_shape"])

    def stitch(self, path: str) -> Optional[torch.Tensor]:
        """The global tensor of ``path`` from every host's boxes (a
        replicated tensor's first copy serves), folded to its global shape;
        None when no host saved it. Raises ``CheckpointUnreadableError``
        when the boxes leave part of it uncovered."""
        boxes: Dict[Any, Tuple[str, str, Mapping[str, Any]]] = {}
        for host in self.hosts:
            for token, (akey, meta) in self.table(host).get(path, {}).items():
                boxes.setdefault(token, (host, akey, meta))
        if not boxes:
            return None
        meta0 = next(iter(boxes.values()))[2]
        full = torch.empty(meta0["shape"], dtype=getattr(torch, meta0["dtype"]))
        covered = 0
        for host, akey, meta in boxes.values():
            full[tuple(slice(a, b) for a, b in meta["index"])] = self.read(host, akey, meta)
            covered += int(np.prod(meta["shard_shape"]))
        if covered < full.numel():
            raise CheckpointUnreadableError(
                f"sharded step at {self.step_root!r}: leaf {path} covers {covered} of "
                f"{full.numel()} elements: a host's blocks are missing."
            )
        return full.reshape(meta0.get("global_shape", meta0["shape"]))

    def close(self) -> None:
        for _, npz in self._open.values():
            try:
                npz.close()
            except Exception:
                pass
        self._open.clear()


def _step_hosts(step_root: str) -> List[str]:
    """The hosts a committed step's record lists (raises
    ``CheckpointUnreadableError`` without a readable record)."""
    try:
        with open(os.path.join(step_root, "COMMIT.json")) as f:
            commit = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointUnreadableError(
            f"sharded step at {step_root!r} has no readable commit record: {e}") from e
    hosts = sorted(commit.get("hosts", []))
    if not hosts:
        raise CheckpointUnreadableError(
            f"sharded step at {step_root!r}: commit record lists no hosts.")
    return hosts


def _restore_zkhost_tree(step_root: str) -> Dict[str, Any]:
    """The global tensors of the module, the EMA and the LM flag of one
    committed per-host sharded step (every host's blocks stitched together
    and folded): the readers' view of a group's checkpoint. Warns when the
    step spans several hosts (the whole state then sits in this process's
    memory). Raises ``CheckpointUnreadableError`` on torn or missing
    blocks."""
    hosts = _step_hosts(step_root)
    if len(hosts) > 1:
        logger.warning(
            "loading a MULTI-HOST sharded checkpoint (%d hosts) at %s into one "
            "process: every host's blocks are reassembled here, so the full state "
            "must fit this host's memory", len(hosts), step_root,
        )
    files = _HostFiles(step_root, hosts)
    try:
        paths: Dict[str, None] = {}
        for host in hosts:
            try:
                paths.update(dict.fromkeys(files.table(host)))
            except (OSError, ValueError) as e:
                raise CheckpointUnreadableError(
                    f"sharded step at {step_root!r}: host dir {host} unreadable ({e}): torn "
                    "after commit?") from e
        tree: Dict[str, Any] = {}
        for path in paths:
            segs = _KEYSTR_SEGMENT_RE.findall(path)
            if not segs or segs[0] not in ("module", "ema_params", "lm"):
                continue
            if _keystr(tuple(segs)) != path:
                raise CheckpointUnreadableError(
                    f"sharded step at {step_root!r}: leaf path {path!r} is not a nested-dict "
                    "path.")
            node = tree
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
            node[segs[-1]] = files.stitch(path)
        if "module" not in tree:
            raise CheckpointUnreadableError(
                f"sharded step at {step_root!r} holds no module blocks: not a training state.")
        tree["lm"] = bool(tree.get("lm", False))
        return tree
    finally:
        files.close()


@component
class Checkpointer:
    """Saves and restores the training state (see the module docstring
    for the format). ``directory=None`` disables it (the default)."""

    directory: Optional[str] = Field(None)
    #: Steps the local tier keeps (the newest, or the best under
    #: ``keep_best_metric``); 0 keeps every step.
    max_to_keep: int = Field(3)
    #: Save at every Nth epoch boundary; 0 disables epoch saves.
    save_every_epochs: int = Field(1)
    #: Also save every N train steps (0 = off), so a crash loses at most N
    #: steps; the resume is exact mid-epoch (``DataLoader.batches(
    #: start_batch=...)``). Refused with ``keep_best_metric``: mid-epoch
    #: saves carry no rankable metrics. Under the fused loop
    #: (``unroll > 1``) a due step saves at the end of its slab, the state
    #: a few steps later, just as exactly resumable.
    save_every_steps: int = Field(0)
    #: Resume from the newest restorable step in ``directory``.
    restore: bool = Field(True)
    #: A sync-mode save lands before ``save`` returns. The JAX package's
    #: ``synchronous=False`` (a sync-mode save that writes in the
    #: background) is ``mode="async"`` here, and raises with ``mode="sync"``.
    synchronous: bool = Field(True)
    #: Rank the local tier by this metric of the epoch saves (Keras
    #: ``save_best_only``): ``max_to_keep`` keeps the best N. Resume still
    #: restores the newest kept step; ``best_step()`` names the best.
    keep_best_metric: Optional[str] = Field(None)
    #: "max" (accuracy-like) or "min" (loss-like).
    best_mode: str = Field("max")
    #: A save that raises is retried this many times with exponential
    #: backoff, then logged and dropped (``save()`` returns False):
    #: training goes on and the work-loss bound stretches to the next
    #: save. Configuration errors still raise.
    save_retries: int = Field(2)
    #: The first retry's backoff, doubled each attempt, with a fresh
    #: +-50% jitter every attempt.
    save_retry_backoff_s: float = Field(0.25)
    #: "sync" (written on the training thread) or "async" (the training
    #: thread takes the device-to-host snapshot, a background writer
    #: writes it). The preemption path drains the writer and still saves
    #: once, synchronously.
    mode: str = Field("sync")
    #: Async mode, when a snapshot already waits behind the write in
    #: flight: "wait" (the new one blocks the training thread) or
    #: "supersede" (it replaces the waiting one; the write in flight
    #: always completes).
    queue_policy: str = Field("wait")
    #: The durable tier: a saved step is also written to
    #: ``durable_directory`` once at least this many steps passed since the
    #: last promotion (the first save always promotes; 0 = off): progress,
    #: not step divisibility, so no save cadence can starve it.
    durable_every_steps: int = Field(0)
    #: None = ``<directory>/durable``.
    durable_directory: Optional[str] = Field(None)
    #: Steps the durable tier keeps; 0 keeps every step.
    durable_max_to_keep: int = Field(0)
    #: The per-host sharded protocol (module docstring): on a run of
    #: several processes each writes only its own blocks, and process 0
    #: commits the step once every host has finalized. The directory must
    #: be storage every host reads and writes. At ``process_count == 1``
    #: the bare layout above, unchanged.
    sharded_per_host: bool = Field(False)
    #: This host in the group (-1: ``torch.distributed``'s rank and world
    #: size when a group is formed, else 0 and 1); set them to drive the
    #: protocol without a real group.
    process_index: int = Field(-1)
    process_count: int = Field(-1)
    #: How long process 0 waits for every host's directory before giving
    #: up the step's commit record (the step then never becomes
    #: restorable); a quarter of the restore agreement's rounds' deadline
    #: (at least 60 s).
    host_commit_timeout_s: float = Field(60.0)

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    def set_replicas(self, replicas: Any, is_chief: bool) -> None:
        """The ranks holding copies of the state (a ``parallel.
        ReplicaGroup``; None on one rank): only the chief (rank 0) writes,
        and every rank passes ``replicas.barrier()`` once a sync save has
        landed and once ``wait`` has drained the writer."""
        object.__setattr__(self, "_replicas", replicas)
        object.__setattr__(self, "_chief", is_chief)

    def _barrier(self) -> None:
        """The replicas' barrier (the bare layout's; the per-host protocol
        runs no collective)."""
        replicas = getattr(self, "_replicas", None)
        if replicas is not None and not self._sharded_active:
            replicas.barrier()

    @property
    def _writes(self) -> bool:
        """Whether this rank writes (every rank but the chief's replicas
        skip; under the per-host protocol every rank writes its blocks)."""
        return (getattr(self, "_replicas", None) is None or getattr(self, "_chief", True)
                or self._sharded_active)

    # -- the per-host protocol's identity and coordinator -------------------

    def _host_identity(self) -> Tuple[int, int]:
        """``(process_index, process_count)``: the fields when set, else
        the formed process group's rank and size, else ``(0, 1)``."""
        pid, count = self.process_index, self.process_count
        if pid < 0 or count < 0:
            import torch.distributed as dist

            formed = dist.is_available() and dist.is_initialized()
            if pid < 0:
                pid = dist.get_rank() if formed else 0
            if count < 0:
                count = dist.get_world_size() if formed else 1
        return int(pid), int(count)

    @property
    def _sharded_active(self) -> bool:
        """Whether saves take the per-host protocol: asked for, and the
        group has more than one process."""
        return self.enabled and self.sharded_per_host and self._host_identity()[1] > 1

    def set_coordinator(self, coordinator: Any) -> "Checkpointer":
        """The cross-host coordinator the restore agreement uses (tests, or
        one shared with a supervisor). Default: a ``FileCoordinator`` under
        ``<directory>/.zkcoord``."""
        object.__setattr__(self, "_coord", coordinator)
        return self

    def _coordinator(self):
        coord = getattr(self, "_coord", None)
        if coord is None and self._sharded_active:
            from zookeeper_tpu_torch.resilience.coordination import FileCoordinator

            pid, count = self._host_identity()
            # The agreement's rounds must outlast a peer still waiting out
            # its own commit deadline.
            coord = FileCoordinator(os.path.join(self._root(), ".zkcoord"), pid, count,
                                    timeout_s=max(60.0, 4 * self.host_commit_timeout_s))
            object.__setattr__(self, "_coord", coord)
        return coord

    def _root(self) -> str:
        return os.path.abspath(os.path.expanduser(self.directory))

    @property
    def _durable_enabled(self) -> bool:
        return self.enabled and self.durable_every_steps > 0

    def _durable_path(self) -> str:
        base = self.durable_directory or os.path.join(self.directory, "durable")
        return os.path.abspath(os.path.expanduser(base))

    def _tier_root(self, tier: str) -> str:
        return self._durable_path() if tier in ("durable", "hosts-durable") else self._root()

    def _io_lock(self) -> threading.Lock:
        """Held around every write, retention pass and restore read: the
        writer thread and the training thread share the directories, and
        retention must not delete a step being read."""
        lock = getattr(self, "_lock", None)
        if lock is None:
            lock = threading.Lock()
            object.__setattr__(self, "_lock", lock)
        return lock

    def _nonce(self) -> int:
        counter = getattr(self, "_counter", None)
        if counter is None:
            counter = itertools.count(1)
            object.__setattr__(self, "_counter", counter)
        return next(counter)

    def _writer(self):
        """The async writer, started at first use."""
        from zookeeper_tpu_torch.training.async_checkpoint import AsyncCheckpointWriter

        writer = getattr(self, "_async_writer", None)
        if writer is None:
            writer = AsyncCheckpointWriter(self, queue_policy=self.queue_policy)
            object.__setattr__(self, "_async_writer", writer)
        return writer

    def _validate_mode(self) -> None:
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode={self.mode!r} unknown; choose sync/async.")
        if self.queue_policy not in ("wait", "supersede"):
            raise ValueError(
                f"queue_policy={self.queue_policy!r} unknown; choose wait/supersede."
            )
        if self.durable_every_steps < 0 or self.durable_max_to_keep < 0:
            raise ValueError(
                "durable_every_steps/durable_max_to_keep must be >= 0 "
                "(0 disables the durable tier / keeps everything)."
            )
        if self.mode == "sync" and not self.synchronous:
            raise ValueError(
                "synchronous=False with mode='sync': a sync-mode save always "
                "lands before save() returns. Use mode='async' to write in "
                "the background."
            )
        if self.keep_best_metric is not None and self.best_mode not in ("max", "min"):
            raise ValueError(f"best_mode={self.best_mode!r} unknown; choose max/min.")
        if self.queue_policy == "supersede" and self.keep_best_metric:
            raise ValueError(
                "queue_policy='supersede' is incompatible with "
                "keep_best_metric: superseding may drop a better-ranked "
                "queued snapshot in favor of a worse one. Use "
                "queue_policy='wait'."
            )
        if self.host_commit_timeout_s <= 0:
            raise ValueError(
                f"host_commit_timeout_s={self.host_commit_timeout_s} must be > 0."
            )
        if self.sharded_per_host and self.keep_best_metric:
            # The per-host commit record carries no metrics to rank by.
            raise ValueError(
                "sharded_per_host is incompatible with keep_best_metric:"
                " the per-host commit protocol keeps by recency, not "
                "rank. Use one or the other."
            )

    # -- the write path (the sync caller and the async writer) ------------

    def _run_with_save_retries(self, step: int, attempt_fn) -> bool:
        """Retry ``attempt_fn`` with exponential backoff and a fresh +-50%
        jitter each attempt; when every attempt fails, log at error level
        with the exception chain and return False."""
        attempts = max(0, int(self.save_retries)) + 1
        for attempt in range(attempts):
            try:
                return bool(attempt_fn())
            except Exception as e:
                if attempt + 1 >= attempts:
                    logger.error(
                        "checkpoint save at step %d DROPPED after %d "
                        "attempt(s); training continues, work-loss bound "
                        "stretches to the next successful save",
                        step, attempts, exc_info=e,
                    )
                    return False
                delay = self.save_retry_backoff_s * (2**attempt)
                delay *= random.uniform(0.5, 1.5)  # drawn again every attempt
                logger.warning(
                    "checkpoint save at step %d failed (%s); retrying in "
                    "%.2fs (%d/%d)", step, e, delay, attempt + 1, attempts - 1,
                )
                if delay > 0:
                    time.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    def _write_step(self, root: str, step: int, tree: Any, metrics: Optional[dict],
                    finalize: bool = True) -> None:
        """Write one step under a temporary name, fsync it, and rename it
        to ``<root>/<step>`` (a step already there is left as it is).
        ``finalize=False`` stops before the rename (an injected finalize
        failure), leaving the unfinalized remnant."""
        os.makedirs(root, exist_ok=True)
        final = os.path.join(root, str(step))
        if os.path.isdir(final):
            return
        tmp = os.path.join(root, f"{step}.tmp-{os.getpid()}-{self._nonce()}")
        os.makedirs(tmp)
        _write_file(os.path.join(tmp, STATE_FILE), lambda f: torch.save(tree, f))
        _write_file(os.path.join(tmp, METRICS_FILE),
                    lambda f: f.write(json.dumps({"step": step, "metrics": metrics}).encode()))
        _fsync_dir(tmp)
        if not finalize:
            return
        os.rename(tmp, final)
        _fsync_dir(root)

    def _step_metrics(self, root: str, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(root, str(step), METRICS_FILE)) as f:
                return json.load(f).get("metrics")
        except (OSError, ValueError):
            return None

    def _ranked(self, root: str, steps: List[int]) -> List[int]:
        """``steps`` best first by ``keep_best_metric``; steps without the
        metric rank last (they are dropped first)."""
        metric = self.keep_best_metric

        def key(step):
            value = (self._step_metrics(root, step) or {}).get(metric)
            if value is None:
                return (1, 0.0, -step)
            return (0, -value if self.best_mode == "max" else value, -step)

        return sorted(steps, key=key)

    def _retain(self, root: str, keep: int, ranked: bool) -> None:
        """Retention: delete the steps past ``keep`` (0 keeps all) and the
        remnants of writes that died. Caller holds ``_io_lock``."""
        steps = sorted(_bare_steps(root), reverse=True)
        if keep > 0 and len(steps) > keep:
            order = self._ranked(root, steps) if ranked else steps
            for step in order[keep:]:
                shutil.rmtree(os.path.join(root, str(step)), ignore_errors=True)
        for name in os.listdir(root):
            if _REMNANT.match(name):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    def _durable_promotion_due(self, step: int) -> bool:
        """The first save promotes, then every save at least
        ``durable_every_steps`` past the durable tier's newest step (so the
        cadence survives restarts)."""
        steps = _bare_steps(self._durable_path())
        return not steps or step - steps[-1] >= self.durable_every_steps

    def _write_state(self, tree: Any, step: int, metrics: Optional[dict]) -> bool:
        """One write attempt of a host snapshot: the local tier, the
        durable promotion when due, retention; the plan's hooks in line."""
        plan = faults.active()
        if plan is not None and plan.take_save_io_failure():
            raise faults.InjectedFault(f"injected save IO failure at step {step}")
        if isinstance(tree, dict) and tree.get("kind") == _HOST_SHARD_KIND:
            # The per-host protocol replaces the bare layout's write, its
            # durable promotion and its retention.
            return self._write_host_sharded(tree, step)
        root = self._root()
        with self._io_lock():
            self._write_step(root, step, tree, metrics)
            if self._durable_enabled and self._durable_promotion_due(step):
                durable = self._durable_path()
                self._write_step(durable, step, tree, None)
                self._retain(durable, self.durable_max_to_keep, ranked=False)
            self._retain(root, self.max_to_keep, ranked=self.keep_best_metric is not None)
        plan = faults.active()
        if plan is not None and plan.corrupt_due(step):
            # Tear this step once it has landed: the disk a crash leaves.
            faults.corrupt_checkpoint_dir(os.path.join(root, str(step)))
        return True

    def _attempt_async_write(self, step: int, tree: Any, metrics: Optional[dict]) -> bool:
        """One writer-thread attempt; an injected finalize failure writes
        the data and skips the rename, leaving an unfinalized remnant."""
        plan = faults.active()
        if plan is not None and plan.take_async_finalize_failure():
            if tree.get("kind") == _HOST_SHARD_KIND:
                self._leave_unfinalized_remnant(step)
            else:
                with self._io_lock():
                    self._write_step(self._root(), step, tree, metrics, finalize=False)
            raise faults.InjectedFault(f"injected async finalize failure at step {step}")
        return self._write_state(tree, step, metrics)

    def _leave_unfinalized_remnant(self, step: int) -> None:
        """A write that died before its rename: a temporary-named step
        directory with a torn state file, fsynced. Its name is not a bare
        step number, so no listing sees it."""
        root = self._root()
        tmp = os.path.join(root, f"{step}.tmp-{os.getpid()}-{self._nonce()}")
        os.makedirs(tmp, exist_ok=True)
        _write_file(os.path.join(tmp, STATE_FILE), lambda f: f.write(b"\xde\xad\xbe\xef" * 8))

    # -- the per-host protocol's write path ----------------------------------

    def _extract_host_shards(self, state: Any) -> Tuple[Dict[str, Any], Any]:
        """This host's blocks of the state (a replicated tensor whole) as
        a snapshot of host tensors plus the index manifest: ``(payload,
        ready event)``, the event as ``host_snapshot``'s. The training
        thread takes it; the raw bytes are made by the write."""
        from zookeeper_tpu_torch.training.step import host_snapshot

        plan = state.shards
        coords = plan.coords if plan is not None else {}
        sizes = plan.mesh.sizes if plan is not None else {}
        tensors, manifest = {}, {}
        for n, (keys, leaf) in enumerate(_flat_leaves(_named_tree(state, _state_tree(state)))):
            layout = None
            if isinstance(leaf, _Named):
                layout = plan.layouts.get(leaf.name)
                leaf = leaf.tensor
            t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.tensor(leaf)
            gshape = tuple(layout.shape) if layout is not None else tuple(t.shape)
            view, index = _box(gshape, layout, coords, sizes)
            akey = f"a{n}"
            tensors[akey] = t
            manifest[akey] = {
                "path": _keystr(keys), "index": index, "shape": view,
                "shard_shape": [b - a for a, b in index], "dtype": _dtype_name(t.dtype),
            }
            if list(gshape) != view:
                manifest[akey]["global_shape"] = list(gshape)
        tensors, ready = host_snapshot(tensors)
        return {"kind": _HOST_SHARD_KIND, "tensors": tensors, "manifest": manifest}, ready

    def _write_host_sharded(self, payload: Dict[str, Any], step: int) -> bool:
        """One attempt of the per-host protocol: finalize this host's
        directory; process 0 then waits for every host's and commits the
        step, promotes it and prunes."""
        pid, count = self._host_identity()
        root = self._root()
        step_root = os.path.join(root, f"{int(step)}{_HOST_STEP_SUFFIX}")
        if not self._finalize_host_dir(step_root, step, pid, payload):
            return False
        if pid != 0:
            return True  # this host's half is durable; process 0 commits
        if not self._commit_sharded_step(step_root, step, count):
            return False
        self._maybe_promote_sharded_durable(step, step_root)
        self._prune_sharded(root)
        return True

    def _finalize_host_dir(self, step_root: str, step: int, pid: int,
                           payload: Dict[str, Any]) -> bool:
        """Write this host's blocks into a temporary directory, fsync, and
        rename it: the rename is the host's finalize marker."""
        from zookeeper_tpu_torch.resilience.coordination import _atomic_write_json

        host_dir = os.path.join(step_root, f"host_{pid:05d}")
        if os.path.isdir(host_dir):
            if os.path.isfile(os.path.join(step_root, "COMMIT.json")):
                return True  # committed: saving it again changes nothing
            # An uncommitted host directory is a stale half of an earlier
            # incarnation's torn save: rewrite it, never seal old bytes
            # under a new commit.
            shutil.rmtree(host_dir, ignore_errors=True)
        tmp = os.path.join(step_root, f".tmp-host_{pid:05d}-{self._nonce()}")
        os.makedirs(tmp, exist_ok=True)
        arrays = {akey: t.contiguous().reshape(-1).view(torch.uint8).numpy()
                  for akey, t in payload["tensors"].items()}
        _write_file(os.path.join(tmp, "data.npz"), lambda f: np.savez(f, **arrays))
        _atomic_write_json(os.path.join(tmp, "manifest.json"), payload["manifest"])
        _fsync_dir(tmp)
        plan = faults.active()
        if plan is not None and plan.take_host_finalize_failure(pid):
            # The host died between writing its blocks and the rename: no
            # marker, no commit, no retry (a dead host does not retry).
            logger.error(
                "per-host finalize of step %d on host %d dropped (injected host "
                "death): marker absent, the step's commit record will not land and "
                "restore walks back", step, pid,
            )
            return False
        os.replace(tmp, host_dir)
        _fsync_dir(step_root)
        default_registry().gauge(
            "zk_ckpt_host_finalized",
            help="newest step this host finalized its sharded checkpoint half for",
            labels={"pid": str(pid)},
        ).set(int(step))
        _trace.event("ckpt_host_finalized", step=int(step), attrs={"pid": pid})
        return True

    def _commit_sharded_step(self, step_root: str, step: int, count: int) -> bool:
        """Process 0: write ``COMMIT.json`` once every host's directory is
        there; a host missing at ``host_commit_timeout_s`` leaves the step
        uncommitted (the previous committed step is the resume point)."""
        from zookeeper_tpu_torch.resilience.coordination import _atomic_write_json

        deadline = time.monotonic() + self.host_commit_timeout_s
        while True:
            try:
                hosts = sorted(n for n in os.listdir(step_root) if n.startswith("host_"))
            except OSError:
                hosts = []
            if len(hosts) >= count:
                break
            if time.monotonic() >= deadline:
                logger.error(
                    "sharded checkpoint of step %d: only %d/%d host(s) finalized within "
                    "%.1fs; commit record NOT written — the step stays invisible to "
                    "restore on every host", step, len(hosts), count,
                    self.host_commit_timeout_s,
                )
                _trace.event("ckpt_group_commit_abandoned", step=int(step),
                             attrs={"hosts": len(hosts), "expected": count})
                return False
            time.sleep(0.01)
        _atomic_write_json(os.path.join(step_root, "COMMIT.json"),
                           {"step": int(step), "process_count": int(count), "hosts": hosts})
        _trace.event("ckpt_group_committed", step=int(step), attrs={"hosts": count})
        return True

    def _maybe_promote_sharded_durable(self, step: int, step_root: str) -> None:
        """Process 0: a committed step is copied whole (its record too)
        into the durable tier on the bare layout's progress cadence,
        finalized by rename."""
        if not self._durable_enabled:
            return
        droot = self._durable_path()
        existing = _sharded_step_dirs(droot)
        if existing and step - existing[0][0] < self.durable_every_steps:
            return
        dst = os.path.join(droot, f"{int(step)}{_HOST_STEP_SUFFIX}")
        if os.path.isdir(dst):
            return
        os.makedirs(droot, exist_ok=True)
        tmp = os.path.join(droot, f".tmp-{int(step)}-{self._nonce()}")
        try:
            shutil.copytree(step_root, tmp)
            os.replace(tmp, dst)
        except OSError as e:
            logger.warning("durable promotion of sharded step %d failed (%s); the local "
                           "tier still holds it", step, e)
            shutil.rmtree(tmp, ignore_errors=True)
            return
        if self.durable_max_to_keep > 0:
            for _, old in _sharded_step_dirs(droot)[self.durable_max_to_keep:]:
                shutil.rmtree(old, ignore_errors=True)

    def _prune_sharded(self, root: str) -> None:
        """Process 0: keep the newest ``max_to_keep`` committed steps."""
        if self.max_to_keep <= 0:
            return
        for _, old in _sharded_step_dirs(root)[self.max_to_keep:]:
            shutil.rmtree(old, ignore_errors=True)

    def save(self, state: Any, *, step: Optional[int] = None,
             metrics: Optional[dict] = None, sync: Optional[bool] = None) -> bool:
        """Save ``state`` (``sync=True`` takes the synchronous path in any
        mode: the preemption save). The training thread takes the host
        snapshot (device-to-host copies, nothing else); in async mode the
        writer serializes and writes it, and True means the writer
        accepted it (``wait()`` sees it land)."""
        if not self.enabled:
            return False
        from zookeeper_tpu_torch.training.step import host_snapshot

        self._validate_mode()
        if self.keep_best_metric is not None:
            if not metrics or self.keep_best_metric not in metrics:
                raise ValueError(
                    f"keep_best_metric={self.keep_best_metric!r} but this "
                    "save carries no such metric "
                    f"(got {sorted(metrics or {})}). Pass metrics= to "
                    "save(), or unset keep_best_metric."
                )
        if metrics:
            metrics = {k: float(v) for k, v in metrics.items()}
        step = int(state.step) if step is None else int(step)
        asynchronous = self.mode == "async" and not sync
        if self._sharded_active:
            # Every rank writes its own blocks: no gather, no barrier. The
            # extraction is both modes' snapshot.
            with _trace.span("ckpt_snapshot", step=step):
                payload, ready = self._extract_host_shards(state)
            if asynchronous:
                return self._writer().submit(step, payload, metrics, ready=ready)
            with _trace.span("ckpt_sync_save", step=step):
                if ready is not None:
                    ready.synchronize()
                return self._run_with_save_retries(
                    step, lambda: self._write_state(payload, step, metrics))
        tree = _state_tree(state)
        if state.shards is not None:
            tree = state.shards.gather_tree(tree)  # every rank takes part
        if not self._writes:
            if not asynchronous:
                self._barrier()  # the chief's write has landed
            return True
        if asynchronous:
            with _trace.span("ckpt_snapshot", step=step):
                tree, ready = host_snapshot(tree)
            return self._writer().submit(step, tree, metrics, ready=ready)
        with _trace.span("ckpt_sync_save", step=step):
            tree, ready = host_snapshot(tree)
            if ready is not None:
                ready.synchronize()
            saved = self._run_with_save_retries(
                step, lambda: self._write_state(tree, step, metrics))
        self._barrier()
        return saved

    def _tier_entries(self) -> List[Tuple[int, str]]:
        """Every retained ``(step, tier)``, newest first: the bare tiers
        ("local", "durable") and the committed per-host sharded steps
        ("hosts", "hosts-durable"); for one step the cheapest tier first
        (``_TIER_PRIORITY``)."""
        entries = [(s, "local") for s in _bare_steps(self._root())]
        entries += [(s, "hosts") for s, _ in _sharded_step_dirs(self._root())]
        if self._durable_enabled:
            durable = self._durable_path()
            entries += [(s, "durable") for s in _bare_steps(durable)]
            entries += [(s, "hosts-durable") for s, _ in _sharded_step_dirs(durable)]
        entries.sort(key=lambda e: (e[0], _TIER_PRIORITY[e[1]]), reverse=True)
        return entries

    def latest_step(self) -> Optional[int]:
        """The newest finalized step of any tier (an async write still in
        flight, or a sharded step some host has not finalized, does not
        count)."""
        if not self.enabled:
            return None
        entries = self._tier_entries()
        return entries[0][0] if entries else None

    def best_step(self) -> Optional[int]:
        """The best retained step by ``keep_best_metric`` (None when
        ranking is off or nothing is ranked)."""
        if not self.enabled or self.keep_best_metric is None:
            return None
        root = self._root()
        ranked = [s for s in self._ranked(root, _bare_steps(root))
                  if (self._step_metrics(root, s) or {}).get(self.keep_best_metric) is not None]
        return ranked[0] if ranked else None

    def _read_checked(self, step: int, tier: str, state: Any) -> Dict[str, Any]:
        """Read one bare-layout step and check it against the live state's
        structure; raises on a torn, vanished or mismatched step."""
        step_dir = os.path.join(self._tier_root(tier), str(step))
        with self._io_lock():
            tree = _load_state_file(step_dir)
        live = _state_tree(state)
        if state.shards is not None:
            live = state.shards.global_like(live)
        _check_tree(step_dir, tree["module"], live["module"], "module/")
        _check_tree(step_dir, tree["opt_state"], live["opt_state"], "opt_state/")
        if tree.get("ema_params") is not None:
            params = {n for n, _ in state.module.named_parameters()}
            _check_tree(step_dir, tree["ema_params"], {n: live["module"][n] for n in params},
                        "ema_params/")
        return tree

    def _validate_sharded_step(self, step: int, root: str) -> bool:
        """A committed sharded step is whole: its record and every recorded
        host's files are there (retention, or a lost tier, can tear a step
        after its commit)."""
        step_root = os.path.join(root, f"{int(step)}{_HOST_STEP_SUFFIX}")
        try:
            hosts = _step_hosts(step_root)
        except CheckpointUnreadableError:
            return False
        return all(os.path.isfile(os.path.join(step_root, h, "data.npz"))
                   and os.path.isfile(os.path.join(step_root, h, "manifest.json"))
                   for h in hosts)

    def _validate_entry(self, step: int, tier: str) -> bool:
        """The cheap, local check of one walk entry, which the group
        exchanges before any host restores."""
        if tier in ("hosts", "hosts-durable"):
            return self._validate_sharded_step(step, self._tier_root(tier))
        return os.path.isfile(os.path.join(self._tier_root(tier), str(step), STATE_FILE))

    def _restore_host_sharded(self, step: int, state: Any, root: str) -> Dict[str, Any]:
        """This rank's tree of one committed sharded step, shaped as the
        live state's (its blocks under a sharded state): each block is read
        from the host directory holding that box, this host's first; a box
        no host saved (another topology) is cut from the stitched global
        tensor. Raises on a torn or missing block, or a shape or dtype
        that differs from the live state's."""
        step_root = os.path.join(root, f"{int(step)}{_HOST_STEP_SUFFIX}")
        try:
            hosts = sorted(n for n in os.listdir(step_root) if n.startswith("host_")
                           and os.path.isdir(os.path.join(step_root, n)))
        except OSError as e:
            raise CheckpointUnreadableError(
                f"sharded step {step} vanished under the walk: {e}") from e
        if not hosts:
            raise CheckpointUnreadableError(
                f"sharded step {step} has a commit record but no host directories")
        own = f"host_{self._host_identity()[0]:05d}"
        order = ([own] if own in hosts else []) + [h for h in hosts if h != own]
        files = _HostFiles(step_root, order)
        plan = state.shards
        coords = plan.coords if plan is not None else {}
        sizes = plan.mesh.sizes if plan is not None else {}

        def read(keys, leaf):
            layout, name = None, None
            if isinstance(leaf, _Named):
                name, leaf = leaf.name, leaf.tensor
                layout = plan.layouts.get(name)
            path = _keystr(keys)
            tensor = isinstance(leaf, torch.Tensor)
            shape = tuple(leaf.shape) if tensor else ()
            gshape = tuple(layout.shape) if layout is not None else shape
            _, index = _box(gshape, layout, coords, sizes)
            token = _token(index)
            count = keys[-1] in COUNT_KEYS or not tensor

            def check(saved_shape, saved_dtype):
                # A count may be a host int or a 0-d tensor on either side.
                if tuple(saved_shape) != gshape or (
                        not count and saved_dtype != _dtype_name(leaf.dtype)):
                    raise ValueError(
                        f"sharded step {step}: leaf {path} saved as {saved_dtype}"
                        f"{tuple(saved_shape)}, the run expects "
                        f"{_dtype_name(leaf.dtype) if tensor else 'a count'}{gshape} — "
                        "model/checkpoint structure mismatch")

            for host in order:
                hit = files.table(host).get(path, {}).get(token)
                if hit is not None:
                    akey, meta = hit
                    check(meta.get("global_shape", meta["shape"]), meta["dtype"])
                    return files.read(host, akey, meta).reshape(shape)
            full = files.stitch(path)
            if full is None:
                raise CheckpointUnreadableError(f"sharded step {step}: no host saved {path}")
            check(full.shape, _dtype_name(full.dtype))
            return plan.shard(name, full) if layout is not None else full.reshape(shape)

        def build(tree, keys=()):
            return {k: (build(v, keys + (str(k),)) if isinstance(v, dict)
                        else read(keys + (str(k),), v)) for k, v in tree.items()}

        try:
            live = _named_tree(state, _state_tree(state))
            if "ema_params" in live and not any(
                    p.startswith("['ema_params']") for h in order for p in files.table(h)):
                del live["ema_params"]  # saved without the EMA: seeded from the module
            live.pop("lm", None)
            return build(live)
        finally:
            files.close()

    def _restore_entry(self, step: int, tier: str, state: Any):
        """One restore attempt: ``(tree, None)``, or ``(None, error)``."""
        try:
            with _trace.span("restore_step", step=step):
                if tier in ("hosts", "hosts-durable"):
                    with self._io_lock():
                        return (self._restore_host_sharded(step, state, self._tier_root(tier)),
                                None)
                return self._read_checked(step, tier, state), None
        except Exception as e:
            return None, e

    def restore_state(self, state: Any) -> Any:
        """Restore the newest restorable step into ``state``, in place:
        every tensor is copied into the built state's own (on its device,
        in its dtype), so the optimizer's, the step's and the EMA's
        references stay valid. Returns ``state``; unchanged when disabled
        or when no step exists.

        A step that is unfinalized, torn, structurally unreadable, or
        deleted since it was listed is skipped with a warning and the next
        newest restores instead. Only when every retained step fails does
        restore raise: the likely cause is then a model or config mismatch.

        Under the per-host protocol on several processes the walk is
        agreed: the hosts exchange their candidate lists (the union is
        walked), then for each candidate a validity verdict before anyone
        reads it (a step any host finds torn is skipped by all) and a
        read verdict after, so every process resumes from the same step.
        A lost coordinator drops the walk to this host's own decisions,
        with a warning."""
        if not self.enabled or not self.restore:
            return state
        from zookeeper_tpu_torch.resilience.coordination import CoordinatorLostError

        entries = self._tier_entries()
        coord = self._coordinator() if self._sharded_active else None
        group = coord is not None and coord.process_count > 1
        if group:
            try:
                proposals = coord.exchange("restore_candidates",
                                           [[int(s), t] for s, t in entries])
                merged = {(int(s), str(t)) for plist in proposals for s, t in plist}
                entries = sorted(merged, key=lambda e: (e[0], _TIER_PRIORITY.get(e[1], -1)),
                                 reverse=True)
            except CoordinatorLostError as e:
                logger.warning(
                    "cross-host restore agreement unavailable (%s); falling back to "
                    "this host's local walk — a step another host finds torn may "
                    "desync the group", e,
                )
                group = False
        if not entries:
            return state
        last_err: Optional[Exception] = None
        for i, (step, tier) in enumerate(entries):
            valid = self._validate_entry(step, tier)
            if group:
                try:
                    valids = coord.exchange(f"restore_try_{step}_{tier}", bool(valid))
                except CoordinatorLostError as e:
                    logger.warning("restore agreement lost mid-walk (%s); continuing with "
                                   "this host's local walk", e)
                    group, valids = False, [valid]
                if valid and not all(valids):
                    logger.warning(
                        "%s checkpoint step %d is restorable here but torn on a peer "
                        "host; skipped on EVERY host for group agreement", tier, step)
                    _restore_skip(step, tier, "peer_torn")
                    continue
            if not valid:
                _restore_skip(step, tier, "unfinalized")
                logger.warning(
                    "%s checkpoint step %d is not finalized (crash mid-save, or host "
                    "data GC'd since listing?); falling back to an earlier step",
                    tier, step)
                continue
            tree, err = self._restore_entry(step, tier, state)
            ok = err is None
            if group:
                try:
                    oks = coord.exchange(f"restore_ok_{step}_{tier}", ok)
                except CoordinatorLostError as e:
                    logger.warning("restore confirmation lost (%s); continuing with this "
                                   "host's local walk", e)
                    group, oks = False, [ok]
                if ok and not all(oks):
                    logger.warning("a peer host failed to read %s step %d; skipped on every "
                                   "host for group agreement", tier, step)
                    _restore_skip(step, tier, "peer_unreadable")
                    continue
            if not ok:
                last_err = err
                _restore_skip(step, tier, "unreadable")
                logger.warning(
                    "%s checkpoint step %d failed to restore (%s); falling back to an "
                    "earlier retained step", tier, step, err,
                )
                continue
            if i > 0:
                logger.warning(
                    "restored %s step %d instead of the newest retained step %d: later "
                    "step(s) were corrupt/unreadable — work since step %d will be "
                    "retrained", tier, step, entries[0][0], step,
                )
            _trace.event("restore_done", step=step, attrs={"tier": tier})
            if tier in ("hosts", "hosts-durable"):
                self._load_tree(state, tree)
            else:
                self._assemble(state, tree)
            return state
        raise ValueError(
            f"None of the {len(entries)} retained checkpoint step(s) "
            f"{[s for s, _ in entries]} in {self.directory!r} could be "
            "restored. If every step failed identically this is almost "
            "certainly a model/checkpoint STRUCTURE mismatch (the "
            "restoring model must be built with the exporting run's "
            "architecture config), not disk corruption. Last error: "
            f"{last_err}"
        ) from last_err

    @staticmethod
    def _assemble(state: Any, tree: Mapping[str, Any]) -> None:
        """Load a global tree (this rank's blocks of it under shards)."""
        if state.shards is not None:
            tree = state.shards.shard_tree(dict(tree))
        Checkpointer._load_tree(state, tree)

    @staticmethod
    def _load_tree(state: Any, tree: Mapping[str, Any]) -> None:
        """Load a tree shaped as the live state (its blocks) into it."""
        with torch.no_grad():
            state.module.load_state_dict(tree["module"])
            _copy_into(state.opt_state, tree["opt_state"])
            if state.ema_params is not None:
                # Saved without the EMA: it starts at the restored weights.
                source = tree.get("ema_params") or tree["module"]
                for name, t in state.ema_params.items():
                    t.copy_(source[name])
        state.step = int(tree["step"])

    def wait(self, supersede: bool = False) -> float:
        """Block until every accepted async snapshot is written or dropped
        (sync saves have landed when ``save`` returns), then pass the
        ranks' barrier (the bare layout's); returns the ms spent draining (0.0 in sync mode).
        ``supersede=True`` drops the queued, not yet started snapshot
        first."""
        writer = getattr(self, "_async_writer", None)
        waited = 0.0 if writer is None else writer.drain(supersede=supersede)
        self._barrier()
        return waited

    def close(self) -> None:
        """Stop the async writer (a queued snapshot is still written)."""
        writer = getattr(self, "_async_writer", None)
        if writer is not None:
            writer.stop()
            object.__setattr__(self, "_async_writer", None)
