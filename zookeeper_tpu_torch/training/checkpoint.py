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

The JAX package's per-host sharded protocol (``sharded_per_host``,
``process_index``, ``process_count``, ``host_commit_timeout_s``) is not
ported yet (ROADMAP.md): those fields keep JAX's defaults and raise when
set.
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
from zookeeper_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)

#: The file a ``save_model`` directory holds.
EXPORT_FILE = "model.pt"
#: The files of a ``Checkpointer`` step directory.
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
#: Walk order among tiers holding the same step: the local tier first.
_TIER_PRIORITY = {"local": 2, "durable": 0}
#: A step written under its temporary name, not yet finalized.
_REMNANT = re.compile(r"^\d+\.tmp-")
Flat = Dict[str, torch.Tensor]


class CheckpointUnreadableError(ValueError):
    """No restorable checkpoint bytes at the requested path: nothing
    there, an empty directory, or a file ``torch.load`` cannot read. A
    ``ValueError``, told apart from the configuration errors (a structure
    mismatch, ``weights="ema"`` without an EMA) by its type."""


def _torch_tree(tree: Mapping[str, Any]) -> Flat:
    """A nested tree of numpy leaves as ``{path: contiguous CPU tensor}``
    (copies)."""
    return {path: torch.tensor(np.asarray(leaf)) for path, leaf in flatten_tree(tree).items()}


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


def _step_names(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    return [n for n in names if n.isdigit() and os.path.isdir(os.path.join(path, n))]


def finalized_steps(path: str) -> List[int]:
    """The finalized steps of a ``Checkpointer`` directory, ascending:
    its bare numbered directories. A write in flight, or one that died,
    lives under a temporary name until its rename and is never listed.
    Empty when ``path`` is missing or holds no step."""
    return sorted(int(n) for n in _step_names(os.path.abspath(os.path.expanduser(path))))


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
        return _torch_tree(_flax_lm_tree(named)), {}
    flax_params, model_state = to_flax_variables(None, named)
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


def _read(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """An export's trees, or those of a ``Checkpointer`` directory's latest
    (or ``step``'s) training state."""
    path = os.path.abspath(os.path.expanduser(path))
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
    #: The per-host sharded protocol's fields, with JAX's defaults; not
    #: ported yet (ROADMAP.md), so another value raises.
    sharded_per_host: bool = Field(False)
    process_index: int = Field(-1)
    process_count: int = Field(-1)
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
        replicas = getattr(self, "_replicas", None)
        if replicas is not None:
            replicas.barrier()

    @property
    def _writes(self) -> bool:
        """Whether this rank writes (every rank but the chief's replicas
        skip)."""
        return getattr(self, "_replicas", None) is None or getattr(self, "_chief", True)

    def _root(self) -> str:
        return os.path.abspath(os.path.expanduser(self.directory))

    @property
    def _durable_enabled(self) -> bool:
        return self.enabled and self.durable_every_steps > 0

    def _durable_path(self) -> str:
        base = self.durable_directory or os.path.join(self.directory, "durable")
        return os.path.abspath(os.path.expanduser(base))

    def _tier_root(self, tier: str) -> str:
        return self._durable_path() if tier == "durable" else self._root()

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
        later = {"sharded_per_host": (self.sharded_per_host, False),
                 "process_index": (self.process_index, -1),
                 "process_count": (self.process_count, -1),
                 "host_commit_timeout_s": (self.host_commit_timeout_s, 60.0)}
        for name, (value, default) in later.items():
            if value != default:
                raise NotImplementedError(
                    f"checkpointer.{name}={value!r}: the per-host sharded "
                    "checkpoint protocol is not in the PyTorch port yet; it is "
                    "queued in ROADMAP.md (Queue 1 item 3)."
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
        steps = sorted(finalized_steps(root), reverse=True)
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
        steps = finalized_steps(self._durable_path())
        return not steps or step - steps[-1] >= self.durable_every_steps

    def _write_state(self, tree: Any, step: int, metrics: Optional[dict]) -> bool:
        """One write attempt of a host snapshot: the local tier, the
        durable promotion when due, retention; the plan's hooks in line."""
        plan = faults.active()
        if plan is not None and plan.take_save_io_failure():
            raise faults.InjectedFault(f"injected save IO failure at step {step}")
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
        tree = _state_tree(state)
        if state.shards is not None:
            tree = state.shards.gather_tree(tree)  # every rank takes part
        if not self._writes:
            if not asynchronous:
                self._barrier()  # the chief's write has landed
            return True
        tree, ready = host_snapshot(tree)
        if asynchronous:
            return self._writer().submit(step, tree, metrics, ready=ready)
        if ready is not None:
            ready.synchronize()
        saved = self._run_with_save_retries(step, lambda: self._write_state(tree, step, metrics))
        self._barrier()
        return saved

    def _tier_entries(self) -> List[Tuple[int, str]]:
        """Every retained ``(step, tier)``, newest first, the local tier
        before the durable one for the same step."""
        entries = [(s, "local") for s in finalized_steps(self._root())]
        if self._durable_enabled:
            entries += [(s, "durable") for s in finalized_steps(self._durable_path())]
        entries.sort(key=lambda e: (e[0], _TIER_PRIORITY[e[1]]), reverse=True)
        return entries

    def latest_step(self) -> Optional[int]:
        """The newest finalized step of either tier (an async write still
        in flight does not count)."""
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
        ranked = [s for s in self._ranked(root, finalized_steps(root))
                  if (self._step_metrics(root, s) or {}).get(self.keep_best_metric) is not None]
        return ranked[0] if ranked else None

    def _read_checked(self, step: int, tier: str, state: Any) -> Dict[str, Any]:
        """Read one step and check it against the live state's structure;
        raises on a torn, vanished or mismatched step."""
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

    def restore_state(self, state: Any) -> Any:
        """Restore the newest restorable step into ``state``, in place:
        every tensor is copied into the built state's own (on its device,
        in its dtype), so the optimizer's, the step's and the EMA's
        references stay valid. Returns ``state``; unchanged when disabled
        or when no step exists.

        A step that is torn, structurally unreadable, or deleted since it
        was listed is skipped with a warning and the next newest restores
        instead. Only when every retained step fails does restore raise:
        the likely cause is then a model or config mismatch."""
        if not self.enabled or not self.restore:
            return state
        entries = self._tier_entries()
        if not entries:
            return state
        last_err: Optional[Exception] = None
        for i, (step, tier) in enumerate(entries):
            try:
                tree = self._read_checked(step, tier, state)
            except Exception as e:
                last_err = e
                logger.warning(
                    "%s checkpoint step %d failed to restore (%s); falling "
                    "back to an earlier retained step", tier, step, e,
                )
                continue
            if i > 0:
                logger.warning(
                    "restored %s step %d instead of the newest retained step "
                    "%d: later step(s) were corrupt/unreadable — work since "
                    "step %d will be retrained", tier, step, entries[0][0], step,
                )
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
        if state.shards is not None:
            tree = state.shards.shard_tree(dict(tree))
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
        ranks' barrier; returns the ms spent draining (0.0 in sync mode).
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
