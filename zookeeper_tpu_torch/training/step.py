"""Train and eval step builders.

The port of ``zookeeper_tpu/training/step.py``: ``make_train_step``
returns ``(state, batch) -> (state, metrics)``, one eager forward and
backward of the module in train mode (batch-statistics BatchNorms that
update their running statistics in place) and one optimizer update.
Metrics stay 0-d tensors on the device, so the caller decides when to
pay the readback. The step's options are the JAX step's: distillation
from a frozen teacher, the parameter EMA, the flip ratio of the binary
kernels, a non-finite-loss policy (selected on the card, no readback)
and a rematerialization policy (``torch.utils.checkpoint``).
:func:`host_snapshot` is the async checkpointer's copy of the state.

:func:`build_multi_step` fuses the step over a *slab* of ``k`` stacked
batches (the JAX package's ``lax.scan`` multi-step). On the card it
captures the ``k`` steps once into one ``torch.cuda.CUDAGraph`` and
replays it once per slab, so the host launches one graph where it would
launch every kernel of ``k`` steps; on the CPU it is the plain loop.
"""

import contextlib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from zookeeper_tpu_torch.ops.layers import remat_scope
from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.training.optimizer import (
    counts_to_device,
    global_norm,
    select_,
    sharded_norms,
    state_tensors,
)
from zookeeper_tpu_torch.training.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in float32, over
    the last axis of ``logits`` and every leading position (an LM's
    ``[b, s, vocab]`` against ``[b, s]`` targets), as optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``."""
    logits = logits.to(torch.float32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.long().reshape(-1))


def smoothed_softmax_cross_entropy(smoothing: float):
    """Label-smoothed cross-entropy: targets ``(1 - smoothing)`` on the
    true class plus ``smoothing / num_classes`` everywhere (optax's
    ``smooth_labels``). ``smoothing=0`` is the plain integer-label loss."""
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(
            f"label smoothing {smoothing} outside [0, 1): 0 disables; "
            "1.0 would erase the labels entirely."
        )
    if smoothing == 0.0:
        return softmax_cross_entropy

    def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = logits.to(torch.float32)
        num_classes = logits.shape[-1]
        # one_hot's label-range check reads the labels back on the CPU.
        classes = torch.arange(num_classes, device=labels.device)
        targets = (labels.long()[..., None] == classes).to(torch.float32)
        targets = targets * (1.0 - smoothing) + smoothing / num_classes
        return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()

    return loss_fn


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels.long()).to(torch.float32).mean()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of examples whose true label is in the top-k logits."""
    top = torch.topk(logits.to(torch.float32), k, dim=-1).indices
    return (top == labels.long()[..., None]).any(dim=-1).to(torch.float32).mean()


def kd_divergence(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Hinton's knowledge-distillation loss: ``T^2`` times KL(teacher ||
    student) over the temperature-softened distributions, in float32."""
    sl = student_logits.to(torch.float32) / temperature
    tl = teacher_logits.to(torch.float32) / temperature
    p_t = F.softmax(tl, dim=-1)
    kl = (p_t * (F.log_softmax(tl, dim=-1) - F.log_softmax(sl, dim=-1))).sum(-1)
    return (temperature**2) * kl.mean()


REMAT_POLICIES = ("none", "dots", "full", "quant")
NAN_POLICIES = ("ignore", "skip", "halt")

#: The matmuls with no batch dimension: what "dots" saves (JAX's
#: ``dots_with_no_batch_dims_saveable``; convolutions recompute).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_if(ops):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _apply_model(remat: str) -> Callable[[torch.nn.Module, torch.Tensor], torch.Tensor]:
    """``(module, x) -> module(x)`` under the remat policy: "none" keeps
    every activation; the others run the forward inside one
    ``torch.utils.checkpoint`` region, as JAX's ``jax.checkpoint`` wraps
    the whole apply, and recompute it for the backward, "full" saving
    nothing, "dots" the matmuls with no batch dimension, "quant" only the
    tagged quantized activations (``ops.layers.tag_quant_act``). The
    recompute leaves the BatchNorm statistics as one forward does."""
    if remat == "none":
        return lambda module, x: module(x)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    tag = remat == "quant"
    saved = {"dots": _DOTS,
             "quant": (torch.ops.zookeeper_tpu_torch.quant_act.default,)}.get(remat)

    def contexts():
        forward, recompute = remat_scope(tag=tag), remat_scope(tag=tag, recompute=True)
        if saved is None:
            return forward, recompute
        sac_forward, sac_recompute = create_selective_checkpoint_contexts(_save_if(saved))
        return _both(forward, sac_forward), _both(recompute, sac_recompute)

    # The forward draws no random numbers, so the RNG state needs no
    # saving; under a CUDA graph's capture it cannot be read.
    return lambda module, x: checkpoint(
        module, x, use_reentrant=False, context_fn=contexts,
        preserve_rng_state=not (x.is_cuda and torch.cuda.is_current_stream_capturing()))


def _bn_statistics(module: torch.nn.Module):
    return [b for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def make_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = softmax_cross_entropy,
    *,
    flip_ratio_pattern: Optional[str] = None,
    distill: Optional[Tuple] = None,
    ema_decay: Optional[float] = None,
    remat: str = "none",
    nan_policy: str = "ignore",
    replicas: Optional[Any] = None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """Build the train step. It updates ``state`` in place (parameters,
    BatchNorm statistics, optimizer state, EMA, ``step``) and returns it
    with ``{"loss", "accuracy", "grad_norm"}`` and, as the options add
    them, ``kd_loss``, ``flip_ratio`` and ``skipped_steps``.

    - ``distill``: ``(teacher_fn, alpha, temperature)``. ``teacher_fn(x)``
      runs under ``torch.no_grad()``; the loss becomes ``alpha * loss +
      (1 - alpha) * kd_divergence``.
    - ``ema_decay``: keep ``ema = d * ema + (1 - d) * params`` (the state
      must be created with ``ema=True``).
    - ``flip_ratio_pattern``: a regex over flax paths
      (``BINARY_KERNEL_PATTERN``); reports the share of the matched
      weights whose sign changed this step. A pattern that matches no
      parameter raises.
    - ``nan_policy``: "ignore"; "skip" keeps the pre-step parameters,
      optimizer state, EMA and BatchNorm statistics where the loss or the
      gradient norm is not finite, selected on the card, while
      ``state.step`` advances; "halt" does the same and the experiment
      raises at its next readback. Both report ``skipped_steps`` (0/1)
      and keep the optimizer's counts on the card.
    - ``remat``: "none", "dots", "full" or "quant" (see
      ``_apply_model``); every policy computes the same bits as "none".
    - ``replicas``: the ranks that hold copies of the parameters
      (``parallel.ReplicaGroup``, from the partitioner; None on one
      rank). Each rank runs its share of the global batch; train-mode
      BatchNorms take the moments of the global batch (forward, backward
      and a remat recompute), and the gradients and the loss are averaged
      over the ranks right after the backward, before the norm and the
      update, so the norm, the non-finite guard, the optimizer (Bop's
      flips) and the EMA agree on every rank. The other metrics are
      averaged at the end of the step. The forward runs in the
      partitioner's activation scope.

    A sharded state (``state.shards``, ``parallel.shards``) gathers the
    parameters it holds in blocks and no layer computes on before the
    forward (into leaves whose gradients the backward returns), swaps them
    into the module for the forward and backward, and reduce-scatters
    their gradients back to blocks; the tensor-parallel layers compute on
    their blocks. The gradient norm, the trust ratio, the clip and the
    flip ratio are taken over the whole tensors, so every rank takes the
    non-finite guard's decision alike.

    The active ``FaultPlan``'s ``nan_at_step`` is read here, once: the
    step whose counter (``state.step`` before it) equals it multiplies
    its loss by NaN, which poisons every gradient as a real blow-up does.
    Under a CUDA graph the counter is ``state.step_counter`` on the card
    and the factor is selected there (1 elsewhere: ``loss * 1`` is
    ``loss``).
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy {remat!r}; choose none/dots/full/quant.")
    if nan_policy not in NAN_POLICIES:
        raise ValueError(f"Unknown nan_policy {nan_policy!r}; choose ignore/skip/halt.")
    flip_paths = re.compile(flip_ratio_pattern) if flip_ratio_pattern is not None else None
    apply_model = _apply_model(remat)
    guard = nan_policy != "ignore"
    plan = faults.active()
    nan_at_step = plan.nan_at_step if plan is not None else None

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        module = state.module.train()
        batch_stats = replicas.batch_stats() if replicas is not None else contextlib.nullcontext()
        scope = (replicas.activation_scope(batch["input"].shape[0]) if replicas is not None
                 else contextlib.nullcontext())
        plan = state.shards
        params = state.params
        names = list(params)
        if ema_decay is not None and state.ema_params is None:
            raise ValueError(
                "ema_decay is set but the TrainState has no ema_params; "
                "build it with TrainState.create(..., ema=True)."
            )
        flipped = []
        if flip_paths is not None:
            flipped = [n for n in names if flip_paths.search(state.flax_paths[n])]
            if not flipped:
                raise ValueError(
                    f"flip_ratio_pattern {flip_paths.pattern!r} matched no "
                    "parameter path. Is the model actually binarized "
                    "(Quant* layers), or is the pattern misspelled? "
                    f"Available paths: {sorted(state.flax_paths.values())[:8]}..."
                )
            old_signs = [torch.sign(params[n].detach()) for n in flipped]
        if guard:
            counts_to_device(state.opt_state, params[names[0]].device)
            kept = (list(params.values()) + state_tensors(state.opt_state)
                    + list((state.ema_params or {}).values()) + _bn_statistics(module))
            olds = [t.detach().clone() for t in kept]
        whole = plan.gather_params(params, requires_grad=True) if plan is not None else {}
        swapped = plan.swapped(module, whole) if plan is not None else contextlib.nullcontext()
        with batch_stats, scope, swapped:
            logits = apply_model(module, batch["input"])
            loss = loss_fn(logits, batch["target"])
            if nan_at_step is not None:
                if state.step_counter is not None:
                    loss = loss * torch.where(state.step_counter == nan_at_step,
                                              float("nan"), 1.0)
                elif state.step == nan_at_step:
                    loss = loss * float("nan")
            kd = None
            if distill is not None:
                teacher_fn, alpha, temperature = distill
                with torch.no_grad():
                    t_logits = teacher_fn(batch["input"])
                kd = kd_divergence(logits, t_logits, temperature)
                loss = alpha * loss + (1.0 - alpha) * kd
            grads = dict(zip(names, torch.autograd.grad(
                loss, [whole.get(n, p) for n, p in params.items()])))
        loss = loss.detach()
        if plan is not None:
            loss = loss.clone()
            plan.reduce_gradients(grads, [loss], replicas)
        elif replicas is not None:
            loss = loss.clone()
            replicas.mean_([*grads.values(), loss])
        with sharded_norms(plan):
            grad_norm = global_norm(grads.values(), names)
            state.apply_gradients(grads)
        with torch.no_grad():
            if ema_decay is not None:
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [params[n].detach() for n in names], 1.0 - ema_decay))
            if guard:
                ok = torch.isfinite(loss.detach()) & torch.isfinite(grad_norm)
                select_(ok, [t.detach() for t in kept], olds)
        metrics = {
            "loss": loss,
            "accuracy": accuracy(logits.detach(), batch["target"]),
            "grad_norm": grad_norm,
        }
        if guard:
            metrics["skipped_steps"] = (~ok).to(torch.float32)
        if kd is not None:
            metrics["kd_loss"] = kd.detach()
        if flip_paths is not None:
            counts = [(torch.sign(params[n].detach()) != s).sum() for n, s in zip(flipped, old_signs)]
            total = sum(params[n].numel() for n in flipped)
            if plan is not None:
                counts = plan.whole_sums(counts, flipped)
                total = sum(plan.numel(n, params[n]) for n in flipped)
            flips = sum(counts)
            # A fill, not a host copy: a graph's capture allows no copy.
            metrics["flip_ratio"] = flips.to(torch.float32) / torch.full(
                (), float(total), dtype=torch.float32, device=flips.device)
        if replicas is not None:
            # The parameters agree on every rank (each block on the ranks
            # that hold it), so the flip ratio, the norm and the skip flag
            # do; the rest are per-rank means.
            local = [metrics[k] for k in ("accuracy", "kd_loss") if k in metrics]
            replicas.mean_(local)
        return state, metrics

    return train_step


def make_eval_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = softmax_cross_entropy,
    *,
    use_ema: bool = False,
    top5: bool = False,
) -> Callable[[TrainState, Batch], Metrics]:
    """Build the eval step: the module in eval mode (running statistics),
    no gradient. ``use_ema`` scores the EMA weights (the ones that ship)
    instead of the parameters; ``top5`` adds top-5 accuracy. A sharded
    state gathers the blocks no layer computes on, as the train step
    does."""

    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        module = state.module.eval()
        if use_ema and state.ema_params is None:
            raise ValueError(
                "use_ema=True but the TrainState has no ema_params; "
                "build it with TrainState.create(..., ema=True)."
            )
        plan = state.shards
        with torch.no_grad():
            if use_ema:
                weights = dict(state.ema_params)
                if plan is not None:
                    weights.update(plan.gather_params(weights))
                logits = torch.func.functional_call(module, weights, (batch["input"],))
            elif plan is not None:
                with plan.swapped(module, plan.gather_params(state.params)):
                    logits = module(batch["input"])
            else:
                logits = module(batch["input"])
            metrics = {
                "loss": loss_fn(logits, batch["target"]),
                "accuracy": accuracy(logits, batch["target"]),
            }
            if top5:
                metrics["top5_accuracy"] = top_k_accuracy(logits, batch["target"], k=5)
        return metrics

    return eval_step


# -- the fused multi-step ---------------------------------------------------


def _launch_counters() -> List[Dict[str, int]]:
    """The kernel wrappers' launch (and copy) counters, bumped in Python
    where a wrapper launches: a graph's capture bumps them without
    launching, each replay launches without bumping."""
    from zookeeper_tpu_torch.ops import attention, binary_compute

    return [binary_compute.LAUNCHES, binary_compute.COPIES, attention.LAUNCHES]


def _stack_metrics(per_step: List[Metrics]) -> Metrics:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def _slab_steps(step_fn, state: TrainState, slab: Batch) -> Tuple[TrainState, Metrics]:
    """The plain multi-step: ``step_fn`` over the slab's leading axis,
    the metrics stacked ``[k]``."""
    k = int(next(iter(slab.values())).shape[0])
    per_step = []
    for i in range(k):
        state, metrics = step_fn(state, {key: v[i] for key, v in slab.items()})
        per_step.append(metrics)
    return state, _stack_metrics(per_step)


def state_storage(state: TrainState) -> Tuple[int, ...]:
    """The addresses of every tensor of the state: parameters, buffers
    (the BatchNorm statistics), optimizer state (its counts on the card
    included), EMA and ``step_counter``. A graph replays these addresses,
    so a state that rebinds any of them needs a new capture."""
    tensors = (list(state.module.parameters()) + list(state.module.buffers())
               + state_tensors(state.opt_state) + list((state.ema_params or {}).values()))
    if state.step_counter is not None:
        tensors.append(state.step_counter)
    return tuple(t.data_ptr() for t in tensors)


def prepare_for_graph(state: TrainState, device: torch.device) -> TrainState:
    """Move what the step reads on the host to ``device``: every
    optimizer count (``counts_to_device``) and the step
    (``state.step_counter``). A replay runs no host code, so a value the
    step would read on the host would stay as it was at the capture."""
    counts_to_device(state.opt_state, device)
    if state.step_counter is None:
        state.step_counter = torch.zeros((), dtype=torch.int64, device=device)
    state.step_counter.fill_(state.step)
    return state


class _SlabGraph:
    """One captured slab: the graph, its input buffers (a slab is copied
    in before each replay), its ``[k]`` metrics (overwritten by each
    replay), the state's addresses at the capture and the launches a
    replay makes."""

    def __init__(self, graph, slab, metrics, storage, launches, capture_s):
        self.graph, self.slab, self.metrics = graph, slab, metrics
        self.storage, self.launches, self.capture_s = storage, launches, capture_s
        self.replays = 0


class MultiStep:
    """``(state, slab) -> (state, metrics stacked [k])``: ``step_fn`` run
    over the slab's leading axis (:func:`build_multi_step`).

    On CPU tensors it is the plain loop. On the card the first slab runs
    eagerly on a side stream (the warm-up ``torch.cuda.graphs``
    prescribes: the CUDA libraries built at first use, cuBLAS and cuDNN
    handles and workspaces, the tables read by counts on the card are
    made here, outside any capture), and each later slab replays a graph
    of its ``k`` steps, captured once per slab shape (an epoch has at
    most two: the steady ``unroll`` and a partial last slab) and again
    whenever a state tensor was rebound. The graph replays on the
    caller's stream, so a ``host_snapshot`` taken between slabs queues
    behind it and the next replay behind the snapshot's copies. A
    failed capture or replay raises; nothing falls back to the eager
    loop. ``graphs`` maps each slab signature to its :class:`_SlabGraph`."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.graphs: Dict[tuple, _SlabGraph] = {}
        self.warmed = False
        self._stream = None
        self._pool = None

    def __call__(self, state: TrainState, slab: Batch) -> Tuple[TrainState, Metrics]:
        first = next(iter(slab.values()))
        if first.device.type != "cuda":
            return _slab_steps(self.step_fn, state, slab)
        device = first.device
        prepare_for_graph(state, device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if not self.warmed:
            return self._warm_up(state, slab)
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in slab.items())
        graph = self.graphs.get(key)
        if graph is None or graph.storage != state_storage(state):
            graph = self.graphs[key] = self._capture(state, slab)
        for name, buf in graph.slab.items():
            buf.copy_(slab[name])
        graph.graph.replay()
        graph.replays += 1
        for counts, delta in zip(_launch_counters(), graph.launches):
            for name, n in delta.items():
                counts[name] += n
        state.step += int(first.shape[0])
        return state, {k: v.clone() for k, v in graph.metrics.items()}

    def _warm_up(self, state: TrainState, slab: Batch) -> Tuple[TrainState, Metrics]:
        current, side = torch.cuda.current_stream(self._stream.device), self._stream
        side.wait_stream(current)
        for v in slab.values():
            v.record_stream(side)
        with torch.cuda.stream(side):
            state, metrics = _slab_steps(self.step_fn, state, slab)
        current.wait_stream(side)
        for v in metrics.values():
            v.record_stream(current)
        self.warmed = True
        return state, metrics

    def _capture(self, state: TrainState, slab: Batch) -> _SlabGraph:
        buffers = {k: torch.empty_like(v) for k, v in slab.items()}
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        host_step = state.step
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        self._stream.wait_stream(torch.cuda.current_stream(self._stream.device))
        try:
            # "thread_local": the loader's prefetch thread keeps pinning and
            # copying the next batches on its own stream while this thread
            # captures; in the default global mode such a call from another
            # thread invalidates the capture.
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                _, metrics = _slab_steps(self.step_fn, state, buffers)
        finally:
            # The capture ran the host code but no kernel: the state is
            # as it was, and nothing was launched.
            state.step = host_step
            launches = [{n: c[n] - b[n] for n in c if c[n] != b[n]}
                        for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.update(b)
        capture_s = time.perf_counter() - t0
        # Both shapes of an epoch share one pool: they never replay at once.
        self._pool = graph.pool()
        return _SlabGraph(graph, buffers, metrics, state_storage(state), launches, capture_s)


def build_multi_step(step_fn) -> MultiStep:
    """Fuse a ``(state, batch) -> (state, metrics)`` step into a
    ``(state, slab) -> (state, metrics stacked [k])`` multi-step over a
    slab of ``k`` stacked batches (``data.pipeline.slab_iterator``): the
    port of the JAX package's ``lax.scan`` multi-step. The same steps on
    the same batches in the same order, so the same bits as ``k`` calls
    of ``step_fn``: on the CPU the plain loop, on the card one CUDA graph
    per slab shape (:class:`MultiStep`), with the optimizer's counts and
    the step counter on the card (:func:`prepare_for_graph`)."""
    return MultiStep(step_fn)


def host_snapshot(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """A copy of a nested dict of tensors (and host ints) that owns its
    bytes, for a checkpoint written while training goes on: every card
    tensor is copied into pinned host memory by a non-blocking copy on
    the current stream, the stream the step runs on and the fused loop's
    graph replays on, so the next step's (or slab's) in-place writes
    queue behind the copies; a CPU tensor is cloned.
    Returns ``(copy, event)``, the event recorded after the copies (None
    when no tensor lies on a card): wait on it before reading the copy."""
    devices = []

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type != "cuda":
            return x.clone()
        devices.append(x.device)
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    out = copy(tree)
    event = None
    if devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(devices[0]))
    return out, event
