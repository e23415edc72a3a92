"""Optimizer components.

The port of ``zookeeper_tpu/training/optimizer.py``: ``Sgd``,
``Momentum``, ``Adam``/``AdamW``, ``Rmsprop``, ``Lamb``, ``Lars``,
gradient accumulation (``accumulate_steps``, optax ``MultiSteps``) and
``Bop``, the binary nets' optimizer. Each builds the optax chain the JAX
component builds — ``clip_by_global_norm`` (when set), then
``add_decayed_weights`` unless the core applies the decay itself, then
the core's own stages (``scale_by_adam``, ``trace``, ``scale_by_rms``,
``scale_by_trust_ratio``, ``scale_by_learning_rate``) — as plain tensor
code in optax 0.2.6's order of operations, each step rounding as one
optax op does, mostly as multi-tensor ``torch._foreach_*`` ops; not
``torch.optim``, whose arithmetic differs.

A transform's state is a dict under optax's names (``count``, ``mu``,
``nu``, ``trace``, ``gradient_memory``, ``mini_step``, ...), each
per-parameter entry a ``{name: tensor}`` dict. ``count`` (the updates
applied, which drives the schedules) is a host ``int``; a train step
under a ``nan_policy`` that may skip a step moves every count to the
card as a 0-d int32 tensor (:func:`counts_to_device`), and the
schedules read it there, so skipping a step needs no readback. So does
the fused loop's CUDA graph (``training.step.build_multi_step``), which
replays no host code. Every count-dependent scalar on the card is read
from a float32 table of the host's values (the schedules' tables, the
Adam bias corrections' :func:`_bias_table`), and a division by one takes
the host float's route (:func:`_foreach_div`), so a count on the card
gives the host's bits.

Under sharded parameters (``parallel.shards``) every tensor a transform
sees is this rank's block, and the elementwise stages need nothing more.
The stages that reduce over whole tensors (the global norm of
``ClipByGlobalNorm`` and of the train step's ``grad_norm``,
``ScaleByTrustRatio``'s per-parameter norms) complete each block's norm
over its group inside :func:`sharded_norms`, so every rank computes the
same clip and trust ratio.
"""

import contextlib
import re
from contextvars import ContextVar
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from zookeeper_tpu_torch.core import (
    ComponentField,
    Field,
    component,
    configured_field_names,
)
from zookeeper_tpu_torch.models.convert import COUNT_KEYS
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN
from zookeeper_tpu_torch.training.schedule import ConstantSchedule, Schedule

_F = np.float32
Params = Mapping[str, torch.Tensor]
Knob = Union[float, Callable]


_SHARDS: ContextVar[Optional[Any]] = ContextVar("zk_torch_norm_shards", default=None)


@contextlib.contextmanager
def sharded_norms(plan: Optional[Any]):
    """Inside the block, the norms of named tensors that ``plan`` (a
    ``parallel.shards.ShardPlan``, or None) shards are the norms of the
    whole tensors."""
    token = _SHARDS.set(plan)
    try:
        yield
    finally:
        _SHARDS.reset(token)


def tensor_norms(tensors, names=None) -> List[torch.Tensor]:
    """The L2 norm of each tensor (a 0-d tensor each): of the whole tensor
    where an active :func:`sharded_norms` plan shards ``names[i]``."""
    norms = torch._foreach_norm(list(tensors))
    plan = _SHARDS.get()
    if plan is None or names is None:
        return norms
    return plan.whole_norms(norms, list(names))


def global_norm(tensors, names=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's
    ``global_norm``), as a 0-d tensor on the tensors' device; ``names``
    completes sharded tensors (:func:`tensor_norms`)."""
    return torch.linalg.vector_norm(torch.stack(tensor_norms(tensors, names)))


def counts_to_device(state: Dict[str, Any], device: torch.device) -> None:
    """Move every host count of an optimizer state (nested dicts) to
    ``device`` as a 0-d int32 tensor, in place."""
    for key, value in state.items():
        if isinstance(value, dict):
            counts_to_device(value, device)
        elif key in COUNT_KEYS and isinstance(value, int):
            state[key] = torch.tensor(value, dtype=torch.int32, device=device)


def state_tensors(state: Any) -> List[torch.Tensor]:
    """Every tensor of a nested state dict, in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in state_tensors(v)]
    return []


def select_(ok: torch.Tensor, tensors: List[torch.Tensor], olds: List[torch.Tensor]) -> None:
    """``t = ok ? t : old`` for each pair, in place, ``ok`` a bool on the
    card (optax's and the train step's ``jnp.where`` selects)."""
    for t, old in zip(tensors, olds):
        torch.where(ok, t, old, out=t)


def _increment(state: Dict[str, Any], key: str) -> None:
    count = state[key]
    if isinstance(count, torch.Tensor):
        count.add_(1)
    else:
        state[key] = count + 1


def _knob(value: Knob, count):
    """A knob's value at ``count``: the float itself, or its schedule at
    ``count`` (a float32 value: a host float, or a 0-d tensor on the
    card)."""
    return value(count) if callable(value) else value


def _host_bias_correction(decay: float, count: int) -> float:
    return float(_F(1) - _F(decay) ** _F(count))


def _bias_table(decay: float) -> torch.Tensor:
    """The host's ``1 - decay**count`` for counts 0.. up to the first
    count where it rounds to 1 in float32 (it stays 1 past it), as a
    float32 table: a count on the card reads the host's values, so the
    two branches agree bit for bit on any card (``torch.pow`` there need
    not round as the host's ``powf``)."""
    values = [_host_bias_correction(decay, 0)]
    while values[-1] != 1.0:
        values.append(_host_bias_correction(decay, len(values)))
    return torch.tensor(values, dtype=torch.float32)


def _bias_correction(decay: float, count, tables: Optional[Dict[Any, torch.Tensor]] = None):
    """optax's ``1 - decay**count`` in float32: on the host for an int
    count, from :func:`_bias_table` (made once per device into
    ``tables``) for a count on the card."""
    if isinstance(count, torch.Tensor):
        if abs(decay) >= 1:  # no saturation, so no finite table
            return 1 - torch.pow(decay, count.to(torch.float32))
        tables = {} if tables is None else tables
        key = (float(decay), count.device)
        if key not in tables:
            tables[key] = _bias_table(decay).to(count.device)
        table = tables[key]
        index = count.clamp(0, table.numel() - 1).long().reshape(1)
        return torch.index_select(table, 0, index).reshape(())
    return _host_bias_correction(decay, count)


def _foreach_div(tensors: List[torch.Tensor], divisor) -> List[torch.Tensor]:
    """``t / divisor`` for each tensor, ``divisor`` a host float or a 0-d
    float32 tensor holding the value the host would pass. PyTorch divides
    by a host float on a card as ``t * (1 / divisor)`` (the reciprocal
    rounded to float32), and by a tensor as ``t / divisor``; on the CPU
    both are the division. A divisor on the card takes the same route as
    a host float there, so a count on the card gives the host count's
    bits."""
    if isinstance(divisor, torch.Tensor) and divisor.device.type == "cuda":
        return torch._foreach_mul(tensors, torch.reciprocal(divisor))
    return torch._foreach_div(tensors, divisor)


class Transform:
    """An optax gradient transformation over dicts of named tensors.
    ``init(params, paths)`` returns the state (``paths`` maps each name to
    its flax path, for transforms that split by path);
    ``updates(grads, state, params)`` returns ``{name: update}`` and
    advances the state in place (an update may share storage with the
    state: read it, never write it); ``update`` also adds the updates to
    the parameters in place (optax ``apply_updates``)."""

    def init(self, params: Params, paths: Optional[Mapping[str, str]] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def updates(self, grads: Params, state: Dict[str, Any], params: Params) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def update(self, grads: Params, state: Dict[str, Any], params: Params) -> None:
        updates = self.updates(grads, state, params)
        names = list(updates)
        if names:
            torch._foreach_add_([params[n] for n in names], [updates[n] for n in names])


# -- the chain's stages: (updates, state, params, count) -> updates ---------


class _Stage:
    keys = ()

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
                         for n, p in params.items()}
        return {key: zeros() for key in self.keys}

    def apply(self, u, state, p, names, count):
        raise NotImplementedError


class ClipByGlobalNorm(_Stage):
    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def apply(self, u, state, p, names, count):
        norm = global_norm(u, names)
        scaled = torch._foreach_mul(torch._foreach_div(u, norm), self.max_norm)
        keep = norm < self.max_norm
        return [torch.where(keep, a, b) for a, b in zip(u, scaled)]


class AddDecayedWeights(_Stage):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def apply(self, u, state, p, names, count):
        return torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))


class ScaleByAdam(_Stage):
    keys = ("mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self._tables: Dict[Any, torch.Tensor] = {}

    def apply(self, u, state, p, names, count):
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        # mu = (1 - b1) * g + b1 * mu
        t = torch._foreach_mul(u, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, t)
        # nu = (1 - b2) * g**2 + b2 * nu
        t = torch._foreach_mul(u, u)
        torch._foreach_mul_(t, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, t)
        out = _foreach_div(mu, _bias_correction(self.b1, count + 1, self._tables))
        den = _foreach_div(nu, _bias_correction(self.b2, count + 1, self._tables))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(out, den)
        return out


class ScaleByRms(_Stage):
    """optax ``scale_by_rms`` (``initial_scale`` 0, ``eps`` in the root)."""

    keys = ("nu",)

    def __init__(self, decay: float, eps: float):
        self.decay, self.eps = decay, eps

    def apply(self, u, state, p, names, count):
        nu = [state["nu"][n] for n in names]
        t = torch._foreach_mul(u, u)
        torch._foreach_mul_(t, 1 - self.decay)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_add_(nu, t)
        scaling = [torch.rsqrt(n) for n in torch._foreach_add(nu, self.eps)]
        return torch._foreach_mul(scaling, u)


class ScaleByTrustRatio(_Stage):
    """optax ``scale_by_trust_ratio`` (``min_norm`` 0): each update times
    ``trust_coefficient * |p| / (|u| + eps)``, or 1 where a norm is 0."""

    def __init__(self, trust_coefficient: float = 1.0, eps: float = 0.0):
        self.trust_coefficient, self.eps = trust_coefficient, eps

    def apply(self, u, state, p, names, count):
        if not u:
            return u
        p_norm = torch.stack(tensor_norms(p, names))
        u_norm = torch.stack(tensor_norms(u, names))
        ratio = self.trust_coefficient * p_norm / (u_norm + self.eps)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)
        return [x * r for x, r in zip(u, ratio.unbind())]


class ScaleByLearningRate(_Stage):
    def __init__(self, learning_rate: Callable):
        self.learning_rate = learning_rate

    def apply(self, u, state, p, names, count):
        lr = self.learning_rate(count)
        neg = -lr if isinstance(lr, torch.Tensor) else float(-_F(lr))
        return torch._foreach_mul(u, neg)


class Trace(_Stage):
    """optax ``trace``: ``t = g + decay * t``; the update is ``t``, or
    ``g + decay * t`` with ``nesterov``."""

    keys = ("trace",)

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def apply(self, u, state, p, names, count):
        trace = [state["trace"][n] for n in names]
        torch._foreach_mul_(trace, self.decay)
        torch._foreach_add_(trace, u)
        if not self.nesterov:
            return trace
        out = torch._foreach_mul(trace, self.decay)
        torch._foreach_add_(out, u)
        return out


class Chain(Transform):
    """optax ``chain`` of stages ending in the learning rate, over one
    ``count`` of applied updates that every stage reads before it
    advances (optax's per-stage counts move together)."""

    def __init__(self, stages: List[_Stage]):
        self.stages = list(stages)

    def init(self, params: Params, paths=None) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        for stage in self.stages:
            state.update(stage.init(params))
        return state

    def updates(self, grads, state, params):
        names = list(params)
        u = [grads[n] for n in names]
        p = [params[n] for n in names]
        if names:
            for stage in self.stages:
                u = stage.apply(u, state, p, names, state["count"])
        _increment(state, "count")
        return dict(zip(names, u))


class MultiSteps(Transform):
    """optax ``MultiSteps`` (``use_grad_mean``): the running mean
    ``acc + (g - acc) / (n + 1)`` of ``every_k`` micro-steps' gradients
    feeds the inner transform once every ``every_k`` calls, whose counts
    (the schedules, Bop's knobs) advance only then. With host counts the
    inner transform runs only on those boundaries, so off them the
    parameters do not move. With counts on the card the boundary is not
    known to the host: as optax does, the inner transform runs every
    call, and its state and (times 0 or 1) its updates are selected on
    the card."""

    def __init__(self, inner: Transform, every_k: int):
        self.inner, self.every_k = inner, int(every_k)

    def init(self, params, paths=None):
        return {
            "mini_step": 0,
            "gradient_step": 0,
            "inner_opt_state": self.inner.init(params, paths),
            "acc_grads": {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                          for n, p in params.items()},
        }

    def updates(self, grads, state, params):
        names = list(params)
        acc = [state["acc_grads"][n] for n in names]
        n_acc = state["mini_step"]
        k = self.every_k
        if names:
            d = _foreach_div(torch._foreach_sub([grads[n] for n in names], acc),
                             (n_acc + 1).to(torch.float32)
                             if isinstance(n_acc, torch.Tensor) else float(n_acc + 1))
            torch._foreach_add_(acc, d)
        inner_state = state["inner_opt_state"]
        if not isinstance(n_acc, torch.Tensor):
            state["mini_step"] = (n_acc + 1) % k
            if n_acc != k - 1:
                return {}
            out = self.inner.updates(dict(zip(names, acc)), inner_state, params)
            state["gradient_step"] += 1
            if names:
                torch._foreach_mul_(acc, 0.0)
            return out
        emit = n_acc == k - 1
        olds = [t.clone() for t in state_tensors(inner_state)]
        keep = emit.to(torch.float32)
        # The updates times 0 or 1 first: an update may share the state's
        # storage, which the select below may put back.
        out = {n: u * keep for n, u in
               self.inner.updates(dict(zip(names, acc)), inner_state, params).items()}
        select_(emit, state_tensors(inner_state), olds)
        state["gradient_step"].add_(emit.to(torch.int32))
        n_acc.add_(1).remainder_(k)
        if names:
            torch._foreach_mul_(acc, 1 - keep)
        return out


class BopTransform(Transform):
    """optax-style ``scale_by_bop`` (Helwegen et al. 2019): the gradient
    memory ``m = (1 - gamma) m + gamma g``; where ``|m| > threshold`` and
    ``sign(m) == sign(w)`` the update is ``-2w`` (a sign flip once added),
    else 0. Added as optax adds it, ``w + 0`` turns an unflipped -0.0 into
    +0.0. ``threshold`` and ``gamma`` are floats or schedules of the Bop
    ``count``."""

    def __init__(self, threshold: Knob = 1e-8, gamma: Knob = 1e-4):
        self.threshold, self.gamma = threshold, gamma

    def init(self, params, paths=None):
        return {"gradient_memory": {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                                    for n, p in params.items()},
                "count": 0}

    def updates(self, grads, state, params):
        names = list(params)
        count = state["count"]
        out = {}
        if names:
            gamma = _knob(self.gamma, count)
            threshold = _knob(self.threshold, count)
            if isinstance(gamma, torch.Tensor):
                keep = 1 - gamma
            elif callable(self.gamma):
                keep = float(_F(1) - _F(gamma))
            else:
                keep = 1.0 - gamma
            m = [state["gradient_memory"][n] for n in names]
            torch._foreach_mul_(m, keep)
            torch._foreach_add_(m, torch._foreach_mul([grads[n] for n in names], gamma))
            for n, mi in zip(names, m):
                w = params[n]
                flip = (mi.abs() > threshold) & (torch.sign(mi) == torch.sign(w))
                out[n] = torch.where(flip, w * -2.0, 0.0)
        _increment(state, "count")
        return out


#: The JAX package's name for Bop's transform (its state is optax's
#: ``BopState``: ``{"gradient_memory", "count"}``).
scale_by_bop = BopTransform


class BopSplit(Transform):
    """optax ``multi_transform`` of Bop and the fp optimizer, labelled by
    flax path: a parameter whose path ``pattern`` matches is "binary"
    (Bop), every other "fp". Each side sees only its own leaves (the fp
    side's clip norm, its Adam moments)."""

    def __init__(self, pattern: str, bop: Transform, fp: Transform):
        self.pattern = re.compile(pattern)
        self.bop, self.fp = bop, fp
        self.labels: Dict[str, str] = {}

    def init(self, params, paths=None):
        paths = paths or {n: n for n in params}
        self.labels = {n: "binary" if self.pattern.search(paths[n]) else "fp" for n in params}
        return {side: tx.init(self._side(params, side))
                for side, tx in (("binary", self.bop), ("fp", self.fp))}

    def _side(self, tree, side):
        return {n: t for n, t in tree.items() if self.labels[n] == side}

    def updates(self, grads, state, params):
        out = {}
        for side, tx in (("binary", self.bop), ("fp", self.fp)):
            out.update(tx.updates(self._side(grads, side), state[side], self._side(params, side)))
        return {n: out[n] for n in params if n in out}


# -- components -------------------------------------------------------------


@component
class Optimizer:
    """Builds the update rule. ``schedule`` supplies the per-step learning
    rate; ``weight_decay`` and ``global_clip_norm`` live on the base, as
    in the JAX package."""

    schedule: Schedule = ComponentField(ConstantSchedule)
    weight_decay: float = Field(0.0)
    global_clip_norm: float = Field(0.0)
    #: Gradient accumulation: apply updates every N steps on the mean of
    #: N micro-batch gradients (optax ``MultiSteps``). ``state.step``
    #: counts micro-steps.
    accumulate_steps: int = Field(1)

    #: Set where the core applies ``weight_decay`` itself (AdamW, LAMB,
    #: LARS), so the base chain does not apply it twice.
    _core_handles_weight_decay = False

    def _core(self, learning_rate) -> List[_Stage]:
        raise NotImplementedError

    def _applied_steps(self, total_steps: int) -> int:
        """Updates applied in a run of ``total_steps`` micro-steps: the
        schedules count those."""
        if self.accumulate_steps > 1:
            return max(1, -(-total_steps // self.accumulate_steps))
        return total_steps

    def _wrap_accumulation(self, tx: Transform) -> Transform:
        if self.accumulate_steps > 1:
            tx = MultiSteps(tx, self.accumulate_steps)
        return tx

    def build(self, total_steps: int, *, _accumulate: bool = True) -> Transform:
        """``total_steps`` counts micro-steps; ``_accumulate=False`` is
        for an optimizer (Bop) that wraps accumulation once around a
        composite itself."""
        lr = self.schedule.build(self._applied_steps(total_steps))
        stages: List[_Stage] = []
        if self.global_clip_norm > 0:
            stages.append(ClipByGlobalNorm(self.global_clip_norm))
        if self.weight_decay > 0 and not self._core_handles_weight_decay:
            stages.append(AddDecayedWeights(self.weight_decay))
        tx = Chain(stages + self._core(lr))
        return self._wrap_accumulation(tx) if _accumulate else tx


@component
class Sgd(Optimizer):
    def _core(self, lr):
        return [ScaleByLearningRate(lr)]


@component
class Momentum(Optimizer):
    momentum: float = Field(0.9)
    nesterov: bool = Field(False)

    def _core(self, lr):
        return [Trace(self.momentum, self.nesterov), ScaleByLearningRate(lr)]


@component
class Adam(Optimizer):
    """optax ``adam``; with ``weight_decay > 0``, optax ``adamw``
    (decoupled decay), as the JAX component builds it."""

    b1: float = Field(0.9)
    b2: float = Field(0.999)
    eps: float = Field(1e-8)

    _core_handles_weight_decay = True

    def _core(self, lr):
        decay = [AddDecayedWeights(self.weight_decay)] if self.weight_decay > 0 else []
        return [ScaleByAdam(self.b1, self.b2, self.eps), *decay, ScaleByLearningRate(lr)]


@component
class AdamW(Adam):
    weight_decay: float = Field(1e-4)


@component
class Rmsprop(Optimizer):
    decay: float = Field(0.9)
    eps: float = Field(1e-8)
    momentum: float = Field(0.0)

    def _core(self, lr):
        # optax ``rmsprop`` with a momentum (0.0 included): the trace
        # follows the learning rate.
        return [ScaleByRms(self.decay, self.eps), ScaleByLearningRate(lr), Trace(self.momentum)]


@component
class Lamb(Optimizer):
    """LAMB (You et al. 2020): layerwise-adaptive Adam for large-batch
    training (optax ``lamb``)."""

    b1: float = Field(0.9)
    b2: float = Field(0.999)
    eps: float = Field(1e-6)

    _core_handles_weight_decay = True

    def _core(self, lr):
        return [ScaleByAdam(self.b1, self.b2, self.eps), AddDecayedWeights(self.weight_decay),
                ScaleByTrustRatio(), ScaleByLearningRate(lr)]


@component
class Lars(Optimizer):
    """LARS (You et al. 2017): layerwise-adaptive momentum SGD for
    large-batch training (optax ``lars``)."""

    momentum: float = Field(0.9)
    trust_coefficient: float = Field(0.001)

    _core_handles_weight_decay = True

    def _core(self, lr):
        return [AddDecayedWeights(self.weight_decay), ScaleByTrustRatio(self.trust_coefficient),
                ScaleByLearningRate(lr), Trace(self.momentum)]


@component
class Bop(Optimizer):
    """Binary optimizer (larq ``Bop`` with its ``CaseOptimizer``): Bop
    flips the sign-read kernels of the Quant* layers, the parameters whose
    flax path ``binary_param_pattern`` matches; every other parameter
    (BatchNorm, the fp stem and head, biases) trains under
    ``fp_optimizer``.

    Bop has no learning rate: ``gamma`` (the gradient memory's rate) and
    ``threshold`` are its knobs, each a float or, through
    ``gamma_schedule``/``threshold_schedule``, a schedule whose
    ``base_lr`` is the knob's initial value (the flat field then left
    unset). ``weight_decay``, ``global_clip_norm`` and ``schedule`` set on
    Bop itself raise: they belong on ``fp_optimizer``. Accumulation wraps
    the split once, so Bop's memory sees the mean of the micro-batches'
    gradients."""

    threshold: float = Field(1e-8)
    gamma: float = Field(1e-4)
    gamma_schedule: Schedule = ComponentField(ConstantSchedule)
    threshold_schedule: Schedule = ComponentField(ConstantSchedule)
    binary_param_pattern: str = Field(BINARY_KERNEL_PATTERN)
    fp_optimizer: Optimizer = ComponentField(Adam)

    def _knob(self, name: str, flat_value: float, sched, total_steps: int) -> Knob:
        """The configured schedule when present (its base_lr is the initial
        value), else the flat float."""
        configured = type(sched) is not ConstantSchedule or bool(configured_field_names(sched))
        if not configured:
            return flat_value
        if name in configured_field_names(self):
            raise ValueError(
                f"Both Bop.{name} and Bop.{name}_schedule are configured — "
                f"set the initial value on {name}_schedule.base_lr and "
                f"leave {name} unset (two sources of truth would pick a "
                "silent winner)."
            )
        return sched.build(self._applied_steps(total_steps))

    def build(self, total_steps: int, *, _accumulate: bool = True) -> Transform:
        if self.weight_decay > 0 or self.global_clip_norm > 0:
            raise ValueError(
                "Bop has no weight decay / gradient clipping (sign flips "
                "have no magnitude to decay or clip). Configure "
                "fp_optimizer.weight_decay / fp_optimizer.global_clip_norm "
                "for the full-precision parameters instead."
            )
        if type(self.schedule) is not ConstantSchedule or configured_field_names(self.schedule):
            raise ValueError(
                "Bop has no learning rate, so a schedule configured on Bop "
                "itself would be silently dead. Schedule the fp side via "
                "fp_optimizer.schedule.* (Bop's own knobs are gamma/"
                "threshold, schedulable via gamma_schedule/"
                "threshold_schedule)."
            )
        fp_tx = self.fp_optimizer.build(total_steps, _accumulate=False)
        bop_tx = BopTransform(
            self._knob("threshold", self.threshold, self.threshold_schedule, total_steps),
            self._knob("gamma", self.gamma, self.gamma_schedule, total_steps),
        )
        tx = BopSplit(self.binary_param_pattern, bop_tx, fp_tx)
        return self._wrap_accumulation(tx) if _accumulate else tx
