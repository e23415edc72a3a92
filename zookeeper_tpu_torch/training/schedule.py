"""Learning-rate schedule components.

The port of ``zookeeper_tpu/training/schedule.py``. ``build(total_steps)``
returns a :class:`ScheduleFn`, ``count -> rate`` with optax's formulas
evaluated in float32 in optax's order of operations (the JAX package
evaluates them in float32 on the device), so the update multiplies by
the same rate. Every schedule is constant past a last step (its
``horizon``), so a ``ScheduleFn`` is a float32 table of the rates at
``0..horizon``: a host ``int`` count reads it on the host, a count that
lives on the card (a 0-d integer tensor, as the train step keeps it
under a ``nan_policy`` that may skip steps) reads it there, with no
readback.
"""

from typing import Callable, List

import numpy as np
import torch

from zookeeper_tpu_torch.core import Field, component

_F = np.float32


class ScheduleFn:
    """``count -> rate``. ``fn`` maps an integer array of counts to their
    float32 rates; past ``horizon`` the rate no longer changes. A host
    ``int`` gives a ``float``; a 0-d integer tensor gives a 0-d float32
    tensor on its device."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray], horizon: int):
        self.fn = fn
        self.horizon = max(0, int(horizon))
        self._table = None
        self._device_tables = {}

    def table(self) -> np.ndarray:
        if self._table is None:
            counts = np.arange(self.horizon + 1, dtype=np.int64)
            self._table = np.asarray(self.fn(counts), dtype=np.float32).reshape(-1)
        return self._table

    def __call__(self, count):
        if isinstance(count, torch.Tensor):
            table = self._device_tables.get(count.device)
            if table is None:
                table = torch.from_numpy(self.table()).to(count.device)
                self._device_tables[count.device] = table
            # index_select, not ``table[count]``: a 0-d index tensor is
            # read back to the host, which a CUDA graph's capture forbids.
            index = count.clamp(0, self.horizon).long().reshape(1)
            return torch.index_select(table, 0, index).reshape(())
        return float(self.table()[min(max(int(count), 0), self.horizon)])


def _constant(value: float) -> ScheduleFn:
    v = _F(value)
    return ScheduleFn(lambda c: np.full(c.shape, v, dtype=np.float32), 0)


def _polynomial(init_value: float, end_value: float, power: float,
                transition_steps: int) -> ScheduleFn:
    """optax ``polynomial_schedule``: ``(init - end) * frac**power + end``,
    ``frac = 1 - clip(count, 0, T) / T``."""
    if transition_steps <= 0:
        return _constant(init_value)
    span, end, t = _F(init_value - end_value), _F(end_value), _F(transition_steps)

    def fn(count):
        c = np.clip(count, 0, transition_steps).astype(np.float32)
        frac = _F(1) - c / t
        if power != 1:
            frac = np.power(frac, _F(power))
        return span * frac + end

    return ScheduleFn(fn, transition_steps)


def _linear(init_value: float, end_value: float, transition_steps: int) -> ScheduleFn:
    """optax ``linear_schedule``: polynomial of power 1."""
    return _polynomial(init_value, end_value, 1, transition_steps)


def _cosine_values(init_value: float, decay_steps: int, alpha: float):
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}.")

    def fn(count):
        c = np.minimum(count, decay_steps).astype(np.float32)
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / _F(decay_steps)))
        decayed = _F(1 - alpha) * cosine + _F(alpha)
        return _F(init_value) * decayed

    return fn


def _cosine(init_value: float, decay_steps: int, alpha: float) -> ScheduleFn:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    return ScheduleFn(_cosine_values(init_value, decay_steps, alpha), decay_steps)


@component
class Schedule:
    """Builds ``step -> learning rate``."""

    base_lr: float = Field(1e-3)

    def build(self, total_steps: int) -> ScheduleFn:
        raise NotImplementedError


@component
class ConstantSchedule(Schedule):
    def build(self, total_steps: int) -> ScheduleFn:
        return _constant(self.base_lr)


@component
class CosineDecay(Schedule):
    alpha: float = Field(0.0)  # Final LR fraction.

    def build(self, total_steps: int) -> ScheduleFn:
        return _cosine(self.base_lr, max(1, total_steps), self.alpha)


@component
class WarmupCosine(Schedule):
    """Linear warmup from 0 (optax's ``warmup_cosine_decay_schedule`` with
    ``init_value=0.0``, so the rate at step 0 is 0), then cosine decay to
    ``base_lr * alpha`` at ``total_steps``."""

    warmup_steps: int = Field(0)
    warmup_fraction: float = Field(0.0)  # Used when warmup_steps == 0.
    alpha: float = Field(0.0)

    def build(self, total_steps: int) -> ScheduleFn:
        warmup = self.warmup_steps or int(total_steps * self.warmup_fraction)
        warmup = max(1, min(warmup, max(0, total_steps - 1)))
        peak = self.base_lr
        end = peak * self.alpha
        decay_steps = max(2, total_steps)
        warm = _linear(0.0, peak, warmup).fn
        decay = _cosine_values(peak, decay_steps - warmup, 0.0 if peak == 0.0 else end / peak)
        return ScheduleFn(
            lambda c: np.where(c < warmup, warm(c), decay(c - warmup)), decay_steps
        )


@component
class StepDecay(Schedule):
    """Piecewise-constant decay at fractional boundaries of training
    (optax ``piecewise_constant_schedule``)."""

    boundaries: List[float] = Field([0.5, 0.75])
    factor: float = Field(0.1)

    def build(self, total_steps: int) -> ScheduleFn:
        # Boundaries that collapse onto the same step (short runs)
        # compound their factors, as the JAX component's do.
        boundaries: dict = {}
        for b in self.boundaries:
            step = max(1, int(b * total_steps))
            boundaries[step] = boundaries.get(step, 1.0) * self.factor
        if any(s < 0.0 for s in boundaries.values()):
            raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")
        base = _F(self.base_lr)
        steps = sorted(boundaries.items())

        def fn(count):
            v = np.full(count.shape, base, dtype=np.float32)
            for threshold, scale in steps:
                # v * indicator + (1 - indicator) * scale * v, indicator 1
                # before the boundary and 0 from it on.
                indicator = (count < threshold).astype(np.float32)
                v = v * indicator + (_F(1) - indicator) * _F(scale) * v
            return v

        return ScheduleFn(fn, max([0] + [s for s, _ in steps]))


@component
class PolynomialDecay(Schedule):
    """Polynomial decay from base_lr to end_lr over training (power=1 is
    the classic linear decay)."""

    end_lr: float = Field(0.0)
    power: float = Field(1.0)

    def build(self, total_steps: int) -> ScheduleFn:
        return _polynomial(self.base_lr, self.end_lr, self.power, max(1, total_steps))


@component
class LinearWarmup(Schedule):
    """Linear 0 -> base_lr warmup, then constant (optax
    ``warmup_constant_schedule``)."""

    warmup_steps: int = Field(0)
    warmup_fraction: float = Field(0.05)  # Used when warmup_steps == 0.

    def build(self, total_steps: int) -> ScheduleFn:
        warmup = self.warmup_steps or int(total_steps * self.warmup_fraction)
        warmup = max(1, min(warmup, total_steps))
        return _linear(0.0, self.base_lr, warmup)
