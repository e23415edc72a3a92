"""Learning-rate schedule components.

The port of ``zookeeper_tpu/training/schedule.py``. ``build(total_steps)``
returns ``step -> learning rate`` with optax's formulas, evaluated in
float32 on the host in optax's order of operations (the JAX package
evaluates them in float32 on the device), so the update multiplies by
the same rate. ``StepDecay``, ``PolynomialDecay`` and ``LinearWarmup``
are not ported yet (ROADMAP.md).
"""

from typing import Callable

import numpy as np

from zookeeper_tpu_torch.core import Field, component

_F = np.float32


def _linear(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: polynomial of power 1."""

    def schedule(count: int) -> float:
        c = _F(min(max(count, 0), transition_steps))
        frac = _F(1) - c / _F(transition_steps)
        return float((_F(init_value) - _F(end_value)) * frac + _F(end_value))

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}.")

    def schedule(count: int) -> float:
        c = np.minimum(_F(count), _F(decay_steps))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / _F(decay_steps)))
        decayed = _F(1 - alpha) * cosine + _F(alpha)
        return float(_F(init_value) * decayed)

    return schedule


@component
class Schedule:
    """Builds ``step -> learning rate``."""

    base_lr: float = Field(1e-3)

    def build(self, total_steps: int) -> Callable[[int], float]:
        raise NotImplementedError


@component
class ConstantSchedule(Schedule):
    def build(self, total_steps: int) -> Callable[[int], float]:
        value = float(_F(self.base_lr))
        return lambda count: value


@component
class CosineDecay(Schedule):
    alpha: float = Field(0.0)  # Final LR fraction.

    def build(self, total_steps: int) -> Callable[[int], float]:
        return _cosine(self.base_lr, max(1, total_steps), self.alpha)


@component
class WarmupCosine(Schedule):
    """Linear warmup from 0 (optax's ``warmup_cosine_decay_schedule`` with
    ``init_value=0.0``, so the rate at step 0 is 0), then cosine decay to
    ``base_lr * alpha`` at ``total_steps``."""

    warmup_steps: int = Field(0)
    warmup_fraction: float = Field(0.0)  # Used when warmup_steps == 0.
    alpha: float = Field(0.0)

    def build(self, total_steps: int) -> Callable[[int], float]:
        warmup = self.warmup_steps or int(total_steps * self.warmup_fraction)
        warmup = max(1, min(warmup, max(0, total_steps - 1)))
        peak = self.base_lr
        end = peak * self.alpha
        warm = _linear(0.0, peak, warmup)
        decay = _cosine(
            peak, max(2, total_steps) - warmup, 0.0 if peak == 0.0 else end / peak
        )
        return lambda count: warm(count) if count < warmup else decay(count - warmup)
