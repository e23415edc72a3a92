"""Optimizer components.

The port of ``zookeeper_tpu/training/optimizer.py`` for Adam and AdamW.
The update is plain tensor code in optax's order of operations —
``clip_by_global_norm`` (when set), ``scale_by_adam`` (``mu = (1-b1) g +
b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, ``mu_hat / (sqrt(nu_hat) + eps)``),
the decoupled weight decay of ``adamw`` (when set), then ``* -lr`` and
the add to the parameters — not ``torch.optim.Adam``, whose arithmetic
differs. It runs as multi-tensor ``torch._foreach_*`` ops, each rounding
as one optax op does. ``Bop``, ``Sgd``, ``Momentum``, ``Rmsprop``,
``Lamb``, ``Lars`` and gradient accumulation are not ported yet
(ROADMAP.md).
"""

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from zookeeper_tpu_torch.core import ComponentField, Field, component
from zookeeper_tpu_torch.training.schedule import ConstantSchedule, Schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's
    ``global_norm``), as a 0-d tensor on the tensors' device."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamTransform:
    """optax ``adam``/``adamw`` (optionally behind ``clip_by_global_norm``)
    over a dict of named parameters. The state is ``{"count": int, "mu":
    {name: tensor}, "nu": {name: tensor}}``; ``count`` is the number of
    updates applied, which also drives the schedule."""

    def __init__(
        self,
        learning_rate: Callable[[int], float],
        b1: float,
        b2: float,
        eps: float,
        weight_decay: float = 0.0,
        clip_norm: float = 0.0,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": {n: torch.zeros_like(p, memory_format=torch.preserve_format) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, memory_format=torch.preserve_format) for n, p in params.items()},
        }

    def update(
        self,
        grads: Mapping[str, torch.Tensor],
        state: Dict[str, Any],
        params: Mapping[str, torch.Tensor],
    ) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        names = list(params)
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        if self.clip_norm > 0:
            norm = global_norm(g)
            scaled = torch._foreach_mul(torch._foreach_div(g, norm), self.clip_norm)
            keep = norm < self.clip_norm
            g = [torch.where(keep, a, b) for a, b in zip(g, scaled)]
        # mu = (1 - b1) * g + b1 * mu
        t = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, t)
        # nu = (1 - b2) * g**2 + b2 * nu
        t = torch._foreach_mul(g, g)
        torch._foreach_mul_(t, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, t)
        count = state["count"] + 1
        bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(count)
        u = torch._foreach_div(mu, float(bc1))
        den = torch._foreach_div(nu, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay > 0:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        lr = np.float32(self.learning_rate(state["count"]))
        torch._foreach_mul_(u, float(-lr))
        torch._foreach_add_(p, u)
        state["count"] = count


@component
class Optimizer:
    """Builds the update rule. ``schedule`` supplies the per-step learning
    rate; ``weight_decay`` and ``global_clip_norm`` live on the base, as
    in the JAX package."""

    schedule: Schedule = ComponentField(ConstantSchedule)
    weight_decay: float = Field(0.0)
    global_clip_norm: float = Field(0.0)
    #: Gradient accumulation over N micro-steps: not ported yet.
    accumulate_steps: int = Field(1)

    def build(self, total_steps: int) -> AdamTransform:
        if self.accumulate_steps != 1:
            raise NotImplementedError(
                f"accumulate_steps={self.accumulate_steps}: gradient "
                "accumulation is not in the PyTorch port yet; it is queued "
                "in ROADMAP.md."
            )
        return self._build(self.schedule.build(total_steps))

    def _build(self, learning_rate: Callable[[int], float]) -> AdamTransform:
        raise NotImplementedError(
            f"{type(self).__name__} is not in the PyTorch port yet (Adam and "
            "AdamW are); the others are queued in ROADMAP.md."
        )


@component
class Adam(Optimizer):
    """optax ``adam``; with ``weight_decay > 0``, optax ``adamw``
    (decoupled decay), as the JAX component builds it."""

    b1: float = Field(0.9)
    b2: float = Field(0.999)
    eps: float = Field(1e-8)

    def _build(self, learning_rate: Callable[[int], float]) -> AdamTransform:
        return AdamTransform(
            learning_rate, self.b1, self.b2, self.eps,
            weight_decay=self.weight_decay, clip_norm=self.global_clip_norm,
        )


@component
class AdamW(Adam):
    weight_decay: float = Field(1e-4)
