"""The training state: step, parameters, model state, optimizer state.

The port of ``zookeeper_tpu/training/state.py``. In PyTorch the
parameters and the model state (the BatchNorm running statistics) live
in the ``nn.Module``; the optimizer state is a dict of tensors beside
it. The train step updates all of them in place and advances ``step``,
a host-side count, so reading it never waits on the card.
"""

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    module: nn.Module
    tx: Any  # the built optimizer (``init``/``update``)
    opt_state: Dict[str, Any]

    @classmethod
    def create(cls, module: nn.Module, tx: Any) -> "TrainState":
        state = cls(step=0, module=module, tx=tx, opt_state={})
        state.opt_state = tx.init(state.params)
        return state

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.module.named_parameters())

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        """One optimizer update of the parameters, in place; ``step``
        advances. Returns the state."""
        with torch.no_grad():
            self.tx.update(grads, self.opt_state, self.params)
        self.step += 1
        return self
