"""The training state: step, parameters, model state, optimizer state.

The port of ``zookeeper_tpu/training/state.py``. In PyTorch the
parameters and the model state (the BatchNorm running statistics) live
in the ``nn.Module``; the optimizer state is a dict of tensors beside
it, and so is the parameter EMA when it is kept. The train step updates
all of them in place and advances ``step``, a host-side count, so
reading it never waits on the card. The fused loop's CUDA graph replays
no host code, so under it the step also lives on the card
(``step_counter``), advanced by the same update.

Under a partitioner's rules (``parallel.shards``) the state holds
shards: each sharded parameter (and buffer) of the module is this
rank's block, and so are its optimizer state and its EMA copy, whose
dicts co-shard with it; ``shards`` is the plan that says which and how,
and what gathers them (a checkpoint, ``models.convert.flax_train_state``)
and scatters them back.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from zookeeper_tpu_torch.models.convert import flax_param_paths


@dataclass
class TrainState:
    step: int
    module: nn.Module
    tx: Any  # the built optimizer (``init``/``update``)
    opt_state: Dict[str, Any]
    #: The exponential moving average of the parameters (None when EMA is
    #: off), kept by the train step's ``ema_decay``, read by eval/export.
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    #: ``{parameter name: flax path}`` (``models.convert.flax_param_paths``):
    #: what Bop's split and the flip ratio match their patterns against.
    flax_paths: Dict[str, str] = field(default_factory=dict)
    #: ``step`` on the card (a 0-d int64), kept only while a CUDA graph
    #: replays the step (``training.step.prepare_for_graph``): what the
    #: step reads where it would read ``step``. Never checkpointed.
    step_counter: Optional[torch.Tensor] = None
    #: The ``parallel.shards.ShardPlan`` of a sharded state (None: every
    #: tensor whole), set by the partitioner's ``shard_state``.
    shards: Optional[Any] = None

    @classmethod
    def create(cls, module: nn.Module, tx: Any, ema: bool = False) -> "TrainState":
        state = cls(step=0, module=module, tx=tx, opt_state={},
                    flax_paths=flax_param_paths(module))
        params = state.params
        state.opt_state = tx.init(params, state.flax_paths)
        if ema:
            state.ema_params = {n: p.detach().clone() for n, p in params.items()}
        return state

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.module.named_parameters())

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        """One optimizer update of the parameters, in place; ``step``
        advances. Returns the state."""
        with torch.no_grad():
            self.tx.update(grads, self.opt_state, self.params)
            if self.step_counter is not None:
                self.step_counter.add_(1)
        self.step += 1
        return self
