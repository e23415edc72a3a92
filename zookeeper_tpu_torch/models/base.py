"""Abstract Model component."""

from typing import Sequence

import torch
from torch import nn

from zookeeper_tpu_torch.core import Field, component


@component
class Model:
    """A component that builds a ``torch.nn.Module``.

    Modules built here take batched NHWC input (as in the JAX package)
    and return float32 outputs. ``module.train()`` runs them as flax's
    ``training=True`` does (batch-statistics BatchNorms that update their
    running statistics); ``module.eval()`` serves.
    """

    #: Compute dtype for activations. Parameters stay float32.
    compute_dtype: str = Field("float32")

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        raise NotImplementedError("Model subclasses must implement build().")

    def dtype(self) -> torch.dtype:
        dtype = getattr(torch, self.compute_dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"compute_dtype {self.compute_dtype!r} is not a torch dtype.")
        return dtype

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        """Fill ``module``'s parameters in place from a ``torch.Generator``
        seeded with ``seed``: every submodule with a ``reset_parameters
        (generator)`` method draws from it in registration order.
        Returns the module."""
        generator = torch.Generator().manual_seed(int(seed))
        for sub in module.modules():
            reset = getattr(sub, "reset_parameters", None)
            if reset is not None:
                reset(generator)
        return module
