"""Small reference architectures (MNIST/CIFAR scale): BASELINE config 1.

Counterparts of ``zookeeper_tpu/models/simple.py``'s ``SimpleCnn``
([conv with bias, optional BN, ReLU] per width, a 2x2 max pool after
every second, dense layers with ReLU, the head) and ``Mlp`` (flatten,
dense layers with ReLU, the head). Their BatchNorms are flax's default
ones: momentum 0.99, float32 output whatever the compute dtype.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import _FlaxNames, max_pool
from zookeeper_tpu_torch.ops.layers import BatchNorm, Conv, Dense


class _CnnModule(nn.Module):
    def __init__(self, *, input_shape: Tuple[int, int, int], features: Tuple[int, ...],
                 dense_units: Tuple[int, ...], num_classes: int, use_batch_norm: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        add = _FlaxNames(self)
        h, w, width = input_shape
        self._convs: List[Tuple[str, Optional[str]]] = []
        for i, feat in enumerate(features):
            conv = add("Conv", Conv(width, feat, (3, 3), dtype=dtype, use_bias=True))
            bn = add("BatchNorm", BatchNorm(feat, momentum=0.99)) if use_batch_norm else None
            self._convs.append((conv, bn))
            if i % 2 == 1:
                h, w = h // 2, w // 2
            width = feat
        width = h * w * width
        self._denses: List[str] = []
        for units in dense_units:
            self._denses.append(add("Dense", Dense(width, units, dtype=dtype)))
            width = units
        self._head = add("Dense", Dense(width, num_classes, dtype=dtype))
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        x = x.to(self.dtype)
        for i, (conv, bn) in enumerate(self._convs):
            x = layer(conv)(x)
            if bn is not None:
                x = layer(bn)(x)
            x = F.relu(x)
            if i % 2 == 1:
                x = max_pool(x, (2, 2), (2, 2))
        x = x.reshape(x.shape[0], -1)
        for dense in self._denses:
            x = F.relu(layer(dense)(x))
        return layer(self._head)(x).to(torch.float32)


class _MlpModule(nn.Module):
    def __init__(self, *, input_shape: Sequence[int], hidden_units: Tuple[int, ...],
                 num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        add = _FlaxNames(self)
        width = 1
        for s in input_shape:
            width *= int(s)
        self._denses: List[str] = []
        for units in hidden_units:
            self._denses.append(add("Dense", Dense(width, units, dtype=dtype)))
            width = units
        self._head = add("Dense", Dense(width, num_classes, dtype=dtype))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        for dense in self._denses:
            x = F.relu(layer(dense)(x))
        return layer(self._head)(x).to(torch.float32)


@component
class SimpleCnn(Model):
    """Small conv net: [conv(-bn)-relu]xN with pooling, dense head."""

    features: Sequence[int] = Field((32, 64))
    dense_units: Sequence[int] = Field((128,))
    use_batch_norm: bool = Field(True)

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _CnnModule(
            input_shape=tuple(int(s) for s in input_shape), features=tuple(self.features),
            dense_units=tuple(self.dense_units), num_classes=num_classes,
            use_batch_norm=self.use_batch_norm, dtype=self.dtype(),
        )


@component
class Mlp(Model):
    """Flatten + dense stack, the minimal smoke-test model."""

    hidden_units: Sequence[int] = Field((128,))

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _MlpModule(
            input_shape=tuple(int(s) for s in input_shape),
            hidden_units=tuple(self.hidden_units), num_classes=num_classes,
            dtype=self.dtype(),
        )
