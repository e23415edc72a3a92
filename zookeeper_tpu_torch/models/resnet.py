"""The full-precision ResNet family (BASELINE config 5): ResNet-v1.5
bottleneck networks, the stride on the 3x3 conv.

Counterparts of ``zookeeper_tpu/models/resnet.py``'s ``ResNet50``,
``ResNet101`` and ``ResNet152``. Their convs and matmuls are PyTorch's
(cuDNN and cuBLAS on the card), as the JAX package computes them with
XLA and no kernel of its own. Each bottleneck is a submodule under its
flax scope name (``_Bottleneck_0``) holding its layers under theirs
(``Conv_0``, ``BatchNorm_0``: the projection shortcut first, where the
block has one), so a JAX checkpoint maps across by name
(``models/convert.py``).
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import _FlaxNames, max_pool
from zookeeper_tpu_torch.models.binary_resnet import _Block
from zookeeper_tpu_torch.ops.layers import BatchNorm, Conv, Dense


class _Bottleneck(_Block):
    """1x1 -> 3x3 (stride) -> 1x1 to 4x ``features``, BN and ReLU between,
    plus the shortcut (a strided 1x1 conv and BN where the width or the
    size changes), then ReLU."""

    def __init__(self, in_features: int, features: int, strides: int, dtype: torch.dtype):
        super().__init__()
        out = 4 * features

        def conv_bn(cin: int, cout: int, k: int, s: int = 1) -> Tuple[str, str]:
            return (self.add("Conv", Conv(cin, cout, (k, k), (s, s), dtype=dtype)),
                    self.add("BatchNorm", BatchNorm(cout, dtype=dtype)))

        self.shortcut = None
        if in_features != out or strides > 1:
            self.shortcut = conv_bn(in_features, out, 1, strides)
        self.body = [conv_bn(in_features, features, 1), conv_bn(features, features, 3, strides),
                     conv_bn(features, out, 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv_bn(names: Tuple[str, str], y: torch.Tensor) -> torch.Tensor:
            return self.layer(names[1])(self.layer(names[0])(y))

        shortcut = x if self.shortcut is None else conv_bn(self.shortcut, x)
        y = F.relu(conv_bn(self.body[0], x))
        y = F.relu(conv_bn(self.body[1], y))
        return F.relu(conv_bn(self.body[2], y) + shortcut)


class _ResNetModule(nn.Module):
    """ResNet over NHWC input: fp 7x7/2 stem, BN, ReLU, 3x3/2 SAME max pool,
    the sections' bottlenecks (widths ``width * 2**s``, the first block of
    every later section at stride 2), the global mean and the head;
    float32 logits."""

    def __init__(self, *, in_channels: int, blocks_per_section: Tuple[int, ...],
                 num_classes: int, dtype: torch.dtype, width: int = 64):
        super().__init__()
        self.dtype = dtype
        add = _FlaxNames(self)
        self._stem = (add("Conv", Conv(in_channels, width, (7, 7), (2, 2), dtype=dtype)),
                      add("BatchNorm", BatchNorm(width, dtype=dtype)))
        self._blocks: List[str] = []
        cin = width
        for s, n in enumerate(blocks_per_section):
            for b in range(n):
                strides = 2 if (b == 0 and s > 0) else 1
                feat = width * 2**s
                self._blocks.append(add("_Bottleneck", _Bottleneck(cin, feat, strides, dtype)))
                cin = 4 * feat
        self._head = add("Dense", Dense(cin, num_classes, dtype=dtype))
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        conv, bn = self._stem
        x = F.relu(layer(bn)(layer(conv)(x.to(self.dtype))))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for block in self._blocks:
            x = layer(block)(x)
        return layer(self._head)(x.mean(dim=(1, 2))).to(torch.float32)


@component
class ResNet50(Model):
    """ResNet-50 (BASELINE config 5)."""

    blocks_per_section: Sequence[int] = Field((3, 4, 6, 3))
    width: int = Field(64)

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _ResNetModule(
            in_channels=int(input_shape[-1]), blocks_per_section=tuple(self.blocks_per_section),
            num_classes=num_classes, dtype=self.dtype(), width=self.width,
        )


@component
class ResNet101(ResNet50):
    blocks_per_section: Sequence[int] = Field((3, 4, 23, 3))


@component
class ResNet152(ResNet50):
    blocks_per_section: Sequence[int] = Field((3, 8, 36, 3))
