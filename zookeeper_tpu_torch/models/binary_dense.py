"""The dense-connectivity binary zoo: BinaryDenseNet-28/37/45 (and the
dilated 37) and MeliusNet-22.

Counterparts of ``zookeeper_tpu/models/binary.py``'s ``BinaryDenseNet28``,
``BinaryDenseNet37``, ``BinaryDenseNet37Dilated``, ``BinaryDenseNet45`` and
``MeliusNet22``. Both families grow a feature stack by concatenation on
the channel axis (NHWC): each binary 3x3 conv is pre-activated (BN, then
``ste_sign`` on its input and weights) and its ``growth`` new channels are
appended to the stack. Between blocks an fp 1x1 conv reduces the stack.

- BinaryDenseNet: an fp 7x7/2 stem, BN, ReLU and a 3x3/2 SAME max pool;
  dense blocks of binary convs; transitions of BN, ReLU, a 2x2/2 SAME max
  pool (skipped before a dilated block) and the 1x1 conv to the stack
  width over the block's ``reduction``, rounded to a multiple of 32; BN,
  ReLU, the global mean and the fp head. A block's ``dilation`` > 1 runs
  its convs dilated, which only the "mxu" path takes.
- MeliusNet: an fp 3x3/2 stem, BN, ReLU and the 3x3/2 max pool; sections
  of (Dense, Improvement) block pairs; transitions of BN, ReLU, the 1x1
  conv to ``transition_features`` and the 2x2/2 max pool. A Dense block
  appends ``growth`` channels; an Improvement block's conv reads the whole
  stack and adds its output onto the newest ``growth`` channels.

Layers carry flax's scope names in flax's creation order: DenseNet's are
flat (``Conv_0``, ``BatchNorm_3``, ``QuantConv_5``, ``Dense_0``), Melius
nests each block (``_MeliusDenseBlock_2.QuantConv_0``), so a JAX
checkpoint maps across by name (``models/convert.py``). No BN follows a
binary conv in either family (pre-activation), so nothing folds:
``pack_quantconv_params(fold_bn=True)`` refuses the DenseNet tree, as
the JAX converter does. DenseNet's ``packed_weights`` holds the packed
deployment; Melius has no such field in the JAX package and packs its
latent kernels at each call on the packed paths.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import _FlaxNames, _initialize_packed, max_pool
from zookeeper_tpu_torch.models.binary_resnet import _Block
from zookeeper_tpu_torch.ops.layers import BatchNorm, Conv, Dense, QuantConv


def _round_channels(c: float, multiple: int = 32) -> int:
    return max(multiple, int(c / multiple + 0.5) * multiple)


def _binary_conv(in_features: int, features: int, dtype: torch.dtype, binary_compute: str,
                 packed_weights: bool = False, dilation: int = 1) -> QuantConv:
    return QuantConv(
        in_features, features, (3, 3), input_quantizer="ste_sign",
        kernel_quantizer="ste_sign", dtype=dtype, binary_compute=binary_compute,
        packed_weights=packed_weights, kernel_dilation=(dilation, dilation),
    )


class _BinaryDenseNetModule(nn.Module):
    """BinaryDenseNet over NHWC input; returns float32 logits."""

    KERNEL_QUANTIZER = "ste_sign"

    def __init__(
        self,
        *,
        in_channels: int,
        layers_per_block: Tuple[int, ...],
        reduction: Tuple[float, ...],
        dilation: Tuple[int, ...],
        growth_rate: int,
        initial_features: int,
        num_classes: int,
        dtype: torch.dtype,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
    ):
        super().__init__()
        self.config: Dict[str, Any] = dict(
            in_channels=in_channels, layers_per_block=tuple(layers_per_block),
            reduction=tuple(reduction), dilation=tuple(dilation), growth_rate=growth_rate,
            initial_features=initial_features, num_classes=num_classes, dtype=dtype,
            binary_compute=binary_compute, packed_weights=packed_weights,
        )
        self.dtype = dtype
        add = _FlaxNames(self)
        d = dtype
        width = initial_features
        self._stem = (add("Conv", Conv(in_channels, width, (7, 7), (2, 2), dtype=d)),
                      add("BatchNorm", BatchNorm(width, dtype=d)))
        self._blocks: List[Tuple[List[Tuple[str, str]], Optional[Tuple[str, bool, str]]]] = []
        for block, n_layers in enumerate(layers_per_block):
            layers = []
            for _ in range(n_layers):
                bn = add("BatchNorm", BatchNorm(width, dtype=d))
                conv = add("QuantConv", _binary_conv(
                    width, growth_rate, d, binary_compute, packed_weights, dilation[block]))
                layers.append((bn, conv))
                width += growth_rate
            transition = None
            if block < len(layers_per_block) - 1:
                bn = add("BatchNorm", BatchNorm(width, dtype=d))
                reduced = _round_channels(width / reduction[block])
                conv = add("Conv", Conv(width, reduced, (1, 1), dtype=d))
                transition = (bn, dilation[block + 1] == 1, conv)
                width = reduced
            self._blocks.append((layers, transition))
        self._final_bn = add("BatchNorm", BatchNorm(width, dtype=d))
        self._head = add("Dense", Dense(width, num_classes, dtype=d))
        self.eval()  # flax's training=False default

    def float_twin(self) -> "_BinaryDenseNetModule":
        """The same architecture holding latent float kernels: the
        training-side model whose converted weights this one serves."""
        return type(self)(**{**self.config, "packed_weights": False})

    @property
    def packed_any(self) -> bool:
        return bool(self.config["packed_weights"])

    @property
    def folds(self) -> bool:
        return False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        conv, bn = self._stem
        x = F.relu(layer(bn)(layer(conv)(x.to(self.dtype))))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for layers, transition in self._blocks:
            for bn, conv in layers:
                x = torch.cat([x, layer(conv)(layer(bn)(x))], dim=-1)
            if transition is not None:
                bn, pool, conv = transition
                x = F.relu(layer(bn)(x))
                if pool:
                    x = max_pool(x, (2, 2), (2, 2), "SAME")
                x = layer(conv)(x)
        x = F.relu(layer(self._final_bn)(x))
        return layer(self._head)(x.mean(dim=(1, 2))).to(torch.float32)


@component
class BinaryDenseNet28(Model):
    """BinaryDenseNet-28."""

    layers_per_block: Sequence[int] = Field((6, 6, 6, 5))
    reduction: Sequence[float] = Field((2.7, 2.7, 2.2))
    #: Per-block conv dilation; a block with dilation > 1 skips the
    #: transition's downsample ("mxu" only).
    dilation: Sequence[int] = Field((1, 1, 1, 1))
    growth_rate: int = Field(64)
    initial_features: int = Field(64)
    #: Binary conv path: "mxu", "int8", "xnor" or "xnor_popcount".
    binary_compute: str = Field("mxu")
    #: Inference-only: the bit-packed kernels (a seeded build holds the
    #: packed form of its float twin, see ``initialize``).
    packed_weights: bool = Field(False)

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _BinaryDenseNetModule(
            in_channels=int(input_shape[-1]),
            layers_per_block=tuple(self.layers_per_block),
            reduction=tuple(self.reduction),
            dilation=tuple(self.dilation),
            growth_rate=self.growth_rate,
            initial_features=self.initial_features,
            num_classes=num_classes,
            dtype=self.dtype(),
            binary_compute=self.binary_compute,
            packed_weights=self.packed_weights,
        )

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        return _initialize_packed(self, module, seed)


@component
class BinaryDenseNet37(BinaryDenseNet28):
    """BinaryDenseNet-37."""

    layers_per_block: Sequence[int] = Field((6, 8, 12, 6))
    reduction: Sequence[float] = Field((3.3, 3.3, 4.0))


@component
class BinaryDenseNet37Dilated(BinaryDenseNet37):
    """BinaryDenseNet-37 with its last two blocks dilated instead of
    downsampled ("mxu" only)."""

    dilation: Sequence[int] = Field((1, 1, 2, 4))


@component
class BinaryDenseNet45(BinaryDenseNet28):
    """BinaryDenseNet-45."""

    layers_per_block: Sequence[int] = Field((6, 12, 14, 8))
    reduction: Sequence[float] = Field((2.7, 3.3, 4.0))


class _MeliusDenseBlock(_Block):
    """BN -> sign -> binary 3x3 conv of ``growth`` channels, concatenated
    onto the stack."""

    def __init__(self, in_features: int, growth: int, dtype: torch.dtype,
                 binary_compute: str = "mxu"):
        super().__init__()
        self.bn = self.add("BatchNorm", BatchNorm(in_features, dtype=dtype))
        self.conv = self.add("QuantConv", _binary_conv(in_features, growth, dtype,
                                                       binary_compute))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.layer(self.conv)(self.layer(self.bn)(x))], dim=-1)


class _MeliusImprovementBlock(_MeliusDenseBlock):
    """BN -> sign -> binary 3x3 conv over the whole stack, its ``growth``
    output channels added onto the newest ``growth`` channels."""

    def __init__(self, in_features: int, growth: int, dtype: torch.dtype,
                 binary_compute: str = "mxu"):
        super().__init__(in_features, growth, dtype, binary_compute)
        self.growth = growth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layer(self.conv)(self.layer(self.bn)(x))
        g = self.growth
        return torch.cat([x[..., :-g], x[..., -g:] + y], dim=-1)


class _MeliusNetModule(nn.Module):
    """MeliusNet over NHWC input; returns float32 logits."""

    KERNEL_QUANTIZER = "ste_sign"

    def __init__(
        self,
        *,
        in_channels: int,
        blocks_per_section: Tuple[int, ...],
        transition_features: Tuple[int, ...],
        growth: int,
        stem_features: int,
        num_classes: int,
        dtype: torch.dtype,
        binary_compute: str = "mxu",
    ):
        super().__init__()
        self.dtype = dtype
        add = _FlaxNames(self)
        d = dtype
        width = stem_features
        self._stem = (add("Conv", Conv(in_channels, width, (3, 3), (2, 2), dtype=d)),
                      add("BatchNorm", BatchNorm(width, dtype=d)))
        self._sections: List[Tuple[List[str], Optional[Tuple[str, str]]]] = []
        for s, n_pairs in enumerate(blocks_per_section):
            blocks = []
            for _ in range(n_pairs):
                blocks.append(add("_MeliusDenseBlock", _MeliusDenseBlock(
                    width, growth, d, binary_compute)))
                width += growth
                blocks.append(add("_MeliusImprovementBlock", _MeliusImprovementBlock(
                    width, growth, d, binary_compute)))
            transition = None
            if s < len(blocks_per_section) - 1:
                transition = (add("BatchNorm", BatchNorm(width, dtype=d)),
                              add("Conv", Conv(width, transition_features[s], (1, 1), dtype=d)))
                width = transition_features[s]
            self._sections.append((blocks, transition))
        self._final_bn = add("BatchNorm", BatchNorm(width, dtype=d))
        self._head = add("Dense", Dense(width, num_classes, dtype=d))
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        conv, bn = self._stem
        x = F.relu(layer(bn)(layer(conv)(x.to(self.dtype))))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for blocks, transition in self._sections:
            for block in blocks:
                x = layer(block)(x)
            if transition is not None:
                bn, conv = transition
                x = layer(conv)(F.relu(layer(bn)(x)))
                x = max_pool(x, (2, 2), (2, 2), "SAME")
        x = F.relu(layer(self._final_bn)(x))
        return layer(self._head)(x.mean(dim=(1, 2))).to(torch.float32)


@component
class MeliusNet22(Model):
    """MeliusNet-22: capacity from the Dense blocks' concatenation, quality
    from the Improvement blocks' refinement of the newest channels."""

    blocks_per_section: Sequence[int] = Field((4, 5, 4, 4))
    transition_features: Sequence[int] = Field((160, 224, 256))
    growth: int = Field(64)
    stem_features: int = Field(64)
    #: Binary conv path: "mxu", "int8", "xnor" or "xnor_popcount".
    binary_compute: str = Field("mxu")

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        if len(self.transition_features) != len(self.blocks_per_section) - 1:
            raise ValueError(
                f"transition_features has {len(self.transition_features)} "
                f"entries; expected {len(self.blocks_per_section) - 1} "
                "(one per section boundary)."
            )
        return _MeliusNetModule(
            in_channels=int(input_shape[-1]),
            blocks_per_section=tuple(self.blocks_per_section),
            transition_features=tuple(self.transition_features),
            growth=self.growth,
            stem_features=self.stem_features,
            num_classes=num_classes,
            dtype=self.dtype(),
            binary_compute=self.binary_compute,
        )
