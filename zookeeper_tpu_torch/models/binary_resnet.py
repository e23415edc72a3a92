"""The ResNet-topology binary zoo: Bi-Real-Net-18, BinaryResNetE18,
Real-to-Binary-Net and ReActNet-A.

Counterparts of ``zookeeper_tpu/models/binary.py``'s ``BiRealNet``,
``BinaryResNetE18``, ``RealToBinaryNet`` and ``ReActNet``. The first
three share the ResNet-18 skeleton (:class:`_ResNet18Module`): a 7x7/2 fp
stem, BN and a 3x3/2 SAME max pool, four sections of blocks (the first
block of every later section at stride 2), a global mean and the fp head.
Each block is one binary 3x3 conv with a real-valued shortcut around it:

- ``_BiRealBlock``: ``approx_sign`` activations, ``magnitude_aware_sign``
  weights, BN; the downsample shortcut is a 2x2 SAME average pool, an fp
  1x1 conv and BN;
- ``_ResNetEBlock``: ``ste_sign`` on both, BN; the downsample shortcut is
  parameter-free (the average pool, then the channels repeated);
- ``_R2BBlock``: ``ste_sign`` on both; the conv's output is scaled by a
  gate computed from the block's real input (global mean, fp dense
  bottleneck, ReLU, fp dense, sigmoid), then BN; Bi-Real's shortcut.

ReActNet-A is MobileNetV1-shaped (a 3x3/2 fp stem, then 13 blocks of a
binary 3x3 stage and a binary 1x1 stage that doubles the width as two
branches) with ``RSign`` (a learned per-channel shift before the sign)
and ``RPReLU`` (a shifted PReLU) around every binary conv.

Each block is a submodule with its flax scope name (``_BiRealBlock_3``),
and holds its layers under their flax names in creation order
(``Conv_0``, ``BatchNorm_0``, ``QuantConv_0``, ``BatchNorm_1``), so a JAX
checkpoint maps across by name (``models/convert.py``) and the BN fold
pairs each packed conv with the BN created after it inside its block.
``fold_bn`` folds only the BN that follows a packed binary conv; the
shortcut's BN follows an fp conv and stays. ``BiRealNet.pack_residuals``
(the int8 training path's 1-bit residuals, numerics unchanged) is an
option of the port; the JAX module has no such field.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import (
    _check_fold_training,
    _FlaxNames,
    _initialize_packed,
    _post_conv_bn,
    avg_pool,
    max_pool,
)
from zookeeper_tpu_torch.ops.layers import BatchNorm, Conv, Dense, QuantConv
from zookeeper_tpu_torch.ops.quantizers import ste_sign


class _Block(nn.Module):
    """A flax submodule scope: its layers are added under their flax names
    by ``self.add``; ``self.layer(name)`` fetches one (None passes)."""

    def __init__(self):
        super().__init__()
        self.add = _FlaxNames(self)

    def layer(self, name: Optional[str]) -> Optional[nn.Module]:
        return None if name is None else self.get_submodule(name)


def _binary_conv(in_features: int, features: int, strides: int, dtype: torch.dtype,
                 conf: Dict[str, Any], fold_here: bool, input_quantizer: str,
                 kernel_quantizer: str) -> QuantConv:
    return QuantConv(
        in_features, features, (3, 3), (strides, strides),
        input_quantizer=input_quantizer, kernel_quantizer=kernel_quantizer, dtype=dtype,
        binary_compute=conf["binary_compute"], packed_weights=conf["packed_weights"],
        pack_residuals=conf["pack_residuals"],
        use_bias=fold_here,  # carries the folded BN shift
    )


class _BiRealBlock(_Block):
    """sign -> binary 3x3 conv -> BN -> + shortcut (real-valued after every
    binary conv: Bi-Real-Net's signature)."""

    def __init__(self, in_features: int, features: int, strides: int, dtype: torch.dtype,
                 conf: Dict[str, Any]):
        super().__init__()
        self.strides = strides
        fold_here = conf["fold_bn"] and conf["packed_weights"]
        self.shortcut = None
        if strides > 1 or in_features != features:
            self.shortcut = (self.add("Conv", Conv(in_features, features, (1, 1), dtype=dtype)),
                             self.add("BatchNorm", BatchNorm(features, dtype=dtype)))
        self.conv = self.add("QuantConv", _binary_conv(
            in_features, features, strides, dtype, conf, fold_here,
            "approx_sign", "magnitude_aware_sign"))
        self.bn = _post_conv_bn(self.add, features, dtype, fold_here)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut is not None:
            s = self.strides
            shortcut = avg_pool(x, (2, 2), (s, s), "SAME")
            shortcut = self.layer(self.shortcut[1])(self.layer(self.shortcut[0])(shortcut))
        y = self.layer(self.conv)(x)
        if self.bn is not None:
            y = self.layer(self.bn)(y)
        return y + shortcut


class _ResNetEBlock(_Block):
    """sign -> binary 3x3 conv -> BN -> + shortcut, the downsample
    shortcut parameter-free: a 2x2 SAME average pool, then the channels
    repeated to the new width."""

    def __init__(self, in_features: int, features: int, strides: int, dtype: torch.dtype,
                 conf: Dict[str, Any]):
        super().__init__()
        if features % in_features:
            raise ValueError(
                f"BinaryResNetE18: a block widens {in_features} -> {features}; the "
                "channel-repeating shortcut needs a whole multiple."
            )
        self.strides = strides
        self.reps = features // in_features
        fold_here = conf["fold_bn"] and conf["packed_weights"]
        self.conv = self.add("QuantConv", _binary_conv(
            in_features, features, strides, dtype, conf, fold_here, "ste_sign", "ste_sign"))
        self.bn = _post_conv_bn(self.add, features, dtype, fold_here)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.strides > 1:
            shortcut = avg_pool(x, (2, 2), (self.strides, self.strides), "SAME")
        if self.reps > 1:
            shortcut = torch.cat([shortcut] * self.reps, dim=-1)
        y = self.layer(self.conv)(x)
        if self.bn is not None:
            y = self.layer(self.bn)(y)
        return y + shortcut


class _R2BBlock(_Block):
    """Real-to-Binary block: the binary 3x3 conv's output times a
    per-channel gate from the block's real input, then BN, plus
    Bi-Real's shortcut. The BN follows the gate, so nothing folds."""

    def __init__(self, in_features: int, features: int, strides: int, dtype: torch.dtype,
                 conf: Dict[str, Any]):
        super().__init__()
        self.strides = strides
        self.shortcut = None
        if strides > 1 or in_features != features:
            self.shortcut = (self.add("Conv", Conv(in_features, features, (1, 1), dtype=dtype)),
                             self.add("BatchNorm", BatchNorm(features, dtype=dtype)))
        hidden = max(1, in_features // conf["gate_reduction"])
        self.gate = (self.add("Dense", Dense(in_features, hidden, dtype=dtype)),
                     self.add("Dense", Dense(hidden, features, dtype=dtype)))
        self.conv = self.add("QuantConv", _binary_conv(
            in_features, features, strides, dtype, conf, False, "ste_sign", "ste_sign"))
        self.bn = self.add("BatchNorm", BatchNorm(features, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut is not None:
            if self.strides > 1:
                shortcut = avg_pool(shortcut, (2, 2), (self.strides, self.strides), "SAME")
            shortcut = self.layer(self.shortcut[1])(self.layer(self.shortcut[0])(shortcut))
        g = x.mean(dim=(1, 2))
        g = torch.sigmoid(self.layer(self.gate[1])(F.relu(self.layer(self.gate[0])(g))))
        y = self.layer(self.conv)(x) * g[:, None, None, :]
        return self.layer(self.bn)(y) + shortcut


class _ResNet18Module(nn.Module):
    """The ResNet-18 skeleton over NHWC input: fp 7x7/2 stem conv, BN, 3x3/2
    SAME max pool, the sections' blocks (``BLOCK``), an optional ReLU, the
    global mean and the fp head; float32 logits. Subclasses name the block,
    the stem's width and the head's ReLU."""

    BLOCK: type = _BiRealBlock
    #: The kernel quantizer of the binary convs (the packed build packs with it).
    KERNEL_QUANTIZER = "ste_sign"
    RELU_HEAD = False

    def __init__(
        self,
        *,
        in_channels: int,
        blocks_per_section: Tuple[int, ...],
        section_features: Tuple[int, ...],
        num_classes: int,
        dtype: torch.dtype,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        fold_bn: bool = False,
        pack_residuals: bool = False,
        gate_reduction: int = 8,
    ):
        super().__init__()
        self.config: Dict[str, Any] = dict(
            in_channels=in_channels, blocks_per_section=tuple(blocks_per_section),
            section_features=tuple(section_features), num_classes=num_classes, dtype=dtype,
            binary_compute=binary_compute, packed_weights=packed_weights, fold_bn=fold_bn,
            pack_residuals=pack_residuals, gate_reduction=gate_reduction,
        )
        self.dtype = dtype
        add = _FlaxNames(self)
        width = self.stem_features(tuple(section_features))
        self._stem = (add("Conv", Conv(in_channels, width, (7, 7), (2, 2), dtype=dtype)),
                      add("BatchNorm", BatchNorm(width, dtype=dtype)))
        self._blocks: List[str] = []
        for s, (n, feat) in enumerate(zip(blocks_per_section, section_features)):
            for b in range(n):
                strides = 2 if (b == 0 and s > 0) else 1
                block = self.BLOCK(width, feat, strides, dtype, self.config)
                self._blocks.append(add(self.BLOCK.__name__, block))
                width = feat
        self._head = add("Dense", Dense(width, num_classes, dtype=dtype))
        self.eval()  # flax's training=False default

    def stem_features(self, section_features: Tuple[int, ...]) -> int:
        return section_features[0]

    def float_twin(self) -> "_ResNet18Module":
        """The same architecture holding latent float kernels and every BN:
        the training-side model whose converted weights this one serves."""
        return type(self)(**{**self.config, "packed_weights": False, "fold_bn": False})

    @property
    def packed_any(self) -> bool:
        return bool(self.config["packed_weights"])

    @property
    def folds(self) -> bool:
        return bool(self.config["fold_bn"]) and self.packed_any

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_fold_training(self.config["fold_bn"], self.packed_any, self.training)
        layer = self.get_submodule
        conv, bn = self._stem
        x = layer(bn)(layer(conv)(x.to(self.dtype)))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for block in self._blocks:
            x = layer(block)(x)
        if self.RELU_HEAD:
            x = F.relu(x)
        return layer(self._head)(x.mean(dim=(1, 2))).to(torch.float32)


class _BiRealNetModule(_ResNet18Module):
    """Bi-Real-Net-18: a 64-wide stem whatever the sections' widths."""

    BLOCK = _BiRealBlock
    KERNEL_QUANTIZER = "magnitude_aware_sign"

    def stem_features(self, section_features: Tuple[int, ...]) -> int:
        return 64


class _BinaryResNetEModule(_ResNet18Module):
    BLOCK = _ResNetEBlock
    RELU_HEAD = True


class _RealToBinaryNetModule(_ResNet18Module):
    BLOCK = _R2BBlock

    @property
    def folds(self) -> bool:
        return False


class _ResNet18Model(Model):
    """The fields and build the ResNet-18 families share."""

    MODULE: type = _ResNet18Module

    blocks_per_section: Sequence[int] = Field((4, 4, 4, 4))
    section_features: Sequence[int] = Field((64, 128, 256, 512))
    #: Binary conv path: "mxu", "int8", "xnor" or "xnor_popcount".
    binary_compute: str = Field("mxu")
    #: Inference-only: the bit-packed kernels (a seeded build holds the
    #: packed form of its float twin, see ``initialize``).
    packed_weights: bool = Field(False)

    def _module_kwargs(self) -> Dict[str, Any]:
        return {}

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return self.MODULE(
            in_channels=int(input_shape[-1]),
            blocks_per_section=tuple(self.blocks_per_section),
            section_features=tuple(self.section_features),
            num_classes=num_classes,
            dtype=self.dtype(),
            binary_compute=self.binary_compute,
            packed_weights=self.packed_weights,
            **self._module_kwargs(),
        )

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        return _initialize_packed(self, module, seed)


@component
class BiRealNet(_ResNet18Model):
    """Bi-Real-Net-18 (BASELINE config 3)."""

    MODULE = _BiRealNetModule

    #: Deployment-only: binary-conv BNs folded into the conv epilogue
    #: (pair with ops.packed.pack_quantconv_params fold_bn=True).
    fold_bn: bool = Field(False)
    #: 1-bit residual storage on the binary convs (int8 path only; the
    #: port's option, the numbers unchanged).
    pack_residuals: bool = Field(False)

    def _module_kwargs(self) -> Dict[str, Any]:
        return {"fold_bn": self.fold_bn, "pack_residuals": self.pack_residuals}


@component
class BinaryResNetE18(_ResNet18Model):
    """BinaryResNetE18: parameter-free downsample shortcuts, ``ste_sign`` on
    activations and weights."""

    MODULE = _BinaryResNetEModule

    #: Deployment-only: binary-conv BNs folded into the conv epilogue.
    fold_bn: bool = Field(False)

    def _module_kwargs(self) -> Dict[str, Any]:
        return {"fold_bn": self.fold_bn}


@component
class RealToBinaryNet(_ResNet18Model):
    """Real-to-Binary-Net: the architecture (its distillation recipe is
    not ported)."""

    MODULE = _RealToBinaryNetModule

    gate_reduction: int = Field(8)

    def _module_kwargs(self) -> Dict[str, Any]:
        return {"gate_reduction": self.gate_reduction}


class RSign(nn.Module):
    """ReActNet's learned-threshold sign: ``ste_sign(x - alpha_c)``, the
    straight-through gradient reaching both ``x`` and ``alpha``."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ste_sign(x - self.alpha.to(x.dtype))


class RPReLU(nn.Module):
    """ReActNet's shifted PReLU: ``PReLU_beta(x - gamma_c) + zeta_c``."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(features))
        self.zeta = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.full((features,), 0.25))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.zero_()
            self.zeta.zero_()
            self.beta.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.dtype
        y = x - self.gamma.to(d)
        y = torch.where(y > 0, y, self.beta.to(d) * y)
        return y + self.zeta.to(d)


class _ReActBlock(_Block):
    """RSign -> binary 3x3 conv (stride s) -> BN -> + shortcut -> RPReLU,
    then RSign -> binary 1x1 conv -> BN -> + shortcut -> RPReLU; a block
    that doubles the width runs the 1x1 stage as two branches whose
    outputs concatenate. The convs' own ``ste_sign`` is the identity on
    RSign's ±1 (kept so the binary paths validate and run)."""

    def __init__(self, in_features: int, features: int, strides: int, dtype: torch.dtype,
                 binary_compute: str):
        super().__init__()
        if features not in (in_features, 2 * in_features):
            raise ValueError(
                f"ReActNet block widens {in_features} -> {features}; only same-width "
                "or exact doubling is defined."
            )
        self.strides = strides

        def stage(k: int, s: int) -> Tuple[str, str, str]:
            return (self.add("RSign", RSign(in_features)),
                    self.add("QuantConv", QuantConv(
                        in_features, in_features, (k, k), (s, s), input_quantizer="ste_sign",
                        kernel_quantizer="ste_sign", dtype=dtype,
                        binary_compute=binary_compute)),
                    self.add("BatchNorm", BatchNorm(in_features, dtype=dtype)))

        self.stage3 = stage(3, strides)
        self.act3 = self.add("RPReLU", RPReLU(in_features))
        self.stages1 = [stage(1, 1) for _ in range(features // in_features)]
        self.act1 = self.add("RPReLU", RPReLU(features))

    def _stage(self, names: Tuple[str, str, str], x: torch.Tensor) -> torch.Tensor:
        sign, conv, bn = (self.layer(n) for n in names)
        return bn(conv(sign(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.strides > 1:
            shortcut = avg_pool(x, (2, 2), (self.strides, self.strides), "SAME")
        x = self.layer(self.act3)(self._stage(self.stage3, x) + shortcut)
        outs = [self._stage(names, x) + x for names in self.stages1]
        return self.layer(self.act1)(outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1))


class _ReActNetModule(nn.Module):
    """ReActNet-A over NHWC input: fp 3x3/2 stem conv and BN, then one
    ``_ReActBlock`` per later width, the global mean and the fp head;
    float32 logits."""

    def __init__(self, *, in_channels: int, features: Tuple[int, ...],
                 strides: Tuple[int, ...], num_classes: int, dtype: torch.dtype,
                 binary_compute: str = "mxu"):
        super().__init__()
        self.dtype = dtype
        add = _FlaxNames(self)
        self._stem = (add("Conv", Conv(in_channels, features[0], (3, 3), (2, 2), dtype=dtype)),
                      add("BatchNorm", BatchNorm(features[0], dtype=dtype)))
        self._blocks = [
            add("_ReActBlock", _ReActBlock(cin, feat, s, dtype, binary_compute))
            for cin, feat, s in zip(features[:-1], features[1:], strides)
        ]
        self._head = add("Dense", Dense(features[-1], num_classes, dtype=dtype))
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        conv, bn = self._stem
        x = layer(bn)(layer(conv)(x.to(self.dtype)))
        for block in self._blocks:
            x = layer(block)(x)
        return layer(self._head)(x.mean(dim=(1, 2))).to(torch.float32)


@component
class ReActNet(Model):
    """ReActNet-A (MobileNetV1 topology, every conv but the stem binary)."""

    features: Sequence[int] = Field(
        (32, 64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024, 1024)
    )
    #: Stride of each block's 3x3 stage (len == len(features) - 1).
    strides: Sequence[int] = Field((1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1))
    binary_compute: str = Field("mxu")

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        if len(self.strides) != len(self.features) - 1:
            raise ValueError(
                f"strides has {len(self.strides)} entries; expected "
                f"{len(self.features) - 1} (one per block)."
            )
        return _ReActNetModule(
            in_channels=int(input_shape[-1]), features=tuple(self.features),
            strides=tuple(self.strides), num_classes=num_classes, dtype=self.dtype(),
            binary_compute=self.binary_compute,
        )
