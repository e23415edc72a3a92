"""The QuickNet family, for training and serving.

Counterparts of ``zookeeper_tpu/models/binary.py``'s ``QuickNet``,
``QuickNetSmall`` and ``QuickNetLarge``: fp stem, sections of residual
binary 3x3 convs, fp 1x1 transitions with blurpool downsampling, fp head.
A built module starts in eval mode, as flax's ``training`` flag
defaults to False; ``module.train()`` trains it (batch-statistics
BatchNorms), as ``training=True`` does.
Submodules carry the flax auto-numbered names (``Conv_0``,
``BatchNorm_3``, ``QuantConv_7``, ``Dense_0``) in flax creation order, so
a JAX checkpoint maps across by name (``models/convert.py``) and the BN
fold pairs each binary conv with the BN created after it.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.ops.binary_compute import _spatial_pad
from zookeeper_tpu_torch.ops.layers import BatchNorm, Conv, Dense, QuantConv

_FOLD_BN_TRAINING_ERROR = (
    "fold_bn=True is a DEPLOYMENT mode: the binary-conv BatchNorms are "
    "folded into conv params at convert time and skipped here, so a "
    "training forward would run un-normalized with batch stats silently "
    "missing. Train with fold_bn=False and convert with "
    "pack_quantconv_params(fold_bn=True)."
)


def _packed_any(packed_weights) -> bool:
    if isinstance(packed_weights, (tuple, list)):
        return any(packed_weights)
    return bool(packed_weights)


def _check_fold_training(fold_bn, packed_weights, training: bool) -> None:
    """Raise on a training forward of a build that actually folds (the
    fold applies only where a section is packed, so an unpacked build
    with an inherited fold_bn=True trains normally)."""
    if fold_bn and _packed_any(packed_weights) and training:
        raise ValueError(_FOLD_BN_TRAINING_ERROR)


def _section_opt(value, s: int):
    return value[s] if isinstance(value, (tuple, list)) else value


def _blur_pool(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Anti-aliased stride-2 downsampling over NHWC: fixed 3x3 binomial
    filter, depthwise, SAME padding."""
    c = x.shape[-1]
    f = torch.tensor([1.0, 2.0, 1.0], dtype=dtype, device=x.device)
    k2d = torch.outer(f, f)
    k2d = k2d / k2d.sum()
    weight = k2d.expand(c, 1, 3, 3).contiguous()
    xp, _, _ = _spatial_pad(x, 3, 3, (2, 2), "SAME", 0.0)
    y = F.conv2d(xp.permute(0, 3, 1, 2), weight, stride=2, groups=c)
    return y.permute(0, 2, 3, 1)


class _QuickNetModule(nn.Module):
    """QuickNet over NHWC input; returns float32 logits.

    ``binary_compute``/``packed_weights`` may be per-section tuples.
    ``pack_residuals`` stores the binary convs' training residuals at 1
    bit per value (int8 path; see ``QuantConv``).
    ``fold_bn`` (deployment only) skips the BN after each packed binary
    conv: its eval-mode affine was folded into the conv's
    ``kernel_scale``/``bias`` by ``ops.packed.pack_quantconv_params``. The
    skipped BN still takes its number, so the remaining BatchNorm names
    match the trained checkpoint."""

    def __init__(
        self,
        *,
        in_channels: int,
        blocks_per_section: Tuple[int, ...],
        section_features: Tuple[int, ...],
        num_classes: int,
        dtype: torch.dtype,
        binary_compute: Any = "xnor_popcount",
        packed_weights: Any = False,
        pack_residuals: bool = False,
        fold_bn: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        self.config: Dict[str, Any] = dict(
            in_channels=in_channels,
            blocks_per_section=tuple(blocks_per_section),
            section_features=tuple(section_features),
            num_classes=num_classes,
            dtype=dtype,
            binary_compute=binary_compute,
            packed_weights=packed_weights,
            pack_residuals=pack_residuals,
            fold_bn=fold_bn,
            binary_flavor=binary_flavor,
        )
        self.dtype = dtype
        counters: Dict[str, int] = {}

        def add(kind: str, module: Optional[nn.Module]) -> Optional[str]:
            name = f"{kind}_{counters.get(kind, 0)}"
            counters[kind] = counters.get(kind, 0) + 1
            if module is None:
                return None
            self.add_module(name, module)
            return name

        d = dtype
        f0 = section_features[0]
        self._stem = [
            add("Conv", Conv(in_channels, 8, (3, 3), (2, 2), dtype=d)),
            add("BatchNorm", BatchNorm(8, dtype=d)),
            add("Conv", Conv(8, f0, (3, 3), (2, 2), feature_group_count=4, dtype=d)),
            add("BatchNorm", BatchNorm(f0, dtype=d)),
        ]
        self._sections: List[Tuple[Optional[Tuple[str, str]], List[Tuple[str, Optional[str]]]]] = []
        width = f0
        for s, (n, feat) in enumerate(zip(blocks_per_section, section_features)):
            transition = None
            if s > 0:
                transition = (
                    add("Conv", Conv(width, feat, (1, 1), dtype=d)),
                    add("BatchNorm", BatchNorm(feat, dtype=d)),
                )
                width = feat
            packed = bool(_section_opt(packed_weights, s))
            fold_here = fold_bn and packed
            blocks = []
            for _ in range(n):
                conv = add("QuantConv", QuantConv(
                    feat, feat, (3, 3), dtype=d,
                    binary_compute=_section_opt(binary_compute, s),
                    packed_weights=packed,
                    pack_residuals=pack_residuals,
                    use_bias=fold_here,  # carries the folded BN shift
                    binary_flavor=binary_flavor,
                ))
                bn = add("BatchNorm", None if fold_here else BatchNorm(feat, dtype=d))
                blocks.append((conv, bn))
            self._sections.append((transition, blocks))
        self._head = add("Dense", Dense(width, num_classes, dtype=d))
        self.eval()  # flax's training=False default

    def float_twin(self) -> "_QuickNetModule":
        """The same architecture holding latent float kernels and every BN:
        the training-side model whose converted weights this one serves."""
        return _QuickNetModule(
            **{**self.config, "packed_weights": False, "fold_bn": False}
        )

    @property
    def packed_any(self) -> bool:
        return _packed_any(self.config["packed_weights"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_fold_training(
            self.config["fold_bn"], self.config["packed_weights"], self.training
        )
        layer = self.get_submodule
        conv0, bn0, conv1, bn1 = self._stem
        x = x.to(self.dtype)
        x = F.relu(layer(bn0)(layer(conv0)(x)))
        x = layer(bn1)(layer(conv1)(x))
        for transition, blocks in self._sections:
            if transition is not None:
                x = _blur_pool(F.relu(x), self.dtype)
                x = layer(transition[1])(layer(transition[0])(x))
            for conv, bn in blocks:
                y = layer(conv)(x)
                if bn is not None:
                    y = layer(bn)(y)
                x = x + y  # residual around every binary conv
        x = F.relu(x).mean(dim=(1, 2))
        return layer(self._head)(x).to(torch.float32)


@component
class QuickNet(Model):
    """QuickNet. ``binary_compute``/``packed_weights`` accept one value or
    a per-section tuple (mixed deployment, e.g. ("int8", "int8", "xnor",
    "xnor") with packed_weights (False, False, True, True))."""

    blocks_per_section: Sequence[int] = Field((2, 3, 4, 4))
    section_features: Sequence[int] = Field((64, 128, 256, 512))
    binary_compute: Union[str, Sequence[str]] = Field("mxu")
    packed_weights: Union[bool, Sequence[bool]] = Field(False)
    #: 1-bit residual storage on the binary convs (int8 path only).
    pack_residuals: bool = Field(False)
    #: Deployment-only: binary-conv BNs folded into the conv epilogue
    #: (pair with ops.packed.pack_quantconv_params fold_bn=True).
    fold_bn: bool = Field(False)
    #: Kernel flavor for the binary convs (see ops.binary_compute).
    binary_flavor: str = Field("auto")

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        n_sections = len(tuple(self.blocks_per_section))

        def norm(v):
            if isinstance(v, (list, tuple)):
                if len(v) != n_sections:
                    raise ValueError(
                        f"Per-section value {tuple(v)!r} has {len(v)} entries "
                        f"but the model has {n_sections} sections."
                    )
                return tuple(v)
            return v

        return _QuickNetModule(
            in_channels=int(input_shape[-1]),
            blocks_per_section=tuple(self.blocks_per_section),
            section_features=tuple(self.section_features),
            num_classes=num_classes,
            dtype=self.dtype(),
            binary_compute=norm(self.binary_compute),
            packed_weights=norm(self.packed_weights),
            pack_residuals=self.pack_residuals,
            fold_bn=self.fold_bn,
            binary_flavor=self.binary_flavor,
        )

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        """A packed build gets the packed (and, with ``fold_bn``, folded)
        form of its float twin initialized from the same seed, through
        ``pack_quantconv_params`` — the deployment path a trained float
        model takes. Other builds initialize in place."""
        if not getattr(module, "packed_any", False):
            return super().initialize(module, seed)
        from zookeeper_tpu_torch.models.convert import (
            from_flax_variables,
            to_flax_variables,
        )
        from zookeeper_tpu_torch.ops.packed import pack_quantconv_params

        twin = super().initialize(module.float_twin(), seed)
        params, state = to_flax_variables(twin)
        template, _ = to_flax_variables(module)
        if module.config["fold_bn"]:
            params, stats = pack_quantconv_params(
                params, template=template, fold_bn=True,
                batch_stats=state["batch_stats"],
            )
            state = {"batch_stats": stats}
        else:
            params = pack_quantconv_params(params, template=template)
        module.load_state_dict(from_flax_variables(params, state))
        return module


@component
class QuickNetSmall(QuickNet):
    section_features: Sequence[int] = Field((32, 64, 256, 512))


@component
class QuickNetLarge(QuickNet):
    """QuickNet-Large (the repo's north-star model)."""

    blocks_per_section: Sequence[int] = Field((6, 8, 12, 6))
