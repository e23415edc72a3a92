"""The binary model zoo the port serves and trains.

Counterparts of ``zookeeper_tpu/models/binary.py``'s ``QuickNet``,
``QuickNetSmall`` and ``QuickNetLarge`` (fp stem, sections of residual
binary 3x3 convs, fp 1x1 transitions with blurpool downsampling, fp
head), ``BinaryNet`` (VGG-style: binary 3x3 convs with a maxpool after
every second one, binary dense layers, fp head) and ``BinaryAlexNet``
(fp 11x11 stem, four binary convs, two binary dense layers of 4096, fp
head). A built module starts in eval mode, as flax's ``training`` flag
defaults to False; ``module.train()`` trains it (batch-statistics
BatchNorms), as ``training=True`` does.
Submodules carry the flax auto-numbered names (``Conv_0``,
``BatchNorm_3``, ``QuantConv_7``, ``QuantDense_1``, ``Dense_0``) in flax
creation order, so a JAX checkpoint maps across by name
(``models/convert.py``) and the BN fold pairs each packed binary layer
with the BN created after it.
"""

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.ops.binary_compute import _spatial_pad
from zookeeper_tpu_torch.ops.layers import BatchNorm, Conv, Dense, QuantConv, QuantDense
from zookeeper_tpu_torch.ops.quantizers import dorefa
from zookeeper_tpu_torch.parallel.sharding import constrain_batch_sharded

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


def _dense_stage_fold(
    fold_bn: bool, conv_packed: bool, dense_packed: bool, family: str, pooled_convs: str
) -> bool:
    """Whether the dense stage of a VGG-style family (BinaryNet,
    BinaryAlexNet) folds its BNs. Their convs feed a maxpool BEFORE the
    BatchNorm, and max commutes with the folded per-channel affine only
    when the BN scale is positive, so a conv fold would be wrong for
    learned negative scales: conv-packed + fold raises."""
    if fold_bn and conv_packed:
        raise ValueError(
            f"{family} fold_bn supports the DENSE stage only: "
            f"{pooled_convs} feed a maxpool before their BatchNorm, and "
            "max only commutes with the folded affine when the BN scale "
            "is positive. Pack/fold the dense stage "
            "(dense_packed_weights=True) and keep packed_weights=False."
        )
    return fold_bn and dense_packed


def max_pool(
    x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int], padding: str = "VALID"
) -> torch.Tensor:
    """``flax.linen.max_pool`` over NHWC. SAME pads as XLA does (the odd
    pixel after) with -inf, then pools VALID: ``F.max_pool2d``'s own
    padding is symmetric and would shift every window."""
    x, _, _ = _spatial_pad(x, *window, strides, padding, float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, strides).permute(0, 2, 3, 1)


def avg_pool(
    x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int], padding: str = "VALID"
) -> torch.Tensor:
    """``flax.linen.avg_pool`` over NHWC: SAME pads with zeros that count
    in the mean (flax's ``count_include_pad=True``)."""
    x, _, _ = _spatial_pad(x, *window, strides, padding, 0.0)
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, strides).permute(0, 2, 3, 1)


def _pooled(size: int, window: int, stride: int) -> int:
    return (size - window) // stride + 1


class _FlaxNames:
    """Adds submodules to ``parent`` under flax's auto-numbered names
    (``Conv_0``, ``BatchNorm_3``) in creation order. ``None`` takes a
    number and adds nothing: a BN folded away at deployment still takes
    its number, so the others keep the trained checkpoint's names."""

    def __init__(self, parent: nn.Module):
        self.parent = parent
        self.counters: Dict[str, int] = {}

    def __call__(self, kind: str, module: Optional[nn.Module]) -> Optional[str]:
        n = self.counters.get(kind, 0)
        self.counters[kind] = n + 1
        if module is None:
            return None
        name = f"{kind}_{n}"
        self.parent.add_module(name, module)
        return name


def _post_conv_bn(add: "_FlaxNames", features: int, dtype: torch.dtype,
                  fold_here: bool) -> Optional[str]:
    """The BN after a binary layer or, where the deployment folded it into
    the layer's ``kernel_scale``/``bias``, its number alone: the folded BN
    is skipped but still numbered, so the remaining BatchNorm names match
    the trained checkpoint."""
    return add("BatchNorm", None if fold_here else BatchNorm(features, dtype=dtype))


def _section_opt(value, s: int):
    return value[s] if isinstance(value, (tuple, list)) else value


def _blur_pool(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Anti-aliased stride-2 downsampling over NHWC: fixed 3x3 binomial
    filter, depthwise, SAME padding."""
    c = x.shape[-1]
    # Filled on the device: a host tensor's copy has no place in a CUDA
    # graph's capture.
    f = 2.0 - (torch.arange(3, dtype=dtype, device=x.device) - 1.0).abs()  # [1, 2, 1]
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

    KERNEL_QUANTIZER = "ste_sign"

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
        add = _FlaxNames(self)
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
                bn = _post_conv_bn(add, feat, d, fold_here)
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

    @property
    def folds(self) -> bool:
        """Whether the packed layers' following BNs are folded away."""
        return self.config["fold_bn"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_fold_training(
            self.config["fold_bn"], self.config["packed_weights"], self.training
        )
        layer = self.get_submodule
        # The JAX model's activation pins (parallel.sharding): where the
        # port checks the layout it keeps.
        pin = constrain_batch_sharded
        conv0, bn0, conv1, bn1 = self._stem
        x = x.to(self.dtype)
        x = pin(F.relu(layer(bn0)(layer(conv0)(x))))
        x = pin(layer(bn1)(layer(conv1)(x)))
        for transition, blocks in self._sections:
            if transition is not None:
                x = pin(_blur_pool(pin(F.relu(x)), self.dtype))
                x = pin(layer(transition[1])(layer(transition[0])(x)))
            for conv, bn in blocks:
                y = layer(conv)(x)
                if bn is not None:
                    y = layer(bn)(y)
                x = x + y  # residual around every binary conv
        x = F.relu(x).mean(dim=(1, 2))
        return layer(self._head)(x).to(torch.float32)


def _initialize_packed(model: Model, module: nn.Module, seed: int) -> nn.Module:
    """A packed build gets the packed (and, where it folds, folded) form of
    its float twin initialized from the same seed, through
    ``pack_quantconv_params`` with the kernel quantizer the family trains
    with (the module's ``KERNEL_QUANTIZER``: ``magnitude_aware_sign``
    gives Bi-Real-Net and XNOR-Net their mean|w| scales): the deployment
    path a trained float model takes. Other builds initialize in place."""
    if not getattr(module, "packed_any", False):
        return Model.initialize(model, module, seed)
    from zookeeper_tpu_torch.models.convert import (
        from_flax_variables,
        to_flax_variables,
    )
    from zookeeper_tpu_torch.ops.packed import pack_quantconv_params

    twin = Model.initialize(model, module.float_twin(), seed)
    params, state = to_flax_variables(twin)
    template, _ = to_flax_variables(module)
    k_q = module.KERNEL_QUANTIZER
    if module.folds:
        params, stats = pack_quantconv_params(
            params, kernel_quantizer=k_q, template=template, fold_bn=True,
            batch_stats=state["batch_stats"],
        )
        state = {"batch_stats": stats}
    else:
        params = pack_quantconv_params(params, kernel_quantizer=k_q, template=template)
    module.load_state_dict(from_flax_variables(params, state))
    return module


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
        return _initialize_packed(self, module, seed)


@component
class QuickNetSmall(QuickNet):
    section_features: Sequence[int] = Field((32, 64, 256, 512))


@component
class QuickNetLarge(QuickNet):
    """QuickNet-Large (the repo's north-star model)."""

    blocks_per_section: Sequence[int] = Field((6, 8, 12, 6))


class _VggModule(nn.Module):
    """What BinaryNet and BinaryAlexNet share: the dense-stage settings
    (``dense_binary_compute``/``dense_packed_weights``, None = follow the
    conv stage), the dense-stage BN fold, the binary dense layers with
    their BNs, the fp head and the float twin."""

    FAMILY = ""
    POOLED_CONVS = ""
    KERNEL_QUANTIZER = "ste_sign"

    def _setup_dense_stage(self, add: _FlaxNames, width: int, dense_units, num_classes: int,
                           fold_bn: bool, dtype: torch.dtype, flavor: str) -> None:
        c = self.config
        conv_packed = bool(c["packed_weights"])
        dense_bc = c["binary_compute"] if c["dense_binary_compute"] is None else c["dense_binary_compute"]
        dense_packed = bool(
            c["packed_weights"] if c["dense_packed_weights"] is None else c["dense_packed_weights"]
        )
        self.dense_packed = dense_packed
        self.dense_fold = _dense_stage_fold(
            fold_bn, conv_packed, dense_packed, self.FAMILY, self.POOLED_CONVS
        )
        self._denses: List[Tuple[str, Optional[str]]] = []
        for units in dense_units:
            dense = add("QuantDense", QuantDense(
                width, units, input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                use_bias=self.dense_fold,  # carries the folded BN shift
                dtype=dtype, binary_compute=dense_bc, packed_weights=dense_packed,
                binary_flavor=flavor,
            ))
            bn = _post_conv_bn(add, units, dtype, self.dense_fold)
            self._denses.append((dense, bn))
            width = units
        self._head = add("Dense", Dense(width, num_classes, dtype=dtype))

    def float_twin(self) -> "_VggModule":
        """The same architecture holding latent float kernels and every BN:
        the training-side model whose converted weights this one serves."""
        return type(self)(**{**self.config, "packed_weights": False,
                             "dense_packed_weights": False, "fold_bn": False})

    @property
    def packed_any(self) -> bool:
        return bool(self.config["packed_weights"]) or self.dense_packed

    @property
    def folds(self) -> bool:
        return self.dense_fold

    def _dense_stage(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        x = x.reshape(x.shape[0], -1)
        for dense, bn in self._denses:
            x = layer(dense)(x)
            if bn is not None:
                x = layer(bn)(x)
        return layer(self._head)(x).to(torch.float32)


class _BinaryNetModule(_VggModule):
    """VGG-style BinaryNet (Courbariaux et al. 2016) over NHWC input:
    binary 3x3 SAME convs (the first one takes the fp input on "mxu"), a
    2x2 maxpool after every second conv, a BN after each, then the binary
    dense layers and the fp head; float32 logits. ``fold_bn`` folds the
    dense stage only (see :func:`_dense_stage_fold`)."""

    FAMILY = "BinaryNet"
    POOLED_CONVS = "odd-indexed convs"

    def __init__(
        self,
        *,
        input_shape: Tuple[int, int, int],
        features: Tuple[int, ...],
        dense_units: Tuple[int, ...],
        num_classes: int,
        dtype: torch.dtype,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        dense_binary_compute: Optional[str] = None,
        dense_packed_weights: Optional[bool] = None,
        fold_bn: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        self.config: Dict[str, Any] = dict(
            input_shape=tuple(input_shape), features=tuple(features),
            dense_units=tuple(dense_units), num_classes=num_classes, dtype=dtype,
            binary_compute=binary_compute, packed_weights=packed_weights,
            dense_binary_compute=dense_binary_compute,
            dense_packed_weights=dense_packed_weights, fold_bn=fold_bn,
            binary_flavor=binary_flavor,
        )
        self.dtype = dtype
        add = _FlaxNames(self)
        h, w, width = input_shape
        self._convs: List[Tuple[str, str]] = []
        for i, feat in enumerate(features):
            conv = add("QuantConv", QuantConv(
                width, feat, (3, 3), input_quantizer=None if i == 0 else "ste_sign",
                kernel_quantizer="ste_sign", dtype=dtype,
                binary_compute="mxu" if i == 0 else binary_compute,
                packed_weights=False if i == 0 else packed_weights,
                binary_flavor=binary_flavor,
            ))
            if i % 2 == 1:
                h, w = _pooled(h, 2, 2), _pooled(w, 2, 2)
            self._convs.append((conv, add("BatchNorm", BatchNorm(feat, dtype=dtype))))
            width = feat
        self._setup_dense_stage(add, h * w * width, dense_units, num_classes, fold_bn, dtype,
                                binary_flavor)
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_fold_training(self.config["fold_bn"], self.dense_packed, self.training)
        layer = self.get_submodule
        x = x.to(self.dtype)
        for i, (conv, bn) in enumerate(self._convs):
            x = layer(conv)(x)
            if i % 2 == 1:
                x = max_pool(x, (2, 2), (2, 2))
            x = layer(bn)(x)
        return self._dense_stage(x)


class _BinaryAlexNetModule(_VggModule):
    """Binary AlexNet over NHWC input: fp 11x11/4 stem, 3x3/2 maxpool, BN;
    binary convs of 192, 384, 384 and 256 channels (5x5, then 3x3), a
    maxpool after the first and the last, a BN after each; two binary
    dense layers of 4096 with BNs; the fp head; float32 logits.
    ``fold_bn`` folds the dense stage only (see :func:`_dense_stage_fold`)."""

    FAMILY = "BinaryAlexNet"
    POOLED_CONVS = "two of the four binary convs"

    def __init__(
        self,
        *,
        input_shape: Tuple[int, int, int],
        num_classes: int,
        dtype: torch.dtype,
        inflation: int = 1,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        dense_binary_compute: Optional[str] = None,
        dense_packed_weights: Optional[bool] = None,
        fold_bn: bool = False,
    ):
        super().__init__()
        self.config: Dict[str, Any] = dict(
            input_shape=tuple(input_shape), num_classes=num_classes, dtype=dtype,
            inflation=inflation, binary_compute=binary_compute,
            packed_weights=packed_weights, dense_binary_compute=dense_binary_compute,
            dense_packed_weights=dense_packed_weights, fold_bn=fold_bn,
        )
        self.dtype = dtype
        f = inflation
        add = _FlaxNames(self)
        h, w, width = input_shape
        self._stem = (add("Conv", Conv(width, 64 * f, (11, 11), (4, 4), dtype=dtype)),
                      add("BatchNorm", BatchNorm(64 * f, dtype=dtype)))
        h, w = _pooled(-(-h // 4), 3, 2), _pooled(-(-w // 4), 3, 2)
        width = 64 * f
        self._convs: List[Tuple[str, bool, str]] = []
        for feat, k in ((192 * f, 5), (384 * f, 3), (384 * f, 3), (256 * f, 3)):
            conv = add("QuantConv", QuantConv(
                width, feat, (k, k), input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                dtype=dtype, binary_compute=binary_compute, packed_weights=packed_weights,
            ))
            pool = feat in (192 * f, 256 * f)
            if pool:
                h, w = _pooled(h, 3, 2), _pooled(w, 3, 2)
            self._convs.append((conv, pool, add("BatchNorm", BatchNorm(feat, dtype=dtype))))
            width = feat
        self._setup_dense_stage(add, h * w * width, (4096, 4096), num_classes, fold_bn, dtype,
                                "auto")
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_fold_training(self.config["fold_bn"], self.dense_packed, self.training)
        layer = self.get_submodule
        conv0, bn0 = self._stem
        x = max_pool(layer(conv0)(x.to(self.dtype)), (3, 3), (2, 2))
        x = layer(bn0)(x)
        for conv, pool, bn in self._convs:
            x = layer(conv)(x)
            if pool:
                x = max_pool(x, (3, 3), (2, 2))
            x = layer(bn)(x)
        return self._dense_stage(x)


@component
class BinaryNet(Model):
    """BinaryNet VGG for CIFAR-scale inputs."""

    features: Sequence[int] = Field((128, 128, 256, 256, 512, 512))
    dense_units: Sequence[int] = Field((1024, 1024))
    #: Binary conv path: "mxu", "int8", "xnor" or "xnor_popcount".
    binary_compute: str = Field("mxu")
    #: Inference-only: the bit-packed kernels (a seeded build holds the
    #: packed form of its float twin, see ``initialize``).
    packed_weights: bool = Field(False)
    #: Dense-stage overrides; unset = follow the conv-stage settings.
    dense_binary_compute: str = Field(allow_missing=True)
    dense_packed_weights: bool = Field(allow_missing=True)
    #: Deployment-only, DENSE stage only (see ``_dense_stage_fold``).
    fold_bn: bool = Field(False)
    #: Kernel flavor for the binary layers (see ops.binary_compute).
    binary_flavor: str = Field("auto")

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        # allow_missing fields raise AttributeError on read; getattr's
        # default maps that to "follow the conv-stage settings".
        return _BinaryNetModule(
            input_shape=tuple(int(s) for s in input_shape),
            features=tuple(self.features), dense_units=tuple(self.dense_units),
            num_classes=num_classes, dtype=self.dtype(),
            binary_compute=self.binary_compute, packed_weights=self.packed_weights,
            dense_binary_compute=getattr(self, "dense_binary_compute", None),
            dense_packed_weights=getattr(self, "dense_packed_weights", None),
            fold_bn=self.fold_bn, binary_flavor=self.binary_flavor,
        )

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        return _initialize_packed(self, module, seed)


@component
class BinaryAlexNet(Model):
    """Binarized AlexNet for ImageNet (BASELINE config #2)."""

    inflation: int = Field(1)
    binary_compute: str = Field("mxu")
    packed_weights: bool = Field(False)
    #: Dense-stage overrides; unset = follow the conv-stage settings.
    #: Dense-only packing ("xnor" + True here, mxu convs) is BASELINE's
    #: deployment.
    dense_binary_compute: str = Field(allow_missing=True)
    dense_packed_weights: bool = Field(allow_missing=True)
    #: Deployment-only, DENSE stage only (see ``_dense_stage_fold``).
    fold_bn: bool = Field(False)

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _BinaryAlexNetModule(
            input_shape=tuple(int(s) for s in input_shape), num_classes=num_classes,
            dtype=self.dtype(), inflation=self.inflation,
            binary_compute=self.binary_compute, packed_weights=self.packed_weights,
            dense_binary_compute=getattr(self, "dense_binary_compute", None),
            dense_packed_weights=getattr(self, "dense_packed_weights", None),
            fold_bn=self.fold_bn,
        )

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        return _initialize_packed(self, module, seed)


def _conv_out(size: int, k: int, s: int, padding: str) -> int:
    return -(-size // s) if padding == "SAME" else (size - k) // s + 1


class _XnorNetModule(nn.Module):
    """XNOR-Net over NHWC input: binarized AlexNet in the order BN ->
    binarize -> conv -> pool, every binary layer's kernel
    ``magnitude_aware_sign`` (mean|w| per output channel). An fp 11x11/4
    VALID stem of 96 and BN, a 3x3/2 max pool; binary convs of 256 (5x5),
    384, 384 and 256 (3x3), each followed by its BN, max pools after the
    first and the last; two binary dense layers of 4096 with BNs; the fp
    head; float32 logits. Every binary layer is directly BN-followed, so
    ``fold_bn`` folds both stages, each where it is packed."""

    KERNEL_QUANTIZER = "magnitude_aware_sign"

    def __init__(
        self,
        *,
        input_shape: Tuple[int, int, int],
        num_classes: int,
        dtype: torch.dtype,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        dense_binary_compute: Optional[str] = None,
        dense_packed_weights: Optional[bool] = None,
        fold_bn: bool = False,
    ):
        super().__init__()
        self.config: Dict[str, Any] = dict(
            input_shape=tuple(input_shape), num_classes=num_classes, dtype=dtype,
            binary_compute=binary_compute, packed_weights=packed_weights,
            dense_binary_compute=dense_binary_compute,
            dense_packed_weights=dense_packed_weights, fold_bn=fold_bn,
        )
        self.dtype = dtype
        self.dense_packed = bool(
            packed_weights if dense_packed_weights is None else dense_packed_weights
        )
        conv_fold = fold_bn and bool(packed_weights)
        self.dense_fold = fold_bn and self.dense_packed
        dense_bc = binary_compute if dense_binary_compute is None else dense_binary_compute
        add = _FlaxNames(self)
        h, w, width = input_shape
        self._stem = (add("Conv", Conv(width, 96, (11, 11), (4, 4), "VALID", dtype=dtype)),
                      add("BatchNorm", BatchNorm(96, dtype=dtype)))
        h, w = _pooled(_conv_out(h, 11, 4, "VALID"), 3, 2), _pooled(_conv_out(w, 11, 4, "VALID"), 3, 2)
        width = 96
        self._convs: List[Tuple[str, Optional[str], bool]] = []
        for feat, k, pool in ((256, 5, True), (384, 3, False), (384, 3, False), (256, 3, True)):
            conv = add("QuantConv", QuantConv(
                width, feat, (k, k), input_quantizer="ste_sign",
                kernel_quantizer="magnitude_aware_sign", dtype=dtype,
                binary_compute=binary_compute, packed_weights=packed_weights,
                use_bias=conv_fold,  # carries the folded BN shift
            ))
            self._convs.append((conv, _post_conv_bn(add, feat, dtype, conv_fold), pool))
            if pool:
                h, w = _pooled(h, 3, 2), _pooled(w, 3, 2)
            width = feat
        width = h * w * width
        self._denses: List[Tuple[str, Optional[str]]] = []
        for units in (4096, 4096):
            dense = add("QuantDense", QuantDense(
                width, units, input_quantizer="ste_sign",
                kernel_quantizer="magnitude_aware_sign", use_bias=self.dense_fold, dtype=dtype,
                binary_compute=dense_bc, packed_weights=self.dense_packed,
            ))
            self._denses.append((dense, _post_conv_bn(add, units, dtype, self.dense_fold)))
            width = units
        self._head = add("Dense", Dense(width, num_classes, dtype=dtype))
        self.eval()  # flax's training=False default

    def float_twin(self) -> "_XnorNetModule":
        """The same architecture holding latent float kernels and every BN."""
        return _XnorNetModule(**{**self.config, "packed_weights": False,
                                 "dense_packed_weights": False, "fold_bn": False})

    @property
    def packed_any(self) -> bool:
        return bool(self.config["packed_weights"]) or self.dense_packed

    @property
    def folds(self) -> bool:
        return bool(self.config["fold_bn"]) and self.packed_any

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_fold_training(self.config["fold_bn"], self.packed_any, self.training)
        layer = self.get_submodule
        conv0, bn0 = self._stem
        x = max_pool(layer(bn0)(layer(conv0)(x.to(self.dtype))), (3, 3), (2, 2))
        for conv, bn, pool in self._convs:
            x = layer(conv)(x)
            if bn is not None:
                x = layer(bn)(x)
            if pool:
                x = max_pool(x, (3, 3), (2, 2))
        x = x.reshape(x.shape[0], -1)
        for dense, bn in self._denses:
            x = layer(dense)(x)
            if bn is not None:
                x = layer(bn)(x)
        return layer(self._head)(x).to(torch.float32)


@component
class XNORNet(Model):
    """XNOR-Net AlexNet."""

    binary_compute: str = Field("mxu")
    packed_weights: bool = Field(False)
    #: Dense-stage overrides; unset = follow the conv-stage settings.
    dense_binary_compute: str = Field(allow_missing=True)
    dense_packed_weights: bool = Field(allow_missing=True)
    #: Deployment-only; both stages fold, each where it is packed.
    fold_bn: bool = Field(False)

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _XnorNetModule(
            input_shape=tuple(int(s) for s in input_shape), num_classes=num_classes,
            dtype=self.dtype(), binary_compute=self.binary_compute,
            packed_weights=self.packed_weights,
            dense_binary_compute=getattr(self, "dense_binary_compute", None),
            dense_packed_weights=getattr(self, "dense_packed_weights", None),
            fold_bn=self.fold_bn,
        )

    def initialize(self, module: nn.Module, seed: int = 0) -> nn.Module:
        return _initialize_packed(self, module, seed)


class _DoReFaNetModule(nn.Module):
    """DoReFa-Net w1/a``activation_bits`` over NHWC input: an fp 12x12/4
    VALID stem of 96 and BN; binary convs of 256 (5x5), 384, 384 and 256
    (3x3) whose inputs are ``dorefa`` k-bit fixed point and whose kernels
    are ``magnitude_aware_sign``, each followed by BN, 3x3/2 SAME max pools
    after the first and the last; two such dense layers of 4096 with BNs;
    the fp head; float32 logits. Multi-bit activations keep it on the
    "mxu" path (the quantizer passes as a callable, as in the JAX
    module)."""

    def __init__(self, *, input_shape: Tuple[int, int, int], num_classes: int,
                 dtype: torch.dtype, activation_bits: int = 2):
        super().__init__()
        self.dtype = dtype
        act_q = functools.partial(dorefa, k_bit=activation_bits)
        add = _FlaxNames(self)
        h, w, width = input_shape
        self._stem = (add("Conv", Conv(width, 96, (12, 12), (4, 4), "VALID", dtype=dtype)),
                      add("BatchNorm", BatchNorm(96, dtype=dtype)))
        h, w = _conv_out(h, 12, 4, "VALID"), _conv_out(w, 12, 4, "VALID")
        width = 96
        self._convs: List[Tuple[str, str, bool]] = []
        for feat, k, pool in ((256, 5, True), (384, 3, False), (384, 3, False), (256, 3, True)):
            conv = add("QuantConv", QuantConv(
                width, feat, (k, k), input_quantizer=act_q,
                kernel_quantizer="magnitude_aware_sign", dtype=dtype))
            self._convs.append((conv, add("BatchNorm", BatchNorm(feat, dtype=dtype)), pool))
            if pool:
                h, w = _conv_out(h, 3, 2, "SAME"), _conv_out(w, 3, 2, "SAME")
            width = feat
        width = h * w * width
        self._denses: List[Tuple[str, str]] = []
        for units in (4096, 4096):
            dense = add("QuantDense", QuantDense(
                width, units, input_quantizer=act_q, kernel_quantizer="magnitude_aware_sign",
                use_bias=False, dtype=dtype))
            self._denses.append((dense, add("BatchNorm", BatchNorm(units, dtype=dtype))))
            width = units
        self._head = add("Dense", Dense(width, num_classes, dtype=dtype))
        self.eval()  # flax's training=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.get_submodule
        conv0, bn0 = self._stem
        x = layer(bn0)(layer(conv0)(x.to(self.dtype)))
        for conv, bn, pool in self._convs:
            x = layer(bn)(layer(conv)(x))
            if pool:
                x = max_pool(x, (3, 3), (2, 2), "SAME")
        x = x.reshape(x.shape[0], -1)
        for dense, bn in self._denses:
            x = layer(bn)(layer(dense)(x))
        return layer(self._head)(x).to(torch.float32)


@component
class DoReFaNet(Model):
    """DoReFa-Net w1/a2 (1-bit scaled weights, 2-bit activations)."""

    activation_bits: int = Field(2)

    def build(self, input_shape: Sequence[int], num_classes: int) -> nn.Module:
        return _DoReFaNetModule(
            input_shape=tuple(int(s) for s in input_shape), num_classes=num_classes,
            dtype=self.dtype(), activation_bits=self.activation_bits,
        )
