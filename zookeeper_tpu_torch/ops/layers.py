"""The binary models' layers, as ``nn.Module``s, for training and serving.

Counterparts of the flax layers the JAX zoo builds: ``Conv``
(``flax.linen.Conv``, with or without a bias), ``BatchNorm``
(``ops/layers.py`` ``BatchNorm``, i.e. ``flax.linen.BatchNorm``), ``Dense``,
and ``QuantConv`` and ``QuantDense`` on all four binary paths with every
quantizer of the registry, validated as the JAX layers validate them.
Every layer takes and returns NHWC tensors, as in the JAX package. The fp
convs run ``F.conv2d`` on the logical-NCHW view of the NHWC storage (a
``torch.channels_last`` tensor), so no layout copy is made; the packed
kernels read the same storage directly. Parameter names and layouts
follow the flax ones (see ``models/convert.py``), except that fp conv
weights are OIHW and the dense weight is [out, in], as PyTorch holds
them. ``module.train()`` is flax's ``training=True``.
"""

import math
from typing import Callable, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.ops.binary_compute import (
    _packed_conv_forward,
    _spatial_pad,
    float_conv,
    int8_conv,
    int8_dense,
    pack_conv_kernel,
    packed_conv_infer,
    packed_dense_infer,
    resolve_binary_flavor,
    xnor_dense,
)
from zookeeper_tpu_torch.ops.quantizers import get_quantizer, ste_sign_packed

#: A quantizer: a registry name, a callable, or None (no quantization).
Quantizer = Union[str, Callable, None]

#: Binary compute modes of the JAX package; the port runs all four.
BINARY_COMPUTE_MODES = ("mxu", "int8", "xnor", "xnor_popcount")

#: Flat param-path regex (flax names: "QuantDense_1/kernel") matching the
#: latent sign-read kernels of the Quant* layers: the JAX package's
#: ``BINARY_KERNEL_PATTERN``, kept here so the port reads no JAX module.
BINARY_KERNEL_PATTERN = r"Quant[A-Za-z0-9]*_\d+/kernel$"

#: Kernel quantizers whose output is sign x per-output-channel scale: the
#: contract of the packed binary kernels.
_SIGN_KERNEL_QUANTIZERS = frozenset(
    {"ste_sign", "approx_sign", "swish_sign", "magnitude_aware_sign"}
)
#: Input quantizers that emit exact small integers ({-1, 0, +1}), which
#: the int8 and packed-weight paths cast to int8 (dorefa's fractions would
#: truncate).
_INT_INPUT_QUANTIZERS = frozenset(
    {"ste_sign", "ste_sign_packed", "approx_sign", "swish_sign", "ste_tern",
     "ste_heaviside"}
)
#: Kernel quantizers the int8 path runs exactly: the sign family (the
#: scale re-applies after the integer sum) and the small-integer ones.
_INT_KERNEL_QUANTIZERS = _SIGN_KERNEL_QUANTIZERS | {"ste_tern", "ste_heaviside"}
#: Input quantizers that emit strictly ±1: what the popcount path and
#: 1-bit residual packing need (a 0 would come back as +1).
_PM1_INPUT_QUANTIZERS = frozenset(
    {"ste_sign", "ste_sign_packed", "approx_sign", "swish_sign"}
)


def kernel_param_name(kernel_quantizer: Quantizer) -> str:
    """The latent kernel's parameter name, as the flax layers name it:
    "kernel" for a sign-family or callable quantizer (what
    ``BINARY_KERNEL_PATTERN`` treats as binary), "kernel_fp" for None and
    the multi-level quantizers (ste_tern, ste_heaviside, dorefa)."""
    if kernel_quantizer is None:
        return "kernel_fp"
    if callable(kernel_quantizer) or kernel_quantizer in _SIGN_KERNEL_QUANTIZERS:
        return "kernel"
    return "kernel_fp"


def check_binary_compute(mode: str, layer: str, input_quantizer: Quantizer = None,
                         kernel_quantizer: Quantizer = None) -> None:
    """Raise where the JAX layers raise: an unknown mode, or a binary path
    that its quantizers cannot run exactly (a typo or a mismatch must not
    quietly run another path). Callables are trusted to honour the value
    contracts."""
    if mode not in BINARY_COMPUTE_MODES:
        raise ValueError(
            f"{layer}: unknown binary_compute {mode!r}; choose from "
            f"{BINARY_COMPUTE_MODES}."
        )
    if mode == "mxu":
        return
    problems = []
    missing = [n for n, q in (("input", input_quantizer), ("kernel", kernel_quantizer))
               if q is None]
    if missing:
        problems.append(
            f"it needs both an input and a kernel quantizer (the {' and '.join(missing)} "
            "quantizer is None: not binarized)"
        )
    if isinstance(kernel_quantizer, str):
        if mode in ("xnor", "xnor_popcount") and kernel_quantizer not in _SIGN_KERNEL_QUANTIZERS:
            problems.append(
                f"kernel_quantizer {kernel_quantizer!r} does not produce sign x "
                "per-channel scale (packed kernels require one of "
                f"{sorted(_SIGN_KERNEL_QUANTIZERS)})"
            )
        if mode == "int8" and kernel_quantizer not in _INT_KERNEL_QUANTIZERS:
            problems.append(
                f"kernel_quantizer {kernel_quantizer!r} does not produce sign x "
                "per-channel scale or exact small integers (int8 requires one of "
                f"{sorted(_INT_KERNEL_QUANTIZERS)})"
            )
    if isinstance(input_quantizer, str):
        if mode in ("int8", "xnor") and input_quantizer not in _INT_INPUT_QUANTIZERS:
            problems.append(
                f"input_quantizer {input_quantizer!r} can emit non-integer values, "
                f"which the int8 activation cast would truncate ({mode} requires "
                f"one of {sorted(_INT_INPUT_QUANTIZERS)})"
            )
        if mode == "xnor_popcount" and input_quantizer not in _PM1_INPUT_QUANTIZERS:
            problems.append(
                f"input_quantizer {input_quantizer!r} can emit values other than "
                "+-1, which bit-packing would miscount (xnor_popcount requires "
                f"one of {sorted(_PM1_INPUT_QUANTIZERS)})"
            )
    if problems:
        raise ValueError(
            f"{layer}: binary_compute={mode!r} requested but unusable: "
            + "; ".join(problems)
            + ". Fix the configuration or set binary_compute='mxu' explicitly "
            "— this layer never falls back silently."
        )


def check_pack_residuals(
    mode: str, input_quantizer, packed_weights: bool, layer: str
) -> None:
    """Loud validation of ``pack_residuals=True`` (1-bit fwd->bwd
    residuals): it needs the int8 path, which owns its backward
    residuals, and a strictly ±1 input quantizer; packed weights are
    inference-only. Callables are trusted to honour the ±1 contract."""
    problems = []
    if packed_weights:
        problems.append(
            "packed_weights=True is inference-only (no training residuals "
            "to pack)"
        )
    if mode != "int8":
        problems.append(
            f"binary_compute={mode!r} does not own its backward residuals "
            "(supported: 'int8')"
        )
    if input_quantizer is None:
        problems.append("input_quantizer is None (unquantized inputs are not +-1)")
    elif isinstance(input_quantizer, str) and input_quantizer not in _PM1_INPUT_QUANTIZERS:
        problems.append(
            f"input_quantizer {input_quantizer!r} can emit values other than "
            "+-1, which 1-bit packing would corrupt (requires one of "
            f"{sorted(_PM1_INPUT_QUANTIZERS)})"
        )
    if problems:
        raise ValueError(
            f"{layer}: pack_residuals=True requested but unusable: "
            + "; ".join(problems)
            + ". Fix the configuration or drop pack_residuals — this layer "
            "never falls back silently."
        )


def _int8_kernel_is_unscaled(kernel_quantizer) -> bool:
    """True when the kernel is statically known to be pure {-1, 0, +1}
    (skips the int8 path's runtime scale extraction). Callables are
    assumed scaled, which stays exact either way."""
    return isinstance(kernel_quantizer, str) and kernel_quantizer != "magnitude_aware_sign"


def _apply_clip(kernel: torch.Tensor, clip: bool) -> torch.Tensor:
    """Read-time weight clip as a straight-through projection: the forward
    sees ``clamp(kernel, -1, 1)``, the gradient passes to the latent
    weight unclipped (larq's weight_clip semantics, as in the JAX
    layer)."""
    if not clip:
        return kernel
    return kernel + (kernel.clamp(-1.0, 1.0) - kernel).detach()


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class Conv(nn.Module):
    """Float conv over NHWC with XLA SAME/VALID padding
    (``flax.linen.Conv``); the weight is OIHW. Computes in ``dtype``, the
    bias (``use_bias``) added in it."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int],
        strides: Tuple[int, int] = (1, 1),
        padding: str = "SAME",
        feature_group_count: int = 1,
        dtype: torch.dtype = torch.float32,
        use_bias: bool = False,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = feature_group_count
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(features, in_features // feature_group_count, kh, kw)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()  # lecun_normal, as flax's default
        _normal_(self.weight, 1.0 / math.sqrt(fan_in), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        x, _, _ = _spatial_pad(
            x.to(self.dtype), kh, kw, self.strides, self.padding, 0.0
        )
        y = F.conv2d(
            x.permute(0, 3, 1, 2), self.weight.to(self.dtype),
            stride=self.strides, groups=self.groups,
        ).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class BatchNorm(nn.Module):
    """Batch norm over the trailing (channel) axis with flax
    ``nn.BatchNorm`` semantics (``momentum`` 0.9 and eps 1e-5 as the zoo
    builds it; flax's own default momentum is 0.99, which ``SimpleCnn``
    takes). Statistics and the normalisation run in float32:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast to ``dtype``.

    In train mode (``module.train()``) it normalises with the batch mean
    and flax's fast biased variance ``mean(x^2) - mean(x)^2`` clipped at
    0, and updates ``ra = m * ra + (1 - m) * batch`` for both statistics
    (the biased variance, unlike ``nn.BatchNorm2d``), ``m`` the share of
    the running statistic kept (flax's convention). In eval mode it uses
    the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                keep, take = self.momentum, 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + take * mean)
                self.running_var.copy_(keep * self.running_var + take * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Dense(nn.Module):
    """``flax.linen.Dense`` over the last axis, computed in ``dtype``;
    the weight is [out, in]."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


def _check_quant_layer(layer: str, binary_compute: str, binary_flavor: str,
                       input_quantizer, kernel_quantizer, packed_weights: bool) -> None:
    """The validation both Quant layers share: a known flavor, a binary path
    its quantizers run exactly (``check_binary_compute``), packed weights
    only on the packed paths."""
    resolve_binary_flavor(binary_flavor)  # loud typo check
    check_binary_compute(binary_compute, layer, input_quantizer, kernel_quantizer)
    if packed_weights and binary_compute not in ("xnor", "xnor_popcount"):
        raise ValueError(
            "packed_weights=True requires binary_compute='xnor' or "
            f"'xnor_popcount', got {binary_compute!r}."
        )


class _QuantLayer(nn.Module):
    @property
    def latent(self) -> nn.Parameter:
        """The latent float kernel, under flax's name for it
        (:func:`kernel_param_name`: ``kernel`` or ``kernel_fp``)."""
        return getattr(self, self.latent_name)


class QuantDense(_QuantLayer):
    """Binary dense layer over the last axis: the JAX ``QuantDense`` on its
    four paths.

    - "mxu": the float matmul of the quantized operands in ``dtype``.
    - "int8": :func:`~zookeeper_tpu_torch.ops.binary_compute.int8_dense`,
      exact integer sums with the float matmul's gradients.
    - "xnor_popcount": both operands packed; K1 + K2 under the default
      flavor, ``pack_bits`` + K5 + the scale under "reference".
    - "xnor": int8 activations times packed weights, K4.

    The two packed paths are inference-only in the port (their training
    VJP is queued in ROADMAP.md). ``packed_weights=True`` holds only the
    deployed form: ``kernel_packed`` [ceil(K/32), N] int32 and
    ``kernel_scale`` [N] float32 (plus ``bias`` when ``use_bias``, which
    carries a folded BN's shift). Otherwise the latent float kernel
    [K, N] (the flax layout, named as flax names it: ``kernel``, or
    ``kernel_fp`` for a multi-level or no quantizer) is held, clipped straight-through and
    quantized at each call. Output is cast to ``dtype`` and the bias added
    in ``dtype``. ``in_features`` (K) is given at construction.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        input_quantizer: Quantizer = None,
        kernel_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        self.in_q = get_quantizer(input_quantizer)
        self.k_q = get_quantizer(kernel_quantizer)
        _check_quant_layer(type(self).__name__, binary_compute, binary_flavor,
                           input_quantizer, kernel_quantizer, packed_weights)
        self.in_features = in_features
        self.kernel_clip = kernel_clip
        self.dtype = dtype
        self.binary_compute = binary_compute
        self.packed_weights = packed_weights
        self.binary_flavor = binary_flavor
        self.scaled = not _int8_kernel_is_unscaled(kernel_quantizer)
        if packed_weights:
            self.register_buffer(
                "kernel_packed",
                torch.zeros(-(-in_features // 32), features, dtype=torch.int32),
            )
            self.kernel_scale = nn.Parameter(torch.ones(features))
        else:
            self.latent_name = kernel_param_name(kernel_quantizer)
            self.register_parameter(
                self.latent_name, nn.Parameter(torch.zeros(in_features, features))
            )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.packed_weights:
                self.kernel_packed.zero_()
                self.kernel_scale.fill_(1.0)
            else:
                k, n = self.latent.shape
                _normal_(self.latent, math.sqrt(2.0 / (k + n)), generator)  # glorot_normal
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.binary_compute
        if x.shape[-1] != self.in_features:
            raise ValueError(
                f"{type(self).__name__}: input has {x.shape[-1]} features, the "
                f"layer was built for {self.in_features}."
            )
        if self.in_q is not None:
            x = self.in_q(x)
        if self.packed_weights:
            y = packed_dense_infer(
                x, self.kernel_packed, self.kernel_scale, self.in_features,
                use_popcount=mode == "xnor_popcount", flavor=self.binary_flavor,
            )
        else:
            kernel = _apply_clip(self.latent, self.kernel_clip)
            if self.k_q is not None:
                kernel = self.k_q(kernel)
            if mode == "int8":
                y = int8_dense(x, kernel, self.scaled)
            elif mode == "mxu":
                d = self.dtype
                y = torch.matmul(x.to(d), kernel.to(d))
            else:
                y = xnor_dense(x, kernel, mode == "xnor_popcount", self.binary_flavor)
        y = y.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class QuantConv(_QuantLayer):
    """Binary 2-D conv (NHWC): the JAX ``QuantConv`` on its four paths.

    - "mxu": the float conv of the quantized operands in ``dtype`` (the
      JAX package's default training path).
    - "int8": :func:`~zookeeper_tpu_torch.ops.binary_compute.int8_conv`,
      exact integer sums with the float conv's gradients.
      ``pack_residuals=True`` stores its forward->backward residuals at 1
      bit per value: the ±1 conv input (K6 in the forward, K7 in the
      backward) and, when the input quantizer is "ste_sign", the STE mask
      (the quantizer becomes "ste_sign_packed": K6, then K8). Numerics
      are bit-identical either way.
    - "xnor_popcount": both operands packed, K1 + K3 under the default
      flavor (SAME pads with ones, the documented popcount deviation).
    - "xnor": int8 activations times packed weights, K4 (zero padding,
      exact against the float conv).

    The two packed paths are inference-only in the port (their training
    VJP is queued in ROADMAP.md). ``packed_weights=True`` holds only the
    deployed form: ``kernel_packed`` [kh, kw, ceil(ci/32), co] int32 and
    ``kernel_scale`` [co] float32 (plus ``bias`` when ``use_bias``, which
    carries a folded BN's shift). Otherwise the latent HWIO float kernel
    (``kernel``, or ``kernel_fp`` as flax names it) is held, clipped
    straight-through and quantized at each call. Output is cast to
    ``dtype`` and the bias added in ``dtype``.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Sequence[int] = (1, 1),
        padding: str = "SAME",
        input_quantizer: Quantizer = "ste_sign",
        kernel_quantizer: Quantizer = "ste_sign",
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        pack_residuals: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        name = type(self).__name__
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"{name}: padding {padding!r} is not SAME/VALID.")
        self.in_q = get_quantizer(input_quantizer)
        self.k_q = get_quantizer(kernel_quantizer)
        _check_quant_layer(name, binary_compute, binary_flavor, input_quantizer,
                           kernel_quantizer, packed_weights)
        if pack_residuals:
            check_pack_residuals(binary_compute, input_quantizer, packed_weights, name)
            if input_quantizer == "ste_sign":
                # Same values and gradients; the STE mask packs to 1 bit
                # alongside the conv input.
                self.in_q = ste_sign_packed
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.kernel_clip = kernel_clip
        self.dtype = dtype
        self.binary_compute = binary_compute
        self.packed_weights = packed_weights
        self.pack_residuals = pack_residuals
        self.binary_flavor = binary_flavor
        self.scaled = not _int8_kernel_is_unscaled(kernel_quantizer)
        if packed_weights:
            ciw = -(-in_features // 32)
            self.register_buffer(
                "kernel_packed",
                torch.zeros(kh, kw, ciw, features, dtype=torch.int32),
            )
            self.kernel_scale = nn.Parameter(torch.ones(features))
        else:
            self.latent_name = kernel_param_name(kernel_quantizer)
            self.register_parameter(
                self.latent_name, nn.Parameter(torch.zeros(kh, kw, in_features, features))
            )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.packed_weights:
                self.kernel_packed.zero_()
                self.kernel_scale.fill_(1.0)
            else:
                kh, kw, ci, co = self.latent.shape
                std = math.sqrt(2.0 / (kh * kw * (ci + co)))  # glorot_normal
                _normal_(self.latent, std, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.binary_compute
        if self.in_q is not None:
            x = self.in_q(x)
        if self.packed_weights:
            y = packed_conv_infer(
                x, self.kernel_packed, self.kernel_scale, self.strides,
                self.padding, use_popcount=mode == "xnor_popcount",
                flavor=self.binary_flavor,
            )
        else:
            kernel = _apply_clip(self.latent, self.kernel_clip)
            if self.k_q is not None:
                kernel = self.k_q(kernel)
            if mode == "int8":
                y = int8_conv(
                    x, kernel, self.strides, self.padding, 1,
                    self.scaled, self.pack_residuals,
                )
            elif mode == "mxu":
                y = float_conv(x.to(self.dtype), kernel, self.strides, self.padding)
            else:
                if torch.is_grad_enabled() and kernel.requires_grad:
                    raise NotImplementedError(
                        f"{type(self).__name__}: training through "
                        f"binary_compute={mode!r} (the xnor_conv VJP) is not "
                        "in the PyTorch port yet; it is queued in "
                        "ROADMAP.md. Train with 'int8' or 'mxu'."
                    )
                packed, scale = pack_conv_kernel(kernel)
                y = _packed_conv_forward(
                    x, packed, scale, self.strides, self.padding,
                    ci=x.shape[-1], use_popcount=mode == "xnor_popcount",
                    flavor=self.binary_flavor,
                )
        y = y.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y
