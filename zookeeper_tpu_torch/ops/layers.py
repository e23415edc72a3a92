"""Inference layers of the packed QuickNet path, as ``nn.Module``s.

Counterparts of the flax layers the JAX QuickNet builds: ``Conv``
(``flax.linen.Conv``), ``BatchNorm`` (eval mode of ``ops/layers.py``
``BatchNorm``), ``Dense`` and ``QuantConv`` on its packed binary paths.
Every layer takes and returns NHWC tensors, as in the JAX package. The
fp convs run ``F.conv2d`` on the logical-NCHW view of the NHWC storage
(a ``torch.channels_last`` tensor), so no layout copy is made; the
packed kernels read the same storage directly. Parameter names and
layouts follow the flax ones (see ``models/convert.py``), except that
fp conv weights are OIHW and the dense weight is [out, in], as PyTorch
holds them.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.ops.binary_compute import (
    _packed_conv_forward,
    _spatial_pad,
    pack_conv_kernel,
    packed_conv_infer,
    resolve_binary_flavor,
)
from zookeeper_tpu_torch.ops.quantizers import get_quantizer

#: Binary compute modes of the JAX package; the port runs the two packed
#: ones so far.
BINARY_COMPUTE_MODES = ("mxu", "int8", "xnor", "xnor_popcount")
PORTED_BINARY_COMPUTE = ("xnor", "xnor_popcount")


def check_binary_compute(mode: str, layer: str) -> None:
    """Raise for an unknown mode, and loudly for a mode the port does not
    run yet: a config asking for it must not quietly run another path."""
    if mode not in BINARY_COMPUTE_MODES:
        raise ValueError(
            f"{layer}: unknown binary_compute {mode!r}; choose from "
            f"{BINARY_COMPUTE_MODES}."
        )
    if mode not in PORTED_BINARY_COMPUTE:
        raise NotImplementedError(
            f"{layer}: binary_compute={mode!r} (the unpacked int8/mxu conv "
            "paths and mixed per-section deployment) is not in the PyTorch "
            "port yet; it is queued in ROADMAP.md. Use 'xnor' or "
            "'xnor_popcount'."
        )


def _apply_clip(kernel: torch.Tensor, clip: bool) -> torch.Tensor:
    """Read-time weight clip (the forward of the JAX layer's straight-
    through projection)."""
    return kernel.clamp(-1.0, 1.0) if clip else kernel


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class Conv(nn.Module):
    """Float conv over NHWC with XLA SAME/VALID padding (``flax.linen.Conv``
    with ``use_bias=False``); the weight is OIHW. Computes in ``dtype``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int],
        strides: Tuple[int, int] = (1, 1),
        padding: str = "SAME",
        feature_group_count: int = 1,
        dtype: torch.dtype = torch.float32,
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

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()  # lecun_normal, as flax's default
        _normal_(self.weight, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        x, _, _ = _spatial_pad(
            x.to(self.dtype), kh, kw, self.strides, self.padding, 0.0
        )
        y = F.conv2d(
            x.permute(0, 3, 1, 2), self.weight.to(self.dtype),
            stride=self.strides, groups=self.groups,
        )
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the trailing (channel) axis, in flax's
    order: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
    cast to ``dtype``. Running statistics only: the port serves."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
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
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        return y.to(self.dtype)


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


class QuantConv(nn.Module):
    """Binary 2-D conv (NHWC) on the packed paths of the JAX ``QuantConv``.

    ``binary_compute`` is "xnor_popcount" (both operands packed: K1 + K3
    under the default flavor; SAME pads with ones, the documented
    popcount deviation) or "xnor" (int8 activations times packed weights:
    K4; zero padding, exact against the float conv).

    ``packed_weights=True`` holds only the deployed form: ``kernel_packed``
    [kh, kw, ceil(ci/32), co] int32 and ``kernel_scale`` [co] float32 (plus
    ``bias`` when ``use_bias``, which carries a folded BN's shift).
    Otherwise the latent HWIO float ``kernel`` is held and packed at each
    call, as the JAX ``xnor_conv`` forward does. Output is cast to
    ``dtype`` and the bias added in ``dtype``.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Sequence[int] = (1, 1),
        padding: str = "SAME",
        input_quantizer: Optional[str] = "ste_sign",
        kernel_quantizer: Optional[str] = "ste_sign",
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "xnor_popcount",
        packed_weights: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        name = type(self).__name__
        check_binary_compute(binary_compute, name)
        resolve_binary_flavor(binary_flavor)  # loud typo check
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"{name}: padding {padding!r} is not SAME/VALID.")
        self.in_q = get_quantizer(input_quantizer)
        self.k_q = get_quantizer(kernel_quantizer)
        if self.in_q is None or self.k_q is None:
            raise ValueError(
                f"{name}: binary_compute={binary_compute!r} needs both an "
                "input and a kernel quantizer."
            )
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.kernel_clip = kernel_clip
        self.dtype = dtype
        self.use_popcount = binary_compute == "xnor_popcount"
        self.packed_weights = packed_weights
        self.binary_flavor = binary_flavor
        if packed_weights:
            ciw = -(-in_features // 32)
            self.register_buffer(
                "kernel_packed",
                torch.zeros(kh, kw, ciw, features, dtype=torch.int32),
            )
            self.kernel_scale = nn.Parameter(torch.ones(features))
        else:
            self.kernel = nn.Parameter(torch.zeros(kh, kw, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.packed_weights:
                self.kernel_packed.zero_()
                self.kernel_scale.fill_(1.0)
            else:
                kh, kw, ci, co = self.kernel.shape
                std = math.sqrt(2.0 / (kh * kw * (ci + co)))  # glorot_normal
                _normal_(self.kernel, std, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_q(x)
        if self.packed_weights:
            y = packed_conv_infer(
                x, self.kernel_packed, self.kernel_scale, self.strides,
                self.padding, use_popcount=self.use_popcount,
                flavor=self.binary_flavor,
            )
        else:
            packed, scale = pack_conv_kernel(
                self.k_q(_apply_clip(self.kernel, self.kernel_clip))
            )
            y = _packed_conv_forward(
                x, packed, scale, self.strides, self.padding,
                ci=x.shape[-1], use_popcount=self.use_popcount,
                flavor=self.binary_flavor,
            )
        y = y.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y
