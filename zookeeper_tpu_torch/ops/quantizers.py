"""Straight-through-estimator quantizers: the port of
``zookeeper_tpu/ops/quantizers.py``, as ``torch.autograd.Function``s.
Each forward gives exactly representable values; each backward is the
JAX package's surrogate gradient:

- ``ste_sign``: sign forward (sign(±0) = +1, sign(NaN) = -1), gradient
  ``g * (|x| <= 1)`` (BinaryNet's clipped identity);
- ``ste_sign_packed``: the same values and gradients, with the backward
  residual stored at 1 bit per value — the pass-through mask is packed
  along the batch in the forward (K6, mask mode) and applied in the
  backward by K8;
- ``approx_sign``: sign forward, gradient ``g * (2 - 2|x|) * (|x| <= 1)``
  (Bi-Real-Net);
- ``swish_sign(x, beta=5.0)``: sign forward, the scaled swish
  derivative ``beta (2 - bx tanh(bx / 2)) s (1 - s) 2`` with ``bx = beta
  x`` and ``s = sigmoid(bx)`` as the gradient (BNN+);
- ``magnitude_aware_sign``: ``sign(w) * mean|w|``, the mean over every
  axis but the last (one scale per output channel), held constant in the
  gradient ``g * scale * (|w| <= 1)`` (Bi-Real-Net's weights);
- ``ste_tern(x, threshold_value=0.05, ternary_weight_networks=False)``:
  {-1, 0, +1} past ``±threshold`` (TWN: ``0.7 * mean|x|``), gradient
  ``g * (|x| <= 1)``;
- ``ste_heaviside``: {0, 1} (``x > 0``), gradient ``g * (|x| <= 1)``;
- ``dorefa(x, k_bit=2)``: ``floor(clip(x, 0, 1) * n + 0.5) / n`` with
  ``n = 2**k_bit - 1`` (half-up rounding), gradient ``g * (0 <= x <= 1)``.

The sign-family forwards give +1 at ±0 and -1 at NaN. The scales of
``magnitude_aware_sign`` and TWN's threshold are float32 means; XLA and
PyTorch sum them in different orders, so they may differ from the JAX
package's in the last bits (the signs never do).

The int8 KV-row codec of the paged decode cache is here too:
``quantize_kv_rows`` / ``dequantize_kv_rows``.
"""

import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from zookeeper_tpu_torch.ops import binary_compute


def _sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Sign with sign(±0) = +1 and sign(NaN) = -1, in ``x``'s dtype."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class _SteSignPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(binary_compute.pack_resid(x, mask_mode=True))
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (words,) = ctx.saved_tensors
        return binary_compute.mask_mul_resid(g, words)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Sign forward, clipped-identity (``|x| <= 1``) gradient."""
    return _SteSign.apply(x) if _differentiated(x) else _sign_pm1(x)


def ste_sign_packed(x: torch.Tensor) -> torch.Tensor:
    """:func:`ste_sign` whose backward residual is the 1-bit packed
    mask (K6 in the forward, K8 in the backward) instead of ``x``.
    Identical values and gradients. Needs a batched input (batch first).
    Without a gradient to take it is the plain sign (nothing packed)."""
    return _SteSignPacked.apply(x) if _differentiated(x) else _sign_pm1(x)


class _ApproxSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a = x.abs()
        return g * ((2.0 - 2.0 * a) * (a <= 1.0).to(g.dtype))


def approx_sign(x: torch.Tensor) -> torch.Tensor:
    """Sign forward, Bi-Real-Net's piecewise-linear gradient
    ``g * (2 - 2|x|)`` inside ``|x| <= 1``."""
    return _ApproxSign.apply(x) if _differentiated(x) else _sign_pm1(x)


class _SwishSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        beta = ctx.beta
        bx = beta * x
        # The logistic as 1 / (1 + exp(-bx)), each step rounded in x's
        # dtype, as XLA expands it.
        sig = 1.0 / (1.0 + torch.exp(-bx))
        surrogate = beta * (2.0 - bx * torch.tanh(bx * 0.5)) * sig * (1.0 - sig) * 2.0
        return g * surrogate, None


def swish_sign(x: torch.Tensor, beta: float = 5.0) -> torch.Tensor:
    """Sign forward, BNN+'s scaled swish-derivative gradient (``beta`` is
    not differentiated)."""
    return _SwishSign.apply(x, beta) if _differentiated(x) else _sign_pm1(x)


def _mean_abs(x: torch.Tensor, dims=None) -> torch.Tensor:
    """mean|x| over ``dims`` (all by default, else kept as size-1 axes),
    summed in float32 and scaled by the float32 reciprocal of the count,
    as XLA computes a mean; in ``x``'s dtype, outside the gradient."""
    a = x.detach().abs().float()
    count = a.numel() if dims is None else math.prod(a.shape[d] for d in dims)
    total = a.sum() if dims is None else a.sum(dim=dims, keepdim=True)
    # A fill, not a host copy, so a CUDA graph can capture it.
    recip = 1.0 / torch.full((), float(count), dtype=torch.float32, device=x.device)
    return (total * recip).to(x.dtype)


def _channel_mean_abs(w: torch.Tensor) -> torch.Tensor:
    """mean|w| over every axis but the last, kept as size-1 axes."""
    return _mean_abs(w, tuple(range(w.dim() - 1)))


class _MagnitudeAwareSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        scale = _channel_mean_abs(w)
        ctx.save_for_backward(w, scale)
        return _sign_pm1(w) * scale

    @staticmethod
    def backward(ctx, g):
        w, scale = ctx.saved_tensors
        return g * scale * (w.abs() <= 1.0).to(g.dtype)


def magnitude_aware_sign(w: torch.Tensor) -> torch.Tensor:
    """``sign(w) * mean|w|`` per output channel (the last axis), the scale
    held constant in the gradient ``g * scale * (|w| <= 1)``."""
    if _differentiated(w):
        return _MagnitudeAwareSign.apply(w)
    return _sign_pm1(w) * _channel_mean_abs(w)


def _clip_mask(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return g * (x.abs() <= 1.0).to(g.dtype)


def _tern_forward(x: torch.Tensor, threshold_value: float, twn: bool) -> torch.Tensor:
    thr = 0.7 * _mean_abs(x) if twn else threshold_value
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > thr, one, torch.where(x < -thr, -one, torch.zeros_like(one)))


class _SteTern(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, threshold_value, twn):
        ctx.save_for_backward(x)
        return _tern_forward(x, threshold_value, twn)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _clip_mask(x, g), None, None


def ste_tern(
    x: torch.Tensor, threshold_value: float = 0.05, ternary_weight_networks: bool = False
) -> torch.Tensor:
    """{-1, 0, +1}: +1 above ``threshold_value``, -1 below its negative
    (Ternary Weight Networks: the threshold is ``0.7 * mean|x|``); the
    clipped-identity gradient."""
    if _differentiated(x):
        return _SteTern.apply(x, threshold_value, ternary_weight_networks)
    return _tern_forward(x, threshold_value, ternary_weight_networks)


def _heaviside(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).to(x.dtype)


class _SteHeaviside(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _heaviside(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _clip_mask(x, g)


def ste_heaviside(x: torch.Tensor) -> torch.Tensor:
    """{0, 1} (``x > 0``), the clipped-identity gradient."""
    return _SteHeaviside.apply(x) if _differentiated(x) else _heaviside(x)


def _dorefa_forward(x: torch.Tensor, k_bit: int) -> torch.Tensor:
    n = float(2**k_bit - 1)
    # Half-up rounding: torch.round is half to even.
    return torch.floor(x.clamp(0.0, 1.0) * n + 0.5) / n


class _Dorefa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_bit):
        ctx.save_for_backward(x)
        return _dorefa_forward(x, k_bit)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= 0.0) & (x <= 1.0)).to(g.dtype), None


def dorefa(x: torch.Tensor, k_bit: int = 2) -> torch.Tensor:
    """DoReFa's k-bit fixed point in [0, 1]: ``2**k_bit`` levels, half-up
    rounding; the gradient passes inside [0, 1]."""
    return _Dorefa.apply(x, k_bit) if _differentiated(x) else _dorefa_forward(x, k_bit)


#: Symmetric int8 grid [-127, 127] of the KV-row codec: dequantization is
#: one multiply, with no zero point.
KV_INT8_QMAX = 127.0


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV rows ``x [..., heads, head_dim]`` to ``(q int8 [...,
    heads, head_dim], scale float32 [..., heads])``: ``scale = max|x| /
    127`` per (row, head), 1 for an all-zero row, ``q = round(x /
    scale)`` clipped to the grid. The rounding is half to even, as the
    JAX package's ``jnp.round`` (its docstring says half away from zero;
    the code is what both packages match)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / KV_INT8_QMAX, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).clamp(-KV_INT8_QMAX, KV_INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: float32 rows ``q * scale``."""
    return q.float() * scale.float()[..., None]


QUANTIZERS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "ste_sign": ste_sign,
    "ste_sign_packed": ste_sign_packed,
    "approx_sign": approx_sign,
    "swish_sign": swish_sign,
    "magnitude_aware_sign": magnitude_aware_sign,
    "ste_tern": ste_tern,
    "ste_heaviside": ste_heaviside,
    "dorefa": dorefa,
}


def get_quantizer(
    q: Union[str, Callable, None],
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Resolve a quantizer by name (config/CLI strings) or pass through a
    callable / None."""
    if q is None or callable(q):
        return q
    if q in QUANTIZERS:
        return QUANTIZERS[q]
    raise ValueError(f"Unknown quantizer {q!r}. Known: {sorted(QUANTIZERS)}.")
