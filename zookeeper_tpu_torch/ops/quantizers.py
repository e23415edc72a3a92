"""Straight-through-estimator sign quantizers.

The port of the part of ``zookeeper_tpu/ops/quantizers.py`` that
QuickNet uses, as ``torch.autograd.Function``s:

- ``ste_sign``: sign forward (sign(±0) = +1, sign(NaN) = -1), gradient
  ``g * (|x| <= 1)`` (BinaryNet's clipped identity);
- ``ste_sign_packed``: the same values and gradients, with the backward
  residual stored at 1 bit per value — the pass-through mask is packed
  along the batch in the forward (K6, mask mode) and applied in the
  backward by K8.

The int8 KV-row codec of the paged decode cache is here too:
``quantize_kv_rows`` / ``dequantize_kv_rows``.

The other quantizers of the JAX registry (approx_sign, swish_sign,
magnitude_aware_sign, ste_tern, ste_heaviside, dorefa) are not ported yet
(see ROADMAP.md).
"""

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
    raise ValueError(
        f"Unknown quantizer {q!r}. Known in the PyTorch port: "
        f"{sorted(QUANTIZERS)} (the others are queued in ROADMAP.md)."
    )
