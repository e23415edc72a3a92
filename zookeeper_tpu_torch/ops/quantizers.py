"""Sign quantizers for the packed inference path.

The forward halves of the JAX package's straight-through quantizers that
QuickNet uses. The packed path is inference-only, so no surrogate
gradient is defined; the other quantizers of the JAX registry are not
ported yet (see ROADMAP.md).
"""

from typing import Callable, Dict, Optional, Union

import torch


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Sign with sign(±0) = +1 and sign(NaN) = -1, in ``x``'s dtype.

    Binary networks need two-valued outputs, so zero maps to +1; NaN
    fails the ``x >= 0`` compare and maps to -1, as in the JAX package."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


QUANTIZERS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "ste_sign": ste_sign,
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
