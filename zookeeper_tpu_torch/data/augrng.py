"""Counter-based augmentation RNG.

The port's own copy of ``zookeeper_tpu/data/augrng.py``. Augmentation
draws from a splitmix64 stream keyed by ``(seed, example_index, epoch)``,
so a batch is the same whatever thread assembles it and whichever epoch
the run resumes at. Every derived draw uses only exactly-rounded IEEE
double operations (and :func:`recipe_exp` a fixed-order polynomial in
place of a libm ``exp``), so the stream, and the pixels cut with it, are
the same bits as the JAX package's for the same key.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB

#: Exactly 2**-53 (a power of two, so the product below rounds once).
_U53_INV = 1.0 / 9007199254740992.0


def _mix(z: int) -> int:
    """splitmix64 finalizer (64-bit wrapping arithmetic)."""
    z &= _MASK
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK
    return (z ^ (z >> 31)) & _MASK


class AugRng:
    """Deterministic per-example augmentation stream for ``(seed, index,
    epoch)``."""

    def __init__(self, seed: int, index: int, epoch: int):
        s = _mix((int(seed) + _GOLDEN) & _MASK)
        s = _mix(((s ^ (int(index) & _MASK)) + _GOLDEN) & _MASK)
        s = _mix(((s ^ (int(epoch) & _MASK)) + _GOLDEN) & _MASK)
        self._state = s

    def next_u64(self) -> int:
        self._state = (self._state + _GOLDEN) & _MASK
        return _mix(self._state)

    def uniform(self, lo: float, hi: float) -> float:
        """Double in [lo, hi): 53 mantissa bits, one rounding for the
        scale and one for the affine."""
        d = (self.next_u64() >> 11) * _U53_INV
        return lo + (hi - lo) * d

    def randint(self, n: int) -> int:
        """Integer in [0, n) (plain modulo; the bias is ~n/2**64)."""
        return int(self.next_u64() % n)


def recipe_exp(u: float) -> float:
    """exp(u) as a fixed-order 21-term Horner polynomial: the same bits on
    every platform, ~1 ulp for |u| <= 2 (the log-aspect range of
    RandomResizedCrop)."""
    acc = 1.0
    for k in range(21, 0, -1):
        acc = 1.0 + acc * (u / k)
    return acc
