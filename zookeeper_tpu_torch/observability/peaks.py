"""Hardware peak anchors: the ONE table the live MFU/MBU gauges and the
profiler's roofline divide by.

MFU is only meaningful relative to a stated roofline, and the roofline
itself is the easiest number to get wrong: an above-physics "measured"
peak, a wrong int8 factor, a table row of another part. So the tables,
the data-sheet clamp and the agreement-gated aggregation of measured
attempts live here once; ``training.profiling`` (its ``PEAKS``) and the
serving engines' gauges (``zk_serve_mfu``, ``zk_serve_mfu_int8``,
``zk_decode_mbu``) read them.

The tables hold NVIDIA rows only, keyed by substrings of the device
name ``torch.cuda.get_device_name()`` gives, matched longest first (so
"H100 PCIe" wins over a bare "H100"). Each rate is the data sheet's
dense rate (no sparsity) at the part's full power limit:

- "H100" (SXM, "NVIDIA H100 80GB HBM3"): bf16 989.4 TFLOP/s, int8
  1978.9 TOP/s, HBM3 3.35 TB/s;
- "H100 PCIe": bf16 756.5 TFLOP/s, int8 1513 TOP/s, HBM2e 2.0 TB/s.

Resolution for a live process (:func:`reference_peak_flops`,
:func:`reference_int8_peak_flops`, :func:`reference_hbm_bandwidth`) is
table-driven and never touches the card: an environment override
(``ZK_BENCH_PEAK_FLOPS``, ``ZK_BENCH_INT8_PEAK_FLOPS``,
``ZK_BENCH_HBM_BANDWIDTH``) > the matched data-sheet row > the H100 SXM
row (the part this port is measured on). No measured fraction of the
data sheet is applied: none has been recorded for these parts, and a
guessed one would be a fabricated anchor. Every resolver is total: it
returns ``(value, source_tag)`` and never raises, with no card too.
"""

import logging
import math
import os
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "BF16_PEAK_FALLBACK",
    "DATASHEET_HEADROOM",
    "HBM_BANDWIDTH_FALLBACK",
    "INT8_PEAK_FALLBACK",
    "NVIDIA_DATASHEET_BF16_FLOPS",
    "NVIDIA_DATASHEET_HBM_BYTES",
    "NVIDIA_DATASHEET_INT8_OPS",
    "aggregate_peak_attempts",
    "check_peak_against_datasheet",
    "datasheet_bf16_peak",
    "datasheet_hbm_bandwidth",
    "datasheet_int8_peak",
    "datasheet_match",
    "reference_hbm_bandwidth",
    "reference_int8_peak_flops",
    "reference_peak_flops",
    "resolve_device_kind",
]

#: Dense bf16 tensor-core FLOP/s by device-name substring (data sheet).
NVIDIA_DATASHEET_BF16_FLOPS = {
    "H100": 989.4e12,
    "H100 PCIe": 756.5e12,
}

#: Dense int8 tensor-core op/s by device-name substring (data sheet).
NVIDIA_DATASHEET_INT8_OPS = {
    "H100": 1978.9e12,
    "H100 PCIe": 1513e12,
}

#: HBM bytes/s by device-name substring (data sheet).
NVIDIA_DATASHEET_HBM_BYTES = {
    "H100": 3.35e12,
    "H100 PCIe": 2.0e12,
}

#: Fallbacks for an unrecognized device name: the H100 SXM rows.
BF16_PEAK_FALLBACK = NVIDIA_DATASHEET_BF16_FLOPS["H100"]
INT8_PEAK_FALLBACK = NVIDIA_DATASHEET_INT8_OPS["H100"]
HBM_BANDWIDTH_FALLBACK = NVIDIA_DATASHEET_HBM_BYTES["H100"]

#: Headroom above the data-sheet number before a measured peak is
#: rejected: covers clock and rounding slop in the data sheet itself,
#: not a broken measurement (which lands far outside this band).
DATASHEET_HEADROOM = 1.05


def _env_peak(env, name: str) -> Optional[float]:
    """A positive-float env override, or None — a malformed value is
    warn-and-ignored, never raised: these resolve inside gauge updates
    on the serving hot paths, whose totality contract a typo'd export
    must not be able to break."""
    raw = env.get(name)
    if not raw:
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        logger.warning("%s=%r is not a number — ignoring the override", name, raw)
        return None
    if not math.isfinite(value) or value <= 0:
        logger.warning("%s=%r is not a finite positive peak — ignoring the override",
                       name, raw)
        return None
    return value


def _match_datasheet_table(device_kind, table) -> Optional[Tuple[str, float]]:
    """Longest-substring table match shared by every data-sheet lookup
    (one matching rule for every table). Case-insensitive. Returns
    ``(table_key, raw_table_value)`` or None."""
    kind = (device_kind or "").lower()
    best = None
    for key, value in table.items():
        if key.lower() in kind and (best is None or len(key) > len(best[0])):
            best = (key, value)
    return best


def resolve_device_kind(device_kind: Optional[str] = None) -> Optional[str]:
    """``device_kind``, or the first card's name; None without a card.
    Never raises, never touches the card beyond reading its name."""
    if device_kind is not None:
        return device_kind
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:  # a gauge update must not raise
        return None
    return None


def datasheet_match(device_kind) -> Optional[Tuple[str, float]]:
    """``(table_key, bf16 FLOP/s)`` of the longest table key in
    ``device_kind``, or None when the part is unrecognized."""
    return _match_datasheet_table(device_kind, NVIDIA_DATASHEET_BF16_FLOPS)


def datasheet_bf16_peak(device_kind) -> Optional[float]:
    """Data-sheet dense bf16 FLOP/s, or None for an unrecognized part
    (a future card must not be clamped to a stale table)."""
    match = datasheet_match(device_kind)
    return None if match is None else match[1]


def datasheet_int8_peak(device_kind) -> Optional[float]:
    """Data-sheet dense int8 op/s, or None for an unrecognized part."""
    best = _match_datasheet_table(device_kind, NVIDIA_DATASHEET_INT8_OPS)
    return None if best is None else best[1]


def datasheet_hbm_bandwidth(device_kind) -> Optional[float]:
    """Data-sheet HBM bytes/s, or None for an unrecognized part."""
    best = _match_datasheet_table(device_kind, NVIDIA_DATASHEET_HBM_BYTES)
    return None if best is None else best[1]


def check_peak_against_datasheet(peak, device_kind) -> None:
    """Raise when a measured peak exceeds the data-sheet band for this
    part: an above-physics reading is a measurement failure, and
    recording it as "measured" corrupts every MFU computed against it.
    Unknown parts pass: a stale table must not reject a future card."""
    sheet = datasheet_bf16_peak(device_kind)
    if sheet is not None and peak > DATASHEET_HEADROOM * sheet:
        raise ValueError(
            f"measured peak {peak / 1e12:.1f} TF/s exceeds the "
            f"{device_kind!r} data sheet {sheet / 1e12:.0f} TF/s by more "
            f"than {DATASHEET_HEADROOM:.2f}x — measurement failure, not hardware"
        )


def aggregate_peak_attempts(attempts, rel_tol=0.05):
    """Agreement-gated aggregation of independent peak attempts: the
    estimate is the median of the largest cluster of attempts that agree
    within ``rel_tol`` (max/min <= 1+rel_tol over the cluster), requiring
    at least two members. Raises when no two attempts agree.

    Max-over-attempts would amplify any fast-side measurement failure.
    When two DISJOINT clusters tie for largest (a bimodal session),
    neither is trustworthy and the function refuses rather than guess:
    anchoring on the slow cluster would inflate MFU, on the fast one it
    risks a broken measurement.
    """
    vals = sorted(a for a in attempts if a > 0)
    if len(vals) < 2:
        raise ValueError(
            f"need >=2 positive attempts to agree, got {len(vals)} "
            f"from {list(attempts)}"
        )
    best = None
    ambiguous = False  # a DISJOINT equal-size cluster exists
    for i in range(len(vals)):
        j = i
        while j + 1 < len(vals) and vals[j + 1] <= vals[i] * (1 + rel_tol):
            j += 1
        size = j - i + 1
        if size >= 2:
            if best is None or size > best[0]:
                best, ambiguous = (size, i, j), False
            elif size == best[0] and i > best[2]:
                # Only windows sharing NO attempts with the best are a
                # second mode; an equal-size window overlapping it is
                # the same cluster shifted and must not veto it.
                ambiguous = True
    if best is None:
        raise ValueError(
            "no two peak attempts agree within "
            f"{rel_tol:.0%}: {[round(v / 1e12, 1) for v in vals]} TF/s — "
            "session too noisy to anchor MFU"
        )
    if ambiguous:
        raise ValueError(
            "ambiguous peak attempts (two disjoint equal-size clusters): "
            f"{[round(v / 1e12, 1) for v in vals]} TF/s — bimodal "
            "session, refusing to pick a cluster"
        )
    _, i, j = best
    cluster = vals[i : j + 1]
    mid = len(cluster) // 2
    if len(cluster) % 2:
        return cluster[mid]
    return 0.5 * (cluster[mid - 1] + cluster[mid])


def _reference(env_name, table, fallback, kind, env) -> Tuple[float, str]:
    env = os.environ if env is None else env
    override = _env_peak(env, env_name)
    if override is not None:
        return override, "env"
    match = _match_datasheet_table(resolve_device_kind(kind), table)
    if match is not None:
        return match[1], "datasheet"
    return fallback, "fallback_h100"


def reference_peak_flops(device_kind: Optional[str] = None, env=None) -> Tuple[float, str]:
    """The bf16 FLOP/s anchor of the live MFU gauges, resolved WITHOUT
    touching the card: ``ZK_BENCH_PEAK_FLOPS`` > the data-sheet row of
    ``device_kind`` (default: the first card's name) > the H100 SXM row.
    Returns ``(flops_per_sec, source_tag)``; never raises."""
    return _reference("ZK_BENCH_PEAK_FLOPS", NVIDIA_DATASHEET_BF16_FLOPS,
                      BF16_PEAK_FALLBACK, device_kind, env)


def reference_int8_peak_flops(device_kind: Optional[str] = None,
                              env=None) -> Tuple[float, str]:
    """The int8 op/s anchor of ``zk_serve_mfu_int8`` (packed
    deployments), same resolution as :func:`reference_peak_flops`
    (``ZK_BENCH_INT8_PEAK_FLOPS`` overrides)."""
    return _reference("ZK_BENCH_INT8_PEAK_FLOPS", NVIDIA_DATASHEET_INT8_OPS,
                      INT8_PEAK_FALLBACK, device_kind, env)


def reference_hbm_bandwidth(device_kind: Optional[str] = None,
                            env=None) -> Tuple[float, str]:
    """The HBM bytes/s anchor of ``zk_decode_mbu``, same resolution
    (``ZK_BENCH_HBM_BANDWIDTH`` overrides)."""
    return _reference("ZK_BENCH_HBM_BANDWIDTH", NVIDIA_DATASHEET_HBM_BYTES,
                      HBM_BANDWIDTH_FALLBACK, device_kind, env)
