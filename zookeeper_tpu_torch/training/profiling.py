"""Trace analysis: where a step's device time goes, from a profiler trace.

The port of ``zookeeper_tpu/training/profiling.py``. The JAX package
reads an xplane dump; the port reads the Chrome trace that
``torch.profiler`` writes (``TrainingExperiment.profile_dir``, or
``prof.export_chrome_trace(path)`` directly): the device events are the
trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events of one card.
A training loop wants one number per question ("where does the step time
go, and is it compute or bandwidth?") without a UI:

- **by category**: every port kernel by its CUDA function name (K1-K13,
  e.g. ``pack_rows_vec_kernel`` is K1), cuBLAS/cuDNN products,
  elementwise, reduction and copy kernels, the rest "other". CUDA kernels
  keep their function names in the trace, so the name is the category's
  evidence here (XLA's fused ``%fusion.N`` names, which the JAX reader
  must not trust, have no counterpart).
- **roofline**: an event's ideal compute time (``flops`` / peak) against
  its ideal memory time (``bytes`` / peak) classifies it compute- or
  bandwidth-bound. Flops come from the trace where it carries them (a
  ``with_flops`` profile attaches them to the operator that launched the
  kernels, split here over its kernels by duration; a ``flops`` or
  ``bytes`` argument on the kernel event itself wins); every event
  without either goes to ``unattributed_ms_per_step``, as the JAX reader
  does for ops without stats. Peaks are the card's data-sheet numbers
  (``PEAKS``, from ``observability.peaks``' tables, matched on the
  trace's ``deviceProperties`` name as the live gauges match the card's
  name) unless the caller passes its own.

``python -m zookeeper_tpu_torch.training.profiling TRACE [--steps N]
[--device cuda:0] [--top K] [--category SUBSTR] [--min-ms MS]`` prints
the breakdown of a trace file or of the newest trace under a directory.
"""

import glob
import json
import os
import re
import socket
import time
from collections import defaultdict
from typing import Dict, List, Optional

from zookeeper_tpu_torch.observability import peaks as _peak_tables

__all__ = [
    "PEAKS",
    "ProfileWindow",
    "device_op_stats",
    "format_breakdown",
    "kernel_category",
    "op_time_breakdown",
    "slab_annotation",
]

TRACE_SUFFIX = ".pt.trace.json"

#: (device-name substring, dense bf16 FLOP/s, HBM bytes/s) from the data
#: sheet (``observability.peaks``): the roofline's default peaks.
PEAKS = tuple((key, flops, _peak_tables.NVIDIA_DATASHEET_HBM_BYTES[key])
              for key, flops in _peak_tables.NVIDIA_DATASHEET_BF16_FLOPS.items())

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: (pattern on the CUDA function name, category), first match wins: the
#: port's kernels first, so none of them lands in a library bucket.
_CATEGORIES = tuple((re.compile(p), c) for p, c in (
    (r"pack_rows_(vec|scalar)_kernel", "K1 pack_rows"),
    (r"xnor_gemm(_small_m)?_kernel<(\d+, ?)?true>", "K2 xnor_matmul_packed_scaled"),
    (r"conv_gemm_s8_kernel", "K3 conv_gemm_popcount"),
    (r"packed_weight_matmul_small_m_kernel|tile_gemm_s8_kernel<false>",
     "K4 packed_weight_matmul"),
    (r"xnor_gemm(_small_m)?_kernel<(\d+, ?)?false>|tile_gemm_s8_kernel<true>",
     "K5 xnor_matmul_packed"),
    (r"unpack_resid_pm1_kernel", "K7 unpack_resid_pm1"),
    (r"pack_resid_kernel", "K6 pack_resid"),
    (r"mask_mul_resid_kernel", "K8 mask_mul_resid"),
    (r"flash_forward(_mma|_wide)?_kernel", "K9 flash_forward"),
    (r"flash_dq(_mma|_wide)?_kernel", "K10 flash_backward_dq"),
    (r"flash_dkv(_mma|_wide)?_kernel", "K11 flash_backward_dkv"),
    (r"decode_attention_(split|wide)_kernel<[^,<>]*, ?[^,<>]*, ?false",
     "K12 paged_decode_attention"),
    (r"decode_attention_(split|wide)_kernel<[^,<>]*, ?[^,<>]*, ?true",
     "K13 pool_paged_decode_attention"),
    (r"(?i)gemm|cutlass|cublas|xmma|cudnn|convolve|conv2d|winograd|wgrad|dgrad|fprop"
     r"|nchwToNhwc|nhwcToNchw", "cuBLAS/cuDNN"),
    (r"(?i)memcpy|CatArrayBatchedCopy|copy_kernel", "copy"),
    (r"(?i)memset", "memset"),
    (r"(?i)reduce|welford|batch_norm_collect|softmax|norm_kernel", "reduction"),
    (r"(?i)elementwise|foreach|index|scatter|gather|where", "elementwise"),
))


def slab_annotation(slab_index: int, num_steps: int = 1):
    """A ``torch.profiler.record_function`` span ``"slab i (k steps)"``
    around one call of the fused loop's multi-step
    (``training.step.build_multi_step``)::

        with slab_annotation(i, num_steps=k):
            state, metrics = multi_step(state, slab)

    In a trace the host thread shows one span a slab (on the card one
    graph launch) over the device's kernels of its ``k`` steps. Nearly
    free when no profiler records."""
    import torch

    return torch.profiler.record_function(f"slab {slab_index} ({num_steps} steps)")


def kernel_category(name: str, cat: str = "kernel") -> str:
    """The breakdown's category of a device event (its name, and its
    Chrome-trace ``cat``)."""
    if cat == "gpu_memcpy":
        return "copy"
    if cat == "gpu_memset":
        return "memset"
    for pattern, category in _CATEGORIES:
        if pattern.search(name):
            return category
    return "other"


def _find_trace_files(trace_dir: str) -> List[str]:
    """The ``*.pt.trace.json`` files under ``trace_dir``, oldest to newest
    by mtime (callers take the newest); a file path passes through."""
    if os.path.isfile(trace_dir):
        return [trace_dir]
    hits = sorted(
        glob.glob(os.path.join(trace_dir, "**", f"*{TRACE_SUFFIX}"), recursive=True),
        key=os.path.getmtime,
    )
    if not hits:
        raise FileNotFoundError(
            f"No {TRACE_SUFFIX} trace under {trace_dir!r}: was the profiler "
            "window closed (the profiled epoch finished)?"
        )
    return hits


def _peaks(trace: dict):
    for props in trace.get("deviceProperties") or ():
        name = str(props.get("name", ""))
        flops = _peak_tables.datasheet_bf16_peak(name)
        if flops is not None:
            return flops, _peak_tables.datasheet_hbm_bandwidth(name)
    return None, None


def device_op_stats(trace_dir: str, device_substring: str = "") -> dict:
    """Per-kernel aggregates of the newest trace, of ONE card.

    Returns ``{"ops": [{"name", "category", "seconds", "count", "flops",
    "bytes"}...], "peak_flops_per_sec", "peak_bytes_per_sec"}`` from the
    device events of the first card (``cuda:N``, by index) whose name
    contains ``device_substring``: one card's events are the per-card
    attribution, and summing cards would multiply every number by the
    card count.
    """
    path = _find_trace_files(trace_dir)[-1]
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if isinstance(e, dict) and e.get("ph") == "X"]
    by_device: Dict[int, list] = defaultdict(list)
    for e in events:
        if str(e.get("cat", "")).lower() in _DEVICE_CATS:
            args = e.get("args") or {}
            by_device[int(args.get("device", e.get("pid", 0)))].append(e)
    chosen = None
    for device in sorted(by_device):
        if device_substring in f"cuda:{device}":
            chosen = by_device[device]
            break
    if not chosen:
        raise ValueError(
            f"Trace {path!r} has no device kernel events"
            + (f" matching {device_substring!r}" if device_substring else "")
            + ": profile a run that launches work on the card."
        )
    # Flops of the launching operator (with_flops), by external id, split
    # over its kernels by duration.
    op_flops = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and args.get("flops") and "External id" in args:
            op_flops[args["External id"]] = float(args["flops"])
    op_kernel_us: Dict[int, float] = defaultdict(float)
    for e in chosen:
        ext = (e.get("args") or {}).get("External id")
        if ext in op_flops:
            op_kernel_us[ext] += float(e.get("dur", 0.0))
    per_op: Dict[str, dict] = {}
    for e in chosen:
        args = e.get("args") or {}
        dur_us = float(e.get("dur", 0.0))
        flops = args.get("flops")
        if flops is None:
            ext = args.get("External id")
            share = dur_us / op_kernel_us[ext] if op_kernel_us.get(ext) else 0.0
            flops = op_flops.get(ext, 0.0) * share
        row = per_op.get(e["name"])
        if row is None:
            row = per_op[e["name"]] = {
                "name": e["name"],
                "category": kernel_category(e["name"], str(e.get("cat", "")).lower()),
                "seconds": 0.0, "count": 0, "flops": 0.0, "bytes": 0.0,
            }
        row["seconds"] += dur_us / 1e6
        row["count"] += 1
        row["flops"] += float(flops)
        row["bytes"] += float(args.get("bytes") or 0.0)
    peak_flops, peak_bytes = _peaks(trace)
    return {
        "ops": list(per_op.values()),
        "peak_flops_per_sec": peak_flops,
        "peak_bytes_per_sec": peak_bytes,
    }


def op_time_breakdown(
    trace_dir: str,
    *,
    steps: int = 1,
    device_substring: str = "",
    top_k: int = 10,
    peak_flops_per_sec: Optional[float] = None,
    peak_bytes_per_sec: Optional[float] = None,
    top_category: str = "",
    top_min_ms: float = 0.0,
) -> dict:
    """Per-category ms a step, the roofline compute/bandwidth split and
    the top kernels, with the JAX reader's keys.

    ``steps``: how many steps the trace covers (totals are divided by
    it). Peak overrides default to ``PEAKS``. Kernels with neither flops
    nor bytes are ``unattributed_ms_per_step``. ``top_category`` /
    ``top_min_ms`` narrow the top list only (category substring, per-step
    floor), before ranking; totals and the roofline cover every kernel.
    """
    data = device_op_stats(trace_dir, device_substring)
    peak_f = peak_flops_per_sec or data["peak_flops_per_sec"]
    peak_b = peak_bytes_per_sec or data["peak_bytes_per_sec"]
    total = sum(op["seconds"] for op in data["ops"])
    steps = max(1, steps)

    by_cat: Dict[str, float] = defaultdict(float)
    roof = {"compute_bound": 0.0, "bandwidth_bound": 0.0, "unattributed": 0.0}
    ideal_c = ideal_m = 0.0
    for op in data["ops"]:
        by_cat[op["category"] or "(uncategorized)"] += op["seconds"]
        if not peak_f or not peak_b or (not op["flops"] and not op["bytes"]):
            roof["unattributed"] += op["seconds"]
            continue
        t_c = op["flops"] / peak_f
        t_m = op["bytes"] / peak_b
        ideal_c += t_c
        ideal_m += t_m
        roof["compute_bound" if t_c >= t_m else "bandwidth_bound"] += op["seconds"]
    candidates = [
        op for op in data["ops"]
        if top_category.lower() in (op["category"] or "").lower()
        and op["seconds"] / steps * 1e3 >= top_min_ms
    ]
    top = sorted(candidates, key=lambda op: -op["seconds"])[:top_k]
    per_step = lambda s: s / steps * 1e3  # noqa: E731
    return {
        "total_ms_per_step": per_step(total),
        "by_category": {
            c: {"ms_per_step": per_step(d), "share": d / total if total else 0.0}
            for c, d in sorted(by_cat.items(), key=lambda kv: -kv[1])
        },
        "roofline": {
            "compute_bound_ms_per_step": per_step(roof["compute_bound"]),
            "bandwidth_bound_ms_per_step": per_step(roof["bandwidth_bound"]),
            "unattributed_ms_per_step": per_step(roof["unattributed"]),
            "compute_bound_share": roof["compute_bound"] / total if total else 0.0,
            "bandwidth_bound_share": roof["bandwidth_bound"] / total if total else 0.0,
            "ideal_compute_ms_per_step": per_step(ideal_c),
            "ideal_memory_ms_per_step": per_step(ideal_m),
        },
        # (ms a step, category, name, achieved bytes/s, its share of the
        # bandwidth peak): None without bytes or a peak.
        "top_ops": [
            (
                per_step(op["seconds"]),
                op["category"],
                op["name"],
                op["bytes"] / op["seconds"] if op["seconds"] and op["bytes"] else None,
                (op["bytes"] / op["seconds"] / peak_b
                 if op["seconds"] and op["bytes"] and peak_b else None),
            )
            for op in top
        ],
    }


def format_breakdown(breakdown: dict, name_width: int = 70) -> str:
    """Human-readable rendering of :func:`op_time_breakdown`."""
    lines = [f"device op time: {breakdown['total_ms_per_step']:.2f} ms/step"]
    for category, row in breakdown["by_category"].items():
        if row["ms_per_step"] < 0.005:
            continue
        lines.append(
            f"  {category:28s} {row['ms_per_step']:8.2f} ms/step {row['share'] * 100:5.1f}%"
        )
    roof = breakdown["roofline"]
    line = (
        "roofline: "
        f"compute-bound ops {roof['compute_bound_ms_per_step']:.2f} ms "
        f"({roof['compute_bound_share'] * 100:.0f}%), "
        f"bandwidth-bound ops {roof['bandwidth_bound_ms_per_step']:.2f} ms "
        f"({roof['bandwidth_bound_share'] * 100:.0f}%)"
    )
    if roof["unattributed_ms_per_step"] > 0.005:
        # A trace without flops/bytes would otherwise read as "no time".
        line += (
            f", unattributed {roof['unattributed_ms_per_step']:.2f} ms "
            "(ops without flops/bytes stats or peaks)"
        )
    lines.append(line)
    if roof["ideal_compute_ms_per_step"] or roof["ideal_memory_ms_per_step"]:
        lines.append(
            "roofline lower bounds (sum over ops at device peaks): "
            f"compute {roof['ideal_compute_ms_per_step']:.2f} ms, "
            f"memory {roof['ideal_memory_ms_per_step']:.2f} ms"
        )
    lines.append("top ops (ms/step, achieved GB/s, % of HBM peak):")
    for ms, category, op_name, bps, frac in breakdown["top_ops"]:
        rate = (
            f"{bps / 1e9:6.0f} GB/s {frac * 100:4.0f}%"
            if bps is not None and frac is not None
            else " " * 17
        )
        lines.append(f"  {ms:8.3f} {rate} [{category}] {op_name[:name_width]}")
    return "\n".join(lines)


class ProfileWindow:
    """A ``torch.profiler`` capture (CPU and, on a card, CUDA activities,
    ``with_flops``) whose Chrome trace lands in ``directory`` as
    ``<host>.<pid>.<ms>.pt.trace.json``. ``stop()`` waits for the card,
    closes the capture and writes the trace; ``abort()`` closes an open
    capture without writing, so an exception mid-window never leaves a
    profiler capture running."""

    def __init__(self, directory: str, device):
        self.directory = directory
        self.device = device
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _on_card(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._on_card():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, with_flops=True)
        prof.start()
        self._prof = prof

    def stop(self) -> str:
        import torch

        prof, self._prof = self._prof, None
        if self._on_card():
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(
            self.directory,
            f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}{TRACE_SUFFIX}",
        )
        prof.export_chrome_trace(path)
        return path

    def abort(self) -> None:
        # Cleared first: a stop that raises is not retried.
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.stop()


def _main(argv: Optional[List[str]] = None) -> None:
    """``python -m zookeeper_tpu_torch.training.profiling TRACE [--steps N]
    [--device SUBSTR] [--top K] [--category SUBSTR] [--min-ms MS]``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Per-kernel device-time attribution of a torch.profiler "
        "Chrome trace (category shares + roofline split)."
    )
    parser.add_argument("trace_dir", help="profile_dir, or one .pt.trace.json file")
    parser.add_argument("--steps", type=int, default=1,
                        help="train steps the trace covers (divides totals)")
    parser.add_argument("--device", default="", help="card substring, e.g. cuda:0")
    parser.add_argument("--top", type=int, default=10)
    parser.add_argument("--category", default="",
                        help="only list top kernels whose category contains this "
                        "substring (e.g. 'copy'); the per-category totals always "
                        "cover everything")
    parser.add_argument("--min-ms", type=float, default=0.0,
                        help="drop top-kernel rows below this many ms/step")
    args = parser.parse_args(argv)
    print(format_breakdown(op_time_breakdown(
        args.trace_dir, steps=args.steps, device_substring=args.device, top_k=args.top,
        top_category=args.category, top_min_ms=args.min_ms,
    )))


if __name__ == "__main__":
    _main()
