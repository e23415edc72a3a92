"""Serving metrics: latency percentiles, queue depth, padding cost.

The port of ``zookeeper_tpu/serving/metrics.py``'s ``ServingMetrics``
without the observability registry (``/metrics`` exposition waits, see
ROADMAP.md). The batcher records host-side floats only; recording never
synchronises the card.

- ``latency_p50/p95/p99_ms``: per-request submit-to-result wall time;
- ``queue_depth``: pending rows at submit time;
- ``bucket_fill``: real rows / bucket rows per dispatch;
- ``padding_waste``: padded rows / bucket rows per dispatch.
"""

import threading
from collections import deque
from typing import Dict, Mapping, Optional

import numpy as np

from zookeeper_tpu_torch.core import Field, component

#: Lifetime counters, in the order ``totals`` reports them.
_COUNTER_NAMES = (
    "requests",
    "rows",
    "dispatches",
    "rejected",
    "deadline_expired",
    "worker_restarts",
)


@component
class ServingMetrics:
    """Bounded-window aggregator for serving samples. Recorders are O(1)
    and thread-safe; ``snapshot()`` reduces the current window, counters
    are lifetime totals."""

    #: Samples retained per series; percentiles are over this window.
    window: int = Field(4096)

    def _state(self) -> dict:
        state = getattr(self, "_obs_state", None)
        if state is None:
            state = {
                "lock": threading.Lock(),
                "counters": dict.fromkeys(_COUNTER_NAMES, 0),
                "windows": {},
            }
            object.__setattr__(self, "_obs_state", state)
        return state

    def _count(self, name: str, n: int = 1) -> None:
        state = self._state()
        with state["lock"]:
            state["counters"][name] += int(n)

    def _observe(self, name: str, value: float) -> None:
        state = self._state()
        with state["lock"]:
            series = state["windows"].setdefault(
                name, deque(maxlen=max(1, int(self.window)))
            )
            series.append(float(value))

    def record_request(self, latency_ms: float, rows: int) -> None:
        self._observe("latency_ms", latency_ms)
        self._count("requests")
        self._count("rows", rows)

    def record_queue_depth(self, rows: int) -> None:
        self._observe("queue_depth", rows)

    def record_rejected(self) -> None:
        """A submit was shed (``RejectedError``) instead of enqueued."""
        self._count("rejected")

    def record_deadline_expired(self) -> None:
        self._count("deadline_expired")

    def record_worker_restart(self) -> None:
        self._count("worker_restarts")

    def record_dispatch(self, real_rows: int, bucket_rows: int) -> None:
        if bucket_rows <= 0:
            return
        self._observe("bucket_fill", real_rows / bucket_rows)
        self._observe("padding_waste", (bucket_rows - real_rows) / bucket_rows)
        self._count("dispatches")

    @property
    def totals(self) -> Dict[str, int]:
        state = self._state()
        with state["lock"]:
            return dict(state["counters"])

    def snapshot(self) -> Dict[str, float]:
        """The current window as a flat ``{name: float}`` mapping (absent
        series are omitted)."""
        state = self._state()
        with state["lock"]:
            windows = {k: list(v) for k, v in state["windows"].items()}
            out: Dict[str, float] = {
                k: float(v) for k, v in state["counters"].items()
            }
        lat = windows.get("latency_ms")
        if lat:
            arr = np.asarray(lat)
            out["latency_p50_ms"] = float(np.percentile(arr, 50))
            out["latency_p95_ms"] = float(np.percentile(arr, 95))
            out["latency_p99_ms"] = float(np.percentile(arr, 99))
            out["latency_mean_ms"] = float(arr.mean())
        for name in ("queue_depth", "bucket_fill", "padding_waste"):
            if windows.get(name):
                out[f"{name}_mean"] = float(np.mean(windows[name]))
        return out

    def emit(self, writer, step: int = 0,
             extra: Optional[Mapping[str, float]] = None) -> Dict[str, float]:
        """Write the snapshot (and ``extra``) through a training-family
        ``MetricsWriter`` under the ``serve/`` prefix; returns the
        snapshot."""
        snap = self.snapshot()
        scalars = {f"serve/{k}": float(v) for k, v in snap.items()}
        if extra:
            scalars.update({f"serve/{k}": float(v) for k, v in extra.items()})
        writer.write_scalars(int(step), scalars)
        return snap
