"""Serving metrics: latency percentiles, queue depth, padding cost.

The port of ``zookeeper_tpu/serving/metrics.py``'s ``ServingMetrics``
without the observability registry (``/metrics`` exposition waits, see
ROADMAP.md). The batcher records host-side floats only; recording never
synchronises the card.

- ``latency_p50/p95/p99_ms``: per-request submit-to-result wall time;
- ``queue_depth``: pending rows at submit time;
- ``bucket_fill``: real rows / bucket rows per dispatch;
- ``padding_waste``: padded rows / bucket rows per dispatch;
- ``weight_swaps`` and ``weight_swap_ms``: checkpoint hot swaps and
  their load + placement wall time; ``serving_weights_step`` the
  training step whose weights are live (-1: the bind-time weights);
  ``watcher_stopped`` counts a checkpoint watcher that died on a fatal
  error (its step is frozen from then on).
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
    "weight_swaps",
    "watcher_stopped",
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
                "weights_step": -1,
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

    def record_weight_swap(self, swap_ms: float, step: int) -> None:
        """A checkpoint hot swap landed: ``step``'s weights are live;
        ``swap_ms`` is the load + placement wall time."""
        self._observe("weight_swap_ms", swap_ms)
        state = self._state()
        with state["lock"]:
            state["counters"]["weight_swaps"] += 1
            state["weights_step"] = int(step)

    def record_watcher_stopped(self) -> None:
        """The checkpoint watcher died on a fatal error:
        ``serving_weights_step`` is frozen from here on."""
        self._count("watcher_stopped")

    def record_weights_step(self, step: int) -> None:
        """Set the live-weights step without counting a swap (the
        weights a service loaded at start-up)."""
        state = self._state()
        with state["lock"]:
            state["weights_step"] = int(step)

    @property
    def weights_step(self) -> int:
        """The live training step (-1: the bind-time weights)."""
        state = self._state()
        with state["lock"]:
            return int(state["weights_step"])

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
            out: Dict[str, int] = {}
            for name in _COUNTER_NAMES:
                out[name] = int(state["counters"][name])
                if name == "weight_swaps":
                    # JAX's key order: the live step follows the swap count.
                    out["serving_weights_step"] = int(state["weights_step"])
            return out

    def snapshot(self) -> Dict[str, float]:
        """The current window as a flat ``{name: float}`` mapping (absent
        series are omitted)."""
        state = self._state()
        with state["lock"]:
            windows = {k: list(v) for k, v in state["windows"].items()}
        out: Dict[str, float] = {k: float(v) for k, v in self.totals.items()}
        lat = windows.get("latency_ms")
        if lat:
            arr = np.asarray(lat)
            out["latency_p50_ms"] = float(np.percentile(arr, 50))
            out["latency_p95_ms"] = float(np.percentile(arr, 95))
            out["latency_p99_ms"] = float(np.percentile(arr, 99))
            out["latency_mean_ms"] = float(arr.mean())
        for name in ("queue_depth", "bucket_fill", "padding_waste", "weight_swap_ms"):
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
