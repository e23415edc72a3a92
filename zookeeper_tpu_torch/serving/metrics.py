"""Serving metrics: latency percentiles, queue depth, padding cost.

The port of ``zookeeper_tpu/serving/metrics.py``'s ``ServingMetrics``,
built on the typed registry (``observability.registry``): every
lifetime total is a ``Counter`` (or a ``Gauge`` for
``serving_weights_step``), every sampled series feeds a bounded window
(exact ``np.percentile`` snapshots) plus a fixed-bucket ``Histogram``,
and the whole instrument set renders live at ``/metrics`` as
``zk_serving_*`` (``ServingConfig.metrics_port``). ``totals``,
``snapshot()`` and ``emit()`` report the same keys and values as
before. The batcher records host-side floats only: recording never
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
from zookeeper_tpu_torch.observability.registry import (
    DEFAULT_MS_BUCKETS,
    DEFAULT_RATIO_BUCKETS,
    MetricsRegistry,
)

#: Exposition name prefix: every instrument renders as ``zk_serving_<name>``.
_PREFIX = "zk_serving_"

#: Guards first-touch creation of an instance's instrument set: two
#: threads racing the first record_* must share ONE registry.
_INIT_LOCK = threading.Lock()


# -- the windowed-registry machinery DecodeMetrics shares ------------------


def _get_or_build_obs(metrics, build) -> dict:
    """Double-checked lazy init of a metrics component's ``_obs_state``
    (one registry per instance even under racing first recorders)."""
    obs = getattr(metrics, "_obs_state", None)
    if obs is None:
        with _INIT_LOCK:
            obs = getattr(metrics, "_obs_state", None)
            if obs is not None:
                return obs
            obs = build()
            object.__setattr__(metrics, "_obs_state", obs)
    return obs


def _window_series(metrics, obs: dict, name: str) -> deque:
    series = obs["windows"].get(name)
    if series is None:
        # setdefault: two threads racing a series' first sample share
        # ONE deque. The ``window`` field is read here only: a field read
        # costs microseconds, and the decode loop records every token.
        series = obs["windows"].setdefault(name, deque(maxlen=max(1, int(metrics.window))))
    return series


def _observe_sample(metrics, obs: dict, name: str, value: float) -> None:
    """One sample: window append (exact percentile source) + fixed-bucket
    histogram observe (live scrape source)."""
    _window_series(metrics, obs, name).append(float(value))
    hist = obs["hist"].get(name)
    if hist is not None:
        hist.observe(value)


def _reset_obs(metrics) -> None:
    """Zero every instrument IN PLACE: a server that captured
    ``registry`` at start-up keeps rendering this aggregator (a scraper
    sees an ordinary counter reset)."""
    obs = getattr(metrics, "_obs_state", None)
    if obs is None:
        return
    for inst in (*obs["counters"].values(), *obs["gauges"].values(), *obs["hist"].values()):
        inst.reset()
    obs["windows"].clear()


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

    def _obs(self) -> dict:
        return _get_or_build_obs(self, self._build_obs)

    def _build_obs(self) -> dict:
        registry = MetricsRegistry()
        return {
            "registry": registry,
            "counters": {
                name: registry.counter(_PREFIX + name, help=f"lifetime {name} total")
                for name in _COUNTER_NAMES
            },
            "gauges": {
                "weights_step": registry.gauge(
                    _PREFIX + "serving_weights_step",
                    help="training step whose weights are live (-1 = bind-time weights)",
                    initial=-1,
                ),
                "queue_depth": registry.gauge(
                    _PREFIX + "queue_depth", help="pending rows at the last submit"),
            },
            "hist": {
                "latency_ms": registry.histogram(
                    _PREFIX + "latency_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="per-request submit-to-result wall time"),
                "bucket_fill": registry.histogram(
                    _PREFIX + "bucket_fill", buckets=DEFAULT_RATIO_BUCKETS,
                    help="real rows / bucket rows per dispatch"),
                "padding_waste": registry.histogram(
                    _PREFIX + "padding_waste", buckets=DEFAULT_RATIO_BUCKETS,
                    help="padded rows / bucket rows per dispatch"),
                "weight_swap_ms": registry.histogram(
                    _PREFIX + "weight_swap_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="checkpoint hot-swap load + placement time"),
            },
            "windows": {},
        }

    @property
    def registry(self) -> MetricsRegistry:
        """The instrument registry behind this aggregator: attach it to an
        ``ObservabilityServer`` to scrape every series live."""
        return self._obs()["registry"]

    def _observe(self, name: str, value: float) -> None:
        _observe_sample(self, self._obs(), name, value)

    def record_request(self, latency_ms: float, rows: int) -> None:
        obs = self._obs()
        self._observe("latency_ms", latency_ms)
        obs["counters"]["requests"].inc()
        obs["counters"]["rows"].inc(int(rows))

    def record_queue_depth(self, rows: int) -> None:
        obs = self._obs()
        _window_series(self, obs, "queue_depth").append(float(rows))
        obs["gauges"]["queue_depth"].set(rows)

    def record_rejected(self) -> None:
        """A submit was shed (``RejectedError``) instead of enqueued."""
        self._obs()["counters"]["rejected"].inc()

    def record_deadline_expired(self) -> None:
        self._obs()["counters"]["deadline_expired"].inc()

    def record_worker_restart(self) -> None:
        self._obs()["counters"]["worker_restarts"].inc()

    def record_weight_swap(self, swap_ms: float, step: int) -> None:
        """A checkpoint hot swap landed: ``step``'s weights are live;
        ``swap_ms`` is the load + placement wall time."""
        obs = self._obs()
        self._observe("weight_swap_ms", swap_ms)
        obs["counters"]["weight_swaps"].inc()
        obs["gauges"]["weights_step"].set(int(step))

    def record_watcher_stopped(self) -> None:
        """The checkpoint watcher died on a fatal error:
        ``serving_weights_step`` is frozen from here on."""
        self._obs()["counters"]["watcher_stopped"].inc()

    def record_weights_step(self, step: int) -> None:
        """Set the live-weights step without counting a swap (the
        weights a service loaded at start-up)."""
        self._obs()["gauges"]["weights_step"].set(int(step))

    @property
    def weights_step(self) -> int:
        """The live training step (-1: the bind-time weights)."""
        return int(self._obs()["gauges"]["weights_step"].value)

    def record_dispatch(self, real_rows: int, bucket_rows: int) -> None:
        if bucket_rows <= 0:
            return
        self._observe("bucket_fill", real_rows / bucket_rows)
        self._observe("padding_waste", (bucket_rows - real_rows) / bucket_rows)
        self._obs()["counters"]["dispatches"].inc()

    @property
    def totals(self) -> Dict[str, int]:
        obs = self._obs()
        out: Dict[str, int] = {}
        for name in _COUNTER_NAMES:
            out[name] = int(obs["counters"][name].value)
            if name == "weight_swaps":
                # JAX's key order: the live step follows the swap count.
                out["serving_weights_step"] = int(obs["gauges"]["weights_step"].value)
        return out

    def snapshot(self) -> Dict[str, float]:
        """The current window as a flat ``{name: float}`` mapping (absent
        series are omitted)."""
        windows = self._obs()["windows"]
        out: Dict[str, float] = {k: float(v) for k, v in self.totals.items()}
        lat = windows.get("latency_ms")
        if lat:
            arr = np.asarray(lat)
            out["latency_p50_ms"] = float(np.percentile(arr, 50))
            out["latency_p95_ms"] = float(np.percentile(arr, 95))
            out["latency_p99_ms"] = float(np.percentile(arr, 99))
            out["latency_mean_ms"] = float(arr.mean())
        for name in ("queue_depth", "bucket_fill", "padding_waste", "weight_swap_ms"):
            series = windows.get(name)
            if series:
                out[f"{name}_mean"] = float(np.mean(series))
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

    def reset(self) -> None:
        """Zero every series IN PLACE (see :func:`_reset_obs`)."""
        _reset_obs(self)
