"""Step-time anomaly watchdog: EWMA baseline + MAD spread over a
rolling window.

The serving dispatcher (and, once wired, the training loop) produces a
steady stream of durations (seconds per coalesced dispatch, per step).
A straggler dispatch (a noisy neighbor on the host, a background
compaction, a throttled card) or a post-warm-up first shape silently
eats throughput — visible only as a slightly worse rate hours later.
The watchdog makes those self-announcing:

- **Baseline**: an exponentially-weighted moving average (EWMA,
  ``alpha`` default 0.2 — the baseline absorbs a genuine level shift
  in ~1/alpha observations).
- **Spread**: 1.4826 x the median absolute deviation (MAD) of the
  rolling window — the robust sigma estimate, immune to the very
  outliers being hunted (a stddev would inflate itself on each
  anomaly and go blind). Recomputed every ``recompute_every``
  observations, not every sample: ``observe`` is on the dispatch path,
  so it stays a deque append and a few float ops.
- **Trigger**: after ``warmup`` observations, a duration is anomalous
  when it exceeds ``ewma + threshold * mad_sigma`` AND
  ``min_ratio * ewma`` — the ratio guard is the false-positive floor
  for near-perfectly-steady cadences, where MAD collapses toward 0
  and any microsecond of jitter would otherwise fire.

On trigger: a ``step_time_anomaly`` trace event (step attribution +
observed/baseline ms) and a ``zk_step_time_anomalies_total{stream=}``
counter bump. Anomalous samples still update the EWMA and the window —
a persistent regression fires for a bounded burst (~1/alpha
observations) while it is news, then becomes the new baseline instead
of alerting forever.

Anomalies are also a FLIGHT-RECORDER trigger source: every trigger
notifies the process-global recorder (one global read when none is
installed) so the evidence — trace ring, metrics,
RequestLog — is bundled while the straggler's spans still exist; the
``on_anomaly`` callback seam lets a caller subscribe its own handler
on top (called OUTSIDE the watchdog lock; its failures are logged,
never raised into the step path).
"""

import logging
import threading
from collections import deque
from typing import Callable, Optional

from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
)

logger = logging.getLogger(__name__)

__all__ = ["StepTimeWatchdog"]

#: MAD -> sigma for normally-distributed noise.
_MAD_SIGMA = 1.4826


class StepTimeWatchdog:
    """Anomaly detector over one duration stream.

    ``observe(seconds, step=)`` returns True when the sample is
    anomalous. Thread-safe (the serving dispatcher's worker thread and
    a test's assertions may race); the lock covers a deque append and
    a few float ops, with the MAD re-sort amortized over
    ``recompute_every`` samples.
    """

    def __init__(
        self,
        stream: str,
        *,
        window: int = 64,
        warmup: int = 5,
        alpha: float = 0.2,
        threshold: float = 6.0,
        min_ratio: float = 1.5,
        min_excess_s: float = 0.0,
        recompute_every: int = 8,
        registry: Optional[MetricsRegistry] = None,
        on_anomaly: Optional[
            Callable[[str, float, Optional[int]], None]
        ] = None,
    ) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha} must be in (0, 1].")
        if window < 4:
            raise ValueError(f"window={window} must be >= 4.")
        if warmup < 1:
            raise ValueError(f"warmup={warmup} must be >= 1.")
        if min_ratio < 1.0:
            raise ValueError(
                f"min_ratio={min_ratio} must be >= 1 (an 'anomaly' "
                "faster than baseline is just a good step)."
            )
        self.stream = str(stream)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.min_ratio = float(min_ratio)
        #: Absolute excess-over-baseline floor: sub-floor spikes are
        #: never anomalies, however many MADs they span. The guard for
        #: microsecond-cadence streams (a CPU test loop, an idle
        #: dispatcher) where baseline AND spread are so tiny that
        #: host-scheduler jitter satisfies every relative test.
        self.min_excess_s = float(min_excess_s)
        #: Subscriber seam: ``on_anomaly(stream, seconds, step)`` fires
        #: per flagged sample, after the counter/event, outside the
        #: lock. The flight recorder is notified regardless (module
        #: global; no-op when none installed).
        self.on_anomaly = on_anomaly
        self._recompute_every = max(1, int(recompute_every))
        self._window: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self._ewma: Optional[float] = None
        self._mad_sigma = 0.0
        self._seen = 0
        self._since_recompute = 0
        self._anomalies = 0
        reg = registry if registry is not None else default_registry()
        self._counter = reg.counter(
            "zk_step_time_anomalies_total",
            help="straggler steps/dispatches flagged by the watchdog",
            labels={"stream": self.stream},
        )
        self._gauge = reg.gauge(
            "zk_step_time_ewma_ms",
            help="EWMA step/dispatch duration the watchdog baselines on",
            labels={"stream": self.stream},
        )

    @property
    def ewma_seconds(self) -> Optional[float]:
        return self._ewma

    @property
    def anomalies(self) -> int:
        return self._anomalies

    def _recompute_mad(self) -> None:
        # Median + MAD over the window; sorted() over <= window floats,
        # amortized to every Nth observe.
        vals = sorted(self._window)
        n = len(vals)
        if n < 4:
            self._mad_sigma = 0.0
            return
        med = (
            vals[n // 2]
            if n % 2
            else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
        )
        devs = sorted(abs(v - med) for v in vals)
        mad = (
            devs[n // 2]
            if n % 2
            else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
        )
        self._mad_sigma = _MAD_SIGMA * mad

    def observe(self, seconds: float, step: Optional[int] = None) -> bool:
        """Feed one duration; returns whether it was flagged."""
        seconds = float(seconds)
        if seconds < 0:
            return False
        with self._lock:
            self._seen += 1
            ewma = self._ewma
            anomalous = (
                self._seen > self.warmup
                and ewma is not None
                and seconds > ewma * self.min_ratio
                and seconds > ewma + self.threshold * self._mad_sigma
                and seconds - ewma >= self.min_excess_s
            )
            # The anomalous sample still feeds baseline + window (the
            # bounded-burst policy in the module docstring).
            self._ewma = (
                seconds
                if ewma is None
                else ewma + self.alpha * (seconds - ewma)
            )
            self._window.append(seconds)
            self._since_recompute += 1
            if self._since_recompute >= self._recompute_every:
                self._since_recompute = 0
                self._recompute_mad()
            if anomalous:
                self._anomalies += 1
            baseline = self._ewma
        self._gauge.set(baseline * 1e3)
        if anomalous:
            self._counter.inc()
            _trace.event(
                "step_time_anomaly",
                step=step,
                attrs={
                    "stream": self.stream,
                    "observed_ms": round(seconds * 1e3, 3),
                    "baseline_ms": round((ewma or 0.0) * 1e3, 3),
                },
            )
            # Flight-recorder trigger + the caller's seam, both outside
            # the lock and both failure-isolated from the step path.
            _recorder.notify(
                "step_time_anomaly",
                step=step,
                attrs={
                    "stream": self.stream,
                    "observed_ms": round(seconds * 1e3, 3),
                    "baseline_ms": round((ewma or 0.0) * 1e3, 3),
                },
            )
            callback = self.on_anomaly
            if callback is not None:
                try:
                    callback(self.stream, seconds, step)
                except Exception:
                    logger.warning(
                        "watchdog on_anomaly callback failed",
                        exc_info=True,
                    )
        return anomalous
