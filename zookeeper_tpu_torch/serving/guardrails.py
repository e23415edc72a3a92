"""Runtime overload defenses: predicted-miss admission, the brown-out
and the per-replica circuit breaker.

The port of ``zookeeper_tpu/serving/guardrails.py``; host-side Python
only, its decisions the same as the JAX package's on the same
observations and clock.

- :class:`OverloadGuard`: two EWMA estimators (the queue wait observed
  from submit to dispatch, the service time per delivered unit observed
  from dispatch to completion) predict a submit's completion time
  against its deadline; a request predicted to miss is shed at submit
  with :class:`PredictedMissError` instead of holding queue and device
  time only to expire. An empty queue always admits one request, and a
  request without a deadline has nothing to miss.
- :class:`BrownOut`: after ``engage_after`` predicted-miss sheds in a
  row the owning service caps ``max_new_tokens`` and turns speculation
  off for newly admitted streams; the decode scheduler applies the
  transition only when its slot array is empty (the boundary a staged
  weight swap waits for), so no stream in flight changes. It releases
  after ``release_after`` admits in a row.
- :class:`CircuitBreaker`: the state machine ``FleetRouter`` keeps for
  each replica: ``closed`` -> ``open`` on a run of transport failures or
  of slow successes (the gray failure a liveness probe cannot see) ->
  ``half_open`` after a jittered cooldown, when exactly one probe
  request rides through -> ``closed`` on its success, ``open`` again on
  its failure.

Every knob is deterministic and the clock injectable: the cooldown
jitter draws from the splitmix64 counter RNG (``data.augrng.AugRng``)
keyed on ``(seed, crc32(replica key), open count)``, so two runs of one
chaos plan open and probe at the same offsets.
"""

import logging
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.data.augrng import AugRng
from zookeeper_tpu_torch.observability.registry import DEFAULT_MS_BUCKETS, MetricsRegistry
from zookeeper_tpu_torch.serving.batcher import RejectedError

logger = logging.getLogger(__name__)

__all__ = ["BrownOut", "CircuitBreaker", "OverloadGuard", "PredictedMissError"]


class PredictedMissError(RejectedError):
    """Predicted-miss shed: the guard's cost model says this request
    would expire before completing. A ``RejectedError``, so every shed
    handling applies (``outcome_of`` -> "shed"); the type tells a
    predictive shed from a ``shed_above`` one."""


class BrownOut:
    """Hysteresis over admission decisions: ``engage_after`` predicted-
    miss sheds in a row engage, ``release_after`` admits in a row
    release. Bookkeeping only: the owning service applies the
    degradation at its own safe boundary. Thread-safe."""

    def __init__(self, engage_after: int, release_after: int) -> None:
        if engage_after < 1 or release_after < 1:
            raise ValueError(
                f"engage_after={engage_after} and release_after={release_after} must "
                "be >= 1."
            )
        self.engage_after = int(engage_after)
        self.release_after = int(release_after)
        self.engaged = False
        self.engaged_total = 0
        self._shed_streak = 0
        self._ok_streak = 0
        self._lock = threading.Lock()

    def note(self, shed: bool) -> None:
        """Record one admission decision (True: a predicted-miss shed)."""
        with self._lock:
            if shed:
                self._shed_streak += 1
                self._ok_streak = 0
                if not self.engaged and self._shed_streak >= self.engage_after:
                    self.engaged = True
                    self.engaged_total += 1
            else:
                self._ok_streak += 1
                self._shed_streak = 0
                if self.engaged and self._ok_streak >= self.release_after:
                    self.engaged = False

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "engaged": self.engaged,
                "engaged_total": self.engaged_total,
                "shed_streak": self._shed_streak,
                "ok_streak": self._ok_streak,
                "engage_after": self.engage_after,
                "release_after": self.release_after,
            }


@component
class OverloadGuard:
    """Predicted-miss admission. Per submit with ``queued_units`` of work
    ahead, ``request_units`` of its own and ``deadline_ms`` left::

        predicted_ms = max(queued_units * service_ewma, wait_ewma)
                       + request_units * service_ewma
        shed iff queued_units > 0 and predicted_ms > deadline_ms * headroom

    ``service_ewma`` is the EWMA of the per-unit service time, and
    ``wait_ewma`` the EWMA of whole-request queue waits, a floor that
    catches what the queue x service product misses (coalescing gaps,
    dispatch stalls). Units are the caller's: generated tokens (plus
    prefill chunks owed) for the decode scheduler, rows for the
    ``MicroBatcher``. Below ``min_samples`` observations the guard
    admits everything.
    """

    #: Master switch: a disabled guard admits everything and records
    #: nothing (the services treat ``guard=None`` the same way).
    enabled: bool = Field(False)
    #: EWMA smoothing factor of both estimators (1.0: the last sample).
    alpha: float = Field(0.25)
    #: Completed requests observed before the guard may shed.
    min_samples: int = Field(4)
    #: Shed when ``predicted > headroom * deadline``.
    headroom: float = Field(1.0)
    #: Predicted-miss sheds in a row that engage the brown-out (0: off).
    brownout_after: int = Field(0)
    #: Admits in a row that release an engaged brown-out.
    brownout_release: int = Field(16)
    #: The ``max_new_tokens`` cap of streams admitted under the brown-out.
    brownout_max_new_tokens: int = Field(8)

    def bind(self) -> "OverloadGuard":
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha={self.alpha} must be in (0, 1].")
        if self.min_samples < 1:
            raise ValueError(f"min_samples={self.min_samples} must be >= 1.")
        if self.headroom <= 0.0:
            raise ValueError(f"headroom={self.headroom} must be > 0.")
        if self.brownout_max_new_tokens < 1:
            raise ValueError(
                f"brownout_max_new_tokens={self.brownout_max_new_tokens} must be >= 1."
            )
        set_ = lambda name, value: object.__setattr__(self, name, value)  # noqa: E731
        set_("_lock", threading.Lock())
        set_("_service_ewma", None)
        set_("_wait_ewma", None)
        set_("_samples", 0)
        set_("_brownout", BrownOut(self.brownout_after, self.brownout_release)
             if self.brownout_after > 0 else None)
        return self

    def _require_bound(self) -> None:
        if getattr(self, "_lock", None) is None:
            raise RuntimeError("OverloadGuard is not bound: call guard.bind() before use.")

    # -- the zk_guard_* family, on its own registry ---------------------

    def _obs(self) -> dict:
        from zookeeper_tpu_torch.serving.metrics import _get_or_build_obs

        return _get_or_build_obs(self, self._build_obs)

    def _build_obs(self) -> dict:
        r = MetricsRegistry()
        return {
            "registry": r,
            "counters": {
                "predicted_miss": r.counter("zk_guard_predicted_miss_total",
                                            help="submits shed by predicted-miss admission"),
                "admitted": r.counter("zk_guard_admitted_total",
                                      help="submits the guard admitted"),
                "brownouts": r.counter("zk_guard_brownouts_total",
                                       help="brown-out engagements applied at the drain "
                                            "boundary"),
            },
            "gauges": {
                "service_ewma_ms": r.gauge("zk_guard_service_ewma_ms",
                                           help="EWMA per-unit service time estimate"),
                "wait_ewma_ms": r.gauge("zk_guard_wait_ewma_ms",
                                        help="EWMA whole-request queue wait estimate"),
                "brownout_active": r.gauge("zk_guard_brownout_active",
                                           help="1 = brown-out degradation applied (cap + no "
                                                "speculation for new admissions)"),
            },
            "hist": {
                "predicted_ms": r.histogram("zk_guard_predicted_ms", buckets=DEFAULT_MS_BUCKETS,
                                            help="predicted completion time at admission"),
            },
            "windows": {},
        }

    @property
    def registry(self) -> MetricsRegistry:
        return self._obs()["registry"]

    # -- estimators ------------------------------------------------------

    def observe_service(self, service_ms: float, units: int) -> None:
        """One completed request's dispatch-to-completion time over the
        units it delivered."""
        self._require_bound()
        per_unit = float(service_ms) / max(1, int(units))
        with self._lock:
            cur = self._service_ewma
            object.__setattr__(self, "_service_ewma", per_unit if cur is None
                               else cur + self.alpha * (per_unit - cur))
            object.__setattr__(self, "_samples", self._samples + 1)
            self._obs()["gauges"]["service_ewma_ms"].set(self._service_ewma)

    def observe_wait(self, wait_ms: float) -> None:
        """One completed request's submit-to-dispatch queue wait."""
        self._require_bound()
        with self._lock:
            cur = self._wait_ewma
            object.__setattr__(self, "_wait_ewma", float(wait_ms) if cur is None
                               else cur + self.alpha * (float(wait_ms) - cur))
            self._obs()["gauges"]["wait_ewma_ms"].set(self._wait_ewma)

    @property
    def samples(self) -> int:
        return getattr(self, "_samples", 0)

    def predicted_ms(self, queued_units: float, request_units: float) -> Optional[float]:
        """The completion-time prediction (None below ``min_samples``)."""
        self._require_bound()
        with self._lock:
            if self._samples < self.min_samples:
                return None
            service = self._service_ewma or 0.0
            wait = self._wait_ewma or 0.0
        return max(float(queued_units) * service, wait) + float(request_units) * service

    # -- admission -------------------------------------------------------

    def admit(self, *, queued_units: float, request_units: float,
              deadline_ms: Optional[float]) -> Tuple[bool, Optional[float]]:
        """One admission decision, ``(admitted, predicted_ms)``, recorded in
        the counters and the brown-out's streaks. The caller raises
        :class:`PredictedMissError` on False, after logging the shed."""
        self._require_bound()
        predicted = self.predicted_ms(queued_units, request_units)
        obs = self._obs()
        if predicted is not None:
            obs["hist"]["predicted_ms"].observe(predicted)
        shed = (
            predicted is not None
            and queued_units > 0  # an empty queue always admits one request
            and deadline_ms is not None  # no deadline, nothing to miss
            and predicted > float(deadline_ms) * self.headroom
        )
        obs["counters"]["predicted_miss" if shed else "admitted"].inc()
        brownout = getattr(self, "_brownout", None)
        if brownout is not None:
            brownout.note(shed)
        return not shed, predicted

    # -- the brown-out seam (the owning scheduler polls and applies) -----

    @property
    def brownout_engaged(self) -> bool:
        """Whether the pressure wants the brown-out; the scheduler applies
        it at its drain boundary, so the two can disagree for a while."""
        brownout = getattr(self, "_brownout", None)
        return brownout is not None and brownout.engaged

    def record_brownout_applied(self, active: bool) -> None:
        """The owning scheduler applied a transition: set the gauge and
        count an engagement."""
        obs = self._obs()
        obs["gauges"]["brownout_active"].set(1.0 if active else 0.0)
        if active:
            obs["counters"]["brownouts"].inc()

    # -- introspection ---------------------------------------------------

    def status(self) -> Dict[str, object]:
        """The ``/statusz`` ``guardrails`` section."""
        if getattr(self, "_lock", None) is None:
            return {"enabled": False, "bound": False}
        with self._lock:
            service, wait, samples = self._service_ewma, self._wait_ewma, self._samples
        counters = self._obs()["counters"]
        brownout = getattr(self, "_brownout", None)
        return {
            "enabled": bool(self.enabled),
            "samples": samples,
            "warmed_up": samples >= self.min_samples,
            "service_ewma_ms": round(service, 4) if service is not None else None,
            "wait_ewma_ms": round(wait, 4) if wait is not None else None,
            "headroom": self.headroom,
            "predicted_miss_total": int(counters["predicted_miss"].value),
            "admitted_total": int(counters["admitted"].value),
            "brownout": (brownout.status() if brownout is not None
                         else {"engaged": False, "configured": False}),
        }

    def snapshot(self) -> Dict[str, float]:
        counters = self._obs()["counters"]
        out = {
            "guard_predicted_miss_total": float(counters["predicted_miss"].value),
            "guard_admitted_total": float(counters["admitted"].value),
            "guard_brownouts_total": float(counters["brownouts"].value),
        }
        if getattr(self, "_service_ewma", None) is not None:
            out["guard_service_ewma_ms"] = float(self._service_ewma)
        if getattr(self, "_wait_ewma", None) is not None:
            out["guard_wait_ewma_ms"] = float(self._wait_ewma)
        return out


class CircuitBreaker:
    """One replica's breaker (the state machine of the module docstring).
    The router drives it under its own lock, and every method is
    thread-safe on its own: claiming the probe is race-free.

    It trips on ``failure_threshold`` transport failures in a row (0:
    never), or on ``latency_window`` successes in a row slower than
    ``latency_threshold_ms`` (0.0: never). ``clock`` defaults to
    ``time.monotonic``; each cooldown lies in ``[cooldown_s, cooldown_s
    * (1 + jitter_frac)]``, deterministic per open and different across
    opens and replicas, so a fleet's breakers do not re-probe in
    lockstep after a correlated trip."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, *, key: str = "", failure_threshold: int = 3,
                 latency_threshold_ms: float = 0.0, latency_window: int = 3,
                 cooldown_s: float = 5.0, jitter_frac: float = 0.5, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if failure_threshold < 0 or latency_window < 1:
            raise ValueError(
                f"failure_threshold={failure_threshold} must be >= 0 (0 disables) and "
                f"latency_window={latency_window} >= 1."
            )
        if cooldown_s <= 0 or jitter_frac < 0:
            raise ValueError(
                f"cooldown_s={cooldown_s} must be > 0 and jitter_frac={jitter_frac} >= 0."
            )
        self.key = str(key)
        self.failure_threshold = int(failure_threshold)
        self.latency_threshold_ms = float(latency_threshold_ms)
        self.latency_window = int(latency_window)
        self.cooldown_s = float(cooldown_s)
        self.jitter_frac = float(jitter_frac)
        self.seed = int(seed)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._fail_streak = 0
        self._slow_streak = 0
        self._open_until = 0.0
        self.opened_total = 0
        self.probes_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_code(self) -> float:
        """The gauge's encoding: 0 closed, 0.5 half-open, 1 open."""
        with self._lock:
            return {self.CLOSED: 0.0, self.HALF_OPEN: 0.5}.get(self._state, 1.0)

    @property
    def open_until(self) -> float:
        """When the half-open probe falls due (clock units; while open)."""
        with self._lock:
            return self._open_until

    def routable(self) -> bool:
        """Closed, or open with the probe due (claim it with
        :meth:`try_probe`); half-open means the one probe is in flight."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                return self._clock() >= self._open_until
            return False

    def try_probe(self) -> bool:
        """Claim the half-open probe: True exactly once per cooldown
        expiry (open and due -> half-open). The winner's next
        ``record_success``/``record_failure`` resolves it."""
        with self._lock:
            if self._state == self.OPEN and self._clock() >= self._open_until:
                self._state = self.HALF_OPEN
                self.probes_total += 1
                logger.info("circuit breaker %s half-open: probe in flight",
                            self.key or "<anon>")
                return True
            return False

    def _trip(self, reason: str) -> None:
        """Caller holds the lock."""
        self._state = self.OPEN
        self.opened_total += 1
        rng = AugRng(self.seed, zlib.crc32(self.key.encode()), self.opened_total)
        delay = self.cooldown_s * (1.0 + rng.uniform(0.0, self.jitter_frac)
                                   if self.jitter_frac > 0 else 1.0)
        self._open_until = self._clock() + delay
        self._fail_streak = 0
        self._slow_streak = 0
        logger.warning("circuit breaker %s OPEN (%s); next probe in %.3fs",
                       self.key or "<anon>", reason, delay)

    def record_success(self, latency_ms: Optional[float] = None) -> None:
        """A request to this replica completed: the half-open probe's
        success closes the breaker; while closed, a slow success counts
        toward the latency trip."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._state = self.CLOSED
                self._fail_streak = 0
                self._slow_streak = 0
                logger.info("circuit breaker %s CLOSED (probe succeeded)",
                            self.key or "<anon>")
                return
            if self._state != self.CLOSED:
                return  # a late result from before the trip
            self._fail_streak = 0
            if (self.latency_threshold_ms > 0 and latency_ms is not None
                    and float(latency_ms) > self.latency_threshold_ms):
                self._slow_streak += 1
                if self._slow_streak >= self.latency_window:
                    self._trip(f"{self._slow_streak} consecutive responses over "
                               f"{self.latency_threshold_ms:.0f}ms")
            else:
                self._slow_streak = 0

    def record_failure(self) -> None:
        """A request to this replica failed at the transport; the probe's
        failure re-opens with a fresh cooldown."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._trip("probe failed")
                return
            if self._state != self.CLOSED:
                return
            self._fail_streak += 1
            if self.failure_threshold > 0 and self._fail_streak >= self.failure_threshold:
                self._trip(f"{self._fail_streak} consecutive failures")

    def reset(self) -> None:
        """Closed with clean streaks: a replica that passes its health
        probe again after death is a new process with no history."""
        with self._lock:
            self._state = self.CLOSED
            self._fail_streak = 0
            self._slow_streak = 0

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self._state,
                "opened_total": self.opened_total,
                "probes_total": self.probes_total,
                "fail_streak": self._fail_streak,
                "slow_streak": self._slow_streak,
                "failure_threshold": self.failure_threshold,
                "latency_threshold_ms": self.latency_threshold_ms,
            }
