"""Typed metrics registry: Counter / Gauge / Histogram behind one name
table.

The serving metrics (``ServingMetrics``, ``DecodeMetrics``) and the
process-wide gauges (device memory, MFU/MBU, recompiles) record here so
a live process can be *scraped*. This registry is the common
substrate: subsystems register typed instruments once and record into
them from any thread; an exporter
(``observability.export``) renders every registered series in one pass
— Prometheus text for ``/metrics``, a flat dict for ``/statusz`` and
the ``MetricsWriter`` family.

Semantics (the useful subset of the Prometheus data model):

- :class:`Counter` — monotone float/int total; ``inc(n)`` with n >= 0.
- :class:`Gauge` — a settable point-in-time value (``set``/``inc``).
- :class:`Histogram` — FIXED ascending bucket bounds declared at
  registration; ``observe(v)`` updates cumulative bucket counts +
  sum/count. Fixed buckets keep ``observe`` O(log buckets) with zero
  allocation — the recorder-side cost model serving needs — and render
  directly as Prometheus ``_bucket{le=...}`` series.

All instruments are lock-guarded (recorders race across the training
thread, batcher worker, checkpoint writer, watcher); registration is
get-or-create keyed on ``(name, labels)`` so two subsystems asking for
the same series share one instrument, while a same-name different-TYPE
registration fails loudly (a silent type fork would render invalid
exposition text).

Label-cardinality guard: one metric NAME may register at most
``max_label_variants`` distinct label-value combinations (default 64).
Beyond the cap a registration returns a DETACHED instrument — fully
usable by the caller, but never collected, so ``/metrics`` stays
bounded — while ``zk_labels_dropped_total{metric=<name>}`` counts the
drops and one WARNING names the runaway series. An unbounded label (a
future per-tenant or per-bucket label fed from request data) must
never grow the exposition without bound.
"""

import bisect
import logging
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
]

#: Default latency-ish buckets (ms): sub-ms serving dispatches through
#: multi-second checkpoint writes.
DEFAULT_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

#: Default ratio buckets (bucket fill / padding waste: values in [0, 1]).
DEFAULT_RATIO_BUCKETS = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0,
)

_LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Mapping[str, str]]) -> _LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


class _Instrument:
    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        self.name = name
        self.help = help
        self.labels: Dict[str, str] = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonically increasing total."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"Counter {self.name!r} is monotone; inc({n}) is negative "
                "(use a Gauge for values that go down)."
            )
        with self._lock:
            self._value += n

    def reset(self) -> None:
        """Zero the total IN PLACE (the instrument object and its
        registry registration survive — scrapers see an ordinary
        counter reset, the same thing a process restart produces)."""
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Instrument):
    """Point-in-time value; settable from any thread."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None, initial: float = 0.0):
        super().__init__(name, help, labels)
        self._initial = float(initial)
        self._value = float(initial)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def reset(self) -> None:
        """Back to the registration-time ``initial`` value, in place."""
        with self._lock:
            self._value = self._initial

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Instrument):
    """Cumulative histogram over fixed ascending bucket bounds.

    ``observe`` is the hot call: one bisect + two adds under the lock,
    no allocation. ``+Inf`` is implicit (the total count)."""

    kind = "histogram"

    def __init__(
        self,
        name,
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
        help="",
        labels=None,
    ):
        super().__init__(name, help, labels)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)) or not all(
            math.isfinite(b) for b in bounds
        ):
            raise ValueError(
                f"Histogram {name!r} buckets must be a non-empty, strictly "
                f"ascending sequence of finite bounds, got {buckets!r}."
            )
        self.buckets = bounds
        self._counts = [0] * len(bounds)  # per-bucket (non-cumulative)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = bisect.bisect_left(self.buckets, v)
            if i < len(self._counts):
                self._counts[i] += 1
            self._count += 1
            self._sum += v

    def reset(self) -> None:
        """Zero counts and sum IN PLACE; bounds are immutable."""
        with self._lock:
            self._counts = [0] * len(self.buckets)
            self._count = 0
            self._sum = 0.0

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative_counts(self) -> List[int]:
        """Per-bound cumulative counts (Prometheus ``le`` semantics);
        the implicit ``+Inf`` bucket is :attr:`count`."""
        return self.collect_state()[0]

    def collect_state(self) -> Tuple[List[int], int, float]:
        """``(cumulative_counts, count, sum)`` read under ONE lock
        acquisition: a scrape assembled from separate reads can observe
        ``_count != +Inf bucket`` when a concurrent ``observe`` lands
        between them — spec-invalid exposition text."""
        with self._lock:
            out, total = [], 0
            for c in self._counts:
                total += c
                out.append(total)
            return out, self._count, self._sum


#: The drop-accounting series itself is exempt from the cardinality
#: guard (its variant count is bounded by the number of DISTINCT capped
#: metric names, and capping it would hide the very overflow it
#: reports).
_DROPPED_SERIES = "zk_labels_dropped_total"


class MetricsRegistry:
    """Name table of typed instruments.

    Get-or-create: ``counter/gauge/histogram`` return the existing
    instrument when ``(name, labels)`` was already registered with the
    same type (and, for histograms, the same bounds); a type or bounds
    conflict raises — one name must mean one series shape. A NEW label
    variant past ``max_label_variants`` per name is dropped (detached
    instrument returned; ``zk_labels_dropped_total{metric=}`` bumped,
    warned once per name) — see the module docstring.
    """

    def __init__(self, max_label_variants: int = 64) -> None:
        if max_label_variants < 1:
            raise ValueError(
                f"max_label_variants={max_label_variants} must be >= 1."
            )
        self.max_label_variants = int(max_label_variants)
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, _LabelsKey], _Instrument] = {}
        self._variant_counts: Dict[str, int] = {}
        self._cardinality_warned: Set[str] = set()

    def _get_or_create(self, cls, name, labels, factory):
        key = (str(name), _labels_key(labels))
        warn = False
        with self._lock:
            existing = self._instruments.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}."
                    )
                return existing
            variants = self._variant_counts.get(key[0], 0)
            if (
                key[0] != _DROPPED_SERIES
                and variants >= self.max_label_variants
            ):
                # Over the cap: fall through to the detached path below
                # (the drop counter is registered OUTSIDE this lock —
                # it goes through _get_or_create itself).
                if key[0] not in self._cardinality_warned:
                    self._cardinality_warned.add(key[0])
                    warn = True
            else:
                inst = factory()
                self._instruments[key] = inst
                self._variant_counts[key[0]] = variants + 1
                return inst
        if warn:
            logger.warning(
                "metric %r is at its label-cardinality cap (%d distinct "
                "label combinations): new variants record into detached "
                "instruments and are NOT exported — an unbounded label "
                "value is feeding this series "
                "(zk_labels_dropped_total{metric=%r} counts the drops)",
                key[0],
                self.max_label_variants,
                key[0],
            )
        self.counter(
            _DROPPED_SERIES,
            help="label variants dropped by the per-metric cardinality "
            "cap",
            labels={"metric": key[0]},
        ).inc()
        # Detached: the caller gets a real, recordable instrument of
        # the right shape; it simply never renders.
        return factory()

    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        return self._get_or_create(
            Counter, name, labels, lambda: Counter(name, help, labels)
        )

    def gauge(
        self, name: str, help: str = "", labels=None, initial: float = 0.0
    ) -> Gauge:
        return self._get_or_create(
            Gauge, name, labels, lambda: Gauge(name, help, labels, initial)
        )

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
        help: str = "",
        labels=None,
    ) -> Histogram:
        hist = self._get_or_create(
            Histogram,
            name,
            labels,
            lambda: Histogram(name, buckets, help, labels),
        )
        if hist.buckets != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{hist.buckets}, not {tuple(buckets)!r}."
            )
        return hist

    def collect(self) -> List[_Instrument]:
        """Every registered instrument, registration-ordered (dicts
        preserve insertion order), for exporters."""
        with self._lock:
            return list(self._instruments.values())

    def as_flat_dict(self) -> Dict[str, float]:
        """Scalar view (``/statusz`` + MetricsWriter bridging):
        counters/gauges by name, histograms as ``name_count``/
        ``name_sum``/``name_mean``. Labeled series get a
        ``{k=v,...}`` suffix."""
        out: Dict[str, float] = {}
        for inst in self.collect():
            suffix = (
                "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(inst.labels.items())
                ) + "}"
                if inst.labels
                else ""
            )
            if isinstance(inst, Histogram):
                _, count, total = inst.collect_state()
                out[f"{inst.name}_count{suffix}"] = float(count)
                out[f"{inst.name}_sum{suffix}"] = float(total)
                if count:
                    out[f"{inst.name}_mean{suffix}"] = total / count
            else:
                out[f"{inst.name}{suffix}"] = float(inst.value)
        return out


#: Process-global registry for cross-cutting background subsystems
#: (async-checkpoint queue depth, data prefetch occupancy) that have no
#: natural per-component owner. Component-owned registries (a
#: ``ServingMetrics`` instance's) stay separate so parallel instances
#: never double-count; exporters render both.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
