"""Host-side span/event tracing: the timeline the device trace can't see.

``torch.profiler`` answers "where does DEVICE time go" (its Chrome
trace, ``training.profiling``); nothing answered "where does HOST time go" —
data wait vs slab dispatch vs metrics readback vs checkpoint drain vs
batcher coalescing — or correlated those phases ACROSS subsystems
(training thread, async checkpoint writer, micro-batcher worker,
checkpoint watcher). This module is that layer:

- :func:`span` — ``with span("data_wait", step=n): ...`` records one
  timed interval on the calling thread into a process-global tracer.
- :func:`event` — an instant marker (a fault injection firing, a
  request enqueue, a restart attempt).
- :func:`export_chrome_trace` — writes the ring as Chrome trace-event
  JSON, so the host timeline opens in Perfetto/``chrome://tracing``
  ALONGSIDE the ``torch.profiler`` device trace: load both, line up the
  wall clocks, and a stalled dispatch is attributable to the exact host
  phase that blocked it.

Cost contract (the instrumented call sites are hot loops):

- **Disabled** (the default): ``span()``/``event()`` perform ONE module
  global read and return a shared no-op — no allocation, no lock, no
  clock read. The fixed keyword signature matters: a ``**kwargs``
  catch-all would allocate a dict on every call even when disabled.
- **Enabled**: one small object + two ``perf_counter_ns`` reads per
  span, appended to a bounded ``deque`` ring (thread-safe under the
  GIL; old records are evicted, never blocking a recorder).

Records carry thread identity + name (satellite: every background
thread here is ``zk-``-prefixed named) and optional ``step``/``slab``
attribution so a span is traceable to the training-loop coordinate
that produced it.

Request-scoped flow: records may additionally
carry a ``rid`` — the monotonically-minted request id from
``observability.requests`` — and the Chrome exporter synthesizes flow
events (``s``/``t``/``f`` phases keyed on the rid) from every
rid-tagged record, so Perfetto draws one arrow from the submitting
thread through the batcher/decode worker to the dispatch span and the
completion. The rid rides the SAME record tuple (one extra slot), so
tagging costs nothing beyond the span/event itself.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer",
    "disable",
    "enable",
    "enabled",
    "event",
    "export_chrome_trace",
    "get_tracer",
    "install",
    "span",
    "to_chrome_trace",
]

#: Default ring capacity: ~64k records covers minutes of slab-cadence
#: training or tens of thousands of serving requests at a few MB of
#: host memory.
DEFAULT_CAPACITY = 65536


class _NoopSpan:
    """The shared disabled-path context manager: entering/exiting it
    allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    """One live span: records its interval on ``__exit__``."""

    __slots__ = (
        "_tracer", "_name", "_step", "_slab", "_attrs", "_rid", "_t0",
    )

    def __init__(self, tracer, name, step, slab, attrs, rid):
        self._tracer = tracer
        self._name = name
        self._step = step
        self._slab = slab
        self._attrs = attrs
        self._rid = rid
        self._t0 = 0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter_ns()
        thread = threading.current_thread()
        self._tracer._ring.append(
            (
                "X",
                self._name,
                self._t0,
                t1 - self._t0,
                thread.ident,
                thread.name,
                self._step,
                self._slab,
                self._attrs,
                self._rid,
            )
        )
        return False


class Tracer:
    """Thread-safe bounded ring of span/event records.

    Appends go straight into a ``deque(maxlen=capacity)`` — atomic
    under the GIL, evicting the oldest record when full, so recorders
    never block and memory is bounded by construction. ``drain()`` and
    the exporters snapshot the ring without stopping recording.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1.")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)

    def span(self, name, step=None, slab=None, attrs=None, rid=None) -> _Span:
        return _Span(self, name, step, slab, attrs, rid)

    def event(self, name, step=None, attrs=None, rid=None) -> None:
        thread = threading.current_thread()
        self._ring.append(
            (
                "i",
                name,
                time.perf_counter_ns(),
                0,
                thread.ident,
                thread.name,
                step,
                None,
                attrs,
                rid,
            )
        )

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def drain(self) -> List[dict]:
        """Snapshot-and-clear the ring as a list of dicts (oldest
        first). Recording may continue concurrently; records appended
        after the snapshot stay in the ring."""
        raw = list(self._ring)
        # Remove exactly the snapshotted records, identified by object
        # identity (``raw`` holds the references, so ids are stable).
        # A blind popleft-N would miscount when the ring is at capacity
        # and a concurrent append evicts a snapshotted record from the
        # left: the Nth popleft would then swallow the brand-new
        # UN-snapshotted record.
        snapshotted = {id(rec) for rec in raw}
        while True:
            try:
                head = self._ring[0]
            except IndexError:
                break
            if id(head) not in snapshotted:
                break
            try:
                self._ring.popleft()
            except IndexError:  # pragma: no cover - concurrent clear
                break
        return self._as_dicts(raw)

    def snapshot(self) -> List[dict]:
        """The current ring as dicts, oldest first, without clearing."""
        return self._as_dicts(list(self._ring))

    @staticmethod
    def _as_dicts(records) -> List[dict]:
        return [
            {
                "phase": ph,
                "name": name,
                "ts_ns": ts,
                "dur_ns": dur,
                "thread_id": tid,
                "thread_name": tname,
                "step": step,
                "slab": slab,
                "attrs": attrs,
                "rid": rid,
            }
            for (
                ph, name, ts, dur, tid, tname, step, slab, attrs, rid,
            ) in records
        ]


#: The process-global tracer; None = disabled (the single flag the hot
#: paths read).
_TRACER: Optional[Tracer] = None


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Turn tracing on. Idempotent, first-enable-wins: when a tracer is
    already live, its ring is KEPT and ``capacity`` is ignored — a
    nested enabler (an experiment's ``trace_export`` inside an
    externally-traced session) must never drop the outer session's
    records or invalidate its ``get_tracer()`` reference. To change
    capacity, ``disable()`` first."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def install(tracer: Optional[Tracer]) -> None:
    """Install ``tracer`` as the process-global tracer (None disables).
    This is the save/restore primitive for scoped measurements (an
    overhead comparison with tracing on and off): ``saved = get_tracer(); ...;
    install(saved)`` puts back the ORIGINAL object with its ring
    intact, where a disable()/enable() cycle would swap in an empty
    ring and orphan held references. Normal code uses
    :func:`enable`/:func:`disable`."""
    global _TRACER
    _TRACER = tracer


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def span(name: str, step=None, slab=None, attrs=None, rid=None):
    """A timed interval on the calling thread. Returns the shared no-op
    when tracing is disabled — one global read, zero allocation (the
    cost contract the hot loops rely on). ``attrs`` is an optional
    pre-built dict; build it only behind an ``enabled()`` check if its
    construction is itself nontrivial. ``rid`` tags the record with a
    request id (``observability.requests``) so the Chrome exporter can
    draw its cross-thread flow arrow."""
    tracer = _TRACER
    if tracer is None:
        return _NOOP
    return tracer.span(name, step, slab, attrs, rid)


def event(name: str, step=None, attrs=None, rid=None) -> None:
    """An instant marker (fault injection, enqueue, restart...). Free
    when disabled, same contract as :func:`span`."""
    tracer = _TRACER
    if tracer is not None:
        tracer.event(name, step, attrs, rid)


# -- Chrome trace-event export -------------------------------------------


def to_chrome_trace(tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """Render the ring as a Chrome trace-event JSON object
    (``{"traceEvents": [...]}``, the format Perfetto /
    ``chrome://tracing`` load natively).

    Spans become ``"X"`` (complete) events with microsecond ``ts`` /
    ``dur``; instants become ``"i"`` events; each thread gets an ``"M"``
    ``thread_name`` metadata event so the timeline rows carry the
    ``zk-``-prefixed thread names instead of bare ids. ``step``/``slab``
    attribution and attrs land in ``args`` (visible in the Perfetto
    detail pane). Timestamps are ``perf_counter_ns``-based — the same
    monotonic clock within one process, so host spans from every thread
    share one timeline.

    Rid-tagged records additionally synthesize Chrome FLOW events: per
    rid with two or more records, the
    timeline-ordered chain gets ``s`` (start) / ``t`` (step) / ``f``
    (end) flow phases, ``id`` = the rid, ``cat`` = ``"rid"``, each flow
    point timestamped INSIDE its record (mid-span for ``X`` records) so
    Perfetto binds it to the enclosing slice (``bp: "e"``) and draws
    one arrow from the submitting thread through the worker's dispatch
    to the completion.
    """
    tracer = tracer if tracer is not None else _TRACER
    records = tracer.snapshot() if tracer is not None else []
    pid = os.getpid()
    events: List[dict] = []
    seen_threads: Dict[int, str] = {}
    flows: Dict[Any, List[dict]] = {}
    for rec in records:
        tid = rec["thread_id"]
        if tid not in seen_threads:
            seen_threads[tid] = rec["thread_name"]
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": rec["thread_name"]},
                }
            )
        args = dict(rec["attrs"] or {})
        if rec["step"] is not None:
            args["step"] = rec["step"]
        if rec["slab"] is not None:
            args["slab"] = rec["slab"]
        rid = rec.get("rid")
        if rid is not None:
            args["rid"] = rid
        out = {
            "ph": rec["phase"],
            "name": rec["name"],
            "pid": pid,
            "tid": tid,
            "ts": rec["ts_ns"] / 1e3,
            "args": args,
        }
        if rec["phase"] == "X":
            out["dur"] = rec["dur_ns"] / 1e3
        else:
            out["s"] = "t"  # instant scoped to its thread
        events.append(out)
        if rid is not None:
            # Flow point INSIDE the record: mid-span for X so the point
            # falls within the slice Perfetto binds the arrow to.
            flows.setdefault(rid, []).append(
                {
                    "tid": tid,
                    "ts": (rec["ts_ns"] + rec["dur_ns"] // 2) / 1e3,
                }
            )
    for rid, points in flows.items():
        if len(points) < 2:
            continue  # an arrow needs two ends
        points.sort(key=lambda p: p["ts"])
        last = len(points) - 1
        for i, point in enumerate(points):
            ph = "s" if i == 0 else ("f" if i == last else "t")
            flow = {
                "ph": ph,
                "name": "request",
                "cat": "rid",
                "id": rid,
                "pid": pid,
                "tid": point["tid"],
                "ts": point["ts"],
            }
            if ph != "s":
                flow["bp"] = "e"  # bind to the enclosing slice
            events.append(flow)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(
    path: str, tracer: Optional[Tracer] = None
) -> int:
    """Write :func:`to_chrome_trace` to ``path``; returns the number of
    trace events written (metadata rows included)."""
    doc = to_chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
