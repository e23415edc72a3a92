"""Request-scoped flow tracing: rid minting + the per-service RequestLog.

The aggregate view (spans, typed metrics, the program ledger) answers
"how is the service doing"; nothing answered "what happened to THAT
request" — the question a p99 spike or a chaos leg actually poses.
This module adds the per-request axis:

- :func:`next_rid` — a process-global, monotonically-assigned request
  id, minted once at ``MicroBatcher.submit`` / ``DecodeScheduler.submit``
  and carried on the request handle through queue → coalesce/slot-refill
  → dispatch → completion. Trace records tag it (``trace.span(...,
  rid=)``), and the Chrome exporter turns the chain into flow events so
  Perfetto draws one arrow from the submitting thread through the
  worker to the dispatch span.
- :class:`RequestLog` — a bounded per-service ring of one COMPACT
  summary per terminal request: rid, enqueue/dispatch/complete
  timestamps (``perf_counter_ns`` — the trace clock, so summaries and
  spans line up), bucket or slot, rows or tokens, outcome, and the
  weights step that served it. The ring is the "recent requests" table
  an operator reads off ``/statusz`` and the flight recorder dumps
  into every bundle — when the trace ring has already evicted a
  request's spans, its one-line summary survives here.

Cost contract: ``append`` is one dict build + one bounded ``deque``
append (GIL-atomic, never blocks, oldest evicted), host-only like the
trace spans.
"""

import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "OUTCOMES",
    "RequestLog",
    "next_rid",
]

#: Terminal outcomes a request summary may carry. "ok" covers every
#: successful finish (decode records the finer eos/length/capacity
#: reason in ``detail``); the rest are the §10 failure taxonomy.
OUTCOMES = ("ok", "shed", "deadline_expired", "crashed", "error")

#: Process-global monotonic rid source. ``next()`` on an
#: ``itertools.count`` is GIL-atomic, so minting costs one C call and
#: two submits can never share a rid.
_RIDS = itertools.count(1)


def next_rid() -> int:
    """Mint the next request id (process-global, monotonic, never
    reused)."""
    return next(_RIDS)


class RequestLog:
    """Bounded ring of per-request terminal summaries for ONE service.

    Appends are cheap and thread-safe (bounded deque, GIL-atomic);
    readers (``tail``, ``find``, ``as_status``) snapshot without
    blocking recorders. ``total`` counts every summary ever appended —
    the ring only bounds what is still READABLE.
    """

    def __init__(self, name: str, capacity: int = 1024) -> None:
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1.")
        self.name = str(name)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0
        self._by_outcome: Dict[str, int] = {}

    def append(
        self,
        rid: int,
        outcome: str,
        *,
        enqueue_ns: Optional[int] = None,
        dispatch_ns: Optional[int] = None,
        complete_ns: Optional[int] = None,
        rows: Optional[int] = None,
        tokens: Optional[int] = None,
        bucket: Optional[int] = None,
        slot: Optional[int] = None,
        weights_step: Optional[int] = None,
        detail: Optional[str] = None,
        role: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Record one TERMINAL request (exactly once per request — the
        handles' first-transition-wins completion guarantees callers
        only reach this once). Returns the summary dict."""
        record: Dict[str, Any] = {
            "rid": int(rid),
            "outcome": str(outcome),
            "enqueue_ns": enqueue_ns,
            "dispatch_ns": dispatch_ns,
            "complete_ns": complete_ns,
        }
        if rows is not None:
            record["rows"] = int(rows)
        if tokens is not None:
            record["tokens"] = int(tokens)
        if bucket is not None:
            record["bucket"] = int(bucket)
        if slot is not None:
            record["slot"] = int(slot)
        if weights_step is not None:
            record["weights_step"] = int(weights_step)
        if detail is not None:
            record["detail"] = str(detail)
        if role is not None:
            # Which serving ROLE completed the dispatch (disaggregated
            # topologies: "prefill" / "transfer" / "decode"; single-mesh
            # schedulers record "decode"). A small CLOSED vocabulary by
            # construction — same posture as the registry's label-
            # cardinality guard, though this is a record field, never a
            # metric label.
            record["role"] = str(role)
        # Counters under the lock; the append itself is deque-atomic.
        with self._lock:
            self._total += 1
            self._by_outcome[record["outcome"]] = (
                self._by_outcome.get(record["outcome"], 0) + 1
            )
        self._ring.append(record)
        return record

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def total(self) -> int:
        """Summaries ever appended (>= ``len()``: eviction only bounds
        readability)."""
        return self._total

    def tail(self, n: int = 64) -> List[Dict[str, Any]]:
        """The newest ``n`` summaries, oldest-of-the-tail first."""
        n = int(n)
        if n <= 0:
            return []  # records[-0:] would be the WHOLE ring
        return list(self._ring)[-n:]

    def find(self, rid: int) -> Optional[Dict[str, Any]]:
        """The (newest) summary for ``rid`` still in the ring, or
        None."""
        for record in reversed(list(self._ring)):
            if record["rid"] == rid:
                return record
        return None

    def as_status(self, tail: int = 32) -> Dict[str, Any]:
        """The ``/statusz`` section: counts by outcome + the recent
        tail — the numbers an operator reads before digging into the
        trace."""
        with self._lock:
            by_outcome = dict(self._by_outcome)
            total = self._total
        return {
            "service": self.name,
            "capacity": self.capacity,
            "recorded_total": total,
            "by_outcome": by_outcome,
            "tail": self.tail(tail),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total = 0
            self._by_outcome.clear()
