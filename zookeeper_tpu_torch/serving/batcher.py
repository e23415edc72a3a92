"""Request coalescing: many ``submit()`` calls, one engine dispatch.

The port of ``zookeeper_tpu/serving/batcher.py``'s ``MicroBatcher``.
Queued requests are concatenated FIFO and row-granular into the engine's
largest bucket; only the final remainder is padded, and per-request
slices come back out of ONE ``.cpu()`` readback per dispatch.

- Oversized requests (more rows than the largest bucket) are split
  across consecutive dispatches and re-assembled.
- Queue-full applies backpressure: synchronous mode drains the backlog
  inline, async mode blocks the submitter.
- ``shed_above_rows > 0`` sheds instead (``RejectedError``).
- A request may carry ``deadline_ms``; an expired request fails with
  ``DeadlineExpiredError`` and is never dispatched late.
- If the async worker dies, every queued and in-flight request fails
  with ``WorkerCrashedError`` and the next ``submit()`` restarts it.

``synchronous=True`` (the default) is thread- and clock-free: requests
queue until ``flush()`` or ``result()``. Async mode adds one worker that
dispatches when the largest bucket fills or the oldest request has
waited ``max_delay_ms``. Inference is row-independent, so a request's
result does not depend on how it was coalesced or split.

**Chief-led dispatch.** In front of an engine whose partitioner spans
several ranks every rank runs its own batcher, and each dispatch is a
collective. The synchronous mode without deadlines plans the same
dispatches on every rank by itself. The async worker, deadlines and a
followed checkpoint watcher (``follow``) would decide by each rank's
clock, so there rank 0 decides (``parallel.distributed.ChiefLink``):
before each dispatch its worker (or its ``flush()``) broadcasts one
record, the requests it expired since the last one and the plan (each
request's submission ordinal and row slice, the bucket and the sequence
bucket), and the step a watched swap applies at; the other ranks apply
it, never consulting their own clock. A deadline therefore expires a
request at the chief's next dispatch decision after it, on every rank
alike, and a follower's ``result()`` waits for that decision. Every rank
must submit the same requests in the same order. Shedding and the
overload guard decide at submit by one rank's queue and are refused
there. At world size 1 nothing of this runs.

``FaultPlan.serving_worker_crash`` crashes the async worker at the top
of an iteration (the chaos seam of the crash path above).

Observability (``observability``): every request gets a rid at
``submit()`` (before the shed check, so a shed request is traceable
too), its terminal summary lands in the batcher's
``RequestLog("serving")`` (``request_log``; outcome by
:func:`outcome_of`), and with tracing on the rid-tagged
``request_enqueue`` / ``request_dispatch`` / ``request_complete`` /
``request_shed`` events and the ``serve_dispatch`` span draw each
request's flow; a deadline expiry is a ``request_deadline_expired``
event. A worker crash notifies the flight recorder, outside the lock,
after the victims' summaries are logged. After each dispatch's readback
the engine's ``observe_dispatch(rows, seconds)`` feeds its watchdog and
MFU gauges: the wall time is the readback's own, so nothing adds a
device synchronisation.

The overload guard (``serving.guardrails.OverloadGuard``, bound with
``bind(engine, guard=...)``) adds predicted-miss admission on top of
``shed_above_rows``: at both submit sites a request the guard predicts
to miss its deadline behind the queued rows is shed with
``PredictedMissError`` (its summary's ``detail`` carries the
prediction), and every served request feeds the guard its
dispatch-to-completion time per row and its queue wait.
"""

import logging
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.requests import RequestLog, next_rid
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.parallel.distributed import ChiefLedError

logger = logging.getLogger(__name__)


class RejectedError(RuntimeError):
    """Load shedding: the queue is past ``shed_above_rows``; the request
    was never enqueued."""


class DeadlineExpiredError(TimeoutError):
    """The request's ``deadline_ms`` elapsed before its rows were served."""


class WorkerCrashedError(RuntimeError):
    """The async worker died with this request queued or in flight."""


def outcome_of(error: Optional[BaseException]) -> str:
    """The ``RequestLog`` outcome of a terminal error
    (``observability.requests.OUTCOMES``), shared by the batcher and the
    decode scheduler so both services' summaries read the same."""
    if error is None:
        return "ok"
    if isinstance(error, DeadlineExpiredError):
        return "deadline_expired"
    if isinstance(error, WorkerCrashedError):
        return "crashed"
    if isinstance(error, RejectedError):
        return "shed"
    return "error"


class _ChiefCrashed(WorkerCrashedError):
    """Under chief-led dispatch a follower's worker (or decode loop) ends
    as the chief's did: ``ordinals`` are the requests the chief failed."""

    def __init__(self, ordinals) -> None:
        super().__init__(f"the chief rank's worker crashed; requests {list(ordinals)} "
                         "failed there")
        self.ordinals = list(ordinals)


class PendingResult:
    """Handle for one submitted request; ``result()`` yields its
    ``[n, ...]`` output rows as a numpy array. ``rid`` is the request id
    minted at submit."""

    def __init__(self, batcher: "MicroBatcher", rows: int, event,
                 deadline_at: Optional[float] = None, rid: Optional[int] = None) -> None:
        self._batcher = batcher
        self._event = event  # None in synchronous mode
        self._parts: List[np.ndarray] = []
        self._rows = rows
        self._rows_done = 0
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._t_submit = time.perf_counter()
        self._deadline_at = deadline_at
        self.rid = rid
        self._t_dispatch_ns: Optional[int] = None
        self._bucket: Optional[int] = None
        # The submission ordinal (names the request in chief-led records)
        # and the rows dispatched so far.
        self.ordinal: Optional[int] = None
        self._taken = 0
        # Completion can race between the worker, a crash handler and a
        # deadline expiry: the first transition wins.
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        return self._done

    def expired(self, now: Optional[float] = None) -> bool:
        if self._deadline_at is None:
            return False
        return (time.perf_counter() if now is None else now) >= self._deadline_at

    def _deliver(self, part: np.ndarray) -> None:
        """Consecutive row slices, in row order (FIFO guarantees it,
        across the splits of an oversized request too)."""
        with self._lock:
            if self._done:
                return
            self._parts.append(part)
            self._rows_done += part.shape[0]
            if self._rows_done >= self._rows:
                self._value = (
                    self._parts[0] if len(self._parts) == 1
                    else np.concatenate(self._parts)
                )
                self._parts = []
                self._finish()

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._done:
                return False
            self._error = error
            self._finish()
            return True

    def _finish(self) -> None:
        """Caller holds ``_lock``."""
        self._done = True
        self._batcher._record_done(self, (time.perf_counter() - self._t_submit) * 1e3)
        if self._event is not None:
            self._event.set()

    def _expire(self) -> None:
        if self._fail(DeadlineExpiredError(
            f"request deadline expired after "
            f"{(time.perf_counter() - self._t_submit) * 1e3:.1f}ms"
        )):
            self._batcher._record_deadline_expired()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the rows (async) or flush and return them (sync).
        Never blocks past the request's deadline; under chief-led
        dispatch the chief's next decision after it expires the request,
        on every rank."""
        led = self._batcher._led.link is not None
        if not self._done:
            if self._event is None:
                self._batcher.flush()
                if not self._done and not led and self.expired():
                    self._expire()
            else:
                wait_s = timeout
                if self._deadline_at is not None and not led:
                    remaining = self._deadline_at - time.perf_counter()
                    wait_s = remaining if timeout is None else min(timeout, remaining)
                if not self._event.wait(None if wait_s is None else max(0.0, wait_s)):
                    if not led and self.expired():
                        self._expire()
                    else:
                        raise TimeoutError(
                            f"request not served within {timeout}s (worker "
                            "stalled, or close() was called before flush())."
                        )
        if self._error is not None:
            raise self._error
        return self._value


@component
class MicroBatcher:
    """Coalescing request queue in front of an
    :class:`~zookeeper_tpu_torch.serving.engine.InferenceEngine`."""

    #: Async mode: dispatch when the largest bucket fills or the oldest
    #: pending request has waited this long.
    max_delay_ms: float = Field(2.0)
    #: Backpressure threshold in ROWS.
    max_queue_rows: int = Field(4096)
    #: Load-shedding threshold in ROWS (0 = off); an empty queue always
    #: admits one request.
    shed_above_rows: int = Field(0)
    #: Default per-request deadline in ms (0 = none).
    default_deadline_ms: float = Field(0.0)
    #: Thread- and clock-free deterministic mode: requests queue until
    #: flush()/result().
    synchronous: bool = Field(True)

    def bind(self, engine, metrics=None, guard=None) -> "MicroBatcher":
        if self.max_queue_rows < 1:
            raise ValueError(f"max_queue_rows={self.max_queue_rows} must be >= 1.")
        if self.max_delay_ms < 0:
            raise ValueError(f"max_delay_ms={self.max_delay_ms} must be >= 0.")
        if self.shed_above_rows < 0 or self.default_deadline_ms < 0:
            raise ValueError(
                "shed_above_rows and default_deadline_ms must be >= 0 "
                "(0 disables)."
            )
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_metrics", metrics)
        # Predicted-miss admission on top of shed_above_rows (None: off).
        object.__setattr__(self, "_guard", guard)
        # One compact summary per request that reached an outcome.
        object.__setattr__(self, "_request_log", RequestLog("serving"))
        # Queue of (request, x, lo, hi): row slice [lo, hi) still owed.
        object.__setattr__(self, "_queue", [])
        object.__setattr__(self, "_queue_rows", 0)
        object.__setattr__(self, "_cv", threading.Condition())
        object.__setattr__(self, "_worker", None)
        object.__setattr__(self, "_inflight", None)
        object.__setattr__(self, "_force_drain", False)
        object.__setattr__(self, "_stop", threading.Event())
        # Chief-led dispatch (see the module docstring): the ordinals and
        # the link, the chief's expiries not yet sent, the followed watcher
        # and the step it proposed.
        object.__setattr__(self, "_led", distributed.ChiefLed("request", _ChiefCrashed))
        object.__setattr__(self, "_expired_unsent", [])
        object.__setattr__(self, "_watcher", None)
        object.__setattr__(self, "_proposed_step", None)
        if distributed.chief_led(engine) and (not self.synchronous
                                              or self.default_deadline_ms > 0):
            self._engage()
        return self

    # -- chief-led dispatch ------------------------------------------------

    def _engage(self) -> None:
        """Make the link (every rank at the same point: bind, the first
        request deadline in synchronous mode, ``follow``) and, in async
        mode, start every rank's worker, so a chief's record always has a
        receiver."""
        refused = [name for name, on in (("shed_above_rows", self.shed_above_rows > 0),
                                         ("the overload guard", self._guard is not None)) if on]
        if self._led.engage(refused) and not self.synchronous:
            with self._cv:
                self._ensure_worker()

    def follow(self, watcher) -> None:
        """Serve a :class:`~zookeeper_tpu_torch.serving.engine.\
CheckpointWatcher` under chief-led dispatch: the chief's watcher proposes
        each new step, and every rank loads it and swaps it in at the same
        dispatch boundary (``watcher.apply_step``). Every rank calls it."""
        self._require_bound()
        self._engage()
        object.__setattr__(self, "_watcher", watcher)
        watcher._follow(self, propose=self._led.link.is_chief)

    def _propose_step(self, step: int) -> None:
        """The chief's watcher found ``step``: sent with the next record
        (async mode wakes the worker for it)."""
        with self._cv:
            object.__setattr__(self, "_proposed_step", int(step))
            self._cv.notify_all()

    def _lead(self, plan) -> list:
        """The chief's side of one dispatch: send the record (expiries,
        plan, swap step), agree, swap. Returns the plan to run (empty when
        a follower lacked one of its requests: then it failed
        everywhere)."""
        with self._cv:
            expired, swap = list(self._expired_unsent), self._proposed_step
            self._expired_unsent.clear()
            object.__setattr__(self, "_proposed_step", None)
        bucket, seq_bucket = self._buckets(plan)
        record = [distributed.RECORD_STEP, len(expired), *expired, len(plan)]
        for req, part in plan:
            record += [req.ordinal, req._taken - part.shape[0], req._taken]
        record += [bucket, seq_bucket, -1 if swap is None else swap]
        self._led.link.exchange(record)
        return self._settle(plan, True, swap)

    def _follow_record(self, record) -> list:
        """A follower's side of one dispatch: apply the chief's expiries,
        take the plan's rows off its own queue (waiting a bounded time for
        requests it has not received), agree, swap. Returns the plan to
        run."""
        it = iter(record[1:])
        expired = [next(it) for _ in range(next(it))]
        entries = [(next(it), next(it), next(it)) for _ in range(next(it))]
        bucket, seq_bucket, swap = next(it), next(it), next(it)
        plan, ok = [], True
        with self._cv:
            for ordinal in expired:
                self._decide(ordinal, DeadlineExpiredError(
                    "request deadline expired (the chief rank's decision)"))
            t_end = time.perf_counter() + distributed.FOLLOWER_WAIT_S
            for ordinal, lo, hi in entries:
                ok = self._led.wait(self._cv, lambda: bool(
                    self._queue and self._queue[0][0].ordinal >= ordinal), t_end)
                if not ok:
                    break
                req, x, qlo, qhi = self._queue[0]
                if req.ordinal != ordinal or qlo != lo or hi > qhi:
                    ok = False
                    break
                plan.append((req, x[lo:hi]))
                if hi == qhi:
                    self._queue.pop(0)
                else:
                    self._queue[0] = (req, x, hi, qhi)
                object.__setattr__(self, "_queue_rows", self._queue_rows - (hi - lo))
            if ok:
                ok = self._buckets(plan) == (bucket, seq_bucket)
            if not ok:
                missing = {o for o, _, _ in entries} - {r.ordinal for r, _ in plan}
                for ordinal in missing:
                    self._decide(ordinal, self._lost_error(ordinal))
        return self._settle(plan, ok, None if swap < 0 else swap)

    def _buckets(self, plan) -> tuple:
        """The plan's batch bucket and sequence bucket (-1: none; 0, -1 for
        an empty plan), as the record carries them."""
        rows = sum(part.shape[0] for _, part in plan)
        if not rows:
            return 0, -1
        seq = -1
        if getattr(self._engine, "seq_buckets", ()):
            seq = self._engine._seq_bucket_for(int(plan[0][1].shape[1]))
        return self._engine.bucket_for(rows), seq

    def _lost_error(self, ordinal: int) -> ChiefLedError:
        return self._led.lost_error(f"request #{ordinal}", "dispatch naming it")

    def _settle(self, plan, ok: bool, swap: Optional[int]) -> list:
        """Both sides: agree on the plan (a failed one fails its requests
        on every rank), then apply a proposed swap, so it lands at the
        same boundary everywhere."""
        link = self._led.link
        if not link.agree(ok):
            for req, _ in plan:
                req._fail(self._lost_error(req.ordinal))
            plan = []
        if swap is not None:
            if self._watcher is not None:
                self._watcher.apply_step(swap, link)
            else:
                link.agree(False)  # a rank that follows no watcher: nobody swaps
        return plan

    def _decide(self, ordinal: int, error: BaseException) -> None:
        """Fail request ``ordinal`` with ``error`` on a follower: now, if it
        is queued, else when it arrives. Caller holds ``_cv``."""
        for i, (req, _, lo, hi) in enumerate(self._queue):
            if req.ordinal == ordinal:
                del self._queue[i]
                object.__setattr__(self, "_queue_rows", self._queue_rows - (hi - lo))
                self._fail_decided(req, error)
                return
        self._led.decide(ordinal, error)

    def _fail_decided(self, req: "PendingResult", error: BaseException) -> None:
        if isinstance(error, DeadlineExpiredError):
            req._expire()
        else:
            req._fail(error)

    def _apply_record(self, record) -> None:
        """A follower's async worker applies one of the chief's records."""
        plan = self._follow_record(record)
        with self._cv:
            object.__setattr__(self, "_inflight", plan)
        try:
            self._run_plan(plan)
        except Exception:
            pass  # the requests carry the error; the worker survives
        finally:
            with self._cv:
                object.__setattr__(self, "_inflight", None)
                self._cv.notify_all()

    def _require_bound(self) -> None:
        if getattr(self, "_engine", None) is None:
            raise RuntimeError(
                "MicroBatcher is not bound: call batcher.bind(engine) before "
                "submit()."
            )

    def _weights_step(self) -> Optional[int]:
        return self._metrics.weights_step if self._metrics is not None else None

    def _record_done(self, req: PendingResult, latency_ms: float) -> None:
        error = type(req._error).__name__ if req._error is not None else None
        if _trace.enabled():
            _trace.event("request_complete", rid=req.rid, attrs={
                "rows": req._rows, "latency_ms": round(latency_ms, 3), "error": error})
        if req.rid is not None:
            self._request_log.append(
                req.rid, outcome_of(req._error), enqueue_ns=int(req._t_submit * 1e9),
                dispatch_ns=req._t_dispatch_ns, complete_ns=time.perf_counter_ns(),
                rows=req._rows, bucket=req._bucket, weights_step=self._weights_step(),
                detail=error)
        if self._metrics is not None and req._error is None:
            self._metrics.record_request(latency_ms, req._rows)
        guard = getattr(self, "_guard", None)
        if (guard is not None and guard.enabled and req._error is None
                and req._t_dispatch_ns is not None):
            # Successes only: a failure's timings describe the failure,
            # not the service rate.
            now_ns = time.perf_counter_ns()
            guard.observe_service((now_ns - req._t_dispatch_ns) / 1e6, max(1, req._rows))
            guard.observe_wait((req._t_dispatch_ns - req._t_submit * 1e9) / 1e6)

    def _record_deadline_expired(self) -> None:
        _trace.event("request_deadline_expired")
        if self._metrics is not None:
            self._metrics.record_deadline_expired()

    @property
    def queue_rows(self) -> int:
        return getattr(self, "_queue_rows", 0)

    @property
    def request_log(self) -> Optional[RequestLog]:
        """This batcher's terminal-request ring (None before bind)."""
        return getattr(self, "_request_log", None)

    # -- submission ------------------------------------------------------

    def _deadline_at(self, deadline_ms: Optional[float]) -> Optional[float]:
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms or None
        if deadline_ms is None:
            return None
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms={deadline_ms} must be >= 0.")
        return time.perf_counter() + deadline_ms / 1e3

    def _shed_check(self, n: int, rid: Optional[int] = None) -> None:
        if (
            self.shed_above_rows > 0
            and self._queue
            and self._queue_rows + n > self.shed_above_rows
        ):
            if self._metrics is not None:
                self._metrics.record_rejected()
            if _trace.enabled():
                _trace.event("request_shed", rid=rid,
                             attrs={"rows": n, "queue_rows": self._queue_rows})
            if rid is not None:
                # Never enqueued, so no handle: the summary lands here.
                now_ns = time.perf_counter_ns()
                self._request_log.append(rid, "shed", enqueue_ns=now_ns, complete_ns=now_ns,
                                         rows=n, weights_step=self._weights_step())
            raise RejectedError(
                f"queue at {self._queue_rows} rows; admitting {n} more would "
                f"exceed shed_above_rows={self.shed_above_rows}."
            )

    def _guard_check(self, n: int, rid: int, deadline_at: Optional[float]) -> None:
        """Predicted-miss admission after the static check, with the same
        empty-queue rule (caller holds the lock in async mode)."""
        guard = getattr(self, "_guard", None)
        if guard is None or not guard.enabled:
            return
        # Deferred: guardrails imports RejectedError from this module.
        from zookeeper_tpu_torch.serving.guardrails import PredictedMissError

        deadline_ms = ((deadline_at - time.perf_counter()) * 1e3
                       if deadline_at is not None else None)
        ok, predicted = guard.admit(queued_units=self._queue_rows, request_units=n,
                                    deadline_ms=deadline_ms)
        if ok:
            return
        if self._metrics is not None:
            self._metrics.record_rejected()
        if _trace.enabled():
            _trace.event("request_shed", rid=rid, attrs={
                "rows": n, "queue_rows": self._queue_rows, "reason": "predicted_miss",
                "predicted_ms": round(predicted, 3)})
        now_ns = time.perf_counter_ns()
        self._request_log.append(rid, "shed", enqueue_ns=now_ns, complete_ns=now_ns, rows=n,
                                 weights_step=self._weights_step(),
                                 detail=f"PredictedMissError predicted_ms={predicted:.1f}")
        raise PredictedMissError(
            f"predicted completion in {predicted:.1f}ms exceeds the {deadline_ms:.1f}ms "
            f"deadline with {self._queue_rows} rows queued: shed at admission rather than "
            "served late."
        )

    def _enqueue(self, req: PendingResult, x: np.ndarray, n: int) -> None:
        # The ordinal names the request in the chief's records.
        decided = self._led.mint(req)
        if decided is not None:
            self._fail_decided(req, decided)
            return
        self._queue.append((req, x, 0, n))
        object.__setattr__(self, "_queue_rows", self._queue_rows + n)
        if self._metrics is not None:
            self._metrics.record_queue_depth(self._queue_rows)
        if _trace.enabled():
            _trace.event("request_enqueue", rid=req.rid,
                         attrs={"rows": n, "queue_rows": self._queue_rows})

    def submit(self, x: Any, *, deadline_ms: Optional[float] = None) -> PendingResult:
        """Enqueue one request ``[n, *input_shape]``. An explicit
        ``deadline_ms=0`` is already expired (clock-free expiry for
        tests); ``None`` falls back to ``default_deadline_ms``."""
        self._require_bound()
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"request must have at least one row, got shape {x.shape}.")
        n = int(x.shape[0])
        if deadline_ms is not None and distributed.chief_led(self._engine):
            self._engage()  # every rank submits alike, so every rank engages here
        deadline_at = self._deadline_at(deadline_ms)
        # Minted before the shed check: every outcome has a rid.
        rid = next_rid()
        if self.synchronous:
            self._shed_check(n, rid)
            self._guard_check(n, rid, deadline_at)
            if self._queue and self._queue_rows + n > self.max_queue_rows:
                self.flush()  # backpressure: drain the backlog inline
            req = PendingResult(self, n, event=None, deadline_at=deadline_at, rid=rid)
            self._enqueue(req, x, n)
            return req
        req = PendingResult(self, n, event=threading.Event(), deadline_at=deadline_at, rid=rid)
        with self._cv:
            self._shed_check(n, rid)
            self._guard_check(n, rid, deadline_at)
            while (
                self._queue
                and self._queue_rows + n > self.max_queue_rows
                and not self._stop.is_set()
            ):
                self._cv.wait(0.01)  # backpressure: block the submitter
            self._enqueue(req, x, n)
            # Liveness is checked under the lock, after queueing: a crash
            # cleanup either ran already (a fresh worker starts here) or
            # runs after us and fails this request — never a hang.
            self._ensure_worker()
            self._cv.notify_all()
        return req

    # -- dispatch planning ----------------------------------------------

    def _expire_overdue(self) -> None:
        now = time.perf_counter()
        if not any(req.expired(now) for req, _, _, _ in self._queue):
            return
        kept, dropped = [], 0
        for entry in self._queue:
            req, _, lo, hi = entry
            if req.expired(now):
                dropped += hi - lo
                req._expire()
                if self._led.link is not None:
                    self._expired_unsent.append(req.ordinal)
            else:
                kept.append(entry)
        self._queue[:] = kept
        object.__setattr__(self, "_queue_rows", self._queue_rows - dropped)

    def _take_plan(self) -> List[Tuple[PendingResult, np.ndarray]]:
        """Pop up to ``engine.max_batch`` rows off the queue head (the last
        request taken may contribute only a prefix)."""
        self._expire_overdue()
        room = self._engine.max_batch
        plan: List[Tuple[PendingResult, np.ndarray]] = []
        taken = 0
        while self._queue and taken < room:
            req, x, lo, hi = self._queue[0]
            take = min(room - taken, hi - lo)
            plan.append((req, x[lo : lo + take]))
            req._taken = lo + take
            taken += take
            if lo + take == hi:
                self._queue.pop(0)
            else:
                self._queue[0] = (req, x, lo + take, hi)
        object.__setattr__(self, "_queue_rows", self._queue_rows - taken)
        return plan

    def _run_plan(self, plan: List[Tuple[PendingResult, np.ndarray]]) -> None:
        """One engine dispatch and ONE host readback for the micro-batch,
        then per-request slices delivered back out."""
        rows = sum(part.shape[0] for _, part in plan)
        if rows == 0:
            return
        traced = _trace.enabled()
        try:
            with _trace.span("serve_dispatch",
                             attrs={"rows": rows, "requests": len(plan)} if traced else None):
                t0 = time.perf_counter()
                t0_ns = time.perf_counter_ns()
                batch = plan[0][1] if len(plan) == 1 else np.concatenate(
                    [part for _, part in plan]
                )
                bucket = self._engine.bucket_for(rows)
                # Attributed before the device work: a crash mid-infer still
                # shows the request reached dispatch.
                for req, _ in plan:
                    if req._t_dispatch_ns is None:
                        req._t_dispatch_ns = t0_ns
                        req._bucket = bucket
                    if traced and req.rid is not None:
                        _trace.event("request_dispatch", rid=req.rid, attrs={"bucket": bucket})
                out = self._engine.infer(batch).cpu().numpy()
                dispatch_s = time.perf_counter() - t0
            # The readback above bounds the dispatch: the engine's watchdog
            # and MFU gauges take its wall time. A metrics failure must not
            # fail requests whose inference succeeded.
            observe = getattr(self._engine, "observe_dispatch", None)
            if observe is not None:
                try:
                    observe(rows, dispatch_s)
                except Exception:
                    logger.warning("observe_dispatch failed", exc_info=True)
            if self._metrics is not None:
                self._metrics.record_dispatch(rows, bucket)
            offset = 0
            for req, part in plan:
                k = part.shape[0]
                req._deliver(out[offset : offset + k])
                offset += k
        except Exception as e:
            # Rows already left the queue: fail every request of the plan
            # so no result() hangs (a no-op for delivered ones).
            for req, _ in plan:
                req._fail(e)
            raise

    def flush(self) -> None:
        """Serve every queued request (sync mode: THE dispatch path; async
        mode: wait until the worker drained the queue)."""
        self._require_bound()
        if self.synchronous:
            if self._led.link is not None:
                return self._flush_led()
            while self._queue:
                plan = self._take_plan()
                if plan:
                    self._run_plan(plan)
            return
        with self._cv:
            object.__setattr__(self, "_force_drain", True)
            self._cv.notify_all()
            try:
                while (self._queue or self._inflight) and not self._stop.is_set():
                    worker = self._worker
                    if worker is None or not worker.is_alive():
                        break  # the crash cleanup fails the queue
                    self._cv.wait(0.01)
            finally:
                object.__setattr__(self, "_force_drain", False)

    def _flush_led(self) -> None:
        """Synchronous ``flush()`` under chief-led dispatch: the chief plans
        and sends a record per dispatch, then an end record; a follower
        applies records until that end. Every rank flushes at the same
        point."""
        link = self._led.link
        if not link.is_chief:
            # Records until the end, even past a failed dispatch (the chief
            # sends its end record after one), then that failure.
            failures = []

            def apply(record):
                try:
                    self._run_plan(self._follow_record(record))
                except Exception as e:
                    failures.append(e)

            self._led.follow(apply, distributed.RECORD_END)
            if failures:
                raise failures[0]
            return
        try:
            while True:
                plan = self._take_plan() if self._queue else []
                if not plan and not self._expired_unsent and self._proposed_step is None:
                    break
                self._run_plan(self._lead(plan))
        finally:
            link.exchange([distributed.RECORD_END])

    # -- async worker ----------------------------------------------------

    def _ensure_worker(self) -> None:
        worker = self._worker
        if worker is None or not worker.is_alive():
            thread = threading.Thread(
                target=self._worker_loop, name="zk-microbatcher", daemon=True
            )
            object.__setattr__(self, "_worker", thread)
            thread.start()

    def _worker_loop(self) -> None:
        try:
            self._worker_body()
        except BaseException as e:
            self._on_worker_crash(e)

    def _worker_body(self) -> None:
        from zookeeper_tpu_torch.resilience import faults

        link = self._led.link
        if link is not None and not link.is_chief:
            return self._led.follow(self._apply_record, distributed.RECORD_STOP)
        max_batch = self._engine.max_batch
        delay_s = self.max_delay_ms / 1e3
        while not self._stop.is_set():
            with self._cv:
                # The chief also wakes for a proposed swap with nothing queued.
                while not self._queue and not self._stop.is_set() and (
                        link is None or self._proposed_step is None):
                    self._cv.wait(0.05)
                if self._stop.is_set():
                    break
                plan_fault = faults.active()
                if plan_fault is not None and plan_fault.take_worker_crash():
                    raise WorkerCrashedError(
                        "injected worker crash (FaultPlan.serving_worker_crash)"
                    )
                oldest = self._queue[0][0]._t_submit if self._queue else 0.0
                while (
                    self._queue
                    and self._queue_rows < max_batch
                    and not self._stop.is_set()
                    and not self._force_drain
                ):
                    remaining = oldest + delay_s - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                plan = self._take_plan()
                object.__setattr__(self, "_inflight", plan)
            if link is not None:
                plan = self._lead(plan)  # a broken link crashes the worker
            try:
                self._run_plan(plan)
            except Exception:
                pass  # the requests carry the error; the worker survives
            finally:
                with self._cv:
                    object.__setattr__(self, "_inflight", None)
                    self._cv.notify_all()
        if link is not None:
            link.exchange([distributed.RECORD_STOP])  # the followers' workers end

    def _on_worker_crash(self, error: BaseException) -> None:
        with self._cv:
            failed = [req for req, _ in (self._inflight or [])]
            failed += [req for req, _, _, _ in self._queue]
            link = self._led.link
            if isinstance(error, _ChiefCrashed):
                # A follower fails what the chief failed: the rest of its
                # queue stays, and what it has not received fails on arrival.
                named = self._led.crashed(error, [req.ordinal for req in failed])
                failed = [req for req in failed if req.ordinal in named]
                kept = [e for e in self._queue if e[0].ordinal not in named]
                self._queue[:] = kept
                object.__setattr__(self, "_queue_rows", sum(hi - lo for _, _, lo, hi in kept))
            elif link is not None and link.is_chief:
                self._led.send_crash([req.ordinal for req in failed])
            if not isinstance(error, _ChiefCrashed):
                del self._queue[:]
                object.__setattr__(self, "_queue_rows", 0)
            object.__setattr__(self, "_inflight", None)
            object.__setattr__(self, "_worker", None)
            _trace.event("worker_crash", attrs={"error": type(error).__name__,
                                                "failed_requests": len(failed)})
            if self._metrics is not None:
                self._metrics.record_worker_restart()
            wrapped = WorkerCrashedError(
                f"MicroBatcher worker crashed ({error!r}); resubmit to run on "
                "the restarted worker."
            )
            wrapped.__cause__ = error
            for req in failed:
                req._fail(wrapped)
            self._cv.notify_all()
        # After the fails (the bundle's RequestLog tail carries the
        # crashed summaries) and outside the lock (a bundle write must not
        # stall submitters).
        _recorder.notify("worker_crash", attrs={"error": type(error).__name__,
                                                "failed_requests": len(failed)})

    def close(self, drain: bool = False) -> None:
        """Stop the async worker. ``drain=True`` serves what is queued
        first; otherwise pending requests fail. Safe to call repeatedly."""
        if getattr(self, "_engine", None) is None:
            return
        if drain:
            try:
                self.flush()
            except Exception:
                pass  # per-request errors were delivered to the handles
        self._stop.set()
        worker = self._worker
        if worker is not None:
            with self._cv:
                self._cv.notify_all()
            worker.join(timeout=5)
            object.__setattr__(self, "_worker", None)
        err = RuntimeError("MicroBatcher closed with requests pending.")
        for req, _, _, _ in self._queue:
            req._fail(err)
        del self._queue[:]
        object.__setattr__(self, "_queue_rows", 0)
        self._stop.clear()
