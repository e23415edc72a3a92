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
result does not depend on how it was coalesced or split. In front of
an engine whose partitioner spans several ranks every rank runs its own
batcher before a collective engine, so only the synchronous mode without deadlines is
allowed (the async worker and deadlines decide by each rank's clock and
raise ``ValueError``).

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
device synchronisation. Not ported yet (ROADMAP.md): the overload
guard.
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
from zookeeper_tpu_torch.parallel.distributed import refuse_clock_driven

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
        Never blocks past the request's deadline."""
        if not self._done:
            if self._event is None:
                self._batcher.flush()
                if not self._done and self.expired():
                    self._expire()
            else:
                wait_s = timeout
                if self._deadline_at is not None:
                    remaining = self._deadline_at - time.perf_counter()
                    wait_s = remaining if timeout is None else min(timeout, remaining)
                if not self._event.wait(None if wait_s is None else max(0.0, wait_s)):
                    if self.expired():
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

    def bind(self, engine, metrics=None) -> "MicroBatcher":
        if self.max_queue_rows < 1:
            raise ValueError(f"max_queue_rows={self.max_queue_rows} must be >= 1.")
        if self.max_delay_ms < 0:
            raise ValueError(f"max_delay_ms={self.max_delay_ms} must be >= 0.")
        if self.shed_above_rows < 0 or self.default_deadline_ms < 0:
            raise ValueError(
                "shed_above_rows and default_deadline_ms must be >= 0 "
                "(0 disables)."
            )
        if not self.synchronous:
            refuse_clock_driven(engine, "MicroBatcher(synchronous=False)")
        if self.default_deadline_ms > 0:
            refuse_clock_driven(engine, "MicroBatcher.default_deadline_ms")
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_metrics", metrics)
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
        return self

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

    def _enqueue(self, req: PendingResult, x: np.ndarray, n: int) -> None:
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
        if deadline_ms is not None:
            refuse_clock_driven(self._engine, "a request deadline (deadline_ms)")
        deadline_at = self._deadline_at(deadline_ms)
        # Minted before the shed check: every outcome has a rid.
        rid = next_rid()
        if self.synchronous:
            self._shed_check(n, rid)
            if self._queue and self._queue_rows + n > self.max_queue_rows:
                self.flush()  # backpressure: drain the backlog inline
            req = PendingResult(self, n, event=None, deadline_at=deadline_at, rid=rid)
            self._enqueue(req, x, n)
            return req
        req = PendingResult(self, n, event=threading.Event(), deadline_at=deadline_at, rid=rid)
        with self._cv:
            self._shed_check(n, rid)
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

        max_batch = self._engine.max_batch
        delay_s = self.max_delay_ms / 1e3
        while not self._stop.is_set():
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(0.05)
                if self._stop.is_set():
                    break
                plan_fault = faults.active()
                if plan_fault is not None and plan_fault.take_worker_crash():
                    raise WorkerCrashedError(
                        "injected worker crash (FaultPlan.serving_worker_crash)"
                    )
                oldest = self._queue[0][0]._t_submit
                while (
                    self._queue_rows < max_batch
                    and not self._stop.is_set()
                    and not self._force_drain
                ):
                    remaining = oldest + delay_s - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                plan = self._take_plan()
                object.__setattr__(self, "_inflight", plan)
            try:
                self._run_plan(plan)
            except Exception:
                pass  # the requests carry the error; the worker survives
            finally:
                with self._cv:
                    object.__setattr__(self, "_inflight", None)
                    self._cv.notify_all()

    def _on_worker_crash(self, error: BaseException) -> None:
        with self._cv:
            failed = [req for req, _ in (self._inflight or [])]
            failed += [req for req, _, _, _ in self._queue]
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
