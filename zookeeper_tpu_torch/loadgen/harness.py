"""Trace replay against a live serving target, and its SLO report.

The port of ``zookeeper_tpu/loadgen/harness.py``. ``replay(trace,
target)`` drives every :class:`~zookeeper_tpu_torch.loadgen.traces.
TraceRequest` into the target, classifies each terminal outcome by the
serving errors (``PredictedMissError`` and ``RejectedError``: shed,
``DeadlineExpiredError``: deadline_expired, ``WorkerCrashedError``:
crashed, ``FleetUnavailableError``: unavailable, anything else: error)
and aggregates an :class:`SLOReport`: per-phase TTFT, latency and
inter-token percentiles over the admitted requests, goodput tokens/s,
the outcome counts, the retries read from the target's ``RequestLog``,
and the SLO violations (each also fired at the flight recorder).

Targets, by duck type:

- a stream scheduler (``submit`` + ``drain``, e.g. ``DecodeScheduler``):
  open loop, every request submitted in arrival order first (the queue
  the admission control must see builds up), then resolved;
- a ``MicroBatcher`` (``submit`` + ``flush``): open loop, the prompt as a
  ``[len(prompt), 1]`` float row block;
- a ``FleetRouter`` (a blocking ``submit`` returning a response):
  closed loop over a small thread pool;
- any callable, ``target(trace_request) -> (tokens, ttft_ms or None)``.

A ``fault_plan`` is installed for the replay and always cleared.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from zookeeper_tpu_torch.loadgen.traces import Trace, TraceRequest

__all__ = ["ReplayOutcome", "SLOReport", "replay"]


@dataclasses.dataclass
class ReplayOutcome:
    """One trace request's terminal result."""

    index: int
    rid: Optional[int]
    phase: str
    session: Optional[str]
    outcome: str  # ok | shed | deadline_expired | crashed | unavailable | error
    latency_ms: float
    ttft_ms: Optional[float] = None
    tokens: int = 0
    retried: int = 0
    error: Optional[str] = None


def _percentiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {}
    arr = np.asarray(values, np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p95": round(float(np.percentile(arr, 95)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
    }


@dataclasses.dataclass
class SLOReport:
    """The replay verdict: outcome counts, goodput, per-phase
    percentiles over admitted (ok) requests, violations."""

    trace: str
    seed: int
    wall_s: float
    outcomes: Dict[str, int]
    per_phase: Dict[str, Dict[str, Any]]
    goodput_tokens_per_sec: float
    ok_tokens: int
    retried_total: int
    violations: List[Dict[str, Any]]
    results: List[ReplayOutcome] = dataclasses.field(repr=False)

    @property
    def total(self) -> int:
        return sum(self.outcomes.values())

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready summary (everything but the raw per-request
        list)."""
        return {
            "trace": self.trace,
            "seed": self.seed,
            "wall_s": round(self.wall_s, 3),
            "requests": self.total,
            "outcomes": dict(self.outcomes),
            "per_phase": self.per_phase,
            "goodput_tokens_per_sec": round(
                self.goodput_tokens_per_sec, 3
            ),
            "ok_tokens": self.ok_tokens,
            "retried_total": self.retried_total,
            "violations": len(self.violations),
        }


# -- outcome classification ----------------------------------------------


def _classify(error: Optional[BaseException]) -> str:
    from zookeeper_tpu_torch.serving.batcher import (
        DeadlineExpiredError,
        RejectedError,
        WorkerCrashedError,
    )
    from zookeeper_tpu_torch.serving.fleet import FleetUnavailableError

    if error is None:
        return "ok"
    if isinstance(error, RejectedError):  # PredictedMissError included
        return "shed"
    if isinstance(error, DeadlineExpiredError):
        return "deadline_expired"
    if isinstance(error, WorkerCrashedError):
        return "crashed"
    if isinstance(error, FleetUnavailableError):
        return "unavailable"
    return "error"


def _retried_from_log(target: Any, rid: Optional[int]) -> int:
    """``retried=N`` parsed out of the target RequestLog's detail
    field — the rid-preserving retry counter the router records."""
    log = getattr(target, "request_log", None)
    if log is None or rid is None:
        return 0
    find = getattr(log, "find", None)
    rec = find(rid) if find is not None else None
    detail = (rec or {}).get("detail") or ""
    for part in str(detail).split():
        if part.startswith("retried="):
            try:
                return int(part.split("=", 1)[1])
            except ValueError:
                return 0
    return 0


# -- target adapters -----------------------------------------------------


def _is_router(target: Any) -> bool:
    return hasattr(target, "replicas") and hasattr(target, "submit")


def _is_stream_scheduler(target: Any) -> bool:
    return hasattr(target, "submit") and hasattr(target, "drain")


def _is_batcher(target: Any) -> bool:
    return hasattr(target, "submit") and hasattr(target, "flush")


def _open_loop_submit(
    target: Any, req: TraceRequest
) -> Tuple[Optional[int], Callable[[], Tuple[int, Optional[float]]]]:
    """Enqueue one request on a non-blocking target; returns ``(rid,
    resolve)`` where ``resolve()`` blocks for ``(tokens, ttft_ms)``."""
    if _is_stream_scheduler(target):
        stream = target.submit(
            np.asarray(req.prompt, np.int32),
            max_new_tokens=req.max_new_tokens,
            deadline_ms=req.deadline_ms,
        )
        return stream.rid, lambda: (
            int(stream.result().shape[0]),
            stream.ttft_ms,
        )
    if _is_batcher(target):
        pending = target.submit(
            np.asarray(req.prompt, np.float32)[:, None],
            deadline_ms=req.deadline_ms,
        )
        return pending.rid, lambda: (
            int(np.asarray(pending.result()).shape[0]),
            None,
        )
    raise TypeError(
        f"cannot open-loop replay against {type(target).__name__}: "
        "expected a stream scheduler (submit+drain), a batcher "
        "(submit+flush), a FleetRouter, or a callable."
    )


# -- the replay ----------------------------------------------------------


def replay(
    trace: Trace,
    target: Any,
    *,
    fault_plan: Any = None,
    mode: str = "auto",
    concurrency: int = 8,
    time_scale: float = 0.0,
    slo_ttft_ms: Optional[float] = None,
    slo_latency_ms: Optional[float] = None,
) -> SLOReport:
    """Replay ``trace`` against ``target`` and report.

    ``time_scale`` maps trace arrival offsets onto real time: 1.0
    replays at recorded speed, 0.0 (the deterministic default) submits
    as fast as the target admits — arrival ORDER is what matters to
    admission control, and the queue the open-loop burst builds is the
    overload under test. ``mode`` is ``auto`` (sniff the target),
    ``open_loop`` (submit everything, then resolve) or ``threaded``
    (closed-loop pool for blocking targets). ``fault_plan`` installs a
    chaos plan for the duration of the replay. SLO thresholds, when
    given, turn slow ADMITTED requests into violations (each also
    fired at the flight recorder, so a violating run leaves a
    bundle)."""
    from zookeeper_tpu_torch.observability import recorder as _recorder
    from zookeeper_tpu_torch.resilience import faults

    # Pre-warm the classification imports BEFORE the clock starts —
    # the first _classify call would otherwise charge the serving
    # import chain to one request's measured latency.
    _classify(None)

    if mode == "auto":
        mode = "threaded" if _is_router(target) or callable(target) else (
            "open_loop"
        )
    if mode not in ("open_loop", "threaded"):
        raise ValueError(
            f"mode={mode!r} unknown; choose auto/open_loop/threaded."
        )
    if concurrency < 1:
        raise ValueError(f"concurrency={concurrency} must be >= 1.")

    results: List[Optional[ReplayOutcome]] = [None] * len(trace.requests)
    if fault_plan is not None:
        faults.install(fault_plan)
    t_start = time.perf_counter()
    try:
        if mode == "open_loop":
            _replay_open_loop(trace, target, results, time_scale, t_start)
        else:
            _replay_threaded(
                trace, target, results, time_scale, t_start, concurrency
            )
    finally:
        if fault_plan is not None:
            faults.clear()
    wall_s = max(time.perf_counter() - t_start, 1e-9)

    # Retries come from the target's RequestLog detail, not the
    # exception path — a retried-then-ok request raises nothing.
    for out in results:
        if out is not None and out.retried == 0:
            out.retried = _retried_from_log(target, out.rid)

    outcomes: Dict[str, int] = {}
    ok_tokens = 0
    retried_total = 0
    violations: List[Dict[str, Any]] = []
    per_phase: Dict[str, Dict[str, Any]] = {}
    final = [o for o in results if o is not None]
    for out in final:
        outcomes[out.outcome] = outcomes.get(out.outcome, 0) + 1
        retried_total += out.retried
        if out.outcome == "ok":
            ok_tokens += out.tokens
            breached = []
            if (
                slo_ttft_ms is not None
                and out.ttft_ms is not None
                and out.ttft_ms > slo_ttft_ms
            ):
                breached.append(f"ttft_ms={out.ttft_ms:.1f}")
            if (
                slo_latency_ms is not None
                and out.latency_ms > slo_latency_ms
            ):
                breached.append(f"latency_ms={out.latency_ms:.1f}")
            if breached:
                v = {
                    "index": out.index,
                    "rid": out.rid,
                    "phase": out.phase,
                    "breached": breached,
                }
                violations.append(v)
                _recorder.notify("slo_violation", attrs=v)
    for phase in trace.phases():
        ph = [o for o in final if o.phase == phase]
        ok = [o for o in ph if o.outcome == "ok"]
        per_phase[phase] = {
            "requests": len(ph),
            "ok": len(ok),
            "latency_ms": _percentiles([o.latency_ms for o in ok]),
            "ttft_ms": _percentiles(
                [o.ttft_ms for o in ok if o.ttft_ms is not None]
            ),
            # Per-request mean inter-token gap ((latency - TTFT) /
            # (tokens - 1)), the interference tail chunked prefill
            # flattens; single-token streams have no gap.
            "itl_ms": _percentiles([
                (o.latency_ms - o.ttft_ms) / (o.tokens - 1)
                for o in ok
                if o.ttft_ms is not None and o.tokens > 1
            ]),
        }
    return SLOReport(
        trace=trace.name,
        seed=trace.seed,
        wall_s=wall_s,
        outcomes=outcomes,
        per_phase=per_phase,
        goodput_tokens_per_sec=ok_tokens / wall_s,
        ok_tokens=ok_tokens,
        retried_total=retried_total,
        violations=violations,
        results=final,
    )


def _pace(req: TraceRequest, time_scale: float, t_start: float) -> None:
    if time_scale <= 0:
        return
    due = t_start + req.at_ms * time_scale / 1e3
    delay = due - time.perf_counter()
    if delay > 0:
        time.sleep(delay)


def _replay_open_loop(
    trace: Trace,
    target: Any,
    results: List[Optional[ReplayOutcome]],
    time_scale: float,
    t_start: float,
) -> None:
    """Submit every request in arrival order (building the queue the
    admission control sees), then resolve in order."""
    handles: List[Tuple[int, Optional[int], float, Any]] = []
    for i, req in enumerate(trace.requests):
        _pace(req, time_scale, t_start)
        t0 = time.perf_counter()
        try:
            rid, resolve = _open_loop_submit(target, req)
        except BaseException as e:  # admission-time terminal outcome
            results[i] = ReplayOutcome(
                index=req.index,
                rid=None,
                phase=req.phase,
                session=req.session,
                outcome=_classify(e),
                latency_ms=(time.perf_counter() - t0) * 1e3,
                error=type(e).__name__,
            )
            continue
        handles.append((i, rid, t0, resolve))
    for i, rid, t0, resolve in handles:
        req = trace.requests[i]
        error: Optional[BaseException] = None
        tokens, ttft = 0, None
        try:
            tokens, ttft = resolve()
        except BaseException as e:
            error = e
        results[i] = ReplayOutcome(
            index=req.index,
            rid=rid,
            phase=req.phase,
            session=req.session,
            outcome=_classify(error),
            latency_ms=(time.perf_counter() - t0) * 1e3,
            ttft_ms=ttft,
            tokens=tokens,
            error=type(error).__name__ if error is not None else None,
        )


def _replay_threaded(
    trace: Trace,
    target: Any,
    results: List[Optional[ReplayOutcome]],
    time_scale: float,
    t_start: float,
    concurrency: int,
) -> None:
    """Closed-loop replay for BLOCKING targets (FleetRouter, callables):
    a small pool pulls requests in arrival order; each worker blocks
    for its request's full generation."""
    lock = threading.Lock()
    cursor = [0]

    def submit_one(req: TraceRequest) -> ReplayOutcome:
        _pace(req, time_scale, t_start)
        t0 = time.perf_counter()
        error: Optional[BaseException] = None
        rid, tokens, ttft, retried = None, 0, None, 0
        try:
            if callable(target) and not _is_router(target):
                tokens, ttft = target(req)
                tokens = int(tokens)
            else:
                resp = target.submit(
                    np.asarray(req.prompt, np.int32),
                    session=req.session,
                    max_new_tokens=req.max_new_tokens,
                )
                rid = resp.rid
                tokens = int(np.asarray(resp.tokens).shape[0])
                ttft = resp.ttft_ms
        except BaseException as e:
            error = e
        return ReplayOutcome(
            index=req.index,
            rid=rid,
            phase=req.phase,
            session=req.session,
            outcome=_classify(error),
            latency_ms=(time.perf_counter() - t0) * 1e3,
            ttft_ms=ttft,
            tokens=tokens,
            retried=retried,
            error=type(error).__name__ if error is not None else None,
        )

    def worker() -> None:
        while True:
            with lock:
                i = cursor[0]
                if i >= len(trace.requests):
                    return
                cursor[0] = i + 1
            results[i] = submit_one(trace.requests[i])

    threads = [
        threading.Thread(target=worker, name=f"loadgen-{k}", daemon=True)
        for k in range(min(concurrency, max(1, len(trace.requests))))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
