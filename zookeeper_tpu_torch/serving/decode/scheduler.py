"""Slot-refill continuous batching: the host loop over the decode engine.

The port of ``zookeeper_tpu/serving/decode/scheduler.py``'s
``DecodeScheduler`` and ``DecodeStream``. A sequence occupies a KV slot
across many dispatches, so the scheduling unit is the slot:

1. **Admit**: free slots are refilled from the FIFO queue; a group of
   queued prompts rides one bucketed prefill, which writes their K/V and
   emits each request's first token (TTFT). A finished sequence's slot
   is refilled without draining anything. In the paged layout with the
   radix prefix cache, a prompt whose prefix is cached shares its pages
   (copy-on-write at a mid-page divergence) and runs only its suffix
   (``prefill_warm``); every admitted prompt's pages are then cached.
2. **Decode**: one decode step advances every active slot one token.
   With a bound :class:`SpeculativeDecoding` the two-model window runs
   instead: the draft proposes ``k`` tokens per slot (a width-2 catch-up
   verify and ``k - 1`` draft steps), one teacher ``verify`` scores all
   ``k + 1`` positions, and greedy acceptance commits the longest
   matching prefix plus the teacher's token at the first mismatch: 1 to
   ``k + 1`` tokens per slot, rolled back by length. An iteration where
   a slot is within a window of its token limit runs the plain step (the
   draft catching up by its width-2 verify), so the tokens are plain
   greedy decode's.
3. **Chunks** (the engine's ``prefill_chunk_tokens`` > 0): admission
   allocates pages but dispatches nothing; each iteration spends its
   ``token_budget`` first on decode (one token a slot, a window ``k +
   1``), then on pending prompt chunks, so a long prompt no longer
   stalls the streams in flight. TTFT lands with a prompt's last chunk.
4. **Finish**: EOS, the request's ``max_new_tokens``, the engine's
   token limit, or a deadline ends a stream and frees its slot.

``shed_above`` sheds with ``RejectedError`` before enqueueing; deadlines
fail a stream with ``DeadlineExpiredError`` when queued, mid-stream or in
``result()``; a crash of the loop fails every queued and in-flight
stream with ``WorkerCrashedError`` and the next ``submit()`` restarts
it. In the paged layout an admission the pool cannot serve waits at the
queue head for pages, or is shed when nothing is in flight to free any.
``synchronous=True`` (the default) is thread- and clock-free: the caller
drives with ``drain()``/``result()``; otherwise one ``zk-decode-
scheduler`` daemon thread runs the loop.

**Chief-led dispatch.** In front of an engine whose partitioner spans
several ranks each rank runs its own scheduler, and every dispatch is a
collective. The synchronous mode without deadlines keeps the ranks in
step by itself; the threaded mode and deadlines would decide by each
rank's clock, so there rank 0 leads (``parallel.distributed.
ChiefLink``): each iteration starts with its record, the admission
cutoff (the streams submitted so far, by submission ordinal, which may
be admitted), the queued and active streams it expired, and the staged
swaps it has seen. Every rank applies the record, then runs the same
deterministic iteration: the same admissions into the same slots, the
same retirements, the swap at the same boundary. A follower never
consults its own clock; one that lacks a stream below the cutoff after a
bounded wait fails those streams on every rank (``ChiefLedError``).
Every rank must submit the same streams, and stage the same swaps, in
the same order. ``shed_above`` and the overload guard decide at submit
by one rank's queue and are refused there.

Weight swaps go through :meth:`request_swap`, which keeps one weight
version per sequence (a stream spans many dispatches, so the engine's
``swap_weights`` alone cannot): the swap is validated at the call, held
pending while admission pauses and the slot array drains, and applied
at the first boundary with no stream in flight, with the prefix cache
invalidated (its pages hold the old weights' K/V). Every stream runs
wholly on the weights it started with. Under speculation only the
teacher is swapped, never the draft: a stale draft lowers acceptance,
never correctness. ``FaultPlan.decode_worker_crash`` crashes the loop
at the top of an iteration (the crash path above).

Observability (``observability``): each stream gets a rid at
``submit()`` (before the shed check) and one terminal summary in the
scheduler's ``RequestLog("decode")`` (``request_log``: outcome, tokens,
slot, the live weights' step; an ok stream's finish reason, and under
speculation its accepted/proposed drafts, in ``detail``). With tracing on, the
rid-tagged ``decode_request_enqueue`` / ``decode_request_shed`` /
``decode_request_dispatch`` / ``decode_stream_finish`` /
``decode_stream_fail`` (a deadline expiry, a crash, a shed) and
``spec_accept`` events draw each stream's flow, the speculative window
runs in ``spec_draft`` and ``spec_verify`` spans beside the engine's
dispatch spans (a chunk is a ``prefill_chunk_dispatch``), and a staged
swap and a crash are ``decode_weight_swap`` and ``decode_worker_crash``
events. A loop crash notifies the flight recorder, outside the lock,
after the victims are failed. ``submit(rid=...)`` adopts a rid minted
elsewhere (the fleet router's), so one request reads the same in the
router's log and the worker's.

The overload guard (``serving.guardrails.OverloadGuard``, bound with
``bind(..., guard=...)``) sheds at submit with ``PredictedMissError``
when its EWMA estimate of the tokens still owed by the queue (plus, under
chunked prefill, the prompt chunks still owed, queued and mid-prefill)
says the stream would miss its deadline; each ok stream feeds it its
dispatch-to-completion time per token and its queue wait. Its brown-out
is applied only at the boundary with no stream in flight (the swap's):
while applied, newly admitted streams get ``brownout_max_new_tokens`` at
most and the speculative window is skipped (the draft keeps up through
its width-2 verify, so speculation resumes cleanly on release). The
``guardrails`` section of ``status()`` shows both the guard and the
applied posture.
"""

import logging
import threading
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.requests import RequestLog, next_rid
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.serving.batcher import (
    DeadlineExpiredError,
    RejectedError,
    WorkerCrashedError,
    _ChiefCrashed,
    outcome_of,
)

__all__ = ["DecodeScheduler", "DecodeStream"]

logger = logging.getLogger(__name__)


class DecodeStream:
    """Handle for one generation request: tokens stream in as the
    scheduler produces them; ``result()`` gives the generated array.
    Iterating yields tokens as they arrive (and, in synchronous mode,
    drives the scheduler)."""

    def __init__(self, scheduler: "DecodeScheduler", prompt: np.ndarray,
                 max_new_tokens: int, deadline_at: Optional[float],
                 eos_token: Optional[int], rid: Optional[int] = None) -> None:
        self._scheduler = scheduler
        self.prompt = prompt
        self._max_new = int(max_new_tokens)
        self._deadline_at = deadline_at
        self._eos = eos_token
        self._tokens: List[int] = []
        self._done = False
        self._error: Optional[BaseException] = None
        self._finish_reason: Optional[str] = None
        self._t_submit = time.perf_counter()
        #: Submit-to-first-token milliseconds (None until it lands).
        self.ttft_ms: Optional[float] = None
        self._shared_tokens = 0
        # Drafts proposed and accepted for this stream (speculation).
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._slot: Optional[int] = None
        #: The request id minted at submit (its trace records and its
        #: RequestLog summary carry it).
        self.rid = rid
        self._t_dispatch_ns: Optional[int] = None
        # The serving role that last dispatched it ("" until admission).
        self._role = ""
        self._cond = threading.Condition()
        # The submission ordinal: names the stream in chief-led records.
        self.ordinal: Optional[int] = None

    @property
    def done(self) -> bool:
        return self._done

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def finish_reason(self) -> Optional[str]:
        """"eos", "length" (max_new_tokens) or "capacity" (the token
        limit); None while streaming or on failure."""
        return self._finish_reason

    @property
    def shared_tokens(self) -> int:
        """Prompt tokens whose K/V came warm from the radix prefix cache
        at admission (0: a cold admission, or the slot layout)."""
        return self._shared_tokens

    @property
    def tokens_so_far(self) -> np.ndarray:
        with self._cond:
            return np.asarray(self._tokens, np.int32)

    def expired(self, now: Optional[float] = None) -> bool:
        if self._deadline_at is None:
            return False
        return (time.perf_counter() if now is None else now) >= self._deadline_at

    def _deliver(self, token: int) -> None:
        with self._cond:
            if self._done:
                return
            self._tokens.append(int(token))
            self._cond.notify_all()

    def _finish(self, reason: str) -> None:
        with self._cond:
            if self._done:
                return
            self._done = True
            self._finish_reason = reason
            self._cond.notify_all()
        # Outside the condition; the first transition wins above, so one
        # terminal summary per stream.
        detail = reason
        if self._spec_proposed:
            detail = f"{reason} spec={self._spec_accepted}/{self._spec_proposed}"
        self._scheduler._log_terminal(self, "ok", detail=detail)

    def _fail(self, error: BaseException) -> bool:
        with self._cond:
            if self._done:
                return False
            self._done = True
            self._error = error
            self._cond.notify_all()
        self._scheduler._log_terminal(self, outcome_of(error), detail=type(error).__name__)
        return True

    def _expire(self) -> bool:
        waited_ms = (time.perf_counter() - self._t_submit) * 1e3
        return self._fail(DeadlineExpiredError(
            f"generation deadline expired after {waited_ms:.1f}ms "
            f"({len(self._tokens)} of {self._max_new} tokens generated; partial "
            "output in tokens_so_far)"
        ))

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The generated tokens. Synchronous mode drives the scheduler to
        completion; async mode blocks, never past the deadline."""
        if not self._done:
            self._scheduler._drive(self, timeout)
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int32)

    def __iter__(self):
        served = 0
        while True:
            with self._cond:
                available = len(self._tokens)
            while served < available:
                yield self._tokens[served]
                served += 1
            if self._done:
                if self._error is not None:
                    raise self._error
                with self._cond:
                    remaining = self._tokens[served:]
                yield from remaining
                return
            self._scheduler._advance(self)


@component
class DecodeScheduler:
    """Continuous-batching scheduler over a ``DecodeEngine``."""

    #: Default generation budget per request (``submit`` overrides).
    max_new_tokens: int = Field(32)
    #: Default per-request deadline in ms (0 = none).
    default_deadline_ms: float = Field(0.0)
    #: Load shedding past this many queued requests (0 = off).
    shed_above: int = Field(0)
    #: Backpressure bound on the wait queue (requests).
    max_queue: int = Field(4096)
    #: End-of-sequence token (-1 = none); generation stops with it
    #: delivered.
    eos_token: int = Field(-1)
    #: Thread-free mode: the caller drives via drain()/result().
    synchronous: bool = Field(True)
    #: Tokens one iteration may spend under chunked prefill: decode first
    #: (a token a slot, a speculative window ``k + 1``), then prompt
    #: chunks. 0 sizes it to ``slots x window + prefill_chunk_tokens``
    #: (every slot decoding plus one whole chunk); a smaller budget
    #: squeezes prefill harder, down to one token an iteration.
    token_budget: int = Field(0)

    def bind(self, engine, metrics=None, speculative=None, guard=None,
             request_log: Optional[RequestLog] = None) -> "DecodeScheduler":
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} must be >= 1 (prefill "
                "always emits one token)."
            )
        if self.shed_above < 0 or self.default_deadline_ms < 0:
            raise ValueError(
                f"shed_above={self.shed_above} and default_deadline_ms="
                f"{self.default_deadline_ms} must be >= 0 (0 disables)."
            )
        if self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1.")
        if self.token_budget < 0:
            raise ValueError(
                f"token_budget={self.token_budget} must be >= 0 (0 sizes the "
                "chunked-prefill budget automatically)."
            )
        if speculative is not None:
            speculative._require_bound()
            if speculative.engine is not engine:
                raise ValueError(
                    "the speculative binding mirrors another teacher engine; bind the "
                    "scheduler and the speculative config to the same DecodeEngine."
                )
        engine._require_bound()
        n = int(engine.slots)
        set_ = lambda name, value: object.__setattr__(self, name, value)  # noqa: E731
        set_("_engine", engine)
        set_("_metrics", metrics)
        set_("_request_log", request_log if request_log is not None else RequestLog("decode"))
        set_("_queue", deque())
        set_("_slot_stream", [None] * n)
        set_("_slot_lengths", np.zeros(n, np.int64))
        set_("_slot_tokens", np.zeros(n, np.int32))
        set_("_speculative", speculative)
        # The overload guard (None: off) and the brown-out posture applied
        # at the drain boundary, which may lag the guard's intent.
        set_("_guard", guard)
        set_("_brownout_active", False)
        # The draft cache's rows per slot, and the (at most one) committed
        # token it has not consumed yet (after a fully accepted window).
        set_("_draft_lengths", np.zeros(n, np.int64))
        set_("_draft_pending", [[] for _ in range(n)])
        # Chunked prefill: slot -> {"pos": the next uncommitted prompt
        # offset, "admit_t": admission time} while a prompt is mid-prefill;
        # such a slot holds pages and a stream but does not decode.
        set_("_chunked", bool(engine.paged) and int(engine.prefill_chunk_tokens) > 0)
        set_("_chunk_state", {})
        set_("_slot_last_emit", np.zeros(n, np.float64))
        # _lock guards the bookkeeping; _step_lock serializes iterations
        # so _lock is released across the device dispatches.
        set_("_lock", threading.RLock())
        set_("_step_lock", threading.Lock())
        set_("_cv", threading.Condition())
        set_("_worker", None)
        set_("_stop", threading.Event())
        set_("_swap_pending", None)
        # Chief-led dispatch (see the module docstring): the ordinals and
        # the link, the staged swaps and how many of them records made
        # pending.
        set_("_led", distributed.ChiefLed("stream", _ChiefCrashed))
        set_("_swaps_staged", [])
        set_("_swaps_sent", 0)
        if distributed.chief_led(engine) and (not self.synchronous
                                              or self.default_deadline_ms > 0):
            self._engage()
        return self

    # -- chief-led dispatch ------------------------------------------------

    def _engage(self) -> None:
        """Make the link (every rank at the same point) and, threaded,
        start every rank's loop, so a chief's record always has a
        receiver."""
        refused = [name for name, on in (("shed_above", self.shed_above > 0),
                                         ("the overload guard", self._guard is not None)) if on]
        if self._led.engage(refused) and not self.synchronous:
            self._ensure_worker()

    def _enqueue(self, stream: DecodeStream) -> None:
        """Append ``stream`` with its ordinal (a follower fails one the
        chief already decided). Caller holds ``_lock``."""
        decided = self._led.mint(stream)
        if decided is not None:
            self._fail_decided(stream, decided)
        else:
            self._queue.append(stream)

    def _fail_decided(self, stream: DecodeStream, error: BaseException) -> None:
        if isinstance(error, DeadlineExpiredError):
            if stream._expire() and self._metrics is not None:
                self._metrics.record_deadline_expired()
        else:
            stream._fail(error)

    def _iteration_record(self, record: Optional[list]) -> int:
        """The record that opens an iteration: the chief makes and sends
        it (``record`` None), a follower passes the one it received and
        waits a bounded time for what it names. Both agree, then apply it.
        Returns the admission cutoff. Caller holds ``_step_lock``."""
        led = self._led
        if led.link.is_chief:
            with self._lock:
                now = time.perf_counter()
                queued = [s.ordinal for s in self._queue if s.expired(now)]
                active = [s.ordinal for s in self._slot_stream
                          if s is not None and s.expired(now)]
                record = [distributed.RECORD_STEP, led.next_ordinal, len(self._swaps_staged),
                          len(queued), *queued, len(active), *active]
            led.link.exchange(record)
        it = iter(record[1:])
        cutoff, swaps = next(it), next(it)
        queued = [next(it) for _ in range(next(it))]
        active = set(next(it) for _ in range(next(it)))
        t_end = time.perf_counter() + distributed.FOLLOWER_WAIT_S
        with self._cv:
            have = led.wait(self._cv, lambda: led.next_ordinal >= cutoff
                            and len(self._swaps_staged) >= swaps, t_end)
        ok = led.link.agree(have)
        with self._lock:
            if not ok:
                error = led.lost_error(f"every stream below #{cutoff}",
                                       "iteration admitting them")
                kept = deque()
                for stream in self._queue:
                    if stream.ordinal < cutoff:
                        stream._fail(error)
                    else:
                        kept.append(stream)
                object.__setattr__(self, "_queue", kept)
                for ordinal in range(led.next_ordinal, cutoff):
                    led.decide(ordinal, error)
            for ordinal in queued:
                stream = next((s for s in self._queue if s.ordinal == ordinal), None)
                if stream is None:
                    led.decide(ordinal, DeadlineExpiredError(
                        "generation deadline expired (the chief rank's decision)"))
                    continue
                self._queue.remove(stream)
                self._fail_decided(stream, DeadlineExpiredError(
                    "generation deadline expired (the chief rank's decision)"))
            for slot, stream in enumerate(self._slot_stream):
                if stream is not None and stream.ordinal in active:
                    self._fail_decided(stream, DeadlineExpiredError(
                        "generation deadline expired (the chief rank's decision)"))
                    self._free_slot(slot)
            if ok and swaps > self._swaps_sent:
                object.__setattr__(self, "_swap_pending", self._swaps_staged[swaps - 1])
                object.__setattr__(self, "_swaps_sent", swaps)
        return cutoff

    def _run_led(self, pump_once: bool = False, until=None) -> None:
        """A synchronous entry point under chief-led dispatch: the chief
        runs its iterations (until ``until()`` or the work runs out; one
        for ``pump_once``) and then sends an end record; a follower runs
        the chief's records until that end. A crash on the chief reaches
        the followers as its crash record. Every rank calls the same
        entry points in the same order."""
        link = self._led.link
        if not link.is_chief:
            try:
                self._led.follow(self._pump, distributed.RECORD_END)
            except _ChiefCrashed as error:
                self._on_crash(error)
                raise
            return
        # A crash inside sends the crash record instead of the end record.
        while self._has_work() or self._swaps_unsent():
            if until is not None and until():
                break
            self._pump()
            if pump_once:
                break
        link.exchange([distributed.RECORD_END])

    def _swaps_unsent(self) -> bool:
        return self._led.link is not None and len(self._swaps_staged) > self._swaps_sent

    def _require_bound(self) -> None:
        if getattr(self, "_engine", None) is None:
            raise RuntimeError(
                "DecodeScheduler is not bound: call scheduler.bind(engine) "
                "before submit()."
            )

    @property
    def request_log(self) -> Optional[RequestLog]:
        """This scheduler's terminal-request ring (None before bind)."""
        return getattr(self, "_request_log", None)

    def _log_terminal(self, stream: DecodeStream, outcome: str, detail: Optional[str]) -> None:
        """One summary per terminal stream (its first-wins finish or fail
        calls this)."""
        log = getattr(self, "_request_log", None)
        if log is None or stream.rid is None:
            return
        if outcome != "ok" and _trace.enabled():
            # An ok stream's terminus is its decode_stream_finish event.
            _trace.event("decode_stream_fail", rid=stream.rid,
                         attrs={"outcome": outcome, "detail": detail})
        complete_ns = time.perf_counter_ns()
        log.append(
            stream.rid, outcome, enqueue_ns=int(stream._t_submit * 1e9),
            dispatch_ns=stream._t_dispatch_ns, complete_ns=complete_ns,
            tokens=len(stream._tokens), slot=stream._slot,
            weights_step=self._metrics.weights_step if self._metrics is not None else None,
            detail=detail, role=stream._role or None)
        guard = getattr(self, "_guard", None)
        if (guard is not None and guard.enabled and outcome == "ok"
                and stream._t_dispatch_ns is not None):
            # Successes only: a failure's timings describe the failure.
            dispatch_ns = stream._t_dispatch_ns
            guard.observe_service((complete_ns - dispatch_ns) / 1e6, max(1, len(stream._tokens)))
            guard.observe_wait((dispatch_ns - stream._t_submit * 1e9) / 1e6)

    # -- submission ------------------------------------------------------

    def _deadline_at(self, deadline_ms: Optional[float]) -> Optional[float]:
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms or None
        if deadline_ms is None:
            return None
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms={deadline_ms} must be >= 0.")
        return time.perf_counter() + deadline_ms / 1e3

    def submit(self, prompt: Any, *, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               eos_token: Optional[int] = None,
               rid: Optional[int] = None) -> DecodeStream:
        """Enqueue one prompt (1-D int tokens); returns its
        :class:`DecodeStream`. An explicit ``deadline_ms=0`` is already
        expired. Raises ``RejectedError`` past the shed threshold (a
        ``PredictedMissError`` from the guard). ``rid`` adopts a request id
        minted elsewhere (the fleet router's); None mints one here."""
        self._require_bound()
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(
                f"prompt must be a non-empty 1-D int token array, got shape "
                f"{prompt.shape}."
            )
        engine = self._engine
        if prompt.shape[0] > engine.max_prompt:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens exceeds the largest seq "
                f"bucket {engine.max_prompt}; widen engine.seq_buckets."
            )
        if prompt.shape[0] >= engine.token_limit:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens leaves no room to generate "
                f"within token_limit={engine.token_limit}."
            )
        if deadline_ms is not None and distributed.chief_led(engine):
            self._engage()  # every rank submits alike, so every rank engages here
        new = int(max_new_tokens if max_new_tokens is not None else self.max_new_tokens)
        if new < 1:
            raise ValueError(f"max_new_tokens={new} must be >= 1.")
        eos = eos_token if eos_token is not None else (
            int(self.eos_token) if int(self.eos_token) >= 0 else None
        )
        # Minted before admission control: a shed stream is traceable too.
        rid = next_rid() if rid is None else int(rid)
        stream = DecodeStream(self, prompt, new, self._deadline_at(deadline_ms), eos, rid=rid)
        with self._lock:
            if self.shed_above > 0 and self._queue and len(self._queue) + 1 > self.shed_above:
                if self._metrics is not None:
                    self._metrics.record_rejected()
                if _trace.enabled():
                    _trace.event("decode_request_shed", rid=rid,
                                 attrs={"queue_depth": len(self._queue)})
                self._log_terminal(stream, "shed", detail="RejectedError")
                raise RejectedError(
                    f"decode queue at {len(self._queue)} requests; admitting one "
                    f"more would exceed shed_above={self.shed_above} — request "
                    "shed (service overloaded, retry with backoff)."
                )
            self._guard_check(stream, new)
            backpressure = len(self._queue) + 1 > self.max_queue
            if not backpressure:
                self._enqueue(stream)
                if _trace.enabled():
                    _trace.event("decode_request_enqueue", rid=rid, attrs={
                        "prompt_tokens": int(prompt.shape[0]),
                        "queue_depth": len(self._queue)})
        if backpressure:
            if self.synchronous:
                self.drain()
                with self._lock:
                    self._enqueue(stream)
            else:
                while True:
                    with self._lock:
                        if len(self._queue) + 1 <= self.max_queue:
                            self._enqueue(stream)
                            break
                    if self._stop.is_set():
                        raise RuntimeError(
                            "DecodeScheduler closed while submit was blocked on "
                            "backpressure."
                        )
                    with self._cv:
                        self._cv.wait(0.01)
        if not self.synchronous:
            self._ensure_worker()
            with self._cv:
                self._cv.notify_all()
        elif self._led.link is not None:
            with self._cv:
                self._cv.notify_all()
        return stream

    def _guard_check(self, stream: DecodeStream, new: int) -> None:
        """Predicted-miss admission: queued work is the tokens each queued
        stream may still ask for plus its prompt chunks owed, and the
        chunks owed by the slots mid-prefill. Caller holds the lock."""
        guard = getattr(self, "_guard", None)
        if guard is None or not guard.enabled:
            return
        # Imported here, as the batcher imports it (guardrails imports the batcher).
        from zookeeper_tpu_torch.serving.guardrails import PredictedMissError

        deadline_ms = ((stream._deadline_at - time.perf_counter()) * 1e3
                       if stream._deadline_at is not None else None)
        queued = sum(s._max_new + self._chunk_units(int(s.prompt.shape[0]))
                     for s in self._queue)
        if self._chunked:
            for slot, st in self._chunk_state.items():
                s = self._slot_stream[slot]
                if s is not None:
                    queued += self._chunk_units(int(s.prompt.shape[0]) - int(st["pos"]))
        ok, predicted = guard.admit(
            queued_units=queued,
            request_units=new + self._chunk_units(int(stream.prompt.shape[0])),
            deadline_ms=deadline_ms)
        if ok:
            return
        if self._metrics is not None:
            self._metrics.record_rejected()
        if _trace.enabled():
            _trace.event("decode_request_shed", rid=stream.rid, attrs={
                "queue_depth": len(self._queue), "reason": "predicted_miss",
                "predicted_ms": round(predicted, 3)})
        self._log_terminal(stream, "shed",
                           detail=f"PredictedMissError predicted_ms={predicted:.1f}")
        raise PredictedMissError(
            f"predicted completion in {predicted:.1f}ms exceeds the {deadline_ms:.1f}ms "
            f"deadline with {queued} tokens queued ahead: shed at admission rather than "
            "served late."
        )

    def generate(self, prompt: Any, **kwargs) -> np.ndarray:
        """Submit and block for the whole generation."""
        return self.submit(prompt, **kwargs).result()

    # -- weight hot-swap -------------------------------------------------

    def request_swap(self, params: Any, model_state: Any = None, *,
                     step: Optional[int] = None) -> None:
        """Stage a weight swap (export trees, see ``DecodeEngine.
        check_swap``, which runs here so a bad tree fails at the call):
        admission pauses, in-flight streams finish on their weights, and
        the swap applies at the first boundary with no stream in flight.
        A second request before the first applies replaces it."""
        self._require_bound()
        self._engine.check_swap(params, model_state)
        with self._lock:
            if self._led.link is not None:
                # Staged: the chief's next record makes it pending on every
                # rank at once.
                self._swaps_staged.append((params, model_state, step))
            else:
                object.__setattr__(self, "_swap_pending", (params, model_state, step))
        if self._led.link is not None:
            with self._cv:
                self._cv.notify_all()
        if not self.synchronous:
            self._ensure_worker()
            with self._cv:
                self._cv.notify_all()

    @property
    def swap_pending(self) -> bool:
        return getattr(self, "_swap_pending", None) is not None or (
            getattr(self, "_led", None) is not None and self._swaps_unsent())

    def _maybe_apply_swap(self) -> None:
        """Apply the pending swap once the slot array is empty. Caller
        holds ``_lock``."""
        pending = getattr(self, "_swap_pending", None)
        if pending is None or any(s is not None for s in self._slot_stream):
            return
        params, model_state, step = pending
        self._engine.swap_weights(params, model_state)
        # Cached prefix pages hold K/V of the old weights: a warm hit after
        # the swap would splice them into a new-weights stream.
        dropped = self._engine.invalidate_prefix_cache()
        object.__setattr__(self, "_swap_pending", None)
        _trace.event("decode_weight_swap", step=step,
                     attrs={"deferred": True, "prefix_nodes_dropped": dropped})
        if self._metrics is not None:
            self._metrics.record_weight_swap(step)
        logger.info("decode weights hot-swapped%s (slot array drained)",
                    f" to training step {step}" if step is not None else "")

    def _maybe_apply_brownout(self) -> None:
        """Follow the guard's brown-out intent at the swap's boundary: the
        posture flips only with the slot array empty, so no stream in
        flight has its budget or its speculation changed. Caller holds
        ``_lock``."""
        guard = getattr(self, "_guard", None)
        if guard is None or not guard.enabled:
            return
        want = bool(guard.brownout_engaged)
        if want == self._brownout_active or any(s is not None for s in self._slot_stream):
            return
        object.__setattr__(self, "_brownout_active", want)
        guard.record_brownout_applied(want)
        cap = int(guard.brownout_max_new_tokens)
        _trace.event("decode_brownout", attrs={"engaged": want, "max_new_tokens_cap": cap})
        if want:
            logger.warning(
                "BROWN-OUT ENGAGED: decode degrading, max_new_tokens capped at %d and "
                "speculation off for newly admitted streams (sustained predicted-miss "
                "pressure; releases when admissions stop shedding).", cap)
        else:
            logger.warning("brown-out released: decode back to full token budgets and "
                           "speculation.")

    # -- the scheduling loop ---------------------------------------------

    def _has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(s is not None for s in self._slot_stream)

    def _chunk_units(self, prompt_tokens: int) -> int:
        """Prefill work still owed in budget units: the chunk dispatches
        for ``prompt_tokens`` uncommitted tokens (0 without chunking, where
        the guard counts a prefill as free). The guard's admission
        estimate counts it beside the tokens owed."""
        if not self._chunked or prompt_tokens <= 0:
            return 0
        return -(-int(prompt_tokens) // int(self._engine.prefill_chunk_tokens))

    def _free_slot(self, slot: int) -> None:
        self._slot_stream[slot] = None
        self._chunk_state.pop(slot, None)
        self._engine.release_slot(slot)

    def _finish_or_continue(self, slot: int, token: int) -> None:
        """Deliver ``token`` to the slot's stream; retire the slot when
        the stream is complete. Caller holds the lock."""
        stream = self._slot_stream[slot]
        now = time.perf_counter()
        last = float(self._slot_last_emit[slot])
        if last > 0.0 and self._metrics is not None:
            self._metrics.record_itl((now - last) * 1e3)
        self._slot_last_emit[slot] = now
        stream._deliver(token)
        reason = None
        if stream._eos is not None and token == stream._eos:
            reason = "eos"
        elif len(stream._tokens) >= stream._max_new:
            reason = "length"
        elif self._slot_lengths[slot] + 1 >= self._engine.token_limit:
            # Cached lengths + the token just delivered total token_limit:
            # feeding it back would write past the capacity or the table.
            reason = "capacity"
        if reason is not None:
            stream._finish(reason)
            self._free_slot(slot)
            if _trace.enabled():
                _trace.event("decode_stream_finish", rid=stream.rid, attrs={
                    "slot": slot, "reason": reason, "tokens": len(stream._tokens)})

    def _expire_queued(self) -> None:
        now = time.perf_counter()
        if not any(s.expired(now) for s in self._queue):
            return
        kept = deque()
        for stream in self._queue:
            if stream.expired(now):
                if stream._expire() and self._metrics is not None:
                    self._metrics.record_deadline_expired()
            else:
                kept.append(stream)
        object.__setattr__(self, "_queue", kept)

    def _expire_active(self) -> None:
        now = time.perf_counter()
        for slot, stream in enumerate(self._slot_stream):
            if stream is not None and stream.expired(now):
                if stream._expire() and self._metrics is not None:
                    self._metrics.record_deadline_expired()
                self._free_slot(slot)

    def _admit(self, cutoff: Optional[int] = None) -> None:
        """Refill free slots from the queue head, one prefill dispatch per
        admitted group (a cold ``prefill`` and a warm ``prefill_warm``
        when both kinds are in it; under chunked prefill none: the
        planner appends the prompts). Caller holds ``_step_lock``; the
        dispatches run outside ``_lock`` (admitted streams are reserved
        into the slot array first, so ``close()`` and a crash see
        them)."""
        engine = self._engine
        # Under chief-led dispatch the record's cutoff bounds admission and
        # only records expire streams.
        below = (lambda: True) if cutoff is None else (
            lambda: self._queue[0].ordinal < cutoff)
        while True:
            with self._lock:
                if self._swap_pending is not None or not self._queue or not below():
                    return  # a pending swap drains the slot array first
                free = [i for i, s in enumerate(self._slot_stream) if s is None]
                if not free:
                    return
                group: List[DecodeStream] = []
                slots: List[int] = []
                cap = min(len(free), max(engine._prefill_buckets))
                while self._queue and len(group) < cap and below():
                    stream = self._queue.popleft()
                    if cutoff is None and stream.expired():
                        if stream._expire() and self._metrics is not None:
                            self._metrics.record_deadline_expired()
                        continue
                    if self._brownout_active:
                        # Capped at admission only: a budget in flight is
                        # never rewritten.
                        stream._max_new = min(stream._max_new,
                                              int(self._guard.brownout_max_new_tokens))
                    group.append(stream)
                    slots.append(free[len(group) - 1])
                if not group:
                    continue
                t0_ns = time.perf_counter_ns()
                for stream, slot in zip(group, slots):
                    self._slot_stream[slot] = stream
                    self._slot_lengths[slot] = int(stream.prompt.shape[0])
                    self._slot_last_emit[slot] = 0.0
                    # Attributed before the device work: a crash mid-prefill
                    # still shows the stream reached dispatch.
                    stream._slot = slot
                    stream._role = "decode"
                    if stream._t_dispatch_ns is None:
                        stream._t_dispatch_ns = t0_ns
                    if _trace.enabled() and stream.rid is not None:
                        _trace.event("decode_request_dispatch", rid=stream.rid,
                                     attrs={"slot": slot})
                # Page allocation and the prefix lookup (the slot layout's
                # plans are cold). A stream the pool cannot hold goes back
                # to the queue head while other streams can free pages,
                # else it is shed. The copy-on-write runs outside the lock.
                plans, admitted, admitted_slots, overflow = [], [], [], []
                for stream, slot in zip(group, slots):
                    plan = engine.admit_slot(slot, stream.prompt, copy=False)
                    if plan is None:
                        overflow.append((stream, slot))
                    else:
                        stream._shared_tokens = int(plan.get("shared_tokens") or 0)
                        plans.append(plan)
                        admitted.append(stream)
                        admitted_slots.append(slot)
                overflow_slots = {slot for _, slot in overflow}
                others_active = bool(admitted) or any(
                    s is not None and i not in overflow_slots
                    for i, s in enumerate(self._slot_stream)
                )
                for stream, slot in reversed(overflow):
                    self._slot_stream[slot] = None
                    if others_active:
                        self._queue.appendleft(stream)
                    else:
                        if self._metrics is not None:
                            self._metrics.record_rejected()
                        stream._fail(RejectedError(
                            "KV page pool exhausted with no active streams to "
                            "wait for: the prompt needs more pages than "
                            "pool_pages can ever free — raise engine.pool_pages "
                            "or shorten the prompt."
                        ))
            if not admitted:
                if overflow:
                    return
                continue
            group, slots = admitted, admitted_slots
            for plan in plans:
                cow = plan.pop("cow", None)
                if cow is not None:
                    engine.copy_page(*cow)
            if self._chunked:
                # The planner (_prefill_chunks) appends the prompt chunk by
                # chunk from its cursor: past a warm prefix, so a fully warm
                # prompt costs a 1-token chunk. Meanwhile _slot_lengths is
                # the committed prefix.
                with self._lock:
                    now = time.perf_counter()
                    for stream, slot, plan in zip(group, slots, plans):
                        if self._slot_stream[slot] is not stream:
                            continue  # failed by close()/crash already
                        shared = int(plan.get("shared_tokens") or 0)
                        self._slot_lengths[slot] = shared
                        self._chunk_state[slot] = {"pos": shared, "admit_t": now}
                continue
            cold = [i for i, p in enumerate(plans) if not p.get("shared_tokens")]
            warm = [i for i, p in enumerate(plans) if p.get("shared_tokens")]
            t0 = time.perf_counter()
            first = np.zeros(len(group), np.int32)
            if cold:
                out = engine.prefill([group[i].prompt for i in cold], [slots[i] for i in cold])
                first[cold] = out
            if warm:
                out = engine.prefill_warm([group[i].prompt for i in warm],
                                          [slots[i] for i in warm],
                                          [int(plans[i]["shared_tokens"]) for i in warm])
                first[warm] = out
            spec = self._speculative
            if spec is not None:
                # The draft's own slot cache takes the whole prompt (its
                # first token is discarded: the teacher's is delivered).
                spec.draft_engine.prefill([s.prompt for s in group], slots)
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                now = time.perf_counter()
                delivered = 0
                for stream, slot, token in zip(group, slots, first):
                    if self._slot_stream[slot] is not stream:
                        continue  # failed by close()/crash mid-dispatch
                    stream.ttft_ms = (now - stream._t_submit) * 1e3
                    if self._metrics is not None:
                        self._metrics.record_ttft(stream.ttft_ms)
                    if spec is not None:
                        self._draft_lengths[slot] = int(stream.prompt.shape[0])
                        self._draft_pending[slot] = []
                    # Cache the prompt's pages while the slot holds them.
                    engine.insert_prefix(slot, stream.prompt)
                    self._slot_tokens[slot] = int(token)
                    self._finish_or_continue(slot, int(token))
                    delivered += 1
                if self._metrics is not None:
                    self._metrics.record_prefill(dt_ms, delivered)
                    self._metrics.record_first_tokens(delivered)

    def _ensure_active_rows(self, extra: int) -> None:
        """Every active slot must hold pages for ``length + extra`` rows
        before a decode step (``extra=1``) or a verify window (``extra=w``)
        writes them; a slot the pool cannot grow, even after prefix-cache
        eviction, fails its stream with ``RejectedError``. Mid-prefill
        slots already hold their whole prompt's pages. Caller holds
        ``_lock``."""
        for slot, stream in enumerate(self._slot_stream):
            if stream is None or slot in self._chunk_state:
                continue
            if self._engine.ensure_rows(slot, int(self._slot_lengths[slot]) + int(extra)):
                continue
            if self._metrics is not None:
                self._metrics.record_rejected()
            stream._fail(RejectedError(
                "KV page pool exhausted mid-generation: no free page for this "
                "stream's next token (partial output in tokens_so_far; raise "
                "engine.pool_pages or lower concurrency and resubmit)."
            ))
            self._free_slot(slot)

    def _decoding(self, streams) -> List[int]:
        """The slots that decode: active and not mid-prefill."""
        return [i for i, s in enumerate(streams) if s is not None and i not in self._chunk_state]

    def _decode(self) -> int:
        """One decode dispatch over the whole slot array; deliver each
        decoding slot's token. Returns the iteration's decode spend for the
        chunk budget (a token a slot, a speculative window ``k + 1``). With
        speculation the window schedule runs instead, unless a slot is
        within one window of its token limit (a clamped multi-row append
        would land on live rows): then this iteration is plain and the
        draft keeps up through its width-2 verify. The dispatches run
        outside ``_lock`` over a snapshot of the slot arrays."""
        spec = self._speculative
        if spec is not None:
            with self._lock:
                active = self._decoding(self._slot_stream)
                # The brown-out skips the window; the plain step's width-2
                # draft catch-up keeps the draft cache in step.
                eligible = bool(active) and not self._brownout_active and all(
                    int(self._slot_lengths[i]) + spec.window <= self._engine.token_limit
                    for i in active)
            if not active:
                return 0
            if eligible:
                return self._decode_spec(spec)
        engine = self._engine
        with self._lock:
            self._ensure_active_rows(1)
            snapshot = list(self._slot_stream)
            active = self._decoding(snapshot)
            if not active:
                return 0
            tokens = self._slot_tokens.astype(np.int32)
            lengths = self._slot_lengths.astype(np.int32)
            if spec is not None:
                dlengths = self._draft_lengths.astype(np.int32)
                ctokens, counts = self._draft_catchup_window(active, tokens)
        t0 = time.perf_counter()
        nxt = engine.decode(tokens, lengths)
        if spec is not None:
            # The draft consumes the same token(s): its gap to the teacher
            # stays at most one across plain and speculative iterations.
            spec.draft_engine.verify(ctokens, dlengths)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            delivered = 0
            for slot in active:
                if self._slot_stream[slot] is not snapshot[slot]:
                    continue  # failed by close()/crash mid-dispatch
                self._slot_lengths[slot] += 1
                if spec is not None:
                    self._draft_lengths[slot] = int(dlengths[slot]) + int(counts[slot])
                    self._draft_pending[slot] = []
                token = int(nxt[slot])
                self._slot_tokens[slot] = token
                self._finish_or_continue(slot, token)
                delivered += 1
            if self._metrics is not None:
                self._metrics.record_decode_step(dt_ms, delivered)
        return len(active)

    def _draft_catchup_window(self, active, cur_tokens):
        """The draft's width-2 window: per active slot the (at most one)
        committed token the draft has not consumed, then the current
        token. Returns ``(tokens [slots, 2], counts [slots])``, ``counts``
        the real ones (a padding row's K/V stays past the length)."""
        n = int(self._engine.slots)
        ctokens = np.zeros((n, 2), np.int32)
        counts = np.zeros((n,), np.int32)
        for i in active:
            pending = self._draft_pending[i]
            if pending:
                ctokens[i] = (int(pending[0]), int(cur_tokens[i]))
                counts[i] = 2
            else:
                ctokens[i] = int(cur_tokens[i])
                counts[i] = 1
        return ctokens, counts

    def _decode_spec(self, spec) -> int:
        """One speculative window over the slot array: the draft proposes
        ``k`` tokens per slot (a width-2 catch-up verify, then ``k - 1``
        steps), one teacher ``verify`` scores the ``k + 1`` positions, and
        each slot commits its longest matching prefix plus the teacher's
        token at the first mismatch, one token at a time through the plain
        path's bookkeeping (a stream that finishes mid-window drops the
        rest). Rejected rows in both caches stay past the lengths."""
        engine = self._engine
        draft = spec.draft_engine
        k = int(spec.k)
        n = int(engine.slots)
        with self._lock:
            # The teacher's window writes k + 1 rows; rollback never frees.
            self._ensure_active_rows(spec.window)
            snapshot = list(self._slot_stream)
            active = self._decoding(snapshot)
            if not active:
                return 0
            cur = self._slot_tokens.astype(np.int32)
            lengths = self._slot_lengths.astype(np.int32)
            dlengths = self._draft_lengths.astype(np.int32)
            ctokens, counts = self._draft_catchup_window(active, cur)
        t0 = time.perf_counter()
        proposals = np.zeros((n, k), np.int32)
        traced = _trace.enabled()
        with _trace.span("spec_draft", attrs={"slots": len(active), "k": k} if traced else None):
            # 1. The catch-up brings the draft level with the teacher and
            # consumes the current token; its last real position's argmax
            # is the first proposal.
            out = draft.verify(ctokens, dlengths)
            step_lengths = dlengths.copy()
            for i in active:
                proposals[i, 0] = int(out[i, int(counts[i]) - 1])
                step_lengths[i] += int(counts[i])
            # 2. k - 1 draft steps propose the rest.
            step_tokens = proposals[:, 0].copy()
            for t in range(1, k):
                step_tokens = draft.decode(step_tokens, step_lengths)
                for i in active:
                    proposals[i, t] = int(step_tokens[i])
                    step_lengths[i] += 1
        # 3. One teacher dispatch scores [current, d_1..d_k].
        vtokens = np.zeros((n, k + 1), np.int32)
        for i in active:
            vtokens[i, 0] = int(cur[i])
            vtokens[i, 1:] = proposals[i]
        with _trace.span("spec_verify",
                         attrs={"slots": len(active), "window": k + 1} if traced else None):
            scored = engine.verify(vtokens, lengths)
        dt_ms = (time.perf_counter() - t0) * 1e3
        # 4. Greedy acceptance and the commit.
        with self._lock:
            delivered = proposed_total = accepted_total = 0
            accept_lengths = []
            for i in active:
                stream = snapshot[i]
                if self._slot_stream[i] is not stream:
                    continue  # failed by close()/crash mid-dispatch
                a = 0
                while a < k and int(proposals[i, a]) == int(scored[i, a]):
                    a += 1
                base = int(lengths[i])
                for j in range(a + 1):
                    self._slot_lengths[i] = base + j + 1
                    token = int(scored[i, j])
                    self._slot_tokens[i] = token
                    self._finish_or_continue(i, token)
                    delivered += 1
                    if self._slot_stream[i] is not stream:
                        break
                if self._slot_stream[i] is stream:
                    # The draft consumed [current, d_1..d_{k-1}]; on full
                    # acceptance it still owes d_k, its next catch-up token.
                    self._draft_lengths[i] = base + 1 + min(a, k - 1)
                    self._draft_pending[i] = [int(proposals[i, k - 1])] if a == k else []
                stream._spec_proposed += k
                stream._spec_accepted += a
                proposed_total += k
                accepted_total += a
                accept_lengths.append(a)
                if traced and stream.rid is not None:
                    _trace.event("spec_accept", rid=stream.rid,
                                 attrs={"proposed": k, "accepted": a})
            if accept_lengths:
                spec.record_window(proposed_total, accepted_total)
                if self._metrics is not None:
                    self._metrics.record_spec_window(proposed_total, accepted_total,
                                                     accept_lengths, dt_ms, delivered)
        return len(active) * (k + 1)

    def _iteration_budget(self) -> int:
        """Tokens an iteration may spend on decode and chunks: the
        explicit ``token_budget``, or every slot's window plus one whole
        chunk."""
        if int(self.token_budget) > 0:
            return int(self.token_budget)
        spec = self._speculative
        per = int(spec.window) if spec is not None else 1
        return int(self._engine.slots) * per + int(self._engine.prefill_chunk_tokens)

    def _prefill_chunks(self, decode_spend: int) -> None:
        """Spend what decode left of the budget on pending chunks, in slot
        order: at most ``prefill_chunk_tokens`` a lane, a prefill bucket
        of lanes a dispatch, dispatches while budget and lanes remain (at
        least one token an iteration, so a full slot array cannot starve
        the prompts). A prompt's final chunk gives its first token: TTFT,
        the prefix cached, the draft prefilled, and the slot decodes from
        the next iteration."""
        if not self._chunked:
            return
        engine = self._engine
        spec = self._speculative
        chunk_cap = int(engine.prefill_chunk_tokens)
        lane_cap = max(engine._prefill_buckets)
        budget = max(1, self._iteration_budget() - int(decode_spend))
        while budget > 0:
            group = []  # (slot, stream, chunk, offset, final)
            with self._lock:
                for slot in sorted(self._chunk_state):
                    if len(group) >= lane_cap or budget < 1:
                        break
                    stream = self._slot_stream[slot]
                    if stream is None:
                        continue
                    pos = int(self._chunk_state[slot]["pos"])
                    total = int(stream.prompt.shape[0])
                    c = min(chunk_cap, total - pos, budget)
                    if c < 1:
                        continue
                    budget -= c
                    group.append((slot, stream, stream.prompt[pos:pos + c], pos, pos + c >= total))
            if not group:
                return
            t0 = time.perf_counter()
            last = engine.prefill_chunk([g[2] for g in group], [g[0] for g in group],
                                        [g[3] for g in group])
            finals = [g for g in group if g[4]]
            if spec is not None and finals:
                # The draft prefills once the whole prompt is committed.
                spec.draft_engine.prefill([g[1].prompt for g in finals], [g[0] for g in finals])
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                now = time.perf_counter()
                finished = 0
                stalls = []
                for (slot, stream, chunk, pos, final), tok in zip(group, last):
                    if self._slot_stream[slot] is not stream:
                        continue  # failed by close()/crash mid-dispatch
                    st = self._chunk_state.get(slot)
                    if st is None:
                        continue
                    end = pos + int(np.shape(chunk)[0])
                    st["pos"] = end
                    self._slot_lengths[slot] = end
                    if not final:
                        continue
                    del self._chunk_state[slot]
                    stream.ttft_ms = (now - stream._t_submit) * 1e3
                    stalls.append((now - float(st["admit_t"])) * 1e3)
                    if self._metrics is not None:
                        self._metrics.record_ttft(stream.ttft_ms)
                    if spec is not None:
                        self._draft_lengths[slot] = end
                        self._draft_pending[slot] = []
                    engine.insert_prefix(slot, stream.prompt)
                    self._slot_tokens[slot] = int(tok)
                    self._finish_or_continue(slot, int(tok))
                    finished += 1
                if self._metrics is not None:
                    self._metrics.record_prefill_chunks(len(group), dt_ms)
                    if finished:
                        self._metrics.record_prefill_finish(finished, stalls)
                        self._metrics.record_first_tokens(finished)

    def _update_occupancy(self) -> None:
        if self._metrics is None:
            return
        active_lengths = [int(self._slot_lengths[i])
                          for i, s in enumerate(self._slot_stream) if s is not None]
        self._metrics.record_occupancy(len(active_lengths), int(self._engine.slots),
                                       len(self._queue),
                                       self._engine.kv_pages_in_use(active_lengths))
        pool = self._engine.page_pool
        if pool is not None:
            self._metrics.record_pool(pool.free_pages, pool.prefix_hit_rate)

    def _step_once(self, record: Optional[list] = None) -> bool:
        """One iteration: the swap boundary, deadline sweeps (under
        chief-led dispatch: the record that opens the iteration, a
        follower's ``record``), admit (prefill), decode, then prompt chunks
        under what decode left of the budget, and the swap boundary again
        (the slot array may have drained). Returns whether work remains."""
        from zookeeper_tpu_torch.resilience import faults

        with self._step_lock:
            link = self._led.link
            if link is None or link.is_chief:
                with self._lock:
                    plan = faults.active()
                    if plan is not None and plan.take_decode_worker_crash():
                        raise WorkerCrashedError(
                            "injected decode scheduler crash (FaultPlan.decode_worker_crash)"
                        )
            cutoff = self._iteration_record(record) if link is not None else None
            with self._lock:
                self._maybe_apply_swap()
                self._maybe_apply_brownout()
                if link is None:
                    self._expire_queued()
                    self._expire_active()
            if cutoff is None:
                self._admit()
            else:
                self._admit(cutoff)
            spent = self._decode()
            self._prefill_chunks(spent)
            with self._lock:
                self._maybe_apply_swap()
                self._maybe_apply_brownout()
                self._update_occupancy()
        with self._cv:
            self._cv.notify_all()
        return self._has_work()

    def _pump(self, record: Optional[list] = None) -> bool:
        """``_step_once`` with the crash contract: any failure of the loop
        fails every queued and in-flight stream, then re-raises."""
        try:
            return self._step_once(record)
        except BaseException as e:
            self._on_crash(e)
            raise

    def _on_crash(self, error: BaseException) -> None:
        with self._lock:
            link = self._led.link
            active = [s for s in self._slot_stream if s is not None]
            if isinstance(error, _ChiefCrashed):
                # A follower fails what the chief failed: the rest of its
                # queue stays, and what it has not received fails on arrival.
                named = self._led.crashed(
                    error, [s.ordinal for s in active + list(self._queue)])
                streams = active + [s for s in self._queue if s.ordinal in named]
                object.__setattr__(self, "_queue",
                                   deque(s for s in self._queue if s.ordinal not in named))
            else:
                streams = active + list(self._queue)
                self._queue.clear()
                if link is not None and link.is_chief:
                    self._led.send_crash([s.ordinal for s in streams])
            for i in range(len(self._slot_stream)):
                self._slot_stream[i] = None
                self._engine.release_slot(i)
                # The next occupant's draft prefill reseeds the draft.
                self._draft_lengths[i] = 0
                self._draft_pending[i] = []
            self._chunk_state.clear()
            object.__setattr__(self, "_worker", None)
            _trace.event("decode_worker_crash", attrs={"error": type(error).__name__,
                                                       "failed_streams": len(streams)})
            if self._metrics is not None:
                self._metrics.record_worker_restart()
            wrapped = WorkerCrashedError(
                f"DecodeScheduler crashed ({error!r}); this stream was failed "
                "cleanly (partial tokens in tokens_so_far) — resubmit to run on "
                "the restarted scheduler."
            )
            wrapped.__cause__ = error
            for stream in streams:
                stream._fail(wrapped)
            self._update_occupancy()
        # After the fails (the bundle's RequestLog tail carries the crashed
        # summaries) and outside the lock (a bundle write must not stall
        # submit() or status()).
        _recorder.notify("decode_worker_crash", attrs={"error": type(error).__name__,
                                                       "failed_streams": len(streams)})

    # -- driving ---------------------------------------------------------

    def drain(self) -> None:
        """Serve everything: run the loop until the queue and the slot
        array are empty (sync), or wait for the worker to (async)."""
        self._require_bound()
        if self.synchronous:
            if self._led.link is not None:
                self._run_led()
            else:
                while self._has_work():
                    self._pump()
            with self._lock:
                self._maybe_apply_swap()
            return
        self._ensure_worker()
        with self._cv:
            self._cv.notify_all()
        while self._has_work() and not self._stop.is_set():
            worker = getattr(self, "_worker", None)
            if worker is None or not worker.is_alive():
                break  # the crash already failed the streams
            with self._cv:
                self._cv.wait(0.01)

    def _expire_stream(self, stream: DecodeStream) -> None:
        if stream._expire() and self._metrics is not None:
            self._metrics.record_deadline_expired()

    def _drive(self, stream: DecodeStream, timeout: Optional[float]) -> None:
        """Block (or drive) until ``stream`` completes, never past its
        deadline."""
        led = self._led.link is not None
        if self.synchronous:
            if led:
                self._run_led(until=lambda: stream._done)
                return
            while not stream._done and self._has_work():
                self._pump()
            if not stream._done and stream.expired():
                self._expire_stream(stream)
            return
        self._ensure_worker()
        with self._cv:
            self._cv.notify_all()
        # Chief-led: the chief's records expire streams, never this clock.
        deadline = None if led else stream._deadline_at
        t_end = time.perf_counter() + timeout if timeout is not None else None
        with stream._cond:
            while not stream._done:
                now = time.perf_counter()
                if deadline is not None and now >= deadline:
                    break
                if t_end is not None and now >= t_end:
                    break
                waits = [0.05] + [t - now for t in (deadline, t_end) if t is not None]
                stream._cond.wait(max(0.0, min(waits)))
        if not stream._done:
            if not led and stream.expired():
                self._expire_stream(stream)
            else:
                raise TimeoutError(
                    f"generation not complete within {timeout}s (worker stalled, "
                    "or close() was called)."
                )

    def _advance(self, stream: DecodeStream) -> None:
        """One increment of progress for an iterating consumer."""
        led = self._led.link is not None
        if self.synchronous:
            if led:
                if not stream._done:
                    self._run_led(pump_once=True)
            elif not stream._done and self._has_work():
                self._pump()
            elif not stream._done and stream.expired():
                self._expire_stream(stream)
            return
        with stream._cond:
            if not stream._done:
                stream._cond.wait(0.05)
        if not led and not stream._done and stream.expired():
            self._expire_stream(stream)

    def _ensure_worker(self) -> None:
        with self._lock:
            worker = getattr(self, "_worker", None)
            if worker is None or not worker.is_alive():
                thread = threading.Thread(target=self._worker_loop,
                                          name="zk-decode-scheduler", daemon=True)
                object.__setattr__(self, "_worker", thread)
                thread.start()

    def _worker_loop(self) -> None:
        link = self._led.link
        if link is not None and not link.is_chief:
            return self._follower_loop()
        while not self._stop.is_set():
            if not self._has_work() and not self.swap_pending:
                with self._cv:
                    self._cv.wait(0.05)
                continue
            try:
                self._pump()
            except BaseException:
                return  # streams already failed; the next submit restarts
        if link is not None:
            link.exchange([distributed.RECORD_STOP])  # the followers' loops end

    def _follower_loop(self) -> None:
        """A follower's threaded loop: run the chief's iterations as their
        records come, until its stop record (or its crash record)."""
        try:
            self._led.follow(self._pump, distributed.RECORD_STOP)
        except _ChiefCrashed as error:
            self._on_crash(error)
        except BaseException:
            return  # streams already failed; the next submit restarts

    def close(self, drain: bool = False) -> None:
        """Stop the scheduler. ``drain=True`` serves everything first;
        otherwise pending streams fail, so no ``result()`` blocks
        forever. Safe to call repeatedly, or unbound."""
        if getattr(self, "_engine", None) is None:
            return
        if drain:
            try:
                self.drain()
            except Exception:
                pass  # per-stream errors are already delivered
        self._stop.set()
        worker = getattr(self, "_worker", None)
        if worker is not None:
            with self._cv:
                self._cv.notify_all()
            worker.join(timeout=5)
            object.__setattr__(self, "_worker", None)
        err = RuntimeError("DecodeScheduler closed with streams pending.")
        with self._lock:
            for stream in list(self._queue):
                stream._fail(err)
            self._queue.clear()
            for i, stream in enumerate(self._slot_stream):
                if stream is not None:
                    stream._fail(err)
                    self._free_slot(i)
        self._stop.clear()

    # -- introspection ---------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_slots(self) -> int:
        with self._lock:
            return sum(1 for s in self._slot_stream if s is not None)

    def status(self) -> dict:
        """The numbers an operator checks before trusting the stream
        metrics."""
        engine = self._engine
        with self._lock:
            active_lengths = [int(self._slot_lengths[i])
                              for i, s in enumerate(self._slot_stream) if s is not None]
            out = {
                "slots": int(engine.slots),
                "active_slots": len(active_lengths),
                "queue_depth": len(self._queue),
                "kv_pages_in_use": engine.kv_pages_in_use(active_lengths),
                "kv_capacity_tokens": engine.capacity,
                "kv_cache_mb": round(engine.kv_cache_nbytes / 2**20, 2),
                "kv_cache_bytes": int(engine.kv_cache_nbytes),
                "kv_bytes_per_slot": int(engine.kv_cache_nbytes // max(1, int(engine.slots))),
                "decode_attention": engine.decode_attention_flavor,
                "kv_layout": str(engine.kv_layout),
                "decode_mbu": round(engine.decode_mbu, 4),
                "compiles": engine.compile_count,
                "recompiles_detected": engine.recompiles_detected,
                "swap_pending": self.swap_pending,
            }
            if engine.paged:
                out["kv_pool"] = engine.pool_status()
            spec = self._speculative
            out["speculative"] = spec.status() if spec is not None else {"enabled": False}
            out["chunked_prefill"] = {
                "enabled": self._chunked,
                "chunk_tokens": int(engine.prefill_chunk_tokens),
                "token_budget": self._iteration_budget() if self._chunked else 0,
                "pending_prefills": len(self._chunk_state),
                "pending_prefill_tokens": sum(
                    int(self._slot_stream[i].prompt.shape[0]) - int(st["pos"])
                    for i, st in self._chunk_state.items() if self._slot_stream[i] is not None),
            }
            guard = getattr(self, "_guard", None)
            out["guardrails"] = {
                "guard": guard.status() if guard is not None else {"enabled": False},
                "brownout_active": bool(getattr(self, "_brownout_active", False)),
            }
            return out
