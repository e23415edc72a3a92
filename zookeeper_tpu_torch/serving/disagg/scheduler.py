"""The split prefill/decode scheduler.

The port of ``zookeeper_tpu/serving/disagg/scheduler.py``'s
``DisaggScheduler``: one :class:`~zookeeper_tpu_torch.serving.decode.\
scheduler.DecodeScheduler` loop over two engines. Submission, shedding,
backpressure, deadlines, crash recovery and the staged weight swap are
the base's; only admission becomes two queues:

- **The prefill queue** (the base ``_queue`` and the prefill engine's
  lanes): queued prompts ride bucketed prefills on the prefill engine,
  as wide as its ``prefill_buckets`` allow. The first token is
  delivered when the prefill completes (TTFT is the prefill role's),
  so the handoff lands in token 2's gap. A stream finished by its first
  token (EOS, ``max_new_tokens=1``, the token limit) releases its lane
  and never transfers.
- **The decode queue** (``_parked``, completed prefills): when a decode
  slot frees (a pending weight swap does not stop it), the oldest
  handoff adopts destination pages
  (``PagePool.adopt_slot``), the :class:`~zookeeper_tpu_torch.serving.\
disagg.transfer.PageTransfer` moves the lane's pages across, and the
  stream continues through the base decode loop, plain or speculative
  (the draft, with the decode role, prefills the prompt at this
  admission).

Refcount custody across the seam: destination pages are adopted before
the move, the source lane is released only after the import, and every
failure path (an injected transfer failure, a prefill-role crash,
``close``, a deadline) unwinds whichever side it holds, so both pools
keep ``leak_check() == 0`` at every point.

Fault legs (``resilience.faults``): ``fail_page_transfer`` fails the
next handoff's move (the victim fails with ``PageTransferError``, every
other stream proceeds); ``prefill_role_crash_at=N`` kills the prefill
role at the N-th handoff: its pool and lanes are lost (reset, nothing
leaked), every stream on the prefill side fails cleanly with its
partial tokens readable, and the decode role keeps serving its slots.

Observability: a stream's RequestLog summary (the base scheduler's)
carries the role it ended on ("prefill" for one finished at its first
token, "transfer" while parked, "decode"), and with tracing on the
rid-tagged ``disagg_prefill_dispatch``, ``disagg_prefill_park``,
``page_transfer`` (the move's span) and ``disagg_decode_admit`` draw the
handoff; a prefill-role crash is a ``disagg_prefill_role_crash`` event
and a flight-recorder trigger. The summaries land in the scheduler's
``RequestLog("disagg")`` (``bind(request_log=...)`` takes another), and
``status()`` adds the ``prefill`` and ``transfer`` sections to the
decode role's keys.
"""

import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from zookeeper_tpu_torch.core import component
from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.requests import RequestLog
from zookeeper_tpu_torch.serving.batcher import RejectedError, WorkerCrashedError
from zookeeper_tpu_torch.serving.decode.scheduler import DecodeScheduler, DecodeStream
from zookeeper_tpu_torch.serving.disagg.transfer import PageTransfer, PageTransferError

__all__ = ["DisaggScheduler"]

#: A parked handoff: (stream, prefill lane, first token, prompt tokens,
#: first token's time).
_Handoff = Tuple[DecodeStream, int, int, int, float]


@component
class DisaggScheduler(DecodeScheduler):
    """Continuous batching over a prefill engine and a decode engine
    joined by a :class:`PageTransfer` (see the module docstring). Every
    :class:`DecodeScheduler` field applies."""

    def bind(self, prefill_engine, decode_engine, transfer: PageTransfer, metrics=None,
             request_log: Optional[RequestLog] = None,
             speculative=None) -> "DisaggScheduler":
        """Bind both roles. The decode engine is the base's ``_engine``
        (slots, decode loop, capacity); the prefill engine gives lanes
        and the wide prefill; ``transfer`` must be bound to exactly this
        (prefill, decode) pair. ``request_log`` defaults to
        ``RequestLog("disagg")``."""
        prefill_engine._require_bound()
        decode_engine._require_bound()
        if not prefill_engine.paged or not decode_engine.paged:
            raise ValueError(
                "disaggregated serving needs kv_layout='paged' on BOTH roles — the "
                "handoff unit is the page."
            )
        transfer._require_bound()
        if transfer._src is not prefill_engine or transfer._dst is not decode_engine:
            raise ValueError(
                "transfer is bound to a different engine pair; bind it as "
                "transfer.bind(prefill_engine, decode_engine)."
            )
        if prefill_engine.max_prompt < decode_engine.max_prompt:
            raise ValueError(
                f"prefill seq buckets top out at {prefill_engine.max_prompt} tokens but "
                f"the decode role admits prompts up to {decode_engine.max_prompt} — "
                "widen the prefill engine's seq_buckets."
            )
        super().bind(decode_engine, metrics=metrics, speculative=speculative,
                     request_log=request_log if request_log is not None
                     else RequestLog("disagg"))
        object.__setattr__(self, "_prefill_engine", prefill_engine)
        object.__setattr__(self, "_transfer", transfer)
        object.__setattr__(self, "_lane_stream", [None] * int(prefill_engine.slots))
        object.__setattr__(self, "_parked", deque())
        return self

    def _engage(self) -> None:
        raise ValueError(
            "chief-led dispatch of disaggregated serving is not ported (ROADMAP.md Queue 1 "
            "item 4): serve it synchronously without deadlines, on one rank."
        )

    @property
    def prefill_engine(self):
        return getattr(self, "_prefill_engine", None)

    @property
    def transfer(self) -> Optional[PageTransfer]:
        return getattr(self, "_transfer", None)

    @property
    def parked(self) -> int:
        with self._lock:
            return len(self._parked)

    def _free_lane(self, lane: int) -> None:
        """Every lane retirement: pages released, lane reusable. Caller
        holds ``_lock``."""
        self._lane_stream[lane] = None
        self._prefill_engine.release_slot(lane)

    # -- the split admission ---------------------------------------------

    def _admit(self) -> None:
        """One admission round: land parked handoffs (frees lanes), refill
        the lanes from the queue, then land what that prefill parked, so
        a lone stream on an idle service reaches its decode slot within
        one iteration."""
        self._admit_decode()
        self._admit_prefill()
        self._admit_decode()

    def _admit_prefill(self) -> None:
        """The base admission on the prefill engine's lanes (reserve and
        plan pages under ``_lock``, dispatch outside it, commit after an
        identity check), except that completion parks the stream as a
        handoff instead of entering the decode loop."""
        engine = self._prefill_engine
        while True:
            with self._lock:
                if self._swap_pending is not None or not self._queue:
                    return
                free = [i for i, s in enumerate(self._lane_stream) if s is None]
                if not free:
                    return
                group: List[DecodeStream] = []
                lanes: List[int] = []
                cap = min(len(free), max(engine._prefill_buckets))
                while self._queue and len(group) < cap:
                    stream = self._queue.popleft()
                    if stream.expired():
                        if stream._expire() and self._metrics is not None:
                            self._metrics.record_deadline_expired()
                        continue
                    group.append(stream)
                    lanes.append(free[len(group) - 1])
                if not group:
                    continue
                t0_ns = time.perf_counter_ns()
                for stream, lane in zip(group, lanes):
                    self._lane_stream[lane] = stream
                    stream._role = "prefill"
                    if stream._t_dispatch_ns is None:
                        stream._t_dispatch_ns = t0_ns
                    if _trace.enabled() and stream.rid is not None:
                        _trace.event("disagg_prefill_dispatch", rid=stream.rid,
                                     attrs={"lane": lane})
            # Pages on the prefill pool. A stream the pool cannot hold goes
            # back to the queue head while anything anywhere is in flight
            # (busy lanes, parked handoffs and decoding slots all free
            # prefill pages in time); with the pipeline idle it is shed.
            plans, admitted, admitted_lanes, overflow = [], [], [], []
            with self._lock:
                for stream, lane in zip(group, lanes):
                    if self._lane_stream[lane] is not stream:
                        continue  # failed by close()/crash already
                    plan = engine.admit_slot(lane, stream.prompt, copy=False)
                    if plan is None:
                        overflow.append((stream, lane))
                    else:
                        stream._shared_tokens = int(plan.get("shared_tokens") or 0)
                        plans.append(plan)
                        admitted.append(stream)
                        admitted_lanes.append(lane)
                overflow_lanes = {lane for _, lane in overflow}
                others_active = (
                    any(s is not None and i not in overflow_lanes
                        for i, s in enumerate(self._lane_stream))
                    or bool(admitted) or bool(self._parked)
                    or any(s is not None for s in self._slot_stream))
                for stream, lane in reversed(overflow):
                    self._lane_stream[lane] = None
                    if others_active:
                        self._queue.appendleft(stream)
                    else:
                        if self._metrics is not None:
                            self._metrics.record_rejected()
                        stream._fail(RejectedError(
                            "prefill KV page pool exhausted with nothing in flight to "
                            "wait for: the prompt needs more pages than the prefill "
                            "role's pool_pages can ever free — raise it or shorten the "
                            "prompt."
                        ))
            if not admitted:
                if overflow:
                    return
                continue
            group, lanes = admitted, admitted_lanes
            for plan in plans:
                cow = plan.pop("cow", None)
                if cow is not None:
                    engine.copy_page(*cow)
            cold = [i for i, p in enumerate(plans) if not p.get("shared_tokens")]
            warm = [i for i, p in enumerate(plans) if p.get("shared_tokens")]
            t0 = time.perf_counter()
            first = np.zeros(len(group), np.int32)
            if cold:
                first[cold] = engine.prefill([group[i].prompt for i in cold],
                                             [lanes[i] for i in cold])
            if warm:
                first[warm] = engine.prefill_warm([group[i].prompt for i in warm],
                                                  [lanes[i] for i in warm],
                                                  [int(plans[i]["shared_tokens"]) for i in warm])
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                now = time.perf_counter()
                delivered = 0
                for stream, lane, token in zip(group, lanes, first):
                    if self._lane_stream[lane] is not stream:
                        continue  # failed by close()/crash mid-dispatch
                    stream.ttft_ms = (now - stream._t_submit) * 1e3
                    if self._metrics is not None:
                        self._metrics.record_ttft(stream.ttft_ms)
                    engine.insert_prefix(lane, stream.prompt)
                    token = int(token)
                    stream._deliver(token)
                    delivered += 1
                    prompt_len = int(stream.prompt.shape[0])
                    reason = None
                    if stream._eos is not None and token == stream._eos:
                        reason = "eos"
                    elif len(stream._tokens) >= stream._max_new:
                        reason = "length"
                    elif prompt_len + 1 >= self._engine.token_limit:
                        # The decode role's token limit: the sequence could
                        # never grow there.
                        reason = "capacity"
                    if reason is not None:
                        stream._finish(reason)
                        self._free_lane(lane)
                        if _trace.enabled() and stream.rid is not None:
                            _trace.event("decode_stream_finish", rid=stream.rid, attrs={
                                "lane": lane, "reason": reason, "tokens": len(stream._tokens)})
                    else:
                        stream._role = "transfer"
                        self._parked.append((stream, lane, token, prompt_len, now))
                        if _trace.enabled() and stream.rid is not None:
                            _trace.event("disagg_prefill_park", rid=stream.rid,
                                         attrs={"lane": lane, "parked": len(self._parked)})
                if self._metrics is not None:
                    self._metrics.record_prefill(dt_ms, delivered)
                    self._metrics.record_first_tokens(delivered)

    def _admit_decode(self) -> None:
        """Land parked handoffs into free decode slots, oldest first: adopt
        the destination pages under ``_lock``, run the fault checks and
        the move outside it, commit after an identity check, and only
        then release the source lane."""
        from zookeeper_tpu_torch.resilience import faults

        engine = self._engine
        spec = self._speculative
        while True:
            with self._lock:
                # A parked handoff was prefilled on the weights in place, so
                # it lands even while a swap is pending: the swap waits for
                # it to finish (JAX's scheduler pauses this too, and a swap
                # staged with a handoff parked then never applies).
                if not self._parked:
                    return
                free = [i for i, s in enumerate(self._slot_stream) if s is None]
                if not free:
                    return
                stream, lane, token, prompt_len, t_first = self._parked.popleft()
                slot = free[0]
                n_pages = engine.page_pool.pages_for(prompt_len)
                pages = engine.page_pool.adopt_slot(slot, n_pages)
                if pages is None:
                    # The decode pool is full: wait parked (the prefill pages
                    # stay) while a decoding slot can free pages; with the
                    # slot array idle the handoff could never land, so shed.
                    if any(s is not None for s in self._slot_stream):
                        self._parked.appendleft((stream, lane, token, prompt_len, t_first))
                        return
                    if self._metrics is not None:
                        self._metrics.record_rejected()
                    stream._fail(RejectedError(
                        "decode KV page pool exhausted with no active streams to wait "
                        "for: the handoff needs more pages than the decode role's "
                        "pool_pages can ever free — raise it or shorten the prompt."
                    ))
                    self._free_lane(lane)
                    continue
                # Reserve the slot before the device work, so close() and a
                # crash see (and fail) the stream mid-transfer.
                self._slot_stream[slot] = stream
                self._slot_lengths[slot] = prompt_len
                stream._slot = slot
                src_pages = [int(p) for p in self._prefill_engine.page_pool.table[lane, :n_pages]]
            plan = faults.active()
            if plan is not None and plan.take_prefill_role_crash():
                self._on_prefill_crash(stream, lane, slot)
                continue
            try:
                self._transfer.move(src_pages, pages, rid=stream.rid)
            except PageTransferError as e:
                # Only the victim fails: its adopted pages and its lane are
                # released, both pools stay leak-free.
                with self._lock:
                    if self._slot_stream[slot] is stream:
                        self._slot_stream[slot] = None
                        engine.release_slot(slot)
                    if self._lane_stream[lane] is stream:
                        self._free_lane(lane)
                    stream._fail(e)
                continue
            if spec is not None:
                # The draft lives with the decode role: its cache takes the
                # prompt here (its first token is discarded: the teacher's
                # was delivered by the prefill role).
                spec.draft_engine.prefill([stream.prompt], [slot])
            with self._lock:
                if self._slot_stream[slot] is not stream:
                    # Failed by close()/crash mid-transfer (its slot's pages
                    # were released there): drop the lane if still ours.
                    if self._lane_stream[lane] is stream:
                        self._free_lane(lane)
                    continue
                # The import landed: the source side releases last, so no
                # page was ever unowned.
                if self._lane_stream[lane] is stream:
                    self._free_lane(lane)
                if spec is not None:
                    self._draft_lengths[slot] = prompt_len
                    self._draft_pending[slot] = []
                self._slot_tokens[slot] = int(token)
                stream._role = "decode"
                if _trace.enabled() and stream.rid is not None:
                    _trace.event("disagg_decode_admit", rid=stream.rid,
                                 attrs={"slot": slot, "pages": len(pages)})
                # Token 2's gap runs from the first token: it holds the handoff.
                self._slot_last_emit[slot] = t_first

    # -- failures --------------------------------------------------------

    def _on_prefill_crash(self, stream: DecodeStream, lane: int, slot: int) -> None:
        """The prefill role died mid-handoff (``FaultPlan.
        prefill_role_crash_at``): its pool, lanes and parked handoffs are
        gone. Reset the prefill engine (nothing leaked), fail every stream
        still on the prefill side cleanly (partial tokens readable),
        unwind the victim's adopted decode pages, and leave the decode
        role's slots untouched."""
        with self._lock:
            wrapped = WorkerCrashedError(
                "prefill role crashed mid-handoff (FaultPlan.prefill_role_crash_at); "
                "this stream was failed cleanly (partial tokens in tokens_so_far) — "
                "resubmit to prefill on the recovered role."
            )
            victims = [stream]
            for rec in self._parked:
                if all(rec[0] is not v for v in victims):
                    victims.append(rec[0])
            self._parked.clear()
            for i, s in enumerate(self._lane_stream):
                if s is not None and all(s is not v for v in victims):
                    victims.append(s)
                self._lane_stream[i] = None
            self._prefill_engine._reset_cache()
            if self._slot_stream[slot] is stream:
                self._slot_stream[slot] = None
                self._engine.release_slot(slot)
            for v in victims:
                v._fail(wrapped)
            if self._metrics is not None:
                self._metrics.record_worker_restart()
            _trace.event("disagg_prefill_role_crash", attrs={"failed_streams": len(victims)})
        _recorder.notify("disagg_prefill_role_crash", attrs={"failed_streams": len(victims)})

    def _on_crash(self, error: BaseException) -> None:
        """A crash of the whole loop: the prefill side's streams fail with
        the base's wrapped error and the lanes release their pages, then
        the base cleans up the queue and the slots."""
        with self._lock:
            victims: List[DecodeStream] = [rec[0] for rec in getattr(self, "_parked", ())]
            if getattr(self, "_parked", None) is not None:
                self._parked.clear()
            for i, s in enumerate(getattr(self, "_lane_stream", ())):
                if s is not None and all(s is not v for v in victims):
                    victims.append(s)
                self._lane_stream[i] = None
                self._prefill_engine.release_slot(i)
            wrapped = WorkerCrashedError(
                f"DisaggScheduler crashed ({error!r}); this stream was failed cleanly "
                "(partial tokens in tokens_so_far) — resubmit to run on the restarted "
                "scheduler."
            )
            wrapped.__cause__ = error
            for v in victims:
                v._fail(wrapped)
        super()._on_crash(error)

    def close(self, drain: bool = False) -> None:
        if getattr(self, "_engine", None) is None:
            return
        if drain:
            try:
                self.drain()
            except Exception:
                pass  # per-stream errors are already delivered
        err = RuntimeError("DisaggScheduler closed with streams pending.")
        with self._lock:
            for rec in self._parked:
                rec[0]._fail(err)
            self._parked.clear()
            for i, s in enumerate(self._lane_stream):
                if s is not None:
                    s._fail(err)
                self._lane_stream[i] = None
                self._prefill_engine.release_slot(i)
        super().close(drain=False)

    # -- loop hooks ------------------------------------------------------

    def _has_work(self) -> bool:
        with self._lock:
            return (bool(self._queue) or bool(self._parked)
                    or any(s is not None for s in self._lane_stream)
                    or any(s is not None for s in self._slot_stream))

    def _expire_active(self) -> None:
        super()._expire_active()
        self._expire_parked()

    def _expire_parked(self) -> None:
        """The deadline sweep of the handoff queue. Caller holds
        ``_lock``."""
        now = time.perf_counter()
        if not any(rec[0].expired(now) for rec in self._parked):
            return
        kept = deque()
        for rec in self._parked:
            stream, lane = rec[0], rec[1]
            if stream.expired(now):
                if stream._expire() and self._metrics is not None:
                    self._metrics.record_deadline_expired()
                self._free_lane(lane)
            else:
                kept.append(rec)
        object.__setattr__(self, "_parked", kept)

    def _maybe_apply_swap(self) -> None:
        """One weight version per sequence across both roles: the swap
        waits until the queue's admitted part (lanes, parked handoffs,
        slots) has drained, then swaps the prefill engine and drops its
        prefix cache before the base swaps the decode role."""
        pending = getattr(self, "_swap_pending", None)
        if pending is None:
            return
        if self._parked or any(s is not None for s in self._lane_stream):
            return
        if any(s is not None for s in self._slot_stream):
            return
        params, model_state, _ = pending
        self._prefill_engine.swap_weights(params, model_state)
        self._prefill_engine.invalidate_prefix_cache()
        super()._maybe_apply_swap()

    # -- introspection ---------------------------------------------------

    def status(self) -> dict:
        """The base ``status()`` (the decode role's keys) plus the
        ``prefill`` and ``transfer`` sections."""
        out = super().status()
        pe = self._prefill_engine
        with self._lock:
            out["role_topology"] = "disagg"
            out["prefill"] = {
                "lanes": int(pe.slots),
                "busy_lanes": sum(1 for s in self._lane_stream if s is not None),
                "parked_handoffs": len(self._parked),
                "compiles": pe.compile_count,
                "recompiles_detected": pe.recompiles_detected,
                "kv_pool": pe.pool_status(),
            }
            out["transfer"] = self._transfer.status()
        return out
