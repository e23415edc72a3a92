"""Decode-path metrics: TTFT, inter-token latency, step times, slot
occupancy.

The port of ``zookeeper_tpu/serving/decode/metrics.py``'s
``DecodeMetrics``, stored as the port's ``ServingMetrics`` stores its
series (lifetime counters, bounded windows reduced by ``snapshot()``);
the Prometheus registry waits (ROADMAP.md). Recorders are O(1),
thread-safe and host-side: recording never synchronises the card.

- ``ttft_ms``: submit-to-first-token wall time;
- ``token_ms``: one decode dispatch (one token for every active slot);
- ``prefill_ms``: one prefill dispatch;
- ``itl_ms``: the gap between consecutive tokens of one stream;
- ``prefill_stall_ms``: under chunked prefill, a request's admission to
  its first token;
- counters of the serving features: ``prefill_chunks_total`` (chunk
  lanes dispatched), ``spec_draft_tokens_total`` and
  ``spec_accepted_tokens_total`` (their ratio the acceptance rate, also
  in ``snapshot()``), and per speculative window and slot the accepted
  drafts (``spec_accept_lengths``);
- the staged weight swaps (``weight_swaps_total``, the live training
  step in the ``weights_step`` gauge, -1 for the bind-time weights) and
  the disaggregated page handoffs: ``transfer_handoffs_total``,
  ``transfer_pages_total``, ``transfer_bytes`` (real pages only) and the
  ``transfer_ms`` window;
- gauges: active slots, slot occupancy, queue depth, KV pages in use,
  free pool pages (-1 in the slot layout), the prefix cache's token hit
  rate (-1 before a lookup or without the cache) and the acceptance
  rate (-1 before a window).
"""

import threading
from collections import deque
from typing import Dict

import numpy as np

from zookeeper_tpu_torch.core import Field, component

__all__ = ["DecodeMetrics"]

#: Lifetime counters, in ``totals`` reporting order.
_COUNTER_NAMES = (
    "tokens_total",
    "requests_total",
    "prefills_total",
    "decode_steps_total",
    "rejected_total",
    "deadline_expired_total",
    "worker_restarts_total",
    "weight_swaps_total",
    "prefill_chunks_total",
    "spec_draft_tokens_total",
    "spec_accepted_tokens_total",
    "transfer_handoffs_total",
    "transfer_pages_total",
    "transfer_bytes",
)

#: Windowed series, reported as ``<name>_p50_ms``/``_p99_ms``/``_mean_ms``.
_WINDOW_NAMES = ("ttft_ms", "token_ms", "prefill_ms", "transfer_ms", "itl_ms",
                 "prefill_stall_ms")


@component
class DecodeMetrics:
    """Bounded-window aggregator for decode samples."""

    #: Samples retained per series; percentiles are over this window.
    window: int = Field(4096)

    def _state(self) -> dict:
        state = getattr(self, "_obs_state", None)
        if state is None:
            state = {
                "lock": threading.Lock(),
                "counters": dict.fromkeys(_COUNTER_NAMES, 0),
                "gauges": {
                    "active_slots": 0.0, "slot_occupancy": 0.0, "queue_depth": 0.0,
                    "kv_pages_in_use": 0.0, "kv_pool_free_pages": -1.0,
                    "prefix_cache_hit_rate": -1.0, "spec_acceptance_rate": -1.0,
                    "weights_step": -1.0,
                },
                "accept_lengths": {},
                "windows": {},
            }
            object.__setattr__(self, "_obs_state", state)
        return state

    def _count(self, name: str, n: int = 1) -> None:
        state = self._state()
        with state["lock"]:
            state["counters"][name] += int(n)

    def _observe(self, name: str, value: float) -> None:
        state = self._state()
        with state["lock"]:
            series = state["windows"].setdefault(
                name, deque(maxlen=max(1, int(self.window)))
            )
            series.append(float(value))

    def _set(self, **gauges: float) -> None:
        state = self._state()
        with state["lock"]:
            state["gauges"].update({k: float(v) for k, v in gauges.items()})

    # -- recorders (called by DecodeScheduler) ---------------------------

    def record_ttft(self, ttft_ms: float) -> None:
        self._observe("ttft_ms", ttft_ms)

    def record_prefill(self, prefill_ms: float, requests: int) -> None:
        self._observe("prefill_ms", prefill_ms)
        self._count("prefills_total")
        self._count("requests_total", requests)

    def record_decode_step(self, step_ms: float, tokens: int) -> None:
        """One decode dispatch delivered ``tokens`` stream tokens."""
        self._observe("token_ms", step_ms)
        self._count("decode_steps_total")
        self._count("tokens_total", tokens)

    def record_first_tokens(self, n: int) -> None:
        """Prefill-emitted tokens count toward the token total too."""
        self._count("tokens_total", n)

    def record_itl(self, gap_ms: float) -> None:
        self._observe("itl_ms", gap_ms)

    def record_prefill_chunks(self, chunks: int, dispatch_ms: float) -> None:
        """One chunked-prefill dispatch of ``chunks`` lanes (one slot's
        chunk each); its wall time joins the prefill series."""
        self._count("prefill_chunks_total", chunks)
        self._count("prefills_total")
        self._observe("prefill_ms", dispatch_ms)

    def record_prefill_finish(self, requests: int, stall_ms) -> None:
        """``requests`` prompts' final chunks landed: admitted requests
        now, each with its admission-to-first-token wall time."""
        self._count("requests_total", requests)
        for ms in stall_ms:
            self._observe("prefill_stall_ms", ms)

    def record_spec_window(self, proposed: int, accepted: int, accept_lengths,
                           window_ms: float, delivered: int) -> None:
        """One speculative window committed: ``proposed``/``accepted``
        drafts over its slots, each slot's accepted count, the window's
        wall time in the decode series (a window is the speculative
        path's decode dispatch) and ``delivered`` stream tokens."""
        state = self._state()
        with state["lock"]:
            counters = state["counters"]
            counters["spec_draft_tokens_total"] += int(proposed)
            counters["spec_accepted_tokens_total"] += int(accepted)
            counters["tokens_total"] += int(delivered)
            counters["decode_steps_total"] += 1
            for a in accept_lengths:
                state["accept_lengths"][int(a)] = state["accept_lengths"].get(int(a), 0) + 1
            total = counters["spec_draft_tokens_total"]
            state["gauges"]["spec_acceptance_rate"] = (
                counters["spec_accepted_tokens_total"] / total if total else -1.0)
        self._observe("token_ms", window_ms)

    def record_occupancy(self, active: int, slots: int, queue_depth: int,
                         kv_pages: int) -> None:
        self._set(active_slots=active, slot_occupancy=active / slots if slots else 0.0,
                  queue_depth=queue_depth, kv_pages_in_use=kv_pages)

    def record_pool(self, free_pages: int, hit_rate: float) -> None:
        self._set(kv_pool_free_pages=free_pages, prefix_cache_hit_rate=hit_rate)

    def record_transfer(self, pages: int, nbytes: int, transfer_ms: float) -> None:
        """One completed page handoff: ``pages`` real pages and ``nbytes``
        real bytes moved from the prefill role to the decode role, in
        ``transfer_ms`` wall milliseconds."""
        state = self._state()
        with state["lock"]:
            counters = state["counters"]
            counters["transfer_handoffs_total"] += 1
            counters["transfer_pages_total"] += int(pages)
            counters["transfer_bytes"] += int(nbytes)
        self._observe("transfer_ms", transfer_ms)

    def record_weight_swap(self, step=None) -> None:
        """A staged weight swap applied (``step``: the training step now
        live, when known)."""
        self._count("weight_swaps_total")
        if step is not None:
            self._set(weights_step=int(step))

    def record_rejected(self) -> None:
        self._count("rejected_total")

    def record_deadline_expired(self) -> None:
        self._count("deadline_expired_total")

    def record_worker_restart(self) -> None:
        self._count("worker_restarts_total")

    # -- reduction -------------------------------------------------------

    @property
    def totals(self) -> Dict[str, int]:
        state = self._state()
        with state["lock"]:
            return dict(state["counters"])

    @property
    def spec_accept_lengths(self) -> Dict[int, int]:
        """Speculative windows by accepted drafts (per slot and window)."""
        state = self._state()
        with state["lock"]:
            return dict(sorted(state["accept_lengths"].items()))

    @property
    def gauges(self) -> Dict[str, float]:
        state = self._state()
        with state["lock"]:
            return dict(state["gauges"])

    def snapshot(self) -> Dict[str, float]:
        """Counters plus p50/p99/mean of every non-empty window, as a flat
        ``{name: float}`` mapping."""
        state = self._state()
        with state["lock"]:
            windows = {k: list(v) for k, v in state["windows"].items()}
            out: Dict[str, float] = {k: float(v) for k, v in state["counters"].items()}
        if out["spec_draft_tokens_total"]:
            out["spec_acceptance_rate"] = (out["spec_accepted_tokens_total"]
                                           / out["spec_draft_tokens_total"])
        for name in _WINDOW_NAMES:
            series = windows.get(name)
            if series:
                arr = np.asarray(series)
                out[f"{name[:-3]}_p50_ms"] = float(np.percentile(arr, 50))
                out[f"{name[:-3]}_p99_ms"] = float(np.percentile(arr, 99))
                out[f"{name[:-3]}_mean_ms"] = float(arr.mean())
        return out
