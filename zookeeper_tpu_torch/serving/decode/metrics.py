"""Decode-path metrics: TTFT, inter-token latency, step times, slot
occupancy.

The port of ``zookeeper_tpu/serving/decode/metrics.py``'s
``DecodeMetrics``, built on the typed registry as ``ServingMetrics`` is:
every lifetime total is a ``Counter``, every sampled series feeds a
bounded window (exact ``np.percentile`` snapshots) plus a fixed-bucket
``Histogram``, and the instruments render live at ``/metrics``
(``LMServingConfig.metrics_port``) under the JAX package's series:
``zk_decode_*``, the speculative ``zk_spec_*``, the chunked-prefill
``zk_prefill_chunks_total`` and ``zk_prefill_stall_ms``, the pool's
``zk_kv_pool_free_pages`` and ``zk_prefix_cache_hit_rate``, and the
disaggregated handoffs' ``zk_transfer_*``. Recorders are O(1),
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
  drafts (``spec_accept_lengths``, and the ``zk_spec_accept_length``
  histogram);
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
from typing import Dict, Optional

import numpy as np

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.observability.registry import DEFAULT_MS_BUCKETS, MetricsRegistry
from zookeeper_tpu_torch.serving.metrics import _get_or_build_obs, _observe_sample, _reset_obs

__all__ = ["DecodeMetrics"]

_PREFIX = "zk_decode_"

#: Lifetime counters under the ``zk_decode_`` prefix, in ``totals`` order.
_COUNTER_NAMES = (
    "tokens_total",
    "requests_total",
    "prefills_total",
    "decode_steps_total",
    "rejected_total",
    "deadline_expired_total",
    "worker_restarts_total",
    "weight_swaps_total",
)

#: The feature families' counters, each under its own prefix, reported
#: after the decode family: (name in ``totals``, exposition name, help).
_FEATURE_COUNTERS = (
    ("prefill_chunks_total", "zk_prefill_chunks_total",
     "prefill chunk lanes dispatched (one per slot per chunk; a monolithic "
     "prefill counts zero)"),
    ("spec_draft_tokens_total", "zk_spec_draft_tokens_total",
     "draft tokens proposed across all speculative windows (k per slot per window)"),
    ("spec_accepted_tokens_total", "zk_spec_accepted_tokens_total",
     "draft tokens the teacher verify accepted (longest prefix match; ratio to "
     "proposed = acceptance rate)"),
    ("transfer_handoffs_total", "zk_transfer_handoffs_total",
     "completed page handoffs (one per stream admitted into a decode slot)"),
    ("transfer_pages_total", "zk_transfer_pages_total",
     "KV pages moved prefill->decode across all handoffs"),
    ("transfer_bytes", "zk_transfer_bytes",
     "KV bytes moved prefill->decode (real page bytes, padding lanes excluded)"),
)

#: Accept-length histogram buckets: accepted drafts per verify window.
_SPEC_ACCEPT_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16)

#: Windowed series, reported as ``<name>_p50_ms``/``_p99_ms``/``_mean_ms``.
_WINDOW_NAMES = ("ttft_ms", "token_ms", "prefill_ms", "transfer_ms", "itl_ms",
                 "prefill_stall_ms")


@component
class DecodeMetrics:
    """Bounded-window aggregator for decode samples; its API mirrors
    ``ServingMetrics``."""

    #: Samples retained per series; percentiles are over this window.
    window: int = Field(4096)

    def _obs(self) -> dict:
        return _get_or_build_obs(self, self._build_obs)

    def _build_obs(self) -> dict:
        registry = MetricsRegistry()
        counters = {name: registry.counter(_PREFIX + name, help=f"lifetime decode {name}")
                    for name in _COUNTER_NAMES}
        counters.update({name: registry.counter(series, help=text)
                         for name, series, text in _FEATURE_COUNTERS})

        def gauge(name, text, initial=0.0):
            return registry.gauge(name, help=text, initial=initial)

        return {
            "registry": registry,
            "counters": counters,
            "gauges": {
                "active_slots": gauge(_PREFIX + "active_slots",
                                      "sequence slots currently decoding"),
                "slot_occupancy": gauge(
                    _PREFIX + "slot_occupancy",
                    "active slots / total slots (1.0 = the slot array is the "
                    "bottleneck when the queue is nonempty)"),
                "queue_depth": gauge(_PREFIX + "queue_depth", "requests waiting for a slot"),
                "kv_pages_in_use": gauge(_PREFIX + "kv_pages_in_use",
                                         "KV pages holding live tokens across active slots"),
                "weights_step": gauge(
                    _PREFIX + "serving_weights_step",
                    "training step whose weights are live (-1 = bind-time weights)", -1),
                "spec_acceptance_rate": gauge(
                    "zk_spec_acceptance_rate",
                    "lifetime accepted/proposed draft-token fraction (-1 = no "
                    "speculative window yet)", -1),
                "kv_pool_free_pages": gauge(
                    "zk_kv_pool_free_pages",
                    "free pages in the shared KV page pool (-1 = slot layout, no pool)", -1),
                "prefix_cache_hit_rate": gauge(
                    "zk_prefix_cache_hit_rate",
                    "lifetime prompt-token fraction served from prefix-cache-shared "
                    "pages (-1 = no lookup yet or prefix cache off)", -1),
            },
            "hist": {
                "transfer_ms": registry.histogram(
                    "zk_transfer_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="one page handoff: export gather + device-to-device (or "
                    "host-bounce) move + import scatter"),
                "ttft_ms": registry.histogram(
                    _PREFIX + "ttft_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="submit-to-first-token wall time"),
                "token_ms": registry.histogram(
                    _PREFIX + "token_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="one decode dispatch (one token per active slot)"),
                "prefill_ms": registry.histogram(
                    _PREFIX + "prefill_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="one prefill dispatch (KV write + first token)"),
                "spec_accept_length": registry.histogram(
                    "zk_spec_accept_length", buckets=_SPEC_ACCEPT_BUCKETS,
                    help="accepted drafts per verify window per slot (0..k; mass at k "
                    "means raise k, mass at 0 means the draft disagrees with the "
                    "teacher)"),
                "itl_ms": registry.histogram(
                    _PREFIX + "itl_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="inter-token latency: wall time between consecutive "
                    "delivered tokens of one stream"),
                "prefill_stall_ms": registry.histogram(
                    "zk_prefill_stall_ms", buckets=DEFAULT_MS_BUCKETS,
                    help="per-request admission-to-first-token wall time under "
                    "chunked prefill"),
            },
            "windows": {},
            # Exact per-length counts behind ``spec_accept_lengths`` (the
            # histogram's buckets merge lengths past 4).
            "accept_lengths": {},
            "lock": threading.Lock(),
        }

    @property
    def registry(self) -> MetricsRegistry:
        """The instrument registry: attach it to an ``ObservabilityServer``
        to scrape every ``zk_decode_*`` series."""
        return self._obs()["registry"]

    def _observe(self, name: str, value: float) -> None:
        _observe_sample(self, self._obs(), name, value)

    def _inc(self, name: str, n: int = 1) -> None:
        self._obs()["counters"][name].inc(int(n))

    # -- recorders (called by DecodeScheduler) ---------------------------

    def record_ttft(self, ttft_ms: float) -> None:
        self._observe("ttft_ms", ttft_ms)

    def record_prefill(self, prefill_ms: float, requests: int) -> None:
        self._observe("prefill_ms", prefill_ms)
        self._inc("prefills_total")
        self._inc("requests_total", requests)

    def record_decode_step(self, step_ms: float, tokens: int) -> None:
        """One decode dispatch delivered ``tokens`` stream tokens."""
        self._observe("token_ms", step_ms)
        self._inc("decode_steps_total")
        self._inc("tokens_total", tokens)

    def record_first_tokens(self, n: int) -> None:
        """Prefill-emitted tokens count toward the token total too."""
        self._inc("tokens_total", n)

    def record_itl(self, gap_ms: float) -> None:
        self._observe("itl_ms", gap_ms)

    def record_prefill_chunks(self, chunks: int, dispatch_ms: float) -> None:
        """One chunked-prefill dispatch of ``chunks`` lanes (one slot's
        chunk each); its wall time joins the prefill series."""
        self._inc("prefill_chunks_total", chunks)
        self._inc("prefills_total")
        self._observe("prefill_ms", dispatch_ms)

    def record_prefill_finish(self, requests: int, stall_ms) -> None:
        """``requests`` prompts' final chunks landed: admitted requests
        now, each with its admission-to-first-token wall time."""
        self._inc("requests_total", requests)
        for ms in stall_ms:
            self._observe("prefill_stall_ms", float(ms))

    def record_spec_window(self, proposed: int, accepted: int, accept_lengths,
                           window_ms: float, delivered: int) -> None:
        """One speculative window committed: ``proposed``/``accepted``
        drafts over its slots, each slot's accepted count, the window's
        wall time in the decode series (a window is the speculative
        path's decode dispatch) and ``delivered`` stream tokens."""
        obs = self._obs()
        counters = obs["counters"]
        counters["spec_draft_tokens_total"].inc(int(proposed))
        counters["spec_accepted_tokens_total"].inc(int(accepted))
        counters["tokens_total"].inc(int(delivered))
        counters["decode_steps_total"].inc()
        self._observe("token_ms", float(window_ms))
        with obs["lock"]:
            for a in accept_lengths:
                obs["accept_lengths"][int(a)] = obs["accept_lengths"].get(int(a), 0) + 1
        for a in accept_lengths:
            obs["hist"]["spec_accept_length"].observe(float(a))
        total_p = counters["spec_draft_tokens_total"].value
        total_a = counters["spec_accepted_tokens_total"].value
        obs["gauges"]["spec_acceptance_rate"].set(total_a / total_p if total_p else -1.0)

    def record_occupancy(self, active: int, slots: int, queue_depth: int,
                         kv_pages: int) -> None:
        gauges = self._obs()["gauges"]
        gauges["active_slots"].set(int(active))
        gauges["slot_occupancy"].set(active / slots if slots else 0.0)
        gauges["queue_depth"].set(int(queue_depth))
        gauges["kv_pages_in_use"].set(int(kv_pages))

    def record_pool(self, free_pages: int, hit_rate: float) -> None:
        """The pool's real free-page count and the prefix cache's
        lifetime token hit rate."""
        gauges = self._obs()["gauges"]
        gauges["kv_pool_free_pages"].set(int(free_pages))
        gauges["prefix_cache_hit_rate"].set(float(hit_rate))

    def record_transfer(self, pages: int, nbytes: int, transfer_ms: float) -> None:
        """One completed page handoff: ``pages`` real pages and ``nbytes``
        real bytes moved from the prefill role to the decode role, in
        ``transfer_ms`` wall milliseconds."""
        self._inc("transfer_handoffs_total")
        self._inc("transfer_pages_total", pages)
        self._inc("transfer_bytes", nbytes)
        self._observe("transfer_ms", float(transfer_ms))

    def record_weight_swap(self, step: Optional[int] = None) -> None:
        """A staged weight swap applied (``step``: the training step now
        live, when known)."""
        self._inc("weight_swaps_total")
        if step is not None:
            self._obs()["gauges"]["weights_step"].set(int(step))

    def record_rejected(self) -> None:
        self._inc("rejected_total")

    def record_deadline_expired(self) -> None:
        self._inc("deadline_expired_total")

    def record_worker_restart(self) -> None:
        self._inc("worker_restarts_total")

    # -- reduction -------------------------------------------------------

    @property
    def weights_step(self) -> int:
        """The live training step (-1: the bind-time weights); stamped
        onto RequestLog summaries."""
        return int(self._obs()["gauges"]["weights_step"].value)

    @property
    def totals(self) -> Dict[str, int]:
        counters = self._obs()["counters"]
        return {name: int(counters[name].value)
                for name in _COUNTER_NAMES + tuple(n for n, _, _ in _FEATURE_COUNTERS)}

    @property
    def spec_accept_lengths(self) -> Dict[int, int]:
        """Speculative windows by accepted drafts (per slot and window)."""
        obs = self._obs()
        with obs["lock"]:
            return dict(sorted(obs["accept_lengths"].items()))

    @property
    def gauges(self) -> Dict[str, float]:
        return {name: float(g.value) for name, g in self._obs()["gauges"].items()}

    def snapshot(self) -> Dict[str, float]:
        """Counters plus p50/p99/mean of every non-empty window, as a flat
        ``{name: float}`` mapping."""
        windows = self._obs()["windows"]
        out: Dict[str, float] = {k: float(v) for k, v in self.totals.items()}
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

    def reset(self) -> None:
        """Zero every series IN PLACE (a live ``/metrics`` server keeps
        rendering)."""
        _reset_obs(self)
        obs = getattr(self, "_obs_state", None)
        if obs is not None:
            with obs["lock"]:
                obs["accept_lengths"].clear()
