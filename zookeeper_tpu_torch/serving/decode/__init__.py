"""Continuous-batching LM decode serving: the port of
``zookeeper_tpu/serving/decode``.

- :mod:`~zookeeper_tpu_torch.serving.decode.cache` — the slot layout's
  KV buffers ``[slots, capacity, heads, head_dim]``;
- :mod:`~zookeeper_tpu_torch.serving.decode.pages` — the shared page
  pool and its allocator (:class:`PagePool`), int8 rows optional, and
  the radix prefix cache (:class:`RadixPrefixCache`, copy-on-write
  pages); :mod:`~zookeeper_tpu_torch.serving.decode.prefix_key` — the
  page-chunk keying it shares with a router's :class:`PrefixIndex`;
- :class:`DecodeEngine` — bucketed prefill (K9), the one-token-per-
  slot decode step (K12, or K13 through page tables), the verify window,
  the warm-prefix and chunk prefills and the page copy;
- :class:`DecodeScheduler` / :class:`DecodeStream` — slot-refill
  continuous batching with deadlines, shedding and crash recovery,
  warm admissions, chunked prefill under a token budget and the
  speculative schedule;
- :class:`SpeculativeDecoding` — the draft engine of greedy speculative
  decoding;
- :class:`DecodeMetrics` — TTFT, inter-token and step latencies,
  counters and occupancy gauges;
- :class:`LMServingConfig` — the CLI task::

      python -m zookeeper_tpu_torch.serving.decode LMServingConfig key=value ...
"""

from zookeeper_tpu_torch.serving.decode.cache import (
    allocate_kv_cache,
    append_kv_rows,
    kv_cache_bytes,
    pages_in_use,
)
from zookeeper_tpu_torch.serving.decode.engine import DecodeEngine
from zookeeper_tpu_torch.serving.decode.metrics import DecodeMetrics
from zookeeper_tpu_torch.serving.decode.pages import (
    PagePool,
    RadixPrefixCache,
    allocate_page_pool,
    page_pool_bytes,
)
from zookeeper_tpu_torch.serving.decode.prefix_key import PrefixIndex
from zookeeper_tpu_torch.serving.decode.scheduler import DecodeScheduler, DecodeStream
from zookeeper_tpu_torch.serving.decode.service import LMServingConfig
from zookeeper_tpu_torch.serving.decode.speculative import SpeculativeDecoding

__all__ = [
    "DecodeEngine",
    "DecodeMetrics",
    "DecodeScheduler",
    "DecodeStream",
    "LMServingConfig",
    "PagePool",
    "PrefixIndex",
    "RadixPrefixCache",
    "SpeculativeDecoding",
    "allocate_kv_cache",
    "allocate_page_pool",
    "append_kv_rows",
    "kv_cache_bytes",
    "page_pool_bytes",
    "pages_in_use",
]
