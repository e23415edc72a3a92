"""Paged KV: the shared device page pool and its host-side allocator.

The port of ``zookeeper_tpu/serving/decode/pages.py`` without the radix
prefix cache (ROADMAP.md). KV rows live in per-layer pools of fixed-size
pages ``[num_pages, page_size, heads, head_dim]``; a slot's logical page
``p`` resolves through the ``[slots, max_pages]`` int32 page table the
decode steps carry as an operand. :class:`PagePool` owns the indices:
the free list, per-page reference counts and the table. Admission
allocates a prompt's pages, each decode step is preceded by an
``ensure_rows`` covering its write, release unreferences. An int8 pool
stores rows int8 with ``[num_pages, page_size, heads]`` float32 scales
(``ops.quantizers.quantize_kv_rows``), dequantized inside the attention
read.

Under a partitioner (``shard``, a ``parallel.shards.DecodeShard``) a
rank allocates and counts its heads of every page: the pages never split
(any slot may reference any page), so each data rank holds a whole copy.

Validity is the slot layout's: a slot's row ``j`` is meaningful iff
``j < length``, wherever the table put it; a recycled page's old rows
sit past the new occupant's length and are never attended.
"""

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PagePool", "allocate_page_pool", "page_pool_bytes"]


def allocate_page_pool(
    num_layers: int,
    num_pages: int,
    page_size: int,
    num_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    quant: str = "none",
    device: Any = "cpu",
    shard: Any = None,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Zeroed page pools: a per-layer tuple of ``{"k", "v"}`` pools
    ``[num_pages, page_size, heads, head_dim]``, plus ``{"k_scale",
    "v_scale"}`` ``[num_pages, page_size, heads]`` float32 (all 1, so a
    zeroed page dequantizes to zeros) when ``quant="int8"``."""
    if num_pages < 1 or page_size < 1:
        raise ValueError(
            f"page pool needs num_pages >= 1 and page_size >= 1, got "
            f"num_pages={num_pages}, page_size={page_size}."
        )
    if quant not in ("none", "int8"):
        raise ValueError(f"quant={quant!r}: expected 'none' or 'int8'.")
    shape = (num_pages, page_size, num_heads, head_dim)
    if shard is not None:
        shape = shard.pool_shape(*shape)
    row_dtype = torch.int8 if quant == "int8" else dtype
    layers = []
    for _ in range(num_layers):
        layer = {
            "k": torch.zeros(shape, dtype=row_dtype, device=device),
            "v": torch.zeros(shape, dtype=row_dtype, device=device),
        }
        if quant == "int8":
            layer["k_scale"] = torch.ones(shape[:3], dtype=torch.float32, device=device)
            layer["v_scale"] = torch.ones(shape[:3], dtype=torch.float32, device=device)
        layers.append(layer)
    return tuple(layers)


def page_pool_bytes(
    num_layers: int,
    num_pages: int,
    page_size: int,
    num_heads: int,
    head_dim: int,
    itemsize: int,
    quant: str = "none",
    shard: Any = None,
) -> int:
    """Device memory the pool occupies (k + v rows, all layers, plus the
    scales when quantized): one rank's under a ``shard``."""
    if shard is not None:
        num_heads = shard.local_heads(num_heads)
    rows = 2 * num_layers * num_pages * page_size * num_heads
    total = rows * head_dim * (1 if quant == "int8" else itemsize)
    if quant == "int8":
        total += rows * 4
    return total


class PagePool:
    """Host-side page allocator and page table for one engine's pool.

    Not thread-safe by itself: the scheduler calls every mutator under
    its own lock."""

    def __init__(self, *, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int) -> None:
        if num_pages < max_pages_per_slot:
            raise ValueError(
                f"num_pages={num_pages} below max_pages_per_slot="
                f"{max_pages_per_slot}: one full-capacity sequence could "
                "never be served."
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        #: The page-table operand: -1 = unallocated (masked by lengths).
        self.table = np.full((self.slots, self.max_pages_per_slot), -1, np.int32)
        self.counts = np.zeros(self.slots, np.int32)
        self.refcount = np.zeros(self.num_pages, np.int32)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self.exhausted_events = 0

    def _unref(self, page: int) -> None:
        self.refcount[page] -= 1
        if self.refcount[page] < 0:
            raise AssertionError(f"page {page} refcount went negative.")
        if self.refcount[page] == 0:
            self._free.append(int(page))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def prefix_hit_rate(self) -> float:
        """-1: the prefix cache is not ported."""
        return -1.0

    def pages_for(self, tokens: int) -> int:
        return max(0, math.ceil(int(tokens) / self.page_size))

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages, or None (nothing allocated) when the
        pool cannot serve them."""
        if len(self._free) < n:
            self.exhausted_events += 1
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refcount[p] += 1
        return out

    def assign_prompt(self, slot: int, prompt) -> Optional[dict]:
        """Admission: allocate ``slot``'s pages for ``prompt`` and build its
        table row. Returns the plan ``{"shared_tokens": 0, "cow": None}``
        (every admission is cold), or None when the pool cannot serve
        the prompt (nothing allocated)."""
        if self.counts[slot]:
            raise AssertionError(
                f"slot {slot} still holds pages at admission; release first."
            )
        fresh = self._alloc(self.pages_for(int(np.asarray(prompt).shape[0])))
        if fresh is None:
            return None
        self.table[slot, : len(fresh)] = fresh
        self.counts[slot] = len(fresh)
        return {"shared_tokens": 0, "cow": None}

    def ensure_rows(self, slot: int, rows: int) -> bool:
        """Grow ``slot``'s pages to cover ``rows`` KV rows; False (nothing
        allocated) when the pool is exhausted."""
        needed = self.pages_for(rows)
        if needed > self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot} needs {needed} pages for {rows} rows, table "
                f"holds {self.max_pages_per_slot}."
            )
        have = int(self.counts[slot])
        if needed <= have:
            return True
        fresh = self._alloc(needed - have)
        if fresh is None:
            return False
        self.table[slot, have:needed] = fresh
        self.counts[slot] = needed
        return True

    def release_slot(self, slot: int) -> None:
        """Drop the slot's references; its pages return to the free list."""
        n = int(self.counts[slot])
        for i in range(n):
            self._unref(int(self.table[slot, i]))
        self.table[slot, :n] = -1
        self.counts[slot] = 0

    def leak_check(self) -> int:
        """Pages off the free list that nothing references (must be 0)."""
        return self.num_pages - len(self._free) - int(np.sum(self.refcount > 0))

    def status(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "fill": round(self.used_pages / self.num_pages, 4),
            "exhausted_events": self.exhausted_events,
            "leaked": self.leak_check(),
        }
