"""Paged KV: the shared device page pool, its host-side allocator and
the radix prefix cache.

The port of ``zookeeper_tpu/serving/decode/pages.py``. KV rows live in
per-layer pools of fixed-size pages ``[num_pages, page_size, heads,
head_dim]``; a slot's logical page ``p`` resolves through the ``[slots,
max_pages]`` int32 page table the dispatches carry as an operand.

- :class:`PagePool` owns the indices: the free list, per-page reference
  counts and the table. Admission allocates a prompt's pages, each
  decode or verify dispatch is preceded by an ``ensure_rows`` covering
  its writes, release unreferences; a page frees when its last reference
  (the slots' and the prefix cache's) drops.
- :class:`RadixPrefixCache` is a trie over prompt prefixes at page-chunk
  granularity. A warm admission references the pages of the longest
  cached prefix instead of recomputing them; sharing is copy-on-write at
  the divergence point: the page holding the first divergent position is
  copied to a fresh page before the new occupant writes into it (full
  pages before it are never written, since writes land only at ``j >=
  length``). Nodes only the cache references are evicted LRU under pool
  pressure. A cached page holds the bytes a cold prefill of the same
  prefix under the same weights writes, so a weight swap must drop the
  cache.
- An int8 pool stores rows int8 with ``[num_pages, page_size, heads]``
  float32 scales (``ops.quantizers.quantize_kv_rows``), dequantized
  inside the attention read.

Under a partitioner (``shard``, a ``parallel.shards.DecodeShard``) a
rank allocates and counts its heads of every page: the pages never split
(any slot may reference any page), so each data rank holds a whole copy.
The table, the refcounts and the trie are host state, the same on every
rank.

Validity is the slot layout's: a slot's row ``j`` is meaningful iff
``j < length``, wherever the table put it; a recycled page's old rows
sit past the new occupant's length and are never attended.
"""

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from zookeeper_tpu_torch.serving.decode.prefix_key import walk_insert, walk_match

__all__ = ["PagePool", "RadixPrefixCache", "allocate_page_pool", "page_pool_bytes"]


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




class _TrieNode:
    __slots__ = ("chunk", "page", "children", "parent", "last_used")

    def __init__(self, chunk: Tuple[int, ...], page: int, parent) -> None:
        self.chunk = chunk
        self.page = int(page)
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """Radix trie over prompt token prefixes, keyed by page chunks.

    Interior nodes hold one full ``page_size`` chunk each (the page
    covering those positions); a leaf may hold a partial tail chunk.
    Lookup walks exact full-chunk matches, then the longest common prefix
    against any child's chunk: a partial hit shares that child's page,
    which the caller copies before its first write lands in it.

    The cache holds its own reference on every node's page (``ref`` /
    ``unref``, the pool's refcounts), so cached pages outlive their
    inserting slot; :meth:`evict_lru` drops least-recently-used childless
    nodes whose page only the cache references (``evictable``), the only
    evictions that free pool pages; :meth:`clear` drops everything."""

    def __init__(self, page_size: int, ref, unref, evictable) -> None:
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1.")
        self.page_size = int(page_size)
        self._ref = ref
        self._unref = unref
        self._evictable = evictable
        self._root = _TrieNode((), -1, None)
        self._clock = 0
        #: Token-level accounting behind the hit rate.
        self.lookup_tokens = 0
        self.hit_tokens = 0
        self.lookups = 0
        self.hits = 0
        self.evicted_pages = 0
        self.invalidations = 0

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    @property
    def nodes(self) -> int:
        count = 0
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            count += len(n.children)
        return count

    @property
    def hit_rate(self) -> float:
        """Lifetime shared-token fraction (-1 before any lookup)."""
        if not self.lookup_tokens:
            return -1.0
        return self.hit_tokens / self.lookup_tokens

    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: ``(t, pages)``, the first
        ``t`` tokens covered by the ``ceil(t / page_size)`` cached
        ``pages`` (the last one partly when ``t`` is off a page edge). The
        caller caps ``t`` and takes its own references on the pages it
        adopts."""
        tokens = [int(x) for x in tokens]
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        t, visited = walk_match(self._root, tokens, self.page_size)
        pages: List[int] = []
        for node in visited:
            pages.append(node.page)
            self._touch(node)
        if t:
            self.hits += 1
            self.hit_tokens += t
        return t, pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Cache ``tokens``' pages (``pages[i]`` covers positions
        ``[i * page_size, (i + 1) * page_size)``, the last possibly
        partial). Existing nodes keep their page: the bytes are the same,
        and other sharers hold it. Returns the nodes (cache references)
        created."""
        ps = self.page_size
        tokens = [int(x) for x in tokens]
        created = 0
        visited = walk_insert(
            self._root, tokens, ps,
            lambda chunk, i, parent: _TrieNode(chunk, pages[i], parent),
            # A partial tail is cached only when a page covers it.
            tail=len(pages) > len(tokens) // ps,
        )
        for node, was_created in visited:
            if was_created:
                self._ref(node.page)
                created += 1
            self._touch(node)
        return created

    def evict_lru(self, want_pages: int) -> int:
        """Free pool pages by dropping LRU childless nodes whose page only
        the cache references. Returns the pages freed (fewer than
        ``want_pages`` when the rest is shared with a live slot or
        interior). One walk collects every evictable leaf and frees them
        in LRU order; it walks again only when evictions exposed new
        leaves."""
        freed = 0
        while freed < want_pages:
            leaves = []
            stack = [self._root]
            while stack:
                n = stack.pop()
                for child in n.children.values():
                    if child.children:
                        stack.append(child)
                    elif self._evictable(child.page):
                        leaves.append(child)
            if not leaves:
                return freed
            leaves.sort(key=lambda n: n.last_used)
            for victim in leaves:
                if freed >= want_pages:
                    return freed
                del victim.parent.children[victim.chunk]
                self._unref(victim.page)
                self.evicted_pages += 1
                freed += 1
        return freed

    def clear(self) -> int:
        """Drop every node and its reference (a weight swap's
        invalidation, counted whether or not nodes were dropped). Returns
        the nodes dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._unref(n.page)
            dropped += 1
        self._root = _TrieNode((), -1, None)
        self.invalidations += 1
        return dropped


class PagePool:
    """Host-side page allocator, page table and (``prefix_cache``) radix
    prefix cache for one engine's pool.

    Not thread-safe by itself: the scheduler calls every mutator under
    its own lock. Under a partitioner every rank holds the same host
    state (the ranks make the same dispatches)."""

    def __init__(self, *, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int, prefix_cache: bool = True) -> None:
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
        self.cow_pages = 0
        self.exhausted_events = 0
        self.prefix: Optional[RadixPrefixCache] = (
            self._new_prefix_cache() if prefix_cache else None)

    def _new_prefix_cache(self) -> RadixPrefixCache:
        return RadixPrefixCache(self.page_size, ref=self._ref, unref=self._unref,
                                evictable=lambda p: int(self.refcount[p]) == 1)

    # -- refcounting -----------------------------------------------------

    def _ref(self, page: int) -> None:
        self.refcount[page] += 1

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

    def pages_for(self, tokens: int) -> int:
        return max(0, math.ceil(int(tokens) / self.page_size))

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages, evicting prefix-cache nodes under
        pressure; None (nothing allocated beyond the evictions) when the
        pool cannot serve them."""
        if len(self._free) < n and self.prefix is not None:
            self.prefix.evict_lru(n - len(self._free))
        if len(self._free) < n:
            self.exhausted_events += 1
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refcount[p] += 1
        return out

    # -- slot lifecycle --------------------------------------------------

    def assign_prompt(self, slot: int, prompt) -> Optional[dict]:
        """Admission: build ``slot``'s table row for ``prompt`` (1-D int
        tokens), sharing the longest cached prefix when the prefix cache
        is on. Returns the plan

        - ``shared_tokens``: prompt tokens whose K/V is already resident
          (the warm dispatch computes only the suffix);
        - ``cow``: ``(src_page, dst_page)`` when the divergence lands
          mid-page: ``src`` must be copied into ``dst`` before the suffix
          dispatch writes into it;

        or None when the pool cannot serve the prompt (nothing
        allocated)."""
        if self.counts[slot]:
            raise AssertionError(
                f"slot {slot} still holds pages at admission; release first."
            )
        prompt = [int(x) for x in np.asarray(prompt).tolist()]
        length = len(prompt)
        shared_tokens = 0
        shared_pages: List[int] = []
        if self.prefix is not None:
            t, pages = self.prefix.lookup(prompt)
            # Never the whole prompt: the last token is always recomputed,
            # so the warm dispatch has the first emission's logits.
            t = min(t, length - 1)
            shared_tokens = t
            shared_pages = pages[: self.pages_for(t)]
        n_full_shared = shared_tokens // self.page_size
        partial = shared_tokens % self.page_size != 0
        fresh = self._alloc(self.pages_for(length) - n_full_shared)
        if fresh is None:
            return None
        row = list(shared_pages[:n_full_shared]) + fresh
        for p in shared_pages[:n_full_shared]:
            self._ref(p)
        cow = None
        if partial:
            # The suffix writes into this page at offset shared_tokens %
            # page_size: its shared rows go to the first fresh page.
            cow = (int(shared_pages[n_full_shared]), int(fresh[0]))
            self.cow_pages += 1
        self.table[slot, : len(row)] = row
        self.counts[slot] = len(row)
        return {"shared_tokens": shared_tokens, "cow": cow}

    def adopt_slot(self, slot: int, n_pages: int) -> Optional[List[int]]:
        """The destination side of a disaggregated handoff: allocate
        ``n_pages`` fresh pages as ``slot``'s table row, with no prefix
        lookup and no sharing (their contents arrive by page transfer
        from another engine's pool). Returns the pages (the transfer's
        targets), or None when the pool cannot serve them (nothing
        changed but evictions). A failed transfer unwinds with
        :meth:`release_slot`."""
        if self.counts[slot]:
            raise AssertionError(
                f"slot {slot} still holds pages at adoption; release first."
            )
        n_pages = int(n_pages)
        if n_pages < 1 or n_pages > self.max_pages_per_slot:
            raise ValueError(
                f"adopt_slot needs 1..{self.max_pages_per_slot} pages, got {n_pages}."
            )
        fresh = self._alloc(n_pages)
        if fresh is None:
            return None
        self.table[slot, :n_pages] = fresh
        self.counts[slot] = n_pages
        return fresh

    def ensure_rows(self, slot: int, rows: int) -> bool:
        """Grow ``slot``'s pages to cover ``rows`` KV rows (a decode
        step's ``length + 1``, a verify window's ``length + w``); False
        (nothing allocated) when the pool is exhausted after eviction."""
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
        """Drop the slot's references: pages the prefix cache also holds
        stay resident, the rest return to the free list."""
        n = int(self.counts[slot])
        for i in range(n):
            self._unref(int(self.table[slot, i]))
        self.table[slot, :n] = -1
        self.counts[slot] = 0

    def insert_prefix(self, slot: int, prompt) -> int:
        """Cache the slot's prompt pages for later warm hits (after the
        dispatch that wrote them). Returns the nodes created."""
        if self.prefix is None:
            return 0
        prompt = np.asarray(prompt)
        n = self.pages_for(int(prompt.shape[0]))
        return self.prefix.insert(prompt.tolist(), [int(p) for p in self.table[slot, :n]])

    def invalidate_prefix(self) -> int:
        """A weight swap's invalidation: cached pages hold the old
        weights' K/V. Returns the nodes dropped."""
        if self.prefix is None:
            return 0
        return self.prefix.clear()

    def reset(self) -> None:
        """Back to the freshly built state (for a reallocated, zeroed
        pool): table cleared, refcounts zeroed, every page free, the trie
        dropped. The lifetime counters (copies, evictions, hits) survive;
        the drop counts as an invalidation."""
        self.table.fill(-1)
        self.counts.fill(0)
        self.refcount.fill(0)
        self._free = list(range(self.num_pages - 1, -1, -1))
        if self.prefix is not None:
            old, fresh = self.prefix, self._new_prefix_cache()
            for name in ("lookup_tokens", "hit_tokens", "lookups", "hits", "evicted_pages"):
                setattr(fresh, name, getattr(old, name))
            fresh.invalidations = old.invalidations + 1
            self.prefix = fresh

    # -- accounting ------------------------------------------------------

    @property
    def prefix_hit_rate(self) -> float:
        """The prefix cache's lifetime shared-token fraction (-1 before
        any lookup, or without the cache)."""
        if self.prefix is None:
            return -1.0
        return self.prefix.hit_rate

    def leak_check(self) -> int:
        """Pages off the free list that nothing references (must be 0)."""
        return self.num_pages - len(self._free) - int(np.sum(self.refcount > 0))

    def status(self) -> dict:
        out = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "fill": round(self.used_pages / self.num_pages, 4),
            "cow_pages": self.cow_pages,
            "exhausted_events": self.exhausted_events,
            "leaked": self.leak_check(),
        }
        if self.prefix is not None:
            out.update(
                prefix_nodes=self.prefix.nodes,
                prefix_lookups=self.prefix.lookups,
                prefix_hits=self.prefix.hits,
                prefix_hit_rate=round(self.prefix.hit_rate, 4),
                prefix_evicted_pages=self.prefix.evicted_pages,
                prefix_invalidations=self.prefix.invalidations,
            )
        return out
