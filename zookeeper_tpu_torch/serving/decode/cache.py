"""KV-cache state of the slot layout.

The port of ``zookeeper_tpu/serving/decode/cache.py``: per transformer
layer one ``k`` and one ``v`` buffer ``[slots, capacity, heads,
head_dim]`` in the model's compute dtype, held on the device by the
decode engine and written in place by every prefill and decode step.
``capacity`` is page-aligned; one slot's rows are contiguous.

Validity invariant (the slot-refill contract): a slot's row ``j`` is
meaningful iff ``j < length`` for its current occupant. Prefill writes
rows ``[0, seq_bucket)`` (rows past the prompt hold padding garbage), a
decode step writes row ``length`` and then advances ``length``, so
garbage always sits at ``j >= length``, where decode attention masks it;
refilling a slot needs no zeroing. A verify window writes ``w`` rows
from ``length`` at once (:func:`append_kv_rows`); rolling back a
rejected suffix is just not advancing ``length`` over it.

Under a partitioner (``shard``, a ``parallel.shards.DecodeShard``) a
rank allocates and counts only its block: its slots of the data split,
its heads of the model split, the per-device accounting of the JAX
engine's sharded cache.
"""

import math
from typing import Any, Dict, Iterable, Tuple

import torch

__all__ = ["allocate_kv_cache", "append_kv_rows", "kv_cache_bytes", "pages_in_use"]


def allocate_kv_cache(
    num_layers: int,
    slots: int,
    capacity: int,
    num_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    device: Any = "cpu",
    shard: Any = None,
) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Zeroed KV cache: a per-layer tuple of ``{"k", "v"}`` buffers
    ``[slots, capacity, heads, head_dim]`` on ``device`` (this rank's
    block of them under a ``shard``)."""
    if slots < 1 or capacity < 1:
        raise ValueError(
            f"KV cache needs slots >= 1 and capacity >= 1, got "
            f"slots={slots}, capacity={capacity}."
        )
    shape = (slots, capacity, num_heads, head_dim)
    if shard is not None:
        shape = shard.cache_shape(*shape)
    return tuple(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(num_layers)
    )


def append_kv_rows(cache_buf: torch.Tensor, rows: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
    """Write ``w`` new K/V rows per slot, ``rows [slots, w, heads,
    head_dim]``, into ``cache_buf [slots, capacity, heads, head_dim]`` at
    each slot's ``starts [slots]`` along the capacity axis, in place;
    returns ``cache_buf``. A start is clamped to ``[0, capacity - w]`` (a
    dynamic-update-slice's semantics) so an idle slot's write stays in
    bounds: callers keep active slots at ``start + w <= capacity`` (the
    scheduler's speculation check), else a clamped write lands on live
    rows."""
    b, w = rows.shape[:2]
    starts = starts.long().clamp(0, cache_buf.shape[1] - w)
    idx = starts[:, None] + torch.arange(w, device=cache_buf.device)[None, :]
    cache_buf[torch.arange(b, device=cache_buf.device)[:, None], idx] = rows.to(cache_buf.dtype)
    return cache_buf


def kv_cache_bytes(
    num_layers: int,
    slots: int,
    capacity: int,
    num_heads: int,
    head_dim: int,
    itemsize: int,
    shard: Any = None,
) -> int:
    """Device memory the cache occupies (k + v, all layers): one rank's
    under a ``shard``."""
    if shard is not None:
        slots, capacity, num_heads, head_dim = shard.cache_shape(
            slots, capacity, num_heads, head_dim)
    return 2 * num_layers * slots * capacity * num_heads * head_dim * itemsize


def pages_in_use(lengths: Iterable[int], page_size: int) -> int:
    """KV pages holding live tokens: ``sum(ceil(len / page_size))`` over
    the active slots' lengths (host-side accounting only)."""
    if page_size < 1:
        raise ValueError(f"page_size={page_size} must be >= 1.")
    return int(sum(math.ceil(int(n) / page_size) for n in lengths if n > 0))
