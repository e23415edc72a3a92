"""Causal transformer LM: the TransformerLM family, for training and
decode serving.

The PyTorch counterpart of ``zookeeper_tpu/models/transformer.py``:
pre-RMSNorm blocks, a tanh-approximated GELU MLP (``jax.nn.gelu``'s
default), a learned positional table and a weight-tied LM head whose
logits are an fp32 product of the fp32 norm output and the fp32
embedding. Dense layers keep fp32 weights and compute in the compute
dtype, as ``flax.linen.Dense(dtype=...)`` does; RMSNorm takes its
statistics in fp32.

One weight set serves three paths, as in the JAX module:

- ``forward`` / ``prefill``: the full-context forward (prefill also
  returns every layer's K/V heads and each sequence's last logits), its
  attention K9 (``attention="flash"``), the dense oracle (``"dense"``)
  or a callable a partitioner injected (``set_attention_override``: the
  sequence-parallel attention, the tokens then a shard of the sequence
  and the positional table read at the shard's global offset). ``forward`` trains under autograd: flash attention
  then runs K9 with lse forward and K10/K11 backward;
- ``decode_step``: one token per sequence over caller-owned slot caches
  ``[slots, capacity, heads, head_dim]`` (K12);
- ``decode_step_paged``: the same over a shared page pool through page
  tables (K13), int8 pools quantized on write.

The port writes a decode step's new K/V rows into the caller's buffers
in place (JAX returns updated copies); the returned cache is the same
objects. Submodules carry the flax scope names (``embed``, ``pos``,
``block{i}`` with ``RMSNorm_0``, ``qkv``, ``proj``, ``RMSNorm_1``,
``up``, ``down``, and the final ``RMSNorm_0``), so
``models.convert.from_flax_lm_variables`` maps a JAX tree by name.
Attention functions are looked up in ``ops.attention`` at call time;
each kernel wrapper runs its plain version on CPU tensors.

Tensor parallelism (``parallel.shards``, ``transformer_tp_rules``): a
block handed a model group for its attention (``_tp_attn``) holds the
head-aligned rows of ``qkv`` (the q, k and v rows of its heads) and the
matching input columns of ``proj``; it attends over its own heads only
(K9-lse/K10/K11, or the sequence-parallel attention, at ``heads / tp``)
and sums the members' ``proj`` outputs (one all-reduce, in float32). Its
MLP (``_tp_mlp``) is the same over the ``up`` rows and ``down`` columns.
A block whose heads or hidden units do not divide the group computes
whole on gathered weights.

Serving under a partitioner (``serving.decode.engine``, with a
``parallel.shards.DecodeShard``): a block's heads lie as its weights
give them (its own heads under ``_tp_attn``, else all) and the cache's
as the engine placed it (its own heads over the model axis, else all);
:func:`relay_heads` moves q/k/v to the cache's layout (a slice, or an
all-gather over the model group) and the attention output back to the
``proj`` input's, so K12/K13 run on the cache's heads and the
row-parallel ``proj``/``down`` partials are summed in float32 as in
training: the logits are the same on every model rank. Under a data
split each rank decodes its own slots; a page pool, which every data
rank holds whole, takes every slot's new rows (gathered over the data
group) so its copies stay equal. ``prefill`` under a model group
returns each layer's K/V for the rank's heads only.

``decode_verify`` / ``decode_verify_paged`` take ``w`` tokens per
sequence in one dispatch (the speculative verify; over the pool also the
warm-prefix extend and the prefill chunk), their attention the plain
fp32 ``verify_cached_attention`` / ``pool_verify_attention``, their
heads relayed as the decode steps' are.
"""

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.ops import attention as attn_ops
from zookeeper_tpu_torch.ops.quantizers import quantize_kv_rows
from zookeeper_tpu_torch.parallel.shards import (
    all_gather_stack,
    copy_to_model,
    reduce_from_model,
)

#: Full-context attention tiers, by the name of their ``ops.attention``
#: function.
_ATTENTION = {"flash": "flash_attention", "dense": "attention_reference"}


def _check_attention(attention: str) -> None:
    if attention not in _ATTENTION:
        raise ValueError(f"attention={attention!r}: expected one of {sorted(_ATTENTION)}.")


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias), statistics
    in fp32, output cast to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.scale).to(self.dtype)


class _Linear(nn.Module):
    """``flax.linen.Dense(use_bias=False, dtype=dtype)``: fp32 weight
    ``[out, in]``, the product in ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


def _pool_store(layer: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                pages: torch.Tensor, offsets: torch.Tensor) -> None:
    """Store ``rows["k"/"v"] [n, heads, head_dim]`` at pool positions
    ``(pages, offsets)`` (all in range), in place; an int8 layer (with
    ``k_scale``/``v_scale``) stores them quantized."""
    for name, scale_name in (("k", "k_scale"), ("v", "v_scale")):
        vals = rows[name]
        if scale_name in layer:
            q, s = quantize_kv_rows(vals)
            layer[name][pages, offsets] = q
            layer[scale_name][pages, offsets] = s
        else:
            layer[name][pages, offsets] = vals.to(layer[name].dtype)


def _pool_write_rows(layer: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                     pages: torch.Tensor, offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write ``rows["k"/"v"] [n..., heads, head_dim]`` into a page-pool
    layer dict at ``(pages, offsets)`` (same leading shape), in place.
    Entries with ``page == num_pages`` (the out-of-range sentinel of
    inactive slots, unallocated table entries and padding rows) write
    nowhere. An int8 layer stores the rows quantized. Returns
    ``layer``."""
    keep = pages < layer["k"].shape[0]
    _pool_store(layer, {name: rows[name][keep] for name in ("k", "v")},
                pages[keep], offsets[keep])
    return layer


def pool_window_write(page_table: torch.Tensor, lengths: torch.Tensor, w: int,
                      page_size: int, valid: torch.Tensor = None):
    """Where a window's rows land in a page pool: ``(rows, pages,
    offsets)`` for the rows, flattened over ``[slots, w]``, whose write is
    live. Position ``lengths + j`` goes to ``(page_table[slot, pos //
    page_size], pos % page_size)``; an unallocated entry, a position past
    the table or a row ``j >= valid`` (when given) drops. Found once for
    every layer (one readback of the mask)."""
    max_pages = page_table.shape[1]
    pos = lengths.long()[:, None] + torch.arange(w, device=page_table.device)[None, :]
    row = (pos // page_size).clamp(0, max_pages - 1)
    page = page_table.long().gather(1, row)
    live = (page >= 0) & (pos < max_pages * page_size)
    if valid is not None:
        live &= torch.arange(w, device=page_table.device)[None, :] < valid.long()[:, None]
    rows = live.reshape(-1).nonzero()[:, 0]
    return rows, page.reshape(-1)[rows], (pos % page_size).reshape(-1)[rows]


def _summed(partial: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel output summed over the model group ``tp`` (itself
    without one)."""
    return partial if tp is None else reduce_from_model(partial, tp)


def relay_heads(t: torch.Tensor, have, want) -> torch.Tensor:
    """``t [..., heads, head_dim]`` whose heads lie as ``have`` (a
    ``TensorParallel``: this rank's block of the model group; None: every
    head) laid out as ``want``: a slice of this rank's heads, an all-gather
    of the group's heads (in group order), or ``t`` itself. Exact either
    way."""
    if have is None and want is None:
        return t
    if have is not None and want is not None:
        if (have.size, have.index) != (want.size, want.index):
            raise ValueError(
                f"heads split {have.size} ways (index {have.index}) cannot be relaid as "
                f"{want.size} ways (index {want.index})."
            )
        return t
    if have is None:
        n = t.shape[-2] // want.size
        return t.narrow(-2, want.index * n, n)
    stacked = all_gather_stack(t, have.group, have.size)  # [size, ..., n, d]
    return stacked.movedim(0, -3).reshape(*t.shape[:-2], have.size * t.shape[-2], t.shape[-1])


class _Block(nn.Module):
    """One pre-norm decoder block; its submodules carry the flax names.
    ``_tp_attn``/``_tp_mlp``: the model groups of its tensor-parallel
    halves (see the module docstring)."""

    _tp_attn = None
    _tp_mlp = None

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype, attention: str):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.attention = attention
        self.RMSNorm_0 = RMSNorm(d_model, dtype)
        self.qkv = _Linear(d_model, 3 * d_model, dtype)
        self.proj = _Linear(d_model, d_model, dtype)
        self.RMSNorm_1 = RMSNorm(d_model, dtype)
        self.up = _Linear(d_model, mlp_ratio * d_model, dtype)
        self.down = _Linear(mlp_ratio * d_model, d_model, dtype)

    def tensor_parallel_forms(self):
        """Column-parallel ``qkv`` (head-aligned: interleave 3) with
        row-parallel ``proj``, and column-parallel ``up`` with row-parallel
        ``down``; the weights are ``[out, in]``."""
        d_ff = self.up.weight.shape[0]
        return [
            ("_tp_attn", {"qkv.weight": (0, 3), "proj.weight": (1, 1)},
             lambda size: self.num_heads % size == 0),
            ("_tp_mlp", {"up.weight": (0, 1), "down.weight": (1, 1)},
             lambda size: d_ff % size == 0),
        ]

    def _heads(self, x: torch.Tensor, tp=None):
        """q, k, v ``[b, n, heads, head_dim]`` (views of one qkv product):
        this rank's heads under a model group ``tp``, whose members sum
        the input's gradient."""
        b, n, _ = x.shape
        heads = self.num_heads // (tp.size if tp is not None else 1)
        h = self.RMSNorm_0(x)
        qkv = self.qkv(h if tp is None else copy_to_model(h, tp))
        return (t.reshape(b, n, heads, self.head_dim)
                for t in qkv.split(heads * self.head_dim, dim=-1))

    def attention_partial(self, x: torch.Tensor, attention=None, kv=None) -> torch.Tensor:
        """The ``proj`` output of this rank's heads (the whole output
        without a model group); ``kv`` collects the heads' K/V."""
        b, s, _ = x.shape
        q, k, v = self._heads(x, self._tp_attn)
        if kv is not None:
            kv.extend((k, v))
        if attention is None:
            attention = getattr(attn_ops, _ATTENTION[self.attention])
        o = attention(q, k, v, causal=True)
        return self.proj(o.reshape(b, s, -1))

    def mlp_partial(self, x: torch.Tensor) -> torch.Tensor:
        """The ``down`` output of this rank's hidden units (the whole
        output without a model group)."""
        tp = self._tp_mlp
        h = self.RMSNorm_1(x)
        h = self.up(h if tp is None else copy_to_model(h, tp))
        return self.down(F.gelu(h, approximate="tanh"))

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + _summed(self.mlp_partial(x), self._tp_mlp)

    def forward(self, x: torch.Tensor, return_kv: bool = False, attention=None):
        kv = [] if return_kv else None
        out = self._mlp(x + _summed(self.attention_partial(x, attention, kv), self._tp_attn))
        return (out, tuple(kv)) if return_kv else out

    def _decode_heads(self, x, shard):
        """q, k, v of one decode step in the cache's head layout."""
        cache = None if shard is None else shard.heads
        return (relay_heads(t, self._tp_attn, cache) for t in self._heads(x, self._tp_attn))

    def _decode_out(self, x, o, shard):
        """The block's output from the attention output ``o [b, n, heads,
        head_dim]`` in the cache's head layout: back to the ``proj``
        input's heads, the row-parallel partials summed."""
        b, n = x.shape[:2]
        o = relay_heads(o, None if shard is None else shard.heads, self._tp_attn)
        return self._mlp(x + _summed(self.proj(o.reshape(b, n, -1)), self._tp_attn))

    def decode(self, x, k_cache, v_cache, lengths, shard=None):
        """One cached step: write the new K/V at ``clamp(lengths, 0,
        capacity - 1)`` in place, attend rows ``0..lengths`` (K12; the
        sharded wrapper on this rank's block under a ``shard``)."""
        b = x.shape[0]
        q, k, v = self._decode_heads(x, shard)
        write = lengths.long().clamp(0, k_cache.shape[1] - 1)
        slots = torch.arange(b, device=x.device)
        k_cache[slots, write] = k[:, 0]
        v_cache[slots, write] = v[:, 0]
        if shard is None:
            o = attn_ops.paged_decode_attention(q, k_cache, v_cache, lengths)
        else:
            o = attn_ops.sharded_paged_decode_attention(q, k_cache, v_cache, lengths,
                                                        **shard.attention_kwargs())
        return self._decode_out(x, o, shard)

    def decode_paged(self, x, layer, page_table, lengths, write, shard=None):
        """The page-pool twin of :meth:`decode` (K13): ``write = (slots,
        pages, offsets)`` names the slots whose new K/V row lands in the
        pool and where (the others drop it); under a ``shard`` with a data
        split the slots are global and every data rank's rows are gathered
        first."""
        q, k, v = self._decode_heads(x, shard)
        slots, pages, offsets = write
        rows = {"k": k[:, 0], "v": v[:, 0]}
        if shard is not None:
            rows = {name: shard.gather_slots(r) for name, r in rows.items()}
        _pool_store(layer, {name: r[slots] for name, r in rows.items()}, pages, offsets)
        scales = {"k_scale": layer.get("k_scale"), "v_scale": layer.get("v_scale")}
        if shard is None:
            o = attn_ops.pool_paged_decode_attention(q, layer["k"], layer["v"], page_table,
                                                     lengths, **scales)
        else:
            o = attn_ops.sharded_pool_paged_decode_attention(
                q, layer["k"], layer["v"], page_table, lengths, **scales,
                **shard.attention_kwargs())
        return self._decode_out(x, o, shard)

    def decode_verify(self, x, k_cache, v_cache, lengths, shard=None):
        """The multi-token step (the speculative verify): ``x [b, w, d]``,
        position ``j`` the token at index ``lengths + j``. All ``w`` new
        K/V rows land at ``lengths`` in place (``append_kv_rows``, its
        start clamped to ``capacity - w``) and position ``j`` attends rows
        ``0..lengths + j`` (``verify_cached_attention``, plain fp32).
        Rollback is by length: the caller advances ``lengths`` over the
        accepted prefix only. Under a ``shard`` the heads relay as in
        :meth:`decode`."""
        from zookeeper_tpu_torch.serving.decode.cache import append_kv_rows

        q, k, v = self._decode_heads(x, shard)
        append_kv_rows(k_cache, k, lengths)
        append_kv_rows(v_cache, v, lengths)
        o = attn_ops.verify_cached_attention(q, k_cache, v_cache, lengths)
        return self._decode_out(x, o, shard)

    def decode_verify_paged(self, x, layer, page_table, lengths, write, shard=None):
        """The page-pool twin of :meth:`decode_verify` (also the
        warm-prefix extend and the prefill chunk): ``write = (rows, pages,
        offsets)`` names the window rows, flattened over ``[slots, w]``,
        that land in the pool and where (the others drop theirs); every
        position attends through the table (``pool_verify_attention``).
        Under a ``shard`` with a data split the slots are global and every
        data rank's rows are gathered first, as in :meth:`decode_paged`."""
        q, k, v = self._decode_heads(x, shard)
        rows, pages, offsets = write
        new = {"k": k, "v": v}
        if shard is not None:
            new = {name: shard.gather_slots(r) for name, r in new.items()}
        new = {name: r.reshape(-1, *r.shape[2:]) for name, r in new.items()}
        _pool_store(layer, {name: r[rows] for name, r in new.items()}, pages, offsets)
        o = attn_ops.pool_verify_attention(q, layer["k"], layer["v"], page_table, lengths,
                                           k_scale=layer.get("k_scale"),
                                           v_scale=layer.get("v_scale"))
        return self._decode_out(x, o, shard)


class TransformerLMModule(nn.Module):
    """The causal LM module (see module docstring)."""

    def __init__(self, vocab_size: int, num_layers: int, d_model: int, num_heads: int,
                 mlp_ratio: int, max_seq_len: int, dtype: torch.dtype,
                 attention: str = "flash", attention_override=None):
        super().__init__()
        _check_attention(attention)
        #: An injected attention callable (``TransformerLM.
        #: set_attention_override``) that takes precedence over
        #: ``attention`` in the full-context forward; with a
        #: ``sequence_offset(local_len)`` method (sequence parallelism) the
        #: tokens are a shard of the sequence starting at that position.
        self.attention_override = attention_override
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.embed = nn.Parameter(torch.zeros(vocab_size, d_model))
        self.pos = nn.Parameter(torch.zeros(max_seq_len, d_model))
        for i in range(num_layers):
            self.add_module(f"block{i}", _Block(d_model, num_heads, mlp_ratio, dtype, attention))
        self.RMSNorm_0 = RMSNorm(d_model, dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def blocks(self) -> Tuple[_Block, ...]:
        return tuple(getattr(self, f"block{i}") for i in range(self.num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.embed, self.pos):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Weight-tied head: fp32 norm output times the fp32 embedding."""
        return torch.matmul(self.RMSNorm_0(x).float(), self.embed.float().t())

    def _backbone(self, tokens: torch.Tensor, collect_kv: bool):
        if tokens.dim() != 2:
            raise ValueError(
                f"TransformerLM expects [batch, seq] int tokens, got shape "
                f"{tuple(tokens.shape)}."
            )
        s = tokens.shape[1]
        override = self.attention_override
        offset = getattr(override, "sequence_offset", lambda _: 0)(s)
        if offset + s > self.max_seq_len:
            raise ValueError(
                f"Sequence length {offset + s} exceeds max_seq_len {self.max_seq_len} "
                "(the positional table size)."
            )
        x = (self.embed[tokens.long()] + self.pos[None, offset:offset + s]).to(self.dtype)
        kv = []
        for block in self.blocks:
            if collect_kv:
                x, layer_kv = block(x, return_kv=True, attention=override)
                kv.append(layer_kv)
            else:
                x = block(x, attention=override)
        return x, kv

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-context logits ``[b, s, vocab]`` (fp32)."""
        x, _ = self._backbone(tokens, collect_kv=False)
        return self._logits(x)

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """Full-context forward over right-padded prompts ``tokens [b,
        s]`` with true ``lengths [b]``: ``(last_logits [b, vocab], kv)``,
        ``kv`` a per-layer tuple of ``(k, v) [b, s, heads, head_dim]``."""
        x, kv = self._backbone(tokens, collect_kv=True)
        logits = self._logits(x)
        idx = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
        last = logits[torch.arange(tokens.shape[0], device=logits.device), idx]
        return last, tuple(kv)

    def _step_input(self, tokens: torch.Tensor, lengths: torch.Tensor, cache) -> torch.Tensor:
        if len(cache) != self.num_layers:
            raise ValueError(
                f"cache has {len(cache)} layers, model has {self.num_layers}."
            )
        pos_idx = lengths.long().clamp(0, self.max_seq_len - 1)
        x = (self.embed[tokens.long()] + self.pos[pos_idx]).to(self.dtype)
        return x[:, None, :]

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Sequence[Dict[str, torch.Tensor]], shard=None):
        """One token per sequence: ``tokens [b]`` sit at positions
        ``lengths [b]`` (int32); ``cache`` a per-layer tuple of ``{"k",
        "v"}`` buffers ``[b, capacity, heads, head_dim]``, written in
        place. Returns ``(logits [b, vocab], cache)``. Under a ``shard``
        (``parallel.shards.DecodeShard``) the tokens, lengths and cache are
        this rank's block (see the module docstring)."""
        x = self._step_input(tokens, lengths, cache)
        for block, layer in zip(self.blocks, cache):
            x = block.decode(x, layer["k"], layer["v"], lengths, shard)
        return self._logits(x)[:, 0], tuple(cache)

    def decode_step_paged(self, tokens: torch.Tensor, lengths: torch.Tensor,
                          cache: Sequence[Dict[str, torch.Tensor]],
                          page_table: torch.Tensor, shard=None, write=None):
        """:meth:`decode_step` over a shared page pool: ``cache`` a
        per-layer tuple of pool dicts (``k``/``v`` ``[pages, page_size,
        heads, head_dim]``, plus ``k_scale``/``v_scale`` for int8 pools),
        ``page_table [b, max_pages]`` int32. The new row lands at
        ``(page_table[b, lengths // page_size], lengths % page_size)``;
        an unallocated entry or a length past the table drops it. Under a
        ``shard`` whose slots split over the data axes, ``write = (slots,
        pages, offsets)`` is the write of every global slot (the engine
        computes it from the whole table)."""
        x = self._step_input(tokens, lengths, cache)
        if write is None:
            write = pool_window_write(page_table, lengths, 1, cache[0]["k"].shape[1])
        for block, layer in zip(self.blocks, cache):
            x = block.decode_paged(x, layer, page_table, lengths, write, shard)
        return self._logits(x)[:, 0], tuple(cache)

    def _window_input(self, tokens: torch.Tensor, lengths: torch.Tensor, cache) -> torch.Tensor:
        if len(cache) != self.num_layers:
            raise ValueError(
                f"cache has {len(cache)} layers, model has {self.num_layers}."
            )
        if tokens.dim() != 2:
            raise ValueError(
                f"a verify window expects [batch, w] int tokens, got shape "
                f"{tuple(tokens.shape)}."
            )
        w = tokens.shape[1]
        pos_idx = (lengths.long()[:, None]
                   + torch.arange(w, device=tokens.device)[None, :]).clamp(0, self.max_seq_len - 1)
        return (self.embed[tokens.long()] + self.pos[pos_idx]).to(self.dtype)

    def decode_verify(self, tokens: torch.Tensor, lengths: torch.Tensor,
                      cache: Sequence[Dict[str, torch.Tensor]], shard=None):
        """``w`` tokens per sequence in one dispatch (the speculative
        verify): ``tokens [b, w]``, token ``j`` at position ``lengths +
        j`` (clamped to the positional table). All ``w`` K/V rows are
        appended to every layer's slot buffers in place. Returns
        ``(logits [b, w, vocab], cache)``: ``logits[:, j]`` is the
        distribution after token ``j``. The caller owns the lengths
        (rollback is advancing them over the accepted prefix only). At
        ``w == 1`` this computes what :meth:`decode_step` does, with the
        plain attention."""
        x = self._window_input(tokens, lengths, cache)
        for block, layer in zip(self.blocks, cache):
            x = block.decode_verify(x, layer["k"], layer["v"], lengths, shard)
        return self._logits(x), tuple(cache)

    def decode_verify_paged(self, tokens: torch.Tensor, lengths: torch.Tensor,
                            cache: Sequence[Dict[str, torch.Tensor]],
                            page_table: torch.Tensor, valid: torch.Tensor = None,
                            shard=None, write=None):
        """:meth:`decode_verify` over a shared page pool: the window's rows
        go through the page table (a window crossing a page edge lands in
        two pages). Also the warm-prefix extend and the prefill chunk: a
        prompt whose first ``lengths`` tokens are resident enters with the
        rest as the window, ``valid [b]`` bounding the real rows of each
        (the others write nowhere; None: all ``w``). A row whose table
        entry is unallocated or whose position is past the table drops
        its write. Under a ``shard`` whose slots split over the data axes,
        ``write`` is the write of every global slot's rows (the engine
        computes it from the whole table)."""
        x = self._window_input(tokens, lengths, cache)
        if write is None:
            write = pool_window_write(page_table, lengths, tokens.shape[1],
                                      cache[0]["k"].shape[1], valid)
        for block, layer in zip(self.blocks, cache):
            x = block.decode_verify_paged(x, layer, page_table, lengths, write, shard)
        return self._logits(x), tuple(cache)


@torch.no_grad()
def greedy_decode(module: TransformerLMModule, prompt: torch.Tensor, steps: int) -> torch.Tensor:
    """Greedy continuation by full recompute (no KV cache): ``[b, t0]``
    int tokens -> ``[b, t0 + steps]``. The oracle the decode engine's
    tokens are held to."""
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0.")
    tokens = torch.as_tensor(prompt)
    if tokens.dim() != 2:
        raise ValueError(f"prompt must be [batch, t0] int tokens, got {tuple(tokens.shape)}.")
    if tokens.shape[1] + steps > module.max_seq_len:
        raise ValueError(
            f"prompt length {tokens.shape[1]} + steps {steps} exceeds the "
            f"positional table capacity {module.max_seq_len}; build the model "
            "with a larger max_seq_len to decode further."
        )
    for _ in range(int(steps)):
        logits = module(tokens)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(tokens.dtype)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens


@component
class TransformerLM(Model):
    """Causal LM model component. ``build(input_shape=(seq_len,),
    num_classes=vocab_size)`` follows the Model contract: the "classes"
    of a language model are its vocabulary."""

    num_layers: int = Field(4)
    d_model: int = Field(256)
    num_heads: int = Field(4)
    mlp_ratio: int = Field(4)
    #: "flash" (K9) or "dense" (the oracle).
    attention: str = Field("flash")
    #: Positional-table capacity; -1 sizes it to the built sequence.
    max_seq_len: int = Field(-1)

    def set_attention_override(self, fn) -> None:
        """The partitioner injection seam (``Partitioner.prepare_model``):
        a mesh-owning partitioner (``SequenceParallelPartitioner``)
        installs its attention callable here before ``build()``, and it
        takes precedence over the ``attention`` Field in the full-context
        forward. ``None`` clears the override."""
        if fn is not None and not callable(fn):
            raise ValueError(
                f"attention override must be callable(q, k, v, *, "
                f"causal) or None, got {fn!r}."
            )
        object.__setattr__(self, "_attention_override", fn)

    def build(self, input_shape: Sequence[int], num_classes: int) -> TransformerLMModule:
        if len(input_shape) != 1:
            raise ValueError(
                f"TransformerLM input_shape must be (seq_len,), got {tuple(input_shape)}."
            )
        _check_attention(self.attention)
        if self.d_model % self.num_heads != 0:
            raise ValueError(
                f"d_model={self.d_model} not divisible by num_heads={self.num_heads}."
            )
        (seq_len,) = input_shape
        if self.max_seq_len == -1:
            max_seq_len = seq_len
        elif self.max_seq_len > 0:
            max_seq_len = self.max_seq_len
        else:
            raise ValueError(
                f"max_seq_len={self.max_seq_len}: expected a positive capacity or "
                "-1 (size to the built sequence)."
            )
        if seq_len > max_seq_len:
            raise ValueError(f"seq_len {seq_len} exceeds max_seq_len {max_seq_len}.")
        return TransformerLMModule(
            vocab_size=num_classes,
            num_layers=self.num_layers,
            d_model=self.d_model,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            max_seq_len=max_seq_len,
            dtype=self.dtype(),
            attention=self.attention,
            attention_override=getattr(self, "_attention_override", None),
        )
