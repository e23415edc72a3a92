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
  attention K9 (``attention="flash"``) or the dense oracle
  (``"dense"``). ``forward`` trains under autograd: flash attention
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
The speculative ``decode_verify`` paths are not ported yet (ROADMAP.md).
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


class _Block(nn.Module):
    """One pre-norm decoder block; its submodules carry the flax names."""

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

    def _heads(self, x: torch.Tensor):
        """q, k, v ``[b, n, heads, head_dim]`` (views of one qkv product)."""
        b, n, _ = x.shape
        qkv = self.qkv(self.RMSNorm_0(x))
        return (t.reshape(b, n, self.num_heads, self.head_dim)
                for t in qkv.split(self.d_model, dim=-1))

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(self.RMSNorm_1(x))
        h = F.gelu(h, approximate="tanh")
        return x + self.down(h)

    def forward(self, x: torch.Tensor, return_kv: bool = False):
        b, s, d = x.shape
        q, k, v = self._heads(x)
        o = getattr(attn_ops, _ATTENTION[self.attention])(q, k, v, causal=True)
        out = self._mlp(x + self.proj(o.reshape(b, s, d)))
        return (out, (k, v)) if return_kv else out

    def decode(self, x, k_cache, v_cache, lengths):
        """One cached step: write the new K/V at ``clamp(lengths, 0,
        capacity - 1)`` in place, attend rows ``0..lengths`` (K12)."""
        b = x.shape[0]
        q, k, v = self._heads(x)
        write = lengths.long().clamp(0, k_cache.shape[1] - 1)
        slots = torch.arange(b, device=x.device)
        k_cache[slots, write] = k[:, 0]
        v_cache[slots, write] = v[:, 0]
        o = attn_ops.paged_decode_attention(q, k_cache, v_cache, lengths)
        return self._mlp(x + self.proj(o.reshape(b, 1, self.d_model)))

    def decode_paged(self, x, layer, page_table, lengths, write):
        """The page-pool twin of :meth:`decode` (K13): ``write = (slots,
        pages, offsets)`` names the slots whose new K/V row lands in the
        pool and where (the others drop it)."""
        b = x.shape[0]
        q, k, v = self._heads(x)
        slots, pages, offsets = write
        _pool_store(layer, {"k": k[slots, 0], "v": v[slots, 0]}, pages, offsets)
        o = attn_ops.pool_paged_decode_attention(
            q, layer["k"], layer["v"], page_table, lengths,
            k_scale=layer.get("k_scale"), v_scale=layer.get("v_scale"))
        return self._mlp(x + self.proj(o.reshape(b, 1, self.d_model)))


class TransformerLMModule(nn.Module):
    """The causal LM module (see module docstring)."""

    def __init__(self, vocab_size: int, num_layers: int, d_model: int, num_heads: int,
                 mlp_ratio: int, max_seq_len: int, dtype: torch.dtype,
                 attention: str = "flash"):
        super().__init__()
        _check_attention(attention)
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
        if s > self.max_seq_len:
            raise ValueError(
                f"Sequence length {s} exceeds max_seq_len {self.max_seq_len} "
                "(the positional table size)."
            )
        x = (self.embed[tokens.long()] + self.pos[None, :s]).to(self.dtype)
        kv = []
        for block in self.blocks:
            if collect_kv:
                x, layer_kv = block(x, return_kv=True)
                kv.append(layer_kv)
            else:
                x = block(x)
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
                    cache: Sequence[Dict[str, torch.Tensor]]):
        """One token per sequence: ``tokens [b]`` sit at positions
        ``lengths [b]`` (int32); ``cache`` a per-layer tuple of ``{"k",
        "v"}`` buffers ``[b, capacity, heads, head_dim]``, written in
        place. Returns ``(logits [b, vocab], cache)``."""
        x = self._step_input(tokens, lengths, cache)
        for block, layer in zip(self.blocks, cache):
            x = block.decode(x, layer["k"], layer["v"], lengths)
        return self._logits(x)[:, 0], tuple(cache)

    def decode_step_paged(self, tokens: torch.Tensor, lengths: torch.Tensor,
                          cache: Sequence[Dict[str, torch.Tensor]],
                          page_table: torch.Tensor):
        """:meth:`decode_step` over a shared page pool: ``cache`` a
        per-layer tuple of pool dicts (``k``/``v`` ``[pages, page_size,
        heads, head_dim]``, plus ``k_scale``/``v_scale`` for int8 pools),
        ``page_table [b, max_pages]`` int32. The new row lands at
        ``(page_table[b, lengths // page_size], lengths % page_size)``;
        an unallocated entry or a length past the table drops it."""
        x = self._step_input(tokens, lengths, cache)
        num_pages, ps = cache[0]["k"].shape[:2]
        max_pages = page_table.shape[1]
        lens = lengths.long()
        row = (lens // ps).clamp(0, max_pages - 1)
        page = page_table.long().gather(1, row[:, None])[:, 0]
        live = (page >= 0) & (lens < max_pages * ps)
        # The slots whose write lands, found once for every layer (one
        # readback of the mask, not one per layer).
        slots = live.nonzero()[:, 0]
        write = (slots, page[slots], (lens % ps)[slots])
        for block, layer in zip(self.blocks, cache):
            x = block.decode_paged(x, layer, page_table, lengths, write)
        return self._logits(x)[:, 0], tuple(cache)


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
        )
