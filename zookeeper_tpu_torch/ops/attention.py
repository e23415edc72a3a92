"""Attention for the TransformerLM paths: the plain oracles and the
hand-written CUDA kernels.

The PyTorch counterpart of the part of ``zookeeper_tpu/ops/attention.py``
that training, prefill and decode run. Public functions keep the JAX
layout ``q/k/v [batch, seq, heads, head_dim]``. The oracles
(``attention_reference``, ``cached_attention``, ``pool_decode_attention``)
compute in fp32 with exact products, as the JAX ones pin
``Precision.HIGHEST``.

Kernels (sources in ``zookeeper_tpu_torch/csrc``), each with its plain
PyTorch version beside it:

- K9 :func:`flash_attention` — the flash forward (``_flash_forward``):
  causal or full, padded keys masked, ``p`` rounded to ``v``'s dtype
  before ``p @ v``. A call that needs no gradient (prefill, eval) runs
  it without ``lse``, as JAX's primal does; a call under autograd runs
  :func:`flash_forward_lse`, which also writes each row's log-sum-exp
  ``lse = m + log l`` as ``[b*h, s]`` fp32 (JAX's ``[b*h, s_pad, 1]``
  without the padded rows). Its plain version
  :func:`flash_attention_plain` is the same blocked online softmax with
  the JAX block choice, so on the CPU it tracks JAX's kernel, not only
  the dense oracle.
- K10 :func:`flash_backward_dq` and K11 :func:`flash_backward_dkv` — the
  recompute backward (``_flash_backward``): ``P = exp(S - lse)`` with a
  hard 0 on masked entries, ``dS = P * (dO V^T - D)`` with ``D =
  rowsum(dO * O)`` (:func:`flash_backward_delta`, torch ops, as XLA
  computes it in JAX), ``dQ = scale dS K``, ``dK = scale dS^T Q``, ``dV
  = P^T dO``; ``dS`` and ``P`` rounded to the input dtype before their
  products. Plain versions :func:`flash_backward_dq_plain` and
  :func:`flash_backward_dkv_plain`. :class:`_FlashAttention` ties K9
  with lse, K10 and K11 into one autograd Function, so
  :func:`flash_attention` trains. bf16 calls at head_dim <= 128 (K9 and
  K9-lse as well as K10/K11) run on tensor cores, fp32 (exact products)
  and wider head_dims on fp32 FMA; :func:`flash_forward_variant` and
  :func:`flash_backward_variant` name the kernels a call takes.
  :func:`flash_attention_lse` (JAX's ``_flash_attention_lse``) goes
  through the same Function and also returns ``lse`` and takes its
  cotangent: the backward runs K10/K11 with ``D' = D - dlse``.
- K12 :func:`paged_decode_attention` — one-position decode over a slot
  cache ``[slots, capacity, heads, head_dim]``, reading only rows
  ``0..clamp(lengths, 0, capacity - 1)``. Plain version:
  :func:`cached_attention`.
- K13 :func:`pool_paged_decode_attention` — K12 through per-slot page
  tables over a shared page pool, with optional int8 rows times fp32
  per-(row, head) scales; each (slot, head)'s rows split over blocks
  (:func:`decode_variant`). Plain version: :func:`pool_decode_attention`.

The sharded decode path (:func:`sharded_paged_decode_attention`,
:func:`sharded_pool_paged_decode_attention`): K12 or K13 on this rank's
(slots, heads) block, zero collectives.

The multi-position windows of the speculative verify, the warm-prefix
extend and chunked prefill (:func:`verify_cached_attention`,
:func:`pool_verify_attention`) are plain fp32 PyTorch, as the JAX
functions are plain einsums: a window-of-``w`` K12/K13 is queued in
ROADMAP.md.

Sequence parallelism across ranks (the JAX package's shard_map
programs, each rank holding its sequence shard): :func:`ring_attention`
(dense blocks), :func:`ring_flash_attention` (:func:`ring_flash_step`
per block: K9-lse forward, K10/K11 backward with the lse cotangent) and
:func:`all_to_all_attention` (Ulysses: dense or flash over whole heads),
their rotations and re-shards ``torch.distributed`` calls on the sp
group.

A wrapper runs its plain version only when its tensors lie on the CPU.
On CUDA tensors it launches its kernel (counting the launch in
:data:`LAUNCHES`) or raises; it never falls back. Kernel and plain
version differ only by the order of fp32 sums (online softmax over
other blocks), within the JAX package's stated tolerances.
"""

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from zookeeper_tpu_torch.ops import cuda_build
from zookeeper_tpu_torch.ops.binary_compute import _cuda_device, _require, _stream

# Large-negative mask value: finite, so a fully masked row's exp()
# underflows to 0 instead of giving inf - inf = nan in the online
# rescale; far below any real fp32 score.
_MASK_VALUE = -0.5 * float(torch.finfo(torch.float32).max)

#: Kernel launches since the last :func:`reset_launches`, by kernel.
LAUNCHES = {
    "flash_forward": 0,
    "flash_forward_lse": 0,
    "flash_backward_dq": 0,
    "flash_backward_dkv": 0,
    "paged_decode_attention": 0,
    "pool_paged_decode_attention": 0,
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- the plain oracles ------------------------------------------------------


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain full softmax attention: ``q/k/v [b, s, h, d]`` -> ``[b, s,
    h, d]`` in ``q``'s dtype, scores and products in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * float(scale)
    if causal:
        n_q, n_k = s.shape[-2:]
        qi = torch.arange(n_q, device=s.device)[:, None]
        ki = torch.arange(n_k, device=s.device)[None, :]
        s = torch.where(ki <= qi, s, _MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-position attention over a per-sequence KV cache: ``q [b,
    1, h, d]``, ``k_cache/v_cache [b, capacity, h, d]`` (already holding
    the new token's K/V at index ``lengths``), ``lengths [b]`` the
    previously cached tokens. Rows ``0..lengths`` are attended, every
    row past them masked. Output ``[b, 1, h, d]`` in ``q``'s dtype. The
    plain version of K12."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * float(scale)
    ki = torch.arange(k_cache.shape[1], device=s.device)
    mask = ki[None, None, None, :] <= lengths.to(s.device)[:, None, None, None]
    s = torch.where(mask, s, _MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float()).to(q.dtype)


def decode_attention_supported(num_heads: int, head_dim: int) -> bool:
    """Whether the decode kernels serve this geometry (the JAX
    package's predicate, kept so a config resolves to the same flavor
    on either package)."""
    return num_heads >= 1 and head_dim >= 8 and head_dim % 8 == 0


def _gathered_pool_view(
    pool: torch.Tensor, page_table: torch.Tensor, scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """A slot-contiguous ``[slots, max_pages * page_size, h, d]`` view of
    a page pool gathered through ``page_table`` (entries clipped to the
    pool), int8 rows dequantized by ``scale [pages, page_size, h]``."""
    idx = page_table.long().clamp(0, pool.shape[0] - 1)
    g = pool[idx]  # [slots, max_pages, page_size, h, d]
    if scale is not None:
        g = g.float() * scale[idx][..., None]
    b, m, ps, h, d = g.shape
    return g.reshape(b, m * ps, h, d)


def pool_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-position decode attention over a shared page pool: ``k_pool
    /v_pool [pages, page_size, h, d]``, ``page_table [slots, max_pages]``
    (negative entries unallocated), optional int8 ``k_scale/v_scale
    [pages, page_size, h]``. :func:`cached_attention` over the gathered
    view; the plain version of K13."""
    kc = _gathered_pool_view(k_pool, page_table, k_scale)
    vc = _gathered_pool_view(v_pool, page_table, v_scale)
    return cached_attention(q, kc, vc, lengths, scale=scale)


@contextlib.contextmanager
def _fp32_products():
    """fp32 products at full precision (no TF32) on the card, the JAX
    functions' ``Precision.HIGHEST``."""
    prev = torch.get_float32_matmul_precision()
    if prev != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev != "highest":
            torch.set_float32_matmul_precision(prev)


def verify_cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-position attention over a per-sequence KV cache (the
    speculative verify and the warm-extend window): ``q [b, w, h, d]``,
    position ``j`` the token at index ``lengths + j``; ``k_cache/v_cache
    [b, capacity, h, d]`` already holding the ``w`` new rows. Position
    ``j`` attends rows ``0..lengths + j``. Output ``[b, w, h, d]`` in q's
    dtype. :func:`cached_attention` op for op (fp32 scores and products,
    the finite mask value); at ``w == 1`` the same computation. Plain
    PyTorch: no kernel serves it yet (ROADMAP.md)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with _fp32_products():
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * float(scale)
        ki = torch.arange(k_cache.shape[1], device=s.device)
        qi = torch.arange(q.shape[1], device=s.device)
        limit = lengths.to(s.device).long()[:, None] + qi[None, :]  # [b, w]
        mask = ki[None, None, None, :] <= limit[:, None, :, None]
        s = torch.where(mask, s, _MASK_VALUE)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float()).to(q.dtype)


def pool_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`verify_cached_attention` over a shared page pool, through
    the slots' page tables (the operands of :func:`pool_decode_attention`;
    int8 pools dequantized in the gathered view)."""
    kc = _gathered_pool_view(k_pool, page_table, k_scale)
    vc = _gathered_pool_view(v_pool, page_table, v_scale)
    return verify_cached_attention(q, kc, vc, lengths, scale=scale)


# -- K9, K10, K11: flash attention forward and backward --------------------

#: Budget the JAX block policy checks the flash backward's working set
#: against (kept so the plain version picks the JAX kernel's blocks).
_FLASH_VMEM_BUDGET = 64 * 1024 * 1024


def _flash_bwd_vmem_estimate(block_q, block_k, head_dim, itemsize):
    blk = max(block_q, block_k)
    intermediates = 3 * block_q * block_k * 4
    tiles = 2 * 6 * blk * head_dim * itemsize
    accumulators = 2 * blk * head_dim * 4
    return intermediates + tiles + accumulators


def _default_flash_blocks(s, block_q, block_k, head_dim=None, itemsize=4):
    """The JAX auto block size: the largest of 1024/512/256/128 whose
    padding stays under s/8 and whose backward working set fits the
    budget; explicit blocks pass through."""
    if block_q is None or block_k is None:
        auto = 128
        for blk in (1024, 512, 256, 128):
            pad = -(-s // blk) * blk - s
            if pad * 8 > s:
                continue
            if (
                head_dim is not None
                and blk > 128
                and _flash_bwd_vmem_estimate(blk, blk, head_dim, itemsize)
                > _FLASH_VMEM_BUDGET
            ):
                continue
            auto = blk
            break
        if block_q is None:
            block_q = auto
        if block_k is None:
            block_k = auto
    return block_q, block_k


def _flash_dims(s, block_q, block_k):
    """Blocks clamped to the smallest 16-aligned length >= s, and the
    padded length (a common multiple of both blocks)."""
    cap = -(-max(8, s) // 16) * 16
    block_q = min(block_q, cap)
    block_k = min(block_k, cap)
    common = math.lcm(block_q, block_k)
    s_pad = -(-s // common) * common
    return block_q, block_k, s_pad


def _to_bh(x: torch.Tensor, s_pad: int) -> torch.Tensor:
    """[b, s, h, d] -> [b*h, s_pad, d], the sequence zero-padded."""
    b, s, h, d = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, s_pad - s))
    return x.permute(0, 2, 1, 3).reshape(b * h, s_pad, d)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    want_lse: bool = False,
):
    """Plain version of K9: ``_flash_forward``'s blocked online softmax
    (running max from ``_MASK_VALUE``, sum and accumulator in fp32; k
    blocks above the causal diagonal skipped; keys past ``s`` masked;
    ``p`` cast to ``v``'s dtype before ``p @ v``) with the JAX block
    choice, over ``[b, s, h, d]``. ``want_lse`` also returns each row's
    ``m + log l`` as ``[b*h, s]`` fp32."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    block_q, block_k = _default_flash_blocks(
        s, block_q, block_k, head_dim=d, itemsize=q.element_size()
    )
    block_q, block_k, s_pad = _flash_dims(s, block_q, block_k)
    qb, kb, vb = (_to_bh(x, s_pad) for x in (q, k, v))
    nq, nk = s_pad // block_q, s_pad // block_k
    out = torch.empty((b * h, s_pad, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b * h, s_pad), dtype=torch.float32, device=q.device)
    rows = torch.arange(block_q, device=q.device)[:, None]
    cols = torch.arange(block_k, device=q.device)[None, :]
    for iq in range(nq):
        q_blk = qb[:, iq * block_q : (iq + 1) * block_q].float()
        m = torch.full((b * h, block_q, 1), _MASK_VALUE, device=q.device)
        l = torch.zeros((b * h, block_q, 1), device=q.device)
        acc = torch.zeros((b * h, block_q, d), device=q.device)
        for ik in range(nk):
            if causal and ik * block_k > iq * block_q + block_q - 1:
                continue  # fully masked: no compute, as the kernel skips it
            k_blk = kb[:, ik * block_k : (ik + 1) * block_k].float()
            v_blk = vb[:, ik * block_k : (ik + 1) * block_k]
            sc = torch.matmul(q_blk, k_blk.transpose(1, 2)) * float(scale)
            ki = ik * block_k + cols
            valid = ki < s
            if causal:
                valid = valid & (ki <= iq * block_q + rows)
            sc = torch.where(valid, sc, _MASK_VALUE)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            m = m_new
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(v.dtype).float(), v_blk.float())
            acc = acc * corr + pv
        out[:, iq * block_q : (iq + 1) * block_q] = acc / l
        lse[:, iq * block_q : (iq + 1) * block_q] = (m + torch.log(l))[..., 0]
    out = out.to(q.dtype).reshape(b, h, s_pad, d).permute(0, 2, 1, 3)
    out = out[:, :s].contiguous()
    return (out, lse[:, :s].contiguous()) if want_lse else out


def flash_backward_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * O)`` in fp32 as ``[b*h, s]``: reduced over
    head_dim first in the ``[b, s, h, d]`` layout (as JAX does, before
    any padding or transpose), then laid out like ``lse``."""
    b, s, h, _ = out.shape
    d = (do.float() * out.float()).sum(dim=-1)  # [b, s, h]
    return d.permute(0, 2, 1).reshape(b * h, s).contiguous()


class _FlashTiles:
    """The JAX backward's blocks and operands: q, k, v and dO (in q's
    dtype; padded rows 0) as ``[b*h, s_pad, d]``, lse and D as ``[b*h,
    s_pad, 1]``, cut into q-side tiles of ``block_q`` rows and k-side
    tiles of ``block_k``; :meth:`p` recomputes one masked probability
    tile."""

    def __init__(self, q, k, v, do, lse, delta, causal, scale, block_q, block_k):
        b, s, h, d = self.shape = q.shape
        self.causal = causal
        self.scale = float(d ** -0.5 if scale is None else scale)
        block_q, block_k = _default_flash_blocks(
            s, block_q, block_k, head_dim=d, itemsize=q.element_size()
        )
        self.block_q, self.block_k, self.s_pad = _flash_dims(s, block_q, block_k)
        self.nq, self.nk = self.s_pad // self.block_q, self.s_pad // self.block_k
        self.q, self.k, self.v = (_to_bh(x, self.s_pad) for x in (q, k, v))
        self.do = _to_bh(do.to(q.dtype), self.s_pad)
        pad = (0, self.s_pad - s)
        self.lse = torch.nn.functional.pad(lse.float(), pad)[..., None]
        self.delta = torch.nn.functional.pad(delta.float(), pad)[..., None]

    def q_tile(self, x: torch.Tensor, iq: int) -> torch.Tensor:
        return x[:, iq * self.block_q : (iq + 1) * self.block_q]

    def k_tile(self, x: torch.Tensor, ik: int) -> torch.Tensor:
        return x[:, ik * self.block_k : (ik + 1) * self.block_k]

    def live(self, iq: int, ik: int) -> bool:
        """False for a tile above the causal diagonal (skipped, as the
        kernels skip it)."""
        return not self.causal or ik * self.block_k <= (iq + 1) * self.block_q - 1

    def p(self, iq: int, ik: int) -> torch.Tensor:
        """``P = exp(S - lse)`` of one tile, a hard 0 on masked entries."""
        s = self.shape[1]
        sc = torch.matmul(self.q_tile(self.q, iq).float(),
                          self.k_tile(self.k, ik).float().transpose(1, 2)) * self.scale
        qi = iq * self.block_q + torch.arange(self.block_q, device=sc.device)[:, None]
        ki = ik * self.block_k + torch.arange(self.block_k, device=sc.device)[None, :]
        # Padded q rows carry dO = 0 and contribute nothing in JAX; here
        # they are masked too, so their padded lse of 0 never overflows.
        valid = (ki < s) & (qi < s)
        if self.causal:
            valid = valid & (ki <= qi)
        p = torch.exp(torch.where(valid, sc, _MASK_VALUE) - self.q_tile(self.lse, iq))
        return torch.where(valid, p, 0.0)


def _from_bh(x: torch.Tensor, b: int, s: int, h: int, dtype: torch.dtype) -> torch.Tensor:
    """[b*h, s_pad, d] -> [b, s, h, d] in ``dtype``, padded rows dropped."""
    d = x.shape[-1]
    return x.to(dtype).reshape(b, h, -1, d).permute(0, 2, 1, 3)[:, :s].contiguous()


def flash_backward_dq_plain(q, k, v, do, lse, delta, *, causal=False, scale=None,
                            block_q=None, block_k=None) -> torch.Tensor:
    """Plain version of K10, the dQ kernel of ``_flash_backward``: per q
    block, over its live k blocks, ``dQ += (P * (dO V^T - D)).to(k.dtype)
    @ K`` in fp32; ``dQ * scale`` in q's dtype, ``[b, s, h, d]``."""
    t = _FlashTiles(q, k, v, do, lse, delta, causal, scale, block_q, block_k)
    b, s, h, d = t.shape
    dq = torch.empty((b * h, t.s_pad, d), dtype=torch.float32, device=q.device)
    for iq in range(t.nq):
        acc = torch.zeros((b * h, t.block_q, d), device=q.device)
        do_blk = t.q_tile(t.do, iq).float()
        for ik in range(t.nk):
            if not t.live(iq, ik):
                continue
            dp = torch.matmul(do_blk, t.k_tile(t.v, ik).float().transpose(1, 2))
            ds = t.p(iq, ik) * (dp - t.q_tile(t.delta, iq))
            acc = acc + torch.matmul(ds.to(k.dtype).float(), t.k_tile(t.k, ik).float())
        t.q_tile(dq, iq)[:] = acc * t.scale
    return _from_bh(dq, b, s, h, q.dtype)


def flash_backward_dkv_plain(q, k, v, do, lse, delta, *, causal=False, scale=None,
                             block_q=None, block_k=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11, the dK/dV kernel of ``_flash_backward``: per
    k block, over the q blocks from the causal diagonal on, ``dV +=
    P.to(dO.dtype)^T dO`` and ``dK += (P * (dO V^T - D)).to(q.dtype)^T Q``
    in fp32; ``dK * scale`` and ``dV`` in k's and v's dtypes."""
    t = _FlashTiles(q, k, v, do, lse, delta, causal, scale, block_q, block_k)
    b, s, h, d = t.shape
    dk = torch.empty((b * h, t.s_pad, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for ik in range(t.nk):
        dk_acc = torch.zeros((b * h, t.block_k, d), device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        v_blk = t.k_tile(t.v, ik).float()
        for iq in range(t.nq):
            if not t.live(iq, ik):
                continue
            p = t.p(iq, ik)
            do_blk = t.q_tile(t.do, iq)
            dv_acc = dv_acc + torch.matmul(p.to(do_blk.dtype).float().transpose(1, 2),
                                           do_blk.float())
            dp = torch.matmul(do_blk.float(), v_blk.transpose(1, 2))
            ds = p * (dp - t.q_tile(t.delta, iq))
            dk_acc = dk_acc + torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                                           t.q_tile(t.q, iq).float())
        t.k_tile(dk, ik)[:] = dk_acc * t.scale
        t.k_tile(dv, ik)[:] = dv_acc
    return _from_bh(dk, b, s, h, k.dtype), _from_bh(dv, b, s, h, v.dtype)


def flash_backward_plain(q, k, v, out, lse, do, *, causal=False, scale=None,
                         block_q=None, block_k=None):
    """Plain version of the whole flash backward: ``(dq, dk, dv)``."""
    delta = flash_backward_delta(out, do)
    kw = dict(causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    dq = flash_backward_dq_plain(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_backward_dkv_plain(q, k, v, do, lse, delta, **kw))


def _check_self_attention(what: str, q, k, v) -> Tuple[int, int, int, int]:
    _require(q.dim() == 4, what, f"expected q [b, s, h, d], got {tuple(q.shape)}")
    _require(q.shape == k.shape == v.shape, what,
             f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    return tuple(q.shape)


def _check_flash_operands(what: str, q, k, v) -> None:
    """What the flash kernels take: fp32/bf16 q/k/v of one dtype, any
    head_dim >= 1 (up to 128 in one register tile, above it in 128-dim
    chunks), the head_dim axis contiguous (other axes may be strided, as
    the split of a fused qkv projection gives them)."""
    _require(q.dtype in (torch.float32, torch.bfloat16), what,
             f"takes float32/bfloat16, got {q.dtype}")
    _require(q.dtype == k.dtype == v.dtype, what, "q/k/v dtypes differ")
    _require(q.shape[3] >= 1, what, f"head_dim must be >= 1, got {q.shape[3]}")
    _require(all(t.stride(3) == 1 for t in (q, k, v)), what,
             "the head_dim axis must be contiguous")


def _strides(*tensors):
    return [t.stride(i) for t in tensors for i in range(3)]


def _flash_forward_launch(what, q, k, v, causal, scale, device, want_lse):
    """Launch K9 into a new ``[b, s, h, d]`` output (and ``[b*h, s]`` fp32
    lse when ``want_lse``)."""
    b, s, h, d = q.shape
    _check_flash_operands(what, q, k, v)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    lib = cuda_build.library("flash_forward")
    cuda_build.check(
        lib.zk_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None,
            _DTYPE_CODES[q.dtype], b, s, h, d, *_strides(q, k, v), float(scale),
            int(bool(causal)), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["flash_forward_lse" if want_lse else "flash_forward"] += 1
    return out, lse


def flash_forward_lse(q, k, v, *, causal=False, scale=None):
    """K9 with lse: ``(out [b, s, h, d], lse [b*h, s] fp32)``, the forward
    that autograd saves for the backward."""
    what = "flash_forward_lse"
    _check_self_attention(what, q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    device = _cuda_device(what, q, k, v)
    if device is None:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, want_lse=True)
    return _flash_forward_launch(what, q, k, v, causal, scale, device, True)


def _check_backward_operands(what, q, k, v, do, lse, delta):
    b, s, h, _ = _check_self_attention(what, q, k, v)
    _require(do.shape == q.shape, what, f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("D", delta)):
        _require(t.shape == (b * h, s), what,
                 f"{name} must be [b*h, s] = [{b * h}, {s}], got {tuple(t.shape)}")


def _backward_kernel_operands(what, q, k, v, do, lse, delta):
    """Checks for K10/K11; dO in q's dtype, dO/lse/D contiguous."""
    _check_flash_operands(what, q, k, v)
    for name, t in (("lse", lse), ("D", delta)):
        _require(t.dtype == torch.float32 and t.is_contiguous(), what,
                 f"{name} must be contiguous float32")
    return do.to(q.dtype).contiguous()


def flash_backward_dq(q, k, v, do, lse, delta, *, causal=False, scale=None) -> torch.Tensor:
    """K10: dQ ``[b, s, h, d]`` in q's dtype from q/k/v, dO, lse and D
    (``[b*h, s]`` fp32, :func:`flash_backward_delta`)."""
    what = "flash_backward_dq"
    _check_backward_operands(what, q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    device = _cuda_device(what, q, k, v, do, lse, delta)
    if device is None:
        return flash_backward_dq_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)
    do = _backward_kernel_operands(what, q, k, v, do, lse, delta)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    lib = cuda_build.library("flash_backward")
    cuda_build.check(
        lib.zk_flash_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _DTYPE_CODES[q.dtype], b, s, h, d,
            *_strides(q, k, v), float(scale), int(bool(causal)), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["flash_backward_dq"] += 1
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal=False,
                       scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: ``(dK, dV)`` ``[b, s, h, d]`` in k's and v's dtypes, from the
    operands of :func:`flash_backward_dq`."""
    what = "flash_backward_dkv"
    _check_backward_operands(what, q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    device = _cuda_device(what, q, k, v, do, lse, delta)
    if device is None:
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)
    do = _backward_kernel_operands(what, q, k, v, do, lse, delta)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    if dk.numel() == 0:
        return dk, dv
    lib = cuda_build.library("flash_backward")
    cuda_build.check(
        lib.zk_flash_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], b, s,
            h, d, *_strides(q, k, v), float(scale), int(bool(causal)), device,
            _stream(device),
        ),
        what,
    )
    LAUNCHES["flash_backward_dkv"] += 1
    return dk, dv


#: The flash kernels (K9 and K9-lse, K10/K11) by the code
#: ``zk_flash_forward_variant`` / ``zk_flash_backward_variant`` returns:
#: ``"mma"`` (bf16 at head_dim <= 128, tensor cores), ``"fma"`` (fp32 at
#: head_dim <= 128, fp32 FMA, exact products) or ``"fma_wide"`` (head_dim
#: > 128, 128-dim chunks).
FLASH_VARIANTS = {0: "fma", 1: "fma_wide", 2: "mma"}


def _flash_variant(which: str, dtype: torch.dtype, head_dim: int) -> str:
    code = getattr(cuda_build.library(f"flash_{which}"), f"zk_flash_{which}_variant")(
        _DTYPE_CODES[dtype], int(head_dim))
    if code not in FLASH_VARIANTS:
        raise ValueError(f"flash {which}: no kernel for {dtype} at head_dim {head_dim}")
    return FLASH_VARIANTS[code]


def flash_forward_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which K9 kernel (with or without lse) a call on the card launches
    for this dtype and head_dim, as the library's dispatch decides (see
    :data:`FLASH_VARIANTS`). Builds the library at first use."""
    return _flash_variant("forward", dtype, head_dim)


def flash_backward_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which K10/K11 kernels a call on the card launches for this dtype
    and head_dim, as the library's dispatch decides (see
    :data:`FLASH_VARIANTS`). Builds the library at first use."""
    return _flash_variant("backward", dtype, head_dim)


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd, returning ``(out, lse)``: K9 with
    lse forward (saving q, k, v, out and lse), then D, K10 and K11
    backward. Where lse takes a cotangent (the ring-flash merge), the
    backward folds it into D as ``D' = D - dlse`` (fp32, ``[b*h, s]``;
    ``d lse_i / d S_ij = P_ij``, so ``dS = P * (dO V^T - D')``) and runs
    K10 and K11 unchanged, as JAX's ``_flash_attention_lse`` does; where
    it takes none (:func:`flash_attention`), D is left as it is. On CPU
    tensors the wrappers run their plain versions; on CUDA tensors they
    launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward_lse(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        delta = flash_backward_delta(out, do)
        if dlse is not None:
            delta = (delta - dlse.float()).contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_backward_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K9: flash attention over ``[b, s, h, d]`` (fp32 or bf16; q/k/v may
    be strided views with a contiguous last axis, as the split of a fused
    qkv projection gives them). Output ``[b, s, h, d]`` contiguous in the
    input dtype. A call that needs a gradient goes through
    :class:`_FlashAttention` (K9 with lse, then K10 and K11 backward)."""
    what = "flash_attention"
    _check_self_attention(what, q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale))[0]
    device = _cuda_device(what, q, k, v)
    if device is None:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return _flash_forward_launch(what, q, k, v, causal, scale, device, False)[0]


def flash_attention_lse(q, k, v, *, causal=False, scale=None):
    """Flash attention that also returns each row's log-sum-exp: ``(out
    [b, s, h, d], lse [b*h, s] fp32)``, K9 with lse. Under autograd both
    outputs take a cotangent (:class:`_FlashAttention`: K10 and K11
    with ``D' = D - dlse``); the ring-flash merge consumes ``lse``."""
    what = "flash_attention_lse"
    _check_self_attention(what, q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return flash_forward_lse(q, k, v, causal=causal, scale=scale)


# -- K12 / K13: decode attention --------------------------------------------


def _check_decode_q(what: str, q: torch.Tensor) -> Tuple[int, int, int]:
    _require(q.dim() == 4 and q.shape[1] == 1, what,
             f"expected q [slots, 1, heads, head_dim], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    return b, h, d


def _check_kernel_operands(what: str, q, kv, d, aligned) -> None:
    _require(q.dtype in (torch.float32, torch.bfloat16), what,
             f"q must be float32/bfloat16, got {q.dtype}")
    _require(d >= 1, what, f"head_dim must be >= 1, got {d}")
    _require(q.stride(3) == 1, what, "q's head_dim axis must be contiguous")
    for t in kv:
        _require(t.is_contiguous(), what, "caches, pools and tables must be contiguous")
    for t in aligned:
        _require(t.data_ptr() % 16 == 0, what, "K/V buffers must be 16-byte aligned")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K12: single-position decode attention over a slot cache, the
    contract of :func:`cached_attention` (``q [slots, 1, h, d]``,
    ``k_cache/v_cache [slots, capacity, h, d]`` in q's dtype, ``lengths
    [slots]`` int32), reading only the live rows of each slot. The row
    split's workspace is kept per card, stream and geometry, as K13's
    (:func:`_split_workspace`): calls on two streams never share it."""
    what = "paged_decode_attention"
    b, h, d = _check_decode_q(what, q)
    _require(k_cache.shape == v_cache.shape and k_cache.dim() == 4, what,
             f"k_cache/v_cache must be identical [slots, capacity, h, d], got "
             f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    _require(k_cache.shape[0] == b and k_cache.shape[2:] == (h, d), what,
             f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    _require(lengths.shape == (b,), what, f"lengths must be [{b}], got {tuple(lengths.shape)}")
    if scale is None:
        scale = d ** -0.5
    device = _cuda_device(what, q, k_cache, v_cache, lengths)
    if device is None:
        return cached_attention(q, k_cache, v_cache, lengths, scale=scale)
    _require(k_cache.dtype == v_cache.dtype == q.dtype, what,
             f"cache dtype {k_cache.dtype} must equal q's {q.dtype}")
    _require(lengths.dtype == torch.int32, what, f"lengths must be int32, got {lengths.dtype}")
    _check_kernel_operands(what, q, (k_cache, v_cache, lengths), d, (k_cache, v_cache))
    cap = k_cache.shape[1]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = cuda_build.library("decode_attention")
    stream = _stream(device)
    part, tickets = _split_workspace(lib, device, stream, (b, cap, h, d))
    cuda_build.check(
        lib.zk_paged_decode_attention(
            q.data_ptr(), q.stride(0), q.stride(2), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), _DTYPE_CODES[q.dtype], b, cap, h, d, float(scale), device,
            stream,
        ),
        what,
    )
    LAUNCHES["paged_decode_attention"] += 1
    return out


#: The K12 and K13 kernels by the code ``zk_decode_attention_variant``
#: returns (one rule for both): ``"split"`` (head_dim <= 256: each (slot,
#: head)'s rows split over blocks, merged in the same launch) or
#: ``"wide"`` (head_dim > 256: one block per (slot, head) over 256-dim
#: chunks).
DECODE_VARIANTS = {0: "split", 1: "wide"}

#: The row split's workspace per (card, stream, geometry), K12's and
#: K13's: the chunk states ``part`` (fp32) and the tickets (int32 zeros
#: that every launch leaves at zero). Launches on one stream run in
#: order, so they share one; a launch on another stream gets its own.
_WORKSPACE: Dict[Tuple[int, ...], Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_workspace(lib, device: int, stream: int,
                     geometry: Tuple[int, int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row split's (part, tickets) for ``geometry`` (slots, rows a
    slot holds, h, d) on ``stream``, made at the first call of the key:
    K12's rows are its capacity, K13's ``max_pages * page_size``."""
    key = (device, stream, *geometry)
    ws = _WORKSPACE.get(key)
    if ws is None:
        slots, _, h, _ = geometry
        dev = torch.device("cuda", device)
        ws = _WORKSPACE[key] = (
            torch.empty(lib.zk_decode_attention_workspace(*geometry),
                        dtype=torch.float32, device=dev),
            torch.zeros(slots * h, dtype=torch.int32, device=dev),
        )
    return ws


def decode_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a K12 or K13 call on the card launches for q's dtype
    and head_dim, as the library's dispatch decides (see
    :data:`DECODE_VARIANTS`). Builds the library at first use."""
    code = cuda_build.library("decode_attention").zk_decode_attention_variant(
        _DTYPE_CODES[dtype], int(head_dim))
    if code not in DECODE_VARIANTS:
        raise ValueError(f"decode: no kernel for {dtype} at head_dim {head_dim}")
    return DECODE_VARIANTS[code]


def pool_paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K13: K12 through per-slot page tables over a shared pool, the
    contract of :func:`pool_decode_attention`: pools ``[pages,
    page_size, h, d]`` in q's dtype, or int8 with ``k_scale/v_scale
    [pages, page_size, h]`` float32; ``page_table [slots, max_pages]``
    int32 (entries clipped to the pool); lengths clamped to
    ``max_pages * page_size - 1``. The row split's workspace is kept per
    card, stream and geometry (:func:`_split_workspace`): calls on one
    stream reuse it in order, calls on two streams never share it."""
    what = "pool_paged_decode_attention"
    b, h, d = _check_decode_q(what, q)
    _require(k_pool.shape == v_pool.shape and k_pool.dim() == 4, what,
             f"k_pool/v_pool must be identical [pages, page_size, h, d], got "
             f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _require(k_pool.shape[2:] == (h, d), what,
             f"pool {tuple(k_pool.shape)} does not match q {tuple(q.shape)}")
    _require(page_table.dim() == 2 and page_table.shape[0] == b, what,
             f"page_table must be [slots={b}, max_pages], got {tuple(page_table.shape)}")
    _require(lengths.shape == (b,), what, f"lengths must be [{b}], got {tuple(lengths.shape)}")
    _require((k_scale is None) == (v_scale is None), what,
             "k_scale and v_scale must be given together")
    if scale is None:
        scale = d ** -0.5
    scales = () if k_scale is None else (k_scale, v_scale)
    device = _cuda_device(what, q, k_pool, v_pool, page_table, lengths, *scales)
    if device is None:
        return pool_decode_attention(q, k_pool, v_pool, page_table, lengths,
                                     k_scale=k_scale, v_scale=v_scale, scale=scale)
    num_pages, ps = k_pool.shape[:2]
    if scales:
        _require(k_pool.dtype == v_pool.dtype == torch.int8, what,
                 "scales are given, so the pools must be int8")
        for t in scales:
            _require(t.shape == k_pool.shape[:3] and t.dtype == torch.float32, what,
                     f"scales must be float32 {tuple(k_pool.shape[:3])}, got "
                     f"{t.dtype} {tuple(t.shape)}")
    else:
        _require(k_pool.dtype == v_pool.dtype == q.dtype, what,
                 f"pool dtype {k_pool.dtype} must equal q's {q.dtype} (or be int8 with scales)")
    _require(page_table.dtype == torch.int32 and lengths.dtype == torch.int32, what,
             "page_table and lengths must be int32")
    _check_kernel_operands(what, q, (k_pool, v_pool, page_table, lengths, *scales), d,
                           (k_pool, v_pool))
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = cuda_build.library("decode_attention")
    max_pages = page_table.shape[1]
    stream = _stream(device)
    part, tickets = _split_workspace(lib, device, stream, (b, max_pages * ps, h, d))
    cuda_build.check(
        lib.zk_pool_paged_decode_attention(
            q.data_ptr(), q.stride(0), q.stride(2), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr() if scales else None,
            v_scale.data_ptr() if scales else None, page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_pool.dtype], b, max_pages, num_pages, ps,
            h, d, float(scale), device, stream,
        ),
        what,
    )
    LAUNCHES["pool_paged_decode_attention"] += 1
    return out


# -- the sharded decode path ------------------------------------------------
#
# Decode attention is elementwise over slots and heads, so a rank that
# holds its (slots, heads) block of q, the lengths and the cache (or its
# heads of the pool and its slots' rows of the table) computes exactly its
# block of the whole call's output with zero collectives: the JAX
# package's shard_map local function. Here each rank already holds its
# blocks (the decode engine allocates them, ``parallel.shards.
# DecodeShard``), so the wrappers check the layout and run K12 or K13 on
# them. The kernels are looked up at call time.


def _mesh_axes(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or a ``{axis: size}`` mapping."""
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def _check_decode_axes(what: str, mesh, data_axes, model_axis, replicated: bool) -> None:
    if mesh is None:
        raise ValueError(f"{what}: the sharded decode path needs the mesh.")
    if replicated:
        return
    names = _mesh_axes(mesh)
    unknown = [a for a in (*tuple(data_axes), *((model_axis,) if model_axis else ()))
               if a not in names]
    _require(not unknown, what, f"axes {unknown} are not mesh axes {names}")


def sharded_paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    mesh,
    data_axes=("data",),
    model_axis: Optional[str] = None,
    replicated: bool = False,
    **kernel_kwargs,
) -> torch.Tensor:
    """:func:`paged_decode_attention` (K12) on this rank's block: ``q
    [slots / data, 1, heads / model, d]``, the cache ``[slots / data,
    capacity, heads / model, d]`` and ``lengths [slots / data]``, the
    layout ``parallel.rules.decode_cache_rules(data_axes, model_axis)``
    gives the cache (slots over ``data_axes``, heads over ``model_axis``).
    Returns this rank's block of the output, with zero collectives.
    ``replicated=True`` is the engine's indivisible-geometry fallback:
    every rank holds and runs the whole call. ``mesh`` is the
    ``DeviceMesh`` (or a ``{axis: size}`` mapping, to compose ranks in
    one process)."""
    what = "sharded_paged_decode_attention"
    _check_decode_axes(what, mesh, data_axes, model_axis, replicated)
    return paged_decode_attention(q, k_cache, v_cache, lengths, **kernel_kwargs)


def sharded_pool_paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    mesh,
    data_axes=("data",),
    model_axis: Optional[str] = None,
    replicated: bool = False,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    **kernel_kwargs,
) -> torch.Tensor:
    """:func:`pool_paged_decode_attention` (K13) on this rank's block. A
    pool differs from a slot cache in one way: any slot may read any page,
    so the pages never split; the pools ``[pages, page_size, heads /
    model, d]`` and their int8 scales ``[pages, page_size, heads / model]``
    split on heads only, while q, ``page_table [slots / data, max_pages]``
    and ``lengths`` split on slots (``parallel.rules.page_pool_rules``).
    Zero collectives; ``replicated=True`` runs the whole call on every
    rank."""
    what = "sharded_pool_paged_decode_attention"
    _check_decode_axes(what, mesh, data_axes, model_axis, replicated)
    return pool_paged_decode_attention(q, k_pool, v_pool, page_table, lengths,
                                       k_scale=k_scale, v_scale=v_scale, **kernel_kwargs)


# -- sequence parallelism across ranks: ring, ring-flash, Ulysses -----------
#
# Each rank holds its sequence shard ``[b, s/n, h, d]`` of q, k and v; the
# n ranks of the ``seq_axis`` group (the ranks of one data index) hold the
# shards in rank order. The JAX package runs the same programs under
# shard_map; here every rank runs its own, and the collectives are
# ``torch.distributed`` calls on the sp group.


def _check_self_attention_shapes(q, k, v) -> None:
    """Identical q/k/v shapes are the sequence-parallel contract (the JAX
    package's check and message)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "Sequence-parallel attention requires q, k, v of identical "
            f"shape (self-attention); got q={tuple(q.shape)}, k={tuple(k.shape)}, "
            f"v={tuple(v.shape)}."
        )


def _ring(group) -> Tuple[int, int]:
    """``(n, my)``: the group's size and this rank's index in it; ``(1,
    0)`` without a group."""
    import torch.distributed as dist

    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _ring_start(tensors, group, shift: int):
    """Post one hop of ``tensors`` around ``group``: send each to group
    rank ``my + shift``, receive its successor's from ``my - shift``.
    Returns ``(received, works, sent)``; the received buffers hold the
    data once every work has been waited on, and ``sent`` must live
    until then."""
    import torch.distributed as dist

    n, my = _ring(group)
    dst = dist.get_global_rank(group, (my + shift) % n)
    src = dist.get_global_rank(group, (my - shift) % n)
    sent = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = []
    for t, r in zip(sent, received):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    return received, dist.batch_isend_irecv(ops), sent


class _RingRotate(torch.autograd.Function):
    """One ring hop of a K/V block (``_ring_rotate``): group rank i sends
    to i-1 and receives from i+1, so after t hops rank r holds the block
    that started on ``(r + t) % n``. The backward runs the inverse hop.
    ``pending``: None waits in the forward; a list takes the works (and
    the sent buffers) for the caller to wait on after the block's compute
    (the overlap schedule)."""

    @staticmethod
    def forward(ctx, k, v, group, pending):
        ctx.group = group
        (k_next, v_next), works, sent = _ring_start((k, v), group, -1)
        if pending is None:
            for w in works:
                w.wait()
        else:
            pending.extend([*works, sent])
        return k_next, v_next

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dk, dv):
        (dk_prev, dv_prev), works, _ = _ring_start((dk, dv), ctx.group, 1)
        for w in works:
            w.wait()
        return dk_prev, dv_prev, None, None


def _wait(pending) -> None:
    for item in pending:
        if not isinstance(item, list):
            item.wait()


def _ring_rotate(k_blk, v_blk, group, pending=None):
    """One hop of the ring (:class:`_RingRotate`); the identity at n = 1."""
    if _ring(group)[0] == 1:
        return k_blk, v_blk
    return _RingRotate.apply(k_blk, v_blk, group, pending)


class _KeepRingInGraph(torch.autograd.Function):
    """``o.to(dtype)`` that also takes the ring's last K/V blocks, whose
    gradient it leaves at zero. The rotations form a chain, so the last
    blocks tie every rotation into the backward graph on every rank: a
    causal rank that used no rotated block (rank 0 skips every block after
    its own) still runs each inverse rotation its peers post, in the same
    order, instead of leaving them waiting."""

    @staticmethod
    def forward(ctx, o, dtype, k_last, v_last):
        ctx.o_dtype = o.dtype
        ctx.blocks = [(t.shape, t.dtype, t.device) for t in (k_last, v_last)]
        return o.to(dtype, copy=True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        zeros = [torch.zeros(shape, dtype=dtype, device=device)
                 for shape, dtype, device in ctx.blocks]
        return grad.to(ctx.o_dtype), None, *zeros


def _ring_loop(k, v, group, overlap: bool, block_fn):
    """The ring schedule over the n blocks: ``block_fn(t, k_blk, v_blk)``
    at step t on the block that started on ``(my + t) % n``, with the
    rotation to the next block issued before the compute and waited on
    after it (``overlap``) or issued after it. No hop follows the last
    block. Returns the last blocks."""
    n, _ = _ring(group)
    k_blk, v_blk = k, v
    for t in range(n):
        last = t == n - 1
        pending = []
        if overlap and not last:
            nxt = _ring_rotate(k_blk, v_blk, group, pending)
        block_fn(t, k_blk, v_blk)
        if not last:
            if overlap:
                _wait(pending)
            else:
                nxt = _ring_rotate(k_blk, v_blk, group)
            k_blk, v_blk = nxt
    return k_blk, v_blk


def ring_attention_local(q, k, v, *, group, causal=False, scale=None, overlap=True):
    """The per-rank ring program with dense block compute (JAX's
    ``ring_attention_local``): the online softmax of this rank's queries
    over each rank's K/V block in ring order, scores and products in fp32,
    causal masking by global positions (this rank's queries start at ``my
    * sq``; the block at step t started on ``(my + t) % n``). ``overlap``
    picks the schedule (:func:`_ring_loop`); the same bits either way."""
    _check_self_attention_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, my = _ring(group)
    b, sq, h, d = q.shape
    qf = q.float().permute(0, 2, 1, 3)  # [b, h, sq, d]
    carry = {
        "m": torch.full((b, h, sq), _MASK_VALUE, dtype=torch.float32, device=q.device),
        "l": torch.zeros((b, h, sq), dtype=torch.float32, device=q.device),
        "acc": torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device),
    }
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sq, device=q.device)[None, :]

    def block(t, k_blk, v_blk):
        s = torch.einsum("bhqd,bkhd->bhqk", qf, k_blk.float()) * float(scale)
        if causal:
            src = (my + t) % n
            s = torch.where(src * sq + cols <= my * sq + rows, s, _MASK_VALUE)
        m, l, acc = carry["m"], carry["l"], carry["acc"]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        carry["m"] = m_new
        carry["l"] = l * corr + p.sum(dim=-1)
        carry["acc"] = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())

    _ring_loop(k, v, group, overlap, block)
    out = carry["acc"] / carry["l"][..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_flash_step(q, k_blk, v_blk, o, lse, *, src, my, causal=False, scale=None):
    """One ring-flash step: this rank's queries (group index ``my``)
    against the K/V block that started on ``src``, merged into the
    running ``(o [b, s, h, d] fp32, lse [b, s, h, 1] fp32)`` (both None
    before the first block). The block's position picks its kernel call
    under ``causal``: ``src == my`` the causal diagonal block (K9-lse on
    local indices), ``src < my`` a full block, ``src > my`` no call (its
    zeros and ``_MASK_VALUE`` lse leave the merge as it was). The merge is
    JAX's: ``lse' = logaddexp(lse, lse_t)``, ``o' = o exp(lse - lse') +
    o_t exp(lse_t - lse')``; the first block is taken as it is (the merge
    of it into the empty state, to the bit)."""
    if causal and src > my:
        return o, lse
    b, s, h, _ = q.shape
    o_t, lse_t = flash_attention_lse(q, k_blk, v_blk, causal=causal and src == my, scale=scale)
    o_t = o_t.float()
    lse_t = lse_t.view(b, h, s).permute(0, 2, 1).unsqueeze(-1)
    if o is None:
        return o_t, lse_t
    lse_new = torch.logaddexp(lse, lse_t)
    return o * torch.exp(lse - lse_new) + o_t * torch.exp(lse_t - lse_new), lse_new


def ring_flash_attention_local(q, k, v, *, group, causal=False, scale=None, overlap=True):
    """The composed tier, flash within the card and ring across cards
    (JAX's ``ring_flash_attention_local``): :func:`ring_flash_step` on
    each block in ring order, K9-lse forward and K10/K11 backward (with
    the lse cotangent) per live block, the inverse rotation carrying the
    K/V gradients home. ``overlap`` picks the schedule; the same bits
    either way. Output in q's dtype."""
    _check_self_attention_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, my = _ring(group)
    state = {"o": None, "lse": None}

    def block(t, k_blk, v_blk):
        state["o"], state["lse"] = ring_flash_step(
            q, k_blk, v_blk, state["o"], state["lse"], src=(my + t) % n, my=my,
            causal=causal, scale=scale)

    k_last, v_last = _ring_loop(k, v, group, overlap, block)
    if n > 1 and torch.is_grad_enabled() and k_last.requires_grad:
        return _KeepRingInGraph.apply(state["o"], q.dtype, k_last, v_last)
    return state["o"].to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over ``group`` along the leading axis (chunk
    j goes to group rank j), autograd-aware."""
    import warnings

    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()
    with warnings.catch_warnings():
        # Deprecated in favour of a private module; present in every
        # torch this port runs on.
        warnings.simplefilter("ignore", FutureWarning)
        return all_to_all_single(torch.empty_like(x), x, group=group)


def _seq_to_heads(x, group, n):
    """``[b, s/n, h, d]`` sequence shards -> ``[b, s, h/n, d]`` head
    shards (JAX's ``all_to_all(split_axis=2, concat_axis=1, tiled=True)``)."""
    b, sl, h, d = x.shape
    parts = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4)
    return _all_to_all(parts, group).permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)


def _heads_to_seq(x, group, n):
    """The inverse of :func:`_seq_to_heads`."""
    b, s, hn, d = x.shape
    parts = x.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4)
    return _all_to_all(parts, group).permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hn, d)


def all_to_all_attention_local(q, k, v, *, group, causal=False, scale=None,
                               local_attention="dense", axis_name="sp"):
    """Ulysses-style sequence parallelism (JAX's
    ``all_to_all_attention_local``): one all-to-all re-shards q, k and v
    from sequence shards ``[b, s/n, h, d]`` to head shards ``[b, s, h/n,
    d]``, the local attention runs over the whole sequence of this rank's
    heads (``"dense"``: the fp32 oracle; ``"flash"``: K9, and K9-lse with
    K10/K11 under autograd), and one all-to-all re-shards back. Needs
    ``heads % n == 0``."""
    if local_attention not in ("dense", "flash"):
        raise ValueError(
            f"local_attention={local_attention!r}: expected 'dense' or "
            "'flash'."
        )
    _check_self_attention_shapes(q, k, v)
    n, _ = _ring(group)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"heads={q.shape[2]} is not divisible by the '{axis_name}' "
            f"axis size {n}, which all-to-all (Ulysses) attention needs "
            "to give every device whole heads."
        )
    local_fn = flash_attention if local_attention == "flash" else attention_reference
    if n == 1:
        return local_fn(q, k, v, causal=causal, scale=scale)
    out = local_fn(*(_seq_to_heads(t, group, n) for t in (q, k, v)), causal=causal, scale=scale)
    return _heads_to_seq(out, group, n)


def _seq_group(q, k, v, mesh, seq_axis, batch_axis):
    """The checks of JAX's one-call wrappers, on this rank's shards, and
    the ring's group (None without a mesh: one rank, no collective)."""
    _check_self_attention_shapes(q, k, v)
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    for axis in (seq_axis, batch_axis):
        if axis is not None and axis not in names:
            raise ValueError(f"Mesh axis {axis!r} is not one of the mesh's axes {names}.")
    return mesh.get_group(seq_axis)


def ring_attention(q, k, v, *, mesh, seq_axis, batch_axis=None, causal=False,
                   scale=None, overlap=True):
    """One-call sequence-parallel attention with dense block compute
    (JAX's ``ring_attention``) over this rank's shards ``[b, s/n, h,
    d]`` of q/k/v: the ring over ``mesh``'s ``seq_axis`` group. ``batch_
    axis`` names the axis the batch is split over (each of its indices
    runs its own ring; attention is batch-elementwise, so it changes no
    value). ``mesh=None`` is one rank."""
    group = _seq_group(q, k, v, mesh, seq_axis, batch_axis)
    return ring_attention_local(q, k, v, group=group, causal=causal, scale=scale,
                                overlap=overlap)


def ring_flash_attention(q, k, v, *, mesh, seq_axis, batch_axis=None, causal=False,
                         scale=None, overlap=True):
    """One-call composed-tier attention (JAX's ``ring_flash_attention``):
    :func:`ring_attention`'s contract with the flash kernels as each
    block's compute (:func:`ring_flash_attention_local`)."""
    group = _seq_group(q, k, v, mesh, seq_axis, batch_axis)
    return ring_flash_attention_local(q, k, v, group=group, causal=causal, scale=scale,
                                      overlap=overlap)


def all_to_all_attention(q, k, v, *, mesh, seq_axis, batch_axis=None, causal=False,
                         scale=None, local_attention="dense"):
    """One-call Ulysses attention (JAX's ``all_to_all_attention``):
    :func:`ring_attention`'s contract, the all-to-all re-shard of
    :func:`all_to_all_attention_local` as the communication."""
    group = _seq_group(q, k, v, mesh, seq_axis, batch_axis)
    return all_to_all_attention_local(q, k, v, group=group, causal=causal, scale=scale,
                                      local_attention=local_attention, axis_name=seq_axis)
