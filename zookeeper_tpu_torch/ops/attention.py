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
  :func:`flash_attention` trains. bf16 calls at head_dim <= 128 run on
  tensor cores, fp32 (exact products) and wider head_dims on fp32 FMA;
  :func:`flash_backward_variant` names the kernels a call takes. The
  ``lse`` cotangent of JAX's ``_flash_attention_lse`` (only the ring
  merge uses it) is not ported.
- K12 :func:`paged_decode_attention` — one-position decode over a slot
  cache ``[slots, capacity, heads, head_dim]``, reading only rows
  ``0..clamp(lengths, 0, capacity - 1)``. Plain version:
  :func:`cached_attention`.
- K13 :func:`pool_paged_decode_attention` — K12 through per-slot page
  tables over a shared page pool, with optional int8 rows times fp32
  per-(row, head) scales. Plain version: :func:`pool_decode_attention`.

A wrapper runs its plain version only when its tensors lie on the CPU.
On CUDA tensors it launches its kernel (counting the launch in
:data:`LAUNCHES`) or raises; it never falls back. Kernel and plain
version differ only by the order of fp32 sums (online softmax over
other blocks), within the JAX package's stated tolerances.
"""

import math
from typing import Optional, Tuple

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


#: The K10/K11 kernels by the code ``zk_flash_backward_variant`` returns.
BACKWARD_VARIANTS = {0: "fma", 1: "fma_wide", 2: "mma"}


def flash_backward_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which K10/K11 kernels a call on the card launches for this dtype
    and head_dim, as the library's dispatch decides: ``"mma"`` (bf16 at
    head_dim <= 128, tensor cores), ``"fma"`` (fp32 at head_dim <= 128,
    fp32 FMA, exact products) or ``"fma_wide"`` (head_dim > 128, 128-dim
    chunks). Builds the library at first use."""
    code = cuda_build.library("flash_backward").zk_flash_backward_variant(
        _DTYPE_CODES[dtype], int(head_dim))
    if code not in BACKWARD_VARIANTS:
        raise ValueError(f"flash backward: no kernel for {dtype} at head_dim {head_dim}")
    return BACKWARD_VARIANTS[code]


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: K9 with lse forward (saving q, k,
    v, out and lse), then D, K10 and K11 backward. On CPU tensors the
    wrappers run their plain versions; on CUDA tensors they launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward_lse(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = flash_backward_delta(out, do)
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
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    device = _cuda_device(what, q, k, v)
    if device is None:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return _flash_forward_launch(what, q, k, v, causal, scale, device, False)[0]


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
    [slots]`` int32), reading only the live rows of each slot."""
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
    cuda_build.check(
        lib.zk_paged_decode_attention(
            q.data_ptr(), q.stride(0), q.stride(2), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, cap, h, d, float(scale), device,
            _stream(device),
        ),
        what,
    )
    LAUNCHES["paged_decode_attention"] += 1
    return out


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
    ``max_pages * page_size - 1``."""
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
    cuda_build.check(
        lib.zk_pool_paged_decode_attention(
            q.data_ptr(), q.stride(0), q.stride(2), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr() if scales else None,
            v_scale.data_ptr() if scales else None, page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_pool.dtype], b, page_table.shape[1], num_pages, ps,
            h, d, float(scale), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["pool_paged_decode_attention"] += 1
    return out
