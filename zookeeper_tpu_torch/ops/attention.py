"""Attention for the TransformerLM decode-serving path: the plain
oracles and the hand-written CUDA kernels.

The PyTorch counterpart of the part of ``zookeeper_tpu/ops/attention.py``
that prefill and decode run. Public functions keep the JAX layout ``q/k/v
[batch, seq, heads, head_dim]``. The oracles (``attention_reference``,
``cached_attention``, ``pool_decode_attention``) compute in fp32 with
exact products, as the JAX ones pin ``Precision.HIGHEST``.

Kernels (sources in ``zookeeper_tpu_torch/csrc``), each with its plain
PyTorch version beside it:

- K9 :func:`flash_attention` — the flash forward (``_flash_forward``
  with ``want_lse=False``): causal or full, padded keys masked, ``p``
  rounded to ``v``'s dtype before ``p @ v``. Its plain version
  :func:`flash_attention_plain` is the same blocked online softmax with
  the JAX block choice, so on the CPU it tracks JAX's kernel, not only
  the dense oracle. The backward (K10, K11) and the ``lse`` output come
  with LM training (ROADMAP.md); a call that needs a gradient raises.
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
    "paged_decode_attention": 0,
    "pool_paged_decode_attention": 0,
}

#: Largest head_dim each kernel serves (K9 pads its tiles to 32, 64 or
#: 128 dims; K12/K13 to 32, 64, 128 or 256).
FLASH_MAX_HEAD_DIM = 128
DECODE_MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_NO_BACKWARD = (
    "flash_attention is forward-only in the PyTorch port: the flash "
    "backward (K10, K11) and the lse output come with LM training "
    "(queued in ROADMAP.md). Call it under torch.no_grad() or on "
    "tensors that do not require grad."
)


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


# -- K9: flash attention forward --------------------------------------------

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
) -> torch.Tensor:
    """Plain version of K9: ``_flash_forward``'s blocked online softmax
    (running max from ``_MASK_VALUE``, sum and accumulator in fp32; k
    blocks above the causal diagonal skipped; keys past ``s`` masked;
    ``p`` cast to ``v``'s dtype before ``p @ v``) with the JAX block
    choice, over ``[b, s, h, d]``."""
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
    out = out.to(q.dtype).reshape(b, h, s_pad, d).permute(0, 2, 1, 3)
    return out[:, :s].contiguous()


def _check_self_attention(what: str, q, k, v) -> Tuple[int, int, int, int]:
    _require(q.dim() == 4, what, f"expected q [b, s, h, d], got {tuple(q.shape)}")
    _require(q.shape == k.shape == v.shape, what,
             f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    return tuple(q.shape)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K9: flash attention forward over ``[b, s, h, d]`` (fp32 or bf16;
    q/k/v may be strided views with a contiguous last axis, as the
    split of a fused qkv projection gives them). Output ``[b, s, h, d]``
    contiguous in the input dtype."""
    what = "flash_attention"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(_NO_BACKWARD)
    b, s, h, d = _check_self_attention(what, q, k, v)
    if scale is None:
        scale = d ** -0.5
    device = _cuda_device(what, q, k, v)
    if device is None:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _require(q.dtype in (torch.float32, torch.bfloat16), what,
             f"takes float32/bfloat16, got {q.dtype}")
    _require(q.dtype == k.dtype == v.dtype, what, "q/k/v dtypes differ")
    _require(1 <= d <= FLASH_MAX_HEAD_DIM, what,
             f"head_dim {d} is past the kernel's {FLASH_MAX_HEAD_DIM}")
    _require(all(t.stride(3) == 1 for t in (q, k, v)), what,
             "the head_dim axis must be contiguous")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    lib = cuda_build.library("flash_forward")
    cuda_build.check(
        lib.zk_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, s, h, d, *strides, float(scale),
            int(bool(causal)), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["flash_forward"] += 1
    return out


# -- K12 / K13: decode attention --------------------------------------------


def _check_decode_q(what: str, q: torch.Tensor) -> Tuple[int, int, int]:
    _require(q.dim() == 4 and q.shape[1] == 1, what,
             f"expected q [slots, 1, heads, head_dim], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    return b, h, d


def _check_kernel_operands(what: str, q, kv, d, aligned) -> None:
    _require(q.dtype in (torch.float32, torch.bfloat16), what,
             f"q must be float32/bfloat16, got {q.dtype}")
    _require(1 <= d <= DECODE_MAX_HEAD_DIM, what,
             f"head_dim {d} is past the kernel's {DECODE_MAX_HEAD_DIM}")
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
