"""The port's attention oracles, the plain versions of K9, K12 and K13,
and the int8 KV-row codec, against the JAX package on the same seeded
numpy inputs.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU. Tolerances:

- the oracles (``attention_reference``, ``cached_attention``,
  ``pool_decode_attention``): 1e-6 in fp32; both sides take exact fp32
  products, and only the order of the sums differs;
- the plain flash against ``flash_attention``: 2e-5 in fp32 and 3e-2 in
  bf16, the JAX package's own (``tests/ops/test_ring_attention.py``);
- the plain K12/K13 against ``paged_decode_attention`` and
  ``pool_paged_decode_attention``: 2e-6 in fp32, the JAX package's
  kernel-versus-reference bound;
- ``quantize_kv_rows``: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu import ops as jops
from zookeeper_tpu.ops.quantizers import quantize_kv_rows as jax_quantize_kv_rows
from zookeeper_tpu_torch.ops import attention as A
from zookeeper_tpu_torch.ops.quantizers import dequantize_kv_rows, quantize_kv_rows

F32_ORACLE = 1e-6
F32_FLASH, BF16_FLASH = 2e-5, 3e-2
F32_DECODE = 2e-6


def _t(x):
    """numpy -> torch (a copy: jax-backed arrays are read-only)."""
    return torch.from_numpy(np.array(x))


def _j(x, dtype=None):
    return jnp.asarray(x, dtype=dtype)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


# -- the oracles -------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 13, 3, 8), (1, 32, 2, 16)])
def test_attention_reference_matches_jax(shape, causal):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, *shape) for _ in range(3))
    want = jops.attention_reference(_j(q), _j(k), _j(v), causal=causal)
    got = A.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want, F32_ORACLE)


@pytest.mark.parametrize("head_dim", [8, 16])
def test_cached_attention_matches_jax(head_dim):
    rng = np.random.default_rng(1)
    b, cap, h = 5, 24, 3
    q = _normal(rng, b, 1, h, head_dim)
    k, v = _normal(rng, b, cap, h, head_dim), _normal(rng, b, cap, h, head_dim)
    lengths = np.array([0, 1, 11, cap - 1, cap + 7], np.int32)
    want = jops.cached_attention(_j(q), _j(k), _j(v), _j(lengths))
    got = A.cached_attention(_t(q), _t(k), _t(v), _t(lengths))
    _close(got, want, F32_ORACLE)


def _pool_case(rng, head_dim, quant):
    """Pools of 16 pages of 4 rows, 3 slots of up to 5 pages each, with
    dead (-1) and negative table entries, garbage everywhere else."""
    b, pages, ps, h, m = 3, 16, 4, 2, 5
    q = _normal(rng, b, 1, h, head_dim)
    kp, vp = _normal(rng, pages, ps, h, head_dim), _normal(rng, pages, ps, h, head_dim)
    table = rng.permutation(pages)[: b * m].reshape(b, m).astype(np.int32)
    table[0, 3:] = -1
    table[1, 4] = -7
    lengths = np.array([11, 19, 0], np.int32)
    scales = None
    if quant:
        kq, ks = (np.array(x) for x in jax_quantize_kv_rows(_j(kp)))
        vq, vs = (np.array(x) for x in jax_quantize_kv_rows(_j(vp)))
        kp, vp, scales = kq, vq, (ks, vs)
    return q, kp, vp, table, lengths, scales


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("head_dim", [8, 16])
def test_pool_decode_attention_matches_jax(head_dim, quant):
    q, kp, vp, table, lengths, scales = _pool_case(np.random.default_rng(2), head_dim, quant)
    jkw = {} if scales is None else {"k_scale": _j(scales[0]), "v_scale": _j(scales[1])}
    tkw = {} if scales is None else {"k_scale": _t(scales[0]), "v_scale": _t(scales[1])}
    want = jops.pool_decode_attention(_j(q), _j(kp), _j(vp), _j(table), _j(lengths), **jkw)
    got = A.pool_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths), **tkw)
    _close(got, want, F32_ORACLE)


def test_decode_attention_supported_matches_jax():
    for h in (0, 1, 8):
        for d in (4, 8, 12, 16, 64, 72):
            assert A.decode_attention_supported(h, d) == jops.decode_attention_supported(h, d)


# -- K9: the plain flash forward against the JAX kernel ----------------------


@pytest.mark.parametrize(
    "shape,causal,blocks",
    [
        ((1, 16, 2, 8), True, (None, None)),
        ((2, 37, 2, 16), True, (None, None)),   # ragged s: padded keys masked
        ((1, 64, 2, 8), False, (None, None)),
        ((1, 48, 1, 8), True, (16, 32)),        # unequal blocks: lcm padding
        ((1, 40, 2, 16), False, (32, 16)),
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_jax_flash(shape, causal, blocks, dtype):
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, *shape) for _ in range(3))
    bq, bk = blocks
    want = jops.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype), causal=causal,
                                block_q=bq, block_k=bk)
    tdtype = getattr(torch, dtype)
    tq, tk, tv = (_t(x).to(tdtype) for x in (q, k, v))
    got = A.flash_attention_plain(tq, tk, tv, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == tdtype and tuple(got.shape) == shape
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           F32_FLASH if dtype == "float32" else BF16_FLASH)
    if bq is None:  # the wrapper on CPU tensors is the plain version
        assert torch.equal(A.flash_attention(tq, tk, tv, causal=causal), got)


def test_flash_block_policy_matches_jax():
    from zookeeper_tpu.ops.attention import _flash_dims
    from zookeeper_tpu.ops.blocks import _default_flash_blocks

    for s in (1, 8, 16, 37, 100, 999, 1100, 2048, 8192):
        for d, size in ((64, 2), (128, 4), (256, 4)):
            blocks = _default_flash_blocks(s, None, None, head_dim=d, itemsize=size)
            assert A._default_flash_blocks(s, None, None, head_dim=d, itemsize=size) == blocks
            assert A._flash_dims(s, *blocks) == _flash_dims(s, *blocks)


def test_flash_with_a_gradient_raises():
    """A first gradient flows (K9 with lse, K10, K11; their numbers are
    held to JAX in test_torch_flash_backward.py); the backward is
    differentiable once (its gradient carries no graph), so a gradient
    of the gradient raises."""
    q = torch.randn(1, 8, 1, 8, requires_grad=True)
    out = A.flash_attention(q, q, q, causal=True)
    (grad,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    assert grad.shape == q.shape and bool(torch.isfinite(grad).all())
    assert not grad.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(grad.sum(), q)
    with torch.no_grad():
        assert A.flash_attention(q, q, q, causal=True).shape == q.shape


# -- K12 / K13: the plain versions against the JAX kernels -------------------


@pytest.mark.parametrize("head_dim", [8, 16])
def test_plain_k12_matches_jax_kernel(head_dim):
    """Lengths at and past capacity, a one-row slot, and garbage (large
    values) in every row past a slot's length."""
    rng = np.random.default_rng(4)
    b, cap, h = 4, 32, 2
    q = _normal(rng, b, 1, h, head_dim)
    k, v = _normal(rng, b, cap, h, head_dim), _normal(rng, b, cap, h, head_dim)
    lengths = np.array([0, 13, cap - 1, cap + 5], np.int32)
    for slot, n in enumerate(lengths):
        k[slot, n + 1:] = 1e4
        v[slot, n + 1:] = -1e4
    want = jops.paged_decode_attention(_j(q), _j(k), _j(v), _j(lengths), page_size=4)
    got = A.paged_decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    _close(got, want, F32_DECODE)
    assert A.LAUNCHES["paged_decode_attention"] == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("head_dim", [8, 16])
def test_plain_k13_matches_jax_kernel(head_dim, quant):
    q, kp, vp, table, lengths, scales = _pool_case(np.random.default_rng(5), head_dim, quant)
    lengths = np.array([11, 19, 40], np.int32)  # the last past the table's 20 rows
    jkw = {} if scales is None else {"k_scale": _j(scales[0]), "v_scale": _j(scales[1])}
    tkw = {} if scales is None else {"k_scale": _t(scales[0]), "v_scale": _t(scales[1])}
    want = jops.pool_paged_decode_attention(_j(q), _j(kp), _j(vp), _j(table), _j(lengths), **jkw)
    got = A.pool_paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths), **tkw)
    _close(got, want, F32_DECODE)


def test_decode_wrappers_validate_shapes():
    q = torch.zeros(2, 1, 2, 8)
    with pytest.raises(ValueError, match="q \\[slots, 1"):
        A.paged_decode_attention(torch.zeros(2, 3, 2, 8), torch.zeros(2, 4, 2, 8),
                                 torch.zeros(2, 4, 2, 8), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match"):
        A.paged_decode_attention(q, torch.zeros(2, 4, 3, 8), torch.zeros(2, 4, 3, 8),
                                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="together"):
        A.pool_paged_decode_attention(q, torch.zeros(3, 4, 2, 8), torch.zeros(3, 4, 2, 8),
                                      torch.zeros(2, 2, dtype=torch.int32),
                                      torch.zeros(2, dtype=torch.int32),
                                      k_scale=torch.ones(3, 4, 2))


# -- the int8 KV-row codec ---------------------------------------------------


def test_quantize_kv_rows_bitwise():
    rng = np.random.default_rng(6)
    x = _normal(rng, 3, 5, 2, 16) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1
    # Exact .5 quotients: max 127 makes the scale exactly 1, so these
    # round half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0).
    x[1, 2, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    want_q, want_s = (np.array(a) for a in jax_quantize_kv_rows(_j(x)))
    got_q, got_s = quantize_kv_rows(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32), want_s.view(np.int32))
    assert got_q[1, 2, 1, :6].tolist() == [127, 0, 2, 2, 0, -4]
    deq = dequantize_kv_rows(got_q, got_s)
    want_deq = np.array(jops.dequantize_kv_rows(_j(want_q), _j(want_s)))
    np.testing.assert_array_equal(deq.numpy(), want_deq)
