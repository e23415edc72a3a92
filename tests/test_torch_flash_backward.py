"""The flash attention backward of the port (the plain versions of K9
with lse, K10 and K11, and the autograd Function that ties them) against
the JAX package's Pallas kernels in interpret mode, on the same seeded
numpy inputs.

Tolerances are the JAX package's own for its flash gradients
(``tests/ops/test_ring_attention.py``): 5e-5 in fp32 and 5e-2 in bf16.
lse is an fp32 reduction on both sides and is held to 5e-5 in both
dtypes (bf16 inputs give exact products).
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu import ops as jops
from zookeeper_tpu.ops.attention import _flash_backward as jax_flash_backward
from zookeeper_tpu.ops.attention import _flash_forward as jax_flash_forward
from zookeeper_tpu_torch.ops import attention as A

TOL = {"float32": 5e-5, "bfloat16": 5e-2}

#: (shape, causal, blocks): the JAX tests' shapes with blocks of 16 (s=40
#: pads to 48), and unequal blocks (the lcm padding).
CASES = [
    ((2, 32, 2, 8), True, (16, 16)),
    ((2, 32, 2, 8), False, (16, 16)),
    ((1, 40, 1, 16), True, (16, 16)),
    ((1, 40, 1, 16), False, (16, 16)),
    ((1, 48, 1, 8), True, (16, 32)),
    ((1, 40, 2, 16), False, (32, 16)),
]


def _t(x, dtype):
    """numpy -> torch in ``dtype`` (a copy: jax-backed arrays are read-only)."""
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float(), np.float64), _np(want), rtol=atol,
                               atol=atol)


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,blocks", CASES)
def test_plain_backward_matches_jax_kernels(shape, causal, blocks, dtype):
    """lse of the plain forward against ``_flash_forward(want_lse=True)``,
    and the plain dQ/dK/dV against ``_flash_backward`` from the same
    out, lse and dO, at the same blocks."""
    q, k, v, do = _operands(shape, seed=shape[1] + causal)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    scale = shape[-1] ** -0.5
    bq, bk = blocks
    j_out, j_lse = jax_flash_forward(jq, jk, jv, causal, scale, bq, bk, True, want_lse=True)
    want = jax_flash_backward(jq, jk, jv, j_out, j_lse, jdo, causal, scale, bq, bk, True)

    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    out, lse = A.flash_attention_plain(tq, tk, tv, causal=causal, block_q=bq, block_k=bk,
                                       want_lse=True)
    b, s, h, _ = shape
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b * h, s)
    _close(lse, np.asarray(j_lse)[:, :s, 0], TOL["float32"])
    _close(out, j_out, TOL[dtype])

    t_out = _t(j_out, dtype)
    t_lse = torch.from_numpy(np.array(j_lse)[:, :s, 0])
    got = A.flash_backward_plain(tq, tk, tv, t_out, t_lse, tdo, causal=causal, block_q=bq,
                                 block_k=bk)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 32, 2, 8), (1, 40, 1, 16)])
def test_flash_attention_grads_match_jax(shape, causal, dtype):
    """``torch.autograd`` through ``flash_attention`` (K9 with lse, K10,
    K11 as their plain versions on CPU tensors) against ``jax.grad`` of
    the JAX ``flash_attention`` with blocks of 16, under a random
    cotangent."""
    q, k, v, w = _operands(shape, seed=7 + shape[1] + causal)
    jdt = getattr(jnp, dtype)

    def loss(q_, k_, v_):
        o = jops.flash_attention(q_, k_, v_, causal=causal, block_q=16, block_k=16,
                                 interpret=True)
        return (o.astype(jnp.float32) * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))

    ts = [_t(x, dtype).requires_grad_(True) for x in (q, k, v)]
    A.reset_launches()
    out = A.flash_attention(*ts, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert sum(A.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    for t, wg in zip(ts, want):
        assert t.grad.dtype == t.dtype
        _close(t.grad, wg, TOL[dtype])


def test_padded_keys_get_zero_gradient(monkeypatch):
    """s=40 with blocks of 16 pads to 48: the padded keys' dK and dV rows
    are exactly 0 before the wrapper slices them off, and the real rows
    match the dense oracle's gradients."""
    shape = (1, 40, 1, 16)
    q, k, v, do = (_t(x, "float32") for x in _operands(shape, seed=3))
    out, lse = A.flash_attention_plain(q, k, v, causal=True, block_q=16, block_k=16,
                                       want_lse=True)
    full = []
    from_bh = A._from_bh
    monkeypatch.setattr(A, "_from_bh", lambda x, *a: (full.append(x), from_bh(x, *a))[1])
    delta = A.flash_backward_delta(out, do)
    dk, dv = A.flash_backward_dkv_plain(q, k, v, do, lse, delta, causal=True, block_q=16,
                                        block_k=16)
    assert [tuple(x.shape) for x in full] == [(1, 48, 16)] * 2
    for x in full:
        assert torch.count_nonzero(x[:, 40:]) == 0
        assert torch.count_nonzero(x[:, :40]) > 0

    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(A.attention_reference(*ts, causal=True), ts, do)
    for got, want in zip((dk, dv), grads[1:]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL["float32"],
                                   atol=TOL["float32"])


def test_delta_reduces_before_the_layout_change():
    """D = rowsum(dO * O) in fp32, laid out ``[b*h, s]`` like lse."""
    rng = np.random.default_rng(5)
    out, do = (torch.from_numpy(rng.normal(size=(2, 5, 3, 8)).astype(np.float32))
               for _ in range(2))
    got = A.flash_backward_delta(out.to(torch.bfloat16), do.to(torch.bfloat16))
    want = (out.to(torch.bfloat16).double() * do.to(torch.bfloat16).double()).sum(-1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 5)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 1).reshape(6, 5).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_backward_wrappers_validate_shapes():
    q = torch.zeros(1, 8, 2, 8)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="lse must be"):
        A.flash_backward_dq(q, q, q, q, torch.zeros(2, 9), lse)
    with pytest.raises(ValueError, match="dO"):
        A.flash_backward_dkv(q, q, q, torch.zeros(1, 8, 2, 4), lse, lse)
