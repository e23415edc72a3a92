"""The port's 1-bit residual kernels (K6 pack_resid, K7 unpack_resid_pm1,
K8 mask_mul_resid) and its ste_sign quantizers against the JAX package.

On CPU tensors the wrappers run their plain PyTorch versions; the JAX
functions run their Pallas kernels in interpret mode, as the JAX
package's own tests run them. Every result is a bit, a +-1, or a value
times 0 or 1, so the two sides must agree bit for bit: words exactly,
floats by their bit patterns (which tells -0 from +0), NaN by position.

Subnormal inputs stay out of the comparison with JAX: XLA's CPU backend
flushes them to zero, so it reads -1e-40 as -0 (sign bit 1), where the
port, its CUDA kernel and its K1 wire format compare in IEEE arithmetic
(sign bit 0). A separate test pins the port's subnormal semantics.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu.ops import quantizers as jq
from zookeeper_tpu_torch.ops import binary_compute as bc
from zookeeper_tpu_torch.ops import quantizers as pq

#: Batch off a multiple of 32 (the pad path) in 2-D, 3-D, 4-D and 5-D,
#: and two full 32-row word groups.
SHAPES = [(37, 96), (33, 6, 40), (37, 5, 3, 8), (33, 2, 3, 5, 7), (64, 3, 5, 8)]
DTYPES = ["float32", "bfloat16"]
EDGES = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
     np.nextafter(1.0, 2.0), -np.nextafter(1.0, 2.0)],
    np.float32,
)


def _values(shape, dtype, seed):
    """Normal values at scale 1.5 (both sides of the |x| <= 1 window),
    a quarter of them replaced by the edge values, as float32 numpy
    exactly representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=shape) * 1.5).astype(np.float32)
    pick = rng.random(shape) < 0.25
    v[pick] = EDGES[rng.integers(len(EDGES), size=int(pick.sum()))]
    return np.asarray(jnp.asarray(v, getattr(jnp, dtype)).astype(jnp.float32))


def _to_jax(v, dtype):
    return jnp.asarray(v, getattr(jnp, dtype))


def _to_port(v, dtype):
    return torch.from_numpy(v.copy()).to(getattr(torch, dtype))


def _assert_same_floats(got: torch.Tensor, want) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got.view(np.uint32)[keep], want.view(np.uint32)[keep])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mask_mode", [False, True], ids=["sign", "mask"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_resid_matches_jax(shape, mask_mode, dtype):
    v = _values(shape, dtype, seed=len(shape) + mask_mode)
    want = np.asarray(jbc.pack_resid(_to_jax(v, dtype), mask_mode=mask_mode, interpret=True))
    got = bc.pack_resid(_to_port(v, dtype), mask_mode=mask_mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unpack_resid_pm1_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape))
    b, h, w, c = bc._to_4d_shape(shape)
    # Random words, pad bits included: the unpack must ignore the pad rows.
    words = rng.integers(-(2**31), 2**31, size=(-(-b // 32), h, w, c), dtype=np.int64)
    words = words.astype(np.int32)
    want = jbc.unpack_resid_pm1(jnp.asarray(words), shape, getattr(jnp, dtype), interpret=True)
    got = bc.unpack_resid_pm1(torch.from_numpy(words), shape, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    _assert_same_floats(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mask_mul_resid_matches_jax(shape, dtype):
    x = _values(shape, dtype, seed=7)
    g = _values(shape, dtype, seed=8)  # edges in g too: inf * 0, NaN * 1
    words = jbc.pack_resid(_to_jax(x, dtype), mask_mode=True, interpret=True)
    want = jbc.mask_mul_resid(_to_jax(g, dtype), words, interpret=True)
    got = bc.mask_mul_resid(_to_port(g, dtype), torch.from_numpy(np.array(words)))
    assert got.dtype == getattr(torch, dtype)
    _assert_same_floats(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_resid_subnormals_compare_in_ieee(dtype):
    """+-1e-40 are subnormal in float32 and bfloat16: sign mode packs
    +1e-40 as 1 and -1e-40 as 0; both lie inside the mask window."""
    x = torch.tensor([1e-40, -1e-40] * 16 + [float("nan"), -0.0], dtype=getattr(torch, dtype))
    sign = bc.pack_resid(x[:32, None]).item() & 0xFFFFFFFF
    mask = bc.pack_resid(x[:32, None], mask_mode=True).item() & 0xFFFFFFFF
    assert sign == 0x55555555 and mask == 0xFFFFFFFF
    pad = bc.pack_resid(x[32:, None]).item() & 0xFFFFFFFF
    assert pad == 0xFFFFFFFE  # NaN -> 0, -0 -> 1, 30 pad rows -> 1


def test_sign_pack_round_trips_pm1():
    """K7 inverts sign-mode K6 on +-1 tensors (the int8 conv residual)."""
    x = torch.where(torch.rand(37, 4, 3, 8) < 0.5, -1.0, 1.0).to(torch.bfloat16)
    back = bc.unpack_resid_pm1(bc.pack_resid(x), x.shape, x.dtype)
    assert torch.equal(back, x)


def test_residual_wrappers_reject_bad_input():
    with pytest.raises(ValueError, match="batched"):
        bc.pack_resid(torch.ones(64))
    words = torch.zeros(2, 1, 1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not pack"):
        bc.unpack_resid_pm1(words, (65, 8), torch.float32)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        bc.mask_mul_resid(torch.ones(40, 8, dtype=torch.float16), words)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("packed", [False, True], ids=["ste_sign", "ste_sign_packed"])
@pytest.mark.parametrize("shape", [(37, 96), (5, 4, 3, 8)], ids=str)
def test_ste_sign_value_and_grad_match_jax(shape, packed, dtype):
    x = _values(shape, dtype, seed=11)
    g = _values(shape, dtype, seed=12)
    jax_fn = jq.ste_sign_packed if packed else jq.ste_sign
    want_y, vjp = jax.vjp(jax_fn, _to_jax(x, dtype))
    (want_dx,) = vjp(_to_jax(g, dtype))

    xt = _to_port(x, dtype).requires_grad_(True)
    bc.reset_launches()
    y = (pq.ste_sign_packed if packed else pq.ste_sign)(xt)
    (dx,) = torch.autograd.grad(y, xt, _to_port(g, dtype))
    assert bc.LAUNCHES["pack_resid"] == 0  # CPU tensors: the plain versions
    _assert_same_floats(y.detach(), want_y)
    _assert_same_floats(dx, want_dx)


def test_ste_sign_packed_saves_only_words():
    """The packed quantizer's backward keeps the 1-bit mask words, not its
    input (the memory the lever exists to save)."""
    x = torch.randn(64, 4, 4, 8, requires_grad=True)
    y = pq.ste_sign_packed(x)
    saved = y.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.int32]
    assert saved[0].shape == (2, 4, 4, 8)
