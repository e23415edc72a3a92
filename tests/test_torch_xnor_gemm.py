"""The plain versions of K5 (``xnor_matmul_packed``) and K2
(``xnor_matmul_packed_scaled``) against the JAX Pallas kernels, bit for
bit.

The same seeded packed words go through the JAX kernels in interpret
mode (as the JAX package's own CPU tests run them) and through the port's
wrappers on CPU tensors, which run their plain versions. Every K5 output
is an exact integer and every K2 output one fp32 multiply of one, so the
comparisons are ``assert_array_equal`` on the bits. The CUDA kernels are
held to these plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu_torch.ops import binary_compute as tbc

#: (M, Kw, N): ragged in every axis, a single word, a single row, and the
#: BinaryAlexNet dense layers' K words at a cut N; then both sides of the
#: kernels' "popc"/"mma" threshold (M 64 and 65) and ragged rows past it.
SHAPES = [(1, 1, 1), (37, 7, 130), (8, 9, 33), (3, 20, 5), (2, 288, 40), (8, 128, 64),
          (64, 7, 130), (65, 7, 130), (129, 1, 8), (300, 37, 72)]


def _words(rng, *shape):
    return rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)


def _operands(m, kw, n, seed):
    rng = np.random.default_rng(seed)
    a, b = _words(rng, m, kw), _words(rng, kw, n)
    scale = rng.normal(size=n).astype(np.float32)
    scale[0] = 0.0
    if n > 2:
        scale[1] = -scale[1] * 1e-30  # a tiny negative scale
    return a, b, scale, 32 * kw - (seed % 32)


@pytest.mark.parametrize("m,kw,n", SHAPES)
def test_k5_plain_matches_pallas(m, kw, n):
    a, b, _, k_true = _operands(m, kw, n, m + kw + n)
    want = np.asarray(jbc.xnor_matmul_packed(jnp.asarray(a), jnp.asarray(b), k_true=k_true,
                                             interpret=True))
    got = tbc.xnor_matmul_packed(torch.from_numpy(a), torch.from_numpy(b), k_true=k_true)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbc.xnor_matmul_packed_plain(torch.from_numpy(a), torch.from_numpy(b),
                                     k_true=k_true).numpy(), want)


@pytest.mark.parametrize("m,kw,n", SHAPES)
def test_k2_plain_matches_pallas(m, kw, n):
    a, b, scale, k_true = _operands(m, kw, n, 2 * m + kw + n)
    want = np.asarray(jbc.xnor_matmul_packed_scaled(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale), k_true=k_true, interpret=True))
    ta, tb, ts = (torch.from_numpy(x) for x in (a, b, scale))
    got = tbc.xnor_matmul_packed_scaled(ta, tb, ts, k_true=k_true)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # The zero-ULP contract: K2 is K5 cast to float32 times the scale.
    k5 = tbc.xnor_matmul_packed(ta, tb, k_true=k_true)
    np.testing.assert_array_equal(
        got.numpy().view(np.int32), (k5.float() * ts[None, :]).numpy().view(np.int32))


def test_k5_counts_mismatches_of_packed_signs():
    """Packed ±1 matrices: K5 is their exact integer product, the K
    padding (equal +1 bits on both sides) adding nothing."""
    rng = np.random.default_rng(7)
    k = 70
    x = np.where(rng.random((5, k)) < 0.5, -1.0, 1.0).astype(np.float32)
    w = np.where(rng.random((k, 9)) < 0.5, -1.0, 1.0).astype(np.float32)
    pad = lambda t, axis: np.concatenate(  # noqa: E731
        [t, np.ones((t.shape[0], 96 - k) if axis == 1 else (96 - k, t.shape[1]), np.float32)],
        axis=axis)
    a = tbc.pack_bits(torch.from_numpy(pad(x, 1)), axis=-1)
    b = tbc.pack_bits(torch.from_numpy(pad(w, 0)), axis=0)
    got = tbc.xnor_matmul_packed(a, b, k_true=k)
    np.testing.assert_array_equal(got.numpy(), (x @ w).astype(np.int32))


def test_operands_are_validated():
    a = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="Packed K mismatch"):
        tbc.xnor_matmul_packed(a, torch.zeros(2, 5, dtype=torch.int32), k_true=96)
    with pytest.raises(ValueError, match="expected a_packed"):
        tbc.xnor_matmul_packed(a[0], torch.zeros(3, 5, dtype=torch.int32), k_true=96)
    with pytest.raises(ValueError, match="scale must be \\[5\\]"):
        tbc.xnor_matmul_packed_scaled(a, torch.zeros(3, 5, dtype=torch.int32),
                                      torch.ones(4), k_true=96)


def test_off_the_cpu_the_wrappers_never_run_plain():
    """A tensor that is not on the CPU never takes the plain version: on a
    device other than CUDA both wrappers raise, and nothing launches."""
    tbc.reset_launches()
    a = torch.empty(4, 2, dtype=torch.int32, device="meta")
    b = torch.empty(2, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbc.xnor_matmul_packed(a, b, k_true=64)
    with pytest.raises(ValueError, match="CUDA"):
        tbc.xnor_matmul_packed_scaled(a, b, torch.empty(8, device="meta"), k_true=64)
    with pytest.raises(ValueError, match="CUDA"):  # mixed devices
        tbc.xnor_matmul_packed(a, torch.zeros(2, 8, dtype=torch.int32), k_true=64)
    assert tbc.LAUNCHES == {k: 0 for k in tbc.LAUNCHES}


@pytest.mark.parametrize("m,kw,n", [(5, 1, 3), (65, 7, 130), (9, 37, 8)])
def test_k5_is_the_pm1_dot_less_the_pad(m, kw, n):
    """The identity the tensor-core K5 epilogue rests on: over all 32 Kw
    values, pad bits included and unequal on the two sides, the +-1 dot
    of the unpacked words is 32 Kw - 2 mismatches, so K5's ``k_true - 2
    mismatches`` is that dot less ``32 Kw - k_true``, bit for bit."""
    rng = np.random.default_rng(100 * m + kw)
    a, b = _words(rng, m, kw), _words(rng, kw, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for k_true in (32 * kw, 32 * kw - 1, 32 * kw - 31):
        dot = (tbc.unpack_bits(ta, 32 * kw, axis=-1).double()
               @ tbc.unpack_bits(tb, 32 * kw, axis=0).double()).to(torch.int32)
        got = tbc.xnor_matmul_packed_plain(ta, tb, k_true=k_true)
        np.testing.assert_array_equal(got.numpy(), (dot - (32 * kw - k_true)).numpy())
