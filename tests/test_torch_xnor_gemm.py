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

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu_torch.ops import binary_compute as tbc

CSRC = pathlib.Path(__file__).resolve().parents[1] / "zookeeper_tpu_torch" / "csrc"

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


#: The "small_m" rows (M <= 8) of the card's K2 and K5: M 1, 3 and 8,
#: Kw 1, 7 and 288 (BinaryAlexNet's first dense layer), N 72 and 130.
SMALL_M_SHAPES = [(m, kw, n) for m in (1, 3, 8) for kw in (1, 7, 288) for n in (72, 130)]


def _pm1(words, axis):
    """Packed words as +-1 int64 along ``axis`` (bit t of word w is value
    32w + t; a set bit is +1), independent of the port's unpacking."""
    bits = (words.astype(np.int64)[..., None] >> np.arange(32)) & 1
    if axis == 0:
        bits = np.moveaxis(bits, -1, 1)  # [Kw, 32, N]
        return (2 * bits - 1).reshape(-1, words.shape[1])
    return (2 * bits - 1).reshape(words.shape[0], -1)


def _equal_pad_operands(m, kw, n, seed):
    """Seeded words whose K padding (the top 32 Kw - k_true bits of the
    last word, k_true not a multiple of 32) is set on both sides, as the
    packing pads with ones."""
    a, b, scale, _ = _operands(m, kw, n, seed)
    pad = 1 + seed % 31
    k_true = 32 * kw - pad
    ones = np.array(-(1 << (32 - pad)), dtype=np.int64).astype(np.int32)  # bits 32 - pad..31
    a[:, -1] |= ones
    b[-1, :] |= ones
    return a, b, scale, k_true


@pytest.mark.parametrize("m,kw,n", SMALL_M_SHAPES)
def test_k2_is_the_pm1_product_less_the_pad_times_scale(m, kw, n):
    """The identity K2's "small_m" design computes on the int8 tensor
    cores: the +-1 product of both decoded operands over all 32 Kw values
    less ``32 Kw - k_true``, cast to fp32, times the scale, is the plain
    K2 bit for bit; with equal pad bits that integer is the +-1 dot over
    the k_true true values."""
    a, b, scale, k_true = _equal_pad_operands(m, kw, n, 3 * m + kw + n)
    full = _pm1(a, axis=1) @ _pm1(b, axis=0)
    dot = full - (32 * kw - k_true)
    np.testing.assert_array_equal(dot, _pm1(a, 1)[:, :k_true] @ _pm1(b, 0)[:k_true])
    want = torch.from_numpy(dot.astype(np.int32)).float() * torch.from_numpy(scale)[None, :]
    got = tbc.xnor_matmul_packed_scaled_plain(torch.from_numpy(a), torch.from_numpy(b),
                                              torch.from_numpy(scale), k_true=k_true)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("m,kw,n", SMALL_M_SHAPES)
def test_k2_small_m_shapes_match_pallas(m, kw, n):
    """The port's K2 at the "small_m" rows against the JAX kernel in
    interpret mode, bit for bit, with equal pad bits."""
    a, b, scale, k_true = _equal_pad_operands(m, kw, n, 5 * m + kw + n)
    want = np.asarray(jbc.xnor_matmul_packed_scaled(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale), k_true=k_true, interpret=True))
    got = tbc.xnor_matmul_packed_scaled(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(scale), k_true=k_true)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _sign_bytes(w, r):
    """The kernel's ``sign_bytes``: byte j is 0xFF where bit 8j + 7 - r of
    w is set (the top bit of byte j of ``w << r``), else 0x00."""
    x = (w.astype(np.int64) << r) & 0xFFFFFFFF
    out = np.zeros_like(x)
    for j in range(4):
        out |= ((x >> (8 * j + 7)) & 1) * (0xFF << (8 * j))
    return out


def _s8(v):
    """uint32 values as their 4 little-endian int8 bytes, [..., 4] int64."""
    return v.astype("<u4").view(np.int8).reshape(*v.shape, 4).astype(np.int64)


@pytest.mark.parametrize("m,kw,n", [(1, 1, 8), (3, 7, 72), (8, 37, 130), (6, 288, 20)])
def test_small_m_sign_byte_decode_gives_k5(m, kw, n):
    """A numpy model of the K2/K5 "small_m" kernel's arithmetic: for each
    K word and shift r = 0..7, the weights' ``sign_bytes`` (-x a byte) times
    the activations' ``~sign_bytes | 0x01010101`` (+-1 a byte) summed to M,
    each row's S = sum over its words of 2 popcount - 32, and D = -2 M - S
    less ``32 Kw - k_true`` is the plain K5 bit for bit. The formulas are
    checked in the source verbatim."""
    source = (CSRC / "xnor_gemm.cu").read_text()
    for text in ('asm("prmt.b32 %0, %1, %1, 0xBA98;" : "=r"(d) : "r"(w << r));',
                 "~sign_bytes(aw, 2 * i) | 0x01010101u", "~sign_bytes(aw, 2 * i + 1) | 0x01010101u",
                 "s_row += live ? 2 * __popc(aw) - 32 : 0;", "constexpr int M_SCALE = -2;",
                 "make_int4(M_SCALE * acc[0][c] - sc, M_SCALE * acc[1][c] - sc,"):
        assert text in source, text
    rng = np.random.default_rng(m + kw + n)
    a, b = _words(rng, m, kw), _words(rng, kw, n)
    k_true = 32 * kw - 3
    prod = np.zeros((m, n), np.int64)
    for wd in range(kw):
        for r in range(8):
            w_side = _s8(_sign_bytes(b[wd], r))                               # [n, 4]: -x
            x_side = _s8((~_sign_bytes(a[:, wd], r) | 0x01010101) & 0xFFFFFFFF)  # [m, 4]: +-1
            assert set(np.unique(w_side)) <= {0, -1} and set(np.unique(x_side)) <= {1, -1}
            prod += x_side @ w_side.T
    popc = ((a.astype(np.int64)[..., None] >> np.arange(32)) & 1).sum(-1)
    s_row = (2 * popc - 32).sum(1)
    dot = -2 * prod - s_row[:, None] - (32 * kw - k_true)
    want = tbc.xnor_matmul_packed_plain(torch.from_numpy(a), torch.from_numpy(b), k_true=k_true)
    np.testing.assert_array_equal(dot, want.numpy())


@pytest.mark.parametrize("cs", range(1, 9))
def test_small_m_cluster_join_gives_every_quad_one_slot(cs):
    """A model of the "small_m" kernel's cluster join at a cluster of cs
    blocks: block z owns quads [z Q / cs, (z + 1) Q / cs) of the tile's Q,
    every block stores its sum of quad e into slot z * share_max + e - (its
    owner's first quad) of the owner, and the owner reads slots rank *
    share_max + its e. Each (block, quad) lands in one slot of the array
    the kernel declares, the slots of two pairs never meet, and each owner
    reads back exactly the cs sums of each of its quads, at every cs up to
    the largest cluster, however unevenly cs divides Q. The formulas are
    checked in the source verbatim."""
    source = (CSRC / "xnor_gemm.cu").read_text()
    for text in ("const int share_max = (SM_QUADS + cs - 1) / cs;",
                 "const int owner = ((e + 1) * cs - 1) / SM_QUADS;",
                 "cluster.map_shared_rank(slots_in, owner)[z * share_max + e - owner * SM_QUADS / cs]",
                 "const int q0 = z * SM_QUADS / cs;",
                 "if (e < (z + 1) * SM_QUADS / cs - q0) {",
                 "const int4 v = slots_in[rank * share_max + e];",
                 "__shared__ int4 slots_in[SM_QUADS + SM_CLUSTER_MAX];"):
        assert text in source, text
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (SM_COLS|SM_CLUSTER_MAX) = (\d+);", source)}
    quads, slots = 8 * const["SM_COLS"] // 4, 8 * const["SM_COLS"] // 4 + const["SM_CLUSTER_MAX"]
    assert cs <= const["SM_CLUSTER_MAX"]
    share_max = (quads + cs - 1) // cs
    written = {}  # (owner, slot): (block, quad)
    for z in range(cs):
        for e in range(quads):
            owner = ((e + 1) * cs - 1) // quads
            assert owner * quads // cs <= e < (owner + 1) * quads // cs
            slot = z * share_max + e - owner * quads // cs
            assert 0 <= slot < slots and (owner, slot) not in written
            written[(owner, slot)] = (z, e)
    for z in range(cs):
        q0 = z * quads // cs
        for e in range((z + 1) * quads // cs - q0):
            assert [written[(z, rank * share_max + e)] for rank in range(cs)] == [
                (rank, q0 + e) for rank in range(cs)]
    assert len(written) == cs * quads
