"""The PyTorch port's binary compute against the JAX package, bit for bit.

Same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``zookeeper_tpu_torch.ops.binary_compute``. The JAX side
runs its Pallas kernels in interpret mode (as its own CPU tests do); the
port runs on CPU tensors, where each kernel wrapper takes its plain
version. Every result is an exact integer or one fp32 multiply of one,
so the comparisons are ``np.array_equal``, not a tolerance.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu_torch.ops import binary_compute as tbc


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


# -- wire format -------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((3, 64), -1), ((96, 5), 0), ((2, 3, 32, 4), 2)])
def test_pack_unpack_bits_match_jax(shape, axis):
    rng = np.random.default_rng(len(shape) * 10 + axis)
    x = rng.normal(size=shape).astype(np.float32)
    got = tbc.pack_bits(torch.from_numpy(x), axis=axis)
    want = jbc.pack_bits(jnp.asarray(x), axis=axis)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    k = shape[axis] - 3
    np.testing.assert_array_equal(
        _np(tbc.unpack_bits(got, k, axis=axis)),
        np.asarray(jbc.unpack_bits(want, k, axis=axis)),
    )


@pytest.mark.parametrize("ci", [3, 40])
def test_pack_conv_and_dense_kernel_match_jax(ci):
    rng = np.random.default_rng(ci)
    scale = (np.abs(rng.normal(size=7)) + 0.1).astype(np.float32)
    scale[2] = 0.0  # an all-zero channel takes the guarded scale path
    q = _signs(rng, (3, 2, ci, 7)) * scale
    got_p, got_s = tbc.pack_conv_kernel(torch.from_numpy(q))
    want_p, want_s = jbc.pack_conv_kernel(jnp.asarray(q))
    np.testing.assert_array_equal(_np(got_p), np.asarray(want_p))
    np.testing.assert_array_equal(_np(got_s), np.asarray(want_s))
    qd = q.reshape(-1, 7)
    got_p, got_s = tbc.pack_dense_kernel(torch.from_numpy(qd))
    want_p, want_s = jbc.pack_dense_kernel(jnp.asarray(qd))
    np.testing.assert_array_equal(_np(got_p), np.asarray(want_p))
    np.testing.assert_array_equal(_np(got_s), np.asarray(want_s))


# -- K1: sign+pack rows ------------------------------------------------------


@pytest.mark.parametrize("m,k,dtype", [(1, 32, "float32"), (37, 96, "float32"), (41, 64, "bfloat16")])
def test_pack_rows_matches_pallas(m, k, dtype):
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tbc.pack_rows(xt)
    want = jbc.pack_rows_packed(xj, interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_pack_rows_sign_edge_semantics():
    x = np.asarray(
        [[0.0, -0.0, np.nan, -np.nan] * 8, [1.0, -1.0, np.inf, -np.inf] * 8],
        np.float32,
    )
    got = _np(tbc.pack_rows(torch.from_numpy(x)))
    want = np.asarray(jbc.pack_rows_packed(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] & 0xF == 0b0011  # ±0 -> 1, NaN -> 0


def test_pack_rows_rejects_unaligned_k():
    with pytest.raises(ValueError, match="32"):
        tbc.pack_rows(torch.ones(4, 33))


#: K1's wire-format edges, as chip_smoke mixes them into its K1 rows.
K1_EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40], np.float32)


def _k1_word_model(bits: np.ndarray, itemsize: int) -> np.ndarray:
    """The word assembly of ``pack_rows_vec_kernel``: ``bits`` are the
    raw fp32 (uint32) or bf16 (uint16) values of the flattened source.
    Thread t reads word t as LPW 16-byte loads ``x + t * LPW + j``, sets
    bit i of load j's part for its value i >= 0 (bf16 widened to fp32 by
    a 16-bit shift) and ORs the part in at bit VPL * j. Returns the
    words as uint32."""
    vpl = 16 // itemsize
    lpw = 32 // vpl
    wide = bits.astype(np.uint32) << np.uint32(16) if itemsize == 2 else bits.astype(np.uint32)
    ge0 = (wide.view(np.float32) >= 0).astype(np.uint32)  # no flush to zero
    # [word t, load j, value i]: load j of word t is 16 bytes at t * LPW + j.
    ge0 = ge0.reshape(-1, lpw, vpl)
    part = (ge0 << np.arange(vpl, dtype=np.uint32)).sum(-1, dtype=np.uint32)
    word = np.zeros(part.shape[0], np.uint32)
    for j in range(lpw):
        word |= part[:, j] << np.uint32(vpl * j)
    return word


def _bits(words: np.ndarray) -> np.ndarray:
    """[n] uint32 words -> [n, 32] bits, bit b of word t at [t, b]."""
    return (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1


@pytest.mark.parametrize("m,k,dtype", [(37, 96, "float32"), (53, 64, "bfloat16"),
                                       (2, 4096, "float32"), (3, 2048, "bfloat16"),
                                       (648, 512, "bfloat16"), (1, 32, "bfloat16")])
def test_k1_word_assembly_matches_pallas(m, k, dtype):
    """The vector kernel's bit assembly, modelled in numpy on a value mix
    with the edges of ``K1_EDGES`` (ragged word counts, bf16's 4 loads to
    a word and fp32's 8), equals the JAX Pallas kernel bit for bit, and
    the port's plain version word for word. XLA's CPU backend flushes
    subnormals to zero and reads -1e-40 as -0 (bit 1), where the kernel
    compares in IEEE fp32 (bit 0): JAX is held to every other value, the
    plain version to all of them."""
    src = (CSRC / "pack_rows.cu").read_text()
    assert "x + t * LPW + j" in src and "<< (VPL * j)" in src
    rng = np.random.default_rng(m * 7 + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    pick = rng.random((m, k)) < 0.3
    x[pick] = K1_EDGES[rng.integers(len(K1_EDGES), size=int(pick.sum()))]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    raw = xt.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
    raw = raw.view(np.uint16 if dtype == "bfloat16" else np.uint32).reshape(-1)
    got = _k1_word_model(raw, xt.element_size())
    plain = _np(tbc.pack_rows_plain(xt)).reshape(-1).view(np.uint32)
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jbc.pack_rows_packed(jnp.asarray(xt.float().numpy(), dtype),
                                           interpret=True)).reshape(-1).view(np.uint32)
    ieee = ~((xt.float().numpy() < 0) & (xt.float().numpy() > -1.2e-38)).reshape(-1, 32)
    np.testing.assert_array_equal(_bits(got)[ieee], _bits(want)[ieee])
    assert bool((_bits(got)[~ieee] == 0).all())  # negative subnormals pack as 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_rows_of_an_offset_view_matches_pallas(dtype):
    """A contiguous view with a storage offset (on the card a base that is
    not 16-byte aligned, K1's scalar path) packs as the JAX kernel."""
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.normal(size=9 * 64 + 3).astype(np.float32)).to(getattr(torch, dtype))
    xt = flat[3:].view(9, 64)
    assert xt.is_contiguous() and xt.storage_offset() == 3
    want = jbc.pack_rows_packed(jnp.asarray(xt.float().numpy(), dtype), interpret=True)
    np.testing.assert_array_equal(_np(tbc.pack_rows(xt)), np.asarray(want))


# -- K3: popcount conv -------------------------------------------------------


def _conv_case(rng, b, h, w, ci, co, kh, kw):
    x = _signs(rng, (b, h, w, ci))
    # Scales over 16 decades: any epilogue reassociation shows bitwise.
    s = np.abs(rng.normal(size=co)).astype(np.float32) + 0.1
    s = (s * rng.choice([1e-8, 1.0, 1e8], size=co)).astype(np.float32)
    q = _signs(rng, (kh, kw, ci, co)) * s
    packed, scale = jbc.pack_conv_kernel(jnp.asarray(q))
    return x, np.array(packed), np.array(scale)


def _conv_popcount_pair(x, packed, scale, strides, padding, ci):
    want = jax.jit(
        lambda *a: jbc._conv_gemm_popcount(*a, strides, padding, ci=ci, interpret=True)
    )(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale))
    got = tbc._conv_gemm_popcount(
        torch.from_numpy(np.array(x, np.float32)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
        ),
        torch.from_numpy(packed), torch.from_numpy(scale), strides, padding,
        ci=ci,
    )
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    return _np(got)


@pytest.mark.parametrize(
    "strides,padding,dtype",
    [((1, 1), "SAME", "float32"), ((2, 2), "SAME", "bfloat16"), ((2, 1), "VALID", "float32")],
)
def test_conv_gemm_popcount_strides_padding(strides, padding, dtype):
    rng = np.random.default_rng(sum(strides) * 10 + len(padding))
    x, packed, scale = _conv_case(rng, b=2, h=9, w=8, ci=17, co=33, kh=3, kw=3)
    x = np.asarray(jnp.asarray(x, getattr(jnp, dtype)))  # ±1: exact in bf16
    _conv_popcount_pair(x, packed, scale, strides, padding, ci=17)


@pytest.mark.parametrize("ci,co,kh,kw", [(3, 8, 1, 1), (40, 130, 5, 3)])
def test_conv_gemm_popcount_ragged_channels(ci, co, kh, kw):
    rng = np.random.default_rng(ci * co)
    x, packed, scale = _conv_case(rng, b=1, h=7, w=7, ci=ci, co=co, kh=kh, kw=kw)
    _conv_popcount_pair(x, packed, scale, (1, 1), "SAME", ci=ci)


# (batch, padded height, padded width, ciw, kh, kw, stride): QuickNet's
# four sections (3x3 SAME at 56/28/14/7, 64-512 channels), BinaryAlexNet's
# 5x5 at ciw 2 and 3x3 at ciw 6 and 12, a stride-2 conv, and the ragged
# (ci 17, co 33) geometry at stride 2.
@pytest.mark.parametrize("b,hp,wp,ciw,kh,kw,stride", [
    (2, 58, 58, 2, 3, 3, 1), (2, 30, 30, 4, 3, 3, 1), (2, 16, 16, 8, 3, 3, 1),
    (2, 9, 9, 16, 3, 3, 1), (2, 31, 31, 2, 5, 5, 1), (2, 15, 15, 6, 3, 3, 1),
    (2, 15, 15, 12, 3, 3, 1), (2, 30, 29, 4, 3, 3, 2), (2, 10, 10, 1, 3, 3, 2),
])
def test_conv_k_offsets_gather_the_unfolded_taps(b, hp, wp, ciw, kh, kw, stride):
    """K3's implicit im2col: word (m, k) of the plain version's patch
    matrix is ``xq.flatten()[base(m) + koff[k]]``, with base(m) =
    ((b*Hp + ho*sh)*Wp + wo*sw)*ciw and koff the wrapper's table."""
    rng = np.random.default_rng(hp * ciw + kh + stride)
    xq = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(b, hp, wp, ciw), dtype=np.int64)
                          .astype(np.int32))
    koff = tbc._conv_k_offsets(kh, kw, wp, ciw)
    assert koff.dtype == torch.int32 and koff.shape == (kh * kw * ciw,)
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    bi, y, x = np.meshgrid(np.arange(b), np.arange(ho), np.arange(wo), indexing="ij")
    base = (((bi * hp + y * stride) * wp + x * stride) * ciw).reshape(-1)
    index = base[:, None] + koff.numpy().astype(np.int64)[None, :]
    gathered = xq.reshape(-1)[torch.from_numpy(index)]
    np.testing.assert_array_equal(
        gathered.numpy(), tbc._conv_patches(xq, kh, kw, (stride, stride)).numpy())


def test_conv_gemm_popcount_validates_operands():
    xq = torch.zeros(1, 5, 5, 2, dtype=torch.int32)
    packed = torch.zeros(3, 3, 1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="words"):
        tbc.conv_gemm_popcount(xq, packed, torch.ones(4), (1, 1), 27)
    packed = torch.zeros(3, 3, 2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        tbc.conv_gemm_popcount(xq, packed, torch.ones(3), (1, 1), 27)


# -- K4: packed-weight GEMM --------------------------------------------------


# Ragged in every axis; on both sides of the kernels' "small_m"/"mma"
# threshold (M 8 and 9); a single K word; a dense-stage shape at a cut N.
@pytest.mark.parametrize("m,k,n", [(1, 32, 1), (37, 70, 33), (130, 576, 64), (3, 70, 130),
                                   (17, 32, 33), (65, 1000, 130), (9, 96, 130), (8, 2304, 64)])
def test_packed_weight_matmul_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = _signs(rng, (m, k))
    a[rng.random((m, k)) < 0.2] = 0.0  # zeros from spatial padding
    w = _signs(rng, (k, n))
    bp = np.array(jbc.pack_dense_kernel(jnp.asarray(w))[0])
    want = jbc.packed_weight_matmul(jnp.asarray(a), jnp.asarray(bp), interpret=True)
    got = tbc.packed_weight_matmul(
        torch.from_numpy(a).to(torch.int8), torch.from_numpy(bp)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), (a @ w).astype(np.int32))


CSRC = pathlib.Path(__file__).resolve().parents[1] / "zookeeper_tpu_torch" / "csrc"


def _pm1_bytes(nib):
    """numpy model of ``pm1_bytes`` in ``csrc/mma_s8.cuh`` (uint32
    arithmetic): bits 0-3 of ``nib`` as four +-1 bytes."""
    x = ((nib & np.uint64(0xF)) * np.uint64(0x00204081)) & np.uint64(0x01010101)
    return (np.uint64(0xFFFFFFFF) - x * np.uint64(0xFE)) & np.uint64(0xFFFFFFFF)


def _decode_words(words):
    """[n] int32 packed words -> [n, 32] int8, as the kernels decode them:
    word q of the 8 is ``pm1_bytes(w >> 4q)``, bytes little-endian."""
    w = words.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    quads = np.stack([_pm1_bytes(w >> np.uint64(4 * q)) for q in range(8)], axis=-1)
    return quads.astype("<u4").view(np.int8).reshape(len(words), 32)


def test_kernel_bit_decode_matches_unpack_bits():
    """The carry-free decode the K4 and K5 kernels compile (the formula in
    the header, checked verbatim) gives bit t -> byte t, +1 for a set bit
    and -1 for a clear one, exactly as ``unpack_bits``: for all 16
    nibbles (every byte position) and for random words."""
    header = (CSRC / "mma_s8.cuh").read_text()
    assert "((nib & 0xFu) * 0x00204081u) & 0x01010101u" in header
    assert "0xFFFFFFFFu - x * 0xFEu" in header
    nibbles = np.arange(16, dtype=np.uint64)
    want = np.array([[1 if (v >> j) & 1 else -1 for j in range(4)] for v in range(16)], np.int8)
    got = _pm1_bytes(nibbles).astype("<u4").view(np.int8).reshape(16, 4)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(11)
    words = rng.integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)
    words[:4] = [0, -1, 1, -(2**31)]
    want = tbc.unpack_bits(torch.from_numpy(words)[:, None], 32, axis=-1).numpy()
    np.testing.assert_array_equal(_decode_words(words), want.astype(np.int8))


def test_packed_weight_matmul_validates_operands():
    a = torch.zeros(4, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="K-words"):
        tbc.packed_weight_matmul(a, torch.zeros(3, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        tbc.packed_weight_matmul(a.float(), torch.zeros(2, 8, dtype=torch.int32))


# -- the schedules -----------------------------------------------------------


@pytest.mark.parametrize(
    "use_popcount,fuse_taps,padding,strides",
    [
        (True, True, "SAME", (1, 1)),
        (True, False, "VALID", (2, 2)),
        (False, True, "VALID", (2, 2)),
        (False, False, "SAME", (1, 1)),
    ],
)
def test_packed_conv_forward_schedules_match_jax(use_popcount, fuse_taps, padding, strides):
    """Both schedules (one fused-tap GEMM, or one GEMM per tap) of the
    reference composition, and the port's default flavor, against the
    JAX reference flavor."""
    rng = np.random.default_rng(int(use_popcount) * 2 + int(fuse_taps))
    x, packed, scale = _conv_case(rng, b=2, h=7, w=6, ci=36, co=20, kh=3, kw=3)
    args = (packed, scale, strides, padding)
    kw = {"ci": 36, "use_popcount": use_popcount}
    want = jax.jit(lambda *a: jbc._packed_conv_forward(
        *a, strides, padding, interpret=True, fuse_taps=fuse_taps,
        flavor="reference", **kw,
    ))(jnp.asarray(x), *map(jnp.asarray, args[:2]))
    xt = torch.from_numpy(x)
    pt, st = torch.from_numpy(packed), torch.from_numpy(scale)
    got = tbc._packed_conv_forward(
        xt, pt, st, strides, padding, fuse_taps=fuse_taps,
        flavor="reference", **kw,
    )
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    got_auto = tbc.packed_conv_infer(
        xt, pt, st, strides, padding, use_popcount=use_popcount
    )
    np.testing.assert_array_equal(_np(got_auto), np.asarray(want))


def test_flavor_seam():
    assert tbc.resolve_binary_flavor("auto") == "pallas"
    assert tbc.resolve_binary_flavor("reference") == "reference"
    with pytest.raises(ValueError, match="flavor"):
        tbc.resolve_binary_flavor("palas")


def test_wrappers_off_the_cpu_launch_or_raise():
    """A tensor that is not on the CPU never takes the plain version:
    on a device other than CUDA every wrapper raises, K5 included, and
    nothing launches."""
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbc.pack_rows(x)
    with pytest.raises(ValueError, match="CUDA"):
        tbc.packed_weight_matmul(
            torch.empty(4, 64, dtype=torch.int8, device="meta"),
            torch.empty(2, 8, dtype=torch.int32, device="meta"),
        )
    with pytest.raises(ValueError, match="CUDA"):
        tbc.xnor_matmul_packed(
            torch.empty(4, 2, dtype=torch.int32, device="meta"),
            torch.empty(2, 8, dtype=torch.int32, device="meta"),
            k_true=64,
        )
    assert tbc.LAUNCHES == {k: 0 for k in tbc.LAUNCHES}


def test_packed_conv_infer_is_inference_only():
    x = torch.ones(1, 4, 4, 32, requires_grad=True)
    packed = torch.zeros(3, 3, 1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="inference-only"):
        tbc.packed_conv_infer(x, packed, torch.ones(4), (1, 1), "SAME")
