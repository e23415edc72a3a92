"""Binary compute: bit packing, the packed conv and dense schedules and
their training VJPs (``xnor_conv``, ``xnor_dense``), the int8 training
conv (any spatial rank, with its 1-bit residuals), transposed conv and
dense, the rank-generic float conv, and the hand-written CUDA kernels
they run.

The PyTorch counterpart of ``zookeeper_tpu/ops/binary_compute.py``.
Tensors keep the JAX package's layouts at every public function: NHWC
activations, HWIO float kernels, packed conv kernels ``[kh, kw,
ceil(ci/32), co]`` int32, the little-endian wire format (bit b of word t
is ``x[..., 32t + b] >= 0``) and the batch-packed residual format (bit b
of word ``[g, h, w, c]`` comes from ``x[32g + b, h, w, c]``).

Kernels (sources in ``zookeeper_tpu_torch/csrc``), each with its plain
PyTorch version beside it:

- K1 :func:`pack_rows` — sign+pack of float rows into words;
- K3 :func:`conv_gemm_popcount` — popcount conv with the scale epilogue,
  an implicit GEMM on the int8 tensor cores;
- K4 :func:`packed_weight_matmul` — int8 activations times packed
  weights, on the int8 tensor cores (:func:`packed_weight_matmul_variant`
  names the design a shape takes);
- K5 :func:`xnor_matmul_packed` — the unfused popcount GEMM on packed
  operands (the "reference" flavor's conv and dense GEMM): the int8
  tensor cores at M <= 8 (K split over a cluster) and past M 64, XOR and
  popcount on the CUDA cores between (:func:`xnor_matmul_packed_variant`);
- K2 :func:`xnor_matmul_packed_scaled` — K5 with the per-output-channel
  scale epilogue (the packed dense layer's GEMM): K5's int8 tensor-core
  design at M <= 8, XOR and popcount past it
  (:func:`xnor_matmul_packed_scaled_variant`);
- K6 :func:`pack_resid` — 1-bit pack along the batch of the sign bit or
  the STE mask;
- K7 :func:`unpack_resid_pm1` — the sign-mode inverse of K6, to ±1;
- K8 :func:`mask_mul_resid` — ``g * mask`` from K6's mask words.

A wrapper runs its plain version only when its tensors lie on the CPU.
On a CUDA tensor it launches its kernel (counting the launch in
:data:`LAUNCHES`) or raises; it never falls back. Every result is an
exact integer, one fp32 multiply of one, a bit, or a value times 0 or 1,
so kernel and plain version agree bit for bit.
"""

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from zookeeper_tpu_torch.ops import cuda_build

#: Binary compute flavors (layer field ``binary_flavor``), as in the JAX
#: package so configs carry over. "auto" and "pallas" run the fused
#: kernels (K1 + K3 convs, K1 + K2 dense); "reference" runs the unfused
#: composition (``pack_bits``, then K5, then the scale).
BINARY_FLAVORS = ("auto", "pallas", "reference")

#: Fuse the kh*kw taps into one patch matrix when it stays under this many
#: bytes (counted in the input's dtype, as the JAX package counts them);
#: larger convs run one GEMM per tap to bound peak memory.
_FUSE_TAPS_MAX_BYTES = 32 * 2**20

#: Kernel launches since the last :func:`reset_launches`, by kernel.
LAUNCHES = {
    "pack_rows": 0, "conv_gemm_popcount": 0, "packed_weight_matmul": 0,
    "pack_resid": 0, "unpack_resid_pm1": 0, "mask_mul_resid": 0,
    "xnor_matmul_packed": 0, "xnor_matmul_packed_scaled": 0,
}

#: Copies the residual kernels' wrappers made of a strided input to hand
#: their kernel a dense one, since the last :func:`reset_launches`.
COPIES = {"pack_resid": 0, "mask_mul_resid": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, COPIES):
        for name in counts:
            counts[name] = 0


def resolve_binary_flavor(flavor: str) -> str:
    """Resolve a flavor to "pallas" (the fused kernels) or "reference";
    anything else raises so a typo cannot change which kernels serve."""
    if flavor not in BINARY_FLAVORS:
        raise ValueError(
            f"binary_flavor must be one of {BINARY_FLAVORS}, got {flavor!r}."
        )
    return "pallas" if flavor == "auto" else flavor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# -- bit packing ------------------------------------------------------------


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack the sign bits of ``x`` along ``axis`` into int32 words: bit=1
    encodes x >= 0 (+1, also ±0), bit=0 encodes x < 0 or NaN;
    little-endian within the word. The axis length must be a multiple of
    32."""
    x = torch.movedim(x, axis, -1)
    k = x.shape[-1]
    if k % 32 != 0:
        raise ValueError(f"Packed axis must be a multiple of 32, got {k}.")
    bits = (x >= 0).reshape(*x.shape[:-1], k // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = _to_int32((bits << shifts).sum(-1))
    return torch.movedim(words, -1, axis).contiguous()


def unpack_bits(packed: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words -> ±1.0 float32."""
    words = torch.movedim(packed, axis, -1).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (words[..., None] >> shifts) & 1
    values = bits.to(torch.float32) * 2.0 - 1.0
    values = values.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :k]
    return torch.movedim(values, -1, axis)


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 lanes holding 32-bit values (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _popcount_mismatches(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_t popcount(a[m, t] ^ b[t, n])`` as [M, N] int32, for packed
    [M, Kw] and [Kw, N] int32 operands; M is chunked so the [M, Kw, N]
    intermediate stays bounded."""
    m, kw = a.shape
    n = b.shape[1]
    a64 = a.to(torch.int64) & 0xFFFFFFFF
    b64 = (b.to(torch.int64) & 0xFFFFFFFF)[None]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    step = max(1, 2**24 // max(1, kw * n))
    for lo in range(0, m, step):
        x = a64[lo : lo + step, :, None] ^ b64
        out[lo : lo + step] = _popcount(x).sum(1).to(torch.int32)
    return out


# -- weight packing ---------------------------------------------------------


def pack_conv_kernel(q_kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a quantized HWIO conv kernel (sign x per-output-channel
    scale) into ``(packed [kh, kw, ceil(ci/32), co] int32, scale [co]
    float32)``; padded input channels pack as +1 bits."""
    kh, kw, ci, co = q_kernel.shape
    scale = q_kernel.abs().amax(dim=(0, 1, 2)).to(torch.float32)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    signs = q_kernel / safe  # exactly ±1 by the quantizer contract
    ci_pad = _round_up(ci, 32)
    if ci_pad != ci:
        signs = F.pad(signs, (0, 0, 0, ci_pad - ci), value=1.0)
    return pack_bits(signs, axis=2), scale


def pack_dense_kernel(q_kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a quantized dense kernel [K, N] into ``(packed [ceil(K/32),
    N] int32, scale [N] float32)``."""
    k, n = q_kernel.shape
    scale = q_kernel.abs().amax(dim=0).to(torch.float32)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    signs = q_kernel / safe
    k_pad = _round_up(k, 32)
    if k_pad != k:
        signs = F.pad(signs, (0, 0, 0, k_pad - k), value=1.0)
    return pack_bits(signs, axis=0), scale


# -- kernel wrappers --------------------------------------------------------


def _cuda_device(what: str, *tensors: torch.Tensor) -> Optional[int]:
    """None when every tensor lies on the CPU (run the plain version);
    the CUDA device index when all lie on one card; raises otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return None
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{what}: tensors must all lie on the CPU or all on one CUDA "
            f"card, got {sorted(str(d) for d in devices)}."
        )
    return next(iter(devices)).index


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _stream(device: int) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pack_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: a 32-way shift-or of ``x >= 0``."""
    return pack_bits(x, axis=-1)


def pack_rows(x: torch.Tensor) -> torch.Tensor:
    """K1: [M, K] fp32/bf16 -> [M, K/32] int32 wire-format words
    (bit-identical to :func:`pack_bits`, NaN -> 0, ±0 -> 1). On the card
    a base that is not 16-byte aligned (a view with a storage offset)
    takes the kernel's scalar-load path."""
    what = "pack_rows"
    _require(x.dim() == 2, what, f"expected [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    _require(k % 32 == 0, what, f"K must be a multiple of 32, got {k}")
    device = _cuda_device(what, x)
    if device is None:
        return pack_rows_plain(x)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    _require(x.dtype in codes, what, f"takes float32/bfloat16, got {x.dtype}")
    _require(x.is_contiguous(), what, "input must be contiguous")
    out = torch.empty((m, k // 32), dtype=torch.int32, device=x.device)
    lib = cuda_build.library("pack_rows")
    cuda_build.check(
        lib.zk_pack_rows(
            x.data_ptr(), codes[x.dtype], out.data_ptr(), m * (k // 32),
            device, _stream(device),
        ),
        what,
    )
    LAUNCHES["pack_rows"] += 1
    return out


def _conv_out_size(xq, packed, strides) -> Tuple[int, int]:
    _, hp, wp, _ = xq.shape
    kh, kw = packed.shape[:2]
    sh, sw = strides
    return (hp - kh) // sh + 1, (wp - kw) // sw + 1


def conv_gemm_popcount_plain(
    xq: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    strides: Sequence[int],
    k_true: int,
) -> torch.Tensor:
    """Plain version of K3: unfold the taps of the packed input, XOR with
    the packed weights, popcount in int64, then the kernel's epilogue."""
    b = xq.shape[0]
    kh, kw, ciw, co = packed.shape
    ho, wo = _conv_out_size(xq, packed, strides)
    patches = _conv_patches(xq, kh, kw, strides)
    mism = _popcount_mismatches(patches, packed.reshape(kh * kw * ciw, co))
    y = (k_true - (mism + mism)).to(torch.float32) * scale.to(torch.float32)
    return y.reshape(b, ho, wo, co)


def _conv_patches(xq: torch.Tensor, kh: int, kw: int, strides: Sequence[int]) -> torch.Tensor:
    """The unfolded taps of ``xq`` [B, Hp, Wp, ciw]: [B*Ho*Wo, kh*kw*ciw],
    row (b, ho, wo), column (dy*kw + dx)*ciw + t (VALID on ``xq``)."""
    b, hp, wp, ciw = xq.shape
    sh, sw = strides
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    taps = [
        xq[:, dy : dy + (ho - 1) * sh + 1 : sh, dx : dx + (wo - 1) * sw + 1 : sw]
        for dy in range(kh)
        for dx in range(kw)
    ]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * ciw)


def _conv_k_offsets(kh: int, kw: int, wp: int, ciw: int) -> torch.Tensor:
    """K3's implicit im2col: [kh*kw*ciw] int32, the offset of K word
    ``(dy*kw + dx)*ciw + t`` from its output pixel's first word in the
    flattened ``xq``, ``(dy*Wp + dx)*ciw + t``. Pixel (b, ho, wo) starts at
    ``((b*Hp + ho*sh)*Wp + wo*sw)*ciw``; the kernel gathers word (m, k)
    of :func:`_conv_patches` from there plus this table."""
    dy = torch.arange(kh).reshape(kh, 1, 1)
    dx = torch.arange(kw).reshape(1, kw, 1)
    t = torch.arange(ciw).reshape(1, 1, ciw)
    return ((dy * wp + dx) * ciw + t).reshape(-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _conv_k_offsets_on(device: int, kh: int, kw: int, wp: int, ciw: int) -> torch.Tensor:
    """:func:`_conv_k_offsets` on a card, made once per geometry."""
    return _conv_k_offsets(kh, kw, wp, ciw).to(torch.device("cuda", device))


def conv_gemm_popcount(
    xq: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    strides: Sequence[int],
    k_true: int,
) -> torch.Tensor:
    """K3: popcount conv of the packed, already padded input ``xq``
    [B, Hp, Wp, ciw] int32 against ``packed`` [kh, kw, ciw, co] int32,
    VALID on ``xq``; returns ``(k_true - 2*mismatches) * scale`` as
    [B, Ho, Wo, co] float32."""
    what = "conv_gemm_popcount"
    _require(xq.dim() == 4 and packed.dim() == 4, what,
             "expected xq [B, Hp, Wp, ciw] and packed [kh, kw, ciw, co]")
    b, hp, wp, ciw = xq.shape
    kh, kw, ciw_w, co = packed.shape
    _require(ciw == ciw_w, what, f"input words {ciw} != weight words {ciw_w}")
    _require(tuple(scale.shape) == (co,), what,
             f"scale must be [{co}], got {tuple(scale.shape)}")
    sh, sw = (int(s) for s in strides)
    _require(hp >= kh and wp >= kw and sh > 0 and sw > 0, what,
             "padded input smaller than the kernel, or bad strides")
    device = _cuda_device(what, xq, packed, scale)
    if device is None:
        return conv_gemm_popcount_plain(xq, packed, scale, (sh, sw), k_true)
    _require(xq.dtype == torch.int32 and packed.dtype == torch.int32, what,
             "xq and packed must be int32")
    _require(scale.dtype == torch.float32, what, "scale must be float32")
    _require(all(t.is_contiguous() for t in (xq, packed, scale)), what,
             "operands must be contiguous")
    lib = cuda_build.library("conv_gemm_popcount")
    ho, wo = _conv_out_size(xq, packed, (sh, sw))
    koff = _conv_k_offsets_on(device, kh, kw, wp, ciw)
    out = torch.empty((b, ho, wo, co), dtype=torch.float32, device=xq.device)
    cuda_build.check(
        lib.zk_conv_gemm_popcount(
            xq.data_ptr(), packed.data_ptr(), scale.data_ptr(), koff.data_ptr(),
            out.data_ptr(), b, hp, wp, ciw, kh, kw, co, sh, sw, ho, wo,
            int(k_true), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["conv_gemm_popcount"] += 1
    return out


def packed_weight_matmul_plain(
    a: torch.Tensor, b_packed: torch.Tensor
) -> torch.Tensor:
    """Plain version of K4: decode the weights to ±1 and multiply in
    float64 (exact for any K below 2^53), cast to int32."""
    k = a.shape[1]
    w = unpack_bits(b_packed, k, axis=0).to(torch.float64)
    return (a.to(torch.float64) @ w).to(torch.int32)


def packed_weight_matmul(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """K4: ``a`` [M, K] int8 in {-1, 0, +1} times the bit-packed ±1
    weights ``b_packed`` [ceil(K/32), N] int32; returns [M, N] int32."""
    what = "packed_weight_matmul"
    _require(a.dim() == 2 and b_packed.dim() == 2, what,
             "expected a [M, K] and b_packed [Kw, N]")
    m, k = a.shape
    kw, n = b_packed.shape
    _require(kw * 32 == _round_up(k, 32), what,
             f"packed weight K-words {kw} inconsistent with A's K {k}")
    _require(a.dtype == torch.int8, what, f"a must be int8, got {a.dtype}")
    device = _cuda_device(what, a, b_packed)
    if device is None:
        return packed_weight_matmul_plain(a, b_packed)
    _require(b_packed.dtype == torch.int32, what, "b_packed must be int32")
    if k != kw * 32:
        # Zeros on the A side contribute nothing against any weight bit.
        a = F.pad(a, (0, kw * 32 - k))
    _require(a.is_contiguous() and b_packed.is_contiguous(), what,
             "operands must be contiguous")
    # The kernels read A's rows as 16-byte vectors (``cp.async``).
    _require(a.data_ptr() % 16 == 0, what, "a must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    lib = cuda_build.library("packed_weight_matmul")
    cuda_build.check(
        lib.zk_packed_weight_matmul(
            a.data_ptr(), b_packed.data_ptr(), out.data_ptr(), m, n, kw,
            device, _stream(device),
        ),
        what,
    )
    LAUNCHES["packed_weight_matmul"] += 1
    return out


#: The K4 kernels by the code ``zk_packed_weight_matmul_variant`` returns:
#: ``"mma"`` (M > 8: the block-tile GEMM on the int8 tensor cores) or
#: ``"small_m"`` (M <= 8: the weights as the tensor cores' A operand,
#: decoded in registers, K split over the card).
PACKED_WEIGHT_VARIANTS = {0: "mma", 1: "small_m"}

#: The K5 and K2 kernels by the code ``zk_xnor_matmul_packed_variant`` /
#: ``zk_xnor_matmul_packed_scaled_variant`` returns: ``"small_m"`` (M <=
#: 8, both: the weights as the int8 tensor cores' A operand, both sides
#: decoded to +-1 bytes in registers, K split over a cluster of blocks
#: that joins its sums in distributed shared memory), ``"popc"`` (XOR and
#: popcount on the CUDA cores: K5 at M 9..64, K2 at every M past 8) or
#: ``"mma"`` (K5 past M 64: both operands decoded to +-1 bytes in the
#: block-tile GEMM on the int8 tensor cores).
XNOR_VARIANTS = {0: "mma", 1: "popc", 2: "small_m"}


def _gemm_variant(library: str, what: str, names: dict, m: int, n: int, kw: int) -> str:
    code = getattr(cuda_build.library(library), f"zk_{what}_variant")(int(m), int(n), int(kw))
    if code not in names:
        raise ValueError(f"{what}: no kernel for M={m}, N={n}, Kw={kw}")
    return names[code]


def packed_weight_matmul_variant(m: int, n: int, kw: int) -> str:
    """Which K4 kernel a call on the card launches for ``a`` [m, 32 kw]
    and ``b_packed`` [kw, n], as the library's dispatch decides (see
    :data:`PACKED_WEIGHT_VARIANTS`). Builds the library at first use."""
    return _gemm_variant("packed_weight_matmul", "packed_weight_matmul",
                         PACKED_WEIGHT_VARIANTS, m, n, kw)


# -- batch-packed 1-bit residuals (K6, K7, K8) -------------------------------
#
# The training residuals of the int8 binary conv: the ±1 conv input and
# the ste_sign pass-through mask are stored at 1 bit per value between
# forward and backward. Bits pack along the BATCH axis of the 4-D
# normalised shape, so no relayout of the NHWC residual is needed; the
# batch pads to a multiple of 32 (1.0 for a pack, 0.0 for a cotangent).


def _to_4d_shape(shape: Sequence[int]) -> Tuple[int, int, int, int]:
    """A residual shape as [B, H, W, C]: [B, K] -> [B, 1, 1, K], [B, W,
    C] -> [B, 1, W, C], and [B, *spatial, C] merges the leading spatial
    dims. Pack and unpack recompute it from the original shape."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 4:
        return shape
    if len(shape) == 2:
        return (shape[0], 1, 1, shape[1])
    if len(shape) == 3:
        return (shape[0], 1, shape[1], shape[2])
    if len(shape) > 4:
        inner = 1
        for s in shape[1:-2]:
            inner *= s
        return (shape[0], inner, shape[-2], shape[-1])
    raise ValueError(
        f"1-bit residual packing needs a batched tensor, got shape {shape}."
    )


def _pad_batch(x4: torch.Tensor, pad_value: float) -> torch.Tensor:
    b = x4.shape[0]
    bp = _round_up(b, 32)
    if bp == b:
        return x4
    return F.pad(x4, (0, 0, 0, 0, 0, 0, 0, bp - b), value=pad_value)


def _bit_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device).reshape(1, 32, 1, 1, 1)


def _unpack_resid_bits(words: torch.Tensor) -> torch.Tensor:
    """[G, H, W, C] words -> [32G, H, W, C] int64 bits in batch order."""
    g, h, w, c = words.shape
    bits = ((words.to(torch.int64)[:, None] & 0xFFFFFFFF) >> _bit_shifts(words.device)) & 1
    return bits.reshape(g * 32, h, w, c)


def _resid_dtype_code(what: str, dtype: torch.dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    _require(dtype in codes, what, f"takes float32/bfloat16, got {dtype}")
    return codes[dtype]


def _dense(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as a contiguous tensor for a kernel that reads flat rows;
    a strided ``t`` is copied once, counted in :data:`COPIES`."""
    if t.is_contiguous():
        return t
    COPIES[what] += 1
    return t.contiguous()


def pack_resid_plain(x: torch.Tensor, mask_mode: bool = False) -> torch.Tensor:
    """Plain version of K6: pad the batch with 1.0, compare in fp32, and
    shift-or 32 batch rows into each word."""
    x4 = _pad_batch(x.reshape(_to_4d_shape(x.shape)), 1.0)
    bp, h, w, c = x4.shape
    v = x4.to(torch.float32)
    bits = (v.abs() <= 1.0) if mask_mode else (v >= 0)
    bits = bits.reshape(bp // 32, 32, h, w, c).to(torch.int64)
    return _to_int32((bits << _bit_shifts(x.device)).sum(1))


def pack_resid(x: torch.Tensor, mask_mode: bool = False) -> torch.Tensor:
    """K6: pack ``x`` (fp32/bf16, batch first) to 1 bit per value along
    the batch: ``x >= 0`` (sign mode, exact for ±1 tensors; NaN -> 0,
    -0 -> 1) or ``|x| <= 1`` (``mask_mode``, the ste_sign pass-through;
    NaN -> 0). Returns [ceil(B/32), H, W, C] int32 words of the
    :func:`_to_4d_shape` normalisation."""
    what = "pack_resid"
    b, h, w, c = _to_4d_shape(x.shape)
    code = _resid_dtype_code(what, x.dtype)
    device = _cuda_device(what, x)
    if device is None:
        return pack_resid_plain(x, mask_mode)
    x = _dense(x, what)
    out = torch.empty((-(-b // 32), h, w, c), dtype=torch.int32, device=x.device)
    lib = cuda_build.library("resid_pack")
    cuda_build.check(
        lib.zk_pack_resid(
            x.data_ptr(), code, int(mask_mode), out.data_ptr(), b, h * w * c,
            device, _stream(device),
        ),
        what,
    )
    LAUNCHES["pack_resid"] += 1
    return out


def unpack_resid_pm1_plain(
    words: torch.Tensor, shape: Sequence[int], dtype: torch.dtype
) -> torch.Tensor:
    """Plain version of K7: ``bit + bit - 1`` for every batch row, the
    pad rows sliced off."""
    b4 = _to_4d_shape(shape)[0]
    bits = _unpack_resid_bits(words)
    return (bits + bits - 1).to(dtype)[:b4].reshape(tuple(shape))


def _check_words(what: str, words: torch.Tensor, shape: Sequence[int]) -> None:
    b, h, w, c = _to_4d_shape(shape)
    want = (-(-b // 32), h, w, c)
    _require(tuple(words.shape) == want, what,
             f"words {tuple(words.shape)} do not pack a residual of shape "
             f"{tuple(shape)} (want {want})")
    _require(words.dtype == torch.int32, what, f"words must be int32, got {words.dtype}")


def unpack_resid_pm1(
    words: torch.Tensor, shape: Sequence[int], dtype: torch.dtype
) -> torch.Tensor:
    """K7: the inverse of sign-mode :func:`pack_resid` — ±1 values of
    ``shape`` in ``dtype`` (exact: ±1 is representable in every float
    type)."""
    what = "unpack_resid_pm1"
    shape = tuple(int(s) for s in shape)
    _check_words(what, words, shape)
    code = _resid_dtype_code(what, dtype)
    device = _cuda_device(what, words)
    if device is None:
        return unpack_resid_pm1_plain(words, shape, dtype)
    b, h, w, c = _to_4d_shape(shape)
    words = words.contiguous()
    out = torch.empty(shape, dtype=dtype, device=words.device)
    lib = cuda_build.library("resid_pack")
    cuda_build.check(
        lib.zk_unpack_resid_pm1(
            words.data_ptr(), out.data_ptr(), code, b, h * w * c,
            device, _stream(device),
        ),
        what,
    )
    LAUNCHES["unpack_resid_pm1"] += 1
    return out


def mask_mul_resid_plain(g: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: pad ``g``'s batch with 0.0, multiply by the
    unpacked mask in ``g``'s dtype, slice the pad rows off."""
    g4 = _pad_batch(g.reshape(_to_4d_shape(g.shape)), 0.0)
    mask = _unpack_resid_bits(words).to(g.dtype)
    return (g4 * mask)[: g.shape[0]].reshape(g.shape)


def mask_mul_resid(g: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """K8: ``g * mask`` where ``words`` is a mask-mode :func:`pack_resid`
    of a tensor shaped like ``g`` — the ste_sign backward from the packed
    mask (one read of ``g`` and 1/16 of its bytes in words)."""
    what = "mask_mul_resid"
    _check_words(what, words, g.shape)
    code = _resid_dtype_code(what, g.dtype)
    device = _cuda_device(what, g, words)
    if device is None:
        return mask_mul_resid_plain(g, words)
    b, h, w, c = _to_4d_shape(g.shape)
    g = _dense(g, what)
    words = words.contiguous()
    out = torch.empty_like(g)
    lib = cuda_build.library("resid_pack")
    cuda_build.check(
        lib.zk_mask_mul_resid(
            g.data_ptr(), words.data_ptr(), out.data_ptr(), code, b, h * w * c,
            device, _stream(device),
        ),
        what,
    )
    LAUNCHES["mask_mul_resid"] += 1
    return out


# -- K5, K2: the popcount GEMM on packed operands ----------------------------


def xnor_matmul_packed_plain(
    a_packed: torch.Tensor, b_packed: torch.Tensor, *, k_true: int
) -> torch.Tensor:
    """Plain version of K5: XOR the words, popcount in int64, then
    ``k_true - 2*mismatches`` in int32."""
    mism = _popcount_mismatches(a_packed, b_packed)
    return k_true - (mism + mism)


def xnor_matmul_packed_scaled_plain(
    a_packed: torch.Tensor, b_packed: torch.Tensor, scale: torch.Tensor, *,
    k_true: int,
) -> torch.Tensor:
    """Plain version of K2: the plain K5, cast to float32, times the
    scale (the JAX reference epilogue)."""
    acc = xnor_matmul_packed_plain(a_packed, b_packed, k_true=k_true)
    return acc.to(torch.float32) * scale.to(torch.float32)[None, :]


def _check_xnor_operands(what: str, a_packed, b_packed, scale=None) -> Tuple[int, int, int]:
    _require(a_packed.dim() == 2 and b_packed.dim() == 2, what,
             "expected a_packed [M, Kw] and b_packed [Kw, N]")
    m, kw = a_packed.shape
    kw2, n = b_packed.shape
    _require(kw == kw2, what, f"Packed K mismatch: {kw} vs {kw2}")
    if scale is not None:
        _require(tuple(scale.shape) == (n,), what,
                 f"scale must be [{n}] (per output channel), got {tuple(scale.shape)}")
    return m, kw, n


def _xnor_kernel_operands(what: str, *tensors: torch.Tensor) -> None:
    a_packed, b_packed = tensors[:2]
    _require(a_packed.dtype == torch.int32 and b_packed.dtype == torch.int32, what,
             "a_packed and b_packed must be int32")
    _require(all(t.is_contiguous() for t in tensors), what, "operands must be contiguous")


def xnor_matmul_packed(
    a_packed: torch.Tensor, b_packed: torch.Tensor, *, k_true: int
) -> torch.Tensor:
    """K5: binary GEMM on packed operands (``a_packed`` [M, Kw] and
    ``b_packed`` [Kw, N] int32, packed along K; equal-bit K padding
    cancels): ``k_true - 2*mismatches`` as [M, N] int32, i.e. ``sign(A) @
    sign(B)`` over ``k_true`` terms."""
    what = "xnor_matmul_packed"
    m, kw, n = _check_xnor_operands(what, a_packed, b_packed)
    device = _cuda_device(what, a_packed, b_packed)
    if device is None:
        return xnor_matmul_packed_plain(a_packed, b_packed, k_true=k_true)
    _xnor_kernel_operands(what, a_packed, b_packed)
    out = torch.empty((m, n), dtype=torch.int32, device=a_packed.device)
    lib = cuda_build.library("xnor_gemm")
    cuda_build.check(
        lib.zk_xnor_matmul_packed(
            a_packed.data_ptr(), b_packed.data_ptr(), out.data_ptr(), m, n, kw,
            int(k_true), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["xnor_matmul_packed"] += 1
    return out


def xnor_matmul_packed_variant(m: int, n: int, kw: int) -> str:
    """Which K5 kernel a call on the card launches for ``a_packed`` [m,
    kw] and ``b_packed`` [kw, n], as the library's dispatch decides (see
    :data:`XNOR_VARIANTS`). Builds the library at first use."""
    return _gemm_variant("xnor_gemm", "xnor_matmul_packed", XNOR_VARIANTS, m, n, kw)


def xnor_matmul_packed_scaled_variant(m: int, n: int, kw: int) -> str:
    """Which K2 kernel a call on the card launches, as
    :func:`xnor_matmul_packed_variant` says for K5."""
    return _gemm_variant("xnor_gemm", "xnor_matmul_packed_scaled", XNOR_VARIANTS, m, n, kw)


def xnor_matmul_packed_scaled(
    a_packed: torch.Tensor, b_packed: torch.Tensor, scale: torch.Tensor, *,
    k_true: int,
) -> torch.Tensor:
    """K2: :func:`xnor_matmul_packed` with the per-output-channel
    ``scale`` [N] float32 applied in the epilogue; [M, N] float32, bit
    for bit ``xnor_matmul_packed(...).float() * scale`` (an exact integer
    cast and one fp32 multiply)."""
    what = "xnor_matmul_packed_scaled"
    m, kw, n = _check_xnor_operands(what, a_packed, b_packed, scale)
    device = _cuda_device(what, a_packed, b_packed, scale)
    if device is None:
        return xnor_matmul_packed_scaled_plain(a_packed, b_packed, scale, k_true=k_true)
    _require(scale.dtype == torch.float32, what, "scale must be float32")
    _xnor_kernel_operands(what, a_packed, b_packed, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=a_packed.device)
    lib = cuda_build.library("xnor_gemm")
    cuda_build.check(
        lib.zk_xnor_matmul_packed_scaled(
            a_packed.data_ptr(), b_packed.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, n, kw, int(k_true), device, _stream(device),
        ),
        what,
    )
    LAUNCHES["xnor_matmul_packed_scaled"] += 1
    return out


def xnor_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binary GEMM of float ±1 operands through bit packing, ``[M, K] @
    [K, N]`` as float32 exact integers (the JAX package's
    ``xnor_matmul``). K pads to a multiple of 32 with +1 on both
    operands, whose bits match and so cancel, and ``k_true`` stays the
    original K. On the card: K1 on ``a`` and on ``b``'s transpose, then
    K5; on the CPU their plain versions (``pack_bits``, then the plain
    K5), bit for bit the same."""
    _require(a.dim() == 2 and b.dim() == 2, "xnor_matmul", "expected a [M, K] and b [K, N]")
    k, k2 = a.shape[1], b.shape[0]
    if k != k2:
        raise ValueError(f"Inner dims mismatch: {k} vs {k2}.")
    k_pad = _round_up(k, 32)
    if k_pad != k:
        a = F.pad(a, (0, k_pad - k), value=1.0)
        b = F.pad(b, (0, 0, 0, k_pad - k), value=1.0)
    # K1 reads float32/bfloat16; any other dtype keeps its signs in float32.
    if a.dtype not in (torch.float32, torch.bfloat16):
        a = a.to(torch.float32)
    if b.dtype not in (torch.float32, torch.bfloat16):
        b = b.to(torch.float32)
    a_packed = pack_rows(a.contiguous())
    b_packed = pack_rows(b.t().contiguous()).t().contiguous()
    return xnor_matmul_packed(a_packed, b_packed, k_true=k).to(torch.float32)


def int8_matmul(a_sign: torch.Tensor, b_sign: torch.Tensor) -> torch.Tensor:
    """Binary GEMM on int8 operands with int32 accumulation, float32 out
    (the JAX package's ``int8_matmul``, which XLA computes outside any
    Pallas kernel): both operands round half to even to int8, so a
    literal 0 stays 0. On the card this is ``torch._int_mm``, with M, K
    and N padded by zeros (which add nothing to the sums) to the shapes
    it takes, then sliced back; on the CPU an int32 matmul."""
    _require(a_sign.dim() == 2 and b_sign.dim() == 2, "int8_matmul",
             "expected a_sign [M, K] and b_sign [K, N]")
    (m, k), (k2, n) = a_sign.shape, b_sign.shape
    if k != k2:
        raise ValueError(f"Inner dims mismatch: {k} vs {k2}.")
    a8 = torch.round(a_sign).to(torch.int8)
    b8 = torch.round(b_sign).to(torch.int8)
    if _cuda_device("int8_matmul", a8, b8) is None:
        return (a8.to(torch.int32) @ b8.to(torch.int32)).to(torch.float32)
    # _int_mm takes M > 16 and K, N multiples of 8; b column-major.
    mp, kp, np_ = max(m, 17), _round_up(max(k, 16), 8), _round_up(max(n, 8), 8)
    a8 = F.pad(a8, (0, kp - k, 0, mp - m))
    b8 = F.pad(b8, (0, np_ - n, 0, kp - k)).t().contiguous().t()
    return torch._int_mm(a8, b8)[:m, :n].to(torch.float32)


# -- packed conv schedules --------------------------------------------------


def _spatial_pad(
    x: torch.Tensor, kh: int, kw: int, strides: Sequence[int], padding: str,
    pad_value: float,
) -> Tuple[torch.Tensor, int, int]:
    """Pad NHWC input per XLA SAME/VALID semantics; returns (padded, Ho,
    Wo). SAME puts the odd pixel after, as XLA does."""
    _, h, w, _ = x.shape
    sh, sw = strides
    top, bottom, left, right = _pads(h, w, kh, kw, strides, padding)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom), value=pad_value)
    return x, (h + top + bottom - kh) // sh + 1, (w + left + right - kw) // sw + 1


def _pads(
    h: int, w: int, kh: int, kw: int, strides: Sequence[int], padding: str
) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of XLA's SAME (odd pixel after) or
    VALID padding."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"Unsupported padding {padding!r} (SAME/VALID).")
    (top, bottom), (left, right) = conv_pads((h, w), (kh, kw), strides, padding)
    return top, bottom, left, right


def _conv_gemm_popcount(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    strides: Sequence[int],
    padding: str,
    *,
    ci: int,
) -> torch.Tensor:
    """Fused popcount conv: ones-pad the ±1 input, sign+pack it once (K1),
    then the conv-as-GEMM kernel (K3). SAME pads with ONES, the
    documented popcount deviation; padded channels match the weights'
    +1 pad bits, so ``k_true = kh*kw*ci`` is exact."""
    kh, kw, ciw, co = packed.shape
    xp, _, _ = _spatial_pad(x, kh, kw, strides, padding, 1.0)
    b, hp, wp, _ = xp.shape
    ci_pad = ciw * 32
    if ci_pad != ci:
        xp = F.pad(xp, (0, ci_pad - ci), value=1.0)
    xq = pack_rows(xp.reshape(-1, ci_pad)).reshape(b, hp, wp, ciw)
    return conv_gemm_popcount(xq, packed, scale, strides, kh * kw * ci)


def _packed_conv_forward(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    strides: Sequence[int],
    padding: str,
    *,
    ci: int,
    use_popcount: bool,
    fuse_taps: Optional[bool] = None,
    flavor: str = "auto",
) -> torch.Tensor:
    """Conv of NHWC ``x`` (±1, or 0 from padding) against pre-packed
    weights; returns [B, Ho, Wo, co] float32.

    ``use_popcount`` with the "auto"/"pallas" flavor runs K1 + K3.
    Otherwise the conv decomposes into ``sum over (dy, dx) of shifted_x @
    W[dy, dx]``, either as ONE GEMM over a tap-major patch matrix
    (``fuse_taps``; default when it fits in ``_FUSE_TAPS_MAX_BYTES``) or
    as one GEMM per tap; both are bit-identical. The GEMM is K4 on int8
    activations (``use_popcount=False``, zero padding, exact against the
    float conv) or the unfused popcount GEMM (ones padding)."""
    strides = tuple(int(s) for s in strides)
    if use_popcount and resolve_binary_flavor(flavor) == "pallas":
        return _conv_gemm_popcount(x, packed, scale, strides, padding, ci=ci)
    kh, kw, ciw, co = packed.shape
    b = x.shape[0]
    pad_value = 1.0 if use_popcount else 0.0
    xp, ho, wo = _spatial_pad(x, kh, kw, strides, padding, pad_value)
    sh, sw = strides
    m = b * ho * wo
    ci_pad = ciw * 32
    if fuse_taps is None:
        # Counted in x's dtype, as the JAX package decides it.
        fuse_taps = m * kh * kw * ci_pad * x.element_size() <= _FUSE_TAPS_MAX_BYTES
    if ci_pad != ci:
        xp = F.pad(xp, (0, ci_pad - ci), value=pad_value)
    if not use_popcount:
        xp = xp.to(torch.int8)  # exact: the values are -1, 0 and +1

    def tap(dy: int, dx: int) -> torch.Tensor:
        return xp[:, dy : dy + (ho - 1) * sh + 1 : sh,
                  dx : dx + (wo - 1) * sw + 1 : sw]

    def gemm(a: torch.Tensor, w: torch.Tensor, k_true: int) -> torch.Tensor:
        if use_popcount:
            return xnor_matmul_packed(pack_bits(a, axis=-1), w, k_true=k_true)
        return packed_weight_matmul(a, w)

    if fuse_taps:
        taps = [tap(dy, dx) for dy in range(kh) for dx in range(kw)]
        patches = torch.stack(taps, dim=3).reshape(m, kh * kw * ci_pad)
        acc = gemm(patches, packed.reshape(kh * kw * ciw, co), kh * kw * ci)
    else:
        acc = None
        for dy in range(kh):
            for dx in range(kw):
                a = tap(dy, dx).reshape(m, ci_pad)
                out = gemm(a, packed[dy, dx], ci)
                acc = out if acc is None else acc + out
    y = acc.to(torch.float32) * scale[None, :].to(torch.float32)
    return y.reshape(b, ho, wo, co)


def packed_conv_infer(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    strides: Sequence[int],
    padding: str,
    *,
    use_popcount: bool = False,
    flavor: str = "auto",
) -> torch.Tensor:
    """Inference conv from PRE-PACKED weights (the deployment path: the
    weights never exist unpacked on the card). Inference only: packed
    weights carry no latent parameters to train, so an input that
    requires grad raises."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "packed_conv_infer is inference-only: packed weights carry no "
            "latent parameters to train."
        )
    return _packed_conv_forward(
        x, packed, scale, strides, padding,
        ci=x.shape[-1], use_popcount=use_popcount, flavor=flavor,
    )


# -- dense binary paths ------------------------------------------------------


def _flatten_leading(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[..., K] -> ([M, K], leading shape) for the 2-D GEMM kernels."""
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def _packed_dense_forward(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    k_true: int,
    use_popcount: bool,
    flavor: str = "auto",
) -> torch.Tensor:
    """Dense ``[..., K]`` against pre-packed weights ``[ceil(K/32), N]``;
    returns ``[..., N]`` float32.

    ``use_popcount``: both operands packed; K pads with +1 on both sides
    (equal bits, no mismatch; the inputs must be ±1). The "auto"/"pallas"
    flavor runs K1 then K2 (the scale in the GEMM's epilogue); "reference"
    runs ``pack_bits``, K5 and the scale as a separate multiply, bit for
    bit the same. Otherwise the activations go to int8 (exact on -1, 0,
    +1; K pads with zeros, which add nothing) through K4, then the scale."""
    x2, lead = _flatten_leading(x)
    if use_popcount:
        k_pad = _round_up(k_true, 32)
        if k_pad != k_true:
            x2 = F.pad(x2, (0, k_pad - k_true), value=1.0)
        if resolve_binary_flavor(flavor) == "pallas":
            y = xnor_matmul_packed_scaled(
                pack_rows(x2.contiguous()), packed, scale, k_true=k_true
            )
            return y.reshape(*lead, -1)
        acc = xnor_matmul_packed(pack_bits(x2, axis=-1), packed, k_true=k_true)
    else:
        acc = packed_weight_matmul(x2.to(torch.int8).contiguous(), packed)
    y = acc.to(torch.float32) * scale[None, :].to(torch.float32)
    return y.reshape(*lead, -1)


def xnor_dense(
    x: torch.Tensor,
    q_kernel: torch.Tensor,
    use_popcount: bool = False,
    flavor: str = "auto",
) -> torch.Tensor:
    """Binary dense ``[..., K] @ [K, N]`` through the packed kernels (the
    JAX package's ``xnor_dense``), packing the quantized kernel (sign x
    per-output-channel scale) at each call: K1 + K2 (``pack_bits`` + K5
    under "reference") with ``use_popcount``, K4 otherwise. Under autograd
    the gradients are the float matmul's on the saved quantized operands
    (:class:`_XnorDense`)."""
    if torch.is_grad_enabled() and (x.requires_grad or q_kernel.requires_grad):
        return _XnorDense.apply(x, q_kernel, bool(use_popcount), flavor)
    packed, scale = pack_dense_kernel(q_kernel)
    return _packed_dense_forward(
        x, packed, scale, k_true=q_kernel.shape[0], use_popcount=use_popcount,
        flavor=flavor,
    )


def packed_dense_infer(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    k_true: int,
    *,
    use_popcount: bool = False,
    flavor: str = "auto",
) -> torch.Tensor:
    """Inference dense from PRE-PACKED weights (the dense deployment
    path). Inference only: an input that requires grad raises."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "packed_dense_infer is inference-only: packed weights carry no "
            "latent parameters to train."
        )
    return _packed_dense_forward(
        x, packed, scale, k_true=k_true, use_popcount=use_popcount, flavor=flavor,
    )


# -- the float conv and its VJP (rank-generic) ----------------------------


def conv_pads(
    spatial: Sequence[int], kernel: Sequence[int], strides: Sequence[int], padding,
    dilation: Optional[Sequence[int]] = None,
) -> Tuple[Tuple[int, int], ...]:
    """(before, after) per spatial dim of XLA's SAME (the odd pixel after,
    over the dilated kernel's extent), VALID, or explicit pads."""
    rank = len(spatial)
    dilation = tuple(dilation or (1,) * rank)
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0),) * rank
        if padding != "SAME":
            raise ValueError(f"Unsupported padding {padding!r} (SAME/VALID or explicit pads).")
        pads = []
        for n, k, s, d in zip(spatial, kernel, strides, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pads) != rank or any(lo < 0 or hi < 0 for lo, hi in pads):
        raise ValueError(f"Explicit pads {padding!r}: want {rank} non-negative (lo, hi) pairs.")
    return pads


def _conv_operands(
    x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int], padding,
    dilation: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, Tuple[int, ...], Optional[Tuple[int, ...]]]:
    """``(input, conv padding, offset)`` for a conv of channels-last ``x``:
    symmetric padding is left to the conv; an asymmetric one (SAME's odd
    pixel after, or explicit pads) is applied with zeros here, and
    ``offset`` (the leading pad of each spatial dim) locates ``x`` inside
    the padded input."""
    pads = conv_pads(x.shape[1:-1], kernel, strides, padding, dilation)
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads), None
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat), (0,) * len(pads), tuple(lo for lo, _ in pads)


def _oihw(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A channels-last kernel (``[*spatial, I, O]``, HWIO in 2-D) as the
    ``[O, I, *spatial]`` weight of ``F.conv*d`` in ``dtype``, stored
    channels-last like the activations it meets."""
    return k.to(dtype).movedim(-1, 0).contiguous().movedim(-1, 1)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def float_conv(
    x: torch.Tensor, k: torch.Tensor, strides: Sequence[int], padding,
    groups: int = 1, dilation: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Conv of channels-last ``x`` (NHWC in 2-D; 1-D and 3-D too) with the
    channels-last kernel ``k`` (HWIO) cast to ``x``'s dtype (the JAX
    package's ``_float_conv``): the compute dtype follows the activations,
    as the gradient convs of the binary paths do. XLA SAME/VALID padding
    or explicit pads, ``dilation`` of the kernel; differentiable by
    autograd."""
    rank = k.dim() - 2
    xp, pad, _ = _conv_operands(x, k.shape[:rank], strides, padding, dilation)
    y = _CONV[rank](
        xp.movedim(-1, 1), _oihw(k, x.dtype), stride=tuple(strides), padding=pad,
        dilation=tuple(dilation or (1,) * rank), groups=groups,
    )
    return y.movedim(1, -1)


def _float_conv_vjp(
    x: torch.Tensor, k: torch.Tensor, g: torch.Tensor, strides: Sequence[int],
    padding, groups: int, needs: Sequence[bool],
    dilation: Optional[Sequence[int]] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dx, dk)`` of :func:`float_conv` at ``(x, k)`` for the cotangent
    ``g`` (in ``x``'s dtype; dk in it too, channels-last), straight from
    the conv backward, without recomputing the forward. ``needs`` masks
    them."""
    rank = k.dim() - 2
    dilation = tuple(dilation or (1,) * rank)
    xp, pad, offset = _conv_operands(x, k.shape[:rank], strides, padding, dilation)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.movedim(-1, 1), xp.movedim(-1, 1), _oihw(k, x.dtype), None,
        list(strides), list(pad), list(dilation), False, [0] * rank, groups,
        [bool(needs[0]), bool(needs[1]), False],
    )
    if dx is not None:
        dx = dx.movedim(1, -1)
        if offset is not None:
            dx = dx[(slice(None),) + tuple(
                slice(o, o + n) for o, n in zip(offset, x.shape[1:-1]))]
    if dw is not None:
        dw = dw.movedim(0, -1).movedim(0, -2)
    return dx, dw


# -- training through the packed kernels ------------------------------------


class _XnorConv(torch.autograd.Function):
    """:func:`xnor_conv` on the differentiated path: the packed forward,
    and the VJP of the float function it equals on its domain
    (``_reference_conv`` of the JAX package) on the saved quantized
    operands. The popcount path's SAME pads with ones and then runs VALID,
    so its border gradient is the interior slice of the padded input's
    gradient; the others are the float conv's. The backward computes in
    ``x``'s dtype (the kernel cast to it, as the forward convs of the
    float paths do)."""

    @staticmethod
    def forward(ctx, x, q_kernel, strides, padding, use_popcount, flavor):
        packed, scale = pack_conv_kernel(q_kernel)
        ctx.save_for_backward(x, q_kernel)
        ctx.conf = (strides, padding, use_popcount)
        return _packed_conv_forward(
            x, packed, scale, strides, padding, ci=x.shape[-1],
            use_popcount=use_popcount, flavor=flavor,
        )

    @staticmethod
    def backward(ctx, g):
        x, q_kernel = ctx.saved_tensors
        strides, padding, use_popcount = ctx.conf
        needs = ctx.needs_input_grad[:2]
        g = g.to(x.dtype)
        if use_popcount and padding == "SAME":
            kh, kw = q_kernel.shape[:2]
            xp, _, _ = _spatial_pad(x, kh, kw, strides, "SAME", 1.0)
            dx, dk = _float_conv_vjp(xp, q_kernel, g, strides, "VALID", 1, needs)
            if dx is not None:
                top, _, left, _ = _pads(x.shape[1], x.shape[2], kh, kw, strides, "SAME")
                dx = dx[:, top : top + x.shape[1], left : left + x.shape[2]]
        else:
            dx, dk = _float_conv_vjp(x, q_kernel, g, strides, padding, 1, needs)
        return (
            None if dx is None else dx.to(x.dtype),
            None if dk is None else dk.to(q_kernel.dtype),
            None, None, None, None,
        )


def xnor_conv(
    x: torch.Tensor,
    q_kernel: torch.Tensor,
    strides: Sequence[int],
    padding: str,
    use_popcount: bool = False,
    flavor: str = "auto",
) -> torch.Tensor:
    """NHWC binary conv through the packed kernels (the JAX package's
    ``xnor_conv``), packing the quantized kernel (sign x per-output-channel
    scale, HWIO) at each call; float32 out.

    ``use_popcount`` runs K1 + K3 (or ``pack_bits`` + K5 under the
    "reference" flavor), SAME padding with ones; otherwise K4 on int8
    activations, exact against the float conv. Under autograd the
    gradients are those of the float function the op equals (see
    :class:`_XnorConv`), so the quantizers' straight-through gradients
    compose as on the "mxu" and "int8" paths."""
    strides = tuple(int(s) for s in strides)
    if torch.is_grad_enabled() and (x.requires_grad or q_kernel.requires_grad):
        return _XnorConv.apply(x, q_kernel, strides, padding, bool(use_popcount), flavor)
    packed, scale = pack_conv_kernel(q_kernel)
    return _packed_conv_forward(
        x, packed, scale, strides, padding, ci=x.shape[-1],
        use_popcount=use_popcount, flavor=flavor,
    )


def _float_dense_vjp(x, k, g, needs):
    """``(dx, dk)`` of ``[..., K] @ k.to(x.dtype)`` for the cotangent
    ``g`` in ``x``'s dtype; dk cast back to ``k``'s dtype."""
    dtype = x.dtype
    g2, _ = _flatten_leading(g.to(dtype))
    dx = dk = None
    if needs[0]:
        dx = (g2 @ k.to(dtype).t()).reshape(x.shape)
    if needs[1]:
        x2, _ = _flatten_leading(x)
        dk = (x2.t() @ g2).to(k.dtype)
    return dx, dk


class _XnorDense(torch.autograd.Function):
    """:func:`xnor_dense` on the differentiated path: the packed forward,
    the float matmul's VJP in ``x``'s dtype on the saved quantized
    operands."""

    @staticmethod
    def forward(ctx, x, q_kernel, use_popcount, flavor):
        ctx.save_for_backward(x, q_kernel)
        packed, scale = pack_dense_kernel(q_kernel)
        return _packed_dense_forward(
            x, packed, scale, k_true=q_kernel.shape[0], use_popcount=use_popcount,
            flavor=flavor,
        )

    @staticmethod
    def backward(ctx, g):
        x, q_kernel = ctx.saved_tensors
        dx, dk = _float_dense_vjp(x, q_kernel, g, ctx.needs_input_grad[:2])
        return dx, dk, None, None


# -- the int8 training conv --------------------------------------------------


def _int8_conv_forward(x_sign, k_sign, strides, padding, groups, scaled):
    """Exact integer sums of the rounded operands, then the optional
    per-output-channel scale, as float32. The sums run in a float conv:
    the operands are in {-1, 0, +1} and ``|sum| <= kh*kw*ci``, far below
    2^24, so float32 accumulation is exact on the card (also in TF32,
    where ±1 is exact); the CPU sums in float64."""
    if scaled:
        # Kernel contract: sign x per-output-channel scale. Dividing by
        # the channel max recovers exact {-1, 0, +1}; the scale re-applies
        # to the integer sums with one rounding.
        kscale = k_sign.abs().amax(dim=tuple(range(k_sign.dim() - 1)))
        safe = torch.where(kscale > 0, kscale, torch.ones_like(kscale))
        k8 = torch.round(k_sign / safe)
    else:
        k8 = torch.round(k_sign)
    # round, not sign: a literal 0 (SAME padding) stays 0.
    x8 = torch.round(x_sign)
    acc = torch.float64 if x_sign.device.type == "cpu" else torch.float32
    out = float_conv(x8.to(acc), k8, strides, padding, groups).to(torch.float32)
    return out * safe.to(torch.float32) if scaled else out


class _Int8Conv(torch.autograd.Function):
    """:func:`int8_conv` on the differentiated path: the float conv's
    VJP in ``x_sign``'s dtype. With ``pack_residuals`` the context keeps
    only K6's sign words, the input's trailing shape and dtype, and
    ``k_sign``; the backward rebuilds ``x_sign`` with K7."""

    @staticmethod
    def forward(ctx, x_sign, k_sign, strides, padding, groups, scaled, pack_residuals):
        y = _int8_conv_forward(x_sign, k_sign, strides, padding, groups, scaled)
        if pack_residuals:
            ctx.save_for_backward(pack_resid(x_sign), k_sign)
            ctx.x_meta = (tuple(x_sign.shape[1:]), x_sign.dtype)
        else:
            ctx.save_for_backward(x_sign, k_sign)
        ctx.conf = (strides, padding, groups, pack_residuals)
        return y

    @staticmethod
    def backward(ctx, g):
        strides, padding, groups, pack_residuals = ctx.conf
        if pack_residuals:
            words, k_sign = ctx.saved_tensors
            tail, dtype = ctx.x_meta
            x_sign = unpack_resid_pm1(words, (g.shape[0], *tail), dtype)
        else:
            x_sign, k_sign = ctx.saved_tensors
        dx, dk = _float_conv_vjp(
            x_sign, k_sign, g.to(x_sign.dtype), strides, padding, groups,
            ctx.needs_input_grad[:2],
        )
        return (
            None if dx is None else dx.to(x_sign.dtype),
            None if dk is None else dk.to(k_sign.dtype),
            None, None, None, None, None,
        )


def int8_conv(
    x_sign: torch.Tensor,
    k_sign: torch.Tensor,
    strides: Sequence[int],
    padding: str,
    groups: int = 1,
    scaled: bool = True,
    pack_residuals: bool = False,
) -> torch.Tensor:
    """Channels-last conv of quantized operands (1-D, 2-D NHWC or 3-D;
    the rank is the kernel's) with exact integer accumulation, returned as
    float32 (the JAX package's ``int8_conv``).

    ``x_sign`` holds exact small integers ({-1, 0, +1}); ``k_sign`` (HWIO)
    is sign x per-output-channel scale (``scaled``) or pure {-1, 0, +1}
    (``scaled=False`` skips the scale extraction). ``groups`` gives a
    grouped conv. The gradients are the float conv's, in ``x_sign``'s
    dtype. ``pack_residuals=True`` stores the activation residual at 1 bit
    per value between forward and backward (K6, then K7 in the backward):
    it needs strictly ±1 inputs, since a 0 would come back as +1.
    Without a gradient to take, only the forward runs (nothing is
    packed)."""
    strides = tuple(int(s) for s in strides)
    if torch.is_grad_enabled() and (x_sign.requires_grad or k_sign.requires_grad):
        return _Int8Conv.apply(
            x_sign, k_sign, strides, padding, int(groups), bool(scaled),
            bool(pack_residuals),
        )
    return _int8_conv_forward(x_sign, k_sign, strides, padding, int(groups), bool(scaled))


# -- the transposed conv (float and int8) ----------------------------------


def float_conv_transpose(
    x: torch.Tensor, k: torch.Tensor, strides: Sequence[int], padding,
) -> torch.Tensor:
    """JAX's ``lax.conv_transpose`` (``transpose_kernel=False``) over
    channels-last ``x`` with the un-flipped ``[*spatial, I, O]`` kernel cast
    to ``x``'s dtype: ``x`` dilated by ``strides`` (zeros between its
    values), padded as the transposed conv pads (SAME/VALID of the forward
    conv, or explicit pads of the transposed one), then a stride-1 conv.
    Differentiable by autograd."""
    rank = k.dim() - 2
    strides = tuple(int(s) for s in strides)
    spatial = x.shape[1:-1]
    dilated = [(n - 1) * s + 1 for n, s in zip(spatial, strides)]
    xd = x.new_zeros((x.shape[0], *dilated, x.shape[-1]))
    xd[(slice(None),) + tuple(slice(None, None, s) for s in strides)] = x
    if isinstance(padding, str):
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"Unsupported padding {padding!r} (SAME/VALID or explicit pads).")
        pads = []
        for kk, s in zip(k.shape[:rank], strides):
            if padding == "SAME":
                total = kk + s - 2
                lo = kk - 1 if s > kk - 1 else -(-total // 2)
            else:
                total = kk + s - 2 + max(kk - s, 0)
                lo = kk - 1
            pads.append((lo, total - lo))
    else:
        pads = padding
    return float_conv(xd, k, (1,) * rank, pads)


def _int8_conv_transpose_forward(x_sign, k_sign, strides, padding, scaled):
    """Exact integer sums of the rounded operands through
    :func:`float_conv_transpose` (float64 on the CPU, float32 on the card:
    exact for these small sums), then the optional per-output-channel
    scale, as float32 (the JAX package's int32 accumulation, one scale
    multiply)."""
    if scaled:
        kscale = k_sign.abs().amax(dim=tuple(range(k_sign.dim() - 1)))
        safe = torch.where(kscale > 0, kscale, torch.ones_like(kscale))
        k8 = torch.round(k_sign / safe)
    else:
        k8 = torch.round(k_sign)
    x8 = torch.round(x_sign)
    acc = torch.float64 if x_sign.device.type == "cpu" else torch.float32
    out = float_conv_transpose(x8.to(acc), k8, strides, padding).to(torch.float32)
    return out * safe.to(torch.float32) if scaled else out


class _Int8ConvTranspose(torch.autograd.Function):
    """:func:`int8_conv_transpose` on the differentiated path: the VJP of
    :func:`float_conv_transpose` in ``x_sign``'s dtype."""

    @staticmethod
    def forward(ctx, x_sign, k_sign, strides, padding, scaled):
        ctx.save_for_backward(x_sign, k_sign)
        ctx.conf = (strides, padding)
        return _int8_conv_transpose_forward(x_sign, k_sign, strides, padding, scaled)

    @staticmethod
    def backward(ctx, g):
        x_sign, k_sign = ctx.saved_tensors
        strides, padding = ctx.conf
        with torch.enable_grad():
            x = x_sign.detach().requires_grad_()
            k = k_sign.detach().requires_grad_()
            y = float_conv_transpose(x, k, strides, padding)
            dx, dk = torch.autograd.grad(y, (x, k), g.to(x_sign.dtype))
        return dx.to(x_sign.dtype), dk.to(k_sign.dtype), None, None, None


def int8_conv_transpose(
    x_sign: torch.Tensor, k_sign: torch.Tensor, strides: Sequence[int], padding,
    scaled: bool = True,
) -> torch.Tensor:
    """Channels-last transposed conv of quantized operands with exact
    integer accumulation, float32 out (the JAX package's
    ``int8_conv_transpose``; any spatial rank): inputs in {-1, 0, +1}, the
    kernel sign x per-output-channel scale (``scaled``) or pure {-1, 0,
    +1}. The gradients are :func:`float_conv_transpose`'s."""
    strides = tuple(int(s) for s in strides)
    if torch.is_grad_enabled() and (x_sign.requires_grad or k_sign.requires_grad):
        return _Int8ConvTranspose.apply(x_sign, k_sign, strides, padding, bool(scaled))
    return _int8_conv_transpose_forward(x_sign, k_sign, strides, padding, bool(scaled))


# -- the int8 training dense --------------------------------------------------


def _int8_dense_forward(x_sign, k_sign, scaled):
    """Exact integer sums of the rounded operands ``[..., K] @ [K, N]``,
    then the optional per-output-channel scale, as float32: the float
    matmul is exact for operands in {-1, 0, +1} and |sums| <= K, far
    below 2^24 (float32 on the card, float64 on the CPU)."""
    if scaled:
        kscale = k_sign.abs().amax(dim=0)
        safe = torch.where(kscale > 0, kscale, torch.ones_like(kscale))
        k8 = torch.round(k_sign / safe)
    else:
        k8 = torch.round(k_sign)
    x2, lead = _flatten_leading(torch.round(x_sign))
    acc = torch.float64 if x_sign.device.type == "cpu" else torch.float32
    out = torch.matmul(x2.to(acc), k8.to(acc)).to(torch.float32).reshape(*lead, -1)
    return out * safe.to(torch.float32) if scaled else out


class _Int8Dense(torch.autograd.Function):
    """:func:`int8_dense` on the differentiated path: the float matmul's
    VJP in ``x_sign``'s dtype (dk cast back to ``k_sign``'s)."""

    @staticmethod
    def forward(ctx, x_sign, k_sign, scaled):
        ctx.save_for_backward(x_sign, k_sign)
        return _int8_dense_forward(x_sign, k_sign, scaled)

    @staticmethod
    def backward(ctx, g):
        x_sign, k_sign = ctx.saved_tensors
        dx, dk = _float_dense_vjp(x_sign, k_sign, g, ctx.needs_input_grad[:2])
        return dx, dk, None


def int8_dense(x_sign: torch.Tensor, k_sign: torch.Tensor, scaled: bool = True) -> torch.Tensor:
    """Dense layer of quantized operands with exact integer accumulation,
    float32 out (the JAX package's ``int8_dense``): ``x_sign`` in {-1, 0,
    +1}, ``k_sign`` [K, N] sign x per-output-channel scale (``scaled``) or
    pure {-1, 0, +1}. The gradients are the float matmul's, in
    ``x_sign``'s dtype."""
    if torch.is_grad_enabled() and (x_sign.requires_grad or k_sign.requires_grad):
        return _Int8Dense.apply(x_sign, k_sign, bool(scaled))
    return _int8_dense_forward(x_sign, k_sign, bool(scaled))
