// K3: popcount convolution on packed operands, with the scale epilogue.
//
// Replaces zookeeper_tpu/ops/binary_compute.py `_conv_gemm_popcount`
// (Pallas body `_conv_gemm_kernel`):
//   xq    [B, Hp, Wp, ciw] int32  sign bits of the one-padded input
//   w     [kh, kw, ciw, co] int32 packed +-1 weights
//   scale [co] fp32
//   out   [B, Ho, Wo, co] fp32 =
//       (k_true - 2 * sum_{dy,dx,t} popc(x[ho*sh+dy, wo*sw+dx, t] ^ w[dy,dx,t]))
//       * scale
// with Ho = (Hp - kh) / sh + 1, Wo = (Wp - kw) / sw + 1 (VALID on the
// padded input; the caller pads SAME with ones before packing).
//
// Bound on an H100: operations. Each output is a +-1 dot over kh*kw*ci
// values, while the bytes moved are small (1-bit operands, fp32 output);
// the cheapest unit that computes the +-1 products is the int8 tensor
// core.
//
// Design: an implicit GEMM on the int8 tensor cores, the block-tile GEMM
// of mma_s8.cuh (`conv_gemm_s8_kernel`). M rows of output pixels, N = co,
// K = kh*kw*ciw words; B is `w` as it lies ([kh*kw*ciw, co] packed
// words). A is never materialised: its word (m, k) sits at xq[base(m) +
// koff[k]], base(m) = ((b*Hp + ho*sh)*Wp + wo*sw)*ciw and koff[(dy*kw +
// dx)*ciw + t] = (dy*Wp + dx)*ciw + t (a table the wrapper keeps on the
// device per geometry), so the producer warps gather the taps word by
// word in their 4-byte `cp.async` copies (a K stage of 4 words may cross
// taps when ciw is not a multiple of 4) and decode them to +-1 bytes.
// The full dot over 32 Kw values is 32 Kw - 2 mismatches whatever the
// pad bits, so the epilogue writes __fmul_rn((float)(dot - (32 Kw -
// k_true)), scale[n]) as fp32 straight into [B, Ho, Wo, co]: exact
// integers and one fp32 multiply (no FMA contraction), the plain
// version's operation, so the result is bit-identical to it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

// xq [batch, hp, wp, ciw], w [kh, kw, ciw, co] int32 and scale [co]
// float32, contiguous; koff [kh*kw*ciw] int32 (see the file comment);
// out [batch, ho, wo, co] float32. Returns a cudaError_t.
extern "C" int zk_conv_gemm_popcount(const void* xq, const void* w, const void* scale,
                                     const void* koff, void* out, int batch, int hp, int wp,
                                     int ciw, int kh, int kw, int co, int sh, int sw, int ho,
                                     int wo, int k_true, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || ho <= 0 || wo <= 0 || co <= 0) return 0;
  const long long m = static_cast<long long>(batch) * ho * wo;
  if (m > 0x7fffffffLL || koff == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int kw_total = kh * kw * ciw;
  const s8::ConvGeom g{static_cast<const int32_t*>(koff), static_cast<const float*>(scale),
                       hp, wp, ciw, ho, wo, sh, sw};
  return s8::launch_tile_gemm<true, true>(xq, w, out, static_cast<int>(m), co, kw_total,
                                          32 * kw_total - k_true, device,
                                          static_cast<cudaStream_t>(stream), g);
}
