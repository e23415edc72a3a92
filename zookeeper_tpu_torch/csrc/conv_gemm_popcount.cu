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
// Bound on an H100: integer issue. Each 32-bit word of the contraction
// costs an XOR, a POPC and an ADD on the CUDA cores, while the bytes
// moved are small (1-bit operands, fp32 output).
//
// Design: one block per (co tile of 64, output row ho, image b). The
// block stages the co tile's packed weights [kh*kw*ciw][64] and the kh
// packed input rows that output row reads into shared memory once, so
// every word is read from device memory once per block. Thread c of each
// group of 64 owns output channel co0 + c and walks the output columns
// wo; the 64 threads of a group read consecutive weight words (no bank
// conflicts) and the same input word (a broadcast). The TPU kernel's
// sequential dy grid axis with a VMEM accumulator becomes a loop inside
// the block: nothing carries across blocks. The accumulator is an exact
// int32 and the epilogue is one fp32 multiply (`__fmul_rn`, no FMA
// contraction), the same operation as the plain version, so the result
// is bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCoTile = 64;
constexpr int kThreads = 256;

__global__ void conv_gemm_popcount_kernel(
    const int32_t* __restrict__ xq, const int32_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int hp, int wp,
    int ciw, int kh, int kw, int co, int sh, int sw, int ho_n, int wo_n,
    int k_true) {
  extern __shared__ int32_t smem[];
  const int tap_words = kh * kw * ciw;
  const int row_words = wp * ciw;
  int32_t* ws = smem;                       // [tap_words][kCoTile]
  int32_t* xs = smem + tap_words * kCoTile;  // [kh][row_words]

  const int co0 = blockIdx.x * kCoTile;
  const int ho = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = threadIdx.x; i < tap_words * kCoTile; i += blockDim.x) {
    const int r = i / kCoTile;
    const int c = i - r * kCoTile;
    ws[i] = (co0 + c < co) ? w[static_cast<long long>(r) * co + co0 + c] : 0;
  }
  const long long row0 =
      (static_cast<long long>(b) * hp + static_cast<long long>(ho) * sh) *
      row_words;
  for (int i = threadIdx.x; i < kh * row_words; i += blockDim.x) {
    xs[i] = xq[row0 + i];  // kh consecutive padded rows are contiguous
  }
  __syncthreads();

  const int c = threadIdx.x % kCoTile;
  if (co0 + c >= co) return;  // no barrier follows
  const float s = scale[co0 + c];
  const int groups = blockDim.x / kCoTile;
  float* out_row =
      out + (static_cast<long long>(b) * ho_n + ho) * wo_n * co + co0 + c;
  for (int wo = threadIdx.x / kCoTile; wo < wo_n; wo += groups) {
    int acc = 0;
    for (int dy = 0; dy < kh; ++dy) {
      for (int dx = 0; dx < kw; ++dx) {
        const int32_t* xr = xs + dy * row_words + (wo * sw + dx) * ciw;
        const int32_t* wr = ws + (dy * kw + dx) * ciw * kCoTile + c;
        for (int t = 0; t < ciw; ++t) {
          acc += __popc(xr[t] ^ wr[t * kCoTile]);
        }
      }
    }
    out_row[static_cast<long long>(wo) * co] =
        __fmul_rn(static_cast<float>(k_true - (acc + acc)), s);
  }
}

}  // namespace

// Shared memory the launch needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" long long zk_conv_gemm_popcount_smem(int wp, int ciw, int kh,
                                                int kw) {
  return (static_cast<long long>(kh) * kw * ciw * kCoTile +
          static_cast<long long>(kh) * wp * ciw) *
         static_cast<long long>(sizeof(int32_t));
}

// Returns a cudaError_t.
extern "C" int zk_conv_gemm_popcount(const void* xq, const void* w,
                                     const void* scale, void* out, int batch,
                                     int hp, int wp, int ciw, int kh, int kw,
                                     int co, int sh, int sw, int ho, int wo,
                                     int k_true, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || ho <= 0 || wo <= 0 || co <= 0) return 0;
  const long long smem = zk_conv_gemm_popcount_smem(wp, ciw, kh, kw);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conv_gemm_popcount_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((co + kCoTile - 1) / kCoTile, ho, batch);
  conv_gemm_popcount_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xq), static_cast<const int32_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), hp, wp, ciw,
      kh, kw, co, sh, sw, ho, wo, k_true);
  return static_cast<int>(cudaGetLastError());
}
