// K4: int8 activations times bit-packed +-1 weights, int32 accumulation.
//
// Replaces zookeeper_tpu/ops/binary_compute.py `packed_weight_matmul`
// (Pallas body `_pw_kernel`):
//   a   [M, K] int8 with values in {-1, 0, +1}, K = 32 * Kw
//   b   [Kw, N] int32, bit r of word t is the sign of weight row 32t + r
//       (1 -> +1, 0 -> -1)
//   out [M, N] int32 = a @ unpack(b)
//
// Bound on an H100: memory at the shapes the packed QuickNet serves. A is
// the materialised im2col patch matrix (kh*kw times the activation
// bytes), while the weights arrive 32x compressed.
//
// Design: a 64x64 output tile per block, 256 threads, each owning a 4x4
// sub-tile. The K loop walks one packed word (32 values of K) per step:
// the block copies its [64, 32] int8 A slab into shared memory as eight
// int32 words per row, and decodes its [32, 64] weight slab once into
// +-1 int8, four K values per int32, as the TPU kernel decodes once per
// (n, k) into scratch. The product is `__dp4a` (4 int8 products and an
// int32 add per instruction); sums stay exact in int32. The caller pads
// K to a multiple of 32 with zeros on the A side, which contributes
// nothing whatever the padded weight bits decode to.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kQuads = 8;  // int32 words of int8 per 32-value K step
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t decode_quad(uint32_t word, int q) {
  // Four sign bits -> four int8 lanes: bit set -> 0x01 (+1), clear ->
  // 0xFF (-1); byte j holds K index 4q + j (little-endian, as dp4a reads).
  const uint32_t nib = (word >> (4 * q)) & 0xFu;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v |= (((nib >> j) & 1u) ? 0x01u : 0xFFu) << (8 * j);
  }
  return static_cast<int32_t>(v);
}

__global__ void packed_weight_matmul_kernel(const int32_t* __restrict__ a,
                                            const uint32_t* __restrict__ b,
                                            int32_t* __restrict__ out, int m,
                                            int n, int kw) {
  __shared__ int32_t as[kTileM][kQuads + 1];  // +1: no bank conflicts
  __shared__ int32_t bs[kQuads][kTileN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const long long a_row_words = static_cast<long long>(kw) * kQuads;

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kt = 0; kt < kw; ++kt) {
    for (int i = threadIdx.x; i < kTileM * kQuads; i += blockDim.x) {
      const int r = i / kQuads;
      const int q = i - r * kQuads;
      const int gm = m0 + r;
      as[r][q] = gm < m ? a[gm * a_row_words + kt * kQuads + q] : 0;
    }
    for (int i = threadIdx.x; i < kQuads * kTileN; i += blockDim.x) {
      const int q = i / kTileN;
      const int c = i - q * kTileN;
      const int gn = n0 + c;
      const uint32_t word =
          gn < n ? b[static_cast<long long>(kt) * n + gn] : 0u;
      bs[q][c] = decode_quad(word, q);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      int32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) out[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

}  // namespace

// a: [m, 32*kw] int8 (4-byte aligned rows), b: [kw, n] int32,
// out: [m, n] int32. Returns a cudaError_t.
extern "C" int zk_packed_weight_matmul(const void* a, const void* b,
                                       void* out, int m, int n, int kw,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  // M tiles on x (no 65535 limit); neighbouring blocks share a weight
  // slab through L2.
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  packed_weight_matmul_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), m, n, kw);
  return static_cast<int>(cudaGetLastError());
}
