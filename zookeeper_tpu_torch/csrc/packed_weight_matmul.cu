// K4: int8 activations times bit-packed +-1 weights, int32 accumulation.
//
// Replaces zookeeper_tpu/ops/binary_compute.py `packed_weight_matmul`
// (Pallas body `_pw_kernel`):
//   a   [M, K] int8 with values in {-1, 0, +1}, K = 32 * Kw
//   b   [Kw, N] int32, bit r of word t is the sign of weight row 32t + r
//       (1 -> +1, 0 -> -1)
//   out [M, N] int32 = a @ unpack(b)
//
// Bound on an H100: memory. At large M (the packed QuickNet's fused-tap
// conv GEMMs) A is the materialised im2col patch matrix and the int32
// output, while the weights arrive 32x compressed; at M = batch (the
// packed dense stage) the weights are the bytes (4.7 MB at K 9216, N
// 4096). The products run on the int8 tensor cores (`mma.sync.m16n8k32`
// s8 x s8 -> s32, helpers in mma_s8.cuh): every sum is an exact integer,
// so the result is the same bits in any order. The caller pads K to a
// multiple of 32 with zeros on the A side, which contribute nothing
// whatever the padded weight bits decode to.
//
// Two designs, chosen by M in the C entry point (`variant`):
//   "mma" (M > 8): the block-tile GEMM of mma_s8.cuh. A 64 x 64 tile a
//     block (N 64 reads A once), A's rows in a ring of three 128-byte K
//     stages by 16-byte `cp.async`, each packed weight word loaded once
//     per block per stage and decoded to +-1 bytes in shared memory, as
//     the TPU kernel decodes a weight slab into VMEM scratch once per
//     (n, k). Producer warps copy and decode while consumer warps
//     multiply; where the tiles leave the card half empty (slice B's
//     last section: 56 tiles), a cluster of blocks splits K and joins
//     its sums through distributed shared memory.
//   "small_m" (M <= 8): out^T = unpack(b)^T a^T. The decoded weight
//     columns are the mma's A operand (16 columns a tile), decoded from
//     the packed words straight into the fragment registers; the <= 8
//     activation rows are its B operand (n8). K is permuted
//     consistently on both sides (a sum is the same in any order): lane
//     group t of a product takes 8 values of its own word, so each lane
//     reads whole 16-byte vectors of 4 neighbouring columns' words. A
//     warp owns 64 columns and 4 K words, a block 4 warps on the same
//     columns and 16 K words; the grid splits K over many small blocks
//     (1152 at K 9216, N 4096), so the weights stream with many loads in
//     flight. The 4 warps join their sums in shared memory, and each
//     block adds its share into the output (zeroed first) with one
//     atomic per value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int SMALL_M_MAX = 8;  // "small_m": the rows fill one n8 operand
constexpr int SM_WARPS = 4;
constexpr int SM_COLS = 64;  // output columns a block (and a warp)
constexpr int SM_BLOCK_WORDS = SM_WARPS * 4;  // K words a block: 4 a warp

// M <= 8 activation rows, `vec` as `s8::load_cols` takes it.
__global__ void __launch_bounds__(SM_WARPS * 32)
packed_weight_matmul_small_m_kernel(const int8_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    int32_t* __restrict__ out, int m, int n, int kw,
                                    bool vec) {
  __shared__ int32_t part[8][SM_COLS];
  for (int e = threadIdx.x; e < 8 * SM_COLS; e += blockDim.x) (&part[0][0])[e] = 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * SM_COLS;
  // Lane group t takes K word wd (`s8::small_m_products` has the
  // layout), and the 32 activations of word wd for row g (zeros past m
  // or kw): x[2i], x[2i + 1] are values 8i..8i+3 and 8i+4..8i+7.
  const int wd = blockIdx.y * SM_BLOCK_WORDS + warp * 4 + t;
  const uint4 lo = s8::load_cols(b, wd, n0 + 4 * g, n, wd < kw, vec);
  const uint4 hi = s8::load_cols(b, wd, n0 + 32 + 4 * g, n, wd < kw, vec);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
  if (g < m && wd < kw) {
    const uint4* src = reinterpret_cast<const uint4*>(a + g * 32LL * kw + 32LL * wd);
    x0 = __ldg(src);
    x1 = __ldg(src + 1);
  }
  const uint32_t x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};

  int acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0;
  s8::small_m_products(acc, w, x);

  // acc[q]: rows 2t (c0, c2) and 2t + 1 (c1, c3) of columns 4g + q
  // (c0, c1) and 32 + 4g + q (c2, c3).
  __syncthreads();  // part is zeroed
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    atomicAdd(&part[2 * t][4 * g + q], acc[q][0]);
    atomicAdd(&part[2 * t + 1][4 * g + q], acc[q][1]);
    atomicAdd(&part[2 * t][32 + 4 * g + q], acc[q][2]);
    atomicAdd(&part[2 * t + 1][32 + 4 * g + q], acc[q][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 8 * SM_COLS; e += blockDim.x) {
    const int row = e / SM_COLS;
    const int col = n0 + e % SM_COLS;
    if (row < m && col < n) {
      atomicAdd(out + static_cast<long long>(row) * n + col, (&part[0][0])[e]);
    }
  }
}

// 0 "mma", 1 "small_m"; -1 for a shape no kernel takes.
int variant(int m, int n, int kw) {
  if (m <= 0 || n <= 0 || kw < 0) return -1;
  return m <= SMALL_M_MAX ? 1 : 0;
}

}  // namespace

// Which design a call takes (see `variant`).
extern "C" int zk_packed_weight_matmul_variant(int m, int n, int kw) { return variant(m, n, kw); }

// a: [m, 32*kw] int8 (16-byte aligned), b: [kw, n] int32,
// out: [m, n] int32. Returns a cudaError_t.
extern "C" int zk_packed_weight_matmul(const void* a, const void* b,
                                       void* out, int m, int n, int kw,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant(m, n, kw) == 0) {
    return s8::launch_tile_gemm<false>(a, b, out, m, n, kw, 0, device, st);
  }
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * sizeof(int32_t), st);
  if (err != cudaSuccess || kw == 0) return static_cast<int>(err);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((n + SM_COLS - 1) / SM_COLS, (kw + SM_BLOCK_WORDS - 1) / SM_BLOCK_WORDS);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  packed_weight_matmul_small_m_kernel<<<grid, SM_WARPS * 32, 0, st>>>(
      static_cast<const int8_t*>(a), static_cast<const uint32_t*>(b), static_cast<int32_t*>(out),
      m, n, kw, vec);
  return static_cast<int>(cudaGetLastError());
}
