// K5 and K2: the binary GEMM on bit-packed operands, unfused (K5) and with
// the per-output-channel scale epilogue (K2).
//
// Replaces zookeeper_tpu/ops/binary_compute.py `xnor_matmul_packed` (K5,
// Pallas body `_xnor_kernel`) and `xnor_matmul_packed_scaled` (K2, body
// `_xnor_scaled_kernel`). a [M, Kw] and b [Kw, N] int32 are packed along K
// (bit t of word w is element 32w + t, the wire format of `pack_bits`).
// Each output is `k_true - 2 * sum_w popcount(a[m, w] ^ b[w, n])`: K5
// writes it as int32; K2 writes `__fmul_rn((float)(k_true - 2*acc),
// scale[n])` as fp32, one multiply that no contraction can fuse, so K2 is
// bit for bit K5's output `.float() * scale`. K padding of equal bits on
// both sides adds no mismatch, so the kernels never pad: they bounds-check
// the ragged M, N and Kw tails themselves.
//
// Bound on an H100: bytes for the dense layers at M = batch (b is read
// once: 4.7 MB at K 9216, N 4096, against ~0.3 us of popcount work at
// the int8 peak); operations only at large M (the conv-as-GEMM schedules,
// whose b is a few hundred kB and stays in L2).
//
// Two designs, chosen by M in the C entry point (`variant`):
//   "popc" (M <= 64, and K2 at every M): `xnor_gemm_kernel`, XOR and
//     popcount on the CUDA cores. A block of 4 warps owns 32 output
//     columns and BM rows. Inside a warp, 8 lanes cover 8 neighbouring
//     columns and the warp's 4 lane groups split K word by word, so one
//     load instruction reads 4 rows of b x 32 contiguous bytes: every
//     32-byte sector is used whole, and each b word is read once per M
//     tile. The A tile (BM rows x KT words) is staged in shared memory,
//     K-major, and read back as 16-byte vectors broadcast to the 8 lanes
//     of a group. Each thread keeps BM int32 accumulators in registers;
//     the 4 partial sums of a column are joined by two xor-shuffles. BM
//     is 8 for small M (the dense layers) and 32 for K2's large M.
//   "mma" (K5 at M > 64, the conv GEMMs): `__popc` on the CUDA cores runs
//     at 16 a clock per SM, about 1/8 of the int8 tensor-core rate in
//     binary products. So both operands are decoded to +-1 bytes in
//     shared memory by producer warps and multiplied on the int8 tensor
//     cores by consumer warps in the block-tile GEMM of mma_s8.cuh
//     (`mma.sync.m16n8k32` s8 -> s32), the design K4 runs at large M.
//     The full padded dot over 32 Kw values is 32 Kw - 2 mismatches
//     whatever the pad bits are, so the epilogue subtracts
//     32 Kw - k_true.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // 128
constexpr int COLS = WARPS * 8;      // 32 output columns per block
constexpr int SLICES = 4;            // K word slices per warp
constexpr int KT = 128;              // K words staged per step
constexpr int POPC_M_MAX = 64;       // K5 takes the tensor cores past this M

template <int BM, bool SCALED>
__global__ void __launch_bounds__(THREADS)
xnor_gemm_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int m, int n, int kw, int k_true) {
  // a_s[t][BM + 4]: K-major, 4 words of padding per row so the 4 lane
  // groups' vector reads of neighbouring words fall in distinct banks.
  constexpr int STRIDE = BM + 4;
  __shared__ __align__(16) uint32_t a_s[KT * STRIDE];

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slice = lane / 8;
  const int col = blockIdx.y * COLS + warp * 8 + lane % 8;
  const bool live_col = col < n;

  uint32_t acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0u;

  for (int k0 = 0; k0 < kw; k0 += KT) {
    const int kt = min(KT, kw - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < BM * KT; e += THREADS) {
      const int r = e / KT;
      const int t = e % KT;
      uint32_t v = 0u;
      if (m0 + r < m && t < kt) {
        v = a[static_cast<long long>(m0 + r) * kw + k0 + t];
      }
      a_s[t * STRIDE + r] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = slice; t < kt; t += SLICES) {
      const uint32_t bw =
          live_col ? b[static_cast<long long>(k0 + t) * n + col] : 0u;
      const uint4* row = reinterpret_cast<const uint4*>(a_s + t * STRIDE);
#pragma unroll
      for (int i = 0; i < BM / 4; ++i) {
        const uint4 av = row[i];
        acc[4 * i + 0] += __popc(av.x ^ bw);
        acc[4 * i + 1] += __popc(av.y ^ bw);
        acc[4 * i + 2] += __popc(av.z ^ bw);
        acc[4 * i + 3] += __popc(av.w ^ bw);
      }
    }
  }

  // Join the 4 slices' partial sums (lanes 8 and 16 apart); every lane
  // then holds its column's total and slice s writes rows r = s mod 4.
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
  if (!live_col) return;
  const float sc = SCALED ? scale[col] : 0.0f;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    if ((i % SLICES) != slice || m0 + i >= m) continue;
    const int dot = k_true - 2 * static_cast<int>(acc[i]);
    const long long idx = static_cast<long long>(m0 + i) * n + col;
    if (SCALED) {
      static_cast<float*>(out)[idx] = __fmul_rn(__int2float_rn(dot), sc);
    } else {
      static_cast<int*>(out)[idx] = dot;
    }
  }
}

template <bool SCALED>
int launch(const void* a, const void* b, const void* scale, void* out, int m,
           int n, int kw, int k_true, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  const unsigned col_blocks = (n + COLS - 1) / COLS;
  if (col_blocks > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= POPC_M_MAX) {
    const dim3 grid((m + 7) / 8, col_blocks);
    xnor_gemm_kernel<8, SCALED><<<grid, THREADS, 0, st>>>(ap, bp, sp, out, m, n, kw, k_true);
  } else if constexpr (SCALED) {
    const dim3 grid((m + 31) / 32, col_blocks);
    xnor_gemm_kernel<32, SCALED><<<grid, THREADS, 0, st>>>(ap, bp, sp, out, m, n, kw, k_true);
  } else {
    return s8::launch_tile_gemm<true>(a, b, out, m, n, kw, 32 * kw - k_true, device, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5's design: 0 "mma", 1 "popc"; -1 for a shape no kernel takes.
int variant(int m, int n, int kw) {
  if (m <= 0 || n <= 0 || kw < 0) return -1;
  return m <= POPC_M_MAX ? 1 : 0;
}

}  // namespace

// Which design K5 takes (see `variant`); K2 always takes "popc".
extern "C" int zk_xnor_matmul_packed_variant(int m, int n, int kw) { return variant(m, n, kw); }

// K5: a [m, kw], b [kw, n] int32, contiguous; out [m, n] int32.
// Returns a cudaError_t.
extern "C" int zk_xnor_matmul_packed(const void* a, const void* b, void* out,
                                     int m, int n, int kw, int k_true,
                                     int device, void* stream) {
  return launch<false>(a, b, nullptr, out, m, n, kw, k_true, device, stream);
}

// K2: the same operands and scale [n] float32; out [m, n] float32.
extern "C" int zk_xnor_matmul_packed_scaled(const void* a, const void* b,
                                            const void* scale, void* out,
                                            int m, int n, int kw, int k_true,
                                            int device, void* stream) {
  if (scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(a, b, scale, out, m, n, kw, k_true, device, stream);
}
