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
// Three designs, chosen by M in the C entry point (`variant`):
//   "small_m" (M <= 8, K2 and K5: the dense layers at batch <= 8):
//     `xnor_gemm_small_m_kernel`, out^T = decode(b)^T decode(a)^T on the
//     int8 tensor cores (`mma.sync.m16n8k32` s8 -> s32) in K4's
//     "small_m" layout: the packed weight words are read as 16-byte
//     vectors of 4 neighbouring columns' words (`s8::load_cols`) and
//     decoded straight into the A-fragment registers, the <= 8 packed
//     activation rows into the n8 B operand; rows past m decode to zero
//     bytes, so they add nothing and are never written. The decode is two
//     instructions a register (`sign_bytes`: a shift and a `prmt` that
//     spreads 4 bits' signs over 4 bytes) where K4's +-1 bytes take five:
//     the weights enter as -x (x their bit), the activations as +-1 (Y),
//     and the +-1 dot sum (2x - 1) Y is -2 (the products) - (the row's
//     sum of Y, from popcounts). The full padded dot over 32 Kw values is
//     32 Kw - 2 mismatches, so the epilogue subtracts 32 Kw - k_true. A
//     block owns 64 columns; its 4 warps take 4 K words each a step, the
//     loads of the next step in flight, and add their sums in shared
//     memory. K is split over a cluster of up to 8 blocks of at least 2
//     steps each (512 blocks at Kw 288, N 4096); the cluster joins its
//     exact int32 sums through distributed shared memory (each block
//     stores its sum of a quad of outputs into the quad's owner, one
//     cluster barrier) before the one fp32 multiply, so K2 stays bit for
//     bit K5 `.float() * scale`, with no workspace, memset or second
//     launch.
//   "popc" (9 <= M <= 64, and K2 at every M past 8): `xnor_gemm_kernel`,
//     XOR and popcount on the CUDA cores. A block of 4 warps owns 32
//     output columns and BM rows. Inside a warp, 8 lanes cover 8
//     neighbouring columns and the warp's 4 lane groups split K word by
//     word, so one load instruction reads 4 rows of b x 32 contiguous
//     bytes: every 32-byte sector is used whole, and each b word is read
//     once per M tile. The A tile (BM rows x KT words) is staged in
//     shared memory, K-major, and read back as 16-byte vectors broadcast
//     to the 8 lanes of a group. Each thread keeps BM int32 accumulators
//     in registers; the 4 partial sums of a column are joined by two
//     xor-shuffles. BM is 8 up to M 64 and 32 for K2's larger M.
//   "mma" (K5 at M > 64, the conv GEMMs): `__popc` on the CUDA cores runs
//     at 16 a clock per SM, about 1/8 of the int8 tensor-core rate in
//     binary products. So both operands are decoded to +-1 bytes in
//     shared memory by producer warps and multiplied on the int8 tensor
//     cores by consumer warps in the block-tile GEMM of mma_s8.cuh
//     (`mma.sync.m16n8k32` s8 -> s32), the design K4 runs at large M,
//     with the same epilogue bias as "small_m".

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // 128
constexpr int COLS = WARPS * 8;      // 32 output columns per block
constexpr int SLICES = 4;            // K word slices per warp
constexpr int KT = 128;              // K words staged per step
constexpr int POPC_M_MAX = 64;       // K5 takes the tensor cores past this M
constexpr int SMALL_M_MAX = 8;       // "small_m": the rows fill one n8 operand
constexpr int SM_WARPS = 4;
constexpr int SM_THREADS = SM_WARPS * 32;
constexpr int SM_COLS = 64;                  // output columns a "small_m" block
constexpr int SM_STEP_WORDS = SM_WARPS * 4;  // K words a block step: 4 a warp
constexpr int SM_QUADS = 8 * SM_COLS / 4;    // int4 groups of a block's sums
constexpr int SM_CLUSTER_MAX = 8;            // the portable cluster size
constexpr int SM_MIN_STEPS = 2;              // steps a block takes at least, where it can
constexpr int SM_DEPTH = 2;                  // steps whose loads are in flight

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

// out[row, col..col+3] from the int32 dots v (K2: times scale, one
// rounding each); `quads`: N % 4 == 0, so the 4 columns are one vector.
template <bool SCALED>
__device__ __forceinline__ void store_quad(void* out, const float* __restrict__ scale, int4 v,
                                           int row, int col, int n, bool quads) {
  const long long idx = static_cast<long long>(row) * n + col;
  if constexpr (SCALED) {
    float* dst = static_cast<float*>(out) + idx;
    const float* sc = scale + col;
    if (quads) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(__fmul_rn(__int2float_rn(v.x), __ldg(sc)),
                      __fmul_rn(__int2float_rn(v.y), __ldg(sc + 1)),
                      __fmul_rn(__int2float_rn(v.z), __ldg(sc + 2)),
                      __fmul_rn(__int2float_rn(v.w), __ldg(sc + 3)));
    } else {
      dst[0] = __fmul_rn(__int2float_rn(v.x), __ldg(sc));
      if (col + 1 < n) dst[1] = __fmul_rn(__int2float_rn(v.y), __ldg(sc + 1));
      if (col + 2 < n) dst[2] = __fmul_rn(__int2float_rn(v.z), __ldg(sc + 2));
      if (col + 3 < n) dst[3] = __fmul_rn(__int2float_rn(v.w), __ldg(sc + 3));
    }
  } else {
    int* dst = static_cast<int*>(out) + idx;
    if (quads) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (col + 1 < n) dst[1] = v.y;
      if (col + 2 < n) dst[2] = v.z;
      if (col + 3 < n) dst[3] = v.w;
    }
  }
}

// Bits 8j + 7 - r of w, j = 0..3, as bytes j: 0xFF (-1) where set, 0x00
// where clear. `prmt` in its sign mode replicates the top bit of each
// byte of w << r over the byte.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t w, int r) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %1, 0xBA98;" : "=r"(d) : "r"(w << r));
  return d;
}

// One step of a lane's products (the layout of `s8::small_m_products`,
// with K permuted otherwise): product i takes shifts r = 2i (k-slots
// 4t..4t+3) and 2i + 1 (slots 16+4t..16+4t+3) of `sign_bytes`, so its
// k-slot 4t + j (or 16 + 4t + j) is bit 8j + 7 - r of the lane group's
// word on both sides. The weights enter as -x (x their bit: two
// instructions a register, where +-1 bytes take five), the activations
// of row g as +-1 (Y), zero bytes past m or kw (`live`). So acc gathers
// M = -sum x Y, s_row the row's sum S = sum Y, and the +-1 dot is
// sum (2x - 1) Y = -2 M - S.
__device__ __forceinline__ void small_m_step(int (&acc)[4][4], int& s_row, const uint32_t (&w)[8],
                                             uint32_t aw, bool live) {
  s_row += live ? 2 * __popc(aw) - 32 : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b0 = live ? ~sign_bytes(aw, 2 * i) | 0x01010101u : 0u;
    const uint32_t b1 = live ? ~sign_bytes(aw, 2 * i + 1) | 0x01010101u : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t af[4] = {sign_bytes(w[q], 2 * i), sign_bytes(w[4 + q], 2 * i),
                              sign_bytes(w[q], 2 * i + 1), sign_bytes(w[4 + q], 2 * i + 1)};
      s8::mma(acc[q], af, b0, b1);
    }
  }
}

// "small_m": M <= 8 rows, 64 columns a block (blockIdx.x), K split over
// gridDim.y blocks (blockIdx.y = z: steps [z S / cs, (z + 1) S / cs) of
// the S steps of SM_STEP_WORDS words; a warp takes 4 words of a step).
// The blocks of a column tile form a cluster, joined through distributed
// shared memory. `vec` as `s8::load_cols` takes it; bias = 32 kw - k_true.
template <bool SCALED>
__global__ void __launch_bounds__(SM_THREADS)
xnor_gemm_small_m_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                         const float* __restrict__ scale, void* __restrict__ out, int m, int n,
                         int kw, int bias, bool vec) {
  // Each warp's sums by quad (row, 4 columns), rows padded by a quad so
  // that a warp's quad stores fall in distinct banks; then the cs slots
  // of this block's share of the tile's quads, rank-major, at most
  // 128 + 5.
  __shared__ int4 warp_sums[SM_WARPS][8][SM_COLS / 4 + 1];
  __shared__ int4 slots_in[SM_QUADS + SM_CLUSTER_MAX];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * SM_COLS;
  const int cs = gridDim.y;
  const int z = blockIdx.y;
  const int steps = (kw + SM_STEP_WORDS - 1) / SM_STEP_WORDS;
  const int s_end = (z + 1) * steps / cs;
  int s = z * steps / cs;
  // The cluster join writes into the other blocks' shared memory, which
  // is there once each has started: each block says so now and waits for
  // the others only before those writes.
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // The lane's K word of each step: its 8 columns' weight words and row
  // g's activation word, loaded SM_DEPTH steps ahead of their products
  // (a ring of registers; zeros past the block's steps or kw).
  const uint32_t* arow = a + static_cast<long long>(g < m ? g : 0) * kw;
  const int wd0 = warp * 4 + t;
  uint4 lo[SM_DEPTH], hi[SM_DEPTH];
  uint32_t aw[SM_DEPTH];
  const auto load = [&](int d, int step) {
    const int wd = step * SM_STEP_WORDS + wd0;
    const bool live = step < s_end && wd < kw;
    lo[d] = s8::load_cols(b, wd, n0 + 4 * g, n, live, vec);
    hi[d] = s8::load_cols(b, wd, n0 + 32 + 4 * g, n, live, vec);
    aw[d] = live && g < m ? __ldg(arow + wd) : 0u;
  };
#pragma unroll
  for (int d = 0; d < SM_DEPTH; ++d) load(d, s + d);

  int acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0;
  int s_row = 0;
  for (; s < s_end; s += SM_DEPTH) {
#pragma unroll
    for (int d = 0; d < SM_DEPTH; ++d) {
      if (s + d >= s_end) break;
      const uint32_t w[8] = {lo[d].x, lo[d].y, lo[d].z, lo[d].w,
                             hi[d].x, hi[d].y, hi[d].z, hi[d].w};
      const bool x_live = g < m && (s + d) * SM_STEP_WORDS + wd0 < kw;
      small_m_step(acc, s_row, w, aw[d], x_live);
      load(d, s + d + SM_DEPTH);
    }
  }

  // The dots: D = M_SCALE M - S, S of row 2t (c0, c2) and 2t + 1 (c1,
  // c3) summed over the warp's 4 lane groups. acc[0..3][c] are 4
  // neighbouring columns: the lane holds the quads (2t, g), (2t + 1, g),
  // (2t, 8 + g) and (2t + 1, 8 + g) of the tile.
  constexpr int M_SCALE = -2;
  s_row += __shfl_xor_sync(0xffffffffu, s_row, 1);
  s_row += __shfl_xor_sync(0xffffffffu, s_row, 2);
  const int s_lo = __shfl_sync(0xffffffffu, s_row, 8 * t);
  const int s_hi = __shfl_sync(0xffffffffu, s_row, 8 * t + 4);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int sc = c & 1 ? s_hi : s_lo;
    warp_sums[warp][2 * t + (c & 1)][(c >> 1) * 8 + g] =
        make_int4(M_SCALE * acc[0][c] - sc, M_SCALE * acc[1][c] - sc,
                  M_SCALE * acc[2][c] - sc, M_SCALE * acc[3][c] - sc);
  }
  __syncthreads();

  // Quad e of the tile (row e / 16, columns 4 (e % 16)..+3), one a
  // thread: the block's sum over its warps.
  const int e = threadIdx.x;
  int4 sum = make_int4(0, 0, 0, 0);
  if (e < SM_QUADS) {
#pragma unroll
    for (int w = 0; w < SM_WARPS; ++w) {
      const int4 v = warp_sums[w][e / (SM_COLS / 4)][e % (SM_COLS / 4)];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
  }
  const bool quads = (n & 3) == 0;
  const auto finish = [&](int quad, int4 v) {
    const int row = quad / (SM_COLS / 4);
    const int col = n0 + 4 * (quad % (SM_COLS / 4));
    if (row < m && col < n) {
      store_quad<SCALED>(out, scale, make_int4(v.x - bias, v.y - bias, v.z - bias, v.w - bias),
                         row, col, n, quads);
    }
  };
  if (cs == 1) {
    if (e < SM_QUADS) finish(e, sum);
    return;
  }
  // The cluster join: block z owns quads [z Q / cs, (z + 1) Q / cs).
  // Each block stores its sum of a quad into slot (its rank) of the
  // owner's shared memory (a store into another block's shared memory
  // does not wait for an answer); after one cluster barrier each block
  // sums its slots locally and writes its quads.
  cg::cluster_group cluster = cg::this_cluster();
  const int share_max = (SM_QUADS + cs - 1) / cs;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (e < SM_QUADS) {
    const int owner = ((e + 1) * cs - 1) / SM_QUADS;
    cluster.map_shared_rank(slots_in, owner)[z * share_max + e - owner * SM_QUADS / cs] = sum;
  }
  cluster.sync();
  const int q0 = z * SM_QUADS / cs;
  if (e < (z + 1) * SM_QUADS / cs - q0) {
    int4 total = make_int4(0, 0, 0, 0);
    for (int rank = 0; rank < cs; ++rank) {
      const int4 v = slots_in[rank * share_max + e];
      total.x += v.x, total.y += v.y, total.z += v.z, total.w += v.w;
    }
    finish(q0 + e, total);
  }
}

// Column tiles and K split of a "small_m" launch: K over a cluster of at
// most 8 blocks of at least SM_MIN_STEPS steps each.
dim3 small_m_grid(int n, int kw) {
  const int steps = kw > 0 ? (kw + SM_STEP_WORDS - 1) / SM_STEP_WORDS : 1;
  const int split = steps / SM_MIN_STEPS;
  return dim3((n + SM_COLS - 1) / SM_COLS,
              split > SM_CLUSTER_MAX ? SM_CLUSTER_MAX : (split > 1 ? split : 1));
}

template <bool SCALED>
int launch_small_m(const uint32_t* a, const uint32_t* b, const float* scale, void* out, int m,
                   int n, int kw, int k_true, cudaStream_t stream) {
  const dim3 grid = small_m_grid(n, kw);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int bias = 32 * kw - k_true;
  if (grid.y == 1) {
    xnor_gemm_small_m_kernel<SCALED><<<grid, SM_THREADS, 0, stream>>>(a, b, scale, out, m, n, kw,
                                                                      bias, vec);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(SM_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, xnor_gemm_small_m_kernel<SCALED>, a, b, scale,
                                             out, m, n, kw, bias, vec));
}

template <bool SCALED>
int launch(const void* a, const void* b, const void* scale, void* out, int m,
           int n, int kw, int k_true, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= SMALL_M_MAX) {
    return launch_small_m<SCALED>(ap, bp, sp, out, m, n, kw, k_true, st);
  }
  const unsigned col_blocks = (n + COLS - 1) / COLS;
  if (col_blocks > 65535u) return static_cast<int>(cudaErrorInvalidValue);
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

// The design a call takes: 0 "mma" (K5 past M 64), 1 "popc" (K5 at M
// 9..64, K2 at every M past 8), 2 "small_m" (M <= 8); -1 for a shape
// no kernel takes.
int variant(bool scaled, int m, int n, int kw) {
  if (m <= 0 || n <= 0 || kw < 0) return -1;
  if (m <= SMALL_M_MAX) return 2;
  return scaled || m <= POPC_M_MAX ? 1 : 0;
}

}  // namespace

// Which design K5 and K2 take (see `variant`).
extern "C" int zk_xnor_matmul_packed_variant(int m, int n, int kw) {
  return variant(false, m, n, kw);
}
extern "C" int zk_xnor_matmul_packed_scaled_variant(int m, int n, int kw) {
  return variant(true, m, n, kw);
}

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

