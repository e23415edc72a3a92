// K9: flash attention forward, causal or full.
//
// Replaces zookeeper_tpu/ops/attention.py `_flash_forward` (Pallas body
// `kernel`, want_lse False or True): q, k, v [b, s, h, d] fp32/bf16 -> o
// [b, s, h, d] in the input dtype and, when an lse pointer is given, each
// row's log-sum-exp `m + log l` as fp32 [b*h, s] (JAX's [b*h, s_pad, 1]
// without the padded rows), the one residual the backward (K10, K11)
// needs beyond the primals. The output does not depend on the pointer:
// one compiled kernel serves both, the lse store behind a runtime test.
// Scores `(q . k) * scale` in fp32 with exact products; keys >= s and,
// when causal, keys > the query's row are set to the finite mask value;
// online softmax with the running max started at the mask value, sum
// and accumulator at 0; `p` rounded to the input dtype before `p @ v`
// (the sum `l` takes the unrounded `p`); the accumulator divided by `l`
// once at the end.
//
// Bound on an H100: operations. A causal call does 2 * b*h * d * s^2
// multiply-adds (q.k and p.v over half the square); the bytes (q, k, v
// read once, o written once) are a few MB.
//
// Three variants, chosen by `variant()` (mma_bf16.cuh; exported as
// zk_flash_forward_variant) from the dtype and head_dim, as the
// backward's:
//
// 1. Tensor cores (bf16, head_dim <= 128; prefill, eval and the LM
//    training forward): `flash_forward_mma_kernel`. Every product is an
//    `mma.sync.m16n8k16` of bf16 operands into fp32 accumulators (exact
//    products, as JAX's Precision.DEFAULT gives for bf16), at the bf16
//    tensor-core rate where an FMA loop tops out at the fp32 CUDA-core
//    rate (67 TFLOP/s, 15x below). A block of 4 warps owns 64 q rows,
//    16 a warp. Q's tile is copied once by `cp.async` and held as A
//    fragments in registers for every key tile. K and V come in 64-key
//    tiles, copied as bf16 by `cp.async` two stages deep (the next
//    tile's copy overlaps this tile's work; Q's copy borrows the second
//    stage), rows padded by 16 bytes so that `ldmatrix` reads no bank
//    twice, head_dims below the tile width (32, 64 or 128) zero-filled.
//    The loop is bound by instruction issue more than by the tensor
//    cores: every score costs a dozen CUDA-core instructions (the scale,
//    mask and max, the accurate `expf`, the sum, the rounding) beside its
//    share of an `mma`. So the tile copy keeps each thread's 16-byte
//    chunks fixed (`copy_rows16`).
//    Per tile a warp computes S = Q K^T by mma (K read by `ldmatrix` as
//    the B operand), then the online softmax on the accumulator
//    fragments: `__fmul_rn` by the scale (never contracted into the
//    subtraction), the masks (in a second copy of that loop, taken only
//    on tiles that cross the causal diagonal or the end), the row max
//    over the four lanes of a row by two xor-shuffles, the accurate
//    `expf`, each lane's share of `l`, and P rounded to bf16 and packed
//    in registers as the A operand of O += P V (V read by
//    `ldmatrix.trans`), the accumulator rescaled by `expf(m - m_new)`
//    first. The grid is (b*h, q tiles), the last (heaviest causal) q
//    tile first across all heads, so the longest blocks do not set the
//    tail. Only the order of the fp32 sums differs from the FMA kernel:
//    the four lanes of a row each keep a partial `l` over their columns,
//    joined at the end.
// 2. FMA (fp32 at head_dim <= 128): `flash_forward_kernel`. JAX runs
//    fp32 at Precision.HIGHEST, exact products, which TF32 tensor cores
//    would break. One block per (b*h, 64-row q tile), 256 threads, four
//    threads per q row. A thread keeps a quarter of its row's q and
//    accumulator in registers, in fp32. The TPU kernel's sequential k
//    grid axis becomes a loop inside the block over 32-key tiles that
//    stops at the causal diagonal, so masked tiles cost neither loads
//    nor compute. Each tile of K and V is widened to fp32 in shared
//    memory, zero-padded past head_dim (zeros add nothing to a dot
//    product or an accumulator). A score is four partial dot products
//    summed by two xor-shuffles among the row's four lanes, plain fp32
//    FMA (never TF32).
// 3. FMA wide (head_dim > 128, either dtype): `flash_forward_wide_kernel`,
//    the same block, tiles and numerics as 2, over chunks of 128 dims. A
//    score sums its partial products over every chunk of q and K (q's
//    chunk read into registers, K's widened into the same 32 x 128
//    shared tile, one chunk at a time); the output is produced one
//    128-dim chunk per pass over the keys, each pass recomputing the
//    same scores, softmax and `l` in the same order, so every chunk sees
//    identical weights. Shared memory stays 32 KiB (static) and
//    registers those of the 128-dim kernel whatever the head_dim; the
//    price is ceil(d / 128) score passes.
//
// Rows >= s are computed but never written (nor is their lse); no
// host-side padding is needed. q, k and v are read through their
// strides, so the split of a fused qkv projection needs no copy; the
// tensor-core kernel copies 16-byte chunks when head_dim, every stride
// and every base address allow it, else element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 32;            // keys per tile
constexpr int TPR = 4;            // threads per q row
constexpr int THREADS = BQ * TPR; // 256
constexpr float MASK_VALUE = -0.5f * FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a cast does
}

// `p.astype(v.dtype)`: bf16 inputs round p, fp32 inputs keep it.
__device__ __forceinline__ float round_p(float p, const float*) { return p; }
__device__ __forceinline__ float round_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

struct Strides {
  long long b, s, h;
};

// DP: head_dim padded to a multiple of 16 (32, 64 or 128).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s, int h, int d,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal) {
  constexpr int C4 = DP / 4 / TPR;  // float4 chunks per thread
  __shared__ float4 k_tile[BK][DP / 4];
  __shared__ float4 v_tile[BK][DP / 4];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = q0 + row;

  // This thread's dims: float4 chunks c = part + TPR * i, so the four
  // lanes of a row read 64 contiguous bytes of a tile row.
  float qv[C4 * 4];
  float acc[C4 * 4];
  const T* q_row = q + b * qs.b + static_cast<long long>(qi) * qs.s + hh * qs.h;
#pragma unroll
  for (int i = 0; i < C4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = 4 * (part + TPR * i) + j;
      qv[4 * i + j] = (qi < s && dd < d) ? to_float(q_row[dd]) : 0.0f;
      acc[4 * i + j] = 0.0f;
    }
  }
  float m = MASK_VALUE;
  float l = 0.0f;

  // Causal: keys past the tile's last row are masked for every row.
  const int k_end = causal ? min(s, q0 + BQ) : s;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int kr = e / DP;
      const int dd = e % DP;
      const int kj = k0 + kr;
      float kx = 0.0f, vx = 0.0f;
      if (kj < s && dd < d) {
        kx = to_float(k[b * ks.b + static_cast<long long>(kj) * ks.s + hh * ks.h + dd]);
        vx = to_float(v[b * vs.b + static_cast<long long>(kj) * vs.s + hh * vs.h + dd]);
      }
      reinterpret_cast<float*>(k_tile)[e] = kx;
      reinterpret_cast<float*>(v_tile)[e] = vx;
    }
    __syncthreads();

    float sc[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < C4; ++i) {
        const float4 kk = k_tile[j][part + TPR * i];
        dot = fmaf(qv[4 * i + 0], kk.x, dot);
        dot = fmaf(qv[4 * i + 1], kk.y, dot);
        dot = fmaf(qv[4 * i + 2], kk.z, dot);
        dot = fmaf(qv[4 * i + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      const bool valid = kj < s && (!causal || kj <= qi);
      sc[j] = valid ? dot * scale : MASK_VALUE;
      m_new = fmaxf(m_new, sc[j]);
    }
    const float corr = expf(m - m_new);
    float p_sum = 0.0f;
    float pv[C4 * 4];
#pragma unroll
    for (int i = 0; i < C4 * 4; ++i) pv[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sc[j] - m_new);
      p_sum += p;
      const float pr = round_p(p, q);
#pragma unroll
      for (int i = 0; i < C4; ++i) {
        const float4 vv = v_tile[j][part + TPR * i];
        pv[4 * i + 0] = fmaf(pr, vv.x, pv[4 * i + 0]);
        pv[4 * i + 1] = fmaf(pr, vv.y, pv[4 * i + 1]);
        pv[4 * i + 2] = fmaf(pr, vv.z, pv[4 * i + 2]);
        pv[4 * i + 3] = fmaf(pr, vv.w, pv[4 * i + 3]);
      }
    }
    m = m_new;
    l = l * corr + p_sum;
#pragma unroll
    for (int i = 0; i < C4 * 4; ++i) acc[i] = acc[i] * corr + pv[i];
  }

  if (qi < s) {
    T* o_row = o + ((static_cast<long long>(b) * s + qi) * h + hh) * d;
#pragma unroll
    for (int i = 0; i < C4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dd = 4 * (part + TPR * i) + j;
        if (dd < d) store(o_row + dd, acc[4 * i + j] / l);
      }
    }
    if (lse != nullptr && part == 0) {
      lse[static_cast<long long>(bh) * s + qi] = m + logf(l);
    }
  }
}

// Head_dim > 128: DC-dim chunks; see the file comment.
constexpr int DC = 128;

// Load chunk c (DC dims) of BK rows k0.. of one (batch, head) (element
// offset `base`, `row_stride` between rows) into `tile`, widened, zeros
// past s and d.
template <typename T>
__device__ __forceinline__ void load_chunk(float4 (*tile)[DC / 4], const T* x, long long base,
                                           long long row_stride, int k0, int c, int s,
                                           int d) {
  for (int e = threadIdx.x; e < BK * DC; e += THREADS) {
    const int kj = k0 + e / DC;
    const int dd = c * DC + e % DC;
    float val = 0.0f;
    if (kj < s && dd < d) val = to_float(x[base + static_cast<long long>(kj) * row_stride + dd]);
    reinterpret_cast<float*>(tile)[e] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_forward_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int s, int h, int d,
                          Strides qs, Strides ks, Strides vs, float scale,
                          int causal) {
  constexpr int C4 = DC / 4 / TPR;  // float4 chunks per thread per DC dims
  __shared__ float4 tile[BK][DC / 4];  // K's chunk, then V's

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = q0 + row;
  const int chunks = (d + DC - 1) / DC;
  const T* q_row = q + b * qs.b + static_cast<long long>(qi) * qs.s + hh * qs.h;
  const int k_end = causal ? min(s, q0 + BQ) : s;

  for (int oc = 0; oc < chunks; ++oc) {
    float acc[C4 * 4];
#pragma unroll
    for (int i = 0; i < C4 * 4; ++i) acc[i] = 0.0f;
    float m = MASK_VALUE;
    float l = 0.0f;

    for (int k0 = 0; k0 < k_end; k0 += BK) {
      float sc[BK];
#pragma unroll
      for (int j = 0; j < BK; ++j) sc[j] = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        __syncthreads();  // the previous tile is consumed
        load_chunk<T>(tile, k, b * ks.b + hh * ks.h, ks.s, k0, c, s, d);
        __syncthreads();
        float qv[C4 * 4];
#pragma unroll
        for (int i = 0; i < C4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int dd = c * DC + 4 * (part + TPR * i) + j;
            qv[4 * i + j] = (qi < s && dd < d) ? to_float(q_row[dd]) : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < BK; ++j) {
          float dot = sc[j];
#pragma unroll
          for (int i = 0; i < C4; ++i) {
            const float4 kk = tile[j][part + TPR * i];
            dot = fmaf(qv[4 * i + 0], kk.x, dot);
            dot = fmaf(qv[4 * i + 1], kk.y, dot);
            dot = fmaf(qv[4 * i + 2], kk.z, dot);
            dot = fmaf(qv[4 * i + 3], kk.w, dot);
          }
          sc[j] = dot;
        }
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        float dot = sc[j];
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kj = k0 + j;
        const bool valid = kj < s && (!causal || kj <= qi);
        sc[j] = valid ? dot * scale : MASK_VALUE;
        m_new = fmaxf(m_new, sc[j]);
      }
      const float corr = expf(m - m_new);
      __syncthreads();  // K's last chunk is consumed
      load_chunk<T>(tile, v, b * vs.b + hh * vs.h, vs.s, k0, oc, s, d);
      __syncthreads();
      float p_sum = 0.0f;
      float pv[C4 * 4];
#pragma unroll
      for (int i = 0; i < C4 * 4; ++i) pv[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(sc[j] - m_new);
        p_sum += p;
        const float pr = round_p(p, q);
#pragma unroll
        for (int i = 0; i < C4; ++i) {
          const float4 vv = tile[j][part + TPR * i];
          pv[4 * i + 0] = fmaf(pr, vv.x, pv[4 * i + 0]);
          pv[4 * i + 1] = fmaf(pr, vv.y, pv[4 * i + 1]);
          pv[4 * i + 2] = fmaf(pr, vv.z, pv[4 * i + 2]);
          pv[4 * i + 3] = fmaf(pr, vv.w, pv[4 * i + 3]);
        }
      }
      m = m_new;
      l = l * corr + p_sum;
#pragma unroll
      for (int i = 0; i < C4 * 4; ++i) acc[i] = acc[i] * corr + pv[i];
    }

    if (qi < s) {
      T* o_row = o + ((static_cast<long long>(b) * s + qi) * h + hh) * d;
#pragma unroll
      for (int i = 0; i < C4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int dd = oc * DC + 4 * (part + TPR * i) + j;
          if (dd < d) store(o_row + dd, acc[4 * i + j] / l);
        }
      }
      if (oc == 0 && lse != nullptr && part == 0) {
        lse[static_cast<long long>(bh) * s + qi] = m + logf(l);
      }
    }
  }
}


// `load_tile_bf16`'s 16-byte path for one K or V tile (MMA_KTILE rows
// r0.., zeros past s and d) with each thread's chunk column and rows
// fixed: a few instructions a chunk instead of a division, a 64-bit
// product and a bounds test each (the loop is issue-bound).
template <int DP>
__device__ __forceinline__ void copy_rows16(bf16* tile, const bf16* x, long long row_stride,
                                            int r0, int s, int d) {
  constexpr int CH = DP / 8;              // chunks a row
  constexpr int STEP = MMA_THREADS / CH;  // rows a pass
  static_assert(MMA_THREADS % CH == 0 && MMA_KTILE % STEP == 0, "whole passes");
  const int c = threadIdx.x % CH;
  const int r = threadIdx.x / CH;
  const bool col_live = c * 8 < d;
  const bf16* src = x + static_cast<long long>(r0 + r) * row_stride + c * 8;
  const uint32_t dst = smem_u32(tile + r * (DP + 8) + c * 8);
#pragma unroll
  for (int i = 0; i < MMA_KTILE / STEP; ++i) {
    const bool live = col_live && r0 + r + i * STEP < s;
    cp_async16(dst + i * STEP * (DP + 8) * sizeof(bf16),
               live ? src + i * STEP * row_stride : x, live);
  }
}

// K9 on tensor cores. DP: head_dim padded to 32, 64 or 128. Grid (b*h,
// q tiles), the last (heaviest causal) q tile first.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_forward_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int s, int h, int d, Strides qs, Strides ks,
                         Strides vs, float scale, int causal, int vec) {
  static_assert(MMA_ROWS == MMA_KTILE, "Q's tile is copied through a K stage");
  constexpr int PITCH = DP + 8;
  constexpr int K_TILE = MMA_KTILE * PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [2][64][PITCH]
  bf16* v_s = k_s + 2 * K_TILE;               // [2][64][PITCH]

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;

  const bf16* k_base = k + b * ks.b + hh * ks.h;
  const bf16* v_base = v + b * vs.b + hh * vs.h;
  auto load_kv = [&](int st, int k0) {
    if (vec) {
      copy_rows16<DP>(k_s + st * K_TILE, k_base, ks.s, k0, s, d);
      copy_rows16<DP>(v_s + st * K_TILE, v_base, vs.s, k0, s, d);
    } else {
      load_tile_bf16<MMA_KTILE, DP>(k_s + st * K_TILE, k_base, ks.s, k0, s, d, vec);
      load_tile_bf16<MMA_KTILE, DP>(v_s + st * K_TILE, v_base, vs.s, k0, s, d, vec);
    }
  };

  // Causal: keys past the tile's last row are masked for every row.
  const int k_end = causal ? min(s, q0 + MMA_ROWS) : s;
  const int n_tiles = (k_end + MMA_KTILE - 1) / MMA_KTILE;
  // Q through K's second stage (free until the loop's first copy), then
  // the first K/V tile; Q's fragments stay in registers for every tile.
  load_tile_bf16<MMA_ROWS, DP>(k_s + K_TILE, q + b * qs.b + hh * qs.h, qs.s, q0, s, d, vec);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) load_a(qa[c], k_s + K_TILE, PITCH, warp * 16, 16 * c, lane);
  __syncthreads();  // Q is read before the loop copies into its stage

  // This thread's two rows (lane / 4 and lane / 4 + 8 of its warp's 16),
  // their running max and this lane's share of their sums.
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int rows[2] = {row_lo, row_lo + 8};
  float m[2] = {MASK_VALUE, MASK_VALUE};
  float l[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * MMA_KTILE;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      load_kv((it + 1) & 1, k0 + MMA_KTILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + (it & 1) * K_TILE;
    const bf16* vt = v_s + (it & 1) * K_TILE;

    // S = Q K^T: 16 rows x 64 keys a warp.
    float sc[MMA_KTILE / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_KTILE / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
      for (int j = 0; j < MMA_KTILE / 8; j += 2) {
        uint32_t kb[4];
        load_bt(kb, kt, PITCH, 8 * j, 16 * c, lane);
        mma_bf16(sc[j], qa[c], kb[0], kb[1]);
        mma_bf16(sc[j + 1], qa[c], kb[2], kb[3]);
      }
    }

    // The online softmax on the accumulator fragments; P rounded to bf16
    // as the A operand of P V. Element e of n8 tile j: row rows[e / 2],
    // key k0 + 8j + 2t + e % 2. The masks are compiled into a second copy
    // of the loop, taken only where the tile crosses the causal diagonal
    // or the end.
    uint32_t pa[MMA_KTILE / 16][4];
    auto to_p = [&](auto masked) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < MMA_KTILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const bool valid =
              !decltype(masked)::value || (kj < s && (!causal || kj <= rows[e >> 1]));
          sc[j][e] = valid ? __fmul_rn(sc[j][e], scale) : MASK_VALUE;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < MMA_KTILE / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(sc[j][e] - mx[e >> 1]);
          sum[e >> 1] += p[e];
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      }
    };
    if ((causal && k0 + MMA_KTILE - 1 > q0) || k0 + MMA_KTILE > s) {
      to_p(std::true_type());
    } else {
      to_p(std::false_type());
    }

    // O += P V.
#pragma unroll
    for (int c = 0; c < MMA_KTILE / 16; ++c) {
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        uint32_t vb[4];
        load_b(vb, vt, PITCH, 16 * c, 8 * n, lane);
        mma_bf16(acc[n], pa[c], vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa[c], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the copy into it
  }

  // o = acc / l (a division, as JAX's), l summed over the row's lanes.
  const bool pairs = (d & 1) == 0;  // bf16 pairs are 4-byte aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lr = l[half];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = rows[half];
    if (row >= s) continue;
    bf16* dst = o + ((static_cast<long long>(b) * s + row) * h + hh) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= d) continue;
      const float x0 = acc[n][2 * half] / lr;
      const float x1 = acc[n][2 * half + 1] / lr;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[col] = __float2bfloat16(x0);
        if (col + 1 < d) dst[col + 1] = __float2bfloat16(x1);
      }
    }
    if (lse != nullptr && t == 0) lse[static_cast<long long>(bh) * s + row] = m[half] + logf(lr);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int b, s, h, d;
  Strides qs, ks, vs;
  float scale;
  int causal;
};

template <typename T, int DP>
void launch_fma(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.s + BQ - 1) / BQ, a.b * a.h);
  flash_forward_kernel<T, DP><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.s, a.h, a.d, a.qs, a.ks, a.vs, a.scale, a.causal);
}

template <typename T>
void launch_wide(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.s + BQ - 1) / BQ, a.b * a.h);
  flash_forward_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.s, a.h, a.d, a.qs, a.ks, a.vs, a.scale, a.causal);
}

template <int DP>
cudaError_t launch_mma_dp(const Args& a, cudaStream_t stream) {
  const int tiles = (a.s + MMA_ROWS - 1) / MMA_ROWS;
  if (tiles > 65535) return cudaErrorInvalidValue;
  // Two stages of K and V (Q's copy borrows one): 37 KB at head_dim 64,
  // 70 KB at 128, above the 48 KB a launch gets without opting in.
  constexpr int smem = 4 * MMA_KTILE * (DP + 8) * sizeof(bf16);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_forward_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = vec_copy_ok(a.d, {a.q, a.k, a.v}, {a.qs.b, a.qs.s, a.qs.h, a.ks.b, a.ks.s,
                                                     a.ks.h, a.vs.b, a.vs.s, a.vs.h});
  flash_forward_mma_kernel<DP><<<dim3(a.b * a.h, tiles), MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.s, a.h, a.d, a.qs,
      a.ks, a.vs, a.scale, a.causal, vec);
  return cudaGetLastError();
}

int run(const Args& a, int dtype_code, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.b <= 0 || a.s <= 0 || a.h <= 0 || a.d <= 0) return 0;
  if (a.b * a.h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant(dtype_code, a.d)) {
    case 2:
      if (a.d <= 32) return static_cast<int>(launch_mma_dp<32>(a, st));
      if (a.d <= 64) return static_cast<int>(launch_mma_dp<64>(a, st));
      return static_cast<int>(launch_mma_dp<128>(a, st));
    case 1:
      if (dtype_code == 0) {
        launch_wide<float>(a, st);
      } else {
        launch_wide<__nv_bfloat16>(a, st);
      }
      break;
    case 0:
      if (a.d <= 32) {
        launch_fma<float, 32>(a, st);
      } else if (a.d <= 64) {
        launch_fma<float, 64>(a, st);
      } else {
        launch_fma<float, 128>(a, st);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Strides are in elements, per
// tensor (batch, seq, head); the head_dim axis is contiguous. The output
// is a contiguous [b, s, h, d]; lse (may be null) a contiguous fp32
// [b*h, s]. Returns a cudaError_t.
extern "C" int zk_flash_forward(const void* q, const void* k, const void* v,
                                void* o, void* lse, int dtype_code, int b,
                                int s, int h,
                                int d, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, float scale, int causal,
                                int device, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), b, s, h, d,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, scale, causal};
  return run(a, dtype_code, device, stream);
}

// Which variant a call of this dtype code and head_dim launches: 0 FMA,
// 1 FMA wide, 2 tensor cores; -1 for a dtype code the kernels refuse.
extern "C" int zk_flash_forward_variant(int dtype_code, int d) {
  return variant(dtype_code, d);
}
