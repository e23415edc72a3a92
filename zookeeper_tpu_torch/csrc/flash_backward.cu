// K10 and K11: the flash attention backward, causal or full.
//
// Replace zookeeper_tpu/ops/attention.py `_flash_backward`: K10 its dQ
// kernel (`dq_kernel`, pallas_call at attention.py:1474), K11 its dK/dV
// kernel (`dkv_kernel`, :1492). Both recompute the probabilities from
// the forward's lse instead of storing them: with S = q . k in fp32
// (exact products), keys >= s and, when causal, keys > the query's row
// masked,
//
//   P  = exp(S * scale - lse), a hard 0 on masked entries
//   dS = P * (dO . v - D),  D = rowsum(dO * O) given by the caller
//   dQ = scale * sum_k round(dS) k            (K10)
//   dV = sum_q round(P) dO,  dK = scale * sum_q round(dS) q   (K11)
//
// `round` is the cast to the input dtype that JAX applies before each
// product (`ds.astype(k.dtype)`, `p.astype(do.dtype)`): bf16 inputs
// round, fp32 inputs keep the value. Sums are fp32; outputs are cast to
// the input dtype once, at the end. Every output tile has one writer (a
// loop inside its block takes the TPU grid's sequential axis): no
// atomics, and a call gives the same bits every time.
//
// Bound on an H100: operations. Per attended (q, k) pair K10 does 3d
// multiply-adds (S, dO.v, dS k) and K11 4d (S, dO.v, P dO, dS q): 14d
// flops together, where one fused kernel would do 10d (S and dO.v once)
// but needs atomic adds into dQ, whose order changes from run to run.
// The split is the price of repeatable bits. The bytes (q, k, v, dO,
// lse, D read once, the gradients written once) are a few MB.
//
// Three variants, chosen by `variant()` (mma_bf16.cuh; exported as
// zk_flash_backward_variant) from the dtype and head_dim:
//
// 1. Tensor cores (bf16, head_dim <= 128; the LM training path):
//    `flash_dq_mma_kernel`, `flash_dkv_mma_kernel`. Every product is an
//    `mma.sync.m16n8k16` of bf16 operands into fp32 accumulators, at the
//    bf16 tensor-core rate (989 TFLOP/s dense) where an FMA loop tops out
//    at the fp32 CUDA-core rate (67). Blocks of 4 warps own 64 output
//    rows, 16 per warp (K10: q rows; K11: key rows). The loop tiles (K10:
//    64 keys of K and V; K11: 64 or, at head_dim 128, 32 rows of Q and dO
//    with their lse and D) are copied as bf16 into shared memory by
//    `cp.async`, two stages deep, so the next tile's copy overlaps this
//    tile's products; rows are padded by 16 bytes so that the 8 rows an
//    `ldmatrix` reads fall in distinct banks. Head_dims below the tile
//    width (32, 64 or 128) are zero-filled. Per tile a warp computes S
//    and dP (K11: their transposes) by mma, P and dS elementwise on the
//    fp32 accumulator fragments (the masks in a second copy of that loop,
//    taken only on tiles that cross the causal diagonal or the end),
//    rounds dS (and P) to bf16 and repacks
//    them in registers as the A operand of the next mma (the m16n8k16
//    accumulator layout of two n8 tiles is the A layout of one k16 slice),
//    and adds dS K (K11: P^T dO and dS^T Q) with the B operand read by
//    `ldmatrix.trans`. The grid runs the heaviest causal tiles first
//    (K10 the last q tiles, K11 the first key tiles) across all heads,
//    so the longest blocks do not set the tail. Only the order of the
//    fp32 sums differs from the FMA kernels. What holds them above their
//    bound on the card is the elementwise work: per attended pair each
//    kernel runs an accurate `expf` and a dozen other instructions on the
//    CUDA cores, which the products of the same warp wait for
//    (`python -m zookeeper_tpu_torch.ablate` times them without it).
// 2. FMA (fp32 at head_dim <= 128): `flash_dq_kernel`,
//    `flash_dkv_kernel`. JAX runs fp32 at Precision.HIGHEST, exact
//    products, which TF32 tensor cores would break. One block per (b*h,
//    64-row tile), 256 threads, four threads per output row, each
//    holding a quarter of its row's operands and accumulators in fp32
//    registers; the loop tiles (32 rows) are widened to fp32 in shared
//    memory. A dot product is four partial sums joined by two
//    xor-shuffles; plain fp32 FMA, never TF32.
// 3. FMA wide (head_dim > 128, either dtype): `flash_dq_wide_kernel`,
//    `flash_dkv_wide_kernel`. The same blocks and numerics over chunks
//    of 128 dims, with loop tiles of 16 rows. Each row's S and dO . v
//    sum their partial products over every chunk (the register row's
//    chunk read from global memory, the tile's widened into shared
//    memory one chunk at a time); the gradients are produced one 128-dim
//    chunk per pass over the loop tiles, each pass recomputing the same
//    P and dS in the same order. Shared memory stays static (16 KiB) and
//    registers near those of the 128-dim kernels whatever the head_dim;
//    the price is ceil(d / 128) passes.
//
// q, k and v are read through their strides (the split of a fused qkv
// projection needs no copy); dO is a contiguous [b, s, h, d]; lse and D
// contiguous fp32 [b*h, s]. Rows >= s are computed as masked and never
// written. The tensor-core kernels copy 16-byte chunks when head_dim,
// every stride and every base address allow it, else element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = 64;            // output rows per block (q for K10, k for K11)
constexpr int TILE = 32;            // rows per loop tile (k for K10, q for K11)
constexpr int TPR = 4;              // threads per output row
constexpr int THREADS = ROWS * TPR; // 256

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a cast does
}

// The cast to the input dtype before a product: bf16 rounds, fp32 keeps.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

struct Strides {
  long long b, s, h;
};

// Load `TILE` rows of one (batch, head) starting at row `r0` (element
// offset `base`, `row_stride` between rows) into a fp32 shared tile,
// zeros past s and d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float4 (*tile)[DP / 4], const T* x,
                                          long long base, long long row_stride,
                                          int r0, int s, int d) {
  for (int e = threadIdx.x; e < TILE * DP; e += THREADS) {
    const int r = e / DP;
    const int dd = e % DP;
    const int ri = r0 + r;
    float val = 0.0f;
    if (ri < s && dd < d) {
      val = to_float(x[base + static_cast<long long>(ri) * row_stride + dd]);
    }
    reinterpret_cast<float*>(tile)[e] = val;
  }
}

// Load this thread's quarter of one row into fp32 registers.
template <typename T, int C4>
__device__ __forceinline__ void load_row(float* out, const T* row, bool live,
                                         int part, int d) {
#pragma unroll
  for (int i = 0; i < C4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = 4 * (part + TPR * i) + j;
      out[4 * i + j] = (live && dd < d) ? to_float(row[dd]) : 0.0f;
    }
  }
}

template <typename T, int C4>
__device__ __forceinline__ void store_row(T* row, const float* acc, float mul,
                                          int part, int d) {
#pragma unroll
  for (int i = 0; i < C4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = 4 * (part + TPR * i) + j;
      if (dd < d) store(row + dd, acc[4 * i + j] * mul);
    }
  }
}

// This thread's partial dot product of its register row with a shared
// tile row.
template <int C4>
__device__ __forceinline__ float partial_dot(const float* reg, const float4* tile_row,
                                             int part) {
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < C4; ++i) {
    const float4 t = tile_row[part + TPR * i];
    dot = fmaf(reg[4 * i + 0], t.x, dot);
    dot = fmaf(reg[4 * i + 1], t.y, dot);
    dot = fmaf(reg[4 * i + 2], t.z, dot);
    dot = fmaf(reg[4 * i + 3], t.w, dot);
  }
  return dot;
}

template <int C4>
__device__ __forceinline__ void axpy(float* acc, float a, const float4* tile_row, int part) {
#pragma unroll
  for (int i = 0; i < C4; ++i) {
    const float4 t = tile_row[part + TPR * i];
    acc[4 * i + 0] = fmaf(a, t.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(a, t.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, t.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, t.w, acc[4 * i + 3]);
  }
}

// K10. DP: head_dim padded to 32, 64 or 128.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int s, int h, int d, Strides qs, Strides ks,
                Strides vs, float scale, int causal) {
  constexpr int C4 = DP / 4 / TPR;
  __shared__ float4 k_tile[TILE][DP / 4];
  __shared__ float4 v_tile[TILE][DP / 4];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = blockIdx.x * ROWS;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + row;
  const bool live = qi < s;

  float qv[C4 * 4], dov[C4 * 4], acc[C4 * 4];
  const long long out_row = (static_cast<long long>(b) * s + qi) * h + hh;
  load_row<T, C4>(qv, q + b * qs.b + static_cast<long long>(qi) * qs.s + hh * qs.h,
                  live, part, d);
  load_row<T, C4>(dov, dout + out_row * d, live, part, d);
#pragma unroll
  for (int i = 0; i < C4 * 4; ++i) acc[i] = 0.0f;
  const long long stat = static_cast<long long>(bh) * s + qi;
  const float lse_i = live ? lse[stat] : 0.0f;
  const float d_i = live ? delta[stat] : 0.0f;

  // Causal: keys past the tile's last row are masked for every row.
  const int k_end = causal ? min(s, q0 + ROWS) : s;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<T, DP>(k_tile, k, b * ks.b + hh * ks.h, ks.s, k0, s, d);
    load_tile<T, DP>(v_tile, v, b * vs.b + hh * vs.h, vs.s, k0, s, d);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float dot = quad_sum(partial_dot<C4>(qv, k_tile[j], part));
      const float dp = quad_sum(partial_dot<C4>(dov, v_tile[j], part));
      const int kj = k0 + j;
      const bool valid = live && kj < s && (!causal || kj <= qi);
      const float p = valid ? expf(__fmul_rn(dot, scale) - lse_i) : 0.0f;
      const float ds = round_to(p * (dp - d_i), q);
      axpy<C4>(acc, ds, k_tile[j], part);
    }
  }
  if (live) store_row<T, C4>(dq + out_row * d, acc, scale, part, d);
}

// K11. DP: head_dim padded to 32, 64 or 128.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int s, int h, int d,
                 Strides qs, Strides ks, Strides vs, float scale, int causal) {
  constexpr int C4 = DP / 4 / TPR;
  __shared__ float4 q_tile[TILE][DP / 4];
  __shared__ float4 do_tile[TILE][DP / 4];
  __shared__ float lse_tile[TILE];
  __shared__ float d_tile[TILE];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int k0 = blockIdx.x * ROWS;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int kj = k0 + row;
  const bool live = kj < s;

  float kv[C4 * 4], vv[C4 * 4], dk_acc[C4 * 4], dv_acc[C4 * 4];
  load_row<T, C4>(kv, k + b * ks.b + static_cast<long long>(kj) * ks.s + hh * ks.h,
                  live, part, d);
  load_row<T, C4>(vv, v + b * vs.b + static_cast<long long>(kj) * vs.s + hh * vs.h,
                  live, part, d);
#pragma unroll
  for (int i = 0; i < C4 * 4; ++i) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }
  const long long stat0 = static_cast<long long>(bh) * s;

  // Causal: q rows above the tile's first key are masked for every key
  // (k0 is a multiple of TILE, so the loop starts on a tile boundary).
  for (int q0 = causal ? k0 : 0; q0 < s; q0 += TILE) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<T, DP>(q_tile, q, b * qs.b + hh * qs.h, qs.s, q0, s, d);
    load_tile<T, DP>(do_tile, dout, (static_cast<long long>(b) * s * h + hh) * d,
                     static_cast<long long>(h) * d, q0, s, d);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      lse_tile[threadIdx.x] = qi < s ? lse[stat0 + qi] : 0.0f;
      d_tile[threadIdx.x] = qi < s ? delta[stat0 + qi] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      const float dot = quad_sum(partial_dot<C4>(kv, q_tile[i], part));
      const float dp = quad_sum(partial_dot<C4>(vv, do_tile[i], part));
      const int qi = q0 + i;
      const bool valid = live && qi < s && (!causal || kj <= qi);
      const float p = valid ? expf(__fmul_rn(dot, scale) - lse_tile[i]) : 0.0f;
      axpy<C4>(dv_acc, round_to(p, q), do_tile[i], part);
      axpy<C4>(dk_acc, round_to(p * (dp - d_tile[i]), q), q_tile[i], part);
    }
  }
  if (live) {
    const long long out_row = (static_cast<long long>(b) * s + kj) * h + hh;
    store_row<T, C4>(dk + out_row * d, dk_acc, scale, part, d);
    store_row<T, C4>(dv + out_row * d, dv_acc, 1.0f, part, d);
  }
}

// Head_dim > 128: DC-dim chunks and WT-row loop tiles.
constexpr int DC = 128;
constexpr int WT = 16;
constexpr int WC4 = DC / 4 / TPR;  // float4 chunks per thread per DC dims

// Load WT rows r0.. of chunk c (DC dims) into a fp32 shared tile, zeros
// past s and d.
template <typename T>
__device__ __forceinline__ void load_chunk(float4 (*tile)[DC / 4], const T* x,
                                           long long base, long long row_stride,
                                           int r0, int c, int s, int d) {
  for (int e = threadIdx.x; e < WT * DC; e += THREADS) {
    const int r = e / DC;
    const int dd = c * DC + e % DC;
    const int ri = r0 + r;
    float val = 0.0f;
    if (ri < s && dd < d) {
      val = to_float(x[base + static_cast<long long>(ri) * row_stride + dd]);
    }
    reinterpret_cast<float*>(tile)[e] = val;
  }
}

// K10 for head_dim > 128.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, int s, int h, int d, Strides qs, Strides ks,
                     Strides vs, float scale, int causal) {
  __shared__ float4 k_tile[WT][DC / 4];
  __shared__ float4 v_tile[WT][DC / 4];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = blockIdx.x * ROWS;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + row;
  const bool live = qi < s;
  const int chunks = (d + DC - 1) / DC;

  const long long out_row = (static_cast<long long>(b) * s + qi) * h + hh;
  const T* q_row = q + b * qs.b + static_cast<long long>(qi) * qs.s + hh * qs.h;
  const T* do_row = dout + out_row * d;
  const long long stat = static_cast<long long>(bh) * s + qi;
  const float lse_i = live ? lse[stat] : 0.0f;
  const float d_i = live ? delta[stat] : 0.0f;
  const long long k_base = b * ks.b + hh * ks.h;
  const long long v_base = b * vs.b + hh * vs.h;
  const int k_end = causal ? min(s, q0 + ROWS) : s;

  for (int oc = 0; oc < chunks; ++oc) {
    float acc[WC4 * 4];
#pragma unroll
    for (int i = 0; i < WC4 * 4; ++i) acc[i] = 0.0f;
    for (int k0 = 0; k0 < k_end; k0 += WT) {
      float dot[WT], dp[WT];
#pragma unroll
      for (int j = 0; j < WT; ++j) dot[j] = dp[j] = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        __syncthreads();  // the previous tiles are consumed
        load_chunk<T>(k_tile, k, k_base, ks.s, k0, c, s, d);
        load_chunk<T>(v_tile, v, v_base, vs.s, k0, c, s, d);
        __syncthreads();
        float qv[WC4 * 4], dov[WC4 * 4];
        load_row<T, WC4>(qv, q_row + c * DC, live, part, d - c * DC);
        load_row<T, WC4>(dov, do_row + c * DC, live, part, d - c * DC);
#pragma unroll
        for (int j = 0; j < WT; ++j) {
          dot[j] += partial_dot<WC4>(qv, k_tile[j], part);
          dp[j] += partial_dot<WC4>(dov, v_tile[j], part);
        }
      }
      __syncthreads();  // the last chunk is consumed
      load_chunk<T>(k_tile, k, k_base, ks.s, k0, oc, s, d);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < WT; ++j) {
        const float sdot = quad_sum(dot[j]);
        const float sdp = quad_sum(dp[j]);
        const int kj = k0 + j;
        const bool valid = live && kj < s && (!causal || kj <= qi);
        const float p = valid ? expf(__fmul_rn(sdot, scale) - lse_i) : 0.0f;
        const float ds = round_to(p * (sdp - d_i), q);
        axpy<WC4>(acc, ds, k_tile[j], part);
      }
    }
    if (live) store_row<T, WC4>(dq + out_row * d + oc * DC, acc, scale, part, d - oc * DC);
  }
}

// K11 for head_dim > 128.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int s, int h, int d,
                      Strides qs, Strides ks, Strides vs, float scale, int causal) {
  __shared__ float4 q_tile[WT][DC / 4];
  __shared__ float4 do_tile[WT][DC / 4];
  __shared__ float lse_tile[WT];
  __shared__ float d_tile[WT];

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hh = bh % h;
  const int k0 = blockIdx.x * ROWS;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int kj = k0 + row;
  const bool live = kj < s;
  const int chunks = (d + DC - 1) / DC;

  const T* k_row = k + b * ks.b + static_cast<long long>(kj) * ks.s + hh * ks.h;
  const T* v_row = v + b * vs.b + static_cast<long long>(kj) * vs.s + hh * vs.h;
  const long long stat0 = static_cast<long long>(bh) * s;
  const long long q_base = b * qs.b + hh * qs.h;
  const long long do_base = (static_cast<long long>(b) * s * h + hh) * d;
  const long long do_stride = static_cast<long long>(h) * d;

  for (int oc = 0; oc < chunks; ++oc) {
    float dk_acc[WC4 * 4], dv_acc[WC4 * 4];
#pragma unroll
    for (int i = 0; i < WC4 * 4; ++i) {
      dk_acc[i] = 0.0f;
      dv_acc[i] = 0.0f;
    }
    // Causal: q rows above the tile's first key are masked for every key
    // (k0 is a multiple of WT, so the loop starts on a tile boundary).
    for (int q0 = causal ? k0 : 0; q0 < s; q0 += WT) {
      float dot[WT], dp[WT];
#pragma unroll
      for (int i = 0; i < WT; ++i) dot[i] = dp[i] = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        __syncthreads();  // the previous tiles are consumed
        load_chunk<T>(q_tile, q, q_base, qs.s, q0, c, s, d);
        load_chunk<T>(do_tile, dout, do_base, do_stride, q0, c, s, d);
        if (c == 0 && threadIdx.x < WT) {
          const int qi = q0 + threadIdx.x;
          lse_tile[threadIdx.x] = qi < s ? lse[stat0 + qi] : 0.0f;
          d_tile[threadIdx.x] = qi < s ? delta[stat0 + qi] : 0.0f;
        }
        __syncthreads();
        float kv[WC4 * 4], vv[WC4 * 4];
        load_row<T, WC4>(kv, k_row + c * DC, live, part, d - c * DC);
        load_row<T, WC4>(vv, v_row + c * DC, live, part, d - c * DC);
#pragma unroll
        for (int i = 0; i < WT; ++i) {
          dot[i] += partial_dot<WC4>(kv, q_tile[i], part);
          dp[i] += partial_dot<WC4>(vv, do_tile[i], part);
        }
      }
      __syncthreads();  // the last chunk is consumed
      load_chunk<T>(q_tile, q, q_base, qs.s, q0, oc, s, d);
      load_chunk<T>(do_tile, dout, do_base, do_stride, q0, oc, s, d);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        const float sdot = quad_sum(dot[i]);
        const float sdp = quad_sum(dp[i]);
        const int qi = q0 + i;
        const bool valid = live && qi < s && (!causal || kj <= qi);
        const float p = valid ? expf(__fmul_rn(sdot, scale) - lse_tile[i]) : 0.0f;
        axpy<WC4>(dv_acc, round_to(p, q), do_tile[i], part);
        axpy<WC4>(dk_acc, round_to(p * (sdp - d_tile[i]), q), q_tile[i], part);
      }
    }
    if (live) {
      const long long out_row = (static_cast<long long>(b) * s + kj) * h + hh;
      store_row<T, WC4>(dk + out_row * d + oc * DC, dk_acc, scale, part, d - oc * DC);
      store_row<T, WC4>(dv + out_row * d + oc * DC, dv_acc, 1.0f, part, d - oc * DC);
    }
  }
}

// -- Tensor-core variant (bf16, head_dim <= 128) ----------------------------

// The shared helpers (block geometry, cp.async, ldmatrix, mma) are in
// mma_bf16.cuh.

// Store a warp's 16 x DP fp32 accumulator times `mul` as bf16 rows
// row0.. (rows >= s and dims >= d skipped) of a contiguous [b, s, h, d].
template <int DP>
__device__ __forceinline__ void store_acc(bf16* out, const float (&acc)[DP / 8][4], float mul,
                                          int b, int row0, int hh, int s, int h, int d,
                                          int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= s) continue;
    bf16* dst = out + ((static_cast<long long>(b) * s + row) * h + hh) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane & 3) + e;
        if (col < d) dst[col] = __float2bfloat16(acc[n][2 * half + e] * mul);
      }
    }
  }
}

// K10 on tensor cores. DP: head_dim padded to 32, 64 or 128. Grid (b*h,
// q tiles), the last (heaviest causal) q tile first.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int s, int h, int d, Strides qs, Strides ks,
                    Strides vs, float scale, int causal, int vec) {
  constexpr int PITCH = DP + 8;
  constexpr int ROW_TILE = MMA_ROWS * PITCH;
  constexpr int K_TILE = MMA_KTILE * PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [64][PITCH]
  bf16* do_s = q_s + ROW_TILE;                // [64][PITCH]
  bf16* k_s = do_s + ROW_TILE;                // [2][64][PITCH]
  bf16* v_s = k_s + 2 * K_TILE;               // [2][64][PITCH]

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;

  const bf16* q_base = q + b * qs.b + hh * qs.h;
  const bf16* k_base = k + b * ks.b + hh * ks.h;
  const bf16* v_base = v + b * vs.b + hh * vs.h;
  const bf16* do_base = dout + (static_cast<long long>(b) * s * h + hh) * d;
  const long long do_stride = static_cast<long long>(h) * d;

  // Causal: keys past the tile's last row are masked for every row.
  const int k_end = causal ? min(s, q0 + MMA_ROWS) : s;
  const int n_tiles = (k_end + MMA_KTILE - 1) / MMA_KTILE;
  load_tile_bf16<MMA_ROWS, DP>(q_s, q_base, qs.s, q0, s, d, vec);
  load_tile_bf16<MMA_ROWS, DP>(do_s, do_base, do_stride, q0, s, d, vec);
  load_tile_bf16<MMA_KTILE, DP>(k_s, k_base, ks.s, 0, s, d, vec);
  load_tile_bf16<MMA_KTILE, DP>(v_s, v_base, vs.s, 0, s, d, vec);
  cp_async_commit();

  // This thread's two rows (lane / 4 and lane / 4 + 8 of its warp's 16).
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  int rows[2] = {row_lo, row_lo + 8};
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long stat = static_cast<long long>(bh) * s + rows[i];
    lse_r[i] = rows[i] < s ? lse[stat] : 0.0f;
    d_r[i] = rows[i] < s ? delta[stat] : 0.0f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * MMA_KTILE;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      const int nxt = (it + 1) & 1;
      load_tile_bf16<MMA_KTILE, DP>(k_s + nxt * K_TILE, k_base, ks.s, k0 + MMA_KTILE, s, d, vec);
      load_tile_bf16<MMA_KTILE, DP>(v_s + nxt * K_TILE, v_base, vs.s, k0 + MMA_KTILE, s, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + (it & 1) * K_TILE;
    const bf16* vt = v_s + (it & 1) * K_TILE;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp.
    float sc[MMA_KTILE / 8][4], dp[MMA_KTILE / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_KTILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      uint32_t qa[4], da[4];
      load_a(qa, q_s, PITCH, warp * 16, 16 * c, lane);
      load_a(da, do_s, PITCH, warp * 16, 16 * c, lane);
#pragma unroll
      for (int j = 0; j < MMA_KTILE / 8; j += 2) {
        uint32_t kb[4], vb[4];
        load_bt(kb, kt, PITCH, 8 * j, 16 * c, lane);
        load_bt(vb, vt, PITCH, 8 * j, 16 * c, lane);
        mma_bf16(sc[j], qa, kb[0], kb[1]);
        mma_bf16(sc[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], da, vb[0], vb[1]);
        mma_bf16(dp[j + 1], da, vb[2], vb[3]);
      }
    }

    // P and dS on the accumulator fragments; dS rounded to bf16 as the A
    // operand of dS K. Element e of n8 tile j: row rows[e / 2], key
    // k0 + 8j + 2t + e % 2. The masks are compiled into a second copy of
    // the loop, taken only where the tile crosses the causal diagonal or
    // the end.
    uint32_t dsa[MMA_KTILE / 16][4];
    auto to_ds = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < MMA_KTILE / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const bool valid =
              !decltype(masked)::value || (kj < s && (!causal || kj <= rows[e >> 1]));
          const float p = valid ? expf(__fmul_rn(sc[j][e], scale) - lse_r[e >> 1]) : 0.0f;
          ds[e] = p * (dp[j][e] - d_r[e >> 1]);
        }
        dsa[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
    };
    if ((causal && k0 + MMA_KTILE - 1 > q0) || k0 + MMA_KTILE > s) {
      to_ds(std::true_type());
    } else {
      to_ds(std::false_type());
    }

    // dQ += dS K.
#pragma unroll
    for (int c = 0; c < MMA_KTILE / 16; ++c) {
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        uint32_t kb[4];
        load_b(kb, kt, PITCH, 16 * c, 8 * n, lane);
        mma_bf16(acc[n], dsa[c], kb[0], kb[1]);
        mma_bf16(acc[n + 1], dsa[c], kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the copy into it
  }
  store_acc<DP>(dq, acc, scale, b, q0 + warp * 16, hh, s, h, d, lane);
}

// K11 on tensor cores. DP: head_dim padded to 32, 64 or 128; BQ: rows
// per q tile. Grid (b*h, key tiles), the first (heaviest causal) first.
template <int DP, int BQ>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int h, int d,
                     Strides qs, Strides ks, Strides vs, float scale, int causal, int vec) {
  constexpr int PITCH = DP + 8;
  constexpr int ROW_TILE = MMA_ROWS * PITCH;
  constexpr int Q_TILE = BQ * PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [64][PITCH]
  bf16* v_s = k_s + ROW_TILE;                 // [64][PITCH]
  bf16* q_s = v_s + ROW_TILE;                 // [2][BQ][PITCH]
  bf16* do_s = q_s + 2 * Q_TILE;              // [2][BQ][PITCH]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * Q_TILE);  // [2][BQ]
  float* d_s = lse_s + 2 * BQ;                                   // [2][BQ]

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int k0 = blockIdx.y * MMA_ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;

  const bf16* q_base = q + b * qs.b + hh * qs.h;
  const bf16* do_base = dout + (static_cast<long long>(b) * s * h + hh) * d;
  const long long do_stride = static_cast<long long>(h) * d;
  const long long stat0 = static_cast<long long>(bh) * s;

  // One q tile (rows q0..) with its lse and D into stage `st`.
  auto load_q_tile = [&](int st, int q0) {
    load_tile_bf16<BQ, DP>(q_s + st * Q_TILE, q_base, qs.s, q0, s, d, vec);
    load_tile_bf16<BQ, DP>(do_s + st * Q_TILE, do_base, do_stride, q0, s, d, vec);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      const bool live = qi < s;
      cp_async4(smem_u32(lse_s + st * BQ + threadIdx.x), live ? lse + stat0 + qi : lse, live);
      cp_async4(smem_u32(d_s + st * BQ + threadIdx.x), live ? delta + stat0 + qi : delta, live);
    }
  };

  // Causal: q rows above the tile's first key are masked for every key
  // (k0 is a multiple of BQ, so the loop starts on a tile boundary).
  const int q_start = causal ? k0 : 0;
  const int n_tiles = (s - q_start + BQ - 1) / BQ;
  load_tile_bf16<MMA_ROWS, DP>(k_s, k + b * ks.b + hh * ks.h, ks.s, k0, s, d, vec);
  load_tile_bf16<MMA_ROWS, DP>(v_s, v + b * vs.b + hh * vs.h, vs.s, k0, s, d, vec);
  load_q_tile(0, q_start);
  cp_async_commit();

  // This thread's two key rows (lane / 4 and lane / 4 + 8 of its warp's 16).
  const int key_lo = k0 + warp * 16 + (lane >> 2);
  const int keys[2] = {key_lo, key_lo + 8};

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_start + it * BQ;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      load_q_tile((it + 1) & 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const bf16* qt = q_s + st * Q_TILE;
    const bf16* dot = do_s + st * Q_TILE;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ rows a warp.
    float sc[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      uint32_t ka[4], va[4];
      load_a(ka, k_s, PITCH, warp * 16, 16 * c, lane);
      load_a(va, v_s, PITCH, warp * 16, 16 * c, lane);
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t qb[4], db[4];
        load_bt(qb, qt, PITCH, 8 * j, 16 * c, lane);
        load_bt(db, dot, PITCH, 8 * j, 16 * c, lane);
        mma_bf16(sc[j], ka, qb[0], qb[1]);
        mma_bf16(sc[j + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[j], va, db[0], db[1]);
        mma_bf16(dp[j + 1], va, db[2], db[3]);
      }
    }

    // P^T and dS^T on the fragments, rounded to bf16 as A operands.
    // Element e of n8 tile j: key keys[e / 2], row q0 + 8j + 2t + e % 2.
    // The masks as in K10: a second copy of the loop, for the tiles that
    // cross the causal diagonal or the end.
    const float* lse_t = lse_s + st * BQ;
    const float* d_t = d_s + st * BQ;
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    auto to_p_ds = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int qi = q0 + col;
          const bool valid =
              !decltype(masked)::value || (qi < s && (!causal || keys[e >> 1] <= qi));
          p[e] = valid ? expf(__fmul_rn(sc[j][e], scale) - lse_t[col]) : 0.0f;
          ds[e] = p[e] * (dp[j][e] - d_t[col]);
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
        dsa[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
    };
    if ((causal && q0 < k0 + MMA_ROWS - 1) || q0 + BQ > s) {
      to_p_ds(std::true_type());
    } else {
      to_p_ds(std::false_type());
    }

    // dV += P^T dO, dK += dS^T Q.
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        uint32_t db[4], qb[4];
        load_b(db, dot, PITCH, 16 * c, 8 * n, lane);
        mma_bf16(dv_acc[n], pa[c], db[0], db[1]);
        mma_bf16(dv_acc[n + 1], pa[c], db[2], db[3]);
        load_b(qb, qt, PITCH, 16 * c, 8 * n, lane);
        mma_bf16(dk_acc[n], dsa[c], qb[0], qb[1]);
        mma_bf16(dk_acc[n + 1], dsa[c], qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the copy into it
  }
  store_acc<DP>(dk, dk_acc, scale, b, k0 + warp * 16, hh, s, h, d, lane);
  store_acc<DP>(dv, dv_acc, 1.0f, b, k0 + warp * 16, hh, s, h, d, lane);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int b, s, h, d;
  Strides qs, ks, vs;
  float scale;
  int causal;
};

template <typename T, int DP>
void launch_dp(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.s + ROWS - 1) / ROWS, a.b * a.h);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (a.dq != nullptr) {
    flash_dq_kernel<T, DP><<<grid, THREADS, 0, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.s, a.h, a.d,
        a.qs, a.ks, a.vs, a.scale, a.causal);
  } else {
    flash_dkv_kernel<T, DP><<<grid, THREADS, 0, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.s, a.h, a.d, a.qs, a.ks, a.vs, a.scale,
        a.causal);
  }
}

template <typename T>
void launch_wide(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.s + ROWS - 1) / ROWS, a.b * a.h);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (a.dq != nullptr) {
    flash_dq_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.s, a.h, a.d,
        a.qs, a.ks, a.vs, a.scale, a.causal);
  } else {
    flash_dkv_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.s, a.h, a.d, a.qs, a.ks, a.vs, a.scale,
        a.causal);
  }
}

bool vec_ok(const Args& a) {
  return vec_copy_ok(a.d, {a.q, a.k, a.v, a.dout},
                     {a.qs.b, a.qs.s, a.qs.h, a.ks.b, a.ks.s, a.ks.h, a.vs.b, a.vs.s, a.vs.h});
}

template <int DP>
cudaError_t launch_mma_dp(const Args& a, cudaStream_t stream) {
  // K11's q tile: 64 rows, 32 at head_dim 128, where the dK and dV
  // accumulators take 128 registers a thread.
  constexpr int BQ = DP > 64 ? 32 : 64;
  const int tiles = (a.s + MMA_ROWS - 1) / MMA_ROWS;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.b * a.h, tiles);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int vec = vec_ok(a) ? 1 : 0;
  cudaError_t err;
  if (a.dq != nullptr) {
    constexpr int smem = (2 * MMA_ROWS + 4 * MMA_KTILE) * (DP + 8) * sizeof(bf16);
    err = cudaFuncSetAttribute(flash_dq_mma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_dq_mma_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.s, a.h, a.d, a.qs, a.ks,
        a.vs, a.scale, a.causal, vec);
  } else {
    constexpr int smem =
        (2 * MMA_ROWS + 4 * BQ) * (DP + 8) * sizeof(bf16) + 4 * BQ * sizeof(float);
    err = cudaFuncSetAttribute(flash_dkv_mma_kernel<DP, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_dkv_mma_kernel<DP, BQ><<<grid, MMA_THREADS, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.s, a.h, a.d, a.qs, a.ks, a.vs, a.scale, a.causal, vec);
  }
  return cudaGetLastError();
}

cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_mma_dp<32>(a, stream);
  if (a.d <= 64) return launch_mma_dp<64>(a, stream);
  return launch_mma_dp<128>(a, stream);
}

int run(const Args& a, int dtype_code, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.b <= 0 || a.s <= 0 || a.h <= 0 || a.d <= 0) return 0;
  if (a.b * a.h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant(dtype_code, a.d)) {
    case 2:
      return static_cast<int>(launch_mma(a, st));
    case 1:
      if (dtype_code == 0) {
        launch_wide<float>(a, st);
      } else {
        launch_wide<__nv_bfloat16>(a, st);
      }
      break;
    case 0:
      if (a.d <= 32) {
        launch_dp<float, 32>(a, st);
      } else if (a.d <= 64) {
        launch_dp<float, 64>(a, st);
      } else {
        launch_dp<float, 128>(a, st);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (q, k, v, dO and the gradients).
// Strides are in elements, per tensor (batch, seq, head); the head_dim
// axis is contiguous. dO and the gradients are contiguous [b, s, h, d];
// lse and D contiguous fp32 [b*h, s]. Each returns a cudaError_t.
extern "C" int zk_flash_backward_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype_code, int b, int s,
    int h, int d, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int device, void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, b, s, h, d,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, scale, causal};
  return run(a, dtype_code, device, stream);
}

extern "C" int zk_flash_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype_code,
    int b, int s, int h, int d, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int device,
    void* stream) {
  if (dk == nullptr || dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, b, s, h, d,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, scale, causal};
  return run(a, dtype_code, device, stream);
}

// Which variant a call of this dtype code and head_dim launches: 0 FMA,
// 1 FMA wide, 2 tensor cores; -1 for a dtype code the kernels refuse.
extern "C" int zk_flash_backward_variant(int dtype_code, int d) {
  return variant(dtype_code, d);
}
