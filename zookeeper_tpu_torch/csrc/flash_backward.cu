// K10 and K11: the flash attention backward, causal or full.
//
// Replace zookeeper_tpu/ops/attention.py `_flash_backward`: K10 its dQ
// kernel (`dq_kernel`), K11 its dK/dV kernel (`dkv_kernel`). Both
// recompute the probabilities from the forward's lse instead of storing
// them: with S = (q . k) * scale in fp32 (exact products), keys >= s
// and, when causal, keys > the query's row masked,
//
//   P  = exp(S - lse), a hard 0 on masked entries
//   dS = P * (dO . v - D),  D = rowsum(dO * O) given by the caller
//   dQ = scale * sum_k round(dS) k            (K10)
//   dV = sum_q round(P) dO,  dK = scale * sum_q round(dS) q   (K11)
//
// `round` is the cast to the input dtype that JAX applies before each
// product (`ds.astype(k.dtype)`, `p.astype(do.dtype)`): bf16 inputs
// round, fp32 inputs keep the value. Sums are fp32; outputs are cast to
// the input dtype once, at the end.
//
// Bound on an H100: operations. Per attended (q, k) pair K10 does 3d
// multiply-adds (S, dO.v, dS k) and K11 4d (S, dO.v, P dO, dS q); the
// bytes (q, k, v, dO, lse, D read once, the gradients written once) are
// a few MB.
//
// Design (simple first, like K9; wgmma/TMA is later work): on the TPU the
// inner grid axis runs in order with the accumulator in VMEM; here it is
// a loop inside each block, so every output tile has one writer: no
// atomics, and the result is the same from run to run.
//
// - K10: one block per (b*h, 64-row q tile), 256 threads, four threads
//   per q row, each holding a quarter of its row's q, dO and dQ
//   accumulator in fp32 registers. The block loops over 32-key tiles of
//   K and V (widened to fp32 in shared memory, zero-padded past
//   head_dim) and stops at the causal diagonal.
// - K11: one block per (b*h, 64-key tile), four threads per key row,
//   each holding a quarter of its row's k, v and the dK and dV
//   accumulators. The block loops over 32-row tiles of Q and dO (with
//   their lse and D) from the causal diagonal down to the last row.
//
// A dot product is four partial sums joined by two xor-shuffles among
// the row's four lanes; plain fp32 FMA, never TF32. q, k and v are read
// through their strides (the split of a fused qkv projection needs no
// copy); dO is a contiguous [b, s, h, d]; lse and D contiguous fp32
// [b*h, s]. Rows >= s are computed as masked and never written.
//
// Head_dims above 128 (`flash_dq_wide_kernel`, `flash_dkv_wide_kernel`):
// the same blocks and numerics over chunks of 128 dims, with loop tiles
// of 16 rows. Each row's S and dO . v sum their partial products over
// every chunk (the register row's chunk read from global memory, the
// tile's widened into shared memory one chunk at a time); the gradients
// are produced one 128-dim chunk per pass over the loop tiles, each pass
// recomputing the same P and dS in the same order. Shared memory stays
// static (16 KiB) and registers near those of the 128-dim kernels
// whatever the head_dim; the price is ceil(d / 128) passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.d <= 32) {
    launch_dp<T, 32>(a, stream);
  } else if (a.d <= 64) {
    launch_dp<T, 64>(a, stream);
  } else if (a.d <= 128) {
    launch_dp<T, 128>(a, stream);
  } else {
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
  return cudaGetLastError();
}

int run(const Args& a, int dtype_code, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.b <= 0 || a.s <= 0 || a.h <= 0 || a.d <= 0) return 0;
  if (a.b * a.h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    err = launch<float>(a, st);
  } else if (dtype_code == 1) {
    err = launch<__nv_bfloat16>(a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
