// K9: flash attention forward, causal or full.
//
// Replaces zookeeper_tpu/ops/attention.py `_flash_forward` (Pallas body
// `kernel`, want_lse False or True): q, k, v [b, s, h, d] fp32/bf16 -> o
// [b, s, h, d] in the input dtype and, when an lse pointer is given, each
// row's log-sum-exp `m + log l` as fp32 [b*h, s] (JAX's [b*h, s_pad, 1]
// without the padded rows), the one residual the backward (K10, K11)
// needs beyond the primals. The output does not depend on the pointer. Scores `(q . k) * scale` in fp32 with exact
// products; keys >= s and, when causal, keys > the query's row are set
// to the finite mask value; online softmax with the running max started
// at the mask value, sum and accumulator at 0; `p` rounded to the input
// dtype before `p @ v` (the sum `l` takes the unrounded `p`); the
// accumulator divided by `l` once at the end.
//
// Bound on an H100: operations. A causal call does 2 * b*h * d * s^2
// multiply-adds (q.k and p.v over half the square); the bytes (q, k, v
// read once, o written once) are a few MB.
//
// Design (simple first; wgmma/TMA is later work): one block per
// (b*h, 64-row q tile), 256 threads, four threads per q row. A thread
// keeps a quarter of its row's q and accumulator in registers, in fp32.
// The TPU kernel's sequential k grid axis becomes a loop inside the
// block over 32-key tiles that stops at the causal diagonal, so masked
// tiles cost neither loads nor compute. Each tile of K and V is widened
// to fp32 in shared memory, zero-padded past head_dim (zeros add
// nothing to a dot product or an accumulator). A score is four partial
// dot products summed by two xor-shuffles among the row's four lanes,
// plain fp32 FMA (never TF32). Rows >= s are computed but never
// written (nor is their lse); no host-side padding is needed. q, k and
// v are read through their strides, so the split of a fused qkv
// projection needs no copy.
//
// Head_dims above 128 (`flash_forward_wide_kernel`): the same block,
// tiles and numerics, over chunks of 128 dims. A score sums its partial
// products over every chunk of q and K (q's chunk read into registers,
// K's widened into the same 32 x 128 shared tile, one chunk at a time);
// the output is produced one 128-dim chunk per pass over the keys, each
// pass recomputing the same scores, softmax and `l` in the same order,
// so every chunk sees identical weights. Shared memory stays 32 KiB
// (static) and registers those of the 128-dim kernel whatever the
// head_dim; the price is ceil(d / 128) score passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int h, int d, Strides qs,
                   Strides ks, Strides vs, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (d <= 32) {
    flash_forward_kernel<T, 32><<<grid, THREADS, 0, stream>>>(
        qp, kp, vp, op, lse, s, h, d, qs, ks, vs, scale, causal);
  } else if (d <= 64) {
    flash_forward_kernel<T, 64><<<grid, THREADS, 0, stream>>>(
        qp, kp, vp, op, lse, s, h, d, qs, ks, vs, scale, causal);
  } else if (d <= 128) {
    flash_forward_kernel<T, 128><<<grid, THREADS, 0, stream>>>(
        qp, kp, vp, op, lse, s, h, d, qs, ks, vs, scale, causal);
  } else {
    flash_forward_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
        qp, kp, vp, op, lse, s, h, d, qs, ks, vs, scale, causal);
  }
  return cudaGetLastError();
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || s <= 0 || h <= 0 || d <= 0) return 0;
  if (b * h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    err = launch<float>(q, k, v, o, static_cast<float*>(lse), b, s, h, d, qs,
                        ks, vs, scale, causal, st);
  } else if (dtype_code == 1) {
    err = launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), b, s, h,
                                d, qs, ks, vs, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
