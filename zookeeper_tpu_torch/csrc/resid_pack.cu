// K6, K7, K8: the 1-bit batch-packed training residuals.
//
// Replaces, in zookeeper_tpu/ops/binary_compute.py:
//   K6 `pack_resid`       (Pallas body `_pack_resid_kernel`),
//   K7 `unpack_resid_pm1` (Pallas body `_unpack_pm1_resid_kernel`),
//   K8 `mask_mul_resid`   (Pallas body `_mask_mul_resid_kernel`).
//
// Layout (the JAX package's residual storage format): a residual of
// batch B, normalised to [B, H, W, C] and viewed as [B, N] with
// N = H*W*C, packs into [ceil(B/32), N] int32 words; bit b of word
// [g, i] comes from x[32g + b, i]. Rows past B are the batch padding the
// JAX package adds: 1.0 for a pack (bit 1 in both modes) and 0.0 for K8's
// cotangent (those rows are never written, as the JAX wrapper slices
// them off).
//
//   K6 sign mode: bit = x >= 0 (NaN -> 0, -0 -> 1);
//   K6 mask mode: bit = |x| <= 1, the ste_sign pass-through window
//                 (|NaN| <= 1 is false -> 0);
//   K7: out[r, i] = bit ? +1 : -1 in the output dtype;
//   K8: out[r, i] = g[r, i] * (bit ? 1 : 0), an IEEE multiply, so -0,
//       NaN and inf*0 = NaN come out as the reference's multiply gives
//       them.
//
// bf16 is widened to fp32 by a 16-bit shift (exact; NaN stays NaN), as
// the Pallas kernel widens before its compare. Every value K7 and K8
// write is exact in bf16 (+-1, g, +-0) or a NaN; it is narrowed with
// __float2bfloat16, the conversion PyTorch's own device code uses, so
// a NaN comes out with the same bits as PyTorch's multiply gives it.
//
// Bound on an H100: memory. K6 reads the source once and writes 1/32 of
// it (a 2-byte value becomes one bit of a 4-byte word, 1/16 of the
// bytes); K7 is the reverse; K8 reads g and 1/16 of its bytes in words,
// and writes g's bytes. The arithmetic is one compare or one multiply
// per value.
//
// Design: one thread per word position (g, i), consecutive threads on
// consecutive i, so each of the 32 row accesses of a warp is one
// contiguous run of 32 values (coalesced); the 32-row loop is unrolled
// so its loads are all in flight together. A batch that is a multiple
// of 32 (every training batch on the main path) takes the branch-free
// loop; the ragged last group masks its rows. Grid-stride over words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }

__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);

template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ uint16_t narrow<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

template <bool kMask>
__device__ __forceinline__ uint32_t bit_of(float v) {
  return kMask ? static_cast<uint32_t>(fabsf(v) <= 1.0f)
               : static_cast<uint32_t>(v >= 0.0f);
}

template <typename T, bool kMask>
__global__ void pack_resid_kernel(const T* __restrict__ x,
                                  int32_t* __restrict__ out, long long rows,
                                  long long n, long long n_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < n_words; w += stride) {
    const long long grp = w / n;
    const long long i = w - grp * n;
    const long long row0 = grp * 32;
    const T* src = x + row0 * n + i;
    uint32_t bits = 0;
    if (row0 + 32 <= rows) {
#pragma unroll
      for (int b = 0; b < 32; ++b) bits |= bit_of<kMask>(widen(src[b * n])) << b;
    } else {
      for (int b = 0; b < 32; ++b) {
        // Batch padding packs as 1.0: +1 in sign mode, inside the window.
        const uint32_t bit =
            row0 + b < rows ? bit_of<kMask>(widen(src[b * n])) : 1u;
        bits |= bit << b;
      }
    }
    out[w] = static_cast<int32_t>(bits);
  }
}

template <typename T>
__global__ void unpack_resid_pm1_kernel(const int32_t* __restrict__ words,
                                        T* __restrict__ out, long long rows,
                                        long long n, long long n_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < n_words; w += stride) {
    const long long grp = w / n;
    const long long i = w - grp * n;
    const long long row0 = grp * 32;
    const uint32_t bits = static_cast<uint32_t>(words[w]);
    T* dst = out + row0 * n + i;
    const int live = rows - row0 < 32 ? static_cast<int>(rows - row0) : 32;
    if (live == 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        dst[b * n] = narrow<T>((bits >> b) & 1u ? 1.0f : -1.0f);
    } else {
      for (int b = 0; b < live; ++b)
        dst[b * n] = narrow<T>((bits >> b) & 1u ? 1.0f : -1.0f);
    }
  }
}

template <typename T>
__global__ void mask_mul_resid_kernel(const T* __restrict__ g,
                                      const int32_t* __restrict__ words,
                                      T* __restrict__ out, long long rows,
                                      long long n, long long n_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < n_words; w += stride) {
    const long long grp = w / n;
    const long long i = w - grp * n;
    const long long row0 = grp * 32;
    const uint32_t bits = static_cast<uint32_t>(words[w]);
    const T* src = g + row0 * n + i;
    T* dst = out + row0 * n + i;
    const int live = rows - row0 < 32 ? static_cast<int>(rows - row0) : 32;
    if (live == 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        dst[b * n] = narrow<T>(
            __fmul_rn(widen(src[b * n]), (bits >> b) & 1u ? 1.0f : 0.0f));
    } else {
      for (int b = 0; b < live; ++b)
        dst[b * n] = narrow<T>(
            __fmul_rn(widen(src[b * n]), (bits >> b) & 1u ? 1.0f : 0.0f));
    }
  }
}

constexpr int kThreads = 256;

int grid_for(long long n_words) {
  const long long blocks = (n_words + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1048576LL ? blocks : 1048576LL);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Each entry point returns a
// cudaError_t (0 on a clean launch).

extern "C" int zk_pack_resid(const void* x, int dtype_code, int mask_mode,
                             void* out, long long rows, long long n,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_words = (rows + 31) / 32 * n;
  if (n_words <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  const int blocks = grid_for(n_words);
  if (dtype_code == 0 && !mask_mode) {
    pack_resid_kernel<float, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, rows, n, n_words);
  } else if (dtype_code == 0) {
    pack_resid_kernel<float, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, rows, n, n_words);
  } else if (dtype_code == 1 && !mask_mode) {
    pack_resid_kernel<uint16_t, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), o, rows, n, n_words);
  } else if (dtype_code == 1) {
    pack_resid_kernel<uint16_t, true><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), o, rows, n, n_words);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_unpack_resid_pm1(const void* words, void* out,
                                   int dtype_code, long long rows,
                                   long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_words = (rows + 31) / 32 * n;
  if (n_words <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(words);
  const int blocks = grid_for(n_words);
  if (dtype_code == 0) {
    unpack_resid_pm1_kernel<float><<<blocks, kThreads, 0, s>>>(
        w, static_cast<float*>(out), rows, n, n_words);
  } else if (dtype_code == 1) {
    unpack_resid_pm1_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        w, static_cast<uint16_t*>(out), rows, n, n_words);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_mask_mul_resid(const void* g, const void* words, void* out,
                                 int dtype_code, long long rows, long long n,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_words = (rows + 31) / 32 * n;
  if (n_words <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(words);
  const int blocks = grid_for(n_words);
  if (dtype_code == 0) {
    mask_mul_resid_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), w, static_cast<float*>(out), rows, n,
        n_words);
  } else if (dtype_code == 1) {
    mask_mul_resid_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(g), w, static_cast<uint16_t*>(out), rows,
        n, n_words);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
