// K1: sign+pack of float rows into little-endian int32 words.
//
// Replaces zookeeper_tpu/ops/binary_compute.py `pack_rows_packed`
// (Pallas body `_pack_rows_kernel`): [M, K] fp32/bf16 -> [M, K/32] int32,
// bit b of word t is `x[32t + b] >= 0` in IEEE fp32 (NaN -> 0, -0 and
// +0 -> 1, a negative subnormal -> 0: no flush to zero).
//
// Bound on an H100: memory. One read of the source and a 1/32-size
// write; the compare is one instruction per value.
//
// Design (`pack_rows_vec_kernel`): K % 32 == 0, so word t of the
// flattened output packs the 32 consecutive values 32t.., 64 (bf16) or
// 128 (fp32) contiguous bytes. One thread makes one word from its own
// LPW = 4 (bf16) or 8 (fp32) 16-byte loads, all issued before the
// compares: each load's 8 or 4 compares give a byte or a nibble,
// shifted to its place. Consecutive threads take consecutive words, so
// each warp's stores are one coalesced 128-byte store. The grid is
// sized from the SM count and strides over the words. (Chosen by
// measurement over two words a thread, over lanes that OR their parts
// of a word by shuffles, and over staging bytes in shared memory:
// PERF.md section 6.)
//
// A source not 16-byte aligned (a view with a storage offset) takes
// `pack_rows_scalar_kernel` in the same launch function: one warp per
// word, lane b loads value 32t + b, and `__ballot_sync` turns lane b's
// compare into bit b.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }

__device__ __forceinline__ float load_as_float(const uint16_t* p) {
  // bf16 is the top half of an fp32: widening is exact, NaN stays NaN.
  return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}

// Bit i set when value i of the 16 bytes is >= 0, values in memory order.
__device__ __forceinline__ unsigned part_bits(const uint4& v, const float*) {
  return (__uint_as_float(v.x) >= 0.0f ? 1u : 0u) | (__uint_as_float(v.y) >= 0.0f ? 2u : 0u) |
         (__uint_as_float(v.z) >= 0.0f ? 4u : 0u) | (__uint_as_float(v.w) >= 0.0f ? 8u : 0u);
}

__device__ __forceinline__ unsigned part_bits(const uint4& v, const uint16_t*) {
  // A 32-bit word holds two bf16 values, the first in its low half;
  // each widens exactly to the fp32 with those top bits.
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bits |= (__uint_as_float(w[i] << 16) >= 0.0f ? 1u : 0u) << (2 * i);
    bits |= (__uint_as_float(w[i] & 0xffff0000u) >= 0.0f ? 1u : 0u) << (2 * i + 1);
  }
  return bits;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pack_rows_vec_kernel(const uint4* __restrict__ x, int32_t* __restrict__ out,
                     long long n_words) {
  constexpr int VPL = 16 / static_cast<int>(sizeof(T));  // values a load: 8 or 4
  constexpr int LPW = 32 / VPL;                          // loads a word: 4 or 8
  const long long threads = static_cast<long long>(gridDim.x) * THREADS;
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; t < n_words;
       t += threads) {
    uint4 v[LPW];
#pragma unroll
    for (int j = 0; j < LPW; ++j) v[j] = __ldg(x + t * LPW + j);
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < LPW; ++j) {
      word |= part_bits(v[j], static_cast<const T*>(nullptr)) << (VPL * j);
    }
    out[t] = static_cast<int32_t>(word);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pack_rows_scalar_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                        long long n_words) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * THREADS) >> 5;
  for (long long word = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
       word < n_words; word += warps) {
    const float v = load_as_float(x + word * 32 + lane);
    const unsigned bits = __ballot_sync(FULL, v >= 0.0f);
    if (lane == 0) out[word] = static_cast<int32_t>(bits);
  }
}

// Blocks for `units` warp-sized pieces of work: one warp each, at most
// 16 blocks (2048 threads) per SM of the device.
int grid_blocks(long long units, int sms) {
  const long long needed = (units + THREADS / 32 - 1) / (THREADS / 32);
  const long long most = 16LL * sms;
  return static_cast<int>(needed < most ? needed : most);
}

template <typename T>
void launch(const void* x, void* out, long long n_words, int sms, cudaStream_t s) {
  int32_t* o = static_cast<int32_t*>(out);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    pack_rows_vec_kernel<T><<<grid_blocks((n_words + 31) / 32, sms), THREADS, 0, s>>>(
        static_cast<const uint4*>(x), o, n_words);
  } else {
    pack_rows_scalar_kernel<T><<<grid_blocks(n_words, sms), THREADS, 0, s>>>(
        static_cast<const T*>(x), o, n_words);
  }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. x is the contiguous source,
// any base address of its dtype's alignment. Returns a cudaError_t.
extern "C" int zk_pack_rows(const void* x, int dtype_code, void* out,
                            long long n_words, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_words <= 0) return 0;
  static int sms[64] = {};  // per device: SMs, once the attribute is read
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess || sms[device] < 1) {
      sms[device] = 0;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    launch<float>(x, out, n_words, sms[device], s);
  } else if (dtype_code == 1) {
    launch<uint16_t>(x, out, n_words, sms[device], s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
