// K1: sign+pack of float rows into little-endian int32 words.
//
// Replaces zookeeper_tpu/ops/binary_compute.py `pack_rows_packed`
// (Pallas body `_pack_rows_kernel`): [M, K] fp32/bf16 -> [M, K/32] int32,
// bit b of word t is `x[32t + b] >= 0` (NaN -> 0, -0 and +0 -> 1).
//
// Bound on an H100: memory. One read of the source and a 1/32-size
// write; the compare is one instruction per value.
//
// Design: one warp per output word. K % 32 == 0, so the 32 values of a
// word are 32 consecutive elements of the flattened input: lane b loads
// element 32*word + b (a coalesced 64- or 128-byte warp load), compares
// in fp32, and `__ballot_sync` turns lane b's predicate into bit b of the
// word, exactly the little-endian pack_bits order. Lane 0 stores it. The
// loop is grid-stride over words; every lane of a warp runs the same
// trip count, so the full-mask ballot is always legal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }

__device__ __forceinline__ float load_as_float(const uint16_t* p) {
  // bf16 is the top half of an fp32: widening is exact, NaN stays NaN.
  return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}

template <typename T>
__global__ void pack_rows_kernel(const T* __restrict__ x,
                                 int32_t* __restrict__ out,
                                 long long n_words) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_grid =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  long long word =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  for (; word < n_words; word += warps_per_grid) {
    const float v = load_as_float(x + word * 32 + lane);
    const unsigned bits = __ballot_sync(0xffffffffu, v >= 0.0f);
    if (lane == 0) out[word] = static_cast<int32_t>(bits);
  }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int zk_pack_rows(const void* x, int dtype_code, void* out,
                            long long n_words, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_words <= 0) return 0;
  const int threads = 256;
  const long long blocks_needed = (n_words * 32 + threads - 1) / threads;
  const int blocks = static_cast<int>(
      blocks_needed < 1048576LL ? blocks_needed : 1048576LL);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    pack_rows_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int32_t*>(out), n_words);
  } else if (dtype_code == 1) {
    pack_rows_kernel<uint16_t><<<blocks, threads, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<int32_t*>(out),
        n_words);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
