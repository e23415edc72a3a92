// Tensor-core helpers shared by the flash forward (K9) and backward
// (K10, K11) kernels for bf16 at head_dim <= 128: the block geometry,
// `cp.async` copies into shared memory, `ldmatrix` operand loads, the
// `mma.sync.m16n8k16` bf16 -> fp32 product, and the dispatch rule both
// sources export. Included by flash_forward.cu and flash_backward.cu;
// everything sits in an anonymous namespace, as in the sources.
//
// Operand layouts (PTX ISA, mma.m16n8k16): lane l holds, of the 16 x 8
// fp32 accumulator, rows l / 4 and l / 4 + 8, columns 2 (l % 4) and
// 2 (l % 4) + 1; two neighbouring n8 accumulator tiles in that layout,
// rounded to bf16 and packed in pairs (`pack_bf16`), are the A fragment
// of one k16 slice, so a product's result feeds the next product
// without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;  // 128
constexpr int MMA_ROWS = MMA_WARPS * 16;     // output rows per block: 16 a warp
constexpr int MMA_KTILE = 64;                // K10's loop tile (keys)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !live (no read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives in r[m] its part of matrix m (transposed with TRANS).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest even, as a cast does), the
// first in the low half: one register of an mma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy rows r0.. (R of them) of one (batch, head), head_dim d, into a
// shared tile of R rows x DP bf16 with a row pitch of DP + 8; zeros past
// s and d. `vec`: 16-byte cp.async chunks (d, strides and addresses are
// multiples of 8 elements); else element by element.
template <int R, int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* tile, const bf16* x, long long row_stride,
                                               int r0, int s, int d, bool vec) {
  constexpr int PITCH = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int e = threadIdx.x; e < R * CH; e += MMA_THREADS) {
      const int r = e / CH;
      const int c = e % CH;
      const int ri = r0 + r;
      const bool live = ri < s && c * 8 < d;
      const bf16* src = live ? x + static_cast<long long>(ri) * row_stride + c * 8 : x;
      cp_async16(smem_u32(tile + r * PITCH + c * 8), src, live);
    }
  } else {
    for (int e = threadIdx.x; e < R * DP; e += MMA_THREADS) {
      const int r = e / DP;
      const int c = e % DP;
      const int ri = r0 + r;
      tile[r * PITCH + c] = (ri < s && c < d) ? x[static_cast<long long>(ri) * row_stride + c]
                                              : __float2bfloat16(0.0f);
    }
  }
}

// The A fragment (16 rows x 16 dims at column c0) of a row-major shared
// tile with `pitch`, rows row0.. .
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int pitch, int row0,
                                       int c0, int lane) {
  const int row = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int col = c0 + 8 * (lane >> 4);
  ldmatrix_x4<false>(a, smem_u32(tile + row * pitch + col));
}

// B fragments of two n8 tiles for a product with the tile's rows as the
// columns (X Y^T): rows n0.. n0+15 of the tile, dims c0.. c0+15.
// b[0], b[1] serve rows n0..n0+7; b[2], b[3] rows n0+8..n0+15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int pitch, int n0,
                                        int c0, int lane) {
  const int row = n0 + (lane & 7) + 8 * (lane >> 4);
  const int col = c0 + 8 * ((lane >> 3) & 1);
  ldmatrix_x4<false>(b, smem_u32(tile + row * pitch + col));
}

// B fragments of two n8 tiles for a product with the tile itself (X Y):
// the k16 slice of rows k0.. k0+15, dims n0.. n0+15. b[0], b[1] serve
// dims n0..n0+7; b[2], b[3] dims n0+8..n0+15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int pitch, int k0,
                                       int n0, int lane) {
  const int row = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int col = n0 + 8 * (lane >> 4);
  ldmatrix_x4<true>(b, smem_u32(tile + row * pitch + col));
}

// 16-byte copies (`load_tile_bf16`'s `vec`) need head_dim, every stride
// and every base address to be multiples of 8 bf16 elements.
inline bool vec_copy_ok(int d, std::initializer_list<const void*> ptrs,
                        std::initializer_list<long long> strides) {
  bool ok = d % 8 == 0;
  for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long x : strides) ok = ok && x % 8 == 0;
  return ok;
}

// Which kernels a flash call takes: 0 FMA (fp32, head_dim <= 128), 1 FMA
// wide (head_dim > 128), 2 tensor cores (bf16, head_dim <= 128); -1 for
// a dtype code (0 float32, 1 bfloat16) the kernels do not take.
inline int variant(int dtype_code, int d) {
  if (dtype_code != 0 && dtype_code != 1) return -1;
  if (d > 128) return 1;
  return dtype_code == 1 ? 2 : 0;
}

}  // namespace
