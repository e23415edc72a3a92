// Int8 tensor-core helpers shared by the packed-weight GEMM (K4,
// packed_weight_matmul.cu), the popcount GEMM (K5, xnor_gemm.cu) and the
// popcount conv (K3, conv_gemm_popcount.cu): `cp.async` copies,
// `ldmatrix` operand loads of K-contiguous int8 rows, the
// `mma.sync.m16n8k32` s8 x s8 -> s32 product, the carry-free decode of
// packed sign bits to +-1 bytes, the "small_m" weight loads and
// products of M <= 8 rows, and the block-tile GEMM the three sources
// instantiate for large M (K3 as an implicit-im2col conv).
// Everything sits in `s8` inside an anonymous namespace, so these names
// cannot meet those of mma_bf16.cuh.
//
// Operand layouts (PTX ISA, mma.m16n8k32 with .s8): with g = lane / 4 and
// t = lane % 4, lane l holds of A (16 x 32, row) the bytes k = 4t..4t+3
// of rows g (a[0]) and g + 8 (a[1]), and k = 16+4t..16+4t+3 of the same
// rows (a[2], a[3]); of B (32 x 8, col) the bytes k = 4t..4t+3 (b0) and
// 16+4t..16+4t+3 (b1) of column g; of the 16 x 8 int32 sum, rows g and
// g + 8 at columns 2t and 2t + 1. An int8 tile stored K-contiguous by
// row, [rows][pitch] bytes, gives both fragments through `ldmatrix` (its
// 8x8 b16 matrices are 8 rows x 16 bytes), A by rows and B by columns.
// Every product and sum is an exact integer, so any order of the sums
// gives the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace s8 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !live (no read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros when !live (no read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices (8 rows x 16 bytes each); lane i gives the
// address of row i % 8 of matrix i / 8 and receives in r[m] bytes
// 4 (i % 4)..+3 of row i / 4 of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16x32 s8 (row), b 32x8 s8 (col), c 16x8 s32.
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (rows row0..row0+15, bytes k0..k0+31) of a K-contiguous
// int8 tile with row pitch `pitch` bytes.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* tile, int pitch,
                                       int row0, int k0, int lane) {
  const int row = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  ldmatrix_x4(a, smem_u32(tile + row * pitch + k0 + 16 * (lane >> 4)));
}

// B fragments of two n8 tiles from a tile stored one row per output
// column: rows n0..n0+15, bytes k0..k0+31. b[0], b[1] serve columns
// n0..n0+7; b[2], b[3] columns n0+8..n0+15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const uint8_t* tile, int pitch, int n0,
                                       int k0, int lane) {
  const int row = n0 + (lane & 7) + 8 * (lane >> 4);
  ldmatrix_x4(b, smem_u32(tile + row * pitch + k0 + 16 * ((lane >> 3) & 1)));
}

// Bits 0-3 of `nib` as four +-1 bytes, bit j -> byte j (little-endian,
// the order of `pack_bits`): 0x01 if set, 0xFF if clear. The first
// multiply copies the 4-bit value to bit offsets 0, 7, 14 and 21; the
// copies do not overlap, so nothing carries, and bit j lands on bit 8j.
// Each byte of x is then 0 or 1, so x * 0xFE has bytes 0 or 0xFE (no
// carry either), and 0xFFFFFFFF minus it is its complement: 0x01 or
// 0xFF a byte.
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t nib) {
  const uint32_t x = ((nib & 0xFu) * 0x00204081u) & 0x01010101u;
  return 0xFFFFFFFFu - x * 0xFEu;
}

// One packed word -> 32 +-1 bytes at `dst` (16-byte aligned), byte t
// from bit t; 32 zero bytes when !live (a K word past the operand's end,
// which then adds nothing to any sum).
__device__ __forceinline__ void store_pm1_word(uint8_t* dst, uint32_t w, bool live) {
  uint32_t v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = live ? pm1_bytes(w >> (4 * q)) : 0u;
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// The "small_m" layout (K4, and K2/K5 at M <= 8): out^T = W^T X^T,
// the decoded weight columns the mma's A operand (16 columns a tile),
// decoded from the packed words straight into the fragment registers,
// and the <= 8 activation rows its n8 B operand. A warp owns 64 output
// columns and 4 K words at a time: lane (g, t) = (lane / 4, lane % 4)
// takes K word t of the four for columns 4g + q (w[q], fragment row g
// of tile q) and 32 + 4g + q (w[4 + q], row g + 8), q = 0..3, and the
// activations of that word for row g, so each lane reads whole 16-byte
// vectors of 4 neighbouring columns' words. K is permuted consistently
// on both sides (a sum is the same in any order).

// Words of K word `wd` for columns col..col+3, zeros past n (or when
// !live). `vec`: N % 4 == 0 and b 16-byte aligned, so 4 neighbouring
// columns' words are one vector.
__device__ __forceinline__ uint4 load_cols(const uint32_t* __restrict__ b, long long wd, int col,
                                           int n, bool live, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!live) return v;
  const uint32_t* row = b + wd * n;
  if (vec) {
    if (col < n) v = __ldg(reinterpret_cast<const uint4*>(row + col));
  } else {
    if (col < n) v.x = __ldg(row + col);
    if (col + 1 < n) v.y = __ldg(row + col + 1);
    if (col + 2 < n) v.z = __ldg(row + col + 2);
    if (col + 3 < n) v.w = __ldg(row + col + 3);
  }
  return v;
}

// K4's products: acc[q] += the 4 products of the lane's weight words w
// (above), decoded to +-1 bytes, with the B operand x. Product i takes
// bits 8i..8i+7 of each lane group's word: k-slots 4t..4t+3 bits
// 8i..8i+3 and 16+4t..16+4t+3 bits 8i+4..8i+7, x[2i] and x[2i + 1] for
// row g. acc[q] then holds rows 2t (c0, c2) and 2t + 1 (c1, c3) of
// columns 4g + q (c0, c1) and 32 + 4g + q (c2, c3).
__device__ __forceinline__ void small_m_products(int (&acc)[4][4], const uint32_t (&w)[8],
                                                 const uint32_t (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t af[4] = {
          pm1_bytes(w[q] >> (8 * i)), pm1_bytes(w[4 + q] >> (8 * i)),
          pm1_bytes(w[q] >> (8 * i + 4)), pm1_bytes(w[4 + q] >> (8 * i + 4))};
      mma(acc[q], af, x[2 * i], x[2 * i + 1]);
    }
  }
}

// Named barriers (ids 1..15; 0 is __syncthreads'): `count` threads,
// a multiple of 32, meet. arrive does not wait; sync waits for the count.
// arrive orders the thread's earlier memory accesses before the waiters'
// later ones, as a __syncthreads would.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The block-tile GEMM: a cluster of CS blocks (gridDim.z, the cluster
// along z) computes one BM x BN int32 tile of A B, each block a 1/CS
// share of the K stages; out = A B - bias.
//   A_BITS false (K4): a [M, 32 kw] int8 rows, 16-byte aligned, copied
//     by 16-byte `cp.async` into the stage, read by the products as they
//     arrive;
//   A_BITS true (K5): a [M, kw] packed words, copied by 4-byte `cp.async`
//     (a ragged kw leaves rows unaligned) and decoded to +-1 bytes;
//   b [kw, N] packed words, copied by 4-byte `cp.async` and decoded once
//     per block per K stage into a K-contiguous [BN][pitch] tile.
// Each stage is KWS words (32 KWS values) of K. The warps are
// specialised: WARPS_M x WARPS_N consumer warps own 16 MI x 32 sub-tiles
// (MI m16 x 4 n8 products a 32-value K slice) and only load fragments
// (`ldmatrix`) and multiply; as many producer warps copy stage kt while
// they decode stage kt - (STAGES - 2), so the copies, the decodes and the
// products of different stages overlap. A ring of STAGES stages in
// shared memory passes between them through named barriers: FULL[s]
// (the producers arrive once stage s is copied and decoded, the
// consumers wait) and EMPTY[s] (the reverse). Rows are padded by 16
// bytes, so the 8 rows an `ldmatrix` matrix or a decode store touches
// fall in distinct 16-byte bank groups.
//
// The K split fills the card where M / BM x N / BN blocks would leave
// SMs idle (a block walks its K stages in series): with CS > 1 each
// block stores each row of its partial tile into the shared memory of
// the block that owns the row (distributed shared memory), and after a
// cluster barrier each block sums and writes its own 1/CS of the rows.
// No output is zeroed and no atomic is used; the integer sums are exact
// in any order.
template <bool A_BITS>
struct TileGemm {
  // 2 x 2 consumer warps of 32 x 32, stages of 4 words (128 values of
  // K) in a ring of 3: 58-60 KB of shared memory, 3 blocks an SM.
  static constexpr int WARPS_M = 2, WARPS_N = 2, MI = 2, KWS = 4, STAGES = 3;
  static_assert(STAGES >= 3 && 2 * STAGES <= 15, "the ring's named barriers");
  static constexpr int WM = 16 * MI;  // a warp's rows
  static constexpr int BM = WM * WARPS_M;
  static constexpr int BN = 32 * WARPS_N;
  static constexpr int CONSUMERS = 32 * WARPS_M * WARPS_N;
  static constexpr int PRODUCERS = CONSUMERS;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int LAG = STAGES - 2;  // stages a producer copies ahead of its decode
  static constexpr int BK = 32 * KWS;  // K bytes a stage
  static constexpr int PITCH = BK + 16;
  // A stage: A rows [BM][PITCH] (int8, or decoded), A's raw words
  // [KWS][BM] (A_BITS), b's raw words [KWS][BN], b decoded [BN][PITCH].
  static constexpr int A_ROWS = BM * PITCH;
  static constexpr int A_RAW = A_BITS ? KWS * BM * 4 : 0;
  static constexpr int B_RAW = KWS * BN * 4;
  static constexpr int B_DEC = BN * PITCH;
  static constexpr int STAGE = A_ROWS + A_RAW + B_RAW + B_DEC;
  static constexpr int RED_PITCH = BN + 4;  // a partial tile row, int32
  // The CS slots of a K split's row share (at most BM + 7 rows) reuse
  // the stages' shared memory.
  static constexpr int RED = (BM + 8) * RED_PITCH * 4;
  static constexpr int SMEM = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  // Named barrier ids.
  static constexpr int FULL = 1;
  static constexpr int EMPTY = 1 + STAGES;
};

// The conv's geometry (CONV): xq [B, Hp, Wp, ciw] words, output rows
// m = (b, ho, wo) of [B, Ho, Wo], strides (sh, sw); base(m) =
// ((b Hp + ho sh) Wp + wo sw) ciw; koff [kw] the word offset of K word
// k = (dy kw + dx) ciw + t from base(m), (dy Wp + dx) ciw + t; scale [N].
struct ConvGeom {
  const int32_t* koff;
  const float* scale;
  int hp, wp, ciw, ho, wo, sh, sw;
};

template <bool CONV>
struct TileOut {
  using T = int32_t;
};
template <>
struct TileOut<true> {
  using T = float;
};

// The body of the tile GEMM kernels below (forced inline: each kernel
// compiles to its own code).
template <bool A_BITS, bool CONV>
__device__ __forceinline__ void tile_gemm_s8(const void* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             typename TileOut<CONV>::T* __restrict__ out, int m,
                                             int n, int kw, int bias, const ConvGeom& conv) {
  static_assert(A_BITS || !CONV, "the conv gathers packed activation words");
  using T = TileGemm<A_BITS>;
  constexpr int BM = T::BM, BN = T::BN, PITCH = T::PITCH, MI = T::MI, KWS = T::KWS;
  constexpr int STAGES = T::STAGES, WARPS_N = T::WARPS_N;
  extern __shared__ __align__(16) uint8_t smem[];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int cs = gridDim.z;
  const int nk_all = (kw + KWS - 1) / KWS;
  const int kt0 = static_cast<int>(static_cast<long long>(blockIdx.z) * nk_all / cs);
  const int nk = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * nk_all / cs) - kt0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid >= T::CONSUMERS) {
    // Producer p's share of a stage's copies and decodes, fixed for the
    // whole K loop: PRODUCERS divides every count, so the loops unroll,
    // and the global addresses advance by one stage per issue (stages
    // are issued in order), so a copy costs an add, a compare and the copy.
    const int p = tid - T::CONSUMERS;
    constexpr int CH = T::BK / 16;  // 16-byte chunks of an int8 A row a stage
    constexpr int NA = A_BITS ? BM * KWS / T::PRODUCERS : BM * CH / T::PRODUCERS;
    constexpr int NB = KWS * BN / T::PRODUCERS;
    static_assert(NA * T::PRODUCERS == (A_BITS ? BM * KWS : BM * CH), "A copies divide evenly");
    static_assert(NB * T::PRODUCERS == KWS * BN, "B copies divide evenly");
    const long long k_first = static_cast<long long>(kt0) * KWS;  // the block's first K word
    const uint8_t* a_src[NA];
    bool a_row[NA];
    int a_k[NA];  // the copy's K word (A_BITS) or 16-byte chunk (int8), first stage
    int a_off[CONV ? NA : 1];  // CONV: koff of the copy's next K word, loaded a stage ahead
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = p + i * T::PRODUCERS;
      const int r = A_BITS ? e % BM : e / CH;
      const int c = A_BITS ? e / BM : e % CH;
      a_row[i] = m0 + r < m;
      const long long row = a_row[i] ? m0 + r : 0;
      if constexpr (CONV) {
        // The row's first word; the K words' offsets come from koff.
        const int hw = conv.ho * conv.wo;
        const int bi = static_cast<int>(row / hw);
        const int yx = static_cast<int>(row - static_cast<long long>(bi) * hw);
        const int y = yx / conv.wo;
        const int x = yx - y * conv.wo;
        a_k[i] = static_cast<int>(k_first) + c;
        a_src[i] = static_cast<const uint8_t*>(a) +
                   4 * ((static_cast<long long>(bi) * conv.hp + y * conv.sh) * conv.wp +
                        static_cast<long long>(x) * conv.sw) *
                       conv.ciw;
        a_off[i] = a_row[i] && a_k[i] < kw ? __ldg(conv.koff + a_k[i]) : 0;
      } else if constexpr (A_BITS) {
        a_k[i] = static_cast<int>(k_first) + c;
        a_src[i] = static_cast<const uint8_t*>(a) + 4 * (row * kw + k_first + c);
      } else {
        a_k[i] = 2 * static_cast<int>(k_first) + c;
        a_src[i] = static_cast<const uint8_t*>(a) + row * 32LL * kw + 32 * k_first + 16 * c;
      }
    }
    const uint32_t* b_src[NB];
    bool b_col[NB];
    int b_k[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = p + i * T::PRODUCERS;
      b_col[i] = n0 + e % BN < n;
      b_k[i] = static_cast<int>(k_first) + e / BN;
      b_src[i] = b + (k_first + e / BN) * n + (b_col[i] ? n0 + e % BN : 0);
    }
    const uint32_t ring = smem_u32(smem);

    for (int kt = 0; kt < nk + T::LAG; ++kt) {
      if (kt < nk) {
        // Copy stage kt into its slot once the consumers are done with
        // stage kt - STAGES there.
        const int slot = kt % STAGES;
        if (kt >= STAGES) named_sync(T::EMPTY + slot, T::THREADS);
        const uint32_t st = ring + slot * T::STAGE;
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int e = p + i * T::PRODUCERS;
          if constexpr (CONV) {
            cp_async4(st + T::A_ROWS + 4 * e, a_src[i] + 4LL * a_off[i], a_row[i] && a_k[i] < kw);
            a_k[i] += KWS;
            a_off[i] = a_row[i] && a_k[i] < kw ? __ldg(conv.koff + a_k[i]) : 0;
          } else if constexpr (A_BITS) {
            cp_async4(st + T::A_ROWS + 4 * e, a_src[i], a_row[i] && a_k[i] < kw);
            a_src[i] += 4 * KWS;
            a_k[i] += KWS;
          } else {
            cp_async16(st + (e / CH) * PITCH + 16 * (e % CH), a_src[i],
                       a_row[i] && a_k[i] < 2 * kw);
            a_src[i] += T::BK;
            a_k[i] += 2 * KWS;
          }
        }
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int e = p + i * T::PRODUCERS;
          cp_async4(st + T::A_ROWS + T::A_RAW + 4 * e, b_src[i], b_col[i] && b_k[i] < kw);
          b_src[i] += static_cast<long long>(KWS) * n;
          b_k[i] += KWS;
        }
      }
      cp_async_commit();  // every iteration commits a group: fixed wait counts
      const int kd = kt - T::LAG;
      if (kd < 0) continue;
      // This thread's copies of stage kd have landed. It decodes only the
      // words it copied itself (the copy and the decode share the index
      // e), so its own wait suffices; its arrive on FULL then orders its
      // copies and decodes before the consumers' reads.
      cp_async_wait<T::LAG>();
      uint8_t* st = smem + (kd % STAGES) * T::STAGE;
      const int k0w = (kt0 + kd) * KWS;
      const uint32_t* bw = reinterpret_cast<const uint32_t*>(st + T::A_ROWS + T::A_RAW);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = p + i * T::PRODUCERS;
        const int j = e / BN;
        store_pm1_word(st + T::A_ROWS + T::A_RAW + T::B_RAW + (e % BN) * PITCH + 32 * j, bw[e],
                       k0w + j < kw);
      }
      if constexpr (A_BITS) {
        const uint32_t* aw = reinterpret_cast<const uint32_t*>(st + T::A_ROWS);
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int e = p + i * T::PRODUCERS;
          const int j = e / BM;
          store_pm1_word(st + (e % BM) * PITCH + 32 * j, aw[e], k0w + j < kw);
        }
      }
      named_arrive(T::FULL + kd % STAGES, T::THREADS);
    }
    if (cs == 1) return;
  }

  // Consumer warps: fragment (i, j, h) of warp (wm, wn) is row
  // wm WM + 16i + g + 8h, columns wn 32 + 8j + 2t and + 1 of the tile.
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;
  const int t = lane & 3;
  int acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  if (tid < T::CONSUMERS) {
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % STAGES;
      named_sync(T::FULL + slot, T::THREADS);
      const uint8_t* at = smem + slot * T::STAGE;
      const uint8_t* bt = at + T::A_ROWS + T::A_RAW + T::B_RAW;
#pragma unroll
      for (int kk = 0; kk < KWS; ++kk) {
        uint32_t af[MI][4], bf[2][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) load_a(af[i], at, PITCH, wm * T::WM + 16 * i, 32 * kk, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) load_b(bf[j], bt, PITCH, wn * 32 + 16 * j, 32 * kk, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma(acc[i][j], af[i], bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
      }
      // The producers wait for this slot only if a later stage needs it.
      if (kt + STAGES < nk) named_arrive(T::EMPTY + slot, T::THREADS);
    }

    if (cs == 1) {
      const bool pairs = (n & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * T::WM + 16 * i + g + 8 * h;
          if (row >= m) continue;
          auto* dst = out + static_cast<long long>(row) * n;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = n0 + wn * 32 + 8 * j + 2 * t;
            const int v0 = acc[i][j][2 * h] - bias;
            const int v1 = acc[i][j][2 * h + 1] - bias;
            if constexpr (CONV) {
              if (pairs && col + 1 < n) {
                *reinterpret_cast<float2*>(dst + col) =
                    make_float2(__fmul_rn(__int2float_rn(v0), __ldg(conv.scale + col)),
                                __fmul_rn(__int2float_rn(v1), __ldg(conv.scale + col + 1)));
              } else {
                if (col < n) dst[col] = __fmul_rn(__int2float_rn(v0), __ldg(conv.scale + col));
                if (col + 1 < n) {
                  dst[col + 1] = __fmul_rn(__int2float_rn(v1), __ldg(conv.scale + col + 1));
                }
              }
            } else if (pairs && col + 1 < n) {
              *reinterpret_cast<int2*>(dst + col) = make_int2(v0, v1);
            } else {
              if (col < n) dst[col] = v0;
              if (col + 1 < n) dst[col + 1] = v1;
            }
          }
        }
      }
      return;
    }
  }

  // The K split: block z owns rows [z BM / CS, (z + 1) BM / CS) of the
  // tile. Once every block of the cluster is past its K loop (the slots
  // reuse the stages), the consumers of every block store each of their
  // rows into slot (the block's rank) of the owner's shared memory
  // (stores into another block's shared memory do not wait for an
  // answer); after a second cluster barrier each block sums its CS slots
  // locally and writes its rows.
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  int32_t* red = reinterpret_cast<int32_t*>(smem);
  const int z = static_cast<int>(blockIdx.z);
  const int rows_max = (BM + cs - 1) / cs;  // a share, at most
  if (tid < T::CONSUMERS) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::WM + 16 * i + g + 8 * h;
        const int owner = ((r + 1) * cs - 1) / BM;
        int32_t* slot = cluster.map_shared_rank(red, owner) +
                        (z * rows_max + r - owner * BM / cs) * T::RED_PITCH;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn * 32 + 8 * j + 2 * t;
          *reinterpret_cast<int2*>(slot + c) = make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
  }
  cluster.sync();
  constexpr int QUADS = BN / 4;  // int4 groups of a tile row
  const int r_lo = z * BM / cs;
  const int share = ((z + 1) * BM / cs - r_lo) * QUADS;
  const bool quads = (n & 3) == 0;  // 16-byte aligned column quads
  for (int e = tid; e < share; e += T::THREADS) {
    const int lr = e / QUADS;
    const int c = 4 * (e % QUADS);
    int4 sum = make_int4(-bias, -bias, -bias, -bias);
    for (int rank = 0; rank < cs; ++rank) {
      const int4 v =
          *reinterpret_cast<const int4*>(red + (rank * rows_max + lr) * T::RED_PITCH + c);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    const int row = m0 + r_lo + lr;
    const int col = n0 + c;
    if (row >= m || col >= n) continue;
    auto* dst = out + static_cast<long long>(row) * n + col;
    if constexpr (CONV) {
      const float* sc = conv.scale + col;
      if (quads && col + 3 < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            __fmul_rn(__int2float_rn(sum.x), __ldg(sc)),
            __fmul_rn(__int2float_rn(sum.y), __ldg(sc + 1)),
            __fmul_rn(__int2float_rn(sum.z), __ldg(sc + 2)),
            __fmul_rn(__int2float_rn(sum.w), __ldg(sc + 3)));
      } else {
        dst[0] = __fmul_rn(__int2float_rn(sum.x), __ldg(sc));
        if (col + 1 < n) dst[1] = __fmul_rn(__int2float_rn(sum.y), __ldg(sc + 1));
        if (col + 2 < n) dst[2] = __fmul_rn(__int2float_rn(sum.z), __ldg(sc + 2));
        if (col + 3 < n) dst[3] = __fmul_rn(__int2float_rn(sum.w), __ldg(sc + 3));
      }
    } else if (quads && col + 3 < n) {
      *reinterpret_cast<int4*>(dst) = sum;
    } else {
      dst[0] = sum.x;
      if (col + 1 < n) dst[1] = sum.y;
      if (col + 2 < n) dst[2] = sum.z;
      if (col + 3 < n) dst[3] = sum.w;
    }
  }
}

// K4 (A_BITS false) and K5 (A_BITS true): out [M, N] int32 = A B - bias.
template <bool A_BITS>
__global__ void __launch_bounds__(TileGemm<A_BITS>::THREADS)
tile_gemm_s8_kernel(const void* __restrict__ a, const uint32_t* __restrict__ b,
                    int32_t* __restrict__ out, int m, int n, int kw, int bias) {
  tile_gemm_s8<A_BITS, false>(a, b, out, m, n, kw, bias, ConvGeom{});
}

// K3: out [M, N] fp32 = (A B - bias) * scale, A gathered from xq. A
// template, so that only the source that launches it compiles it.
template <bool A_BITS>
__global__ void __launch_bounds__(TileGemm<A_BITS>::THREADS)
conv_gemm_s8_kernel(const void* __restrict__ xq, const uint32_t* __restrict__ b,
                    float* __restrict__ out, int m, int n, int kw, int bias, ConvGeom conv) {
  tile_gemm_s8<A_BITS, true>(xq, b, out, m, n, kw, bias, conv);
}

// Launch the block-tile GEMM on `stream` (device `device` current): K4
// and K5's `tile_gemm_s8_kernel`, or with CONV K3's `conv_gemm_s8_kernel`
// (out fp32, `conv` its geometry).
// Where the M x N tiles fill at most half the card's SMs, the K split CS
// is the most that keeps the grid within one wave of resident blocks
// (occupancy x SMs), capped at a split of 2 stages a block and at 4
// blocks for K4, 3 for K5 and K3 (wider clusters measured slower on an
// H100, K5's at 4 already); otherwise, or with CS = 1, the launch is a
// plain one.
// Raises the kernel's dynamic shared memory limit once per device when
// it needs more than the default 48 KB.
template <bool A_BITS, bool CONV = false>
int launch_tile_gemm(const void* a, const void* b, void* out, int m, int n, int kw, int bias,
                     int device, cudaStream_t stream, const ConvGeom& conv = ConvGeom{}) {
  using T = TileGemm<A_BITS>;
  using Out = typename TileOut<CONV>::T;
  const auto kernel = [] {
    if constexpr (CONV) {
      return conv_gemm_s8_kernel<A_BITS>;
    } else {
      return tile_gemm_s8_kernel<A_BITS>;
    }
  }();
  static int sms[64] = {};       // per device: SMs, once the attribute is set
  static int resident[64] = {};  // per device: blocks an SM holds at once
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && T::SMEM > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[device], kernel, T::THREADS,
                                                          T::SMEM);
    }
    if (err != cudaSuccess || resident[device] < 1) {
      sms[device] = 0;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
  }
  const unsigned row_blocks = (m + T::BM - 1) / T::BM;
  const unsigned col_blocks = (n + T::BN - 1) / T::BN;
  if (col_blocks > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(row_blocks) * col_blocks;
  const int nk = (kw + T::KWS - 1) / T::KWS;
  long long cs = 1;
  if (2 * tiles <= sms[device]) {
    cs = static_cast<long long>(resident[device]) * sms[device] / tiles;
    const int max_split = A_BITS ? 3 : 4;
    if (cs > max_split) cs = max_split;
    if (cs > nk / 2) cs = nk / 2;
  }
  const uint32_t* bw = static_cast<const uint32_t*>(b);
  Out* o = static_cast<Out*>(out);
  if (cs <= 1) {
    if constexpr (CONV) {
      kernel<<<dim3(row_blocks, col_blocks), T::THREADS, T::SMEM, stream>>>(a, bw, o, m, n, kw,
                                                                           bias, conv);
    } else {
      kernel<<<dim3(row_blocks, col_blocks), T::THREADS, T::SMEM, stream>>>(a, bw, o, m, n, kw,
                                                                           bias);
    }
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, col_blocks, static_cast<unsigned>(cs));
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(cs);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (CONV) {
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a, bw, o, m, n, kw, bias, conv));
  } else {
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a, bw, o, m, n, kw, bias));
  }
}

}  // namespace s8
}  // namespace
