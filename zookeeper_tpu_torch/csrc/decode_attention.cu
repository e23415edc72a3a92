// K12 and K13: single-position decode attention over a slot cache (K12)
// or through per-slot page tables over a shared page pool (K13), one
// device routine for both.
//
// Replaces zookeeper_tpu/ops/attention.py `paged_decode_attention` (K12)
// and `pool_paged_decode_attention` (K13). q [slots, 1, h, d] fp32/bf16;
// K12 caches [slots, cap, h, d] in q's dtype; K13 pools [pages,
// page_size, h, d] in q's dtype, or int8 with fp32 scales [pages,
// page_size, h]; lengths [slots] int32; K13 tables [slots, max_pages]
// int32. Slot `s` attends its rows 0..len with len = clamp(lengths[s],
// 0, cap - 1) (K13: cap = max_pages * page_size, and a row's page is
// table[s, row / page_size] clipped to [0, pages - 1]). Output [slots,
// 1, h, d] in q's dtype.
//
// Numerics, as the TPU kernels: q.k and p.v in exact fp32 on widened
// values (an int8 value times its row's scale first), scores times
// `scale`, online softmax in fp32 with the running max started at the
// finite mask value, the accumulator divided by `l` once at the end. A
// row past `len` has weight exactly 0 in the reference, so it is never
// read: the live rows are the whole read.
//
// Bound on an H100: bytes. A step reads each slot's live K/V rows once
// (2 * (len + 1) * d values per slot and head) and does 4 flops per
// value read; decode is far below the card's flop:byte ratio.
//
// Design, head_dim <= 256 (`decode_attention_split_kernel`, one
// template for both, PAGED picking how a row is found: K12 at
// `(slot * cap + row) * h + head`, K13 through the page table). One
// block per (slot, head) walking its live rows in series would be 64
// blocks on 132 SMs at 8 slots x 8 heads, each capped by the bytes one
// SM keeps in flight; so the rows split into chunks of SPLIT_ROWS (256:
// 16 pages of 16), one block of 256 threads each (flash-decoding).
// Inside a block eight lanes share a row, each loading its d/8
// contiguous values in one vector load (16 B for a bf16 row of 64); the
// 32 lane groups walk the chunk's rows in a strided loop, four rows per
// group per iteration (fewer past head_dim 64) with all their loads
// issued first and the rows kept as raw words until the products widen
// them, so enough bytes are in flight (`attend_rows`). A score is eight
// partial dot products summed by three xor-shuffles inside the group.
// Each group keeps its own running max, sum and accumulator (the TPU
// kernel's sequential kv grid axis becomes this loop); the 32 partial
// states are merged in shared memory into the block's state (m, l, o),
// which goes to a workspace, and the last block of a (slot, head)
// merges the chunks in a fixed order, chunk 0 first, in the same launch
// (see the kernel). Lengths and the page table are read by the block
// itself, in place of the TPU's scalar prefetch.
//
// Head_dims above 256 (`decode_attention_wide_kernel`): the same block
// and numerics over chunks of 256 dims (32 a lane), one row per lane
// group per iteration. A score sums its partial products over every
// chunk of q and the K row; the output is produced one 256-dim chunk per
// pass over the rows, each pass recomputing the same scores and softmax
// in the same order, then merged and written as above. Shared memory
// stays the 256-dim kernel's; the price is ceil(d / 256) passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LPR = 8;                 // lanes per row
constexpr int GROUPS = THREADS / LPR;  // rows in flight per block step
constexpr float MASK_VALUE = -0.5f * FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
template <>
__device__ __forceinline__ int8_t zero_value<int8_t>() { return 0; }

// N consecutive values of a K or V row kept as raw 32-bit words. Rows
// are widened to fp32 only where a product needs them, so the loads of
// all rows of an iteration are in flight together (a widening right
// after a load would wait for it).
template <typename T, int N>
struct RawRow {
  static constexpr int BYTES = N * static_cast<int>(sizeof(T));
  alignas(16) uint32_t w[(BYTES + 3) / 4];

  __device__ __forceinline__ float get(int i) const {
    return to_float(reinterpret_cast<const T*>(w)[i]);
  }

  // Load from p: vector loads when `full` (p aligned to BYTES), else
  // one value at a time with values past `n_valid` read as 0.
  __device__ __forceinline__ void load(const T* __restrict__ p, bool full,
                                       int n_valid) {
    if (full && BYTES % 16 == 0) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        reinterpret_cast<uint4*>(w)[i] = reinterpret_cast<const uint4*>(p)[i];
      }
    } else if (full && BYTES % 8 == 0) {
#pragma unroll
      for (int i = 0; i < BYTES / 8; ++i) {
        reinterpret_cast<uint2*>(w)[i] = reinterpret_cast<const uint2*>(p)[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        reinterpret_cast<T*>(w)[i] = i < n_valid ? p[i] : zero_value<T>();
      }
    }
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < (BYTES + 3) / 4; ++i) w[i] = 0u;
  }
};

struct Geometry {
  int h, d;
  // K12: rows of a slot are contiguous, `cap` of them.
  int cap;
  // K13: the pool and the slot's table row.
  const int* table;
  int max_pages, num_pages, page_size;
};

// Element offset of (slot, row, head)'s first value, and the index of
// its (page, offset, head) scale for K13.
template <bool PAGED>
__device__ __forceinline__ long long row_offset(const Geometry& g, int slot,
                                                int r, int hh,
                                                long long* scale_idx) {
  if (PAGED) {
    int page = g.table[static_cast<long long>(slot) * g.max_pages + r / g.page_size];
    page = min(max(page, 0), g.num_pages - 1);
    const long long row = static_cast<long long>(page) * g.page_size + r % g.page_size;
    *scale_idx = row * g.h + hh;
    return (row * g.h + hh) * g.d;
  }
  *scale_idx = 0;
  return ((static_cast<long long>(slot) * g.cap + r) * g.h + hh) * g.d;
}

// Rows a slot can hold: K12's capacity, K13's pages times page size.
template <bool PAGED>
__device__ __host__ __forceinline__ int slot_rows(const Geometry& g) {
  return PAGED ? g.max_pages * g.page_size : g.cap;
}

// One lane group's online softmax over rows r_first..r_last of (slot,
// head hh), strided over the block's lane groups, UNROLL rows a group an
// iteration: updates the group's running max m, sum l and accumulator
// acc (this lane's DL dims from d0), rows found as `row_offset<PAGED>`.
template <bool PAGED, typename KT, int DL, int UNROLL>
__device__ __forceinline__ void attend_rows(
    const Geometry& g, int slot, int hh, int group, int d0, int n_valid, bool full,
    const float (&qv)[DL], int r_first, int r_last, const KT* __restrict__ kbuf,
    const KT* __restrict__ vbuf, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, float scale, float& m, float& l, float (&acc)[DL]) {
  // Every lane runs the same trip count (the bound is per block), so
  // the full-mask shuffles below are always legal; dead rows are
  // predicated off.
  for (int r0 = r_first; r0 <= r_last; r0 += GROUPS * UNROLL) {
    RawRow<KT, DL> kv[UNROLL], vv[UNROLL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * GROUPS + group;
      ksc[u] = 1.0f;
      vsc[u] = 1.0f;
      if (r <= r_last) {
        long long sidx;
        const long long off = row_offset<PAGED>(g, slot, r, hh, &sidx) + d0;
        kv[u].load(kbuf + off, full, n_valid);
        vv[u].load(vbuf + off, full, n_valid);
        if (PAGED && k_scale != nullptr) {  // K12 has no scales
          ksc[u] = k_scale[sidx];
          vsc[u] = v_scale[sidx];
        }
      } else {
        kv[u].clear();
        vv[u].clear();
      }
    }
    float sc[UNROLL];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < DL; ++i) dot = fmaf(qv[i], kv[u].get(i) * ksc[u], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      const int r = r0 + u * GROUPS + group;
      // -inf, not the mask value: a dead row must weigh exactly 0 even
      // before this group has seen a live row.
      sc[u] = r <= r_last ? dot * scale : -INFINITY;
      m_new = fmaxf(m_new, sc[u]);
    }
    const float corr = expf(m - m_new);
    float p_sum = 0.0f;
    float pv[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) pv[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = expf(sc[u] - m_new);
      p_sum += p;
#pragma unroll
      for (int i = 0; i < DL; ++i) pv[i] = fmaf(p, vv[u].get(i) * vsc[u], pv[i]);
    }
    m = m_new;
    l = l * corr + p_sum;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = acc[i] * corr + pv[i];
  }
}

// K12 and K13 split over the rows (flash-decoding): block (pair, c) of
// pair = slot * h + head takes rows c * SPLIT_ROWS.. of its slot
// (`attend_rows`), and merges its lane groups into one unnormalised
// state (m, l, o[d]). A slot whose rows fit one chunk writes o / l at
// once. Otherwise each block stores its state in `part`
// [pairs][gridDim.y][d + 2] (m, l, o), and the last block of the pair
// to finish (a ticket counted in `tickets[pair]`, which it resets to
// 0) merges the chunks in order, chunk 0 first, and writes o / l: the
// same bits whichever block merges. Blocks past their slot's length exit
// at once (the grid is sized from the capacity: the lengths live on the
// device).
constexpr int SPLIT_ROWS = 256;

template <typename QT, typename KT, bool PAGED, int DL,
          int UNROLL = (DL >= 32 ? 1 : (DL >= 16 ? 2 : 4))>
__global__ void __launch_bounds__(THREADS)
decode_attention_split_kernel(const QT* __restrict__ q, long long q_sb, long long q_sh,
                              const KT* __restrict__ kbuf, const KT* __restrict__ vbuf,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ lengths, QT* __restrict__ out,
                              float* __restrict__ part, int* __restrict__ tickets, Geometry g,
                              float scale) {
  __shared__ float s_m[GROUPS];
  __shared__ float s_l[GROUPS];
  __shared__ float s_acc[GROUPS][DL * LPR];
  __shared__ float s_w[GROUPS];  // each group's weight in the block's merge
  __shared__ float s_mb;         // the block's running max
  __shared__ bool s_last;
  static_assert(GROUPS == 32, "one warp merges the groups' maxima");

  const int pair = blockIdx.x;
  const int slot = pair / g.h;
  const int hh = pair % g.h;
  const int len = min(max(lengths[slot], 0), slot_rows<PAGED>(g) - 1);
  const int chunks = len / SPLIT_ROWS + 1;
  const int c = blockIdx.y;
  if (c >= chunks) return;
  const int group = threadIdx.x / LPR;
  const int sub = threadIdx.x % LPR;
  const int d0 = sub * DL;
  const int n_valid = min(DL, max(g.d - d0, 0));
  const bool full = (g.d == DL * LPR);

  float qv[DL];
  {
    const QT* q_row = q + slot * q_sb + hh * q_sh + d0;
#pragma unroll
    for (int i = 0; i < DL; ++i) qv[i] = i < n_valid ? to_float(q_row[i]) : 0.0f;
  }
  float m = MASK_VALUE;
  float l = 0.0f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.0f;
  const int r_first = c * SPLIT_ROWS;
  attend_rows<PAGED, KT, DL, UNROLL>(g, slot, hh, group, d0, n_valid, full, qv, r_first,
                                     min(r_first + SPLIT_ROWS - 1, len), kbuf, vbuf, k_scale,
                                     v_scale, scale, m, l, acc);

  // Merge the groups' partial softmax states into the block's: warp 0
  // takes the max and each group's weight once, then every output dim
  // sums the groups in order.
  if (sub == 0) {
    s_m[group] = m;
    s_l[group] = l;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) s_acc[group][d0 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    const float mk = s_m[threadIdx.x];
    float mb = fmaxf(mk, MASK_VALUE);
#pragma unroll
    for (int o = GROUPS / 2; o > 0; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    s_w[threadIdx.x] = expf(mk - mb);
    if (threadIdx.x == 0) s_mb = mb;
  }
  __syncthreads();
  const int j = threadIdx.x;  // the output dim this thread merges
  const float m_blk = s_mb;
  float l_blk = 0.0f, o_blk = 0.0f;
  if (j < g.d) {
    for (int k = 0; k < GROUPS; ++k) {
      l_blk = fmaf(s_l[k], s_w[k], l_blk);
      o_blk = fmaf(s_acc[k][j], s_w[k], o_blk);
    }
  }
  QT* dst = out + static_cast<long long>(pair) * g.d + j;
  if (chunks == 1) {
    if (j < g.d) store(dst, o_blk / l_blk);
    return;
  }
  const int pitch = g.d + 2;
  float* pair_part = part + static_cast<long long>(pair) * gridDim.y * pitch;
  if (j < g.d) {
    float* mine = pair_part + c * pitch;
    mine[2 + j] = o_blk;
    if (j == 0) {
      mine[0] = m_blk;
      mine[1] = l_blk;
    }
  }
  // Publish the state before the ticket; the last block reads every
  // chunk's state from L2 after taking it.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + pair, 1) == chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (j < g.d) {
    float m_all = MASK_VALUE;
    for (int k = 0; k < chunks; ++k) m_all = fmaxf(m_all, __ldcg(pair_part + k * pitch));
    float l_all = 0.0f, o = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      const float* st = pair_part + k * pitch;
      const float w = expf(__ldcg(st) - m_all);
      l_all = fmaf(__ldcg(st + 1), w, l_all);
      o = fmaf(__ldcg(st + 2 + j), w, o);
    }
    store(dst, o / l_all);
  }
  if (threadIdx.x == 0) tickets[pair] = 0;
}

// Head_dim > 256: chunks of WDL * LPR dims; see the file comment.
constexpr int WDL = 32;
constexpr int WCH = WDL * LPR;  // 256

template <typename QT, typename KT, bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_attention_wide_kernel(const QT* __restrict__ q, long long q_sb,
                             long long q_sh, const KT* __restrict__ kbuf,
                             const KT* __restrict__ vbuf,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ lengths,
                             QT* __restrict__ out, Geometry g, float scale) {
  __shared__ float s_m[GROUPS];
  __shared__ float s_l[GROUPS];
  __shared__ float s_acc[GROUPS][WCH];

  const int slot = blockIdx.x / g.h;
  const int hh = blockIdx.x % g.h;
  const int group = threadIdx.x / LPR;
  const int sub = threadIdx.x % LPR;
  const int len = min(max(lengths[slot], 0), slot_rows<PAGED>(g) - 1);
  const int chunks = (g.d + WCH - 1) / WCH;
  // Vector loads need every lane's 32 values 16-byte aligned: rows of d
  // values keep that when d values fill a multiple of 16 bytes.
  const bool aligned = (static_cast<long long>(g.d) * sizeof(KT)) % 16 == 0;
  const QT* q_row = q + slot * q_sb + hh * q_sh;

  for (int oc = 0; oc < chunks; ++oc) {
    const int d0_out = oc * WCH + sub * WDL;
    const int n_out = min(WDL, max(g.d - d0_out, 0));
    float m = MASK_VALUE;
    float l = 0.0f;
    float acc[WDL];
#pragma unroll
    for (int i = 0; i < WDL; ++i) acc[i] = 0.0f;

    // Every lane runs the same trip count, as in the narrow kernel.
    for (int r0 = 0; r0 <= len; r0 += GROUPS) {
      const int r = r0 + group;
      const bool row_live = r <= len;
      long long off = 0, sidx = 0;
      float ksc = 1.0f, vsc = 1.0f;
      if (row_live) {
        off = row_offset<PAGED>(g, slot, r, hh, &sidx);
        if (k_scale != nullptr) {
          ksc = k_scale[sidx];
          vsc = v_scale[sidx];
        }
      }
      float dot = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        const int d0 = c * WCH + sub * WDL;
        const int n_valid = min(WDL, max(g.d - d0, 0));
        RawRow<KT, WDL> kr;
        if (row_live) {
          kr.load(kbuf + off + d0, aligned && n_valid == WDL, n_valid);
        } else {
          kr.clear();
        }
#pragma unroll
        for (int i = 0; i < WDL; ++i) {
          const float qv = i < n_valid ? to_float(q_row[d0 + i]) : 0.0f;
          dot = fmaf(qv, kr.get(i) * ksc, dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      // -inf, not the mask value: a dead row must weigh exactly 0 even
      // before this group has seen a live row.
      const float sc = row_live ? dot * scale : -INFINITY;
      const float m_new = fmaxf(m, sc);
      const float corr = expf(m - m_new);
      const float p = expf(sc - m_new);
      RawRow<KT, WDL> vr;
      if (row_live) {
        vr.load(vbuf + off + d0_out, aligned && n_out == WDL, n_out);
      } else {
        vr.clear();
      }
      m = m_new;
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < WDL; ++i) acc[i] = acc[i] * corr + fmaf(p, vr.get(i) * vsc, 0.0f);
    }

    // Merge the groups' partial softmax states for this chunk.
    __syncthreads();  // the previous chunk's merge is done
    if (sub == 0) {
      s_m[group] = m;
      s_l[group] = l;
    }
#pragma unroll
    for (int i = 0; i < WDL; ++i) s_acc[group][sub * WDL + i] = acc[i];
    __syncthreads();
    if (oc * WCH + threadIdx.x < g.d) {
      float m_all = MASK_VALUE;
      for (int j = 0; j < GROUPS; ++j) m_all = fmaxf(m_all, s_m[j]);
      float l_all = 0.0f, o = 0.0f;
      for (int j = 0; j < GROUPS; ++j) {
        const float w = expf(s_m[j] - m_all);
        l_all = fmaf(s_l[j], w, l_all);
        o = fmaf(s_acc[j][threadIdx.x], w, o);
      }
      store(out + (static_cast<long long>(slot) * g.h + hh) * g.d + oc * WCH + threadIdx.x,
            o / l_all);
    }
  }
}

// The design for q's dtype code and head_dim d, K12's and K13's alike:
// 0 the row split, 1 the chunked wide kernel; -1 for a shape no kernel
// takes.
int variant(int q_dtype, int d) {
  if ((q_dtype != 0 && q_dtype != 1) || d < 1) return -1;
  return d <= 256 ? 0 : 1;
}

// Chunks of SPLIT_ROWS rows a (slot, head) of the row split can have.
int split_chunks(int rows) {
  return static_cast<int>((static_cast<long long>(rows) + SPLIT_ROWS - 1) / SPLIT_ROWS);
}

// K12 (PAGED false) or K13: the row split up to head_dim 256 (`part` and
// `tickets` its workspace, see `decode_attention_split_kernel`), else the
// wide kernel.
template <typename QT, typename KT, bool PAGED>
cudaError_t launch(const void* q, long long q_sb, long long q_sh, const void* k,
                   const void* v, const float* k_scale, const float* v_scale,
                   const int* lengths, void* out, int slots, const Geometry& g,
                   float scale, cudaStream_t stream, float* part, int* tickets) {
  const QT* qp = static_cast<const QT*>(q);
  const KT* kp = static_cast<const KT*>(k);
  const KT* vp = static_cast<const KT*>(v);
  QT* op = static_cast<QT*>(out);
  if (g.d > 256) {
    decode_attention_wide_kernel<QT, KT, PAGED><<<slots * g.h, THREADS, 0, stream>>>(
        qp, q_sb, q_sh, kp, vp, k_scale, v_scale, lengths, op, g, scale);
    return cudaGetLastError();
  }
  const dim3 grid(slots * g.h, split_chunks(slot_rows<PAGED>(g)));
#define ZK_SPLIT_LAUNCH(DL)                                                       \
  decode_attention_split_kernel<QT, KT, PAGED, DL><<<grid, THREADS, 0, stream>>>( \
      qp, q_sb, q_sh, kp, vp, k_scale, v_scale, lengths, op, part, tickets, g, scale)
  if (g.d <= 32) {
    ZK_SPLIT_LAUNCH(4);
  } else if (g.d <= 64) {
    ZK_SPLIT_LAUNCH(8);
  } else if (g.d <= 128) {
    ZK_SPLIT_LAUNCH(16);
  } else {
    ZK_SPLIT_LAUNCH(32);
  }
#undef ZK_SPLIT_LAUNCH
  return cudaGetLastError();
}

// The row split needs its workspace, and at most 65535 chunks a slot.
bool split_ready(int q_dtype, int d, int rows, const void* part, const void* tickets) {
  return variant(q_dtype, d) != 0 ||
         (part != nullptr && tickets != nullptr && split_chunks(rows) <= 65535);
}

}  // namespace

// K12. dtype_code: 0 = float32, 1 = bfloat16 (q and the caches). q is
// read through its slot and head strides (elements); the caches, the
// lengths and the output are contiguous; part and tickets the row
// split's workspace (see `zk_decode_attention_workspace`, rows = cap).
// Returns a cudaError_t.
extern "C" int zk_paged_decode_attention(const void* q, long long q_sb, long long q_sh,
                                         const void* k, const void* v, const void* lengths,
                                         void* out, void* part, void* tickets, int dtype_code,
                                         int slots, int cap, int h, int d, float scale,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots <= 0 || h <= 0 || d <= 0) return 0;
  if (cap <= 0 || !split_ready(dtype_code, d, cap, part, tickets)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{h, d, cap, nullptr, 0, 0, 0};
  const int* lens = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) {
    err = launch<float, float, false>(q, q_sb, q_sh, k, v, nullptr, nullptr, lens, out, slots,
                                      g, scale, st, pt, tk);
  } else if (dtype_code == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16, false>(q, q_sb, q_sh, k, v, nullptr, nullptr,
                                                      lens, out, slots, g, scale, st, pt, tk);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K12's and K13's design for q's dtype code and head_dim (see `variant`).
extern "C" int zk_decode_attention_variant(int q_dtype, int d) { return variant(q_dtype, d); }

// Floats of the row split's workspace `part` for slots of `rows` rows
// (K12: the capacity; K13: max_pages * page_size), 0 when the geometry
// takes the wide kernel; `tickets` holds slots * h int32 that start at 0
// (each launch leaves them at 0). Launches that share a workspace must
// run in order (one stream).
extern "C" long long zk_decode_attention_workspace(int slots, int rows, int h, int d) {
  if (variant(0, d) != 0 || slots <= 0 || h <= 0 || rows <= 0) return 0;
  return static_cast<long long>(slots) * h * split_chunks(rows) * (d + 2);
}

// K13. q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: the same codes, or
// 2 = int8 with k_scale/v_scale [pages, page_size, h] float32 (null for
// float pools); part and tickets the row split's workspace (see
// `zk_decode_attention_workspace`, rows = max_pages * page_size).
// Returns a cudaError_t.
extern "C" int zk_pool_paged_decode_attention(
    const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* lengths, void* out, void* part, void* tickets,
    int q_dtype, int kv_dtype, int slots, int max_pages, int num_pages, int page_size,
    int h, int d, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots <= 0 || h <= 0 || d <= 0) return 0;
  if (max_pages <= 0 || num_pages <= 0 || page_size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!split_ready(q_dtype, d, max_pages * page_size, part, tickets)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{h, d, 0, static_cast<const int*>(table), max_pages,
                   num_pages, page_size};
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* lens = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch<float, float, true>(q, q_sb, q_sh, k, v, ks, vs, lens, out, slots, g, scale,
                                     st, pt, tk);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16, true>(q, q_sb, q_sh, k, v, ks, vs, lens, out,
                                                     slots, g, scale, st, pt, tk);
  } else if (q_dtype == 0 && quant) {
    err = launch<float, int8_t, true>(q, q_sb, q_sh, k, v, ks, vs, lens, out, slots, g, scale,
                                      st, pt, tk);
  } else if (q_dtype == 1 && quant) {
    err = launch<__nv_bfloat16, int8_t, true>(q, q_sb, q_sh, k, v, ks, vs, lens, out, slots, g,
                                              scale, st, pt, tk);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
