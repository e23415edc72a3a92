// Native host kernels of the port's input pipeline: C++ with threads
// where per-example Python or numpy is slow. The port's own copy of the
// JAX package's source, built and loaded by ../__init__.py (g++, a C ABI
// read through ctypes), so the two packages assemble the same bytes.
//
// Functions:
//   zk_pack_bits_f32     — pack float sign bits into int32 words, bit j
//                          of word w the sign of element 32*w + j.
//   zk_gather_normalize_u8 — fused batch assembly: gather examples by
//                          index from a uint8 image store and emit
//                          normalized float32 (scale*x + shift).
//   zk_gather_augment_normalize_u8 — the AUGMENTED fused batch assembly:
//                          per-example RandomResizedCrop (bilinear) or
//                          reflect-pad+crop (the CIFAR recipe), flip,
//                          and normalize in one pass over the store,
//                          bit-identical to the per-example Python path
//                          through the shared counter RNG
//                          (data/augrng.py).
//   zk_xnor_gemm_ref     — bit-serial XNOR-popcount GEMM on packed words,
//                          a host reference of the popcount GEMMs.
//
// Build: see ../__init__.py (g++ -O3 -shared -fPIC, plain std::thread).
// -ffp-contract=off is REQUIRED: the augmented kernel's bit-identity
// contract with numpy depends on mul+add staying two rounded ops (an
// auto-contracted FMA would flip the last ulp of every bilinear tap).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

// Run fn(first, last) over [0, total) split across threads.
// ``grain`` is the minimum work units per thread: element-granular
// kernels keep the historical 1024 floor; per-EXAMPLE kernels (one unit
// = a whole image's worth of augmentation) use grain=1 so a batch of 64
// still fans out across every host core.
template <typename Fn>
void parallel_for(int64_t total, Fn fn, int max_threads = 0,
                  int64_t grain = 1024) {
  int n_threads = max_threads > 0 ? max_threads : hardware_threads();
  if (total < 2 * grain || n_threads <= 1) {
    fn(static_cast<int64_t>(0), total);
    return;
  }
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, (total + grain - 1) / grain));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (total + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t first = t * chunk;
    int64_t last = std::min<int64_t>(first + chunk, total);
    if (first >= last) break;
    threads.emplace_back([=] { fn(first, last); });
  }
  for (auto& th : threads) th.join();
}

// ---- Shared augmentation RNG (C++ twin of data/augrng.py) -----------
//
// splitmix64 counter keyed by (seed, example index, epoch). Every
// derived draw uses only exactly-rounded double ops so the Python
// reference and this kernel consume the identical stream and produce
// bit-identical pixels. Any change here MUST be mirrored in augrng.py.

constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;

inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct AugRng {
  uint64_t state;
  AugRng(uint64_t seed, uint64_t index, uint64_t epoch) {
    uint64_t s = mix64(seed + kGolden);
    s = mix64((s ^ index) + kGolden);
    s = mix64((s ^ epoch) + kGolden);
    state = s;
  }
  uint64_t next_u64() {
    state += kGolden;
    return mix64(state);
  }
  double uniform(double lo, double hi) {
    double d = static_cast<double>(next_u64() >> 11) *
               (1.0 / 9007199254740992.0);  // exactly 2^-53
    return lo + (hi - lo) * d;
  }
  int64_t randint(int64_t n) {
    return static_cast<int64_t>(next_u64() % static_cast<uint64_t>(n));
  }
};

// exp(u) as the SAME fixed-order Horner polynomial as
// augrng.recipe_exp — bit-identical by construction, ~1 ulp for
// |u| <= 2 (libm exp may differ in the last ulp between platforms,
// which would desync the aspect draw).
inline double recipe_exp(double u) {
  double acc = 1.0;
  for (int k = 21; k >= 1; --k) acc = 1.0 + acc * (u / k);
  return acc;
}

// ---- Augmented assembly helpers -------------------------------------

// px -> px / 255.0f, precomputed. The table entries are the EXACT
// results of float division (the numpy reference's op), so using it is
// a pure speedup, not a rounding change (a reciprocal-multiply would
// flip ulps).
inline const float* u8_to_unit_lut() {
  static const struct Lut {
    float v[256];
    Lut() {
      for (int i = 0; i < 256; ++i) v[i] = static_cast<float>(i) / 255.0f;
    }
  } lut;
  return lut.v;
}

// Bilinear resize of the crop window [top, top+crop_h) x [left,
// left+crop_w) of a (src_h, src_w, channels) uint8 image into
// (out_h, out_w, channels) float32 in [0, 1]. Half-pixel centers
// (align_corners=False), clamped edges. Tap values are px/255.0f and
// the interpolation is float32 mul+add in the numpy reference's exact
// op order (weights computed in double, cast to float).
void bilinear_crop_resize(const uint8_t* src, int64_t src_h, int64_t src_w,
                          int64_t channels, int64_t top, int64_t left,
                          int64_t crop_h, int64_t crop_w, float* dst,
                          int64_t out_h, int64_t out_w) {
  const float* lut = u8_to_unit_lut();
  const double sy_scale = static_cast<double>(crop_h) /
                          static_cast<double>(out_h);
  const double sx_scale = static_cast<double>(crop_w) /
                          static_cast<double>(out_w);
  // Column coordinates are y-invariant: compute once per call, not per
  // row (the double floor/clamp chain dominated the inner loop).
  std::vector<int64_t> x0s(out_w), x1s(out_w);
  std::vector<float> fxs(out_w);
  for (int64_t x = 0; x < out_w; ++x) {
    const double sx = (static_cast<double>(x) + 0.5) * sx_scale - 0.5;
    const double x0d = std::floor(sx);
    fxs[x] = static_cast<float>(sx - x0d);
    int64_t x0 = static_cast<int64_t>(x0d);
    int64_t x1 = x0 + 1;
    x0s[x] = x0 < 0 ? 0 : (x0 > crop_w - 1 ? crop_w - 1 : x0);
    x1s[x] = x1 < 0 ? 0 : (x1 > crop_w - 1 ? crop_w - 1 : x1);
  }
  for (int64_t y = 0; y < out_h; ++y) {
    const double sy = (static_cast<double>(y) + 0.5) * sy_scale - 0.5;
    const double y0d = std::floor(sy);
    const float fy = static_cast<float>(sy - y0d);
    const float wy0 = 1.0f - fy;
    int64_t y0 = static_cast<int64_t>(y0d);
    int64_t y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 > crop_h - 1 ? crop_h - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 > crop_h - 1 ? crop_h - 1 : y1);
    const uint8_t* row0 = src + ((top + y0) * src_w + left) * channels;
    const uint8_t* row1 = src + ((top + y1) * src_w + left) * channels;
    float* orow = dst + y * out_w * channels;
    for (int64_t x = 0; x < out_w; ++x) {
      const float fx = fxs[x];
      const float wx0 = 1.0f - fx;
      const uint8_t* c00 = row0 + x0s[x] * channels;
      const uint8_t* c01 = row0 + x1s[x] * channels;
      const uint8_t* c10 = row1 + x0s[x] * channels;
      const uint8_t* c11 = row1 + x1s[x] * channels;
      for (int64_t c = 0; c < channels; ++c) {
        const float tp = lut[c00[c]] * wx0 + lut[c01[c]] * fx;
        const float bt = lut[c10[c]] * wx0 + lut[c11[c]] * fx;
        orow[x * channels + c] = tp * wy0 + bt * fy;
      }
    }
  }
}

// numpy 'reflect' (no repeated edge) index for j in [-(n-1), 2n-2).
inline int64_t reflect_index(int64_t j, int64_t n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * n - 2 - j;
  return j;
}

}  // namespace

extern "C" {

// in:  [rows, cols] float32, cols % 32 == 0.
// out: [rows, cols/32] int32; bit j of word w is in[r, 32*w + j] >= 0.
void zk_pack_bits_f32(const float* in, int32_t* out, int64_t rows,
                      int64_t cols) {
  const int64_t words = cols / 32;
  parallel_for(rows, [=](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const float* row = in + r * cols;
      int32_t* orow = out + r * words;
      for (int64_t w = 0; w < words; ++w) {
        uint32_t acc = 0;
        const float* src = row + w * 32;
        for (int b = 0; b < 32; ++b) {
          acc |= (src[b] >= 0.0f ? 1u : 0u) << b;
        }
        orow[w] = static_cast<int32_t>(acc);
      }
    }
  });
}

// Gather batch rows by index from a uint8 store and normalize to float32.
// store:   [num_examples, example_size] uint8 (contiguous per example)
// indices: [batch] int64 row indices
// out:     [batch, example_size] float32 = scale * x + shift
void zk_gather_normalize_u8(const uint8_t* store, const int64_t* indices,
                            float* out, int64_t batch, int64_t example_size,
                            float scale, float shift) {
  parallel_for(batch, [=](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const uint8_t* src = store + indices[b] * example_size;
      float* dst = out + b * example_size;
      for (int64_t i = 0; i < example_size; ++i) {
        dst[i] = scale * static_cast<float>(src[i]) + shift;
      }
    }
  });
}

// Fused AUGMENTED batch assembly: for each batch row, gather example
// indices[b] from a (num_examples, src_h, src_w, channels) uint8 store,
// apply the training augmentation recipe, and emit (out_h, out_w,
// channels) float32 — one pass, parallelized per example across host
// cores. Bit-identical to the Python reference
// (ImageClassificationPreprocessing.input with augment=True) via the
// shared (seed, index, epoch) counter RNG; draw order is part of the
// contract:
//
//   RRC mode (random_resized_crop != 0): up to 10 rejection tries of
//     (area uniform, log-aspect uniform via recipe_exp), on acceptance
//     (top randint, left randint), bilinear resize of the crop; the
//     deterministic center-square fallback consumes no further draws.
//   CIFAR mode: if pad_pixels > 0, (oy randint, ox randint) crop of the
//     reflect-padded image (requires src == out spatial shape).
//   Then: one flip coin iff random_flip, column-reversing the image.
//   Then: v * post_scale + post_shift elementwise (v is the /255.0f
//     float image, matching the Python path's normalize-then-augment
//     -then-zero-center op order exactly).
void zk_gather_augment_normalize_u8(
    const uint8_t* store, const int64_t* indices, float* out,
    int64_t batch, int64_t src_h, int64_t src_w, int64_t channels,
    int64_t out_h, int64_t out_w, int64_t seed, int64_t epoch,
    int32_t random_resized_crop, double scale_lo, double scale_hi,
    double log_aspect_lo, double log_aspect_hi, int32_t pad_pixels,
    int32_t random_flip, float post_scale, float post_shift) {
  const int64_t example_size = src_h * src_w * channels;
  const int64_t out_size = out_h * out_w * channels;
  parallel_for(
      batch,
      [=](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
          const int64_t idx = indices[b];
          const uint8_t* src = store + idx * example_size;
          float* dst = out + b * out_size;
          AugRng rng(static_cast<uint64_t>(seed),
                     static_cast<uint64_t>(idx),
                     static_cast<uint64_t>(epoch));
          if (random_resized_crop) {
            const double area =
                static_cast<double>(src_h) * static_cast<double>(src_w);
            int64_t ch = -1, cw = -1, top = 0, left = 0;
            for (int t = 0; t < 10; ++t) {
              const double target_area =
                  area * rng.uniform(scale_lo, scale_hi);
              const double aspect =
                  recipe_exp(rng.uniform(log_aspect_lo, log_aspect_hi));
              const int64_t cwt = std::llrint(std::sqrt(target_area * aspect));
              const int64_t cht = std::llrint(std::sqrt(target_area / aspect));
              if (cwt > 0 && cwt <= src_w && cht > 0 && cht <= src_h) {
                cw = cwt;
                ch = cht;
                top = rng.randint(src_h - ch + 1);
                left = rng.randint(src_w - cw + 1);
                break;
              }
            }
            if (ch < 0) {  // deterministic center-square fallback
              const int64_t side = src_h < src_w ? src_h : src_w;
              ch = cw = side;
              top = (src_h - side) / 2;
              left = (src_w - side) / 2;
            }
            bilinear_crop_resize(src, src_h, src_w, channels, top, left,
                                 ch, cw, dst, out_h, out_w);
          } else if (pad_pixels > 0) {
            // Reflect-pad by p then crop at (oy, ox): output pixel
            // (y, x) gathers src[reflect(y + oy - p), reflect(x + ox
            // - p)]. Requires src spatial shape == out spatial shape
            // (the pipeline gates on it).
            const float* lut = u8_to_unit_lut();
            const int64_t p = pad_pixels;
            const int64_t oy = rng.randint(2 * p + 1);
            const int64_t ox = rng.randint(2 * p + 1);
            for (int64_t y = 0; y < out_h; ++y) {
              const int64_t sy = reflect_index(y + oy - p, src_h);
              const uint8_t* srow = src + sy * src_w * channels;
              float* drow = dst + y * out_w * channels;
              for (int64_t x = 0; x < out_w; ++x) {
                const int64_t sx = reflect_index(x + ox - p, src_w);
                for (int64_t c = 0; c < channels; ++c) {
                  drow[x * channels + c] = lut[srow[sx * channels + c]];
                }
              }
            }
          } else {  // flip/normalize-only recipe: straight copy
            const float* lut = u8_to_unit_lut();
            for (int64_t i = 0; i < out_size; ++i) {
              dst[i] = lut[src[i]];
            }
          }
          if (random_flip && rng.next_u64() % 2 == 1) {
            // Horizontal flip: column swap (pure permutation, exact).
            for (int64_t y = 0; y < out_h; ++y) {
              float* row = dst + y * out_w * channels;
              for (int64_t x = 0; x < out_w / 2; ++x) {
                float* a = row + x * channels;
                float* bpx = row + (out_w - 1 - x) * channels;
                for (int64_t c = 0; c < channels; ++c) {
                  const float tmp = a[c];
                  a[c] = bpx[c];
                  bpx[c] = tmp;
                }
              }
            }
          }
          for (int64_t i = 0; i < out_size; ++i) {
            dst[i] = dst[i] * post_scale + post_shift;
          }
        }
      },
      /*max_threads=*/0, /*grain=*/1);
}

// Bit-serial binary GEMM on packed operands (a host reference of the
// popcount GEMMs): out[m, n] = k_true - 2 * popcount(a[m, :] ^ b[n, :]).
// a: [M, KP] int32, b: [N, KP] int32 (B transposed, packed along K).
void zk_xnor_gemm_ref(const int32_t* a, const int32_t* b, int32_t* out,
                      int64_t m, int64_t n, int64_t kp, int32_t k_true) {
  parallel_for(m, [=](int64_t m0, int64_t m1) {
    for (int64_t i = m0; i < m1; ++i) {
      const uint32_t* arow = reinterpret_cast<const uint32_t*>(a) + i * kp;
      for (int64_t j = 0; j < n; ++j) {
        const uint32_t* brow = reinterpret_cast<const uint32_t*>(b) + j * kp;
        int32_t mismatches = 0;
        for (int64_t w = 0; w < kp; ++w) {
          mismatches += __builtin_popcount(arow[w] ^ brow[w]);
        }
        out[i * n + j] = k_true - 2 * mismatches;
      }
    }
  });
}

int zk_version() { return 2; }

}  // extern "C"
