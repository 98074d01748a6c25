// Native (C++) host-side batch assembly for the input pipeline.
//
// The reference parallelizes its input path with torch's native
// DataLoader workers (reference AiR/train.py:98-109, num_workers=4);
// this module is the TPU rebuild's equivalent: the two per-sample hot
// loops — packed-image gather+normalize and ground-truth scanpath
// tensorization (reference OSIE/dataset/dataset.py:68-102) — run as
// multi-threaded C++ over whole batches, GIL-free, producing arrays
// BIT-IDENTICAL to the numpy path in data/datasets.py (proven by
// tests/test_native.py).
//
// Built on demand by scanpaths_tpu.native (g++ -O3 -shared), loaded
// via ctypes; every entry point is plain C over raw pointers.
//
// The port's own copy of ``scanpaths_tpu/native/sp_native.cpp``
// (the port imports nothing of the JAX package); keep the two identical.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_for(int64_t n, int n_threads, F f) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&] {
    int64_t i;
    while ((i = next.fetch_add(1)) < n) f(i);
  };
  int k = static_cast<int>(n_threads < n ? n_threads : n);
  std::vector<std::thread> ts;
  ts.reserve(k - 1);
  for (int t = 0; t < k - 1; ++t) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// out[i] = (store[rows[i]] / 255 - mean) / std, NHWC float32.
// Bit-identical to data/packed_cache.py::PackedImageCache.load: the
// normalization is a pure function of (uint8 value, channel), so a
// 3x256 LUT computed with the same f32 operation order reproduces
// numpy's result exactly.
void sp_gather_normalize(const uint8_t* store, const int64_t* rows,
                         int64_t n, int64_t hw, const float* mean,
                         const float* stdv, float* out, int n_threads) {
  float lut[3][256];
  for (int c = 0; c < 3; ++c)
    for (int v = 0; v < 256; ++v)
      lut[c][v] = (static_cast<float>(v) / 255.0f - mean[c]) / stdv[c];
  parallel_for(n, n_threads, [&](int64_t i) {
    const uint8_t* src = store + rows[i] * hw * 3;
    float* dst = out + i * hw * 3;
    for (int64_t p = 0; p < hw; ++p) {
      dst[3 * p + 0] = lut[0][src[3 * p + 0]];
      dst[3 * p + 1] = lut[1][src[3 * p + 1]];
      dst[3 * p + 2] = lut[2][src[3 * p + 2]];
    }
  });
}

// Batched ground-truth tensorization, one sample per task unit.
// Mirrors data/datasets.py::tensorize_scanpath exactly (which mirrors
// reference OSIE/dataset/dataset.py:68-102):
//   * fixation t >= len  -> STOP one-hot at column 0;
//   * otherwise grid one-hot at (y/down_y, x/down_x) (f32 divide,
//     truncation cast — numpy .astype(int32) semantics), optionally
//     replaced by a caller-precomputed normalized blur row;
//   * duration = ms/1000 (f32), action/duration masks over [0,len),
//     plus the extra STOP-supervision step in action_mask;
//   * optional COCO-style clamp (x >= lim -> val), with the scalar
//     thresholds precomputed host-side in the exact f32 values numpy
//     would use.
// Negative grid indices take numpy's single-wrap behavior; indices
// beyond the grid (which would raise IndexError in the numpy path —
// invalid data) are clamped to the last cell.
//
// xs/ys/durs: [n, l_max] f32, row-padded.  lens: [n] int32 true
// lengths.  down_*, clamp_*: [n] f32 per-sample scalars (clamp_* may
// be NULL).  blur_rows: [mh*mw, mh*mw] f32 or NULL.  Outputs are
// written in full (no pre-zeroing required): target [n, t_max,
// mh*mw+1], duration/amask/dmask [n, t_max].
void sp_tensorize_batch(const float* xs, const float* ys,
                        const float* durs, const int32_t* lens, int64_t n,
                        int64_t l_max, int32_t t_max, int32_t mh,
                        int32_t mw, const float* down_x,
                        const float* down_y, const float* clamp_lim_x,
                        const float* clamp_val_x, const float* clamp_lim_y,
                        const float* clamp_val_y, const float* blur_rows,
                        float* target, float* duration, float* amask,
                        float* dmask, int n_threads) {
  const int64_t hw = static_cast<int64_t>(mh) * mw;
  const int64_t tw = hw + 1;
  parallel_for(n, n_threads, [&](int64_t i) {
    const float* px = xs + i * l_max;
    const float* py = ys + i * l_max;
    const float* pd = durs + i * l_max;
    float* tgt = target + i * t_max * tw;
    float* dur = duration + i * t_max;
    float* am = amask + i * t_max;
    float* dm = dmask + i * t_max;
    std::memset(tgt, 0, sizeof(float) * t_max * tw);
    std::memset(dur, 0, sizeof(float) * t_max);
    std::memset(am, 0, sizeof(float) * t_max);
    std::memset(dm, 0, sizeof(float) * t_max);
    const int32_t nfix = lens[i] < t_max ? lens[i] : t_max;
    for (int32_t t = 0; t < t_max; ++t) {
      if (t >= nfix) {
        tgt[static_cast<int64_t>(t) * tw] = 1.0f;
        continue;
      }
      float x = px[t], y = py[t];
      if (clamp_lim_x != nullptr) {
        if (x >= clamp_lim_x[i]) x = clamp_val_x[i];
        if (y >= clamp_lim_y[i]) y = clamp_val_y[i];
      }
      int32_t xd = static_cast<int32_t>(x / down_x[i]);
      int32_t yd = static_cast<int32_t>(y / down_y[i]);
      if (xd < 0) xd += mw;
      if (yd < 0) yd += mh;
      int64_t cell = static_cast<int64_t>(yd) * mw + xd;
      if (cell < 0) cell = 0;
      if (cell >= hw) cell = hw - 1;
      dur[t] = pd[t] / 1000.0f;
      am[t] = 1.0f;
      dm[t] = 1.0f;
      if (blur_rows != nullptr) {
        std::memcpy(tgt + static_cast<int64_t>(t) * tw + 1,
                    blur_rows + cell * hw, sizeof(float) * hw);
      } else {
        tgt[static_cast<int64_t>(t) * tw + 1 + cell] = 1.0f;
      }
    }
    if (nfix <= t_max - 1) am[nfix] = 1.0f;
  });
}

}  // extern "C"
