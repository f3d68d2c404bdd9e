// pdm_runtime — native host-side data engine of pdm_tpu_torch.
//
// A copy of the JAX package's runtime (the same C ABI and arithmetic, so
// both packages decode, resize and gather the same bytes the same way),
// except in how many threads a call starts: one per kBytesPerThread of
// output, where the JAX copy starts one per core on every call. Starting
// a thread costs ~0.2 ms on the card's host, more than gathering a
// training batch of 128 CIFAR rows (1.5 MB, 0.2 ms on one thread; 1.9 ms
// on eight, measured on an H100 machine's host).
// It owns the host side of the data pipeline: image normalization,
// bilinear resize, and the per-step minibatch gather into a staging buffer
// used when a dataset is kept in host memory (HostResidentData). All entry
// points are multithreaded C with a flat ABI for ctypes.
//
// Built at first use by pdm_tpu_torch/runtime/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 pdm_runtime.cpp -o <lib>.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Output bytes a thread is started for.
constexpr int64_t kBytesPerThread = int64_t(8) << 20;

// Run fn(i) for i in [0, n) across hardware threads, one for every
// kBytesPerThread of the item_bytes-sized outputs.
template <typename F>
void parallel_for(int64_t n, int64_t item_bytes, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t by_work = std::max<int64_t>(1, n * item_bytes / kBytesPerThread);
  int64_t n_threads = std::max<int64_t>(
      1, std::min<int64_t>(std::min<int64_t>(hw ? hw : 4, n), by_work));
  if (n_threads == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// uint8 HWC images -> float32 CHW in [-1, 1].
// in:  (n, h, w, c) uint8 contiguous
// out: (n, c, h, w) float32 contiguous
void pdm_normalize_u8_hwc_to_f32_chw(const uint8_t* in, float* out, int64_t n,
                                     int64_t h, int64_t w, int64_t c) {
  const float scale = 2.0f / 255.0f;
  const int64_t img_in = h * w * c;
  const int64_t img_out = c * h * w;
  parallel_for(n, img_out * int64_t(sizeof(float)), [&](int64_t i) {
    const uint8_t* src = in + i * img_in;
    float* dst = out + i * img_out;
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* px = src + (y * w + x) * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          dst[ch * h * w + y * w + x] = px[ch] * scale - 1.0f;
        }
      }
    }
  });
}

// Batched bilinear resize of uint8 HWC images.
// in:  (n, h_in, w_in, c); out: (n, h_out, w_out, c)
void pdm_resize_bilinear_u8(const uint8_t* in, uint8_t* out, int64_t n,
                            int64_t h_in, int64_t w_in, int64_t h_out,
                            int64_t w_out, int64_t c) {
  const float sy = h_out > 1 ? float(h_in - 1) / float(h_out - 1) : 0.0f;
  const float sx = w_out > 1 ? float(w_in - 1) / float(w_out - 1) : 0.0f;
  const int64_t in_img = h_in * w_in * c;
  const int64_t out_img = h_out * w_out * c;
  parallel_for(n, out_img, [&](int64_t i) {
    const uint8_t* src = in + i * in_img;
    uint8_t* dst = out + i * out_img;
    for (int64_t y = 0; y < h_out; ++y) {
      float fy = y * sy;
      int64_t y0 = (int64_t)fy;
      int64_t y1 = std::min(y0 + 1, h_in - 1);
      float wy = fy - y0;
      for (int64_t x = 0; x < w_out; ++x) {
        float fx = x * sx;
        int64_t x0 = (int64_t)fx;
        int64_t x1 = std::min(x0 + 1, w_in - 1);
        float wx = fx - x0;
        for (int64_t ch = 0; ch < c; ++ch) {
          float v00 = src[(y0 * w_in + x0) * c + ch];
          float v01 = src[(y0 * w_in + x1) * c + ch];
          float v10 = src[(y1 * w_in + x0) * c + ch];
          float v11 = src[(y1 * w_in + x1) * c + ch];
          float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                    wy * ((1 - wx) * v10 + wx * v11);
          dst[(y * w_out + x) * c + ch] = (uint8_t)(v + 0.5f);
        }
      }
    }
  });
}

// Gather rows of a host-resident float32 matrix into a batch buffer:
// out[i] = data[idx[i]], row_elems floats per row.
void pdm_gather_rows_f32(const float* data, const int64_t* idx, float* out,
                         int64_t batch, int64_t row_elems) {
  parallel_for(batch, row_elems * int64_t(sizeof(float)), [&](int64_t i) {
    std::memcpy(out + i * row_elems, data + idx[i] * row_elems,
                row_elems * sizeof(float));
  });
}

// Fused gather + uint8->[-1,1] float32 decode (for uint8 host caches: 4x
// less host RAM, decode on the fly into the staging buffer).
void pdm_gather_rows_u8_to_f32(const uint8_t* data, const int64_t* idx,
                               float* out, int64_t batch, int64_t row_elems) {
  const float scale = 2.0f / 255.0f;
  parallel_for(batch, row_elems * int64_t(sizeof(float)), [&](int64_t i) {
    const uint8_t* src = data + idx[i] * row_elems;
    float* dst = out + i * row_elems;
    for (int64_t j = 0; j < row_elems; ++j) dst[j] = src[j] * scale - 1.0f;
  });
}

// Running mean/M2 update over a batch of rows (Welford, for streaming
// dataset statistics on host without materializing doubles in Python).
void pdm_stream_mean(const float* batch, int64_t n_rows, int64_t row_elems,
                     double* mean_accum, int64_t* count) {
  for (int64_t i = 0; i < n_rows; ++i) {
    ++(*count);
    const double inv = 1.0 / double(*count);
    const float* row = batch + i * row_elems;
    for (int64_t j = 0; j < row_elems; ++j) {
      mean_accum[j] += (double(row[j]) - mean_accum[j]) * inv;
    }
  }
}

int64_t pdm_version() { return 1; }

}  // extern "C"
