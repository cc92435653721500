// Native host-side data kernels for the TPU framework's input pipeline.
//
// The reference delegates its host data path to torchvision + torch
// DataLoader (C++ under ATen: `data_parallelism_train.py:69-79`). This
// framework batches on-device (data/pipeline.py), so the host hot spots
// that remain are the one-time dataset decode (CIFAR plane-major uint8 ->
// normalized NHWC float32 - a 4-pass numpy chain of reshape / transpose /
// astype / affine) and row-gather for host-side streaming. Each is fused
// here into a single cache-friendly pass, parallelized across rows with
// std::thread. Built at import time by distributed_neural_network_tpu/
// native/__init__.py (g++ -O3 -shared), called through ctypes; numpy is
// the documented fallback when no compiler is available.
//
// All functions write `out = a * x + b` per element, which expresses any
// mean/std normalization: a = 1/(255*std), b = -mean/std.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kH = 32, kW = 32, kC = 3;
constexpr int64_t kRow = kH * kW * kC;  // 3072

int resolve_threads(int32_t nthreads, int64_t rows) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int t = nthreads > 0 ? nthreads : std::min(hw, 8);
  return static_cast<int>(std::min<int64_t>(t, std::max<int64_t>(rows, 1)));
}

template <typename Fn>
void parallel_rows(int64_t rows, int32_t nthreads, Fn fn) {
  int t = resolve_threads(nthreads, rows);
  if (t <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  int64_t chunk = (rows + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = std::min(rows, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// CIFAR python-batch layout: each row is 3072 bytes, plane-major
// (R[32][32], G[32][32], B[32][32]). Emit NHWC float32, out = a*x + b.
void cifar_decode_chw_to_nhwc(const uint8_t* src, int64_t n, float a, float b,
                              float* dst, int32_t nthreads) {
  parallel_rows(n, nthreads, [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* in = src + r * kRow;
      float* out = dst + r * kRow;
      for (int64_t hw = 0; hw < kH * kW; ++hw) {
        float* px = out + hw * kC;
        px[0] = a * in[hw] + b;
        px[1] = a * in[kH * kW + hw] + b;
        px[2] = a * in[2 * kH * kW + hw] + b;
      }
    }
  });
}

// Elementwise affine uint8 -> float32 over an arbitrary contiguous buffer
// (layout-preserving; used for NHWC arrays that are already interleaved).
void affine_u8_to_f32(const uint8_t* src, int64_t size, float a, float b,
                      float* dst, int32_t nthreads) {
  // treat as pseudo-rows for threading granularity
  constexpr int64_t kBlock = 1 << 16;
  int64_t blocks = (size + kBlock - 1) / kBlock;
  parallel_rows(blocks, nthreads, [=](int64_t lo, int64_t hi) {
    int64_t start = lo * kBlock;
    int64_t end = std::min(size, hi * kBlock);
    for (int64_t i = start; i < end; ++i) dst[i] = a * src[i] + b;
  });
}

// Row gather + affine: dst[j] = a * src[idx[j]] + b for row_elems-wide rows.
// The host-streaming batch assembly (gather/convert/normalize in one pass).
void gather_affine_u8(const uint8_t* src, const int64_t* idx, int64_t nidx,
                      int64_t row_elems, float a, float b, float* dst,
                      int32_t nthreads) {
  parallel_rows(nidx, nthreads, [=](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      const uint8_t* in = src + idx[j] * row_elems;
      float* out = dst + j * row_elems;
      for (int64_t i = 0; i < row_elems; ++i) out[i] = a * in[i] + b;
    }
  });
}

}  // extern "C"
