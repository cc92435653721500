// Fused LeNet classifier head for Hopper (sm_90a): forward and backward.
//
//     logits = relu(relu(x @ W1 + b1) @ W2 + b2) @ W3 + b3      (400 -> 120 -> 84 -> 10)
//
// Replaces the TPU kernels in distributed_neural_network_tpu/ops/pallas_kernels.py:
// `_fwd_kernel` (forward, optional h1/h2 residuals) and `_bwd_kernel` (dx plus all six
// weight/bias gradients, ReLU masks from h1/h2).
//
// What bounds it on an H100: at the training batch (16 rows per worker) the forward moves
// ~262 KB (the 58,920 weights dominate) and does ~1.9 MFLOP, a bound of ~0.08 us at
// 3.35 TB/s - far below the launch latency, so these kernels are launch-bound on the
// main path. At thousands of rows the f32 FMA work (2*B*58,920 per pass, no tensor
// cores in this version) is what bounds it.
//
// Design against the TPU version:
// - The TPU kernel pins all three weight matrices in VMEM (235,680 B). That is more than
//   the 227 KB of shared memory a Hopper block can have. Here a block keeps only its own
//   tile of rows (x and the h1/h2 activations) in shared memory (< 48 KB, static) and
//   reads the weights through L2 (they stay resident there: 236 KB against 50 MB).
//   In each layer one thread owns one output column for every row of the tile, so each
//   weight is read once per block, coalesced across the warp, and the activations are
//   shared-memory broadcasts.
// - The TPU backward sums dW/db across grid steps in place, which is legal because a
//   TPU grid runs in order. Hopper blocks run in parallel and in no order, so each
//   backward block writes its tile's partial dW/db to a scratch row of its own and a
//   second kernel sums those rows in a fixed order. No atomics: the result is bitwise
//   reproducible run to run.
// - Rows past B (a ragged last tile) are masked in the kernel: they load as zeros,
//   contribute exactly zero to every gradient, and are never stored. There is no
//   host-side padding copy.
// - f32 in, f32 accumulate (fmaf), no TF32 and no tensor cores in this version.
//
// Plain C interface, loaded with ctypes. Each entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int D0 = 400;  // flattened conv features
constexpr int D1 = 120;  // fc1 width
constexpr int D2 = 84;   // fc2 width
constexpr int D3 = 10;   // classes

constexpr int FWD_ROWS = 16;
constexpr int FWD_THREADS = 128;
constexpr int BWD_ROWS = 16;
constexpr int BWD_THREADS = 256;
constexpr int REDUCE_THREADS = 256;

// layout of one row of gradient partials (and of the final flat gradient)
constexpr int N_W1 = D0 * D1;
constexpr int N_W2 = D1 * D2;
constexpr int N_W3 = D2 * D3;
constexpr int OFF_DW1 = 0;
constexpr int OFF_DB1 = OFF_DW1 + N_W1;
constexpr int OFF_DW2 = OFF_DB1 + D1;
constexpr int OFF_DB2 = OFF_DW2 + N_W2;
constexpr int OFF_DW3 = OFF_DB2 + D2;
constexpr int OFF_DB3 = OFF_DW3 + N_W3;
constexpr int N_GRAD = OFF_DB3 + D3;  // 59,134

// Load a (ROWS, D) tile starting at row0; rows at or past `rows` read as zero.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int rows) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    dst[i] = (i / D) < rows ? src[(size_t)row0 * D + i] : 0.f;
  }
}

// out[r][j] = act(sum_k in[r][k] * w[k][j] + b[j]) for every row of the tile,
// one thread per output column j.
template <int ROWS, int K, int N, int THREADS, bool RELU>
__device__ __forceinline__ void dense_tile(const float* in, const float* __restrict__ w,
                                           const float* __restrict__ b, float* out) {
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = w[k * N + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(in[r * K + k], wk, acc[r]);
    }
    const float bj = b[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = acc[r] + bj;
      out[r * N + j] = RELU ? fmaxf(v, 0.f) : v;
    }
  }
}

template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) dst[(size_t)row0 * D + i] = src[i];
}

__global__ void __launch_bounds__(FWD_THREADS)
mlp3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, float* __restrict__ out,
                float* __restrict__ h1_out, float* __restrict__ h2_out, int B) {
  __shared__ float xs[FWD_ROWS * D0];
  __shared__ float h1s[FWD_ROWS * D1];
  __shared__ float h2s[FWD_ROWS * D2];
  __shared__ float os[FWD_ROWS * D3];
  const int row0 = blockIdx.x * FWD_ROWS;
  const int rows = min(FWD_ROWS, B - row0);

  load_tile<FWD_ROWS, D0, FWD_THREADS>(xs, x, row0, rows);
  __syncthreads();
  dense_tile<FWD_ROWS, D0, D1, FWD_THREADS, true>(xs, w1, b1, h1s);
  __syncthreads();
  dense_tile<FWD_ROWS, D1, D2, FWD_THREADS, true>(h1s, w2, b2, h2s);
  __syncthreads();
  dense_tile<FWD_ROWS, D2, D3, FWD_THREADS, false>(h2s, w3, b3, os);
  __syncthreads();
  store_tile<FWD_ROWS, D3, FWD_THREADS>(out, os, row0, rows);
  if (h1_out != nullptr) {
    store_tile<FWD_ROWS, D1, FWD_THREADS>(h1_out, h1s, row0, rows);
    store_tile<FWD_ROWS, D2, FWD_THREADS>(h2_out, h2s, row0, rows);
  }
}

// part[o] = sum over the tile's rows of a[r][o / NB] * b[r][o % NB]   (a^T b, flattened)
template <int ROWS, int NA, int NB, int THREADS>
__device__ __forceinline__ void outer_tile(const float* a, const float* bm,
                                           float* __restrict__ part) {
  for (int o = threadIdx.x; o < NA * NB; o += THREADS) {
    const int i = o / NB, j = o % NB;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc = fmaf(a[r * NA + i], bm[r * NB + j], acc);
    part[o] = acc;
  }
}

// part[j] = sum over the tile's rows of m[r][j]
template <int ROWS, int N, int THREADS>
__device__ __forceinline__ void colsum_tile(const float* m, float* __restrict__ part) {
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc += m[r * N + j];
    part[j] = acc;
  }
}

// d[r][i] = (d[r][i] > 0 ? sum_j up[r][j] * w[i][j] : 0), in place: `d` holds the
// forward activation on entry (its sign is the ReLU mask) and the masked gradient on exit.
template <int ROWS, int NI, int NJ, int THREADS>
__device__ __forceinline__ void relu_bwd_tile(const float* up, const float* __restrict__ w,
                                              float* d) {
  for (int o = threadIdx.x; o < ROWS * NI; o += THREADS) {
    const int r = o / NI, i = o % NI;
    float acc = 0.f;
    for (int j = 0; j < NJ; ++j) acc = fmaf(up[r * NJ + j], w[i * NJ + j], acc);
    d[o] = d[o] > 0.f ? acc : 0.f;
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
mlp3_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                const float* __restrict__ h1, const float* __restrict__ h2,
                const float* __restrict__ w1, const float* __restrict__ w2,
                const float* __restrict__ w3, float* __restrict__ dx,
                float* __restrict__ partials, int B) {
  __shared__ float xs[BWD_ROWS * D0];
  __shared__ float a1[BWD_ROWS * D1];  // h1, then dh1
  __shared__ float a2[BWD_ROWS * D2];  // h2, then dh2
  __shared__ float gs[BWD_ROWS * D3];
  const int row0 = blockIdx.x * BWD_ROWS;
  const int rows = min(BWD_ROWS, B - row0);
  float* part = partials + (size_t)blockIdx.x * N_GRAD;

  load_tile<BWD_ROWS, D0, BWD_THREADS>(xs, x, row0, rows);
  load_tile<BWD_ROWS, D1, BWD_THREADS>(a1, h1, row0, rows);
  load_tile<BWD_ROWS, D2, BWD_THREADS>(a2, h2, row0, rows);
  load_tile<BWD_ROWS, D3, BWD_THREADS>(gs, g, row0, rows);
  __syncthreads();

  // layer 3: dW3 = h2^T g, db3 = sum g; then dh2 = (g W3^T) * [h2 > 0]
  outer_tile<BWD_ROWS, D2, D3, BWD_THREADS>(a2, gs, part + OFF_DW3);
  colsum_tile<BWD_ROWS, D3, BWD_THREADS>(gs, part + OFF_DB3);
  __syncthreads();
  relu_bwd_tile<BWD_ROWS, D2, D3, BWD_THREADS>(gs, w3, a2);
  __syncthreads();

  // layer 2: dW2 = h1^T dh2, db2 = sum dh2; then dh1 = (dh2 W2^T) * [h1 > 0]
  outer_tile<BWD_ROWS, D1, D2, BWD_THREADS>(a1, a2, part + OFF_DW2);
  colsum_tile<BWD_ROWS, D2, BWD_THREADS>(a2, part + OFF_DB2);
  __syncthreads();
  relu_bwd_tile<BWD_ROWS, D1, D2, BWD_THREADS>(a2, w2, a1);
  __syncthreads();

  // layer 1: dW1 = x^T dh1, db1 = sum dh1, dx = dh1 W1^T
  outer_tile<BWD_ROWS, D0, D1, BWD_THREADS>(xs, a1, part + OFF_DW1);
  colsum_tile<BWD_ROWS, D1, BWD_THREADS>(a1, part + OFF_DB1);
  for (int k = threadIdx.x; k < D0; k += BWD_THREADS) {
    float acc[BWD_ROWS];
#pragma unroll
    for (int r = 0; r < BWD_ROWS; ++r) acc[r] = 0.f;
    for (int i = 0; i < D1; ++i) {
      const float wki = w1[k * D1 + i];
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) acc[r] = fmaf(a1[r * D1 + i], wki, acc[r]);
    }
    for (int r = 0; r < rows; ++r) dx[(size_t)(row0 + r) * D0 + k] = acc[r];
  }
}

// grads[e] = sum over tiles t = 0, 1, ... of partials[t][e], in that order.
__global__ void __launch_bounds__(REDUCE_THREADS)
mlp3_bwd_reduce_kernel(const float* __restrict__ partials, int ntiles,
                       float* __restrict__ grads) {
  const int e = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e >= N_GRAD) return;
  float acc = 0.f;
  for (int t = 0; t < ntiles; ++t) acc += partials[(size_t)t * N_GRAD + e];
  grads[e] = acc;
}

}  // namespace

extern "C" {

int fused_mlp3_grad_size() { return N_GRAD; }
int fused_mlp3_bwd_tile_rows() { return BWD_ROWS; }

int fused_mlp3_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, float* out,
                   float* h1, float* h2, int B, void* stream) {
  const int grid = (B + FWD_ROWS - 1) / FWD_ROWS;
  mlp3_fwd_kernel<<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, out, h1, h2, B);
  return static_cast<int>(cudaGetLastError());
}

int fused_mlp3_bwd(const float* g, const float* x, const float* h1, const float* h2,
                   const float* w1, const float* w2, const float* w3, float* dx,
                   float* partials, int B, void* stream) {
  const int grid = (B + BWD_ROWS - 1) / BWD_ROWS;
  mlp3_bwd_kernel<<<grid, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, h1, h2, w1, w2, w3, dx, partials, B);
  return static_cast<int>(cudaGetLastError());
}

int fused_mlp3_bwd_reduce(const float* partials, int ntiles, float* grads, void* stream) {
  const int grid = (N_GRAD + REDUCE_THREADS - 1) / REDUCE_THREADS;
  mlp3_bwd_reduce_kernel<<<grid, REDUCE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, ntiles, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
