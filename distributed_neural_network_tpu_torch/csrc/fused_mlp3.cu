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
// cores) is what bounds it.
//
// The forward, spread over the card: at B = 16 one block per 16-row tile ran the
// whole head as a serial chain on one SM (each of 120 threads walking K = 400). Here
// a thread-block cluster of CL blocks shares each 16-row tile (mlp3_fwd_kernel<CL>):
// - block rank c computes layer 1's columns [15 c, 15 c + 15) (CL 8) for all 16 rows:
//   thread (ks, j) sums a slice of 20 consecutive k for column j in 16 registers,
//   reading x from shared memory as float4 broadcasts and each W1 weight once from
//   L2; the 20 slices' partial sums meet in shared memory (in x's space) and one
//   thread per output adds them in slice order, adds the bias and applies ReLU;
// - after cluster.sync() every block gathers all of h1 from the others' shared
//   memory (distributed shared memory, map_shared_rank), computes layer 2's columns
//   [11 c, 11 c + 11) the same way and writes them into rank 0's shared memory;
// - after a second cluster.sync() rank 0 computes the 10 logits, k in order.
// Sums run in a fixed order and there are no atomics, so a call gives the same bits
// every time; ragged rows load as zero and are never stored; f32 FMAs only.
// Which cluster size, measured (chip_smoke.py phases 2 and 6, device time in a CUDA
// graph, H100 at 700 W): CL 8 at B = 16 in 8.8 us against 9.9 us for CL 4 and 15.5 us
// for the addmm/relu chain (the one-block design measured 56 us); CL 4 from B = 512 on
// (B = 4096: 45.6 us against 61.7 us; each of CL blocks reads the whole x tile), so
// the wrapper takes 8 up to 256 rows and 4 above (ops/fused_head.py fwd_cluster).
// Not built: one block of 512-1024 threads splitting K over warps, which leaves the
// head on one SM's 128 FMA lanes (about 3 us of layer-1 FMAs alone at B = 16).
//
// The backward, as the TPU kernels' design against Hopper:
// - The TPU kernel pins all three weight matrices in VMEM (235,680 B). That is more than
//   the 227 KB of shared memory a Hopper block can have. Here a block keeps only its own
//   tile of rows (x and the h1/h2 activations) in shared memory (< 48 KB, static) and
//   reads the weights through L2 (they stay resident there: 236 KB against 50 MB).
// - The TPU backward sums dW/db across grid steps in place, which is legal because a
//   TPU grid runs in order. Hopper blocks run in parallel and in no order, so each
//   backward block writes its tile's partial dW/db to a scratch row of its own and a
//   second kernel sums those rows in a fixed order. No atomics: the result is bitwise
//   reproducible run to run.
// - Rows past B (a ragged last tile) are masked in the kernel: they load as zeros,
//   contribute exactly zero to every gradient, and are never stored. There is no
//   host-side padding copy.
// - f32 in, f32 accumulate (fmaf), no TF32 and no tensor cores.
//
// Plain C interface, loaded with ctypes. Each entry returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D0 = 400;  // flattened conv features
constexpr int D1 = 120;  // fc1 width
constexpr int D2 = 84;   // fc2 width
constexpr int D3 = 10;   // classes

constexpr int FWD_ROWS = 16;
constexpr int FWD_THREADS = 320;
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

// The forward spread over a cluster of CL blocks per 16-row tile (CL 8 or
// 4): block rank c of the cluster computes layer 1's columns [c N1, c N1 +
// N1) and layer 2's [c N2, c N2 + N2); rank 0 computes layer 3. Inside a
// block, thread (ks, j) sums a slice of K1 (K2) consecutive k for column j
// and all 16 rows in registers, reading x (h1) as shared-memory broadcasts
// (float4 along k for x) and its weights once from L2; the KS slices'
// partial sums meet in shared memory and one thread per output adds them
// in slice order (a fixed order: bitwise repeatable, no atomics).
template <int CL>
struct FwdSplit {
  static constexpr int NJ = 128 / CL;            // column lanes: 16 or 32
  static constexpr int KS = FWD_THREADS / NJ;    // k slices: 20 or 10
  static constexpr int N1 = (D1 + CL - 1) / CL;  // layer-1 columns of a block: 15 or 30
  static constexpr int N2 = (D2 + CL - 1) / CL;  // layer-2 columns of a block: 11 or 21
  static constexpr int K1 = D0 / KS, K2 = D1 / KS;
  static_assert(D0 % KS == 0 && D1 % KS == 0 && K1 % 4 == 0 && N1 <= NJ && N2 <= NJ,
                "the k slices tile K exactly and the columns fit the lanes");
  static_assert(KS * FWD_ROWS * NJ <= FWD_ROWS * D0, "the partial sums fit in x's space");
};

// acc[r] = sum over k of the slice [kb, kb + KN) of in[r][k] * w[k][col]
// (zero weight for a lane past the block's columns); in: FWD_ROWS x LDI
template <int KN, int LDI, int LDW, bool kVec4>
__device__ __forceinline__ void slice_dot(float (&acc)[FWD_ROWS], const float* in,
                                          const float* __restrict__ w, int kb, int col,
                                          bool live) {
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) acc[r] = 0.f;
  if constexpr (kVec4) {
#pragma unroll
    for (int k = 0; k < KN; k += 4) {
      float wk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wk[i] = live ? w[(kb + k + i) * LDW + col] : 0.f;
#pragma unroll
      for (int r = 0; r < FWD_ROWS; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(in + r * LDI + kb + k);
        acc[r] = fmaf(xv.x, wk[0], acc[r]);
        acc[r] = fmaf(xv.y, wk[1], acc[r]);
        acc[r] = fmaf(xv.z, wk[2], acc[r]);
        acc[r] = fmaf(xv.w, wk[3], acc[r]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      const float wk = live ? w[(kb + k) * LDW + col] : 0.f;
#pragma unroll
      for (int r = 0; r < FWD_ROWS; ++r) acc[r] = fmaf(in[r * LDI + kb + k], wk, acc[r]);
    }
  }
}

// output (r, j) of a block: the KS partial sums of part (KS x FWD_ROWS x NJ)
// added in slice order, plus the bias
template <int KS, int NJ>
__device__ __forceinline__ float slice_sum(const float* part, int r, int j, float bias) {
  float v = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) v += part[(ks * FWD_ROWS + r) * NJ + j];
  return v + bias;
}

template <int CL>
__global__ void __launch_bounds__(FWD_THREADS)
mlp3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, float* __restrict__ out,
                float* __restrict__ h1_out, float* __restrict__ h2_out, int B) {
  using Sp = FwdSplit<CL>;
  constexpr int NJ = Sp::NJ, N1 = Sp::N1, N2 = Sp::N2;
  __shared__ __align__(16) float xs[FWD_ROWS * D0];  // x, then the partial sums
  __shared__ float h1s[FWD_ROWS * N1];               // this block's h1 columns
  __shared__ float h1f[FWD_ROWS * D1];               // all of h1, gathered
  __shared__ float h2f[FWD_ROWS * D2];               // all of h2 (rank 0)
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / CL) * FWD_ROWS;
  const int rows = min(FWD_ROWS, B - row0);
  const int ks = threadIdx.x / NJ, j = threadIdx.x - ks * NJ;
  float acc[FWD_ROWS];

  load_tile<FWD_ROWS, D0, FWD_THREADS>(xs, x, row0, rows);
  __syncthreads();
  // layer 1: h1[:, c N1 + j] over the slice [ks K1, ks K1 + K1)
  slice_dot<Sp::K1, D0, D1, true>(acc, xs, w1, ks * Sp::K1, c * N1 + j, j < N1);
  __syncthreads();  // x is read: its space takes the partial sums
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) xs[(ks * FWD_ROWS + r) * NJ + j] = acc[r];
  __syncthreads();
  for (int o = threadIdx.x; o < FWD_ROWS * N1; o += FWD_THREADS) {
    const int r = o / N1, jj = o - r * N1, col = c * N1 + jj;
    const float v = fmaxf(slice_sum<Sp::KS, NJ>(xs, r, jj, b1[col]), 0.f);
    h1s[o] = v;
    if (h1_out != nullptr && r < rows) h1_out[(size_t)(row0 + r) * D1 + col] = v;
  }
  cluster.sync();  // every block's h1 columns are written (and every block has started)
  for (int o = threadIdx.x; o < FWD_ROWS * D1; o += FWD_THREADS) {
    const int r = o / D1, col = o - r * D1, src = col / N1;
    h1f[o] = cluster.map_shared_rank(&h1s[0], src)[r * N1 + col - src * N1];
  }
  __syncthreads();
  // layer 2: h2[:, c N2 + j] over the slice [ks K2, ks K2 + K2)
  const int col2 = c * N2 + j;
  slice_dot<Sp::K2, D1, D2, false>(acc, h1f, w2, ks * Sp::K2, col2, j < N2 && col2 < D2);
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) xs[(ks * FWD_ROWS + r) * NJ + j] = acc[r];
  __syncthreads();
  float* h2_rank0 = cluster.map_shared_rank(&h2f[0], 0);
  for (int o = threadIdx.x; o < FWD_ROWS * N2; o += FWD_THREADS) {
    const int r = o / N2, jj = o - r * N2, col = c * N2 + jj;
    if (col >= D2) continue;
    const float v = fmaxf(slice_sum<Sp::KS, NJ>(xs, r, jj, b2[col]), 0.f);
    h2_rank0[r * D2 + col] = v;
    if (h2_out != nullptr && r < rows) h2_out[(size_t)(row0 + r) * D2 + col] = v;
  }
  cluster.sync();  // h2 is in rank 0's shared memory; no block reads another's after this
  if (c != 0) return;
  // layer 3 on rank 0: one thread per logit, k in order
  for (int o = threadIdx.x; o < rows * D3; o += FWD_THREADS) {
    const int r = o / D3, jj = o - r * D3;
    float v = 0.f;
    for (int k = 0; k < D2; ++k) v = fmaf(h2f[r * D2 + k], w3[k * D3 + jj], v);
    out[(size_t)(row0 + r) * D3 + jj] = v + b3[jj];
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

template <int CL>
cudaLaunchConfig_t fwd_config(int B, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + FWD_ROWS - 1) / FWD_ROWS) * CL);
  cfg.blockDim = dim3(FWD_THREADS);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CL>
cudaError_t launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* w3, const float* b3, float* out, float* h1,
                       float* h2, int B, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_config<CL>(B, stream, &attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mlp3_fwd_kernel<CL>, x, w1, b1, w2, b2, w3, b3, out, h1, h2, B);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// blocks of the forward that fit on one SM, and clusters of it that the card
// runs at once (at B = 16 * 1024, enough tiles to fill it)
template <int CL>
cudaError_t fwd_occupancy(int* blocks, int* clusters) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mlp3_fwd_kernel<CL>,
                                                                FWD_THREADS, 0);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_config<CL>(FWD_ROWS * 1024, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, mlp3_fwd_kernel<CL>, &cfg);
}

}  // namespace

extern "C" {

int fused_mlp3_grad_size() { return N_GRAD; }
int fused_mlp3_bwd_tile_rows() { return BWD_ROWS; }

// cluster: the blocks that share one 16-row tile (4 or 8)
int fused_mlp3_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, float* out,
                   float* h1, float* h2, int B, int cluster, void* stream) {
  if (B < 1 || (cluster != 4 && cluster != 8)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cluster == 8
                              ? launch_fwd<8>(x, w1, b1, w2, b2, w3, b3, out, h1, h2, B, st)
                              : launch_fwd<4>(x, w1, b1, w2, b2, w3, b3, out, h1, h2, B, st));
}

int fused_mlp3_fwd_info(int cluster, int* blocks_per_sm, int* clusters) {
  if (cluster != 4 && cluster != 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cluster == 8 ? fwd_occupancy<8>(blocks_per_sm, clusters)
                                       : fwd_occupancy<4>(blocks_per_sm, clusters));
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
