// Fused LeNet classifier head for Hopper (sm_90a): forward and backward.
//
//     logits = relu(relu(x @ W1 + b1) @ W2 + b2) @ W3 + b3      (400 -> 120 -> 84 -> 10)
//
// Replaces the TPU kernels in distributed_neural_network_tpu/ops/pallas_kernels.py:
// `_fwd_kernel` (forward, optional h1/h2 residuals) and `_bwd_kernel` (dx plus all six
// weight/bias gradients, ReLU masks from h1/h2).
//
// Both kernels take a replica axis: x (N, B, 400), weights (N, in, out), biases (N,
// out), outputs (N, B, .); blockIdx.y is the replica, so one launch serves the N
// workers of the replica group (ops/fused_head.py, train/engine.py), where the TPU
// ran one kernel per device under shard_map.
//
// What bounds it on an H100: at the training batch (16 rows per worker) the forward moves
// ~262 KB a replica (the 58,920 weights dominate) and does ~1.9 MFLOP, a bound of ~0.08
// us at 3.35 TB/s - far below the launch latency, so these kernels are launch-bound on
// the main path. At thousands of rows the f32 FMA work (2*B*58,920 per pass, no tensor
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
//   the 227 KB of shared memory a Hopper block can have. Here each 16-row tile is a
//   thread-block cluster of BWD_CL = 8 blocks (mlp3_bwd_kernel<8>), and each block keeps
//   its share: W1's rows [50 c, 50 c + 50), W2's rows for its dh1 columns, W3, and the
//   tile's x columns, h1 columns, h2 and g (55,848 B of dynamic shared memory). Every
//   block forms all of dh2 (16 x 84, K = 10), then its dh1 columns, and pushes them into
//   every block's shared memory (distributed shared memory), so that after one
//   cluster.sync() each block holds all of dh1 and computes its rows of dW1 and its
//   columns of dx from its own W1 rows, read once, coalesced.
//   The one-block design before it read W1 a column at a time for dx (lanes 120
//   floats apart) and ran the whole tile on one SM: 86-87 us at B = 16 and at B = 128.
// - The TPU backward sums dW/db across grid steps in place, which is legal because a
//   TPU grid runs in order. Hopper blocks run in parallel and in no order, so a
//   replica's tiles are cut into groups by a rule of B alone (bwd_groups: at most
//   BWD_GROUP_MAX groups of equal runs of tiles), and one cluster walks its group's
//   tiles in order, keeping the group's dW/db sums in its threads' registers (each
//   element owned by one thread of one block) and the weights in shared memory, loaded
//   once; it stores one row per group. At one group (B <= 16, the main path) that row
//   is the gradient and nothing else runs; above, a second kernel sums a replica's
//   group rows in group order. No atomics: the result is bitwise reproducible run to
//   run, and its bits depend on B, never on the card's occupancy.
//   The design before it wrote one row per 16-row tile and always ran the second
//   kernel: at B = 4096 60.6 MB written and read back, now 15.1 MB (64 groups).
// - Rows past B (a ragged last tile) are masked in the kernel: they load as zeros,
//   contribute exactly zero to every gradient, and are never stored. There is no
//   host-side padding copy.
// - f32 in, f32 accumulate (fmaf), no TF32 and no tensor cores.
// Which cluster size, measured (chip_smoke.py phase 6, device time in a CUDA graph, H100
// at 700 W): CL 8 at B = 16 in 13.2 us against 17.6 us for CL 4 (100 W1 rows a block,
// 89,248 B of shared memory, 2 blocks per SM) and 59.6 us for the autograd backward;
// B = 128 13.4 against 17.7; B = 4096 119.5 against 121.6. CL 8 is the faster at every
// B, so only it is built (ops/fused_head.py bwd_cluster).
// The tile groups, measured the same way (port_probes/head_bwd_groups.py): at (N 4,
// B 16) the backward of all four replicas 12.4 us. Holding 34 sums a thread costs
// registers: 128 a thread (2 blocks per SM, 30 clusters at once). Capping them for 3
// or 4 blocks per SM (80 or 64 registers, with spills) made (4, 16) slower (14.3 and
// 17.0 us), so the kernel is not capped. At B = 4096 a cluster walks 4 tiles one after
// another: 0.150 ms with 64 groups against 0.119 for the earlier design's 256 one-tile
// clusters (each tile's chain of loads, cluster barriers and shared-memory sums is
// latency-bound at 8 warps an SM); overlapping one tile's loads with the last one's
// sums is not built.

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
constexpr int BWD_CL = 8;  // blocks of the backward's cluster
// the most groups of tiles a replica's backward is cut into (the group rule,
// bwd_groups): about two waves of the clusters an H100 runs at once (30 clusters of
// 8 at 2 blocks per SM, 128 registers; fused_mlp3_bwd_info on an H100 80GB HBM3 at
// 700 W). Measured at B = 4096 in a CUDA graph (port_probes/head_bwd_groups.py):
// 64 groups 0.150 ms, 32 groups 0.176, 16 groups 0.211, 128 groups 0.153 (0.168
// with the reduce of 128 rows)
constexpr int BWD_GROUP_MAX = 64;
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
  // replica n = blockIdx.y: its rows, weights and outputs
  const size_t n = blockIdx.y;
  x += n * B * D0;
  w1 += n * N_W1, b1 += n * D1, w2 += n * N_W2, b2 += n * D2, w3 += n * N_W3, b3 += n * D3;
  out += n * B * D3;
  if (h1_out != nullptr) h1_out += n * B * D1, h2_out += n * B * D2;
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

// the cluster barrier in two halves: arrive at the start (relaxed: no
// memory is published by it), wait before the first write into another
// block's shared memory, which is then known to be running
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The backward spread over a cluster of CL blocks (built at CL = BWD_CL). Block rank c
// owns W1's rows [c K1, c K1 + K1) (dW1's rows and dx's columns), dh1's columns
// [c N1, c N1 + N1) (with dW2's rows and db1) and dW3's rows and db2's columns
// [c N2, c N2 + N2); its data lives in dynamic shared memory at these offsets (floats).
template <int CL>
struct BwdSplit {
  static constexpr int K1 = D0 / CL;             // 50 at CL 8
  static constexpr int N1 = D1 / CL;             // 15
  static constexpr int N2 = (D2 + CL - 1) / CL;  // 11
  static constexpr int LDW1 = D1 + 1;            // a W1 row in shared memory, padded to odd
  static constexpr int G = 0;                        // g (16 x 10)
  static constexpr int H2 = G + BWD_ROWS * D3;       // h2 (16 x 84)
  static constexpr int W3 = H2 + BWD_ROWS * D2;      // W3 (84 x 10)
  static constexpr int DH2T = W3 + D2 * D3 + 4;      // dh2, transposed (84 x 16)
  static constexpr int H1T = DH2T + D2 * BWD_ROWS;   // h1's columns of the block, (N1 x 16)
  static constexpr int W2 = H1T + N1 * BWD_ROWS;     // W2's rows of the block (N1 x 84)
  static constexpr int XT = W2 + N1 * D2;            // x's columns of the block, (K1 x 16)
  static constexpr int DH1T = XT + K1 * BWD_ROWS;    // all of dh1, transposed (120 x 16)
  static constexpr int W1 = DH1T + D1 * BWD_ROWS;    // W1's rows of the block (K1 x LDW1)
  static constexpr int BYTES = (W1 + K1 * LDW1) * 4;
  // the gradient elements a thread owns, summed over its group's tiles in registers
  static constexpr int KH = BWD_THREADS / D1;        // runs of k per dW1 column: 2
  static constexpr int IH = BWD_THREADS / D2;        // runs of columns per dW2 column: 3
  static constexpr int OWN_W1 = (K1 + KH - 1) / KH;  // 25
  static constexpr int OWN_W2 = (N1 + IH - 1) / IH;  // 5
  static_assert(D0 % CL == 0 && D1 % CL == 0, "the ranks split W1's rows and dh1's columns");
  static_assert(DH2T % 4 == 0 && H1T % 4 == 0 && XT % 4 == 0 && DH1T % 4 == 0,
                "float4 reads of the transposed tiles");
  static_assert(N2 * D3 <= BWD_THREADS && N1 <= BWD_THREADS && D3 <= BWD_THREADS,
                "one thread per dW3 / db1 / db2 / db3 element");
};

// the group rule (ops/fused_head.py bwd_groups): T = ceil(B/16) tiles of a
// replica, ceil(T / BWD_GROUP_MAX) tiles a group, ceil(T / that) groups
__host__ __device__ __forceinline__ int bwd_tiles_per_group(int B) {
  const int tiles = (B + BWD_ROWS - 1) / BWD_ROWS;
  return (tiles + BWD_GROUP_MAX - 1) / BWD_GROUP_MAX;
}
__host__ __device__ __forceinline__ int bwd_groups(int B) {
  const int tiles = (B + BWD_ROWS - 1) / BWD_ROWS, tpg = bwd_tiles_per_group(B);
  return (tiles + tpg - 1) / tpg;
}

// One cluster per (replica n = blockIdx.y, group of tiles): dx's rows of the group's
// tiles and the group's row of gradient sums (layout OFF_DW1 .. N_GRAD), every element
// owned by exactly one thread of one block of the cluster:
// - every block loads its W1 and W2 rows (coalesced, W1 into rows padded to 121 floats)
//   and W3 once, then walks its group's tiles in tile order; for each tile it loads g,
//   h2, its h1 columns and its x columns (both transposed: 16 rows a float4 quad);
// - every block computes all of dh2 = (g W3^T) [h2 > 0] (16 x 84, K = 10), then its dW3
//   rows, db3 (rank 0), its dh1 columns (dh2 W2^T) [h1 > 0] (K = 84), which it pushes
//   into every block's dh1^T (distributed shared memory), and its dW2 rows and db2
//   columns;
// - after cluster.sync() every block holds all of dh1 and computes its dW1 rows (thread
//   (i, run of k): dh1's column i in 16 registers, x^T rows as float4 broadcasts), its
//   db1 columns and its dx columns (thread (k, 4 rows): W1's row k from shared memory,
//   dh1^T as float4 broadcasts, i in order), and stores dx;
// - each tile's dW/db sums (r ascending) are added to the owner's registers in tile
//   order, and the group's sums are stored once after its last tile. With one group
//   (B <= 16) that row is the replica's gradient itself.
// A cluster barrier split in two halves guards dh1^T between tiles: each block arrives
// after its last read of the tile's dh1^T and waits before its first push of the next.
// Every sum runs in a fixed order and there are no atomics, so a call gives the same bits
// every time; ragged rows load as zero, so they add exactly zero, and dx is never stored
// for them.
template <int CL>
__global__ void __launch_bounds__(BWD_THREADS)
mlp3_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                const float* __restrict__ h1, const float* __restrict__ h2,
                const float* __restrict__ w1, const float* __restrict__ w2,
                const float* __restrict__ w3, float* __restrict__ dx,
                float* __restrict__ partials, int B) {
  using Sp = BwdSplit<CL>;
  constexpr int K1 = Sp::K1, N1 = Sp::N1, N2 = Sp::N2, LDW1 = Sp::LDW1;
  constexpr int KH = Sp::KH, IH = Sp::IH;
  constexpr int Q = BWD_ROWS / 4;  // float4 quads of a transposed row
  extern __shared__ __align__(16) float smem[];
  float* gs = smem + Sp::G;
  float* h2s = smem + Sp::H2;
  float* w3s = smem + Sp::W3;
  float* dh2t = smem + Sp::DH2T;
  float* h1t = smem + Sp::H1T;
  float* w2s = smem + Sp::W2;
  float* xt = smem + Sp::XT;
  float* dh1t = smem + Sp::DH1T;
  float* w1s = smem + Sp::W1;
  const float4* dh2v = reinterpret_cast<const float4*>(dh2t);
  const float4* h1v = reinterpret_cast<const float4*>(h1t);
  const float4* xv = reinterpret_cast<const float4*>(xt);
  const float4* dh1v = reinterpret_cast<const float4*>(dh1t);

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  // replica n's rows, weights and outputs; this cluster's group of tiles
  const size_t n = blockIdx.y;
  const int groups = static_cast<int>(gridDim.x) / CL, group = static_cast<int>(blockIdx.x) / CL;
  g += n * B * D3, x += n * B * D0, h1 += n * B * D1, h2 += n * B * D2, dx += n * B * D0;
  w1 += n * N_W1, w2 += n * N_W2, w3 += n * N_W3;
  float* part = partials + (n * groups + group) * N_GRAD;
  const int tpg = bwd_tiles_per_group(B);
  const int tile0 = group * tpg;
  const int tile1 = min(tile0 + tpg, (B + BWD_ROWS - 1) / BWD_ROWS);

  const float* w1b = w1 + (size_t)c * K1 * D1;
  for (int o = t; o < K1 * D1; o += BWD_THREADS) {
    const int kk = o / D1;
    w1s[kk * LDW1 + o - kk * D1] = w1b[o];
  }
  const float* w2b = w2 + (size_t)c * N1 * D2;
  for (int o = t; o < N1 * D2; o += BWD_THREADS) w2s[o] = w2b[o];
  for (int o = t; o < D2 * D3; o += BWD_THREADS) w3s[o] = w3[o];

  // the owned elements' sums over the group's tiles
  const int i3 = c * N2 + t / D3, j3 = t % D3;      // dW3 (i3, j3)
  const bool own_w3 = t < N2 * D3 && i3 < D2;
  const int j2 = t % D2, ih = t / D2;               // dW2 (c N1 + ih + m IH, j2)
  const int i1 = t % D1, kh = t / D1;               // dW1 (c K1 + kh + m KH, i1)
  const int jb2 = c * N2 + t;                       // db2 column
  float s_w3 = 0.f, s_b3 = 0.f, s_b2 = 0.f, s_b1 = 0.f;
  float s_w2[Sp::OWN_W2], s_w1[Sp::OWN_W1];
#pragma unroll
  for (int m = 0; m < Sp::OWN_W2; ++m) s_w2[m] = 0.f;
#pragma unroll
  for (int m = 0; m < Sp::OWN_W1; ++m) s_w1[m] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * BWD_ROWS;
    const int rows = min(BWD_ROWS, B - row0);
    for (int o = t; o < BWD_ROWS * K1; o += BWD_THREADS) {
      const int r = o / K1, kk = o - r * K1;
      xt[kk * BWD_ROWS + r] = r < rows ? x[(size_t)(row0 + r) * D0 + c * K1 + kk] : 0.f;
    }
    for (int o = t; o < BWD_ROWS * N1; o += BWD_THREADS) {
      const int r = o / N1, ii = o - r * N1;
      h1t[ii * BWD_ROWS + r] = r < rows ? h1[(size_t)(row0 + r) * D1 + c * N1 + ii] : 0.f;
    }
    load_tile<BWD_ROWS, D2, BWD_THREADS>(h2s, h2, row0, rows);
    load_tile<BWD_ROWS, D3, BWD_THREADS>(gs, g, row0, rows);
    __syncthreads();

    // layer 3: dh2 (all of it; thread (i, half of the rows), W3's row i in
    // registers), this block's dW3 rows, db3 on rank 0
    if (t < 2 * D2) {
      const int i = t % D2, r0 = (t / D2) * (BWD_ROWS / 2);
      float w[D3];
#pragma unroll
      for (int j = 0; j < D3; ++j) w[j] = w3s[i * D3 + j];
#pragma unroll
      for (int r = r0; r < r0 + BWD_ROWS / 2; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D3; ++j) acc = fmaf(gs[r * D3 + j], w[j], acc);
        dh2t[i * BWD_ROWS + r] = h2s[r * D2 + i] > 0.f ? acc : 0.f;
      }
    }
    if (own_w3) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) acc = fmaf(h2s[r * D2 + i3], gs[r * D3 + j3], acc);
      s_w3 += acc;
    }
    if (c == 0 && t < D3) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) acc += gs[r * D3 + t];
      s_b3 += acc;
    }
    __syncthreads();

    // layer 2: this block's dh1 columns (thread (column, 4 rows)), pushed into
    // every block's dh1^T once every block is done with the last tile's; its
    // dW2 rows (thread (j, run of columns): dh2's column j in registers) and
    // db2 columns
    cluster_wait();
    for (int o = t; o < N1 * Q; o += BWD_THREADS) {
      const int ii = o % N1, rq = o / N1;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wr = w2s + ii * D2;
      for (int j = 0; j < D2; ++j) {
        const float w = wr[j];
        const float4 d = dh2v[j * Q + rq];
        a4[0] = fmaf(d.x, w, a4[0]);
        a4[1] = fmaf(d.y, w, a4[1]);
        a4[2] = fmaf(d.z, w, a4[2]);
        a4[3] = fmaf(d.w, w, a4[3]);
      }
      const float4 hq = h1v[ii * Q + rq];
      const float hv[4] = {hq.x, hq.y, hq.z, hq.w};
      const int at = (c * N1 + ii) * BWD_ROWS + 4 * rq;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = hv[q] > 0.f ? a4[q] : 0.f;
#pragma unroll
        for (int dst = 0; dst < CL; ++dst) cluster.map_shared_rank(dh1t, dst)[at + q] = v;
      }
    }
    if (t < IH * D2) {
      float dv[BWD_ROWS];
#pragma unroll
      for (int q4 = 0; q4 < Q; ++q4) {
        const float4 d = dh2v[j2 * Q + q4];
        dv[4 * q4] = d.x, dv[4 * q4 + 1] = d.y, dv[4 * q4 + 2] = d.z, dv[4 * q4 + 3] = d.w;
      }
#pragma unroll
      for (int m = 0; m < Sp::OWN_W2; ++m) {
        const int ii = ih + m * IH;
        if (ii >= N1) continue;
        float acc = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < Q; ++q4) {
          const float4 hq = h1v[ii * Q + q4];
          acc = fmaf(hq.x, dv[4 * q4], acc);
          acc = fmaf(hq.y, dv[4 * q4 + 1], acc);
          acc = fmaf(hq.z, dv[4 * q4 + 2], acc);
          acc = fmaf(hq.w, dv[4 * q4 + 3], acc);
        }
        s_w2[m] += acc;
      }
    }
    if (t < N2 && jb2 < D2) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) acc += dh2t[jb2 * BWD_ROWS + r];
      s_b2 += acc;
    }
    cluster.sync();  // every block's dh1 columns are in every block

    // layer 1: this block's dW1 rows, db1 columns and dx columns
    if (t < KH * D1) {
      float dv[BWD_ROWS];
#pragma unroll
      for (int q4 = 0; q4 < Q; ++q4) {
        const float4 d = dh1v[i1 * Q + q4];
        dv[4 * q4] = d.x, dv[4 * q4 + 1] = d.y, dv[4 * q4 + 2] = d.z, dv[4 * q4 + 3] = d.w;
      }
#pragma unroll
      for (int m = 0; m < Sp::OWN_W1; ++m) {
        const int kk = kh + m * KH;
        if (kk >= K1) continue;
        float acc = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < Q; ++q4) {
          const float4 xk = xv[kk * Q + q4];
          acc = fmaf(xk.x, dv[4 * q4], acc);
          acc = fmaf(xk.y, dv[4 * q4 + 1], acc);
          acc = fmaf(xk.z, dv[4 * q4 + 2], acc);
          acc = fmaf(xk.w, dv[4 * q4 + 3], acc);
        }
        s_w1[m] += acc;
      }
    }
    if (t < N1) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < BWD_ROWS; ++r) acc += dh1t[(c * N1 + t) * BWD_ROWS + r];
      s_b1 += acc;
    }
    for (int o = t; o < Q * K1; o += BWD_THREADS) {
      const int kk = o % K1, rq = o / K1;
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wr = w1s + kk * LDW1;
      for (int i = 0; i < D1; ++i) {
        const float w = wr[i];
        const float4 d = dh1v[i * Q + rq];
        a4[0] = fmaf(d.x, w, a4[0]);
        a4[1] = fmaf(d.y, w, a4[1]);
        a4[2] = fmaf(d.z, w, a4[2]);
        a4[3] = fmaf(d.w, w, a4[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * rq + q;
        if (r < rows) dx[(size_t)(row0 + r) * D0 + c * K1 + kk] = a4[q];
      }
    }
    if (tile + 1 < tile1) {
      // the next tile overwrites this one's x, h1, h2, g (here) and dh1 (from
      // every block, after the wait above)
      cluster_arrive();
      __syncthreads();
    }
  }

  // the group's sums, each element by its owner
  if (own_w3) part[OFF_DW3 + i3 * D3 + j3] = s_w3;
  if (c == 0 && t < D3) part[OFF_DB3 + t] = s_b3;
  if (t < IH * D2) {
#pragma unroll
    for (int m = 0; m < Sp::OWN_W2; ++m) {
      const int ii = ih + m * IH;
      if (ii < N1) part[OFF_DW2 + (c * N1 + ii) * D2 + j2] = s_w2[m];
    }
  }
  if (t < N2 && jb2 < D2) part[OFF_DB2 + jb2] = s_b2;
  if (t < KH * D1) {
#pragma unroll
    for (int m = 0; m < Sp::OWN_W1; ++m) {
      const int kk = kh + m * KH;
      if (kk < K1) part[OFF_DW1 + (size_t)(c * K1 + kk) * D1 + i1] = s_w1[m];
    }
  }
  if (t < N1) part[OFF_DB1 + c * N1 + t] = s_b1;
}

// grads[n][e] = sum over groups q = 0, 1, ... of partials[n][q][e], in that order
// (replica n = blockIdx.y); launched only when a replica has more than one group.
__global__ void __launch_bounds__(REDUCE_THREADS)
mlp3_bwd_reduce_kernel(const float* __restrict__ partials, int groups,
                       float* __restrict__ grads) {
  const int e = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e >= N_GRAD) return;
  const size_t n = blockIdx.y;
  const float* p = partials + n * groups * N_GRAD + e;
  float acc = 0.f;
  for (int q = 0; q < groups; ++q) acc += p[(size_t)q * N_GRAD];
  grads[n * N_GRAD + e] = acc;
}

// the launch of a cluster kernel over `clusters` x N clusters of CL blocks
// (blockIdx.y = the replica)
cudaLaunchConfig_t cluster_config(int cl, int clusters, int N, int threads, int smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cl), static_cast<unsigned>(N));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CL>
cudaError_t launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* w3, const float* b3, float* out, float* h1,
                       float* h2, int N, int B, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(CL, (B + FWD_ROWS - 1) / FWD_ROWS, N,
                                                FWD_THREADS, 0, stream, &attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mlp3_fwd_kernel<CL>, x, w1, b1, w2, b2, w3, b3, out, h1, h2, B);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// blocks of the forward that fit on one SM, and clusters of it that the card
// runs at once (at 1024 tiles, enough to fill it)
template <int CL>
cudaError_t fwd_occupancy(int* blocks, int* clusters) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mlp3_fwd_kernel<CL>,
                                                                FWD_THREADS, 0);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(CL, 1024, 1, FWD_THREADS, 0, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, mlp3_fwd_kernel<CL>, &cfg);
}

// the backward's dynamic shared memory (above the 48 KB default), set once
cudaError_t bwd_smem_attr() {
  static const cudaError_t e =
      cudaFuncSetAttribute(mlp3_bwd_kernel<BWD_CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BwdSplit<BWD_CL>::BYTES);
  return e;
}

}  // namespace

extern "C" {

int fused_mlp3_grad_size() { return N_GRAD; }
int fused_mlp3_bwd_tile_rows() { return BWD_ROWS; }
int fused_mlp3_bwd_group_max() { return BWD_GROUP_MAX; }
int fused_mlp3_bwd_groups(int B) { return B < 1 ? 0 : bwd_groups(B); }

// x (N, B, 400), weights (N, in, out) and (N, out), outputs (N, B, .); cluster:
// the blocks that share one 16-row tile (4 or 8); h1 and h2 both null or both set
int fused_mlp3_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, float* out,
                   float* h1, float* h2, int N, int B, int cluster, void* stream) {
  if (N < 1 || N > 65535 || B < 1 || (cluster != 4 && cluster != 8) ||
      (h1 == nullptr) != (h2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cluster == 8
                              ? launch_fwd<8>(x, w1, b1, w2, b2, w3, b3, out, h1, h2, N, B, st)
                              : launch_fwd<4>(x, w1, b1, w2, b2, w3, b3, out, h1, h2, N, B, st));
}

int fused_mlp3_fwd_info(int cluster, int* blocks_per_sm, int* clusters) {
  if (cluster != 4 && cluster != 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cluster == 8 ? fwd_occupancy<8>(blocks_per_sm, clusters)
                                       : fwd_occupancy<4>(blocks_per_sm, clusters));
}

// g (N, B, 10), x (N, B, 400), h1, h2, weights (N, in, out); dx (N, B, 400) and
// partials (N, groups, 59134), where groups must be the rule's bwd_groups(B)
int fused_mlp3_bwd(const float* g, const float* x, const float* h1, const float* h2,
                   const float* w1, const float* w2, const float* w3, float* dx,
                   float* partials, int N, int B, int groups, void* stream) {
  if (N < 1 || N > 65535 || B < 1 || groups != bwd_groups(B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = bwd_smem_attr();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(BWD_CL, groups, N, BWD_THREADS, BwdSplit<BWD_CL>::BYTES,
                     static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, mlp3_bwd_kernel<BWD_CL>, g, x, h1, h2, w1, w2, w3, dx,
                         partials, B);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// the backward's cluster size, dynamic shared memory, blocks per SM and the
// clusters of it that the card runs at once (at BWD_GROUP_MAX groups)
int fused_mlp3_bwd_info(int* cluster, int* blocks_per_sm, int* clusters, int* smem_bytes) {
  *cluster = BWD_CL;
  *smem_bytes = BwdSplit<BWD_CL>::BYTES;
  cudaError_t e = bwd_smem_attr();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, mlp3_bwd_kernel<BWD_CL>,
                                                    BWD_THREADS, BwdSplit<BWD_CL>::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(BWD_CL, BWD_GROUP_MAX, 1, BWD_THREADS,
                                                BwdSplit<BWD_CL>::BYTES, nullptr, &attr);
  e = cudaOccupancyMaxActiveClusters(clusters, mlp3_bwd_kernel<BWD_CL>, &cfg);
  return static_cast<int>(e);
}

// partials (N, groups, 59134) -> grads (N, 59134); 2 <= groups <= BWD_GROUP_MAX
int fused_mlp3_bwd_reduce(const float* partials, int N, int groups, float* grads,
                          void* stream) {
  if (N < 1 || N > 65535 || groups < 2 || groups > BWD_GROUP_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N_GRAD + REDUCE_THREADS - 1) / REDUCE_THREADS, N);
  mlp3_bwd_reduce_kernel<<<grid, REDUCE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, groups, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
