// Single-query decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of distributed_neural_network_tpu/ops/
// decode_pallas.py: `_decode_kernel` (K/V in q's dtype, f32 or bf16) and
// `_decode_kernel_q8` (int8 K/V with per-slot f32 scales), both reached
// through `decode_cache_attention`. For every (batch b, head h):
//
//   s_j = (q . k_j) * scale, j = 0 .. min(pos[b], total - 1)   (f32)
//   o   = sum_j softmax(s)_j v_j                                (f32, cast to q's dtype)
//
// with the TPU kernel's rounding points: f32 scores times scale; the
// unnormalised p = exp(s - m) is rounded to V's dtype before P.V (m: the
// running max of the simt kernel's tile, the max of a piece on the split
// route), the parts merged with exp(m_i - m) weights; in the int8 kernel each
// dequantized k/v element (code * scale) is rounded to q's dtype before its
// dot; the softmax denominator is clamped to 1e-30; o is cast to q's dtype.
//
// What bounds it on this card: bytes. Each live K/V row is read once and
// used for 2*Dh FLOPs, about 1 FLOP per byte in bf16 and 2 in int8, far
// below the H100's ~295 FLOP/byte ridge, so the least time is the live K/V
// prefix (plus q, o and the scales) over 3.35 TB/s.
//
// Two routes, chosen by the stated rule (`split_ok` below; `decode_route` in
// ops/decode_attention.py states the same rule):
// - "split": decode_split_kernel, for K/V in q's dtype (f32, bf16) with a
//   head dim of whole 16-byte vectors (at most 256), 16-byte-aligned q, K, V
//   and out, and K/V batch, head and slot strides in whole 16-byte vectors
//   (stride 0 included: the prefill's broadcast slab);
// - "simt": decode_attention_kernel, for every other legal input and for
//   int8 K/V.
// The split route's entry point refuses inputs outside the rule.
//
// The split route (decode_split_kernel<T, L, NV>). The live prefix [0, n),
// n = min(pos[b], total - 1) + 1, is cut into at most 8 contiguous pieces of
// piece_rows(n, Dh) rows (a multiple of 16; the last piece may be shorter),
// and each (b, h) row is a thread-block cluster with one block per piece:
// - a group of L lanes reads one K or V row with 16-byte vector loads (L =
//   Dh / elements per 16 bytes, rounded up to a power of two, at most 32; NV
//   vectors a lane); at Dh 64 in bf16 8 lanes hold a row, so a warp reads 4
//   rows a load and each dot reduces in 3 shuffles inside its group;
// - a block walks its piece in chunks of 4 warps x (32 / L) groups x 4 rows;
//   every K and V load of a chunk is issued before the first score is formed,
//   so a lane has 4 rows of K and 4 of V in flight;
// - the piece's own max m is reduced over the block first, then p = exp(s -
//   m) is rounded to V's dtype for P.V and summed unrounded for l (a piece
//   longer than one chunk reads its K twice, scores and then P.V, with the
//   same arithmetic, so the bits do not depend on the chunking);
// - each block pushes its (m, l, acc) into rank 0's shared memory
//   (distributed shared memory), and rank 0 merges the pieces in order with
//   weights exp(m_i - max m), clamps the denominator at 1e-30 and writes o.
// The cluster has next_pow2(min(8, ceil(total / piece_rows(1, Dh)))) blocks;
// blocks past the last piece only take part in the cluster barriers. The
// pieces, the lanes' rows and every sum's order are functions of n and Dh
// alone, never of total, B, H or the other rows of the batch, so a cache
// padded to another length (the serving engine's bucket width, generate()'s
// static cache) and another batch give the same bits, and so does a rerun.
//
// The simt route (decode_attention_kernel, the first version): one block of
// 4 warps per (b, h) over the live prefix [0, pos[b]] only (the port of the
// TPU kernel's dead-block skip); the 4 warps split that range into
// contiguous chunks, each walks its chunk 8 columns at a time with its own
// online-softmax state (m, l, acc), lane i holding head elements i, i+32,
// ...; the 8 dot products reduce across the warp by an xor butterfly, which
// leaves the same bits in every lane; the warps merge through shared memory
// in a fixed order. Its sum order, too, depends only on pos[b] and Dh. It
// takes any head dim of 1..256 and int8 K/V (dequantized in the loop).
// K/V (and the scales) are addressed through strides on both routes, so the
// serving engine's gathered (B, S, H, Dh) slab is read as its (B, H, S, Dh)
// view without a copy.
//
// Left for later PRs: the int8 K/V on the split design, reading the paged
// pool through the block table instead of a gathered copy, and one CUDA
// graph per serving bucket.
//
// Each entry point returns cudaGetLastError() right after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;  // columns a warp handles per online-softmax step
constexpr int kMaxHeadDim = 256;
constexpr float kNegBig = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA do
}

// x rounded to T and back (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f<T>(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;       // (B, H, D) contiguous, T
  const void* k;       // (B, H, total, D), unit stride on D; T or int8
  const void* v;
  const float* ks;     // (B, H, total) f32 scales (int8 kernel only)
  const float* vs;
  const int* pos;      // (B,) int32, or null: pos_scalar for every b
  int pos_scalar;
  void* out;           // (B, H, D) contiguous, T
  int B, H, total, D;
  float scale;         // 1/sqrt(D), rounded to f32 by the caller
  long long k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long ks_sb, ks_sh, ks_st, vs_sb, vs_sh, vs_st;
};

// T: q/out dtype; KV: cache dtype (T, or int8_t with per-slot scales);
// NT: head elements per lane (ceil(D / 32) rounded up to a power of two)
template <typename T, typename KV, int NT>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHeadDim];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = a.pos ? a.pos[b] : a.pos_scalar;
  const int n = max(0, min(p, a.total - 1) + 1);  // live columns [0, n)
  const int chunk = (n + kWarps - 1) / kWarps;
  const int c0 = warp * chunk, c1 = min(c0 + chunk, n);

  const T* q = static_cast<const T*>(a.q) + static_cast<long long>(bh) * a.D;
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + h * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ksb = kQ8 ? a.ks + b * a.ks_sb + h * a.ks_sh : nullptr;
  const float* vsb = kQ8 ? a.vs + b * a.vs_sb + h * a.vs_sh : nullptr;

  float qr[NT], acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = lane + 32 * t;
    qr[t] = d < a.D ? to_f<T>(q[d]) : 0.f;
    acc[t] = 0.f;
  }
  float m = kNegBig, l = 0.f;

  for (int j0 = c0; j0 < c1; j0 += kTile) {
    float s[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int j = j0 + u;
      float part = 0.f;
      if (j < c1) {
        const KV* kr = kb + j * a.k_st;
        const float sc = kQ8 ? ksb[j * a.ks_st] : 1.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          if (d < a.D) {
            const float kf = kQ8 ? round_to<T>(to_f<KV>(kr[d]) * sc) : to_f<KV>(kr[d]);
            part += qr[t] * kf;
          }
        }
      }
      s[u] = part;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      s[u] = warp_sum(s[u]) * a.scale;
      if (j0 + u < c1) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f, pv[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) pv[t] = 0.f;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int j = j0 + u;
      if (j < c1) {
        const float pj = expf(s[u] - m_new);
        psum += pj;
        const float pr = round_to<T>(pj);
        const KV* vr = vb + j * a.v_st;
        const float sc = kQ8 ? vsb[j * a.vs_st] : 1.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          if (d < a.D) {
            const float vf = kQ8 ? round_to<T>(to_f<KV>(vr[d]) * sc) : to_f<KV>(vr[d]);
            pv[t] += pr * vf;
          }
        }
      }
    }
    l = l * alpha + psum;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = acc[t] * alpha + pv[t];
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = lane + 32 * t;
    if (d < a.D) sm_acc[warp][d] = acc[t];
  }
  __syncthreads();

  float mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kWarps], den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(sm_m[w] - mx);
    den += sm_l[w] * wgt[w];
  }
  den = fmaxf(den, 1e-30f);
  T* out = static_cast<T*>(a.out) + static_cast<long long>(bh) * a.D;
  for (int d = threadIdx.x; d < a.D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * wgt[w];
    out[d] = from_f<T>(o / den);
  }
}

template <typename T, typename KV>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H), block(kThreads);
  if (a.D <= 32) {
    decode_attention_kernel<T, KV, 1><<<grid, block, 0, stream>>>(a);
  } else if (a.D <= 64) {
    decode_attention_kernel<T, KV, 2><<<grid, block, 0, stream>>>(a);
  } else if (a.D <= 128) {
    decode_attention_kernel<T, KV, 4><<<grid, block, 0, stream>>>(a);
  } else {
    decode_attention_kernel<T, KV, 8><<<grid, block, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------ the split route

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kRowsPerLane = 4;     // rows a lane group holds per chunk
constexpr int kMaxPieces = 8;       // the cluster's blocks at most (portable size)
constexpr int kPieceStep = 16;      // piece rows are a multiple of this
constexpr int kMinPieceElems = 1024;  // a piece holds at least this many K elements
constexpr int kVecBytes = 16;

// rows of each piece of a live prefix of n rows at head dim D (the last
// piece may be shorter); ops/decode_attention.py `piece_rows` mirrors it
__host__ __device__ __forceinline__ int piece_rows(int n, int D) {
  const int even = (n + kMaxPieces - 1) / kMaxPieces, least = kMinPieceElems / D;
  const int r = even > least ? even : least;
  return (r + kPieceStep - 1) / kPieceStep * kPieceStep;
}

__host__ __device__ __forceinline__ int num_pieces(int n, int D) {
  if (n <= 0) return 0;
  const int r = piece_rows(n, D);
  return (n + r - 1) / r;
}

// blocks per cluster for a cache of `total` rows: every n <= total has at
// most ceil(total / piece_rows(1, D)) pieces (piece_rows grows with n)
int split_cluster(int total, int D) {
  const int most = std::min(kMaxPieces, (total + piece_rows(1, D) - 1) / piece_rows(1, D));
  int cl = 1;
  while (cl < most) cl <<= 1;
  return cl;
}

// 16 bytes as floats: 8 bf16 or 4 f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

// the cluster barrier in two halves: arrive at the start (relaxed: no
// memory is published by it), wait before the first write into another
// block's shared memory, which is then known to be running
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// T: q/K/V/out dtype; L: lanes that read one row (a power of two <= 32);
// NV: 16-byte vectors of a row per lane
template <typename T, int L, int NV>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(Args a) {
  constexpr int VE = kVecBytes / static_cast<int>(sizeof(T));  // elements per vector
  constexpr int NE = NV * VE;                  // elements of a row per lane
  constexpr int RW = 32 / L;                   // rows of a warp per load
  constexpr int CH = kSplitWarps * RW * kRowsPerLane;  // rows per chunk
  __shared__ float sm_m[kSplitWarps], sm_l[kSplitWarps];
  __shared__ __align__(16) float sm_acc[kSplitWarps][kMaxHeadDim];
  __shared__ float piece_m[kMaxPieces], piece_l[kMaxPieces];  // rank 0: every piece's
  __shared__ __align__(16) float piece_acc[kMaxPieces][kMaxHeadDim];

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = static_cast<int>(blockIdx.x / cluster.num_blocks());
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / L, gl = lane % L;  // the lane's row group and place in it
  const int nvec = a.D / VE;                 // vectors of a row

  const T* q = static_cast<const T*>(a.q) + static_cast<long long>(bh) * a.D;
  float qf[NE];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = gl + L * j;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (vi < nvec) u = *reinterpret_cast<const uint4*>(q + vi * VE);
    unpack<T>(u, qf + j * VE);
  }
  const int p = a.pos ? a.pos[b] : a.pos_scalar;
  const int n = max(0, min(p, a.total - 1) + 1);  // live rows [0, n)
  const int rows = piece_rows(n, a.D);
  const int np = num_pieces(n, a.D);
  const int r0 = rank * rows, r1 = min(r0 + rows, n);

  float m = kNegBig, l = 0.f, acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.f;

  if (rank < np) {
    const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
    const int nch = (r1 - r0 + CH - 1) / CH;
    uint4 kr[kRowsPerLane][NV], vr[kRowsPerLane][NV];
    float s[kRowsPerLane];
    // the lane group's row of slot u in chunk c
    auto row_of = [&](int c, int u) { return r0 + c * CH + (u * kSplitWarps + warp) * RW + grp; };
    auto load = [&](const T* base, long long st, int c, uint4 (&dst)[kRowsPerLane][NV]) {
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        const int r = row_of(c, u);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int vi = gl + L * j;
          dst[u][j] = make_uint4(0u, 0u, 0u, 0u);
          if (r < r1 && vi < nvec)
            dst[u][j] = *reinterpret_cast<const uint4*>(base + r * st + vi * VE);
        }
      }
    };
    // s[u] = (q . k_row) * scale: the lane's NE products in order, then the
    // group's xor butterfly (the same bits in every lane of the group)
    auto scores = [&]() {
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float kf[VE];
          unpack<T>(kr[u][j], kf);
#pragma unroll
          for (int e = 0; e < VE; ++e) part = fmaf(qf[j * VE + e], kf[e], part);
        }
        s[u] = part;
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kRowsPerLane; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      }
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) s[u] *= a.scale;
    };

    // the piece's max: scores of every chunk (K and V of a one-chunk piece
    // are loaded together and kept)
    float mx = kNegBig;
    for (int c = 0; c < nch; ++c) {
      load(kb, a.k_st, c, kr);
      if (nch == 1) load(vb, a.v_st, c, vr);
      scores();
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u)
        if (row_of(c, u) < r1) mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) sm_m[warp] = mx;
    __syncthreads();
    m = sm_m[0];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) m = fmaxf(m, sm_m[w]);

    // P.V against the piece's max, chunk by chunk, slot by slot
    for (int c = 0; c < nch; ++c) {
      if (nch > 1) {
        load(kb, a.k_st, c, kr);
        load(vb, a.v_st, c, vr);
        scores();
      }
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        if (row_of(c, u) >= r1) continue;
        const float pj = expf(s[u] - m);
        l += pj;
        const float pr = round_to<T>(pj);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VE];
          unpack<T>(vr[u][j], vf);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[j * VE + e] = fmaf(pr, vf[e], acc[j * VE + e]);
        }
      }
    }
    // the warp's groups, then the block's warps, in a fixed order
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = gl + L * j;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < VE; ++e) sm_acc[warp][vi * VE + e] = acc[j * VE + e];
        }
      }
    }
    if (lane == 0) sm_l[warp] = l;
    __syncthreads();
  }

  cluster_wait();  // every block of the cluster runs: rank 0's memory can take writes
  if (rank < np) {
    float* dst_acc = cluster.map_shared_rank(&piece_acc[rank][0], 0);
    for (int d = threadIdx.x; d < a.D; d += kSplitThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) o += sm_acc[w][d];
      dst_acc[d] = o;
    }
    if (threadIdx.x == 0) {
      float lw = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) lw += sm_l[w];
      *cluster.map_shared_rank(&piece_m[rank], 0) = m;
      *cluster.map_shared_rank(&piece_l[rank], 0) = lw;
    }
  }
  cluster.sync();  // every piece is in rank 0's shared memory
  if (rank != 0) return;

  float mx = kNegBig;
  for (int i = 0; i < np; ++i) mx = fmaxf(mx, piece_m[i]);
  float wgt[kMaxPieces], den = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPieces; ++i) {
    wgt[i] = i < np ? expf(piece_m[i] - mx) : 0.f;
    if (i < np) den = fmaf(piece_l[i], wgt[i], den);
  }
  den = fmaxf(den, 1e-30f);
  T* out = static_cast<T*>(a.out) + static_cast<long long>(bh) * a.D;
  for (int d = threadIdx.x; d < a.D; d += kSplitThreads) {
    float o = 0.f;
    for (int i = 0; i < np; ++i) o = fmaf(piece_acc[i][d], wgt[i], o);
    out[d] = from_f<T>(o / den);
  }
}

cudaLaunchConfig_t split_config(const Args& a, int cl, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B * a.H * cl));
  cfg.blockDim = dim3(kSplitThreads);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the instance for D: lanes per row = the row's 16-byte vectors rounded up
// to a power of two, at most 32 (then NV = 2 vectors a lane: f32 rows of
// more than 128 elements); f(L, NV) gets them as integral constants
template <typename T, typename F>
cudaError_t split_instance(int D, F&& f) {
  using std::integral_constant;
  const int nvec = D / (kVecBytes / static_cast<int>(sizeof(T)));
  if (nvec <= 1) return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
  if (nvec <= 2) return f(integral_constant<int, 2>{}, integral_constant<int, 1>{});
  if (nvec <= 4) return f(integral_constant<int, 4>{}, integral_constant<int, 1>{});
  if (nvec <= 8) return f(integral_constant<int, 8>{}, integral_constant<int, 1>{});
  if (nvec <= 16) return f(integral_constant<int, 16>{}, integral_constant<int, 1>{});
  if (nvec <= 32) return f(integral_constant<int, 32>{}, integral_constant<int, 1>{});
  if constexpr (sizeof(T) == 4) return f(integral_constant<int, 32>{}, integral_constant<int, 2>{});
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  const int cl = split_cluster(a.total, a.D);
  if (static_cast<long long>(a.B) * a.H * cl > 0x7fffffffLL) return cudaErrorInvalidValue;
  return split_instance<T>(a.D, [&](auto l, auto nv) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = split_config(a, cl, stream, &attr);
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, decode_split_kernel<T, decltype(l)::value, decltype(nv)::value>, a);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

// blocks of the instance for D that fit on one SM, and clusters of it (for a
// cache of `total` rows) that the card runs at once, at B * H = 1024
template <typename T>
cudaError_t split_occupancy(int D, int total, int* blocks, int* clusters) {
  return split_instance<T>(D, [&](auto l, auto nv) {
    auto* kernel = decode_split_kernel<T, decltype(l)::value, decltype(nv)::value>;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kSplitThreads, 0);
    if (e != cudaSuccess) return e;
    Args a{};
    a.B = 1024, a.H = 1, a.D = D, a.total = total;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = split_config(a, split_cluster(total, D), nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  });
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// the split route's rule: K/V in q's dtype (the caller's dtype code), a head
// dim of whole 16-byte vectors up to kMaxHeadDim, 16-byte-aligned q/k/v/out
// and K/V batch, head and slot strides in whole vectors (0 included)
bool split_ok(int elem_bytes, const Args& a) {
  const int ve = kVecBytes / elem_bytes;
  if (a.D % ve != 0 || a.D > kMaxHeadDim) return false;
  if (!aligned(a.q) || !aligned(a.k) || !aligned(a.v) || !aligned(a.out)) return false;
  for (long long st : {a.k_sb, a.k_sh, a.k_st, a.v_sb, a.v_sh, a.v_st})
    if (st % ve != 0) return false;
  return true;
}

bool shape_ok(int B, int H, int total, int D) {
  return B >= 1 && H >= 1 && total >= 1 && D >= 1 && D <= kMaxHeadDim &&
         static_cast<long long>(B) * H <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

int decode_attention_max_head_dim() { return kMaxHeadDim; }

// the simt route (decode_attention_kernel); dtype: 0 = float32, 1 = bfloat16
// (q, k, v, out all of it)
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     const int* pos, int pos_scalar, void* out, int B, int H, int total,
                     int D, float scale, long long k_sb, long long k_sh, long long k_st,
                     long long v_sb, long long v_sh, long long v_st, cudaStream_t stream) {
  if (!shape_ok(B, H, total, D)) return cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, pos, pos_scalar, out, B, H, total, D, scale,
         k_sb, k_sh, k_st, v_sb, v_sh, v_st, 0, 0, 0, 0, 0, 0};
  if (dtype == 0) return launch_typed<float, float>(a, stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, stream);
  return cudaErrorInvalidValue;
}

// the split route (decode_split_kernel); refuses inputs outside split_ok
int decode_attention_split(int dtype, const void* q, const void* k, const void* v,
                           const int* pos, int pos_scalar, void* out, int B, int H, int total,
                           int D, float scale, long long k_sb, long long k_sh, long long k_st,
                           long long v_sb, long long v_sh, long long v_st,
                           cudaStream_t stream) {
  if (!shape_ok(B, H, total, D)) return cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, pos, pos_scalar, out, B, H, total, D, scale,
         k_sb, k_sh, k_st, v_sb, v_sh, v_st, 0, 0, 0, 0, 0, 0};
  if (dtype == 0 && split_ok(4, a)) return launch_split<float>(a, stream);
  if (dtype == 1 && split_ok(2, a)) return launch_split<__nv_bfloat16>(a, stream);
  return cudaErrorInvalidValue;
}

// the split rule's rows per piece (ops/decode_attention.py `piece_rows`
// states the same rule; chip_smoke.py compares the two)
int decode_attention_piece_rows(int n, int D) { return D >= 1 ? piece_rows(n, D) : -1; }

// the split instance for (dtype, D): its blocks per SM, the blocks of its
// cluster for a cache of `total` rows, and the clusters that run at once
int decode_attention_split_info(int dtype, int D, int total, int* blocks_per_sm,
                                int* cluster, int* clusters) {
  if (D < 1 || D > kMaxHeadDim || total < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  *cluster = split_cluster(total, D);
  return dtype == 0 ? split_occupancy<float>(D, total, blocks_per_sm, clusters)
                    : split_occupancy<__nv_bfloat16>(D, total, blocks_per_sm, clusters);
}

// int8 K/V with f32 per-slot scales; dtype is q's and out's (0 f32, 1 bf16)
int decode_attention_q8(int dtype, const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* pos, int pos_scalar,
                        void* out, int B, int H, int total, int D, float scale,
                        long long k_sb, long long k_sh, long long k_st, long long v_sb,
                        long long v_sh, long long v_st, long long ks_sb, long long ks_sh,
                        long long ks_st, long long vs_sb, long long vs_sh, long long vs_st,
                        cudaStream_t stream) {
  if (!shape_ok(B, H, total, D)) return cudaErrorInvalidValue;
  Args a{q, k, v, ks, vs, pos, pos_scalar, out, B, H, total, D, scale,
         k_sb, k_sh, k_st, v_sb, v_sh, v_st, ks_sb, ks_sh, ks_st, vs_sb, vs_sh, vs_st};
  if (dtype == 0) return launch_typed<float, int8_t>(a, stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16, int8_t>(a, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
