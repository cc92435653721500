// Flash attention for Hopper (sm_90a): forward, quantized (int8 / fp8-e4m3)
// forward, and the two-kernel recompute backward (dq; dk and dv).
//
// Replaces the Pallas TPU kernels of distributed_neural_network_tpu/ops/
// flash_pallas.py, all reached through `flash_mha`:
//   flash_fwd_kernel        <- `_fwd_kernel`        (call `_fwd_call`)
//   flash_fwd_quant_kernel  <- `_fwd_quant_kernel`  (call `_fwd_quant_call`)
//   flash_dq_kernel         <- `_dq_kernel`         (call `_bwd_call`)
//   flash_dkv_kernel        <- `_dkv_kernel`        (call `_bwd_call`)
//
// For every (batch b, head h), on rows of a (B, S, H, D) tensor:
//   s  = (q k^T) * scale, masked to -1e30 (causal: col > row; and col >= S)
//   o  = softmax(s) v,  lse = m + log(max(l, 1e-30))          (forward)
//   p  = exp(s - lse),  ds = p * (dp - delta) * scale,  dp = do v^T
//   dq = ds k,  dk = ds^T q,  dv = p^T do                       (backward)
// with delta = rowsum(do * o) computed by the caller, as the TPU code does.
//
// The TPU rounding points are kept: p is rounded to V's dtype before P.V
// (forward), ds to K's dtype for dq, p to dO's dtype for dv and ds to Q's
// dtype for dk; o, dq, dk, dv are written in the inputs' dtype, lse in f32.
// Every product is accumulated in f32 (int32 for int8), every exp is expf.
//
// Quantized forward: q/k/v arrive as int8 or e4m3 codes with one f32 scale
// per row (quantized by the caller, as the TPU code quantizes in XLA).
// s = ((qc . kc) * sq * sk) * scale, the int8 dot accumulated in int32 and
// the fp8 dot in f32; v's scale is folded into p (p_f = p * sv) and p_f is
// re-quantized with ONE scale per row per k tile, sp = max(max|p_f|, 1e-30)
// / qmax, codes = rint(p_f / sp) (int8) or e4m3(p_f / sp) (round to nearest
// even, saturating); acc = acc * alpha + (codes . vc) * sp. The per-tile
// grouping makes the k tile (kBK = 64) part of the function: the plain
// version in ops/flash_attention.py takes the same block_k.
//
// What bounds it on this card: operations. At the flagship shape (B*H 128,
// S 2048, D 64, causal) the forward does 68.7 GFLOP of products for 134 MB
// of q/k/v/o, about 500 FLOP a byte, above the H100's ~295 FLOP/byte
// ridge in bf16: the bound is the FLOPs over the tensor cores' 989 TFLOP/s.
//
// Design (the simple first version; no tensor cores yet):
// - one block of 256 threads per (q tile of 64 rows, b*h) in the forward
//   and dq kernels, per (k tile of 64 rows, b*h) in the dkv kernel; each
//   output tile belongs to one block, so there are no atomics and a call
//   gives the same bits every time;
// - tiles are staged in shared memory as f32 (codes as int32 / f32 in the
//   quantized kernel), zero-padded past S and past D, with a row stride of
//   D_pad + 1 floats so that the column reads are free of bank conflicts;
// - thread (ty, tx) of a 16 x 16 grid owns score rows ty*4 .. ty*4+3 and
//   columns tx, tx+16, tx+32, tx+48 of the 64 x 64 tile, and output rows
//   ty*4 .. ty*4+3 at head dims tx, tx+16, ...; row max and row sums
//   reduce over the 16 lanes of a half warp by an xor butterfly, which
//   leaves the same bits in every lane;
// - the causal forward and dq loop over k tiles up to the diagonal only,
//   and dkv over q tiles from the diagonal on: the TPU kernels' causal
//   skip. Every row sees column 0 in the first k tile, so its running max
//   is finite after it, and fully masked rows of a diagonal tile add 0.
// Legality: any S >= 1 (tail tiles are masked), head dim 1..128, B*H up
// to 65535, unit stride on the head dim; the other strides are free, so a
// strided (B, S, H, D) view is read in place. The wrapper raises outside
// the rule.
//
// Left for later PRs: mma.sync / wgmma on the bf16, int8 and fp8 paths,
// cp.async or TMA double-buffering of the K/V tiles, and a persistent
// schedule that balances the causal triangle.
//
// Each entry point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr float kNegBig = -1e30f;
constexpr int kLDP = kBK + 1;  // row stride of the 64 x 64 p / ds tiles

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

__device__ __forceinline__ float fp8_to_f(uint8_t bits) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(bits), __NV_E4M3);
  return __half2float(__half(h));
}

// x rounded to e4m3 (nearest even, saturating at 448) and back
__device__ __forceinline__ float round_fp8(float x) {
  return fp8_to_f(static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3)));
}

// reductions over the 16 lanes that share a score row (xor butterfly)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A (B, S, H, D) tensor with unit stride on D (or a (B, S, H) one with no D
// axis, for the quantized kernel's scales); strides in elements.
struct View {
  void* p;
  long long sb, ss, sh;
};

template <typename E>
__device__ __forceinline__ E* at(const View& v, int b, int s, int h) {
  return static_cast<E*>(v.p) + b * v.sb + s * v.ss + h * v.sh;
}

// storage element E -> the shared-memory element SE
template <typename E, typename SE>
__device__ __forceinline__ SE load_elem(const E* p) {
  if constexpr (std::is_same<E, int8_t>::value) {
    return static_cast<SE>(*p);
  } else if constexpr (std::is_same<E, uint8_t>::value) {  // e4m3 codes
    return fp8_to_f(*p);
  } else {
    return to_f<E>(*p);
  }
}

// rows [row0, row0 + 64) of head (b, h) into dst (64 x ld), zero past S and D
template <typename E, typename SE, int DP>
__device__ __forceinline__ void load_tile(SE* dst, const View& v, int b, int h, int row0,
                                          int S, int D) {
  constexpr int LD = DP + 1;
  for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - r * DP;
    const int row = row0 + r;
    SE x = SE(0);
    if (row < S && d < D) x = load_elem<E, SE>(at<const E>(v, b, row, h) + d);
    dst[r * LD + d] = x;
  }
}

// out[i][j] = sum_d A[ty*4+i][d] * Bm[tx+16j][d] over two (64 x LD) tiles
template <typename SE, int DP>
__device__ __forceinline__ void dot_rows(SE (&out)[4][4], const SE* A, const SE* Bm, int ty,
                                         int tx) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = SE(0);
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    SE a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] += a[i] * bb[j];
  }
}

// out[i][j] = sum_k P(ty*4+i, k) * M[k][tx+16j] over k < 64, where P is a
// 64 x 64 tile (row stride kLDP) read as is or, kTrans, transposed
template <typename SE, int NDJ, int LD, bool kTrans>
__device__ __forceinline__ void dot_cols(SE (&out)[4][NDJ], const SE* P, const SE* M, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NDJ; ++j) out[i][j] = SE(0);
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    SE p[4], mv[NDJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = kTrans ? P[k * kLDP + ty * 4 + i] : P[(ty * 4 + i) * kLDP + k];
#pragma unroll
    for (int j = 0; j < NDJ; ++j) mv[j] = M[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NDJ; ++j) out[i][j] += p[i] * mv[j];
  }
}

// the score mask: column past the sequence or (causal) above the diagonal
__device__ __forceinline__ bool masked(int row, int col, int S, int causal) {
  return col >= S || (causal && col > row);
}

struct Args {
  View q, k, v, o;      // inputs (codes in the quantized kernel); o output
  View d_o, dq, dk, dv; // backward: dO input, gradients output
  View sq, sk, sv;      // quantized kernel: f32 row scales (B, S, H)
  float* lse;           // (B, H, S) f32: output of the forwards, input of the backward
  const float* delta;   // (B, H, S) f32 rowsum(dO * o)
  int B, S, H, D;
  float scale;
  int causal;
};

// ----------------------------------------------------------------- forward

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LD = DP + 1, NDJ = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, float, DP>(sQ, a.q, b, h, q0, a.S, a.D);
  float m[4], l[4], acc[4][NDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NDJ; ++j) acc[i][j] = 0.f;
  }
  const int q_end = min(q0 + kBQ, a.S);
  const int n_kt = a.causal ? (q_end - 1) / kBK + 1 : (a.S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, float, DP>(sK, a.k, b, h, k0, a.S, a.D);
    load_tile<T, float, DP>(sV, a.v, b, h, k0, a.S, a.D);
    __syncthreads();
    float s[4][4];
    dot_rows<float, DP>(s, sQ, sK, ty, tx);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(row, k0 + tx + 16 * j, a.S, a.causal) ? kNegBig : s[i][j] * a.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(ty * 4 + i) * kLDP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha[i] + row_sum(ps);
      m[i] = m_new;
    }
    __syncthreads();
    float pv[4][NDJ];
    dot_cols<float, NDJ, LD, false>(pv, sP, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NDJ; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* o = at<T>(a.o, b, row, h);
#pragma unroll
    for (int j = 0; j < NDJ; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) o[d] = from_f<T>(acc[i][j] / lc);
    }
    if (tx == 0) a.lse[(static_cast<long long>(bh)) * a.S + row] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------- quantized forward

// TO: o's dtype; kInt8: int8 codes with int32 dots, else e4m3 codes (stored
// as uint8) with f32 dots
template <typename TO, bool kInt8, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_quant_kernel(Args a) {
  using SE = typename std::conditional<kInt8, int, float>::type;
  using CE = typename std::conditional<kInt8, int8_t, uint8_t>::type;
  constexpr int LD = DP + 1, NDJ = DP / 16;
  constexpr float kQmax = kInt8 ? 127.f : 448.f;
  extern __shared__ float smem[];
  SE* sQ = reinterpret_cast<SE*>(smem);
  SE* sK = sQ + kBQ * LD;
  SE* sV = sK + kBK * LD;
  SE* sP = sV + kBK * LD;
  float* sSk = reinterpret_cast<float*>(sP + kBQ * kLDP);
  float* sSv = sSk + kBK;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<CE, SE, DP>(sQ, a.q, b, h, q0, a.S, a.D);
  float sq[4], m[4], l[4], acc[4][NDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    sq[i] = row < a.S ? *at<const float>(a.sq, b, row, h) : 0.f;
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NDJ; ++j) acc[i][j] = 0.f;
  }
  const int q_end = min(q0 + kBQ, a.S);
  const int n_kt = a.causal ? (q_end - 1) / kBK + 1 : (a.S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<CE, SE, DP>(sK, a.k, b, h, k0, a.S, a.D);
    load_tile<CE, SE, DP>(sV, a.v, b, h, k0, a.S, a.D);
    for (int c = threadIdx.x; c < kBK; c += kThreads) {
      const bool live = k0 + c < a.S;
      sSk[c] = live ? *at<const float>(a.sk, b, k0 + c, h) : 0.f;
      sSv[c] = live ? *at<const float>(a.sv, b, k0 + c, h) : 0.f;
    }
    __syncthreads();
    SE s_acc[4][4];
    dot_rows<SE, DP>(s_acc, sQ, sK, ty, tx);
    float alpha[4], sp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float s[4], mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[j] = masked(row, k0 + c, a.S, a.causal)
                   ? kNegBig
                   : static_cast<float>(s_acc[i][j]) * sq[i] * sSk[c] * a.scale;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float ps = 0.f, pf[4], amax = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[j] - m_new);
        ps += p;
        pf[j] = p * sSv[tx + 16 * j];
        amax = fmaxf(amax, fabsf(pf[j]));
      }
      l[i] = l[i] * alpha[i] + row_sum(ps);
      m[i] = m_new;
      sp[i] = fmaxf(row_max(amax), 1e-30f) / kQmax;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pq = pf[j] / sp[i];
        SE code;
        if constexpr (kInt8) {
          code = static_cast<int>(rintf(pq));  // round half to even, as jnp.round
        } else {
          code = round_fp8(pq);
        }
        sP[(ty * 4 + i) * kLDP + tx + 16 * j] = code;
      }
    }
    __syncthreads();
    SE pv[4][NDJ];
    dot_cols<SE, NDJ, LD, false>(pv, sP, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NDJ; ++j)
        acc[i][j] = acc[i][j] * alpha[i] + static_cast<float>(pv[i][j]) * sp[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    TO* o = at<TO>(a.o, b, row, h);
#pragma unroll
    for (int j = 0; j < NDJ; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) o[d] = from_f<TO>(acc[i][j] / lc);
    }
    if (tx == 0) a.lse[(static_cast<long long>(bh)) * a.S + row] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------------- backward: dq

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int LD = DP + 1, NDJ = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kBQ * LD;
  float* sK = sDO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sDS = sV + kBK * LD;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, float, DP>(sQ, a.q, b, h, q0, a.S, a.D);
  load_tile<T, float, DP>(sDO, a.d_o, b, h, q0, a.S, a.D);
  float lse[4], dlt[4], dq[4][NDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const long long r = static_cast<long long>(bh) * a.S + row;
    lse[i] = row < a.S ? a.lse[r] : 0.f;
    dlt[i] = row < a.S ? a.delta[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NDJ; ++j) dq[i][j] = 0.f;
  }
  const int q_end = min(q0 + kBQ, a.S);
  const int n_kt = a.causal ? (q_end - 1) / kBK + 1 : (a.S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, float, DP>(sK, a.k, b, h, k0, a.S, a.D);
    load_tile<T, float, DP>(sV, a.v, b, h, k0, a.S, a.D);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_rows<float, DP>(s, sQ, sK, ty, tx);
    dot_rows<float, DP>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = masked(row, k0 + tx + 16 * j, a.S, a.causal) ? kNegBig : s[i][j] * a.scale;
        const float p = row < a.S ? expf(sc - lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - dlt[i]) * a.scale;
        sDS[(ty * 4 + i) * kLDP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    float part[4][NDJ];
    dot_cols<float, NDJ, LD, false>(part, sDS, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NDJ; ++j) dq[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    T* out = at<T>(a.dq, b, row, h);
#pragma unroll
    for (int j = 0; j < NDJ; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) out[d] = from_f<T>(dq[i][j]);
    }
  }
}

// --------------------------------------------------------- backward: dk, dv

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int LD = DP + 1, NDJ = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sDO = sQ + kBQ * LD;
  float* sP = sDO + kBQ * LD;
  float* sDS = sP + kBQ * kLDP;
  float* sLse = sDS + kBQ * kLDP;
  float* sDlt = sLse + kBQ;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, float, DP>(sK, a.k, b, h, k0, a.S, a.D);
  load_tile<T, float, DP>(sV, a.v, b, h, k0, a.S, a.D);
  float dk[4][NDJ], dv[4][NDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NDJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  for (int qt = a.causal ? k0 / kBQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile<T, float, DP>(sQ, a.q, b, h, q0, a.S, a.D);
    load_tile<T, float, DP>(sDO, a.d_o, b, h, q0, a.S, a.D);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const long long i = static_cast<long long>(bh) * a.S + q0 + r;
      sLse[r] = q0 + r < a.S ? a.lse[i] : 0.f;
      sDlt[r] = q0 + r < a.S ? a.delta[i] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_rows<float, DP>(s, sQ, sK, ty, tx);   // rows: q, columns: k
    dot_rows<float, DP>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sc = masked(row, k0 + c, a.S, a.causal) ? kNegBig : s[i][j] * a.scale;
        const float p = row < a.S ? expf(sc - sLse[r]) : 0.f;
        const float ds = p * (dp[i][j] - sDlt[r]) * a.scale;
        sP[r * kLDP + c] = round_to<T>(p);
        sDS[r * kLDP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
    float pv[4][NDJ], pk[4][NDJ];  // rows: k, columns: head dims
    dot_cols<float, NDJ, LD, true>(pv, sP, sDO, ty, tx);
    dot_cols<float, NDJ, LD, true>(pk, sDS, sQ, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NDJ; ++j) {
        dv[i][j] += pv[i][j];
        dk[i][j] += pk[i][j];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= a.S) continue;
    T* ok = at<T>(a.dk, b, row, h);
    T* ov = at<T>(a.dv, b, row, h);
#pragma unroll
    for (int j = 0; j < NDJ; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) {
        ok[d] = from_f<T>(dk[i][j]);
        ov[d] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// shared memory in bytes, per kernel kind and padded head dim
enum Kind { kFwd, kQuant, kDq, kDkv };

size_t smem_bytes(Kind kind, int dp) {
  const size_t ld = dp + 1, tile = 64 * ld, ptile = 64 * kLDP;
  switch (kind) {
    case kFwd: return 4 * (3 * tile + ptile);
    case kQuant: return 4 * (3 * tile + ptile + 2 * kBK);
    case kDq: return 4 * (4 * tile + ptile);
    default: return 4 * (4 * tile + 2 * ptile + 2 * kBQ);
  }
}

template <void (*Kernel)(Args)>
cudaError_t launch(Kind kind, int dp, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(kind, dp);
  // each kernel instance raises its dynamic shared-memory cap once, on its
  // first launch (outside any CUDA graph capture)
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid((a.S + 63) / 64, a.B * a.H);
  Kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the padded head dim: 16, 32, 64 or 128
int pad_dim(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

#define FLASH_DISPATCH(KERNEL, KIND, ...)                                      \
  switch (pad_dim(a.D)) {                                                      \
    case 16: return launch<KERNEL<__VA_ARGS__, 16>>(KIND, 16, a, stream);      \
    case 32: return launch<KERNEL<__VA_ARGS__, 32>>(KIND, 32, a, stream);      \
    case 64: return launch<KERNEL<__VA_ARGS__, 64>>(KIND, 64, a, stream);      \
    default: return launch<KERNEL<__VA_ARGS__, 128>>(KIND, 128, a, stream);    \
  }

bool shape_ok(int B, int S, int H, int D) {
  return B >= 1 && S >= 1 && H >= 1 && D >= 1 && D <= kMaxHeadDim &&
         static_cast<long long>(B) * H <= 65535;
}

View view(void* p, long long sb, long long ss, long long sh) { return View{p, sb, ss, sh}; }

}  // namespace

extern "C" {

int flash_max_head_dim() { return kMaxHeadDim; }
int flash_block_k() { return kBK; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o all of it)
int flash_fwd(int dtype, void* q, long long q_sb, long long q_ss, long long q_sh, void* k,
              long long k_sb, long long k_ss, long long k_sh, void* v, long long v_sb,
              long long v_ss, long long v_sh, void* o, long long o_sb, long long o_ss,
              long long o_sh, float* lse, int B, int S, int H, int D, float scale, int causal,
              cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return cudaErrorInvalidValue;
  Args a{};
  a.q = view(q, q_sb, q_ss, q_sh);
  a.k = view(k, k_sb, k_ss, k_sh);
  a.v = view(v, v_sb, v_ss, v_sh);
  a.o = view(o, o_sb, o_ss, o_sh);
  a.lse = lse;
  a.B = B, a.S = S, a.H = H, a.D = D, a.scale = scale, a.causal = causal;
  if (dtype == 0) { FLASH_DISPATCH(flash_fwd_kernel, kFwd, float) }
  if (dtype == 1) { FLASH_DISPATCH(flash_fwd_kernel, kFwd, __nv_bfloat16) }
  return cudaErrorInvalidValue;
}

// out_dtype: o's (0 float32, 1 bfloat16); fmt: 0 = int8 codes, 1 = e4m3 codes;
// sq/sk/sv: (B, S, H) f32 row scales
int flash_fwd_quant(int out_dtype, int fmt, void* q, long long q_sb, long long q_ss,
                    long long q_sh, void* k, long long k_sb, long long k_ss, long long k_sh,
                    void* v, long long v_sb, long long v_ss, long long v_sh, void* sq,
                    long long sq_sb, long long sq_ss, long long sq_sh, void* sk, long long sk_sb,
                    long long sk_ss, long long sk_sh, void* sv, long long sv_sb, long long sv_ss,
                    long long sv_sh, void* o, long long o_sb, long long o_ss, long long o_sh,
                    float* lse, int B, int S, int H, int D, float scale, int causal,
                    cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return cudaErrorInvalidValue;
  Args a{};
  a.q = view(q, q_sb, q_ss, q_sh);
  a.k = view(k, k_sb, k_ss, k_sh);
  a.v = view(v, v_sb, v_ss, v_sh);
  a.sq = view(sq, sq_sb, sq_ss, sq_sh);
  a.sk = view(sk, sk_sb, sk_ss, sk_sh);
  a.sv = view(sv, sv_sb, sv_ss, sv_sh);
  a.o = view(o, o_sb, o_ss, o_sh);
  a.lse = lse;
  a.B = B, a.S = S, a.H = H, a.D = D, a.scale = scale, a.causal = causal;
  if (out_dtype == 0 && fmt == 0) { FLASH_DISPATCH(flash_fwd_quant_kernel, kQuant, float, true) }
  if (out_dtype == 0 && fmt == 1) { FLASH_DISPATCH(flash_fwd_quant_kernel, kQuant, float, false) }
  if (out_dtype == 1 && fmt == 0) {
    FLASH_DISPATCH(flash_fwd_quant_kernel, kQuant, __nv_bfloat16, true)
  }
  if (out_dtype == 1 && fmt == 1) {
    FLASH_DISPATCH(flash_fwd_quant_kernel, kQuant, __nv_bfloat16, false)
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and dq); lse, delta (B, H, S) f32
int flash_dq(int dtype, void* q, long long q_sb, long long q_ss, long long q_sh, void* k,
             long long k_sb, long long k_ss, long long k_sh, void* v, long long v_sb,
             long long v_ss, long long v_sh, void* d_o, long long do_sb, long long do_ss,
             long long do_sh, float* lse, const float* delta, void* dq, long long dq_sb,
             long long dq_ss, long long dq_sh, int B, int S, int H, int D, float scale,
             int causal, cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return cudaErrorInvalidValue;
  Args a{};
  a.q = view(q, q_sb, q_ss, q_sh);
  a.k = view(k, k_sb, k_ss, k_sh);
  a.v = view(v, v_sb, v_ss, v_sh);
  a.d_o = view(d_o, do_sb, do_ss, do_sh);
  a.dq = view(dq, dq_sb, dq_ss, dq_sh);
  a.lse = lse;
  a.delta = delta;
  a.B = B, a.S = S, a.H = H, a.D = D, a.scale = scale, a.causal = causal;
  if (dtype == 0) { FLASH_DISPATCH(flash_dq_kernel, kDq, float) }
  if (dtype == 1) { FLASH_DISPATCH(flash_dq_kernel, kDq, __nv_bfloat16) }
  return cudaErrorInvalidValue;
}

int flash_dkv(int dtype, void* q, long long q_sb, long long q_ss, long long q_sh, void* k,
              long long k_sb, long long k_ss, long long k_sh, void* v, long long v_sb,
              long long v_ss, long long v_sh, void* d_o, long long do_sb, long long do_ss,
              long long do_sh, float* lse, const float* delta, void* dk, long long dk_sb,
              long long dk_ss, long long dk_sh, void* dv, long long dv_sb, long long dv_ss,
              long long dv_sh, int B, int S, int H, int D, float scale, int causal,
              cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return cudaErrorInvalidValue;
  Args a{};
  a.q = view(q, q_sb, q_ss, q_sh);
  a.k = view(k, k_sb, k_ss, k_sh);
  a.v = view(v, v_sb, v_ss, v_sh);
  a.d_o = view(d_o, do_sb, do_ss, do_sh);
  a.dk = view(dk, dk_sb, dk_ss, dk_sh);
  a.dv = view(dv, dv_sb, dv_ss, dv_sh);
  a.lse = lse;
  a.delta = delta;
  a.B = B, a.S = S, a.H = H, a.D = D, a.scale = scale, a.causal = causal;
  if (dtype == 0) { FLASH_DISPATCH(flash_dkv_kernel, kDkv, float) }
  if (dtype == 1) { FLASH_DISPATCH(flash_dkv_kernel, kDkv, __nv_bfloat16) }
  return cudaErrorInvalidValue;
}

}  // extern "C"
