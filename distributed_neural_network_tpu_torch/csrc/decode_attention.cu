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
// with the TPU kernel's rounding points: p is rounded to V's dtype before
// P.V; in the int8 kernel each dequantized k/v element (code * scale) is
// rounded to q's dtype before its dot; the softmax denominator is clamped
// to 1e-30.
//
// What bounds it on this card: bytes. Each live K/V row is read once and
// used for 2*Dh FLOPs, about 1 FLOP per byte in bf16 and 2 in int8, far
// below the H100's ~295 FLOP/byte ridge, so the least time is the live K/V
// prefix (plus q, o and the scales) over 3.35 TB/s.
//
// Design (the simple first version):
// - one block of 4 warps per (b, h); the block loops over the live prefix
//   [0, pos[b]] only, which is the port of the TPU kernel's dead-block skip:
//   slots past pos are never read;
// - the 4 warps split that range into contiguous chunks; each warp walks
//   its chunk 8 columns at a time with its own online-softmax state
//   (m, l, acc), lane i holding head elements i, i+32, ...; the 8 dot
//   products reduce across the warp by an xor butterfly, which leaves the
//   same bits in every lane;
// - the warps merge through shared memory in a fixed order.
// The order of every sum depends only on pos[b] and Dh, never on the cache
// length `total` or on scheduling, so a rerun gives the same bits, and a
// cache padded to another length (the serving engine's bucket width,
// generate()'s static cache) gives the same bits as well.
// K/V (and the scales) are addressed through strides, so the serving
// engine's gathered (B, S, H, Dh) slab is read as its (B, H, S, Dh) view
// without a copy. The head dimension may be any of 1..256.
//
// Left for later PRs: reading the paged pool through the block table
// instead of a gathered copy, split-K across blocks for long prefixes at
// small B*H, cp.async/TMA pipelining of the K/V rows, and one CUDA graph
// per serving bucket.
//
// Each entry point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

bool shape_ok(int B, int H, int total, int D) {
  return B >= 1 && H >= 1 && total >= 1 && D >= 1 && D <= kMaxHeadDim &&
         static_cast<long long>(B) * H <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

int decode_attention_max_head_dim() { return kMaxHeadDim; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out all of it)
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
