// Flash attention for Hopper (sm_90a): forward, quantized (int8 / fp8-e4m3)
// forward, and the two-kernel recompute backward (dq; dk and dv).
//
// Replaces the Pallas TPU kernels of distributed_neural_network_tpu/ops/
// flash_pallas.py, all reached through `flash_mha`:
//   flash_fwd_wgmma_kernel, flash_fwd_mma_kernel, flash_fwd_kernel
//                           <- `_fwd_kernel`        (call `_fwd_call`)
//   flash_fwd_quant_mma_kernel, flash_fwd_quant_kernel
//                           <- `_fwd_quant_kernel`  (call `_fwd_quant_call`)
//   flash_dq_mma_kernel, flash_dq_kernel    <- `_dq_kernel`  (call `_bwd_call`)
//   flash_dkv_mma_kernel, flash_dkv_kernel  <- `_dkv_kernel` (call `_bwd_call`)
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
// Two routes for the forward, the quantized forward and the backward pair,
// chosen by one stated rule (mma_ok and quant_mma_ok below; `fwd_route`,
// `quant_route` and `bwd_route` in ops/flash_attention.py state the same
// rule through one helper):
// - "mma": the tensor-core kernels, for bf16 operands with D % 16 == 0, D <=
//   128, 16-byte-aligned base pointers and batch/sequence/head strides that
//   are multiples of 8 elements (the model's (B, S, H, D) projections all
//   are): flash_fwd_wgmma_kernel at a padded head dim of 64 (D 48, 64),
//   flash_fwd_mma_kernel at the others, flash_dq_mma_kernel and
//   flash_dkv_mma_kernel; and for the quantized forward,
//   flash_fwd_quant_mma_kernel on int8 or e4m3 codes with D % 16 == 0, D <=
//   128, 16-byte-aligned bases and strides in whole 16-byte vectors;
// - "simt": flash_fwd_kernel, flash_fwd_quant_kernel, flash_dq_kernel and
//   flash_dkv_kernel, scalar FMAs, for every other legal input (f32, D 40,
//   D 8, a misaligned view).
// The entry points of the mma route refuse inputs outside the rule; no
// input that the rule admits falls back to the scalar kernels.
//
// The forward on tensor cores. What bounds it: operations, 2 products of
// (pairs x D) and one expf per pair. Two kernels, both with the rounding
// points above and the online softmax of `online_softmax` (s scaled and
// masked in f32, row max and sum over the 4 lanes of a quad, l summed from
// the unrounded p, p rounded to bf16 straight into the A fragments of P.V,
// acc rescaled in f32, no shared-memory round trip for p):
// - flash_fwd_wgmma_kernel (D 64, the main path): one warpgroup per 64 q
//   rows; s = q k^T and acc += p v are wgmma.m64n64k16 (q, k, v from
//   shared memory by descriptor, p from registers: warp by warp, wgmma's
//   m64 accumulator and A layouts are mma.sync's m16n8 and m16n8k16
//   layouts); tiles in the 128-byte-swizzled canonical layout (a 64-element
//   row is 128 bytes), filled by a 2-stage cp.async ring with a
//   fence.proxy.async before the barrier; 100 registers, 4 blocks per SM.
// - flash_fwd_mma_kernel (D 16, 32, 128): the backward pair's building
//   blocks (mma.sync.m16n8k16, ldmatrix / ldmatrix.trans, the padded tiles,
//   the 2-stage ring) on a q tile of 128 rows: 4 warps of 2 m-tiles at D <=
//   32, so each K and V fragment feeds two products, 8 warps of 1 at D 128.
// Both: a 1-D grid ranked by work (the causal triangle's heaviest q tile
// first), the k loop bounded at the diagonal, the mask only on diagonal
// and ragged tiles, no atomics (bitwise-repeatable calls).
// Measured device time at (B, S, H, D) = (16, 2048, 8, 64) causal bf16 on
// an H100 at 700 W (chip_smoke.py phase 15; the mma.sync kernel at D 64 in
// the same call while it was still built for that head dim): wgmma 0.358
// ms, mma.sync 0.404 ms (a 64-row q tile of 4 warps x 1 m-tile: 0.420 ms),
// the scalar kernel 3.39 ms; at (16, 2048, 4, 128) the mma.sync kernel
// 0.349-0.367 ms (64 rows: 0.412 ms). What holds mma.sync back here: at about 17 clocks
// per m16n8k16 per SM sub-partition (the dq and dkv kernels' times fit the
// same rate) the products alone take about 0.3 ms, and the expf chain (8
// instructions a pair) overlaps them only partly; wgmma's products run
// asynchronously at the warpgroup's rate. Tried and not kept (no gain in
// probe runs): a 3-stage ring with one barrier a tile, q's fragments read
// from shared memory each k step, s * scale - m as one FFMA.
//
// The quantized forward on tensor cores (flash_fwd_quant_mma_kernel). What
// bounds it: operations, the same 2 products of (pairs x D) as the bf16
// forward but at the 8-bit rate (1,979 TOP/s): 0.035 ms at the flagship
// shape. Per pair it does more elementwise work than the bf16 forward
// (fold sv, |p_f| max, a true division, a rounding, a byte pack), so its
// exp-and-requantize chain, not its products, is the longer one. Both
// products are mma.sync.m16n8k32 on 8-bit codes (.s32.s8.s8.s32 for int8,
// .f32.e4m3.e4m3.f32 for fp8) on a 64-row q tile of 4 warps, with the
// forward's other parts: the 2-stage cp.async ring (codes, and K's and V's
// 64 column scales), the work-ranked 1-D grid, the mask only on diagonal
// and ragged tiles, the quad reductions of online_softmax, no atomics (a
// rerun gives the same bits). The traps, and what the design does:
// - V is the reduction-major operand of P.V and ldmatrix.trans moves 16-bit
//   elements only: V stays [key][d] in shared memory, ldmatrix.x4.trans
//   reads 32 keys x 16 bytes, and a byte permute (prmt) of its registers
//   makes the two n-tiles of even and odd byte columns (no transposed copy
//   of V in memory, no extra pass);
// - p's accumulator layout gives a thread 2 adjacent columns per n8 tile,
//   the k32 A fragment wants 4 adjacent k: the kernel keeps p where it is
//   and permutes k instead, the same way for V's keys (quant_tile's note);
//   a permutation of the summed index leaves an int8 sum exact;
// - rounding as the function: p_f / sp is a true division (a reciprocal
//   multiply moves codes near .5), int8 codes are rintf (half to even),
//   e4m3 codes satfinite round to nearest even as round_fp8, and sp is the
//   max over the tile's 64 columns across the quad;
// - fp8 accumulation: Hopper's fp8 tensor-core sums keep fewer bits than
//   f32, so each k32 product runs into a zeroed fragment and is added into
//   the f32 accumulator on the CUDA cores (mma8_add);
// - int8 dots are exact in int32 on both routes, so s, the row max, p and
//   the codes match the scalar kernel bit for bit; o and lse differ only
//   through l's summation order (the quad's per-lane sums here, a 16-lane
//   butterfly there) and the rounding of acc * alpha + pv * sp.
//
// The backward pair on tensor cores. What bounds it: operations. dq does 3
// products of (pairs x D) (s = q k^T, dp = do v^T, dq = ds k) and dkv 4
// (s^T, dp^T, dv = p^T do, dk = ds^T q): at the flagship shape 103 and 137
// GFLOP for 170 and 203 MB, 0.104 and 0.139 ms at 989 TFLOP/s. Recomputing s
// and dp in both kernels costs 7 products where a fused backward with
// atomics does 5; the price buys bitwise-repeatable gradients (each block
// owns its output tile and there are no atomics). The design:
// - mma.sync.m16n8k16 (bf16 in, f32 accumulate) for all seven products;
//   operands come from shared memory by ldmatrix.x4, with .trans for the
//   operands read transposed (K in dq += ds k, dO in dv += p^T dO, Q in
//   dk += ds^T q);
// - p and ds never leave registers: the m16n8 accumulator layout of s / dp
//   is the m16n8k16 A-operand layout, so ds (dq) and p^T, ds^T (dkv) are
//   rounded to bf16 and packed straight into the A fragments of the next
//   product; lse and delta are per row in registers (dq) or per column in
//   shared memory (dkv);
// - tiles stay bf16 in shared memory with a row pad of 8 elements (16 B),
//   which makes every ldmatrix free of bank conflicts; the resident tile
//   (Q and dO in dq, K and V in dkv) is loaded once, the streamed tiles (K
//   and V; Q, dO, lse and delta) go through a 2-stage ring of 16-byte
//   cp.async.cg copies (4-byte ones for lse and delta), zero-filled past S
//   and past D, the next tile's copy issued before the current tile's
//   products: 55 KB (dq) and 56 KB (dkv) a block at D 64, 104 / 105 KB at
//   D 128; with the register caps of MmaTile, 4 blocks of dq and 3 of dkv
//   (4 warps each) fit on an SM at D 64, 2 of each at D 128;
// - 4 warps own 16 rows each of the block's 64-row output tile; a warp
//   takes the other axis in chunks of NC columns (64, or 32 at D 128, so
//   that s, dp and the accumulators stay in registers);
// - causal schedule: the grid is 1-D, blocks ordered by their tile's work,
//   heaviest first (dq: the last q tile, which meets every k tile; dkv: k
//   tile 0), every (batch, head) of one rank together, so the short
//   diagonal blocks fill the tail of the grid; the mask is evaluated only on the diagonal tile and
//   on tiles that run past S, every other tile takes the unmasked path.
//
// Design of the scalar kernels (the simt route's forward and backward, and
// the quantized forward; the first version, no tensor cores):
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
// Left for later PRs: wgmma for the backward pair, the quantized forward
// and the forward's other head dims, TMA loads.
//
// Each entry point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
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

// ------------------------------------------- backward pair on tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of the 64-row output tile each
constexpr int kPad = 8;           // bf16 elements of row padding in shared memory

// the mma route's legality rule (ops/flash_attention.py `bwd_route`)
constexpr int kMmaDimStep = 16;

// bf16 shared-memory tile of 64 rows x DP head dims, row stride DP + kPad
template <int DP>
struct MmaTile {
  static constexpr int LD = DP + kPad;
  static constexpr int kElems = 64 * LD;
  static constexpr int NC = DP <= 64 ? 64 : 32;  // columns of the other axis per chunk
  // blocks per SM asked of the register allocator: at D <= 64, 4 blocks of
  // dq (128 registers) and 3 of dkv (168) instead of the 3 and 2 that the
  // uncapped 168 and 190 registers allow at D 64, for more warps to hide
  // ldmatrix and expf latency, at the price of a few bytes of spills in
  // some instances (chip_smoke.py phase 2 prints them); at D 128 a cap
  // spills hundreds of bytes, so none is asked
  static constexpr int kMinBlocksDq = DP <= 64 ? 4 : 1;
  static constexpr int kMinBlocksDkv = DP <= 64 ? 3 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, asynchronously; zero-filled
// when !live (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); .trans delivers each one transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment coordinates of lane l (g = l / 4, t = l % 4). m16n8 accumulator
// element e of n-tile j sits at row g + 8 * (e / 2), column 8 j + 2 t + e % 2;
// the m16n8k16 A operand's registers 0..3 hold (row g, k 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8), pairs of columns each: the accumulators of
// n-tiles 2kk and 2kk + 1, packed, are the A operand of k step kk.
//
// ldmatrix row offsets: an A operand (16 x 16 at (r, c) of a row-major
// tile) and a B operand read transposed (k rows, n columns) take lane l's
// address at (r + a_row, c + a_col); a B operand stored n-major (n rows,
// contiguous k) at (n + b_row, k + b_col). x4 gives B for two n-tiles:
// registers 0, 1 the first, 2, 3 the second.
struct Lane {
  int warp, g, t, a_row, a_col, b_row, b_col;
  __device__ __forceinline__ Lane() {
    const int l = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    g = l >> 2;
    t = l & 3;
    a_row = (l & 7) + ((l >> 3) & 1) * 8;
    a_col = (l >> 4) * 8;
    b_row = (l & 7) + (l >> 4) * 8;
    b_col = ((l >> 3) & 1) * 8;
  }
};

// rows [row0, row0 + ROWS) of head (b, h) into a bf16 tile by THREADS
// threads, zero past S and D (D % 8 == 0 on this route, so a 16-byte chunk
// is all in or all out)
template <int DP, int ROWS = 64, int THREADS = kMmaThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const View& v, int b, int h, int row0,
                                                int S, int D) {
  constexpr int kChunks = DP / 8, kTotal = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + THREADS - 1) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (kTotal % THREADS != 0 && idx >= kTotal) break;
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool live = row0 + r < S && c * 8 < D;
    const bf16* src = live ? at<const bf16>(v, b, row0 + r, h) + c * 8 : static_cast<const bf16*>(v.p);
    cp_async16(dst + r * MmaTile<DP>::LD + c * 8, src, live);
  }
}

// rows [q0, q0 + 64) of lse and delta (B, H, S) into shared memory, zero past S
__device__ __forceinline__ void load_rows_async(float* s_lse, float* s_dlt, const Args& a, int bh,
                                                int q0) {
  const int r = threadIdx.x & 63;
  const bool live = q0 + r < a.S;
  const long long i = static_cast<long long>(bh) * a.S + q0 + r;
  if (threadIdx.x < 64) {
    cp_async4(s_lse + r, live ? a.lse + i : a.lse, live);
  } else {
    cp_async4(s_dlt + r, live ? a.delta + i : a.delta, live);
  }
}

// the accumulators (16 x DP per warp) of rows row0 + g, row0 + g + 8 to out
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4], const View& out, int b,
                                           int h, int row0, const Lane& ln, int S, int D) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ln.g + 8 * i;
    if (row >= S) continue;
    bf16* o = at<bf16>(out, b, row, h);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * ln.t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(o + d) =
            __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// One k tile of dq for one warp: s = q k^T and dp = do v^T over the warp's
// 16 q rows, p = exp(s * scale - lse), ds = p (dp - delta) scale rounded to
// bf16 in registers, dq += ds k. kMask: the diagonal tile or a tile past S.
template <int DP, bool kMask>
__device__ __forceinline__ void dq_tile(float (&dq)[DP / 8][4], const bf16* sQ, const bf16* sDO,
                                        const bf16* sK, const bf16* sV, const float (&lse)[2],
                                        const float (&dlt)[2], int q0, int k0, const Args& a,
                                        const Lane& ln) {
  constexpr int LD = MmaTile<DP>::LD, NC = MmaTile<DP>::NC;
  const int r0 = ln.warp * 16;
#pragma unroll
  for (int c0 = 0; c0 < kBK; c0 += NC) {
    float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, sQ + (r0 + ln.a_row) * LD + kk + ln.a_col);
      ldsm_x4(da, sDO + (r0 + ln.a_row) * LD + kk + ln.a_col);
#pragma unroll
      for (int j = 0; j < NC / 16; ++j) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, sK + (c0 + 16 * j + ln.b_row) * LD + kk + ln.b_col);
        ldsm_x4(vb, sV + (c0 + 16 * j + ln.b_row) * LD + kk + ln.b_col);
        mma_bf16(s[2 * j], qa, kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * j], da, vb[0], vb[1]);
        mma_bf16(dp[2 * j + 1], da, vb[2], vb[3]);
      }
    }
    uint32_t dsa[NC / 16][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = 0.f;
        if (!kMask || (q0 + r0 + ln.g + 8 * i < a.S &&
                       !masked(q0 + r0 + ln.g + 8 * i, k0 + c0 + 8 * j + 2 * ln.t + (e & 1), a.S,
                               a.causal)))
          p = expf(s[j][e] * a.scale - lse[i]);
        ds[e] = p * (dp[j][e] - dlt[i]) * a.scale;
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
#pragma unroll
      for (int jd = 0; jd < DP / 16; ++jd) {
        uint32_t kb[4];
        ldsm_x4_t(kb, sK + (c0 + 16 * kk + ln.a_row) * LD + 16 * jd + ln.a_col);
        mma_bf16(dq[2 * jd], dsa[kk], kb[0], kb[1]);
        mma_bf16(dq[2 * jd + 1], dsa[kk], kb[2], kb[3]);
      }
  }
}

// 1-D grid of (q tiles) x (B*H) blocks, ranked by work: the blocks of q
// tile n_qt - 1 first
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaTile<DP>::kMinBlocksDq)
    flash_dq_mma_kernel(Args a) {
  constexpr int TILE = MmaTile<DP>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + TILE;
  bf16* sK = sDO + TILE;  // 2 stages
  bf16* sV = sK + 2 * TILE;  // 2 stages
  const Lane ln;
  const int n_bh = a.B * a.H, rank = static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) - rank * n_bh, b = bh / a.H, h = bh - b * a.H;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - rank, q0 = qt * kBQ;
  const int n_kt = a.causal ? qt + 1 : (a.S + kBK - 1) / kBK;

  load_tile_async<DP>(sQ, a.q, b, h, q0, a.S, a.D);
  load_tile_async<DP>(sDO, a.d_o, b, h, q0, a.S, a.D);
  cp_async_commit();
  load_tile_async<DP>(sK, a.k, b, h, 0, a.S, a.D);
  load_tile_async<DP>(sV, a.v, b, h, 0, a.S, a.D);
  cp_async_commit();
  float lse[2], dlt[2], dq[DP / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ln.warp * 16 + ln.g + 8 * i;
    const long long r = static_cast<long long>(bh) * a.S + row;
    lse[i] = row < a.S ? a.lse[r] : 0.f;
    dlt[i] = row < a.S ? a.delta[r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {
      const int nxt = ((kt + 1) & 1) * TILE;
      load_tile_async<DP>(sK + nxt, a.k, b, h, k0 + kBK, a.S, a.D);
      load_tile_async<DP>(sV + nxt, a.v, b, h, k0 + kBK, a.S, a.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cur = (kt & 1) * TILE;
    const bool edge = (a.causal && k0 + kBK > q0) || k0 + kBK > a.S || q0 + kBQ > a.S;
    if (edge) {
      dq_tile<DP, true>(dq, sQ, sDO, sK + cur, sV + cur, lse, dlt, q0, k0, a, ln);
    } else {
      dq_tile<DP, false>(dq, sQ, sDO, sK + cur, sV + cur, lse, dlt, q0, k0, a, ln);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  store_rows<DP>(dq, a.dq, b, h, q0 + ln.warp * 16, ln, a.S, a.D);
}

// One q tile of dk, dv for one warp: s^T = k q^T and dp^T = v do^T over the
// warp's 16 k rows, p^T = exp(s^T * scale - lse[col]) and ds^T = p^T (dp^T -
// delta[col]) scale, both rounded to bf16 in registers, dv += p^T do and
// dk += ds^T q. kMask: the diagonal tile or a tile past S.
template <int DP, bool kMask>
__device__ __forceinline__ void dkv_tile(float (&dk)[DP / 8][4], float (&dv)[DP / 8][4],
                                         const bf16* sK, const bf16* sV, const bf16* sQ,
                                         const bf16* sDO, const float* sLse, const float* sDlt,
                                         int q0, int k0, const Args& a, const Lane& ln) {
  constexpr int LD = MmaTile<DP>::LD, NC = MmaTile<DP>::NC;
  const int r0 = ln.warp * 16;
#pragma unroll
  for (int c0 = 0; c0 < kBQ; c0 += NC) {
    float st[NC / 8][4], dpt[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, sK + (r0 + ln.a_row) * LD + kk + ln.a_col);
      ldsm_x4(va, sV + (r0 + ln.a_row) * LD + kk + ln.a_col);
#pragma unroll
      for (int j = 0; j < NC / 16; ++j) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, sQ + (c0 + 16 * j + ln.b_row) * LD + kk + ln.b_col);
        ldsm_x4(ob, sDO + (c0 + 16 * j + ln.b_row) * LD + kk + ln.b_col);
        mma_bf16(st[2 * j], ka, qb[0], qb[1]);
        mma_bf16(st[2 * j + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[2 * j], va, ob[0], ob[1]);
        mma_bf16(dpt[2 * j + 1], va, ob[2], ob[3]);
      }
    }
    uint32_t pa[NC / 16][4], dsa[NC / 16][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + 2 * ln.t + (e & 1);  // q column within the tile
        p[e] = 0.f;
        if (!kMask || (q0 + c < a.S &&
                       !masked(q0 + c, k0 + r0 + ln.g + 8 * (e >> 1), a.S, a.causal)))
          p[e] = expf(st[j][e] * a.scale - sLse[c]);
        ds[e] = p[e] * (dpt[j][e] - sDlt[c]) * a.scale;
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
#pragma unroll
      for (int jd = 0; jd < DP / 16; ++jd) {
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, sDO + (c0 + 16 * kk + ln.a_row) * LD + 16 * jd + ln.a_col);
        ldsm_x4_t(qb, sQ + (c0 + 16 * kk + ln.a_row) * LD + 16 * jd + ln.a_col);
        mma_bf16(dv[2 * jd], pa[kk], ob[0], ob[1]);
        mma_bf16(dv[2 * jd + 1], pa[kk], ob[2], ob[3]);
        mma_bf16(dk[2 * jd], dsa[kk], qb[0], qb[1]);
        mma_bf16(dk[2 * jd + 1], dsa[kk], qb[2], qb[3]);
      }
  }
}

// 1-D grid of (k tiles) x (B*H) blocks, ranked by work: the blocks of k
// tile 0 first
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaTile<DP>::kMinBlocksDkv)
    flash_dkv_mma_kernel(Args a) {
  constexpr int TILE = MmaTile<DP>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;  // 2 stages
  bf16* sDO = sQ + 2 * TILE;  // 2 stages
  float* sLse = reinterpret_cast<float*>(sDO + 2 * TILE);  // 2 stages of 64
  float* sDlt = sLse + 2 * kBQ;  // 2 stages of 64
  const Lane ln;
  const int n_bh = a.B * a.H, rank = static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) - rank * n_bh, b = bh / a.H, h = bh - b * a.H;
  const int k0 = rank * kBK;
  const int n_qt = (a.S + kBQ - 1) / kBQ, qt0 = a.causal ? k0 / kBQ : 0;

  load_tile_async<DP>(sK, a.k, b, h, k0, a.S, a.D);
  load_tile_async<DP>(sV, a.v, b, h, k0, a.S, a.D);
  cp_async_commit();
  load_tile_async<DP>(sQ, a.q, b, h, qt0 * kBQ, a.S, a.D);
  load_tile_async<DP>(sDO, a.d_o, b, h, qt0 * kBQ, a.S, a.D);
  load_rows_async(sLse, sDlt, a, bh, qt0 * kBQ);
  cp_async_commit();
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ, it = qt - qt0;
    if (qt + 1 < n_qt) {
      const int nxt = (it + 1) & 1;
      load_tile_async<DP>(sQ + nxt * TILE, a.q, b, h, q0 + kBQ, a.S, a.D);
      load_tile_async<DP>(sDO + nxt * TILE, a.d_o, b, h, q0 + kBQ, a.S, a.D);
      load_rows_async(sLse + nxt * kBQ, sDlt + nxt * kBQ, a, bh, q0 + kBQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cur = it & 1;
    const bool edge = (a.causal && q0 < k0 + kBK) || q0 + kBQ > a.S || k0 + kBK > a.S;
    if (edge) {
      dkv_tile<DP, true>(dk, dv, sK, sV, sQ + cur * TILE, sDO + cur * TILE, sLse + cur * kBQ,
                         sDlt + cur * kBQ, q0, k0, a, ln);
    } else {
      dkv_tile<DP, false>(dk, dv, sK, sV, sQ + cur * TILE, sDO + cur * TILE, sLse + cur * kBQ,
                          sDlt + cur * kBQ, q0, k0, a, ln);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  store_rows<DP>(dk, a.dk, b, h, k0 + ln.warp * 16, ln, a.S, a.D);
  store_rows<DP>(dv, a.dv, b, h, k0 + ln.warp * 16, ln, a.S, a.D);
}

// ------------------------------------------------ forward on tensor cores

// The mma.sync forward's q tile: 128 rows, 4 warps of 2 m-tiles (16 rows
// each) at D <= 32, so that each K and V fragment read by ldmatrix feeds two
// products, and 8 warps of 1 at D 128, where two m-tiles' accumulators do
// not fit in registers. kMinBlocks: blocks per SM asked of the register
// allocator.
constexpr int kFwdRows = 128;
template <int DP>
struct FwdMma {
  static constexpr int kWarps = DP <= 32 ? 4 : 8;
  static constexpr int kMt = kFwdRows / (16 * kWarps), kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = DP <= 32 ? 2 : 1;
};

// The online softmax of one m-tile (16 rows of a warp) over one k tile, in
// registers: s (the m16n8 accumulators of s = q k^T) scaled and, kMask,
// masked; the row max and sum reduce over the 4 lanes of a quad, so every
// lane of a row holds the same bits; p = exp(s - m) is summed unrounded
// into l and rounded to bf16 straight into pa, the m16n8k16 A fragments of
// acc += p v; acc is rescaled by exp(m_old - m). r0: the m-tile's first row.
template <int DP, bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[kBK / 8][4], float (&m)[2], float (&l)[2],
                                               float (&acc)[DP / 8][4], uint32_t (&pa)[kBK / 16][4],
                                               int r0, int k0, const Args& a, const Lane& ln) {
  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = kMask && masked(r0 + ln.g + 8 * i, k0 + 8 * j + 2 * ln.t + (e & 1), a.S, a.causal)
                    ? kNegBig
                    : s[j][e] * a.scale;
      mx[i] = fmaxf(mx[i], s[j][e]);
    }
  float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = expf(s[j][e] - m[e >> 1]);
      ps[e >> 1] += p[e];
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
    ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
    l[i] = l[i] * alpha[i] + ps[i];
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
}

// One k tile of the forward for one warp's MT m-tiles: s = q k^T (q's A
// fragments held in registers; each K fragment feeds every m-tile), the
// online softmax, acc += p v (each V fragment feeds every m-tile). kMask:
// the diagonal tile or a tile past S; r0: the warp's first row.
template <int DP, int MT, bool kMask>
__device__ __forceinline__ void fwd_tile(float (&acc)[MT][DP / 8][4], float (&m)[MT][2],
                                         float (&l)[MT][2], const uint32_t (&qa)[MT][DP / 16][4],
                                         const bf16* sK, const bf16* sV, int r0, int k0,
                                         const Args& a, const Lane& ln) {
  constexpr int LD = MmaTile<DP>::LD;
  float s[MT][kBK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t kb[4];
      ldsm_x4(kb, sK + (16 * j + ln.b_row) * LD + 16 * kk + ln.b_col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * j], qa[mt][kk], kb[0], kb[1]);
        mma_bf16(s[mt][2 * j + 1], qa[mt][kk], kb[2], kb[3]);
      }
    }
  uint32_t pa[MT][kBK / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    online_softmax<DP, kMask>(s[mt], m[mt], l[mt], acc[mt], pa[mt], r0 + 16 * mt, k0, a, ln);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int jd = 0; jd < DP / 16; ++jd) {
      uint32_t vb[4];
      ldsm_x4_t(vb, sV + (16 * kk + ln.a_row) * LD + 16 * jd + ln.a_col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * jd], pa[mt][kk], vb[0], vb[1]);
        mma_bf16(acc[mt][2 * jd + 1], pa[mt][kk], vb[2], vb[3]);
      }
    }
}

// o = acc / l in bf16 and lse = m + log(l) for one m-tile's rows (r0 + g,
// r0 + g + 8), l clamped to 1e-30
template <int DP>
__device__ __forceinline__ void fwd_store(const float (&acc)[DP / 8][4], const float (&m)[2],
                                          const float (&l)[2], const Args& a, int b, int h, int bh,
                                          int r0, const Lane& ln) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ln.g + 8 * i;
    if (row >= a.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    bf16* o = at<bf16>(a.o, b, row, h);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * ln.t;
      if (d < a.D)
        *reinterpret_cast<__nv_bfloat162*>(o + d) =
            __floats2bfloat162_rn(acc[j][2 * i] / lc, acc[j][2 * i + 1] / lc);
    }
    if (ln.t == 0) a.lse[static_cast<long long>(bh) * a.S + row] = m[i] + logf(lc);
  }
}

// 1-D grid of (q tiles) x (B*H) blocks, ranked by work: the blocks of q
// tile n_qt - 1 (which meets every k tile of a causal call) first. A warp
// skips the k tiles in which all its rows are masked (an exact no-op: p =
// 0, alpha = 1) and the whole loop when its rows lie past S.
template <int DP>
__global__ void __launch_bounds__(FwdMma<DP>::kThreads, FwdMma<DP>::kMinBlocks)
    flash_fwd_mma_kernel(Args a) {
  constexpr int LD = MmaTile<DP>::LD, TILE = MmaTile<DP>::kElems, ROWS = kFwdRows;
  constexpr int MT = FwdMma<DP>::kMt, THREADS = FwdMma<DP>::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + ROWS * LD;  // 2 stages
  bf16* sV = sK + 2 * TILE;   // 2 stages
  const Lane ln;
  const int n_bh = a.B * a.H, rank = static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) - rank * n_bh, b = bh / a.H, h = bh - b * a.H;
  const int n_qt = (a.S + ROWS - 1) / ROWS;
  const int q0 = (n_qt - 1 - rank) * ROWS, r0 = q0 + ln.warp * 16 * MT;
  const int n_kt = a.causal ? (min(q0 + ROWS, a.S) - 1) / kBK + 1 : (a.S + kBK - 1) / kBK;

  load_tile_async<DP, ROWS, THREADS>(sQ, a.q, b, h, q0, a.S, a.D);
  load_tile_async<DP, kBK, THREADS>(sK, a.k, b, h, 0, a.S, a.D);
  load_tile_async<DP, kBK, THREADS>(sV, a.v, b, h, 0, a.S, a.D);
  cp_async_commit();
  uint32_t qa[MT][DP / 16][4];
  float m[MT][2], l[MT][2], acc[MT][DP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegBig;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {
      const int nxt = ((kt + 1) & 1) * TILE;
      load_tile_async<DP, kBK, THREADS>(sK + nxt, a.k, b, h, k0 + kBK, a.S, a.D);
      load_tile_async<DP, kBK, THREADS>(sV + nxt, a.v, b, h, k0 + kBK, a.S, a.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldsm_x4(qa[mt][kk], sQ + (r0 - q0 + 16 * mt + ln.a_row) * LD + 16 * kk + ln.a_col);
    }
    const int cur = (kt & 1) * TILE;
    if (r0 < a.S && (!a.causal || k0 <= r0 + 16 * MT - 1)) {
      if ((a.causal && k0 + kBK - 1 > r0) || k0 + kBK > a.S) {
        fwd_tile<DP, MT, true>(acc, m, l, qa, sK + cur, sV + cur, r0, k0, a, ln);
      } else {
        fwd_tile<DP, MT, false>(acc, m, l, qa, sK + cur, sV + cur, r0, k0, a, ln);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fwd_store<DP>(acc[mt], m[mt], l[mt], a, b, h, bh, r0 + 16 * mt, ln);
}

// ------------------------------------------- forward with wgmma (head dim 64)

// One warpgroup (4 warps) per 64 q rows: both products as wgmma, s = q k^T
// with q and k from shared memory, acc += p v with p from registers (the
// m64 accumulator and A layouts of wgmma are, warp by warp, the m16n8 and
// m16n8k16 layouts of mma.sync, so the online softmax is the same code).
// Tiles sit in shared memory in wgmma's canonical 128-byte-swizzled
// layout: a tile row of 64 bf16 is 128 bytes, 8 rows make a 1024-byte atom,
// and 16-byte chunk c of row r lies at byte 128 r + 16 (c ^ (r % 8)), so
// the 8 rows of any 16-byte column sit in 8 different bank groups. Q and K
// are read k-major (16 columns a product: 32 bytes into the rows), V
// n-major (16 rows a product: two atoms); atoms are 1024 bytes apart.
constexpr int kWgThreads = 128;
constexpr uint32_t kAtomBytes = 1024;

// rows [row0, row0 + 64) of head (b, h) into a swizzled tile (64 x 64),
// zero past S and D
__device__ __forceinline__ void load_tile_sw128(bf16* dst, const View& v, int b, int h, int row0,
                                                int S, int D) {
#pragma unroll
  for (int i = 0; i < 64 * 8 / kWgThreads; ++i) {
    const int idx = threadIdx.x + i * kWgThreads;
    const int r = idx >> 3, c = idx & 7;
    const bool live = row0 + r < S && c * 8 < D;
    const bf16* src = live ? at<const bf16>(v, b, row0 + r, h) + c * 8 : static_cast<const bf16*>(v.p);
    cp_async16(dst + r * 64 + ((c ^ (r & 7)) << 3), src, live);
  }
}

// a shared-memory matrix descriptor of wgmma for a 128-byte-swizzled
// operand at p (inside a 1024-byte-aligned tile): start address, atoms
// `sbo` bytes apart
__device__ __forceinline__ uint64_t wg_desc(const bf16* p, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | uint64_t{1} << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{1} << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// makes the cp.async writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (the warpgroup's 64 x 64 f32, m16n8 accumulators per warp) = (d if
// accumulate) + A B, A (64 x 16) and B (64 x 16, k contiguous) in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
                 "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
                 "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
                 "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
                 "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
                 "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
                 "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
                 "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
               : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16) from registers (each warp's m16n8k16 A fragment),
// B (16 x 64, n contiguous) in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
               : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
                 "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
                 "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
                 "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
                 "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
                 "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
                 "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
                 "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// 1-D grid of (q tiles of 64 rows) x (B*H) blocks ranked by work, as the
// mma.sync kernels; the K/V ring, the mask only on diagonal and ragged tiles
// and the rounding points are theirs
template <int DP>
__global__ void __launch_bounds__(kWgThreads) flash_fwd_wgmma_kernel(Args a) {
  static_assert(DP == 64, "the wgmma forward takes head dim 64 (128-byte rows, m64n64)");
  constexpr int TILE = 64 * DP;  // elements of a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the tiles start on a 1024-byte boundary (the swizzle atom)
  bf16* sQ = reinterpret_cast<bf16*>(
      smem_raw + ((kAtomBytes - smem_u32(smem_raw) % kAtomBytes) % kAtomBytes));
  bf16* sK = sQ + TILE;      // 2 stages
  bf16* sV = sK + 2 * TILE;  // 2 stages
  const Lane ln;
  const int n_bh = a.B * a.H, rank = static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) - rank * n_bh, b = bh / a.H, h = bh - b * a.H;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - rank) * kBQ, r0 = q0 + ln.warp * 16;
  const int n_kt = a.causal ? (min(q0 + kBQ, a.S) - 1) / kBK + 1 : (a.S + kBK - 1) / kBK;

  load_tile_sw128(sQ, a.q, b, h, q0, a.S, a.D);
  load_tile_sw128(sK, a.k, b, h, 0, a.S, a.D);
  load_tile_sw128(sV, a.v, b, h, 0, a.S, a.D);
  cp_async_commit();
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, acc[DP / 8][4], s[kBK / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {
      const int nxt = ((kt + 1) & 1) * TILE;
      load_tile_sw128(sK + nxt, a.k, b, h, k0 + kBK, a.S, a.D);
      load_tile_sw128(sV + nxt, a.v, b, h, k0 + kBK, a.S, a.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const bf16* k = sK + (kt & 1) * TILE;
    const bf16* v = sV + (kt & 1) * TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)  // 16 columns of q and k: 32 bytes into the rows
      wgmma_ss(s, wg_desc(sQ + kk * 16, kAtomBytes), wg_desc(k + kk * 16, kAtomBytes), kk);
    wg_commit_wait();
    uint32_t pa[kBK / 16][4];
    if ((a.causal && k0 + kBK - 1 > q0) || k0 + kBK > a.S) {
      online_softmax<DP, true>(s, m, l, acc, pa, r0, k0, a, ln);
    } else {
      online_softmax<DP, false>(s, m, l, acc, pa, r0, k0, a, ln);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 16 rows of v: 2 atoms
      wgmma_rs(acc, pa[kk], wg_desc(v + kk * 16 * DP, kAtomBytes));
    wg_commit_wait();
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  fwd_store<DP>(acc, m, l, a, b, h, bh, r0, ln);
}

// ----------------------------------- quantized forward on tensor cores (8-bit)

// The 8-bit forward's q tile: 64 rows, 4 warps of one m-tile (16 rows)
// each. Codes sit in shared memory as bytes, a row of DP bytes (the head
// dim padded to 32, 64 or 128) plus 16 bytes of pad, so every ldmatrix
// row address falls in its own 16-byte bank group.
constexpr int kQuantThreads = 128;
constexpr int kQuantPad = 16;

template <int DP>
struct QuantTile {
  static constexpr int LD = DP + kQuantPad;  // bytes a row
  static constexpr int kBytes = 64 * LD;
};

// the 8-bit forward's padded head dim: whole k32 steps (32, 64 or 128 bytes)
int quant_pad_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

// rows [row0, row0 + 64) of 8-bit codes of head (b, h) into a byte tile,
// zero past S and D (D % 16 == 0 on this route, so a 16-byte chunk is all
// in or all out)
template <int DP>
__device__ __forceinline__ void load_codes_async(uint8_t* dst, const View& v, int b, int h,
                                                 int row0, int S, int D) {
  constexpr int kChunks = DP / 16, kTotal = 64 * kChunks;
#pragma unroll
  for (int i = 0; i < kTotal / kQuantThreads; ++i) {
    const int idx = threadIdx.x + i * kQuantThreads;
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool live = row0 + r < S && c * 16 < D;
    const uint8_t* src =
        live ? at<const uint8_t>(v, b, row0 + r, h) + c * 16 : static_cast<const uint8_t*>(v.p);
    cp_async16(dst + r * QuantTile<DP>::LD + c * 16, src, live);
  }
}

// the f32 scales of K and V for columns [k0, k0 + 64), zero past S
__device__ __forceinline__ void load_col_scales_async(float* s_k, float* s_v, const Args& a,
                                                      int b, int h, int k0) {
  const int c = threadIdx.x & 63;
  const bool live = k0 + c < a.S;
  const View& v = threadIdx.x < 64 ? a.sk : a.sv;
  float* dst = (threadIdx.x < 64 ? s_k : s_v) + c;
  cp_async4(dst, live ? at<const float>(v, b, k0 + c, h) : static_cast<const float*>(v.p), live);
}

// c (16 x 8) += a (16 x 32, row) * b (32 x 8, col), 8-bit operands: int8
// into an int32 accumulator (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ... and e4m3 into an f32 accumulator
__device__ __forceinline__ void mma_e4m3(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += one k32 product. int8: chained in the int32 accumulator. e4m3: the
// tensor core's fp8 sums keep fewer bits than f32 (DeepSeek-V3's report on
// Hopper), so each k32 product runs into a zeroed fragment and is added
// into the f32 accumulator on the CUDA cores
template <bool kInt8>
__device__ __forceinline__ void mma8_add(typename std::conditional<kInt8, int, float>::type (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (kInt8) {
    mma_s8(c, a, b0, b1);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_e4m3(t, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
  }
}

// the code of p_f / sp as a byte: int8 rint (half to even, as jnp.round),
// or e4m3 round to nearest even, saturating at 448 (round_fp8's rounding)
template <bool kInt8>
__device__ __forceinline__ uint32_t code_byte(float x) {
  if constexpr (kInt8) {
    return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(rintf(x))));
  } else {
    return static_cast<uint32_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
  }
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return b0 | b1 << 8 | b2 << 16 | b3 << 24;
}

// One k tile (64 columns) of the 8-bit forward for one warp's 16 rows (r0
// .. r0 + 15). Fragments (lane l: g = l / 4, t = l % 4):
// - s = qc kc^T: Q's and K's k32 fragments are byte-for-byte the m16n8k16
//   bf16 ones (4 bytes a register), so ldmatrix reads them as b16 pairs;
// - p's codes go into the A fragments of P.V straight from the m16n8
//   accumulators, no shuffle: the thread holds columns 8j + 2t, 8j + 2t + 1
//   of n-tiles j, so k32 step kk's A register 0 (row g) packs columns {2t,
//   2t+1, 8+2t, 9+2t} of the step and register 2 columns {16+2t, 17+2t,
//   24+2t, 25+2t}: the step's k index is permuted, the same way for V below,
//   which leaves the sum unchanged (exact for int8);
// - V is K-major for P.V (the reduction runs over keys) and ldmatrix.trans
//   moves 16-bit elements only: ldmatrix.x4.trans over 32 keys x 16 bytes
//   gives each thread keys (2t, 2t+1) of each 8-key block at byte columns
//   (2g, 2g+1); a byte permute of blocks (0, 1) and (2, 3) picks byte
//   column 2g (even) or 2g+1 (odd) for the keys {2t, 2t+1, 8+2t, 9+2t} and
//   {16+2t, ...}, the A fragment's order. So each 16-byte column block db
//   gives two n-tiles, even (n -> d = 16 db + 2n) and odd (d = 16 db + 2n +
//   1), and the thread's accumulators of rows g and g + 8 hold d = 16 db +
//   4t .. 16 db + 4t + 3.
// The function's rounding points: s = ((acc * sq) * sk) * scale in f32; p =
// expf(s - m); p_f = p * sv; sp = max(max|p_f| over the 64 columns (the
// quad's lanes), 1e-30) / qmax; codes of p_f / sp (a true division); acc =
// acc * alpha + (codes . vc) * sp. kMask: the diagonal tile or one past S.
template <bool kInt8, int DP, bool kMask>
__device__ __forceinline__ void quant_tile(float (&acc)[DP / 8][4], float (&m)[2], float (&l)[2],
                                           const uint32_t (&qa)[DP / 32][4], const float (&sq)[2],
                                           const uint8_t* sK, const uint8_t* sV, const float* sSk,
                                           const float* sSv, int r0, int k0, const Args& a,
                                           const Lane& ln) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int LD = QuantTile<DP>::LD;
  constexpr float kQmax = kInt8 ? 127.f : 448.f;
  const int lane = threadIdx.x & 31;
  Acc sacc[kBK / 8][4];
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = Acc(0);
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
    for (int kk = 0; kk < DP / 32; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, reinterpret_cast<const bf16*>(sK + (16 * j + ln.b_row) * LD + 32 * kk +
                                                2 * ln.b_col));
      mma8_add<kInt8>(sacc[2 * j], qa[kk], kb[0], kb[1]);
      mma8_add<kInt8>(sacc[2 * j + 1], qa[kk], kb[2], kb[3]);
    }
  float s[kBK / 8][4], mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, c = 8 * j + 2 * ln.t + (e & 1);
      s[j][e] = kMask && masked(r0 + ln.g + 8 * i, k0 + c, a.S, a.causal)
                    ? kNegBig
                    : static_cast<float>(sacc[j][e]) * sq[i] * sSk[c] * a.scale;
      mx[i] = fmaxf(mx[i], s[j][e]);
    }
  float alpha[2], ps[2] = {0.f, 0.f}, amax[2] = {0.f, 0.f}, sp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = expf(s[j][e] - m[i]);
      ps[i] += p;
      s[j][e] = p * sSv[8 * j + 2 * ln.t + (e & 1)];  // p_f, in place
      amax[i] = fmaxf(amax[i], fabsf(s[j][e]));
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
    ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
    l[i] = l[i] * alpha[i] + ps[i];
    sp[i] = fmaxf(amax[i], 1e-30f) / kQmax;
  }
  uint32_t pa[kBK / 32][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // registers 0, 1 (half 0) and 2, 3 (half 1)
      const int j = 4 * kk + 2 * half;
      uint32_t cb[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[jj][e] = code_byte<kInt8>(s[j + jj][e] / sp[e >> 1]);
      pa[kk][2 * half] = pack4(cb[0][0], cb[0][1], cb[1][0], cb[1][1]);      // row g
      pa[kk][2 * half + 1] = pack4(cb[0][2], cb[0][3], cb[1][2], cb[1][3]);  // row g + 8
    }
  Acc pv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[j][e] = Acc(0);
#pragma unroll
  for (int db = 0; db < DP / 16; ++db)
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t r[4];
      ldsm_x4_t(r, reinterpret_cast<const bf16*>(sV + (32 * kk + lane) * LD + 16 * db));
      mma8_add<kInt8>(pv[2 * db], pa[kk], __byte_perm(r[0], r[1], 0x6420),
                      __byte_perm(r[2], r[3], 0x6420));
      mma8_add<kInt8>(pv[2 * db + 1], pa[kk], __byte_perm(r[0], r[1], 0x7531),
                      __byte_perm(r[2], r[3], 0x7531));
    }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = acc[j][e] * alpha[e >> 1] + static_cast<float>(pv[j][e]) * sp[e >> 1];
}

// 1-D grid of (q tiles of 64 rows) x (B*H) blocks ranked by work (the last
// q tile first), a 2-stage cp.async ring of K, V and their column scales,
// a warp skipping the k tiles in which all its rows are masked (an exact
// no-op: p = 0, alpha = 1, codes 0) and the whole loop past S, the mask
// only on diagonal and ragged tiles, no atomics. TO: o's dtype; kInt8:
// int8 codes, else e4m3.
template <typename TO, bool kInt8, int DP>
__global__ void __launch_bounds__(kQuantThreads) flash_fwd_quant_mma_kernel(Args a) {
  constexpr int LD = QuantTile<DP>::LD, TILE = QuantTile<DP>::kBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sQ = smem_raw;
  uint8_t* sK = sQ + TILE;      // 2 stages
  uint8_t* sV = sK + 2 * TILE;  // 2 stages
  float* sSk = reinterpret_cast<float*>(sV + 2 * TILE);  // 2 stages of 64
  float* sSv = sSk + 2 * kBK;                             // 2 stages of 64
  const Lane ln;
  const int n_bh = a.B * a.H, rank = static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) - rank * n_bh, b = bh / a.H, h = bh - b * a.H;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - rank, q0 = qt * kBQ, r0 = q0 + ln.warp * 16;
  const int n_kt = a.causal ? qt + 1 : (a.S + kBK - 1) / kBK;

  load_codes_async<DP>(sQ, a.q, b, h, q0, a.S, a.D);
  load_codes_async<DP>(sK, a.k, b, h, 0, a.S, a.D);
  load_codes_async<DP>(sV, a.v, b, h, 0, a.S, a.D);
  load_col_scales_async(sSk, sSv, a, b, h, 0);
  cp_async_commit();
  float sq[2], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ln.g + 8 * i;
    sq[i] = row < a.S ? *at<const float>(a.sq, b, row, h) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qa[DP / 32][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {
      const int nxt = (kt + 1) & 1;
      load_codes_async<DP>(sK + nxt * TILE, a.k, b, h, k0 + kBK, a.S, a.D);
      load_codes_async<DP>(sV + nxt * TILE, a.v, b, h, k0 + kBK, a.S, a.D);
      load_col_scales_async(sSk + nxt * kBK, sSv + nxt * kBK, a, b, h, k0 + kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 32; ++kk)
        ldsm_x4(qa[kk], reinterpret_cast<const bf16*>(sQ + (ln.warp * 16 + ln.a_row) * LD +
                                                      32 * kk + 2 * ln.a_col));
    }
    const int cur = kt & 1;
    if (r0 < a.S && (!a.causal || k0 <= r0 + 15)) {
      const uint8_t* k = sK + cur * TILE;
      const uint8_t* v = sV + cur * TILE;
      if ((a.causal && k0 + kBK - 1 > r0) || k0 + kBK > a.S) {
        quant_tile<kInt8, DP, true>(acc, m, l, qa, sq, k, v, sSk + cur * kBK, sSv + cur * kBK, r0,
                                    k0, a, ln);
      } else {
        quant_tile<kInt8, DP, false>(acc, m, l, qa, sq, k, v, sSk + cur * kBK, sSv + cur * kBK,
                                     r0, k0, a, ln);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ln.g + 8 * i;
    if (row >= a.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    TO* o = at<TO>(a.o, b, row, h);
#pragma unroll
    for (int db = 0; db < DP / 16; ++db) {
      const int d = 16 * db + 4 * ln.t;  // the thread's 4 columns: even, odd, even, odd n-tile
      if (d < a.D) {
        o[d] = from_f<TO>(acc[2 * db][2 * i] / lc);
        o[d + 1] = from_f<TO>(acc[2 * db + 1][2 * i] / lc);
        o[d + 2] = from_f<TO>(acc[2 * db][2 * i + 1] / lc);
        o[d + 3] = from_f<TO>(acc[2 * db + 1][2 * i + 1] / lc);
      }
    }
    if (ln.t == 0) a.lse[static_cast<long long>(bh) * a.S + row] = m[i] + logf(lc);
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

// dynamic shared memory of the mma kernels: the forward's q tile of `rows`
// rows and 2 stages of K and V; dq and dkv 6 bf16 tiles (2 resident, 2
// streamed x 2 stages), and for dkv 2 stages of lse and delta
size_t mma_smem_bytes(Kind kind, int dp, int rows) {
  const size_t row = static_cast<size_t>(dp + kPad) * sizeof(bf16), tile = 64 * row;
  if (kind == kFwd) return rows * row + 4 * tile;
  return kind == kDq ? 6 * tile : 6 * tile + 4 * kBQ * sizeof(float);
}

// raises the instance's dynamic shared-memory cap once (outside any CUDA
// graph capture) and asks for the largest shared-memory carveout
template <void (*Kernel)(Args)>
cudaError_t prepare_mma(Kind kind, int dp, int rows) {
  static bool raised = false;
  if (raised) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(mma_smem_bytes(kind, dp, rows)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  raised = e == cudaSuccess;
  return e;
}

// one block of `threads` per (output tile of `rows` rows, b*h) on a 1-D grid
template <void (*Kernel)(Args)>
cudaError_t launch_mma(Kind kind, int dp, int rows, int threads, const Args& a,
                       cudaStream_t stream) {
  const cudaError_t e = prepare_mma<Kernel>(kind, dp, rows);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>((a.S + rows - 1) / rows) * (a.B * a.H);
  Kernel<<<grid, threads, mma_smem_bytes(kind, dp, rows), stream>>>(a);
  return cudaGetLastError();
}

// the wgmma forward (head dim 64): Q and 2 stages of K and V, 64-row tiles
// of 8 KB, and room to start them on a 1024-byte boundary
constexpr size_t kWgSmem = 5 * 64 * 64 * sizeof(bf16) + kAtomBytes;

cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((a.S + kBQ - 1) / kBQ) * (a.B * a.H);
  flash_fwd_wgmma_kernel<64><<<grid, kWgThreads, kWgSmem, stream>>>(a);
  return cudaGetLastError();
}

// blocks of an mma instance that fit on one SM
template <void (*Kernel)(Args)>
cudaError_t occupancy_mma(Kind kind, int dp, int rows, int threads, int* blocks) {
  const cudaError_t e = prepare_mma<Kernel>(kind, dp, rows);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, Kernel, threads,
                                                       mma_smem_bytes(kind, dp, rows));
}

#define FLASH_MMA_DISPATCH(FN, KERNEL, KIND, ...)                     \
  switch (pad_dim(D)) {                                               \
    case 16: return FN<KERNEL<16>>(KIND, 16, kBQ, kMmaThreads, __VA_ARGS__);   \
    case 32: return FN<KERNEL<32>>(KIND, 32, kBQ, kMmaThreads, __VA_ARGS__);   \
    case 64: return FN<KERNEL<64>>(KIND, 64, kBQ, kMmaThreads, __VA_ARGS__);   \
    default: return FN<KERNEL<128>>(KIND, 128, kBQ, kMmaThreads, __VA_ARGS__); \
  }

// the mma.sync forward's instance for head dim D (padded head dims 16, 32
// and 128; 64 takes the wgmma kernel)
#define FLASH_FWD_MMA_CASE(FN, DP, ...) \
  FN<flash_fwd_mma_kernel<DP>>(kFwd, DP, kFwdRows, FwdMma<DP>::kThreads, __VA_ARGS__)
#define FLASH_FWD_MMA_DISPATCH(FN, ...)                                \
  switch (pad_dim(D)) {                                                \
    case 16: return FLASH_FWD_MMA_CASE(FN, 16, __VA_ARGS__);           \
    case 32: return FLASH_FWD_MMA_CASE(FN, 32, __VA_ARGS__);           \
    default: return FLASH_FWD_MMA_CASE(FN, 128, __VA_ARGS__);          \
  }

// the forward's kernel on the mma route: wgmma where the head dim pads to
// 64 (rows of 128 bytes, the 128-byte swizzle's width), mma.sync elsewhere
bool fwd_wgmma(int D) { return pad_dim(D) == 64; }

// the mma route's rule on one operand: 16-byte-aligned base, strides in
// multiples of 8 elements (so every 16-byte chunk of a row is aligned)
bool mma_view_ok(const View& v) {
  return reinterpret_cast<uintptr_t>(v.p) % 16 == 0 && v.sb % 8 == 0 && v.ss % 8 == 0 &&
         v.sh % 8 == 0;
}

// the mma route's rule (ops/flash_attention.py `_mma_rule`): bf16, D % 16
// == 0, D <= 128, and every operand, inputs and outputs, meets mma_view_ok
bool mma_ok(int dtype, int D, std::initializer_list<View> views) {
  if (dtype != 1 || D % kMmaDimStep != 0 || D > kMaxHeadDim) return false;
  for (const View& v : views)
    if (!mma_view_ok(v)) return false;
  return true;
}


// the 8-bit forward's dynamic shared memory: Q, 2 stages of K and V, and 2
// stages of K's and V's 64 column scales
size_t quant_smem_bytes(int dp) {
  return 5 * 64 * static_cast<size_t>(dp + kQuantPad) + 4 * kBK * sizeof(float);
}

// raises an instance's dynamic shared-memory cap once (outside any CUDA
// graph capture)
template <void (*Kernel)(Args)>
cudaError_t prepare_quant(int dp) {
  static bool raised = false;
  if (raised) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(quant_smem_bytes(dp)));
  raised = e == cudaSuccess;
  return e;
}

template <void (*Kernel)(Args)>
cudaError_t launch_quant_mma(int dp, const Args& a, cudaStream_t stream) {
  const cudaError_t e = prepare_quant<Kernel>(dp);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>((a.S + kBQ - 1) / kBQ) * (a.B * a.H);
  Kernel<<<grid, kQuantThreads, quant_smem_bytes(dp), stream>>>(a);
  return cudaGetLastError();
}

template <void (*Kernel)(Args)>
cudaError_t occupancy_quant_mma(int dp, int* blocks) {
  const cudaError_t e = prepare_quant<Kernel>(dp);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, Kernel, kQuantThreads,
                                                       quant_smem_bytes(dp));
}

// the 8-bit forward's instance for (o's dtype, int8 or e4m3, padded head
// dim), handed to FN<kernel>(dp, ...)
#define FLASH_QUANT_MMA_CASES(FN, TO, INT8, ...)                                     \
  switch (quant_pad_dim(D)) {                                                        \
    case 32: return FN<flash_fwd_quant_mma_kernel<TO, INT8, 32>>(32, __VA_ARGS__);   \
    case 64: return FN<flash_fwd_quant_mma_kernel<TO, INT8, 64>>(64, __VA_ARGS__);   \
    default: return FN<flash_fwd_quant_mma_kernel<TO, INT8, 128>>(128, __VA_ARGS__); \
  }
#define FLASH_QUANT_MMA_DISPATCH(FN, ...)                                             \
  if (out_dtype == 0 && fmt == 0) { FLASH_QUANT_MMA_CASES(FN, float, true, __VA_ARGS__) } \
  if (out_dtype == 0 && fmt == 1) { FLASH_QUANT_MMA_CASES(FN, float, false, __VA_ARGS__) } \
  if (out_dtype == 1 && fmt == 0) { FLASH_QUANT_MMA_CASES(FN, bf16, true, __VA_ARGS__) }  \
  if (out_dtype == 1 && fmt == 1) { FLASH_QUANT_MMA_CASES(FN, bf16, false, __VA_ARGS__) } \
  return cudaErrorInvalidValue;

// the 8-bit forward's mma rule (ops/flash_attention.py `quant_route`): int8
// or e4m3 codes (1 byte), D % 16 == 0, D <= 128, and q, k, v each with a
// 16-byte-aligned base and batch/sequence/head strides in whole 16-byte
// vectors; o and the f32 scales are written and read element by element,
// so their layout is free
bool quant_mma_ok(int fmt, int D, std::initializer_list<View> views) {
  if ((fmt != 0 && fmt != 1) || D % kMmaDimStep != 0 || D > kMaxHeadDim) return false;
  for (const View& v : views)
    if (reinterpret_cast<uintptr_t>(v.p) % 16 != 0 || v.sb % 16 != 0 || v.ss % 16 != 0 ||
        v.sh % 16 != 0)
      return false;
  return true;
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

// the mma route of the forward (bf16 only): the same arguments as flash_fwd;
// inputs outside the route's rule are refused, never sent to another kernel
int flash_fwd_mma(int dtype, void* q, long long q_sb, long long q_ss, long long q_sh, void* k,
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
  if (!mma_ok(dtype, D, {a.q, a.k, a.v, a.o})) return cudaErrorInvalidValue;
  if (fwd_wgmma(D)) return launch_wgmma(a, stream);
  FLASH_FWD_MMA_DISPATCH(launch_mma, a, stream)
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

// the mma route of the quantized forward (8-bit tensor cores): the same
// arguments as flash_fwd_quant; inputs outside quant_mma_ok are refused,
// never sent to the scalar kernel
int flash_fwd_quant_mma(int out_dtype, int fmt, void* q, long long q_sb, long long q_ss,
                        long long q_sh, void* k, long long k_sb, long long k_ss, long long k_sh,
                        void* v, long long v_sb, long long v_ss, long long v_sh, void* sq,
                        long long sq_sb, long long sq_ss, long long sq_sh, void* sk,
                        long long sk_sb, long long sk_ss, long long sk_sh, void* sv,
                        long long sv_sb, long long sv_ss, long long sv_sh, void* o, long long o_sb,
                        long long o_ss, long long o_sh, float* lse, int B, int S, int H, int D,
                        float scale, int causal, cudaStream_t stream) {
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
  if (!quant_mma_ok(fmt, D, {a.q, a.k, a.v})) return cudaErrorInvalidValue;
  FLASH_QUANT_MMA_DISPATCH(launch_quant_mma, a, stream)
}

// the quantized forward's mma instance for (o's dtype, fmt, head dim D):
// its dynamic shared memory (bytes) and the blocks of it that fit on one SM
int flash_fwd_quant_mma_info(int out_dtype, int fmt, int D, int* smem, int* blocks) {
  if (D < 1 || D > kMaxHeadDim || D % kMmaDimStep) return cudaErrorInvalidValue;
  *smem = static_cast<int>(quant_smem_bytes(quant_pad_dim(D)));
  FLASH_QUANT_MMA_DISPATCH(occupancy_quant_mma, blocks)
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

// the mma route (bf16 only): the same arguments as flash_dq / flash_dkv;
// inputs outside the route's rule are refused, never sent to another kernel
int flash_dq_mma(int dtype, void* q, long long q_sb, long long q_ss, long long q_sh, void* k,
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
  if (!mma_ok(dtype, D, {a.q, a.k, a.v, a.d_o, a.dq})) return cudaErrorInvalidValue;
  FLASH_MMA_DISPATCH(launch_mma, flash_dq_mma_kernel, kDq, a, stream)
}

int flash_dkv_mma(int dtype, void* q, long long q_sb, long long q_ss, long long q_sh, void* k,
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
  if (!mma_ok(dtype, D, {a.q, a.k, a.v, a.d_o, a.dk, a.dv})) return cudaErrorInvalidValue;
  FLASH_MMA_DISPATCH(launch_mma, flash_dkv_mma_kernel, kDkv, a, stream)
}

// the mma instance for head dim D: its dynamic shared memory (bytes) and
// the blocks of it that fit on one SM (dkv: 0 = dq, 1 = dkv)
int flash_bwd_mma_info(int dkv, int D, int* smem, int* blocks) {
  if (D < 1 || D > kMaxHeadDim || D % kMmaDimStep) return cudaErrorInvalidValue;
  const Kind kind = dkv ? kDkv : kDq;
  *smem = static_cast<int>(mma_smem_bytes(kind, pad_dim(D), kBQ));
  if (dkv) { FLASH_MMA_DISPATCH(occupancy_mma, flash_dkv_mma_kernel, kDkv, blocks) }
  FLASH_MMA_DISPATCH(occupancy_mma, flash_dq_mma_kernel, kDq, blocks)
}

// the same for the forward's kernel on the mma route for head dim D
int flash_fwd_mma_info(int D, int* smem, int* blocks) {
  if (D < 1 || D > kMaxHeadDim || D % kMmaDimStep) return cudaErrorInvalidValue;
  if (fwd_wgmma(D)) {
    *smem = static_cast<int>(kWgSmem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_fwd_wgmma_kernel<64>,
                                                         kWgThreads, kWgSmem);
  }
  *smem = static_cast<int>(mma_smem_bytes(kFwd, pad_dim(D), kFwdRows));
  FLASH_FWD_MMA_DISPATCH(occupancy_mma, blocks)
}

int flash_mma_dim_step() { return kMmaDimStep; }

}  // extern "C"
