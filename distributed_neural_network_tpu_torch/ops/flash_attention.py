"""Flash attention as hand-written CUDA: forward, quantized forward and the
two-kernel recompute backward.

Counterpart of `distributed_neural_network_tpu/ops/flash_pallas.py`
(`flash_mha` over `_fwd_kernel`, `_fwd_quant_kernel`, `_dq_kernel` and
`_dkv_kernel`). The kernels live in `csrc/flash_attention.cu` (the design
note is at the top of that file); this module builds them with `nvcc` at
first use (`ops/_nvcc.py`), binds them with ctypes, checks what they are
given, and wires them into a `torch.autograd.Function` as the JAX package's
`custom_vjp` does: the forward saves (q, k, v, o, lse), with the ORIGINAL
q/k/v when the forward was quantized, and the backward always runs the dq
and dkv kernels (straight-through for a quantized forward).

Four kernels, each with a launch counter in `LAUNCHES`: ``flash_fwd``,
``flash_fwd_quant``, ``flash_dq`` and ``flash_dkv``. A wrapper given CPU
tensors computes the plain PyTorch version of the same function
(`flash_fwd_plain`, `flash_fwd_quant_plain`, `flash_dq_plain`,
`flash_dkv_plain`); given CUDA tensors it launches the kernel or raises.

The forward, the quantized forward and the backward pair each have two
routes, picked by `fwd_route`, `quant_route` and `bwd_route` from the
inputs' dtype, head dim, alignment and strides alone, by one rule
(`_mma_rule`): ``mma`` (the tensor-core kernels, for bf16 operands, or int8
/ e4m3 codes for the quantized forward, with D % 16 == 0, 16-byte-aligned
base pointers and batch/sequence/head strides in whole 16-byte vectors) and
``simt`` (the scalar kernels, for every other legal input). On the mma
route the forward runs the wgmma kernel where the head dim pads to 64 (48,
64) and the mma.sync kernel elsewhere, chosen in `csrc/flash_attention.cu`
(`fwd_wgmma`); the quantized forward runs 8-bit mma.sync. `ROUTE_LAUNCHES`
counts the launches of each route; their sums are the `LAUNCHES` totals. A
failing mma launch raises: no input changes route after the rule has
picked it.

Legality rule (the TPU's divisor-of-S block rule does not apply): any
sequence length S >= 1, head dim 1..128, B*H <= 65535, float32 or bfloat16
q/k/v of one (B, S, H, D) shape with unit stride on D; the other strides are
free, so a strided view is read in place.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from . import _nvcc
from .quant import QUANT_FORMATS, quantize

SOURCE = os.path.join(_nvcc.CSRC, "flash_attention.cu")
BLOCK_K = 64  # the kernels' k tile; part of the quantized forward's function
MAX_HEAD_DIM = 128
MAX_BH = 65535
NEG_BIG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FMT_CODE = {"int8": 0, "fp8": 1}

MMA_DIM_STEP = 16  # the mma route's head dims are multiples of this
MMA_ALIGN_BYTES = 16  # ... its base pointers and batch/sequence/head strides whole vectors of this
ROUTES = ("mma", "simt")

# kernel name -> launches since the last reset (callers zero the values)
LAUNCHES = {"flash_fwd": 0, "flash_fwd_quant": 0, "flash_dq": 0, "flash_dkv": 0}
# the routed kernels' launches by route, "<kernel>_<route>"
ROUTED = ("flash_fwd", "flash_fwd_quant", "flash_dq", "flash_dkv")
ROUTE_LAUNCHES = {f"{k}_{r}": 0 for k in ROUTED for r in ROUTES}


# ------------------------------------------------------------ plain versions


def _heads(x):
    """(B, S, H, D) -> (B, H, S, D) float32."""
    return x.permute(0, 2, 1, 3).float()


def _to_bshd(x, dtype):
    """(B, H, S, D) float32 -> contiguous (B, S, H, D) in `dtype`."""
    return x.to(dtype).permute(0, 2, 1, 3).contiguous()


def _live(s: int, k0: int, kn: int, causal: bool, device):
    """(S, kn) bool: score (row, k0 + j) is live (causal: row >= column)."""
    if not causal:
        return None
    rows = torch.arange(s, device=device)[:, None]
    return rows >= (k0 + torch.arange(kn, device=device))[None, :]


def _scale(d: int, scale) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def flash_fwd_plain(q, k, v, *, causal: bool = True, scale=None, block_k: int = BLOCK_K):
    """Plain version of ``flash_fwd``: the kernel's online softmax over k
    tiles of `block_k` columns, in f32, with p rounded to V's dtype before
    P.V. Returns (o (B, S, H, D) in q's dtype, lse (B, H, S) f32)."""
    b, s, h, d = q.shape
    sc_ = _scale(d, scale)
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    m = torch.full((b, h, s, 1), NEG_BIG, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for k0 in range(0, s, block_k):
        kn = min(block_k, s - k0)
        sc = (qf @ kf[:, :, k0:k0 + kn].transpose(-1, -2)) * sc_
        live = _live(s, k0, kn, causal, q.device)
        if live is not None:
            sc = sc.masked_fill(~live, NEG_BIG)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k0 + kn]
        m = m_new
    lc = l.clamp_min(1e-30)
    return _to_bshd(acc / lc, q.dtype), (m + torch.log(lc))[..., 0]


def flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, *, causal: bool = True, scale=None,
                          block_k: int = BLOCK_K, out_dtype=torch.float32):
    """Plain version of ``flash_fwd_quant`` on int8 or e4m3 codes (B, S, H,
    D) with f32 row scales (B, S, H): scores ((qc.kc) * sq * sk) * scale;
    v's scale folded into p; the folded p re-quantized with one scale per
    row per k tile of `block_k` columns (the kernel's grouping). The code
    dots are exact in f32 for int8 (|sum| < 2^24), as the kernel's int32
    ones; the fp8 ones round in f32 as the kernel's do. Returns (o (B, S, H,
    D) in `out_dtype`, lse (B, H, S) f32)."""
    fmt = "int8" if qc.dtype == torch.int8 else "fp8"
    qmax = QUANT_FORMATS[fmt][1]
    b, s, h, d = qc.shape
    sc_ = _scale(d, scale)
    qf, kf, vf = _heads(qc), _heads(kc), _heads(vc)
    sqh = sq.permute(0, 2, 1)[..., None]  # (B, H, S, 1)
    skh, svh = sk.permute(0, 2, 1)[:, :, None, :], sv.permute(0, 2, 1)[:, :, None, :]
    m = torch.full((b, h, s, 1), NEG_BIG, device=qc.device)
    l = torch.zeros((b, h, s, 1), device=qc.device)
    acc = torch.zeros((b, h, s, d), device=qc.device)
    for k0 in range(0, s, block_k):
        kn = min(block_k, s - k0)
        cols = slice(k0, k0 + kn)
        sc = (qf @ kf[:, :, cols].transpose(-1, -2)) * sqh * skh[..., cols] * sc_
        live = _live(s, k0, kn, causal, qc.device)
        if live is not None:
            sc = sc.masked_fill(~live, NEG_BIG)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_f = p * svh[..., cols]
        sp = p_f.abs().amax(-1, keepdim=True).clamp_min(1e-30) / qmax
        p_q = p_f / sp
        codes = torch.round(p_q) if fmt == "int8" else p_q.to(torch.float8_e4m3fn).float()
        acc = acc * alpha + (codes @ vf[:, :, cols]) * sp
        m = m_new
    lc = l.clamp_min(1e-30)
    return _to_bshd(acc / lc, out_dtype), (m + torch.log(lc))[..., 0]


def flash_delta(o, do):
    """delta = rowsum(dO * o) in f32, (B, H, S): the backward's per-row
    residual, computed outside the kernels as in the JAX package."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q, k, lse, causal, scale):
    """p = exp(s - lse), (B, H, S, S) f32, masked entries exactly 0."""
    s = q.shape[1]
    sc = (_heads(q) @ _heads(k).transpose(-1, -2)) * scale
    live = _live(s, 0, s, causal, q.device)
    if live is not None:
        sc = sc.masked_fill(~live, NEG_BIG)
    return torch.exp(sc - lse[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True, scale=None):
    """Plain version of ``flash_dq``: ds = p * (dp - delta) * scale, rounded
    to K's dtype, then dq = ds k, in q's dtype."""
    sc_ = _scale(q.shape[-1], scale)
    p = _probs(q, k, lse, causal, sc_)
    dp = _heads(do) @ _heads(v).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * sc_
    return _to_bshd(ds.to(k.dtype).float() @ _heads(k), q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True, scale=None):
    """Plain version of ``flash_dkv``: dv = p^T dO with p rounded to dO's
    dtype, dk = ds^T q with ds rounded to Q's dtype."""
    sc_ = _scale(q.shape[-1], scale)
    p = _probs(q, k, lse, causal, sc_)
    dof = _heads(do)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ _heads(v).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * sc_
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ _heads(q)
    return _to_bshd(dk, k.dtype), _to_bshd(dv, v.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True, scale=None):
    """(dq, dk, dv) from q, k, v, o, lse and dO: the plain backward."""
    delta = flash_delta(o, do)
    dq = flash_dq_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


# ----------------------------------------------------------------- the build


def build() -> str:
    """Compile csrc/flash_attention.cu (once per source hash); return the library path."""
    return _nvcc.build(SOURCE)


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    view = [p, ll, ll, ll]
    shape = [i, i, i, i, f, i]  # B, S, H, D, scale, causal
    lib = _nvcc.load(SOURCE, {
        "flash_fwd": [i] + view * 4 + [p] + shape + [p],
        "flash_fwd_mma": [i] + view * 4 + [p] + shape + [p],
        "flash_fwd_quant": [i, i] + view * 7 + [p] + shape + [p],
        "flash_fwd_quant_mma": [i, i] + view * 7 + [p] + shape + [p],
        "flash_fwd_quant_mma_info": [i, i, i, p, p],
        "flash_dq": [i] + view * 4 + [p, p] + view + shape + [p],
        "flash_dkv": [i] + view * 4 + [p, p] + view * 2 + shape + [p],
        "flash_dq_mma": [i] + view * 4 + [p, p] + view + shape + [p],
        "flash_dkv_mma": [i] + view * 4 + [p, p] + view * 2 + shape + [p],
        "flash_bwd_mma_info": [i, i, p, p],
        "flash_fwd_mma_info": [i, p, p],
        "flash_max_head_dim": [],
        "flash_block_k": [],
        "flash_mma_dim_step": [],
    })
    if (lib.flash_max_head_dim() != MAX_HEAD_DIM or lib.flash_block_k() != BLOCK_K
            or lib.flash_mma_dim_step() != MMA_DIM_STEP):
        raise RuntimeError("csrc/flash_attention.cu disagrees with flash_attention.py on "
                           "the largest head dim, the k tile or the mma route's head dims")
    return lib


def mma_info(kernel: str, d: int, *, out_dtype=torch.bfloat16, fmt: str = "int8") -> dict:
    """The mma-route instance of `kernel` ("flash_fwd" | "flash_fwd_quant"
    | "flash_dq" | "flash_dkv") for head dim `d` (the quantized forward's
    for `out_dtype` and `fmt` too) on the current card: its dynamic shared
    memory in bytes and the blocks of it that fit on one SM."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    if kernel == "flash_fwd_quant":
        rc = _lib().flash_fwd_quant_mma_info(_DTYPE_CODE[out_dtype], _FMT_CODE[fmt], d,
                                             ctypes.byref(smem), ctypes.byref(blocks))
    elif kernel == "flash_fwd":
        rc = _lib().flash_fwd_mma_info(d, ctypes.byref(smem), ctypes.byref(blocks))
    else:
        rc = _lib().flash_bwd_mma_info(int(kernel == "flash_dkv"), d, ctypes.byref(smem),
                                       ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"mma_info({kernel}, D={d}) failed: cudaError {rc}")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def _view(t):
    """(pointer, batch, sequence and head strides) of a (B, S, H[, D]) tensor."""
    return (t.data_ptr(), *t.stride()[:3])


# ----------------------------------------------------------------- the checks


def _check(q, k, v, dtypes=tuple(_DTYPE_CODE)) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    b, s, h, d = q.shape
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k, v must share one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(b, s, h) < 1 or not 1 <= d <= MAX_HEAD_DIM or b * h > MAX_BH:
        raise ValueError(f"flash attention takes B, S, H >= 1, 1 <= D <= {MAX_HEAD_DIM} and "
                         f"B*H <= {MAX_BH}, got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes} like q, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last axis")


def _shape_args(q, scale, causal):
    b, s, h, d = q.shape
    return (b, s, h, d, _scale(d, scale), int(causal))


# ----------------------------------------------------------------- the kernels


def flash_fwd(q, k, v, *, causal: bool = True, scale=None):
    """Forward: (o (B, S, H, D) in q's dtype, lse (B, H, S) f32). CPU
    tensors take the plain version; CUDA tensors launch the kernel of the
    route that `fwd_route` picks, counted in LAUNCHES and ROUTE_LAUNCHES."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    b, s, h, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch_fwd(q, k, v, o, lse, scale, causal)
    return o, lse


def _launch_fwd(q, k, v, o, lse, scale, causal) -> None:
    """One launch of the forward on the route that `fwd_route` picks;
    counted in LAUNCHES and ROUTE_LAUNCHES."""
    route = fwd_route(q, k, v)
    entry = "flash_fwd_mma" if route == "mma" else "flash_fwd"  # the C entry point
    _nvcc.launch(_lib(), entry, q.device, _DTYPE_CODE[q.dtype], *_view(q), *_view(k), *_view(v),
                 *_view(o), lse.data_ptr(), *_shape_args(q, scale, causal))
    LAUNCHES["flash_fwd"] += 1
    ROUTE_LAUNCHES[f"flash_fwd_{route}"] += 1


def flash_fwd_quant_codes(qc, kc, vc, sq, sk, sv, *, causal: bool = True, scale=None,
                          out_dtype=torch.float32):
    """Quantized forward on codes (int8 or float8_e4m3fn, (B, S, H, D)) and
    f32 row scales (B, S, H): (o in `out_dtype`, lse f32). CPU tensors take
    the plain version; CUDA tensors launch the kernel of the route that
    `quant_route` picks, counted in LAUNCHES and ROUTE_LAUNCHES."""
    _check(qc, kc, vc, dtypes=(torch.int8, torch.float8_e4m3fn))
    b, s, h, _ = qc.shape
    for name, t in (("sq", sq), ("sk", sk), ("sv", sv)):
        if tuple(t.shape) != (b, s, h) or t.dtype != torch.float32 or t.device != qc.device:
            raise ValueError(f"{name} must be float32 {(b, s, h)} on {qc.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if qc.device.type == "cpu":
        return flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, causal=causal, scale=scale,
                                     out_dtype=out_dtype)
    o = torch.empty(qc.shape, dtype=out_dtype, device=qc.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qc.device)
    _launch_quant(qc, kc, vc, sq, sk, sv, o, lse, scale, causal)
    return o, lse


def _launch_quant(qc, kc, vc, sq, sk, sv, o, lse, scale, causal) -> None:
    """One launch of the quantized forward on the route that `quant_route`
    picks; counted in LAUNCHES and ROUTE_LAUNCHES."""
    route = quant_route(qc, kc, vc)
    entry = "flash_fwd_quant_mma" if route == "mma" else "flash_fwd_quant"  # the C entry
    fmt = _FMT_CODE["int8" if qc.dtype == torch.int8 else "fp8"]
    _nvcc.launch(_lib(), entry, qc.device, _DTYPE_CODE[o.dtype], fmt,
                 *_view(qc), *_view(kc), *_view(vc), *_view(sq), *_view(sk), *_view(sv),
                 *_view(o), lse.data_ptr(), *_shape_args(qc, scale, causal))
    LAUNCHES["flash_fwd_quant"] += 1
    ROUTE_LAUNCHES[f"flash_fwd_quant_{route}"] += 1


def quantize_qkv(q, k, v, fmt: str):
    """Per-row symmetric codes and f32 scales of q, k and v (`ops/quant.py`
    `quantize` over the head dim, as the JAX package's `_fwd_quant_call`)."""
    return [t for x in (q, k, v) for t in quantize(x, fmt)]


def flash_fwd_quant(q, k, v, *, fmt: str, causal: bool = True, scale=None):
    """Quantized forward from full-precision q/k/v: quantize, then the
    kernel (or its plain version on the CPU). Returns (o in q's dtype, lse)."""
    _check(q, k, v)
    qc, sq, kc, sk, vc, sv = quantize_qkv(q, k, v, fmt)
    return flash_fwd_quant_codes(qc, kc, vc, sq, sk, sv, causal=causal, scale=scale,
                                 out_dtype=q.dtype)


def _mma_rule(*tensors, dtypes=(torch.bfloat16,)) -> str:
    """The one route rule of the forward, the quantized forward and the
    backward pair: "mma" (the tensor-core kernels) when every tensor is of
    one of `dtypes` (bf16; int8 or e4m3 codes for the quantized forward)
    with D % MMA_DIM_STEP == 0, D <= MAX_HEAD_DIM, a base pointer aligned to
    MMA_ALIGN_BYTES and batch, sequence and head strides in whole
    MMA_ALIGN_BYTES vectors (8 bf16 elements, 16 codes); "simt" (the scalar
    kernels) for every other input the kernels take (f32, D 40, a
    misaligned view). The kernels' outputs are allocated contiguous, so
    they meet the rule whenever the inputs do. `csrc/flash_attention.cu`
    `mma_ok` and `quant_mma_ok` state the same rule and refuse what it
    excludes."""
    d = tensors[0].shape[-1]
    if d % MMA_DIM_STEP or d > MAX_HEAD_DIM:
        return "simt"
    for t in tensors:
        vec = MMA_ALIGN_BYTES // t.element_size()
        if (t.dtype not in dtypes or t.data_ptr() % MMA_ALIGN_BYTES
                or any(st % vec for st in t.stride()[:3])):
            return "simt"
    return "mma"


def fwd_route(q, k, v) -> str:
    """The forward's route for these inputs (`_mma_rule` over q, k, v)."""
    return _mma_rule(q, k, v)


def quant_route(qc, kc, vc) -> str:
    """The quantized forward's route for these codes (`_mma_rule` over qc,
    kc, vc with int8 or e4m3 codes; the f32 scales' layout is free)."""
    return _mma_rule(qc, kc, vc, dtypes=(torch.int8, torch.float8_e4m3fn))


def bwd_route(q, k, v, do) -> str:
    """The backward pair's route for these inputs (`_mma_rule` over q, k,
    v, dO)."""
    return _mma_rule(q, k, v, do)


def _launch_bwd(kernel, q, k, v, do, lse, delta, outs, scale, causal) -> None:
    """One launch of `kernel` ("flash_dq" | "flash_dkv") on the route that
    `bwd_route` picks; counted in LAUNCHES and ROUTE_LAUNCHES."""
    route = bwd_route(q, k, v, do)
    entry = kernel + "_mma" if route == "mma" else kernel  # the C entry point
    _nvcc.launch(_lib(), entry, q.device, _DTYPE_CODE[q.dtype], *_view(q),
                 *_view(k), *_view(v), *_view(do), lse.data_ptr(), delta.data_ptr(),
                 *(x for o in outs for x in _view(o)), *_shape_args(q, scale, causal))
    LAUNCHES[kernel] += 1
    ROUTE_LAUNCHES[f"{kernel}_{route}"] += 1


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True, scale=None):
    """dq in q's dtype from the forward's lse and delta (B, H, S) f32."""
    _check(q, k, v)
    _check(q, do, do)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)
    _check_residuals(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_dq", q, k, v, do, lse, delta, (dq,), scale, causal)
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True, scale=None):
    """(dk, dv) in the inputs' dtype from the forward's lse and delta."""
    _check(q, k, v)
    _check(q, do, do)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)
    _check_residuals(q, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_dkv", q, k, v, do, lse, delta, (dk, dv), scale, causal)
    return dk, dv


def _check_residuals(q, lse, delta) -> None:
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != (b, h, s) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 {(b, h, s)} on {q.device}")


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = True, scale=None):
    """(dq, dk, dv): delta = rowsum(dO * o), then the dq and dkv kernels. dO
    may come from autograd with a zero stride (the gradient of a sum), which
    the kernels do not read in place."""
    do = do if do.stride(-1) == 1 else do.contiguous()
    delta = flash_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, quant):
        if quant:
            o, lse = flash_fwd_quant(q, k, v, fmt=quant, causal=causal, scale=scale)
        else:
            o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        # the ORIGINAL q/k/v even after a quantized forward: straight-through
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_mha(q, k, v, *, causal: bool = True, scale=None, quant: str | None = None):
    """Flash attention, (B, S, H, D) -> (B, S, H, D), trainable.

    ``quant`` ("int8" | "fp8") switches the forward to the quantized kernel
    (per-row codes, both products in the storage type with wide
    accumulation); the backward stays on the full-precision kernels and the
    original q/k/v. On a CUDA device every call launches the kernels; on
    the CPU their plain versions run.
    """
    if quant is not None and quant not in QUANT_FORMATS:
        raise ValueError(f"unknown quant format {quant!r}; supported: "
                         f"{', '.join(QUANT_FORMATS)} (or None for bf16/f32)")
    return _Flash.apply(q, k, v, causal, _scale(q.shape[-1], scale), quant)
