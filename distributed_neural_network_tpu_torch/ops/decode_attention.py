"""Single-query decode attention over a KV cache as hand-written CUDA.

Counterpart of `distributed_neural_network_tpu/ops/decode_pallas.py`
(`decode_cache_attention`, `_decode_kernel`, `_decode_kernel_q8`). The
kernels live in `csrc/decode_attention.cu` (the design note is at the top of
that file); this module builds them with `nvcc` at first use
(`ops/_nvcc.py`), binds them with ctypes and checks what they are given.

Two kernels, each with a launch counter in `LAUNCHES`:

- ``decode_attention``: K/V in q's dtype (float32 or bfloat16);
- ``decode_attention_q8``: int8 K/V with per-slot float32 scales,
  dequantized inside the kernel's column loop.

A wrapper given CPU tensors computes the plain PyTorch version of the same
function (`decode_attention_reference`, `decode_attention_q8_reference`);
given CUDA tensors it launches the kernel or raises.

Legality rule (the TPU's 16/32-row sublane gate does not apply): any cache
length ``total >= 1``, any head dim ``1 <= Dh <= 256``, q contiguous, and
K/V with unit stride on their last axis; their other strides and all of the
scales' are free, so a transposed view is read in place.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from . import _nvcc

SOURCE = os.path.join(_nvcc.CSRC, "decode_attention.cu")
MAX_HEAD_DIM = 256
NEG_BIG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel name -> launches since the last reset (callers zero the values)
LAUNCHES = {"decode_attention": 0, "decode_attention_q8": 0}


def decode_kernel_ok(head_dim: int) -> bool:
    """True when the kernels take this head dim (every cache length does)."""
    return 1 <= head_dim <= MAX_HEAD_DIM


# ------------------------------------------------------------ plain versions


def _live(pos, b: int, total: int, device) -> torch.Tensor:
    """(B, total) bool: column j is live for batch row i when j <= pos[i]."""
    if isinstance(pos, int):
        pos = torch.full((b,), pos, dtype=torch.int64, device=device)
    pos = pos.to(device=device, dtype=torch.int64).reshape(-1).expand(b)
    return torch.arange(total, device=device)[None, :] <= pos[:, None]


def masked_decode_attention(q, ck, cv, live):
    """The kernels' function for any (B, total) mask: f32 scores scaled by
    1/sqrt(Dh), masked to -1e30, exp against the row max, the unnormalised
    p rounded to V's dtype for P.V, the f32 sum clamped to 1e-30, the
    output cast to q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bhd,bhtd->bht", q.float(), ck.float()) * (1.0 / math.sqrt(d))
    s = s.masked_fill(~live[:, None, :], NEG_BIG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bht,bhtd->bhd", e.to(cv.dtype).float(), cv.float())
    return (o / e.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def decode_attention_reference(q, ck, cv, pos):
    """Plain version of ``decode_attention``: masked softmax attention."""
    b, _, total, _ = ck.shape
    return masked_decode_attention(q, ck, cv, _live(pos, b, total, q.device))


def decode_attention_q8_reference(q, ck, cv, pos, k_scale, v_scale):
    """Plain version of ``decode_attention_q8``: dequantize (code x scale,
    rounded to q's dtype), then attend."""
    k = (ck.float() * k_scale[..., None]).to(q.dtype)
    v = (cv.float() * v_scale[..., None]).to(q.dtype)
    return decode_attention_reference(q, k, v, pos)


def decode_attention_plain(q, ck, cv, pos, *, k_scale=None, v_scale=None):
    """`decode_cache_attention`'s signature over the plain versions, on any
    device (the serving engine's and generate()'s ``torch`` route)."""
    if k_scale is not None:
        return decode_attention_q8_reference(q, ck, cv, pos, k_scale, v_scale)
    return decode_attention_reference(q, ck, cv, pos)


# ----------------------------------------------------------------- the build


def build() -> str:
    """Compile csrc/decode_attention.cu (once per source hash); return the library path."""
    return _nvcc.build(SOURCE)


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib = _nvcc.load(SOURCE, {
        "decode_attention": [i, p, p, p, p, i, p, i, i, i, i, f] + [ll] * 6 + [p],
        "decode_attention_q8": [i, p, p, p, p, p, p, i, p, i, i, i, i, f] + [ll] * 12 + [p],
        "decode_attention_max_head_dim": [],
    })
    if lib.decode_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("csrc/decode_attention.cu disagrees with decode_attention.py "
                           "on the largest head dim")
    return lib


# ----------------------------------------------------------------- the checks


def _check(q, ck, cv, pos, k_scale, v_scale) -> None:
    if ck.dim() != 4:
        raise ValueError(f"ck must be (B, H, total, Dh), got {tuple(ck.shape)}")
    b, h, total, d = ck.shape
    if min(b, h, total) < 1 or not decode_kernel_ok(d):
        raise ValueError(f"decode_cache_attention takes B, H, total >= 1 and 1 <= Dh <= "
                         f"{MAX_HEAD_DIM}, got ck {tuple(ck.shape)}")
    if tuple(q.shape) != (b, h, d) or tuple(cv.shape) != tuple(ck.shape):
        raise ValueError(f"q must be {(b, h, d)} and cv {tuple(ck.shape)}, got "
                         f"{tuple(q.shape)} and {tuple(cv.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_scale is not None or v_scale is not None
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("quantized decode needs BOTH k_scale and v_scale "
                         "(per-slot f32, shape (B, H, total))")
    kv_dtype = torch.int8 if quantized else q.dtype
    if ck.dtype != kv_dtype or cv.dtype != kv_dtype:
        raise TypeError(f"ck/cv must be {kv_dtype}, got {ck.dtype}/{cv.dtype}")
    named = {"q": q, "ck": ck, "cv": cv}
    if quantized:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (b, h, total) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {(b, h, total)}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
        named.update(k_scale=k_scale, v_scale=v_scale)
    if isinstance(pos, torch.Tensor):
        if pos.numel() not in (1, b) or pos.dim() > 1:
            raise ValueError(f"pos must be a scalar or shape ({b},), got {tuple(pos.shape)}")
        named["pos"] = pos
    elif not isinstance(pos, int):
        raise TypeError(f"pos must be an int or an int tensor, got {type(pos).__name__}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name in ("ck", "cv"):
        if named[name].stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last axis")


# ----------------------------------------------------------------- the kernels


def decode_cache_attention(q, ck, cv, pos, *, k_scale=None, v_scale=None):
    """One cached decode step of attention for every (batch, head).

    q (B, H, Dh); ck/cv (B, H, total, Dh) in q's dtype, or int8 when
    ``k_scale``/``v_scale`` (B, H, total) float32 per-slot scales are given;
    pos an int (every sequence at the same position) or a (B,) int tensor
    (per-sequence positions: columns > pos[b] are dead for batch b). pos
    must lie in [0, total). Returns o (B, H, Dh) in q's dtype. CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    """
    _check(q, ck, cv, pos, k_scale, v_scale)
    quantized = k_scale is not None
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, pos, k_scale=k_scale, v_scale=v_scale)
    b, h, total, d = ck.shape
    if isinstance(pos, torch.Tensor):
        # held in a local until the launch is queued (out may reuse a freed block)
        pos_i32 = pos.to(torch.int32).reshape(-1).expand(b).contiguous()
        pos_ptr, pos_scalar = pos_i32.data_ptr(), 0
    else:
        pos_ptr, pos_scalar = None, pos
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    head = (_DTYPE_CODE[q.dtype], q.data_ptr(), ck.data_ptr(), cv.data_ptr())
    tail = (out.data_ptr(), b, h, total, d, scale, *ck.stride()[:3], *cv.stride()[:3])
    if quantized:
        name = "decode_attention_q8"
        args = (*head, k_scale.data_ptr(), v_scale.data_ptr(), pos_ptr, pos_scalar, *tail,
                *k_scale.stride(), *v_scale.stride())
    else:
        name = "decode_attention"
        args = (*head, pos_ptr, pos_scalar, *tail)
    _nvcc.launch(_lib(), name, q.device, *args)
    LAUNCHES[name] += 1
    return out
