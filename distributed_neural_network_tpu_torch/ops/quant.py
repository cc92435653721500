"""Low-precision quantization: the port of the JAX package's `ops/quant.py`.

- `quantize` / `dequantize`: symmetric scaling of the LAST axis, one f32
  scale per row (``block=None``) or per ``block`` elements, to ``int8``
  (round half to even onto [-127, 127]) or ``fp8`` (float8_e4m3fn, the
  block amax at the format's 448, clamped first);
- `roundtrip_error`: quantize, dequantize, report mae / max abs / relative;
- `quantized_matmul`, `prequantize_weight`: per-row x per-column quantized
  products, or weight-only (W8A16);
- `quantized_attention`: the quantized attention reference, full-row p
  quantization (the flash kernel's per-k-tile grouping equals it when one
  tile spans the row).

The products of codes run in f32 here: int8 products summed over at most
1,040 terms stay below 2^24 and are exact, as the JAX package's int32
accumulation; e4m3 products are exact in f32 and accumulate in f32, as its
``preferred_element_type=float32`` dot. Codes carry no gradient, as
`astype(int8)` carries none in JAX; gradients reach the inputs only through
the scales, as in JAX's autodiff of the same graph.
"""

from __future__ import annotations

import math

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn largest finite
# quantized formats: name -> (storage dtype, max representable magnitude)
QUANT_FORMATS = {
    "int8": (torch.int8, INT8_MAX),
    "fp8": (torch.float8_e4m3fn, FP8_MAX),
}
_EPS = 1e-30  # smallest scale: keeps 1/scale finite and an all-zero block exact
NEG_BIG = -1e30


def _check_fmt(fmt: str) -> None:
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"unknown quantized format {fmt!r}; supported: "
                         f"{', '.join(QUANT_FORMATS)}")


def _block_view(x, block: int):
    """(..., n) -> (..., n // block, block); n must divide by block."""
    n = x.shape[-1]
    if n % block:
        raise ValueError(f"quantization block {block} must divide the quantized axis ({n})")
    return x.reshape(*x.shape[:-1], n // block, block)


def quantize(x, fmt: str = "int8", *, block: int | None = None):
    """Symmetric quantization of the LAST axis: ``(codes, scale)`` with
    ``x ~= codes * scale``; one f32 scale per row (``block=None``) or per
    ``block`` consecutive elements, shaped ``x.shape[:-1] + (n // block,)``.
    Scales are strictly positive."""
    _check_fmt(fmt)
    dtype, qmax = QUANT_FORMATS[fmt]
    xf = x.float()
    if block is not None:
        xf = _block_view(xf, block)
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(_EPS) / qmax
    q = xf / scale
    if fmt == "int8":
        q = torch.round(q).clamp(-INT8_MAX, INT8_MAX)
    else:
        q = q.clamp(-FP8_MAX, FP8_MAX)
    q = q.detach().to(dtype)
    if block is not None:
        q = q.reshape(x.shape)
    return q, scale[..., 0]


def dequantize(q, scale, *, block: int | None = None):
    """Inverse of `quantize`: the f32 reconstruction ``codes * scale``."""
    qf = q.float()
    if block is None:
        return qf * scale[..., None]
    return (_block_view(qf, block) * scale[..., None]).reshape(q.shape)


def roundtrip_error(x, fmt: str = "int8", *, block: int | None = None) -> dict:
    """Quantize -> dequantize -> ``{"mae", "max_abs", "rel"}`` (rel = max abs
    error over the tensor amax)."""
    q, scale = quantize(x, fmt, block=block)
    err = (dequantize(q, scale, block=block) - x.float()).abs()
    amax = max(float(x.float().abs().max()), _EPS)
    return {"mae": float(err.mean()), "max_abs": float(err.max()),
            "rel": float(err.max()) / amax}


def prequantize_weight(w, fmt: str = "int8"):
    """Quantize a ``(..., k, n)`` weight once: per-COLUMN codes stored
    transposed ``(..., n, k)`` plus the ``(..., n)`` f32 scales, the layout
    `quantized_matmul` builds for its right operand."""
    _check_fmt(fmt)
    return quantize(w.transpose(-1, -2), fmt)


def quantized_matmul(a, b, fmt: str = "int8", *, weight_only: bool = False):
    """``a (m, k) @ b (k, n)`` through per-row codes of a and per-column
    codes of b, f32 result. ``b`` may be a ``(codes, scales)`` pair from
    `prequantize_weight`. ``weight_only`` quantizes b alone (W8A16)."""
    _check_fmt(fmt)
    b_q, sb = b if isinstance(b, tuple) else quantize(b.T, fmt)  # (n, k), (n,)
    if weight_only:
        return (a.float() @ b_q.float().T) * sb[None, :]
    a_q, sa = quantize(a, fmt)
    return (a_q.float() @ b_q.float().T) * sa[:, None] * sb[None, :]


def quantized_attention(q, k, v, *, causal: bool = True, fmt: str = "int8", scale=None):
    """Quantized attention, (B, S, H, D) -> same, in q's dtype: per-row codes
    of q/k/v, scores ((qc.kc) * sq * sk) * scale, softmax in f32, v's scale
    folded into p, the folded p quantized per row, then (codes . vc) * sp."""
    _check_fmt(fmt)
    b, s, h, d = q.shape
    sc = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))  # (B, H, S, D)
    q_q, sq = quantize(qt, fmt)
    k_q, sk = quantize(kt, fmt)
    v_q, sv = quantize(vt, fmt)
    s_acc = q_q.float() @ k_q.float().transpose(-1, -2)
    scores = s_acc * sq[..., :, None] * sk[..., None, :] * sc
    if causal:
        live = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~live, NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    p_q, sp = quantize(p * sv[..., None, :], fmt)
    o = (p_q.float() @ v_q.float()) * sp[..., None]
    return o.to(q.dtype).permute(0, 2, 1, 3)
