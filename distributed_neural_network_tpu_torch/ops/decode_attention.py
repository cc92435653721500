"""Single-query decode attention over a KV cache as hand-written CUDA.

Counterpart of `distributed_neural_network_tpu/ops/decode_pallas.py`
(`decode_cache_attention`, `_decode_kernel`, `_decode_kernel_q8`). The
kernels live in `csrc/decode_attention.cu` (the design note is at the top of
that file); this module builds them with `nvcc` at first use
(`ops/_nvcc.py`), binds them with ctypes and checks what they are given.

Two functions, each with a launch counter in `LAUNCHES`:

- ``decode_attention``: K/V in q's dtype (float32 or bfloat16);
- ``decode_attention_q8``: int8 K/V with per-slot float32 scales,
  dequantized inside the kernel's column loop.

Two routes for each function, picked by `decode_route` from the inputs'
dtype, head dim, alignment and strides alone: ``split`` (the live prefix
cut into pieces by `decode_pieces`, one block of a thread-block cluster per
piece, merged in order: a head dim of whole 16-byte vectors of K/V up to
256, 16-byte-aligned bases and K/V batch, head and slot strides in whole
16-byte vectors, 0 included; for K/V in q's dtype and for int8 K/V alike)
and ``simt`` (the first kernel, one block per (b, h): every other legal
input, such as a misaligned view or int8 K/V at Dh 8, half a vector).
`ROUTE_LAUNCHES` counts each route's launches ("<function>_<route>");
their sums are the `LAUNCHES` totals. The split route's bits depend only on
pos[b] and the head dim: `decode_pieces` is a function of the live length
and the head dim alone, and `csrc/decode_attention.cu` `piece_rows` mirrors
it. The plain version's bits depend on the live prefix alone too
(`masked_decode_attention`).

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

# the split route: at most MAX_PIECES pieces of whole PIECE_STEP rows, each
# holding at least MIN_PIECE_ELEMS elements of K; its loads are VEC_BYTES wide
MAX_PIECES, PIECE_STEP, MIN_PIECE_ELEMS, VEC_BYTES = 8, 16, 1024, 16
ROUTES = ("split", "simt")

# kernel name -> launches since the last reset (callers zero the values)
LAUNCHES = {"decode_attention": 0, "decode_attention_q8": 0}
# the launches by route, "<function>_<route>"
ROUTE_LAUNCHES = {f"{fn}_{r}": 0 for fn in LAUNCHES for r in ROUTES}


def decode_kernel_ok(head_dim: int) -> bool:
    """True when the kernels take this head dim (every cache length does)."""
    return 1 <= head_dim <= MAX_HEAD_DIM


def piece_rows(n: int, head_dim: int) -> int:
    """Rows of each piece of a live prefix of n rows on the split route (the
    last piece may be shorter): n / MAX_PIECES, at least MIN_PIECE_ELEMS /
    head_dim, rounded up to whole PIECE_STEP rows."""
    rows = max(-(-n // MAX_PIECES), MIN_PIECE_ELEMS // head_dim)
    return -(-rows // PIECE_STEP) * PIECE_STEP


def decode_pieces(n: int, head_dim: int) -> list[tuple[int, int]]:
    """The split route's pieces of the live prefix [0, n): contiguous
    [start, stop) ranges in order, at most MAX_PIECES of them. A function of
    n and the head dim alone, never of the cache length, the batch or the
    heads: the bits of one (b, h) row depend only on pos[b] and Dh."""
    rows = piece_rows(n, head_dim)
    return [(s, min(s + rows, n)) for s in range(0, n, rows)]


def decode_route(q, ck, cv, k_scale=None) -> str:
    """The route for these inputs: "split" when ck/cv are in q's dtype (or
    int8, with `k_scale` given), the head dim is whole VEC_BYTES vectors of
    K/V (at most MAX_HEAD_DIM; int8 K/V at Dh 8 is half a vector), q, ck and
    cv start on VEC_BYTES boundaries and ck/cv's batch, head and slot
    strides are whole vectors (stride 0 included); "simt" otherwise. The
    scales' strides are free. `csrc/decode_attention.cu` `split_ok` states
    the same rule (over the output too, which the wrapper allocates
    aligned) and refuses what it excludes."""
    kv_dtype = torch.int8 if k_scale is not None else q.dtype
    if ck.dtype != kv_dtype or cv.dtype != kv_dtype:
        return "simt"
    vec = VEC_BYTES // ck.element_size()
    if q.shape[-1] % vec or q.shape[-1] > MAX_HEAD_DIM:
        return "simt"
    if any(t.data_ptr() % VEC_BYTES for t in (q, ck, cv)):
        return "simt"
    if any(st % vec for t in (ck, cv) for st in t.stride()[:3]):
        return "simt"
    return "split"


# ------------------------------------------------------------ plain versions


def _live(pos, b: int, total: int, device) -> torch.Tensor:
    """(B, total) bool: column j is live for batch row i when j <= pos[i]."""
    if isinstance(pos, int):
        pos = torch.full((b,), pos, dtype=torch.int64, device=device)
    pos = pos.to(device=device, dtype=torch.int64).reshape(-1).expand(b)
    return torch.arange(total, device=device)[None, :] <= pos[:, None]


def _pair_sum(x, dim: int):
    """Sum over `dim` as a tree of elementwise adds that pairs neighbours:
    level by level, element 2i + 1 is added to element 2i, the axis padded
    with zeros to a power of two first. Which elements meet depends on
    their indices alone, never on the axis' length, strides or the other
    axes, so the sum of a prefix followed by zeros has the same bits at any
    padded length, on any device (elementwise adds have no kernel choice)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(0, n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def masked_decode_attention(q, ck, cv, live):
    """The kernels' function for any (B, total) mask: f32 scores scaled by
    1/sqrt(Dh), masked to -1e30, exp against the row max, the unnormalised
    p rounded to V's dtype for P.V, the f32 sum clamped to 1e-30, the
    output cast to q's dtype.

    What the bits depend on: every sum (q . k over Dh; p . v and the
    denominator over the cache) is `_pair_sum`, elementwise products added
    in a tree fixed by the element indices, and a dead column adds an
    exact 0 (p = exp(-1e30 - m) = 0). So under a prefix mask the bits of a
    (b, h) row are a function of its live prefix, Dh and the dtypes alone:
    not of `total`, B, the other rows or the strides of K/V (a transposed
    view, a stride-0 broadcast), which lets the serving engine's bucket
    slab and generate()'s static cache give the same tokens."""
    d = q.shape[-1]
    s = _pair_sum(q.float()[:, :, None, :] * ck.float(), -1) * (1.0 / math.sqrt(d))
    s = s.masked_fill(~live[:, None, :], NEG_BIG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = _pair_sum(e.to(cv.dtype).float()[..., None] * cv.float(), -2)
    return (o / _pair_sum(e, -1)[..., None].clamp_min(1e-30)).to(q.dtype)


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
        "decode_attention_split": [i, p, p, p, p, i, p, i, i, i, i, f] + [ll] * 6 + [p],
        "decode_attention_q8": [i, p, p, p, p, p, p, i, p, i, i, i, i, f] + [ll] * 12 + [p],
        "decode_attention_q8_split": [i, p, p, p, p, p, p, i, p, i, i, i, i, f] + [ll] * 12
        + [p],
        "decode_attention_max_head_dim": [],
        "decode_attention_piece_rows": [i, i],
        "decode_attention_split_info": [i, i, i, i, p, p, p],
    })
    if lib.decode_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("csrc/decode_attention.cu disagrees with decode_attention.py "
                           "on the largest head dim")
    return lib


def kernel_piece_rows(n: int, head_dim: int) -> int:
    """`piece_rows` as the CUDA source computes it (builds the library)."""
    return _lib().decode_attention_piece_rows(n, head_dim)


def split_info(dtype: torch.dtype, head_dim: int, total: int, *, q8: bool = False) -> dict:
    """The split kernel's instance for (q's dtype, head_dim; int8 K/V when
    `q8`) on the current card: its blocks per SM, the blocks of its cluster
    for a cache of `total` rows, and the clusters of it that run at once."""
    out = [ctypes.c_int(0) for _ in range(3)]
    rc = _lib().decode_attention_split_info(_DTYPE_CODE[dtype], int(q8), head_dim, total,
                                            *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"decode_attention_split_info failed: cudaError {rc}")
    return dict(zip(("blocks_per_sm", "cluster", "active_clusters"), (c.value for c in out)))


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
    take the plain version; CUDA tensors launch the kernel of the route
    that `decode_route` picks, or raise.
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
    route = decode_route(q, ck, cv, k_scale)
    if quantized:
        name = "decode_attention_q8"
        args = (*head, k_scale.data_ptr(), v_scale.data_ptr(), pos_ptr, pos_scalar, *tail,
                *k_scale.stride(), *v_scale.stride())
    else:
        name = "decode_attention"
        args = (*head, pos_ptr, pos_scalar, *tail)
    entry = f"{name}_split" if route == "split" else name  # the C entry point
    _nvcc.launch(_lib(), entry, q.device, *args)
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[f"{name}_{route}"] += 1
    return out
