"""Fused classifier head: relu(relu(x@W1+b1)@W2+b2)@W3+b3 as hand-written CUDA.

Counterpart of `distributed_neural_network_tpu/ops/pallas_kernels.py`
(`fused_mlp3`, `_fwd_kernel`, `_bwd_kernel`). The kernels live in
`csrc/fused_mlp3.cu` (the design note is at the top of that file); this module
builds them with `nvcc` at first use (`ops/_nvcc.py`), binds them with ctypes,
and wraps them in a `torch.autograd.Function`.

Three kernels, each with a launch counter in `LAUNCHES`:

- ``fused_mlp3_fwd``: logits, plus the h1/h2 residuals when a gradient is
  needed (the TPU kernel's two forward variants), each 16-row tile spread
  over a thread-block cluster of `fwd_cluster(B)` blocks;
- ``fused_mlp3_bwd``: dx and one row of per-tile dW/db partials, each
  16-row tile spread over a thread-block cluster of `bwd_cluster(B)`
  blocks;
- ``fused_mlp3_bwd_reduce``: the fixed-order sum of those partial rows (the
  TPU kernel accumulated across its sequential grid instead).

A wrapper given CPU tensors computes the plain PyTorch version of the same
math; given CUDA tensors it launches the kernel or raises. Weights are
``(in, out)``, the layout of the JAX package's Dense kernels.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _nvcc

D_IN, D1, D2, D_OUT = 400, 120, 84, 10
WEIGHT_SHAPES = ((D_IN, D1), (D1,), (D1, D2), (D2,), (D2, D_OUT), (D_OUT,))
GRAD_SIZE = sum(int(torch.Size(s).numel()) for s in WEIGHT_SHAPES)  # 59,134
BWD_TILE_ROWS = 16
# the forward kernel's cluster: FWD_CLUSTERS[0] blocks per 16-row tile up to
# FWD_CLUSTER_MAX_ROWS rows, FWD_CLUSTERS[1] above (csrc/fused_mlp3.cu's
# header note has the measurements behind the rule)
FWD_CLUSTERS = (8, 4)
FWD_CLUSTER_MAX_ROWS = 256
# the backward kernel's blocks per 16-row tile (csrc/fused_mlp3.cu BWD_CL; its
# header note has the measurements behind it)
BWD_CLUSTER = 8

SOURCE = os.path.join(_nvcc.CSRC, "fused_mlp3.cu")

# kernel name -> launches since the last reset (callers zero the values)
LAUNCHES = {"fused_mlp3_fwd": 0, "fused_mlp3_bwd": 0, "fused_mlp3_bwd_reduce": 0}


# ------------------------------------------------------------ plain versions


def mlp3_reference(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch math of the fused head (natively differentiable)."""
    return mlp3_forward_reference(x, w1, b1, w2, b2, w3, b3)[0]


def mlp3_forward_reference(x, w1, b1, w2, b2, w3, b3):
    """(logits, h1, h2): the plain version of the forward kernel with residuals."""
    h1 = torch.relu(x @ w1 + b1)
    h2 = torch.relu(h1 @ w2 + b2)
    return h2 @ w3 + b3, h1, h2


def _layer_grads(g, x, h1, h2, w1, w2, w3):
    dh2 = (g @ w3.T) * (h2 > 0)
    dh1 = (dh2 @ w2.T) * (h1 > 0)
    return dh1, dh2


def mlp3_backward_reference(g, x, h1, h2, w1, w2, w3):
    """(dx, dW1, db1, dW2, db2, dW3, db3) in plain PyTorch."""
    dh1, dh2 = _layer_grads(g, x, h1, h2, w1, w2, w3)
    return (
        dh1 @ w1.T,
        x.T @ dh1, dh1.sum(0),
        h1.T @ dh2, dh2.sum(0),
        h2.T @ g, g.sum(0),
    )


def mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3):
    """(dx, partials): the plain version of the backward kernel, with one
    row of flattened dW1|db1|dW2|db2|dW3|db3 per 16-row tile."""
    dh1, dh2 = _layer_grads(g, x, h1, h2, w1, w2, w3)
    b = x.shape[0]
    nt = -(-b // BWD_TILE_ROWS)
    pad = nt * BWD_TILE_ROWS - b

    def tiles(a):
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return a.view(nt, BWD_TILE_ROWS, a.shape[1])

    x_t, g_t, h1_t, h2_t = tiles(x), tiles(g), tiles(h1), tiles(h2)
    dh1_t, dh2_t = tiles(dh1), tiles(dh2)
    parts = [
        x_t.transpose(1, 2) @ dh1_t, dh1_t.sum(1),
        h1_t.transpose(1, 2) @ dh2_t, dh2_t.sum(1),
        h2_t.transpose(1, 2) @ g_t, g_t.sum(1),
    ]
    return dh1 @ w1.T, torch.cat([p.reshape(nt, -1) for p in parts], dim=1)


def split_grads(flat):
    """Views of a flat (59,134,) gradient as (dW1, db1, dW2, db2, dW3, db3)."""
    out, off = [], 0
    for shape in WEIGHT_SHAPES:
        n = int(torch.Size(shape).numel())
        out.append(flat[off : off + n].view(shape))
        off += n
    return tuple(out)


# ----------------------------------------------------------------- the build


def build() -> str:
    """Compile csrc/fused_mlp3.cu (once per source hash); return the library path."""
    return _nvcc.build(SOURCE)


@functools.cache
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _nvcc.load(SOURCE, {
        "fused_mlp3_fwd": [p] * 10 + [i, i, p],
        "fused_mlp3_fwd_info": [i, p, p],
        "fused_mlp3_bwd": [p] * 9 + [i, p],
        "fused_mlp3_bwd_info": [p, p, p, p],
        "fused_mlp3_bwd_reduce": [p, i, p, p],
        "fused_mlp3_grad_size": [],
        "fused_mlp3_bwd_tile_rows": [],
    })
    if (lib.fused_mlp3_grad_size(), lib.fused_mlp3_bwd_tile_rows()) != (
        GRAD_SIZE, BWD_TILE_ROWS
    ):
        raise RuntimeError("csrc/fused_mlp3.cu disagrees with fused_head.py on sizes")
    return lib


def fwd_cluster(b: int) -> int:
    """The forward kernel's blocks per 16-row tile at `b` rows: 8 up to
    FWD_CLUSTER_MAX_ROWS rows (the main path's 16; more blocks, each on
    fewer columns, shorten one tile's chain), 4 above (fewer blocks that
    each read the whole x tile)."""
    return FWD_CLUSTERS[0] if b <= FWD_CLUSTER_MAX_ROWS else FWD_CLUSTERS[1]


def fwd_info(cluster: int) -> dict:
    """The forward kernel with `cluster` blocks per tile on the current
    card: its blocks per SM and the clusters of it that run at once."""
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().fused_mlp3_fwd_info(cluster, ctypes.byref(blocks), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"fused_mlp3_fwd_info({cluster}) failed: cudaError {rc}")
    return {"blocks_per_sm": blocks.value, "active_clusters": clusters.value}


def bwd_cluster(b: int) -> int:
    """The backward kernel's blocks per 16-row tile at `b` rows: 8 at every
    B, each block then owning 50 of W1's 400 rows (8 measured faster than 4
    at B = 16, 128 and 4096; the kernel's header note)."""
    return BWD_CLUSTER


def bwd_info() -> dict:
    """The backward kernel on the current card: its blocks per tile (as
    built), dynamic shared memory, blocks per SM and the clusters of it that
    run at once."""
    out = [ctypes.c_int(0) for _ in range(4)]
    rc = _lib().fused_mlp3_bwd_info(*map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"fused_mlp3_bwd_info failed: cudaError {rc}")
    cluster, blocks, clusters, smem = (v.value for v in out)
    return {"cluster": cluster, "smem_bytes": smem, "blocks_per_sm": blocks,
            "active_clusters": clusters}


def _launch(name: str, device: torch.device, *args) -> None:
    _nvcc.launch(_lib(), name, device, *args)
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


# ----------------------------------------------------------------- the checks


def _check(device, **named) -> None:
    """Each value is (tensor, expected shape): raise on a wrong shape,
    device or dtype, or on a non-contiguous tensor."""
    for name, (t, shape) in named.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _rows(x) -> int:
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (B>=1, {D_IN}), got {tuple(x.shape)}")
    return x.shape[0]


def _check_head(x, w1, b1, w2, b2, w3, b3) -> None:
    b = _rows(x)
    w = dict(zip(("w1", "b1", "w2", "b2", "w3", "b3"),
                 zip((w1, b1, w2, b2, w3, b3), WEIGHT_SHAPES)))
    _check(x.device, x=(x, (b, D_IN)), **w)


# ----------------------------------------------------------------- the kernels


def mlp3_forward(x, w1, b1, w2, b2, w3, b3, *, residuals: bool):
    """(logits, h1, h2) from the forward kernel, each 16-row tile on a
    cluster of `fwd_cluster(B)` blocks; h1/h2 are None unless `residuals`.
    CPU tensors take the plain version."""
    _check_head(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        out, h1, h2 = mlp3_forward_reference(x, w1, b1, w2, b2, w3, b3)
        return (out, h1, h2) if residuals else (out, None, None)
    b = x.shape[0]
    out = torch.empty(b, D_OUT, device=x.device)
    h1 = torch.empty(b, D1, device=x.device) if residuals else None
    h2 = torch.empty(b, D2, device=x.device) if residuals else None
    _launch(
        "fused_mlp3_fwd", x.device,
        *map(_ptr, (x, w1, b1, w2, b2, w3, b3, out, h1, h2)), b, fwd_cluster(b),
    )
    return out, h1, h2


def mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3):
    """(dx, partials (ceil(B/16), 59134)) from the backward kernel, each
    16-row tile on a cluster of `bwd_cluster(B)` blocks."""
    b = _rows(x)
    _check(
        x.device, g=(g, (b, D_OUT)), x=(x, (b, D_IN)), h1=(h1, (b, D1)),
        h2=(h2, (b, D2)), w1=(w1, WEIGHT_SHAPES[0]), w2=(w2, WEIGHT_SHAPES[2]),
        w3=(w3, WEIGHT_SHAPES[4]),
    )
    if x.device.type == "cpu":
        return mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3)
    nt = -(-b // BWD_TILE_ROWS)
    dx = x.new_empty(b, D_IN)
    partials = x.new_empty(nt, GRAD_SIZE)
    _launch(
        "fused_mlp3_bwd", x.device, *map(_ptr, (g, x, h1, h2, w1, w2, w3, dx, partials)), b
    )
    return dx, partials


def mlp3_bwd_reduce(partials):
    """(59134,) fixed-order sum of the partial rows, from the reduce kernel."""
    if partials.dim() != 2 or partials.shape[0] < 1:
        raise ValueError(f"partials must be (T>=1, {GRAD_SIZE}), got {tuple(partials.shape)}")
    _check(partials.device, partials=(partials, (partials.shape[0], GRAD_SIZE)))
    if partials.device.type == "cpu":
        return partials.sum(0)
    grads = torch.empty(GRAD_SIZE, device=partials.device)
    _launch("fused_mlp3_bwd_reduce", partials.device, partials.data_ptr(),
            partials.shape[0], grads.data_ptr())
    return grads


def mlp3_backward(g, x, h1, h2, w1, w2, w3):
    """(dx, dW1, db1, dW2, db2, dW3, db3) from the two backward kernels."""
    dx, partials = mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3)
    return (dx, *split_grads(mlp3_bwd_reduce(partials)))


class _FusedMLP3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        out, h1, h2 = mlp3_forward(x, w1, b1, w2, b2, w3, b3, residuals=True)
        ctx.save_for_backward(x, h1, h2, w1, w2, w3)
        return out

    @staticmethod
    def backward(ctx, g):
        return mlp3_backward(g.contiguous(), *ctx.saved_tensors)


def fused_mlp3(x, w1, b1, w2, b2, w3, b3):
    """relu(relu(x@W1+b1)@W2+b2)@W3+b3, trainable.

    x (B, 400) float32; weights (in, out); returns (B, 10) logits. On CPU
    tensors this is `mlp3_reference`; on CUDA tensors the forward launches
    the fused kernel (with residuals only when a gradient is needed) and the
    backward launches the backward and reduce kernels.
    """
    args = (x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        _check_head(*args)
        return mlp3_reference(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedMLP3.apply(*args)
    return mlp3_forward(*args, residuals=False)[0]
