"""Fused classifier head: relu(relu(x@W1+b1)@W2+b2)@W3+b3 as hand-written CUDA.

Counterpart of `distributed_neural_network_tpu/ops/pallas_kernels.py`
(`fused_mlp3`, `_fwd_kernel`, `_bwd_kernel`). The kernels live in
`csrc/fused_mlp3.cu` (the design note is at the top of that file); this module
builds them with `nvcc` at first use (`ops/_nvcc.py`), binds them with ctypes,
and wraps them in a `torch.autograd.Function`.

The kernels take a replica axis: x is (N, B, 400), each weight (N, in, out)
and each bias (N, out), and one launch serves all N replicas (the replica
group of `train/engine.py`, stacked on a leading axis). Three kernels, each
with a launch counter in `LAUNCHES`:

- ``fused_mlp3_fwd``: logits, plus the h1/h2 residuals when a gradient is
  needed (the TPU kernel's two forward variants), each (replica, 16-row
  tile) spread over a thread-block cluster of `fwd_cluster(B)` blocks;
- ``fused_mlp3_bwd``: dx and the dW/db sums of each (replica, group of
  tiles) by the group rule `bwd_groups(B)`, each group on a cluster of
  `bwd_cluster(B)` blocks that walks its tiles in order; with one group (B
  <= 16, the main path among them) that row is the replica's gradient
  itself;
- ``fused_mlp3_bwd_reduce``: the fixed-order sum of a replica's group rows,
  launched only when it has more than one (the TPU kernel accumulated
  across its sequential grid instead).

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
# the most groups of 16-row tiles a replica's backward is cut into
# (csrc/fused_mlp3.cu BWD_GROUP_MAX, where the measurement behind it is)
BWD_GROUP_MAX = 64
# the forward kernel's cluster: FWD_CLUSTERS[0] blocks per 16-row tile up to
# FWD_CLUSTER_MAX_ROWS rows, FWD_CLUSTERS[1] above (csrc/fused_mlp3.cu's
# header note has the measurements behind the rule)
FWD_CLUSTERS = (8, 4)
FWD_CLUSTER_MAX_ROWS = 256
# the backward kernel's blocks per cluster (csrc/fused_mlp3.cu BWD_CL; its
# header note has the measurements behind it)
BWD_CLUSTER = 8

SOURCE = os.path.join(_nvcc.CSRC, "fused_mlp3.cu")

# kernel name -> launches since the last reset (callers zero the values)
LAUNCHES = {"fused_mlp3_fwd": 0, "fused_mlp3_bwd": 0, "fused_mlp3_bwd_reduce": 0}


def bwd_groups(b: int) -> int:
    """The group rule: the backward cuts a replica's T = ceil(b/16) tiles
    into groups of ceil(T / BWD_GROUP_MAX) consecutive tiles, so into
    ceil(T / that) groups. A function of b alone (never of what the card
    reports), so a gradient's bits depend on b only."""
    tiles = -(-b // BWD_TILE_ROWS)
    per_group = -(-tiles // BWD_GROUP_MAX)
    return -(-tiles // per_group)


# ------------------------------------------------------------ plain versions


def mlp3_reference(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch math of the fused head (natively differentiable); one
    replica's (B, 400) or stacked (N, B, 400)."""
    return mlp3_forward_reference(x, w1, b1, w2, b2, w3, b3)[0]


def mlp3_forward_reference(x, w1, b1, w2, b2, w3, b3):
    """(logits, h1, h2): the plain version of the forward kernel with residuals."""
    h1 = torch.relu(x @ w1 + b1.unsqueeze(-2))
    h2 = torch.relu(h1 @ w2 + b2.unsqueeze(-2))
    return h2 @ w3 + b3.unsqueeze(-2), h1, h2


def _layer_grads(g, h1, h2, w2, w3):
    dh2 = (g @ w3.mT) * (h2 > 0)
    dh1 = (dh2 @ w2.mT) * (h1 > 0)
    return dh1, dh2


def mlp3_backward_reference(g, x, h1, h2, w1, w2, w3):
    """(dx, dW1, db1, dW2, db2, dW3, db3) in plain PyTorch."""
    dh1, dh2 = _layer_grads(g, h1, h2, w2, w3)
    return (
        dh1 @ w1.mT,
        x.mT @ dh1, dh1.sum(-2),
        h1.mT @ dh2, dh2.sum(-2),
        h2.mT @ g, g.sum(-2),
    )


def mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3):
    """(dx (N, B, 400), sums (N, bwd_groups(B), 59134)): the plain version of
    the backward kernel. Each 16-row tile's flattened dW1|db1|dW2|db2|dW3|db3
    is summed over its rows, and a group's row is its tiles' sums added in
    tile order."""
    dh1, dh2 = _layer_grads(g, h1, h2, w2, w3)
    n, b = x.shape[:2]
    nt = -(-b // BWD_TILE_ROWS)
    groups = bwd_groups(b)
    per_group = -(-nt // groups)

    def tiles(a):
        a = torch.nn.functional.pad(a, (0, 0, 0, nt * BWD_TILE_ROWS - b))
        return a.view(n, nt, BWD_TILE_ROWS, a.shape[-1])

    x_t, g_t, h1_t, h2_t = tiles(x), tiles(g), tiles(h1), tiles(h2)
    dh1_t, dh2_t = tiles(dh1), tiles(dh2)
    parts = torch.cat([p.reshape(n, nt, -1) for p in (
        x_t.mT @ dh1_t, dh1_t.sum(2),
        h1_t.mT @ dh2_t, dh2_t.sum(2),
        h2_t.mT @ g_t, g_t.sum(2),
    )], dim=2)
    parts = torch.nn.functional.pad(parts, (0, 0, 0, groups * per_group - nt))
    parts = parts.view(n, groups, per_group, GRAD_SIZE)
    sums = parts[:, :, 0]
    for i in range(1, per_group):
        sums = sums + parts[:, :, i]
    return dh1 @ w1.mT, sums


def split_grads(flat):
    """Views of flat (..., 59,134) gradients as (dW1, db1, dW2, db2, dW3, db3)
    with the leading axes kept."""
    out, off = [], 0
    for shape in WEIGHT_SHAPES:
        n = int(torch.Size(shape).numel())
        out.append(flat[..., off : off + n].view(*flat.shape[:-1], *shape))
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
        "fused_mlp3_fwd": [p] * 10 + [i, i, i, p],
        "fused_mlp3_fwd_info": [i, p, p],
        "fused_mlp3_bwd": [p] * 9 + [i, i, i, p],
        "fused_mlp3_bwd_info": [p, p, p, p],
        "fused_mlp3_bwd_reduce": [p, i, i, p, p],
        "fused_mlp3_bwd_groups": [i],
        "fused_mlp3_grad_size": [],
        "fused_mlp3_bwd_tile_rows": [],
        "fused_mlp3_bwd_group_max": [],
    })
    if (lib.fused_mlp3_grad_size(), lib.fused_mlp3_bwd_tile_rows(),
            lib.fused_mlp3_bwd_group_max()) != (GRAD_SIZE, BWD_TILE_ROWS, BWD_GROUP_MAX):
        raise RuntimeError("csrc/fused_mlp3.cu disagrees with fused_head.py on sizes")
    return lib


def kernel_bwd_groups(b: int) -> int:
    """The CUDA source's group rule at `b` rows (to hold `bwd_groups` to)."""
    return _lib().fused_mlp3_bwd_groups(b)


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
    """The backward kernel's blocks per cluster at `b` rows: 8 at every B,
    each block then owning 50 of W1's 400 rows (8 measured faster than 4
    at B = 16, 128 and 4096; the kernel's header note)."""
    return BWD_CLUSTER


def bwd_info() -> dict:
    """The backward kernel on the current card: its blocks per cluster (as
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


def _rows(x) -> tuple[int, int]:
    """(N, B) of a stacked x."""
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (N>=1, B>=1, {D_IN}), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _weights(n, names, tensors, shapes) -> dict:
    return {k: (t, (n, *s)) for k, t, s in zip(names, tensors, shapes)}


def _check_head(x, w1, b1, w2, b2, w3, b3) -> None:
    n, b = _rows(x)
    w = _weights(n, ("w1", "b1", "w2", "b2", "w3", "b3"), (w1, b1, w2, b2, w3, b3),
                 WEIGHT_SHAPES)
    _check(x.device, x=(x, (n, b, D_IN)), **w)


# ----------------------------------------------------------------- the kernels


def mlp3_forward(x, w1, b1, w2, b2, w3, b3, *, residuals: bool):
    """(logits, h1, h2), each (N, B, .), from one forward launch over the N
    replicas, each (replica, 16-row tile) on a cluster of `fwd_cluster(B)`
    blocks; h1/h2 are None unless `residuals`. CPU tensors take the plain
    version."""
    _check_head(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        out, h1, h2 = mlp3_forward_reference(x, w1, b1, w2, b2, w3, b3)
        return (out, h1, h2) if residuals else (out, None, None)
    n, b = x.shape[:2]
    out = x.new_empty(n, b, D_OUT)
    h1 = x.new_empty(n, b, D1) if residuals else None
    h2 = x.new_empty(n, b, D2) if residuals else None
    _launch(
        "fused_mlp3_fwd", x.device,
        *map(_ptr, (x, w1, b1, w2, b2, w3, b3, out, h1, h2)), n, b, fwd_cluster(b),
    )
    return out, h1, h2


def mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3):
    """(dx (N, B, 400), sums (N, bwd_groups(B), 59134)) from one backward
    launch over the N replicas, each group of tiles on a cluster of
    `bwd_cluster(B)` blocks."""
    n, b = _rows(x)
    _check(
        x.device, g=(g, (n, b, D_OUT)), x=(x, (n, b, D_IN)), h1=(h1, (n, b, D1)),
        h2=(h2, (n, b, D2)),
        **_weights(n, ("w1", "w2", "w3"), (w1, w2, w3), WEIGHT_SHAPES[::2]),
    )
    if x.device.type == "cpu":
        return mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3)
    groups = bwd_groups(b)
    dx = x.new_empty(n, b, D_IN)
    sums = x.new_empty(n, groups, GRAD_SIZE)
    _launch(
        "fused_mlp3_bwd", x.device,
        *map(_ptr, (g, x, h1, h2, w1, w2, w3, dx, sums)), n, b, groups,
    )
    return dx, sums


def mlp3_bwd_reduce(sums):
    """(N, 59134): each replica's group rows (N, G >= 2, 59134) summed in
    group order, from the reduce kernel."""
    if sums.dim() != 3 or min(sums.shape[:2]) < 1:
        raise ValueError(f"sums must be (N>=1, G>=1, {GRAD_SIZE}), got {tuple(sums.shape)}")
    n, groups = sums.shape[:2]
    _check(sums.device, sums=(sums, (n, groups, GRAD_SIZE)))
    if sums.device.type == "cpu":
        out = sums[:, 0]
        for q in range(1, groups):
            out = out + sums[:, q]
        return out
    grads = sums.new_empty(n, GRAD_SIZE)
    _launch("fused_mlp3_bwd_reduce", sums.device, sums.data_ptr(), n, groups,
            grads.data_ptr())
    return grads


def mlp3_backward(g, x, h1, h2, w1, w2, w3):
    """(dx, dW1, db1, dW2, db2, dW3, db3), stacked, from the backward kernel
    and, when a replica's tiles form more than one group, the reduce kernel."""
    dx, sums = mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3)
    flat = sums[:, 0] if sums.shape[1] == 1 else mlp3_bwd_reduce(sums)
    return (dx, *split_grads(flat))


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

    x (N, B, 400) float32 with weights (N, in, out) and biases (N, out)
    returns (N, B, 10) logits. On CPU tensors this is `mlp3_reference`; on
    CUDA tensors the forward launches the fused kernel once for all replicas
    (with residuals only when a gradient is needed) and the backward
    launches the backward kernel (and the reduce kernel when B > 16).
    """
    args = (x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        _check_head(*args)
        return mlp3_reference(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedMLP3.apply(*args)
    return mlp3_forward(*args, residuals=False)[0]
