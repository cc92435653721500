"""Fused classifier head: relu(relu(x@W1+b1)@W2+b2)@W3+b3 as hand-written CUDA.

Counterpart of `distributed_neural_network_tpu/ops/pallas_kernels.py`
(`fused_mlp3`, `_fwd_kernel`, `_bwd_kernel`). The kernels live in
`csrc/fused_mlp3.cu` (the design note is at the top of that file); this module
builds them with `nvcc` at first use, binds them with ctypes, and wraps them in
a `torch.autograd.Function`.

Three kernels, each with a launch counter in `LAUNCHES`:

- ``fused_mlp3_fwd``: logits, plus the h1/h2 residuals when a gradient is
  needed (the TPU kernel's two forward variants);
- ``fused_mlp3_bwd``: dx and one row of per-tile dW/db partials per block;
- ``fused_mlp3_bwd_reduce``: the fixed-order sum of those partial rows (the
  TPU kernel accumulated across its sequential grid instead).

A wrapper given CPU tensors computes the plain PyTorch version of the same
math; given CUDA tensors it launches the kernel or raises. Weights are
``(in, out)``, the layout of the JAX package's Dense kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

D_IN, D1, D2, D_OUT = 400, 120, 84, 10
WEIGHT_SHAPES = ((D_IN, D1), (D1,), (D1, D2), (D2,), (D2, D_OUT), (D_OUT,))
GRAD_SIZE = sum(int(torch.Size(s).numel()) for s in WEIGHT_SHAPES)  # 59,134
BWD_TILE_ROWS = 16

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_mlp3.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused head's CUDA kernels cannot be built")


def build() -> str:
    """Compile csrc/fused_mlp3.cu into a shared library (once per source
    hash) and return its path. Raises if nvcc fails."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"fused_mlp3_{tag}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
        )
    with open(os.path.join(BUILD_DIR, f"fused_mlp3_{tag}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp3_fwd.argtypes = [p] * 10 + [i, p]
    lib.fused_mlp3_bwd.argtypes = [p] * 9 + [i, p]
    lib.fused_mlp3_bwd_reduce.argtypes = [p, i, p, p]
    for fn in ("fused_mlp3_fwd", "fused_mlp3_bwd", "fused_mlp3_bwd_reduce",
               "fused_mlp3_grad_size", "fused_mlp3_bwd_tile_rows"):
        getattr(lib, fn).restype = i
    if (lib.fused_mlp3_grad_size(), lib.fused_mlp3_bwd_tile_rows()) != (
        GRAD_SIZE, BWD_TILE_ROWS
    ):
        raise RuntimeError("csrc/fused_mlp3.cu disagrees with fused_head.py on sizes")
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
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
    """(logits, h1, h2) from the forward kernel; h1/h2 are None unless
    `residuals`. CPU tensors take the plain version."""
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
        *map(_ptr, (x, w1, b1, w2, b2, w3, b3, out, h1, h2)), b,
    )
    return out, h1, h2


def mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3):
    """(dx, partials (ceil(B/16), 59134)) from the backward kernel."""
    b = _rows(x)
    _check(
        x.device, g=(g, (b, D_OUT)), x=(x, (b, D_IN)), h1=(h1, (b, D1)),
        h2=(h2, (b, D2)), w1=(w1, WEIGHT_SHAPES[0]), w2=(w2, WEIGHT_SHAPES[2]),
        w3=(w3, WEIGHT_SHAPES[4]),
    )
    if x.device.type == "cpu":
        return mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3)
    nt = -(-b // BWD_TILE_ROWS)
    dx = torch.empty(b, D_IN, device=x.device)
    partials = torch.empty(nt, GRAD_SIZE, device=x.device)
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
