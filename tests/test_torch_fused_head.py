"""The port's fused classifier head (`ops/fused_head.py`) against the JAX
package's Pallas kernel (`ops/pallas_kernels.py` `fused_mlp3`), run in
interpret mode as tests/test_pallas.py runs it.

On CPU tensors the port's wrapper computes the plain PyTorch version; the
CUDA kernels themselves are checked on the card by chip_smoke.py. The same
numpy inputs feed both frameworks; tolerance rtol = atol = 1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops.pallas_kernels import fused_mlp3 as jax_fused_mlp3
from distributed_neural_network_tpu_torch.ops import _nvcc
from distributed_neural_network_tpu_torch.ops import fused_head as fh


def _make(B, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(B, 400)).astype(np.float32),
        (rng.normal(size=(400, 120)) * 0.05).astype(np.float32),
        rng.normal(size=(120,)).astype(np.float32),
        (rng.normal(size=(120, 84)) * 0.05).astype(np.float32),
        rng.normal(size=(84,)).astype(np.float32),
        (rng.normal(size=(84, 10)) * 0.05).astype(np.float32),
        rng.normal(size=(10,)).astype(np.float32),
    ]


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("batch", [128, 200, 8, 1])
def test_forward_matches_jax_kernel(n_devices, batch):
    args = _make(batch)
    want = jax_fused_mlp3(*map(jnp.asarray, args), interpret=True)
    got = fh.fused_mlp3(*map(torch.from_numpy, args))
    _close(got.numpy(), want)


def _jax_grads(args, g):
    def loss(*a):
        return (jax_fused_mlp3(*a, interpret=True) * g).sum()

    return jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))


def test_gradients_match_jax_kernel(n_devices):
    """B = 200 is not a multiple of either framework's tile."""
    args = _make(200)
    g = np.random.default_rng(1).normal(size=(200, 10)).astype(np.float32)
    want = _jax_grads(args, g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(fh.fused_mlp3(*leaves), leaves, torch.from_numpy(g))
    for p, r in zip(got, want):
        scale = max(float(np.max(np.abs(r))), 1.0)
        _close(p.numpy() / scale, np.asarray(r) / scale)


def test_plain_kernel_versions_match_jax_kernel(n_devices):
    """The plain versions the CUDA kernels are held to on the card: the
    forward with residuals, the per-tile backward partials and their
    fixed-order reduction give JAX's logits and gradients."""
    args = _make(200, seed=2)
    g = np.random.default_rng(3).normal(size=(200, 10)).astype(np.float32)
    t = list(map(torch.from_numpy, args))
    out, h1, h2 = fh.mlp3_forward(*t, residuals=True)
    _close(out.numpy(), jax_fused_mlp3(*map(jnp.asarray, args), interpret=True))
    x, w1, _, w2, _, w3, _ = t
    dx, partials = fh.mlp3_bwd_partials(torch.from_numpy(g), x, h1, h2, w1, w2, w3)
    assert partials.shape == (13, fh.GRAD_SIZE)  # ceil(200 / 16) tiles
    grads = (dx, *fh.split_grads(fh.mlp3_bwd_reduce(partials)))
    full = fh.mlp3_backward_reference(torch.from_numpy(g), x, h1, h2, w1, w2, w3)
    for p, q, r in zip(grads, full, _jax_grads(args, g)):
        scale = max(float(np.max(np.abs(r))), 1.0)
        _close(p.numpy() / scale, np.asarray(r) / scale)
        _close(q.numpy() / scale, np.asarray(r) / scale)


def test_padded_rows_contribute_nothing():
    """Rows with a zero upstream gradient leave every weight gradient as it
    is without them (the engine's padded last batch)."""
    args = list(map(torch.from_numpy, _make(40, seed=4)))
    out, h1, h2 = fh.mlp3_forward(*args, residuals=True)
    x, w1, _, w2, _, w3, _ = args
    g = torch.randn(40, 10, generator=torch.Generator().manual_seed(0))
    g[25:] = 0
    full = fh.mlp3_backward(g, x, h1, h2, w1, w2, w3)
    cut = fh.mlp3_backward(g[:25], x[:25], h1[:25], h2[:25], w1, w2, w3)
    for a, b in zip(full[1:], cut[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "noncontiguous", "weight_shape", "empty"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = list(map(torch.from_numpy, _make(8)))
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[0] = args[0][:, :399]
    elif bad == "noncontiguous":
        args[0] = torch.cat([args[0], args[0]], dim=1)[:, ::2]
    elif bad == "weight_shape":
        args[1] = args[1].T.contiguous()
    else:
        args[0] = args[0][:0]
    with pytest.raises((TypeError, ValueError)):
        fh.fused_mlp3(*args)


@pytest.mark.parametrize("batch, cluster", [(1, 8), (16, 8), (256, 8), (257, 4), (4096, 4)])
def test_forward_cluster_rule(batch, cluster):
    """The forward kernel's blocks per 16-row tile by the stated rule: 8 up
    to FWD_CLUSTER_MAX_ROWS rows (the main path's 16 among them), 4 above;
    the cluster changes how the card splits the work, not the function (the
    CPU route is the plain version at every B)."""
    assert fh.fwd_cluster(batch) == cluster
    assert cluster in fh.FWD_CLUSTERS
    args = list(map(torch.from_numpy, _make(batch, seed=5)))
    got = fh.mlp3_forward(*args, residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, fh.mlp3_forward_reference(*args)))


def test_module_import_builds_nothing():
    """Importing the wrapper neither compiles nor loads the kernel library."""
    assert fh._lib.cache_info().currsize == 0
    assert _nvcc.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
