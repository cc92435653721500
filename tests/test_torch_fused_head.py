"""The port's fused classifier head (`ops/fused_head.py`) against the JAX
package's Pallas kernel (`ops/pallas_kernels.py` `fused_mlp3`), run in
interpret mode as tests/test_pallas.py runs it.

On CPU tensors the port's wrapper computes the plain PyTorch version; the
CUDA kernels themselves are checked on the card by chip_smoke.py. The same
numpy inputs feed both frameworks; tolerance rtol = atol = 1e-5 (f32). The
kernels take a replica axis (x (N, B, 400), weights (N, in, out)): each
replica's slice is held to JAX's kernel on that replica's inputs.
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


def _make_stacked(n, B, seed=0):
    """N replicas' inputs, each from `_make(B, seed + d)`, stacked."""
    per = [_make(B, seed + d) for d in range(n)]
    return [np.stack(a) for a in zip(*per)], per


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("batch", [128, 200, 8, 1])
def test_forward_matches_jax_kernel(n_devices, batch):
    """One replica (N = 1) against the JAX kernel on the same inputs."""
    args = _make(batch)
    want = jax_fused_mlp3(*map(jnp.asarray, args), interpret=True)
    got = fh.fused_mlp3(*(torch.from_numpy(a)[None] for a in args))
    assert got.shape == (1, *want.shape)
    _close(got[0].numpy(), want)


def _jax_grads(args, g):
    def loss(*a):
        return (jax_fused_mlp3(*a, interpret=True) * g).sum()

    return jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))


def test_gradients_match_jax_kernel(n_devices):
    """B = 200 is not a multiple of either framework's tile; one replica."""
    args = _make(200)
    g = np.random.default_rng(1).normal(size=(200, 10)).astype(np.float32)
    want = _jax_grads(args, g)
    leaves = [torch.from_numpy(a)[None].requires_grad_() for a in args]
    got = torch.autograd.grad(fh.fused_mlp3(*leaves), leaves, torch.from_numpy(g)[None])
    for p, r in zip(got, want):
        scale = max(float(np.max(np.abs(r))), 1.0)
        _close(p[0].numpy() / scale, np.asarray(r) / scale)


def test_plain_kernel_versions_match_jax_kernel(n_devices):
    """The plain versions the CUDA kernels are held to on the card, over a
    replica axis: the forward with residuals, the backward's group sums and
    their fixed-order reduction give, in each replica's slice, JAX's logits
    and gradients for that replica."""
    stacked, per = _make_stacked(2, 200, seed=2)
    gs = np.random.default_rng(3).normal(size=(2, 200, 10)).astype(np.float32)
    t = list(map(torch.from_numpy, stacked))
    out, h1, h2 = fh.mlp3_forward(*t, residuals=True)
    x, w1, _, w2, _, w3, _ = t
    g = torch.from_numpy(gs)
    dx, sums = fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3)
    assert sums.shape == (2, 13, fh.GRAD_SIZE)  # ceil(200 / 16) tiles, one a group
    grads = (dx, *fh.split_grads(fh.mlp3_bwd_reduce(sums)))
    full = fh.mlp3_backward_reference(g, x, h1, h2, w1, w2, w3)
    for d, args in enumerate(per):
        _close(out[d].numpy(), jax_fused_mlp3(*map(jnp.asarray, args), interpret=True))
        for p, q, r in zip(grads, full, _jax_grads(args, gs[d])):
            scale = max(float(np.max(np.abs(r))), 1.0)
            _close(p[d].numpy() / scale, np.asarray(r) / scale)
            _close(q[d].numpy() / scale, np.asarray(r) / scale)


@pytest.mark.parametrize("n, batch", [(1, 1), (3, 16), (2, 40), (2, 1030)])
def test_replica_axis_equals_per_replica_calls(n, batch):
    """The replica-axis plain versions (forward, backward, group sums) give
    each replica what the one-replica call gives it: the axis adds no
    coupling between replicas. At B 1030 a replica's 65 tiles form 33
    groups of 2 tiles, summed in tile order."""
    stacked, per = _make_stacked(n, batch, seed=11)
    t = list(map(torch.from_numpy, stacked))
    g = torch.from_numpy(np.random.default_rng(12).normal(size=(n, batch, 10)).astype(np.float32))
    out, h1, h2 = fh.mlp3_forward(*t, residuals=True)
    x, w1, _, w2, _, w3, _ = t
    dx, sums = fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3)
    assert sums.shape == (n, fh.bwd_groups(batch), fh.GRAD_SIZE)
    grads = fh.mlp3_backward(g, x, h1, h2, w1, w2, w3)
    for d, args in enumerate(per):
        one = [torch.from_numpy(a)[None] for a in args]
        o1, a1, b1 = fh.mlp3_forward(*one, residuals=True)
        for got, want in zip((out, h1, h2), (o1, a1, b1)):
            torch.testing.assert_close(got[d], want[0], rtol=1e-6, atol=1e-6)
        xs, ws1, _, ws2, _, ws3, _ = one
        dx1, sums1 = fh.mlp3_bwd_partials(g[d:d + 1], xs, a1, b1, ws1, ws2, ws3)
        torch.testing.assert_close(dx[d], dx1[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sums[d], sums1[0], rtol=1e-5, atol=1e-5)
        ref = fh.mlp3_backward_reference(g[d], xs[0], a1[0], b1[0], ws1[0], ws2[0], ws3[0])
        for got, want in zip(grads, ref):
            torch.testing.assert_close(got[d], want, rtol=1e-4, atol=1e-4)
    # group q's row is the sum of its tiles' rows, in tile order
    tiles = -(-batch // 16)
    per_group = -(-tiles // fh.bwd_groups(batch))
    for q in (0, fh.bwd_groups(batch) - 1):
        want = 0
        for tile in range(q * per_group, min(q * per_group + per_group, tiles)):
            r = slice(16 * tile, 16 * tile + 16)
            want = want + fh.mlp3_bwd_partials(
                *(a[:1, r].contiguous() for a in (g, x, h1, h2)), w1[:1], w2[:1], w3[:1])[1][0, 0]
        torch.testing.assert_close(sums[0, q], want, rtol=1e-5, atol=1e-5)


def test_padded_rows_contribute_nothing():
    """Rows with a zero upstream gradient leave every weight gradient as it
    is without them (the engine's padded last batch), in every replica."""
    args = [torch.from_numpy(a) for a in _make_stacked(2, 40, seed=4)[0]]
    out, h1, h2 = fh.mlp3_forward(*args, residuals=True)
    x, w1, _, w2, _, w3, _ = args
    g = torch.randn(2, 40, 10, generator=torch.Generator().manual_seed(0))
    g[:, 25:] = 0
    full = fh.mlp3_backward(g, x, h1, h2, w1, w2, w3)
    cut = fh.mlp3_backward(*(a[:, :25].contiguous() for a in (g, x, h1, h2)), w1, w2, w3)
    for a, b in zip(full[1:], cut[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "noncontiguous", "weight_shape", "empty", "unstacked"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = [torch.from_numpy(a)[None] for a in _make(8)]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[0] = args[0][..., :399]
    elif bad == "noncontiguous":
        args[0] = torch.cat([args[0], args[0]], dim=-1)[..., ::2]
    elif bad == "weight_shape":
        args[1] = args[1].mT.contiguous()
    elif bad == "empty":
        args[0] = args[0][:, :0]
    else:  # one replica's tensors without the replica axis
        args = [a[0] for a in args]
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
    args = [torch.from_numpy(a) for a in _make_stacked(2, batch, seed=5)[0]]
    got = fh.mlp3_forward(*args, residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, fh.mlp3_forward_reference(*args)))


@pytest.mark.parametrize("batch", [1, 16, 17, 128, 256, 257, 4096])
def test_backward_cluster_rule(batch):
    """The backward kernel's blocks per cluster by the stated rule: 8 at
    every B, which splits W1's 400 rows and dh1's 120 columns evenly (each
    block then owns 50 rows and 15 columns). The kernel against its plain
    version at each B is chip_smoke.py phase 3's check, on the card."""
    cl = fh.bwd_cluster(batch)
    assert cl == fh.BWD_CLUSTER == 8
    assert (fh.D_IN // cl, fh.D1 // cl) == (50, 15)
    assert fh.D_IN % cl == 0 and fh.D1 % cl == 0


def test_bwd_groups_rule():
    """The group rule over B 1-8192: at most BWD_GROUP_MAX groups of equal
    runs of consecutive tiles (the last may be shorter, never empty); one
    group, the replica's gradient itself, exactly when B <= 16; one tile a
    group up to 16 * BWD_GROUP_MAX rows."""
    for b in range(1, 8193):
        tiles = -(-b // 16)
        groups = fh.bwd_groups(b)
        per_group = -(-tiles // fh.BWD_GROUP_MAX)
        assert 1 <= groups <= fh.BWD_GROUP_MAX
        assert (groups - 1) * per_group < tiles <= groups * per_group
        assert (groups == 1) == (b <= 16)
        if b <= 16 * fh.BWD_GROUP_MAX:
            assert groups == tiles
    assert [fh.bwd_groups(b) for b in (16, 64, 256, 4096)] == [1, 4, 16, 64]


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(fh, "_lib", lambda: None)
    monkeypatch.setattr(fh._nvcc, "launch", lambda lib, name, device, *a: calls.append((name, a)))
    monkeypatch.setattr(fh, "LAUNCHES", dict.fromkeys(fh.LAUNCHES, 0))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    return calls


@pytest.mark.parametrize("n, batch, groups", [(1, 1, 1), (4, 16, 1), (1, 17, 2), (2, 40, 3),
                                              (4, 64, 4), (1, 4096, 64)])
def test_backward_launch_passes_its_batch(monkeypatch, n, batch, groups):
    """On the card the backward's entry point gets the nine tensors, the
    replica count, the batch and the rule's group count, and its outputs are
    dx (N, B, 400) and one row of sums per (replica, group) on x's device;
    here the launch is recorded instead of made."""
    args = [torch.from_numpy(a) for a in _make_stacked(n, batch, seed=7)[0]]
    _, h1, h2 = fh.mlp3_forward(*args, residuals=True)
    x, w1, _, w2, _, w3, _ = args
    g = torch.zeros(n, batch, 10)
    calls = _record_launches(monkeypatch)
    dx, sums = fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3)
    (name, a), = calls
    assert name == "fused_mlp3_bwd" and a[-3:] == (n, batch, groups) and len(a) == 12
    assert a[:9] == tuple(t.data_ptr() for t in (g, x, h1, h2, w1, w2, w3, dx, sums))
    assert dx.shape == (n, batch, fh.D_IN) and sums.shape == (n, groups, fh.GRAD_SIZE)
    assert fh.LAUNCHES["fused_mlp3_bwd"] == 1


@pytest.mark.parametrize("n, batch, residuals", [(1, 1, False), (4, 16, True), (2, 300, True)])
def test_forward_launch_passes_replicas_and_batch(monkeypatch, n, batch, residuals):
    """The forward's entry point gets the ten pointers (null residuals when
    none are asked for), the replica count, the batch and the cluster rule's
    size, once for all replicas."""
    args = [torch.from_numpy(a) for a in _make_stacked(n, batch, seed=8)[0]]
    calls = _record_launches(monkeypatch)
    out, h1, h2 = fh.mlp3_forward(*args, residuals=residuals)
    (name, a), = calls
    assert name == "fused_mlp3_fwd" and a[-3:] == (n, batch, fh.fwd_cluster(batch))
    assert a[:10] == tuple(None if t is None else t.data_ptr() for t in (*args, out, h1, h2))
    assert out.shape == (n, batch, 10) and (h1 is not None) == residuals
    assert fh.LAUNCHES["fused_mlp3_fwd"] == 1


@pytest.mark.parametrize("n, batch, reduces", [(4, 16, 0), (1, 17, 1), (3, 64, 1), (1, 4096, 1)])
def test_reduce_launches_only_for_more_than_one_group(monkeypatch, n, batch, reduces):
    """`mlp3_backward` launches the reduce kernel only when a replica's
    tiles form more than one group, with the replica count and the group
    count; with one group (the main path's B 16) the backward's own row is
    the gradient."""
    args = [torch.from_numpy(a) for a in _make_stacked(n, batch, seed=9)[0]]
    _, h1, h2 = fh.mlp3_forward(*args, residuals=True)
    x, w1, _, w2, _, w3, _ = args
    calls = _record_launches(monkeypatch)
    grads = fh.mlp3_backward(torch.zeros(n, batch, 10), x, h1, h2, w1, w2, w3)
    names = [name for name, _ in calls]
    assert names == ["fused_mlp3_bwd"] + ["fused_mlp3_bwd_reduce"] * reduces
    if reduces:
        assert calls[1][1][1:3] == (n, fh.bwd_groups(batch))
    assert [tuple(t.shape) for t in grads[1:]] == [(n, *s) for s in fh.WEIGHT_SHAPES]
    assert fh.LAUNCHES == {"fused_mlp3_fwd": 0, "fused_mlp3_bwd": 1,
                           "fused_mlp3_bwd_reduce": reduces}


def test_module_import_builds_nothing():
    """Importing the wrapper neither compiles nor loads the kernel library."""
    assert fh._lib.cache_info().currsize == 0
    assert _nvcc.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
