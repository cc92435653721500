"""The port's step math (`ops/losses.py`, `ops/sgd.py`, `ops/train.py`,
`parallel/collectives.py`) against the JAX package's on the same numpy
inputs: the batch loss (1e-5) and its gradients, one local-SGD epoch of two
stacked replicas on injected permutations, each against a JAX epoch (loss
1e-5, params max-rel 1e-4), the eval accounting, and the fault-masked
parameter mean with dead and all-dead workers, the mask on the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models.cnn import Network as JaxNetwork
from distributed_neural_network_tpu.ops.losses import masked_correct as j_correct
from distributed_neural_network_tpu.ops.sgd import sgd_step as j_sgd_step
from distributed_neural_network_tpu.ops.train import make_batch_loss as j_batch_loss
from distributed_neural_network_tpu.ops.train import make_eval_epoch, make_train_epoch
from distributed_neural_network_tpu.parallel.collectives import (
    masked_pmean_tree,
    weighted_mean_scalar as j_weighted_mean_scalar,
)
from distributed_neural_network_tpu_torch.data.pipeline import gather_batch, stacked_plan
from distributed_neural_network_tpu_torch.models.cnn import (
    ReplicaNetwork,
    from_jax_params,
    to_jax_params,
)
from distributed_neural_network_tpu_torch.ops import losses, sgd
from distributed_neural_network_tpu_torch.ops.train import (
    GradSync,
    apply_mean_grads,
    eval_epoch,
    grad_step,
    loss_and_grads,
    train_step,
)
from distributed_neural_network_tpu_torch.parallel.collectives import (
    masked_mean,
    pack,
    unpack,
    weighted_mean_scalar,
)
from distributed_neural_network_tpu_torch.parallel.mesh import create_mesh


def _setup(n=32, seed=0):
    params = JaxNetwork().init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return params, x, y, _replicas(params, 1)


def _max_rel(a, b):
    return max(
        float(np.max(np.abs(np.asarray(p) - np.asarray(q)) / (np.abs(np.asarray(q)) + 1e-3)))
        for p, q in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def test_batch_loss_and_grads_match_jax(n_devices):
    params, x, y, net = _setup(16)
    w = np.ones(16, np.float32)
    w[-3:] = 0.0  # padded rows
    j_loss, j_grads = jax.value_and_grad(j_batch_loss(JaxNetwork().apply))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
    )
    loss, grads = loss_and_grads(
        net, torch.from_numpy(x)[None], torch.from_numpy(y).long()[None], torch.from_numpy(w)[None]
    )
    assert loss.shape == (1,)
    assert abs(float(loss[0]) - float(j_loss)) < 1e-5
    names = [k for k, _ in net.named_parameters()]
    assert _max_rel(to_jax_params({k: g[0] for k, g in zip(names, grads)}), j_grads) < 1e-4


def test_loss_and_correct_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(12, 10)).astype(np.float32)
    y = rng.integers(0, 10, size=12).astype(np.int32)
    w = (rng.uniform(size=12) > 0.3).astype(np.float32)
    from distributed_neural_network_tpu.ops.losses import masked_cross_entropy as j_ce

    t = torch.from_numpy
    assert abs(float(losses.masked_cross_entropy(t(logits), t(y), t(w)))
               - float(j_ce(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w)))) < 1e-6
    assert float(losses.masked_correct(t(logits), t(y).long(), t(w))) == float(
        j_correct(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w))
    )
    assert float(losses.masked_cross_entropy(t(logits), t(y), t(np.zeros(12, np.float32)))) == 0.0


def test_sgd_step_matches_jax():
    rng = np.random.default_rng(0)
    p, m, g = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    jp, jm = j_sgd_step(jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), 0.1, 0.9)
    tp, tm = [torch.from_numpy(p.copy())], [torch.from_numpy(m.copy())]
    sgd.sgd_step(tp, tm, [torch.from_numpy(g)], 0.1, 0.9)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    assert all(float(z.abs().sum()) == 0 for z in sgd.init_momentum(tp))


def _replicas(params, n):
    """A ReplicaNetwork whose n replicas all hold the JAX `params`."""
    net = ReplicaNetwork(n)
    net.load_state_dict({k: v.expand(n, *v.shape).clone()
                         for k, v in from_jax_params(params).items()})
    return net


@pytest.mark.parametrize("reset_momentum", [True, False])
def test_local_sgd_epoch_matches_jax(n_devices, reset_momentum):
    """40 rows at batch 16: 3 steps, the last one padded; two stacked
    replicas from the same params on two permutations, each against a JAX
    epoch with that permutation's key. The port's epoch is what the engine's
    programs run: the momentum reset, then `train_step` once per step."""
    params, x, y, _ = _setup(40, seed=2)
    keys = [jax.random.key(9), jax.random.key(10)]
    mom0 = jax.tree.map(lambda a: (0.01 * np.ones_like(a)).astype(np.float32), params)
    epoch = make_train_epoch(
        JaxNetwork().apply, lr=0.05, momentum=0.9, n_rows=40, batch_size=16,
        reset_momentum=reset_momentum,
    )
    net = _replicas(params, 2)
    names = [k for k, _ in net.named_parameters()]
    mom = [from_jax_params(mom0)[k].expand(2, *p.shape[1:]).clone()
           for k, p in net.named_parameters()]
    idx, w = stacked_plan([np.asarray(jax.random.permutation(k, 40)) for k in keys], 40, 16)
    if reset_momentum:
        torch._foreach_zero_(mom)
    images, labels = torch.from_numpy(x), torch.from_numpy(y).long()
    loss_sums = sum(train_step(net, mom, *gather_batch(images, labels, idx[:, s]), w[:, s],
                               lr=0.05, momentum=0.9) for s in range(idx.shape[1]))
    assert idx.shape[1] == 3
    state = net.state_dict()
    for d, key in enumerate(keys):
        j_params, j_mom, j_loss, j_nb = epoch(params, mom0, jnp.asarray(x), jnp.asarray(y), key)
        assert float(j_nb) == 3
        assert abs(float(loss_sums[d]) - float(j_loss)) < 1e-5
        assert _max_rel(to_jax_params({k: v[d] for k, v in state.items()}), j_params) < 1e-4
        assert _max_rel(to_jax_params({k: m[d] for k, m in zip(names, mom)}), j_mom) < 1e-4


def test_step_sync_takes_the_replica_mean(n_devices):
    """sync_mode="step": `grad_step` packs each replica's gradients into the
    group's gather buffer (`GradSync`, one buffer at grad_sync="end") and
    `apply_mean_grads` steps every replica with their mean, JAX's `pmean`
    of the grads."""
    params, x, y, net1 = _setup(32, seed=6)
    net = _replicas(params, 2)
    mom = [torch.zeros_like(p) for p in net.parameters()]
    idx = torch.tensor([list(range(16)), list(range(16, 32))])
    w = torch.ones(2, 16)
    images, labels = torch.from_numpy(x), torch.from_numpy(y).long()
    sync = GradSync(create_mesh(2, "cpu"), list(net.parameters()))
    loss = grad_step(net, *gather_batch(images, labels, idx), w, sync)
    apply_mean_grads(net, mom, sync, lr=0.1, momentum=0.9)
    grads = [loss_and_grads(net1, images[None, 16 * d:16 * d + 16],
                            labels[None, 16 * d:16 * d + 16], torch.ones(1, 16))[1]
             for d in range(2)]
    for (name, p), g0, g1 in zip(net.named_parameters(), *grads):
        want = from_jax_params(params)[name] - 0.1 * (g0[0] + g1[0]) / 2
        torch.testing.assert_close(p[0], want, rtol=1e-5, atol=1e-6)
        assert torch.equal(p[0], p[1]), name
    assert loss.shape == (2,)


def test_eval_epoch_matches_jax(n_devices):
    params, x, y, _ = _setup(37, seed=3)
    rw = np.ones(37, np.float32)
    rw[30:] = 0.0  # padding rows of a per-worker partition
    j = make_eval_epoch(JaxNetwork().apply, n_rows=37, batch_size=8)(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(rw)
    )
    idx, w = stacked_plan([np.arange(37)], 37, 8)
    got = eval_epoch(_replicas(params, 1), torch.from_numpy(x), torch.from_numpy(y).long(),
                     torch.from_numpy(rw), idx, w)[:, 0]
    # 5 batches, the last (rows 32..36) all padding: excluded from the count
    assert float(got[1]) == float(j[1]) == 4
    assert abs(float(got[0]) - float(j[0])) < 1e-5
    assert float(got[2]) == float(j[2]) and float(got[3]) == float(j[3]) == 30


@pytest.mark.parametrize("live", [[1, 0, 1, 1], [0, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]])
def test_masked_mean_matches_jax(live):
    rng = np.random.default_rng(1)
    stacked = {"a": rng.normal(size=(4, 3, 2)).astype(np.float32),
               "b": rng.normal(size=(4, 5)).astype(np.float32)}
    live = np.asarray(live, np.float32)
    want = jax.vmap(lambda t, w: masked_pmean_tree(t, w, "data"), axis_name="data")(
        stacked, jnp.asarray(live)
    )
    like = [torch.from_numpy(stacked[k]) for k in ("a", "b")]
    got = unpack(masked_mean(pack(like, 4), torch.from_numpy(live)), like)
    for k, g in zip(("a", "b"), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k][0]), rtol=1e-6, atol=1e-6)
    assert torch.allclose(
        masked_mean(torch.from_numpy(stacked["a"]), torch.from_numpy(live)), got[0],
        rtol=0, atol=0
    )


def test_weighted_mean_scalar_and_sync_grads_match_jax():
    v = np.array([3.0, 1.0, 2.0, 5.0], np.float32)
    w = np.array([2.0, 2.0, 0.0, 1.0], np.float32)
    want = jax.vmap(lambda a, b: j_weighted_mean_scalar(a, b, "data"), axis_name="data")(
        jnp.asarray(v), jnp.asarray(w)
    )
    assert abs(float(weighted_mean_scalar(torch.from_numpy(v), torch.from_numpy(w)))
               - float(want[0])) < 1e-6
    grads = [torch.arange(4.0)[:, None].expand(4, 2), 2.0 * torch.arange(4.0)[:, None].expand(4, 3)]
    mean = [m.expand(4, *m.shape) for m in unpack(pack(grads, 4).mean(0), grads)]
    want = jax.vmap(lambda g: jax.lax.pmean(g, "data"), axis_name="data")(
        jnp.arange(4.0)
    )
    assert mean[0].shape == (4, 2) and mean[1].shape == (4, 3)
    assert torch.allclose(mean[0], torch.full((4, 2), float(want[0])))
    assert torch.allclose(mean[1], torch.full((4, 3), 2.0 * float(want[0])))
