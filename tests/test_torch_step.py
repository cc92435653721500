"""The port's step math (`ops/losses.py`, `ops/sgd.py`, `ops/train.py`,
`parallel/collectives.py`) against the JAX package's on the same numpy
inputs: the batch loss (1e-5) and its gradients, one local-SGD epoch on an
injected permutation (loss 1e-5, params max-rel 1e-4), and the fault-masked
parameter mean with dead and all-dead workers."""

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
from distributed_neural_network_tpu_torch.models.cnn import Network, from_jax_params, to_jax_params
from distributed_neural_network_tpu_torch.ops import losses, sgd
from distributed_neural_network_tpu_torch.ops.train import (
    eval_epoch,
    loss_and_grads,
    sync_grads,
    train_epoch,
)
from distributed_neural_network_tpu_torch.parallel.collectives import (
    masked_mean,
    masked_mean_tree,
    weighted_mean_scalar,
)


def _setup(n=32, seed=0):
    params = JaxNetwork().init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    net = Network()
    net.load_state_dict(from_jax_params(params))
    return params, x, y, net


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
        net, torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(w)
    )
    assert abs(float(loss) - float(j_loss)) < 1e-5
    names = [k for k, _ in net.named_parameters()]
    assert _max_rel(to_jax_params(dict(zip(names, grads))), j_grads) < 1e-4


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


@pytest.mark.parametrize("reset_momentum", [True, False])
def test_local_sgd_epoch_matches_jax(n_devices, reset_momentum):
    """40 rows at batch 16: 3 steps, the last one padded."""
    params, x, y, net = _setup(40, seed=2)
    key = jax.random.key(9)
    mom0 = jax.tree.map(lambda a: (0.01 * np.ones_like(a)).astype(np.float32), params)
    epoch = make_train_epoch(
        JaxNetwork().apply, lr=0.05, momentum=0.9, n_rows=40, batch_size=16,
        reset_momentum=reset_momentum,
    )
    j_params, j_mom, j_loss, j_nb = epoch(params, mom0, jnp.asarray(x), jnp.asarray(y), key)
    names = [k for k, _ in net.named_parameters()]
    mom = [from_jax_params(mom0)[k] for k in names]
    mom, loss_sum, nb = train_epoch(
        net, mom, torch.from_numpy(x), torch.from_numpy(y).long(),
        np.asarray(jax.random.permutation(key, 40)), batch_size=16, lr=0.05,
        momentum=0.9, reset_momentum=reset_momentum,
    )
    assert nb == float(j_nb) == 3
    assert abs(float(loss_sum) - float(j_loss)) < 1e-5
    assert _max_rel(to_jax_params(net.state_dict()), j_params) < 1e-4
    assert _max_rel(to_jax_params(dict(zip(names, mom))), j_mom) < 1e-4


def test_eval_epoch_matches_jax(n_devices):
    params, x, y, net = _setup(37, seed=3)
    rw = np.ones(37, np.float32)
    rw[30:] = 0.0  # padding rows of a per-worker partition
    j = make_eval_epoch(JaxNetwork().apply, n_rows=37, batch_size=8)(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(rw)
    )
    got = eval_epoch(net, torch.from_numpy(x), torch.from_numpy(y).long(),
                     torch.from_numpy(rw), batch_size=8)
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
    per_worker = [[torch.from_numpy(stacked[k][d]) for k in ("a", "b")] for d in range(4)]
    got = masked_mean_tree(per_worker, live)
    for k, g in zip(("a", "b"), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k][0]), rtol=1e-6, atol=1e-6)
    assert torch.allclose(
        masked_mean(torch.from_numpy(stacked["a"]), live), got[0], rtol=0, atol=0
    )


def test_weighted_mean_scalar_and_sync_grads_match_jax():
    v = np.array([3.0, 1.0, 2.0, 5.0], np.float32)
    w = np.array([2.0, 2.0, 0.0, 1.0], np.float32)
    want = jax.vmap(lambda a, b: j_weighted_mean_scalar(a, b, "data"), axis_name="data")(
        jnp.asarray(v), jnp.asarray(w)
    )
    assert abs(float(weighted_mean_scalar(torch.from_numpy(v), torch.from_numpy(w)))
               - float(want[0])) < 1e-6
    grads = [[torch.full((2,), float(d)), torch.full((3,), 2.0 * d)] for d in range(4)]
    mean = sync_grads(grads)
    want = jax.vmap(lambda g: jax.lax.pmean(g, "data"), axis_name="data")(
        jnp.arange(4.0)
    )
    assert torch.allclose(mean[0], torch.full((2,), float(want[0])))
    assert torch.allclose(mean[1], torch.full((3,), 2.0 * float(want[0])))
