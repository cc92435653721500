"""The port's LeNet (`models/cnn.py`) against the JAX package's Flax
`Network`: the parameter converter (stacked trees too), logits for both head
implementations of both frameworks, the replica-stacked `ReplicaNetwork`
per replica, and the parameter and FLOP counts. f32, 1e-5; at
`compute_dtype=bfloat16` against JAX's bf16 `Network`, 2 bf16 ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models.cnn import Network as JaxNetwork
from distributed_neural_network_tpu.models.cnn import flops_per_image as jax_flops
from distributed_neural_network_tpu_torch.models.cnn import (
    Network,
    ReplicaNetwork,
    flops_per_image,
    from_jax_params,
    param_count,
    to_jax_params,
)


def _jax_params(seed=0):
    params = JaxNetwork().init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def _images(n=6, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32)


def test_converter_round_trips_bitwise():
    tree = _jax_params()
    back = to_jax_params(from_jax_params(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    # and the other way: a port state survives the JAX form unchanged
    net = Network(generator=torch.Generator().manual_seed(3))
    again = from_jax_params(to_jax_params(net.state_dict()))
    for k, v in net.state_dict().items():
        assert torch.equal(v, again[k]), k


@pytest.mark.parametrize("use_pallas_head", [False, True])
@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_logits_match_jax(n_devices, use_pallas_head, kernels):
    """Port kernels torch/cuda (the latter on CPU tensors takes the plain
    head) vs JAX use_pallas_head False/True (off-TPU: the plain jnp head),
    through a one-replica ReplicaNetwork (the model the engine runs)."""
    tree = _jax_params()
    x = _images()
    want = JaxNetwork(use_pallas_head=use_pallas_head).apply({"params": tree}, jnp.asarray(x))
    net = ReplicaNetwork(1, kernels=kernels)
    net.load_state_dict({k: v.unsqueeze(0) for k, v in from_jax_params(tree).items()})
    with torch.no_grad():
        got = net(torch.from_numpy(x).unsqueeze(0))
    assert got.shape == (1, *want.shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_param_and_flop_counts():
    net = Network()
    assert param_count(net) == 62_006
    assert param_count(net.state_dict()) == 62_006
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(_jax_params())) == 62_006
    assert flops_per_image() == jax_flops()


def test_init_is_seeded_and_bounded():
    a = Network(generator=torch.Generator().manual_seed(0)).state_dict()
    b = Network(generator=torch.Generator().manual_seed(0)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
    # U(-1/sqrt(fan_in), 1/sqrt(fan_in)): fc1 fan_in 400 -> bound 0.05
    assert float(a["fc1.kernel"].abs().max()) <= 0.05
    assert a["fc1.kernel"].shape == (400, 120)
    assert a["conv1.weight"].shape == (6, 3, 5, 5)


def test_rejects_unknown_kernels():
    with pytest.raises(ValueError):
        ReplicaNetwork(1, kernels="pallas")


def test_stacked_tree_converts_per_replica():
    """A JAX tree stacked on a leading axis (the engine's momentum stack,
    `P(DATA_AXIS)`) converts to a ReplicaNetwork state_dict whose slice d is
    replica d's own conversion, and back bit for bit."""
    trees = [_jax_params(seed) for seed in range(3)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *trees)
    state = from_jax_params(stacked)
    for d, tree in enumerate(trees):
        for k, v in from_jax_params(tree).items():
            assert torch.equal(state[k][d], v), k
    back = to_jax_params(state)
    for a, b in zip(jax.tree.leaves(stacked), jax.tree.leaves(back)):
        assert np.array_equal(a, b)
    assert set(ReplicaNetwork(3).state_dict()) == set(state)


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_replica_network_matches_jax_per_replica(n_devices, kernels):
    """ReplicaNetwork with 3 replicas of different params (grouped convs, one
    head call) gives each replica JAX's logits for its own params and
    images."""
    trees = [_jax_params(seed) for seed in range(3)]
    x = np.stack([_images(4, seed=d) for d in range(3)])
    net = ReplicaNetwork(3, kernels=kernels)
    net.load_state_dict(from_jax_params(jax.tree.map(lambda *a: np.stack(a), *trees)))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (3, 4, 10)
    for d, tree in enumerate(trees):
        want = JaxNetwork().apply({"params": tree}, jnp.asarray(x[d]))
        np.testing.assert_allclose(got[d].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_replicas_start_from_one_seeded_network():
    """Every replica is the `Network` that the generator's stream draws."""
    base = Network(generator=torch.Generator().manual_seed(7)).state_dict()
    net = ReplicaNetwork(4, generator=torch.Generator().manual_seed(7))
    for k, v in net.state_dict().items():
        assert v.shape == (4, *base[k].shape)
        assert all(torch.equal(v[d], base[k]) for d in range(4)), k
    assert param_count(net) == 4 * 62_006


def _bf16_ulp(a) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of `a`."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(a, np.float64)).max())) - 7)


@pytest.mark.parametrize("use_pallas_head,kernels", [(False, "torch"), (True, "cuda")])
def test_bf16_logits_match_jax(n_devices, use_pallas_head, kernels):
    """`ReplicaNetwork(compute_dtype=bfloat16)` against JAX
    `Network(compute_dtype=bfloat16)` on the same params, 2 replicas of 8
    images: the convs in bf16 and the head in bf16 (torch; JAX's Dense) or
    in f32 (cuda on CPU tensors: the plain head; JAX's Pallas head off the
    TPU), logits f32. Within 2 bf16 ulps of the largest |logit| (another
    summation order in each bf16 conv and dense rounds differently);
    parameters and their gradients stay f32."""
    for seed in range(3):
        tree = _jax_params(seed)
        x = np.stack([_images(8, seed=seed + d) for d in range(2)])
        net = ReplicaNetwork(2, kernels=kernels, compute_dtype=torch.bfloat16)
        net.load_state_dict({k: v.expand(2, *v.shape).clone()
                             for k, v in from_jax_params(tree).items()})
        got = net(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (2, 8, 10)
        model = JaxNetwork(compute_dtype=jnp.bfloat16, use_pallas_head=use_pallas_head)
        want = np.stack([np.asarray(model.apply({"params": tree}, jnp.asarray(x[d])))
                         for d in range(2)])
        err = float(np.abs(got.detach().numpy() - want).max())
        assert err <= 2 * _bf16_ulp(want), (seed, err, _bf16_ulp(want))
        got.square().sum().backward()
        assert all(p.dtype == p.grad.dtype == torch.float32 for p in net.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        ReplicaNetwork(1, compute_dtype=torch.float16)
