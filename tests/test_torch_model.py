"""The port's LeNet (`models/cnn.py`) against the JAX package's Flax
`Network`: the parameter converter, logits for both head implementations of
both frameworks, and the parameter and FLOP counts. f32, 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models.cnn import Network as JaxNetwork
from distributed_neural_network_tpu.models.cnn import flops_per_image as jax_flops
from distributed_neural_network_tpu_torch.models.cnn import (
    Network,
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
    head) vs JAX use_pallas_head False/True (off-TPU: the plain jnp head)."""
    tree = _jax_params()
    x = _images()
    want = JaxNetwork(use_pallas_head=use_pallas_head).apply({"params": tree}, jnp.asarray(x))
    net = Network(kernels=kernels)
    net.load_state_dict(from_jax_params(tree))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


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
        Network(kernels="pallas")
