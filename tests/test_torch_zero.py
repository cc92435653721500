"""ZeRO-1 (`parallel/zero.py`): the shard sizes and padding are the JAX
package's (`zero_shard_size`, `leaf_shard_size`, the state trees' shapes:
rank r holds slice r of JAX's (n*S,) global buffer), and on gloo ranks
(world 2 and 4, tests/torch_rank_worker.py, OMP_NUM_THREADS=1) the sharded
update is bitwise the replicated one on the same summed gradient, after one
and three steps: `zero_sgd_step_sharded` against `ops/sgd.py` `sgd_step`
(parameters and momentum), `zero_adam_step_sharded` against
`ops/adam.py` `adam_step` (with weight decay); `zero_sgd_step`, the JAX
package's ravel-and-psum plain form, is bitwise the sharded path; and the
reduce-scatter of each rank's partial gradients matches the slice of their
all-reduced sum (bitwise at world 2, 1e-6 at world 4). The state shards
match the JAX functions' on the 8 virtual devices too (`zero_sgd_step_sharded`
under shard_map), within 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from distributed_neural_network_tpu import compat
from distributed_neural_network_tpu.parallel import zero as JZ
from distributed_neural_network_tpu_torch.parallel import zero as Z

from torch_rank_worker import ZERO_SHAPES, launch, zero_inputs

SEED = 9


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_sizes_and_padding_match_jax(n):
    params = {"a": jnp.zeros((3, 5)), "b": jnp.zeros((7,)), "c": {"d": jnp.zeros((2, 4, 3))}}
    tparams = {"a": torch.zeros(3, 5), "b": torch.zeros(7), "c": {"d": torch.zeros(2, 4, 3)}}
    assert Z.zero_shard_size(tparams, n) == JZ.zero_shard_size(params, n)
    for d in (1, 7, 24, 1000):
        assert Z.leaf_shard_size(d, n) == JZ.leaf_shard_size(d, n)
        assert Z._padded(d, n) == JZ._padded(d, n)
    jt = JZ.init_zero_adam_tree(params, n)
    tt = Z.init_zero_adam_tree(tparams, n)
    for key in ("m", "v"):
        for j, t in zip(jax.tree.leaves(jt[key]), jax.tree.leaves(tt[key],
                                                                  is_leaf=torch.is_tensor)):
            assert j.shape == (t.numel() * n,) and not t.any()
    assert tt["t"] == 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for w in (2, 4):
        d = tmp_path_factory.mktemp(f"z{w}")
        for p in launch(w, {"device": "cpu", "out": str(d), "zero": {"seed": SEED}},
                        timeout=120, env={"OMP_NUM_THREADS": "1"}):
            assert p.returncode == 0, p.stderr[-3000:]
        out[w] = [dict(np.load(d / f"zero_rank{r}.npz")) for r in range(w)]
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_update_is_bitwise_the_replicated_one(ranks, world, steps):
    got = ranks[world]
    for r, g in enumerate(got):
        for i, shape in enumerate(ZERO_SHAPES):
            for a, b in ((f"zero{steps}/{i}", f"sgd{steps}/{i}"),
                         (f"flat{steps}/{i}", f"sgd{steps}/{i}"),
                         (f"zero_adam{steps}/{i}", f"adam{steps}/{i}")):
                assert np.array_equal(g[a], g[b]), (r, a)
                assert np.array_equal(g[a], got[0][a]), (r, a)
            # rank r's momentum shard is slice r of the padded replicated momentum
            s = Z.leaf_shard_size(int(np.prod(shape)), world)
            full = np.zeros(s * world, np.float32)
            full[:int(np.prod(shape))] = g[f"sgd_mom{steps}/{i}"].reshape(-1)
            assert np.array_equal(g[f"zero_mom{steps}/{i}"], full[r * s:(r + 1) * s])
        # the flat form's momentum: slice r of the whole padded vector
        flat = np.concatenate([g[f"sgd_mom{steps}/{i}"].reshape(-1)
                               for i in range(len(ZERO_SHAPES))])
        s = Z.zero_shard_size([torch.zeros(sh) for sh in ZERO_SHAPES], world)
        flat = np.concatenate([flat, np.zeros(s * world - flat.size, np.float32)])
        assert np.array_equal(g[f"flat_mom{steps}"], flat[r * s:(r + 1) * s])


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_of_partial_gradients(ranks, world):
    for g in ranks[world]:
        for i in range(len(ZERO_SHAPES)):
            a, b = g[f"partial/{i}"], g[f"presummed/{i}"]
            if world == 2:
                assert np.array_equal(a, b), i
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sgd_state_matches_jax(n_devices, ranks, world):
    """The JAX `zero_sgd_step_sharded` under shard_map on `world` devices
    from the same parameters and summed gradients: every rank's parameters
    and momentum shards within 1e-6."""
    params, grads, _ = zero_inputs(SEED, 0)
    jp = [jnp.asarray(x.numpy()) for x in params]
    jg = [jnp.asarray(x.numpy()) for x in grads]
    mesh = jax.make_mesh((world,), ("data",), devices=jax.devices()[:world])
    mom = jax.device_put(JZ.init_zero_momentum_tree(jp, world), NamedSharding(mesh, JP("data")))
    step = jax.jit(compat.shard_map(
        functools.partial(JZ.zero_sgd_step_sharded, lr=0.1, momentum=0.9, axis_name="data"),
        mesh=mesh, in_specs=(JP(), JP("data"), JP()), out_specs=(JP(), JP("data")),
        check_vma=False))
    for _ in range(3):
        jp, mom = step(jp, mom, jg)
    got = ranks[world]
    for i in range(len(ZERO_SHAPES)):
        np.testing.assert_allclose(got[0][f"zero3/{i}"], np.asarray(jp[i]), rtol=1e-6,
                                   atol=1e-6)
        whole = np.concatenate([g[f"zero_mom3/{i}"] for g in got])
        np.testing.assert_allclose(whole, np.asarray(mom[i]), rtol=1e-6, atol=1e-6)
