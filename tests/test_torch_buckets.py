"""Leaf buckets of the overlapped gradient sync: the port's
`parallel/collectives.py` `plan_buckets` gives the JAX package's bucket
boundaries, byte counts and shard sizes for the same leaf shapes, dtypes,
cap and group keys (the LM's parameters grouped by PartitionSpec, a mixed
f32 / bf16 tree, caps from 1 byte to one bucket); `pack_buckets` /
`unpack_buckets` round-trip, into padded buffers too; on gloo ranks (world
2 and 4, tests/torch_rank_worker.py) the bucketed mean equals the per-leaf
all-reduce mean (bitwise at world 2, where each element is one addition;
within 1e-6 relative at world 4, where the ring's chunks follow the buffer's
length; bf16 within two bf16 ulps at 1) and the reduce-scatter /
all-gather round trip equals the bucketed sum, both against the float64
sum of every rank's leaves; and the CNN's bucketed gradient mean
(`ops/train.py` `GradSync`) is bitwise the one-buffer mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.parallel import collectives as JC
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.parallel import collectives as C

from torch_rank_worker import BUCKET_SHAPES, bucket_leaves, launch

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
SEED, CAP = 5, 100


def _plans(jtree, ttree, **kw):
    return JC.plan_buckets(jtree, **kw), C.plan_buckets(ttree, **kw)


def _same(j, t, n=3):
    assert t.buckets == j.buckets and t.shapes == j.shapes and t.dtypes == j.dtypes
    assert t.bucket_bytes() == j.bucket_bytes() and t.bucket_elems() == j.bucket_elems()
    assert t.shard_sizes(n) == j.shard_sizes(n) and t.n_buckets == j.n_buckets


@pytest.mark.parametrize("mb", [1e-6, 0.004, 0.01, 0.1, 64.0])
def test_lm_bucket_plans_match_jax(mb):
    jcfg, tcfg = jtfm.TransformerConfig(**KW), tfm.TransformerConfig(**KW)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = tfm.init_params(0, tcfg)
    jkeys = [str(s) for s in jax.tree.leaves(
        jtfm.param_specs(jcfg), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

    tkeys = [str(s) for s in tree_leaves(tfm.param_specs(tcfg))]
    assert tkeys == jkeys
    cap = max(int(mb * 2**20), 1)
    _same(*_plans(jparams, tparams, bucket_bytes=cap, group_keys=None))
    _same(*_plans(jparams, tparams, bucket_bytes=cap, group_keys=None), n=4)
    j, t = JC.plan_buckets(jparams, bucket_bytes=cap, group_keys=jkeys), C.plan_buckets(
        tparams, bucket_bytes=cap, group_keys=tkeys)
    _same(j, t)


@pytest.mark.parametrize("cap", [1, 40, CAP, 10_000])
def test_mixed_dtype_plans_match_jax(cap):
    leaves = bucket_leaves(SEED, 0)
    jleaves = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16
                                                      else jnp.float32) for x in leaves]
    _same(*_plans(jleaves, leaves, bucket_bytes=cap))
    keys = [i % 2 for i in range(len(leaves))]
    _same(*_plans(jleaves, leaves, bucket_bytes=cap, group_keys=keys))
    with pytest.raises(ValueError, match="group_keys"):
        C.plan_buckets(leaves, group_keys=[0])
    with pytest.raises(ValueError, match="bucket_bytes"):
        C.plan_buckets(leaves, bucket_bytes=0)


def test_pack_unpack_round_trip():
    params = tfm.init_params(0, tfm.TransformerConfig(**KW))
    layout = C.plan_buckets(params, bucket_bytes=5000)
    back = C.unpack_buckets(layout, C.pack_buckets(layout, params))
    assert back.keys() == params.keys()
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
    # into padded buffers (the reduce-scatter's), read back up to each bucket's length
    bufs = [torch.full((s * 3,), 7.0) for s in layout.shard_sizes(3)]
    C.pack_buckets(layout, params, out=bufs)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(C.unpack_buckets(layout, bufs)),
                                                 tree_leaves(params)))
    with pytest.raises(ValueError, match="buffers"):
        C.unpack_buckets(layout, bufs[:-1])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for w in (2, 4):
        d = tmp_path_factory.mktemp(f"b{w}")
        for p in launch(w, {"device": "cpu", "out": str(d), "buckets": {"seed": SEED,
                                                                        "cap": CAP}},
                        timeout=120, env={"OMP_NUM_THREADS": "1"}):
            assert p.returncode == 0, p.stderr[-3000:]
        out[w] = [dict(np.load(d / f"buckets_rank{r}.npz")) for r in range(w)]
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_bucketed_mean_and_round_trip_across_ranks(ranks, world):
    got = ranks[world]
    leaves = [[x.double().numpy() for x in bucket_leaves(SEED, r)] for r in range(world)]
    n_f32 = len(BUCKET_SHAPES)
    for r, g in enumerate(got):
        assert int(g["n_buckets"]) > 1
        for i in range(len(leaves[0])):
            mean, per_leaf = g[f"mean/{i}"], g[f"per_leaf/{i}"]
            exact = sum(lv[i] for lv in leaves) / world
            if world == 2:
                assert np.array_equal(mean, per_leaf), (r, i)
            bf16 = i >= n_f32
            # bf16: two bf16 ulps at 1 (the sums of 4 run in another order)
            np.testing.assert_allclose(mean, per_leaf, rtol=0 if bf16 else 1e-6,
                                       atol=1.6e-2 if bf16 else 0)
            np.testing.assert_allclose(mean, exact, rtol=0 if bf16 else 1e-5,
                                       atol=1.6e-2 if bf16 else 1e-6)
        for i in range(n_f32):
            assert np.array_equal(g[f"gathered/{i}"], got[0][f"gathered/{i}"])
            np.testing.assert_allclose(g[f"gathered/{i}"], g[f"summed/{i}"], rtol=1e-6,
                                       atol=1e-6)
            if world == 2:
                assert np.array_equal(g[f"gathered/{i}"], g[f"summed/{i}"])
    # rank r's shard of each bucket is the r-th slice of the padded sum
    layout = C.plan_buckets(bucket_leaves(SEED, 0)[:n_f32], bucket_bytes=CAP)
    for b, s in enumerate(layout.shard_sizes(world)):
        whole = np.concatenate([g[f"shard/{b}"] for g in got])
        assert whole.shape == (s * world,)
        assert not whole[layout.bucket_elems()[b]:].any()  # the padding sums to zero


@pytest.mark.parametrize("mb", [0.0001, 0.01])
def test_cnn_bucketed_mean_is_bitwise_the_one_buffer_mean(mb):
    """`GradSync` over N stacked replicas' gradients in one process: the
    overlap form's per-bucket means are the end form's bits."""
    from distributed_neural_network_tpu_torch.models.cnn import ReplicaNetwork
    from distributed_neural_network_tpu_torch.ops.train import GradSync
    from distributed_neural_network_tpu_torch.parallel.mesh import ReplicaGroup

    net = ReplicaNetwork(4, generator=torch.Generator().manual_seed(0))
    params = list(net.parameters())
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, p in enumerate(params)]
    group = ReplicaGroup(4, torch.device("cpu"))
    end = GradSync(group, params)
    over = GradSync(group, params, grad_sync="overlap", bucket_bytes=int(mb * 2**20))
    assert len(end.gathers) == 1 and len(over.gathers) > 1
    for s in (end, over):
        s.put(grads, 4)
    for a, b in zip(end.mean_grads(), over.mean_grads()):
        assert torch.equal(a, b)
    for a, g in zip(end.mean_grads(), grads):
        torch.testing.assert_close(a, g.double().mean(0).float(), rtol=1e-6, atol=1e-6)
