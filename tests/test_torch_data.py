"""The port's data layer (`data/cifar10.py`, `data/pipeline.py`,
`parallel/partition.py`) against the JAX package's: synthetic data and
labels byte-identical, `normalize` within 1e-6, shards and plans exact,
the stacked plan per replica with its shard offset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.data import cifar10 as jcifar
from distributed_neural_network_tpu.data import pipeline as jpipe
from distributed_neural_network_tpu.parallel import partition as jpart
from distributed_neural_network_tpu_torch.data import cifar10, pipeline
from distributed_neural_network_tpu_torch.parallel import partition


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_synthetic_byte_identical(seed, train):
    a = cifar10.make_synthetic(300, seed=seed, train=train)
    b = jcifar.make_synthetic(300, seed=seed, train=train)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_normalize_and_load_split():
    u8 = cifar10.make_synthetic(64, seed=2)[0]
    np.testing.assert_allclose(cifar10.normalize(u8), jcifar.normalize(u8), rtol=0, atol=1e-6)
    a = cifar10.load_split(False, source="synthetic", synthetic_size=64, seed=2)
    b = jcifar.load_split(False, source="synthetic", synthetic_size=64, seed=2)
    assert a.source == b.source == "synthetic" and len(a) == len(b) == 64
    assert a.images.dtype == np.float32 and a.images.shape == (64, 32, 32, 3)
    np.testing.assert_allclose(a.images, b.images, rtol=0, atol=1e-6)
    assert np.array_equal(a.labels, b.labels)


def test_missing_real_data_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        cifar10.load_split(True, root=str(tmp_path), source="pickle")
    with pytest.raises(FileNotFoundError):
        cifar10.load_split(True, root=str(tmp_path), source="npz")


@pytest.mark.parametrize("total,n", [(512, 4), (50_000, 4), (103, 8), (7, 8)])
def test_shards_match_jax(total, n):
    assert partition.shard_size(total, n) == jpart.shard_size(total, n)
    assert partition.shard_bounds(total, n) == jpart.shard_bounds(total, n)
    assert np.array_equal(partition.shard_rows(total, n), jpart.shard_rows(total, n))
    assert np.array_equal(partition.replicated_rows(total, n), jpart.replicated_rows(total, n))
    with pytest.raises(ValueError):
        partition.shard_size(total, 0)


@pytest.mark.parametrize("n_rows,bs", [(128, 16), (100, 16), (5, 16), (33, 1)])
def test_plans_match_jax(n_rows, bs):
    """With JAX's permutation injected the shuffled plan is JAX's, padding
    and weights included; the eval plan is JAX's."""
    key = jax.random.key(11)
    perm = np.asarray(jax.random.permutation(key, n_rows))
    j_idx, j_w = jpipe.epoch_plan(key, n_rows, bs)
    idx, w = pipeline.epoch_plan(perm, n_rows, bs)
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(w.numpy(), np.asarray(j_w))
    j_idx, j_w = jpipe.eval_plan(n_rows, bs)
    idx, w = pipeline.eval_plan(n_rows, bs)
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(w.numpy(), np.asarray(j_w))
    assert pipeline.plan_shape(n_rows, bs) == jpipe.plan_shape(n_rows, bs)


def test_generator_plan_is_a_seeded_permutation():
    a, _ = pipeline.epoch_plan(pipeline.shuffle_generator(0, 1, 2), 50, 8)
    b, _ = pipeline.epoch_plan(pipeline.shuffle_generator(0, 1, 2), 50, 8)
    c, _ = pipeline.epoch_plan(pipeline.shuffle_generator(0, 1, 3), 50, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sorted(a.flatten()[:50].tolist()) == list(range(50))
    with pytest.raises(ValueError):
        pipeline.epoch_plan(np.arange(49), 50, 8)
    with pytest.raises(ValueError):
        pipeline.plan_shape(0, 8)


def test_gather_batch_matches_jax():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(20, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=20).astype(np.int32)
    idx = np.array([3, 0, 19, 3], np.int32)
    jx, jy = jpipe.gather_batch(jnp.asarray(images), jnp.asarray(labels), jnp.asarray(idx))
    x, y = pipeline.gather_batch(
        torch.from_numpy(images), torch.from_numpy(labels).long(), torch.from_numpy(idx).long()
    )
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("n_rows,bs,offsets", [(40, 16, [0, 40, 80]), (33, 8, [0, 0, 0])])
def test_stacked_plan_is_each_replicas_jax_plan(n_rows, bs, offsets):
    """Replica d's slice of the stacked plan is JAX's plan for its own
    permutation, moved by its shard offset (padding rows: the replica's row
    0, weight 0)."""
    keys = [jax.random.key(20 + d) for d in range(3)]
    perms = [np.asarray(jax.random.permutation(k, n_rows)) for k in keys]
    idx, w = pipeline.stacked_plan(perms, n_rows, bs, offsets)
    assert idx.shape == w.shape == (3, -(-n_rows // bs), bs)
    for d, key in enumerate(keys):
        j_idx, j_w = jpipe.epoch_plan(key, n_rows, bs)
        assert np.array_equal(idx[d].numpy(), np.asarray(j_idx) + offsets[d])
        assert np.array_equal(w[d].numpy(), np.asarray(j_w))
    x, y = pipeline.gather_batch(torch.arange(200.0).view(200, 1), torch.arange(200), idx[:, 0])
    assert x.shape == (3, bs, 1) and torch.equal(y, idx[:, 0])
