"""The slice gate: the port's Engine against the float64 numpy oracle of the
reference algorithm (tests/oracle_numpy.py) and against the JAX Engine.

1. `sync_mode="epoch"` over 3 epochs, data_parallel (512 rows) and
   replication (128 rows), 4 workers, batch 16, lr 0.01, with JAX's shuffle
   orders injected into the port and the oracle, as tests/test_oracle.py
   checks the JAX engine: train loss within 5e-4, params max-rel within 2e-3.
2. One data_parallel epoch with eval and a fault mask, and one
   `sync_mode="step"` epoch, each from the JAX Engine's initial params with
   its orders and masks injected: train loss and val_loss within 5e-4,
   val_acc within one test row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_neural_network_tpu.data.cifar10 import load_split as jax_load_split
from distributed_neural_network_tpu.parallel.fault import epoch_key
from distributed_neural_network_tpu.parallel.fault import live_mask as jax_live_mask
from distributed_neural_network_tpu.train.engine import Engine as JaxEngine
from distributed_neural_network_tpu.train.engine import TrainConfig as JaxConfig
from distributed_neural_network_tpu_torch.data.cifar10 import load_split
from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

from oracle_numpy import reference_trajectory

N_WORKERS = 4


def _jax_order(seed, epoch, worker, n_rows):
    """The JAX engine's per-(seed, epoch, device) shuffle (engine.py train_shard)."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(seed), jnp.uint32(epoch)), jnp.int32(worker)
    )
    return np.asarray(jax.random.permutation(key, n_rows))


def _max_rel_err(a, b):
    return max(
        float(np.max(np.abs(np.asarray(x) - y) / (np.abs(y) + 1e-3)))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.mark.parametrize("regime", ["data_parallel", "replication"])
def test_epoch_trajectory_matches_reference_oracle(n_devices, regime):
    n_rows = 512 if regime == "data_parallel" else 128
    epochs = 3
    split = load_split(True, source="synthetic", synthetic_size=n_rows, seed=3)
    cfg = TrainConfig(lr=0.01, momentum=0.9, batch_size=16, epochs=epochs,
                      nb_proc=N_WORKERS, regime=regime, seed=0)
    rows = n_rows // N_WORKERS if regime == "data_parallel" else n_rows
    orders = [[_jax_order(0, e, d, rows) for d in range(N_WORKERS)] for e in range(epochs)]
    eng = Engine(cfg, split, None, device="cpu", orders=lambda e, d: orders[e][d])
    assert eng.local_train_rows == rows
    oracle = reference_trajectory(
        eng.state_tree()["params"], split.images, split.labels, n_workers=N_WORKERS,
        batch_size=16, epochs=epochs, lr=cfg.lr, momentum=cfg.momentum,
        orders=orders, regime=regime,
    )
    for e in range(epochs):
        m = eng.run_epoch(e, do_eval=False)
        assert abs(m.train_loss - oracle[e]["train_loss"]) < 5e-4, (e, m.train_loss)
        rel = _max_rel_err(eng.state_tree()["params"], oracle[e]["params"])
        assert rel < 2e-3, (e, rel)


def _fault_seed(p):
    """The first seed whose epoch-0 JAX mask has both dead and live workers."""
    for seed in range(100):
        mask = np.asarray(jax_live_mask(epoch_key(seed, 0), N_WORKERS, p))
        if 0 < mask.sum() < N_WORKERS:
            return seed, mask
    raise AssertionError("no mixed mask in 100 seeds")


@pytest.mark.parametrize("sync_mode", ["epoch", "step"])
def test_one_epoch_matches_jax_engine(n_devices, sync_mode):
    p_fail = 0.5 if sync_mode == "epoch" else 0.0
    seed, mask = _fault_seed(0.5) if p_fail else (1, np.ones(N_WORKERS, np.float32))
    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=1, nb_proc=N_WORKERS,
              regime="data_parallel", sync_mode=sync_mode, seed=seed,
              failure_probability=p_fail, eval_batch_size=8)
    size = dict(source="synthetic", synthetic_size=256, seed=seed)
    test_size = dict(source="synthetic", synthetic_size=50, seed=seed)
    jeng = JaxEngine(JaxConfig(**kw), jax_load_split(True, **size),
                     jax_load_split(False, **test_size))
    state0 = jax.tree.map(np.asarray, jeng.state_tree())
    test_split = load_split(False, **test_size)
    eng = Engine(
        TrainConfig(**kw), load_split(True, **size), test_split, device="cpu",
        orders=lambda e, d: _jax_order(seed, e, d, 256 // N_WORKERS),
        masks=lambda e: np.asarray(jax_live_mask(epoch_key(seed, e), N_WORKERS, p_fail)),
    )
    eng.load_state_tree(state0)
    want = jeng.run_epoch(0)
    got = eng.run_epoch(0)
    assert got.n_live == want.n_live == int(mask.sum())
    assert abs(got.train_loss - want.train_loss) < 5e-4
    assert abs(got.val_loss - want.val_loss) < 5e-4
    assert abs(got.val_acc - want.val_acc) <= 100.0 / len(test_split) + 1e-9
    rel = _max_rel_err(eng.state_tree()["params"], jax.tree.map(np.asarray, jeng.params))
    assert rel < 2e-3


def test_state_tree_round_trips():
    split = load_split(True, source="synthetic", synthetic_size=64, seed=0)
    eng = Engine(TrainConfig(nb_proc=2, epochs=1, seed=4), split, None, device="cpu")
    tree = eng.state_tree()
    assert tree["mom"]["fc1"]["kernel"].shape == (2, 400, 120)
    tree["mom"]["fc1"]["kernel"][1] += 1.0
    eng.load_state_tree(tree)
    back = eng.state_tree()
    assert np.array_equal(back["mom"]["fc1"]["kernel"], tree["mom"]["fc1"]["kernel"])
    assert np.array_equal(back["params"]["conv1"]["kernel"], tree["params"]["conv1"]["kernel"])


def test_regimes_place_data_without_copies():
    split = load_split(True, source="synthetic", synthetic_size=103, seed=0)
    test = load_split(False, source="synthetic", synthetic_size=10, seed=0)
    dp = Engine(TrainConfig(nb_proc=4, regime="data_parallel"), split, test, device="cpu")
    assert dp.local_train_rows == 25 and dp.local_test_rows == 3
    base = dp.train_views[0][0].untyped_storage().data_ptr()
    assert all(v[0].untyped_storage().data_ptr() == base for v in dp.train_views)
    rep = Engine(TrainConfig(nb_proc=3, regime="replication", reference_compat=True),
                 split, None, device="cpu")
    assert rep.n_workers == 2 and rep.local_train_rows == 103
    assert rep.train_views[0][0] is rep.train_views[1][0]
    single = Engine(TrainConfig(nb_proc=8, regime="single"), split, None, device="cpu")
    assert single.n_workers == 1


def test_all_dead_epoch_degrades_to_plain_mean():
    split = load_split(True, source="synthetic", synthetic_size=64, seed=0)
    eng = Engine(TrainConfig(nb_proc=2, lr=0.05, failure_probability=1.0), split, None,
                 device="cpu")
    m = eng.run_epoch(0, do_eval=False)
    assert m.n_live == 0 and np.isfinite(m.train_loss)
    a, b = (list(w.parameters()) for w in eng.workers)
    assert all(bool((x == y).all()) for x, y in zip(a, b))


@pytest.mark.parametrize("field,value", [
    ("input_mode", "stream"), ("grad_sync", "overlap"),
    ("compute_dtype", "bfloat16"), ("dynamics", True),
])
def test_later_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="slice"):
        TrainConfig(**{field: value})
