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
3. A fused span (`run_span(0, 3)`, with and without eval inside) against
   the JAX Engine's `run_span(0, 3)` under the same injection, with the same
   bounds and params max-rel within 2e-3; and the span equal bit for bit to
   three `run_epoch` calls of the port.
4. One epoch at `compute_dtype="bfloat16"` against the JAX Engine's, per
   epoch and per step, with either head: the losses as in 2, every
   parameter within 2 bf16 ulps of its leaf's largest magnitude.
5. `run(guard=...)` against the JAX Engine's with a guard whose observation
   of epoch 2 is replaced once (warn, skip, rollback): the histories and
   final params within the bounds of 1 and 3; warn bitwise the unguarded
   run.

The engine keeps the N workers stacked on a leading axis; on the CPU its
programs run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """Each split is one device tensor: data_parallel's workers read their
    shards of it through row offsets, replication's all read it whole."""
    split = load_split(True, source="synthetic", synthetic_size=103, seed=0)
    test = load_split(False, source="synthetic", synthetic_size=10, seed=0)
    dp = Engine(TrainConfig(nb_proc=4, regime="data_parallel"), split, test, device="cpu")
    assert dp.local_train_rows == 25 and dp.local_test_rows == 3
    assert dp.train_images.shape[0] == 100 and dp.train_offsets == [0, 25, 50, 75]
    assert dp.test_images.shape[0] == 12 and dp.eval_idx.shape == (4, 1, 16)
    assert dp.eval_idx[:, 0, 0].tolist() == [0, 3, 6, 9]
    assert all(p.shape[0] == 4 for p in dp.params)
    rep = Engine(TrainConfig(nb_proc=3, regime="replication", reference_compat=True),
                 split, None, device="cpu")
    assert rep.n_workers == 2 and rep.local_train_rows == 103
    assert rep.train_images.shape[0] == 103 and rep.train_offsets == [0, 0]
    single = Engine(TrainConfig(nb_proc=8, regime="single"), split, None, device="cpu")
    assert single.n_workers == 1


def test_all_dead_epoch_degrades_to_plain_mean():
    split = load_split(True, source="synthetic", synthetic_size=64, seed=0)
    eng = Engine(TrainConfig(nb_proc=2, lr=0.05, failure_probability=1.0), split, None,
                 device="cpu")
    m = eng.run_epoch(0, do_eval=False)
    assert m.n_live == 0 and np.isfinite(m.train_loss)
    assert all(bool((p[0] == p[1]).all()) for p in eng.params)


def _span_engines(eval_inside):
    """The JAX Engine and the port's on the same data, with JAX's orders and
    fault masks injected and the port loaded with JAX's initial state (before
    either trains)."""
    seed, p_fail = _fault_seed(0.5)[0], 0.5
    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=3, nb_proc=N_WORKERS,
              regime="data_parallel", seed=seed, failure_probability=p_fail,
              eval_batch_size=8)
    size = dict(source="synthetic", synthetic_size=192, seed=seed)
    test_size = dict(source="synthetic", synthetic_size=40, seed=seed)
    jeng = JaxEngine(JaxConfig(**kw), jax_load_split(True, **size),
                     jax_load_split(False, **test_size) if eval_inside else None)
    test_split = load_split(False, **test_size) if eval_inside else None
    eng = Engine(
        TrainConfig(**kw), load_split(True, **size), test_split, device="cpu",
        orders=lambda e, d: _jax_order(seed, e, d, 192 // N_WORKERS),
        masks=lambda e: np.asarray(jax_live_mask(epoch_key(seed, e), N_WORKERS, p_fail)),
    )
    eng.load_state_tree(jax.tree.map(np.asarray, jeng.state_tree()))
    return jeng, eng, test_split


@pytest.mark.parametrize("eval_inside", [True, False])
def test_fused_span_matches_jax_engine(n_devices, eval_inside):
    """`run_span(0, 3)` against the JAX Engine's fused span: per-epoch train
    loss (and val_loss) within 5e-4, val_acc within one test row, the live
    counts equal, and the final params within max-rel 2e-3."""
    jeng, eng, test_split = _span_engines(eval_inside)
    want = jeng.run_span(0, 3, eval_inside=eval_inside)
    got = eng.run_span(0, 3, eval_inside=eval_inside)
    assert [m.epoch for m in got] == [0, 1, 2]
    assert len({m.n_live for m in got}) > 1 or got[0].n_live < N_WORKERS
    for g, w in zip(got, want):
        assert g.n_live == w.n_live
        assert abs(g.train_loss - w.train_loss) < 5e-4
        if eval_inside:
            assert abs(g.val_loss - w.val_loss) < 5e-4
            assert abs(g.val_acc - w.val_acc) <= 100.0 / len(test_split) + 1e-9
        else:
            assert g.val_loss is None and w.val_loss is None
    rel = _max_rel_err(eng.state_tree()["params"], jax.tree.map(np.asarray, jeng.params))
    assert rel < 2e-3


def _quiet(*_):
    pass


class _SpikingGuard:
    """A guard whose observed loss at `epoch` is replaced once (the
    ChaosMonkey.perturb pattern), for the JAX guard or the port's."""

    def __init__(self, mod, policy, epoch, value):
        self.g = mod.TrainingGuard(mod.GuardConfig(policy=policy, warmup_steps=2),
                                   log=_quiet)
        self.epoch, self.value, self.fired = epoch, value, False

    def observe(self, epoch, loss, **kw):
        if epoch == self.epoch and not self.fired:
            self.fired = True
            loss = loss * self.value if self.value > 1 else self.value
        return self.g.observe(epoch, loss, **kw)

    def __getattr__(self, name):
        return getattr(self.g, name)


@pytest.mark.parametrize("policy,value", [("warn", 1.0), ("skip", float("nan")),
                                          ("rollback", 100.0)])
def test_engine_guard_matches_the_jax_engine(n_devices, policy, value):
    """`Engine.run(guard=...)` on the port and the JAX engine, the same
    orders, masks and initial state, the guard's observation of epoch 2
    replaced once (warn: nothing; skip: NaN, the epoch's update dropped;
    rollback: x100, the snapshot restored and the lr halved): the histories
    and final parameters within test_torch_engine.py's bounds; warn is
    bitwise the unguarded run."""
    from distributed_neural_network_tpu.train import guard as JG
    from distributed_neural_network_tpu_torch.train import guard as G

    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=4, nb_proc=N_WORKERS,
              regime="data_parallel", seed=1)
    size = dict(source="synthetic", synthetic_size=128, seed=1)
    jeng = JaxEngine(JaxConfig(**kw), jax_load_split(True, **size), None)
    state0 = jax.tree.map(np.asarray, jeng.state_tree())

    def port():
        eng = Engine(TrainConfig(**kw), load_split(True, **size), None, device="cpu",
                     orders=lambda e, d: _jax_order(1, e, d, 128 // N_WORKERS))
        eng.load_state_tree(state0)
        return eng

    jguard, guard = _SpikingGuard(JG, policy, 2, value), _SpikingGuard(G, policy, 2, value)
    want = jeng.run(log=_quiet, guard=jguard)
    eng = port()
    got = eng.run(log=_quiet, guard=guard)
    assert [m.epoch for m in got] == [m.epoch for m in want]
    for g, w in zip(got, want):
        assert abs(g.train_loss - w.train_loss) < 5e-4
    assert guard.summary() == jguard.summary()
    assert eng.config.lr == jeng.config.lr == (0.025 if policy == "rollback" else 0.05)
    rel = _max_rel_err(eng.state_tree()["params"], jax.tree.map(np.asarray, jeng.params))
    assert rel < 2e-3
    if policy == "warn":
        plain = port()
        assert plain.run(log=_quiet) == got
        assert all(torch.equal(a, b) for a, b in zip(plain.params + plain.mom,
                                                     eng.params + eng.mom))


def test_fused_span_equals_per_epoch_path():
    """On the CPU a 3-epoch span gives the bits of three `run_epoch` calls:
    params, momentum and every metric."""
    split = load_split(True, source="synthetic", synthetic_size=160, seed=2)
    test = load_split(False, source="synthetic", synthetic_size=30, seed=2)
    cfg = TrainConfig(nb_proc=4, lr=0.05, batch_size=16, epochs=3, seed=5,
                      failure_probability=0.4, reset_momentum=False, kernels="cuda")
    a, b = (Engine(cfg, split, test, device="cpu") for _ in range(2))
    per_epoch = [a.run_epoch(e) for e in range(3)]
    span = b.run_span(0, 3)
    assert per_epoch == span
    assert all(torch.equal(p, q) for p, q in zip(a.params + a.mom, b.params + b.mom))


@pytest.mark.parametrize("field,value", [("dynamics", True)])
def test_later_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="slice"):
        TrainConfig(**{field: value})


def test_step_sync_in_buckets_is_bitwise_the_one_buffer_sync():
    """sync_mode="step" with grad_sync="overlap" (a bucket cap that splits
    the head's leaves) against "end": the same history and parameters, bit
    for bit; a bad grad_sync or bucket_mb is refused."""
    split = load_split(True, source="synthetic", synthetic_size=128, seed=2)
    test = load_split(False, source="synthetic", synthetic_size=32, seed=2)
    runs = []
    for gs in ("end", "overlap"):
        cfg = TrainConfig(nb_proc=4, lr=0.05, batch_size=8, epochs=2, seed=5, sync_mode="step",
                          kernels="cuda", grad_sync=gs, bucket_mb=0.01)
        eng = Engine(cfg, split, test, device="cpu")
        runs.append(([eng.run_epoch(e) for e in range(2)], eng.params))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    for bad in ({"grad_sync": "later"}, {"bucket_mb": 0.0}):
        with pytest.raises(ValueError):
            TrainConfig(**bad)


def _bf16_ulp(a) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of `a`."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(a, np.float64)).max())) - 7)


@pytest.mark.parametrize("sync_mode", ["epoch", "step"])
@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_bf16_epoch_matches_jax_engine(n_devices, sync_mode, kernels):
    """One data_parallel epoch at `compute_dtype="bfloat16"` against the JAX
    Engine's (kernels torch ~ xla, cuda ~ pallas), from its initial params
    with its orders: train loss and val_loss within 5e-4 (both compute the
    loss in f32; a bf16 ulp at 2.3 is 0.0156), val_acc within one test row,
    and every parameter leaf within 2 bf16 ulps of its largest magnitude
    (the f32 parameters take steps computed from bf16 activations)."""
    seed = 1
    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=1, nb_proc=N_WORKERS,
              regime="data_parallel", sync_mode=sync_mode, seed=seed, eval_batch_size=8,
              compute_dtype="bfloat16")
    size = dict(source="synthetic", synthetic_size=256, seed=seed)
    test_size = dict(source="synthetic", synthetic_size=50, seed=seed)
    jeng = JaxEngine(JaxConfig(**kw, kernels="pallas" if kernels == "cuda" else "xla"),
                     jax_load_split(True, **size), jax_load_split(False, **test_size))
    test_split = load_split(False, **test_size)
    eng = Engine(TrainConfig(**kw, kernels=kernels), load_split(True, **size), test_split,
                 device="cpu", orders=lambda e, d: _jax_order(seed, e, d, 256 // N_WORKERS))
    eng.load_state_tree(jax.tree.map(np.asarray, jeng.state_tree()))
    want, got = jeng.run_epoch(0), eng.run_epoch(0)
    assert abs(got.train_loss - want.train_loss) < 5e-4
    assert abs(got.val_loss - want.val_loss) < 5e-4
    assert abs(got.val_acc - want.val_acc) <= 100.0 / len(test_split) + 1e-9
    params, jparams = eng.state_tree()["params"], jax.tree.map(np.asarray, jeng.params)
    for layer in params:
        for leaf, p in params[layer].items():
            want_p = jparams[layer][leaf]
            assert np.abs(p - want_p).max() <= 2 * _bf16_ulp(want_p), (layer, leaf)
