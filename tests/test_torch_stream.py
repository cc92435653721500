"""Host streaming in the port (`data/stream.py`, `Engine(input_mode="stream")`)
against the JAX package's: `HostStream` yields the JAX stream's batches for
the same (seed, epoch, worker) seed, uint8 and float32, shuffled and in
order, the last batch padded; `prefetch` as the JAX tests hold it (order,
overlap, a producer's exception, tuple items); one stream epoch of the
port's engine against the JAX engine's stream epoch (the tolerance of
tests/test_torch_engine.py `test_one_epoch_matches_jax_engine`: loss and
val_loss 5e-4, val_acc one test row, params max-rel 2e-3); on the CPU the
stream engine gives the bits of the hbm engine fed the stream's orders, and
of itself without prefetch; `--fused` with streaming runs per epoch and
says so."""

import threading

import jax
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.data.cifar10 import load_split as jax_load_split
from distributed_neural_network_tpu.data.stream import HostStream as JaxHostStream
from distributed_neural_network_tpu.train.engine import Engine as JaxEngine
from distributed_neural_network_tpu.train.engine import TrainConfig as JaxConfig
from distributed_neural_network_tpu_torch.data.cifar10 import load_split
from distributed_neural_network_tpu_torch.data.stream import HostStream, prefetch
from distributed_neural_network_tpu_torch.train import cli
from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

N_WORKERS = 4


def _split(n=23, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
    return x, rng.integers(0, 10, size=n).astype(np.int32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_equal_the_jax_stream(dtype, shuffle):
    """Two epochs of (seed 5, epoch 1, worker 2) at 23 rows, batch 8: three
    batches each, the last padded with row 0 at weight 0."""
    x, y = _split()
    if dtype == "float32":
        x = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    seed = (5, 1, 2)
    port, ref = HostStream(x, y, 8, seed=seed), JaxHostStream(x, y, 8, seed=seed)
    assert port.steps == ref.steps == 3
    for _ in range(2):
        got, want = list(port.epoch(shuffle=shuffle)), list(ref.epoch(shuffle=shuffle))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        weights = np.concatenate([w for _, _, w in got])
        assert weights.sum() == 23 and (weights[23:] == 0).all()
    with pytest.raises(TypeError, match="uint8"):
        HostStream(x.astype(np.int64), y, 8)
    with pytest.raises(ValueError, match="images vs"):
        HostStream(x, y[:-1], 8)


def test_prefetch_yields_all_items_in_order():
    assert list(prefetch(iter(range(100)), depth=2)) == list(range(100))


def test_prefetch_overlaps_producer_with_consumer():
    """With depth 2 the producer makes item t+1 while the consumer still
    holds item t (an event, not a wall clock: the JAX test's timing bound)."""
    made = [threading.Event() for _ in range(4)]

    def gen():
        for i in range(4):
            made[i].set()
            yield i

    for i in prefetch(gen(), depth=2):
        if i + 1 < 4:
            assert made[i + 1].wait(timeout=10.0), f"item {i + 1} not made while {i} is held"


def test_prefetch_propagates_producer_exception():
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_handles_tuple_items():
    items = [(np.ones(3), np.zeros(2), np.ones(1)) for _ in range(5)]
    out = list(prefetch(iter(items), depth=2))
    assert len(out) == 5
    np.testing.assert_array_equal(out[3][0], np.ones(3))


def _max_rel_err(a, b):
    return max(
        float(np.max(np.abs(np.asarray(x) - y) / (np.abs(y) + 1e-3)))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.mark.parametrize("sync_mode", ["epoch", "step"])
def test_one_stream_epoch_matches_jax_engine(n_devices, sync_mode):
    """Both engines shuffle each worker's rows with numpy's (seed, epoch,
    worker) stream, so no order is injected; the port starts from the JAX
    engine's initial state."""
    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=1, nb_proc=N_WORKERS,
              regime="data_parallel", sync_mode=sync_mode, seed=2, eval_batch_size=8,
              input_mode="stream")
    size = dict(source="synthetic", synthetic_size=200, seed=2, normalize_images=False)
    test_size = dict(source="synthetic", synthetic_size=50, seed=2)
    jeng = JaxEngine(JaxConfig(**kw), jax_load_split(True, **size),
                     jax_load_split(False, **test_size))
    test_split = load_split(False, **test_size)
    eng = Engine(TrainConfig(**kw), load_split(True, **size), test_split, device="cpu")
    assert eng.train_images is None  # nothing of the train split on the device
    eng.load_state_tree(jax.tree.map(np.asarray, jeng.state_tree()))
    want, got = jeng.run_epoch(0), eng.run_epoch(0)
    assert got.n_live == want.n_live == N_WORKERS
    assert abs(got.train_loss - want.train_loss) < 5e-4
    assert abs(got.val_loss - want.val_loss) < 5e-4
    assert abs(got.val_acc - want.val_acc) <= 100.0 / len(test_split) + 1e-9
    rel = _max_rel_err(eng.state_tree()["params"], jax.tree.map(np.asarray, jeng.params))
    assert rel < 2e-3


@pytest.mark.parametrize("regime", ["data_parallel", "replication"])
def test_stream_engine_equals_hbm_engine_fed_its_orders(regime):
    """The stream's batches are the hbm plan's rows for the stream's orders
    (`default_order` in stream mode), normalized by the same native kernel:
    two epochs give the same bits, and again without prefetch."""
    kw = dict(lr=0.05, batch_size=8, epochs=2, nb_proc=2, regime=regime, seed=4,
              kernels="cuda", failure_probability=0.4)
    raw = load_split(True, source="synthetic", synthetic_size=52, seed=1, normalize_images=False)
    norm = load_split(True, source="synthetic", synthetic_size=52, seed=1)
    test = load_split(False, source="synthetic", synthetic_size=20, seed=1)
    streams = [Engine(TrainConfig(**kw, input_mode="stream", stream_prefetch=depth), raw, test,
                      device="cpu") for depth in (2, 0)]
    hbm = Engine(TrainConfig(**kw), norm, test, device="cpu",
                 orders=streams[0].default_order)
    runs = [[e.run_epoch(i) for i in range(2)] for e in (*streams, hbm)]
    assert runs[0] == runs[1] == runs[2]
    for e in streams[1:] + [hbm]:
        assert all(torch.equal(a, b) for a, b in zip(streams[0].params + streams[0].mom,
                                                      e.params + e.mom))
    with pytest.raises(ValueError, match="HBM"):
        streams[0].run_span(2, 1)
    with pytest.raises(ValueError, match="orders"):
        Engine(TrainConfig(**kw, input_mode="stream"), raw, test, device="cpu",
               orders=hbm.default_order)


def test_fused_with_stream_runs_per_epoch(tmp_path):
    lines = []
    rc = cli.main(["--device", "cpu", "--log-dir", str(tmp_path), "--synthetic-size", "96",
                   "--epochs", "2", "--nb-proc", "2", "--lr", "0.05", "--input-mode", "stream",
                   "--stream-prefetch", "1", "--fused"], log=lines.append)
    assert rc == 0
    assert ("(fused mode needs HBM-resident data; input_mode=stream uses the per-epoch "
            "path)") in lines
    assert lines.count("Starting epoch  1") == 1
    assert sum(l.startswith("Validation Accuracy") for l in lines) == 2
    comm = next(l for l in lines if l.startswith("Time spent on parent communication"))
    assert float(comm.split(":")[1]) > 0.0  # the per-epoch path times the sync on its own
