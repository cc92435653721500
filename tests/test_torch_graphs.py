"""The port's captured programs (`train/graphs.py`): launch accounting holds
on the eager path (the CPU) and across capture and replays (a recorded
stand-in for the CUDA graph here), and on the card a graphed engine equals
its own eager run bit for bit (marked `cuda`: skips without a GPU)."""

import gc
import weakref

import numpy as np
import pytest
import torch

from distributed_neural_network_tpu_torch.data.cifar10 import load_split
from distributed_neural_network_tpu_torch.models import cnn
from distributed_neural_network_tpu_torch.ops import fused_head as fh
from distributed_neural_network_tpu_torch.train import graphs
from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig


def _counting_program(counters, step):
    """A program that 'launches' kernel a twice and b once per run, and
    advances a step tensor."""

    def fn():
        counters["a"] += 2
        counters["b"] += 1
        step.add_(1)

    return graphs.Program(fn, counters=(counters,))


@pytest.mark.parametrize("times", [1, 3, 782])
def test_eager_calls_count_each_launch(times):
    counters, step = {"a": 0, "b": 0}, torch.zeros(1)
    prog = _counting_program(counters, step)
    prog(times)
    prog()
    assert counters == {"a": 2 * (times + 1), "b": times + 1}
    assert float(step) == times + 1


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: the capture runs the function once
    (its counter increments are what a real capture records) and a replay
    is only counted."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("k", [1, 5, 782])
def test_replays_add_the_captured_change_times_replays(monkeypatch, k):
    """counters after k replays = (change during the capture) x k; the
    capture itself leaves the counters as they were."""
    counters, step = {"a": 10, "b": 0}, torch.zeros(1)
    prog = _counting_program(counters, step)

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode="global"):
            self.graph = graph

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    prog.capture(stream=None)
    assert counters == {"a": 10, "b": 0}
    assert prog.delta == [{"a": 2, "b": 1}]
    prog(k)
    assert prog.graph.replays == k
    assert counters == {"a": 10 + 2 * k, "b": k}


def test_engine_programs_count_the_head_kernels_per_step(monkeypatch):
    """The engine's per-epoch formula on the CPU path, with the model's head
    routed through the kernel wrappers' autograd function and their calls
    counted: one forward and one backward per train step for all replicas,
    one forward per eval batch, no reduce at B 16 (one group)."""
    split = load_split(True, source="synthetic", synthetic_size=128, seed=0)
    test = load_split(False, source="synthetic", synthetic_size=40, seed=0)
    eng = Engine(TrainConfig(nb_proc=4, batch_size=16, kernels="cuda"), split, test,
                 device="cpu")
    calls = dict.fromkeys(fh.LAUNCHES, 0)

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name, fn in (("fused_mlp3_fwd", "mlp3_forward"), ("fused_mlp3_bwd", "mlp3_bwd_partials"),
                     ("fused_mlp3_bwd_reduce", "mlp3_bwd_reduce")):
        monkeypatch.setattr(fh, fn, counted(name, getattr(fh, fn)))

    def head(*args):
        if torch.is_grad_enabled():
            return fh._FusedMLP3.apply(*args)
        return fh.mlp3_forward(*args, residuals=False)[0]

    monkeypatch.setattr(cnn, "fused_mlp3", head)
    m = eng.run_epoch(0)
    steps, eval_steps = 128 // 4 // 16, -(-10 // 16)
    assert calls == {"fused_mlp3_fwd": steps + eval_steps, "fused_mlp3_bwd": steps,
                     "fused_mlp3_bwd_reduce": 0}
    assert np.isfinite(m.train_loss) and m.val_acc is not None


def test_dropped_engine_frees_its_programs_at_once():
    """An engine and its programs form no reference cycle: dropping the
    engine frees them (and on the card their graphs) without the garbage
    collector, which could otherwise run inside another capture and spoil
    it."""
    split = load_split(True, source="synthetic", synthetic_size=64, seed=0)
    test = load_split(False, source="synthetic", synthetic_size=20, seed=0)
    gc.disable()
    try:
        eng = Engine(TrainConfig(nb_proc=2), split, test, device="cpu")
        eng.run_epoch(0)
        eng.run_span(1, 1)
        refs = [weakref.ref(p) for p in eng._programs()] + [weakref.ref(eng)]
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the head kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_graphed_engine_equals_its_eager_run(cuda_device):
    """On the card: 2 epochs replayed from the captured programs give the
    bits of the same programs run eagerly (the engine's `_capture` hook)."""
    split = load_split(True, source="synthetic", synthetic_size=256, seed=1)
    test = load_split(False, source="synthetic", synthetic_size=64, seed=1)
    cfg = TrainConfig(nb_proc=4, lr=0.01, batch_size=16, kernels="cuda",
                      failure_probability=0.3)
    graphed, eager = (Engine(cfg, split, test, device=cuda_device) for _ in range(2))
    eager._capture = False
    got = [graphed.run_epoch(e) for e in range(2)]
    want = [eager.run_epoch(e) for e in range(2)]
    assert got == want
    assert graphed._step.graph is not None and eager._step.graph is None
    assert all(torch.equal(a, b) for a, b in zip(graphed.params, eager.params))
    assert np.isfinite(got[-1].train_loss)


def test_eager_part_runs_between_the_graphs(monkeypatch):
    """A program with an `Eager` part (a gloo collective) is captured as a
    graph before it and one after it; each call replays them with the eager
    part between, in order, and the counters still count replays x the
    captured change (the eager part counts for itself)."""
    order, counters = [], {"a": 0}

    def before():
        order.append("before")
        counters["a"] += 1

    def after():
        order.append("after")

    class RecordingGraph(_FakeGraph):
        def __init__(self):
            super().__init__()
            self.name = None

        def replay(self):
            super().replay()
            order.append(f"replay {self.name}")

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode="global"):
            self.graph = graph

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.graph.name = order[-1]  # the part the capture ran
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", RecordingGraph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    prog = graphs.Program(before, graphs.Eager(lambda: order.append("collective")), after,
                          counters=(counters,))
    prog.capture(stream=None)
    assert counters == {"a": 0} and prog.delta == [{"a": 1}] and len(prog.graphs) == 2
    order.clear()
    prog(2)
    assert order == ["replay before", "collective", "replay after"] * 2
    assert counters == {"a": 2}
    order.clear()
    prog.fn()  # one eager run of every part
    assert order == ["before", "collective", "after"]
