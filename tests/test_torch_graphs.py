"""The port's captured programs (`train/graphs.py`): launch accounting holds
on the eager path (the CPU) and across capture and replays (a recorded
stand-in for the CUDA graph here), and on the card the graphed CNN engine,
serving engine and LM step and eval equal their own eager runs bit for bit
(marked `cuda`: skip without a GPU). This file imports no JAX, so its card
tests run on a machine with the card and no JAX package:
`python -m pytest tests/test_torch_graphs.py -m cuda`."""

import contextlib
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

from distributed_neural_network_tpu_torch.data.cifar10 import load_split
from distributed_neural_network_tpu_torch.models import cnn
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.ops import fused_head as fh
from distributed_neural_network_tpu_torch.ops.schedule import warmup_cosine
from distributed_neural_network_tpu_torch.serve import engine as peng
from distributed_neural_network_tpu_torch.train import graphs
from distributed_neural_network_tpu_torch.train import lm as tlm
from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

GEOM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)


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
        def __init__(self, graph, pool=None, stream=None, capture_error_mode="global"):
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


class _FakeStream:
    def wait_stream(self, other):
        pass


def _fake_capture(monkeypatch, fails):
    """CUDA capture stood in for on the CPU: streams and pools are inert, a
    capture runs its functions once, and it raises where `fails()` holds."""

    class Capture:
        def __init__(self, graph, pool=None, stream=None, capture_error_mode="global"):
            self.graph = graph

        def __enter__(self):
            if fails():
                raise RuntimeError("operation not permitted when stream is capturing")
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())


@pytest.mark.parametrize("at", ["warm-up", "capture"])
def test_capture_all_names_the_program_that_failed(monkeypatch, at):
    """A failure in the second of two programs, in its warm-up or its
    capture, raises naming that program."""
    state = torch.zeros(3)
    capturing = []

    def second():
        if at == "warm-up":
            raise ValueError("bad part")
        state.add_(1)

    first = graphs.Program(lambda: state.add_(1), name="the first")
    prog = graphs.Program(second, name="the second")
    orig = graphs.Program.capture

    def capture(self, stream, pool=None):
        capturing.append(self.name)
        return orig(self, stream, pool)

    monkeypatch.setattr(graphs.Program, "capture", capture)
    _fake_capture(monkeypatch, lambda: capturing[-1] == "the second")
    with pytest.raises(RuntimeError, match=f"{'warming up' if at == 'warm-up' else 'capturing'}"
                                           f" the second"):
        graphs.capture_all([first, prog], [state], torch.device("cpu"))
    if at == "capture":
        assert capturing == ["the first", "the second"]
        assert first.segments is not None and prog.segments is None


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_a_failed_bucket_capture_keeps_no_program(monkeypatch, kv_dtype):
    """A serving bucket whose capture fails raises naming it and is not
    kept: its next use captures again (and raises again), the program count
    does not grow, warmup() keeps none of its grid, and the pools are left
    as they were."""
    _fake_capture(monkeypatch, lambda: True)
    cfg = tfm.TransformerConfig(**GEOM)
    eng = peng.ServeEngine(tfm.init_params(0, cfg, "cpu"), cfg, peng.EngineConfig(
        max_batch=2, num_blocks=8, block_size=4, max_seq_len=16, prefill_chunk=4,
        kv_dtype=kv_dtype))
    eng._capture = True
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"the serving decode bucket \(2, 1\)"):
            eng._bucket("decode", (2, 1))
        assert eng.compiled_programs()["total"] == 0
    with pytest.raises(RuntimeError, match="capturing the serving"):
        eng.warmup()
    assert eng.compiled_programs()["total"] == 0
    assert all(not t.any() for t in eng._state())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_a_failed_step_capture_keeps_nothing(monkeypatch, optimizer):
    """An LM step or eval whose capture fails raises naming it and keeps no
    program: the next call captures again and raises again, the parameters
    and optimizer state (Adam's step count too) are left as they were."""
    _fake_capture(monkeypatch, lambda: True)
    cfg = tfm.TransformerConfig(**GEOM)
    params = tfm.init_params(0, cfg, "cpu")
    before = [t.clone() for t in tlm.tree_leaves(params)]
    mom = tlm.init_lm_momentum(params, optimizer)
    step = tlm.make_lm_train_step(cfg, optimizer=optimizer, lr=0.1)
    ev = tlm.make_eval_fn(cfg)
    step._capture = ev._capture = True
    toks = torch.from_numpy(np.random.default_rng(0).integers(2, 32, size=(2, 8)))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing the LM train step"):
            step(params, mom, toks, toks.roll(-1, 1))
        assert step.program is None
        with pytest.raises(RuntimeError, match="capturing the LM eval loss"):
            ev(params, toks, toks.roll(-1, 1))
        assert ev.program is None
    assert all(torch.equal(a, b) for a, b in zip(tlm.tree_leaves(params), before))
    if optimizer == "adam":
        assert mom["t"] == 0
        assert not any(t.any() for t in mom["m"] + mom["v"])
    else:
        assert not any(t.any() for t in mom)


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
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the port's kernels have no CPU mode")
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
        def __init__(self, graph, pool=None, stream=None, capture_error_mode="global"):
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


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 32, size=n).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_card_graphed_serving_engine_equals_its_eager_run(cuda_device, kv_dtype):
    """On the card: the same requests (one sampled) through a graphed
    serving engine warmed up to 2 blocks (wider buckets captured mid-run)
    and through the same engine run eagerly (`_capture` false): the same
    tokens and the same pools, bit for bit."""
    cfg = tfm.TransformerConfig(**GEOM, dtype=torch.bfloat16)
    params = tfm.init_params(0, cfg, cuda_device)
    runs = []
    for capture in (True, False):
        eng = peng.ServeEngine(params, cfg, peng.EngineConfig(
            max_batch=4, num_blocks=32, block_size=4, max_seq_len=32, prefill_chunk=4,
            kv_dtype=kv_dtype))
        eng._capture = capture
        eng.warmup(max_width_blocks=2)
        seqs = [peng.Sequence(i, _prompt(50 + i, n), 8, temperature=0.7 if i == 2 else 0.0)
                for i, n in enumerate((13, 5, 9, 3))]
        for s in seqs:
            eng.add(s)
        for _ in range(200):
            if not eng.has_work():
                break
            eng.step()
        assert not eng.has_work()
        built = [b.program.graph is not None for fam in eng._programs.values()
                 for b in fam.values()]
        assert all(built) if capture else not any(built)
        runs.append(([s.out for s in seqs], [t.clone() for t in eng._state()]))
    (got, got_state), (want, want_state) = runs
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))


LM_CASES = {
    "sgd-flash": {"attn_impl": "flash", "lr": 0.1},
    "adam-cosine-clip-wd-flash": {"optimizer": "adam", "lr": 0.01, "lr_schedule": "cosine",
                                  "clip_norm": 0.5, "weight_decay": 0.01, "attn_impl": "flash"},
    "accum2": {"accum_steps": 2, "lr": 0.1},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LM_CASES))
def test_card_graphed_lm_step_equals_its_eager_run(cuda_device, case):
    """On the card, bf16: three LM steps and two evals replayed from the
    captured programs give the bits of the same programs run eagerly."""
    kw = dict(LM_CASES[case])
    if kw.pop("lr_schedule", None):
        kw["lr_schedule"] = functools.partial(warmup_cosine, base_lr=kw["lr"], total_steps=3,
                                              warmup_steps=1, min_lr_frac=0.1)
    cfg = tfm.TransformerConfig(**GEOM, dtype=torch.bfloat16)
    g = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(g.integers(2, 32, size=(4, 16))).to(cuda_device)
        batches.append((toks, toks.roll(-1, 1)))
    runs = []
    for capture in (True, False):
        params = tfm.init_params(0, cfg, cuda_device)
        mom = tlm.init_lm_momentum(params, kw.get("optimizer", "sgd"))
        step = tlm.make_lm_train_step(cfg, **kw)
        ev = tlm.make_eval_fn(cfg, attn_impl=kw.get("attn_impl", "ring"))
        step._capture = ev._capture = capture
        losses = [step(params, mom, *b, i) for i, b in enumerate(batches)]
        evals = [ev(params, *b) for b in batches[:2]]
        assert (step.program.graph is not None) == capture
        assert (ev.program.graph is not None) == capture
        runs.append((torch.stack(losses + evals), tlm.tree_leaves(params)))
    (got, got_p), (want, want_p) = runs
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p))
