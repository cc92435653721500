"""The port's span tracing and StepStats (`utils/tracing.py`), its traced LM
step (`train/lm.py` `make_traced_step`) and the CNN engine's spans, against
the JAX package's on the CPU.

1. The tracer: the Chrome trace-event schema (the JAX document's keys,
   strict JSON, one track per phase), span nesting, the disabled no-op,
   non-finite args as null, the atomic export over a previous good trace,
   rank-stamped process metadata.
2. StepStats: the JAX summary and report on the same records (compile vs
   steady, throughput, MFU and its fallback notes, buckets); the `step/*`
   series into a sink; `param_bytes`, `collective_bytes_per_sync` and
   `overlapped_collective_bytes` equal JAX's on the same tree;
   `record_bucket_plan`; `rank_trace_path`; no device memory on the CPU.
3. `make_traced_step` around the port's LM step (one fenced span a step,
   the compile step first, the ledger fed), and the CNN CLI's trace read by
   tools/trace_summary.py (--goodput too) with rc 0.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.utils import tracing as jtr
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.train import cli
from distributed_neural_network_tpu_torch.train import lm as tlm
from distributed_neural_network_tpu_torch.utils import goodput as gp
from distributed_neural_network_tpu_torch.utils import tracing as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _strict(text):
    def reject(tok):
        raise ValueError(f"non-strict token {tok}")

    return json.loads(text, parse_constant=reject)


def _script(mod):
    t = mod.Tracer()
    t.set_process(rank=3, hostname="h")
    for i in range(3):
        with t.span(mod.TRAIN_STEP, track="train", step=i):
            with t.span(mod.SYNC, track="sync", step=i):
                pass
    t.instant("marker", track="train", note="hi")
    t.counter("mem", {"dev0": 123, "bad": float("inf")}, track="memory")
    t.complete("prefill", 0.5, 0.75, track="slot0", req_id=1)
    t.instant_at("preempt", 0.6, track="slot0")
    return t


def test_chrome_document_has_the_jax_schema(tmp_path):
    got, want = _script(tr).to_chrome(), _script(jtr).to_chrome()
    assert set(got) == set(want) and got["otherData"].keys() == want["otherData"].keys()
    assert got["otherData"]["rank"] == 3
    strip = ("ts", "dur", "pid")
    for a, b in zip(got["traceEvents"], want["traceEvents"]):
        assert {k: v for k, v in a.items() if k not in strip} == {
            k: v for k, v in b.items() if k not in strip}
    doc = _strict(open(_script(tr).export(str(tmp_path / "t.json"))).read())
    assert [e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "process_name"] == [
        "rank3"]
    mem = next(e for e in doc["traceEvents"] if e["name"] == "mem")
    assert mem["args"] == {"dev0": 123, "bad": None}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    syncs = [e for e in xs if e["name"] == "sync"]
    assert all(e["args"]["parent"] == "train_step" for e in syncs)


def test_disabled_tracer_is_a_no_op(tmp_path):
    t = tr.Tracer(enabled=False)
    with t.span("x", step=1) as s:
        pass
    assert s is tr.NULL_SPAN and s.dur_s == 0.0
    t.instant("i")
    t.counter("c", {"v": 1})
    t.complete("c", 0.0, 1.0)
    assert t.events() == [] and tr.NULL_TRACER.enabled is False
    doc = _strict(open(t.export(str(tmp_path / "e.json"))).read())
    assert [e for e in doc["traceEvents"] if e["ph"] == "X"] == []


def test_export_is_atomic_over_a_previous_good_trace(tmp_path, monkeypatch):
    path = str(tmp_path / "trace.json")
    t1 = tr.Tracer()
    with t1.span("train_step", track="train", step=0):
        pass
    t1.export(path)
    good = open(path).read()
    t2 = tr.Tracer()
    with t2.span("train_step", track="train", step=1):
        pass
    real = json.dump

    def dying_dump(doc, f, **kw):
        f.write(json.dumps(doc, **kw)[:40])
        raise KeyboardInterrupt("killed mid-export")

    monkeypatch.setattr(tr.json, "dump", dying_dump)
    with pytest.raises(KeyboardInterrupt):
        t2.export(path)
    monkeypatch.setattr(tr.json, "dump", real)
    assert open(path).read() == good and not os.path.exists(path + ".tmp")
    t2.export(path)
    assert [e["args"].get("step") for e in _strict(open(path).read())["traceEvents"]
            if e["ph"] == "X"] == [1]


STATS_CASES = {
    "compile-steady": (dict(item_label="images", n_devices=4, flops_per_step=8e12,
                            flops_source="analytic", peak_flops_per_device=1e12),
                       [(0, 2.0, 400, None), (1, 0.5, 400, None), (2, 0.25, 400, None)]),
    "one-step": (dict(item_label="tokens"), [(5, 1.0, 64, None)]),
    "no-peak": (dict(flops_per_step=1e9, flops_source="analytic", comm_bytes_per_step=4096,
                     grad_sync="overlap", comm_bucket_bytes=[1024, 3072]),
                [(0, 1.0, 8, False), (1, 1.0, 8, None)]),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_step_stats_summary_and_report_are_the_jax(case):
    kw, records = STATS_CASES[case]
    got, want = tr.StepStats(**kw), jtr.StepStats(**kw)
    for s in (got, want):
        for step, wall, items, is_compile in records:
            s.record(step, wall, items=items, is_compile=is_compile)
        s.count_anomaly("spike")
    assert got.summary() == want.summary() and got.report() == want.report()


def test_step_stats_stream_step_series_and_no_memory_on_the_cpu():
    rows = []

    class Sink:
        def append(self, series, value):
            rows.append((series, value))

    s = tr.StepStats(item_label="tokens", sink=Sink())
    s.record(0, 2.0, items=10)
    s.record(1, 0.5, items=10)
    assert rows == [("step/wall_s", 2.0), ("step/wall_s", 0.5), ("step/tokens_per_s", 20.0)]
    assert tr.device_memory_snapshot() is None and s.capture_memory(tr.Tracer()) is None


def test_payload_helpers_equal_the_jax_on_one_tree():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float64), np.zeros(7, np.int8)]}
    torch_tree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(x) for x in tree["b"]]}
    assert tr.param_bytes(tree) == tr.param_bytes(torch_tree) == jtr.param_bytes(tree) == 95
    for n in (1, 2, 8):
        for alg in ("ring", "naive"):
            assert (tr.collective_bytes_per_sync(torch_tree, n, alg)
                    == jtr.collective_bytes_per_sync(tree, n, alg))
            assert (tr.overlapped_collective_bytes([100, 28], n, 3, alg)
                    == jtr.overlapped_collective_bytes([100, 28], n, 3, alg))
    with pytest.raises(ValueError, match="unknown algorithm"):
        tr.collective_bytes_per_sync(tree, 2, "tree")
    assert tr.rank_trace_path("o/t.json", 2) == jtr.rank_trace_path("o/t.json", 2)
    assert tr.rank_trace_path("t", None) == "t" and tr.rank_trace_path("t", 1) == "t_rank1.json"


def test_detect_rank_reads_torchrun(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert tr.detect_rank() is None
    monkeypatch.setenv("RANK", "3")
    assert tr.detect_rank() == 3
    monkeypatch.setenv("RANK", "x")
    assert tr.detect_rank() is None


def test_record_bucket_plan_events_are_the_jax():
    got, want = tr.Tracer(), jtr.Tracer()
    for mod, t in ((tr, got), (jtr, want)):
        mod.record_bucket_plan(t, [10, 20], schedule="overlap", op="psum", axis_size=2,
                               accum_steps=4)
    assert [(e.name, e.args) for e in got.events()] == [(e.name, e.args) for e in want.events()]


@pytest.mark.parametrize("first_step", [0, 5], ids=["fresh", "resumed"])
def test_traced_lm_step_spans_stats_and_ledger(first_step):
    """make_traced_step around the port's step: one fenced train_step span a
    call, counted from first_step (a resumed run's), the first call the
    compile record, the process ledger's steps compile then steady, the
    same losses as the bare step."""
    cfg = tfm.TransformerConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    toks, tgts = tlm.make_copy_task(torch.Generator().manual_seed(0), batch=4, seq_len=16,
                                    vocab=32)
    runs = []
    gp.LEDGER.reset()
    try:
        for traced in (False, True):
            params = tfm.init_params(0, cfg)
            mom = tlm.init_lm_momentum(params)
            step = tlm.make_lm_train_step(cfg, lr=0.1)
            tracer, stats = tr.Tracer(), tr.StepStats(item_label="tokens")
            if traced:
                gp.LEDGER.start()
                step = tlm.make_traced_step(step, tracer=tracer, step_stats=stats,
                                            items_per_step=64, first_step=first_step)
            runs.append([float(step(params, mom, toks, tgts, i)) for i in range(3)])
        rec = gp.LEDGER.finalize()
    finally:
        gp.LEDGER.reset()
    assert runs[0] == runs[1]
    spans = [e for e in tracer.events() if e.name == "train_step"]
    assert [(e.args["step"], e.args["fenced"]) for e in spans] == [
        (first_step + k, True) for k in range(3)]
    assert [r.is_compile for r in stats.records] == [True, False, False]
    assert rec["steps"] == 3 and rec["goodput_steps"] == 2
    assert rec["tokens"] == 64.0 * 2


def test_cnn_trace_is_read_by_trace_summary(tmp_path):
    path = tmp_path / "trace.json"
    lines = []
    assert cli.main(["--device", "cpu", "--synthetic-size", "96", "--epochs", "2",
                     "--nb-proc", "2", "--log-dir", str(tmp_path / "log"), "--trace-out",
                     str(path), "--fused"], log=lines.append) == 0
    doc = _strict(path.read_text())
    spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans.count("train_span") == 1 and "data_loading" in spans
    assert doc["stepStats"]["flops_source"] == "analytic"
    for extra in ([], ["--goodput"]):
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                               str(path), *extra], capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
    assert "train_span" in proc.stdout or "goodput" in proc.stdout.lower()
