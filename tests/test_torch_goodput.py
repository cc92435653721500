"""The port's goodput ledger (`utils/goodput.py`, the training taxonomy and
the record functions) against the JAX package's, and the CNN entry point's
run record read by the JAX readers.

1. One scripted fake clock drives a port ledger and a JAX ledger through
   the same feeds (step spans, intervals, retroactive adds, fills, a
   rollback window, note_steps): the buckets are equal, and each sums to
   the wall clock.
2. The record functions give the JAX results on the same inputs:
   `breakdown_from_trace`, `fleet_goodput_record`, `extract_distributions`,
   `aggregate_records_dir`, `render_record`, `diff_records`, `check_record`,
   `record_causes`, `record_taxonomy`, `config_fingerprint`.
3. The CNN CLI's `--run-record` passes the JAX `validate_record` /
   `check_record`, and tools/goodput.py renders it with rc 0; its buckets
   sum to its wall clock within the ledger's own check.
"""

import json
import os
import subprocess
import sys

import pytest

from distributed_neural_network_tpu.utils import goodput as jgp
from distributed_neural_network_tpu_torch.train import cli
from distributed_neural_network_tpu_torch.utils import goodput as gp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_ledgers():
    gp.LEDGER.reset()
    yield
    gp.LEDGER.reset()


def _script(mod, kind):
    """A ledger of `mod` on a fake clock, fed the scenario `kind`; its
    final record (the clock at 20 s)."""
    clk = [0.0]
    led = mod.GoodputLedger(clock=lambda: clk[0])
    led.start(rank=0)
    if kind == "steps":
        for t, dur in ((2.0, 1.5), (3.0, 1.0), (4.0, 1.0), (6.5, 2.0)):
            clk[0] = t
            led.step_span(int(t), dur, tokens=10.0)
        with led.interval("checkpoint_save"):
            clk[0] = 8.0
        led.add("stall", 7.5, 9.0)  # the save (instrumented) wins the overlap
        clk[0] = 9.5
        led.add_ending_now("data_wait", 0.25)
    elif kind == "rollback":
        for t in (1.0, 2.0, 3.0):
            clk[0] = t
            led.step_span(int(t), 0.5)
        led.mark_recompute(2)
        for t in (4.0, 5.0, 6.0):
            clk[0] = t
            led.step_span(int(t), 0.5, tokens=4.0)
        led.add("reshard", 6.0, 6.5)
    elif kind == "fill":
        clk[0] = 1.0
        led.add("compile", 0.5, 1.0)
        with led.interval("checkpoint_save"):
            clk[0] = 3.0
        clk[0] = 10.0
        led.fill_ending_now("steady_step", 9.0)
        led.note_steps(7, tokens=70.0)
    clk[0] = 20.0
    return led.finalize(metrics={"k": 1})


@pytest.mark.parametrize("kind", ["steps", "rollback", "fill"])
def test_buckets_equal_the_jax_ledger_on_one_clock(kind):
    got, want = _script(gp, kind), _script(jgp, kind)
    assert got["badput_s"] == want["badput_s"] and got["goodput_s"] == want["goodput_s"]
    for key in ("steps", "goodput_steps", "tokens", "goodput_ratio", "taxonomy", "kind",
                "events", "metrics"):
        assert got[key] == want[key], key
    assert got["wall_s"] == pytest.approx(20.0)
    assert got["goodput_s"] + sum(got["badput_s"].values()) == pytest.approx(got["wall_s"],
                                                                             abs=1e-9)
    assert jgp.validate_record(got) is got and jgp.check_record(got, want) == []


def test_ledger_refuses_what_the_jax_ledger_refuses():
    led = gp.GoodputLedger(clock=lambda: 0.0).start()
    with pytest.raises(ValueError, match="idle_other is the computed residual"):
        led.add("idle_other", 0.0, 1.0)
    with pytest.raises(ValueError, match="step_span is the training ledger's feed"):
        gp.GoodputLedger(taxonomy="serve").start().step_span(0, 1.0)
    assert gp.TAXONOMIES.keys() == jgp.TAXONOMIES.keys() and gp.CAUSES == jgp.CAUSES
    assert gp.RECORD_VERSION == jgp.RECORD_VERSION and gp.RUN_RECORD_ENV == jgp.RUN_RECORD_ENV
    with gp.ledger_interval("checkpoint_save") as span:  # disarmed: the shared no-op
        assert span.dur_s == 0.0


def _records():
    return [_script(gp, k) for k in ("steps", "rollback", "fill")]


def _trace():
    us = 1_000_000
    evs = []
    for pid, name, t0, dur in ((0, "train_step", 2.0, 1.0), (0, "data_loading", 3.0, 0.5),
                               (0, "train_step", 3.5, 1.0), (0, "straggler", 4.25, 1.0),
                               (0, "checkpoint_save", 6.5, 0.5), (1, "train_step", 1.0, 2.0),
                               (1, "reshard", 3.0, 1.0)):
        evs.append({"name": name, "ph": "X", "ts": t0 * us, "dur": dur * us, "pid": pid,
                    "tid": 0, "args": {}})
    return {"traceEvents": evs}


RECORD_FUNCTIONS = {
    "breakdown_from_trace": lambda m, recs, tmp: m.breakdown_from_trace(_trace()),
    "fleet_goodput_record": lambda m, recs, tmp: m.fleet_goodput_record(
        recs, restart_gaps=[{"seconds": 2.0, "group_size": 1, "generation": 1}],
        restart_generations={1}),
    "extract_distributions": lambda m, recs, tmp: m.extract_distributions(recs),
    "aggregate_records_dir": lambda m, recs, tmp: m.aggregate_records_dir(str(tmp)),
    "render_record": lambda m, recs, tmp: m.render_record(recs[0], title="t"),
    "diff_records": lambda m, recs, tmp: m.diff_records(recs[0], recs[1]),
    "check_record": lambda m, recs, tmp: m.check_record(recs[0], recs[1]),
    "record_causes": lambda m, recs, tmp: [m.record_causes(r) for r in recs],
    "record_taxonomy": lambda m, recs, tmp: [m.record_taxonomy(r) for r in recs],
    "config_fingerprint": lambda m, recs, tmp: m.config_fingerprint({"b": [1, 2.5], "a": None}),
}


@pytest.mark.parametrize("name", list(RECORD_FUNCTIONS))
def test_record_functions_give_the_jax_results(tmp_path, name):
    recs = _records()
    for i, rec in enumerate(recs):
        with open(tmp_path / f"run_record_rank{i}.json", "w") as f:
            json.dump({**rec, "rank": i}, f)
    got, want = (RECORD_FUNCTIONS[name](m, recs, tmp_path) for m in (gp, jgp))
    if name in ("fleet_goodput_record", "aggregate_records_dir"):
        for doc in (got, want):
            doc.pop("written_unix", None)
            for r in doc.get("ranks", ()):
                r.pop("path", None)
    assert got == want


def test_cnn_run_record_passes_the_jax_readers(tmp_path):
    path = tmp_path / "run_record.json"
    lines = []
    assert cli.main(["--device", "cpu", "--synthetic-size", "96", "--epochs", "2",
                     "--nb-proc", "2", "--log-dir", str(tmp_path / "log"), "--run-record",
                     str(path), "--checkpoint-dir", str(tmp_path / "ck")],
                    log=lines.append) == 0
    rec = jgp.read_record(str(path))  # the JAX validate_record
    assert rec["final"] and rec["taxonomy"] == "train" and rec["kind"] == "rank"
    assert rec["steps"] == 2 and rec["badput_s"]["compile"] > 0
    assert rec["badput_s"]["checkpoint_save"] > 0 and rec["badput_s"]["init"] > 0
    total = rec["goodput_s"] + sum(rec["badput_s"].values())
    assert abs(total - rec["wall_s"]) <= max(1e-6 * max(rec["wall_s"], 1.0), 1e-9)
    assert jgp.check_record(rec, rec) == []
    goodput_line = json.loads(next(l for l in lines if l.startswith("GOODPUT "))[8:])
    assert goodput_line["record"] == str(path) and goodput_line["steps"] == 2
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "goodput.py"),
                           str(path)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "steady_step" in proc.stdout, proc.stderr
