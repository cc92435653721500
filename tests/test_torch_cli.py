"""The port's command line (`train/cli.py`) on the CPU: a tiny synthetic run
writes the reference's two phase-log files and a parseable SUMMARY line; the
default device is CUDA and asking for it without a GPU fails cleanly; a flag
of a later slice raises NotImplementedError naming the slice, and the
checkpoint and telemetry flags run (the guard's: tests/test_torch_guard.py); `--fused` runs
multi-epoch spans with the JAX CLI's lines, and downgrades to the per-epoch
path under `--failure-duration` with the JAX message."""

import json
import os

import pytest
import torch

from distributed_neural_network_tpu_torch.train import cli

TINY = ["--synthetic-size", "96", "--epochs", "2", "--nb-proc", "2", "--lr", "0.05"]


@pytest.mark.parametrize("regime,extra", [
    ("data_parallel", ["--kernels", "cuda", "--failure-probability", "0.5", "--seed", "3"]),
    ("replication", ["--sync-mode", "step", "--no-momentum-reset"]),
    ("single", ["--eval-every", "2", "--eval-batch-size", "7"]),
    ("data_parallel", ["--input-mode", "stream", "--stream-prefetch", "0", "--kernels", "cuda"]),
    ("replication", ["--compute-dtype", "bfloat16", "--sync-mode", "step"]),
    ("data_parallel", ["--sync-mode", "step", "--grad-sync", "overlap", "--bucket-mb", "0.01",
                       "--kernels", "cuda"]),
])
def test_cpu_run_writes_logs_and_summary(tmp_path, regime, extra):
    lines = []
    jsonl = tmp_path / "m.jsonl"
    rc = cli.main(
        ["--device", "cpu", "--regime", regime, "--log-dir", str(tmp_path / "log"),
         "--metrics-jsonl", str(jsonl), *TINY, *extra],
        log=lines.append,
    )
    assert rc == 0
    for role, first in (("parent", "Eval data loading time: "),
                        ("children", "Train data loading time: ")):
        path = tmp_path / "log" / f"bs16_log_epochs2_proc2_{role}.txt"
        assert path.read_text().startswith(first)
    summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[len("SUMMARY "):])
    assert summary["regime"] == regime and summary["epochs"] == 2
    assert summary["device"] == "cpu" and summary["data_source"] == "synthetic"
    assert summary["final_val_acc"] is not None
    for flag, key in (("--input-mode", "input_mode"), ("--compute-dtype", "compute_dtype")):
        if flag in extra:
            assert summary[key] == extra[extra.index(flag) + 1]
    assert summary["rank"] == 0 and summary["world"] == 1
    assert lines.count("Starting epoch  1") == 1
    assert sum(l.startswith("Validation Accuracy") for l in lines) == (
        1 if "--eval-every" in extra else 2
    )
    assert any(l.startswith("Time spent on parent communication and param sync") for l in lines)
    series = [json.loads(l)["series"] for l in jsonl.read_text().splitlines()]
    assert series.count("train/loss") == 2 and "parameters" in series


def test_default_device_is_cuda_and_fails_cleanly_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([*TINY, "--log-dir", str(tmp_path)], log=lambda _: None)
    assert not os.listdir(tmp_path)  # nothing ran


@pytest.mark.parametrize("flags", [
    ["--metrics-port", "0"], ["--sharding", "auto"], ["--dynamics"], ["--neptune"],
])
def test_later_slice_flag_raises(flags):
    with pytest.raises(NotImplementedError, match="slice"):
        cli.main(["--device", "cpu", *TINY, *flags], log=lambda _: None)


@pytest.mark.parametrize("flag", ["--resume", "--checkpoint-dir", "--trace-out",
                                  "--step-stats"])
def test_checkpoint_and_telemetry_flags_run(tmp_path, flag):
    """The flags that raised until the checkpoint and tracing modules came
    run: --checkpoint-dir writes one checkpoint an epoch; --resume over an
    empty directory says so and trains from scratch (without the
    directory it is the JAX CLI's error); --trace-out writes a strict
    Chrome trace with the engine's spans; --step-stats prints the summary
    and streams step/* series."""
    ck, trace, jsonl = tmp_path / "ck", tmp_path / "t.json", tmp_path / "m.jsonl"
    extra = {"--resume": ["--checkpoint-dir", str(ck), "--resume"],
             "--checkpoint-dir": ["--checkpoint-dir", str(ck)],
             "--trace-out": ["--trace-out", str(trace)],
             "--step-stats": ["--step-stats", "--metrics-jsonl", str(jsonl)]}[flag]
    lines = []
    assert cli.main(["--device", "cpu", "--log-dir", str(tmp_path / "log"), *TINY, *extra],
                    log=lines.append) == 0
    assert any(l.startswith("GOODPUT ") for l in lines)
    if flag == "--resume":
        assert any(l.startswith("(WARNING: --resume found no checkpoint") for l in lines)
        with pytest.raises(SystemExit, match="--resume requires --checkpoint-dir"):
            cli.main(["--device", "cpu", *TINY, "--resume"], log=lambda _: None)
    if flag in ("--resume", "--checkpoint-dir"):
        assert sorted(os.listdir(ck)) == ["step_0", "step_1"]
        meta = json.loads((ck / "step_1" / "meta.json").read_text())
        assert meta["epoch"] == 1 and meta["n_workers"] == 2 and len(meta["history"]) == 2
    if flag == "--trace-out":
        doc = json.loads(trace.read_text())
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {"data_loading", "train_step", "sync", "eval"} <= names
        assert doc["stepStats"]["steps"] == 2 and doc["goodput"]["taxonomy"] == "train"
    if flag == "--step-stats":
        assert any(l.startswith("Step stats (2 steps") for l in lines)
        series = [json.loads(l)["series"] for l in jsonl.read_text().splitlines()]
        assert series.count("step/wall_s") == 2 and "step/images_per_s" in series


def test_quantized_precision_is_refused():
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", *TINY, "--precision", "int8"], log=lambda _: None)


@pytest.mark.parametrize("extra", [[], ["--eval-every", "2", "--epochs", "3"]])
def test_fused_runs_spans_with_the_jax_lines(tmp_path, extra):
    """`--fused` on the CPU: the JAX CLI's per-epoch lines, in the per-epoch
    path's values (a span gives the per-epoch path's bits), and TRAINING
    charged with the whole span."""
    runs = {}
    for fused in (False, True):
        lines = []
        rc = cli.main(["--device", "cpu", "--log-dir", str(tmp_path / str(fused)), *TINY,
                       *extra, *(["--fused"] if fused else [])], log=lines.append)
        assert rc == 0
        runs[fused] = lines
    epochs = 3 if extra else 2
    keep = ("Starting epoch", "Global Average Training Loss", "Validation")
    per_epoch, fused = ([l for l in runs[k] if l.startswith(keep)] for k in (False, True))
    assert fused == per_epoch
    assert sum(l.startswith("Starting epoch") for l in fused) == epochs
    assert sum(l.startswith("Validation Accuracy") for l in fused) == (1 if extra else 2)
    summary = json.loads(next(l for l in runs[True] if l.startswith("SUMMARY "))[8:])
    assert (summary["final_val_acc"] is None) == bool(extra)  # epoch 2 is no eval epoch
    comm = next(l for l in runs[True] if l.startswith("Time spent on parent communication"))
    assert float(comm.split(":")[1]) == 0.0


def test_fused_downgrades_under_failure_duration(tmp_path):
    lines = []
    rc = cli.main(["--device", "cpu", "--log-dir", str(tmp_path), *TINY, "--fused",
                   "--failure-probability", "1.0", "--failure-duration", "0.01"],
                  log=lines.append)
    assert rc == 0
    assert ("(fused mode does not support --failure-duration straggler sleeps; "
            "using the per-epoch path)") in lines
    assert any(l.startswith("Device 0 failed!") for l in lines)
    assert lines.count("Starting epoch  1") == 1


def test_say_writes_each_line_with_its_newline_at_once(monkeypatch):
    """Ranks under torchrun share one stdout: a line and its newline go out
    in one write, so no other rank's line lands inside it."""
    writes = []

    class Recorder:
        def write(self, s):
            writes.append(s)

        def flush(self):
            writes.append(None)

    monkeypatch.setattr(cli.sys, "stdout", Recorder())
    cli.say('SUMMARY {"rank": 1}')
    cli.say("Starting epoch  0")
    assert writes == ['SUMMARY {"rank": 1}\n', None, "Starting epoch  0\n", None]
