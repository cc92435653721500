"""The port's command line (`train/cli.py`) on the CPU: a tiny synthetic run
writes the reference's two phase-log files and a parseable SUMMARY line; the
default device is CUDA and asking for it without a GPU fails cleanly; a flag
of a later slice raises NotImplementedError naming the slice."""

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
    ["--fused"], ["--checkpoint-dir", "ckpt"], ["--guard", "skip"], ["--trace-out", "t.json"],
    ["--step-stats"], ["--metrics-port", "0"], ["--sharding", "auto"], ["--input-mode", "stream"],
    ["--grad-sync", "overlap"], ["--compute-dtype", "bfloat16"], ["--dynamics"], ["--neptune"],
])
def test_later_slice_flag_raises(flags):
    with pytest.raises(NotImplementedError, match="slice"):
        cli.main(["--device", "cpu", *TINY, *flags], log=lambda _: None)


def test_quantized_precision_is_refused():
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", *TINY, "--precision", "int8"], log=lambda _: None)
