"""The pipeline through the port's LM entry point (`python -m
distributed_neural_network_tpu_torch.lm_train --pp N ...`) on the CPU at a
tiny width: --pp 2 as two torchrun gloo ranks (with --eval-every on a token
corpus and --generate, which the pipeline skips as the JAX CLI does), and
--dp 2 --pp 2 --pp-interleave 2 as four; every rank's SUMMARY line the
same, its mesh name and pp_bubble_frac those of the JAX CLI's own SUMMARY
line for the same flags (the JAX lm_train.py run in this process on the
virtual CPU devices); the JAX CLI's --pp errors with its own texts (zero with
experts among them); the port's batch check under --pp; --pp 2 --experts 2
as two ranks, as the JAX CLI's SUMMARY; the guard flags refused under --pp
with the JAX CLI's text (the pipeline has no health output).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_neural_network_tpu_torch import lm_train
from test_torch_lm_cli import _jax_cli_error, _port_error

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--steps", "3", "--batch-size", "8", "--seq-len", "16", "--vocab", "32",
        "--d-model", "32", "--n-heads", "4", "--n-layers", "4", "--d-ff", "64",
        "--log-every", "1", "--lr", "0.3"]
# name -> (ranks, the flags both CLIs take)
RUNS = {
    "pp2": (2, ["--pp", "2", "--microbatches", "2"]),
    # MoE under --pp: the experts replicated at dp 1
    "pp2-experts": (2, ["--pp", "2", "--microbatches", "2", "--experts", "2"]),
    "dp2pp2-v2": (4, ["--dp", "2", "--pp", "2", "--pp-interleave", "2", "--microbatches", "2"]),
}


def _torchrun(n, argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), "-m", "distributed_neural_network_tpu_torch.lm_train", "--device", "cpu"]
    return subprocess.run(cmd + argv, env=env, capture_output=True, text=True, timeout=150,
                          cwd=ROOT)


def _jax_cli_summary(monkeypatch, capsys, argv):
    """The JAX lm_train.py's SUMMARY line for `argv`, run in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_lm_train_cli",
                                                  os.path.join(ROOT, "lm_train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(sys, "argv", ["lm_train.py"] + argv)
    capsys.readouterr()
    cli.main()
    out = capsys.readouterr().out.splitlines()
    return json.loads(next(line for line in out if line.startswith("SUMMARY "))[8:])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp_cli") / "tokens.npy"
    np.save(path, np.random.default_rng(3).integers(0, 32, 1 << 14).astype(np.uint16))
    return str(path)


@pytest.mark.parametrize("name", list(RUNS))
def test_pp_under_torchrun_matches_the_jax_cli_summary(n_devices, monkeypatch, capsys, corpus,
                                                       name):
    n, flags = RUNS[name]
    extra = (["--data-path", corpus, "--eval-every", "2", "--eval-batches", "2", "--generate",
              "4"] if name == "pp2" else [])
    proc = _torchrun(n, ARGS + flags + extra)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    summaries = [line for line in lines if line.startswith("SUMMARY ")]
    assert len(summaries) == n and len(set(summaries)) == 1
    got = json.loads(summaries[0][8:])
    want = _jax_cli_summary(monkeypatch, capsys, ARGS + flags)
    assert tuple(got) == tuple(want)
    assert got["mesh"] == want["mesh"] and got["pp_bubble_frac"] == want["pp_bubble_frac"]
    assert got["final_loss"] < got["first_loss"]
    steps = [line for line in lines if line.startswith("step ") and " loss " in line]
    assert len(steps) == 3 * n and len(set(steps)) == 3
    for r in range(n):
        assert f"(Multi-process: rank {r}/{n}, backend gloo, device cpu)" in lines
    if name == "pp2":
        evals = [line for line in lines if line.startswith("step ") and "eval_loss" in line]
        assert len(evals) == n and len(set(evals)) == 1
        assert got["eval"] is not None and np.isfinite(got["eval"]["eval_loss"])
        skipped = "(--generate skipped: decode needs the non-pipeline param layout; rerun " \
                  "without --pp)"
        assert lines.count(skipped) == n and not any(line.startswith("gen[") for line in lines)
    programs = [line for line in lines if line.startswith("(step program: ")]
    assert len(programs) == n and all("eager" in line for line in programs)


# the JAX CLI's --pp checks, each with its port
PP_ERRORS = {
    "sharding rules": ["--pp", "2", "--sharding", "rules:r.json"],
    "ema": ["--pp", "2", "--ema-decay", "0.9"],
    "precision": ["--pp", "2", "--precision", "int8"],
    "sp": ["--pp", "2", "--sp", "2"],
    "zero with tp": ["--pp", "2", "--tp", "2", "--optimizer", "zero"],
    "zero with experts": ["--pp", "2", "--dp", "2", "--experts", "2", "--optimizer", "zero"],
}


@pytest.mark.parametrize("name", list(PP_ERRORS))
def test_pp_argument_errors_are_the_jax_cli_texts(n_devices, monkeypatch, capsys, name):
    args = ARGS + PP_ERRORS[name]
    want = _jax_cli_error(monkeypatch, capsys, args)
    assert _port_error(capsys, args) == want


def test_pp_batch_must_split_into_the_microbatches(capsys):
    err = _port_error(capsys, ARGS + ["--pp", "2", "--dp", "2", "--microbatches", "3"])
    assert "--dp x --accum-steps x --microbatches (2 x 1 x 3)" in err


@pytest.mark.parametrize("flags,match", [(["--guard", "warn"], "the pipeline path has no health "
                                                                "output yet")])
def test_pp_later_features_raise_naming_their_step(n_devices, monkeypatch, capsys, flags, match):
    args = ARGS + ["--pp", "2"] + flags
    want = _jax_cli_error(monkeypatch, capsys, args)
    assert _port_error(capsys, args) == want and match in want
