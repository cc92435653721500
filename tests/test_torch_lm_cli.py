"""The port's LM trainer entry point (`python -m
distributed_neural_network_tpu_torch.lm_train`) on the CPU at a tiny width:
its step lines, its MFU-less CPU summary with the JAX CLI's SUMMARY keys
(read from the JAX script's source), the quantized route, the JAX CLI's
argument errors (those of the mesh's axes held to the JAX CLI's own text), a
NotImplementedError naming the slice for every flag of a later slice, the
checkpoint and telemetry flags running (the guard's and chaos flags:
tests/test_torch_guard.py), the monitor's flags (a live server over one
subprocess run with a stall, the escalation to a checkpoint that resumes
bitwise, the escalation's JAX argument error),
--experts training a mixture of experts, the
pipeline's and remat policy's flags in one process (--pp N outside a group
of N refused with the torchrun command), the data axis's flags in one
process (zero, overlap, sharding rules; --dp N
outside a group of N refused with the torchrun command), --dp 2 --tp 2 as
four torchrun ranks, and the flash launch formulas (the CPU runs each kernel's plain
version where the card launches the kernel, so counting the plain versions
counts the launches the card makes)."""

import ast
import json
import os
import time

import pytest
import torch

from distributed_neural_network_tpu_torch import lm_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--steps", "3", "--batch-size", "4", "--seq-len", "16",
        "--vocab", "32", "--d-model", "32", "--n-heads", "4", "--n-layers", "2",
        "--d-ff", "64", "--log-every", "1"]


def _jax_summary_keys():
    """The keys of the dict in the JAX lm_train.py's `"SUMMARY " + json.dumps({...})`."""
    tree = ast.parse(open(os.path.join(ROOT, "lm_train.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.BinOp) and isinstance(node.left, ast.Constant)
                and node.left.value == "SUMMARY "):
            return tuple(k.value for k in node.right.args[0].keys)
    raise AssertionError("no SUMMARY line in lm_train.py")


def _run(args):
    lines = []
    assert lm_train.main(args, log=lines.append) == 0
    return lines


def test_cpu_run_prints_steps_and_the_jax_summary_keys():
    lines = _run(TINY + ["--attn", "flash", "--generate", "4"])
    steps = [line for line in lines if line.startswith("step ")]
    assert [line.split()[1] for line in steps] == ["0", "1", "2"]
    summary = json.loads(next(line for line in lines if line.startswith("SUMMARY "))[8:])
    assert tuple(summary) == _jax_summary_keys() == lm_train.SUMMARY_KEYS
    assert summary["mesh"] == "single" and summary["mfu_pct"] is None  # no CPU peak
    assert summary["final_loss"] < summary["first_loss"]
    assert sum(line.startswith("gen[") for line in lines) == 2


@pytest.mark.parametrize("extra", [
    ["--attn", "flash", "--precision", "int8"],
    ["--attn", "flash", "--precision", "fp8", "--remat-attn"],
    ["--attn", "zigzag", "--optimizer", "adam", "--lr-schedule", "cosine", "--warmup-steps",
     "1", "--clip-norm", "1.0", "--weight-decay", "0.01", "--accum-steps", "2", "--remat",
     "--loss-chunks", "4", "--ema-decay", "0.9"],
])
def test_routes_run(extra):
    summary = json.loads(_run(TINY + extra)[-1][8:])
    assert summary["final_loss"] == summary["final_loss"]  # finite, not NaN


def test_data_path_eval_and_ema(tmp_path):
    corpus = tmp_path / "c.npy"
    import numpy as np

    np.save(corpus, np.random.default_rng(0).integers(0, 32, size=3000).astype(np.int32))
    lines = _run(TINY + ["--data-path", str(corpus), "--eval-every", "2", "--eval-batches",
                         "2", "--ema-decay", "0.5"])
    summary = json.loads(lines[-1][8:])
    assert summary["data_source"] == "npy" and summary["eval"]["step"] == 1


# extra flags -> (quantized forward, recomputed in backward, accum steps,
# eval passes); 4 steps of 2 layers, eval passes of 2 batches
FORMULAS = {
    "--attn flash": (False, False, 1, 0),
    "--attn flash --remat": (False, True, 1, 0),
    "--attn flash --remat-attn": (False, True, 1, 0),
    "--attn flash --accum-steps 2": (False, False, 2, 0),
    "--attn flash --eval-every 2": (False, False, 1, 2),
    "--attn flash --precision int8 --remat-attn --eval-every 2": (True, True, 1, 2),
    "--attn flash --precision fp8 --accum-steps 2 --remat": (True, True, 2, 0),
}


@pytest.mark.parametrize("flags", list(FORMULAS) + ["--attn ring", "--attn ring --remat"])
def test_flash_launch_formulas(flags, tmp_path, monkeypatch):
    import numpy as np

    from distributed_neural_network_tpu_torch.ops import flash_attention as fa

    counts = dict.fromkeys(fa.LAUNCHES, 0)
    for fn, key in (("flash_fwd_plain", "flash_fwd"), ("flash_fwd_quant_plain", "flash_fwd_quant"),
                    ("flash_dq_plain", "flash_dq"), ("flash_dkv_plain", "flash_dkv")):
        def counted(*a, _fn=getattr(fa, fn), _key=key, **k):
            counts[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(fa, fn, counted)
    corpus = tmp_path / "c.npy"
    np.save(corpus, np.random.default_rng(0).integers(0, 32, size=3000).astype(np.int32))
    steps, layers, batches = 4, 2, 2
    _run(TINY + flags.split() + ["--steps", str(steps), "--data-path", str(corpus),
                                 "--eval-batches", str(batches)])
    quant, remat, accum, evals = FORMULAS.get(flags, (False, False, 1, None))
    if evals is None:  # the plain route launches nothing
        assert counts == dict.fromkeys(fa.LAUNCHES, 0)
        return
    fwd = layers * (steps * accum * (2 if remat else 1) + evals * batches)
    bwd = layers * steps * accum
    assert counts == {"flash_fwd": 0 if quant else fwd, "flash_fwd_quant": fwd if quant else 0,
                      "flash_dq": bwd, "flash_dkv": bwd}


LATER = {
    "--sharding auto": "item 6", "--dynamics-jsonl d.jsonl": "slice 4",
    "--dynamics": "slice 4",
}


@pytest.mark.parametrize("flags", list(LATER))
def test_later_slice_flags_raise_naming_the_slice(flags):
    with pytest.raises(NotImplementedError, match=LATER[flags]):
        lm_train.main(TINY + flags.split(), log=lambda line: None)


@pytest.mark.parametrize("flags", ["--checkpoint-dir ck", "--resume", "--trace-out t.json",
                                   "--metrics-jsonl m.jsonl", "--run-record r.json",
                                   "--step-stats"])
def test_checkpoint_and_telemetry_flags_run(tmp_path, flags):
    """The flags that raised until the checkpoint and tracing modules came
    run: --checkpoint-dir saves at the end (step 2, the JAX meta keys);
    --resume continues from it (without the directory, the JAX CLI's
    error); --trace-out writes a strict trace of one train_step span a
    step; --metrics-jsonl the train/loss series; --run-record the goodput
    record; --step-stats the summary."""
    import subprocess
    import sys

    flag, *value = flags.split()
    path = str(tmp_path / value[0]) if value else None
    ck = str(tmp_path / "ck")
    args = {"--resume": ["--checkpoint-dir", ck], "--step-stats": ["--step-stats"]}.get(
        flag, [flag, path])
    lines = _run(TINY + args)
    assert any(line.startswith("GOODPUT ") for line in lines)
    summary = json.loads(next(line for line in lines if line.startswith("SUMMARY "))[8:])
    if flag in ("--checkpoint-dir", "--resume"):
        with open(os.path.join(ck, "step_2", "meta.json")) as f:
            meta = json.load(f)
        assert {"mesh", "optimizer", "mom_format", "loss", "pp_interleave", "mesh_meta",
                "cursor"} <= set(meta) and meta["cursor"]["step"] == 2
    if flag == "--resume":
        with pytest.raises(SystemExit):
            lm_train.main(TINY + ["--resume"], log=lambda line: None)
        more = _run(TINY + ["--checkpoint-dir", ck, "--resume"])
        assert "(Resumed from step 2; continuing at 3)" in more
        again = json.loads(next(line for line in more if line.startswith("SUMMARY "))[8:])
        assert again["start_step"] == 3 and again["last_step"] == 5
    if flag == "--trace-out":
        with open(path) as f:
            doc = json.load(f)
        steps = [e["args"]["step"] for e in doc["traceEvents"] if e["name"] == "train_step"]
        assert steps == [0, 1, 2] and doc["stepStats"]["compile_steps"] == 1
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                               path], capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
    if flag == "--metrics-jsonl":
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        loss = [r["value"] for r in rows if r["series"] == "train/loss"]
        assert len(loss) == 3 and loss[0] == summary["first_loss"]
        assert loss[-1] == summary["final_loss"]
    if flag == "--run-record":
        with open(path) as f:
            rec = json.load(f)
        # the bare path counts the steady steps (the first is the compile window)
        assert rec["final"] and rec["taxonomy"] == "train" and rec["steps"] == 2
        assert rec["badput_s"]["compile"] > 0 and rec["goodput_s"] > 0
        assert rec["goodput_s"] + sum(rec["badput_s"].values()) == pytest.approx(rec["wall_s"])
    if flag == "--step-stats":
        assert any(line.startswith("Step stats (3 steps") for line in lines)


def _read_until(proc, prefix, lines, timeout=120):
    """Lines of `proc`'s stdout until one starts with `prefix` (returned)."""
    import select

    deadline = time.time() + timeout
    while time.time() < deadline:
        if select.select([proc.stdout], [], [], 1.0)[0]:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.rstrip("\n"))
            if line.startswith(prefix):
                return line
    raise AssertionError(f"no {prefix!r} line in {lines[-20:]}")


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def test_live_monitor_serves_flags_a_stall_and_writes_the_fleet_files(tmp_path):
    """The monitor flags in one subprocess run, as the JAX CLI test
    (`tests/test_cli.py` `test_lm_train_chaos_stall_is_flagged_by_watchdog`):
    --metrics-port 0 serves Prometheus text whose train_steps_total
    advances, /healthz ready; /profile?steps=2 writes a torch.profiler
    trace under --profile-dir; --chaos-stall-step with --watchdog on (8 s
    against the default 5 s floor) counts watchdog_stall_total and puts a
    watchdog/stall instant in --trace-out; --metrics-linger keeps the server
    up for the final scrape; DNN_TPU_HEARTBEAT_FILE gets the last step and
    the rank key, DNN_TPU_FLIGHT_FILE the run's events from run_start to
    run_end."""
    import subprocess
    import sys

    from distributed_neural_network_tpu_torch.utils.obs import parse_prom_samples

    trace, prof = tmp_path / "t.json", tmp_path / "prof"
    env = dict(os.environ, DNN_TPU_HEARTBEAT_FILE=str(tmp_path / "hb.json"),
               DNN_TPU_FLIGHT_FILE=str(tmp_path / "fl.json"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-u", "-m", "distributed_neural_network_tpu_torch.lm_train",
           *TINY, "--steps", "30", "--log-every", "10", "--metrics-port", "0",
           "--metrics-linger", "20", "--watchdog", "on", "--profile-dir", str(prof),
           "--trace-out", str(trace), "--chaos-stall-step", "15", "--chaos-stall-seconds", "8"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    lines = []
    try:
        line = _read_until(proc, "(metrics server: ", lines)
        url = line.split()[2].rsplit("/metrics", 1)[0]
        first = parse_prom_samples(_get(url + "/metrics"))
        _read_until(proc, "(watchdog: STALL - no step heartbeat for", lines)
        # armed during the stall: the capture takes the two steps after it
        assert json.loads(_get(url + "/profile?steps=2"))["ok"]
        _read_until(proc, "(metrics server lingering 20s", lines)
        body = _get(url + "/metrics")
        health = json.loads(_get(url + "/healthz"))
        hb_path, deadline = tmp_path / "hb.json", time.time() + 10
        while json.loads(hb_path.read_text())["step"] != 29 and time.time() < deadline:
            time.sleep(0.1)  # the writer's next tick (every 0.5 s)
        proc.kill()  # in the linger's sleep; the files are written through
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.stderr.close()
    last = parse_prom_samples(body)
    assert last["train_steps_total"][()] == 30 > first.get("train_steps_total", {}).get((), 0)
    assert last["watchdog_stall_total"][()] >= 1 and last["train_ready"][()] == 1
    assert health["ready"] and health["step"] == 29
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"watchdog/stall", "straggler", "train_step"} <= names
    captured = [d for d in os.listdir(prof) if d.startswith("profile_step")]
    assert captured == ["profile_step16_x2"]  # started at the first beat after the stall
    assert json.loads((prof / captured[0] / "trace.json").read_text())["traceEvents"]
    hb = json.loads((tmp_path / "hb.json").read_text())
    assert hb["step"] == 29 and "rank" in hb and hb["metrics_url"] == url
    kinds = [e["kind"] for e in json.loads((tmp_path / "fl.json").read_text())["events"]]
    assert kinds[0] == "run_start" and kinds[-2:] == ["goodput_final", "run_end"]
    assert {"chaos", "watchdog_stall", "profile_capture"} <= set(kinds)


def test_watchdog_escalation_stops_at_a_checkpoint_that_resumes_bitwise(tmp_path, monkeypatch):
    """--watchdog-escalate preempt (the watchdog at poll 0.05 s, its
    threshold clamped to [0.2, 0.5] s): a 2 s stall after step 3 is flagged
    and escalated while it lasts, the run stops after step 4 (the
    flag is agreed at the next launch) with an emergency checkpoint, and
    the resume from it is bitwise the uninterrupted run."""
    import functools

    from distributed_neural_network_tpu_torch.train import monitor as MON

    # the threshold clamped to [0.2, 0.5] s: the CPU's step times vary
    # under load, and the flag and its escalation must land well inside the
    # stall
    monkeypatch.setattr(MON, "WatchdogConfig", functools.partial(
        MON.WatchdogConfig, poll_interval_s=0.05, min_stall_s=0.2, max_stall_s=0.5))
    base = TINY + ["--steps", "8", "--optimizer", "adam"]
    ck = str(tmp_path / "ck")
    whole, stopped, resumed = {}, {}, {}
    assert lm_train.main(base, log=lambda line: None, result=whole) == 0
    lines = []
    assert lm_train.main(base + ["--metrics-port", "0", "--watchdog-escalate", "preempt",
                                 "--chaos-stall-step", "3", "--chaos-stall-seconds", "2",
                                 "--checkpoint-dir", ck], log=lines.append,
                         result=stopped) == 0
    assert any(l.startswith("(watchdog: stall persists - requesting") for l in lines)
    assert "(emergency checkpoint at step 4; resume with --resume to continue bit-exactly)" \
        in lines
    summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
    assert summary["preempted"] and summary["last_step"] == 4
    assert lm_train.main(base + ["--checkpoint-dir", ck, "--resume", "--stop-at-step", "8"],
                         log=lambda line: None,
                         result=resumed) == 0
    assert stopped["losses"] + resumed["losses"] == whole["losses"]
    assert resumed["mom"]["t"] == whole["mom"]["t"] == 8
    for a, b in zip(lm_train.lmtrain.tree_leaves(resumed["params"]),
                    lm_train.lmtrain.tree_leaves(whole["params"])):
        assert torch.equal(a, b)


def test_escalation_needs_the_preemption_path(monkeypatch, capsys):
    args = [a for a in TINY if a not in ("--device", "cpu")] + [
        "--watchdog-escalate", "preempt", "--on-sigterm", "ignore"]
    want = _jax_cli_error(monkeypatch, capsys, args)
    assert want.startswith("--watchdog-escalate preempt rides the cooperative")
    assert _port_error(capsys, args) == want


def test_experts_flag_trains():
    """--experts 4 trains a mixture of 4 experts: the log line names them,
    the loss is finite and the MFU's FLOPs count the top-2 experts
    (train/measure.py)."""
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.train.measure import model_flops_per_token

    lines = _run(TINY + ["--experts", "4", "--attn", "flash", "--generate", "2"])
    assert any("experts=4, optimizer=sgd" in line for line in lines)
    summary = json.loads(lines[-1][8:])
    assert summary["final_loss"] == summary["final_loss"]
    assert sum(line.startswith("gen[") for line in lines) == 2
    kw = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    dense = model_flops_per_token(tfm.TransformerConfig(**kw), 16)
    moe = model_flops_per_token(tfm.TransformerConfig(**kw, n_experts=4), 16)
    assert moe - dense == 3.0 * 2 * 4 * 32 * 64  # one more expert's MLP a layer


@pytest.mark.parametrize("flags", ["--microbatches 4", "--pp-interleave 2",
                                   "--remat --remat-policy dots_saveable"])
def test_pipeline_and_remat_policy_flags_run_in_one_process(flags):
    """Flags that raised before the pipeline axis and the remat policies
    were ported: at --pp 1 the schedule flags are unused (as in the JAX
    CLI), and a remat policy trains (tests/test_torch_remat.py holds its
    numbers)."""
    lines = _run(TINY + flags.split())
    summary = json.loads(next(line for line in lines if line.startswith("SUMMARY "))[8:])
    assert summary["pp_bubble_frac"] is None and summary["mesh"] == "single"


def test_pp_outside_a_group_names_the_torchrun_command():
    with pytest.raises(ValueError, match="torch.distributed.run --standalone --nproc-per-node 2"):
        lm_train.main(TINY + ["--pp", "2"], log=lambda line: None)


@pytest.mark.parametrize("extra", [
    ["--optimizer", "zero"], ["--optimizer", "zero-adam", "--lr", "0.01"],
    ["--grad-sync", "overlap", "--accum-steps", "2", "--bucket-mb", "0.001"],
    ["--grad-sync", "overlap", "--accum-steps", "2", "--optimizer", "zero"],
    ["--sharding", "manual"], ["--sharding", "rules"],
])
def test_data_axis_flags_run_in_one_process(tmp_path, extra):
    """At dp 1 the zero optimizers hold one shard (bitwise sgd / adam), the
    overlap schedule has nothing to sum over, and a rules file in the JAX
    format drives the specs."""
    if extra == ["--sharding", "rules"]:
        from distributed_neural_network_tpu_torch.parallel import rules as R

        path = R.save_rules(R.lm_partition_rules(), str(tmp_path / "rules.json"))
        extra = ["--sharding", f"rules:{path}"]
    lines = _run(TINY + extra)
    summary = json.loads(lines[-1][8:])
    assert summary["mesh"] == "single" and summary["final_loss"] < summary["first_loss"]


def test_dp_outside_a_group_of_its_size_is_refused():
    with pytest.raises(ValueError, match="torch.distributed.run --standalone --nproc-per-node 2"):
        lm_train.main(TINY + ["--dp", "2"], log=lambda line: None)


def test_argument_errors_match_the_jax_cli(capsys):
    with pytest.raises(SystemExit):
        lm_train.main(TINY + ["--precision", "int8-kv"])
    assert lm_train.INT8_KV_MESSAGE in capsys.readouterr().err
    for bad in (["--loss-chunks", "3"], ["--eval-every", "2"], ["--gen-top-k", "5"],
                ["--steps", "0"], ["--bucket-mb", "0"], ["--sharding", "bogus"],
                ["--sharding", "rules:"], ["--dp", "3"], ["--accum-steps", "3"]):
        with pytest.raises(SystemExit):
            lm_train.main(TINY + bad)


def test_default_device_without_cuda_fails_cleanly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        lm_train.main(args, log=lambda line: None)


def _jax_cli_error(monkeypatch, capsys, argv):
    """The text the JAX lm_train.py exits with for `argv` (argparse's
    "error: ..." line, or a SystemExit's message)."""
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location("jax_lm_train_cli",
                                                  os.path.join(ROOT, "lm_train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(sys, "argv", ["lm_train.py"] + argv)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        cli.main()
    return e.value.code if isinstance(e.value.code, str) else (
        capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])


def _port_error(capsys, argv):
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        lm_train.main(["--device", "cpu"] + argv, log=lambda line: None)
    return e.value.code if isinstance(e.value.code, str) else (
        capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])


# the JAX CLI's checks of --elastic and the in-process shrink (lm_train.py),
# each with its port
SHRINK = ["--chaos-shrink-at-step", "1", "--checkpoint-dir", "ck"]
ELASTIC_ERRORS = {
    "elastic without a resume": ["--elastic"],
    "shrink under pp": ["--dp", "2", "--pp", "2", *SHRINK],
    "shrink without a checkpoint dir": ["--dp", "2", "--chaos-shrink-at-step", "1"],
    "shrink without the preemption path": ["--dp", "2", *SHRINK, "--on-sigterm", "ignore"],
    "shrink with eval": ["--dp", "2", *SHRINK, "--eval-every", "2", "--data-path", "c.npy"],
    "shrink to dp": ["--dp", "2", *SHRINK, "--chaos-shrink-to", "2"],
    "shrink to 0": ["--dp", "2", *SHRINK, "--chaos-shrink-to", "0"],
    "shrink at dp 1": SHRINK,
    "batch over the shrunk dp": ["--dp", "4", *SHRINK, "--chaos-shrink-to", "3"],
}


@pytest.mark.parametrize("name", list(ELASTIC_ERRORS))
def test_elastic_argument_errors_are_the_jax_cli_texts(monkeypatch, capsys, name):
    """The flags that raised until elastic resume was ported refuse what the
    JAX CLI refuses, with its text (before any process group is joined)."""
    args = [a for a in TINY if a not in ("--device", "cpu")] + ELASTIC_ERRORS[name]
    want = _jax_cli_error(monkeypatch, capsys, args)
    assert "--chaos-shrink" in want or "--elastic" in want
    assert _port_error(capsys, args) == want


def test_shrink_to_defaults_to_half_the_data_axis():
    args = lm_train.build_parser().parse_args(TINY + ["--dp", "4", *SHRINK])
    lm_train.validate(lm_train.build_parser(), args)
    assert args.chaos_shrink_to == 2


# the JAX CLI's checks of the mesh's axes (lm_train.py), each with its port
MESH_ERRORS = {
    "n-heads % tp": ["--tp", "3"],
    "loss chunks per shard": ["--sp", "2", "--loss-chunks", "16"],
    "zigzag seq % 2sp": ["--sp", "3", "--attn", "zigzag", "--seq-len", "20"],
    "flash with sp": ["--sp", "2", "--attn", "flash"],
    "precision with sp": ["--sp", "2", "--precision", "int8"],
}


@pytest.mark.parametrize("name", list(MESH_ERRORS))
def test_mesh_argument_errors_are_the_jax_cli_texts(n_devices, monkeypatch, capsys, name):
    args = [a for a in TINY if a not in ("--device", "cpu")] + MESH_ERRORS[name]
    want = _jax_cli_error(monkeypatch, capsys, args)
    assert _port_error(capsys, args) == want


def test_dp2_tp2_under_torchrun(tmp_path):
    """--dp 2 --tp 2 as four gloo ranks on the CPU: every rank's SUMMARY
    line the same, mesh data2xmodel2, the loss falling; the log line names
    the collectives' form."""
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "distributed_neural_network_tpu_torch.lm_train", "--device", "cpu",
           "--dp", "2", "--tp", "2", "--attn", "flash", "--steps", "3", "--batch-size", "8",
           "--seq-len", "16", "--vocab", "32", "--d-model", "32", "--n-heads", "4",
           "--n-layers", "2", "--d-ff", "64", "--log-every", "1", "--lr", "0.3"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=150, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    summaries = [line for line in lines if line.startswith("SUMMARY ")]
    assert len(summaries) == 4 and len(set(summaries)) == 1
    summary = json.loads(summaries[0][8:])
    assert summary["mesh"] == "data2xmodel2" and summary["final_loss"] < summary["first_loss"]
    for r in range(4):
        assert f"(Multi-process: rank {r}/4, backend gloo, device cpu)" in lines
    logs = [line for line in lines if line.startswith("(LM ")]
    assert len(logs) == 4 and all("mesh data2xmodel2" in line and "collectives gloo:" in line
                                  for line in logs)
