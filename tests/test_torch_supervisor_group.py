"""A real group of the port's LM workers under the port's supervisor, on the
CPU: two gloo ranks of `lm_train` at a tiny width, launched, watched and
restarted by `train/supervisor.py` (the JAX package's
`tests/test_multiprocess.py` supervisor cases, here in tier-1).

- a SIGKILL of rank 1 after step 3: the group shrinks to one rank (rank 0
  collateral: its collective failed, it exits 0), and generation 1 resumes
  the newest checkpoint at dp 1 with ``--elastic``; its losses within 1e-3
  of an uninterrupted dp-2 run's;
- a SIGTERM of rank 1: it writes the emergency checkpoint and exits
  PREEMPT_RC, rank 0 (stopped for its peer) exits 0, and generation 1
  resumes at the step after the emergency checkpoint: no step lost;
- the peer-loss rule of `lm_train.py` shown directly, without a supervisor
  process: a supervised rank whose peer dies ends with exit 0, one line,
  a ``peer_lost`` flight event and a final run record; without
  ``DNN_TPU_SUPERVISOR`` the same death is the traceback it always was.

Every rank runs with OMP_NUM_THREADS=1. The chaos lands during a host
stall after step 3 (``--chaos-stall-step``), after that step's checkpoint,
so the resume step does not depend on the machine's speed.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time

import pytest

from distributed_neural_network_tpu_torch.parallel.fault import KillEvent, ProcessChaos
from distributed_neural_network_tpu_torch.train.supervisor import (
    PREEMPT_RC,
    Supervisor,
    SupervisorConfig,
    read_heartbeat,
    reserve_port,
)
from distributed_neural_network_tpu_torch.utils.goodput import read_record
from distributed_neural_network_tpu_torch.utils.obs import read_flight_dump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, KILL_AT, LOSS_TOL = 6, 3, 1e-3
TINY = ["--device", "cpu", "--steps", str(STEPS), "--stop-at-step", str(STEPS),
        "--batch-size", "8", "--seq-len", "16", "--vocab", "32", "--d-model", "32",
        "--n-heads", "4", "--n-layers", "2", "--d-ff", "64", "--log-every", "1"]
STALL = ["--chaos-stall-step", str(KILL_AT), "--chaos-stall-seconds", "2"]
ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}


def _worker(d, extra=()):
    """The supervised worker command, its checkpoints and loss series in `d`."""
    return [sys.executable, "-m", "distributed_neural_network_tpu_torch.lm_train", *TINY,
            "--dp", "{devices}", "--checkpoint-every", "2", "--checkpoint-dir",
            str(d / "ck"), "--resume", "--elastic",
            "--metrics-jsonl", str(d / "m_n{nprocs}.jsonl"), *extra]


def _supervise(d, chaos=None, extra=()):
    logs = []
    sup = Supervisor(_worker(d, extra),
                     SupervisorConfig(nprocs=2, poll_s=0.05, restart_backoff_s=0.1,
                                      failure_settle_s=0.3, rendezvous_timeout_s=180.0),
                     run_dir=str(d / "run"), chaos=chaos, base_env={**os.environ, **ENV},
                     log=logs.append)
    rc = sup.run()
    summary = json.loads(next(l for l in logs if l.startswith("SUPERVISOR_SUMMARY "))[19:])
    return rc, summary, logs, sup


def _losses(path) -> list:
    with open(path) as f:
        rows = [json.loads(l) for l in f]
    return [r["value"] for r in rows if r.get("series") == "train/loss"]


def _log(d, gen, rank) -> str:
    with open(d / "run" / "logs" / f"gen{gen}_rank{rank}.log") as f:
        return f.read()


def _close(a, b, what):
    assert len(a) == len(b), f"{what}: {a} against {b}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert math.isfinite(x) and abs(x - y) <= LOSS_TOL * max(abs(x), abs(y)), (
            f"{what}: loss {i}: {x} against {y}")


_CACHE = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted dp-2 run (its losses) and each chaos run, once per
    module: name -> (rc, summary, logs, supervisor, dir)."""
    def get(name):
        if name not in _CACHE:
            d = tmp_path_factory.mktemp(name)
            if name == "whole":
                rc, summary, logs, sup = _supervise(d)
                assert rc == 0 and summary["generations"] == 1, logs
                _CACHE[name] = _losses(d / "m_n2.jsonl")
            else:
                sig = {"kill": "KILL", "term": "TERM"}[name]
                chaos = ProcessChaos(events=(KillEvent(rank=1, at_step=KILL_AT, sig=sig),))
                _CACHE[name] = (*_supervise(d, chaos, STALL), d)
        return _CACHE[name]

    return get


def test_sigkill_shrinks_the_group_and_resumes_elastic(runs):
    whole = runs("whole")
    assert len(whole) == STEPS
    rc, summary, logs, sup, d = runs("kill")
    assert rc == 0, "\n".join(logs)
    assert summary["exit"] == "ok" and summary["final_size"] == 1
    assert summary["generations"] == 2 and summary["restarts"] == 1
    # rank 0 is collateral: its collective failed, it ended with exit 0
    assert summary["worker_failures"] == [{"gen": 0, "rank": 1, "cause": "SIGKILL"}]
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    rc0 = {w["rank"]: w["returncode"] for w in pm["workers"]}
    assert rc0 == {0: 0, 1: -signal.SIGKILL}, rc0
    assert pm["workers"][1]["flight"] is not None and pm["workers"][1]["heartbeat"]["step"] >= 3
    assert f"(peer lost after step {KILL_AT}:" in _log(d, 0, 0)
    # generation 1: the newest periodic checkpoint (step 3) onto dp 1
    gen1 = _log(d, 1, 0)
    assert f"(Resumed from step {KILL_AT}; continuing at {KILL_AT + 1})" in gen1
    assert "(elastic: mesh axis 'data': saved 2, target 1)" in gen1
    assert "(elastic: accum-steps 1 -> 2" in gen1
    before, after = _losses(d / "m_n2.jsonl"), _losses(d / "m_n1.jsonl")
    assert before == whole[:KILL_AT + 1]
    _close(after, whole[KILL_AT + 1:], "generation 1")
    # the fleet record reads back with a restart gap
    fleet = read_record(str(d / "run" / "run_record.json"))
    assert fleet["kind"] == "fleet" and fleet["badput_s"]["restart_gap"] > 0


def test_sigterm_preempts_one_rank_and_loses_no_step(runs):
    whole = runs("whole")
    rc, summary, logs, sup, d = runs("term")
    assert rc == 0, "\n".join(logs)
    assert summary["worker_failures"] == [{"gen": 0, "rank": 1, "cause": "preempt"}]
    assert summary["final_size"] == 1 and summary["generations"] == 2
    with open(sup.postmortem_path) as f:
        pm = json.load(f)
    assert {w["rank"]: w["returncode"] for w in pm["workers"]} == {0: 0, 1: PREEMPT_RC}
    # both ranks stopped after the same step at one emergency checkpoint
    stop = KILL_AT + 1
    for r in (0, 1):
        assert f"(emergency checkpoint at step {stop};" in _log(d, 0, r)
    assert f"(Resumed from step {stop}; continuing at {stop + 1})" in _log(d, 1, 0)
    before, after = _losses(d / "m_n2.jsonl"), _losses(d / "m_n1.jsonl")
    assert len(before) + len(after) == STEPS  # every step once
    assert before == whole[:stop + 1]
    _close(after, whole[stop + 1:], "generation 1")


def _direct(d, supervised: bool):
    """Two ranks of the worker started by hand with torchrun's variables and
    a supervisor's files (and ``DNN_TPU_SUPERVISOR`` when `supervised`);
    rank 1 SIGKILLed during the stall after step KILL_AT. Returns rank 0's
    (exit code, output) and its file paths."""
    port = reserve_port()
    procs, files = [], {}
    for rank in range(2):
        f = {k: str(d / f"{k}{rank}.json") for k in ("hb", "flight", "record")}
        env = {**os.environ, **ENV, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": "2", "DNN_TPU_HEARTBEAT_FILE": f["hb"],
               "DNN_TPU_FLIGHT_FILE": f["flight"], "DNN_TPU_RUN_RECORD": f["record"]}
        env.pop("DNN_TPU_SUPERVISOR", None)
        if supervised:
            env["DNN_TPU_SUPERVISOR"] = "1"
        argv = [a.replace("{devices}", "2") for a in _worker(d / f"r{rank}", STALL)]
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        files[rank] = f
    try:
        deadline = time.monotonic() + 180
        while (read_heartbeat(files[1]["hb"]) or {}).get("step") != KILL_AT:
            assert time.monotonic() < deadline and procs[1].poll() is None
            time.sleep(0.05)
        procs[1].kill()
        out, _ = procs[0].communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return procs[0].returncode, out, files[0]


@pytest.mark.parametrize("supervised", [True, False], ids=["supervised", "plain"])
def test_a_rank_whose_peer_died_ends_as_collateral(tmp_path, supervised):
    rc, out, f = _direct(tmp_path, supervised)
    if not supervised:
        # nothing changes without a supervisor: the collective's error
        assert rc not in (0, PREEMPT_RC) and "Traceback" in out, out[-2000:]
        assert "(peer lost" not in out
        return
    assert rc == 0, out[-3000:]
    assert "Traceback" not in out
    lines = [l for l in out.splitlines() if l.startswith("(peer lost")]
    assert len(lines) == 1 and lines[0].startswith(f"(peer lost after step {KILL_AT}:"), lines
    events = [e for e in read_flight_dump(f["flight"])["events"] if e["kind"] == "peer_lost"]
    assert [e["step"] for e in events] == [KILL_AT]
    rec = read_record(f["record"])
    assert rec["final"] is True and rec["metrics"]["peer_lost"] is True
    assert rec["metrics"]["last_step"] == KILL_AT
