#!/usr/bin/env python3
"""The elastic supervisor on the card: the port's launcher (``python -m
distributed_neural_network_tpu_torch.launch``) runs WORLD ranks of the LM
entry point at chip_smoke.py's flagship width (LM_ARGS, --attn flash),

    lm_train --dp {devices} --steps 6 --stop-at-step 6 --checkpoint-every 2
             --resume --elastic --checkpoint-dir CK --metrics-jsonl OUT/m_n{nprocs}.jsonl

kills one rank once its heartbeat reaches step KILL_AT (``--chaos-kill-*``)
and restarts the survivors, which reshard the newest checkpoint onto the
smaller mesh; each run is held to the uninterrupted run of the same flags.

    python3 port_probes/supervisor_world.py 4      # from the repo root; four cards

WORLD 4 needs four cards (a rank a card, NCCL) and runs the flagship at
global batch 48, so that dp 4 and dp 3 both divide it: one launch of 4 ranks
runs the uninterrupted run (``whole``), then the launcher runs 4 supervised
ranks and SIGKILLs rank 3 at step KILL_AT. The survivors wait on the card in
a collective with the dead rank, where no Python handler runs, so the
supervisor's SIGTERM does nothing and its SIGKILL after the grace window
ends them (collateral); generation 1 resumes at dp 3, one CUDA graph a step
over NCCL. `chip_smoke.py` phase 33 runs the same flow on the one card with
2 ranks over gloo (a crash and a preemption), its uninterrupted run in phase
21's launch of the ranks (`make_spec`).

What a run gives (`supervise`, `read_run`, `check`): the launcher's exit
code and SUPERVISOR_SUMMARY; each generation's logs, run records, loss
series (`--metrics-jsonl`) and, for the ranks that return from
`lm_train.main`, their flash launch counts (the ranks run this file's
`worker`, which calls the entry point's `cli()` and then writes the
counters); postmortem.json and the fleet run_record.json; the launcher's
output lines with the time each arrived (the restart's timeline and the
grace window); whether the launcher process ever mapped the CUDA driver or
opened a ``/dev/nvidia*`` file (``/proc/PID/maps`` and ``/proc/PID/fd``: it
must hold no CUDA context; the workers, which do, are the control); and the
card's compute
processes (``nvidia-smi --query-compute-apps``) before, during and after
the run (none of the workers may be left).

Prints the cards' names and power limits first; exits 1 if a check fails.
Its flow dry-runs on the CPU at a tiny width: `run_whole(world, out,
lm_args)`, `supervise(world, out2, lm_args, sig=..., kill_rank=...)` and
`check(...)` with ``--device cpu`` in `lm_args` and env
``{"OMP_NUM_THREADS": "1"}``.
"""

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "port_probes")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

STEPS, KILL_AT, EVERY = 6, 3, 2
LOSS_TOL = 1e-3
GRACE_S = 10.0  # the launcher's default SIGTERM -> SIGKILL window
FLASH = ["--attn", "flash"]


def worker_args(lm_args, out: str, ck: str) -> list:
    """The supervised worker's lm_train arguments (the tokens substituted by
    the supervisor at every launch)."""
    return [*lm_args, *FLASH, "--dp", "{devices}", "--steps", str(STEPS), "--stop-at-step",
            str(STEPS), "--log-every", "1", "--checkpoint-every", str(EVERY),
            "--checkpoint-dir", ck, "--resume", "--elastic",
            "--metrics-jsonl", os.path.join(out, "m_n{nprocs}.jsonl")]


def worker_main(argv) -> int:
    """``supervisor_world.py worker OUT -- <lm_train arguments>``: the entry
    point's `cli()` on those arguments; when it returns, this rank's flash
    launch counters go to OUT/launches_gen{g}_rank{r}.json (a rank that a
    supervised ending exits from inside `lm_train.main` writes none)."""
    out, args = argv[0], argv[2:]
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa

    sys.argv = ["lm_train", *args]
    rc = lm_train.cli()
    name = (f"launches_gen{os.environ.get('DNN_TPU_SUPERVISOR_GEN', 0)}_rank"
            f"{os.environ.get('RANK', 0)}.json")
    with open(os.path.join(out, name), "w") as f:
        json.dump({"launches": dict(fa.LAUNCHES), "routes": dict(fa.ROUTE_LAUNCHES)}, f)
    return rc


# ------------------------------------------------ the uninterrupted run


def rank_main(spec: dict) -> int:
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel.distributed import initialize

    initialize(device=spec["device"], log=lambda line: None)
    try:
        rank_runs(spec, dist.get_rank())
    finally:
        gc.collect()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def make_spec(out: str, lm_args, world: int, *, device="cuda") -> dict:
    """The ranks' spec of the uninterrupted run (``whole``) of the supervised
    flags at dp `world`, its checkpoints and record under `out`."""
    os.makedirs(out, exist_ok=True)
    return {"device": device, "out": out, "lm_args": list(lm_args), "world": world}


def rank_runs(spec: dict, rank: int) -> dict:
    """This rank's ``whole`` run through `lm_train.main` in the process group
    it has joined; writes ``rank{r}.json`` under the spec's ``out`` (also in
    another probe's ranks: `torch_rank_worker.run_then`)."""
    from distributed_neural_network_tpu_torch import lm_train

    from elastic_world import _step_ms

    from distributed_neural_network_tpu_torch.utils.tracing import rank_trace_path

    out, world = spec["out"], str(spec["world"])
    trace = os.path.join(out, "whole_trace.json")
    args = [a.replace("{devices}", world).replace("{nprocs}", world) for a in worker_args(
        spec["lm_args"], os.path.join(out, "whole_m"), os.path.join(out, "whole_ck"))]
    res, info = {}, {"rank": rank}
    try:
        lm_train.main(args + ["--trace-out", trace], log=lambda line: None, result=res)
        info["losses"] = res["losses"]
        info["segments"] = res["step"].segments
        # each step's fenced span, the checkpoint saves outside it
        info["step_ms"] = _step_ms(rank_trace_path(trace, rank) if world != "1" else trace)
    finally:
        shutil.rmtree(os.path.join(out, "whole_ck"), ignore_errors=True)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    return info


def read_ranks(world: int, out: str) -> list:
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def run_whole(world: int, out: str, lm_args, *, device="cuda", timeout=600, env=None) -> dict:
    """One launch of `world` ranks (tests/torch_rank_worker.py `launch`) over
    the uninterrupted run: rank 0's record (its losses, every rank's equal,
    and ms per step from its trace)."""
    from torch_rank_worker import launch

    procs = launch(world, make_spec(out, lm_args, world, device=device), timeout=timeout,
                   env=env, script=os.path.abspath(__file__))
    for r, p in enumerate(procs):
        if p.returncode:
            raise RuntimeError(f"whole: rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
    ranks = read_ranks(world, out)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks), "whole: the ranks differ"
    return ranks[0]


# ------------------------------------------------------ the supervised run


def compute_apps() -> list | None:
    """The pids `nvidia-smi --query-compute-apps` lists (None without one)."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if p.returncode:
        return None
    return sorted(int(x) for x in p.stdout.split() if x.strip().isdigit())


def cuda_held(pid: int) -> dict:
    """What of the CUDA driver process `pid` holds: "libcuda" (the driver
    library mapped, ``/proc/PID/maps``) and "device" (a ``/dev/nvidia*``
    file open, ``/proc/PID/fd``: the driver's initialization opens them, a
    context needs them)."""
    out = {"libcuda": False, "device": False}
    try:
        with open(f"/proc/{pid}/maps") as f:
            out["libcuda"] = "libcuda.so" in f.read()
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                    out["device"] = True
                    break
            except OSError:
                continue
    except OSError:
        pass
    return out


def _worker_pids(out: str) -> set:
    """The worker pids the heartbeat files under `out` name so far."""
    hb = os.path.join(out, "run", "hb")
    pids = set()
    for name in os.listdir(hb) if os.path.isdir(hb) else ():
        doc = _read_json(os.path.join(hb, name))
        if doc and doc.get("pid"):
            pids.add(int(doc["pid"]))
    return pids


def supervise(world: int, out: str, lm_args, *, sig: str, kill_rank: int, grace=GRACE_S,
              timeout=600, env=None) -> dict:
    """Run the launcher over `world` supervised ranks, SIG to `kill_rank` at
    step KILL_AT; its exit code, timed output lines, the card's compute
    processes before / during / after and whether it mapped the CUDA driver
    (module docs), then `read_run`'s files. The checkpoints go to OUT/ck."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    ck = os.path.join(out, "ck")
    cmd = [sys.executable, "-m", "distributed_neural_network_tpu_torch.launch", "--nprocs",
           str(world), "--run-dir", os.path.join(out, "run"), "--grace", f"{grace:g}",
           "--chaos-kill-rank", str(kill_rank), "--chaos-kill-at-step", str(KILL_AT),
           "--chaos-kill-signal", sig, "--", sys.executable, os.path.abspath(__file__),
           "worker", out, "--", *worker_args(lm_args, out, ck)]
    e = dict(os.environ, **(env or {}))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "DNN_TPU_SUPERVISOR"):
        e.pop(k, None)
    before = compute_apps()
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((round(time.monotonic() - t0, 3), line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    during, last_smi = [], 0.0
    launcher = {"libcuda": False, "device": False}
    workers = {"libcuda": False, "device": False}
    try:
        while proc.poll() is None:
            if time.monotonic() - t0 > timeout:
                raise RuntimeError(f"the launcher ran past {timeout} s")
            for k, v in cuda_held(proc.pid).items():
                launcher[k] |= v
            for pid in _worker_pids(out):
                for k, v in cuda_held(pid).items():
                    workers[k] |= v
            if time.monotonic() - last_smi > 3.0:
                last_smi = time.monotonic()
                during.append(compute_apps())
            time.sleep(0.25)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        reader.join(timeout=30)
    run = {"rc": proc.returncode, "seconds": round(time.monotonic() - t0, 3),
           "lines": lines, "launcher_pid": proc.pid, "launcher_cuda": launcher,
           "workers_cuda": workers,
           "apps_before": before, "apps_during": during, "apps_after": compute_apps(),
           "world": world, "sig": sig, "kill_rank": kill_rank}
    run.update(read_run(out))
    shutil.rmtree(ck, ignore_errors=True)
    return run


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _losses(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r["value"] for r in map(json.loads, f) if r.get("series") == "train/loss"]


def read_run(out: str) -> dict:
    """The files of a supervised run under `out`: per (generation, rank) its
    log, run record and launch counts; per generation rank 0's losses;
    postmortem.json and run_record.json."""
    run_dir = os.path.join(out, "run")
    gens = {}
    for name in sorted(os.listdir(os.path.join(run_dir, "logs"))):
        m = re.fullmatch(r"gen(\d+)_rank(\d+)\.log", name)
        if not m:
            continue
        g, r = int(m[1]), int(m[2])
        with open(os.path.join(run_dir, "logs", name), errors="replace") as f:
            log = f.read()
        gens.setdefault(g, {})[r] = {
            "log": log,
            "record": _read_json(os.path.join(run_dir, "records", f"gen{g}_rank{r}.json")),
            "launches": _read_json(os.path.join(out, f"launches_gen{g}_rank{r}.json")),
        }
    for g, ranks in gens.items():
        n = len(ranks)
        gens[g] = {"ranks": ranks, "losses": _losses(os.path.join(out, f"m_n{n}.jsonl"))}
    series = {n: os.path.getsize(os.path.join(out, n)) for n in os.listdir(out)
              if n.startswith("m_n") and n.endswith(".jsonl")}
    return {"gens": gens, "postmortem": _read_json(os.path.join(run_dir, "postmortem.json")),
            "fleet": _read_json(os.path.join(run_dir, "run_record.json")), "series": series}


def _close(a, b, what):
    """The JAX gate (`tests/test_reshard.py` `_losses_close`)."""
    import math

    assert len(a) == len(b), f"{what}: {len(a)} losses against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert math.isfinite(x) and math.isfinite(y), f"{what}: step {i} not finite"
        assert abs(x - y) <= LOSS_TOL * max(abs(x), abs(y), 1e-3), (
            f"{what}: step {i}: {x} against {y}")


def _at(lines, pattern):
    """(time, match) of the first output line matching `pattern`."""
    for t, line in lines:
        m = re.search(pattern, line)
        if m:
            return t, m
    raise AssertionError(f"no launcher line matches {pattern!r}")


def _ms_per_step(rec) -> float | None:
    if not rec or not rec.get("goodput_steps"):
        return None
    return round(1e3 * rec["goodput_s"] / rec["goodput_steps"], 3)


def check(run, whole, *, whole_ms=None, flash_counts=None, mma_counts=None,
          one_graph=True, concurrent=1) -> dict:
    """The gates over one supervised run (`supervise`) against the
    uninterrupted run's losses `whole`; returns what it prints (raises
    AssertionError naming the failing check). SIGKILL: the only failure is
    the killed rank, every survivor collateral, generation 1 resumes the
    newest periodic checkpoint at dp WORLD - 1, one graph a step. SIGTERM:
    the signalled rank exits PREEMPT_RC after the emergency checkpoint,
    generation 1 resumes at the step after it (no step lost). Both: exit 0
    and final size WORLD - 1, the postmortem bundles the dead rank's flight
    dump and heartbeat, the losses within LOSS_TOL of `whole`, the fleet
    record validates with a restart gap, no CUDA driver in the launcher,
    no worker left on a card. `flash_counts(steps, accum=)` and
    `mma_counts(want)`: the launch formula of generation 1's steps;
    `one_graph` False for a dry run on the CPU (eager steps). `whole_ms`:
    the uninterrupted run's ms per step by step index (its trace), printed
    beside generation 0's (whose ranks' records may end before their steady
    steps are written through). `concurrent`: how many supervised runs
    shared the card at once (their workers count among the card's
    processes; the caller takes ``apps_after`` once all have ended)."""
    from distributed_neural_network_tpu_torch.train.supervisor import PREEMPT_RC
    from distributed_neural_network_tpu_torch.utils.goodput import validate_record

    world, sig, kill = run["world"], run["sig"], run["kill_rank"]
    assert len(whole) == STEPS, f"whole: {len(whole)} losses"
    text = "\n".join(line for _, line in run["lines"])
    assert run["rc"] == 0, f"the launcher exited {run['rc']}:\n{text[-4000:]}"
    summary = json.loads(text.split("SUPERVISOR_SUMMARY ", 1)[1].splitlines()[0])
    cause = "SIGKILL" if sig == "KILL" else "preempt"
    assert summary["exit"] == "ok" and summary["final_size"] == world - 1, summary
    assert summary["generations"] == 2 and summary["restarts"] == 1, summary
    assert summary["worker_failures"] == [{"gen": 0, "rank": kill, "cause": cause}], summary
    pm = run["postmortem"]
    workers = {w["rank"]: w for w in pm["workers"]}
    assert workers[kill]["flight"] and workers[kill]["heartbeat"], "postmortem: no flight dump"
    rcs = {r: w["returncode"] for r, w in workers.items()}
    if sig == "TERM":
        assert rcs[kill] == PREEMPT_RC, rcs
    collateral = {0, PREEMPT_RC, -15, -9}
    assert all(rc in collateral for r, rc in rcs.items() if r != kill), rcs
    g0, g1 = run["gens"][0], run["gens"][1]
    assert len(g0["ranks"]) == world and len(g1["ranks"]) == world - 1
    (t_kill, m_kill) = _at(run["lines"], rf"supervisor chaos: sending SIG{sig} to rank {kill} "
                                         r"at step (\d+)")
    kill_step = int(m_kill[1])
    log1 = g1["ranks"][0]["log"]
    m = re.search(r"\(Resumed from step (\d+); continuing at (\d+)\)", log1)
    if sig == "KILL":
        # the newest periodic checkpoint: the one at the kill's step or,
        # when the kill cut that save short, the one before
        newest = (kill_step + 1) // EVERY * EVERY - 1
        assert m and int(m[1]) in (newest, newest - EVERY), f"gen 1 resumed: {m and m[0]}"
        resumed = int(m[1])
    else:
        stops = {int(x) for x in re.findall(r"\(emergency checkpoint at step (\d+);",
                                            "\n".join(r["log"] for r in g0["ranks"].values()))}
        assert len(stops) == 1 and min(stops) >= kill_step, f"emergency checkpoints {stops}"
        resumed = stops.pop()
        assert resumed == STEPS - 1 or (m and int(m[1]) == resumed), (
            f"gen 1 did not resume at the emergency checkpoint {resumed}: {m and m[0]}")
    assert f"(elastic: mesh axis 'data': saved {world}, target {world - 1})" in log1 \
        or resumed == STEPS - 1, log1[-2000:]
    before, after = g0["losses"], g1["losses"]
    assert len(after) == STEPS - 1 - resumed, f"gen 1 ran {len(after)} steps after {resumed}"
    if sig == "TERM":
        assert len(before) + len(after) == STEPS, f"steps lost: {len(before)} + {len(after)}"
    _close(before, whole[:len(before)], "generation 0")
    _close(after, whole[resumed + 1:], "generation 1")
    segs = [re.search(r"\(step program: ([^)]*)\)", r["log"]) for r in g1["ranks"].values()]
    if after and one_graph:
        assert all(s and s[1] == "graph" for s in segs), f"gen 1's step: {segs}"
    counts = [r["launches"] for r in g1["ranks"].values()]
    assert all(c is not None for c in counts), "a gen-1 rank wrote no launch counts"
    want = None
    if flash_counts is not None and after:
        new_dp = world - 1  # the global batch kept: accum scales when dp divides
        accum = world // new_dp if world % new_dp == 0 else 1
        want = flash_counts(len(after), accum=accum)
        for c in counts:
            assert c["launches"] == want and c["routes"] == mma_counts(want), (
                f"gen 1's flash launches {c} != {want}")
    fleet = validate_record(run["fleet"], "run_record.json")
    gap = fleet["restart_gaps"][0]
    assert fleet["kind"] == "fleet" and fleet["badput_s"]["restart_gap"] > 0, fleet["badput_s"]
    # the launcher holds no CUDA context (neither the driver library nor a
    # device file, where the workers on a card hold both); no worker is left
    # on a card
    assert not any(run["launcher_cuda"].values()), f"the launcher: {run['launcher_cuda']}"
    if run["apps_before"] is not None:
        assert run["workers_cuda"]["device"], f"the workers: {run['workers_cuda']}"
    pids = {w["pid"] for w in pm["workers"]} | {
        r["record"]["pid"] for g in run["gens"].values() for r in g["ranks"].values()
        if r["record"]}
    # nvidia-smi may name every process by a pid of another namespace, so
    # the entries are counted too: never more than the processes before and
    # one a worker of the runs at once (the launcher holds none), none of
    # them left after
    apps_before = run["apps_before"] or []
    apps_during = [a for a in run["apps_during"] if a is not None]
    assert not any(run["launcher_pid"] in a for a in apps_during), "the launcher on the card"
    assert all(len(a) <= len(apps_before) + world * concurrent for a in apps_during), (
        f"more compute processes than workers: {apps_during} (apps_before {apps_before})")
    if run["apps_after"] is not None:
        left = set(run["apps_after"]) - set(apps_before)
        assert not left and not pids & set(run["apps_after"]) and (
            len(run["apps_after"]) <= len(apps_before)), (
            f"left on the card: {run['apps_after']} (apps_before {apps_before})")
    # the timeline: the chaos, the group stop, the respawn
    t_stop, _ = _at(run["lines"], r"supervisor: (stopping \d+ worker|postmortem bundle)")
    t_respawn, _ = _at(run["lines"], r"supervisor: gen 1 - ")
    grace_lines = [t for t, l in run["lines"] if "ignored SIGTERM" in l]
    init1 = max((r["record"]["badput_s"].get("init", 0.0)
                 + r["record"]["badput_s"].get("compile", 0.0))
                for r in g1["ranks"].values() if r["record"])
    return {
        "summary": {k: summary[k] for k in ("exit", "final_size", "generations",
                                            "worker_failures")},
        "returncodes": rcs, "kill_step": kill_step, "resumed_from": resumed,
        "losses": {"gen0": before, "gen1": after, "whole": whole,
                   "gen0_bitwise": before == whole[:len(before)]},
        "restart_s": gap["seconds"], "backoff_s": gap["backoff_s"],
        "death_to_first_step_s": round(gap["seconds"] + init1, 3),
        "restart_gap_badput_s": fleet["badput_s"]["restart_gap"],
        "grace_spent_s": (round(max(grace_lines) - t_stop, 3) if grace_lines else 0.0),
        "survivors_sigkilled_after_grace": len(grace_lines),
        "chaos_to_respawn_s": round(t_respawn - t_kill, 3),
        "ms_per_step": {g: [_ms_per_step(r["record"]) for r in run["gens"][g]["ranks"].values()]
                        for g in (0, 1)},
        "ms_per_step_whole": ({int(k): round(v, 3) for k, v in whole_ms.items() if int(k) > 0}
                              if whole_ms else None),
        "series_bytes": run["series"],
        "segments_gen1": [s[1] if s else None for s in segs],
        "launches_gen1": counts[0]["launches"], "want_gen1": want,
        "launcher_cuda": run["launcher_cuda"], "workers_cuda": run["workers_cuda"],
        "apps_before": run["apps_before"], "apps_during": run["apps_during"],
        "apps_after": run["apps_after"], "seconds": run["seconds"],
    }


def main(world: int) -> int:
    from chip_smoke import LM_ARGS, flash_counts, mma_counts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"supervisor_world{world}")
    work = os.path.join(ROOT, "runs", f"supervisor_world{world}")  # checkpoints: gigabytes
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    lm_args = LM_ARGS + ["--batch-size", str(12 * world)]
    t0 = time.perf_counter()
    try:
        whole = run_whole(world, os.path.join(work, "whole"), lm_args)
        t1 = time.perf_counter()
        run = supervise(world, os.path.join(work, "kill"), lm_args, sig="KILL",
                        kill_rank=world - 1)
        with open(os.path.join(out, "launcher.log"), "w") as f:
            f.write("\n".join(f"{t:9.3f} {line}" for t, line in run["lines"]))
        for g, gen in run["gens"].items():
            for r, rank in gen["ranks"].items():
                with open(os.path.join(out, f"gen{g}_rank{r}.log"), "w") as f:
                    f.write(rank["log"])
        res = check(run, whole["losses"], whole_ms=whole["step_ms"], flash_counts=flash_counts,
                    mma_counts=mma_counts)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"{world} ranks: the uninterrupted run {t1 - t0:.1f} s, the supervised run "
          f"{run['seconds']:.1f} s (with start-up)")
    for k, v in res.items():
        print(f"{k}: {json.dumps(v)}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("supervisor_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        sys.exit(worker_main(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
