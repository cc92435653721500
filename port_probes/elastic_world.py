#!/usr/bin/env python3
"""Elastic resume of the LM entry point across ranks: a dp-WORLD ZeRO-Adam
run of `lm_train.main` is stopped at a checkpoint and resumed with
``--resume --elastic`` on another mesh and optimizer, and shrunk in process
with ``--chaos-shrink-at-step``; each continuation is held to the
uninterrupted run.

    python3 port_probes/elastic_world.py [WORLD]     # from the repo root; 4 (default)

WORLD 4 needs four cards: each rank on its own card, NCCL. One launch of 4
ranks runs, at chip_smoke.py's flagship width (LM_ARGS: d512/L8/H8, d_ff
2048, vocab 32,768, seq 2,048, global batch 16, bf16) with --attn flash:

- ``whole``: --dp 4 --optimizer zero-adam, STEPS steps (the flags of
  `port_probes/lm_dp_world.py`'s zero-adam run);
- ``stopped``: the same to --stop-at-step STOP, with --checkpoint-dir;
- ``r2x1x2``: --dp 2 --tp 2 --optimizer adam --resume --elastic from a
  copy of that checkpoint (ZeRO-Adam to Adam, the data axis 4 to 2, the
  model axis 1 to 2);
- ``shrink``: --dp 4 --chaos-shrink-at-step SHRINK_AT --chaos-shrink-to 2
  --trace-out: ranks 2-3 leave after step SHRINK_AT (exit 0) and ranks 0-1
  finish every step on the survivors' group at dp 2 with accum 2, their
  step captured again as one graph over the new groups.

Then one launch of 2 ranks: ``r2``, --dp 2 --optimizer zero-adam
--resume --elastic from the stopped checkpoint (ZeRO buffers re-padded for
dp 2, accum 2). The checks (`check`): the ranks that ran a run agree on its
losses; the stopped run's losses and the shrink run's up to SHRINK_AT are
the whole run's bitwise; every continuation within LOSS_TOL (relative, the
JAX gate `tests/test_reshard.py` `_losses_close`) of the whole run's; the
resume logs name the axes and the optimizer; the resumed and shrunk steps'
segments; SUMMARY ``preempted`` false, ``last_step`` STEPS - 1 and the new
mesh; the leaving ranks' record. Printed: each reshard's seconds and bytes
read, and the shrink run's ms a step before and after the shrink.
`chip_smoke.py` phase 32 runs ``shrink`` at dp 2 on 2 ranks that share the
one card over gloo (in phase 21's launch), takes phase 23's zero-adam run as
``whole`` (the same flags) and the shrink's emergency checkpoint as the
stopped one (`take_stopped`), and resumes it at dp 1 in its own process.

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`, the runs in
`rank_runs`). Its flow dry-runs on the CPU at a tiny width:
`run_world(world, out, lm_args, runs, device="cpu", env={"OMP_NUM_THREADS":
"1"})` then `check(...)`.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "port_probes")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# STEPS and the flags match port_probes/lm_dp_world.py's zero-adam run (phase
# 23), which chip_smoke.py phase 32 takes as its uninterrupted run
STEPS, STOP, SHRINK_AT = 4, 2, 1
assert SHRINK_AT == STOP - 1  # the shrink's emergency checkpoint is the stopped run's
LOSS_TOL = 1e-3
ZERO_ADAM = ["--optimizer", "zero-adam", "--attn", "flash"]


def world_runs(world: int, out: str, *, whole: bool = True, stopped: bool = True) -> list:
    """The runs of one launch of `world` ranks (the module docstring): each
    [name, extra arguments, options]; options ``copy``: [src, dst]
    directories rank 0 copies before the run (every rank then waits).
    `whole` False leaves out the uninterrupted run (the caller has it);
    `stopped` False the stopped run (the shrink run's emergency checkpoint
    after step SHRINK_AT = STOP - 1 is the same checkpoint: `take_stopped`)."""
    d = {k: os.path.join(out, k) for k in ("stopped", "shrink", "r2x1x2")}
    dp = ["--dp", str(world)]
    runs = [["whole", dp + ZERO_ADAM, {}]] if whole else []
    if stopped:
        runs.append(["stopped", dp + ZERO_ADAM + ["--stop-at-step", str(STOP),
                                                  "--checkpoint-dir", d["stopped"]], {}])
    if world == 4:
        runs.append(["r2x1x2", ["--dp", "2", "--tp", "2", "--optimizer", "adam", "--attn",
                                "flash", "--resume", "--elastic", "--stop-at-step", str(STEPS),
                                "--checkpoint-dir", d["r2x1x2"]],
                     {"copy": [d["stopped"], d["r2x1x2"]]}])
    # last: the ranks it drops are out of the group after it
    runs.append(["shrink", dp + ZERO_ADAM + [
        "--chaos-shrink-at-step", str(SHRINK_AT), "--chaos-shrink-to", str(world // 2),
        "--checkpoint-dir", d["shrink"], "--trace-out", os.path.join(out, "shrink_trace.json")],
        {}])
    return runs


def take_stopped(out: str) -> None:
    """The shrink run's emergency checkpoint (after step SHRINK_AT, before
    any rank left) alone in ``stopped/``: what the stopped run writes."""
    step = f"step_{SHRINK_AT}"
    shutil.copytree(os.path.join(out, "shrink", step), os.path.join(out, "stopped", step))


def resume_runs(out: str, dp: int, optimizer: str) -> list:
    """The resume of the stopped checkpoint at `dp` with `optimizer`."""
    return [[f"r{dp}", ["--dp", str(dp), "--optimizer", optimizer, "--attn", "flash",
                        "--resume", "--elastic", "--stop-at-step", str(STEPS),
                        "--checkpoint-dir", os.path.join(out, "stopped")], {}]]


def _argv(lm_args, device, extra):
    return ["--device", device, "--steps", str(STEPS), "--log-every", "1", *lm_args, *extra]


def _step_ms(trace: str) -> dict:
    """Step index -> the ``train_step`` span's milliseconds in a Chrome trace."""
    with open(trace) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {int(e["args"]["step"]): e["dur"] / 1e3 for e in events
            if e.get("name") == "train_step" and e.get("ph") == "X"}


def rank_main(spec: dict) -> int:
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel.distributed import initialize

    initialize(device=spec["device"], log=lambda line: None)
    rank = dist.get_rank()
    try:
        rank_runs(spec, rank)
    finally:
        gc.collect()
        if dist.is_initialized():  # a rank a shrink left is in no group
            dist.destroy_process_group()
    return 0


def run_one(lm_args, device, name, extra, rank=0) -> dict:
    """One `lm_train.main` run in this process: its record (losses, the
    resume and elastic lines, SUMMARY, segments, flash launches, whether
    this rank left at a shrink, the reshards' seconds and bytes)."""
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.parallel.distributed import joined
    from distributed_neural_network_tpu_torch.utils.tracing import rank_trace_path

    for c in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        c.update(dict.fromkeys(c, 0))
    lines, res = [], {}
    in_group = joined()  # the trace is a per-rank shard when the run starts in a group
    lm_train.main(_argv(lm_args, device, extra), log=lines.append, result=res)
    rec = {"losses": res["losses"], "left": res["left"], "start_step": res["start_step"],
           "mesh": res["mesh"].desc, "launches": dict(fa.LAUNCHES),
           "routes": dict(fa.ROUTE_LAUNCHES),
           "log": [l for l in lines if l.startswith(("(elastic", "(Resumed", "(emergency"))],
           "summary": next((json.loads(l[8:]) for l in lines if l.startswith("SUMMARY ")),
                           None),
           "segments": res["step"].segments if res["step"] is not None else None,
           "reshards": res.get("reshards", [])}
    if "--trace-out" in extra and not res["left"]:
        trace = extra[extra.index("--trace-out") + 1]
        if in_group:
            trace = rank_trace_path(trace, rank)
        rec["step_ms"] = _step_ms(trace)
    return rec


def rank_runs(spec: dict, rank: int) -> dict:
    """This rank's part of `spec`'s runs in the process group it has
    joined; writes its record as ``rank{r}.json`` under the spec's ``out``
    (also when a run fails) and returns it (also in another probe's ranks:
    `torch_rank_worker.run_then`). A run that drops this rank at a shrink
    ends its runs."""
    import torch.distributed as dist

    info = {"rank": rank, "runs": {}}
    try:
        for name, extra, opts in spec["runs"]:
            if "copy" in opts:
                if rank == 0:
                    shutil.copytree(*opts["copy"], dirs_exist_ok=True)
                dist.barrier()
            info["runs"][name] = run_one(spec["lm_args"], spec["device"], name, extra, rank)
            gc.collect()
            if info["runs"][name]["left"]:
                break
    finally:
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    return info


def make_spec(out: str, lm_args, runs, *, device="cuda") -> dict:
    """The ranks' spec of `runs` with records and checkpoints under `out`."""
    os.makedirs(out, exist_ok=True)
    return {"device": device, "out": out, "lm_args": list(lm_args), "runs": runs}


def read_ranks(world: int, out: str) -> list:
    """Every rank's record (`rank_runs`) from `out`."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def run_world(world: int, out: str, lm_args, runs, *, device="cuda", timeout=900, env=None):
    """Launch `world` ranks (tests/torch_rank_worker.py `launch`) over
    `runs`: every rank's record, or a RuntimeError with the failing rank's
    errors (a rank that a shrink drops must exit 0 too)."""
    from torch_rank_worker import launch

    spec = make_spec(out, lm_args, runs, device=device)
    procs = launch(world, spec, timeout=timeout, env=env, script=os.path.abspath(__file__))
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log"), "w") as f:
            f.write(p.stdout + "\n" + p.stderr)
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
    return read_ranks(world, out)


def _close(a, b, what):
    """The JAX gate (`tests/test_reshard.py` `_losses_close`)."""
    import math

    assert len(a) == len(b), f"{what}: {len(a)} losses against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert math.isfinite(x) and math.isfinite(y), f"{what}: step {i} not finite"
        assert abs(x - y) <= LOSS_TOL * max(abs(x), abs(y), 1e-3), (
            f"{what}: step {i}: {x} against {y}")


def check_resume(whole, rec, *, name, saved_dp, dp, tp=1, optimizer, accum) -> dict:
    """One ``--resume --elastic`` run's record against the whole run's
    losses: the continuation within LOSS_TOL, the named differences, the
    rescaled accumulation in SUMMARY; returns what it prints."""
    _close(rec["losses"], whole[STOP:], name)
    assert rec["start_step"] == STOP, f"{name}: started at {rec['start_step']}"
    log = "\n".join(rec["log"])
    assert f"mesh axis 'data': saved {saved_dp}, target {dp}" in log, f"{name}: {log}"
    if tp > 1:
        assert f"mesh axis 'model': saved 1, target {tp}" in log, f"{name}: {log}"
    if optimizer != "zero-adam":
        assert f"optimizer layout: saved 'zero-adam', target '{optimizer}'" in log, log
    assert f"(Resumed from step {STOP - 1}; continuing at {STOP})" in log, f"{name}: {log}"
    s = rec["summary"]
    assert s["accum_steps"] == accum and s["last_step"] == STEPS - 1, f"{name}: {s}"
    return {"losses": rec["losses"], "segments": rec["segments"], "mesh": rec["mesh"],
            "accum_steps": s["accum_steps"], "reshards": rec["reshards"],
            "launches": rec["launches"]}


def check_shrink(world, ranks, whole) -> dict:
    """The shrink run: ranks >= world/2 left after SHRINK_AT (their record
    says so), the survivors' losses the whole run's bitwise to SHRINK_AT and
    within LOSS_TOL after, SUMMARY preempted false, last step STEPS - 1,
    the new mesh and accum; returns what it prints."""
    keep = world // 2
    recs = [r["runs"]["shrink"] for r in ranks]
    for r, rec in enumerate(recs):
        assert rec["left"] == (r >= keep), f"shrink: rank {r} left={rec['left']}"
    left, kept = recs[keep:], recs[:keep]
    for rec in left:
        assert rec["losses"] == whole[:SHRINK_AT + 1], "shrink: a leaving rank's losses differ"
        assert rec["summary"] is None
    assert all(rec["losses"] == kept[0]["losses"] for rec in kept), "shrink: survivors differ"
    losses = kept[0]["losses"]
    assert losses[:SHRINK_AT + 1] == whole[:SHRINK_AT + 1], (
        f"shrink: the steps before the shrink {losses[:SHRINK_AT + 1]} are not the whole "
        f"run's {whole[:SHRINK_AT + 1]}")
    _close(losses[SHRINK_AT + 1:], whole[SHRINK_AT + 1:], "shrink")
    s = kept[0]["summary"]
    want_mesh = f"data{keep}" if keep > 1 else "single"
    assert (s["preempted"] is False and s["last_step"] == STEPS - 1 and s["mesh"] == want_mesh
            and s["accum_steps"] == 2), f"shrink: SUMMARY {s}"
    log = "\n".join(kept[0]["log"])
    assert f"(elastic: continuing at step {SHRINK_AT + 1} on mesh {want_mesh}" in log, log
    ms = {int(k): v for k, v in (kept[0].get("step_ms") or {}).items()}  # JSON keys
    before = [ms[i] for i in range(1, SHRINK_AT + 1) if i in ms]
    after = [ms[i] for i in range(SHRINK_AT + 2, STEPS) if i in ms]
    return {"losses": losses, "mesh": s["mesh"], "accum_steps": s["accum_steps"],
            "segments": kept[0]["segments"], "reshards": kept[0]["reshards"],
            "left_log": [rec["log"] for rec in left], "launches": kept[0]["launches"],
            "ms_before": before, "ms_after": after}


def check(world, ranks, *, resumed=(), whole=None, one_graph=False) -> dict:
    """The checks over one launch's records (the module docstring) and the
    resume runs' records `resumed`: [(name, record, saved dp, dp, tp,
    optimizer, accum)]; `whole`: the uninterrupted run's losses when the
    launch did not run it; `one_graph`: every resumed and shrunk step is one
    CUDA graph (NCCL). Returns what they print (raises AssertionError
    naming the failing check)."""
    for name in ("whole", "stopped"):
        if name in ranks[0]["runs"]:
            assert all(r["runs"][name]["losses"] == ranks[0]["runs"][name]["losses"]
                       for r in ranks), f"the ranks' {name} losses differ"
    if whole is None:
        whole = ranks[0]["runs"]["whole"]["losses"]
    assert len(whole) == STEPS
    if "stopped" in ranks[0]["runs"]:
        assert ranks[0]["runs"]["stopped"]["losses"] == whole[:STOP], "the stopped run differs"
    out = {"whole": whole, "shrink": check_shrink(world, ranks, whole)}
    if "r2x1x2" in ranks[0]["runs"]:
        recs = [r["runs"]["r2x1x2"] for r in ranks]
        assert all(rec["losses"] == recs[0]["losses"] for rec in recs)
        out["r2x1x2"] = check_resume(whole, recs[0], name="r2x1x2", saved_dp=world, dp=2, tp=2,
                                     optimizer="adam", accum=2)
    for name, rec, saved_dp, dp, tp, optimizer, accum in resumed:
        out[name] = check_resume(whole, rec, name=name, saved_dp=saved_dp, dp=dp, tp=tp,
                                 optimizer=optimizer, accum=accum)
    if one_graph:
        for name, row in out.items():
            if name != "whole":
                assert row["segments"] == "graph", f"{name}: segments {row['segments']}"
    return out


def main(world: int) -> int:
    from chip_smoke import LM_ARGS

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"elastic_world{world}")
    ck = os.path.join(ROOT, "runs", f"elastic_world{world}")  # checkpoints: gigabytes
    shutil.rmtree(ck, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    try:
        ranks = run_world(world, ck, LM_ARGS, world_runs(world, ck), timeout=400)
        t1 = time.perf_counter()
        half = run_world(world // 2, os.path.join(ck, "half"), LM_ARGS,
                         resume_runs(ck, world // 2, "zero-adam"), timeout=200)
        assert all(r["runs"][f"r{world // 2}"]["losses"] == half[0]["runs"][f"r{world // 2}"]
                   ["losses"] for r in half), "the resumed ranks differ"
        res = check(world, ranks, resumed=[(f"r{world // 2}", half[0]["runs"][f"r{world // 2}"],
                                            world, world // 2, 1, "zero-adam", 2)],
                    one_graph=True)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        for r in range(world):
            src = os.path.join(ck, f"rank{r}.log")
            if os.path.exists(src):
                shutil.copy(src, out)
        shutil.rmtree(ck, ignore_errors=True)
    print(f"{world} ranks: whole, stopped, (2, 1, 2) resume and shrink in "
          f"{t1 - t0:.1f} s, the dp {world // 2} resume on {world // 2} ranks in "
          f"{time.perf_counter() - t1:.1f} s (with start-up)")
    for name, row in res.items():
        print(f"{name}: {json.dumps(row)}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("elastic_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
