#!/usr/bin/env python3
"""Exact resume of the LM entry point across ranks: each run of RUNS is
trained three times by WORLD ranks of `lm_train.main` under one process
group, uninterrupted for STEPS steps, then to `--stop-at-step STOP` with
``--checkpoint-dir`` (and ``--trace-out``), then ``--resume`` to STEPS;
the resumed run must continue the uninterrupted one bit for bit.

    python3 port_probes/ckpt_world.py [WORLD]     # from the repo root; 2 or 4 (default)

WORLD 4 needs four cards: each rank on its own card, NCCL, the step one
CUDA graph after the restore (the restore copies into the tensors the step
is then captured over); the runs ``--dp 2 --tp 2`` (flash, Adam, cosine
schedule) and ``--dp 2 --pp 2 --pp-interleave 2`` (Adam, cosine). WORLD 2
is `chip_smoke.py` phase 29(e): 2 ranks that share the one card over gloo,
``--dp 2``. At chip_smoke.py's flagship width (LM_ARGS: d512/L8/H8, d_ff
2048, vocab 32,768, seq 2,048, global batch 16, bf16). The checks
(`check`): every rank's three runs' losses the same across ranks; the
stopped run's losses the uninterrupted run's first STOP, the resumed run's
its last STEPS - STOP, bitwise; the final checkpoints of the uninterrupted
and the resumed run (the whole gathered tree, `utils/checkpoint.py`)
equal leaf for leaf; the resumed run's mesh and start step; optionally each
rank's flash launches at a formula. Per run: the checkpoint's save and
restore seconds and bytes (rank 0), the step's segments after the restore,
and the stopped run's per-rank trace shards, merged by
`tools/trace_merge.py`. WORLD 4 then times AB_RUNS with the ranks agreeing
on the preemption flag at every step and without (`check_ab`: the losses
equal, ms a step by mode).

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`, the runs in
`rank_runs`). Its flow dry-runs on the CPU at a tiny width:
`run_world(world, out, lm_args, runs, device="cpu")` and `check(ranks,
runs)`.
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

STEPS, STOP = 6, 3
ADAM = ["--optimizer", "adam", "--lr-schedule", "cosine", "--warmup-steps", "1"]
# world -> [(name, extra arguments)]
RUNS = {
    2: (("dp2", ["--dp", "2", "--attn", "flash"] + ADAM),),
    4: (("dp2tp2", ["--dp", "2", "--tp", "2", "--attn", "flash"] + ADAM),
        ("dp2pp2-v2", ["--dp", "2", "--pp", "2", "--pp-interleave", "2", "--microbatches", "4",
                       "--attn", "ring"] + ADAM)),
}


# world 4 also times a step with the ranks agreeing on the preemption flag
# at every step (--on-sigterm checkpoint, the default) and without (ignore),
# in the order on, off, off, on, at the rows of lm_dp_world.py (dp 4),
# lm_mesh_world.py (tp 4) and pp_world.py (pp 4, M 4); at their --log-every
AB_STEPS = 21
AB_ORDER = ("checkpoint", "ignore", "ignore", "checkpoint")
AB_RUNS = (("dp4", ["--dp", "4", "--attn", "flash"]),
           ("tp4", ["--tp", "4", "--attn", "flash"]),
           ("pp4-m4", ["--pp", "4", "--microbatches", "4", "--attn", "ring"]))


def _argv(lm_args, device, extra, *more):
    return ["--device", device, "--steps", str(STEPS), "--log-every", "1",
            *lm_args, *extra, *more]


def rank_main(spec: dict) -> int:
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel.distributed import initialize

    initialize(device=spec["device"], log=lambda line: None)
    rank = dist.get_rank()
    try:
        rank_runs(spec, rank)
    finally:
        gc.collect()
        dist.destroy_process_group()
    return 0


def rank_runs(spec: dict, rank: int) -> dict:
    """This rank's part of `spec`'s runs (and A/B runs) in the process group
    it has joined; writes its record as ``rank{r}.json`` under the spec's
    ``out`` (also when a run fails) and returns it (also in another probe's
    ranks: `torch_rank_worker.run_then`)."""
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa

    device, out = spec["device"], spec["out"]
    info = {"rank": rank, "runs": {}}
    try:
        for name, extra in spec["runs"]:
            rec, res = {}, {}
            dirs = {k: os.path.join(out, f"{name}_{k}") for k in ("whole", "stopped")}
            plan = (("whole", ["--checkpoint-dir", dirs["whole"]]),
                    ("stopped", ["--checkpoint-dir", dirs["stopped"], "--stop-at-step", str(STOP),
                                 "--trace-out", os.path.join(out, f"{name}_trace.json")]),
                    ("resumed", ["--checkpoint-dir", dirs["stopped"], "--resume",
                                 "--stop-at-step", str(STEPS)]))
            for key, more in plan:
                for c in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
                    c.update(dict.fromkeys(c, 0))
                lines, res = [], {}
                lm_train.main(_argv(spec["lm_args"], device, extra, *more), log=lines.append,
                              result=res)
                rec[key] = {"losses": res["losses"], "launches": dict(fa.LAUNCHES),
                            "routes": dict(fa.ROUTE_LAUNCHES), "start_step": res["start_step"],
                            "mesh": res["mesh"].desc, "segments": res["step"].segments,
                            "checkpoint": res["checkpoint"],
                            "summary": next(l for l in lines if l.startswith("SUMMARY "))}
                del res
                gc.collect()
            if rank == 0:
                rec["state_equal"] = _same_checkpoint(
                    os.path.join(dirs["whole"], f"step_{STEPS - 1}"),
                    os.path.join(dirs["stopped"], f"step_{STEPS - 1}"))
            info["runs"][name] = rec
        info["ab"] = {}
        for name, extra in spec.get("ab", ()):
            rows = []
            for mode in AB_ORDER:
                lines, res = [], {}
                lm_train.main(["--device", device, "--steps", str(AB_STEPS), "--log-every", "10",
                               *spec["lm_args"], *extra, "--on-sigterm", mode],
                              log=lines.append, result=res)
                summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
                rows.append({"on_sigterm": mode, "losses": res["losses"],
                             "ms_per_step": 1e3 * summary["wall_s_post_compile"]
                             / (AB_STEPS - 1)})
                del res
                gc.collect()
            info["ab"][name] = rows
    finally:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    return info


def _same_checkpoint(a: str, b: str) -> bool:
    """Two checkpoints' leaves equal bit for bit."""
    import numpy as np

    with np.load(os.path.join(a, "state.npz")) as x, np.load(os.path.join(b, "state.npz")) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes() for k in x.files)


def run_world(world: int, out: str, lm_args, runs, *, device="cuda", timeout=900, env=None,
              ab=()):
    """Launch the ranks (tests/torch_rank_worker.py `launch`) over `runs`
    (and the A/B runs `ab`): every rank's record, or a RuntimeError with
    the failing rank's errors."""
    from torch_rank_worker import launch

    spec = make_spec(out, lm_args, runs, device=device, ab=ab)
    procs = launch(world, spec, timeout=timeout, env=env, script=os.path.abspath(__file__))
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log"), "w") as f:
            f.write(p.stdout + "\n" + p.stderr)
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
    return read_ranks(world, out)


def make_spec(out: str, lm_args, runs, *, device="cuda", ab=()) -> dict:
    """The ranks' spec of `runs` (and `ab`) over a fresh `out` directory."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    return {"device": device, "out": out, "lm_args": list(lm_args),
            "runs": [list(r) for r in runs], "ab": [list(r) for r in ab]}


def read_ranks(world: int, out: str) -> list:
    """Every rank's record (`rank_runs`) from `out`."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def check(ranks, runs, out, *, launches=None, one_graph=False) -> dict:
    """The checks over the ranks' records (`launches(name, steps)`: each
    rank's flash launches of a run of `steps` steps; `one_graph`: the
    resumed step is one CUDA graph); returns what they print (raises
    AssertionError naming the failing check). Merges the stopped runs'
    trace shards with tools/trace_merge.py."""
    result = {}
    for name, _ in runs:
        recs = [r["runs"][name] for r in ranks]
        for key in ("whole", "stopped", "resumed"):
            assert all(r[key]["losses"] == recs[0][key]["losses"] for r in recs), (
                f"{name}: the ranks' {key} losses differ")
        whole, stopped, resumed = (recs[0][k] for k in ("whole", "stopped", "resumed"))
        assert stopped["losses"] == whole["losses"][:STOP], f"{name}: the stopped run differs"
        assert resumed["losses"] == whole["losses"][STOP:], (
            f"{name}: the resumed losses {resumed['losses']} are not the uninterrupted "
            f"{whole['losses'][STOP:]}")
        assert resumed["start_step"] == STOP and resumed["mesh"] == whole["mesh"]
        assert recs[0]["state_equal"], f"{name}: the final checkpoints differ"
        if one_graph:
            assert all(r["resumed"]["segments"] == "graph" for r in recs), (
                f"{name}: segments {[r['resumed']['segments'] for r in recs]}")
        if launches is not None:
            for key, steps in (("whole", STEPS), ("stopped", STOP), ("resumed", STEPS - STOP)):
                want = launches(name, steps)
                got = [r[key]["launches"] for r in recs]
                assert all(g == want for g in got), f"{name} {key}: launches {got}, want {want}"
        shards = [os.path.join(out, f"{name}_trace_rank{r}.json") for r in range(len(ranks))]
        merged = os.path.join(out, f"{name}_trace_merged.json")
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_merge.py"),
                               *shards, "-o", merged], capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, f"{name}: trace_merge: {proc.stderr[-2000:]}"
        result[name] = {
            "mesh": whole["mesh"], "losses": whole["losses"],
            "save": [r["stopped"]["checkpoint"]["save"] for r in recs],
            "restore": [r["resumed"]["checkpoint"]["restore"] for r in recs],
            "segments_resumed": resumed["segments"],
            "launches_resumed": resumed["launches"],
            "trace_merged": os.path.relpath(merged, ROOT),
        }
    return result


def check_ab(ranks) -> dict:
    """The A/B runs: every rank's losses the same in every run of a row
    (the flag changes no number); returns each row's ms a step by mode, in
    run order (the SUMMARY wall is the slowest rank's, so rank 0's)."""
    result = {}
    for name, rows in ranks[0]["ab"].items():
        for r in ranks:
            assert all(row["losses"] == rows[0]["losses"] for row in r["ab"][name]), (
                f"A/B {name}: the losses differ between runs or ranks")
        result[name] = {mode: [row["ms_per_step"] for row in rows if row["on_sigterm"] == mode]
                        for mode in dict.fromkeys(AB_ORDER)}
    return result


def main(world: int) -> int:
    from chip_smoke import LM_ARGS

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"ckpt_world{world}")
    t0 = time.perf_counter()
    try:
        ab = AB_RUNS if world == 4 else ()
        ranks = run_world(world, out, LM_ARGS, RUNS[world], timeout=1500, ab=ab)
        res = check(ranks, RUNS[world], out, one_graph=world == 4)
        if ab:
            res["on_sigterm_ab"] = check_ab(ranks)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        for name, _ in RUNS[world]:
            for k in ("whole", "stopped"):
                shutil.rmtree(os.path.join(out, f"{name}_{k}"), ignore_errors=True)
    print(f"{world} ranks, every run three times ({time.perf_counter() - t0:.1f} s with "
          "start-up)")
    for name, row in res.items():
        print(f"{name}: {json.dumps(row)}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("ckpt_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
