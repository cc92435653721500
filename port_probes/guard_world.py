#!/usr/bin/env python3
"""The training guard's in-step skip across ranks: each run of RUNS is
trained twice by WORLD ranks of `lm_train.main` under one process group,
with ``--guard skip --chaos-nan-step 2 --stop-at-step 3`` (step 2's
gradients NaN after the sync, the update dropped on the device) and
unguarded with ``--stop-at-step 2``; the guarded run must end bit for bit
where the unguarded one does.

    python3 port_probes/guard_world.py [WORLD]     # from the repo root; 4 (default)

WORLD 4 needs four cards: each rank on its own card, NCCL, the guarded step
one CUDA graph with the finite flag, the gated update and the collectives
inside; the runs ``--dp 4``, ``--dp 2 --tp 2`` and ``--dp 4 --optimizer
zero-adam`` (the shards' update gated before their all-gather, Adam's
counter on the device). At chip_smoke.py's flagship width (LM_ARGS:
d512/L8/H8, d_ff 2048, vocab 32,768, seq 2,048, global batch 16, bf16,
--attn flash). The checks (`check`): on every rank the guard skipped once
(its summary), the guarded run's first two losses the unguarded run's, the
ranks' losses equal, and the two runs' final checkpoints (the whole
gathered tree, Adam's counter included; `utils/checkpoint.py`) equal leaf
for leaf; with `one_graph`, every guarded step one graph. WORLD 4 then
times AB_RUNS with the guard off and on (``--guard warn``: the health
bundle read one step late), in the order off, warn, warn, off (`check_ab`:
the losses equal, ms a step by mode).

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`). Its flow
dry-runs on the CPU at a tiny width: `run_world(world, out, lm_args, runs,
device="cpu")` and `check(ranks, runs, out)`.
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

STEPS, NAN_STEP = 6, 2
GUARDED = ["--guard", "skip", "--chaos-nan-step", str(NAN_STEP), "--stop-at-step",
           str(NAN_STEP + 1)]
PLAIN = ["--stop-at-step", str(NAN_STEP)]
# world -> [(name, extra arguments)]
RUNS = {
    4: (("dp4", ["--dp", "4", "--attn", "flash"]),
        ("dp2tp2", ["--dp", "2", "--tp", "2", "--attn", "flash"]),
        ("dp4-zero-adam", ["--dp", "4", "--attn", "flash", "--optimizer", "zero-adam"])),
}
# world 4 also times a step with the guard off and on (--guard warn), in the
# order off, warn, warn, off, at the row of lm_dp_world.py (dp 4)
AB_STEPS = 21
AB_ORDER = ("off", "warn", "warn", "off")
AB_RUNS = (("dp4", ["--dp", "4", "--attn", "flash"]),)


def _argv(lm_args, device, extra, *more):
    return ["--device", device, "--steps", str(STEPS), "--log-every", "1", *lm_args, *extra,
            *more]


def rank_main(spec: dict) -> int:
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.parallel.distributed import initialize

    device, out = spec["device"], spec["out"]
    initialize(device=device, log=lambda line: None)
    rank = dist.get_rank()
    info = {"rank": rank, "runs": {}}
    try:
        for name, extra in spec["runs"]:
            rec = {}
            for key, more in (("guarded", GUARDED), ("plain", PLAIN)):
                for c in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
                    c.update(dict.fromkeys(c, 0))
                lines, res = [], {}
                ck = os.path.join(out, f"{name}_{key}")
                lm_train.main(_argv(spec["lm_args"], device, extra, *more,
                                    "--checkpoint-dir", ck), log=lines.append, result=res)
                rec[key] = {"losses": res["losses"], "launches": dict(fa.LAUNCHES),
                            "routes": dict(fa.ROUTE_LAUNCHES), "mesh": res["mesh"].desc,
                            "segments": res["step"].segments, "guard": res["guard"],
                            "log": [l for l in lines if l.startswith("(guard")],
                            "summary": next(l for l in lines if l.startswith("SUMMARY "))}
                del res
                gc.collect()
            if rank == 0:
                from ckpt_world import _same_checkpoint

                rec["state_equal"] = _same_checkpoint(
                    os.path.join(out, f"{name}_guarded", f"step_{NAN_STEP}"),
                    os.path.join(out, f"{name}_plain", f"step_{NAN_STEP - 1}"))
            info["runs"][name] = rec
        info["ab"] = {}
        for name, extra in spec.get("ab", ()):
            rows = []
            for mode in AB_ORDER:
                lines, res = [], {}
                lm_train.main(["--device", device, "--steps", str(AB_STEPS), "--log-every", "10",
                               *spec["lm_args"], *extra, "--guard", mode],
                              log=lines.append, result=res)
                summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
                rows.append({"guard": mode, "losses": res["losses"],
                             "ms_per_step": 1e3 * summary["wall_s_post_compile"]
                             / (AB_STEPS - 1)})
                del res
                gc.collect()
            info["ab"][name] = rows
    finally:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        gc.collect()
        dist.destroy_process_group()
    return 0


def run_world(world: int, out: str, lm_args, runs, *, device="cuda", timeout=900, env=None,
              ab=()):
    """Launch the ranks (tests/torch_rank_worker.py `launch`) over `runs`
    (and the A/B runs `ab`): every rank's record, or a RuntimeError with
    the failing rank's errors."""
    from torch_rank_worker import launch

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    spec = {"device": device, "out": out, "lm_args": list(lm_args),
            "runs": [list(r) for r in runs], "ab": [list(r) for r in ab]}
    procs = launch(world, spec, timeout=timeout, env=env, script=os.path.abspath(__file__))
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log"), "w") as f:
            f.write(p.stdout + "\n" + p.stderr)
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def check(ranks, runs, out, *, launches=None, one_graph=False) -> dict:
    """The checks over the ranks' records (`launches(name, steps)`: each
    rank's flash launches of a run of `steps` steps; `one_graph`: every guarded
    step one CUDA graph); returns what they print (raises AssertionError
    naming the failing check)."""
    result = {}
    for name, _ in runs:
        recs = [r["runs"][name] for r in ranks]
        for key in ("guarded", "plain"):
            assert all(r[key]["losses"] == recs[0][key]["losses"] for r in recs), (
                f"{name}: the ranks' {key} losses differ")
        guarded, plain = recs[0]["guarded"], recs[0]["plain"]
        for r in recs:
            g = r["guarded"]["guard"]
            assert g["skipped"] == 1 and g["nonfinite"] == 1 and g["rollbacks"] == 0, (
                f"{name}: guard summary {g}")
            assert any(f"step {NAN_STEP} nonfinite -> skip" in l for l in r["guarded"]["log"]), (
                f"{name}: no skip line in {r['guarded']['log']}")
        assert guarded["losses"][:NAN_STEP] == plain["losses"], (
            f"{name}: the guarded run's losses {guarded['losses']} before the fault are not "
            f"the unguarded {plain['losses']}")
        assert recs[0]["state_equal"], (
            f"{name}: the skipped step changed the state (its final checkpoint is not the "
            f"unguarded run's)")
        if one_graph:
            assert all(r["guarded"]["segments"] == "graph" for r in recs), (
                f"{name}: segments {[r['guarded']['segments'] for r in recs]}")
        if launches is not None:
            for key, steps in (("guarded", NAN_STEP + 1), ("plain", NAN_STEP)):
                want = launches(name, steps)
                got = [r[key]["launches"] for r in recs]
                assert all(g == want for g in got), f"{name} {key}: launches {got}, want {want}"
        result[name] = {"mesh": guarded["mesh"], "losses": guarded["losses"],
                        "segments": guarded["segments"], "guard": guarded["guard"]["skipped"],
                        "launches_guarded": guarded["launches"]}
    return result


def check_ab(ranks) -> dict:
    """The A/B runs: every rank's losses the same in every run of a row (the
    health output only observes); returns each row's ms a step by mode, in
    run order (the SUMMARY wall is the slowest rank's, so rank 0's)."""
    result = {}
    for name, rows in ranks[0]["ab"].items():
        for r in ranks:
            assert all(row["losses"] == rows[0]["losses"] for row in r["ab"][name]), (
                f"A/B {name}: the losses differ between runs or ranks")
        result[name] = {mode: [row["ms_per_step"] for row in rows if row["guard"] == mode]
                        for mode in dict.fromkeys(AB_ORDER)}
    return result


def main(world: int) -> int:
    from chip_smoke import LM_ARGS, flash_counts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"guard_world{world}")
    t0 = time.perf_counter()
    try:
        ab = AB_RUNS if world == 4 else ()
        ranks = run_world(world, out, LM_ARGS, RUNS[world], timeout=1500, ab=ab)
        # a flash launch per layer and step on every rank, whatever its rows or heads
        res = check(ranks, RUNS[world], out, one_graph=True,
                    launches=lambda name, steps: flash_counts(steps))
        if ab:
            res["guard_ab"] = check_ab(ranks)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        for name, _ in RUNS[world]:
            for k in ("guarded", "plain"):
                shutil.rmtree(os.path.join(out, f"{name}_{k}"), ignore_errors=True)
    print(f"{world} ranks, every run guarded and unguarded ({time.perf_counter() - t0:.1f} s "
          "with start-up)")
    for name, row in res.items():
        print(f"{name}: {json.dumps(row)}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    print("guard_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
