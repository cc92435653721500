#!/usr/bin/env python3
"""The LM on the pipeline axis at full width: WORLD ranks of the port's LM
entry point (`lm_train.main` with --pp under a process group) against one
process on the same global batch.

    python3 port_probes/pp_world.py [WORLD]     # from the repo root; 2 or 4 (default)

WORLD 4 needs four cards: each rank on its own card, so
`parallel/distributed.py` picks NCCL and the step is one CUDA graph, every
tick's ppermute and the all-to-all included. WORLD 2 is `chip_smoke.py`
phase 26: 2 ranks that share the one card over gloo (`run_world`), where
each pass's forward and backward, which hold the pipeline's collectives,
run eagerly between the step's graphs. At chip_smoke.py's flagship width
(LM_ARGS: d512/L8/H8, d_ff 2048, vocab 32,768, seq 2,048, global batch 16,
bf16; nothing cut but the steps, 4) the runs of RUNS:

- the GPipe schedule at --pp 2 (M 4) and --pp 4 (M 4 and 8), the
  interleaved one (--pp-interleave 2) at the same, --dp 2 --pp 2, --pp 2
  --tp 2, and --pp 2 --dp 2 --optimizer zero-adam --accum-steps 2
  --grad-sync overlap, each held to its one-process run on the plain
  attention (`reference`: the pipeline's blocks attend with it whatever
  --attn is, as in JAX): every step's loss within LOSS_TOL relative, and
  the run's parameter update (the gathered parameters, the layer axis put
  back in order under interleave, minus the seeded initial ones) within
  UPDATE_TOL of the one-process run's in relative L2, leaf by leaf;
- every rank's SUMMARY line, losses and gathered parameters the same, the
  SUMMARY's mesh and pp_bubble_frac the JAX CLI's, no flash launch (the
  pipeline reaches no hand-written kernel); under NCCL the step one CUDA
  graph;
- per run: ms per step, tokens/s, each rank's peak memory, the step's
  segments, and for the first run of each world a profiled window of 3
  steps' idle share (the union of the ranks' device intervals);
- WORLD 4 also: tokens/s at a fixed microbatch of 2 rows across (M, v) at
  --pp 4, the shape of the JAX bench row pp4_bubble_cpu4 (d256/L8/H8, d_ff
  1,024, vocab 512, seq 128, f32, 6 steps), beside the analytic bubble.

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`).
"""

import gc
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "port_probes")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from lm_dp_world import LOSS_TOL, _profiled, _reset, _sha  # noqa: E402
from lm_mesh_world import UPDATE_TOL, _opt, _update, update_rel  # noqa: E402

STEPS = 4
PLAIN = ["--attn", "ring"]
# reference name -> (extra arguments, steps) of its one-process run
REFERENCES = {
    "plain": (PLAIN, STEPS),
    "plain-adam-accum2": (PLAIN + ["--optimizer", "adam", "--accum-steps", "2"], STEPS),
}
# world -> [(name, phase, extra arguments, steps, reference)]
RUNS = {
    2: (
        ("pp2-m4", 26, PLAIN + ["--pp", "2", "--microbatches", "4"], STEPS, "plain"),
        ("pp2-v2-m4", 26, PLAIN + ["--pp", "2", "--pp-interleave", "2", "--microbatches", "4"],
         STEPS, "plain"),
    ),
    4: (
        ("pp4-m4", 0, PLAIN + ["--pp", "4", "--microbatches", "4"], STEPS, "plain"),
        ("pp4-m8", 0, PLAIN + ["--pp", "4", "--microbatches", "8"], STEPS, "plain"),
        ("pp4-v2-m4", 0, PLAIN + ["--pp", "4", "--pp-interleave", "2", "--microbatches", "4"],
         STEPS, "plain"),
        ("pp4-v2-m8", 0, PLAIN + ["--pp", "4", "--pp-interleave", "2", "--microbatches", "8"],
         STEPS, "plain"),
        ("dp2pp2", 0, PLAIN + ["--dp", "2", "--pp", "2"], STEPS, "plain"),
        ("pp2tp2", 0, PLAIN + ["--pp", "2", "--tp", "2"], STEPS, "plain"),
        ("dp2pp2-zero-adam-overlap", 0,
         PLAIN + ["--pp", "2", "--dp", "2", "--optimizer", "zero-adam", "--accum-steps", "2",
                  "--grad-sync", "overlap"], STEPS, "plain-adam-accum2"),
    ),
}
# the bubble sweep at --pp 4 (JAX train/measure.py measure_pp_bubble's shape)
BUBBLE_ARGS = ["--d-model", "256", "--n-layers", "8", "--n-heads", "8", "--d-ff", "1024",
               "--vocab", "512", "--seq-len", "128", "--dtype", "float32", "--lr", "0.01",
               "--attn", "ring", "--pp", "4"]
BUBBLE_MB_ROWS, BUBBLE_STEPS = 2, 6
BUBBLE_CONFIGS = ((2, 1), (4, 1), (8, 1), (16, 1), (4, 2), (8, 2), (16, 2))


def _argv(lm_args, device, extra, steps):
    return (["--device", device, "--steps", str(steps), "--log-every", "10"] + list(lm_args)
            + list(extra))


def _in_order(whole, argv):
    """The gathered tree with its layer axis in the canonical order (the
    pipeline's interleaved layout undone)."""
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.parallel.pipeline import interleave_layer_order

    a = lm_train.build_parser().parse_args(argv)
    if a.pp_interleave == 1:
        return whole
    inv = interleave_layer_order(a.n_layers, a.pp, a.pp_interleave, inverse=True)
    return dict(whole, layers={k: x[inv] for k, x in whole["layers"].items()})


def reference(lm_args, names, device="cuda", updates=None):
    """The one-process runs of REFERENCES `names`: {name: per-step losses};
    with `updates`, a directory, each run's update saved there as
    <name>.pt."""
    import torch

    from distributed_neural_network_tpu_torch import lm_train

    out = {}
    for name in names:
        extra, steps = REFERENCES[name]
        res = {}
        argv = _argv(lm_args, device, extra, steps)
        lm_train.main(argv, log=lambda line: None, result=res)
        out[name] = res["losses"]
        if updates is not None:
            os.makedirs(updates, exist_ok=True)
            torch.save(_update(res["params"], argv), os.path.join(updates, f"{name}.pt"))
        del res
        gc.collect()
    return out


def rank_main(spec: dict) -> int:
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel.distributed import initialize

    initialize(device=spec["device"], log=lambda line: None)
    try:
        rank_runs(spec, dist.get_rank())
    finally:
        gc.collect()
        dist.destroy_process_group()
    return 0


def rank_runs(spec: dict, rank: int) -> dict:
    """This rank's part of `spec`'s runs in the process group it has joined
    (`make_spec`); writes its record as ``rank{r}.json`` under the spec's
    ``out`` (also when a run fails) and returns it."""
    import torch

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.parallel.distributed import distribute_host_data
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    device, world, lm_args = spec["device"], spec["world"], spec["lm_args"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    info = {"rank": rank, "runs": {}, "bubble": []}
    try:
        for i, (name, phase, extra, steps, ref_name) in enumerate(RUNS[world]):
            _reset(fa.LAUNCHES, fa.ROUTE_LAUNCHES)
            lines, res = [], {}
            argv = _argv(lm_args, device, extra, steps)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            lm_train.main(argv, log=lines.append, result=res)
            seconds = time.perf_counter() - t0
            step, mesh = res["step"], res["mesh"]
            whole = _in_order(lmtrain.gather_params(res["params"], res["specs"], mesh), argv)
            rel = None
            if rank == 0:  # the ranks' trees are equal (`check` holds them to it)
                ref = torch.load(os.path.join(spec["updates"], f"{ref_name}.pt"))
                rel = update_rel(_update(whole, argv), ref)
                del ref
            rec = {"phase": phase, "losses": res["losses"], "launches": dict(fa.LAUNCHES),
                   "mesh": mesh.desc, "seconds": seconds,
                   "summary": next(l for l in lines if l.startswith("SUMMARY ")),
                   "log": [l for l in lines if l.startswith("(")],
                   "form": step.collective_form, "backend": mesh.backend,
                   "segments": step.segments,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
                   "params_sha": _sha(lmtrain.tree_leaves(whole)), "update_rel": rel}
            if i == 0 and cuda:
                args = lm_train.build_parser().parse_args(argv)
                tok, tgt = lmtrain.make_copy_task(
                    torch.Generator().manual_seed(args.seed + 1), batch=args.batch_size,
                    seq_len=args.seq_len, vocab=args.vocab)
                tok, tgt = (distribute_host_data(x, mesh) for x in (tok, tgt))
                rec["profile"] = _profiled(torch, step, res["params"], res["mom"], tok, tgt, 3)
            info["runs"][name] = rec
            del res, step, whole
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        if world == 4:
            for m, v in BUBBLE_CONFIGS:
                lines = []
                argv = _argv(BUBBLE_ARGS + ["--microbatches", str(m), "--pp-interleave", str(v),
                                            "--batch-size", str(BUBBLE_MB_ROWS * m)],
                             device, [], BUBBLE_STEPS)
                lm_train.main(argv, log=lines.append)
                summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
                info["bubble"].append({
                    "microbatches": m, "interleave": v,
                    "tokens_per_s": summary["tokens_per_s"],
                    "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (BUBBLE_STEPS - 1),
                    "bubble_analytic": summary["pp_bubble_frac"]})
                gc.collect()
    finally:
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    return info


def make_spec(world: int, out: str, lm_args, updates, *, device="cuda") -> dict:
    """The ranks' spec against the one-process updates saved in `updates`
    (`reference`), their records to `out`."""
    os.makedirs(out, exist_ok=True)
    return {"device": device, "world": world, "lm_args": list(lm_args), "out": out,
            "updates": updates}


def read_ranks(world: int, out: str) -> list:
    """Every rank's record (`rank_runs`) from `out`."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def run_world(world: int, out: str, lm_args, updates, *, device="cuda", timeout=900, env=None):
    """Launch the ranks (tests/torch_rank_worker.py `launch`) against the
    one-process updates saved in `updates` (`reference`): every rank's
    record, or a RuntimeError with the failing rank's errors."""
    from torch_rank_worker import launch

    spec = make_spec(world, out, lm_args, updates, device=device)
    procs = launch(world, spec, timeout=timeout, env=env, script=os.path.abspath(__file__))
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log"), "w") as f:
            f.write(p.stdout + "\n" + p.stderr)
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
    return read_ranks(world, out)


def check(world, ranks, ref, lm_args, *, busy_union):
    """The checks over the ranks' records; returns what they print (raises
    AssertionError naming the failing check)."""
    out = {}
    for name, _, extra, steps, ref_name in RUNS[world]:
        recs = [r["runs"][name] for r in ranks]
        s0 = recs[0]
        for key in ("summary", "params_sha", "losses"):
            assert all(r[key] == s0[key] for r in recs), f"{name}: the ranks' {key} differ"
        summary = json.loads(s0["summary"][8:])
        dp, pp, tp = (int(_opt(extra, f"--{a}", 1)) for a in ("dp", "pp", "tp"))
        m, v = int(_opt(extra, "--microbatches", 2)), int(_opt(extra, "--pp-interleave", 1))
        want_mesh = "x".join(f"{k}{n}" for k, n in (("data", dp), ("pipe", pp), ("model", tp))
                             if n > 1)
        assert summary["mesh"] == s0["mesh"] == want_mesh, f"{name}: mesh {summary['mesh']}"
        bubble = round((pp - 1) / (v * m + pp - 1), 4)
        assert summary["pp_bubble_frac"] == bubble, (
            f"{name}: pp_bubble_frac {summary['pp_bubble_frac']}, want {bubble}")
        for r, rec in enumerate(recs):
            assert not any(rec["launches"].values()), (
                f"{name}: rank {r} launched flash kernels {rec['launches']}")
        if s0["backend"] == "nccl":
            assert all(r["segments"] == "graph" for r in recs), (
                f"{name}: not one CUDA graph a step: {[r['segments'] for r in recs]}")
        rel = max(abs(a - c) / abs(c) for a, c in zip(s0["losses"], ref[ref_name]))
        assert rel <= LOSS_TOL, f"{name}: losses {s0['losses']} vs one process {ref[ref_name]}"
        leaf, worst = max(s0["update_rel"].items(), key=lambda kv: kv[1])
        assert worst <= UPDATE_TOL, (
            f"{name}: the parameter update of {leaf!r} is {worst:.3e} (relative L2) from the one "
            f"process run's, above {UPDATE_TOL}")
        row = {"losses": s0["losses"], "reference": ref_name, "max_rel_vs_one_process": rel,
               "update_rel_max": worst, "update_rel_leaf": leaf,
               "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (steps - 1),
               "tokens_per_s": summary["tokens_per_s"], "mfu_pct": summary["mfu_pct"],
               "pp_bubble_frac": bubble, "form": s0["form"], "backend": s0["backend"],
               "segments": s0["segments"], "seconds": max(r["seconds"] for r in recs),
               "peak_mem_gib": [r["peak_mem_gib"] for r in recs]}
        if "profile" in s0:
            traces = [r["profile"] for r in recs]
            wall = max(t["end_us"] for t in traces) - min(t["start_us"] for t in traces)
            aligned = all(abs(t["trace_start_us"] - t["start_us"]) < 1e6 for t in traces)
            union = (busy_union([(t["trace_start_us"] + a, t["trace_start_us"] + b)
                                 for t in traces for a, b in t["busy"]]) if aligned else None)
            row["profile"] = {"wall_s": wall / 1e6, "clocks_aligned": aligned,
                              "idle_share": None if union is None else 1 - union / wall}
        out[name] = row
    if ranks[0]["bubble"]:
        out["bubble"] = ranks[0]["bubble"]
    return out


def main(world: int) -> int:
    import subprocess

    from chip_smoke import LM_ARGS
    from torch_rank_worker import busy_union

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"pp_world{world}")
    updates = os.path.join(ROOT, "runs", f"pp_world{world}_updates")
    t0 = time.perf_counter()
    try:
        ref = reference(LM_ARGS, sorted({r[-1] for r in RUNS[world]}), updates=updates)
        print(f"one process: {json.dumps(ref)} ({time.perf_counter() - t0:.1f} s)", flush=True)
        import torch

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_world(world, out, LM_ARGS, updates, timeout=1500)
        res = check(world, ranks, ref, LM_ARGS, busy_union=busy_union)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(updates, ignore_errors=True)
    print(f"{world} ranks ({time.perf_counter() - t0:.1f} s with start-up)")
    for name, row in res.items():
        print(f"{name}: {json.dumps(row)}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump({"one_process": ref, "runs": res}, f, indent=1)
    print("pp_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
