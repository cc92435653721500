#!/usr/bin/env python3
"""The LM on the data axis at full width: WORLD ranks of the port's LM
entry point (`lm_train.main` under a process group) against one process on
the same global batch.

    python3 port_probes/lm_dp_world.py [WORLD]     # from the repo root; default 4

Needs WORLD cards: each rank on its own card, so `parallel/distributed.py`
picks NCCL and the step's collectives are captured in its CUDA graph
(`chip_smoke.py` phases 21-23 run the same runs and checks as 2 ranks that
share the one card, over gloo, through `run_world`). At chip_smoke.py's
flagship width (LM_ARGS: d512/L8/H8, d_ff 2048, vocab 32,768, seq 2,048,
global batch 16, bf16, --attn flash), in one launch of the ranks:

- 21: sgd and adam, 4 steps: every step's loss within LOSS_TOL relative of
  the one-process run (`reference`), the ranks' SUMMARY lines equal, each
  rank's flash launches the formula, all on the mma route; ms per step,
  tokens/s, a profiled window's idle share (union of the ranks' device
  intervals) and the collectives' time per step;
- 22: --accum-steps 4 with --grad-sync end, overlap --bucket-mb 4 and 16,
  3 steps: losses within LOSS_TOL of end, the bucket count `plan_buckets`'s;
- 23: --optimizer zero and zero-adam, 4 steps: the parameters bitwise the
  sgd / adam run's; each rank's optimizer-state bytes (`memory_allocated`
  around `init_lm_momentum`) within 1% of its shards' bytes, half the
  replicated state plus the padding.

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`).
"""

import gc
import hashlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "port_probes")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

LOSS_TOL = 1e-3  # chip_smoke.py phase 13's route tolerance
STATE_TOL = 0.01
# (name, phase, extra arguments, steps)
RUNS = (
    ("sgd", 21, [], 4),
    ("adam", 21, ["--optimizer", "adam"], 4),
    ("end4", 22, ["--accum-steps", "4"], 3),
    ("overlap4", 22, ["--accum-steps", "4", "--grad-sync", "overlap", "--bucket-mb", "4"], 3),
    ("overlap16", 22, ["--accum-steps", "4", "--grad-sync", "overlap", "--bucket-mb", "16"], 3),
    ("zero", 23, ["--optimizer", "zero"], 4),
    ("zero-adam", 23, ["--optimizer", "zero-adam"], 4),
)
REFERENCES = ("sgd", "adam")  # run in one process too


def _argv(lm_args, device, dp, extra, steps):
    return (["--device", device, "--dp", str(dp), "--steps", str(steps), "--log-every", "10"]
            + lm_args + ["--attn", "flash"] + extra)


def _reset(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def reference(lm_args, device="cuda"):
    """The one-process runs of REFERENCES: {name: per-step losses}."""
    from distributed_neural_network_tpu_torch import lm_train

    out = {}
    for name, _, extra, steps in RUNS:
        if name in REFERENCES:
            res = {}
            lm_train.main(_argv(lm_args, device, 1, extra, steps), log=lambda line: None,
                          result=res)
            out[name] = res["losses"]
            del res
            gc.collect()
    return out


def _sha(leaves) -> str:
    h = hashlib.sha256()
    for p in leaves:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _profiled(torch, step, params, mom, tokens, targets, n):
    """n steps under torch.profiler: their span on the host's clock and the
    device's busy intervals relative to the trace's start (microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for i in range(n):
            step(params, mom, tokens, targets, i)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    busy = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    return {"start_us": t0 / 1e3, "end_us": t1 / 1e3, "busy": busy,
            "trace_start_us": prof.profiler.kineto_results.trace_start_ns() / 1e3}


def _collective_ms(torch, dist, step, sync, reps=3) -> float:
    """The step's collective parts run alone on its buffers, per step (ms;
    the median of `reps`)."""
    times = []
    for _ in range(reps):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for c in step.collectives:
            c()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _state_bytes(torch, lmtrain, tfm, cfg, mesh, optimizer) -> dict:
    """memory_allocated around `init_lm_momentum` at full width, beside the
    bytes its tensors hold."""
    params = tfm.init_params(0, cfg, mesh.device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(mesh.device)
    state = lmtrain.init_lm_momentum(params, optimizer, mesh)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(mesh.device) - before
    tensors = lmtrain.tree_leaves({k: v for k, v in state.items() if k != "t"}
                                  if isinstance(state, dict) else state)
    held = sum(t.numel() * t.element_size() for t in tensors)
    return {"allocated": allocated, "held": held}


def rank_main(spec: dict) -> int:
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.parallel.distributed import (
        distribute_host_data,
        initialize,
    )
    from distributed_neural_network_tpu_torch.parallel.zero import leaf_shard_size
    from distributed_neural_network_tpu_torch.train import lm as lmtrain
    from torch_rank_worker import run_then

    device, world, lm_args = spec["device"], spec["world"], spec["lm_args"]
    initialize(device=device, log=lambda line: None)
    rank = dist.get_rank()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    info = {"rank": rank, "runs": {}}
    keep = {}
    try:
        for name, phase, extra, steps in RUNS:
            _reset(fa.LAUNCHES, fa.ROUTE_LAUNCHES)
            lines, res = [], {}
            sync()
            lm_train.main(_argv(lm_args, device, world, extra, steps), log=lines.append,
                          result=res)
            step, mesh = res["step"], res["mesh"]
            leaves = lmtrain.tree_leaves(res["params"])
            rec = {"phase": phase, "losses": res["losses"], "launches": dict(fa.LAUNCHES),
                   "routes": dict(fa.ROUTE_LAUNCHES), "cards": res["cards"],
                   "summary": next(l for l in lines if l.startswith("SUMMARY ")),
                   "log": [l for l in lines if l.startswith("(")],
                   "n_buckets": step.layout.n_buckets if step.layout is not None else 0,
                   "n_collectives": len(step.collectives), "form": step.collective_form,
                   "backend": mesh.backend, "device": str(mesh.device),
                   "segments": (len(step.program.segments)
                                if step.program.segments is not None else None),
                   "params_sha": _sha(leaves)}
            if name in ("sgd", "adam"):
                keep[name] = [p.detach().clone() for p in leaves]
            if name in ("zero", "zero-adam"):
                like = keep["sgd" if name == "zero" else "adam"]
                rec["bitwise"] = all(torch.equal(a, b) for a, b in zip(leaves, like))
            if name in ("sgd", "end4", "overlap4", "overlap16", "zero"):
                rec["collective_ms"] = _collective_ms(torch, dist, step, sync)
            if name == "sgd" and cuda:
                args = lm_train.build_parser().parse_args(_argv(lm_args, device, world, extra,
                                                                steps))
                tok, tgt = lmtrain.make_copy_task(
                    torch.Generator().manual_seed(args.seed + 1), batch=args.batch_size,
                    seq_len=args.seq_len, vocab=args.vocab)
                tok, tgt = (distribute_host_data(x, mesh) for x in (tok, tgt))
                step(res["params"], res["mom"], tok, tgt, steps)
                rec["profile"] = _profiled(torch, step, res["params"], res["mom"], tok, tgt, 3)
            info["runs"][name] = rec
            del res, step, leaves
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        keep.clear()
        if cuda:
            args = lm_train.build_parser().parse_args(_argv(lm_args, device, world, [], 1))
            cfg = tfm.TransformerConfig(vocab_size=args.vocab, d_model=args.d_model,
                                        n_heads=args.n_heads, n_layers=args.n_layers,
                                        d_ff=args.d_ff)
            mesh = lmtrain.create_lm_mesh(world, device=device)
            info["state_bytes"] = {opt: _state_bytes(torch, lmtrain, tfm, cfg, mesh, opt)
                                   for opt in ("adam", "zero-adam", "sgd", "zero")}
            sizes = [p.numel() for p in lmtrain.tree_leaves(tfm.init_params(0, cfg))]
            info["shard_floats"] = sum(leaf_shard_size(d, world) for d in sizes)
            info["param_floats"] = sum(sizes)
        # other probes' runs in this launch of the ranks (`run_world(then=)`)
        run_then(spec, rank)
    finally:
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        gc.collect()
        if dist.is_initialized():  # a shrink run among `then` may have left the group
            dist.destroy_process_group()
    return 0


def run_world(world: int, out: str, lm_args, *, device="cuda", timeout=900, env=None,
              then=()):
    """Launch the ranks (tests/torch_rank_worker.py `launch`): every rank's
    record, or a RuntimeError with the failing rank's errors. `then`: [(a
    probe module, its `make_spec`)] run by the same ranks after these
    (`torch_rank_worker.run_then`); their records are read with the
    module's `read_ranks`."""
    from torch_rank_worker import launch

    os.makedirs(out, exist_ok=True)
    spec = {"device": device, "world": world, "lm_args": list(lm_args), "out": out,
            "then": [list(t) for t in then]}
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


def check(world, ranks, ref, lm_args, *, flash_counts, mma_counts, busy_union):
    """The phases' checks over the ranks' records; returns what they print
    (raises AssertionError naming the failing check)."""
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.collectives import plan_buckets
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

    runs = {name: [r["runs"][name] for r in ranks] for name, *_ in RUNS}
    out = {"runs": {}}
    for name, phase, extra, steps in RUNS:
        recs = runs[name]
        accum = int(extra[extra.index("--accum-steps") + 1]) if "--accum-steps" in extra else 1
        s0 = recs[0]
        assert all(r["summary"] == s0["summary"] for r in recs), (
            f"{name}: the ranks' SUMMARY lines differ: {[r['summary'] for r in recs]}")
        assert all(r["params_sha"] == s0["params_sha"] for r in recs), (
            f"{name}: the ranks' parameters differ")
        assert all(r["losses"] == s0["losses"] for r in recs), f"{name}: the ranks' losses differ"
        want = flash_counts(steps, accum=accum)
        for r, rec in enumerate(recs):
            assert rec["launches"] == want, (
                f"{name}: rank {r}'s flash launches {rec['launches']} != {want}")
            assert rec["routes"] == mma_counts(want), (
                f"{name}: rank {r}'s launches by route {rec['routes']} != {mma_counts(want)}")
        summary = json.loads(s0["summary"][8:])
        assert summary["mesh"] == f"data{world}", summary["mesh"]
        row = {"losses": s0["losses"], "ms_per_step": 1e3 * summary["wall_s_post_compile"]
               / (steps - 1), "tokens_per_s": summary["tokens_per_s"],
               "mfu_pct": summary["mfu_pct"], "launches_per_rank": s0["launches"],
               "form": s0["form"], "backend": s0["backend"], "segments": s0["segments"],
               "n_collectives": s0["n_collectives"], "cards": s0["cards"],
               "collective_ms": [r.get("collective_ms") for r in recs]}
        if name in ref:
            rel = max(abs(a - b) / abs(b) for a, b in zip(s0["losses"], ref[name]))
            assert rel <= LOSS_TOL, f"{name}: losses {s0['losses']} vs one process {ref[name]}"
            row["max_rel_vs_one_process"] = rel
        if name.startswith("overlap"):
            rel = max(abs(a - b) / abs(b) for a, b in zip(s0["losses"], runs["end4"][0]["losses"]))
            assert rel <= LOSS_TOL, f"{name}: losses {s0['losses']} vs end {runs['end4'][0]}"
            row["max_rel_vs_end"] = rel
            cap = int(float(extra[extra.index("--bucket-mb") + 1]) * 2**20)
            args = dict(zip(lm_args[::2], lm_args[1::2]))
            cfg = tfm.TransformerConfig(
                vocab_size=int(args["--vocab"]), d_model=int(args["--d-model"]),
                n_heads=int(args["--n-heads"]), n_layers=int(args["--n-layers"]),
                d_ff=int(args["--d-ff"]))
            params = tfm.init_params(0, cfg)
            layout = plan_buckets(tree_leaves(params), bucket_bytes=cap,
                                  group_keys=[str(s) for s in tree_leaves(tfm.param_specs(cfg))])
            assert s0["n_buckets"] == layout.n_buckets, (
                f"{name}: {s0['n_buckets']} buckets, plan_buckets gives {layout.n_buckets}")
            row["n_buckets"] = layout.n_buckets
        if name in ("zero", "zero-adam"):
            assert all(r["bitwise"] for r in recs), f"{name}: parameters differ from the " \
                f"{'sgd' if name == 'zero' else 'adam'} run's"
        if "profile" in s0:
            traces = [r["profile"] for r in recs]
            wall = max(t["end_us"] for t in traces) - min(t["start_us"] for t in traces)
            aligned = all(abs(t["trace_start_us"] - t["start_us"]) < 1e6 for t in traces)
            union = (busy_union([(t["trace_start_us"] + a, t["trace_start_us"] + b)
                                 for t in traces for a, b in t["busy"]]) if aligned else None)
            row["profile"] = {"wall_s": wall / 1e6, "clocks_aligned": aligned,
                              "idle_share": None if union is None else 1 - union / wall}
        out["runs"][name] = row
    if "state_bytes" in ranks[0]:
        sb = ranks[0]["state_bytes"]
        want = 2 * 4 * ranks[0]["shard_floats"]
        got = sb["zero-adam"]["allocated"]
        assert abs(got - want) <= STATE_TOL * want, (
            f"zero-adam state {got} bytes, its shards hold {want}")
        out["state_bytes"] = {"per_rank": sb, "zero_adam_want": want,
                              "replicated_adam": sb["adam"]["allocated"],
                              "ratio": got / sb["adam"]["allocated"],
                              # padded floats of a leaf's shards over all ranks
                              "padding_floats": (ranks[0]["shard_floats"] * world
                                                 - ranks[0]["param_floats"])}
    return out


def main(world: int) -> int:
    import subprocess

    from chip_smoke import LM_ARGS, flash_counts, mma_counts
    from torch_rank_worker import busy_union

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"lm_dp_world{world}")
    t0 = time.perf_counter()
    ref = reference(LM_ARGS)
    print(f"one process: {json.dumps(ref)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = run_world(world, out, LM_ARGS)
        res = check(world, ranks, ref, LM_ARGS, flash_counts=flash_counts,
                    mma_counts=mma_counts, busy_union=busy_union)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    print(f"{world} ranks ({time.perf_counter() - t0:.1f} s with start-up)")
    for name, row in res["runs"].items():
        print(f"{name}: {json.dumps(row)}")
    print(f"state bytes: {json.dumps(res.get('state_bytes'))}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump({"one_process": ref, **res}, f, indent=1)
    print("lm_dp_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
