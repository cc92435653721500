#!/usr/bin/env python3
"""Mixture of experts across ranks: WORLD ranks of the port's LM entry point
(`lm_train.main --experts 8` with --dp under a process group, the experts
sharded over the data axis) against one process on the same global batch.

    python3 port_probes/moe_world.py [WORLD]     # from the repo root; 2 or 4 (default)

WORLD 4 needs four cards: each rank on its own card, so
`parallel/distributed.py` picks NCCL and the step is one CUDA graph, the
experts' all-to-alls included. WORLD 2 is `chip_smoke.py` phase 28(c): 2
ranks that share the one card over gloo (`run_world`), where each
micro-batch's forward and backward, which hold the all-to-alls, run eagerly
between the step's graphs. At chip_smoke.py's flagship width (LM_ARGS:
d512/L8/H8, d_ff 2048, vocab 32,768, seq 2,048, global batch 16, bf16) with
8 experts at the JAX defaults (top-2, capacity factor 2.0, sort dispatch,
z-loss weight 0.1), --attn flash, 4 steps, the runs of RUNS:

- WORLD 2: --dp 2 (ep 2) at depth 2 (cut from 8); WORLD 4: --dp 4 (ep 4)
  and --dp 2 --tp 2 (ep 2 x tp 2) at depth 8. Each is held to its
  one-process run (`reference`): every step's loss within LOSS_TOL
  relative, and the parameter update (the gathered parameters minus the
  seeded initial ones) within UPDATE_TOL of the one-process run's in
  relative L2, leaf by leaf (the expert leaves included);
- every rank's SUMMARY line, losses and gathered parameters the same, the
  SUMMARY's mesh the JAX CLI's, each rank's flash launches the formula
  (one forward, dq and dkv per layer and step), all on the mma route; under
  NCCL the step one CUDA graph;
- per run: ms per step, tokens/s, MFU, peak memory, the step's segments and
  the collectives' time a step, each timed alone on the run's groups: the
  gradient sync (the step's own collective parts) and the experts'
  all-to-alls (4 a layer: 2 forward, 2 backward, each of a rank's (E, C, d)
  slot tensor).
- WORLD 4 also: the JAX bench row lm_moe_ep_scaling_cpu8's shape
  (`train/measure.py` `measure_ep_scaling`: d128/L2/H8, d_ff 256, vocab
  2,048, seq 256, batch 8, 8 experts, top-2, capacity factor E/k = 4, the
  no-drop regime, SGD lr 0.01, f32) at ep 1, 2 and 4 on as many cards, one
  warm-up step and 3 timed steps from the same init and batch: the final
  losses equal across ep within 1e-3, and overhead_vs_ep1 (the wall of the
  timed steps over ep 1's, as the JAX row).

    python3 port_probes/moe_world.py gap         # one card: why 28(c)'s update gap

`gap` reads where phase 28(c)'s update gap comes from, in bf16 (the phase's
dtype) and in f32: the same one-process and 2-rank gloo runs (--dp 2,
depth 2, flash, 4 steps) and their update gap leaf by leaf, and, at the
seeded initial parameters of each, one forward's routing (`route_reading`):
per layer the share of tokens whose top-2 experts differ from the one
process's, the share of (token, choice) pairs dropped at capacity on each
rank and in the one process, and the aux (the ranks' mean against the one
process's). No gate: it prints what it reads.

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`).
"""

import gc
import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "port_probes")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from lm_dp_world import LOSS_TOL, _collective_ms, _reset, _sha  # noqa: E402
from lm_mesh_world import UPDATE_TOL, _argv, _opt, _update, update_rel  # noqa: E402

STEPS = 4
MOE = ["--attn", "flash", "--experts", "8"]
DEPTH2 = ["--n-layers", "2"]
# reference name -> (extra arguments, steps) of its one-process run
REFERENCES = {
    "moe-L2": (MOE + DEPTH2, STEPS),
    "moe": (MOE, STEPS),
}
# world -> [(name, phase, extra arguments, steps, reference)]
RUNS = {
    2: (("dp2-ep2", 28, MOE + DEPTH2 + ["--dp", "2"], STEPS, "moe-L2"),),
    4: (
        ("dp4-ep4", 0, MOE + ["--dp", "4"], STEPS, "moe"),
        ("dp2tp2-ep2", 0, MOE + ["--dp", "2", "--tp", "2"], STEPS, "moe"),
    ),
}
# the JAX bench row lm_moe_ep_scaling_cpu8 (train/measure.py measure_ep_scaling)
EP_SHAPE = {"vocab_size": 2048, "d_model": 128, "n_heads": 8, "n_layers": 2, "d_ff": 256,
            "n_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 4.0}
EP_BATCH, EP_SEQ, EP_STEPS, EP_SIZES, EP_LOSS_TOL = 8, 256, 3, (1, 2, 4), 1e-3


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


def _all_to_all_ms(torch, dist, mesh, args, sync, reps=5) -> float:
    """One all-to-all of a rank's (E, C, d) slot tensor over the data axis,
    timed alone (the median of `reps`, ms)."""
    from distributed_neural_network_tpu_torch.parallel import collectives as C
    from distributed_neural_network_tpu_torch.parallel.moe import expert_capacity

    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    tokens = args.batch_size // mesh.dp // args.accum_steps * args.seq_len
    cap = expert_capacity(tokens, args.experts, 2, 2.0)
    xe = torch.ones(args.experts, cap, args.d_model, dtype=dt, device=mesh.device)
    C.all_to_all(xe, 0, 1, mesh.data)
    times = []
    for _ in range(reps):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        C.all_to_all(xe, 0, 1, mesh.data)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _ep_point(torch, device, ep) -> dict:
    """One point of the ep sweep on create_lm_mesh(ep, 1, 1) (ep 1: this
    process alone): a warm-up step, then EP_STEPS timed steps."""
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.distributed import distribute_host_data
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    cfg = tfm.TransformerConfig(**EP_SHAPE)
    mesh = lmtrain.create_lm_mesh(ep, 1, 1, device=device)
    params, _ = lmtrain.shard_params(tfm.init_params(0, cfg), cfg, mesh)
    mom = lmtrain.init_lm_momentum(params, "sgd", mesh)
    step = lmtrain.make_lm_train_step(cfg, mesh=mesh, device=mesh.device, lr=0.01)
    tok, tgt = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=EP_BATCH,
                                      seq_len=EP_SEQ, vocab=EP_SHAPE["vocab_size"])
    tok, tgt = (distribute_host_data(x, mesh) for x in (tok, tgt))
    float(step(params, mom, tok, tgt, 0))  # build, capture
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(EP_STEPS):
        loss = step(params, mom, tok, tgt, i + 1)
    final = float(loss)
    sync()
    wall = time.perf_counter() - t0
    point = {"ep": ep, "wall_s": wall, "tokens_per_s": EP_BATCH * EP_SEQ * EP_STEPS / wall,
             "final_loss": final, "experts_per_device": EP_SHAPE["n_experts"] // ep,
             "segments": step.segments}
    del step
    gc.collect()
    return point


def route_reading(torch, argv, mesh) -> dict:
    """One no-grad forward of `argv`'s model at its seeded initial
    parameters on this rank's block of the copy-task batch (what lm_train
    starts from), with every `sort_route` call recorded: {"experts": per
    layer this rank's (T, k) top-k experts (uint8, CPU), "dropped": per
    layer the (token, choice) pairs at capacity, "pairs": k x T, "aux"}."""
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel import moe
    from distributed_neural_network_tpu_torch.parallel.distributed import distribute_host_data
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    a = lm_train.build_parser().parse_args(argv)
    cfg = tfm.TransformerConfig(vocab_size=a.vocab, d_model=a.d_model, n_heads=a.n_heads,
                                n_layers=a.n_layers, d_ff=a.d_ff, n_experts=a.experts,
                                dtype=torch.bfloat16 if a.dtype == "bfloat16" else torch.float32)
    params, _ = lmtrain.shard_params(tfm.init_params(a.seed, cfg), cfg, mesh)
    tok, _ = lmtrain.make_copy_task(torch.Generator().manual_seed(a.seed + 1),
                                    batch=a.batch_size, seq_len=a.seq_len, vocab=a.vocab)
    tok = distribute_host_data(tok, mesh)
    rec = {"experts": [], "dropped": []}
    sort_route = moe.sort_route

    def route(probs, top_k, capacity):
        out = sort_route(probs, top_k, capacity)
        rec["experts"].append(probs.topk(top_k, dim=-1, sorted=True).indices.to(torch.uint8).cpu())
        rec["dropped"].append(int((out[1] == capacity).sum()))
        return out

    moe.sort_route = route
    try:
        with torch.no_grad():
            _, aux = tfm.apply_hidden(params, tok, cfg, ep_axis=lmtrain.expert_axis(cfg, mesh),
                                      attn_impl=a.attn)
    finally:
        moe.sort_route = sort_route
    rec.update(pairs=rec["experts"][0].numel(), aux=float(aux))
    return rec


def rank_main(spec: dict) -> int:
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.parallel.distributed import initialize, joined
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    device = spec["device"]
    initialize(device=device, log=lambda line: None)
    rank = dist.get_rank() if joined() else 0
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    info = {"rank": rank, "runs": {}}
    try:
        if spec.get("ep") is not None:
            info["ep_point"] = _ep_point(torch, device, spec["ep"])
            return 0
        world, lm_args = spec["world"], spec["lm_args"]
        runs = RUNS[world]
        if spec.get("gap"):
            runs = [("dp2-ep2", 0, gap_args(spec["gap"]) + ["--dp", "2"], STEPS,
                     f"gap-{spec['gap']}")]
            mesh = lmtrain.create_lm_mesh(world, 1, 1, device=device)
            torch.save(route_reading(torch, _argv(lm_args, device, runs[0][2], STEPS), mesh),
                       os.path.join(spec["out"], f"routes_rank{rank}.pt"))
        for name, phase, extra, steps, ref_name in runs:
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
            launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
            whole = lmtrain.gather_params(res["params"], res["specs"], mesh)
            args = lm_train.build_parser().parse_args(argv)
            rel = None
            if rank == 0:  # the ranks' trees are equal (`check` holds them to it)
                ref = torch.load(os.path.join(spec["updates"], f"{ref_name}.pt"))
                rel = update_rel(_update(whole, argv), ref)
                del ref
            a2a = _all_to_all_ms(torch, dist, mesh, args, sync)
            info["runs"][name] = {
                "phase": phase, "losses": res["losses"], "launches": launches,
                "routes": routes, "cards": res["cards"], "mesh": mesh.desc,
                "seconds": seconds, "summary": next(l for l in lines if l.startswith("SUMMARY ")),
                "log": [l for l in lines if l.startswith("(")],
                "form": step.collective_form, "backend": mesh.backend,
                "segments": step.segments,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
                "collective_ms": {"sync": _collective_ms(torch, dist, step, sync),
                                  "all_to_all_one": a2a,
                                  "all_to_all": a2a * 4 * args.n_layers * args.accum_steps},
                "params_sha": _sha(lmtrain.tree_leaves(whole)), "update_rel": rel}
            del res, step, whole
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        gc.collect()
        if joined():
            dist.destroy_process_group()
    return 0


def _launch(world, spec, out, timeout, env=None, joined=True):
    from torch_rank_worker import launch

    os.makedirs(out, exist_ok=True)
    procs = launch(world, dict(spec, out=out), timeout=timeout, env=env, joined=joined,
                   script=os.path.abspath(__file__))
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


def run_world(world: int, out: str, lm_args, updates, *, device="cuda", timeout=900, env=None):
    """Launch the ranks (tests/torch_rank_worker.py `launch`) against the
    one-process updates saved in `updates` (`reference`): every rank's
    record, or a RuntimeError with the failing rank's errors."""
    spec = {"device": device, "world": world, "lm_args": list(lm_args), "updates": updates}
    return _launch(world, spec, out, timeout, env)


def ep_scaling(out: str, *, device="cuda", sizes=EP_SIZES, timeout=600, env=None) -> dict:
    """The lm_moe_ep_scaling_cpu8 sweep: one launch per ep (ep 1 a process
    that joins no group); the points, overhead_vs_ep1 and the loss spread
    (raises AssertionError beyond EP_LOSS_TOL)."""
    points = []
    for ep in sizes:
        ranks = _launch(ep, {"device": device, "ep": ep}, os.path.join(out, f"ep{ep}"), timeout,
                        env, joined=ep > 1)
        losses = {r["ep_point"]["final_loss"] for r in ranks}
        assert len(losses) == 1, f"ep {ep}: the ranks' losses differ: {losses}"
        points.append(ranks[0]["ep_point"])
    for p in points:
        p["overhead_vs_ep1"] = p["wall_s"] / points[0]["wall_s"]
    spread = max(p["final_loss"] for p in points) - min(p["final_loss"] for p in points)
    assert spread <= EP_LOSS_TOL, f"final losses across ep differ by {spread}: {points}"
    return {"points": points, "loss_spread": spread,
            "overhead_vs_ep1_max": max(p["overhead_vs_ep1"] for p in points)}


def flash_counts(n: int) -> dict:
    """The flash launches a rank makes over n = layers x steps (one forward,
    dq and dkv each)."""
    return {"flash_fwd": n, "flash_fwd_quant": 0, "flash_dq": n, "flash_dkv": n}


def check(world, ranks, ref, lm_args, *, mma_counts, launches=flash_counts):
    """The checks over the ranks' records; returns what they print (raises
    AssertionError naming the failing check). `launches(layers x steps)`:
    the flash launches a rank must make (`flash_counts`; on the CPU, where
    no kernel launches, a formula of zeros)."""
    out = {}
    for name, _, extra, steps, ref_name in RUNS[world]:
        recs = [r["runs"][name] for r in ranks]
        s0 = recs[0]
        for key in ("summary", "params_sha", "losses"):
            assert all(r[key] == s0[key] for r in recs), f"{name}: the ranks' {key} differ"
        summary = json.loads(s0["summary"][8:])
        dp, tp = (int(_opt(extra, f"--{a}", 1)) for a in ("dp", "tp"))
        want_mesh = "x".join(f"{k}{n}" for k, n in (("data", dp), ("model", tp)) if n > 1)
        assert summary["mesh"] == s0["mesh"] == want_mesh, f"{name}: mesh {summary['mesh']}"
        from distributed_neural_network_tpu_torch import lm_train
        from distributed_neural_network_tpu_torch.train.lm import EXPERT_LEAVES

        want = launches(lm_train.build_parser().parse_args(
            _argv(lm_args, "cpu", extra, steps)).n_layers * steps)
        for r, rec in enumerate(recs):
            assert rec["launches"] == want, f"{name}: rank {r} launches {rec['launches']} != {want}"
            assert rec["routes"] == mma_counts(want), (
                f"{name}: rank {r} launches by route {rec['routes']}")
        assert "experts=8" in " ".join(s0["log"]), f"{name}: log {s0['log']}"
        if s0["backend"] == "nccl":
            assert all(r["segments"] == "graph" for r in recs), (
                f"{name}: not one CUDA graph a step: {[r['segments'] for r in recs]}")
        rel = max(abs(a - c) / abs(c) for a, c in zip(s0["losses"], ref[ref_name]))
        assert rel <= LOSS_TOL, f"{name}: losses {s0['losses']} vs one process {ref[ref_name]}"
        leaf, worst = max(s0["update_rel"].items(), key=lambda kv: kv[1])
        assert worst <= UPDATE_TOL, (
            f"{name}: the parameter update of {leaf!r} is {worst:.3e} (relative L2) from the one "
            f"process run's, above {UPDATE_TOL}")
        experts = {k: v for k, v in s0["update_rel"].items()
                   if k in EXPERT_LEAVES}
        out[name] = {"losses": s0["losses"], "reference": ref_name,
                     "max_rel_vs_one_process": rel, "update_rel_max": worst,
                     "update_rel_leaf": leaf, "update_rel_experts": experts,
                     "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (steps - 1),
                     "tokens_per_s": summary["tokens_per_s"], "mfu_pct": summary["mfu_pct"],
                     "form": s0["form"], "backend": s0["backend"], "cards": s0["cards"],
                     "segments": s0["segments"], "launches_per_rank": s0["launches"],
                     "collective_ms": [r["collective_ms"] for r in recs],
                     "seconds": max(r["seconds"] for r in recs),
                     "peak_mem_gib": [r["peak_mem_gib"] for r in recs]}
    return out


def gap_args(dtype: str) -> list:
    return MOE + DEPTH2 + ["--dtype", dtype]


def gap(lm_args, out: str, updates: str, device="cuda") -> dict:
    """The `gap` reading (module docstring) on one card: {dtype: {"update_rel"
    (leaf: relative L2), "flipped" (per layer), "dropped_one", "dropped_ranks"
    (per layer, shares of the pairs), "aux_one", "aux_ranks_mean"}}."""
    import torch

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh

    res = {}
    for dtype in ("bfloat16", "float32"):
        argv = _argv(lm_args, device, gap_args(dtype), STEPS)
        one = route_reading(torch, argv, ProcessMesh(1, torch.device(device)))
        run = {}
        lm_train.main(argv, log=lambda line: None, result=run)
        os.makedirs(updates, exist_ok=True)
        torch.save(_update(run["params"], argv), os.path.join(updates, f"gap-{dtype}.pt"))
        del run
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        where = os.path.join(out, f"gap_{dtype}")
        spec = {"device": device, "world": 2, "lm_args": list(lm_args), "updates": updates,
                "gap": dtype}
        ranks = _launch(2, spec, where, 900)
        reads = [torch.load(os.path.join(where, f"routes_rank{r}.pt")) for r in range(2)]
        flipped = []
        for layer, want in enumerate(one["experts"]):
            got = torch.cat([r["experts"][layer] for r in reads])
            differ = (got.sort(dim=1).values != want.sort(dim=1).values).any(dim=1)
            flipped.append(float(differ.float().mean()))
        res[dtype] = {
            "update_rel": ranks[0]["runs"]["dp2-ep2"]["update_rel"],
            "losses": ranks[0]["runs"]["dp2-ep2"]["losses"],
            "flipped": flipped,
            "dropped_one": [d / one["pairs"] for d in one["dropped"]],
            "dropped_ranks": [[d / r["pairs"] for d in r["dropped"]] for r in reads],
            "aux_one": one["aux"], "aux_ranks_mean": sum(r["aux"] for r in reads) / 2}
        print(f"gap {dtype}: {json.dumps(res[dtype])}", flush=True)
    return res


def main(world) -> int:
    import subprocess

    from chip_smoke import LM_ARGS, mma_counts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"moe_world{world}")
    updates = os.path.join(ROOT, "runs", f"moe_world{world}_updates")
    t0 = time.perf_counter()
    if world == "gap":
        try:
            res = gap(LM_ARGS, out, updates)
        finally:
            shutil.rmtree(updates, ignore_errors=True)
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(f"moe_world gap: ok ({time.perf_counter() - t0:.1f} s)")
        return 0
    try:
        ref = reference(LM_ARGS, sorted({r[-1] for r in RUNS[world]}), updates=updates)
        print(f"one process: {json.dumps(ref)} ({time.perf_counter() - t0:.1f} s)", flush=True)
        import torch

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_world(world, out, LM_ARGS, updates, timeout=1500)
        res = check(world, ranks, ref, LM_ARGS, mma_counts=mma_counts)
        print(f"{world} ranks ({time.perf_counter() - t0:.1f} s with start-up)", flush=True)
        if world == 4:
            t0 = time.perf_counter()
            res["ep_scaling"] = ep_scaling(out)
            print(f"ep sweep ({time.perf_counter() - t0:.1f} s with start-up)", flush=True)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(updates, ignore_errors=True)
    for name, row in res.items():
        print(f"{name}: {json.dumps(row)}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump({"one_process": ref, "runs": res}, f, indent=1)
    print("moe_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    arg = sys.argv[1] if len(sys.argv) > 1 else "4"
    sys.exit(main(arg if arg == "gap" else int(arg)))
