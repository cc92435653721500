#!/usr/bin/env python3
"""The LM on the model and sequence axes at full width: WORLD ranks of the
port's LM entry point (`lm_train.main` with --dp/--sp/--tp under a process
group) against one process on the same global batch.

    python3 port_probes/lm_mesh_world.py [WORLD]     # from the repo root; 2 or 4 (default)

WORLD 4 needs four cards: each rank on its own card, so
`parallel/distributed.py` picks NCCL and the step is one CUDA graph,
collectives included. WORLD 2 is `chip_smoke.py` phases 24-25: 2 ranks
that share the one card over gloo (`run_world`), where the forward and
backward, which hold the model / sequence collectives, run eagerly between
the step's graphs. At chip_smoke.py's flagship width (LM_ARGS:
d512/L8/H8, d_ff 2048, vocab 32,768, seq 2,048, bf16) the runs of RUNS:

- tensor parallel at --attn flash (the flash kernels on H/tp heads; at 2
  ranks also --precision int8, the quantized forward) and the
  sequence axis at --attn ring / ulysses / zigzag (plain attention blocks;
  global batch 8, cut from 16: the one-process plain reference holds (B, H,
  S, S) scores), each held to its one-process run (`reference`): every
  step's loss within LOSS_TOL relative, and the run's parameter update
  (gathered parameters minus the seeded initial ones) within UPDATE_TOL of
  the one-process run's in relative L2, leaf by leaf;
- every rank's SUMMARY line, losses and gathered parameters
  (`gather_params`) the same; each rank's flash launches the formula, all
  on the mma route, at the (B, S, H/tp, D) its kernels saw (one of the
  shapes chip_smoke.py phase 12 holds against the plain versions); under
  NCCL the step one CUDA graph;
- per run: ms per step, tokens/s, MFU (over the cards the ranks use), the
  step program's segments and the collectives' time per step: the sync
  parts run alone on the step's buffers (`step.collectives`) plus the
  model / sequence collectives of the forward and backward, each timed
  alone at its shape on the mesh's group and multiplied by its count.

Prints the cards' names and power limits first; exits 1 if a check fails.
The rank side is this file run with a JSON spec (`rank_main`, the runs in
`rank_runs`; another probe's launch runs them with `make_spec`).
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

from lm_dp_world import LOSS_TOL, _reset, _sha  # noqa: E402

SP_BATCH = ["--batch-size", "8"]
# a run's parameter update against its one-process run's, each leaf in
# relative L2 (||u - u_ref|| / ||u_ref||; u the gathered parameters minus
# the seeded initial ones). Measured at 2 ranks on one NVIDIA H100 80GB
# HBM3 (700.00 W), bf16 sums in another order: the sgd runs 0.015-0.025
# (embed), adam 0.069 (layers/ln2_scale). A replicated leaf's gradient
# also summed over the model axis (tp times too large) doubles its sgd
# update at tp 2, about 1.0 here; adam's update hardly moves with the
# gradient's scale, so the sgd runs are the ones that catch it.
UPDATE_TOL = 0.2
# reference name -> (extra arguments, steps) of its one-process run
REFERENCES = {
    "flash-sgd": (["--attn", "flash"], 4),
    "flash-adam": (["--attn", "flash", "--optimizer", "adam"], 4),
    "flash-int8": (["--attn", "flash", "--precision", "int8"], 4),
    "flash-accum4": (["--attn", "flash", "--accum-steps", "4"], 3),
    "ring-b8": (["--attn", "ring"] + SP_BATCH, 4),
}
# world -> [(name, phase, extra arguments, steps, reference)]
RUNS = {
    2: (
        ("tp2-sgd", 24, ["--tp", "2", "--attn", "flash"], 4, "flash-sgd"),
        ("tp2-adam", 24, ["--tp", "2", "--attn", "flash", "--optimizer", "adam"], 4,
         "flash-adam"),
        ("tp2-int8", 24, ["--tp", "2", "--attn", "flash", "--precision", "int8"], 4,
         "flash-int8"),
        ("sp2-ring", 25, ["--sp", "2", "--attn", "ring"] + SP_BATCH, 4, "ring-b8"),
        ("sp2-ulysses", 25, ["--sp", "2", "--attn", "ulysses"] + SP_BATCH, 4, "ring-b8"),
        ("sp2-zigzag", 25, ["--sp", "2", "--attn", "zigzag"] + SP_BATCH, 4, "ring-b8"),
        ("dp2", 25, ["--dp", "2", "--attn", "flash"], 4, "flash-sgd"),
    ),
    4: (
        ("tp4", 0, ["--tp", "4", "--attn", "flash"], 4, "flash-sgd"),
        ("dp2tp2-end", 0, ["--dp", "2", "--tp", "2", "--attn", "flash", "--accum-steps", "4"],
         3, "flash-accum4"),
        ("dp2tp2-overlap", 0, ["--dp", "2", "--tp", "2", "--attn", "flash", "--accum-steps", "4",
                               "--grad-sync", "overlap", "--bucket-mb", "4"], 3, "flash-accum4"),
        ("sp4-ring", 0, ["--sp", "4", "--attn", "ring"] + SP_BATCH, 4, "ring-b8"),
        ("sp4-ulysses", 0, ["--sp", "4", "--attn", "ulysses"] + SP_BATCH, 4, "ring-b8"),
        ("sp4-zigzag", 0, ["--sp", "4", "--attn", "zigzag"] + SP_BATCH, 4, "ring-b8"),
        ("dp2sp2-ring", 0, ["--dp", "2", "--sp", "2", "--attn", "ring"] + SP_BATCH, 4, "ring-b8"),
    ),
}


def _argv(lm_args, device, extra, steps):
    """The run's `lm_train` arguments: LM_ARGS, then `extra` (a later flag
    wins: the sequence runs' --batch-size 8)."""
    return (["--device", device, "--steps", str(steps), "--log-every", "10"] + list(lm_args)
            + list(extra))


def _opt(extra, flag, default):
    return extra[extra.index(flag) + 1] if flag in extra else default


def _update(whole, argv) -> dict:
    """{leaf path: the run's update} (f32 on the CPU): the whole parameter
    tree `whole` minus the seeded initial tree that `lm_train` starts from."""
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.rules import named_leaves

    a = lm_train.build_parser().parse_args(argv)
    cfg = tfm.TransformerConfig(vocab_size=a.vocab, d_model=a.d_model, n_heads=a.n_heads,
                                n_layers=a.n_layers, d_ff=a.d_ff, n_experts=a.experts)
    init = dict(named_leaves(tfm.init_params(a.seed, cfg)))
    return {path: x.detach().float().cpu() - init[path] for path, x in named_leaves(whole)}


def update_rel(update: dict, ref: dict) -> dict:
    """{leaf path: ||update - ref|| / ||ref||}, relative L2 leaf by leaf."""
    return {path: float((u - ref[path]).norm() / ref[path].norm().clamp_min(1e-30))
            for path, u in update.items()}


def reference(lm_args, names, device="cuda", updates=None):
    """The one-process runs of REFERENCES `names`: {name: per-step losses};
    with `updates`, a directory, each run's update (`_update`) saved there
    as <name>.pt for the ranks to compare with."""
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


def _median_ms(torch, dist, fn, sync, reps=5) -> float:
    fn()
    times = []
    for _ in range(reps):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _mesh_collectives(torch, dist, step, mesh, args, sync) -> dict:
    """The step's collectives per step, each timed alone on the mesh's
    groups (ms): "sync" (the step's own collective parts, as phase 21),
    "model" (4 all-reduces of a (B/dp, S/sp, d) activation per layer and
    micro-batch: two forward `reduce_from_model`, two backward
    `copy_to_model`), "seq" (ring / zigzag: 4(n-1) ppermutes of a K or V
    block per layer, forward and backward; ulysses: 8 all-to-alls)."""
    from distributed_neural_network_tpu_torch.parallel import collectives as C

    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    b = args.batch_size // mesh.dp // args.accum_steps
    s = args.seq_len // mesh.sp
    layers, micro = args.n_layers, args.accum_steps
    out = {"sync": _median_ms(torch, dist, lambda: [c() for c in step.collectives], sync)
           if step.collectives else 0.0}
    if mesh.tp > 1:
        x = torch.ones(b, s, args.d_model, dtype=dt, device=mesh.device)
        one = _median_ms(torch, dist, lambda: dist.all_reduce(x, group=mesh.model.group), sync)
        out["model"] = one * 4 * layers * micro
    if mesh.sp > 1:
        h = args.n_heads // mesh.tp
        blk = torch.ones(b, s, h, args.d_model // args.n_heads, dtype=dt, device=mesh.device)
        n = mesh.sp
        if args.attn == "ulysses":
            one = _median_ms(torch, dist, lambda: C.all_to_all(blk, 2, 1, mesh.seq), sync)
            out["seq"] = one * 8 * layers * micro
        else:
            perm = [(i, (i + 1) % n) for i in range(n)]
            one = _median_ms(torch, dist, lambda: C.ppermute(blk, perm, mesh.seq), sync)
            out["seq"] = one * 4 * (n - 1) * layers * micro
    out["total"] = sum(out.values())
    return out


def rank_main(spec: dict) -> int:
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel.distributed import initialize
    from torch_rank_worker import run_then

    initialize(device=spec["device"], log=lambda line: None)
    try:
        rank_runs(spec, dist.get_rank())
        # other probes' runs in this launch of the ranks (`run_world(then=)`)
        run_then(spec, dist.get_rank())
    finally:
        gc.collect()
        if dist.is_initialized():  # a shrink run among `then` may have left the group
            dist.destroy_process_group()
    return 0


def rank_runs(spec: dict, rank: int) -> dict:
    """This rank's RUNS[world] in the process group it has joined; writes
    its record as ``rank{r}.json`` under the spec's ``out`` (also when a run
    fails) and returns it (also in another probe's ranks:
    `torch_rank_worker.run_then`, with `make_spec`)."""
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    device, world, lm_args = spec["device"], spec["world"], spec["lm_args"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the (B, S, H, D) of every flash call: the shapes the kernels see
    shapes = set()
    inner = flash.flash_mha

    def seen(q, k, v, **kw):
        shapes.add(tuple(q.shape))
        return inner(q, k, v, **kw)

    flash.flash_mha = seen
    info = {"rank": rank, "runs": {}}
    try:
        for name, phase, extra, steps, ref_name in RUNS[world]:
            _reset(fa.LAUNCHES, fa.ROUTE_LAUNCHES)
            shapes.clear()
            lines, res = [], {}
            argv = _argv(lm_args, device, extra, steps)
            sync()
            t0 = time.perf_counter()
            lm_train.main(argv, log=lines.append, result=res)
            seconds = time.perf_counter() - t0
            step, mesh = res["step"], res["mesh"]
            whole = lmtrain.gather_params(res["params"], res["specs"], mesh)
            args = lm_train.build_parser().parse_args(argv)
            rel = None
            if rank == 0:  # the ranks' trees are equal (`check` holds them to it)
                ref = torch.load(os.path.join(spec["updates"], f"{ref_name}.pt"))
                rel = update_rel(_update(whole, argv), ref)
                del ref
            info["runs"][name] = {
                "phase": phase, "losses": res["losses"], "launches": dict(fa.LAUNCHES),
                "routes": dict(fa.ROUTE_LAUNCHES), "flash_shapes": sorted(shapes),
                "cards": res["cards"], "mesh": mesh.desc, "seconds": seconds,
                "summary": next(l for l in lines if l.startswith("SUMMARY ")),
                "log": [l for l in lines if l.startswith("(")],
                "form": step.collective_form, "backend": mesh.backend,
                "segments": step.segments, "n_collectives": len(step.collectives),
                "collective_ms": _mesh_collectives(torch, dist, step, mesh, args, sync),
                "params_sha": _sha(lmtrain.tree_leaves(whole)), "update_rel": rel}
            del res, step, whole
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        flash.flash_mha = inner
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    return info


def make_spec(world: int, out: str, lm_args, updates, *, device="cuda") -> dict:
    """The ranks' spec of RUNS[world] against the one-process updates in
    `updates` (`reference`), records under `out`."""
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


def run_world(world: int, out: str, lm_args, updates, *, device="cuda", timeout=900, env=None,
              then=()):
    """Launch the ranks (tests/torch_rank_worker.py `launch`) against the
    one-process updates saved in `updates` (`reference`): every rank's
    record, or a RuntimeError with the failing rank's errors. `then`:
    [(a probe module, its `make_spec`)] run by the same ranks after these
    (`torch_rank_worker.run_then`); their records are read with the
    module's `read_ranks`."""
    from torch_rank_worker import launch

    spec = {**make_spec(world, out, lm_args, updates, device=device),
            "then": [list(t) for t in then]}
    procs = launch(world, spec, timeout=timeout, env=env, script=os.path.abspath(__file__))
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log"), "w") as f:
            f.write(p.stdout + "\n" + p.stderr)
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
    return read_ranks(world, out)


def check(world, ranks, ref, lm_args, *, flash_counts, mma_counts, flash_checked):
    """The checks over the ranks' records; returns what they print (raises
    AssertionError naming the failing check). `flash_checked`: the (B, S, H,
    D) shapes at which the flash kernels are held to their plain versions."""
    out = {}
    base = dict(zip(lm_args[::2], lm_args[1::2]))
    for name, _, extra, steps, ref_name in RUNS[world]:
        recs = [r["runs"][name] for r in ranks]
        s0 = recs[0]
        for key in ("summary", "params_sha", "losses"):
            assert all(r[key] == s0[key] for r in recs), f"{name}: the ranks' {key} differ"
        accum = int(_opt(extra, "--accum-steps", 1))
        summary = json.loads(s0["summary"][8:])
        dp, sp, tp = (int(_opt(extra, f"--{a}", 1)) for a in ("dp", "sp", "tp"))
        assert summary["mesh"] == s0["mesh"] and s0["mesh"] == "x".join(
            f"{k}{v}" for k, v in (("data", dp), ("seq", sp), ("model", tp)) if v > 1), (
            f"{name}: mesh {summary['mesh']}")
        flash_run = _opt(extra, "--attn", "ring") == "flash"
        quant = _opt(extra, "--precision", "bf16") != "bf16"
        want = flash_counts(steps, accum=accum, quant=quant) if flash_run else flash_counts(0)
        for r, rec in enumerate(recs):
            assert rec["launches"] == want, f"{name}: rank {r}'s flash launches {rec['launches']}"
            assert rec["routes"] == mma_counts(want), f"{name}: rank {r}'s routes {rec['routes']}"
        b = int(_opt(extra, "--batch-size", base["--batch-size"]))
        heads = int(base["--n-heads"]) // tp
        d = int(base["--d-model"]) // int(base["--n-heads"])
        if flash_run:
            want_shape = [b // dp // accum, int(base["--seq-len"]), heads, d]
            assert all(r["flash_shapes"] == [want_shape] for r in recs), (
                f"{name}: the flash kernels saw {[r['flash_shapes'] for r in recs]}, want "
                f"{want_shape}")
            assert tuple(want_shape) in flash_checked, (
                f"{name}: the flash kernels ran at {want_shape}, not among the shapes held to "
                f"their plain versions {flash_checked}")
        if s0["backend"] == "nccl":
            assert all(r["segments"] == "graph" for r in recs), (
                f"{name}: not one CUDA graph a step: {[r['segments'] for r in recs]}")
        rel = max(abs(a - c) / abs(c) for a, c in zip(s0["losses"], ref[ref_name]))
        assert rel <= LOSS_TOL, f"{name}: losses {s0['losses']} vs one process {ref[ref_name]}"
        leaf, worst = max(s0["update_rel"].items(), key=lambda kv: kv[1])
        assert worst <= UPDATE_TOL, (
            f"{name}: the parameter update of {leaf!r} is {worst:.3e} (relative L2) from the one "
            f"process run's, above {UPDATE_TOL}")
        out[name] = {
            "losses": s0["losses"], "reference": ref_name, "max_rel_vs_one_process": rel,
            "update_rel_max": worst, "update_rel_leaf": leaf, "update_rel": s0["update_rel"],
            "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (steps - 1),
            "tokens_per_s": summary["tokens_per_s"], "mfu_pct": summary["mfu_pct"],
            "cards": s0["cards"], "launches_per_rank": s0["launches"],
            "flash_shapes": s0["flash_shapes"], "form": s0["form"], "backend": s0["backend"],
            "segments": s0["segments"], "seconds": max(r["seconds"] for r in recs),
            "collective_ms": [r["collective_ms"] for r in recs]}
    return out


def main(world: int) -> int:
    import subprocess

    from chip_smoke import FLASH_MAIN, FLASH_MESH, LM_ARGS, flash_counts, mma_counts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"lm_mesh_world{world}")
    updates = os.path.join(ROOT, "runs", f"lm_mesh_world{world}_updates")
    t0 = time.perf_counter()
    try:
        ref = reference(LM_ARGS, sorted({r[-1] for r in RUNS[world]}), updates=updates)
        print(f"one process: {json.dumps(ref)} ({time.perf_counter() - t0:.1f} s)", flush=True)
        import torch

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_world(world, out, LM_ARGS, updates, timeout=1500)
        res = check(world, ranks, ref, LM_ARGS, flash_counts=flash_counts,
                    mma_counts=mma_counts, flash_checked=(FLASH_MAIN,) + FLASH_MESH)
    except (AssertionError, RuntimeError) as e:
        print(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(updates, ignore_errors=True)
    print(f"{world} ranks ({time.perf_counter() - t0:.1f} s with start-up)")
    for name, row in res.items():
        print(f"{name}: {json.dumps({k: v for k, v in row.items() if k != 'update_rel'})}")
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump({"one_process": ref, "runs": res}, f, indent=1)
    print("lm_mesh_world: ok")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("{"):
        sys.exit(rank_main(json.loads(sys.argv[1])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
