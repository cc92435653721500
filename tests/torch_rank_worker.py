"""One rank of a torch.distributed run of the port's CNN engine or LM
train step, and the launcher that starts the ranks (used by
tests/test_torch_distributed.py and tests/test_torch_lm_dp.py on the CPU and
by chip_smoke.py phase 17 on the card).

    python tests/torch_rank_worker.py SPEC_JSON

with torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR, MASTER_PORT) in the environment, as `launch` sets them; at
world 1 without MASTER_ADDR it runs as one process that joins no group (the
in-process reference). The spec:

- ``device``: "cpu" or "cuda";
- ``out``: the directory for the results;
- ``sync`` (optional): {"n", "p", "seed"}: a seeded (n, p) float32 stack
  and five live masks (all dead among them); the rank puts its block of
  rows into a `RowGather`, reduces over the group and checks the masked
  mean of the gathered stack bit for bit against the masked mean of the
  whole stack; writes ``sync_rank{r}.json``;
- ``runs``: a list of {"name", "config" (TrainConfig fields), "train",
  "test" ({"size", "seed"} of a synthetic split), optional "profile"}:
  each trains its epochs per epoch and writes ``{name}_rank{r}.npz`` (the
  initial and final params, the JAX tree form flattened to "layer/leaf"
  keys) and ``{name}_rank{r}.json`` (history, each epoch's wall seconds,
  mesh, the backend, each program's graphs and eager parts). With
  "profile" (on the card) the last epoch runs under torch.profiler, and the
  json holds its span on the host's clock and the device's busy intervals
  relative to the trace's start (`_profiled_epoch`), so that the ranks'
  traces can be merged where both clocks agree (`busy_union`). With
  "resume": {"stop"} the run is trained three times through `Engine.run`
  with a `utils/checkpoint.py` `Checkpointer` (a checkpoint every epoch,
  rank 0 writing into ``{name}_{whole|stopped}/`` under "out"):
  uninterrupted for its epochs, to "stop" epochs, then restored
  (`restore_latest`) and run to its epochs; writes
  ``{name}_rank{r}.json`` with each leg's history and the resumed leg's
  start epoch and this rank's momentum rows right after the restore
  (``{name}_rank{r}.npz``, "mom/layer/leaf");
- ``lm`` (optional): {"params": an .npz of a parameter tree (keys
  "layer/leaf" or "leaf"), "batches": an .npz of "tokens" and "targets"
  (steps, B, S) global batches, "cfg": TransformerConfig fields, "cases":
  [{"name", "kw" (make_lm_train_step arguments), "steps", optional "mesh"
  [dp, sp, tp] (default [world, 1, 1]), "cfg" (fields over the spec's)
  and "eval" (true: also the eval loss)}]}: each case builds the mesh over
  the group (`create_lm_mesh`), cuts the parameters for this rank
  (`shard_params`), with "eval" runs `make_eval_fn` on each step's batch
  at the initial parameters (each rank passing the rows lm_train.py gives
  it), makes the optimizer state and the step, feeds each step this rank's
  block (`distribute_host_data`; under zigzag with sp > 1 the batch
  permuted first, as the CLI does) and writes ``lm_{name}_rank{r}.npz``:
  the losses, the eval losses ("eval", empty without "eval"), the final
  parameters ("params/<path>", gathered over the model axis:
  `gather_params`) and optimizer state ("state/<path>", gathered
  likewise; this rank's shards under zero), the step's bucket count,
  collective count and segments;
- ``pp`` (optional): {"params": {key: an .npz of a parameter tree},
  "batches": an .npz of "tokens" and "targets" (steps, B, S), "cases":
  [{"name", "kind": "loss" | "grads" | "train", "mesh": [dp, pp, tp],
  "params" (a key of "params"), "cfg" (TransformerConfig fields), "m"
  (microbatches), "v" (interleave), "rows" (the global batch's first rows),
  "kw" (make_pp_train_step arguments), "steps"}]}: each case builds
  `create_pp_mesh`, cuts this rank's stage with `shard_pp_params` and feeds
  its data shard: "loss" runs `pipeline_lm_loss` without gradient and sums
  the shares over (data, pipe); "grads" also runs the backward and sums the
  gradients as the step does (layer leaves over data, the others over
  (data, pipe), expert leaves under expert parallelism not at all),
  gathered over every axis (`gather_params`: the layer axis in the
  interleaved order); "train" runs the step. Writes
  ``pp_{name}_rank{r}.npz``: the losses, "grads/<path>" or the gathered
  "params/<path>" and "state/<path>" (this rank's shards under zero), the
  number of block exchanges (`collectives._exchange`: ppermute and
  all-to-all, forward and backward) and the head's calls and rows
  (`pipeline.head_ce`) of the last forward;
- ``attn`` (optional): {"qkv": an .npz of (B, S, H, D) "q", "k", "v" and
  the output weight "w", "cases": [{"name", "fn": "ring" | "ulysses" |
  "zigzag", "causal", "heads" (optional: the first this many heads)}]}: the
  sequence axis is the whole group; each rank takes its contiguous shard
  of S (of the zigzag-ordered sequence for "zigzag"), runs the function
  and the backward of sum(o * w) and writes ``attn_{name}_rank{r}.npz``
  with its shard of o and of the q, k and v gradients, or "error" (the
  text of a ValueError);
- ``moe`` (optional): {"inputs": an .npz of the whole "x" (T, d), router
  "wr" (d, E), experts "w1" (E, d, F), "b1", "w2", "b2" and output weights
  "w" (T, d), "cases": [{"name", "mesh": [dp, tp], "top_k", "capacity",
  "impl", "z"}]}: on create_lm_mesh(dp, 1, tp) each rank takes its block of
  the tokens and of the experts (data axis) and of the hidden columns
  (model axis), runs `moe_ffn` with the data axis as the expert axis and
  the backward of sum(y * w) + aux, and writes ``moe_{name}_rank{r}.npz``:
  its y, aux and the gradients (the router's summed over the data axis,
  the rest this rank's blocks);
- ``norms`` (optional): {"seed", "cfg"}: a seeded whole gradient tree of
  the LM's shapes (`norm_inputs`), cut for this rank of create_lm_mesh(1,
  1, world) by `shard_params`; writes ``norms_rank{r}.npz``: the
  `per_leaf_sq_norms` and `global_norm` over the model-axis specs;
- ``buckets`` (optional): {"seed", "cap"}: seeded leaves that differ by
  rank (f32, and a bf16 run of leaves); writes ``buckets_rank{r}.npz``: the
  bucketed mean (`bucketed_psum`), the per-leaf all-reduce mean, and the
  reduce-scatter / all-gather round trip (`make_overlap_grad_reducers`:
  `reduce_scatter_buckets`, `all_gather_buckets`) with this rank's shards;
- ``reshard`` (optional): {"seed", "cfg", "cases": [[dp, pp], ...]}: for
  each case, on `create_lm_mesh(dp)` (pp 1) or `create_pp_mesh(dp, pp)`, a
  seeded whole parameter tree of the cfg's shapes and momentum tree laid
  out as ZeRO buffers (`parallel/reshard.py` `momentum_to_zero_tree` /
  `momentum_to_pp_zero_tree`), this rank's shards cut by `place_tree`, and
  the collective reassembly (`make_zero_gather_fn` /
  `make_pp_zero_gather_fn`) held to the host transform
  (`zero_tree_to_momentum` / `pp_zero_tree_to_momentum`) bit for bit;
  writes ``reshard_rank{r}.json``: per case the leaves compared, whether
  every one was equal and the collective form;
- ``zero`` (optional): {"seed"}: one summed gradient (the same on every
  rank) and each rank's own partial gradients; writes ``zero_rank{r}.npz``:
  the parameters and state after `zero_sgd_step_sharded`,
  `zero_adam_step_sharded` (from summed and from partial gradients),
  `zero_sgd_step`, and the replicated `sgd_step` / `adam_step`.

Imports the port and numpy only (no JAX).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat_params(tree) -> dict:
    return {f"{layer}/{leaf}": v for layer, d in tree.items() for leaf, v in d.items()}


def busy_union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profiled_epoch(eng, epoch):
    """Run `epoch` under torch.profiler: (metrics, {its span on the host's
    clock (`time.time_ns`), the trace's start on the profiler's clock and
    the device's busy intervals relative to it}, all in microseconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        m = eng.run_epoch(epoch)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    busy = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    return m, {"start_us": t0 / 1e3, "end_us": t1 / 1e3, "busy": busy,
               "trace_start_us": prof.profiler.kineto_results.trace_start_ns() / 1e3}


def _sync_check(spec, rank, out):
    import numpy as np
    import torch

    from distributed_neural_network_tpu_torch.parallel.collectives import RowGather, masked_mean
    from distributed_neural_network_tpu_torch.parallel.mesh import create_mesh

    n, p = spec["n"], spec["p"]
    rng = np.random.default_rng(spec["seed"])
    stack = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(out["device"])
    group = create_mesh(n, out["device"])
    gather = RowGather(group, (p,))
    masks = [np.ones(n), np.zeros(n), (np.arange(n) % 2 == 0), (np.arange(n) == n - 1),
             rng.integers(0, 2, size=n)]
    equal = []
    for m in masks:
        live = torch.tensor(np.asarray(m, np.float32), device=stack.device)
        gather.put(stack[group.first:group.first + group.local])
        if group.joined:
            gather.reduce()
        equal.append(bool(torch.equal(masked_mean(gather.buf, live), masked_mean(stack, live))
                          and torch.equal(gather.buf, stack)))
    with open(os.path.join(out["dir"], f"sync_rank{rank}.json"), "w") as f:
        json.dump({"bitwise": equal, "world": group.world, "local": group.local}, f)


def _lm_runs(spec, rank, out):
    import numpy as np
    import torch

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.distributed import distribute_host_data
    from distributed_neural_network_tpu_torch.parallel.ring import zigzag_order
    from distributed_neural_network_tpu_torch.parallel.rules import named_leaves
    from distributed_neural_network_tpu_torch.train import lm as tlm

    tree = _tree(spec["params"])
    batches = dict(np.load(spec["batches"]))
    device = out["device"]
    for case in spec["cases"]:
        kw = dict(case["kw"])
        cfg = tfm.TransformerConfig(**{**spec["cfg"], **case.get("cfg", {})})
        dp, sp, tp = case.get("mesh") or (kw.pop("dp", None) or _world(), 1, 1)
        mesh = tlm.create_lm_mesh(dp, sp, tp, device=device)
        params, specs = tlm.shard_params(tfm.from_jax_params(tree), cfg, mesh)
        perm = (torch.from_numpy(zigzag_order(batches["tokens"].shape[2], sp)).long()
                if kw.get("attn_impl") == "zigzag" and sp > 1 else None)

        def batch(i, rows=True):
            tok, tgt = (torch.from_numpy(batches[k][i]).long() for k in ("tokens", "targets"))
            if perm is not None:
                tok, tgt = tok[:, perm], tgt[:, perm]
            return (distribute_host_data(x, mesh, rows=rows) for x in (tok, tgt))

        evals = []
        if case.get("eval"):
            ev = tlm.make_eval_fn(cfg, attn_impl=kw.get("attn_impl", "ring"), mesh=mesh)
            evals = [float(ev(params, *batch(i, rows=ev.sharded_rows)))
                     for i in range(case["steps"])]
            del ev
        opt = kw.get("optimizer", "sgd")
        mom = tlm.init_lm_momentum(params, opt, mesh)
        step = tlm.make_lm_train_step(cfg, mesh=mesh, device=device, **kw)
        losses = [float(step(params, mom, *batch(i), i)) for i in range(case["steps"])]
        state = {k: v for k, v in mom.items() if k != "t"} if isinstance(mom, dict) else mom
        if not opt.startswith("zero"):
            leaf_specs = tlm.tree_leaves(specs)
            state = (tlm.gather_params(state, leaf_specs, mesh) if isinstance(state, list) else
                     {k: tlm.gather_params(v, leaf_specs, mesh) for k, v in state.items()})
        whole = tlm.gather_params(params, specs, mesh)
        np.savez(os.path.join(out["dir"], f"lm_{case['name']}_rank{rank}.npz"),
                 losses=np.asarray(losses, np.float64), eval=np.asarray(evals, np.float64),
                 n_buckets=step.layout.n_buckets if step.layout is not None else 0,
                 n_collectives=len(step.collectives), segments=step.segments,
                 **{"params/" + k: v.detach().cpu().numpy() for k, v in named_leaves(whole)},
                 **{f"state/{k}": v.detach().cpu().numpy() for k, v in named_leaves(state)})
        del step


def _pp_runs(spec, rank, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel import collectives as C
    from distributed_neural_network_tpu_torch.parallel import pipeline as ppl
    from distributed_neural_network_tpu_torch.parallel.distributed import distribute_host_data
    from distributed_neural_network_tpu_torch.parallel.rules import named_leaves
    from distributed_neural_network_tpu_torch.train import lm as tlm

    trees = {key: _tree(path) for key, path in spec["params"].items()}
    batches = dict(np.load(spec["batches"]))
    device = out["device"]
    counts = {"exchanges": 0, "head_calls": 0, "head_rows": 0}
    exchange, head_ce = C._exchange, ppl.head_ce

    def counted_exchange(*a, **k):
        counts["exchanges"] += 1
        return exchange(*a, **k)

    def counted_head(h, *a, **k):
        counts["head_calls"] += 1
        counts["head_rows"] += h.shape[0]
        return head_ce(h, *a, **k)

    C._exchange, ppl.head_ce = counted_exchange, counted_head
    try:
        for case in spec["cases"]:
            cfg = tfm.TransformerConfig(**case["cfg"])
            dp, pp, tp = case["mesh"]
            m, v, rows = case.get("m", 2), case.get("v", 1), case["rows"]
            mesh = ppl.create_pp_mesh(dp, pp, tp, device=device)
            params, specs = ppl.shard_pp_params(tfm.from_jax_params(trees[case["params"]]), cfg,
                                                mesh, interleave=v)

            def batch(i):
                return tuple(distribute_host_data(torch.from_numpy(batches[k][i][:rows]).long(),
                                                  mesh) for k in ("tokens", "targets"))

            res = {}
            counts.update(exchanges=0, head_calls=0, head_rows=0)
            if case["kind"] in ("loss", "grads"):
                leaves = tlm.tree_leaves(params)
                grad = case["kind"] == "grads"
                for x in leaves:
                    x.requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    loss = ppl.pipeline_lm_loss(params, *batch(0), cfg, mesh=mesh,
                                                n_microbatches=m, interleave=v)
                if grad:
                    loss.backward()
                    grads = []
                    experts = set(tlm.expert_leaf_indices(specs))
                    for j, (x, s) in enumerate(zip(leaves, tlm.tree_leaves(specs))):
                        g = x.grad if x.grad is not None else torch.zeros_like(x)
                        axis = mesh.data if ppl.PIPE_AXIS in tuple(s) else mesh.data_pipe
                        if axis.group is not None and j not in experts:
                            dist.all_reduce(g, group=axis.group)
                        grads.append(g)
                    whole = tlm.gather_params(tlm.tree_unflatten(params, grads), specs, mesh)
                    res.update({"grads/" + k: g.numpy() for k, g in named_leaves(whole)})
                loss = loss.detach()
                if mesh.data_pipe.group is not None:
                    dist.all_reduce(loss, group=mesh.data_pipe.group)
                res["losses"] = np.asarray([float(loss)])
            else:
                kw = dict(case.get("kw", {}))
                opt = kw.get("optimizer", "sgd")
                mom = (ppl.init_pp_zero_state(params, mesh, opt) if opt.startswith("zero")
                       else tlm.init_lm_momentum(params, opt))
                step = ppl.make_pp_train_step(cfg, mesh, device=device, n_microbatches=m,
                                              interleave=v, **kw)
                losses = [float(step(params, mom, *batch(i), i)) for i in range(case["steps"])]
                state = {k: x for k, x in mom.items() if k != "t"} if isinstance(mom, dict) \
                    else mom
                if not opt.startswith("zero"):
                    leaf_specs = tlm.tree_leaves(specs)
                    state = (tlm.gather_params(state, leaf_specs, mesh) if isinstance(state, list)
                             else {k: tlm.gather_params(x, leaf_specs, mesh)
                                   for k, x in state.items()})
                whole = tlm.gather_params(params, specs, mesh)
                res.update(losses=np.asarray(losses, np.float64), segments=step.segments,
                           n_buckets=step.layout.n_buckets if step.layout is not None else 0,
                           **{"params/" + k: x.numpy() for k, x in named_leaves(whole)},
                           **{"state/" + k: x.detach().numpy() for k, x in named_leaves(state)})
                del step
            np.savez(os.path.join(out["dir"], f"pp_{case['name']}_rank{rank}.npz"),
                     exchanges=counts["exchanges"], head_calls=counts["head_calls"],
                     head_rows=counts["head_rows"], **res)
    finally:
        C._exchange, ppl.head_ce = exchange, head_ce


def _tree(path):
    """A parameter tree from an .npz of "layer/leaf" (or "leaf") keys."""
    import numpy as np

    tree = {}
    for k, v in dict(np.load(path)).items():
        *parts, leaf = k.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _attn_runs(spec, rank, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel import ring
    from distributed_neural_network_tpu_torch.train import lm as tlm

    n = dist.get_world_size()
    axis = tlm.create_lm_mesh(1, n, 1, device="cpu").seq
    data = dict(np.load(spec["qkv"]))
    for case in spec["cases"]:
        h = case.get("heads") or data["q"].shape[2]
        s = data["q"].shape[1]
        order = ring.zigzag_order(s, n) if case["fn"] == "zigzag" else np.arange(s)
        c = s // n
        mine = order[rank * c:(rank + 1) * c]
        q, k, v, w = (torch.from_numpy(np.ascontiguousarray(data[x][:, mine, :h]))
                      for x in ("q", "k", "v", "w"))
        for t in (q, k, v):
            t.requires_grad_(True)
        try:
            if case["fn"] == "ring":
                o = ring.ring_attention(q, k, v, axis, causal=case["causal"])
            elif case["fn"] == "ulysses":
                o = ring.ulysses_attention(q, k, v, axis, causal=case["causal"])
            else:
                o = ring.zigzag_ring_attention(q, k, v, axis)
            (o * w).sum().backward()
            res = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                   "dv": v.grad.numpy()}
        except ValueError as e:
            res = {"error": str(e)}
        np.savez(os.path.join(out["dir"], f"attn_{case['name']}_rank{rank}.npz"), **res)


def _moe_runs(spec, rank, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel.moe import moe_ffn
    from distributed_neural_network_tpu_torch.train import lm as tlm

    data = dict(np.load(spec["inputs"]))
    for case in spec["cases"]:
        dp, tp = case["mesh"]
        mesh = tlm.create_lm_mesh(dp, 1, tp, device="cpu")
        d_i, _, t_i = mesh.coords

        def block(x, dim, n, i):
            c = x.shape[dim] // n
            return np.ascontiguousarray(np.take(x, range(i * c, (i + 1) * c), axis=dim))

        x, w = (block(data[k], 0, dp, d_i) for k in ("x", "w"))
        w1 = block(block(data["w1"], 0, dp, d_i), 2, tp, t_i)
        b1 = block(block(data["b1"], 0, dp, d_i), 1, tp, t_i)
        w2 = block(block(data["w2"], 0, dp, d_i), 1, tp, t_i)
        b2 = block(data["b2"], 0, dp, d_i)
        ins = [torch.from_numpy(a).requires_grad_() for a in (x, data["wr"], w1, b1, w2, b2)]
        y, aux = moe_ffn(*ins, top_k=case["top_k"], capacity=case["capacity"],
                         ep_axis=mesh.data if dp > 1 else None, tp_axis=mesh.tp_axis,
                         dispatch_impl=case["impl"], z_loss_weight=case["z"])
        ((y * torch.from_numpy(w)).sum() + aux).backward()
        grads = [t.grad for t in ins]
        if mesh.data.group is not None:
            dist.all_reduce(grads[1], group=mesh.data.group)
        np.savez(os.path.join(out["dir"], f"moe_{case['name']}_rank{rank}.npz"),
                 y=y.detach().numpy(), aux=float(aux),
                 **{"grad_" + k: g.numpy() for k, g in zip(("x", "wr", "w1", "b1", "w2", "b2"),
                                                           grads)})


def norm_inputs(seed: int, cfg_kw):
    """The ``norms`` check's whole gradient tree as numpy leaves, in
    `tree_leaves` order: seeded normals of the LM's leaf shapes."""
    import numpy as np

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

    rng = np.random.default_rng(seed)
    shapes = [tuple(p.shape) for p in tree_leaves(tfm.init_params(0, tfm.TransformerConfig(
        **cfg_kw)))]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _norm_check(spec, rank, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops.schedule import global_norm, per_leaf_sq_norms
    from distributed_neural_network_tpu_torch.train import lm as tlm

    cfg = tfm.TransformerConfig(**spec["cfg"])
    mesh = tlm.create_lm_mesh(1, 1, dist.get_world_size(), device="cpu")
    like = tfm.init_params(0, cfg)
    whole = tlm.tree_unflatten(like, [torch.from_numpy(x) for x in
                                      norm_inputs(spec["seed"], spec["cfg"])])
    mine, specs = tlm.shard_params(whole, cfg, mesh)
    leaves, kw = tlm.tree_leaves(mine), dict(specs=tlm.tree_leaves(specs),
                                              axes=tuple(mesh.shape), mesh=mesh)
    np.savez(os.path.join(out["dir"], f"norms_rank{rank}.npz"),
             per_leaf=np.asarray([float(x) for x in per_leaf_sq_norms(leaves, **kw)]),
             **{"global": float(global_norm(leaves, **kw))})


BUCKET_SHAPES = [(3, 5), (7,), (4, 4, 2), (1,), (33,), (2, 9)]


def bucket_leaves(seed: int, rank: int):
    """The leaves rank `rank` reduces in the ``buckets`` check: f32, then
    two bf16 leaves (a bucket never mixes dtypes)."""
    import numpy as np
    import torch

    rng = np.random.default_rng((seed, rank))
    out = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in BUCKET_SHAPES]
    out += [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
            for s in ((5,), (6,))]
    return out


def _bucket_check(spec, rank, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.parallel import collectives as C
    from distributed_neural_network_tpu_torch.parallel.zero import make_overlap_grad_reducers
    from distributed_neural_network_tpu_torch.train.lm import create_lm_mesh

    n = dist.get_world_size()
    leaves = bucket_leaves(spec["seed"], rank)
    layout = C.plan_buckets(leaves, bucket_bytes=spec["cap"])
    mean = C.bucketed_psum(leaves, layout, mean=True)
    per_leaf = []
    for x in leaves:
        y = x.clone()
        dist.all_reduce(y)
        per_leaf.append(y.div_(n))
    f32 = [x for x in leaves if x.dtype == torch.float32]
    layout32 = C.plan_buckets(f32, bucket_bytes=spec["cap"])
    # the ZeRO overlap's reducers: `reduce_scatter_buckets`, `all_gather_buckets`
    reduce_fn, finalize_fn = make_overlap_grad_reducers(layout32, create_lm_mesh(n, device="cpu"))
    shards = reduce_fn(f32)
    gathered = finalize_fn(shards)
    summed = C.bucketed_psum(f32, layout32)
    as_np = lambda t: t.float().numpy()  # noqa: E731
    np.savez(os.path.join(out["dir"], f"buckets_rank{rank}.npz"),
             n_buckets=layout.n_buckets,
             **{f"mean/{i}": as_np(x) for i, x in enumerate(mean)},
             **{f"per_leaf/{i}": as_np(x) for i, x in enumerate(per_leaf)},
             **{f"gathered/{i}": as_np(x) for i, x in enumerate(gathered)},
             **{f"summed/{i}": as_np(x) for i, x in enumerate(summed)},
             **{f"shard/{i}": as_np(x) for i, x in enumerate(shards)})


ZERO_SHAPES = [(3, 5), (7,), (2, 4, 3), (1,)]


def zero_inputs(seed: int, rank: int):
    """(params, summed grads, this rank's partial grads) of the ``zero``
    check: the partial grads of all ranks sum to the summed ones in float64
    terms only, so the partial path is held to a tolerance."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in ZERO_SHAPES]
    grads = [rng.normal(size=s).astype(np.float32) for s in ZERO_SHAPES]
    part = np.random.default_rng((seed, rank))
    partial = [part.normal(size=s).astype(np.float32) for s in ZERO_SHAPES]
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    return t(params), t(grads), t(partial)


def _zero_check(spec, rank, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.ops.adam import adam_step, init_adam
    from distributed_neural_network_tpu_torch.ops.sgd import init_momentum, sgd_step
    from distributed_neural_network_tpu_torch.parallel import zero as Z
    from distributed_neural_network_tpu_torch.train.lm import create_lm_mesh

    mesh = create_lm_mesh(dist.get_world_size(), device="cpu")
    n = mesh.dp
    res = {}
    for steps in (1, 3):
        p_rep, g, _ = zero_inputs(spec["seed"], rank)
        mom = init_momentum(p_rep)
        p_sh, _, _ = zero_inputs(spec["seed"], rank)
        mom_sh = Z.init_zero_momentum_tree(p_sh, n)
        p_flat, _, _ = zero_inputs(spec["seed"], rank)
        mom_flat = torch.zeros(Z.zero_shard_size(p_flat, n))
        for _ in range(steps):
            sgd_step(p_rep, mom, g, 0.1, 0.9)
            Z.zero_sgd_step_sharded(p_sh, mom_sh, g, 0.1, 0.9, mesh=mesh)
            Z.zero_sgd_step(p_flat, mom_flat, g, 0.1, 0.9, mesh=mesh)
        res.update({f"sgd{steps}/{i}": x.numpy() for i, x in enumerate(p_rep)})
        res.update({f"zero{steps}/{i}": x.numpy() for i, x in enumerate(p_sh)})
        res.update({f"flat{steps}/{i}": x.numpy() for i, x in enumerate(p_flat)})
        res.update({f"zero_mom{steps}/{i}": x.numpy() for i, x in enumerate(mom_sh)})
        res.update({f"sgd_mom{steps}/{i}": x.numpy() for i, x in enumerate(mom)})
        res[f"flat_mom{steps}"] = mom_flat.numpy()
        p_rep, g, _ = zero_inputs(spec["seed"], rank)
        st = init_adam(p_rep)
        p_sh, _, _ = zero_inputs(spec["seed"], rank)
        st_sh = Z.init_zero_adam_tree(p_sh, n)
        for _ in range(steps):
            adam_step(p_rep, st, g, 0.01, weight_decay=0.01)
            Z.zero_adam_step_sharded(p_sh, st_sh, g, 0.01, weight_decay=0.01, mesh=mesh)
        res.update({f"adam{steps}/{i}": x.numpy() for i, x in enumerate(p_rep)})
        res.update({f"zero_adam{steps}/{i}": x.numpy() for i, x in enumerate(p_sh)})
        res.update({f"zero_adam_v{steps}/{i}": x.numpy() for i, x in enumerate(st_sh["v"])})
    # the reduce-scatter of partial gradients against the slice of their sum
    p_a, _, part = zero_inputs(spec["seed"], rank)
    total = [x.clone() for x in part]
    for x in total:
        dist.all_reduce(x)
    p_b, _, _ = zero_inputs(spec["seed"], rank)
    m_a, m_b = Z.init_zero_momentum_tree(p_a, n), Z.init_zero_momentum_tree(p_b, n)
    Z.zero_sgd_step_sharded(p_a, m_a, part, 0.1, 0.9, mesh=mesh, grads_presummed=False)
    Z.zero_sgd_step_sharded(p_b, m_b, total, 0.1, 0.9, mesh=mesh)
    res.update({f"partial/{i}": x.numpy() for i, x in enumerate(p_a)})
    res.update({f"presummed/{i}": x.numpy() for i, x in enumerate(p_b)})
    np.savez(os.path.join(out["dir"], f"zero_rank{rank}.npz"), **res)


def _reshard_check(spec, rank, out):
    import numpy as np

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel import reshard as R
    from distributed_neural_network_tpu_torch.parallel.mesh import NamedSharding
    from distributed_neural_network_tpu_torch.parallel.partition import PartitionSpec as P
    from distributed_neural_network_tpu_torch.parallel.pipeline import (
        create_pp_mesh,
        pp_param_specs,
    )
    from distributed_neural_network_tpu_torch.train.lm import create_lm_mesh
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = tfm.TransformerConfig(**spec["cfg"])
    shapes = tfm.param_shapes(cfg)
    rng = np.random.default_rng(spec["seed"])

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return rng.standard_normal(node).astype(np.float32)

    params, mom = draw(shapes), draw(shapes)
    result = {}
    for dp, pp in spec["cases"]:
        if pp > 1:
            mesh = create_pp_mesh(dp, pp, device=out["device"])
            specs = pp_param_specs(cfg)
            flat = R.momentum_to_pp_zero_tree(mom, specs, pp, dp)
            state_specs = tree_map(lambda s: P(("pipe", "data")) if "pipe" in R.spec_axes(s)
                                   else P("data"), specs)
            gather = R.make_pp_zero_gather_fn(params, mesh)
            host = R.pp_zero_tree_to_momentum(flat, params, specs, pp)
        else:
            mesh = create_lm_mesh(dp, device=out["device"])
            flat = R.momentum_to_zero_tree(mom, dp)
            state_specs = tree_map(lambda _: P("data"), flat)
            gather = R.make_zero_gather_fn(params, mesh)
            host = R.zero_tree_to_momentum(flat, params)
        shards = R.place_tree(flat, tree_map(lambda s: NamedSharding(mesh, s), state_specs))
        got = [x.cpu().numpy() for x in tree_leaves(gather(shards))]
        want = tree_leaves(host)
        result[f"dp{dp}pp{pp}"] = {
            "leaves": len(want), "form": mesh.data.form,
            "bitwise": len(got) == len(want) and all(
                g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
                for g, w in zip(got, want)),
            "bitwise_mom": all(np.array_equal(g, m) for g, m in zip(got, tree_leaves(mom)))}
    with open(os.path.join(out["dir"], f"reshard_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _resume_run(run, cfg, train, test, rank, out):
    import dataclasses

    import numpy as np

    from distributed_neural_network_tpu_torch.train.engine import Engine
    from distributed_neural_network_tpu_torch.utils.checkpoint import Checkpointer

    stop, quiet = run["resume"]["stop"], (lambda _: None)
    legs, mom = {}, {}
    for leg, epochs, ck_dir in (("whole", cfg.epochs, "whole"), ("stopped", stop, "stopped"),
                                ("resumed", cfg.epochs, "stopped")):
        eng = Engine(dataclasses.replace(cfg, epochs=epochs), train, test, device=out["device"])
        ck = Checkpointer(os.path.join(out["dir"], f"{run['name']}_{ck_dir}"))
        start = 0
        if leg == "resumed":
            start = ck.restore_latest(eng, log=quiet)
            names = [n for n, _ in eng.net.named_parameters()]
            mom = {"mom/" + k: v.detach().cpu().numpy() for k, v in zip(names, eng.mom)}
        eng.run(log=quiet, checkpointer=ck, start_epoch=start)
        ck.close()
        legs[leg] = {"history": [vars(m) for m in eng.history], "start": start}
        del eng
    name = f"{run['name']}_rank{rank}"
    np.savez(os.path.join(out["dir"], name + ".npz"), **mom)
    with open(os.path.join(out["dir"], name + ".json"), "w") as f:
        json.dump(legs, f)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def main(spec_json: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_neural_network_tpu_torch.data.cifar10 import load_split
    from distributed_neural_network_tpu_torch.parallel.distributed import (
        initialize,
        joined,
        rank_device,
    )
    from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

    spec = json.loads(spec_json)
    device = torch.device(spec["device"])
    if initialize(device=device, log=lambda _: None):
        device = rank_device(device)
    rank = dist.get_rank() if joined() else 0
    out = {"dir": spec["out"], "device": device}
    try:
        if spec.get("sync"):
            _sync_check(spec["sync"], rank, out)
        if spec.get("lm"):
            _lm_runs(spec["lm"], rank, out)
        if spec.get("pp"):
            _pp_runs(spec["pp"], rank, out)
        if spec.get("attn"):
            _attn_runs(spec["attn"], rank, out)
        if spec.get("moe"):
            _moe_runs(spec["moe"], rank, out)
        if spec.get("norms"):
            _norm_check(spec["norms"], rank, out)
        if spec.get("buckets"):
            _bucket_check(spec["buckets"], rank, out)
        if spec.get("zero"):
            _zero_check(spec["zero"], rank, out)
        if spec.get("reshard"):
            _reshard_check(spec["reshard"], rank, out)
        for run in spec.get("runs", []):
            cfg = TrainConfig(**run["config"])
            train = load_split(True, source="synthetic", synthetic_size=run["train"]["size"],
                               seed=run["train"]["seed"],
                               normalize_images=cfg.input_mode != "stream")
            test = load_split(False, source="synthetic", synthetic_size=run["test"]["size"],
                              seed=run["test"]["seed"])
            if run.get("resume"):
                _resume_run(run, cfg, train, test, rank, out)
                continue
            eng = Engine(cfg, train, test, device=device)
            params0 = flat_params(eng.state_tree()["params"])
            profiled = cfg.epochs - 1 if run.get("profile") else None
            history, epoch_s = [], []
            for e in range(cfg.epochs):
                if e != profiled:
                    t0 = time.perf_counter()
                    history.append(vars(eng.run_epoch(e)))  # ends in a read of its metrics
                    epoch_s.append(time.perf_counter() - t0)
            trace = None
            if profiled is not None:
                m, trace = _profiled_epoch(eng, profiled)
                history.append(vars(m))
            params = flat_params(eng.state_tree()["params"])
            name = f"{run['name']}_rank{rank}"
            np.savez(os.path.join(spec["out"], name + ".npz"),
                     **{"params0/" + k: v for k, v in params0.items()},
                     **{"params/" + k: v for k, v in params.items()})
            with open(os.path.join(spec["out"], name + ".json"), "w") as f:
                json.dump({"history": history, "world": eng.mesh.world,
                           "workers": list(eng.mesh.workers),
                           "backend": dist.get_backend() if joined() else None,
                           "captured": eng._step.graph is not None, "trace": trace,
                           "epoch_s": epoch_s,
                           "segments": [len(p.segments or ()) for p in eng._programs()]}, f)
            # free the engine's graphs before the group goes: destroying an
            # NCCL group while graphs that captured its collectives live hangs
            del eng
    finally:
        if joined():
            dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_then(spec: dict, rank: int) -> None:
    """Run a probe spec's ``then`` entries in this rank's process group, in
    order: [(a `port_probes/` module, its spec)], each through the module's
    `rank_runs(spec, rank)`. One launch of the ranks then serves several
    probes (a fresh rank process costs seconds before its first step)."""
    import importlib

    for module, sub in spec.get("then") or ():
        importlib.import_module(module).rank_runs(sub, rank)


def launch(world: int, spec, *, timeout: float, joined: bool = True,
           env: dict | None = None, script: str | None = None) -> list[subprocess.CompletedProcess]:
    """Start `world` ranks of this worker (or of `script`, given `spec` as
    its argument) on a free localhost port (or, with `joined=False` and
    world 1, one process that joins no group), each with its own `timeout`;
    every rank is killed if one overruns. Returns the ranks' completed
    processes (stdout and stderr captured)."""
    port = free_port()
    procs = []
    for rank in range(world):
        e = dict(os.environ, **(env or {}))
        e["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, e.get("PYTHONPATH")]))
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                  "LOCAL_WORLD_SIZE"):
            e.pop(k, None)
        if joined:
            e.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                     RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), json.dumps(spec)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    done = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
