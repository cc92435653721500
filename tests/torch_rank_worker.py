"""One rank of a torch.distributed run of the port's CNN engine, and the
launcher that starts the ranks (used by tests/test_torch_distributed.py on
the CPU and by chip_smoke.py phase 17 on the card).

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
  traces can be merged where both clocks agree (`busy_union`).

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
        for run in spec.get("runs", []):
            cfg = TrainConfig(**run["config"])
            train = load_split(True, source="synthetic", synthetic_size=run["train"]["size"],
                               seed=run["train"]["seed"],
                               normalize_images=cfg.input_mode != "stream")
            test = load_split(False, source="synthetic", synthetic_size=run["test"]["size"],
                              seed=run["test"]["seed"])
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


def launch(world: int, spec: dict, *, timeout: float, joined: bool = True,
           env: dict | None = None) -> list[subprocess.CompletedProcess]:
    """Start `world` ranks of this worker on a free localhost port (or, with
    `joined=False` and world 1, one process that joins no group), each
    with its own `timeout`; every rank is killed if one overruns. Returns
    the ranks' completed processes (stdout and stderr captured)."""
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
            [sys.executable, os.path.abspath(__file__), json.dumps(spec)], env=e,
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
