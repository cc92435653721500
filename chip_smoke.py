#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: the card's name and power limit, torch/CUDA/nvcc/triton versions;
2. build the fused-head CUDA kernels from csrc/ and time the build;
3. each kernel against its plain PyTorch version on the card, at B in
   {1, 16, 200, 4096} (atol = rtol = 1e-4, f32 with another summation order),
   plus a bitwise check that the backward gives the same bits twice;
4. the port's Engine on the card (kernels="cuda", data_parallel, 512 rows,
   4 workers, 2 epochs) against the float64 numpy oracle in
   tests/oracle_numpy.py, with the engine's own shuffle orders fed to both
   (train loss within 5e-4, params max-rel within 2e-3), and a second run
   that must reproduce the first bit for bit;
5. the main path at full width through the user's entry point,
   `train.cli.main`: data_parallel, 4 workers, 50,000 synthetic train rows
   and 10,000 test rows, 2 epochs, batch 16, --kernels cuda. The kernels'
   launch counters must equal the steps and eval batches the run made; the
   train loss must fall and the final validation accuracy reach 50%. Runs
   with --kernels torch, torch, cuda follow, for an end-to-end comparison
   of the two heads within one call;
6. kernel times beside their bound, their plain version and a PyTorch library
   call, at B in {16, 128, 4096}: per call in an eager loop timed with CUDA
   events (what the main path pays, host dispatch included), and device time
   from the same calls captured in a CUDA graph;
7. a torch.profiler trace of one steady epoch of the engine (4 workers x
   1024 rows): device busy time, idle share and the top kernels.

The last lines are the kernel table as one JSON object, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 peak outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{name}' FAILED", file=sys.stderr, flush=True)
        sys.exit(1)
    print(f"   ({name}: {time.perf_counter() - t0:.1f} s)", flush=True)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# ------------------------------------------------------------------- helpers


def head_inputs(torch, b, device, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(b, 400), (400, 120), (120,), (120, 84), (84,), (84, 10), (10,)]
    scales = [1.0, 0.05, 1.0, 0.05, 1.0, 0.05, 1.0]
    return [(torch.randn(*s, generator=g) * k).to(device) for s, k in zip(shapes, scales)]


def max_err(torch, a, b):
    if isinstance(a, (list, tuple)):
        return max(max_err(torch, x, y) for x, y in zip(a, b))
    return float((a.detach() - b.detach()).abs().max())


def assert_close(torch, name, a, b):
    for i, (x, y) in enumerate(zip(a, b) if isinstance(a, (list, tuple)) else [(a, b)]):
        ok = torch.allclose(x.detach(), y.detach(), atol=TOL, rtol=TOL)
        check(ok, f"{name}[{i}] differs: max abs err {max_err(torch, x, y)}")


def time_ms(torch, fn, iters=200, warmup=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=50, replays=5):
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed, so host dispatch cost drops out. None if `fn` cannot be
    captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        print(f"   (graph capture failed: {str(e).splitlines()[0]})")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def fmt(t):
    return "n/a" if t is None else f"{t:.5f}"


def ceil(a, b):
    return -(-a // b)


def bound_ms(bytes_moved, flops):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def head_work(b, fh):
    """(bytes, flops) each kernel must move/do at batch b (inputs read once,
    outputs written once)."""
    w = fh.GRAD_SIZE  # weights + biases
    nt = ceil(b, fh.BWD_TILE_ROWS)
    mac = 400 * 120 + 120 * 84 + 84 * 10
    fwd = (4 * (b * 400 + w + b * (10 + 120 + 84)), 2 * b * mac)
    bwd = (4 * (b * (10 + 400 + 120 + 84) + (w - 214) + b * 400 + nt * w), 4 * b * mac)
    red = (4 * (nt * w + w), nt * w)
    return {"fwd": fwd, "bwd": bwd, "reduce": red}


# -------------------------------------------------------------------- phases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    kernels = {
        "fused_mlp3_fwd": {"route": "cuda", "replaces":
                           "distributed_neural_network_tpu/ops/pallas_kernels.py:62"},
        "fused_mlp3_bwd": {"route": "cuda", "replaces":
                           "distributed_neural_network_tpu/ops/pallas_kernels.py:84"},
        "fused_mlp3_bwd_reduce": {"route": "cuda", "replaces":
                                  "distributed_neural_network_tpu/ops/pallas_kernels.py:84"},
    }
    for k in kernels.values():
        k["source"] = "distributed_neural_network_tpu_torch/csrc/fused_mlp3.cu"

    with phase("1 environment"):
        print(f"card: {smi}")
        try:
            import triton

            triton_v = triton.__version__
        except ImportError:
            triton_v = "absent"
        nvcc = run([fh._nvcc(), "--version"]).splitlines()
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, nvcc {nvcc[-1] if nvcc else '?'}, triton {triton_v}")
        print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    with phase("2 build"):
        t0 = time.perf_counter()
        lib = fh.build()
        fh._lib()
        print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")
        log = lib[: -len(".so")] + ".log"
        if os.path.isfile(log):
            for line in open(log):
                if "Used" in line or "spill" in line:
                    print("   ptxas:", line.strip())

    with phase("3 kernels vs plain"):
        for b in (1, 16, 200, 4096):
            args = head_inputs(torch, b, dev, seed=b)
            # each kernel alone against its plain version
            out_k = fh.mlp3_forward(*args, residuals=True)
            out_r = fh.mlp3_forward_reference(*args)
            assert_close(torch, f"fwd B={b}", out_k, out_r)
            x, w1, b1, w2, b2, w3, b3 = args
            gout = torch.randn(b, 10, device=dev, generator=torch.Generator(dev).manual_seed(b))
            _, h1, h2 = out_r
            part_k = fh.mlp3_bwd_partials(gout, x, h1, h2, w1, w2, w3)
            part_r = fh.mlp3_bwd_partials_reference(gout, x, h1, h2, w1, w2, w3)
            assert_close(torch, f"bwd B={b}", part_k, part_r)
            red_k = fh.mlp3_bwd_reduce(part_r[1])
            red_r = part_r[1].sum(0)
            assert_close(torch, f"reduce B={b}", red_k, red_r)
            # forward and all 7 gradients through autograd
            leaves = [a.clone().requires_grad_() for a in args]
            grads_k = torch.autograd.grad(fh.fused_mlp3(*leaves), leaves, gout)
            grads_r = torch.autograd.grad(fh.mlp3_reference(*leaves), leaves, gout)
            assert_close(torch, f"autograd B={b}", grads_k, grads_r)
            errs = {
                "fused_mlp3_fwd": max_err(torch, out_k, out_r),
                "fused_mlp3_bwd": max_err(torch, part_k, part_r),
                "fused_mlp3_bwd_reduce": max_err(torch, red_k, red_r),
            }
            print(f"B={b:5d} max_abs_err {errs}  grads {max_err(torch, grads_k, grads_r):.3g}")
            if b == 16:
                for name, e in errs.items():
                    kernels[name]["max_abs_err"] = e
            if b in (200, 4096):
                again = fh.mlp3_backward(gout, x, h1, h2, w1, w2, w3)
                first = fh.mlp3_backward(gout, x, h1, h2, w1, w2, w3)
                check(all(torch.equal(a, c) for a, c in zip(first, again)),
                      f"backward is not bitwise reproducible at B={b}")
        print("backward bitwise reproducible at B=200 and B=4096")

    with phase("4 oracle on the card"):
        import numpy as np
        from oracle_numpy import reference_trajectory

        from distributed_neural_network_tpu_torch.data.cifar10 import load_split
        from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

        split = load_split(True, source="synthetic", synthetic_size=512, seed=3)
        cfg = TrainConfig(lr=0.01, momentum=0.9, batch_size=16, epochs=2, nb_proc=4,
                          regime="data_parallel", kernels="cuda", seed=0)
        eng = Engine(cfg, split, None, device=dev)
        orders = [[eng.default_order(e, d).numpy() for d in range(4)] for e in range(2)]
        oracle = reference_trajectory(
            eng.state_tree()["params"], split.images, split.labels, n_workers=4,
            batch_size=16, epochs=2, lr=cfg.lr, momentum=cfg.momentum, orders=orders,
        )
        twin = Engine(cfg, split, None, device=dev)
        for e in range(2):
            m = eng.run_epoch(e, do_eval=False)
            twin.run_epoch(e, do_eval=False)
            got = eng.state_tree()["params"]
            rel = max(
                float(np.max(np.abs(got[l][k] - oracle[e]["params"][l][k])
                             / (np.abs(oracle[e]["params"][l][k]) + 1e-3)))
                for l in got for k in got[l]
            )
            dl = abs(m.train_loss - oracle[e]["train_loss"])
            print(f"epoch {e}: train loss {m.train_loss:.6f} (oracle "
                  f"{oracle[e]['train_loss']:.6f}, |d| {dl:.2e}), params max-rel {rel:.2e}")
            check(dl < 5e-4, f"epoch {e} train loss off the oracle by {dl}")
            check(rel < 2e-3, f"epoch {e} params off the oracle by max-rel {rel}")
        check(all(torch.equal(a, b) for a, b in
                  zip(eng.model.parameters(), twin.model.parameters())),
              "two identical engine runs differ")
        print("second engine run bitwise identical")

    full = ["--regime", "data_parallel", "--nb-proc", "4", "--data", "synthetic",
            "--synthetic-size", "50000", "--epochs", "2", "--batch-size", "16",
            "--lr", "0.01", "--log-dir", os.path.join(ROOT, "chiprun_out", "log")]
    main_path = {}
    with phase("5 main path, full width"):
        from distributed_neural_network_tpu_torch.train import cli

        # the checked main-path run first, then torch, torch, cuda: the two
        # heads alternate within this call for an end-to-end comparison
        for run_i, kern in enumerate(("cuda", "torch", "torch", "cuda")):
            lines = []

            def log(line, lines=lines):
                print("   " + line, flush=True)
                lines.append(line)

            for name in fh.LAUNCHES:
                fh.LAUNCHES[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(full + ["--kernels", kern], log=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(fh.LAUNCHES)
            check(rc == 0, f"cli.main returned {rc}")
            summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
            losses = [float(l.split(":")[1]) for l in lines
                      if l.startswith("Global Average Training Loss")]
            train_s = float(next(l for l in lines if l.startswith("Time spent on training"))
                            .split(":")[1])
            steps = ceil(50_000 // 4, 16) * 4 * 2
            eval_batches = ceil(ceil(10_000, 4), 16) * 4 * 2
            images = (50_000 // 4) * 4 * 2
            main_path.setdefault(kern, []).append(
                {"wall_s": wall, "train_s": train_s, "images_per_s": images / train_s,
                 "epoch_wall_s": summary["wall_clock_s"] / 2, "summary": summary})
            print(f"   run {run_i} kernels={kern}: launches {counts}; training {train_s:.3f} s for "
                  f"{images} images = {images / train_s:.1f} images/s; epoch wall "
                  f"{summary['wall_clock_s'] / 2:.3f} s")
            check(len(losses) == 2 and losses[1] < losses[0],
                  f"train loss did not fall: {losses}")
            check(summary["final_val_acc"] is not None and summary["final_val_acc"] >= 50.0,
                  f"final_val_acc {summary['final_val_acc']} < 50")
            if run_i == 0:
                want = {"fused_mlp3_fwd": steps + eval_batches, "fused_mlp3_bwd": steps,
                        "fused_mlp3_bwd_reduce": steps}
                check(counts == want, f"launch counts {counts} != expected {want}")
                for name, n in counts.items():
                    kernels[name]["launches"] = n
            elif kern == "torch":
                check(all(n == 0 for n in counts.values()),
                      f"kernels=torch launched fused kernels: {counts}")

    times = []
    with phase("6 times"):
        for b in (16, 128, 4096):
            args = head_inputs(torch, b, dev, seed=7)
            x, w1, b1, w2, b2, w3, b3 = args
            _, h1, h2 = fh.mlp3_forward_reference(*args)
            g = torch.randn(b, 10, device=dev)
            parts = fh.mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3)[1]
            leaves = [a.clone().requires_grad_() for a in args]

            def lib_fwd():
                hh1 = torch.addmm(b1, x, w1).relu_()
                hh2 = torch.addmm(b2, hh1, w2).relu_()
                return torch.addmm(b3, hh2, w3)

            lh1 = torch.addmm(leaves[2], leaves[0], leaves[1]).relu()
            lh2 = torch.addmm(leaves[4], lh1, leaves[3]).relu()
            lib_out = torch.addmm(leaves[6], lh2, leaves[5])
            work = head_work(b, fh)
            rows = {
                "fused_mlp3_fwd": (
                    lambda: fh.mlp3_forward(*args, residuals=True),
                    lambda: fh.mlp3_forward_reference(*args),
                    lib_fwd, work["fwd"]),
                "fused_mlp3_bwd": (
                    lambda: fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3),
                    lambda: fh.mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3),
                    lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True),
                    work["bwd"]),
                "fused_mlp3_bwd_reduce": (
                    lambda: fh.mlp3_bwd_reduce(parts), lambda: parts.sum(0),
                    lambda: torch.sum(parts, 0), work["reduce"]),
            }
            saved = dict(fh.LAUNCHES)
            for name, (kern_fn, plain_fn, lib_fn, (nbytes, flops)) in rows.items():
                t_k, t_p, t_l = (time_ms(torch, f) for f in (kern_fn, plain_fn, lib_fn))
                d_k, d_p, d_l = (graph_ms(torch, f) for f in (kern_fn, plain_fn, lib_fn))
                bms, by = bound_ms(nbytes, flops)
                print(f"B={b:5d} {name:22s} per call: kernel {t_k:.5f} ms  plain {t_p:.5f} ms  "
                      f"library {t_l:.5f} ms | device (graph): kernel {fmt(d_k)} ms  plain "
                      f"{fmt(d_p)} ms  library {fmt(d_l)} ms | bound {bms:.6f} ms "
                      f"({by}: {nbytes} B, {flops} FLOP)")
                times.append({"B": b, "name": name, "ms": t_k, "plain_ms": t_p,
                              "library_ms": t_l, "graph_ms": d_k, "plain_graph_ms": d_p,
                              "library_graph_ms": d_l, "bound_ms": bms, "bound_by": by})
                if b == 16:
                    kernels[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                         bound_ms=bms, bound_by=by, graph_ms=d_k)
            fh.LAUNCHES.update(saved)  # timing launches are not main-path launches
        for kern, runs in main_path.items():
            for r in runs:
                print(f"main path kernels={kern}: epoch wall {r['epoch_wall_s']:.3f} s, "
                      f"training {r['train_s']:.3f} s, {r['images_per_s']:.1f} images/s, "
                      f"final_val_acc {r['summary']['final_val_acc']:.2f} %")

    profile = {}
    with phase("7 where the time goes"):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        from distributed_neural_network_tpu_torch.data.cifar10 import load_split
        from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

        split = load_split(True, source="synthetic", synthetic_size=4096, seed=0)
        cfg = TrainConfig(lr=0.01, batch_size=16, nb_proc=4, kernels="cuda")
        eng = Engine(cfg, split, None, device=dev)
        saved = dict(fh.LAUNCHES)
        eng.run_epoch(0, do_eval=False)  # warm-up
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run_epoch(1, do_eval=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fh.LAUNCHES.update(saved)
        # kernel rows only: an operator's row repeats its kernels' device time
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(r[1] for r in rows) / 1e6
        steps = 4 * ceil(1024, 16)
        profile = {"wall_s": wall, "device_busy_s": busy, "steps": steps,
                   "idle_share": 1 - busy / wall if busy else None,
                   "top": sorted(rows, key=lambda r: -r[1])[:10]}
        print(f"one epoch, 4 workers x 1024 rows, {steps} steps: wall {wall:.3f} s "
              f"({1e3 * wall / steps:.3f} ms/step), device busy "
              f"{busy:.3f} s, idle share "
              f"{'not measured' if not busy else f'{1 - busy / wall:.3f}'}")
        for key, us, count in profile["top"]:
            print(f"   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")

    table = [{"name": name, **k} for name, k in kernels.items()]
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for row in table:
        missing = [k for k in keys if k not in row]
        if missing:
            print(f"chip_smoke: kernel {row['name']} lacks {missing}", file=sys.stderr)
            return 1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": table, "times": times, "main_path": main_path,
                   "profile": profile}, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
