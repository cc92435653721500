#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: the card's name and power limit, torch/CUDA/nvcc/triton versions;
2. build every CUDA source of csrc/ (one nvcc each, started together) and
   time the build; print each tensor-core flash instance's (forward, dq,
   dkv) registers, spills, dynamic shared memory and blocks per SM, the
   head forward's and backward's cluster instances' registers, shared
   memory, blocks per SM and clusters at once, and the same for the decode
   kernel's split instances;
3. each fused-head kernel against its plain PyTorch version on the card, at
   B in {1, 16, 17, 128, 200, 4096} (atol = rtol = 1e-4, f32 with another
   summation order), the backward at both of its cluster sizes, plus
   bitwise checks that the forward and the backward give the same bits
   twice;
4. the port's CNN Engine on the card (kernels="cuda", data_parallel, 512
   rows, 4 workers, 2 epochs) against the float64 numpy oracle in
   tests/oracle_numpy.py, with the engine's own shuffle orders fed to both
   (train loss within 5e-4, params max-rel within 2e-3), and a second run
   that must reproduce the first bit for bit;
5. the CNN main path at full width through the user's entry point,
   `train.cli.main`: data_parallel, 4 workers, 50,000 synthetic train rows
   and 10,000 test rows, 2 epochs, batch 16, --kernels cuda. The kernels'
   launch counters must equal the steps and eval batches the run made; the
   train loss must fall and the final validation accuracy reach 50%. A run
   with --kernels torch follows, for an end-to-end comparison of the two
   heads within one call;
6. fused-head kernel times beside their bound, their plain version and a
   PyTorch library call, at B in {16, 128, 4096}: per call in an eager loop
   timed with CUDA events (what the main path pays, host dispatch
   included), and device time from the same calls captured in a CUDA graph;
   gates at B = 16: the
   forward's device time is at most the addmm chain's, the backward's at
   most the autograd backward's;
7. a torch.profiler trace of one steady epoch of the CNN engine (4 workers x
   1024 rows): device busy time, idle share and the top kernels;
8. the decode-attention kernels (f32, bf16, int8 K/V with bf16 q) against
   their plain versions on the card: B in {1, 8}, (H, Dh) in {(8, 64),
   (4, 128), (4, 8)}, total in {16, 256, 2048}, pos a scalar and vectors
   holding 0 and total-1, K/V contiguous, as a transposed view and as a
   view 8 bytes off a 16-byte boundary; each case on the route
   `decode_route` gives (f32/bf16 aligned: split; misaligned and int8:
   simt), read from the route counters; f32 atol = rtol = 1e-5, bf16/int8
   1.6e-2 (two bf16 ulps at 1); two calls must give the same bits, and so
   must a shorter cache and, at B = 8, each (b, h) row alone in a batch of
   1; `decode_pieces` against the CUDA source's piece rows;
9. the LM serving main path at full width through `serve.http.build_server`,
   the stack `python -m distributed_neural_network_tpu_torch.serve` builds:
   d512/L8/H8/d_ff 2048/vocab 256, bf16, seed 0, max_batch 8, 129 blocks of
   16, max_seq_len 256, prefill_chunk 16, --warmup, HTTP on 127.0.0.1:0;
   24 greedy requests over HTTP/SSE (prompts of 16/64/128 tokens, 32 new
   each) sent open loop at 4 req/s, for --precision bf16 and int8-kv, each
   with --decode-impl cuda and torch. Gates: 24/24 complete; >= 99%
   per-token agreement with the port's offline bf16 generate() (each served
   token against generate's choice after the same served history, where a
   choice that generate's two routes make differently is a tie: see
   Oracle.agreement), and for bf16 with cuda also >= 99% with the streams
   zipped position by position;
   with cuda the decode kernel launches = (the engine's decode calls +
   prefill calls) x 8 layers, all on the split route for bf16 and on simt
   for int8-kv, with torch none; the serving ledger conserves. The bf16
   torch run is also compared with generate(decode_impl="torch"), the same
   route, and their per-token and zipped agreement printed (not gated;
   generate() has no int8 K/V);
10. decode-kernel times at B = 8, (H, Dh) in {(8, 64), (4, 128)}, live
   prefix 64 and 256: per call and device time, bound, plain version, the
   simt route on the same values (misaligned views), and
   scaled_dot_product_attention with a boolean mask as the library
   yardstick (int8: dequantize, then SDPA); gate: the split route's device
   time at (8, 8, 64, 256) is at most SDPA's;
11. a torch.profiler trace of a steady stretch of serving decode ticks
   (batch 8): idle share and top kernels;
12. the flash kernels (forward, dq, dkv) against their plain versions on the
   card: (B, H) in {(1, 1), (2, 8)}, S in {1, 64, 200, 2048}, D in {64, 128,
   16}, causal and not, f32 and bf16, contiguous and a strided (B, S, H, D)
   view; bf16 at D 32 (the mma route) and D 40 (the simt route), and
   misaligned views (simt); and the main path's own shape FLASH_MAIN (16,
   2048, 8, 64) causal bf16; each case, forward and backward, on the route
   the stated rule gives it (`expected_route`, read from the route
   counters: FLASH_MAIN on mma; the forward's mma route is wgmma at D 48
   and 64, mma.sync at 16, 32 and 128);
   f32 atol = rtol = 1e-4, bf16 1.6e-2, lse 1e-4; and the quantized
   forward (int8, fp8) on codes at the kernel's own k tile, at B 2 and at
   FLASH_MAIN (int8 2e-2; fp8 mean error 1e-4 and max two e4m3 steps, see
   FP8_STEP); every kernel gives the same bits on a second call. The kernel
   line's max_abs_err is the one at FLASH_MAIN;
13. the LM training main path at full width through `lm_train.main`, the
   repo's flagship row lm_flash_d512_L8_seq2048_bf16 with nothing cut
   (d512/L8/H8/d_ff 2048/vocab 32768, batch 16, seq 2048, bf16, SGD lr 0.01
   momentum 0.9, 20 steps, a loss read every 10 steps as the JAX row's
   unfenced loop): --attn flash, then --precision int8 and fp8, then the
   plain route (--attn ring; its (B, H, S, S) buffers fit in device memory,
   so without --remat-attn), and the four again in mirrored order, so that
   routes are compared in turns. Gates: each flash counter equals its
   formula (flash_counts) and is 0 on the plain route, every forward, dq
   and dkv launch of a kernel-route run on the mma route (mma_counts); finite
   losses; the
   kernel route's logged losses within LOSS_TOL of the plain route's, and
   every weight's step-0 gradient within GRAD_TOL of the plain route's
   (route_compare; `python3 chip_smoke.py --route-check` runs this check
   alone). Then FORMULA_STEPS-step runs at full width with --remat,
   --remat-attn, --accum-steps 2, eval batches (--data-path, --eval-every),
   and int8 with --remat-attn and eval, each held to flash_counts. Prints
   tokens/s, ms per step and MFU against the bf16 dense peak;
14. learnability: the copy task at d32/L2/H4/d_ff 64/vocab 32/seq 16/batch
   32, lr 0.3, 300 steps, --attn flash --generate 7: final loss < 0.2 and
   the greedy continuation matches the repeat on > 90% of positions; its
   head dim 8 puts every flash launch on the simt route;
15. flash kernel times at (B, S, H, D) = (16, 2048, 8, 64) and (16, 2048, 4,
   128), causal bf16: per call, device time in a CUDA graph, bound, plain
   version, and the dispatch's `lib` route (scaled_dot_product_attention,
   is_causal=True) forward and forward + backward as the library yardstick;
   the forward and the backward pair on the simt route too (the same values
   in misaligned views);
   the forward's device time against SDPA's forward and its bound, and the
   pair's summed device time against SDPA's whole backward;
16. a torch.profiler trace of 3 steady full-width training steps: idle
   share, the flash kernels' share of device time and the top kernels.

The last lines are the kernel table as one JSON object, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 peak outside the tensor
# cores, bf16 dense tensor-core peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12  # the int8 / fp8 dense tensor-core peak, same sheet
TOL = 1e-4
# flash kernels vs plain: bf16 as the decode kernels (two bf16 ulps at 1).
# Quantized forward: p comes from expf in the kernel and torch.exp in the
# plain version, which differ in the last bits, so now and then a code of p
# rounds the other way. An int8 code step moves o by at most 1/127 of the
# row's largest term: atol = rtol = 2e-2. An e4m3 step is up to 1/8 of its
# term, so fp8 is gated on the mean error (1e-4; such flips are rare) and on
# a max error of two steps, 2 * (1/8) * max |v|
QUANT_TOL = 2e-2
FP8_MEAN_TOL, FP8_STEP = 1e-4, 0.25
DECODE = "distributed_neural_network_tpu/ops/decode_pallas.py"
FLASH = "distributed_neural_network_tpu/ops/flash_pallas.py"
# the repo's flagship LM training row lm_flash_d512_L8_seq2048_bf16 (bench.py,
# geometry in train/measure.py measure_lm_training), nothing cut
LM_SHAPE = {"batch_size": 16, "seq_len": 2048, "vocab": 32768, "d_model": 512, "n_layers": 8,
            "n_heads": 8, "d_ff": 2048}
LM_ARGS = [a for k, v in LM_SHAPE.items() for a in ("--" + k.replace("_", "-"), str(v))] + [
    "--dtype", "bfloat16", "--lr", "0.01", "--momentum", "0.9", "--seed", "0"]
LM_STEPS, LM_LOG_EVERY = 20, 10
# the attention inputs that LM_ARGS give each flash kernel: (B, S, H, D)
FLASH_MAIN = (16, 2048, 8, 64)
# kernel route vs plain route from the same init and batches, bf16 (scores
# and softmax in bf16 on the plain route, f32 in the kernels): the logged
# losses (steps 0, 10, 19; the loss moves about 0.27 over the 20 steps;
# measured differences 4e-5 to 6e-5) within LOSS_TOL, and the gradient of
# every weight at step 0 (each layer of a stacked leaf on its own) within
# GRAD_TOL in relative L2 norm (measured: 0.0115 at worst)
LOSS_TOL = 1e-3
GRAD_TOL = 5e-2
# the launch-formula runs of phase 13 (--remat, --remat-attn, --accum-steps,
# eval) take this many steps at full width
FORMULA_STEPS = 4
SERVE_ARGS = ["--device", "cuda", "--port", "0", "--d-model", "512", "--n-layers", "8",
              "--n-heads", "8", "--d-ff", "2048", "--vocab", "256", "--dtype", "bfloat16",
              "--seed", "0", "--max-batch", "8", "--num-blocks", "129", "--block-size", "16",
              "--max-seq-len", "256", "--prefill-chunk", "16", "--warmup"]
N_REQUESTS, RATE, MAX_NEW, PROMPT_LENS = 24, 4.0, 32, (16, 64, 128)


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


@contextmanager
def uncounted(*counters):
    """Launches made inside are not main-path launches: each launch-counter
    dict gets its values back on the way out."""
    saved = [dict(c) for c in counters]
    try:
        yield
    finally:
        for c, values in zip(counters, saved):
            c.update(values)


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


def bound_ms(bytes_moved, flops, peak_flops=PEAK_F32_FLOPS):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def pct(xs, q):
    """Nearest-rank percentile (None when empty)."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def print_ptxas(lib):
    """One line per library from the compiler's log (printed and returned):
    its kernel instances, their register range and those that spill
    (mangled names)."""
    log = lib[: -len(".so")] + ".log"
    if not os.path.isfile(log):
        return
    name, regs, spills = None, [], []
    for line in open(log):
        if "Function properties for" in line:
            name = line.split("for")[-1].strip()
        elif "spill stores" in line:
            stores = int(line.split("bytes spill stores")[0].split(",")[-1])
            if stores:
                spills.append(f"{name[:70]} ({stores} B)")
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
    if regs:
        line = (f"ptxas {os.path.basename(lib)}: {len(regs)} kernel instances, {min(regs)}-"
                f"{max(regs)} registers; spills: {'; '.join(spills) or 'none'}")
        print("   " + line)
        return line


def ptxas_instances(lib, stem):
    """{"kernel<[T,]A[,B]>": {"registers", "spill_stores", "spill_loads"[,
    "static_smem"]}} from the compiler's log, for the kernel instances whose
    name holds `stem` (T: f32 or bf16 where the first template argument is
    a type; A, B: the integer ones)."""
    out, name = {}, None
    for line in open(lib[: -len(".so")] + ".log"):
        if "Function properties for" in line:
            m = re.search(r"((?:flash|mlp3|decode)_[a-z_]+_kernel)I(f|13__nv_bfloat16)?"
                          r"Li(\d+)E(?:Li(\d+)E)?", line)
            args = ([{"f": "f32"}.get(m.group(2), "bf16")] if m and m.group(2) else []) + [
                g for g in (m.groups()[2:] if m else ()) if g]
            name = f"{m.group(1)}<{','.join(args)}>" if m and stem in m.group(1) else None
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name] = {"spill_stores": int(stores), "spill_loads": int(loads)}
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                out[name]["static_smem"] = int(smem.group(1))
    return out


def profile_rows(prof, DeviceType):
    """(kernel name, device us, count) rows: kernel rows only, since an
    operator's row repeats its kernels' device time."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


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


# ------------------------------------------------------------ serving helpers


DECODE_LAYOUTS = ("contiguous", "strided", "misaligned")


def decode_inputs(torch, kind, b, h, d, total, layout, dev, g):
    """q and the K/V cache in one of DECODE_LAYOUTS: contiguous (B, H, S,
    Dh); the transposed (B, S, H, Dh) slab the serving engine passes; or
    that slab's head dims starting 8 bytes into rows of Dh + 16 elements
    (off a 16-byte boundary: the simt route); plus the int8 kernel's
    scales."""
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    kvdt = torch.int8 if kind == "int8" else qdt
    q = torch.randn(b, h, d, device=dev, generator=g).to(qdt)
    shape = (b, h, total, d) if layout == "contiguous" else (b, total, h, d)
    k, v = (torch.randn(*shape, device=dev, generator=g) for _ in "kv")
    if kind == "int8":
        k, v = ((t * 40).round().clamp(-127, 127) for t in (k, v))
    if layout == "misaligned":
        off = 8 // torch.empty(0, dtype=kvdt).element_size()

        def shift(t):
            buf = torch.zeros(b, total, h, d + 16, device=dev, dtype=kvdt)
            buf[..., off:off + d] = t
            return buf[..., off:off + d]

        k, v = shift(k), shift(v)
    if layout != "contiguous":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    k, v = k.to(kvdt), v.to(kvdt)
    if kind != "int8":
        return q, k, v, {}
    kw = {name: torch.rand(b, h, total, device=dev, generator=g) * 0.05 + 1e-3
          for name in ("k_scale", "v_scale")}
    return q, k, v, kw


def sse_request(port, prompt, max_new, out):
    """One streamed request; fills `out` with the tokens, their arrival
    times and the done frame."""
    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", "/v1/generate", json.dumps({"prompt": prompt, "max_new_tokens": max_new}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    toks, stamps, done = [], [], None
    if r.status == 200:
        for line in iter(r.readline, b""):
            if not line.startswith(b"data: "):
                continue
            doc = json.loads(line[6:])
            if "token" in doc:
                toks.append(doc["token"])
                stamps.append(time.perf_counter())
            else:
                done = doc
                break
    else:
        r.read()
    c.close()
    out.update(status=r.status, tokens=toks, stamps=stamps, t0=t0,
               t_done=time.perf_counter(), done=done)


def open_loop(port, prompts, arrivals):
    """Send every request at its arrival offset (s) from now, each on its
    own thread; return the per-request results in order."""
    results = [{} for _ in prompts]
    start = time.perf_counter()

    def one(i):
        time.sleep(max(0.0, start + arrivals[i] - time.perf_counter()))
        sse_request(port, prompts[i], MAX_NEW, results[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results


class Oracle:
    """The port's offline bf16 generate() on the served model, on either
    route (decode kernel "cuda", plain "torch"): its streams for the served
    prompts, and how far the served streams agree with them."""

    def __init__(self, torch, tfm, prompts, dev):
        self.torch, self.tfm, self.prompts, self.dev = torch, tfm, prompts, dev
        self.cfg = tfm.TransformerConfig(vocab_size=256, d_model=512, n_heads=8, n_layers=8,
                                         d_ff=2048, dtype=torch.bfloat16)
        self.params = tfm.init_params(0, self.cfg, dev)
        self.routes = {"cuda": self.route_streams("cuda")}

    def route_streams(self, impl):
        """generate()'s streams on route `impl` for every prompt (prompts of
        one length in one batch)."""
        streams = [None] * len(self.prompts)
        for n in sorted({len(p) for p in self.prompts}):
            idx = [i for i, p in enumerate(self.prompts) if len(p) == n]
            out = self.generate([self.prompts[i] for i in idx], MAX_NEW, impl)
            for row, i in zip(out, idx):
                streams[i] = row
        return streams

    def generate(self, prompts, n_new, impl="cuda"):
        out = self.tfm.generate(self.params, self.torch.tensor(prompts, device=self.dev),
                                self.cfg, max_new_tokens=n_new, decode_impl=impl)
        return out[:, len(prompts[0]):].tolist()

    def near_ties(self, gap=0.02):
        """Share of the oracle's own greedy choices whose top-2 logit gap is
        under `gap`: how often a rounding difference can flip a stream."""
        torch, n_close, n = self.torch, 0, 0
        for p, want in zip(self.prompts, self.routes["cuda"]):
            toks = torch.tensor([p + want], device=self.dev)
            h = self.tfm.apply_hidden(self.params, toks, self.cfg)[0, len(p) - 1: -1]
            # f32 logits, as the engine and generate() form them
            logits = h.float() @ self.params["head"].to(self.cfg.dtype).float()
            top2 = logits.topk(2, dim=-1).values
            n_close += int(((top2[:, 0] - top2[:, 1]) < gap).sum())
            n += len(want)
        return n_close / n

    def agreement(self, served, impl="cuda"):
        """(per-token agreement, the same up to the oracle's own rounding,
        stream agreement) of the served streams against generate() on route
        `impl`.

        Per token: each served token against generate()'s choice after the
        same prompt and the same earlier served tokens (generate runs again
        from the served prefix after each disagreement). Up to rounding: a
        disagreement counts as agreement when generate's other route (the
        same function, summed in another order) picks the served token after
        that history, i.e. where the bf16 model itself has no single answer.
        Stream: the two streams zipped position by position, the JAX serving
        row's form, in which one flipped near-tie makes every later token
        count as wrong."""
        if impl not in self.routes:
            self.routes[impl] = self.route_streams(impl)
        other = "torch" if impl == "cuda" else "cuda"
        agree = ties = zipped = total = 0
        for p, want, got in zip(self.prompts, self.routes[impl], served):
            zipped += sum(int(a == b) for a, b in zip(got, want))
            total += len(got)
            j, ref = 0, want
            while j < len(got):
                if ref[0] == got[j]:
                    agree, j, ref = agree + 1, j + 1, ref[1:]
                    continue
                ties += int(self.generate([p + got[:j]], 1, impl=other)[0][0] == got[j])
                j += 1
                if j < len(got):
                    ref = self.generate([p + got[:j]], len(got) - j, impl)[0]
        n = max(total, 1)
        return agree / n, (agree + ties) / n, zipped / n


# -------------------------------------------------------------- flash helpers


FLASH_LAYOUTS = ("contiguous", "strided", "misaligned")


def flash_inputs(torch, b, s, h, d, dtype, layout, dev, g):
    """q, k, v, dO (B, S, H, D) in one of FLASH_LAYOUTS: contiguous; the (B,
    S, H, D) view of a (B, H, S, D) buffer (strided on S and H, read in
    place by the kernels); or head dims 4 .. 4 + D of a (B, S, H, D + 8)
    buffer, whose base is 8 bytes (bf16) off a 16-byte boundary."""
    def one():
        if layout == "strided":
            return torch.randn(b, h, s, d, device=dev, generator=g).to(dtype).transpose(1, 2)
        if layout == "misaligned":
            return torch.randn(b, s, h, d + 8, device=dev, generator=g).to(dtype)[..., 4:4 + d]
        return torch.randn(b, s, h, d, device=dev, generator=g).to(dtype)
    return one(), one(), one(), one()


def expected_route(torch, d, dtype, layout):
    """The route the stated rule gives these inputs, forward and backward
    alike (ops/flash_attention.py `fwd_route`, `bwd_route`), from the case
    alone: "mma" for bf16 with D % 16 == 0 in an aligned layout, "simt"
    otherwise."""
    return "mma" if dtype == torch.bfloat16 and d % 16 == 0 and layout != "misaligned" else "simt"


def flash_vs_plain(torch, fa, dev):
    """Phase 12: every flash kernel against its plain version on the card,
    and bitwise against itself on a second call; each case, forward and
    backward, on the route the stated rule gives it (`expected_route`),
    shown by the route counters. Returns the number of cases, the worst max
    abs errors per kernel over all cases ("flash_dq mma bf16", ... per route
    too), and those at the main path's own shape (FLASH_MAIN: (B, S, H, D) =
    (16, 2048, 8, 64), causal, bf16, contiguous, on the mma route; int8 and
    fp8 for the quantized kernel; "flash_fwd o": o's alone)."""
    g = torch.Generator(dev).manual_seed(12)
    worst, main, n = {}, {}, 0
    mb, ms, mh, md = FLASH_MAIN
    main_case = (mb, ms, mh, md, True, torch.bfloat16, "contiguous")

    def record(name, err, is_main):
        worst[name] = max(worst.get(name, 0.0), err)
        if is_main:
            main[name] = max(main.get(name, 0.0), err)

    cases = [(b, s, h, d, causal, dtype, layout)
             for (b, h) in ((1, 1), (2, 8)) for s in (1, 64, 200, 2048) for d in (64, 128, 16)
             for causal in (True, False) for dtype in (torch.float32, torch.bfloat16)
             for layout in ("contiguous", "strided")]
    # bf16 on both backward routes: D 32 (mma), D 40 (simt: D % 16 != 0) and
    # misaligned views (simt)
    cases += [(2, s, 8, d, causal, torch.bfloat16, layout)
              for s in (64, 200) for d in (32, 40) for causal in (True, False)
              for layout in ("contiguous", "strided")]
    cases += [(2, s, 8, d, causal, torch.bfloat16, "misaligned")
              for s in (1, 200) for d in (64, 128) for causal in (True, False)]
    cases.append(main_case)
    for case in cases:
        b, s, h, d, causal, dtype, layout = case
        is_main = case == main_case
        tol = 1e-4 if dtype == torch.float32 else 1.6e-2
        q, k, v, do = flash_inputs(torch, b, s, h, d, dtype, layout, dev, g)
        where = f"B={b} S={s} H={h} D={d} causal={causal} {dtype} {layout}"
        route = fa.bwd_route(q, k, v, do)
        check(route == expected_route(torch, d, dtype, layout) == fa.fwd_route(q, k, v),
              f"routes: forward {fa.fwd_route(q, k, v)}, backward {route}, the rule says "
              f"{expected_route(torch, d, dtype, layout)}: {where}")
        before = dict(fa.ROUTE_LAUNCHES)
        o, lse = fa.flash_fwd(q, k, v, causal=causal)
        o2, lse2 = fa.flash_fwd(q, k, v, causal=causal)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd not bitwise reproducible: {where}")
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal=causal)
        for name, x, y, t in (("o", o, o_p, tol), ("lse", lse, lse_p, TOL)):
            ok = torch.allclose(x.float(), y.float(), atol=t, rtol=t)
            check(ok, f"flash_fwd {name} max abs err {max_err(torch, x.float(), y.float())}: "
                  f"{where}")
        err_o = max_err(torch, o.float(), o_p.float())
        record("flash_fwd", max(err_o, max_err(torch, lse, lse_p)), is_main)
        record(f"flash_fwd {route} {'f32' if dtype == torch.float32 else 'bf16'}", err_o, False)
        if is_main:
            main["flash_fwd o"] = err_o
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta, causal=causal)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=causal)
        check(torch.equal(dq, fa.flash_dq(q, k, v, do, lse, delta, causal=causal)),
              f"flash_dq not bitwise reproducible: {where}")
        dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal=causal)
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash_dkv not bitwise reproducible: {where}")
        ran = {key: n_ - before[key] for key, n_ in fa.ROUTE_LAUNCHES.items()}
        want = {key: 2 if key.endswith("_" + route) else 0 for key in ran}
        check(ran == want, f"route launches {ran} != {want}: {where}")
        dq_p = fa.flash_dq_plain(q, k, v, do, lse, delta, causal=causal)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=causal)
        for name, x, y in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
            ok = torch.allclose(x.float(), y.float(), atol=tol, rtol=tol)
            check(ok, f"flash {name} max abs err {max_err(torch, x.float(), y.float())}: "
                  f"{where}")
        errs = {"flash_dq": max_err(torch, dq.float(), dq_p.float()),
                "flash_dkv": max(max_err(torch, dk.float(), dk_p.float()),
                                 max_err(torch, dv.float(), dv_p.float()))}
        for name, err in errs.items():
            record(name, err, is_main)
            record(f"{name} {route} {'f32' if dtype == torch.float32 else 'bf16'}", err, False)
        n += 1
    # the quantized forward on codes, at the kernel's own k tile (BLOCK_K)
    qcases = [(fmt, 2, s, 8, d, causal, out, "strided" if s == 200 else "contiguous")
              for fmt in ("int8", "fp8") for s in (64, 200, 2048) for d in (64, 128)
              for causal in (True, False) for out in (torch.bfloat16, torch.float32)]
    qcases += [(fmt,) + main_case for fmt in ("int8", "fp8")]
    for fmt, *case in qcases:
        b, s, h, d, causal, out, layout = case
        is_main = tuple(case) == main_case
        q, k, v, _ = flash_inputs(torch, b, s, h, d, out, layout, dev, g)
        qc, sq, kc, sk, vc, sv = fa.quantize_qkv(q, k, v, fmt)
        where = f"{fmt} B={b} S={s} H={h} D={d} causal={causal} out {out} {layout}"
        o, lse = fa.flash_fwd_quant_codes(qc, kc, vc, sq, sk, sv, causal=causal, out_dtype=out)
        o2, lse2 = fa.flash_fwd_quant_codes(qc, kc, vc, sq, sk, sv, causal=causal,
                                            out_dtype=out)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd_quant not bitwise reproducible: {where}")
        o_p, lse_p = fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, causal=causal,
                                              out_dtype=out)
        diff = (o.float() - o_p.float()).abs()
        err = float(diff.max())
        if fmt == "int8":
            ok = torch.allclose(o.float(), o_p.float(), atol=QUANT_TOL, rtol=QUANT_TOL)
        else:
            v_max = float((vc.float() * sv[..., None]).abs().max())
            ok = float(diff.mean()) <= FP8_MEAN_TOL and err <= FP8_STEP * v_max
        check(ok and torch.allclose(lse, lse_p, atol=TOL, rtol=TOL),
              f"flash_fwd_quant max abs err {err}, mean {float(diff.mean())} "
              f"(lse {max_err(torch, lse, lse_p)}): {where}")
        record("flash_fwd_quant", err, is_main)
        if is_main:
            main[f"flash_fwd_quant {fmt}"] = err
        n += 1
    torch.cuda.synchronize()
    return n, worst, main


def flash_work(b, s, h, d):
    """(bytes, operations) each causal flash kernel must move and do at (B,
    S, H, D): bf16 tensors, 1-byte codes and f32 scales for the quantized
    kernel, f32 lse and delta (inputs read once, outputs written once; the
    causal triangle counts S(S+1)/2 pairs)."""
    pairs = s * (s + 1) // 2
    mat = b * s * h * d  # elements of one (B, S, H, D) tensor
    rows = b * h * s
    mm = 2 * b * h * d * pairs  # one (pairs x D) product
    return {
        "flash_fwd": (4 * mat * 2 + rows * 4, 2 * mm),
        "flash_fwd_quant": (3 * mat * 1 + 3 * rows * 4 + mat * 2 + rows * 4, 2 * mm),
        "flash_dq": (5 * mat * 2 + 2 * rows * 4, 3 * mm),
        "flash_dkv": (6 * mat * 2 + 2 * rows * 4, 4 * mm),
    }


def flash_counts(steps, *, quant=False, remat=False, accum=1, evals=0, eval_batches=0):
    """The flash launches a kernel-route training run at LM_SHAPE must
    make: each micro-batch's forward launches the forward kernel once per
    layer, and once more when a checkpoint (--remat or --remat-attn)
    recomputes it in backward; its backward launches dq and dkv once per
    layer; an eval batch launches the forward alone."""
    layers = LM_SHAPE["n_layers"]
    fwd = layers * (steps * accum * (2 if remat else 1) + evals * eval_batches)
    bwd = layers * steps * accum
    return {"flash_fwd": 0 if quant else fwd, "flash_fwd_quant": fwd if quant else 0,
            "flash_dq": bwd, "flash_dkv": bwd}


def mma_counts(want):
    """The launches by route that a bf16 run at LM_SHAPE (D 64, the model's
    aligned projections) must make, from its `flash_counts`: every forward,
    dq and dkv launch on the mma route, none on the simt route."""
    return {f"{k}_{r}": want[k] if r == "mma" else 0 for k in ("flash_fwd", "flash_dq", "flash_dkv")
            for r in ("mma", "simt")}


def lm_run(torch, fa, lm_train, steps, extra):
    """One `lm_train.main` run on the card at LM_ARGS + `extra`, the flash
    counters set to 0 just before it: its launches (and by route), logged
    losses {step: loss}, tokens/s, ms per step, MFU and peak
    memory."""
    lines = []

    def log(line):
        if not line.startswith("step "):
            print("   " + line, flush=True)
        lines.append(line)

    for counters in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        for key in counters:
            counters[key] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = lm_train.main(["--device", "cuda", "--steps", str(steps), "--log-every",
                        str(LM_LOG_EVERY)] + LM_ARGS + extra, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    check(rc == 0, f"lm_train.main {extra} returned {rc}")
    summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
    # the step lines print 4 decimals; SUMMARY has the first and last loss in full
    losses = {int(l.split()[1]): float(l.split()[3]) for l in lines
              if l.startswith("step ") and l.split()[2] == "loss"}
    logged = sorted({i for i in range(steps) if i % LM_LOG_EVERY == 0} | {steps - 1})
    check(sorted(losses) == logged, f"{extra}: logged losses {losses}")
    losses.update({0: summary["first_loss"], steps - 1: summary["final_loss"]})
    check(all(math.isfinite(x) for x in losses.values()), f"{extra}: losses {losses}")
    return {"extra": extra, "steps": steps, "launches": counts, "routes": routes, "losses": losses,
            "wall_s": wall, "tokens_per_s": summary["tokens_per_s"],
            "mfu_pct": summary["mfu_pct"], "eval": summary["eval"],
            "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (steps - 1),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def named_grads(params, grads):
    """{name: gradient} from `grads` in `tree_leaves` order; a stacked layer
    leaf (n_layers, ...) gives one entry per layer."""
    out, it = {}, iter(grads)
    for key in sorted(params):
        if isinstance(params[key], dict):
            for sub in sorted(params[key]):
                g = next(it)
                out.update({f"{key}.{sub}[{i}]": g[i] for i in range(g.shape[0])})
        else:
            out[key] = next(it)
    return out


def route_grad_errs(torch, tfm, lmtrain, dev):
    """The relative L2 error of every weight's step-0 gradient (the flagship
    model and seed, the copy-task batch lm_train makes) on each kernel route
    (flash, int8, fp8) against the plain route: {route: {name: err}}."""
    sh = LM_SHAPE
    toks, tgts = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=sh["batch_size"],
                                        seq_len=sh["seq_len"], vocab=sh["vocab"], device=dev)
    params = None
    grads = {}
    for route, attn, quant in (("plain", "ring", ""), ("flash", "flash", ""),
                               ("int8", "flash", "int8"), ("fp8", "flash", "fp8")):
        cfg = tfm.TransformerConfig(vocab_size=sh["vocab"], d_model=sh["d_model"],
                                    n_heads=sh["n_heads"], n_layers=sh["n_layers"],
                                    d_ff=sh["d_ff"], dtype=torch.bfloat16, attn_quant=quant)
        if params is None:
            params = tfm.init_params(0, cfg, dev)
            leaves = lmtrain.tree_leaves(params)
            for x in leaves:
                x.requires_grad_(True)
        loss = lmtrain.lm_loss(params, toks, tgts, cfg, attn_impl=attn)
        grads[route] = named_grads(params, torch.autograd.grad(loss, leaves))
    ref = grads.pop("plain")
    return {route: {name: float((g[name] - ref[name]).norm() / ref[name].norm().clamp_min(1e-30))
                    for name in ref} for route, g in grads.items()}


def route_compare(torch, fa, tfm, lmtrain, dev, flash_row, plain_row):
    """The kernel route against the plain route: the logged losses of two
    `lm_run` rows and the step-0 gradients. Prints both readings before it
    gates either (LOSS_TOL, GRAD_TOL on the bf16 kernel route)."""
    d_loss = max(abs(flash_row["losses"][i] - plain_row["losses"][i])
                 for i in plain_row["losses"])
    with uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):  # not the main path's launches
        errs = route_grad_errs(torch, tfm, lmtrain, dev)
    worst = {route: max(e.items(), key=lambda kv: kv[1]) for route, e in errs.items()}
    print(f"   kernel route vs plain route: logged losses (steps {sorted(plain_row['losses'])}) "
          f"max |difference| {d_loss:.6f} (tolerance {LOSS_TOL}); step-0 gradients, worst "
          f"relative L2 error per route: " + ", ".join(
              f"{route} {err:.5f} ({name})" for route, (name, err) in worst.items())
          + f" (tolerance {GRAD_TOL} on flash)", flush=True)
    for route in errs:
        rows = sorted(errs[route].items(), key=lambda kv: -kv[1])[:4]
        print(f"   {route}: " + ", ".join(f"{name} {err:.5f}" for name, err in rows))
    out = {"loss_diff": d_loss, "grad_rel_err": {r: {"worst": n, "err": e}
                                                 for r, (n, e) in worst.items()}}
    check(d_loss <= LOSS_TOL, f"kernel-route losses off the plain route by {d_loss}")
    check(worst["flash"][1] <= GRAD_TOL,
          f"kernel-route gradient {worst['flash'][0]} off the plain route by relative "
          f"{worst['flash'][1]}")
    return out


def route_check() -> int:
    """`python3 chip_smoke.py --route-check`: phase 13's kernel route against
    the plain route alone (build, one flash and one plain run of LM_STEPS
    steps, the step-0 gradients), for showing that a copy of the repo with a
    fault planted in a kernel fails it. Exits 1 when a gate fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    fa.build()
    rows = [lm_run(torch, fa, lm_train, LM_STEPS, extra)
            for extra in (["--attn", "flash"], ["--attn", "ring"])]
    try:
        route_compare(torch, fa, tfm, lmtrain, torch.device("cuda"), *rows)
    except SmokeFailure as e:
        print(f"route check FAILED: {e}")
        return 1
    print("route check passed")
    return 0


# -------------------------------------------------------------------- phases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import _nvcc
    from distributed_neural_network_tpu_torch.ops import decode_attention as da
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
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
    for name, line in (("decode_attention", 95), ("decode_attention_q8", 133)):
        kernels[name] = {"route": "cuda", "replaces": f"{DECODE}:{line}",
                         "source": "distributed_neural_network_tpu_torch/csrc/decode_attention.cu"}
    for name, line in (("flash_fwd", 157), ("flash_fwd_quant", 280), ("flash_dq", 414),
                       ("flash_dkv", 447)):
        kernels[name] = {"route": "cuda", "replaces": f"{FLASH}:{line}",
                         "source": "distributed_neural_network_tpu_torch/csrc/flash_attention.cu"}

    with phase("1 environment"):
        print(f"card: {smi}")
        try:
            import triton

            triton_v = triton.__version__
        except ImportError:
            triton_v = "absent"
        nvcc = run([_nvcc.nvcc(), "--version"]).splitlines()
        env = {"card": smi, "versions": f"python {sys.version.split()[0]}, torch "
               f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
               f"{nvcc[-1] if nvcc else '?'}, triton {triton_v}"}
        print(env["versions"])
        print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    with phase("2 build"):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            libs = list(pool.map(lambda m: m.build(), (fh, da, fa)))
        for m in (fh, da, fa):
            m._lib()
        env["build_s"] = time.perf_counter() - t0
        print(f"built {', '.join(os.path.relpath(p, ROOT) for p in libs)} in "
              f"{env['build_s']:.2f} s (in parallel)")
        env["ptxas"] = [print_ptxas(lib) for lib in libs]
        # the tensor-core instances: dq and dkv per padded head dim, the
        # forward's mma.sync ones (16, 32, 128) and its wgmma one (64)
        env["mma_instances"] = ptxas_instances(libs[2], "_mma_")
        env["mma_instances"].update(ptxas_instances(libs[2], "_wgmma_"))
        for name, info in sorted(env["mma_instances"].items()):
            dp = int(name.split("<")[1][:-1])
            info.update(fa.mma_info(name.split("_mma")[0].split("_wgmma")[0], dp))
            print(f"   {name}: {info['registers']} registers, spill stores "
                  f"{info['spill_stores']} B, spill loads {info['spill_loads']} B; "
                  f"{info['smem_bytes']} B of dynamic shared memory, {info['blocks_per_sm']} "
                  f"blocks per SM")
        check(len(env["mma_instances"]) == 12, f"mma instances {sorted(env['mma_instances'])}")
        # the head forward's cluster instances (<blocks per 16-row tile>)
        env["head_fwd_instances"] = ptxas_instances(libs[0], "mlp3_fwd")
        for name, info in sorted(env["head_fwd_instances"].items()):
            info.update(fh.fwd_info(int(name.split("<")[1][:-1])))
            print(f"   {name}: {info['registers']} registers, spill stores "
                  f"{info['spill_stores']} B; {info['static_smem']} B of static shared memory, "
                  f"{info['blocks_per_sm']} blocks per SM, {info['active_clusters']} clusters "
                  f"at once")
        check(len(env["head_fwd_instances"]) == 2,
              f"head forward instances {sorted(env['head_fwd_instances'])}")
        # the head backward's one instance (<blocks per 16-row tile>), the
        # size the rule gives
        env["head_bwd_instances"] = ptxas_instances(libs[0], "mlp3_bwd")
        for name, info in sorted(env["head_bwd_instances"].items()):
            info.update(fh.bwd_info())
            print(f"   {name}: {info['registers']} registers, spill stores "
                  f"{info['spill_stores']} B; {info['smem_bytes']} B of dynamic shared memory, "
                  f"{info['blocks_per_sm']} blocks per SM, {info['active_clusters']} clusters "
                  f"at once")
            check(info["cluster"] == fh.bwd_cluster(16),
                  f"the backward is built at {info['cluster']} blocks a tile, the rule says "
                  f"{fh.bwd_cluster(16)}")
        check(sorted(env["head_bwd_instances"]) == [f"mlp3_bwd_kernel<{fh.bwd_cluster(16)}>"],
              f"head backward instances {sorted(env['head_bwd_instances'])}")
        # the decode kernel's split instances (<dtype, lanes per row, vectors
        # a lane>), each at its largest head dim and a cache of 256 rows
        env["decode_split_instances"] = ptxas_instances(libs[1], "decode_split")
        for name, info in sorted(env["decode_split_instances"].items()):
            dt, lanes, vecs = name.split("<")[1][:-1].split(",")
            f32 = dt == "f32"
            info["head_dim"] = int(lanes) * int(vecs) * (4 if f32 else 8)
            info.update(da.split_info(torch.float32 if f32 else torch.bfloat16,
                                      info["head_dim"], 256))
            print(f"   {name} (Dh {info['head_dim']}): {info['registers']} registers, spill "
                  f"stores {info['spill_stores']} B; {info['static_smem']} B of static shared "
                  f"memory, {info['blocks_per_sm']} blocks per SM, clusters of "
                  f"{info['cluster']}, {info['active_clusters']} at once")
        check(len(env["decode_split_instances"]) == 13,
              f"decode split instances {sorted(env['decode_split_instances'])}")

    with phase("3 kernels vs plain"):
        for b in (1, 16, 17, 128, 200, 4096):
            args = head_inputs(torch, b, dev, seed=b)
            # each kernel alone against its plain version; the forward (a
            # cluster of 8 blocks a tile up to 256 rows, 4 above) with and
            # without residuals, bitwise on a rerun
            out_k = fh.mlp3_forward(*args, residuals=True)
            out_r = fh.mlp3_forward_reference(*args)
            assert_close(torch, f"fwd B={b}", out_k, out_r)
            again = fh.mlp3_forward(*args, residuals=True)
            check(all(torch.equal(a, c) for a, c in zip(out_k, again)),
                  f"forward is not bitwise reproducible at B={b}")
            check(torch.equal(fh.mlp3_forward(*args, residuals=False)[0], out_k[0]),
                  f"forward logits differ without residuals at B={b}")
            x, w1, b1, w2, b2, w3, b3 = args
            gout = torch.randn(b, 10, device=dev, generator=torch.Generator(dev).manual_seed(b))
            _, h1, h2 = out_r
            part_k = fh.mlp3_bwd_partials(gout, x, h1, h2, w1, w2, w3)
            part_r = fh.mlp3_bwd_partials_reference(gout, x, h1, h2, w1, w2, w3)
            assert_close(torch, f"bwd B={b}", part_k, part_r)
            # the backward (a cluster of bwd_cluster(B) blocks a tile) bitwise
            # on a rerun
            check(all(torch.equal(a, c) for a, c in zip(
                part_k, fh.mlp3_bwd_partials(gout, x, h1, h2, w1, w2, w3))),
                  f"backward partials are not bitwise reproducible at B={b}")
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
        print("forward and backward partials bitwise reproducible at every B; the whole "
              "backward at B=200 and B=4096")

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

        # the checked main-path run first, then torch, for an end-to-end
        # comparison of the two heads within this call
        for run_i, kern in enumerate(("cuda", "torch")):
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

            def lib_leaves_fwd(ls=leaves):
                lh1 = torch.addmm(ls[2], ls[0], ls[1]).relu()
                lh2 = torch.addmm(ls[4], lh1, ls[3]).relu()
                return torch.addmm(ls[6], lh2, ls[5])

            lib_out = lib_leaves_fwd()

            def lib_fwd_bwd():
                # fresh leaves and a fresh graph on the capturing stream: the
                # autograd engine then never waits on another stream
                ls = [a.detach().requires_grad_() for a in args]
                return torch.autograd.grad(lib_leaves_fwd(ls), ls, g)

            def lib_bwd_device_ms():
                # the backward's device time is forward + backward, both
                # captured, less the forward alone
                both = graph_ms(torch, lib_fwd_bwd)
                fwd = graph_ms(torch, lambda: lib_leaves_fwd([a.detach() for a in args]))
                return None if both is None or fwd is None else both - fwd

            work = head_work(b, fh)
            rows = {
                "fused_mlp3_fwd": (
                    lambda: fh.mlp3_forward(*args, residuals=True),
                    lambda: fh.mlp3_forward_reference(*args),
                    lib_fwd, None, work["fwd"]),
                "fused_mlp3_bwd": (
                    lambda: fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3),
                    lambda: fh.mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3),
                    lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True),
                    lib_bwd_device_ms, work["bwd"]),
                "fused_mlp3_bwd_reduce": (
                    lambda: fh.mlp3_bwd_reduce(parts), lambda: parts.sum(0),
                    lambda: torch.sum(parts, 0), None, work["reduce"]),
            }
            saved = dict(fh.LAUNCHES)
            for name, (kern_fn, plain_fn, lib_fn, lib_dev, (nbytes, flops)) in rows.items():
                t_k, t_p, t_l = (time_ms(torch, f) for f in (kern_fn, plain_fn, lib_fn))
                d_k, d_p = (graph_ms(torch, f) for f in (kern_fn, plain_fn))
                d_l = lib_dev() if lib_dev else graph_ms(torch, lib_fn)
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
            fwd = next(t for t in times if t["B"] == b and t["name"] == "fused_mlp3_fwd")
            fwd["cluster"] = fh.fwd_cluster(b)
            ratio = (fwd["graph_ms"] / fwd["library_graph_ms"]
                     if fwd["graph_ms"] and fwd["library_graph_ms"] else None)
            print(f"B={b:5d} fused_mlp3_fwd, {fwd['cluster']} blocks a tile: device "
                  f"{fmt(fwd['graph_ms'])} ms, {fmt(ratio)}x the addmm chain's")
            if b == 16:
                check(ratio is not None and ratio <= 1.0,
                      f"the head forward's device time at B=16 is {fmt(ratio)}x the addmm "
                      f"chain's")
            bwd = next(t for t in times if t["B"] == b and t["name"] == "fused_mlp3_bwd")
            bwd["cluster"] = fh.bwd_cluster(b)
            ratio = (bwd["graph_ms"] / bwd["library_graph_ms"]
                     if bwd["graph_ms"] and bwd["library_graph_ms"] else None)
            print(f"B={b:5d} fused_mlp3_bwd, {bwd['cluster']} blocks a tile: device "
                  f"{fmt(bwd['graph_ms'])} ms, {fmt(ratio)}x the autograd backward's")
            if b == 16:
                check(ratio is not None and ratio <= 1.0,
                      f"the head backward's device time at B=16 is {fmt(ratio)}x the autograd "
                      f"backward's")
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
        rows = profile_rows(prof, DeviceType)
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

    with phase("8 decode kernels vs plain"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        # comparison launches are not main-path launches
        g = torch.Generator(dev).manual_seed(0)
        n_checks = 0
        worst, routes = {}, {}
        for kind in ("float32", "bfloat16", "int8"):
            tol = 1e-5 if kind == "float32" else 1.6e-2
            for b in (1, 8):
                for h, d in ((8, 64), (4, 128), (4, 8)):
                    for total in (16, 256, 2048):
                        vec = torch.randint(0, total, (b,), device=dev, generator=g,
                                            dtype=torch.int32)
                        vec[0], vec[-1] = 0, total - 1
                        vecs = [vec] if b > 1 else [vec[:1] * 0, vec[:1] * 0 + total - 1]
                        for layout in DECODE_LAYOUTS:
                            q, k, v, kw = decode_inputs(torch, kind, b, h, d, total, layout,
                                                        dev, g)
                            route = da.decode_route(q, k, v, kw.get("k_scale"))
                            want_route = ("split" if kind != "int8" and layout != "misaligned"
                                          else "simt")
                            fn = "decode_attention_q8" if kw else "decode_attention"
                            for pos in (0, total - 1, *vecs):
                                where = (f"{kind} B={b} H={h} Dh={d} total={total} {layout} "
                                         f"pos={pos if isinstance(pos, int) else pos.tolist()}")
                                check(route == want_route,
                                      f"route {route}, the rule says {want_route}: {where}")
                                before = dict(da.ROUTE_LAUNCHES)
                                o1 = da.decode_cache_attention(q, k, v, pos, **kw)
                                o2 = da.decode_cache_attention(q, k, v, pos, **kw)
                                ref = da.decode_attention_plain(q, k, v, pos, **kw)
                                check(torch.equal(o1, o2), f"not bitwise reproducible: {where}")
                                err = max_err(torch, o1.float(), ref.float())
                                check(torch.allclose(o1.float(), ref.float(), atol=tol, rtol=tol),
                                      f"kernel vs plain max abs err {err}: {where}")
                                # the bits may not depend on the cache length ...
                                m = int(pos if isinstance(pos, int) else pos.max()) + 1
                                kw_m = {n: t[:, :, :m] for n, t in kw.items()}
                                o3 = da.decode_cache_attention(q, k[:, :, :m], v[:, :, :m], pos,
                                                               **kw_m)
                                check(torch.equal(o1, o3), f"bits change with the cache length: {where}")
                                calls = 3
                                if b > 1:
                                    # ... nor on the batch: row 3 alone in a batch of 1
                                    kw_1 = {n: t[3:4] for n, t in kw.items()}
                                    o4 = da.decode_cache_attention(
                                        q[3:4].contiguous(), k[3:4], v[3:4],
                                        pos if isinstance(pos, int) else pos[3:4], **kw_1)
                                    check(torch.equal(o4, o1[3:4]),
                                          f"bits change with the batch: {where}")
                                    calls = 4
                                ran = {key: n_ - before[key] for key, n_ in da.ROUTE_LAUNCHES.items()}
                                want = {key: calls if key == f"{fn}_{route}" else 0 for key in ran}
                                check(ran == want, f"route launches {ran} != {want}: {where}")
                                worst[kind] = max(worst.get(kind, 0.0), err)
                                routes[kind, route] = routes.get((kind, route), 0) + 1
                                if (h, d) == (8, 64) and total <= 256 and layout != "misaligned":
                                    worst[kind, "main"] = max(worst.get((kind, "main"), 0.0), err)
                                n_checks += 1
        torch.cuda.synchronize()
        # the split rule as the CUDA source computes it
        mism = [(n, d) for d in (4, 8, 16, 24, 64, 128, 256) for n in range(0, 4200, 3)
                if da.kernel_piece_rows(n, d) != da.piece_rows(n, d)]
        check(not mism, f"decode_pieces disagrees with the CUDA source at (n, Dh) {mism[:5]}")
        kernels["decode_attention"]["max_abs_err"] = worst["bfloat16", "main"]
        kernels["decode_attention_q8"]["max_abs_err"] = worst["int8", "main"]
        print(f"{n_checks} cases within tolerance, each on the route the rule gives "
              f"({', '.join(f'{k} {r}: {n}' for (k, r), n in sorted(routes.items()))}), bitwise "
              f"reproducible and independent of the cache length and the batch; max abs err "
              f"f32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}, int8 "
              f"{worst['int8']:.3g} (at B<=8, H=8, Dh=64, total<=256, aligned: bf16 "
              f"{worst['bfloat16', 'main']:.3g}, int8 {worst['int8', 'main']:.3g}); "
              f"decode_pieces agrees with the CUDA source")

    serving = []
    with phase("9 serving main path, full width"):
        import numpy as np

        from distributed_neural_network_tpu_torch.models import transformer as tfm
        from distributed_neural_network_tpu_torch.serve.http import build_server

        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 256, size=PROMPT_LENS[i % 3]).tolist()
                   for i in range(N_REQUESTS)]
        arrivals = np.cumsum(rng.exponential(1.0 / RATE, size=N_REQUESTS)).tolist()
        t0 = time.perf_counter()
        with uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
            oracle = Oracle(torch, tfm, prompts, dev)
            ties = oracle.near_ties()
        print(f"offline bf16 generate() oracle for {N_REQUESTS} prompts in "
              f"{time.perf_counter() - t0:.2f} s; {ties:.4f} of its greedy choices have a "
              f"top-2 logit gap under 0.02")
        for precision in ("bf16", "int8-kv"):
            for impl in ("cuda", "torch"):
                srv, sched, eng = build_server(
                    SERVE_ARGS + ["--precision", precision, "--decode-impl", impl],
                    log=lambda line: print("   " + line, flush=True))
                try:
                    for counters in (da.LAUNCHES, da.ROUTE_LAUNCHES):
                        for name in counters:
                            counters[name] = 0
                    calls0, pre0, ticks0 = eng.decode_calls, eng.prefill_calls, eng.ticks
                    torch.cuda.synchronize()
                    results = open_loop(srv.port, prompts, arrivals)
                    torch.cuda.synchronize()
                    launches, by_route = dict(da.LAUNCHES), dict(da.ROUTE_LAUNCHES)
                    calls, ticks = eng.decode_calls - calls0, eng.ticks - ticks0
                    pre_calls = eng.prefill_calls - pre0
                finally:
                    rec = sched.close()  # finalize asserts the ledger's conservation
                    srv.close()
                done = [r for r in results
                        if r.get("done") and r["done"].get("status") == "done"
                        and len(r["tokens"]) == MAX_NEW]
                served = [r.get("tokens", []) for r in results]
                same_route = None
                with uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
                    strict, agree, stream_agree = oracle.agreement(served)
                    if (precision, impl) == ("bf16", "torch"):
                        # the plain route's own contract: generate() on the same
                        # route (generate() has no int8 K/V, so bf16 only)
                        same_route = dict(zip(("strict_agreement", "agreement",
                                               "stream_agreement"),
                                              oracle.agreement(served, impl="torch")))
                n_tok = sum(len(r.get("tokens", [])) for r in results)
                window = max(r["t_done"] for r in results) - min(r["t0"] for r in results)
                ttft = [r["stamps"][0] - r["t0"] for r in results if r.get("stamps")]
                gaps = [b - a for r in results for a, b in zip(r["stamps"], r["stamps"][1:])]
                step_s = rec["goodput_s"] + rec["badput_s"]["prefill"] + rec["badput_s"][
                    "kv_alloc_stall"]
                conserved = abs(rec["goodput_s"] + sum(rec["badput_s"].values())
                                - rec["wall_s"]) <= 1e-5 * max(rec["wall_s"], 1.0)
                row = {"precision": precision, "decode_impl": impl, "completed": len(done),
                       "agreement": agree, "strict_agreement": strict,
                       "stream_agreement": stream_agree, "tokens": n_tok,
                       "req_per_s": len(done) / window, "tokens_per_s": n_tok / window,
                       "ttft_p50_s": pct(ttft, 0.5), "ttft_p99_s": pct(ttft, 0.99),
                       "intertoken_p99_s": pct(gaps, 0.99), "ticks": ticks,
                       "decode_calls": calls, "prefill_calls": pre_calls, "step_ms_per_tick": 1e3 * step_s / max(ticks, 1),
                       "goodput_ratio": rec["goodput_ratio"], "launches": launches,
                       "launches_by_route": by_route, "same_route": same_route,
                       "badput_s": rec["badput_s"], "wall_s": rec["wall_s"]}
                serving.append(row)
                print(f"   {precision:7s} {impl:5s}: {len(done)}/{N_REQUESTS} done, agreement "
                      f"per token {agree:.4f} (strict {strict:.4f}), stream {stream_agree:.4f} "
                      f"over {n_tok} tokens; "
                      f"{row['req_per_s']:.3f} req/s, "
                      f"{row['tokens_per_s']:.1f} tokens/s; TTFT p50 {row['ttft_p50_s']:.4f} s "
                      f"p99 {row['ttft_p99_s']:.4f} s; inter-token p99 "
                      f"{row['intertoken_p99_s']:.4f} s; {row['step_ms_per_tick']:.3f} ms per "
                      f"engine tick ({ticks} ticks, {calls} decode calls, {pre_calls} prefill "
                      f"calls); goodput ratio "
                      f"{rec['goodput_ratio']}; launches {launches}, by route {by_route}")
                if same_route is not None:
                    print(f"   {precision:7s} {impl:5s} against generate(decode_impl=\"torch\"), "
                          f"the same route: per token {same_route['strict_agreement']:.4f} "
                          f"(up to the kernel route's rounding {same_route['agreement']:.4f}), "
                          f"stream {same_route['stream_agreement']:.4f}")
                check(len(done) == N_REQUESTS, f"{len(done)}/{N_REQUESTS} requests completed")
                check(agree >= 0.99,
                      f"per-token agreement {agree:.4f} < 0.99 vs offline generate")
                if (precision, impl) == ("bf16", "cuda"):
                    # generate()'s arithmetic on the card, so the JAX row's
                    # stream form of the gate holds as well
                    check(stream_agree >= 0.99,
                          f"stream agreement {stream_agree:.4f} < 0.99 vs offline generate")
                check(conserved, f"serving ledger does not conserve: {rec}")
                name = "decode_attention_q8" if precision == "int8-kv" else "decode_attention"
                if impl == "cuda":
                    n = (calls + pre_calls) * 8
                    want = {k: (n if k == name else 0) for k in launches}
                    check(calls > 0 and launches == want,
                          f"decode launches {launches} != (decode calls {calls} + prefill calls "
                          f"{pre_calls}) x 8 layers")
                    # bf16 on the split route, int8 K/V on simt, every launch
                    route = f"{name}_{'simt' if precision == 'int8-kv' else 'split'}"
                    want = {k: (n if k == route else 0) for k in by_route}
                    check(by_route == want, f"decode launches by route {by_route} != {want}")
                    kernels[name]["launches"] = launches[name]
                else:
                    check(not any(launches.values()) and not any(by_route.values()),
                          f"--decode-impl torch launched {launches}")

    decode_times = []
    with phase("10 decode kernel times"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        import torch.nn.functional as F

        g = torch.Generator(dev).manual_seed(1)
        b, total = 8, 256
        for h, d in ((8, 64), (4, 128)):
            for prefix in (64, 256):
                for kind in ("bfloat16", "int8"):
                    q, k, v, kw = decode_inputs(torch, kind, b, h, d, total, "strided", dev, g)
                    pos = torch.full((b,), prefix - 1, dtype=torch.int32, device=dev)
                    mask = (torch.arange(total, device=dev) < prefix)[None, None, None, :]

                    def lib(q=q, k=k, v=v, kw=kw, mask=mask):
                        if kw:
                            k = (k.float() * kw["k_scale"][..., None]).to(q.dtype)
                            v = (v.float() * kw["v_scale"][..., None]).to(q.dtype)
                        return F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask)

                    fns = (lambda q=q, k=k, v=v, kw=kw, pos=pos:
                           da.decode_cache_attention(q, k, v, pos, **kw),
                           lambda q=q, k=k, v=v, kw=kw, pos=pos:
                           da.decode_attention_plain(q, k, v, pos, **kw), lib)
                    t_k, t_p, t_l = (time_ms(torch, f) for f in fns)
                    d_k, d_p, d_l = (graph_ms(torch, f) for f in fns)
                    route = da.decode_route(q, k, v, kw.get("k_scale"))
                    simt = {}
                    if route == "split":
                        # the same values in misaligned views: the simt route
                        # (the one-block kernel) at this shape, in this call
                        mq, mk, mv, _ = decode_inputs(torch, kind, b, h, d, total, "misaligned",
                                                      dev, g)
                        mq.copy_(q), mk.copy_(k), mv.copy_(v)
                        check(da.decode_route(mq, mk, mv) == "simt",
                              "phase 10's misaligned copies are not on the simt route")

                        def simt_fn(q=mq, k=mk, v=mv, pos=pos):
                            return da.decode_cache_attention(q, k, v, pos)

                        simt = {"ms": time_ms(torch, simt_fn), "graph_ms": graph_ms(torch, simt_fn)}
                    kv_bytes = 2 * b * h * prefix * d * (1 if kw else 2)
                    nbytes = kv_bytes + 2 * b * h * d * 2 + b * 4 + (
                        2 * b * h * prefix * 4 if kw else 0)
                    flops = 4 * b * h * prefix * d
                    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
                    name = "decode_attention_q8" if kw else "decode_attention"
                    decode_times.append({
                        "name": name, "route": route, "B": b, "H": h, "Dh": d, "prefix": prefix,
                        "total": total, "ms": t_k, "graph_ms": d_k, "plain_ms": t_p,
                        "plain_graph_ms": d_p, "library_ms": t_l, "library_graph_ms": d_l,
                        "simt_ms": simt.get("ms"), "simt_graph_ms": simt.get("graph_ms"),
                        "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops})
                    print(f"{name:20s} B={b} H={h} Dh={d} prefix {prefix:3d} ({route}): per call "
                          f"kernel {t_k:.5f} ms plain {t_p:.5f} ms library {t_l:.5f} ms | device "
                          f"(graph): kernel {fmt(d_k)} ms plain {fmt(d_p)} ms library "
                          f"{fmt(d_l)} ms" + (f" simt route {fmt(simt['graph_ms'])} ms" if simt
                                              else "")
                          + f" | bound {bms:.6f} ms ({by}: {nbytes} B, {flops} FLOP)")
                    if (h, d, prefix) == (8, 64, 256):
                        kernels[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                             bound_ms=bms, bound_by=by, graph_ms=d_k)
                        if name == "decode_attention":
                            ratio = d_k / d_l if d_k and d_l else None
                            print(f"   split route at (B, H, Dh, prefix) = (8, 8, 64, 256): "
                                  f"{fmt(ratio)}x SDPA's device time, "
                                  f"{fmt(simt['graph_ms'] / d_k if d_k else None)}x faster than "
                                  f"the simt route, {fmt(d_k / bms if d_k else None)}x its bound")
                            check(ratio is not None and ratio <= 1.0,
                                  f"the decode kernel's device time at (8, 8, 64, 256) is "
                                  f"{fmt(ratio)}x SDPA's")

    serve_profile = {}
    with phase("11 where the serving time goes"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        from distributed_neural_network_tpu_torch.serve.engine import Sequence
        from distributed_neural_network_tpu_torch.serve.http import build_server

        srv, sched, eng = build_server(SERVE_ARGS + ["--decode-impl", "cuda"],
                                       log=lambda line: None)
        sched.close(finalize=False)  # the engine is driven directly below
        srv.close()
        rng = np.random.default_rng(5)
        seqs = [Sequence(i, rng.integers(0, 256, size=64).tolist(), 64) for i in range(8)]
        for s_ in seqs:
            eng.add(s_)
        while any(s_.pos < s_.prompt_len for s_ in seqs):
            eng.step()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        n_ticks = 20
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = profile_rows(prof, DeviceType)
        busy = sum(r[1] for r in rows) / 1e6
        decode_rows = [r for r in rows if "decode_" in r[0]]
        decode_s = sum(r[1] for r in decode_rows) / 1e6
        serve_profile = {"wall_s": wall, "device_busy_s": busy, "ticks": n_ticks,
                         "idle_share": 1 - busy / wall if busy else None,
                         "decode_kernel_s": decode_s,
                         "decode_launches": sum(r[2] for r in decode_rows),
                         "top": sorted(rows, key=lambda r: -r[1])[:12]}
        print(f"{n_ticks} decode ticks at batch 8 (positions 69-88): wall {wall:.4f} s "
              f"({1e3 * wall / n_ticks:.3f} ms/tick), device busy {busy:.4f} s, idle share "
              f"{'not measured' if not busy else f'{1 - busy / wall:.3f}'}; the decode kernel "
              f"{1e3 * decode_s:.3f} ms over {serve_profile['decode_launches']} launches"
              + (f", {decode_s / busy:.3f} of device time" if busy else ""))
        for key, us, count in serve_profile["top"]:
            print(f"   {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")

    with phase("12 flash kernels vs plain"):
        with uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):  # comparison launches
            n, worst, main_err = flash_vs_plain(torch, fa, dev)
        flash_checks = {"cases": n, "worst": worst, "main": main_err}
        for name in ("flash_fwd", "flash_fwd_quant", "flash_dq", "flash_dkv"):
            kernels[name]["max_abs_err"] = main_err[name]
        print(f"{n} cases within tolerance and bitwise reproducible; max abs err over all "
              f"cases {worst}; at the main path's shape (B, S, H, D) = {FLASH_MAIN}, causal "
              f"bf16 (the quantized kernel: the larger of int8 and fp8) {main_err}")

    lm_runs, lm_checks = {}, {}
    with phase("13 LM training main path, full width"):
        import numpy as np

        from distributed_neural_network_tpu_torch import lm_train
        from distributed_neural_network_tpu_torch.models import transformer as tfm
        from distributed_neural_network_tpu_torch.train import lm as lmtrain

        runs = (("flash", ["--attn", "flash"], {}),
                ("int8", ["--attn", "flash", "--precision", "int8"], {"quant": True}),
                ("fp8", ["--attn", "flash", "--precision", "fp8"], {"quant": True}),
                ("plain", ["--attn", "ring"], None))
        # each route twice, in mirrored order (flash, int8, fp8, plain, plain,
        # fp8, int8, flash), so a drift along the call shows and routes are
        # compared in turns
        for name, extra, formula in runs + runs[::-1]:
            row = lm_run(torch, fa, lm_train, LM_STEPS, extra)
            counts = row["launches"]
            first = name not in lm_runs
            lm_runs.setdefault(name, []).append(row)
            loss = row["losses"]
            print(f"   {name}: {row['tokens_per_s']} tokens/s, {row['ms_per_step']:.2f} ms per "
                  f"step, MFU {row['mfu_pct']}% of the bf16 dense peak, losses {loss[0]:.4f} "
                  f"-> {loss[LM_STEPS - 1]:.4f}, peak memory {row['peak_mem_gib']:.2f} GiB, "
                  f"launches {counts}, by route {row['routes']}", flush=True)
            want = (dict.fromkeys(counts, 0) if formula is None
                    else flash_counts(LM_STEPS, **formula))
            check(counts == want, f"{name}: flash launches {counts} != expected {want}")
            check(row["routes"] == mma_counts(want),
                  f"{name}: launches by route {row['routes']} != {mma_counts(want)}")
            if first and name == "flash":
                for key in ("flash_fwd", "flash_dq", "flash_dkv"):
                    kernels[key]["launches"] = counts[key]
            elif first and name == "int8":
                kernels["flash_fwd_quant"]["launches"] = counts["flash_fwd_quant"]
        for name, rows in lm_runs.items():
            steps_ms = ", ".join(f"{r['ms_per_step']:.2f}" for r in rows)
            print(f"   {name}: ms per step {steps_ms} (in the order run)")
        lm_checks["route"] = route_compare(torch, fa, tfm, lmtrain, dev, lm_runs["flash"][0],
                                           lm_runs["plain"][0])

        # the launch formulas under recomputation, accumulation and eval, at
        # full width for FORMULA_STEPS steps (eval batches from a corpus of
        # random tokens written here and removed after)
        corpus = os.path.join(ROOT, "chiprun_out", "lm_tokens.npy")
        os.makedirs(os.path.dirname(corpus), exist_ok=True)
        np.save(corpus, np.random.default_rng(13).integers(0, 32768, 1 << 20, dtype=np.uint16))
        ev = ["--data-path", corpus, "--eval-every", "2", "--eval-batches", "2"]
        n_ev = {"evals": FORMULA_STEPS // 2, "eval_batches": 2}
        lm_checks["formulas"] = {}
        try:
            for name, extra, formula in (
                    ("--remat", ["--attn", "flash", "--remat"], {"remat": True}),
                    ("--remat-attn", ["--attn", "flash", "--remat-attn"], {"remat": True}),
                    ("--accum-steps 2", ["--attn", "flash", "--accum-steps", "2"], {"accum": 2}),
                    ("eval", ["--attn", "flash"] + ev, n_ev),
                    ("int8 --remat-attn eval", ["--attn", "flash", "--precision", "int8",
                                                "--remat-attn"] + ev,
                     {"quant": True, "remat": True, **n_ev})):
                row = lm_run(torch, fa, lm_train, FORMULA_STEPS, extra)
                want = flash_counts(FORMULA_STEPS, **formula)
                lm_checks["formulas"][name] = {"launches": row["launches"], "want": want,
                                               "routes": row["routes"], "formula": formula}
                print(f"   {name}: launches {row['launches']} (formula {formula}: {want}); "
                      f"by route {row['routes']}", flush=True)
                check(row["launches"] == want,
                      f"{name}: flash launches {row['launches']} != expected {want}")
                check(row["routes"] == mma_counts(want),
                      f"{name}: launches by route {row['routes']} != {mma_counts(want)}")
                check(("evals" not in formula) == (row["eval"] is None)
                      and (row["eval"] is None or math.isfinite(row["eval"]["eval_loss"])),
                      f"{name}: eval {row['eval']}")
        finally:
            os.remove(corpus)

    learn = {}
    with phase("14 learnability"):
        lines = []
        for counters in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
            for key in counters:
                counters[key] = 0
        rc = lm_train.main(["--device", "cuda", "--steps", "300", "--batch-size", "32",
                            "--seq-len", "16", "--vocab", "32", "--d-model", "32", "--n-heads",
                            "4", "--n-layers", "2", "--d-ff", "64", "--lr", "0.3", "--attn",
                            "flash", "--generate", "7", "--log-every", "100"],
                           log=lambda line: (print("   " + line, flush=True), lines.append(line)))
        counts = dict(fa.LAUNCHES)
        summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
        gens = [l for l in lines if l.startswith("gen[")]
        hits = total = 0
        for g_line in gens:
            prompt = json.loads(g_line.split("prompt=")[1].split(" completion=")[0])
            done = json.loads(g_line.split("completion=")[1])
            # prompt = the first half + its first token again: the rest repeats
            hits += sum(int(a == b) for a, b in zip(done, prompt[1:8]))
            total += len(done)
        learn = {"final_loss": summary["final_loss"], "match": hits / max(total, 1),
                 "launches": counts}
        print(f"copy task: final loss {summary['final_loss']:.4f}, greedy continuation "
              f"matches the repeat on {hits}/{total} positions; launches {counts}")
        check(rc == 0 and len(gens) == 2, "lm_train.main did not generate")
        check(summary["final_loss"] < 0.2, f"final loss {summary['final_loss']} >= 0.2")
        check(hits / max(total, 1) > 0.9, f"continuation match {hits}/{total} <= 0.9")
        check(counts["flash_fwd"] == counts["flash_dq"] == counts["flash_dkv"] == 300 * 2,
              f"learnability launches {counts} != 300 steps x 2 layers")
        # head dim 8 is outside the mma rule: every launch on the simt route
        check(all(n == (600 if key.endswith("_simt") else 0)
                  for key, n in fa.ROUTE_LAUNCHES.items()),
              f"learnability launches by route {fa.ROUTE_LAUNCHES}")

    flash_times, flash_pair = [], []
    with phase("15 flash kernel times"), uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        # the library yardstick: the dispatch's `lib` route, one
        # scaled_dot_product_attention(is_causal=True) call on (B, H, S, D) views
        from distributed_neural_network_tpu_torch.ops.flash import flash_local_attention

        g = torch.Generator(dev).manual_seed(15)
        for b, s_, h, d in (FLASH_MAIN, (16, 2048, 4, 128)):
            q, k, v, do = flash_inputs(torch, b, s_, h, d, torch.bfloat16, "contiguous", dev, g)
            o, lse = fa.flash_fwd(q, k, v)
            delta = fa.flash_delta(o, do)
            qc, sq, kc, sk, vc, sv = fa.quantize_qkv(q, k, v, "int8")
            # the same values in misaligned views: the simt route (the scalar
            # kernels) at this shape, timed in the same call
            mis = flash_inputs(torch, b, s_, h, d, torch.bfloat16, "misaligned", dev, g)
            for x, y in zip(mis, (q, k, v, do)):
                x.copy_(y)
            check(fa.bwd_route(q, k, v, do) == fa.fwd_route(q, k, v) == "mma"
                  and fa.bwd_route(*mis) == fa.fwd_route(*mis[:3]) == "simt",
                  "phase 15's inputs are not on the routes they time")

            def sdpa_fwd():
                return flash_local_attention(q, k, v, impl="lib")

            def sdpa_fwd_bwd():
                ls = [x.detach().requires_grad_() for x in (q, k, v)]
                return torch.autograd.grad(flash_local_attention(*ls, impl="lib"), ls, do)

            lib = {"fwd": (time_ms(torch, sdpa_fwd, iters=50), graph_ms(torch, sdpa_fwd, iters=10)),
                   "fwd_bwd": (time_ms(torch, sdpa_fwd_bwd, iters=50),
                               graph_ms(torch, sdpa_fwd_bwd, iters=10))}
            bwd = tuple(None if fb is None or f is None else fb - f
                        for fb, f in zip(lib["fwd_bwd"], lib["fwd"]))
            work = flash_work(b, s_, h, d)
            rows = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v),
                              lib["fwd"], PEAK_BF16_FLOPS),
                "flash_fwd simt": (lambda: fa.flash_fwd(*mis[:3]), None, lib["fwd"],
                                   PEAK_BF16_FLOPS),
                "flash_fwd_quant": (
                    lambda: fa.flash_fwd_quant_codes(qc, kc, vc, sq, sk, sv,
                                                     out_dtype=torch.bfloat16),
                    lambda: fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv,
                                                     out_dtype=torch.bfloat16),
                    (None, None), PEAK_INT8_OPS),
                "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta),
                             lambda: fa.flash_dq_plain(q, k, v, do, lse, delta), bwd,
                             PEAK_BF16_FLOPS),
                "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                              lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta), bwd,
                              PEAK_BF16_FLOPS),
                "flash_dq simt": (lambda: fa.flash_dq(*mis, lse, delta), None, bwd,
                                  PEAK_BF16_FLOPS),
                "flash_dkv simt": (lambda: fa.flash_dkv(*mis, lse, delta), None, bwd,
                                   PEAK_BF16_FLOPS),
            }
            dev_ms = {}
            for name, (kern_fn, plain_fn, (t_l, d_l), peak) in rows.items():
                t_k = time_ms(torch, kern_fn, iters=20, warmup=3)
                d_k = graph_ms(torch, kern_fn, iters=10, replays=3)
                t_p = d_p = None
                if plain_fn is not None:  # the other rows share the mma rows' plain version
                    t_p = time_ms(torch, plain_fn, iters=3, warmup=1)
                    d_p = graph_ms(torch, plain_fn, iters=2, replays=2)
                nbytes, ops = work[name.split()[0]]
                bms, by = bound_ms(nbytes, ops, peak)
                dev_ms[name] = d_k
                flash_times.append({"name": name, "B": b, "S": s_, "H": h, "D": d, "ms": t_k,
                                    "graph_ms": d_k, "plain_ms": t_p, "plain_graph_ms": d_p,
                                    "library_ms": t_l, "library_graph_ms": d_l,
                                    "sdpa_fwd_bwd_ms": lib["fwd_bwd"][0], "bound_ms": bms,
                                    "bound_by": by, "bytes": nbytes, "ops": ops})
                print(f"{name:16s} B={b} S={s_} H={h} D={d}: per call kernel {t_k:.4f} ms plain "
                      f"{fmt(t_p)} ms library {fmt(t_l)} ms | device (graph): kernel {fmt(d_k)} "
                      f"ms plain {fmt(d_p)} ms library {fmt(d_l)} ms | bound {bms:.5f} ms "
                      f"({by}: {nbytes} B, {ops} ops) | kernel/bound {t_k / bms:.1f}x",
                      flush=True)
                if (h, d) == (8, 64) and name in kernels:
                    kernels[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bms,
                                         bound_by=by, graph_ms=d_k)
            fwd_row = next(t for t in flash_times[::-1] if t["name"] == "flash_fwd")
            if None not in (fwd_row["graph_ms"], lib["fwd"][1]):
                kern = "wgmma" if d == 64 else "mma.sync"
                print(f"forward (B, S, H, D) = ({b}, {s_}, {h}, {d}), device time: flash_fwd "
                      f"{fwd_row['graph_ms']:.4f} ms (mma route, the {kern} kernel), "
                      f"{fwd_row['graph_ms'] / lib['fwd'][1]:.2f}x SDPA's forward "
                      f"({lib['fwd'][1]:.4f} ms) and {fwd_row['graph_ms'] / fwd_row['bound_ms']:.1f}x "
                      f"its bound; the simt route {fmt(dev_ms['flash_fwd simt'])} ms", flush=True)
            print(f"   SDPA causal at this shape: forward {lib['fwd'][0]:.4f} ms, forward + "
                  f"backward {lib['fwd_bwd'][0]:.4f} ms per call (library_ms of flash_dq and "
                  f"flash_dkv is SDPA's whole backward, dq, dk and dv together); the quantized "
                  f"kernel has no single PyTorch call for the same function")
            if None not in (dev_ms["flash_dq"], dev_ms["flash_dkv"], bwd[1]):
                pair = {"B": b, "S": s_, "H": h, "D": d, "dq_ms": dev_ms["flash_dq"],
                        "dkv_ms": dev_ms["flash_dkv"],
                        "pair_ms": dev_ms["flash_dq"] + dev_ms["flash_dkv"],
                        "simt_pair_ms": None if None in (dev_ms["flash_dq simt"],
                                                         dev_ms["flash_dkv simt"])
                        else dev_ms["flash_dq simt"] + dev_ms["flash_dkv simt"],
                        "sdpa_bwd_ms": bwd[1]}
                pair["x_sdpa_bwd"] = pair["pair_ms"] / pair["sdpa_bwd_ms"]
                flash_pair.append(pair)
                print(f"backward pair (B, S, H, D) = ({b}, {s_}, {h}, {d}), device time: flash_dq "
                      f"{pair['dq_ms']:.4f} + flash_dkv {pair['dkv_ms']:.4f} = "
                      f"{pair['pair_ms']:.4f} ms (mma route) against SDPA's whole backward "
                      f"{pair['sdpa_bwd_ms']:.4f} ms: {pair['x_sdpa_bwd']:.2f}x; the simt route "
                      f"at this shape {fmt(pair['simt_pair_ms'])} ms", flush=True)
            del q, k, v, do, o, lse, delta, qc, kc, vc, mis
            torch.cuda.empty_cache()

    lm_profile = {}
    with phase("16 where the training time goes"), uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        from distributed_neural_network_tpu_torch.models import transformer as tfm
        from distributed_neural_network_tpu_torch.train import lm as lmtrain

        cfg = tfm.TransformerConfig(vocab_size=32768, d_model=512, n_heads=8, n_layers=8,
                                    d_ff=2048, dtype=torch.bfloat16)
        params = tfm.init_params(0, cfg, dev)
        mom = lmtrain.init_lm_momentum(params)
        step = lmtrain.make_lm_train_step(cfg, device=dev, lr=0.01, attn_impl="flash")
        toks, tgts = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=16,
                                            seq_len=2048, vocab=32768, device=dev)
        for _ in range(2):
            step(params, mom, toks, tgts)
        torch.cuda.synchronize()
        n_steps = 3
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step(params, mom, toks, tgts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = profile_rows(prof, DeviceType)
        busy = sum(r[1] for r in rows) / 1e6
        flash_us = sum(r[1] for r in rows if "flash_" in r[0])
        lm_profile = {"wall_s": wall, "device_busy_s": busy, "steps": n_steps,
                      "idle_share": 1 - busy / wall if busy else None,
                      "flash_share_of_busy": flash_us / 1e6 / busy if busy else None,
                      "top": sorted(rows, key=lambda r: -r[1])[:12]}
        print(f"{n_steps} steady steps at full width (flash, bf16): wall {wall:.3f} s "
              f"({1e3 * wall / n_steps:.1f} ms/step), device busy {busy:.3f} s, idle share "
              f"{'not measured' if not busy else f'{1 - busy / wall:.3f}'}, flash kernels "
              f"{'not measured' if not busy else f'{flash_us / 1e6 / busy:.3f}'} of busy time")
        for key, us, count in lm_profile["top"]:
            print(f"   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
        del params, mom, step
        torch.cuda.empty_cache()

    designs = {"fused_mlp3_fwd": f"cluster of {fh.fwd_cluster(16)} blocks per 16-row tile",
               "fused_mlp3_bwd": f"cluster of {fh.bwd_cluster(16)} blocks per 16-row tile, "
                                 f"W1 split by rows",
               "decode_attention": "split route: the live prefix in up to 8 pieces, one "
                                   "block of a cluster each, rows per lane group by 16-byte "
                                   "loads, merged in order on rank 0",
               "flash_fwd": "wgmma (tensor cores; mma.sync at D 16/32/128)",
               "flash_dq": "mma.sync (tensor cores)", "flash_dkv": "mma.sync (tensor cores)"}
    for name, k in kernels.items():
        k["design"] = designs.get(name, "scalar (no tensor cores)")
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
        json.dump({"card": smi, "env": env, "kernels": table, "times": times,
                   "main_path": main_path,
                   "profile": profile, "serving": serving, "decode_times": decode_times,
                   "serve_profile": serve_profile, "flash_times": flash_times,
                   "flash_pair": flash_pair, "flash_checks": flash_checks,
                   "lm_runs": lm_runs, "lm_checks": lm_checks, "learn": learn,
                   "lm_profile": lm_profile}, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(route_check() if sys.argv[1:] == ["--route-check"] else main())
