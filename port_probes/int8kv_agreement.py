#!/usr/bin/env python3
"""The int8-kv serving run's per-token agreement with the bf16 generate(),
on the split and the simt decode route, on one GPU.

    python3 port_probes/int8kv_agreement.py            # from the repo root
    ROUTES=split,split-eager ONLY_OPEN=1 python3 port_probes/int8kv_agreement.py

Serves chip_smoke.py phase 9's 24 requests (the same prompts, arrivals and
server flags) with --precision int8-kv --decode-impl cuda once per entry of
ROUTES (default split,simt,split,simt,split,simt), the decode route forced
by replacing `decode_route`; an entry ending in "-eager" serves with the
engine run eagerly (its `_capture` hook) rather than from its captured
graphs. Prints chip_smoke's `Oracle.agreement` and the engine's prefill
calls for each. Unless ONLY_OPEN is set it then
serves the same requests with no timing (8 at a time, in order, stepped to
the end) on each route, and prints each route's error against a float64
evaluation of the same function (codes x scales rounded to bf16, exact
softmax) at B 8, H 8, Dh 64 on the engine's transposed layout.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_neural_network_tpu_torch.models import transformer as tfm  # noqa: E402
from distributed_neural_network_tpu_torch.ops import decode_attention as da  # noqa: E402
from distributed_neural_network_tpu_torch.serve.engine import Sequence  # noqa: E402
from distributed_neural_network_tpu_torch.serve.http import build_server  # noqa: E402

ARGS = cs.SERVE_ARGS + ["--precision", "int8-kv", "--decode-impl", "cuda"]
RULE = da.decode_route


def force(route):
    """Send every decode launch to `route` ("split" keeps the rule)."""
    da.decode_route = (lambda *a: "simt") if route == "simt" else RULE


def served_open_loop(prompts, arrivals, eager=False):
    args = [a for a in ARGS if a != "--warmup"] if eager else ARGS
    srv, sched, eng = build_server(args, log=lambda line: None)
    if eager:
        eng._capture = False
        eng.warmup()
    try:
        pre0 = eng.prefill_calls
        results = cs.open_loop(srv.port, prompts, arrivals)
        pre = eng.prefill_calls - pre0
    finally:
        sched.close()
        srv.close()
    return [r.get("tokens", []) for r in results], pre


def served_offline(prompts):
    srv, sched, eng = build_server(ARGS, log=lambda line: None)
    sched.close(finalize=False)
    srv.close()
    seqs = [Sequence(i, p, cs.MAX_NEW) for i, p in enumerate(prompts)]
    pending = list(seqs)
    while pending or eng.has_work():
        while pending and len(eng.active) < 8:
            eng.add(pending.pop(0))
        eng.step()
    return [list(s.out)[:cs.MAX_NEW] for s in seqs]


def float64_errors(dev):
    g = torch.Generator(dev).manual_seed(3)
    b, h, d, total = 8, 8, 64, 256
    for prefix in (20, 64, 100, 150):
        q = torch.randn(b, h, d, device=dev, generator=g).to(torch.bfloat16)
        k, v = ((torch.randn(b, total, h, d, device=dev, generator=g) * 40).round()
                .clamp(-127, 127).to(torch.int8).transpose(1, 2) for _ in "kv")
        ks, vs = ((torch.rand(b, total, h, device=dev, generator=g) * 0.05 + 1e-3)
                  .transpose(1, 2) for _ in "kv")
        pos = torch.full((b,), prefix - 1, device=dev, dtype=torch.int32)
        kd = (k.float() * ks[..., None]).to(torch.bfloat16).double()
        vd = (v.float() * vs[..., None]).to(torch.bfloat16).double()
        s = torch.einsum("bhd,bhtd->bht", q.double(), kd) / d ** 0.5
        s[..., prefix:] = -1e300
        ref = torch.einsum("bht,bhtd->bhd", torch.softmax(s, -1), vd)
        outs = {}
        for route in ("split", "simt"):
            force(route)
            outs[route] = da.decode_cache_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
        force("split")
        outs["plain"] = da.decode_attention_plain(q, k, v, pos, k_scale=ks, v_scale=vs)
        for name, o in outs.items():
            e = (o.double() - ref).abs()
            print(f"prefix {prefix} {name}: max {float(e.max()):.3g} mean {float(e.mean()):.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("int8kv_agreement: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    da.build()
    rng = np.random.default_rng(0)  # chip_smoke.py phase 9's prompts and arrivals
    prompts = [rng.integers(0, 256, size=cs.PROMPT_LENS[i % 3]).tolist()
               for i in range(cs.N_REQUESTS)]
    arrivals = np.cumsum(rng.exponential(1.0 / cs.RATE, size=cs.N_REQUESTS)).tolist()
    oracle = cs.Oracle(torch, tfm, prompts, dev)
    routes = os.environ.get("ROUTES", "split,simt,split,simt,split,simt").split(",")
    for entry in routes:
        route, _, mode = entry.partition("-")
        force(route)
        served, pre = served_open_loop(prompts, arrivals, eager=mode == "eager")
        force("split")
        strict, agree, stream = oracle.agreement(served)
        print(f"open loop {entry}: agree {agree:.4f} strict {strict:.4f} stream {stream:.4f} "
              f"prefill calls {pre}", flush=True)
    if os.environ.get("ONLY_OPEN"):
        return 0
    for route in ("split", "simt"):
        force(route)
        served = served_offline(prompts)
        force("split")
        strict, agree, stream = oracle.agreement(served)
        print(f"offline {route}: agree {agree:.4f} strict {strict:.4f} stream {stream:.4f}",
              flush=True)
    float64_errors(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
