#!/usr/bin/env python3
"""Phase 9's serving agreement as a function of the engine's schedule, on
one GPU.

    python3 port_probes/int8kv_schedule.py [ROOT]     # ROOT: a checkout (default: this one)
    TICK_MS=2,5 python3 port_probes/int8kv_schedule.py runs/parent

Serves chip_smoke.py phase 9's 24 requests (its prompts, arrivals, server
flags and the max batch of 8) through the bare engine on a virtual clock:
every tick advances the clock by one TICK_MS entry, and a request joins, in
arrival order, at the first tick past its arrival once a slot is free. A
tick length thus gives the schedule of a host whose ticks take that long,
without the timing noise of the HTTP loop. For each tick
length, and for --precision int8-kv on both decode routes and bf16 on the
kernel's, prints the prefill calls, the chunks that start off the chunk
grid (a budget's leftover given to a second prompt) and chip_smoke's
`Oracle.agreement` (per token, strict, zipped); the first tick length runs
twice (the same schedule must give the same streams). Writes the rows to
chiprun_out/int8kv_schedule_<ROOT's name>.json.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_neural_network_tpu_torch.models import transformer as tfm  # noqa: E402
from distributed_neural_network_tpu_torch.ops import decode_attention as da  # noqa: E402
from distributed_neural_network_tpu_torch.serve.engine import Sequence  # noqa: E402
from distributed_neural_network_tpu_torch.serve.http import build_server  # noqa: E402

CHUNK = int(cs.SERVE_ARGS[cs.SERVE_ARGS.index("--prefill-chunk") + 1])
MAX_BATCH = int(cs.SERVE_ARGS[cs.SERVE_ARGS.index("--max-batch") + 1])


def engine(precision, impl):
    srv, sched, eng = build_server(cs.SERVE_ARGS + ["--precision", precision,
                                                    "--decode-impl", impl],
                                   log=lambda line: None)
    sched.close(finalize=False)
    srv.close()
    return eng


def serve(eng, prompts, arrivals, tick_s):
    """The streams, prefill calls and off-grid chunks of one virtual-clock run."""
    seqs = [Sequence(i, p, cs.MAX_NEW) for i, p in enumerate(prompts)]
    starts, run_prefill = [], eng._run_prefill

    def spy(toks, pos0, table, n_valid):
        starts.append(pos0)
        return run_prefill(toks, pos0, table, n_valid)

    eng._run_prefill = spy
    pre0, t, nxt = eng.prefill_calls, 0.0, 0
    try:
        while nxt < len(seqs) or eng.has_work():
            while nxt < len(seqs) and arrivals[nxt] <= t and len(eng.active) < MAX_BATCH:
                eng.add(seqs[nxt])
                nxt += 1
            if eng.has_work():
                eng.step()
            t += tick_s
    finally:
        del eng._run_prefill
    torch.cuda.synchronize()
    return ([list(s.out)[:cs.MAX_NEW] for s in seqs], eng.prefill_calls - pre0,
            sum(p % CHUNK != 0 for p in starts))


def main() -> int:
    if not torch.cuda.is_available():
        print("int8kv_schedule: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    da.build()
    rng = np.random.default_rng(0)  # chip_smoke.py phase 9's prompts and arrivals
    prompts = [rng.integers(0, 256, size=cs.PROMPT_LENS[i % 3]).tolist()
               for i in range(cs.N_REQUESTS)]
    arrivals = np.cumsum(rng.exponential(1.0 / cs.RATE, size=cs.N_REQUESTS)).tolist()
    oracle = cs.Oracle(torch, tfm, prompts, dev)
    ticks = [float(x) for x in os.environ.get("TICK_MS", "1,2,3,4,5,6,8,12,20").split(",")]
    rows = []
    print(f"root {ROOT}", flush=True)
    for precision, impl in (("int8-kv", "torch"), ("int8-kv", "cuda"), ("bf16", "cuda")):
        eng = engine(precision, impl)
        first = None
        for k, tick_ms in enumerate([ticks[0]] + ticks):
            served, pre, off = serve(eng, prompts, arrivals, tick_ms / 1e3)
            strict, agree, zipped = oracle.agreement(served)
            same = None
            if k == 0:
                first = served
            elif k == 1:
                same = served == first
            row = {"precision": precision, "impl": impl, "tick_ms": tick_ms,
                   "prefill_calls": pre, "off_grid_chunks": off, "agreement": agree,
                   "strict": strict, "zipped": zipped, "streams": served}
            rows.append(row)
            print(f"{precision:7s} {impl:5s} tick {tick_ms:5.1f} ms: prefill calls {pre}, "
                  f"off-grid chunks {off}, agreement {agree:.4f} (strict {strict:.4f}, "
                  f"zipped {zipped:.4f})" + ("" if same is None else f"; rerun same {same}"),
                  flush=True)
        del eng
        torch.cuda.empty_cache()
    out = os.path.join(HERE, "chiprun_out", f"int8kv_schedule_{os.path.basename(ROOT)}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
