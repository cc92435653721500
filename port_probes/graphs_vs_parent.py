#!/usr/bin/env python3
"""The LM flash step's and the serving decode tick's wall time, one or
more checkouts of the repo in turns on one GPU, each in its own process.

    git archive <commit> | tar -x -C runs/parent      # a parent to compare
    python3 port_probes/graphs_vs_parent.py runs/parent:parent .:graphed \\
        .:eager .:eager-rng .:eager-rng .:eager .:graphed runs/parent:parent

Each argument is ROOT:MODE, run in the order given. MODE is `parent` (the
checkout as it is, for one whose engine and step have no `_capture` hook),
`graphed` (the default of a checkout that has one), `eager` (`_capture`
false on the LM step and the serving engine) or `eager-rng` (eager, with
the checkpoints stashing the RNG state again). Per run it prints one
`RESULT {json}` line: lm_train's 20 full-width flash steps (chip_smoke.py's
LM_ARGS; ms per step and tokens/s after the first step) and, for bf16 and
int8-kv on the decode kernel route, the serving engine at chip_smoke.py's
width driven directly (warmup, 8 prompts of 64 tokens prefilled, 5 ticks,
then 20 timed decode ticks at batch 8, ending in a synchronize: ms per
tick) with the first tokens of two streams.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str, mode: str) -> None:
    sys.path[:0] = [os.path.abspath(root), HERE]
    import numpy as np
    import torch

    import chip_smoke as cs
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops import decode_attention as da
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.serve.engine import Sequence
    from distributed_neural_network_tpu_torch.serve.http import build_server
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    da.build(), fa.build(), da._lib(), fa._lib()
    if mode.startswith("eager"):
        make = lmtrain.make_lm_train_step

        def eager(*a, **kw):
            step = make(*a, **kw)
            step._capture = False
            return step

        lmtrain.make_lm_train_step = eager
    if mode == "eager-rng":
        import torch.utils.checkpoint as ck

        def with_rng(*a, **kw):
            kw["preserve_rng_state"] = True
            return ck.checkpoint(*a, **kw)

        lmtrain.checkpoint = tfm.checkpoint = with_rng
    lines = []
    lm_train.main(["--device", "cuda", "--steps", "20", "--log-every", "10", "--attn", "flash"]
                  + cs.LM_ARGS, log=lines.append)
    summary = json.loads(next(line for line in lines if line.startswith("SUMMARY "))[8:])
    out = {"root": root, "mode": mode, "lm_ms_per_step": 1e3 * summary["wall_s_post_compile"] / 19,
           "lm_tokens_per_s": summary["tokens_per_s"], "final_loss": summary["final_loss"]}
    args = [a for a in cs.SERVE_ARGS if a != "--warmup"] + ["--decode-impl", "cuda"]
    for precision in ("bf16", "int8-kv"):
        srv, sched, eng = build_server(args + ["--precision", precision], log=lambda line: None)
        sched.close(finalize=False)
        srv.close()
        if mode != "parent":
            eng._capture = mode == "graphed"
        eng.warmup()
        rng = np.random.default_rng(5)
        seqs = [Sequence(i, rng.integers(0, 256, size=64).tolist(), 64) for i in range(8)]
        for s in seqs:
            eng.add(s)
        while any(s.pos < s.prompt_len for s in seqs):
            eng.step()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.step()
        torch.cuda.synchronize()
        out[f"{precision}_ms_per_tick"] = 1e3 * (time.perf_counter() - t0) / 20
        out[f"{precision}_tokens"] = [s.out[:8] for s in seqs[:2]]
        del eng
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(*sys.argv[2].rsplit(":", 1))
        return 0
    rc = 0
    for spec in sys.argv[1:] or [".:graphed"]:
        proc = subprocess.run([sys.executable, __file__, "--one", spec], capture_output=True,
                              text=True, timeout=600)
        print("\n".join(line for line in proc.stdout.splitlines()
                        if line.startswith("RESULT ")) or f"{spec}: exit {proc.returncode}\n"
              + proc.stderr[-2000:], flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
