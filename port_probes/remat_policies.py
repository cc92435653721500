#!/usr/bin/env python3
"""Named remat policies on the single-card graphed flash step
(`chip_smoke.py` phase 27; standalone: ``python3
port_probes/remat_policies.py`` from the repo root).

The JAX bench row lm_flash_d512_L8_seq2048_bf16_hd128_dots_b32's shape
(LM_ARGS with --attn flash --batch-size 32 --n-heads 4: d512/L8, H 4, D
128, seq 2,048, bf16), STEPS steps of `lm_train.main` for each run of RUNS:
--remat with no policy, dots_saveable, dots_with_no_batch_dims_saveable and
nothing_saveable, and no remat at all. Each run's step is one CUDA graph;
the flash counters are set to 0 just before it. Checks: every policy's
losses and final parameters bitwise the no-policy run's (the flash kernels
launch outside the dispatcher, so every policy recomputes them, and they
are bitwise reproducible: phase 12); the run without remat within LOSS_TOL
of it (its gap printed); each run's flash launches the formula (the forward
twice a layer and step under remat) on the mma route, every call at
FLASH_REMAT, a shape phase 12 holds against the plain versions. Prints
each run's peak memory (`torch.cuda.max_memory_allocated`), graphed ms per
step and flash launches a step.
"""

import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "port_probes")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

STEPS = 4
SHAPE = ["--attn", "flash", "--batch-size", "32", "--n-heads", "4"]
# (name, extra arguments): the first is the one the others are held to
RUNS = (
    ("remat", ["--remat"]),
    ("dots_saveable", ["--remat", "--remat-policy", "dots_saveable"]),
    ("dots_with_no_batch_dims_saveable",
     ["--remat", "--remat-policy", "dots_with_no_batch_dims_saveable"]),
    ("nothing_saveable", ["--remat", "--remat-policy", "nothing_saveable"]),
    ("no remat", []),
)


def run_policies(torch, lm_args, *, flash_counts, mma_counts, flash_remat, loss_tol):
    """The runs of RUNS and their checks (AssertionError naming the failing
    one); returns {name: row}."""
    import json

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.ops import flash
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    shapes = set()
    inner = flash.flash_mha

    def seen(q, k, v, **kw):
        shapes.add(tuple(q.shape))
        return inner(q, k, v, **kw)

    out, ref = {}, None
    flash.flash_mha = seen
    try:
        for name, extra in RUNS:
            for counters in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
                for key in counters:
                    counters[key] = 0
            shapes.clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            lines, res = [], {}
            t0 = time.perf_counter()
            lm_train.main(["--device", "cuda", "--steps", str(STEPS), "--log-every", "10"]
                          + list(lm_args) + SHAPE + extra, log=lines.append, result=res)
            torch.cuda.synchronize()
            summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
            leaves = [p.detach().clone() for p in lmtrain.tree_leaves(res["params"])]
            remat = bool(extra)
            want = flash_counts(STEPS, remat=remat)
            counts, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
            assert counts == want, f"{name}: flash launches {counts} != {want}"
            assert routes == mma_counts(want), f"{name}: routes {routes} != {mma_counts(want)}"
            assert sorted(shapes) == [flash_remat], (
                f"{name}: the flash kernels saw {sorted(shapes)}, phase 12 holds {flash_remat}")
            assert res["step"].segments == "graph", f"{name}: segments {res['step'].segments}"
            row = {"losses": res["losses"], "peak_mem_gib": torch.cuda.max_memory_allocated()
                   / 2**30, "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (STEPS - 1),
                   "tokens_per_s": summary["tokens_per_s"], "mfu_pct": summary["mfu_pct"],
                   "launches_per_step": {k: n / STEPS for k, n in counts.items()},
                   "seconds": time.perf_counter() - t0}
            if ref is None:
                ref = (res["losses"], leaves)
            else:
                same = res["losses"] == ref[0] and all(
                    torch.equal(a, b) for a, b in zip(leaves, ref[1]))
                row["bitwise_vs_remat"] = same
                row["max_rel_loss_vs_remat"] = max(abs(a - b) / abs(b)
                                                   for a, b in zip(res["losses"], ref[0]))
                row["max_abs_param_vs_remat"] = max(float((a - b).abs().max())
                                                    for a, b in zip(leaves, ref[1]))
                if remat:
                    assert same, (f"{name}: not bitwise the no-policy run (losses "
                                  f"{res['losses']} vs {ref[0]}, parameters within "
                                  f"{row['max_abs_param_vs_remat']})")
                else:
                    assert row["max_rel_loss_vs_remat"] <= loss_tol, (
                        f"{name}: losses {res['losses']} vs the remat run's {ref[0]}")
            out[name] = row
            del res, leaves
    finally:
        flash.flash_mha = inner
    return out


def main() -> int:
    import json
    import subprocess

    import torch

    from chip_smoke import FLASH_REMAT, LM_ARGS, LOSS_TOL, flash_counts, mma_counts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    try:
        res = run_policies(torch, LM_ARGS, flash_counts=flash_counts, mma_counts=mma_counts,
                           flash_remat=FLASH_REMAT, loss_tol=LOSS_TOL)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    for name, row in res.items():
        print(f"{name}: {json.dumps(row)}")
    print("remat_policies: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
