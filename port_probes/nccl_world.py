#!/usr/bin/env python3
"""The CNN trainer over NCCL with one card per rank, against one process
holding every worker, on the same machine.

    python3 port_probes/nccl_world.py [WORLD]     # from the repo root; default 4

Needs WORLD cards. Runs tests/torch_rank_worker.py as WORLD ranks (each rank
on its own card, so `parallel/distributed.py` picks NCCL) and as one process
that joins no group, on chip_smoke.py phase 4's run (4 workers, 512 rows,
2 epochs, --kernels cuda) and at full width (50,000 / 10,000 rows): every
rank's history equal, the one-process run's history and parameters beside
them (largest differences printed), the gathered sync bitwise the
in-process one, every program one CUDA graph (the all-reduce captured);
then each epoch's wall time and the train rows per second of the second
epoch, WORLD ranks against one process; first the cards' names and power
limits. Exits 1 if a check fails.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from torch_rank_worker import launch  # noqa: E402

SMALL = {"lr": 0.01, "momentum": 0.9, "batch_size": 16, "epochs": 2, "nb_proc": 4,
         "regime": "data_parallel", "kernels": "cuda", "seed": 0}
RUNS = [{"name": "small", "config": SMALL, "train": {"size": 512, "seed": 3},
         "test": {"size": 128, "seed": 3}},
        {"name": "full", "config": SMALL, "train": {"size": 50_000, "seed": 0},
         "test": {"size": 10_000, "seed": 0}}]


def main(world: int) -> int:
    import subprocess

    import numpy as np

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out = os.path.join(ROOT, "chiprun_out", f"nccl_world{world}")
    os.makedirs(out, exist_ok=True)
    results = {}
    for label, w, joined, sync in (("ranks", world, True, {"n": 4, "p": 62_007, "seed": 0}),
                                   ("one", 1, False, None)):
        d = os.path.join(out, label)
        os.makedirs(d, exist_ok=True)
        procs = launch(w, {"device": "cuda", "out": d, "sync": sync, "runs": RUNS},
                       timeout=240, joined=joined)
        for r, p in enumerate(procs):
            if p.returncode:
                print(f"{label} rank {r} exited {p.returncode}:\n{p.stderr[-3000:]}")
                return 1
        results[label] = d
    ok = True
    for r in range(world):
        with open(os.path.join(results["ranks"], f"sync_rank{r}.json")) as f:
            sync = json.load(f)
        ok &= sync["bitwise"] == [True] * 5
    print(f"gathered sync over {world} NCCL ranks bitwise the in-process one: {ok}")
    for run in RUNS:
        name = run["name"]

        def load(d, r):
            with open(os.path.join(d, f"{name}_rank{r}.json")) as f:
                info = json.load(f)
            return info, dict(np.load(os.path.join(d, f"{name}_rank{r}.npz")))

        one, one_p = load(results["one"], 0)
        ranks = [load(results["ranks"], r) for r in range(world)]
        same = all(info["history"] == ranks[0][0]["history"] for info, _ in ranks)
        graphs = all(info["backend"] == "nccl" and info["segments"] == [1, 1, 1, 1]
                     for info, _ in ranks)
        d_loss = max(abs(a["train_loss"] - b["train_loss"])
                     for a, b in zip(ranks[0][0]["history"], one["history"]))
        d_par = max(float(np.abs(ranks[0][1][k] - one_p[k]).max()) for k in one_p)
        rows = 50_000 // 4 * 4 if name == "full" else 512
        print(f"{name}: ranks' histories equal {same}; every program one graph over NCCL "
              f"{graphs}; against one process: loss {d_loss:.3e}, params {d_par:.3e}; epoch "
              f"wall s, {world} ranks {[round(t, 4) for t in ranks[0][0]['epoch_s']]} (rank 0), "
              f"one process {[round(t, 4) for t in one['epoch_s']]}; second epoch "
              f"{rows / max(i['epoch_s'][1] for i, _ in ranks):.1f} against "
              f"{rows / one['epoch_s'][1]:.1f} train rows/s")
        ok &= same and graphs and d_loss < 5e-4
    print("nccl_world: ok" if ok else "nccl_world: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if sys.argv[1:] else 4))
