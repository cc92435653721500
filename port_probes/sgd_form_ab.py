#!/usr/bin/env python3
"""The CNN trainer at chip_smoke.py phase 5's full width (4 stacked workers,
B 16, 2 epochs, synthetic CIFAR-10, the head kernels) with `ops/sgd.py`'s
update in its two arithmetic forms, in turns in one process on one GPU:

    python3 port_probes/sgd_form_ab.py [ROUNDS]

`mul-sub` is the port's form, p - (lr*buf) as the JAX package computes it;
`alpha` is p + (-lr)*buf in one operation, the form the update had before.
A first run of each form is discarded (kernel build and cuDNN set-up), then
ROUNDS (default 3) rounds run mul-sub, alpha, alpha, mul-sub. Each run
prints one `RESULT {json}` line: training seconds, images/s, epoch wall
(the CLI's wall over the epochs, capture included) and the training losses.
"""

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from distributed_neural_network_tpu_torch.ops import train as optrain  # noqa: E402
from distributed_neural_network_tpu_torch.train import cli  # noqa: E402

PORT_FORM = optrain.sgd_step


@torch.no_grad()
def alpha_form(params, mom, grads, lr, momentum):
    torch._foreach_mul_(mom, momentum)
    torch._foreach_add_(mom, grads)
    torch._foreach_add_(params, mom, alpha=-lr)


FORMS = {"mul-sub": PORT_FORM, "alpha": alpha_form}
ARGV = ["--regime", "data_parallel", "--nb-proc", "4", "--data", "synthetic",
        "--synthetic-size", "50000", "--epochs", "2", "--batch-size", "16", "--lr", "0.01",
        "--kernels", "cuda", "--log-dir", os.path.join(HERE, "chiprun_out", "log_sgd_ab")]


def run(form: str) -> dict:
    optrain.sgd_step = FORMS[form]
    lines = []
    torch.cuda.synchronize()
    rc = cli.main(ARGV, log=lines.append)
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"cli.main returned {rc}")
    summary = json.loads(next(line for line in lines if line.startswith("SUMMARY "))[8:])
    train_s = float(next(line for line in lines
                         if line.startswith("Time spent on training")).split(":")[1])
    losses = [float(line.split(":")[1]) for line in lines
              if line.startswith("Global Average Training Loss")]
    return {"form": form, "train_s": train_s, "images_per_s": (50_000 // 4) * 4 * 2 / train_s,
            "epoch_wall_s": summary["wall_clock_s"] / 2, "losses": losses}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    for form in FORMS:
        run(form)
    for _ in range(rounds):
        for form in ("mul-sub", "alpha", "alpha", "mul-sub"):
            print("RESULT " + json.dumps(run(form)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
