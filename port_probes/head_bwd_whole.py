#!/usr/bin/env python3
"""Device time of the CNN head's whole backward (the backward kernel, then
the reduce) at one replica of 4,096 rows, for the head of one or more
checkouts of the repo, each in its own process on one GPU.

    python3 port_probes/head_bwd_whole.py [ROOT ...]    # from the repo root

Each ROOT is a checkout (default: this one), run in the order given, so
`OLD . . OLD` interleaves two versions on the same card. A head whose
kernels take no replica axis gets one replica's tensors unstacked. Per
checkout it holds the whole backward to its plain version, then prints the
backward kernel alone, the whole backward and the reduce's share (their
difference), each the device time of one call in a CUDA graph
(chip_smoke.py's `graph_ms`, this checkout's), and the bytes of partial
rows that the kernel writes and the reduce reads back.
"""

import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096


def measure(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    stacked = hasattr(fh, "bwd_groups")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    shapes = [(B, 400), (400, 120), (120,), (120, 84), (84,), (84, 10), (10,)]
    scales = [1.0, 0.05, 1.0, 0.05, 1.0, 0.05, 1.0]
    args = [(torch.randn(1, *s, generator=gen) * k).to(dev) for s, k in zip(shapes, scales)]
    g = torch.randn(1, B, 10, generator=gen).to(dev)
    if not stacked:
        args, g = [a[0] for a in args], g[0]
    x, w1, b1, w2, b2, w3, b3 = args
    _, h1, h2 = fh.mlp3_forward_reference(*args)
    bwd = (g, x, h1, h2, w1, w2, w3)
    err = cs.max_err(torch, list(fh.mlp3_backward(*bwd)), list(fh.mlp3_backward_reference(*bwd)))
    cs.check(err < 1e-3, f"{root}: the whole backward is off its plain version by {err}")
    rows = fh.mlp3_bwd_partials(*bwd)[1].shape[-2]
    kernel = cs.graph_ms(torch, lambda: fh.mlp3_bwd_partials(*bwd))
    whole = cs.graph_ms(torch, lambda: fh.mlp3_backward(*bwd))
    print(f"{root} ({'replica axis' if stacked else 'no replica axis'}) B {B}: backward "
          f"kernel {kernel:.5f} ms, whole backward {whole:.5f} ms, the reduce's share "
          f"{whole - kernel:.5f} ms; {rows} partial rows, {rows * fh.GRAD_SIZE * 4} B; "
          f"max abs err {err:.3g}", flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return measure(argv[1])
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rc = 0
    for root in argv or ["."]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
