#!/usr/bin/env python3
"""Device time of the CNN head's backward at several group limits and
register caps, on one GPU, in one process.

    python3 port_probes/head_bwd_groups.py            # from the repo root

Builds variants of `csrc/fused_mlp3.cu` written under the gitignored
`distributed_neural_network_tpu_torch/_build/` (BWD_GROUP_MAX in {16, 32,
64, 128}; `mlp3_bwd_kernel` with no minimum of blocks per SM, or 3, or 4,
which caps its registers), prints each variant's registers, spills,
blocks per SM and clusters at once, and times the backward kernel alone
and with the reduce (chip_smoke.py's `graph_ms`: device time in a CUDA
graph) at (N, B) in {(4, 16), (1, 1024), (1, 4096)}, after holding the
whole backward to its plain version.
"""

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_neural_network_tpu_torch.ops import _nvcc  # noqa: E402
from distributed_neural_network_tpu_torch.ops import fused_head as fh  # noqa: E402


def inputs(n, b, dev, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(n, b, 400)] + [(n, *s) for s in fh.WEIGHT_SHAPES]
    scales = [1.0, 0.05, 1.0, 0.05, 1.0, 0.05, 1.0]
    return [(torch.randn(*s, generator=g) * k).to(dev) for s, k in zip(shapes, scales)]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    src = open(fh.SOURCE).read()
    bounds = "__global__ void __launch_bounds__(BWD_THREADS)\nmlp3_bwd_kernel"
    assert bounds in src and re.search(r"constexpr int BWD_GROUP_MAX = \d+;", src)
    os.makedirs(_nvcc.BUILD_DIR, exist_ok=True)
    for min_blocks in (0, 3, 4):
        for gmax in (16, 32, 64, 128):
            s = re.sub(r"constexpr int BWD_GROUP_MAX = \d+;",
                       f"constexpr int BWD_GROUP_MAX = {gmax};", src)
            if min_blocks:
                s = s.replace(bounds, bounds.replace("(BWD_THREADS)",
                                                     f"(BWD_THREADS, {min_blocks})"))
            path = os.path.join(_nvcc.BUILD_DIR, f"fused_mlp3_b{min_blocks}_g{gmax}.cu")
            with open(path, "w") as f:
                f.write(s)
            fh.SOURCE, fh.BWD_GROUP_MAX = path, gmax
            fh._lib.cache_clear()
            lib = fh.build()
            print(f"min blocks {min_blocks}, group max {gmax}: "
                  f"{cs.ptxas_instances(lib, 'mlp3_bwd')} {fh.bwd_info()}")
            for n, b in ((4, 16), (1, 1024), (1, 4096)):
                x, w1, b1, w2, b2, w3, b3 = args = inputs(n, b, dev, 7)
                _, h1, h2 = fh.mlp3_forward_reference(*args)
                g = torch.randn(n, b, 10, device=dev)
                err = cs.max_err(torch, list(fh.mlp3_backward(g, x, h1, h2, w1, w2, w3)),
                                 list(fh.mlp3_backward_reference(g, x, h1, h2, w1, w2, w3)))
                kernel = cs.graph_ms(torch, lambda: fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3))
                whole = cs.graph_ms(torch, lambda: fh.mlp3_backward(g, x, h1, h2, w1, w2, w3))
                print(f"   (N {n}, B {b}) {fh.bwd_groups(b)} groups: backward {kernel:.5f} ms, "
                      f"with the reduce {whole:.5f} ms, max abs err {err:.3g}")
            os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
