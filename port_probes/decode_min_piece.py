#!/usr/bin/env python3
"""Device time of the int8 split decode route at two minimum piece sizes,
on one GPU, in one process.

    python3 port_probes/decode_min_piece.py            # from the repo root

Builds `csrc/decode_attention.cu` as it is (kMinPieceElems 1024) and a
variant written beside it with kMinPieceElems 2048 (the same 2 KB of K
bytes per piece as bf16's 1024 elements; removed after), and times the
int8 split route of each, in the order 1024, 2048, 2048, 1024, with
chip_smoke.py's `graph_ms` (device time in a CUDA graph) at B 8, (H, Dh)
in {(8, 64), (4, 128)}, a 256-row engine slab and prefixes 16-256.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_neural_network_tpu_torch.ops import decode_attention as da  # noqa: E402

LINE = "constexpr int kMinPieceElems = 1024;"


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_min_piece: needs a GPU", file=sys.stderr)
        return 1
    base_src = da.SOURCE
    var_src = os.path.join(os.path.dirname(base_src), "decode_attention_min2048.cu")
    src = open(base_src).read()
    if src.count(LINE) != 1:
        print(f"decode_min_piece: {LINE!r} not found once", file=sys.stderr)
        return 1
    with open(var_src, "w") as f:
        f.write(src.replace(LINE, LINE.replace("1024", "2048")))
    try:
        libs = {"min1024": da._lib()}
        da.SOURCE = var_src
        da._lib.cache_clear()
        libs["min2048"] = da._lib()
    finally:
        da.SOURCE = base_src
        os.remove(var_src)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    b, total = 8, 256
    for h, d in ((8, 64), (4, 128)):
        for prefix in (16, 32, 48, 64, 96, 128, 160, 256):
            q = torch.randn(b, h, d, device=dev, generator=g).to(torch.bfloat16)
            k, v = ((torch.randn(b, total, h, d, device=dev, generator=g) * 40).round()
                    .clamp(-127, 127).to(torch.int8).transpose(1, 2) for _ in "kv")
            ks, vs = ((torch.rand(b, total, h, device=dev, generator=g) * 0.05 + 1e-3)
                      .transpose(1, 2) for _ in "kv")
            pos = torch.full((b,), prefix - 1, dtype=torch.int32, device=dev)
            times = {name: [] for name in libs}
            for name in ("min1024", "min2048", "min2048", "min1024"):
                da._lib = lambda lib=libs[name]: lib
                times[name].append(cs.graph_ms(torch, lambda: da.decode_cache_attention(
                    q, k, v, pos, k_scale=ks, v_scale=vs)))
            print(f"H={h} Dh={d} prefix {prefix:3d}: " + "  ".join(
                f"{name} {', '.join(f'{t:.5f}' for t in ts)} ms" for name, ts in times.items()),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
