#!/usr/bin/env python3
"""How far two attention implementations move a mixture-of-experts model's
step-0 gradients when nothing pins the routing.

    python3 port_probes/moe_route_noise.py     # from the repo root, one card

At chip_smoke.py's flagship width (LM_SHAPE: d512/L8/H8, d_ff 2048, vocab
32,768, seq 2,048, batch 16) with 8 experts (top-2, capacity factor 2.0),
the seeded init and the copy-task batch of phase 13's gradient check, in
bf16 and in f32: the loss and the gradient of every weight through the
plain attention (`--attn ring` at sp 1), the flash kernels and SDPA
(`scaled_dot_product_attention`, swapped in for the kernels), each pair's
worst relative L2 errors (each layer of a stacked leaf on its own), and the
share of each layer's tokens whose top-2 experts differ between the pair.
Also the quantiles of the top-2 / top-3 probability gap in layer 6. This is
why chip_smoke.py phase 28 holds the kernel route's gradients to the plain
route's with the routing pinned (`pinned_routing`): unpinned, SDPA differs
from the plain route as much as the kernels do.

Prints the card's name and power limit first.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as C
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops import flash as fl
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.parallel import moe
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    print(C.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]),
          flush=True)
    fa.build()
    dev, sh = torch.device("cuda"), C.LM_SHAPE
    toks, tgts = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=sh["batch_size"],
                                        seq_len=sh["seq_len"], vocab=sh["vocab"], device=dev)
    own, sort_route, seen = fl.flash_mha, moe.sort_route, []

    def sdpa(q, k, v, causal=True, quant=None):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=causal).transpose(1, 2)

    def recorded(probs, top_k, capacity):
        out = sort_route(probs, top_k, capacity)
        chosen = out[0].detach().view(top_k, -1).T.sort(-1).values
        seen.append((chosen, probs.detach().topk(top_k + 1, dim=-1).values))
        return out

    def run(dtype, attn, use_sdpa=False):
        cfg = tfm.TransformerConfig(vocab_size=sh["vocab"], d_model=sh["d_model"],
                                    n_heads=sh["n_heads"], n_layers=sh["n_layers"],
                                    d_ff=sh["d_ff"], dtype=dtype, n_experts=8)
        params = tfm.init_params(0, cfg, dev)
        leaves = lmtrain.tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        fl.flash_mha, moe.sort_route = (sdpa if use_sdpa else own), recorded
        seen.clear()
        try:
            loss = lmtrain.lm_loss(params, toks, tgts, cfg, attn_impl=attn)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            fl.flash_mha, moe.sort_route = own, sort_route
        return float(loss.detach()), C.named_grads(params, grads), list(seen)

    def compare(a, b, name):
        errs = {k: float((a[1][k] - b[1][k]).norm() / b[1][k].norm().clamp_min(1e-30))
                for k in b[1]}
        top = sorted(errs.items(), key=lambda kv: -kv[1])
        flips = [float((x[0] != y[0]).any(-1).float().mean()) for x, y in zip(a[2], b[2])]
        worst = [(k, round(v, 5)) for k, v in top[:6]]
        print(f"   {name}: loss {a[0]:.6f} vs {b[0]:.6f}; worst {worst}; worst not the router "
              f"{[(k, round(v, 5)) for k, v in top if not k.startswith('layers.wr')][:3]}; "
              f"tokens routed otherwise per layer {[round(f, 5) for f in flips]}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        plain, flash, lib = run(dtype, "ring"), run(dtype, "flash"), run(dtype, "flash", True)
        print(f"== {dtype}")
        compare(flash, plain, "flash vs plain")
        compare(lib, plain, "sdpa vs plain")
        compare(flash, lib, "flash vs sdpa")
        top = plain[2][6][1]
        gap = top[:, 1] - top[:, 2]
        print(f"   layer 6: top-2 / top-3 probability gap quantiles (0.001, 0.01, 0.1, 0.5) "
              f"{[float(gap.quantile(q)) for q in (0.001, 0.01, 0.1, 0.5)]}", flush=True)
        del plain, flash, lib
        torch.cuda.empty_cache()
    print("moe_route_noise: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
