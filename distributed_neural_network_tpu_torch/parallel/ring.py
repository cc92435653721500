"""Local attention: the port of `attention` from the JAX package's
`parallel/ring.py`, the plain single-device reference.

The sequence-parallel forms of that module (`ring_attention`,
`ulysses_attention`, `zigzag_ring_attention`) run over a sequence axis of
a device mesh; they come with the parallel layouts and raise here.
"""

from __future__ import annotations

import math

import torch

NEG_BIG = -1e30  # large-negative mask value; avoids -inf NaN propagation
PARALLEL_SLICE = "the parallel-layouts slice of the port (ROADMAP.md Queue 1 item 3)"


def attention(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0,
              scale=None):
    """Plain full attention in the inputs' dtype: q (B, Sq, H, D), k/v (B,
    Sk, H, D) -> (B, Sq, H, D). The offsets are the global positions of row
    0 of q and of k for the causal mask."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _later(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} shards the sequence over a device mesh; it comes "
                                  f"with {PARALLEL_SLICE}")

    fn.__name__ = name
    fn.__doc__ = f"Not ported yet: raises NotImplementedError ({PARALLEL_SLICE})."
    return fn


ring_attention = _later("ring_attention")
ulysses_attention = _later("ulysses_attention")
zigzag_ring_attention = _later("zigzag_ring_attention")
