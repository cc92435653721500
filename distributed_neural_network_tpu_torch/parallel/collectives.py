"""Collectives over the replica group (counterpart of the JAX package's
`parallel/collectives.py` `masked_pmean_tree` and `weighted_mean_scalar`).

The replicas' values are stacked on a leading axis and reduced there; the
live mask is the group's global (N,) device tensor, so nothing here reads
the host. Across processes each rank holds a contiguous block of the N rows
(`parallel/mesh.py`), and `RowGather` first assembles the whole (N, ...)
stack on every rank; every rank then runs the same reduction over the same
tensor in the same order as one process holding all N would, so the result
is bit for bit the in-process one for any layout. (A ring all-reduce of
masked sums would add each chunk in another order.) It is also the
reference's own pattern: its parent gathers the workers' states, then
averages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import ReplicaGroup


def effective_mask(live: torch.Tensor) -> torch.Tensor:
    """The (n,) live mask, or all ones when every replica is dead."""
    return torch.where((live > 0).any(), live, torch.ones_like(live))


def masked_mean(stacked: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Mean of `stacked` (n, ...) over the replicas whose `live` (n,) entry
    is 1. When every replica is dead it degrades to a plain mean over all of
    them."""
    w = effective_mask(live).to(stacked.dtype).view(-1, *([1] * (stacked.dim() - 1)))
    return (stacked * w).sum(0) / w.sum()


def weighted_mean_scalar(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values)/max(sum(weights), 1) - the correctly scaled loss mean."""
    return values.sum() / weights.sum().clamp(min=1.0)


def pack(tensors, n: int) -> torch.Tensor:
    """Stacked tensors (n, ...) side by side as one (n, P) buffer."""
    return torch.cat([t.reshape(n, -1) for t in tensors], 1)


def unpack(row: torch.Tensor, like) -> list[torch.Tensor]:
    """A (P,) row of `pack`'s columns as one tensor per entry of `like`
    (each shaped as one replica of it)."""
    out, at = [], 0
    for t in like:
        size = t[0].numel()
        out.append(row[at:at + size].view(t.shape[1:]))
        at += size
    return out


class RowGather:
    """The all-gather of the ranks' row blocks into one static (N, *row)
    buffer, `buf`, on every rank: `put` writes this rank's rows, `reduce`
    is the collective.

    It is an `all_reduce` (sum) over a buffer in which each rank wrote only
    its own block and zeros elsewhere: an exact all-gather, since every
    entry is one rank's value plus zeros (x + 0 = x; a -0.0 comes back as
    +0.0, equal in value). gloo has no `all_gather` on CUDA tensors, only
    `broadcast` and `all_reduce`, so this one form serves NCCL and gloo, on
    the card and on the CPU, with no staging through host memory. In one
    process that joined no group `put` writes all N rows and there is no
    collective. `buf` never moves, so the parts can be captured in CUDA
    graphs (the collective too under NCCL, `train/graphs.py`).
    """

    def __init__(self, group: ReplicaGroup, row_shape, dtype=torch.float32):
        self.group = group
        self.buf = torch.zeros(group.size, *row_shape, dtype=dtype, device=group.device)

    def put(self, local: torch.Tensor) -> None:
        g = self.group
        if not g.joined:
            self.buf.copy_(local)
            return
        self.buf.zero_()
        self.buf[g.first:g.first + g.local].copy_(local)

    def reduce(self) -> None:
        dist.all_reduce(self.buf)
