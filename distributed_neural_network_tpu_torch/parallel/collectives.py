"""Collectives over the replica group (counterpart of the JAX package's
`parallel/collectives.py` `masked_pmean_tree` and `weighted_mean_scalar`).
The replicas' values are stacked on a leading axis and reduced there; the
live mask is a device tensor, so nothing here reads the host."""

from __future__ import annotations

import torch


def effective_mask(live: torch.Tensor) -> torch.Tensor:
    """The (n,) live mask, or all ones when every replica is dead."""
    return torch.where((live > 0).any(), live, torch.ones_like(live))


def masked_mean(stacked: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Mean of `stacked` (n, ...) over the replicas whose `live` (n,) entry
    is 1. When every replica is dead it degrades to a plain mean over all of
    them."""
    w = effective_mask(live).to(stacked.dtype).view(-1, *([1] * (stacked.dim() - 1)))
    return (stacked * w).sum(0) / w.sum()


def masked_mean_tree(stacked, live):
    """`masked_mean` of each tensor of a list of stacked tensors."""
    return [masked_mean(t, live) for t in stacked]


def weighted_mean_scalar(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values)/max(sum(weights), 1) - the correctly scaled loss mean."""
    return values.sum() / weights.sum().clamp(min=1.0)
