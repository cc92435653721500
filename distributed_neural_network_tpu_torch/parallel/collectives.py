"""Collectives over the replica group (counterpart of the JAX package's
`parallel/collectives.py` `masked_pmean_tree` and `weighted_mean_scalar`).
The workers' values are stacked on a leading axis and reduced there."""

from __future__ import annotations

import numpy as np
import torch


def effective_mask(live) -> torch.Tensor:
    """The host live mask as a float32 tensor, all ones when every worker
    is dead."""
    w = torch.tensor(np.asarray(live, dtype=np.float32))
    return w if bool((w > 0).any()) else torch.ones_like(w)


def masked_mean(stacked: torch.Tensor, live) -> torch.Tensor:
    """Mean of `stacked` (n, ...) over the workers whose host `live` (n,)
    entry is 1. When every worker is dead it degrades to a plain mean over
    all of them."""
    w = effective_mask(live).to(stacked.device, stacked.dtype)
    w = w.view(-1, *([1] * (stacked.dim() - 1)))
    return (stacked * w).sum(0) / w.sum()


def masked_mean_tree(trees, live):
    """`masked_mean` per entry of a list of per-worker parameter lists."""
    return [masked_mean(torch.stack(leaves), live) for leaves in zip(*trees)]


def weighted_mean_scalar(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values)/max(sum(weights), 1) - the correctly scaled loss mean."""
    return values.sum() / weights.sum().clamp(min=1.0)
