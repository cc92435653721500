"""Masked loss and metric ops (counterpart of the JAX package's
`ops/losses.py`): padded rows carry weight 0."""

from __future__ import annotations

import torch.nn.functional as F


def masked_cross_entropy(logits, labels, weights):
    """Weighted-mean softmax cross entropy: sum(w*ce)/max(sum(w),1)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (ce * weights).sum() / weights.sum().clamp(min=1.0)


def masked_correct(logits, labels, weights):
    """Count of correct top-1 predictions among valid (weight=1) rows."""
    return ((logits.argmax(dim=-1) == labels).float() * weights).sum()
