"""Training and evaluation steps over stacked replicas (counterpart of the
JAX package's `ops/train.py`). The N replicas of the group are one
`ReplicaNetwork` (every parameter stacked on a leading axis), a batch is
(N, B) row indices into the split on the device, and one call of the model
serves every replica.

- `train_step` is one SGD step of every replica: gather, forward, the
  per-replica masked loss, `autograd.grad`, update; `sync=True`
  (`sync_mode="step"`) first takes the gradient mean over the replicas.
  The engine's captured step program runs it once per step of an epoch's
  stacked plan, the JAX `lax.scan` (`train/engine.py`).
- `eval_epoch` keeps the JAX accounting per replica: the sum of per-batch
  mean losses, with batches that hold no valid row left out of the batch
  count, and the correct and valid row counts.
"""

from __future__ import annotations

import torch

from ..data.pipeline import gather_batch
from .losses import masked_correct, masked_cross_entropy
from .sgd import sgd_step


def loss_and_grads(model, x, y, w):
    """(loss, grads in `model.parameters()` order) for one batch; stacked
    replicas give (N,) losses and each replica's gradient in its slice."""
    params = list(model.parameters())
    loss = masked_cross_entropy(model(x), y, w)
    return loss.detach(), torch.autograd.grad(loss.sum(), params)


def sync_grads(grads):
    """Per-step gradient mean over the replica group (`grad_sync="end"`):
    each stacked gradient's mean over its leading axis, for every replica."""
    return [g.mean(0, keepdim=True).expand_as(g) for g in grads]


def train_step(net, mom, images, labels, idx, w, *, lr: float, momentum: float,
               sync: bool = False) -> torch.Tensor:
    """One SGD-momentum step of every replica of `net` on rows `idx` (N, B)
    weighted by `w` (N, B); updates the parameters and `mom` in place and
    returns the (N,) batch losses."""
    x, y = gather_batch(images, labels, idx)
    loss, grads = loss_and_grads(net, x, y, w)
    if sync:
        grads = sync_grads(grads)
    sgd_step(list(net.parameters()), mom, grads, lr, momentum)
    return loss


@torch.no_grad()
def eval_epoch(net, images, labels, row_weights, idx, w) -> torch.Tensor:
    """(4, N) sums over every replica's eval plan `idx`, `w` (N, steps, B):
    loss sum, batch count, correct and valid rows; `row_weights` masks
    padding rows."""
    totals = torch.zeros(4, idx.shape[0], device=images.device)
    for s in range(idx.shape[1]):
        x, y = gather_batch(images, labels, idx[:, s])
        rw = row_weights.index_select(0, idx[:, s].reshape(-1)).view(y.shape) * w[:, s]
        logits = net(x)
        valid = rw.sum(-1)
        has_valid = (valid > 0).float()
        totals += torch.stack([masked_cross_entropy(logits, y, rw) * has_valid, has_valid,
                               masked_correct(logits, y, rw), valid])
    return totals
