"""Training and evaluation epochs (counterpart of the JAX package's
`ops/train.py`). The JAX `lax.scan` over batches is a Python loop here; the
split lives on the device and each batch is a row gather.

- `train_epoch` is one worker's local-SGD epoch (`sync_mode="epoch"`);
  `sync_mode="step"` is driven by the engine, with `sync_grads` taking the
  gradient mean over the replica group each step.
- `eval_epoch` keeps the JAX accounting: the mean of per-batch mean losses,
  with batches that hold no valid row left out of the batch count.
"""

from __future__ import annotations

import torch

from ..data.pipeline import epoch_plan, eval_plan, gather_batch
from .losses import masked_correct, masked_cross_entropy
from .sgd import init_momentum, sgd_step


def make_batch_loss(model):
    """f(x, y, w) -> masked mean cross entropy of `model` on one batch."""

    def batch_loss(x, y, w):
        return masked_cross_entropy(model(x), y, w)

    return batch_loss


def loss_and_grads(model, x, y, w):
    """(loss, grads in `model.parameters()` order) for one batch."""
    params = list(model.parameters())
    loss = make_batch_loss(model)(x, y, w)
    return loss.detach(), torch.autograd.grad(loss, params)


def sync_grads(grads_per_worker):
    """Per-step gradient mean over the replica group (`grad_sync="end"`):
    one mean per parameter over the workers' gradient lists."""
    return [torch.stack(gs).mean(0) for gs in zip(*grads_per_worker)]


def train_epoch(model, mom, images, labels, order, *, batch_size: int,
                lr: float, momentum: float, reset_momentum: bool = True):
    """One local-SGD epoch of `model` over (images, labels) in `order`.

    Updates the model's parameters and `mom` in place and returns
    (mom, loss_sum, n_batches): the sum of per-batch mean losses as a device
    scalar and the batch count.
    """
    params = list(model.parameters())
    if reset_momentum:
        mom = init_momentum(params)
    idx, w = epoch_plan(order, images.shape[0], batch_size, images.device)
    loss_sum = torch.zeros((), device=images.device)
    for s in range(idx.shape[0]):
        x, y = gather_batch(images, labels, idx[s])
        loss, grads = loss_and_grads(model, x, y, w[s])
        sgd_step(params, mom, grads, lr, momentum)
        loss_sum += loss
    return mom, loss_sum, idx.shape[0]


@torch.no_grad()
def eval_epoch(model, images, labels, row_weights, *, batch_size: int):
    """(loss_sum, n_batches, correct, n_valid) device scalars over one
    worker's eval rows; `row_weights` masks padding rows."""
    idx, w = eval_plan(images.shape[0], batch_size, images.device)
    dev = images.device
    loss_sum, n_batches = torch.zeros((), device=dev), torch.zeros((), device=dev)
    correct, n_valid = torch.zeros((), device=dev), torch.zeros((), device=dev)
    for s in range(idx.shape[0]):
        x, y = gather_batch(images, labels, idx[s])
        rw = row_weights.index_select(0, idx[s]) * w[s]
        logits = model(x)
        valid = rw.sum()
        has_valid = (valid > 0).float()
        loss_sum += masked_cross_entropy(logits, y, rw) * has_valid
        n_batches += has_valid
        correct += masked_correct(logits, y, rw)
        n_valid += valid
    return loss_sum, n_batches, correct, n_valid
