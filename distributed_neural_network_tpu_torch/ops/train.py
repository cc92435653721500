"""Training and evaluation steps over stacked replicas (counterpart of the
JAX package's `ops/train.py`). The N replicas of a rank are one
`ReplicaNetwork` (every parameter stacked on a leading axis), a batch is
(N, B, 32, 32, 3) images with (N, B) labels and weights, and one call of the
model serves every replica.

- `train_step` is one SGD step of every replica: forward, the per-replica
  masked loss, `autograd.grad`, update. The engine's captured step program
  runs it once per step of an epoch, the JAX `lax.scan`
  (`train/engine.py`), on rows it gathers from the split on the device or
  on a batch streamed from the host.
- `sync_mode="step"` splits the step around the gradient collective
  (`GradSync`, the port of the JAX `sync_grads`): `grad_step` writes every replica's
  gradients as packed rows into the group's gather buffers
  (`parallel/collectives.py` `RowGather`), one buffer for all leaves
  (``grad_sync="end"``) or one per size-capped leaf bucket
  (``"overlap"``, `plan_buckets`), each gathered by its own collective; and
  `apply_mean_grads` takes the mean over all N gathered rows, the JAX
  `pmean` of the gradients, and updates every replica with it. The mean
  adds the rows one after another, elementwise, so a column's bits do not
  depend on the buffer it sits in: bucketing repartitions the same mean,
  and the overlap run is bitwise the end run.
- `eval_epoch` keeps the JAX accounting per replica: the sum of per-batch
  mean losses, with batches that hold no valid row left out of the batch
  count, and the correct and valid row counts.

The model computes in its own `compute_dtype` and returns f32 logits, so
the loss and the gradients of the f32 parameters are f32 at bf16 too: the
steps need no cast of their own.
"""

from __future__ import annotations

import torch

from ..data.pipeline import gather_batch
from ..parallel.collectives import DEFAULT_BUCKET_BYTES, RowGather, pack, plan_buckets, unpack
from .losses import masked_correct, masked_cross_entropy
from .sgd import sgd_step


def loss_and_grads(model, x, y, w):
    """(loss, grads in `model.parameters()` order) for one batch; stacked
    replicas give (N,) losses and each replica's gradient in its slice."""
    params = list(model.parameters())
    loss = masked_cross_entropy(model(x), y, w)
    return loss.detach(), torch.autograd.grad(loss.sum(), params)


def train_step(net, mom, x, y, w, *, lr: float, momentum: float) -> torch.Tensor:
    """One SGD-momentum step of every replica of `net` on the batch `x`
    (N, B, 32, 32, 3), labels `y` and weights `w` (N, B); updates the
    parameters and `mom` in place and returns the (N,) batch losses."""
    loss, grads = loss_and_grads(net, x, y, w)
    sgd_step(list(net.parameters()), mom, grads, lr, momentum)
    return loss


def row_mean(rows: torch.Tensor) -> torch.Tensor:
    """The mean over the leading axis of (N, P) `rows`, added row after row:
    each column's value is the same whatever the other columns are."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc.add_(r)
    return acc.div_(rows.shape[0])


class GradSync:
    """The step's gradient collective over the replica group (the port of
    the JAX `sync_grads`): one `RowGather` of (P,) rows for all leaves
    (``grad_sync="end"``), or one per contiguous leaf bucket of at most
    `bucket_bytes` per replica (``"overlap"``; `plan_buckets` over one
    replica's parameters). ``gathers``: the buffers, each reduced by its own
    collective."""

    def __init__(self, group, params, *, grad_sync: str = "end", bucket_bytes: int | None = None):
        self.params = params
        like = [p[0] for p in params]
        if grad_sync == "overlap":
            cap = bucket_bytes or DEFAULT_BUCKET_BYTES
            self.ranges = list(plan_buckets(like, bucket_bytes=cap).buckets)
        else:
            self.ranges = [(0, len(params))]
        self.gathers = [RowGather(group, (sum(q.numel() for q in like[lo:hi]),))
                        for lo, hi in self.ranges]

    def put(self, grads, n: int) -> None:
        for g, (lo, hi) in zip(self.gathers, self.ranges):
            g.put(pack(grads[lo:hi], n))

    def mean_grads(self) -> list[torch.Tensor]:
        """Every parameter's mean gradient over the N gathered rows."""
        out = []
        for g, (lo, hi) in zip(self.gathers, self.ranges):
            out += unpack(row_mean(g.buf), self.params[lo:hi])
        return out


def grad_step(net, x, y, w, sync: GradSync) -> torch.Tensor:
    """The first half of a `sync_mode="step"` step: every replica's
    gradients packed into its rows of `sync`'s gather buffers; returns the
    (N,) batch losses. The collectives come next."""
    loss, grads = loss_and_grads(net, x, y, w)
    sync.put(grads, net.n)
    return loss


@torch.no_grad()
def apply_mean_grads(net, mom, sync: GradSync, *, lr: float, momentum: float) -> None:
    """The second half: the mean of the gathered gradient rows over the
    whole group, per parameter, and the SGD step of every replica with it."""
    params = list(net.parameters())
    grads = [g.expand_as(p) for g, p in zip(sync.mean_grads(), params)]
    sgd_step(params, mom, grads, lr, momentum)


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
