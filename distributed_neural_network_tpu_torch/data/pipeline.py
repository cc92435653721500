"""Epoch index plans over a split that lives on the device (counterpart of
the JAX package's `data/pipeline.py`).

An epoch is a (steps, batch) int64 tensor of row indices plus a
(steps, batch) float32 weight mask; `stacked_plan` stacks the N replicas'
plans on a leading axis, with each replica's rows offset into the one
tensor that holds them all. The final partial batch is kept, padded
with row 0 and weight 0. The shuffle is a `torch.randperm` from a
`torch.Generator`; the JAX package draws `jax.random.permutation`, so the
two orders differ for the same seed. A caller (a parity test) can pass any
permutation instead.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFF_FFFF


def plan_shape(n_rows: int, batch_size: int) -> tuple[int, int]:
    """(steps, batch) for a split of n_rows - final partial batch kept."""
    if n_rows <= 0:
        raise ValueError(f"n_rows must be positive, got {n_rows}")
    steps = -(-n_rows // batch_size)
    return steps, batch_size


def shuffle_generator(seed: int, epoch: int, worker: int) -> torch.Generator:
    """The port's shuffle stream for one (seed, epoch, worker)."""
    g = torch.Generator()
    g.manual_seed(((seed & _MASK32) << 32) | ((epoch & 0xFFFF) << 16) | (worker & 0xFFFF))
    return g


def epoch_plan(order, n_rows: int, batch_size: int, device=None):
    """Shuffled epoch plan (idx, w).

    `order` is a permutation of range(n_rows) (any int sequence, numpy
    array or tensor) or a `torch.Generator` to draw one from.
    """
    steps, bs = plan_shape(n_rows, batch_size)
    if isinstance(order, torch.Generator):
        order = torch.randperm(n_rows, generator=order)
    if not isinstance(order, torch.Tensor):
        order = torch.from_numpy(np.array(order, dtype=np.int64))
    order = order.to(torch.int64)
    if order.shape != (n_rows,):
        raise ValueError(f"order must have shape ({n_rows},), got {tuple(order.shape)}")
    return _pad_and_reshape(order, n_rows, steps, bs, device)


def eval_plan(n_rows: int, batch_size: int, device=None):
    """Sequential (unshuffled) index plan for evaluation."""
    steps, bs = plan_shape(n_rows, batch_size)
    return _pad_and_reshape(torch.arange(n_rows), n_rows, steps, bs, device)


def _pad_and_reshape(order, n_rows: int, steps: int, bs: int, device):
    pad = steps * bs - n_rows
    idx = torch.cat([order.to(torch.int64), torch.zeros(pad, dtype=torch.int64)])
    w = torch.cat([torch.ones(n_rows), torch.zeros(pad)])
    return idx.view(steps, bs).to(device), w.view(steps, bs).to(device)


def stacked_plan(orders, n_rows: int, batch_size: int, offsets=None, device=None):
    """(idx, w), each (N, steps, batch): replica d's plan from `orders[d]`
    (as `epoch_plan` takes it), its row indices moved by `offsets[d]` into
    the one tensor that holds every replica's rows (a data_parallel shard's
    first row; 0 for replicas that share the full split). Padding rows point
    at the replica's own row 0 with weight 0."""
    plans = [epoch_plan(o, n_rows, batch_size) for o in orders]
    idx = torch.stack([i for i, _ in plans])
    if offsets is not None:
        idx = idx + torch.as_tensor(offsets, dtype=torch.int64).view(-1, 1, 1)
    return idx.to(device), torch.stack([w for _, w in plans]).to(device)


def gather_batch(images: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor):
    """One batch by row gather on the device; `idx` of any shape gives
    images (*idx.shape, ...) and labels idx.shape."""
    flat = idx.reshape(-1)
    return (images.index_select(0, flat).view(*idx.shape, *images.shape[1:]),
            labels.index_select(0, flat).view(idx.shape))
