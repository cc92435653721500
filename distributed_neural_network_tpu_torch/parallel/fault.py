"""Seeded per-epoch worker failures (counterpart of the JAX package's
`parallel/fault.py` `live_mask`, `epoch_key` and `straggler_sleep`).

Each epoch each worker fails independently with probability p; a failed
worker is left out of the epoch's parameter average and rejoins at the next
epoch. The Bernoulli draws come from a `torch.Generator`, so the masks differ
from the JAX package's for the same seed; a caller can inject a mask. Every
rank of a process group draws the same global mask; a straggler sleeps on
the rank that hosts the failed worker, and the other ranks wait for it in
the next collective, as the reference's parent waits for its children.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_FAULT_SALT = 0x5EEDFA17


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of one epoch's fault draws, independent of the shuffle stream."""
    return (((seed ^ _FAULT_SALT) & 0xFFFF_FFFF) << 32) | (epoch & 0xFFFF_FFFF)


def live_mask(seed: int, epoch: int, n_workers: int, failure_probability: float,
              *, mask=None) -> np.ndarray:
    """(n_workers,) float32 {0,1}: 1 = the worker takes part this epoch.

    `mask` (any array of n_workers {0,1} values) is returned as given. p == 0
    is all-live without drawing.
    """
    if mask is not None:
        out = np.asarray(mask, np.float32).reshape(-1)
        if out.shape != (n_workers,) or not np.isin(out, (0.0, 1.0)).all():
            raise ValueError(f"mask must be {n_workers} values in {{0, 1}}, got {mask!r}")
        return out
    if failure_probability <= 0.0:
        return np.ones(n_workers, np.float32)
    g = torch.Generator()
    g.manual_seed(epoch_seed(seed, epoch))
    fail = torch.rand(n_workers, generator=g) < failure_probability
    return (~fail).numpy().astype(np.float32)


def straggler_sleep(mask_host, failure_duration: float, *, workers=None,
                    log=print) -> None:
    """Optional host-side sleep keeping the reference's straggler timing:
    one sleep per epoch in which one of `workers` (global indices; default
    all) failed, and the same fail/wake lines per such worker."""
    if failure_duration <= 0.0:
        return
    workers = range(len(mask_host)) if workers is None else workers
    failed = [d for d in workers if not mask_host[d]]
    if not failed:
        return
    for d in failed:
        log(f"Device {d} failed! Sleeping for {failure_duration} seconds.")
    time.sleep(failure_duration)
    for d in failed:
        log(f"Device {d} woke up!")
