"""Row partitions of a split over workers (counterpart of the JAX package's
`parallel/partition.py` shard helpers): contiguous 1/N shards with the
remainder dropped, or the full split for every worker."""

from __future__ import annotations

import numpy as np


def shard_size(total: int, n_shards: int) -> int:
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    return total // n_shards


def shard_bounds(total: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) row bounds per shard; remainder dropped."""
    p = shard_size(total, n_shards)
    return [(d * p, (d + 1) * p) for d in range(n_shards)]


def shard_rows(total: int, n_shards: int) -> np.ndarray:
    """(n_shards, p) row-index matrix: row d is worker d's contiguous shard."""
    p = shard_size(total, n_shards)
    return np.arange(n_shards * p, dtype=np.int32).reshape(n_shards, p)


def replicated_rows(total: int, n_shards: int) -> np.ndarray:
    """(n_shards, total): every worker sees the full split."""
    return np.broadcast_to(
        np.arange(total, dtype=np.int32), (n_shards, total)
    ).copy()
