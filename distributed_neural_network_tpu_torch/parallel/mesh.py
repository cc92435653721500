"""The replica group: the port's counterpart of the JAX package's device mesh.

The JAX package maps its N data-parallel workers onto N devices of a
`jax.sharding.Mesh` and raises when N exceeds the device count. On one GPU
the port runs the N workers as a replica group in one process: each worker
has its own parameters and momentum on the same device, and the collectives
(`parallel/collectives.py`) are means over the group. So `nb_proc` is
bounded by device memory, not by the number of devices. A
`torch.distributed` path across processes is later work.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class ReplicaGroup:
    """N workers sharing one device."""

    size: int
    device: torch.device


def device_count(device: str | torch.device = "cuda") -> int:
    """Devices of the given type this process can see (the CPU counts as 1)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def create_mesh(n_workers: int | None = None,
                device: str | torch.device = "cuda") -> ReplicaGroup:
    """A group of `n_workers` replicas on `device` (default: one per
    visible device of that type)."""
    dev = resolve_device(device)
    n = n_workers if n_workers is not None else device_count(dev)
    if n < 1:
        raise ValueError(f"need >= 1 workers, got {n}")
    return ReplicaGroup(n, dev)
