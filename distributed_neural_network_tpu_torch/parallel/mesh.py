"""The replica group: the port's counterpart of the JAX package's device mesh.

The JAX package maps its N data-parallel workers onto N devices of a
`jax.sharding.Mesh` and raises when N exceeds the device count. The port
stacks workers on a leading axis of every parameter and runs them in one
process; across processes (`parallel/distributed.py`) the N workers are
split over the ranks of the torch.distributed group, rank r holding the
contiguous block of global workers ``[r*N/w, (r+1)*N/w)``. `nb_proc` is the
global group size, bounded by device memory, not by the number of devices,
and must divide by the world size. The collectives
(`parallel/collectives.py`) gather the ranks' blocks and reduce over all N.

`ProcessMesh` is the LM's counterpart of the JAX package's (dp, sp, tp)
device mesh (`train/lm.py` `create_lm_mesh`): the ranks of the process
group along its data axis, one rank a data shard, on the rank's device
(`parallel/distributed.py` `rank_device`). Only the data axis has more than
one rank so far; the sequence and tensor axes are 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import joined


@dataclass(frozen=True)
class ReplicaGroup:
    """N workers over `world` ranks; this rank holds `local` of them on
    `device`. `joined`: the ranks form a torch.distributed group (the
    collectives then cross processes, also at world 1)."""

    size: int
    device: torch.device
    rank: int = 0
    world: int = 1
    joined: bool = False

    @property
    def local(self) -> int:
        return self.size // self.world

    @property
    def first(self) -> int:
        """Global index of this rank's first worker."""
        return self.rank * self.local

    @property
    def workers(self) -> range:
        """Global indices of this rank's workers."""
        return range(self.first, self.first + self.local)


DATA_AXIS, SEQ_AXIS, TP_AXIS = "data", "seq", "model"


@dataclass(frozen=True)
class ProcessMesh:
    """`dp` ranks along the data axis (this process alone at dp 1, or the
    ranks of its torch.distributed group), this one `rank` on `device`.
    `shape` reads as the JAX `Mesh.shape`; `form` is the group's
    collective form (`collectives.collective_form`), None when no group."""

    dp: int
    device: torch.device
    rank: int = 0
    joined: bool = False

    @property
    def shape(self) -> dict:
        """Axis name -> ranks; the sequence and tensor axes are 1 so far."""
        return {DATA_AXIS: self.dp, SEQ_AXIS: 1, TP_AXIS: 1}

    @property
    def desc(self) -> str:
        """"single", or the axes above 1 as the JAX CLI writes them ("data2")."""
        return "x".join(f"{k}{v}" for k, v in self.shape.items() if v > 1) or "single"

    @property
    def backend(self) -> str | None:
        return dist.get_backend() if self.joined else None

    @property
    def form(self) -> str | None:
        from .collectives import collective_form

        return collective_form() if self.joined else None


@dataclass(frozen=True)
class NamedSharding:
    """A spec with the mesh it refers to (the JAX `NamedSharding`)."""

    mesh: ProcessMesh
    spec: tuple


def device_count(device: str | torch.device = "cuda") -> int:
    """Devices of the given type this process can see (the CPU counts as 1)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def create_mesh(n_workers: int | None = None,
                device: str | torch.device = "cuda") -> ReplicaGroup:
    """A group of `n_workers` replicas (default: one per visible device of
    the type) over the ranks of the torch.distributed group this process
    joined, or over this process alone."""
    dev = resolve_device(device)
    n = n_workers if n_workers is not None else device_count(dev)
    if n < 1:
        raise ValueError(f"need >= 1 workers, got {n}")
    if not joined():
        return ReplicaGroup(n, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n % world:
        raise ValueError(f"{n} workers cannot split evenly over {world} ranks; make "
                         "--nb-proc a multiple of the world size")
    return ReplicaGroup(n, dev, rank, world, True)
