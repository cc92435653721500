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
device mesh (`train/lm.py` `create_lm_mesh`) and of its (dp, pp, tp)
pipeline mesh (`parallel/pipeline.py` `create_pp_mesh`): the ranks of the
process group laid out as JAX reshapes its devices, (dp, sp, tp) or (dp,
pp, tp) with the model axis fastest, so rank = (d*sp + s)*tp + t, or
(d*pp + p)*tp + t, each on its device (`parallel/distributed.py`
`rank_device`); sp and pp are never both above 1. `Axis` is one axis as a
rank sees it: its size, the rank's index along it and the
torch.distributed group of the ranks that differ from this one only along
it (the JAX axis name's collective scope). The sync axis is the (data,
seq) pair that the gradients and the loss are summed over (JAX
`sync_axes`; the data axis alone on a pipeline mesh); "data_pipe" is the
(data, pipe) pair over which the leaves replicated over the pipe axis
(embed, head, the final norm) sum their gradients.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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


DATA_AXIS, SEQ_AXIS, PIPE_AXIS, TP_AXIS = "data", "seq", "pipe", "model"
SYNC_AXES = (DATA_AXIS, SEQ_AXIS)


@dataclass(frozen=True)
class Axis:
    """One axis of a `ProcessMesh` as this rank sees it: `size` ranks,
    this one at `index`, and `group`, the torch.distributed group of the
    ranks along it (None at size 1: no collective). `form` is the group's
    collective form (`collectives.collective_form`)."""

    name: str
    size: int = 1
    index: int = 0
    group: object = None

    @property
    def form(self) -> str | None:
        from .collectives import collective_form

        return collective_form(self.group) if self.group is not None else None


# the default group the cached axis groups were made in, and (dp, sp, pp,
# tp) -> those groups: a layout's groups are made once per process group
_MADE = {"world": None}


def _rank_at(sp: int, pp: int, tp: int):
    """(d, s, p, t) -> rank: the model axis fastest, then pipe, seq, data."""
    return lambda d, s, p, t: ((d * sp + s) * pp + p) * tp + t


def make_axis_groups(dp: int, sp: int, tp: int, rank: int, pp: int = 1) -> dict:
    """Axis name (and "sync", the (data, seq) pair, and "data_pipe", the
    (data, pipe) pair) -> this rank's group along it (None for an axis of
    one rank). Every rank of the world calls `dist.new_group` once for
    every distinct slice of more than one rank, in one fixed order,
    including the slices it is not in (torch.distributed requires it); axes
    over the same ranks share the group (at sp 1 the sync slices are the
    data slices, at pp 1 the data_pipe slices too). A slice that is the
    whole world is the default group. Made once per process group and
    layout."""
    if sp > 1 and pp > 1:
        raise ValueError(f"a mesh has a sequence or a pipeline axis, not both (sp {sp}, pp {pp})")
    if _MADE["world"] is not dist.group.WORLD:
        _MADE.clear()
        _MADE["world"] = dist.group.WORLD
    if (dp, sp, pp, tp) in _MADE:
        return _MADE[dp, sp, pp, tp]
    at = _rank_at(sp, pp, tp)
    every = [(d, s, p, t) for d in range(dp) for s in range(sp) for p in range(pp)
             for t in range(tp)]

    def slices(free):
        """The rank lists of the ranks that differ only in the `free`
        coordinates (indices into (d, s, p, t)), in a fixed order."""
        out = {}
        for c in every:
            key = tuple(x for i, x in enumerate(c) if i not in free)
            out.setdefault(key, []).append(at(*c))
        return list(out.values())

    named = {DATA_AXIS: slices((0,)), SEQ_AXIS: slices((1,)), TP_AXIS: slices((3,)),
             "sync": slices((0, 1)), PIPE_AXIS: slices((2,)), "data_pipe": slices((0, 2))}
    world = dp * sp * pp * tp
    made, out = {}, {}
    for name, rank_lists in named.items():
        out[name] = None
        for ranks in rank_lists:
            if len(ranks) == 1:
                continue
            key = tuple(ranks)
            if key not in made:
                made[key] = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                out[name] = made[key]
    _MADE[dp, sp, pp, tp] = out
    return out


@dataclass(frozen=True)
class ProcessMesh:
    """dp x sp x tp, or dp x pp x tp, ranks (this process alone at 1 x 1 x
    1, or the ranks of its torch.distributed group), this one `rank` on
    `device`. `shape` reads as the JAX `Mesh.shape`; `groups` holds this
    rank's group per axis (`make_axis_groups`); `form` is the default
    group's collective form, None when no group."""

    dp: int
    device: torch.device
    rank: int = 0
    joined: bool = False
    sp: int = 1
    tp: int = 1
    groups: dict = field(default_factory=dict, compare=False, repr=False)
    pp: int = 1

    def __post_init__(self):
        if self.sp > 1 and self.pp > 1:
            raise ValueError(f"a mesh has a sequence or a pipeline axis, not both (sp {self.sp}, "
                             f"pp {self.pp})")

    @property
    def shape(self) -> dict:
        """Axis name -> ranks, in the JAX mesh's order: (data, seq, model),
        or (data, pipe, model) on a pipeline mesh."""
        if self.pp > 1:
            return {DATA_AXIS: self.dp, PIPE_AXIS: self.pp, TP_AXIS: self.tp}
        return {DATA_AXIS: self.dp, SEQ_AXIS: self.sp, TP_AXIS: self.tp}

    @property
    def world(self) -> int:
        return self.dp * self.sp * self.pp * self.tp

    @property
    def coords(self) -> tuple[int, int, int]:
        """This rank's indices in `shape`'s order: (data, seq, model), or
        (data, pipe, model) on a pipeline mesh (the model axis fastest)."""
        r, mid, tp = self.rank, self.sp * self.pp, self.tp
        return r // (mid * tp), r // tp % mid, r % tp

    def axis(self, name: str) -> Axis:
        """`DATA_AXIS`, `SEQ_AXIS`, `PIPE_AXIS`, `TP_AXIS`, "sync" (the
        (data, seq) pair) or "data_pipe" (the (data, pipe) pair) as this rank
        sees it."""
        d, m, t = self.coords
        s, p = (m, 0) if self.pp == 1 else (0, m)
        size, index = {DATA_AXIS: (self.dp, d), SEQ_AXIS: (self.sp, s),
                       PIPE_AXIS: (self.pp, p), TP_AXIS: (self.tp, t),
                       "sync": (self.dp * self.sp, d * self.sp + s),
                       "data_pipe": (self.dp * self.pp, d * self.pp + p)}[name]
        return Axis(name, size, index, self.groups.get(name))

    @property
    def data(self) -> Axis:
        return self.axis(DATA_AXIS)

    @property
    def seq(self) -> Axis:
        return self.axis(SEQ_AXIS)

    @property
    def pipe(self) -> Axis:
        return self.axis(PIPE_AXIS)

    @property
    def model(self) -> Axis:
        return self.axis(TP_AXIS)

    @property
    def sync(self) -> Axis:
        return self.axis("sync")

    @property
    def data_pipe(self) -> Axis:
        return self.axis("data_pipe")

    @property
    def seq_axis(self) -> Axis | None:
        """The sequence axis when it has more than one rank (JAX `sp`)."""
        return self.seq if self.sp > 1 else None

    @property
    def tp_axis(self) -> Axis | None:
        """The model axis when it has more than one rank (JAX `tp`)."""
        return self.model if self.tp > 1 else None

    @property
    def desc(self) -> str:
        """"single", or the axes above 1 as the JAX CLI writes them
        ("data2xmodel2", "data2xpipe2")."""
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
