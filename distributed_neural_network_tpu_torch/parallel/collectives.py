"""Collectives over the replica group and the data axis (counterpart of the
JAX package's `parallel/collectives.py`: `masked_pmean_tree`,
`weighted_mean_scalar`, and the leaf buckets of the overlapped gradient
sync).

The replicas' values are stacked on a leading axis and reduced there; the
live mask is the group's global (N,) device tensor, so nothing here reads
the host. Across processes each rank holds a contiguous block of the N rows
(`parallel/mesh.py`), and `RowGather` first assembles the whole (N, ...)
stack on every rank; every rank then runs the same reduction over the same
tensor in the same order as one process holding all N would, so the result
is bit for bit the in-process one for any layout. (A ring all-reduce of
masked sums would add each chunk in another order.) It is also the
reference's own pattern: its parent gathers the workers' states, then
averages.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_unflatten
from .mesh import ReplicaGroup

DEFAULT_BUCKET_BYTES = 4 * 2**20


def effective_mask(live: torch.Tensor) -> torch.Tensor:
    """The (n,) live mask, or all ones when every replica is dead."""
    return torch.where((live > 0).any(), live, torch.ones_like(live))


def masked_mean(stacked: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Mean of `stacked` (n, ...) over the replicas whose `live` (n,) entry
    is 1. When every replica is dead it degrades to a plain mean over all of
    them."""
    w = effective_mask(live).to(stacked.dtype).view(-1, *([1] * (stacked.dim() - 1)))
    return (stacked * w).sum(0) / w.sum()


def weighted_mean_scalar(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values)/max(sum(weights), 1) - the correctly scaled loss mean."""
    return values.sum() / weights.sum().clamp(min=1.0)


def pack(tensors, n: int) -> torch.Tensor:
    """Stacked tensors (n, ...) side by side as one (n, P) buffer."""
    return torch.cat([t.reshape(n, -1) for t in tensors], 1)


def unpack(row: torch.Tensor, like) -> list[torch.Tensor]:
    """A (P,) row of `pack`'s columns as one tensor per entry of `like`
    (each shaped as one replica of it)."""
    out, at = [], 0
    for t in like:
        size = t[0].numel()
        out.append(row[at:at + size].view(t.shape[1:]))
        at += size
    return out


class RowGather:
    """The all-gather of the ranks' row blocks into one static (N, *row)
    buffer, `buf`, on every rank: `put` writes this rank's rows, `reduce`
    is the collective.

    It is an `all_reduce` (sum) over a buffer in which each rank wrote only
    its own block and zeros elsewhere: an exact all-gather, since every
    entry is one rank's value plus zeros (x + 0 = x; a -0.0 comes back as
    +0.0, equal in value). gloo has no `all_gather` on CUDA tensors, only
    `broadcast` and `all_reduce`, so this one form serves NCCL and gloo, on
    the card and on the CPU, with no staging through host memory. In one
    process that joined no group `put` writes all N rows and there is no
    collective. `buf` never moves, so the parts can be captured in CUDA
    graphs (the collective too under NCCL, `train/graphs.py`).
    """

    def __init__(self, group: ReplicaGroup, row_shape, dtype=torch.float32):
        self.group = group
        self.buf = torch.zeros(group.size, *row_shape, dtype=dtype, device=group.device)

    def put(self, local: torch.Tensor) -> None:
        g = self.group
        if not g.joined:
            self.buf.copy_(local)
            return
        self.buf.zero_()
        self.buf[g.first:g.first + g.local].copy_(local)

    def reduce(self) -> None:
        dist.all_reduce(self.buf)


# --------------------------------------------------- the data axis's forms
#
# gloo has only `broadcast` and `all_reduce` on CUDA tensors, so the ranks
# that share the one card (gloo) cannot call `reduce_scatter_tensor` or
# `all_gather_into_tensor`. `collective_form` picks, in this one place and by
# the group's backend, between two implementations of each collective, which
# give the same values and never leave the card:
# - "nccl": `reduce_scatter_tensor` and `all_gather_into_tensor`;
# - "gloo": the reduce-scatter as an `all_reduce` of the whole buffer and
#   this rank's slice of it; the all-gather as an `all_reduce` of a
#   zero-filled buffer holding this rank's shard in its place (each entry is
#   one rank's value plus zeros: exact, as `RowGather`).
# A failing collective raises; nothing falls back to the other form.

COLLECTIVE_FORMS = {
    "nccl": "nccl: all_reduce, reduce_scatter_tensor, all_gather_into_tensor",
    "gloo": "gloo: all_reduce (reduce-scatter = all_reduce + own slice; all-gather = "
            "all_reduce of a zero-filled buffer)",
}


def collective_form() -> str:
    """"nccl" or "gloo": which implementation of reduce-scatter and
    all-gather the group's backend takes."""
    return "nccl" if dist.get_backend() == "nccl" else "gloo"


def reduce_scatter(out: torch.Tensor, buf: torch.Tensor, *, rank: int, form: str) -> None:
    """Sum the ranks' (n*S,) `buf` and write this rank's (S,) slice into
    `out` (the gloo form overwrites `buf` with the whole sum)."""
    if form == "nccl":
        dist.reduce_scatter_tensor(out, buf)
    else:
        s = out.numel()
        dist.all_reduce(buf)
        out.copy_(buf[rank * s:(rank + 1) * s])


def all_gather(out: torch.Tensor, shard: torch.Tensor, *, rank: int, form: str) -> None:
    """The ranks' (S,) shards side by side, rank-major, in (n*S,) `out`."""
    if form == "nccl":
        dist.all_gather_into_tensor(out, shard)
    else:
        s = shard.numel()
        out.zero_()
        out[rank * s:(rank + 1) * s].copy_(shard)
        dist.all_reduce(out)


# --------------------------------------------------------- leaf bucketing
#
# The overlapped gradient sync (`ops/schedule.py` accumulate_fwd_bwd_overlap,
# `train/lm.py` grad_sync="overlap", the CNN engine's grad_sync="overlap")
# issues one collective per leaf bucket instead of one over the whole tree.
# The grouping is a deterministic layout, so every rank plans the same
# buckets and the reduce-scatter and the all-gather agree on where each
# element sits.


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


@dataclass(frozen=True)
class BucketLayout:
    """Contiguous runs of a tree's leaves (in `tree_leaves` order), each
    packed into one flat buffer. A bucket never mixes dtypes or group keys
    and closes when its payload cap is reached; a leaf larger than the cap
    has a bucket of its own. A function of (structure, leaf shapes and
    dtypes, cap, keys) alone: the JAX package's `BucketLayout`, with the
    tree's structure kept as a skeleton (`like`)."""

    like: object
    shapes: tuple
    dtypes: tuple
    buckets: tuple  # ((start, end), ...) leaf-index ranges

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def leaf_sizes(self) -> tuple:
        out = []
        for s in self.shapes:
            n = 1
            for d in s:
                n *= d
            out.append(n)
        return tuple(out)

    def bucket_elems(self) -> tuple:
        sizes = self.leaf_sizes()
        return tuple(sum(sizes[lo:hi]) for lo, hi in self.buckets)

    def bucket_bytes(self) -> tuple:
        sizes = self.leaf_sizes()
        return tuple(sum(sizes[i] * _itemsize(self.dtypes[i]) for i in range(lo, hi))
                     for lo, hi in self.buckets)

    def shard_sizes(self, n_shards: int) -> tuple:
        """Each bucket's per-rank shard length, ceil-padded to n."""
        return tuple(-(-e // n_shards) for e in self.bucket_elems())


def plan_buckets(tree, *, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 group_keys=None) -> BucketLayout:
    """The contiguous leaf buckets of `tree` (tensors, or anything with
    ``shape`` and ``dtype``). `group_keys`: optional leaf-aligned list (or
    tree) of hashables; a bucket never spans a key change (e.g. one
    PartitionSpec string per leaf)."""
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    leaves = tree_leaves(tree)
    if group_keys is None:
        keys = [None] * len(leaves)
    else:
        keys = list(group_keys) if isinstance(group_keys, (list, tuple)) else tree_leaves(
            group_keys)
        if len(keys) != len(leaves):
            raise ValueError(f"group_keys has {len(keys)} entries for {len(leaves)} leaves")
    shapes = tuple(tuple(p.shape) for p in leaves)
    dtypes = tuple(_dtype_name(p.dtype) for p in leaves)
    buckets = []
    start, acc = 0, 0
    for i, shape in enumerate(shapes):
        n = 1
        for d in shape:
            n *= d
        nbytes = n * _itemsize(dtypes[i])
        if i > start and (dtypes[i] != dtypes[start] or keys[i] != keys[start]
                          or acc + nbytes > bucket_bytes):
            buckets.append((start, i))
            start, acc = i, 0
        acc += nbytes
    if leaves:
        buckets.append((start, len(leaves)))
    like = tree_unflatten(tree, [0] * len(leaves))
    return BucketLayout(like=like, shapes=shapes, dtypes=dtypes, buckets=tuple(buckets))


def pack_buckets(layout: BucketLayout, tree, *, out=None) -> list:
    """`tree`'s leaves as one flat 1-D buffer per bucket; with `out`, written
    into those buffers (each at least the bucket's length; a longer one
    keeps its tail)."""
    leaves = tree_leaves(tree)
    bufs = []
    for b, (lo, hi) in enumerate(layout.buckets):
        parts = [leaves[i].reshape(-1) for i in range(lo, hi)]
        if out is None:
            bufs.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        else:
            n = sum(p.numel() for p in parts)
            torch.cat(parts, out=out[b][:n])
            bufs.append(out[b])
    return bufs


def unpack_buckets(layout: BucketLayout, bufs):
    """The inverse of `pack_buckets` (views of `bufs`); buffers longer than
    their bucket (ceil-padded reduce-scatter / all-gather round trips) are
    read up to the bucket's length."""
    if len(bufs) != layout.n_buckets:
        raise ValueError(f"got {len(bufs)} buffers for {layout.n_buckets} buckets")
    sizes = layout.leaf_sizes()
    leaves = [None] * len(layout.shapes)
    for (lo, hi), buf in zip(layout.buckets, bufs):
        off = 0
        for i in range(lo, hi):
            leaves[i] = buf[off:off + sizes[i]].view(layout.shapes[i])
            off += sizes[i]
    return tree_unflatten(layout.like, leaves)


def bucketed_psum(tree, layout: BucketLayout, *, mean: bool = False):
    """The sum (or mean) of a tree over the group, one `all_reduce` per
    bucket: elementwise the per-leaf sum."""
    n = dist.get_world_size()
    bufs = [b.clone() for b in pack_buckets(layout, tree)]
    for b in bufs:
        dist.all_reduce(b)
        if mean:
            b.div_(n)
    return unpack_buckets(layout, bufs)


def reduce_scatter_buckets(tree, layout: BucketLayout, *, axis_size: int, rank: int,
                           form: str) -> tuple:
    """Reduce-scatter each bucket over the group: one (S_b,) shard per
    bucket, the bucket ceil-padded to axis_size * S_b (layout order)."""
    out = []
    for buf, s in zip(pack_buckets(layout, tree), layout.shard_sizes(axis_size)):
        full = torch.zeros(s * axis_size, dtype=buf.dtype, device=buf.device)
        full[:buf.numel()].copy_(buf)
        sh = torch.empty(s, dtype=buf.dtype, device=buf.device)
        reduce_scatter(sh, full, rank=rank, form=form)
        out.append(sh)
    return tuple(out)


def all_gather_buckets(shards, layout: BucketLayout, *, axis_size: int, rank: int,
                       form: str):
    """The full tree from `reduce_scatter_buckets` shards."""
    bufs = []
    for sh in shards:
        full = torch.empty(sh.numel() * axis_size, dtype=sh.dtype, device=sh.device)
        all_gather(full, sh, rank=rank, form=form)
        bufs.append(full)
    return unpack_buckets(layout, bufs)


class BucketReducer:
    """The all-reduce form of the overlapped gradient sync over static
    buffers (`ops/schedule.py` `overlap_parts`): ``put`` packs a
    micro-batch's gradients into one buffer per bucket, ``reduce`` sums each
    over the mesh's ranks (one `all_reduce` per bucket), ``accumulate`` adds
    the sums into the accumulator and ``average(k)`` makes it the mean:
    each rank's gradients are of its own mean loss, so the sum over dp
    ranks and k micro-batches is divided by k*dp. ``grads``: the
    accumulator as leaf-shaped views. No finalizing collective."""

    finalize = None

    def __init__(self, layout: BucketLayout, mesh, device):
        self.layout, self.mesh = layout, mesh
        self.bufs = [torch.zeros(e, device=device) for e in layout.bucket_elems()]
        self.acc = [torch.zeros_like(b) for b in self.bufs]
        self.grads = tree_leaves(unpack_buckets(layout, self.acc))

    @torch.no_grad()
    def put(self, grads) -> None:
        pack_buckets(self.layout, grads, out=self.bufs)

    def reduce(self) -> None:
        if self.mesh.joined:
            for b in self.bufs:
                dist.all_reduce(b)

    @torch.no_grad()
    def accumulate(self, first: bool) -> None:
        if first:
            for a, b in zip(self.acc, self.bufs):
                a.copy_(b)
        else:
            torch._foreach_add_(self.acc, self.bufs)

    @torch.no_grad()
    def average(self, k: int) -> None:
        torch._foreach_div_(self.acc, float(k * self.mesh.dp))
