"""Collectives over the replica group and the axes of the LM's process mesh
(counterpart of the JAX package's `parallel/collectives.py`:
`masked_pmean_tree`, `weighted_mean_scalar`, and the leaf buckets of the
overlapped gradient sync; and of the `jax.lax` collectives that its model
and sequence axes use: `psum`, `ppermute`, `all_to_all`).

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


# ------------------------------------------------------ the mesh's forms
#
# gloo has only `broadcast` and `all_reduce` on CUDA tensors, so the ranks
# that share the one card (gloo) cannot call `reduce_scatter_tensor`,
# `all_gather_into_tensor` or `all_to_all_single`. `collective_form` picks,
# in this one place and by the group's backend, between two implementations
# of each collective, which give the same values and never leave the card:
# - "nccl": `reduce_scatter_tensor`, `all_gather_into_tensor`, and
#   `all_to_all_single` for the all-to-all and for `ppermute` (each rank
#   sends its whole block to its one destination, nothing to the others).
#   `all_to_all_single` is an NCCL collective like `all_reduce` and is
#   captured in the step's CUDA graph as one; point-to-point
#   `batch_isend_irecv` is not used: its work objects are waited on from
#   the host, which a capture cannot record.
# - "gloo": the reduce-scatter as an `all_reduce` of the whole buffer and
#   this rank's slice of it; the all-gather, the all-to-all and `ppermute`
#   as an `all_reduce` of a zero-filled buffer holding this rank's blocks in
#   their places, then this rank's slice (each entry is one rank's value
#   plus zeros: exact, as `RowGather`).
# A failing collective raises; nothing falls back to the other form.

COLLECTIVE_FORMS = {
    "nccl": "nccl: all_reduce, reduce_scatter_tensor, all_gather_into_tensor, "
            "all_to_all_single (all-to-all and ppermute)",
    "gloo": "gloo: all_reduce (reduce-scatter = all_reduce + own slice; all-gather, "
            "all-to-all and ppermute = all_reduce of a zero-filled buffer + own slice)",
}


def collective_form(group=None) -> str:
    """"nccl" or "gloo": which implementation of reduce-scatter,
    all-gather, all-to-all and ppermute the group's backend takes (the
    default group's when `group` is None)."""
    return "nccl" if dist.get_backend(group) == "nccl" else "gloo"


def reduce_scatter(out: torch.Tensor, buf: torch.Tensor, *, rank: int, form: str,
                   group=None) -> None:
    """Sum the ranks' (n*S,) `buf` and write this rank's (S,) slice into
    `out` (the gloo form overwrites `buf` with the whole sum). `rank`:
    this rank's index in `group`."""
    if form == "nccl":
        dist.reduce_scatter_tensor(out, buf, group=group)
    else:
        s = out.numel()
        dist.all_reduce(buf, group=group)
        out.copy_(buf[rank * s:(rank + 1) * s])


def all_gather(out: torch.Tensor, shard: torch.Tensor, *, rank: int, form: str,
               group=None) -> None:
    """The ranks' (S,) shards side by side, rank-major, in (n*S,) `out`."""
    if form == "nccl":
        dist.all_gather_into_tensor(out, shard, group=group)
    else:
        s = shard.numel()
        out.zero_()
        out[rank * s:(rank + 1) * s].copy_(shard)
        dist.all_reduce(out, group=group)


def gather_dim(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The axis's ranks' `x` concatenated along `dim` in rank order (the
    JAX ``all_gather(..., tiled=True)``); not differentiable."""
    if axis is None or axis.group is None:
        return x
    n = axis.size
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty(n * moved.numel(), dtype=x.dtype, device=x.device)
    all_gather(out, moved.reshape(-1), rank=axis.index, form=axis.form, group=axis.group)
    full = out.view(n, *moved.shape)
    return torch.cat(list(full.unbind(0)), 0).movedim(0, dim)


def _exchange(blocks: dict, srcs, axis) -> dict:
    """The block exchange behind `ppermute` and the all-to-all: this rank
    sends ``blocks[d]`` (contiguous tensors of one shape) to rank ``d`` of
    the axis and gets one block from each rank of `srcs`: {source: block}.
    Every rank's destinations and sources agree (a permutation, or every
    rank to every rank)."""
    n, me = axis.size, axis.index
    like = next(iter(blocks.values()))
    if axis.form == "nccl":
        size = like.numel()
        send = torch.cat([blocks[d].reshape(-1) for d in sorted(blocks)])
        recv = torch.empty(len(srcs) * size, dtype=like.dtype, device=like.device)
        dist.all_to_all_single(recv, send, output_split_sizes=[size if j in srcs else 0
                                                               for j in range(n)],
                               input_split_sizes=[size if j in blocks else 0 for j in range(n)],
                               group=axis.group)
        parts = recv.view(len(srcs), *like.shape).unbind(0)
        return dict(zip(sorted(srcs), parts))
    if len(blocks) == 1 and len(srcs) == 1:
        # a permutation: each destination slot has one writer
        buf = torch.zeros(n, *like.shape, dtype=like.dtype, device=like.device)
        (d, b), = blocks.items()
        buf[d].copy_(b)
        dist.all_reduce(buf, group=axis.group)
        return {srcs[0]: buf[me]}
    # [source, destination] slots; this rank fills its source row
    buf = torch.zeros(n, n, *like.shape, dtype=like.dtype, device=like.device)
    for d, b in blocks.items():
        buf[me, d].copy_(b)
    dist.all_reduce(buf, group=axis.group)
    return {j: buf[j, me] for j in srcs}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """`x`, replicated over the model axis, entering a tensor-sharded
    computation: the identity forward, and backward the all-reduce of the
    ranks' partial gradients (what JAX's typed autodiff inserts for an
    invariant input of a varying computation). None or size 1: `x`."""
    if axis is None or axis.group is None:
        return x
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over the model axis of the ranks' partial `x` (the JAX
    ``psum(x, "model")`` after a row-sharded matmul); its gradient is the
    identity."""
    if axis is None or axis.group is None:
        return x
    return _ReduceFromModel.apply(x, axis.group)


def _ppermute_raw(x, perm, axis):
    """`perm` is a full permutation of the axis's ranks (`ppermute` checks)."""
    me = axis.index
    dest = next(d for s, d in perm if s == me)
    src = next(s for s, d in perm if d == me)
    return _exchange({dest: x.contiguous()}, [src], axis)[src].clone()


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, axis):
        ctx.perm, ctx.axis = perm, axis
        return _ppermute_raw(x, perm, axis)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _ppermute_raw(g, inv, ctx.axis), None, None


def ppermute(x: torch.Tensor, perm, axis) -> torch.Tensor:
    """`jax.lax.ppermute` for a full permutation (the ring shifts of
    `parallel/ring.py`): rank ``s`` of the axis sends `x` to rank ``d`` for
    each ``(s, d)`` of `perm`. Its gradient is the ppermute with the
    inverse permutation. At size 1: `x`."""
    if axis is None or axis.group is None:
        return x
    perm = tuple((int(a), int(b)) for a, b in perm)
    if sorted(a for a, _ in perm) != list(range(axis.size)) or sorted(
            b for _, b in perm) != list(range(axis.size)):
        raise ValueError(f"ppermute takes a permutation of the axis's {axis.size} ranks, got "
                         f"{perm}")
    return _PPermute.apply(x, perm, axis)


def _all_to_all_raw(x, split_dim, concat_dim, axis):
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]}) does not split "
                         f"over {n} ranks")
    blocks = dict(enumerate(b.contiguous() for b in x.chunk(n, dim=split_dim)))
    got = _exchange(blocks, list(range(n)), axis)
    return torch.cat([got[j] for j in range(n)], dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, axis):
        ctx.dims, ctx.axis = (split_dim, concat_dim), axis
        return _all_to_all_raw(x, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all_raw(g, concat_dim, split_dim, ctx.axis), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, axis) -> torch.Tensor:
    """`jax.lax.all_to_all(..., tiled=True)`: `x` split into n blocks along
    `split_dim`, block j sent to rank j, the blocks received concatenated
    along `concat_dim` in source order. Its gradient is the inverse
    all-to-all. At size 1: `x`."""
    if axis is None or axis.group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, axis)


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
                           form: str, group=None) -> tuple:
    """Reduce-scatter each bucket over the group: one (S_b,) shard per
    bucket, the bucket ceil-padded to axis_size * S_b (layout order)."""
    out = []
    for buf, s in zip(pack_buckets(layout, tree), layout.shard_sizes(axis_size)):
        full = torch.zeros(s * axis_size, dtype=buf.dtype, device=buf.device)
        full[:buf.numel()].copy_(buf)
        sh = torch.empty(s, dtype=buf.dtype, device=buf.device)
        reduce_scatter(sh, full, rank=rank, form=form, group=group)
        out.append(sh)
    return tuple(out)


def all_gather_buckets(shards, layout: BucketLayout, *, axis_size: int, rank: int,
                       form: str, group=None):
    """The full tree from `reduce_scatter_buckets` shards."""
    bufs = []
    for sh in shards:
        full = torch.empty(sh.numel() * axis_size, dtype=sh.dtype, device=sh.device)
        all_gather(full, sh, rank=rank, form=form, group=group)
        bufs.append(full)
    return unpack_buckets(layout, bufs)


class BucketReducer:
    """The all-reduce form of the overlapped gradient sync over static
    buffers (`ops/schedule.py` `overlap_parts`): ``put`` packs a
    micro-batch's gradients into one buffer per bucket, ``reduce`` sums each
    over its group (one `all_reduce` per bucket; by default the mesh's sync
    axis, data x seq), ``accumulate`` adds the sums into the accumulator and
    ``average(k)`` makes it the mean: each rank's gradients are of its own
    mean loss, so the sum over the dp*sp ranks and k micro-batches is
    divided by k*dp*sp (`divisor`, by default the sync axis's size). A
    tensor-sharded leaf's bucket holds this model rank's shard and is summed
    over the same ranks. `groups`: one group per bucket, where the buckets
    sum over different ranks (the pipeline's: `parallel/pipeline.py`).
    ``grads``: the accumulator as leaf-shaped views. No finalizing
    collective."""

    finalize = None

    def __init__(self, layout: BucketLayout, mesh, device, *, groups=None, divisor=None):
        self.layout, self.mesh = layout, mesh
        self.groups = list(groups) if groups is not None else [mesh.sync.group] * layout.n_buckets
        self.divisor = mesh.sync.size if divisor is None else divisor
        self.bufs = [torch.zeros(e, device=device) for e in layout.bucket_elems()]
        self.acc = [torch.zeros_like(b) for b in self.bufs]
        self.grads = tree_leaves(unpack_buckets(layout, self.acc))

    @torch.no_grad()
    def put(self, grads) -> None:
        pack_buckets(self.layout, grads, out=self.bufs)

    def reduce(self) -> None:
        for b, group in zip(self.bufs, self.groups):
            if group is not None:
                dist.all_reduce(b, group=group)

    @torch.no_grad()
    def accumulate(self, first: bool) -> None:
        if first:
            for a, b in zip(self.acc, self.bufs):
                a.copy_(b)
        else:
            torch._foreach_add_(self.acc, self.bufs)

    @torch.no_grad()
    def average(self, k: int) -> None:
        torch._foreach_div_(self.acc, float(k * self.divisor))
