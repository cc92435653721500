"""ZeRO-1: the optimizer state sharded over the data axis (the port of the
JAX package's `parallel/zero.py`).

Each leaf is zero-padded to a multiple of the data-axis size n and split
into n equal contiguous shards; rank r holds and updates only shard r of
every padded leaf's optimizer state (momentum, or Adam's m and v), so the
state's memory and the update's work drop by n. The update is elementwise,
so the partition changes no value: a sharded step is bitwise the
replicated one on the same gradient.

- Gradients: already summed over the ranks (``grads_presummed``, the step's
  all-reduce or the overlap's all-gathered buckets), of which each rank
  reads its slice; or each rank's own partial gradient, reduce-scattered.
- Parameters: after the update every rank's updated shards are
  all-gathered (`ZeroShards.gather`, one collective for all leaves: each
  rank's shards of every leaf side by side, rank-major) and every rank
  copies the whole parameters back.

The collectives take the group's form (`collectives.collective_form`:
`reduce_scatter_tensor` / `all_gather_into_tensor` under NCCL, the
`all_reduce` forms under gloo, which has only `all_reduce` and `broadcast`
on CUDA tensors).

`ZeroShards` holds the static buffers of the update, so the LM step
(`train/lm.py`) runs it as program parts: the update on the shards and the
copy back in graphs, the all-gather between them (captured under NCCL,
eager under gloo). `zero_sgd_step_sharded` / `zero_adam_step_sharded` are
the same update as functions of the trees. `zero_sgd_step` is the JAX
package's ravel-and-psum form of the SGD update (one flat vector, a one-hot
all-reduce to reassemble it), kept as the plain version the tests hold the
sharded path to; nothing on the main path calls it.

A mesh here is `parallel/mesh.py` `ProcessMesh`: the shards are over its
data axis (``mesh.data``: the size, this rank's index and the group), and
with a sequence axis the gradients are first summed over it too (JAX
`make_overlap_grad_reducers`' ``extra_axes``); at dp 1 the collectives are
copies. ZeRO with a model axis is refused (`train/lm.py` `lm_wiring`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.adam import B2, EPS, adam_leaf_update, bias_corrections
from ..ops.schedule import apply_decoupled_weight_decay
from ..ops.sgd import sgd_step
from ..utils.tree import tree_leaves, tree_map
from .collectives import all_gather, reduce_scatter


def _padded(d: int, n: int) -> int:
    return (d + n - 1) // n * n


def zero_shard_size(params, n_shards: int) -> int:
    """Length of each rank's shard of the whole flat parameter vector."""
    d = sum(p.numel() for p in tree_leaves(params))
    return _padded(d, n_shards) // n_shards


def leaf_shard_size(d: int, n_shards: int) -> int:
    """Each rank's shard length for one leaf of d elements (ceil(d/n))."""
    return _padded(d, n_shards) // n_shards


def init_zero_momentum_tree(params, n_shards: int):
    """This rank's (pad(leaf)/n,) zero momentum shard of every leaf, f32,
    on the leaves' device, in the shape of `params`."""
    return tree_map(lambda p: torch.zeros(leaf_shard_size(p.numel(), n_shards),
                                          device=p.device), params)


def init_zero_adam_tree(params, n_shards: int) -> dict:
    """ZeRO-1 Adam state: this rank's shards of m and v, and the host's step
    counter."""
    return {"m": init_zero_momentum_tree(params, n_shards),
            "v": init_zero_momentum_tree(params, n_shards), "t": 0}


class ZeroShards:
    """The buffers of one rank's ZeRO-1 update of `leaves` over `mesh`'s
    data axis: ``own`` holds this rank's parameter shards of every leaf
    side by side (``p_sh`` views it per leaf), ``g_sh`` the gradient
    shards, ``full`` the all-gathered shards of every rank (rank-major)."""

    def __init__(self, leaves, mesh):
        self.mesh = mesh
        self.axis = ax = mesh.data
        n, r = ax.size, ax.index
        dev = leaves[0].device
        self.sizes = [p.numel() for p in leaves]
        self.shards = [leaf_shard_size(d, n) for d in self.sizes]
        self.offsets = [sum(self.shards[:i]) for i in range(len(leaves))]
        total = sum(self.shards)
        self.own = torch.zeros(total, device=dev)
        self.full = torch.zeros(n * total, device=dev)
        self.p_sh = [self.own[o:o + s] for o, s in zip(self.offsets, self.shards)]
        self.g_sh = [torch.zeros(s, device=dev) for s in self.shards]
        # the real (unpadded) part of this rank's shard of each leaf
        self.ranges = [(min(r * s, d), min((r + 1) * s, d))
                       for d, s in zip(self.sizes, self.shards)]

    @torch.no_grad()
    def take_params(self, leaves) -> None:
        for p, sh, (lo, hi) in zip(leaves, self.p_sh, self.ranges):
            sh[:hi - lo].copy_(p.detach().reshape(-1)[lo:hi])

    @torch.no_grad()
    def take_grads(self, grads) -> None:
        """This rank's slices of gradients already summed over the ranks."""
        for g, sh, (lo, hi) in zip(grads, self.g_sh, self.ranges):
            sh[:hi - lo].copy_(g.reshape(-1)[lo:hi])

    @torch.no_grad()
    def reduce_grads(self, grads) -> None:
        """Reduce-scatter each rank's own partial gradients into this rank's
        shards (each leaf padded to n shards)."""
        ax = self.axis
        for g, sh, s in zip(grads, self.g_sh, self.shards):
            full = torch.zeros(ax.size * s, dtype=g.dtype, device=g.device)
            full[:g.numel()].copy_(g.reshape(-1))
            if ax.group is not None:
                reduce_scatter(sh, full, rank=ax.index, form=ax.form, group=ax.group)
            else:
                sh.copy_(full)

    @torch.no_grad()
    def gather(self) -> None:
        """All-gather every rank's updated shards into ``full`` (the
        collective)."""
        ax = self.axis
        if ax.group is not None:
            all_gather(self.full, self.own, rank=ax.index, form=ax.form, group=ax.group)
        else:
            self.full.copy_(self.own)

    @torch.no_grad()
    def put_params(self, leaves) -> None:
        """Copy the gathered parameters back into `leaves`."""
        rows = self.full.view(self.axis.size, -1)
        for p, o, s, d in zip(leaves, self.offsets, self.shards, self.sizes):
            p.view(-1).copy_(rows[:, o:o + s].reshape(-1)[:d])


def _sharded_leaf_step(params, grads, state_lists, update_fn, *, mesh,
                       grads_presummed: bool = True) -> None:
    """The ZeRO-1 scaffolding for an elementwise optimizer, in place: this
    rank's shards of the parameters and gradients (sliced, or
    reduce-scattered from partial gradients), ``update_fn(p_shards,
    g_shards, *state_lists)`` updating the shards in place (lists of (S,)
    tensors, one per leaf), then the all-gather and the copy back."""
    leaves, g = tree_leaves(params), tree_leaves(grads)
    sh = ZeroShards(leaves, mesh)
    sh.take_params(leaves)
    if grads_presummed:
        sh.take_grads(g)
    else:
        sh.reduce_grads(g)
    update_fn(sh.p_sh, sh.g_sh, *state_lists)
    sh.gather()
    sh.put_params(leaves)


def zero_sgd_step_sharded(params, mom_tree, grads, lr, momentum: float, *, mesh,
                          grads_presummed: bool = True, weight_decay: float = 0.0) -> None:
    """One SGD-momentum step (then decoupled weight decay) with the momentum
    sharded per leaf over the data axis; params and `mom_tree` (this rank's
    shards, `init_zero_momentum_tree`) updated in place."""

    def upd(p_sh, g_sh, m):
        sgd_step(p_sh, m, g_sh, lr, momentum)
        apply_decoupled_weight_decay(p_sh, lr, weight_decay)

    _sharded_leaf_step(params, grads, (tree_leaves(mom_tree),), upd, mesh=mesh,
                       grads_presummed=grads_presummed)


def zero_adam_step_sharded(params, state, grads, lr, b1: float = 0.9, b2: float = B2,
                           eps: float = EPS, weight_decay: float = 0.0, *, mesh,
                           grads_presummed: bool = True) -> None:
    """One Adam/AdamW step with both moments sharded per leaf over the data
    axis (`init_zero_adam_tree`), in place; the counter ``t`` counts on the
    host."""
    state["t"] += 1
    c1, c2 = bias_corrections(state["t"], b1, b2)

    def upd(p_sh, g_sh, m, v):
        adam_leaf_update(p_sh, g_sh, m, v, c1, c2, lr, b1, b2, eps, weight_decay)

    _sharded_leaf_step(params, grads, (tree_leaves(state["m"]), tree_leaves(state["v"])), upd,
                       mesh=mesh, grads_presummed=grads_presummed)


def make_overlap_grad_reducers(layout, mesh):
    """(reduce_fn, finalize_fn) of the ZeRO overlap schedule
    (`ops/schedule.py` accumulate_fwd_bwd_overlap): each micro-batch's
    gradients reduce-scattered per bucket (the accumulator holds this rank's
    1/n bucket shards only), and the averaged shards all-gathered back into
    the full gradient tree, which the per-leaf update then slices."""
    from .collectives import all_gather_buckets, reduce_scatter_buckets

    ax = mesh.data
    kw = dict(axis_size=ax.size, rank=ax.index, form=ax.form, group=ax.group)
    seq = mesh.seq.group

    def reduce_fn(grads):
        shards = reduce_scatter_buckets(grads, layout, **kw)
        if seq is not None:
            for sh in shards:
                dist.all_reduce(sh, group=seq)
        return shards

    def finalize_fn(shards):
        return all_gather_buckets(shards, layout, **kw)

    return reduce_fn, finalize_fn


def make_zero_split_step(leaves, grads, state, *, mesh, optimizer: str, lr_t, momentum: float,
                         weight_decay: float = 0.0, corrections=None):
    """The optimizer half of the ZeRO-1 LM step over static buffers:
    (update, gather, put), to run in that order after the gradients'
    collective. `grads`: leaf-shaped tensors holding the gradients summed
    over the ranks (clipped already); `state`: this rank's shards (a list,
    or {"m", "v"} for zero-adam); `lr_t` and `corrections` (c1, c2): 0-d
    tensors the host writes before each run. update: slice this rank's
    shards and update them (a graph part); gather: the all-gather (the
    collective, captured under NCCL, eager under gloo); put: the copy back
    into the parameters (a graph part). The parts hold their buffers (a
    `ZeroShards`)."""
    sh = ZeroShards(leaves, mesh)

    @torch.no_grad()
    def update():
        sh.take_params(leaves)
        sh.take_grads(grads)
        if optimizer == "zero-adam":
            c1, c2 = corrections
            adam_leaf_update(sh.p_sh, sh.g_sh, state["m"], state["v"], c1, c2, lr_t, momentum,
                             B2, EPS, weight_decay)
        else:
            sgd_step(sh.p_sh, state, sh.g_sh, lr_t, momentum)
            apply_decoupled_weight_decay(sh.p_sh, lr_t, weight_decay)

    return update, sh.gather, lambda: sh.put_params(leaves)


@torch.no_grad()
def zero_sgd_step(params, mom_shard: torch.Tensor, grads, lr, momentum: float, *, mesh,
                  grads_presummed: bool = True) -> None:
    """One SGD-momentum step with the momentum sharded over the data axis
    as one flat vector (the JAX package's plain form): the whole tree
    raveled and padded, this rank's (pad(D)/n,) slice updated, and the
    vector reassembled by an all-reduce of zeros holding this rank's slice.
    `mom_shard` and the params are updated in place."""
    leaves = tree_leaves(params)
    ax = mesh.data
    n, r = ax.size, ax.index
    flat_p = torch.cat([p.detach().reshape(-1) for p in leaves])
    flat_g = torch.cat([g.reshape(-1) for g in tree_leaves(grads)])
    d = flat_p.numel()
    pad = _padded(d, n) - d
    if pad:
        flat_p = torch.cat([flat_p, flat_p.new_zeros(pad)])
        flat_g = torch.cat([flat_g, flat_g.new_zeros(pad)])
    s = flat_p.numel() // n
    if grads_presummed:
        g_sh = flat_g[r * s:(r + 1) * s]
    else:
        g_sh = torch.empty(s, device=flat_g.device)
        if ax.group is not None:
            reduce_scatter(g_sh, flat_g, rank=r, form=ax.form, group=ax.group)
        else:
            g_sh.copy_(flat_g)
    mom_shard.copy_(momentum * mom_shard + g_sh)
    p_sh = flat_p[r * s:(r + 1) * s] - lr * mom_shard
    flat_new = torch.zeros_like(flat_p)
    flat_new[r * s:(r + 1) * s] = p_sh
    if ax.group is not None:
        dist.all_reduce(flat_new, group=ax.group)
    at = 0
    for p in leaves:
        p.view(-1).copy_(flat_new[at:at + p.numel()])
        at += p.numel()


class ShardReducer:
    """The reduce-scatter form of the overlapped gradient sync (ZeRO's
    shard carry) over static buffers (`ops/schedule.py` `overlap_parts`):
    ``put`` packs a micro-batch's gradients into one buffer per bucket
    (each padded to n shards), ``reduce`` reduce-scatters each into this
    rank's (S_b,) shard over the data axis (then sums it over the bucket's
    `extra` group: by default the sequence axis, when there is one; on a
    pipeline mesh the pipe axis for the buckets of pipe-replicated leaves),
    ``accumulate`` adds the shards into the accumulator, which holds 1/n of
    the gradient; ``average(k)`` divides by k*`divisor` (by default k*dp*sp:
    each rank's gradients are of its own mean loss), and ``finalize``
    all-gathers the averaged shards back into the bucket buffers, whose
    leaf-shaped views are ``grads``: the gradients summed over the ranks,
    which the ZeRO update then slices."""

    def __init__(self, layout, mesh, device, *, extra=None, divisor=None):
        self.layout, self.mesh, self.axis = layout, mesh, mesh.data
        self.extra = list(extra) if extra is not None else [mesh.seq.group] * layout.n_buckets
        self.divisor = mesh.sync.size if divisor is None else divisor
        n = self.axis.size
        shards = layout.shard_sizes(n)
        self.bufs = [torch.zeros(s * n, device=device) for s in shards]
        self.tmp = [torch.zeros(s, device=device) for s in shards]
        self.acc = [torch.zeros(s, device=device) for s in shards]
        from .collectives import unpack_buckets

        self.grads = tree_leaves(unpack_buckets(layout, self.bufs))

    @torch.no_grad()
    def put(self, grads) -> None:
        from .collectives import pack_buckets

        pack_buckets(self.layout, grads, out=self.bufs)

    def reduce(self) -> None:
        ax = self.axis
        for t, b, extra in zip(self.tmp, self.bufs, self.extra):
            if ax.group is not None:
                reduce_scatter(t, b, rank=ax.index, form=ax.form, group=ax.group)
            else:
                t.copy_(b)
            if extra is not None:
                dist.all_reduce(t, group=extra)

    @torch.no_grad()
    def accumulate(self, first: bool) -> None:
        if first:
            for a, t in zip(self.acc, self.tmp):
                a.copy_(t)
        else:
            torch._foreach_add_(self.acc, self.tmp)

    @torch.no_grad()
    def average(self, k: int) -> None:
        torch._foreach_div_(self.acc, float(k * self.divisor))

    def finalize(self) -> None:
        ax = self.axis
        for b, a in zip(self.bufs, self.acc):
            if ax.group is not None:
                all_gather(b, a, rank=ax.index, form=ax.form, group=ax.group)
            else:
                b.copy_(a)
