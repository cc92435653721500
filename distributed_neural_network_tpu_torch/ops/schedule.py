"""Learning-rate schedules and gradient transforms: the port of the JAX
package's `ops/schedule.py`.

Schedules return the lr as a Python float computed in float32, as the JAX
package computes it in the step, so the optimizers see the same value.
Gradient transforms act on lists of tensors (the parameter leaves in
`tree_leaves` order) and update in place where the JAX functions return new
trees.

The norms are mesh-aware as the JAX ones: with ``specs`` (leaf-aligned
PartitionSpecs) and ``axes`` (the mesh's axis names in scope) a leaf's
squared sum is all-reduced over the axes its spec shards it on, each over
its group of the ``mesh`` (`parallel/mesh.py` `ProcessMesh`): a leaf
sharded over ``model`` (tensor parallelism) is summed over the model axis's
ranks. Replicated leaves, whose gradients the step has already summed over
the ranks (and which `copy_to_model`'s backward made whole on every model
rank), count once. Without a mesh (one process) nothing is summed.

`accumulate_fwd_bwd_overlap` moves the gradient collective inside the
accumulation loop (one reduction per micro-batch); `overlap_parts` is the
same schedule as a list of program parts over a reducer's static buffers,
split at its collectives, which is how the LM step runs it (`train/lm.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.partition import spec_axes
from ..utils.tree import tree_leaves

GRAD_SYNCS = ("end", "overlap")


def warmup_cosine(step, *, base_lr: float, total_steps: int, warmup_steps: int = 0,
                  min_lr_frac: float = 0.0) -> float:
    """lr at `step`: linear warmup over `warmup_steps` (step 0 gets
    base_lr / warmup_steps), then half-cosine decay to base_lr * min_lr_frac
    over the remaining steps, and flat after."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be > 0, got {total_steps}")
    if not 0 <= warmup_steps <= total_steps:
        raise ValueError(f"warmup_steps ({warmup_steps}) must be in [0, total_steps "
                         f"({total_steps})]")
    f32 = np.float32
    t = f32(step)
    warm = f32(max(warmup_steps, 1))
    ramp = min((t + f32(1.0)) / warm, f32(1.0))
    span = f32(max(total_steps - warmup_steps, 1))
    frac = min(max((t - f32(warmup_steps)) / span, f32(0.0)), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=np.float32))
    decay = f32(min_lr_frac) + f32(1.0 - min_lr_frac) * cos
    return float(f32(base_lr) * (ramp if t < warmup_steps else decay))


def constant_lr(step, *, base_lr: float, **_) -> float:
    """Fixed lr; the same signature as the others."""
    return float(np.float32(base_lr))


SCHEDULES = {"constant": constant_lr, "cosine": warmup_cosine}


def per_leaf_sq_norms(leaves, *, specs=None, axes=(), mesh=None):
    """Per-leaf global squared L2 norms (f32 0-d tensors): with `specs` and
    `axes`, a leaf's squared sum is all-reduced over each axis of `axes`
    its spec shards it on, over that axis's group of `mesh`. One
    multi-tensor pass reads each leaf once (no squared copy of the
    gradients): the guard's health norm is paid at every step."""
    norms = torch._foreach_norm([g.float() for g in leaves])
    sq = torch._foreach_mul(norms, norms)
    if specs is None or not axes:
        return sq
    spec_leaves = tree_leaves(specs)
    if len(spec_leaves) != len(sq):
        raise ValueError(f"{len(spec_leaves)} specs for {len(sq)} leaves")
    for x, spec in zip(sq, spec_leaves):
        for a in spec_axes(spec):
            group = mesh.axis(a).group if mesh is not None and a in axes else None
            if group is not None:
                dist.all_reduce(x, group=group)
    return sq


def global_norm(leaves, *, specs=None, axes=(), mesh=None):
    """Global L2 norm of a list of gradients (f32 0-d tensor)."""
    return torch.stack(per_leaf_sq_norms(leaves, specs=specs, axes=axes, mesh=mesh)).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(leaves, max_norm: float, *, specs=None, axes=(), mesh=None):
    """Scale `leaves` in place so their global norm is at most `max_norm`;
    returns the pre-clip norm."""
    norm = global_norm(leaves, specs=specs, axes=axes, mesh=mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(leaves, scale)
    return norm


@torch.no_grad()
def apply_decoupled_weight_decay(params, lr_t, weight_decay: float) -> None:
    """AdamW-style decay after the optimizer update, in place: p -= lr*wd*p;
    `lr_t` a number or a 0-d tensor."""
    if weight_decay:
        torch._foreach_add_(params, torch._foreach_mul(params, lr_t * weight_decay), alpha=-1.0)


def health_bundle(loss, grad_norm) -> dict:
    """{loss, grad_norm, all_finite} from two scalars the step already has."""
    loss32 = torch.as_tensor(loss, dtype=torch.float32)
    norm32 = torch.as_tensor(grad_norm, dtype=torch.float32)
    return {"loss": loss32, "grad_norm": norm32,
            "all_finite": torch.isfinite(loss32) & torch.isfinite(norm32)}


def accumulate_fwd_bwd(fwd_bwd_one, accum_steps: int):
    """Wrap a per-micro-batch (tokens, targets) -> loss that ADDS its
    gradients into the leaves' ``.grad`` into a k-step accumulation over
    B/k-row slices: the returned fn leaves the mean gradient in ``.grad``
    (summed in micro-batch order, then divided by k) and returns the mean
    loss, as one k-times larger batch up to float reassociation."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def fwd_bwd(leaves, tokens, targets):
        if accum_steps == 1:
            return fwd_bwd_one(tokens, targets)
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"per-device batch ({b}) must divide by accum_steps "
                             f"({accum_steps})")
        mb = b // accum_steps
        loss = fwd_bwd_one(tokens[:mb], targets[:mb])
        for i in range(1, accum_steps):
            loss = loss + fwd_bwd_one(tokens[i * mb:(i + 1) * mb], targets[i * mb:(i + 1) * mb])
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in leaves], float(accum_steps))
        return loss / accum_steps

    return fwd_bwd


def _check_overlap(accum_steps: int) -> None:
    if accum_steps < 2:
        raise ValueError(f"overlap accumulation needs accum_steps >= 2, got {accum_steps} (at "
                         "k=1 the schedules coincide - use the end path, which is bitwise "
                         "identical)")


def _micro_batches(tokens, targets, accum_steps: int):
    b = tokens.shape[0]
    if b % accum_steps:
        raise ValueError(f"per-device batch ({b}) must divide by accum_steps ({accum_steps})")
    mb = b // accum_steps
    return [(tokens[i * mb:(i + 1) * mb], targets[i * mb:(i + 1) * mb])
            for i in range(accum_steps)]


def accumulate_fwd_bwd_overlap(fwd_bwd_one, accum_steps: int, *, reduce_fn, finalize_fn):
    """Gradient accumulation with the sync collective INSIDE the loop: each
    micro-batch's gradients go straight to `reduce_fn` (a bucketed
    all-reduce for plain dp, a bucketed reduce-scatter for the ZeRO shard
    carry) and the loop accumulates the reduced form, so the collective of
    micro-batch i can run while micro-batch i+1 computes; `finalize_fn` maps
    the averaged reduced form back to a full gradient list (the identity's
    unpack for all-reduced buckets, the all-gather for shards).

    `fwd_bwd_one(tokens, targets)` -> loss, leaving the micro-batch's
    gradients in the leaves' ``.grad`` (added into ``None``);
    `reduce_fn(grads)` -> a list of tensors; `finalize_fn(avg)` -> the
    gradients. Returns `fwd_bwd(leaves, tokens, targets)` -> (mean loss,
    gradients), the leaves' ``.grad`` left ``None``. Matches the end
    schedule up to float reassociation; needs accum_steps >= 2."""
    _check_overlap(accum_steps)

    def fwd_bwd(leaves, tokens, targets):
        loss_sum, red_sum = None, None
        for tok, tgt in _micro_batches(tokens, targets, accum_steps):
            for p in leaves:
                p.grad = None
            loss = fwd_bwd_one(tok, tgt)
            with torch.no_grad():
                red = list(reduce_fn([p.grad for p in leaves]))
                if red_sum is None:
                    loss_sum, red_sum = loss, [r.clone() for r in red]
                else:
                    loss_sum = loss_sum + loss
                    torch._foreach_add_(red_sum, red)
        for p in leaves:
            p.grad = None
        with torch.no_grad():
            torch._foreach_div_(red_sum, float(accum_steps))
            return loss_sum / accum_steps, finalize_fn(red_sum)

    return fwd_bwd


def overlap_parts(fwd_bwd_one, accum_steps: int, leaves, tokens, targets, reducer, loss_out):
    """`accumulate_fwd_bwd_overlap`'s schedule as program parts over static
    buffers: [(fn, kind)], in order, kind "model" (a part that runs the
    model's forward and backward), "collective" or "local". Per
    micro-batch: its forward and backward, the reducer's ``put`` of its
    gradients (one part), then the reducer's ``reduce`` (the collective);
    the next part first adds the reduced form into the accumulator
    (``accumulate``). After the last: ``average(k)``, then the reducer's
    ``finalize`` collective, if it has one. `loss_out` (a 0-d buffer) gets
    the mean local loss.

    The reducer (`parallel/collectives.py` `BucketReducer`,
    `parallel/zero.py` `ShardReducer`) owns the buffers: ``put(grads)``,
    ``reduce()``, ``accumulate(first)``, ``average(k)``, ``finalize`` (None
    or a collective) and ``grads`` (the gradients it leaves)."""
    _check_overlap(accum_steps)
    batches = _micro_batches(tokens, targets, accum_steps)

    def compute(i):
        tok, tgt = batches[i]

        def part():
            if i > 0:
                reducer.accumulate(i == 1)
            for p in leaves:
                p.grad = None
            loss = fwd_bwd_one(tok, tgt)
            with torch.no_grad():
                reducer.put([p.grad for p in leaves])
                if i == 0:
                    loss_out.copy_(loss)
                else:
                    loss_out.add_(loss)
            for p in leaves:
                p.grad = None

        return part

    def last():
        reducer.accumulate(False)
        reducer.average(accum_steps)
        loss_out.div_(accum_steps)

    parts = []
    for i in range(accum_steps):
        parts += [(compute(i), "model"), (reducer.reduce, "collective")]
    parts.append((last, "local"))
    if reducer.finalize is not None:
        parts.append((reducer.finalize, "collective"))
    return parts


def make_ema_update(decay: float):
    """In-place EMA tracker: ema <- decay * ema + (1 - decay) * params."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")

    @torch.no_grad()
    def update(ema, params):
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, params, alpha=1.0 - decay)
        return ema

    return update
