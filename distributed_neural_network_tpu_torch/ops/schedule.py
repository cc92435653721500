"""Learning-rate schedules and gradient transforms: the port of the JAX
package's `ops/schedule.py` for one device.

Schedules return the lr as a Python float computed in float32, as the JAX
package computes it in the step, so the optimizers see the same value.
Gradient transforms act on lists of tensors (the parameter leaves in
`tree_leaves` order) and update in place where the JAX functions return new
trees. The mesh-aware forms (`specs`/`axes`) and the overlapped
accumulation (`accumulate_fwd_bwd_overlap`) come with the parallel layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.ring import PARALLEL_SLICE

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


def _check_single(specs, axes) -> None:
    if specs is not None or axes:
        raise NotImplementedError(f"mesh-aware norms (specs/axes) come with {PARALLEL_SLICE}")


def per_leaf_sq_norms(leaves, *, specs=None, axes=()):
    """Per-leaf squared L2 norms (f32 0-d tensors)."""
    _check_single(specs, axes)
    return [g.float().square().sum() for g in leaves]


def global_norm(leaves, *, specs=None, axes=()):
    """Global L2 norm of a list of gradients (f32 0-d tensor)."""
    return torch.stack(per_leaf_sq_norms(leaves, specs=specs, axes=axes)).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(leaves, max_norm: float, *, specs=None, axes=()):
    """Scale `leaves` in place so their global norm is at most `max_norm`;
    returns the pre-clip norm."""
    norm = global_norm(leaves, specs=specs, axes=axes)
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


def accumulate_fwd_bwd_overlap(*args, **kwargs):
    raise NotImplementedError(f"grad_sync='overlap' (the collective inside the accumulation "
                              f"loop) comes with {PARALLEL_SLICE}")


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
