"""Adam/AdamW, the port of the JAX package's `ops/adam.py`: bias-corrected
Adam with optional decoupled weight decay, in the JAX order of operations,
updating lists of parameter and state tensors in place with `_foreach` ops.

State: ``{"m": [...], "v": [...], "t": int}`` with one tensor per parameter
leaf. The step counter stays on the host; the lr and the bias corrections
may be numbers or 0-d f32 tensors (a captured step reads them from buffers
written before each replay), with the same arithmetic either way.

`guarded_adam_step` is the guard's in-step 'skip' (`train/guard.py`): the
update of the parameters, both moments and the counter gated on a 0-d bool
tensor, on the device, with no host read. A skipped step must not advance
the counter, and the host learns of a skip only later, so the guarded step
counts on the device: ``t`` is a 0-d integer tensor there, and the bias
corrections are read from a device table of the host's f32 values
(`correction_table`), so they are the unguarded step's bits.
"""

from __future__ import annotations

import numpy as np
import torch

B2, EPS = 0.999, 1e-8  # the JAX package's defaults


def init_adam(params) -> dict:
    """Zero first/second-moment lists and a step counter."""
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params], "t": 0}


def bias_corrections(t: int, b1: float, b2: float):
    """(c1, c2) bias-correction divisors at integer step t (1-based), in f32."""
    tf = np.float32(t)
    return (float(np.float32(1.0) - np.float32(b1) ** tf),
            float(np.float32(1.0) - np.float32(b2) ** tf))


@torch.no_grad()
def adam_leaf_update(p, g, m, v, c1, c2, lr, b1, b2, eps, weight_decay) -> None:
    """The elementwise Adam/AdamW update for lists of leaves, in place:
    m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2; step = (m/c1) / (sqrt(v/c2)
    + eps) [+ wd p]; p -= lr step. c1, c2 and lr are numbers or 0-d
    tensors."""
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(g, g), alpha=1.0 - b2)
    denom = torch._foreach_sqrt(torch._foreach_div(v, c2))
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(torch._foreach_div(m, c1), denom)
    if weight_decay:
        torch._foreach_add_(step, torch._foreach_mul(p, weight_decay))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(p, step)


def adam_step(params, state, grads, lr, b1: float = 0.9, b2: float = B2,
              eps: float = EPS, weight_decay: float = 0.0) -> None:
    """One bias-corrected Adam/AdamW update of `params` and `state`, in place."""
    state["t"] += 1
    c1, c2 = bias_corrections(state["t"], b1, b2)
    adam_leaf_update(params, grads, state["m"], state["v"], c1, c2, lr, b1, b2, eps,
                     weight_decay)


# the largest table `correction_table` builds (8 MB of f32 pairs)
TABLE_MAX = 1 << 20


def correction_table(b1: float, b2: float = B2, *, device="cpu") -> torch.Tensor:
    """(T + 1, 2) f32: row t holds `bias_corrections(t, b1, b2)` for t = 1..T
    (row 0 is unused), T the first step at which both corrections are
    exactly 1.0 in f32 and stay so (b**t falls below half an ulp of 1), so
    that row T serves every later step. Built on the host, copied once."""
    rows = [(0.0, 0.0)]
    while rows[-1] != (1.0, 1.0):
        if len(rows) > TABLE_MAX:
            raise ValueError(f"the bias corrections of b1={b1}, b2={b2} do not reach 1.0 "
                             f"within {TABLE_MAX} steps; the device counter has no table "
                             "for them")
        # the scalar f32 power, as the host's step computes it (numpy's
        # vectorized power rounds some steps otherwise)
        rows.append(bias_corrections(len(rows), b1, b2))
    return torch.tensor(rows, dtype=torch.float32, device=device)


def table_corrections(table: torch.Tensor, t: torch.Tensor):
    """(c1, c2) of step t (a 0-d integer tensor) from `correction_table`,
    as 0-d f32 tensors, on the device."""
    # index_select: indexing with a 0-d tensor would read it on the host,
    # which a graph capture forbids
    row = table.index_select(0, torch.clamp(t, max=table.shape[0] - 1).long().reshape(1))[0]
    return row[0], row[1]


@torch.no_grad()
def guarded_adam_leaf_update(p, g, m, v, c1, c2, lr, b1, b2, eps, weight_decay, *,
                             ok) -> None:
    """`adam_leaf_update` applied only where the 0-d bool tensor `ok` is
    true: the new p, m and v computed apart, in the unguarded order of
    operations (so with `ok` true they are its bits), then selected with
    `torch.where` (a 0/1 mask would make NaN of the old values)."""
    from .sgd import select_where

    new_m = torch._foreach_mul(m, b1)
    torch._foreach_add_(new_m, g, alpha=1.0 - b1)
    new_v = torch._foreach_mul(v, b2)
    torch._foreach_add_(new_v, torch._foreach_mul(g, g), alpha=1.0 - b2)
    denom = torch._foreach_sqrt(torch._foreach_div(new_v, c2))
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(torch._foreach_div(new_m, c1), denom)
    if weight_decay:
        torch._foreach_add_(step, torch._foreach_mul(p, weight_decay))
    torch._foreach_mul_(step, lr)
    new_p = torch._foreach_sub(p, step)
    select_where(ok, p, new_p)
    select_where(ok, m, new_m)
    select_where(ok, v, new_v)


@torch.no_grad()
def advance_counter(t: torch.Tensor, ok) -> None:
    """t += 1 where the 0-d bool tensor (or bool) `ok` is true, on the device."""
    t.copy_(torch.where(torch.as_tensor(ok, device=t.device), t + 1, t))


def guarded_adam_step(params, state, grads, lr, *, ok, b1: float = 0.9, b2: float = B2,
                      eps: float = EPS, weight_decay: float = 0.0, table=None) -> None:
    """`adam_step` applied only where the 0-d bool tensor `ok` is true:
    otherwise params, both moments and the counter keep their values. The
    counter ``state["t"]`` is a 0-d integer tensor on the parameters'
    device; the corrections come from `table` (`correction_table(b1, b2)`,
    built here when not given)."""
    t = state["t"]
    if not (isinstance(t, torch.Tensor) and t.dim() == 0 and not t.is_floating_point()):
        raise TypeError("guarded_adam_step counts on the device: state['t'] must be a 0-d "
                        f"integer tensor, got {t!r}")
    if table is None:
        table = correction_table(b1, b2, device=t.device)
    c1, c2 = table_corrections(table, t + 1)
    guarded_adam_leaf_update(params, grads, state["m"], state["v"], c1, c2, lr, b1, b2, eps,
                             weight_decay, ok=ok)
    advance_counter(t, ok)
