"""Adam/AdamW, the port of the JAX package's `ops/adam.py`: bias-corrected
Adam with optional decoupled weight decay, in the JAX order of operations,
updating lists of parameter and state tensors in place with `_foreach` ops.

State: ``{"m": [...], "v": [...], "t": int}`` with one tensor per parameter
leaf. The step counter stays on the host; the lr and the bias corrections
may be numbers or 0-d f32 tensors (a captured step reads them from buffers
written before each replay), with the same arithmetic either way.
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


def guarded_adam_step(params, state, grads, lr: float, *, ok, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """`adam_step` applied only when `ok` (a bool or 0-d tensor) is true:
    otherwise params, both moments and the counter are left as they were."""
    if bool(ok):
        adam_step(params, state, grads, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
