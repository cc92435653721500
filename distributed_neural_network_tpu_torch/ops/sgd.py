"""SGD with momentum, torch semantics (counterpart of the JAX package's
`ops/sgd.py`): buf <- mu*buf + grad, p <- p - lr*buf, no dampening or
nesterov; zero-initialised buffers make the first step buf = grad. The
update is in place on the parameter and buffer tensors, which may be stacked
replicas (N, ...).

The lr is a number or a 0-d tensor, in one arithmetic (lr*buf, then the
subtraction, as the JAX package computes it). A number is a constant of a
captured graph (the CNN trainer's, whose lr never changes); a tensor is read
when the update runs, so a graph replayed at every step of a schedule (the
LM step) takes each step's lr from a buffer written before the replay.

`guarded_sgd_step` is the guard's in-step 'skip' (`train/guard.py`): the
whole update, decoupled weight decay included, gated on a 0-d bool tensor on
the device, with no host read, so a captured step stays one graph."""

from __future__ import annotations

import torch


def init_momentum(params) -> list[torch.Tensor]:
    """Zero momentum buffers - a freshly constructed torch SGD."""
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_step(params, mom, grads, lr, momentum: float) -> None:
    """One SGD-momentum update of `params` and `mom`, in place; `lr` a
    number or a 0-d tensor."""
    torch._foreach_mul_(mom, momentum)
    torch._foreach_add_(mom, grads)
    torch._foreach_sub_(params, torch._foreach_mul(mom, lr))


@torch.no_grad()
def guarded_sgd_step(params, mom, grads, lr, momentum: float, *, ok,
                     weight_decay: float = 0.0) -> None:
    """`sgd_step` and decoupled weight decay, applied only where the 0-d
    bool tensor `ok` is true: otherwise params and momentum keep their
    values. The new values are computed apart (the same operations in the
    same order as the unguarded step, so with `ok` true the result is its
    bits) and selected with `torch.where`: a 0/1 mask would turn the old
    values into NaN wherever the new ones are (NaN * 0 is NaN)."""
    from .schedule import apply_decoupled_weight_decay

    new_m = torch._foreach_mul(mom, momentum)
    torch._foreach_add_(new_m, grads)
    new_p = torch._foreach_sub(params, torch._foreach_mul(new_m, lr))
    apply_decoupled_weight_decay(new_p, lr, weight_decay)
    select_where(ok, params, new_p)
    select_where(ok, mom, new_m)


@torch.no_grad()
def select_where(ok, dst, new) -> None:
    """dst <- where(ok, new, dst), leaf by leaf, in place (`ok` a 0-d bool
    tensor, or a bool): the JAX package's `tree_where` into the state's own
    tensors."""
    for d, n in zip(dst, new):
        d.copy_(torch.where(torch.as_tensor(ok, device=d.device), n, d))
