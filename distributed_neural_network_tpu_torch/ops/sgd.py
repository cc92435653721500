"""SGD with momentum, torch semantics (counterpart of the JAX package's
`ops/sgd.py`): buf <- mu*buf + grad, p <- p - lr*buf, no dampening or
nesterov; zero-initialised buffers make the first step buf = grad. The
update is in place on the parameter and buffer tensors, which may be stacked
replicas (N, ...).

The lr is a number or a 0-d tensor, in one arithmetic (lr*buf, then the
subtraction, as the JAX package computes it). A number is a constant of a
captured graph (the CNN trainer's, whose lr never changes); a tensor is read
when the update runs, so a graph replayed at every step of a schedule (the
LM step) takes each step's lr from a buffer written before the replay."""

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
