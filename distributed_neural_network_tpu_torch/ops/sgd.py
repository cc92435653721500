"""SGD with momentum, torch semantics (counterpart of the JAX package's
`ops/sgd.py`): buf <- mu*buf + grad, p <- p - lr*buf, no dampening or
nesterov; zero-initialised buffers make the first step buf = grad. The
update is in place on the parameter and buffer tensors."""

from __future__ import annotations

import torch


def init_momentum(params) -> list[torch.Tensor]:
    """Zero momentum buffers - a freshly constructed torch SGD."""
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_step(params, mom, grads, lr: float, momentum: float) -> None:
    """One SGD-momentum update of `params` and `mom`, in place."""
    torch._foreach_mul_(mom, momentum)
    torch._foreach_add_(mom, grads)
    torch._foreach_add_(params, mom, alpha=-lr)
