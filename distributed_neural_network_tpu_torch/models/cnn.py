"""LeNet-style CIFAR-10 CNN (counterpart of the JAX package's `models/cnn.py`).

conv(3->6, k5) -> relu -> maxpool2 -> conv(6->16, k5) -> relu -> maxpool2 ->
flatten(400) -> fc 120 -> relu -> fc 84 -> relu -> fc 10.

- **NHWC at the public boundary**, as in the JAX package. The input is
  permuted to NCHW for `F.conv2d` and back to NHWC before the flatten, so the
  400 features come out in H,W,C order and fc1's rows match JAX's.
- Dense kernels are stored ``(in, out)``, the layout the fused head kernel
  takes; conv weights are PyTorch's OIHW. `from_jax_params` /
  `to_jax_params` carry parameters across (HWIO <-> OIHW for the convs).
- Init: every weight and bias ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)), the
  JAX package's torch-default init, drawn from an explicit `torch.Generator`
  (the numbers differ from JAX's for the same seed).
- `Network` is one replica's parameters and their init; the model that
  runs is `ReplicaNetwork(n)`, N replicas of `Network` with every parameter
  stacked on a leading axis (the JAX momentum stack's `P(DATA_AXIS)`). Its
  forward takes (N, B, 32, 32, 3) and runs each conv once for all replicas
  (grouped, `groups=N`) and the head once over all of them: through the
  fused head (`ops/fused_head.py`) with `kernels="cuda"`, its plain version
  with `kernels="torch"`.
- `compute_dtype=torch.bfloat16` (the JAX `Network(compute_dtype=bfloat16)`):
  the input, conv weights and biases are cast to bf16 and the grouped convs,
  ReLUs and pools run in bf16. With `kernels="cuda"` the flattened
  activations are cast to f32 for the f32 head kernels, as the JAX Pallas
  head casts its input; with `kernels="torch"` the head runs in bf16 too.
  The logits come out f32 either way; parameters stay f32 (the casts are
  differentiable, so their gradients are f32).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_head import fused_mlp3, mlp3_reference

KERNELS = ("torch", "cuda")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CONVS = ("conv1", "conv2")
_DENSES = ("fc1", "fc2", "fc3")


class Dense(nn.Module):
    """kernel (in, out) and bias (out,), like the JAX package's Dense params."""

    def __init__(self, fan_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features))


class Network(nn.Module):
    """The parameters of the reference's 62,006-parameter CIFAR-10
    classifier, drawn by its init (`ReplicaNetwork` runs them)."""

    def __init__(self, num_classes: int = 10, *, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = Dense(400, 120)
        self.fc2 = Dense(120, 84)
        self.fc3 = Dense(84, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for name, p in self.named_parameters():
            layer = self.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(layer, nn.Conv2d):
                fan_in = layer.in_channels * layer.kernel_size[0] * layer.kernel_size[1]
            else:
                fan_in = layer.kernel.shape[0]
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(p, -bound, bound, generator=generator)


class _Stacked(nn.Module):
    """One layer's parameters, each with a leading replica axis."""

    def __init__(self, layer: nn.Module, n: int):
        super().__init__()
        for name, p in layer.named_parameters(recurse=False):
            stacked = p.detach().unsqueeze(0).repeat(n, *([1] * p.dim()))
            self.register_parameter(name, nn.Parameter(stacked))


class ReplicaNetwork(nn.Module):
    """`n` replicas of `Network`, each parameter stacked on a leading axis.

    Every replica starts as the one `Network(generator=generator)` that the
    generator's stream draws. Input (n, batch, 32, 32, 3) float32 NHWC;
    output (n, batch, 10) float32 logits, computed in `compute_dtype`
    (module docstring). The state_dict has `Network`'s names with an
    (n, ...) float32 tensor each.
    """

    def __init__(self, n: int, num_classes: int = 10, *, kernels: str = "torch",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kernels not in KERNELS:
            raise ValueError(f"kernels must be one of {KERNELS}, got {kernels!r}")
        if compute_dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES.values())}, "
                             f"got {compute_dtype!r}")
        base = Network(num_classes, generator=generator)
        self.n, self.kernels, self.compute_dtype = n, kernels, compute_dtype
        for name in _CONVS + _DENSES:
            setattr(self, name, _Stacked(base.get_submodule(name), n))

    def _conv(self, x, layer, n):
        w, b = (t.to(self.compute_dtype) for t in (layer.weight, layer.bias))
        return F.conv2d(x, w.reshape(-1, *w.shape[2:]), b.reshape(-1), groups=n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, b = x.shape[:2]
        # (n, B, H, W, C) -> (B, n*C, H, W): replica d's channels are group d
        x = x.to(self.compute_dtype).permute(1, 0, 4, 2, 3).reshape(
            b, n * x.shape[-1], *x.shape[2:4])
        x = F.max_pool2d(F.relu(self._conv(x, self.conv1, n)), 2)
        x = F.max_pool2d(F.relu(self._conv(x, self.conv2, n)), 2)
        c, h, w = x.shape[1] // n, x.shape[2], x.shape[3]
        x = x.view(b, n, c, h, w).permute(1, 0, 3, 4, 2).reshape(n, b, h * w * c)  # H,W,C
        dense = [getattr(self, name) for name in _DENSES]
        if self.kernels == "cuda":  # the head kernels take f32
            return fused_mlp3(x.float(), *(t for d in dense for t in (d.kernel, d.bias)))
        cd = self.compute_dtype
        return mlp3_reference(x, *(t.to(cd) for d in dense for t in (d.kernel, d.bias))).float()


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> a state_dict of `Network`, or of
    `ReplicaNetwork` for a tree whose leaves are stacked on a leading axis."""
    state = {}
    for name in _CONVS:
        k = np.asarray(tree[name]["kernel"])  # HWIO, maybe behind a replica axis
        oihw = np.moveaxis(k, (-1, -2), (-4, -3))
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(oihw))
        state[f"{name}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    for name in _DENSES:
        state[f"{name}.kernel"] = torch.from_numpy(np.array(tree[name]["kernel"]))
        state[f"{name}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    return state


def to_jax_params(state) -> dict[str, dict[str, np.ndarray]]:
    """A state_dict of `Network` (or `ReplicaNetwork`: leaves keep the
    replica axis) -> JAX param tree with numpy leaves."""
    host = {k: v.detach().cpu().numpy().copy() for k, v in state.items()}  # never a view
    tree = {}
    for name in _CONVS:
        hwio = np.moveaxis(host[f"{name}.weight"], (-4, -3), (-1, -2))
        tree[name] = {"kernel": np.ascontiguousarray(hwio), "bias": host[f"{name}.bias"]}
    for name in _DENSES:
        tree[name] = {"kernel": host[f"{name}.kernel"], "bias": host[f"{name}.bias"]}
    return tree


def param_count(params) -> int:
    """Total parameter count (reference Network: 62,006). Takes a module or
    a state_dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(int(t.numel()) for t in tensors)


def flops_per_image(num_classes: int = 10) -> float:
    """Analytic forward FLOPs for one 32x32x3 image (2*MACs of convs + head)."""
    conv1 = 2 * 28 * 28 * 6 * (5 * 5 * 3)
    conv2 = 2 * 10 * 10 * 16 * (5 * 5 * 6)
    dense = 2 * (400 * 120 + 120 * 84 + 84 * num_classes)
    return float(conv1 + conv2 + dense)
