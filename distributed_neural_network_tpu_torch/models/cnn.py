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
- `kernels="cuda"` runs fc1->fc2->fc3 through the fused head
  (`ops/fused_head.py`); `kernels="torch"` runs its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_head import fused_mlp3, mlp3_reference

KERNELS = ("torch", "cuda")
_CONVS = ("conv1", "conv2")
_DENSES = ("fc1", "fc2", "fc3")


class Dense(nn.Module):
    """kernel (in, out) and bias (out,), like the JAX package's Dense params."""

    def __init__(self, fan_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features))


class Network(nn.Module):
    """The reference's 62,006-parameter CIFAR-10 classifier.

    Input (batch, 32, 32, 3) float32 NHWC; output (batch, 10) logits.
    """

    def __init__(self, num_classes: int = 10, *, kernels: str = "torch",
                 generator: torch.Generator | None = None):
        super().__init__()
        if kernels not in KERNELS:
            raise ValueError(f"kernels must be one of {KERNELS}, got {kernels!r}")
        self.kernels = kernels
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).contiguous()  # H,W,C
        head = fused_mlp3 if self.kernels == "cuda" else mlp3_reference
        return head(
            x, self.fc1.kernel, self.fc1.bias, self.fc2.kernel, self.fc2.bias,
            self.fc3.kernel, self.fc3.bias,
        )


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> this Network's state_dict."""
    state = {}
    for name in _CONVS:
        k = np.asarray(tree[name]["kernel"])  # HWIO
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    for name in _DENSES:
        state[f"{name}.kernel"] = torch.from_numpy(np.array(tree[name]["kernel"]))
        state[f"{name}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    return state


def to_jax_params(state) -> dict[str, dict[str, np.ndarray]]:
    """This Network's state_dict -> JAX param tree with numpy leaves."""
    host = {k: v.detach().cpu().numpy() for k, v in state.items()}
    tree = {}
    for name in _CONVS:
        tree[name] = {
            "kernel": np.ascontiguousarray(host[f"{name}.weight"].transpose(2, 3, 1, 0)),
            "bias": host[f"{name}.bias"],
        }
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
