"""Device resolution: the port runs on the GPU unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`"cuda"` (the default everywhere in the port), `"cuda:N"` or `"cpu"`.

    Asking for CUDA where `torch.cuda.is_available()` is False raises: the
    port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu (device='cpu') to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {str(dev)!r}")
    return dev
