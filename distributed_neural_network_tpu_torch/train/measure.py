"""Model FLOPs and the card's peak rates for the LM trainer's MFU line: the
port of `model_flops_per_token` from the JAX package's `train/measure.py`,
with an H100 peak table in place of its TPU one.

Peaks are NVIDIA's H100 SXM data sheet, dense (no sparsity), at the full
700 W power limit: 989 TFLOP/s bf16 on the tensor cores; 67 TFLOP/s f32 on
the CUDA cores. The port leaves `torch.backends.cuda.matmul.allow_tf32` at
PyTorch's default (False), so an f32 run's matmuls are full f32 and its MFU
is taken against the 67 TFLOP/s f32 peak, not TF32's 495. A card set below
700 W runs slower under load; callers print its power limit beside the MFU.
"""

from __future__ import annotations

# device-name substring -> {dtype: peak FLOP/s}
PEAK_FLOPS = {
    "H100": {"bfloat16": 989e12, "float32": 67e12},
}


def peak_flops(device_kind: str, dtype: str = "bfloat16") -> float | None:
    """Per-device peak FLOP/s for the MFU denominator; None for a device
    (the CPU, say) without an entry."""
    for name, peaks in PEAK_FLOPS.items():
        if name in device_kind:
            return peaks.get(dtype)
    return None


def model_flops_per_token(cfg, seq_len: int) -> float:
    """Model FLOPs per trained token (forward + 2x backward), PaLM-appendix
    style: per layer 8 d^2 (QKV and out projections) + 4 seq d (attention
    scores and values, causal not halved) + 4 d ff (MLP; for MoE, the top-k
    activated experts), plus 2 d vocab for the head. Rematerialisation is
    not counted."""
    d, f, v, n_l = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    mlp = 4 * d * f * (cfg.moe_top_k if cfg.n_experts else 1)
    per_layer = 8 * d * d + 4 * seq_len * d + mlp
    return 3.0 * (n_l * per_layer + 2 * d * v)
