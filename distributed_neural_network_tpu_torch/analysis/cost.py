"""Bytes of the paged KV pool: the two functions of the JAX package's
`analysis/cost.py` that the serving stack reports occupancy with, and the
dtype table they read (a copy; the rest of that module is slice 5)."""

from __future__ import annotations

DTYPE_BYTES = {
    "f32": 4, "float32": 4, "fp32": 4,
    "bf16": 2, "bfloat16": 2, "f16": 2, "float16": 2,
    "int8": 1, "fp8": 1, "fp8-e4m3": 1, "float8_e4m3fn": 1,
}
# formats that need a dequantization scale riding along
QUANTIZED_DTYPES = ("int8", "fp8", "fp8-e4m3", "float8_e4m3fn")
SCALE_BYTES = 4  # one f32 scale per quantization block


def dtype_bytes(name: str) -> int:
    try:
        return DTYPE_BYTES[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown dtype name {name!r}; known: {', '.join(sorted(DTYPE_BYTES))}"
        ) from None


def kv_block_bytes(n_layers: int, n_heads: int, head_dim: int,
                   block_size: int, dtype: str = "bf16") -> int:
    """Device bytes of ONE paged-KV block: K + V slabs for every layer, plus,
    for quantized dtypes, the per-(block, head) f32 scale pair of each
    layer."""
    elems = 2 * n_layers * block_size * n_heads * head_dim  # K and V
    total = elems * dtype_bytes(dtype)
    if str(dtype) in QUANTIZED_DTYPES:
        total += 2 * n_layers * n_heads * SCALE_BYTES
    return total


def kv_capacity_sequences(usable_blocks: int, block_size: int, seq_len: int) -> int:
    """Concurrent sequences of ``seq_len`` tokens a pool of ``usable_blocks``
    holds."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    blocks_per_seq = -(-seq_len // block_size)
    return usable_blocks // blocks_per_seq
