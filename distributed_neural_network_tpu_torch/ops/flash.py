"""Flash attention dispatch for local (single-device) attention: the port of
the JAX package's `ops/flash.py` `flash_local_attention`.

- ``own`` (the default): the port's own kernels (`ops/flash_attention.py`,
  hand-written CUDA) on a CUDA device, their plain versions on the CPU;
  ``quant`` selects the quantized forward.
- ``lib``: `torch.nn.functional.scaled_dot_product_attention`, standing in
  for the JAX package's library-kernel A/B baseline. Chosen only by an
  explicit ``impl="lib"`` argument (no environment variable can swap it in
  under ``--attn flash``); it has no quantized path.

The JAX package's TPU block tunings (`FlashBlocks`, `tuned_blocks`,
`tools/flash_tune_TPU_*.json`) do not apply: the port's tiles are the
kernels' own constants.
"""

from __future__ import annotations

import torch.nn.functional as F

from .flash_attention import flash_mha
from .quant import QUANT_FORMATS

FLASH_IMPLS = ("own", "lib")


def flash_local_attention(q, k, v, *, causal: bool = True, impl: str = "own",
                          quant: str | None = None):
    """q/k/v (B, S, H, D) -> (B, S, H, D) through the port's flash kernels
    (``impl="own"``) or SDPA (``impl="lib"``). ``quant`` ("int8" | "fp8")
    runs the quantized forward; the library route rejects it."""
    if impl not in FLASH_IMPLS:
        raise ValueError(f"unknown flash impl {impl!r} (use 'own' or 'lib')")
    if quant is not None:
        if quant not in QUANT_FORMATS:
            raise ValueError(f"unknown quant format {quant!r}; supported: "
                             f"{', '.join(QUANT_FORMATS)}")
        if impl == "lib":
            raise ValueError("the library flash kernel has no quantized path; use "
                             "impl='own' (default) for attn quantization")
    if impl == "lib":
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), is_causal=causal)
        return o.transpose(1, 2)
    return flash_mha(q, k, v, causal=causal, quant=quant)
