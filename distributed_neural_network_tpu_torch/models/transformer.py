"""Decoder-only transformer LM: the dense single-device model of the JAX
package's `models/transformer.py`, in PyTorch.

Parameters are a plain dict with the JAX package's layout, so a tree carries
across with no transpose: ``embed`` (V, d), ``head`` (d, V), ``lnf_scale`` /
``lnf_bias`` (d,), and ``layers``, each leaf stacked on a leading layer axis
(L, ...), Dense kernels as (in, out). `from_jax_params` / `to_numpy` carry a
tree across in either direction.

`apply_hidden` / `apply_with_aux` / `apply` are the teacher-forced forward,
differentiable: the f32 master leaves are sliced per layer and cast to the
model dtype inside the graph, so their gradients land in f32. Without a
sequence axis, attention is the plain local attention (`parallel/ring.py`
`attention`) for ``full``, ``ring``, ``ulysses`` and ``zigzag``, or the flash
kernels (`ops/flash.py`) for ``flash``; ``attn_quant`` quantizes the
attention forward. With a sequence axis (``seq_axis``, a `parallel/mesh.py`
`Axis`) tokens are this rank's shard of the sequence, positions global, and
attention is `ring_attention`, `ulysses_attention` or
`zigzag_ring_attention` (the JAX `_attend`, with its two refusals). With a
model axis (``tp_axis``) each rank holds H/tp heads and d_ff/tp hidden
columns (`train/lm.py` `shard_params`): `copy_to_model` enters each
sharded matmul and `reduce_from_model` sums the attention-out and MLP-out
projections (the JAX ``psum(., "model")``). ``remat`` checkpoints every
block (`remat_block`), ``remat_attn`` the attention call alone
(`torch.utils.checkpoint`, without stashing the RNG state: the model draws
no random numbers, and a step captured as a CUDA graph could not read the
generator's state). ``remat_policy`` names what a checkpointed block keeps
(a `jax.checkpoint_policies` name, `REMAT_POLICIES`): torch's selective
activation checkpointing saves the outputs of the matmuls (``aten.mm`` /
``addmm``, and ``bmm`` / ``baddbmm`` under the dots policies that keep
batched products) and recomputes the rest; ``nothing_saveable`` (and no
policy) recomputes the whole block, ``everything_saveable`` recomputes
nothing. The hand-written flash kernels launch outside the dispatcher, so
a policy sees only their outputs' allocations and they are recomputed
under every policy but ``everything_saveable`` (as a JAX dots policy does
not save a ``pallas_call``).
`generate` is the offline cached decode, whose per-step attention runs the
decode kernel (`ops/decode_attention.py`) on a CUDA device and its plain
version on the CPU. The port's seeded `init_params` and sampling draw from
`torch.Generator`s, so they differ from the JAX package's for the same seed.
`param_specs` / `param_skeleton` give the tree's partition specs from the
rule table (`parallel/rules.py`).

Mixture of experts (``n_experts`` > 0, `parallel/moe.py`): every block's
MLP is a routed expert FFN, the leaves ``wr`` (d, E), ``w1`` (E, d, F),
``b1`` (E, F), ``w2`` (E, F, d), ``b2`` (E, d) stacked on the layer axis.
Each rank's capacity comes from its own B x S_local tokens; with an expert
axis (``ep_axis``, the data axis when it has more than one rank) each rank
holds E/dp experts and the tokens cross it by all-to-all. `apply_hidden`
returns the mean over the layers of the blocks' aux losses (0 for a dense
model). `generate` routes through the dense dispatch with a capacity of
the batch, so decoding drops no token, as in JAX.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.decode_attention import (
    decode_cache_attention,
    decode_kernel_ok,
    masked_decode_attention,
)
from ..ops.quant import QUANT_FORMATS, quantized_attention
from ..parallel.collectives import copy_to_model, reduce_from_model
from ..parallel.moe import DISPATCH_IMPLS, expert_capacity, moe_ffn
from ..parallel.ring import (
    attention,
    ring_attention,
    ulysses_attention,
    zigzag_positions,
    zigzag_ring_attention,
)

LAYER_KEYS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
              "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
# a mixture-of-experts layer adds the router
MOE_LAYER_KEYS = LAYER_KEYS + ("wr",)
DECODE_IMPLS = ("auto", "torch", "cuda")
# full/ring/ulysses/zigzag: plain local attention without a sequence axis,
# the sequence-parallel forms with one; flash: the flash kernels (ops/flash.py)
ATTN_IMPLS = ("full", "ring", "ulysses", "zigzag", "flash")
# the attributes of jax.checkpoint_policies (JAX 0.9), kept here: the port
# imports no JAX
REMAT_POLICIES = (
    "checkpoint_dots", "checkpoint_dots_with_no_batch_dims", "dots_saveable",
    "dots_with_no_batch_dims_saveable", "everything_saveable", "nothing_saveable",
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
    "save_any_names_but_these", "save_anything_except_these_names", "save_from_both_policies",
    "save_only_these_names",
)
# the policies the port maps -> what a checkpointed block saves: "dots" (every
# matmul's output), "dots_no_batch" (the products without batch dimensions:
# the 2-D ones; the attention's batched einsums are bmm), "none" (recompute
# the block), "all" (recompute nothing). checkpoint_dots* are JAX's aliases
# of dots_saveable / dots_with_no_batch_dims_saveable.
REMAT_SAVES = {
    "dots_saveable": "dots", "checkpoint_dots": "dots",
    "dots_with_no_batch_dims_saveable": "dots_no_batch",
    "checkpoint_dots_with_no_batch_dims": "dots_no_batch",
    "nothing_saveable": "none", "everything_saveable": "all",
}
# the rest are factories (they take names or memory spaces and return a
# policy); the JAX package, given one bare as a policy, calls it with a
# primitive's parameters and fails at the first step with a TypeError
REMAT_FACTORIES = tuple(n for n in REMAT_POLICIES if n not in REMAT_SAVES)
_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default},
    "dots_no_batch": {_aten.mm.default, _aten.addmm.default},
}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    dtype: torch.dtype = torch.float32
    # checkpoint every block (recomputed in backward)
    remat: bool = False
    # a jax.checkpoint_policies name in the JAX package; "" = save nothing
    remat_policy: str = ""
    # checkpoint only the attention call (ignored with remat)
    remat_attn: bool = False
    # mixture-of-experts FFN in every block (0 = dense); the capacity factor
    # sizes the static slots per expert (parallel/moe.py)
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    # "sort" (add and gather by coordinates) or "dense" (the one-hot oracle)
    moe_dispatch: str = "sort"
    # low-precision attention forward: "" (off), "int8" or "fp8"
    attn_quant: str = ""
    # the router z-loss's weight relative to the load-balancing aux (the
    # loss adds train/lm.py AUX_WEIGHT * (switch_aux + moe_z_weight * mean(lse^2)))
    moe_z_weight: float = 0.1

    def __post_init__(self):
        if self.moe_dispatch not in DISPATCH_IMPLS:
            raise ValueError(f"moe_dispatch must be 'sort' or 'dense', got {self.moe_dispatch!r}")
        if self.remat_policy:
            check_remat_policy(self.remat_policy)
        if self.attn_quant and self.attn_quant not in QUANT_FORMATS:
            raise ValueError(f"attn_quant must be '' or one of {tuple(QUANT_FORMATS)}, "
                             f"got {self.attn_quant!r}")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def check_remat_policy(name: str) -> None:
    """Raise for a name the port does not map: ValueError when it is no
    `jax.checkpoint_policies` name, TypeError for a policy factory."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {name!r} is not a jax.checkpoint_policies name "
                         f"(one of {REMAT_POLICIES})")
    if name in REMAT_FACTORIES:
        raise TypeError(
            f"remat_policy {name!r} is a jax.checkpoint_policies factory: it takes names (or "
            "memory spaces) and returns a policy, and used bare as a policy the JAX package "
            "fails at its first step (TypeError: an unexpected keyword argument); use one of "
            f"{tuple(REMAT_SAVES)}")


def _saving_policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(fn, x, cfg: TransformerConfig):
    """`fn(x)` with its activations recomputed in backward as
    ``cfg.remat_policy`` says (`REMAT_SAVES`; "" = "nothing_saveable"):
    `torch.utils.checkpoint` (no RNG state stashed), with torch's selective
    activation checkpointing saving the matmuls' outputs under the dots
    policies; under "everything_saveable" nothing is recomputed."""
    saves = REMAT_SAVES[cfg.remat_policy or "nothing_saveable"]
    if saves == "all":
        return fn(x)
    kw = {}
    if saves != "none":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_saving_policy, _SAVED_OPS[saves]))
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False, **kw)


def init_params(seed: int, cfg: TransformerConfig, device="cpu"):
    """Seeded random parameters (f32) with the JAX package's shapes and
    scales; the stream is a `torch.Generator`'s, not `jax.random`'s."""
    g = torch.Generator().manual_seed(seed)
    d, f, v, n_l = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    scale = 1.0 / np.sqrt(d)
    w2_scale = 1.0 / np.sqrt(f) / np.sqrt(2 * n_l)

    def dense(shape, s):
        return torch.randn(shape, generator=g) * s

    e = cfg.n_experts
    ex = (e,) if e else ()  # the expert axis of a MoE layer's FFN leaves
    embed, head = dense((v, d), 1.0), dense((d, v), scale)
    layers = {
        "ln1_scale": torch.ones(n_l, d),
        "ln1_bias": torch.zeros(n_l, d),
        "wq": dense((n_l, d, d), scale),
        "wk": dense((n_l, d, d), scale),
        "wv": dense((n_l, d, d), scale),
        "wo": dense((n_l, d, d), scale / np.sqrt(2 * n_l)),
        "ln2_scale": torch.ones(n_l, d),
        "ln2_bias": torch.zeros(n_l, d),
        "w1": dense((n_l, *ex, d, f), scale),
        "b1": torch.zeros(n_l, *ex, f),
        "w2": dense((n_l, *ex, f, d), w2_scale),
        "b2": torch.zeros(n_l, *ex, d),
    }
    if e:
        layers["wr"] = dense((n_l, d, e), scale)
    params = {"embed": embed, "lnf_scale": torch.ones(d), "lnf_bias": torch.zeros(d),
              "head": head, "layers": layers}
    return to_device(params, device)


def param_shapes(cfg: TransformerConfig) -> dict:
    """`init_params`' tree of leaf shapes (tuples), without drawing a
    number: what a template of a checkpoint's parameters needs."""
    d, f, v, n_l, e = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers, cfg.n_experts
    ex = (e,) if e else ()
    layers = {"ln1_scale": (n_l, d), "ln1_bias": (n_l, d), "wq": (n_l, d, d),
              "wk": (n_l, d, d), "wv": (n_l, d, d), "wo": (n_l, d, d), "ln2_scale": (n_l, d),
              "ln2_bias": (n_l, d), "w1": (n_l, *ex, d, f), "b1": (n_l, *ex, f),
              "w2": (n_l, *ex, f, d), "b2": (n_l, *ex, d)}
    if e:
        layers["wr"] = (n_l, d, e)
    return {"embed": (v, d), "lnf_scale": (d,), "lnf_bias": (d,), "head": (d, v),
            "layers": layers}


def param_skeleton(cfg: TransformerConfig):
    """The parameter tree's structure (`init_params`' keys, placeholder
    leaves): what the partition-rule matcher walks when no parameters
    exist yet."""
    return {"embed": 0, "lnf_scale": 0, "lnf_bias": 0, "head": 0,
            "layers": dict.fromkeys(MOE_LAYER_KEYS if cfg.n_experts else LAYER_KEYS, 0)}


def param_specs(cfg: TransformerConfig, tp_axis: str | None = None,
                ep_axis: str | None = None, rules=None):
    """The parameter tree's `PartitionSpec`s from the partition-rule table
    (`parallel/rules.py` `lm_partition_rules`), or from ``rules``, a custom
    ordered ``(regex, PartitionSpec)`` list (``--sharding rules:<file>``),
    which every leaf must match."""
    from ..parallel.rules import lm_partition_rules, match_partition_rules

    if rules is None:
        rules = lm_partition_rules(tp_axis=tp_axis, ep_axis=ep_axis, n_experts=cfg.n_experts)
    return match_partition_rules(rules, param_skeleton(cfg), skip_scalars=False)


def to_device(params, device):
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)


def from_jax_params(tree, device="cpu"):
    """A JAX parameter tree (numpy or jax leaves, same layout) as f32 torch tensors."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def to_numpy(params):
    """The parameter dict as a tree of f32 numpy arrays (the JAX layout)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def layer_params(params, cfg: TransformerConfig) -> list[dict]:
    """One dict per layer, its weight matrices cast to the model dtype (the
    casts the JAX package repeats inside every step, done once)."""
    return [_layer(params, i, cfg.dtype) for i in range(cfg.n_layers)]


def _layer(params, i: int, dt):
    """Layer i's params, its weight matrices cast to the model dtype (a MoE
    router ``wr`` stays f32: routing runs in f32)."""
    lp = {k: x[i] for k, x in params["layers"].items()}
    for k in ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2"):
        lp[k] = lp[k].to(dt)
    return lp


# ------------------------------------------------------------------ pieces


def _layer_norm(x, scale, bias, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def _sinusoid_pe(pos, d_model, dtype):
    """Sin then cos (concatenated, not interleaved), as the JAX package."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    ang = pos[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def gelu(x):
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_residual(x, lp, dt, tp_axis=None):
    """x + MLP(LN2(x)), in the JAX package's order of operations; with
    `tp_axis`, w1/b1 hold this rank's columns and w2 its rows, and the
    output is summed over the model axis before b2 is added."""
    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"]).to(dt)
    h = gelu(copy_to_model(h, tp_axis) @ lp["w1"] + lp["b1"])
    return x + reduce_from_model(h @ lp["w2"], tp_axis) + lp["b2"]


def moe_residual(x, lp, cfg: TransformerConfig, *, capacity: int, ep_axis=None, tp_axis=None,
                 dispatch_impl: str | None = None, z_loss_weight: float | None = None):
    """(x + MoE(LN2(x)), aux) for x (..., d): the block's routed FFN
    (`parallel/moe.py` `moe_ffn`) over the flattened tokens, with the
    config's top-k, dispatch and z-loss weight unless given."""
    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"]).to(cfg.dtype)
    y, aux = moe_ffn(
        h.reshape(-1, cfg.d_model), lp["wr"], lp["w1"], lp["b1"], lp["w2"], lp["b2"],
        top_k=cfg.moe_top_k, capacity=capacity, ep_axis=ep_axis, tp_axis=tp_axis,
        dispatch_impl=dispatch_impl or cfg.moe_dispatch,
        z_loss_weight=cfg.moe_z_weight if z_loss_weight is None else z_loss_weight)
    return x + y.reshape(x.shape), aux


def resolve_decode_impl(impl: str, device: torch.device) -> str:
    """`auto` -> `cuda` on a CUDA device, `torch` on the CPU; `cuda` on the
    CPU raises (the port never runs a kernel's plain version in its stead)."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"decode impl must be one of {DECODE_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"decode impl 'cuda' needs a CUDA device, got {device}")
    return impl


# ------------------------------------------------------------- the forward


def _positions(s_local: int, seq_axis, attn_impl: str, device):
    """Global positions of this rank's rows (the JAX `_positions`)."""
    if seq_axis is None:
        return torch.arange(s_local, device=device)
    if attn_impl == "zigzag":
        return zigzag_positions(s_local, seq_axis, device=device)
    return seq_axis.index * s_local + torch.arange(s_local, device=device)


def _attend_fn(attn_impl: str, cfg: TransformerConfig, seq_axis=None):
    """(q, k, v) (B, S_local, H_local, Dh) -> (B, S_local, H_local, Dh): the
    JAX `_attend`, wrapped in a checkpoint under ``remat_attn``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    quant = cfg.attn_quant or None
    if seq_axis is not None:
        if quant:
            raise ValueError(
                f"attn_quant={quant!r} is the local quantized path; a sequence axis "
                "(ring/ulysses/zigzag) has no quantized attention - drop the seq axis or "
                "attn_quant")
        if attn_impl == "flash":
            raise ValueError(
                "attn impl 'flash' is the local kernel (no sequence axis); use "
                "'ring'/'ulysses'/'zigzag' for sequence parallelism")
        if attn_impl == "full":
            raise ValueError(
                f"with a sequence axis, attn impl must be 'ring', 'ulysses' or 'zigzag', got "
                f"{attn_impl!r}")
        if attn_impl == "ring":
            def attend(q, k, v):
                return ring_attention(q, k, v, seq_axis, causal=True)
        elif attn_impl == "ulysses":
            def attend(q, k, v):
                return ulysses_attention(q, k, v, seq_axis, causal=True)
        else:
            def attend(q, k, v):
                return zigzag_ring_attention(q, k, v, seq_axis)
    elif attn_impl == "flash":
        from ..ops.flash import flash_local_attention

        def attend(q, k, v):
            return flash_local_attention(q, k, v, causal=True, quant=quant)
    elif quant:
        def attend(q, k, v):
            return quantized_attention(q, k, v, causal=True, fmt=quant)
    else:
        def attend(q, k, v):
            return attention(q, k, v, causal=True)
    if cfg.remat_attn and not cfg.remat:
        return lambda q, k, v: checkpoint(attend, q, k, v, use_reentrant=False,
                                          preserve_rng_state=False)
    return attend


def transformer_block(x, lp, cfg: TransformerConfig, attend, tp_axis=None, ep_axis=None,
                      capacity: int | None = None):
    """One pre-norm block on x (B, S_local, d) with the layer's params `lp`
    (weights already in the model dtype), in the JAX package's order of
    operations: (x, aux), aux the MoE block's load-balancing loss (None for
    a dense block). The local head count comes from wq's columns (H/tp
    under a model axis); a MoE block routes its B x S_local tokens into
    `capacity` slots an expert."""
    dt = cfg.dtype
    b, s = x.shape[:2]
    d_h = cfg.head_dim
    h_n = lp["wq"].shape[-1] // d_h
    h = copy_to_model(_layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]).to(dt), tp_axis)
    q = (h @ lp["wq"]).reshape(b, s, h_n, d_h)
    k = (h @ lp["wk"]).reshape(b, s, h_n, d_h)
    v = (h @ lp["wv"]).reshape(b, s, h_n, d_h)
    o = attend(q, k, v)
    x = x + reduce_from_model(o.reshape(b, s, -1) @ lp["wo"], tp_axis)
    if cfg.n_experts:
        return moe_residual(x, lp, cfg, capacity=capacity, ep_axis=ep_axis, tp_axis=tp_axis)
    return mlp_residual(x, lp, dt, tp_axis), None


def apply_hidden(params, tokens, cfg: TransformerConfig, *, seq_axis=None, tp_axis=None,
                 ep_axis=None, attn_impl: str = "ring"):
    """tokens (B, S_local) -> (final-layer-norm hidden (B, S_local, d) in the
    model dtype, aux): aux the mean over the layers of the MoE blocks'
    load-balancing losses (0-d f32; 0 for a dense model). `seq_axis` /
    `tp_axis` / `ep_axis`: the mesh's sequence, model and expert axes
    (`ProcessMesh` axes, None when 1), as the JAX signature's axis names.

    Differentiable with respect to the f32 leaves of `params`. The vocab
    projection is left to the caller (the chunked loss never forms the
    whole (B, S, vocab) logits)."""
    dt = cfg.dtype
    b, s = tokens.shape
    attend = _attend_fn(attn_impl, cfg, seq_axis)
    cap = (expert_capacity(b * s, cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor)
           if cfg.n_experts else None)
    x = params["embed"][tokens].to(dt)
    x = x + _sinusoid_pe(_positions(s, seq_axis, attn_impl, tokens.device), cfg.d_model,
                         dt)[None]
    auxes = []
    for i in range(cfg.n_layers):
        def block(x, i=i):
            return transformer_block(x, _layer(params, i, dt), cfg, attend, tp_axis, ep_axis, cap)

        x, aux = remat_block(block, x, cfg) if cfg.remat else block(x)
        auxes.append(aux)
    aux = (torch.stack(auxes).mean() if cfg.n_experts
           else torch.zeros((), device=tokens.device))
    return _layer_norm(x, params["lnf_scale"], params["lnf_bias"]).to(dt), aux


def apply_with_aux(params, tokens, cfg: TransformerConfig, *, seq_axis=None, tp_axis=None,
                   ep_axis=None, attn_impl: str = "ring"):
    """tokens (B, S_local) -> (logits (B, S_local, vocab) f32, aux): aux the
    mean MoE load-balancing loss over the layers (0.0 for a dense model)."""
    x, aux = apply_hidden(params, tokens, cfg, seq_axis=seq_axis, tp_axis=tp_axis,
                          ep_axis=ep_axis, attn_impl=attn_impl)
    logits = (x @ params["head"].to(cfg.dtype)).float()
    return logits, aux


def apply(params, tokens, cfg: TransformerConfig, *, seq_axis=None, tp_axis=None,
          ep_axis=None, attn_impl: str = "ring"):
    """tokens (B, S_local) int -> logits (B, S_local, vocab) f32."""
    return apply_with_aux(params, tokens, cfg, seq_axis=seq_axis, tp_axis=tp_axis,
                          ep_axis=ep_axis, attn_impl=attn_impl)[0]


# --------------------------------------------------------------- inference


def _filter_logits(logits, temperature: float, top_k: int, top_p: float):
    """The JAX package's top-k then nucleus cut; both keep the top-1."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        p_srt = torch.softmax(srt / temperature, dim=-1)
        keep = (torch.cumsum(p_srt, dim=-1) - p_srt) < top_p
        cutoff = torch.where(keep, srt, math.inf).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def sample_gumbel(logits, temperature: float, uniform):
    """argmax(logits / t + Gumbel noise) from uniform draws of the same shape:
    a categorical sample whose randomness the caller supplies."""
    u = uniform.clamp(1e-20, 1.0 - 1e-7)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate(
    params,
    prompt,
    cfg: TransformerConfig,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_lens=None,
    decode_impl: str = "auto",
):
    """Autoregressive decoding with per-layer KV caches.

    prompt (B, S_p) int on the parameters' device -> (B, S_p +
    max_new_tokens) int64: the prompt followed by the generated tokens.
    temperature 0 is greedy argmax; > 0 samples from softmax(logits / t)
    after the top-k and nucleus (top_p) cuts, with uniform draws from
    `generator` (a CPU `torch.Generator`, required then). ``prompt_lens``
    (B,) makes the batch left-padded, as in the JAX package (plain route
    only: the kernel masks on the position alone).

    The prompt goes through the same cached step as generation, one token
    at a time, over a static cache of S_p + max_new_tokens slots. The
    logits are the serving engine's: the model-dtype hidden state times the
    model-dtype head, accumulated and kept in f32. (The JAX package's
    generate rounds them to the model dtype, where near-ties then break by
    index; at bf16 that alone changes a greedy stream that the engine does
    not. At f32 the two are the same.)
    ``decode_impl``: ``cuda`` runs every step's attention in the decode
    kernel, ``torch`` in its plain version, ``auto`` picks ``cuda`` on a
    CUDA device.
    """
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 sampling requires `generator`")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    dev = prompt.device
    impl = resolve_decode_impl(decode_impl, dev)
    dt = cfg.dtype
    b, s_p = prompt.shape
    n_h, d_h = cfg.n_heads, cfg.head_dim
    total = s_p + max_new_tokens
    offsets = None
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, dtype=torch.int64, device=dev)
        if tuple(lens.shape) != (b,) or bool((lens < 1).any() or (lens > s_p).any()):
            raise ValueError(f"prompt_lens must be ({b},) values in [1, {s_p}]")
        if impl == "cuda":
            raise ValueError("decode impl 'cuda' does not take left-padded batches "
                             "(prompt_lens): the kernel masks on the position alone")
        offsets = s_p - lens
    if impl == "cuda" and not decode_kernel_ok(d_h):
        raise ValueError(f"head dim {d_h} is outside the decode kernel's range")
    layers = layer_params(params, cfg)
    head = params["head"].to(dt)
    cache_k = [torch.zeros(b, n_h, total, d_h, dtype=dt, device=dev) for _ in layers]
    cache_v = [torch.zeros(b, n_h, total, d_h, dtype=dt, device=dev) for _ in layers]
    pe_all = _sinusoid_pe(torch.arange(total, device=dev), cfg.d_model, dt)
    cols = torch.arange(total, device=dev)
    out = torch.zeros(b, total, dtype=torch.int64, device=dev)
    out[:, :s_p] = prompt
    for pos in range(total - 1):
        tok = out[:, pos]
        if offsets is None:
            pe = pe_all[pos][None]
        else:
            pe = pe_all[torch.clamp(pos - offsets, min=0)]
        x = params["embed"][tok].to(dt) + pe  # (B, d)
        for lp, ck, cv in zip(layers, cache_k, cache_v):
            h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]).to(dt)
            q = (h @ lp["wq"]).reshape(b, n_h, d_h)
            ck[:, :, pos] = (h @ lp["wk"]).reshape(b, n_h, d_h)
            cv[:, :, pos] = (h @ lp["wv"]).reshape(b, n_h, d_h)
            if impl == "cuda":
                o = decode_cache_attention(q, ck, cv, pos)
            else:
                live = (cols <= pos)[None].expand(b, total)
                if offsets is not None:
                    live = live & (cols[None, :] >= offsets[:, None])
                o = masked_decode_attention(q, ck, cv, live)
            x = x + o.reshape(b, -1) @ lp["wo"]
            if cfg.n_experts:
                # the dense dispatch at a capacity of the batch: decoding
                # never drops a token (the teacher-forced forward can)
                x = moe_residual(x, lp, cfg, capacity=b, dispatch_impl="dense",
                                 z_loss_weight=0.0)[0]
            else:
                x = mlp_residual(x, lp, dt)
        if pos < s_p - 1:
            continue  # a prompt position: its prediction is discarded
        h = _layer_norm(x, params["lnf_scale"], params["lnf_bias"]).to(dt)
        logits = h.float() @ head.float()
        if temperature > 0.0:
            logits = _filter_logits(logits, temperature, top_k, top_p)
            u = torch.rand(logits.shape, generator=generator).to(dev)
            nxt = sample_gumbel(logits, temperature, u)
        else:
            nxt = torch.argmax(logits, dim=-1)
        out[:, pos + 1] = nxt
    return out

