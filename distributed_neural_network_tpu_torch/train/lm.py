"""LM training for one device: the port of the JAX package's `train/lm.py`
(`make_copy_task`, `auto_loss_chunks`, `_ce_sum_chunked`, `lm_loss`,
`init_lm_momentum`, `make_lm_train_step`) for the single-device dense case.

Parameters are the transformer's dict of f32 master tensors
(`models/transformer.py`); the optimizer state is a list per leaf in
`tree_leaves` order (the JAX package's sorted-key order, so a JAX momentum
tree carries across leaf by leaf). The step updates parameters and state in
place, as the CNN port does, where the JAX step returns new trees. Meshes,
ZeRO and the overlapped gradient sync come with the parallel layouts; the
guard, fault plans and dynamics with slice 4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models import transformer as tfm
from ..ops.adam import adam_step, init_adam
from ..ops.schedule import (
    GRAD_SYNCS,
    accumulate_fwd_bwd,
    apply_decoupled_weight_decay,
    clip_by_global_norm,
    global_norm,
    health_bundle,
)
from ..ops.sgd import init_momentum, sgd_step
from ..parallel.ring import PARALLEL_SLICE

OPTIMIZERS = ("sgd", "adam", "zero", "zero-adam")


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (`jax.tree.leaves`')."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A dict shaped as `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def make_copy_task(generator: torch.Generator, *, batch: int, seq_len: int, vocab: int,
                   device="cpu"):
    """Synthetic copy task: the second half of each sequence repeats the
    first; targets are the sequence rolled by one (the last position's
    wrapped target is consistent noise). (tokens, targets) int64 (B, S).
    The stream is a `torch.Generator`'s, not `jax.random`'s."""
    half = (seq_len + 1) // 2
    first = torch.randint(2, vocab, (batch, half), generator=generator)
    seq = torch.cat([first, first], dim=1)[:, :seq_len]
    return seq.to(device), torch.roll(seq, -1, dims=1).to(device)


def auto_loss_chunks(b: int, s: int, vocab: int) -> int:
    """Smallest chunk count dividing S that bounds one chunk's f32 logits
    ((b, s/c, vocab)) to ~64 MB; 1 when the single pass already fits."""
    budget = 64 * 2**20 // 4
    for c in range(1, s + 1):
        if s % c == 0 and b * (s // c) * vocab <= budget:
            return c
    return s


def _chunk_ce(xc, head, tc):
    logp = F.log_softmax((xc @ head).float(), dim=-1)
    return -logp.gather(-1, tc[..., None])[..., 0].sum()


def _ce_sum_chunked(x, head, targets, n_chunks: int):
    """Sum of next-token CE over all positions in `n_chunks` sequence chunks,
    each under `torch.utils.checkpoint`: a chunk's (B, S/n, V) f32 logits
    exist only while that chunk runs, forward and backward."""
    s = x.shape[1]
    if s % n_chunks:
        raise ValueError(f"loss chunks {n_chunks} must divide the sequence length {s}")
    cs = s // n_chunks
    head = head.to(x.dtype)
    total = torch.zeros((), device=x.device)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(_chunk_ce, x[:, sl], head, targets[:, sl],
                                   use_reentrant=False)
    return total


def lm_loss(params, tokens, targets, cfg, *, attn_impl: str = "ring", loss_chunks: int = 0):
    """Mean next-token cross-entropy over the batch's tokens. loss_chunks > 1
    chunks the CE along the sequence; 0 picks the chunking that bounds a
    chunk's logits to ~64 MB; 1 is a single pass."""
    x = tfm.apply_hidden(params, tokens, cfg, attn_impl=attn_impl)
    b, s = tokens.shape
    if loss_chunks == 0:
        loss_chunks = auto_loss_chunks(b, s, cfg.vocab_size)
    if loss_chunks > 1:
        total = _ce_sum_chunked(x, params["head"], targets, loss_chunks)
    else:
        total = _chunk_ce(x, params["head"].to(cfg.dtype), targets)
    return total / float(b * s)


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r} (use one of {OPTIMIZERS})")
    if optimizer.startswith("zero"):
        raise NotImplementedError(f"optimizer {optimizer!r} shards its state over a data "
                                  f"axis; it comes with {PARALLEL_SLICE}")


def init_lm_momentum(params, optimizer: str = "sgd"):
    """Optimizer state for `make_lm_train_step(optimizer=...)`: zero
    momentum per leaf (sgd) or Adam's {m, v, t} (adam)."""
    _check_optimizer(optimizer)
    leaves = tree_leaves(params)
    return init_momentum(leaves) if optimizer == "sgd" else init_adam(leaves)


def make_lm_train_step(cfg, *, device=None, lr: float = 0.1, momentum: float = 0.9,
                       attn_impl: str = "ring", optimizer: str = "sgd", loss_chunks: int = 0,
                       lr_schedule=None, clip_norm: float = 0.0, accum_steps: int = 1,
                       weight_decay: float = 0.0, with_health: bool = False,
                       grad_sync: str = "end"):
    """`step(params, mom, tokens, targets, step_i=None)` -> loss (0-d f32
    tensor), or (loss, health) with `with_health`; params and optimizer
    state are updated in place.

    The JAX package's single-device step in its order: forward + backward
    (accumulated over `accum_steps` micro-batches of B/k rows, mean
    gradient), clip by global norm (`clip_norm` > 0; the health norm is the
    pre-clip one), lr from `lr_schedule(step_i)` (a callable, e.g.
    `functools.partial(warmup_cosine, ...)`) or `lr`, then the optimizer:
    SGD with momentum followed by decoupled weight decay, or Adam/AdamW
    with `momentum` as b1. `device`, when given, is where the step moves
    tokens and targets.
    """
    _check_optimizer(optimizer)
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"unknown grad_sync {grad_sync!r} (use one of {GRAD_SYNCS})")
    if grad_sync == "overlap":
        raise NotImplementedError(f"grad_sync='overlap' comes with {PARALLEL_SLICE}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    device = None if device is None else torch.device(device)

    def step(params, mom, tokens, targets, step_i=None):
        if device is not None:
            tokens, targets = tokens.to(device), targets.to(device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None

        def one(tok, tgt):
            loss = lm_loss(params, tok, tgt, cfg, attn_impl=attn_impl, loss_chunks=loss_chunks)
            loss.backward()
            return loss.detach()

        loss = accumulate_fwd_bwd(one, accum_steps)(leaves, tokens, targets)
        grads = [p.grad for p in leaves]
        norm = None
        if clip_norm > 0.0:
            norm = clip_by_global_norm(grads, clip_norm)
        elif with_health:
            norm = global_norm(grads)
        lr_t = lr if lr_schedule is None else lr_schedule(step_i)
        if optimizer == "adam":
            adam_step(leaves, mom, grads, lr_t, b1=momentum, weight_decay=weight_decay)
        else:
            sgd_step(leaves, mom, grads, lr_t, momentum)
            apply_decoupled_weight_decay(leaves, lr_t, weight_decay)
        for p in leaves:
            p.grad = None
        return (loss, health_bundle(loss, norm)) if with_health else loss

    return step


def make_eval_fn(cfg, *, attn_impl: str = "ring", loss_chunks: int = 0):
    """(params, tokens, targets) -> held-out loss, no gradient."""

    @torch.no_grad()
    def eval_loss(params, tokens, targets):
        return lm_loss(params, tokens, targets, cfg, attn_impl=attn_impl,
                       loss_chunks=loss_chunks)

    return eval_loss
