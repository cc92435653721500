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

The train step and the eval loss are each one `train/graphs.py` `Program`
over static buffers (tokens, targets and the step's lr and Adam bias
corrections as 0-d f32 tensors), bound to the parameter and optimizer-state
tensors of their first call: on the card a CUDA graph captured at that call
(the counterpart of the JAX package's jitted step and eval), so a step is a
few copies into the buffers and one replay; on the CPU the same function
runs eagerly. The host computes each step's lr and corrections in f32, as
before, and writes them into their buffers; the updates read the buffers,
so graph and eager give the same bits. `_capture = False` before the first
call runs the program eagerly on the card too (the graphed step is held to
that run bit for bit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models import transformer as tfm
from ..ops import flash_attention as fa
from ..ops.adam import B2, EPS, adam_leaf_update, bias_corrections, init_adam
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
from .graphs import Program, capture_all

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
        # the model draws no random numbers: no RNG state to stash (a
        # captured step could not read the generator's state)
        total = total + checkpoint(_chunk_ce, x[:, sl], head, targets[:, sl],
                                   use_reentrant=False, preserve_rng_state=False)
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


class _Captured:
    """One `Program` over static input buffers, built at the first call and
    bound to that call's parameter (and optimizer-state) tensors; captured
    there when `_capture` holds (by default: when the buffers are on the
    card). A capture that fails raises and keeps nothing, so the next call
    starts afresh."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self._capture = None
        self.program = None
        self._bound = None
        self._inputs = None

    def _bind(self, bound, inputs, build) -> bool:
        """At the first call make the static buffers and the program
        (`build(*buffers)`, a function of no arguments) and return True;
        later raise if `bound` or the inputs' shapes are not the first
        call's, before anything is written."""
        first = self.program is None
        if first:
            dev = self.device or bound[0].device
            if self._capture is None:
                self._capture = dev.type == "cuda"
            self._bound = bound
            self._inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs]
            # a replay adds the flash kernels' captured launches to their counters
            self.program = Program(build(*self._inputs), name=self.name,
                                   counters=(fa.LAUNCHES, fa.ROUTE_LAUNCHES))
        elif len(bound) != len(self._bound) or any(a is not b for a, b in zip(bound, self._bound)):
            raise ValueError(f"{self.name} was built over other parameter or optimizer-state "
                             f"tensors; make a new one for these")
        elif any(x.shape != b.shape for x, b in zip(inputs, self._inputs)):
            raise ValueError(f"{self.name} runs at shapes {[tuple(b.shape) for b in self._inputs]}"
                             f", got {[tuple(x.shape) for x in inputs]}")
        return first

    def _run(self, first: bool, inputs, state) -> None:
        """Copy `inputs` into the static buffers and run the program,
        capturing it at the first call (`state`: the tensors the program
        writes, put back after the capture's warm-up)."""
        for b, x in zip(self._inputs, inputs):
            b.copy_(x)
        if first and self._capture:
            try:
                capture_all([self.program], state, self._inputs[0].device)
            except Exception:
                self.program = self._bound = self._inputs = None
                raise
        self.program()


class LMTrainStep(_Captured):
    """`step(params, mom, tokens, targets, step_i=None)` -> loss (0-d f32
    tensor), or (loss, health) with `with_health`; params and optimizer
    state are updated in place. See `make_lm_train_step`."""

    def __init__(self, cfg, *, device, lr, momentum, attn_impl, optimizer, loss_chunks,
                 lr_schedule, clip_norm, accum_steps, weight_decay, with_health):
        super().__init__("the LM train step", device)
        self.cfg, self.lr, self.momentum = cfg, lr, momentum
        self.attn_impl, self.optimizer, self.loss_chunks = attn_impl, optimizer, loss_chunks
        self.lr_schedule, self.clip_norm, self.accum_steps = lr_schedule, clip_norm, accum_steps
        self.weight_decay, self.with_health = weight_decay, with_health
        self._out = {}
        self._scalars = None

    def _build(self, params, mom, tokens, targets):
        """The step's function over the static buffers (closing over no
        reference to this object: a dropped step frees its graph at once)."""
        cfg, attn_impl, loss_chunks = self.cfg, self.attn_impl, self.loss_chunks
        optimizer, momentum, weight_decay = self.optimizer, self.momentum, self.weight_decay
        clip_norm, with_health, out = self.clip_norm, self.with_health, self._out
        accum = self.accum_steps
        lr_t, c1, c2 = self._scalars
        leaves = tree_leaves(params)

        def fn():
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None

            def one(tok, tgt):
                loss = lm_loss(params, tok, tgt, cfg, attn_impl=attn_impl,
                               loss_chunks=loss_chunks)
                loss.backward()
                return loss.detach()

            loss = accumulate_fwd_bwd(one, accum)(leaves, tokens, targets)
            grads = [p.grad for p in leaves]
            norm = None
            if clip_norm > 0.0:
                norm = clip_by_global_norm(grads, clip_norm)
            elif with_health:
                norm = global_norm(grads)
            if optimizer == "adam":
                adam_leaf_update(leaves, grads, mom["m"], mom["v"], c1, c2, lr_t, momentum,
                                 B2, EPS, weight_decay)
            else:
                sgd_step(leaves, mom, grads, lr_t, momentum)
                apply_decoupled_weight_decay(leaves, lr_t, weight_decay)
            for p in leaves:
                p.grad = None
            out["loss"] = loss
            if with_health:
                out["health"] = health_bundle(loss, norm)

        return fn

    def __call__(self, params, mom, tokens, targets, step_i=None):
        leaves = tree_leaves(params)
        bound = leaves + (mom if self.optimizer == "sgd" else mom["m"] + mom["v"])
        if self._scalars is None:
            self._scalars = [torch.zeros((), device=self.device or leaves[0].device)
                             for _ in range(3)]
        first = self._bind(bound, (tokens, targets),
                           lambda tok, tgt: self._build(params, mom, tok, tgt))
        lr_t, c1, c2 = self._scalars
        # the host's f32 values, written into the buffers the updates read
        lr_t.fill_(self.lr if self.lr_schedule is None else self.lr_schedule(step_i))
        if self.optimizer == "adam":
            for buf, c in zip((c1, c2), bias_corrections(mom["t"] + 1, self.momentum, B2)):
                buf.fill_(c)
        self._run(first, (tokens, targets), bound)
        if self.optimizer == "adam":
            mom["t"] += 1
        loss = self._out["loss"].clone()
        if self.with_health:
            return loss, {k: v.clone() for k, v in self._out["health"].items()}
        return loss


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
    with `momentum` as b1. `device`, when given, is where the step's
    buffers live (the parameters' device; by default theirs), into which
    each call copies its tokens and targets. The step is one program, bound
    to the parameter and state tensors and the token shape of its first
    call (a call with others raises), and on the card a CUDA graph.
    """
    _check_optimizer(optimizer)
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"unknown grad_sync {grad_sync!r} (use one of {GRAD_SYNCS})")
    if grad_sync == "overlap":
        raise NotImplementedError(f"grad_sync='overlap' comes with {PARALLEL_SLICE}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    return LMTrainStep(cfg, device=device, lr=lr, momentum=momentum, attn_impl=attn_impl,
                       optimizer=optimizer, loss_chunks=loss_chunks, lr_schedule=lr_schedule,
                       clip_norm=clip_norm, accum_steps=accum_steps,
                       weight_decay=weight_decay, with_health=with_health)


class EvalLoss(_Captured):
    """(params, tokens, targets) -> held-out loss, no gradient: one program
    at the shape of its first call, bound to that call's parameter tensors
    (the JAX CLI's jitted eval)."""

    def __init__(self, cfg, *, attn_impl: str, loss_chunks: int):
        super().__init__("the LM eval loss")
        self.cfg, self.attn_impl, self.loss_chunks = cfg, attn_impl, loss_chunks
        self._out = {}

    def __call__(self, params, tokens, targets):
        cfg, attn_impl, loss_chunks, out = self.cfg, self.attn_impl, self.loss_chunks, self._out

        def build(tok, tgt):
            @torch.no_grad()
            def fn():
                out["loss"] = lm_loss(params, tok, tgt, cfg, attn_impl=attn_impl,
                                      loss_chunks=loss_chunks)

            return fn

        self._run(self._bind(tree_leaves(params), (tokens, targets), build), (tokens, targets),
                  [])
        return out["loss"].clone()


def make_eval_fn(cfg, *, attn_impl: str = "ring", loss_chunks: int = 0):
    """(params, tokens, targets) -> held-out loss, no gradient (`EvalLoss`)."""
    return EvalLoss(cfg, attn_impl=attn_impl, loss_chunks=loss_chunks)
