"""LM training: the port of the JAX package's `train/lm.py`
(`create_lm_mesh`, `shard_params`, `make_copy_task`, `auto_loss_chunks`,
`_ce_sum_chunked`, `lm_loss`, `optimizer_state_specs`, `init_lm_momentum`,
`lm_wiring`, `make_lm_shardings`, `make_lm_train_step`) for one device and
for data parallelism over a process group.

Parameters are the transformer's dict of f32 master tensors
(`models/transformer.py`); the optimizer state is a list per leaf in
`tree_leaves` order (the JAX package's sorted-key order, so a JAX momentum
tree carries across leaf by leaf), or, under ZeRO-1, this rank's shard of
each padded leaf (`parallel/zero.py`). The step updates parameters and state
in place, as the CNN port does, where the JAX step returns new trees.

The data axis (`create_lm_mesh(dp)`, a `parallel/mesh.py` `ProcessMesh`):
``--dp N`` is N ranks of one torch.distributed group, one rank a data shard
(the JAX mesh over N devices). Each rank feeds the step its contiguous block
of B/dp rows of the global batch (`parallel/distributed.py`
`distribute_host_data`, the rows JAX's ``P("data")`` gives device r), takes
the mean loss over it, and the gradients are averaged over the group; the
loss the step returns is the group mean. Gradient sync:

- ``grad_sync="end"``: after the last micro-batch the gradients (and the
  loss) are packed into one flat buffer and all-reduced once;
- ``grad_sync="overlap"`` with accum_steps > 1: every micro-batch's
  gradients are packed into size-capped leaf buckets (`plan_buckets`,
  leaves grouped by PartitionSpec as in JAX) and reduced per bucket right
  after its backward (`ops/schedule.py` `overlap_parts`): all-reduced, or
  under ZeRO reduce-scattered into this rank's shards and all-gathered
  after the last one. At accum_steps = 1 there is nothing to overlap and the
  end schedule runs (bitwise).
- ``optimizer="zero"|"zero-adam"``: each rank updates only its shards of the
  summed gradient and the parameters are all-gathered
  (`parallel/zero.py` `make_zero_split_step`): bitwise the replicated sgd /
  adam step.

The step and the eval loss are each one `train/graphs.py` `Program` over
static buffers (tokens, targets, the step's lr and Adam bias corrections as
0-d f32 tensors, the gradient and bucket buffers), bound to the parameter
and optimizer-state tensors of their first call: on the card CUDA graphs
captured at that call (the counterpart of the JAX package's jitted step and
eval); on the CPU the same functions run eagerly. Collectives under NCCL
are captured with the rest, so the step stays one graph; under gloo (ranks
that share a card, and the CPU) a collective cannot be captured and runs
eagerly between the graphs (`Eager` parts), one graph part per micro-batch
under overlap. The host computes each step's lr and corrections in f32 and
writes them into their buffers; graph and eager give the same bits.
`_capture = False` before the first call runs the program eagerly on the
card too. Sequence, tensor and pipeline axes, MoE, the guard, fault plans
and dynamics come later (ROADMAP Queue 1 items 3-4).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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
    overlap_parts,
)
from ..ops.sgd import init_momentum, sgd_step
from ..parallel import zero
from ..parallel.collectives import COLLECTIVE_FORMS, BucketReducer, plan_buckets
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, NamedSharding, ProcessMesh
from ..parallel.partition import PartitionSpec as P
from ..parallel.partition import spec_axes, validate_spec_tree
from ..parallel.ring import PARALLEL_SLICE
# tree_leaves / tree_unflatten: the step's leaf order, which callers read here
from ..utils.tree import tree_leaves, tree_map, tree_unflatten  # noqa: F401
from .graphs import Eager, Program, capture_all

OPTIMIZERS = ("sgd", "adam", "zero", "zero-adam")


def create_lm_mesh(dp: int = 1, sp: int = 1, tp: int = 1, *, device="cuda") -> ProcessMesh:
    """The (dp, sp, tp) layout over the process group this process joined
    (`parallel/distributed.py` `initialize`), or over this process alone at
    dp 1: dp must be the group's world size. Only the data axis is ported;
    sp or tp above 1 raise."""
    from ..device import resolve_device
    from ..parallel.distributed import joined, rank_device

    if sp != 1 or tp != 1:
        raise NotImplementedError(f"a sequence or tensor axis (sp={sp}, tp={tp}) comes with "
                                  f"{PARALLEL_SLICE}; the port's mesh has the data axis only")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    dev = resolve_device(device)
    world = dist.get_world_size() if joined() else 1
    if dp != world:
        raise ValueError(
            f"--dp {dp} needs a process group of {dp} ranks, one a data shard; this process is "
            f"in a world of {world}. Start it as: python -m torch.distributed.run --standalone "
            f"--nproc-per-node {dp} -m distributed_neural_network_tpu_torch.lm_train --dp {dp} "
            "...")
    if not joined():
        return ProcessMesh(1, dev)
    return ProcessMesh(dp, rank_device(dev), rank=dist.get_rank(), joined=True)


def shard_params(params, cfg, mesh: ProcessMesh, rules=None):
    """(params on the mesh's device, their specs): the replicated layout
    the data axis keeps (`param_specs`, or ``rules``); a spec that shards a
    leaf over an axis of more than one rank raises (tensor-sharded leaves
    come with TP)."""
    specs = _param_specs(cfg, mesh, rules)
    return tfm.to_device(params, mesh.device), specs


def _param_specs(cfg, mesh, rules):
    specs = tfm.param_specs(cfg, rules=rules)
    for path, spec in _named_specs(specs):
        wide = [a for a in spec_axes(spec) if mesh.shape.get(a, 1) > 1]
        if wide:
            raise NotImplementedError(
                f"the partition rules shard {path!r} as {spec} over {wide}; sharded "
                f"parameters come with tensor parallelism ({PARALLEL_SLICE}) - the data axis "
                "keeps every leaf replicated")
    return specs


def _named_specs(specs):
    from ..parallel.rules import named_leaves

    return named_leaves(specs, is_leaf=lambda s: isinstance(s, P))


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


def optimizer_state_specs(optimizer: str, specs):
    """The optimizer state's specs, in the shape of `init_lm_momentum`'s
    state: sgd mirrors the parameters' specs; adam holds {"m", "v"} of them
    and a replicated counter; the zero variants shard every flat buffer
    over the data axis."""
    _check_optimizer(optimizer)
    if optimizer == "sgd":
        return specs
    if optimizer == "adam":
        return {"m": specs, "v": specs, "t": P()}
    shard = tree_map(lambda _: P(DATA_AXIS), specs)
    return shard if optimizer == "zero" else {"m": shard, "v": shard, "t": P()}


def init_lm_momentum(params, optimizer: str = "sgd", mesh: ProcessMesh | None = None):
    """Optimizer state for `make_lm_train_step(optimizer=...)`, a list per
    leaf in `tree_leaves` order: zero momentum (sgd), Adam's {m, v, t}
    (adam), or this rank's (pad(leaf)/dp,) shard of each (zero: momentum;
    zero-adam: m and v, and t) over `mesh`'s data axis (dp 1 without one)."""
    _check_optimizer(optimizer)
    leaves = tree_leaves(params)
    if optimizer == "sgd":
        return init_momentum(leaves)
    if optimizer == "adam":
        return init_adam(leaves)
    dp = mesh.dp if mesh is not None else 1
    if optimizer == "zero":
        return zero.init_zero_momentum_tree(leaves, dp)
    return zero.init_zero_adam_tree(leaves, dp)


def lm_wiring(cfg, mesh: ProcessMesh, optimizer: str = "sgd", rules=None):
    """(sp, tp, ep, sync_axes, specs, mom_spec, data_spec) for the mesh:
    the one derivation of axes and specs the step uses. The parameters'
    specs come from the rule table (or ``rules``, the ``--sharding
    rules:<file>`` path) and every spec is checked against the mesh's axes
    up front; the data axis keeps every leaf replicated, which the zero
    optimizers require."""
    _check_optimizer(optimizer)
    specs = _param_specs(cfg, mesh, rules)
    if rules is not None and optimizer.startswith("zero"):
        sharded = [(path, s) for path, s in _named_specs(specs)
                   if any(e is not None for e in tuple(s))]
        if sharded:
            raise ValueError(
                f"optimizer={optimizer!r} requires fully replicated param specs (the flat ZeRO "
                f"buffers shard over the data axis), but the rules file shards "
                f"{sharded[0][0]!r} as {sharded[0][1]} ({len(sharded)} sharded leaf/leaves "
                "total) - use 'sgd'/'adam' with sharded rules")
    mom_spec = optimizer_state_specs(optimizer, specs)
    data_spec = P(DATA_AXIS, SEQ_AXIS)
    axes = mesh.shape
    validate_spec_tree(specs, axes, root="params")
    validate_spec_tree(mom_spec, axes, root="optimizer state")
    validate_spec_tree(data_spec, axes, root="tokens")
    sync_axes = (DATA_AXIS, SEQ_AXIS)
    return None, None, None, sync_axes, specs, mom_spec, data_spec


def make_lm_shardings(cfg, mesh: ProcessMesh, optimizer: str = "sgd", rules=None):
    """(specs, param shardings, optimizer-state shardings): each spec with
    its mesh (`NamedSharding`), from the same `lm_wiring` the step uses."""
    specs = lm_wiring(cfg, mesh, optimizer, rules=rules)[4]
    place = lambda s: NamedSharding(mesh, s)  # noqa: E731
    return (specs, tree_map(place, specs),
            tree_map(place, optimizer_state_specs(optimizer, specs)))


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
        (`build(*buffers)`, its parts: functions of no arguments, or `Eager`
        ones) and return True;
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
            self.program = Program(*build(*self._inputs), name=self.name,
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
                # the program's graphs run one after another: one memory pool
                capture_all([self.program], state, self._inputs[0].device,
                            pool=torch.cuda.graph_pool_handle())
            except Exception:
                self.program = self._bound = self._inputs = None
                raise
        self.program()


class LMTrainStep(_Captured):
    """`step(params, mom, tokens, targets, step_i=None)` -> loss (0-d f32
    tensor), or (loss, health) with `with_health`; params and optimizer
    state are updated in place. See `make_lm_train_step`."""

    def __init__(self, cfg, *, mesh, device, lr, momentum, attn_impl, optimizer, loss_chunks,
                 lr_schedule, clip_norm, accum_steps, weight_decay, with_health, grad_sync,
                 bucket_bytes, specs):
        super().__init__("the LM train step", device if device is not None else
                         (mesh.device if mesh.joined else None))
        self.cfg, self.mesh, self.lr, self.momentum = cfg, mesh, lr, momentum
        self.attn_impl, self.optimizer, self.loss_chunks = attn_impl, optimizer, loss_chunks
        self.lr_schedule, self.clip_norm, self.accum_steps = lr_schedule, clip_norm, accum_steps
        self.weight_decay, self.with_health = weight_decay, with_health
        self.overlap = grad_sync == "overlap" and accum_steps > 1
        self.bucket_bytes, self.specs = bucket_bytes, specs
        # the data-axis path: a group to sync over, sharded state, or the
        # per-micro-batch collectives
        self.synced = mesh.joined or optimizer.startswith("zero") or self.overlap
        self.layout = None  # the bucket plan under overlap
        self.collectives = []  # the step's collective parts, in order
        self._out = {}
        self._scalars = None

    @property
    def collective_form(self) -> str | None:
        """The collectives' form (`parallel/collectives.py`), None off a group."""
        return COLLECTIVE_FORMS[self.mesh.form] if self.mesh.joined else None

    def _one(self, params):
        cfg, attn_impl, loss_chunks = self.cfg, self.attn_impl, self.loss_chunks

        def one(tok, tgt):
            loss = lm_loss(params, tok, tgt, cfg, attn_impl=attn_impl, loss_chunks=loss_chunks)
            loss.backward()
            return loss.detach()

        return one

    def _optimize(self):
        """`optimize(leaves, grads, mom)`: clip, then the replicated update
        (sgd or adam) of `leaves` with `grads`, in place; returns the health
        norm (or None). It closes over values, not over this object."""
        optimizer, momentum, weight_decay = self.optimizer, self.momentum, self.weight_decay
        clip_norm, with_health = self.clip_norm, self.with_health
        lr_t, c1, c2 = self._scalars

        def optimize(leaves, grads, mom):
            norm = None
            if clip_norm > 0.0:
                norm = clip_by_global_norm(grads, clip_norm)
            elif with_health:
                norm = global_norm(grads)
            if optimizer == "adam":
                adam_leaf_update(leaves, grads, mom["m"], mom["v"], c1, c2, lr_t, momentum,
                                 B2, EPS, weight_decay)
            elif optimizer == "sgd":
                sgd_step(leaves, mom, grads, lr_t, momentum)
                apply_decoupled_weight_decay(leaves, lr_t, weight_decay)
            return norm

        return optimize

    def _build(self, params, mom, tokens, targets):
        """The step's parts over the static buffers (closing over no
        reference to this object: a dropped step frees its graphs at once)."""
        leaves = tree_leaves(params)
        one, accum, out = self._one(params), self.accum_steps, self._out
        optimize, with_health = self._optimize(), self.with_health

        def begin():
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None

        if not self.synced:
            def fn():
                begin()
                loss = accumulate_fwd_bwd(one, accum)(leaves, tokens, targets)
                grads = [p.grad for p in leaves]
                norm = optimize(leaves, grads, mom)
                for p in leaves:
                    p.grad = None
                out["loss"] = loss
                if with_health:
                    out["health"] = health_bundle(loss, norm)

            return [fn]
        return self._synced_parts(one, leaves, mom, tokens, targets, begin)

    def _synced_parts(self, one, leaves, mom, tokens, targets, begin):
        """The data-axis step: [begin, the gradients and their collectives,
        the update, (zero: the all-gather, the copy back)]."""
        mesh, dev, out = self.mesh, tokens.device, self._out
        accum, dp = self.accum_steps, mesh.dp
        optimize, with_health = self._optimize(), self.with_health
        loss = torch.zeros((), device=dev)
        sums = []  # (fn, is_collective)
        if self.overlap:
            keys = [str(s) for s in tree_leaves(self.specs)]
            self.layout = layout = plan_buckets(leaves, bucket_bytes=self.bucket_bytes,
                                                group_keys=keys)
            reducer = (zero.ShardReducer if self.optimizer.startswith("zero")
                       else BucketReducer)(layout, mesh, dev)
            sums += overlap_parts(one, accum, leaves, tokens, targets, reducer, loss)
            sums.append((lambda: dist.all_reduce(loss) if mesh.joined else None, True))
            grads = reducer.grads

            def average():
                loss.div_(dp)
        else:
            n = sum(p.numel() for p in leaves)
            flat = torch.zeros(n + 1, device=dev)  # the gradients, then the loss
            grads, at = [], 0
            for p in leaves:
                grads.append(flat[at:at + p.numel()].view(p.shape))
                at += p.numel()

            def compute():
                mean = accumulate_fwd_bwd(one, accum)(leaves, tokens, targets)
                with torch.no_grad():
                    torch.cat([p.grad.reshape(-1) for p in leaves] + [mean.reshape(1)], out=flat)
                for p in leaves:
                    p.grad = None

            sums += [(compute, False), (lambda: dist.all_reduce(flat) if mesh.joined else None,
                                        True)]

            def average():
                flat.div_(dp)
                loss.copy_(flat[n])

        zero_parts = ()
        if self.optimizer.startswith("zero"):
            lr_t, c1, c2 = self._scalars
            state = mom if self.optimizer == "zero" else {"m": mom["m"], "v": mom["v"]}
            zero_parts = zero.make_zero_split_step(
                leaves, grads, state, mesh=mesh, optimizer=self.optimizer, lr_t=lr_t,
                momentum=self.momentum, weight_decay=self.weight_decay, corrections=(c1, c2))

        @torch.no_grad()
        def update():
            average()
            norm = optimize(leaves, grads, mom)
            if zero_parts:
                zero_parts[0]()
            out["loss"] = loss
            if with_health:
                out["health"] = health_bundle(loss, norm)

        sums.append((update, False))
        if zero_parts:
            sums += [(zero_parts[1], True), (zero_parts[2], False)]
        # under NCCL a collective is captured with the rest; under gloo it
        # runs eagerly between the graphs; off a group it is a copy or nothing
        eager = mesh.joined and mesh.backend != "nccl"
        parts, self.collectives = [begin], []
        for fn, collective in sums:
            if collective and mesh.joined:
                self.collectives.append(fn)
            parts.append(Eager(fn) if collective and eager else fn)
        return parts

    def __call__(self, params, mom, tokens, targets, step_i=None):
        leaves = tree_leaves(params)
        adam = self.optimizer in ("adam", "zero-adam")
        bound = leaves + (mom["m"] + mom["v"] if adam else mom)
        if self._scalars is None:
            self._scalars = [torch.zeros((), device=self.device or leaves[0].device)
                             for _ in range(3)]
        first = self._bind(bound, (tokens, targets),
                           lambda tok, tgt: self._build(params, mom, tok, tgt))
        lr_t, c1, c2 = self._scalars
        # the host's f32 values, written into the buffers the updates read
        lr_t.fill_(self.lr if self.lr_schedule is None else self.lr_schedule(step_i))
        if adam:
            for buf, c in zip((c1, c2), bias_corrections(mom["t"] + 1, self.momentum, B2)):
                buf.fill_(c)
        self._run(first, (tokens, targets), bound)
        if adam:
            mom["t"] += 1
        loss = self._out["loss"].clone()
        if self.with_health:
            return loss, {k: v.clone() for k, v in self._out["health"].items()}
        return loss


def make_lm_train_step(cfg, *, mesh: ProcessMesh | None = None, device=None, lr: float = 0.1,
                       momentum: float = 0.9, attn_impl: str = "ring", optimizer: str = "sgd",
                       loss_chunks: int = 0, lr_schedule=None, clip_norm: float = 0.0,
                       accum_steps: int = 1, weight_decay: float = 0.0,
                       with_health: bool = False, grad_sync: str = "end",
                       bucket_mb: float = 4.0, rules=None):
    """`step(params, mom, tokens, targets, step_i=None)` -> loss (0-d f32
    tensor), or (loss, health) with `with_health`; params and optimizer
    state are updated in place.

    The JAX package's step in its order: forward + backward (accumulated
    over `accum_steps` micro-batches of B/k rows, mean gradient), the
    gradients' mean over the mesh's data axis, clip by global norm
    (`clip_norm` > 0; the health norm is the pre-clip one), lr from
    `lr_schedule(step_i)` (a callable, e.g. `functools.partial(warmup_cosine,
    ...)`) or `lr`, then the optimizer: SGD with momentum followed by
    decoupled weight decay, or Adam/AdamW with `momentum` as b1, replicated
    or (zero, zero-adam) on this rank's shards.

    `mesh` (`create_lm_mesh`; None: one process, dp 1): each rank passes its
    own B/dp rows (`distribute_host_data`) and gets the group's mean loss.
    `grad_sync`: "end" (one all-reduce after the accumulation) or "overlap"
    (the collective per micro-batch and per leaf bucket of at most
    `bucket_mb` MiB, leaves grouped by PartitionSpec; at accum_steps = 1
    the end schedule, bitwise). `rules`: a custom partition-rule list (the
    ``--sharding rules:<file>`` path); zero optimizers require replicated
    specs. `device`, when given, is where the step's buffers live (by
    default the parameters'), into which each call copies its tokens and
    targets. The step is one program, bound to the parameter and state
    tensors and the token shape of its first call (a call with others
    raises), and on the card CUDA graphs (one, unless gloo collectives
    split it).
    """
    _check_optimizer(optimizer)
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"unknown grad_sync {grad_sync!r} (use one of {GRAD_SYNCS})")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    if mesh is None:
        mesh = ProcessMesh(1, torch.device(device) if device is not None else torch.device("cpu"))
    specs = lm_wiring(cfg, mesh, optimizer, rules=rules)[4]
    return LMTrainStep(cfg, mesh=mesh, device=device, lr=lr, momentum=momentum,
                       attn_impl=attn_impl, optimizer=optimizer, loss_chunks=loss_chunks,
                       lr_schedule=lr_schedule, clip_norm=clip_norm, accum_steps=accum_steps,
                       weight_decay=weight_decay, with_health=with_health, grad_sync=grad_sync,
                       bucket_bytes=max(int(bucket_mb * 2**20), 1), specs=specs)


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

            return [fn]

        self._run(self._bind(tree_leaves(params), (tokens, targets), build), (tokens, targets),
                  [])
        return out["loss"].clone()


def make_eval_fn(cfg, *, attn_impl: str = "ring", loss_chunks: int = 0):
    """(params, tokens, targets) -> held-out loss, no gradient (`EvalLoss`)."""
    return EvalLoss(cfg, attn_impl=attn_impl, loss_chunks=loss_chunks)
