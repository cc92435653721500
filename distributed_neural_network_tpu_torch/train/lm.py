"""LM training: the port of the JAX package's `train/lm.py`
(`create_lm_mesh`, `shard_params`, `make_copy_task`, `auto_loss_chunks`,
`_ce_sum_chunked`, `lm_loss`, `optimizer_state_specs`, `init_lm_momentum`,
`lm_wiring`, `make_lm_shardings`, `make_lm_train_step`) for one device and
for a dp x sp x tp process mesh.

Parameters are the transformer's dict of f32 master tensors
(`models/transformer.py`); the optimizer state is a list per leaf in
`tree_leaves` order (the JAX package's sorted-key order, so a JAX momentum
tree carries across leaf by leaf), or, under ZeRO-1, this rank's shard of
each padded leaf (`parallel/zero.py`). The step updates parameters and state
in place, as the CNN port does, where the JAX step returns new trees.

The mesh (`create_lm_mesh(dp, sp, tp)`, a `parallel/mesh.py` `ProcessMesh`):
dp*sp*tp ranks of one torch.distributed group, laid out as the JAX mesh's
devices (model axis fastest). Each rank feeds the step its block of the
global batch (`parallel/distributed.py` `distribute_host_data`: the rows
and sequence columns JAX's ``P("data", "seq")`` gives its device) and takes
the mean loss over it; the gradients and the loss are averaged over the
sync axis (data x seq; every rank holds the same number of tokens, so this
is JAX's psum of the loss sum and token count over `sync_axes`). The model
axis shards the attention heads and the MLP's hidden columns
(`shard_params`, the rule table's ``model`` specs): the model's
`copy_to_model` / `reduce_from_model` (`parallel/collectives.py`) make the
replicated leaves' gradients whole on every model rank, so no leaf's
gradient is summed over the model axis; a tensor-sharded leaf's is summed
over the same sync ranks as a replicated one's. The sequence axis runs
`parallel/ring.py`'s attention. Gradient sync:

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
under overlap. With a model or sequence axis the forward and backward hold
collectives themselves, so under gloo each micro-batch's forward and
backward is one `Eager` part too (and the update, when its norm sums a
tensor-sharded leaf over the model axis); `Program.describe` names the
segments. The host computes each step's lr and corrections in f32 and
writes them into their buffers; graph and eager give the same bits.
`_capture = False` before the first call runs the program eagerly on the
card too. The pipeline axis's step is this one with its own loss and sync
sets (`parallel/pipeline.py` `PPTrainStep`: `_one`, `_sync_sets`,
`_reducer`). `make_traced_step` wraps either in the trace's spans,
StepStats and the goodput ledger.

The guard's hooks (`train/guard.py`, JAX `make_lm_train_step`'s):
``with_health`` returns the health bundle (loss, global gradient norm,
all-finite flag: three 0-d device tensors) beside the loss and changes no
value; ``skip_nonfinite`` gates the whole update (parameters, optimizer
state, Adam's counter) on the finite flag inside the program
(`ops/sgd.py` `guarded_sgd_step`, `ops/adam.py` `guarded_adam_step`), so
the step stays one graph; ``fault_plan`` (`parallel/fault.py`
`StepFaultPlan`) injects NaN gradients or a loss spike at chosen steps,
read from a 0-d step-index buffer written before each run. Under
``skip_nonfinite`` with Adam the counter lives on the device (the host
learns of a skip one step late, after the next step has read its
corrections): `DeviceCount` is the host's view of it in ``mom["t"]``.
Dynamics come later (ROADMAP Queue 1 item 4).

Mixture of experts (``cfg.n_experts``): with a data axis of more than one
rank the experts are sharded over it (`expert_axis`, the GShard convention):
each rank holds E/dp experts of every layer (the rule table's expert specs,
cut by `shard_params`) and routes its own tokens through them by
all-to-all (`parallel/moe.py`). Each rank's loss adds `AUX_WEIGHT` x its aux
(`lm_loss`), so the step's mean over the sync axis is JAX's ``pmean``. The
expert leaves vary over the data axis: their gradients are not summed over
it (the all-to-all's backward already brought every data rank's tokens to
an expert's rank); they are summed over the sequence axis when it has more
than one rank, and divided by the whole sync size as every other leaf
(`_sync_sets`). ZeRO and the overlapped sync refuse an expert axis, as in
JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models import transformer as tfm
from ..ops import flash_attention as fa
from ..ops.adam import (
    B2,
    EPS,
    adam_leaf_update,
    advance_counter,
    bias_corrections,
    correction_table,
    guarded_adam_leaf_update,
    init_adam,
    table_corrections,
)
from ..ops.schedule import (
    GRAD_SYNCS,
    accumulate_fwd_bwd,
    apply_decoupled_weight_decay,
    clip_by_global_norm,
    global_norm,
    health_bundle,
    overlap_parts,
)
from ..ops.sgd import guarded_sgd_step, init_momentum, sgd_step
from ..parallel import zero
from ..parallel.collectives import COLLECTIVE_FORMS, BucketReducer, gather_dim, plan_buckets
from ..parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    SYNC_AXES,
    TP_AXIS,
    Axis,
    NamedSharding,
    ProcessMesh,
    make_axis_groups,
)
from ..parallel.partition import PartitionSpec as P
from ..parallel.partition import spec_axes, validate_spec_tree
# tree_leaves / tree_unflatten: the step's leaf order, which callers read here
from ..utils.tree import tree_leaves, tree_map, tree_unflatten  # noqa: F401
from .graphs import Eager, Program, capture_all

OPTIMIZERS = ("sgd", "adam", "zero", "zero-adam")
# the MoE aux's weight in the loss (JAX `lm_loss`'s aux_weight), the mesh
# step's and the pipeline's
AUX_WEIGHT = 0.01


def create_lm_mesh(dp: int = 1, sp: int = 1, tp: int = 1, *, device="cuda") -> ProcessMesh:
    """The (dp, sp, tp) layout over the process group this process joined
    (`parallel/distributed.py` `initialize`), or this process alone at
    1 x 1 x 1: dp*sp*tp must be the group's world size. The ranks lie as
    JAX reshapes its devices, (dp, sp, tp) with the model axis fastest, and
    each rank gets its group along each axis (`make_axis_groups`)."""
    from ..device import resolve_device
    from ..parallel.distributed import joined, rank_device

    for name, n in (("dp", dp), ("sp", sp), ("tp", tp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    dev = resolve_device(device)
    world = dist.get_world_size() if joined() else 1
    n = dp * sp * tp
    if n != world:
        flags = " ".join(f"--{k} {v}" for k, v in (("dp", dp), ("sp", sp), ("tp", tp))
                         if v > 1 or k == "dp")
        raise ValueError(
            f"{flags} needs a process group of {n} ranks (dp x sp x tp, one rank a shard); "
            f"this process is in a world of {world}. Start it as: python -m "
            f"torch.distributed.run --standalone --nproc-per-node {n} -m "
            f"distributed_neural_network_tpu_torch.lm_train {flags} ...")
    if not joined():
        return ProcessMesh(1, dev)
    rank = dist.get_rank()
    return ProcessMesh(dp, rank_device(dev), rank=rank, joined=True, sp=sp, tp=tp,
                       groups=make_axis_groups(dp, sp, tp, rank))


def _local_shard(x, spec, mesh):
    """This rank's block of the whole leaf `x` under `spec`: each sharded
    dim cut into the axes' sizes, this rank's coordinates picking the
    block (several axes on one dim: the first axis major, as in JAX)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size, index = 1, 0
        for a in ((entry,) if isinstance(entry, str) else tuple(entry)):
            ax = mesh.axis(a)
            size, index = size * ax.size, index * ax.size + ax.index
        chunk = x.shape[dim] // size
        x = x.narrow(dim, index * chunk, chunk)
    return x.contiguous().clone()


def expert_axis(cfg, mesh: ProcessMesh) -> Axis | None:
    """The expert axis: the mesh's data axis when the model has experts and
    that axis more than one rank (the GShard convention), else None."""
    dp = mesh.shape.get(DATA_AXIS, 1)
    if cfg.n_experts and dp > 1:
        if cfg.n_experts % dp:
            raise ValueError(
                f"n_experts ({cfg.n_experts}) must be divisible by the data-axis size ({dp}) "
                f"for expert parallelism - use a multiple of {dp} experts or a dp that divides "
                f"{cfg.n_experts}")
        return mesh.data
    return None


def shard_params(params, cfg, mesh: ProcessMesh, rules=None):
    """(this rank's parameters on the mesh's device, their specs): the whole
    tree (the same on every rank, e.g. from `from_jax_params`) cut by the
    specs (`param_specs`, or ``rules``): under a model axis wq/wk/wv and w1
    (with b1) by columns, wo and w2 by rows (`lm_partition_rules(tp_axis=
    "model")`); under an expert axis the MoE leaves w1/b1/w2/b2 by experts;
    every other leaf replicated. `gather_params` is the inverse."""
    specs = _param_specs(cfg, mesh, rules)
    params = tfm.to_device(params, mesh.device)
    if mesh.tp > 1 or expert_axis(cfg, mesh):
        params = tree_map(lambda x, s: _local_shard(x, s, mesh), params, specs)
    return params, specs


def gather_params(params, specs, mesh: ProcessMesh):
    """The whole parameter tree from every rank's `shard_params` block: each
    tensor-sharded leaf all-gathered over the model axis (a collective
    every rank of the axis must call); new tensors, detached."""
    def whole(x, spec):
        x = x.detach()
        for dim, entry in enumerate(spec):
            if entry is not None:
                for a in ((entry,) if isinstance(entry, str) else tuple(entry)):
                    x = gather_dim(x, dim, mesh.axis(a))
        return x.clone()

    return tree_map(whole, params, specs)


def _spec_axes_by_dim(spec):
    """(dim, axis names) of each sharded dim of `spec`, the names major first."""
    return [(dim, (entry,) if isinstance(entry, str) else tuple(entry))
            for dim, entry in enumerate(spec) if entry is not None]


def _checkpoint_trees(params, mom, specs, mom_specs, optimizer: str):
    """({"mom", "params"} in the JAX trainer's form, its specs): the
    optimizer state as trees shaped like the parameters (Adam's {"m", "t",
    "v"} with the host counter as "t")."""
    def form(state):
        return tree_unflatten(params, state)

    mom_tree = (form(mom) if optimizer in ("sgd", "zero")
                else {"m": form(mom["m"]), "t": int(adam_count(mom)), "v": form(mom["v"])})
    return {"mom": mom_tree, "params": params}, {"mom": mom_specs, "params": specs}


def checkpoint_state(params, mom, specs, mom_specs, mesh: ProcessMesh, optimizer: str) -> dict:
    """The whole {"mom", "params"} tree a checkpoint holds, the JAX
    trainer's (`lm_train.py` saves `{"params", "mom"}` as its host tree):
    every sharded leaf gathered over its spec's axes (a dim over several
    axes gathered minor axis first: the inverse of `_local_shard`), in the
    collectives' form (`gather_dim`), so every rank must call it; Adam's
    counter as an int32 scalar. New tensors on the mesh's device (the
    pipeline's layers in the interleaved order, as in JAX)."""
    def whole(x, spec):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x, np.int32)  # Adam's counter
        x = x.detach()
        for dim, names in _spec_axes_by_dim(spec):
            for a in reversed(names):
                x = gather_dim(x, dim, mesh.axis(a))
        return x

    tree, spec_tree = _checkpoint_trees(params, mom, specs, mom_specs, optimizer)
    return tree_map(whole, tree, spec_tree)


def checkpoint_template(params, mom, specs, mom_specs, mesh: ProcessMesh, optimizer: str):
    """The whole tree's leaves by shape and dtype (`utils/checkpoint.py`
    `LeafSpec`), for a restore to validate against; no collective."""
    from ..utils.checkpoint import LeafSpec, host_leaf

    def like(x, spec):
        if not isinstance(x, torch.Tensor):
            return LeafSpec((), np.dtype(np.int32))
        shape = list(x.shape)
        for dim, names in _spec_axes_by_dim(spec):
            for a in names:
                shape[dim] *= mesh.axis(a).size
        return LeafSpec(tuple(shape), host_leaf(x.detach().reshape(-1)[:0]).dtype)

    tree, spec_tree = _checkpoint_trees(params, mom, specs, mom_specs, optimizer)
    return tree_map(like, tree, spec_tree)


@torch.no_grad()
def load_checkpoint_state(state, params, mom, specs, mom_specs, mesh: ProcessMesh,
                          optimizer: str) -> None:
    """Copy a restored whole tree (numpy leaves, `checkpoint_state`'s form)
    into this rank's parameter and optimizer-state tensors, each cut to its
    block (`_local_shard`): the tensors a step's program was (or will be)
    captured over stay the same objects. Adam's counter is set on the
    host."""
    from ..utils.checkpoint import to_torch

    tree, spec_tree = _checkpoint_trees(params, mom, specs, mom_specs, optimizer)
    for dst, src, spec in zip(tree_leaves(tree), tree_leaves(state), tree_leaves(spec_tree)):
        if isinstance(dst, torch.Tensor):
            src = src if isinstance(src, torch.Tensor) else to_torch(src)
            dst.copy_(_local_shard(src.to(dst.device), spec, mesh))
    if optimizer in ("adam", "zero-adam"):
        # a plain int: a step that counts on the device takes it from here
        mom["t"] = int(state["mom"]["t"])


class DeviceCount(int):
    """Adam's counter as the host sees it when the step counts on the
    device (``skip_nonfinite``): an int holding the count as if no step had
    been skipped, and the device counter, which `adam_count` reads for the
    exact value. A plain int put into ``mom["t"]`` (a restore) is taken by
    the step's next call as the device counter's new value. It holds the
    counter tensor, not the step: the step's program closes over ``mom``, so
    a reference back to the step would make a cycle, and a step in a cycle
    is freed by the collector, maybe during another capture."""

    def __new__(cls, value: int, device_t):
        obj = super().__new__(cls, value)
        obj.device_t = device_t
        return obj


def adam_count(mom) -> int:
    """Adam's exact step counter from ``mom["t"]``: the device counter's
    value (one read) when the step counts there, else the host's int."""
    t = mom["t"]
    return int(t.device_t) if isinstance(t, DeviceCount) else t


EXPERT_LEAVES = ("layers/w1", "layers/b1", "layers/w2", "layers/b2")


def _param_specs(cfg, mesh, rules):
    ep = getattr(expert_axis(cfg, mesh), "name", None)
    specs = tfm.param_specs(cfg, tp_axis=TP_AXIS if mesh.tp > 1 else None, ep_axis=ep,
                            rules=rules)
    for path, spec in _named_specs(specs):
        allowed = (TP_AXIS, ep) if ep and path in EXPERT_LEAVES else (TP_AXIS,)
        wide = [a for a in spec_axes(spec) if a not in allowed and mesh.shape.get(a, 1) > 1]
        if wide:
            raise NotImplementedError(
                f"the partition rules shard {path!r} as {spec} over {wide}; the port shards "
                "parameters over the model axis (tensor parallelism) and a MoE model's expert "
                "leaves over the data axis (expert parallelism), not another leaf over the "
                "data or sequence axis")
    return specs


def expert_leaf_indices(specs) -> list[int]:
    """The `tree_leaves` indices of the leaves sharded over the data axis:
    the expert leaves under expert parallelism."""
    return [i for i, s in enumerate(tree_leaves(specs)) if DATA_AXIS in spec_axes(s)]


def _named_specs(specs):
    from ..parallel.rules import named_leaves

    return named_leaves(specs, is_leaf=lambda s: isinstance(s, P))


def make_traced_step(step_fn, *, tracer, step_stats=None, items_per_step: float = 0.0,
                     first_step: int = 0, registry=None, recompiles=None):
    """Wrap a train step (`LMTrainStep`, `PPTrainStep`: same arguments and
    return) with span tracing, StepStats, the goodput ledger and the live
    registry (the JAX `make_traced_step`).

    Each call is one ``train_step`` span on the ``train`` track, step
    numbers counted from `first_step`: a graph replay is one span. The span
    closes after a wait for the card (`torch.cuda.synchronize` on the
    loss's device), so it is device time, not queueing time. `step_stats`
    records each call's wall (the first, which builds the kernels and
    captures the step's graph, as the compile step), and the process's
    `utils/goodput.py` LEDGER gets it as a compile / steady_step interval.

    `registry` (`utils/obs.py` `MetricsRegistry`; None: off) marks each
    step begun before the launch (`begin_step`) and, after the fence, beats
    it, counts ``train_steps_total``, observes the ``train_step_seconds``
    histogram, flips readiness after the first call and sets
    ``train_throughput_items_per_s`` from the second call on. `recompiles`
    (`train/monitor.py` `RecompileDetector`) is then observed once a call:
    one ``_cache_size()`` read. All of it is host floats."""
    import itertools
    import time

    from ..utils import goodput as _goodput
    from ..utils import tracing as _tracing
    from ..utils.obs import NULL_REGISTRY
    from ..utils.timers import fence as _fence

    counter = itertools.count(first_step)
    reg = registry if registry is not None else NULL_REGISTRY
    m_steps = reg.counter("train_steps_total", "Completed training steps")
    m_wall = reg.histogram("train_step_seconds", "Fenced wall time per training step")
    m_thr = reg.gauge("train_throughput_items_per_s",
                      "Per-step training throughput (tokens/s for the LM paths)")

    def traced_step(*args, **kwargs):
        i = next(counter)
        # begun before the launch: a rank wedged on the host never begins
        # the next step while its peers have (utils/obs.py begin_step)
        reg.begin_step(i)
        t0 = time.perf_counter()
        with tracer.span(_tracing.TRAIN_STEP, track="train", step=i, fenced=True):
            out = step_fn(*args, **kwargs)
            _fence((out[0] if isinstance(out, tuple) else out).device)
        dt = time.perf_counter() - t0
        if step_stats is not None:
            step_stats.record(i, dt, items=items_per_step)
        _goodput.LEDGER.step_span(i, dt, tokens=items_per_step)
        reg.beat(i)
        m_steps.inc()
        m_wall.observe(dt)
        reg.mark_ready()
        if items_per_step and dt > 0 and reg.ready and i != first_step:
            m_thr.set(items_per_step / dt)
        if recompiles is not None:
            recompiles.observe(i)
        return out

    return traced_step


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


def lm_loss(params, tokens, targets, cfg, *, seq_axis=None, tp_axis=None, ep_axis=None,
            attn_impl: str = "ring", loss_chunks: int = 0):
    """Mean next-token cross-entropy over this rank's tokens (B_local,
    S_local), plus `AUX_WEIGHT` x this rank's MoE aux when the model has
    experts. loss_chunks > 1 chunks the CE along the local sequence; 0
    picks the chunking that bounds a chunk's logits to ~64 MB; 1 is a single
    pass. The step averages it over the sync axis (`LMTrainStep`): every
    rank holds B/dp x S/sp tokens, so that is the JAX psum of the loss sum
    and of the token count over (data, seq), and the JAX pmean of the aux."""
    x, aux = tfm.apply_hidden(params, tokens, cfg, seq_axis=seq_axis, tp_axis=tp_axis,
                              ep_axis=ep_axis, attn_impl=attn_impl)
    b, s = tokens.shape
    if loss_chunks == 0:
        loss_chunks = auto_loss_chunks(b, s, cfg.vocab_size)
    if loss_chunks > 1:
        total = _ce_sum_chunked(x, params["head"], targets, loss_chunks)
    else:
        total = _chunk_ce(x, params["head"].to(cfg.dtype), targets)
    loss = total / float(b * s)
    if cfg.n_experts:
        loss = loss + AUX_WEIGHT * aux
    return loss


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
    dp = mesh.data.size if mesh is not None else 1
    if optimizer == "zero":
        return zero.init_zero_momentum_tree(leaves, dp)
    return zero.init_zero_adam_tree(leaves, dp)


def lm_wiring(cfg, mesh: ProcessMesh, optimizer: str = "sgd", rules=None):
    """(sp, tp, ep, sync_axes, specs, mom_spec, data_spec) for the mesh:
    the one derivation of axes and specs the step uses (sp / tp / ep: the
    axis name when it has more than one rank, else None; ep is the data
    axis for a MoE model, `expert_axis`). The parameters' specs come from the
    rule table (or ``rules``, the ``--sharding rules:<file>`` path) and
    every spec is checked against the mesh's axes up front; the zero
    optimizers need replicated specs, so they refuse a model or expert
    axis, as in JAX."""
    _check_optimizer(optimizer)
    sp = SEQ_AXIS if mesh.sp > 1 else None
    tp = TP_AXIS if mesh.tp > 1 else None
    ep = getattr(expert_axis(cfg, mesh), "name", None)
    specs = _param_specs(cfg, mesh, rules)
    if optimizer.startswith("zero") and (tp or ep):
        raise ValueError(
            f"optimizer={optimizer!r} shards the flat param vector over the data axis, which "
            "requires params replicated across the mesh - not compatible with "
            f"tp_axis={tp!r} / ep_axis={ep!r}; use 'sgd'/'adam' for tensor/expert-sharded "
            "configs")
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
    return sp, tp, ep, SYNC_AXES, specs, mom_spec, data_spec


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
    starts afresh. `_cache_size()` counts the programs built and (on the
    card) captured: 1 after the first call, more only if one was built
    again (`train/monitor.py` `RecompileDetector` reads it)."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self._capture = None
        self.program = None
        self._bound = None
        self._inputs = None
        self._builds = 0

    def _cache_size(self) -> int:
        return self._builds

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
        if first:
            self._builds += 1
        self.program()


class LMTrainStep(_Captured):
    """`step(params, mom, tokens, targets, step_i=None)` -> loss (0-d f32
    tensor), or (loss, health) with `with_health`; params and optimizer
    state are updated in place. See `make_lm_train_step`."""

    def __init__(self, cfg, *, mesh, device, lr, momentum, attn_impl, optimizer, loss_chunks,
                 lr_schedule, clip_norm, accum_steps, weight_decay, with_health, grad_sync,
                 bucket_bytes, specs, skip_nonfinite=False, fault_plan=None):
        super().__init__("the LM train step", device if device is not None else
                         (mesh.device if mesh.joined else None))
        self.cfg, self.mesh, self.lr, self.momentum = cfg, mesh, lr, momentum
        self.attn_impl, self.optimizer, self.loss_chunks = attn_impl, optimizer, loss_chunks
        self.lr_schedule, self.clip_norm, self.accum_steps = lr_schedule, clip_norm, accum_steps
        # skip_nonfinite implies the health output, as JAX's want_health
        self.weight_decay, self.with_health = weight_decay, with_health or skip_nonfinite
        self.skip_nonfinite = skip_nonfinite
        self.fault_plan = fault_plan if fault_plan else None  # an empty plan injects nothing
        # Adam under skip counts on the device (`DeviceCount`)
        self.device_count = skip_nonfinite and optimizer in ("adam", "zero-adam")
        self.overlap = grad_sync == "overlap" and accum_steps > 1
        self.bucket_bytes, self.specs = bucket_bytes, specs
        # the mesh path: a group to sync over, sharded state, or the
        # per-micro-batch collectives
        self.synced = mesh.joined or optimizer.startswith("zero") or self.overlap
        self.layout = None  # the bucket plan under overlap
        self.collectives = []  # the step's collective parts, in order
        # each rank's gradients are of its own mean loss: their sum over
        # the sync axis is divided by its size (the pipeline's are of its
        # share of the global mean: no division)
        self.divisor = mesh.sync.size
        # the expert axis (the data axis of a MoE model)
        self.ep_axis = expert_axis(cfg, mesh)
        ep = self.ep_axis is not None
        # the forward and backward hold collectives (model or sequence axis,
        # the experts' all-to-alls)
        self.inner = mesh.tp > 1 or mesh.sp > 1 or ep
        # the clip / health norm sums a sharded leaf over an axis
        self.norm_collective = mesh.tp > 1 or ep
        self._out = {}
        self._scalars = None
        # the guard's device buffers: the finite flag the gated update reads,
        # the step index a fault plan fires on, Adam's device counter and
        # its corrections table (made at the first call)
        self._ok = self._step_i = self._count = self._table = None

    @property
    def collective_form(self) -> str | None:
        """The collectives' form (`parallel/collectives.py`), None off a group."""
        return COLLECTIVE_FORMS[self.mesh.form] if self.mesh.joined else None

    @property
    def segments(self) -> str:
        """The step program's segments in order (`Program.describe`): one
        "graph" under NCCL; under gloo the graphs and the eager parts
        between them."""
        return self.program.describe() if self.program is not None else "not built"

    def _one(self, params):
        cfg, attn_impl, loss_chunks = self.cfg, self.attn_impl, self.loss_chunks
        seq_axis, tp_axis, ep_axis = self.mesh.seq_axis, self.mesh.tp_axis, self.ep_axis

        def one(tok, tgt):
            loss = lm_loss(params, tok, tgt, cfg, seq_axis=seq_axis, tp_axis=tp_axis,
                           ep_axis=ep_axis, attn_impl=attn_impl, loss_chunks=loss_chunks)
            loss.backward()
            return loss.detach()

        return one

    def _optimize(self, params):
        """`optimize(leaves, grads, mom, loss)`, in the JAX order: the fault
        plan's injection, clip (the health norm is the pre-clip one), the
        health bundle, then the replicated update (sgd or adam) of `leaves`
        with `grads` in place, gated on the finite flag under
        `skip_nonfinite`; returns (loss, health or None). The norm sums a
        tensor-sharded leaf over the model axis. It closes over values, not
        over this object."""
        optimizer, momentum, weight_decay = self.optimizer, self.momentum, self.weight_decay
        clip_norm, with_health, skip = self.clip_norm, self.with_health, self.skip_nonfinite
        lr_t, c1, c2 = self._scalars
        ok, count, table = self._ok, self._count, self._table
        plan, step_i = self.fault_plan, self._step_i
        at = None
        if plan is not None:
            from ..parallel.fault import fault_masks

            at = fault_masks(plan, lr_t.device)
        mesh = self.mesh
        spec_leaves = tree_leaves(self.specs)
        norm_kw = dict(specs=spec_leaves, axes=tuple(mesh.shape), mesh=mesh)

        def optimize(leaves, grads, mom, loss):
            if plan is not None:
                from ..parallel.fault import inject_step_faults

                loss = inject_step_faults(step_i, loss, tree_unflatten(params, grads), plan,
                                          at=at)[0]
            norm = health = None
            if clip_norm > 0.0:
                norm = clip_by_global_norm(grads, clip_norm, **norm_kw)
            elif with_health:
                norm = global_norm(grads, **norm_kw)
            if with_health:
                health = health_bundle(loss, norm)
            if skip:
                ok.copy_(health["all_finite"])
            if count is not None:
                # this step's corrections from the device counter
                n1, n2 = table_corrections(table, count + 1)
                c1.copy_(n1)
                c2.copy_(n2)
            if optimizer == "adam" and skip:
                guarded_adam_leaf_update(leaves, grads, mom["m"], mom["v"], c1, c2, lr_t,
                                         momentum, B2, EPS, weight_decay, ok=ok)
            elif optimizer == "adam":
                adam_leaf_update(leaves, grads, mom["m"], mom["v"], c1, c2, lr_t, momentum,
                                 B2, EPS, weight_decay)
            elif optimizer == "sgd" and skip:
                guarded_sgd_step(leaves, mom, grads, lr_t, momentum, ok=ok,
                                 weight_decay=weight_decay)
            elif optimizer == "sgd":
                sgd_step(leaves, mom, grads, lr_t, momentum)
                apply_decoupled_weight_decay(leaves, lr_t, weight_decay)
            if count is not None:
                advance_counter(count, ok)
            return loss, health

        return optimize

    def _build(self, params, mom, tokens, targets):
        """The step's parts over the static buffers (closing over no
        reference to this object: a dropped step frees its graphs at once)."""
        leaves = tree_leaves(params)
        one, accum, out = self._one(params), self.accum_steps, self._out
        optimize = self._optimize(params)

        def begin():
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None

        if not self.synced:
            def fn():
                begin()
                loss = accumulate_fwd_bwd(one, accum)(leaves, tokens, targets)
                grads = [p.grad for p in leaves]
                out["loss"], out["health"] = optimize(leaves, grads, mom, loss)
                for p in leaves:
                    p.grad = None

            return [fn]
        return self._synced_parts(one, leaves, mom, tokens, targets, begin, optimize)

    def _sync_sets(self, n_leaves: int):
        """[(axis, leaf indices)]: the leaves whose gradients are summed
        over each axis, the loss with the first set's: every leaf over the
        sync axis, but under expert parallelism the expert leaves (which
        vary over the data axis) over the sequence axis alone (no group at
        sp 1). Every set is divided by the sync size. The pipeline splits
        them its own way."""
        if self.ep_axis is None:
            return [(self.mesh.sync, list(range(n_leaves)))]
        experts = expert_leaf_indices(self.specs)
        rest = [i for i in range(n_leaves) if i not in experts]
        return [(self.mesh.sync, rest), (self.mesh.seq, experts)]

    def _reducer(self, layout, dev):
        """The overlap schedule's reducer over `layout`'s buckets."""
        return (zero.ShardReducer if self.optimizer.startswith("zero")
                else BucketReducer)(layout, self.mesh, dev)

    def _synced_parts(self, one, leaves, mom, tokens, targets, begin, optimize):
        """The mesh step: [begin, the gradients and their collectives over
        the sync sets' axes, the update, (zero: the all-gather over the data
        axis, the copy back)]."""
        mesh, dev, out = self.mesh, tokens.device, self._out
        accum, divisor = self.accum_steps, self.divisor
        sets = self._sync_sets(len(leaves))
        loss_group = sets[0][0].group
        with_health = self.with_health
        loss = torch.zeros((), device=dev)
        sums = []  # (fn, kind): "model" (forward and backward), "collective", "local"
        if self.overlap:
            keys = [str(s) for s in tree_leaves(self.specs)]
            self.layout = layout = plan_buckets(leaves, bucket_bytes=self.bucket_bytes,
                                                group_keys=keys)
            reducer = self._reducer(layout, dev)
            sums += overlap_parts(one, accum, leaves, tokens, targets, reducer, loss)
            if loss_group is not None:
                sums.append((lambda: dist.all_reduce(loss, group=loss_group), "collective"))
            grads = reducer.grads

            def average():
                if divisor != 1:
                    loss.div_(divisor)
        else:
            # one flat buffer per set: its gradients, then (the first) the loss
            flats, grads = [], [None] * len(leaves)
            for j, (_, idx) in enumerate(sets):
                flat = torch.zeros(sum(leaves[i].numel() for i in idx) + (j == 0), device=dev)
                at = 0
                for i in idx:
                    grads[i] = flat[at:at + leaves[i].numel()].view(leaves[i].shape)
                    at += leaves[i].numel()
                flats.append(flat)

            def compute():
                mean = accumulate_fwd_bwd(one, accum)(leaves, tokens, targets)
                with torch.no_grad():
                    for j, ((_, idx), flat) in enumerate(zip(sets, flats)):
                        torch.cat([leaves[i].grad.reshape(-1) for i in idx]
                                  + ([mean.reshape(1)] if j == 0 else []), out=flat)
                for p in leaves:
                    p.grad = None

            sums.append((compute, "model"))
            for (axis, _), flat in zip(sets, flats):
                if axis.group is not None:
                    sums.append((lambda flat=flat, group=axis.group:
                                 dist.all_reduce(flat, group=group), "collective"))

            def average():
                if divisor != 1:
                    for flat in flats:
                        flat.div_(divisor)
                loss.copy_(flats[0][-1])

        zero_parts = ()
        if self.optimizer.startswith("zero"):
            lr_t, c1, c2 = self._scalars
            state = mom if self.optimizer == "zero" else {"m": mom["m"], "v": mom["v"]}
            zero_parts = zero.make_zero_split_step(
                leaves, grads, state, mesh=mesh, optimizer=self.optimizer, lr_t=lr_t,
                momentum=self.momentum, weight_decay=self.weight_decay, corrections=(c1, c2),
                ok=self._ok if self.skip_nonfinite else None)

        @torch.no_grad()
        def update():
            average()
            # after the sync: every rank injects the same fault into the
            # same gradients, and spikes the mean loss
            out["loss"], out["health"] = optimize(leaves, grads, mom, loss)
            if zero_parts:
                zero_parts[0]()

        # the norm of a tensor- or stage-sharded leaf is summed over its axis
        sums.append((update, "norm" if self.norm_collective and (self.clip_norm > 0.0
                                                                  or with_health)
                     else "local"))
        if zero_parts:
            sums += [(zero_parts[1], "collective" if mesh.data.group is not None else "local"),
                     (zero_parts[2], "local")]
        # Under NCCL every part is captured, collectives included: one graph.
        # Under gloo (a host collective, which no graph can record) a
        # collective runs eagerly between the graphs, and so does a part
        # that holds one: the forward and backward under a model, sequence
        # or pipeline axis (copy_to_model, ring / all-to-all attention, the
        # pipeline's ppermute and all-to-all), the update whose norm sums
        # over the model or pipe axis. Off a group (the CPU at 1 x 1 x 1)
        # nothing is a collective.
        gloo = mesh.joined and mesh.backend != "nccl"
        inner = self.inner
        labels = {"collective": "eager collective",
                  "model": "eager forward+backward (model/seq/pipe collectives inside)",
                  "norm": "eager update (model/pipe-axis norm)"}
        # `begin` runs with the first part (so no graph of its own is empty)
        (first, kind0), rest = sums[0], sums[1:]
        sums = [(lambda: (begin(), first()), kind0)] + rest
        parts, self.collectives = [], []
        for fn, kind in sums:
            if kind == "collective":
                self.collectives.append(fn)
            eager = gloo and (kind in ("collective", "norm") or (kind == "model" and inner))
            parts.append(Eager(fn, labels[kind]) if eager else fn)
        return parts

    def __call__(self, params, mom, tokens, targets, step_i=None):
        leaves = tree_leaves(params)
        adam = self.optimizer in ("adam", "zero-adam")
        bound = leaves + (mom["m"] + mom["v"] if adam else mom)
        if self.fault_plan is not None and step_i is None:
            raise ValueError("a step with a fault plan fires on the step index: pass step_i")
        if self._scalars is None:
            dev = self.device or leaves[0].device
            self._scalars = [torch.zeros((), device=dev) for _ in range(3)]
            self._ok = torch.ones((), dtype=torch.bool, device=dev)
            self._step_i = torch.zeros((), dtype=torch.int64, device=dev)
            if self.device_count:
                self._count = torch.zeros((), dtype=torch.int32, device=dev)
                self._table = correction_table(self.momentum, B2, device=dev)
        first = self._bind(bound, (tokens, targets),
                           lambda tok, tgt: self._build(params, mom, tok, tgt))
        lr_t, c1, c2 = self._scalars
        # the host's f32 values, written into the buffers the updates read
        lr_t.fill_(self.lr if self.lr_schedule is None else self.lr_schedule(step_i))
        if step_i is not None:
            self._step_i.fill_(int(step_i))
        if self.device_count:
            t = mom["t"]
            if not (isinstance(t, DeviceCount) and t.device_t is self._count):
                # the host set the counter (the first call, a restore)
                self._count.fill_(int(t))
        elif adam:
            for buf, c in zip((c1, c2), bias_corrections(mom["t"] + 1, self.momentum, B2)):
                buf.fill_(c)
        # the capture's warm-up puts back what the step writes: the state,
        # and the device counter when the step counts there
        self._run(first, (tokens, targets),
                  bound + ([self._count] if self._count is not None else []))
        if self.device_count:
            mom["t"] = DeviceCount(mom["t"] + 1, self._count)
        elif adam:
            mom["t"] += 1
        loss = self._out["loss"].clone()
        if not self.with_health:
            return loss
        health = self._out["health"]
        if not health["loss"].is_cuda:
            return loss, {k: v.clone() for k, v in health.items()}
        # copied to pinned host memory now, queued behind this step alone:
        # a read after the next step's launch (`train/guard.py` HealthPipe)
        # waits on `ready`, where reading a device tensor would wait for
        # everything queued on the stream, the next step too
        host = {k: torch.empty((), dtype=v.dtype, pin_memory=True) for k, v in health.items()}
        for k, v in health.items():
            host[k].copy_(v, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return loss, {**host, "ready": ready}


def make_lm_train_step(cfg, *, mesh: ProcessMesh | None = None, device=None, lr: float = 0.1,
                       momentum: float = 0.9, attn_impl: str = "ring", optimizer: str = "sgd",
                       loss_chunks: int = 0, lr_schedule=None, clip_norm: float = 0.0,
                       accum_steps: int = 1, weight_decay: float = 0.0,
                       with_health: bool = False, grad_sync: str = "end",
                       bucket_mb: float = 4.0, rules=None, skip_nonfinite: bool = False,
                       fault_plan=None):
    """`step(params, mom, tokens, targets, step_i=None)` -> loss (0-d f32
    tensor), or (loss, health) with `with_health` or `skip_nonfinite`;
    params and optimizer state are updated in place.

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

    Guard hooks (`train/guard.py`; off by default, and then the program is
    the unguarded one): `with_health` returns {loss, grad_norm, all_finite}
    (0-d tensors; the norm the clip computes, or one global norm) and
    changes no value; on the card they are pinned host tensors filled
    behind the step, valid once the bundle's ``ready`` CUDA event has
    completed (`HealthPipe` waits on it); `skip_nonfinite` gates the whole update - parameters,
    optimizer state, ZeRO's shards before their all-gather, Adam's counter -
    on the finite flag on the device, so a NaN gradient costs one wasted
    forward and backward; with Adam the counter then counts on the device
    (``mom["t"]`` a `DeviceCount`, `adam_count` its exact value);
    `fault_plan` (`parallel/fault.py` `StepFaultPlan`) injects its faults
    after the gradient sync, firing on `step_i` (required then).
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
    wiring = lm_wiring(cfg, mesh, optimizer, rules=rules)
    sp, ep, specs = wiring[0], wiring[2], wiring[4]
    if grad_sync == "overlap" and ep:
        raise ValueError(
            "grad_sync='overlap' psums every gradient bucket over the data axis, but "
            f"expert-sharded leaves VARY over that axis (ep_axis={ep!r}) - their gradients must "
            "stay local; use grad_sync='end' with expert parallelism")
    if attn_impl == "flash" and sp is not None:
        raise ValueError(
            "attn_impl 'flash' is the local (per-device) kernel; with a sequence axis use "
            "'ring'/'ulysses'/'zigzag' (flash composes with dp/tp meshes, not sp)")
    return LMTrainStep(cfg, mesh=mesh, device=device, lr=lr, momentum=momentum,
                       attn_impl=attn_impl, optimizer=optimizer, loss_chunks=loss_chunks,
                       lr_schedule=lr_schedule, clip_norm=clip_norm, accum_steps=accum_steps,
                       weight_decay=weight_decay, with_health=with_health, grad_sync=grad_sync,
                       bucket_bytes=max(int(bucket_mb * 2**20), 1), specs=specs,
                       skip_nonfinite=skip_nonfinite, fault_plan=fault_plan)


class EvalLoss(_Captured):
    """(params, tokens, targets) -> held-out loss, no gradient: one program
    at the shape of its first call, bound to that call's parameter tensors
    (the JAX CLI's jitted eval; for a MoE model it holds the aux, as the JAX
    eval does). On a mesh every rank passes the whole batch's rows and its
    block of the sequence, and the loss is averaged over the sequence axis;
    under expert parallelism (`sharded_rows`) every rank passes its block of
    rows too, so that it routes its own tokens as in training, and the loss
    is averaged over the sync axis. The model axis and the experts run their
    collectives (under gloo with any of these axes the program is one eager
    part)."""

    def __init__(self, cfg, *, attn_impl: str, loss_chunks: int, mesh: ProcessMesh | None = None):
        super().__init__("the LM eval loss", None if mesh is None or not mesh.joined
                         else mesh.device)
        self.cfg, self.attn_impl, self.loss_chunks = cfg, attn_impl, loss_chunks
        self.mesh = mesh
        self.ep_axis = expert_axis(cfg, mesh) if mesh is not None else None
        self._out = {}

    @property
    def sharded_rows(self) -> bool:
        """Each rank passes its block of the batch's rows (expert
        parallelism), not all of them."""
        return self.ep_axis is not None

    def __call__(self, params, tokens, targets):
        cfg, attn_impl, loss_chunks, out = self.cfg, self.attn_impl, self.loss_chunks, self._out
        mesh, ep_axis = self.mesh, self.ep_axis
        seq_axis = mesh.seq_axis if mesh is not None else None
        tp_axis = mesh.tp_axis if mesh is not None else None
        mean_over = mesh.sync if ep_axis is not None else seq_axis

        def build(tok, tgt):
            @torch.no_grad()
            def fn():
                loss = lm_loss(params, tok, tgt, cfg, seq_axis=seq_axis, tp_axis=tp_axis,
                               ep_axis=ep_axis, attn_impl=attn_impl, loss_chunks=loss_chunks)
                if mean_over is not None:
                    dist.all_reduce(loss, group=mean_over.group)
                    loss.div_(mean_over.size)
                out["loss"] = loss

            gloo = mesh is not None and mesh.joined and mesh.backend != "nccl"
            if gloo and (mean_over is not None or tp_axis is not None):
                return [Eager(fn, "eager forward (model/seq collectives inside)")]
            return [fn]

        self._run(self._bind(tree_leaves(params), (tokens, targets), build), (tokens, targets),
                  [])
        return out["loss"].clone()


def make_eval_fn(cfg, *, attn_impl: str = "ring", loss_chunks: int = 0,
                 mesh: ProcessMesh | None = None):
    """(params, tokens, targets) -> held-out loss, no gradient (`EvalLoss`)."""
    return EvalLoss(cfg, attn_impl=attn_impl, loss_chunks=loss_chunks, mesh=mesh)
