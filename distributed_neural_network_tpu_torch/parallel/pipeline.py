"""Pipeline parallelism: the GPipe and interleaved microbatch schedules of
the JAX package's `parallel/pipeline.py`, over the pipe axis of a dp x pp x
tp process mesh.

- **Stages are a mesh axis** (`create_pp_mesh`, `parallel/mesh.py`
  `ProcessMesh` with ``pp``): every leaf of the transformer's stacked
  ``layers`` is cut on its layer axis over ``pipe`` (`pp_param_specs`,
  `shard_pp_params`), each rank holding L/P layers; embed, head and the
  final norm stay whole on every stage. One program on every rank, the same
  sequence of collectives on every rank.
- **The schedule is the JAX dense one, tick for tick** (`pipeline_lm_loss`):
  v*M + P - 1 ticks; on each, every stage runs its layer chunk on its
  current block, and the blocks move one hop along the pipe ring
  (`collectives.ppermute`). Stage 0 takes a fresh embedded microbatch on
  its lap-0 ticks; bubble ticks compute on garbage that never reaches the
  loss. The stage decides what a rank computes, never which collectives it
  runs: the block a rank receives always feeds its next tick (``torch.where``
  where stage 0 takes the fresh block, as the JAX `where`), so every
  ppermute's backward runs on every rank, in the same order.
- **The head runs once per microbatch, over the stages**: the last stage's
  exit blocks (padded to a multiple of P) are dealt round-robin with one
  `collectives.all_to_all`, and each stage runs the final norm, the head
  and the chunked cross-entropy for its k = ceil(M/P) microbatches; no tick
  does vocab-sized work.
- **Autograd does the backward pipeline**: the backward of ppermute is the
  inverse ppermute and that of the all-to-all the inverse all-to-all
  (`parallel/collectives.py`). Each rank's loss is its share of the global
  mean (its microbatches' CE over the global token count), so the layer
  leaves' gradients on a stage are whole for its data shard and are summed
  over the data axis; the leaves replicated over the pipe axis (embed:
  stage 0's gather; head and final norm: each stage's k microbatches) hold
  this stage's part and are summed over (data, pipe) (JAX's typed autodiff
  psums them over ``pipe``). `PPTrainStep` does that; no gradient is
  divided by a rank count.
- ``interleave`` = v > 1 is the circular schedule: each rank holds v
  round-robin chunks of L/(v*P) layers (global chunk l*P + q on rank q,
  `interleave_layer_order`), and a microbatch makes v laps of the ring:
  the bubble falls from (P-1)/(M+P-1) to (P-1)/(v*M+P-1). It needs P | M
  and v*P | L.

The blocks attend with the plain local attention (`parallel/ring.py`
`attention`), whatever ``--attn`` is, as the JAX pipeline does: the pipeline
reaches no hand-written kernel. ``cfg.remat`` / ``remat_policy`` apply to
each block of a chunk (`models/transformer.py` `remat_block`). Under NCCL
the step, every tick's ppermute and the all-to-all included, is one CUDA
graph; under gloo a collective runs on the host, so each accumulation
pass's forward and backward is one eager part (`train/lm.py`
`LMTrainStep.segments`). Left out, with the static analysis (ROADMAP Queue
1 item 6): `abstract_pp_state` and `pp_step_program`.

Mixture-of-experts blocks route each microbatch's tokens (capacity from
the microbatch, `parallel/moe.py`); with a data axis of more than one rank
the experts are sharded over it (`train/lm.py` `expert_axis`) and every tick
runs their all-to-alls over the data group, bubble ticks included: the
ranks of one data group share a stage and run the same ticks. A tick's aux
(the chunk's layers summed) counts only on the ticks that carry a
microbatch (the JAX mask), normalized over m x L x dp. The expert leaves'
gradients are not summed at all (`PPTrainStep._sync_sets`); ZeRO and the
overlapped sync refuse an expert axis, with the JAX texts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models import transformer as tfm
from ..ops.schedule import GRAD_SYNCS
from ..train import lm as lmtrain
from ..utils.tree import tree_leaves, tree_map
from . import zero
from .collectives import BucketReducer, all_to_all, ppermute
from .mesh import DATA_AXIS, PIPE_AXIS, TP_AXIS, Axis, ProcessMesh, make_axis_groups
from .moe import expert_capacity
from .partition import PartitionSpec as P
from .partition import validate_spec_tree
from .ring import attention


def create_pp_mesh(dp: int = 1, pp: int = 1, tp: int = 1, *, device="cuda") -> ProcessMesh:
    """The (data, pipe, model) layout over the process group this process
    joined (`parallel/distributed.py` `initialize`), the model axis fastest,
    then pipe (JAX's device order): dp*pp*tp must be the group's world
    size; each rank gets its group along each axis (`make_axis_groups`)."""
    from ..device import resolve_device
    from .distributed import joined, rank_device

    for name, n in (("dp", dp), ("pp", pp), ("tp", tp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    dev = resolve_device(device)
    world = dist.get_world_size() if joined() else 1
    n = dp * pp * tp
    if n != world:
        flags = " ".join(f"--{k} {v}" for k, v in (("dp", dp), ("pp", pp), ("tp", tp))
                         if v > 1 or k == "pp")
        raise ValueError(
            f"{flags} needs a process group of {n} ranks (dp x pp x tp, one rank a shard); "
            f"this process is in a world of {world}. Start it as: python -m "
            f"torch.distributed.run --standalone --nproc-per-node {n} -m "
            f"distributed_neural_network_tpu_torch.lm_train {flags} ...")
    if not joined():
        return ProcessMesh(1, dev)
    rank = dist.get_rank()
    return ProcessMesh(dp, rank_device(dev), rank=rank, joined=True, tp=tp, pp=pp,
                       groups=make_axis_groups(dp, 1, tp, rank, pp=pp))


def pp_param_specs(cfg, tp_axis: str | None = None, ep_axis: str | None = None):
    """The rule table's specs with every layer leaf cut over ``pipe`` on its
    layer axis (dim 0); embed, head and the final norm stay replicated over
    the pipe axis."""
    specs = tfm.param_specs(cfg, tp_axis=tp_axis, ep_axis=ep_axis)
    specs["layers"] = {k: P(PIPE_AXIS, *tuple(s)[1:]) for k, s in specs["layers"].items()}
    return specs


def pp_wiring(cfg, mesh: ProcessMesh):
    """(tp, ep, sync_axes, specs) of a pipeline mesh: the one derivation the
    step, the eval and the placement share. The gradients sync over the
    data axis (the pipe-replicated leaves also over the pipe axis, which
    `PPTrainStep` adds); ep is the data axis for a MoE model with dp > 1
    (`train/lm.py` `expert_axis`)."""
    tp = TP_AXIS if mesh.tp > 1 else None
    ep = getattr(lmtrain.expert_axis(cfg, mesh), "name", None)
    specs = pp_param_specs(cfg, tp_axis=tp, ep_axis=ep)
    validate_spec_tree(specs, mesh.shape, root="params")
    return tp, ep, (DATA_AXIS,), specs


def pp_optimizer_state_specs(optimizer: str, specs):
    """The optimizer state's specs: sgd and adam follow the parameters; the
    zero variants hold each rank's flat shard of its stage-local leaf over
    the data axis, ``(pipe, data)`` for a stage-sharded leaf (never sharded
    over the pipe axis itself: each stage holds its own chunk's state)."""
    if optimizer == "sgd":
        return specs
    if optimizer == "adam":
        return {"m": specs, "v": specs, "t": P()}

    def leaf_spec(spec):
        return P((PIPE_AXIS, DATA_AXIS)) if PIPE_AXIS in tuple(spec) else P(DATA_AXIS)

    if optimizer == "zero":
        return tree_map(leaf_spec, specs)
    if optimizer == "zero-adam":
        shard = tree_map(leaf_spec, specs)
        return {"m": shard, "v": shard, "t": P()}
    raise ValueError(f"unknown pipeline optimizer {optimizer!r}")


def init_pp_zero_state(params, mesh: ProcessMesh, optimizer: str):
    """ZeRO-1 state for the pipeline mesh: this rank's (ceil(n/dp),) zero
    shard of each of its stage-local leaves (of n elements) over the data
    axis (`parallel/zero.py`), in `tree_leaves` order; zero-adam: m, v and
    the host's counter."""
    leaves = tree_leaves(params)
    if optimizer == "zero":
        return zero.init_zero_momentum_tree(leaves, mesh.data.size)
    if optimizer == "zero-adam":
        return zero.init_zero_adam_tree(leaves, mesh.data.size)
    raise ValueError(f"not a ZeRO optimizer: {optimizer!r}")


def interleave_layer_order(n_layers: int, pp: int, v: int, *, inverse: bool = False) -> np.ndarray:
    """Layer-axis permutation for the interleaved chunk layout.

    Global chunk c (of v*P chunks, L/(v*P) layers each) must live on
    device c % P at local lap c // P, so the pipe-sharded leading axis is
    ordered device-major, lap-minor: position (q*v + l)*cl + j holds
    original layer (l*P + q)*cl + j. `inverse=True` returns the
    permutation that restores the canonical order (for checkpoint export
    or switching schedules).
    """
    if v < 1 or n_layers % (pp * v):
        raise ValueError(
            f"n_layers ({n_layers}) must be divisible by pipeline size x "
            f"interleave ({pp}x{v})"
        )
    cl = n_layers // (pp * v)
    order = np.empty(n_layers, np.int64)
    pos = 0
    for q in range(pp):
        for lap in range(v):
            c = lap * pp + q
            order[pos:pos + cl] = np.arange(c * cl, (c + 1) * cl)
            pos += cl
    if inverse:
        inv = np.empty_like(order)
        inv[order] = np.arange(n_layers)
        return inv
    return order


def shard_pp_params(params, cfg, mesh: ProcessMesh, *, interleave: int = 1):
    """(this rank's parameters on the mesh's device, their specs): the whole
    tree (the same on every rank) with its layer axis permuted into the
    interleaved layout when `interleave` > 1 (`interleave_layer_order`),
    then cut by `pp_param_specs`: this stage's layers, and under a model
    axis this rank's columns or rows. `train/lm.py` `gather_params` is the
    inverse up to that permutation: it gives the layer axis in the
    interleaved order, as the JAX package's sharded tree holds it."""
    specs = pp_wiring(cfg, mesh)[3]
    if interleave > 1:
        order = torch.from_numpy(interleave_layer_order(cfg.n_layers, mesh.pp, interleave))
        params = dict(params, layers={k: x[order] for k, x in params["layers"].items()})
    params = tfm.to_device(params, mesh.device)
    if mesh.world > 1:
        params = tree_map(lambda x, s: lmtrain._local_shard(x, s, mesh), params, specs)
    return params, specs


def _check_schedule(cfg, mesh: ProcessMesh, n_microbatches: int, interleave: int) -> None:
    """The JAX `make_pp_train_step` checks of the layer count and the
    interleaved schedule."""
    pp, v = mesh.pp, interleave
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    if cfg.n_layers % (pp * v):
        raise ValueError(
            f"n_layers ({cfg.n_layers}) must be divisible by pipeline size "
            f"x interleave ({pp}x{v})"
        )
    if v > 1 and n_microbatches % pp:
        raise ValueError(
            f"the interleaved schedule runs microbatches in groups of the "
            f"pipeline size: n_microbatches ({n_microbatches}) must be a "
            f"multiple of {pp}"
        )


def _chunk_ce_weighted(xc, head, tc, w):
    logp = F.log_softmax((xc @ head).float(), dim=-1)
    ll = logp.gather(-1, tc[..., None])[..., 0]
    return -(ll.sum(-1) * w).sum()


def head_ce(h, head, targets, weights, n_chunks: int):
    """The weighted next-token CE sum of this stage's dealt rows: h (rows,
    S, d) final-norm hidden in the model dtype, targets (rows, S), weights
    (rows,) (0 for a padding microbatch), in `n_chunks` sequence chunks,
    each under `torch.utils.checkpoint` (its (rows, S/n, V) f32 logits exist
    only while it runs). The one place the pipeline does vocab-sized work."""
    s = h.shape[1]
    cs = s // n_chunks
    head = head.to(h.dtype)
    total = torch.zeros((), device=h.device)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(_chunk_ce_weighted, h[:, sl], head, targets[:, sl], weights,
                                   use_reentrant=False, preserve_rng_state=False)
    return total


def pipeline_lm_loss(params, tokens, targets, cfg, *, mesh: ProcessMesh, n_microbatches: int,
                     loss_chunks: int = 0, interleave: int = 1):
    """This rank's share of the mean next-token cross-entropy through the
    microbatch schedule: the CE sum of the microbatches dealt to this stage
    over the global token count (every data shard's tokens), plus, for a
    MoE model, `train/lm.py` `AUX_WEIGHT` x the aux of this rank's
    microbatch ticks over m x L x dp. Its sum over the (data, pipe) ranks is the JAX
    `pipeline_lm_loss`; every rank of the mesh must call it (its ppermutes
    and all-to-alls are collectives).

    tokens / targets: this data shard's (B_local, S) rows; params: this
    rank's stage (and model) shard (`shard_pp_params`). `loss_chunks`: the
    CE's sequence chunks (0: `auto_loss_chunks` on the dealt rows).
    `interleave` = v: the circular schedule (module docstring)."""
    pipe = mesh.pipe
    n_pipe, stage = pipe.size, pipe.index
    tp_axis = mesh.tp_axis
    m, v = n_microbatches, interleave
    b_local, s = tokens.shape
    if b_local % m:
        raise ValueError(f"the local batch ({b_local} rows) must divide into {m} microbatches")
    if v > 1 and m % n_pipe:
        raise ValueError(f"the interleaved schedule needs whole groups: {m} microbatches over "
                         f"{n_pipe} stages")
    mb = b_local // m
    dt = cfg.dtype
    tok_mb = tokens.reshape(m, mb, s)
    tgt_mb = targets.reshape(m, mb, s)
    pe = tfm._sinusoid_pe(torch.arange(s, device=tokens.device), cfg.d_model, dt)[None]
    n_local = params["layers"]["wq"].shape[0]
    cl = n_local // v
    ep_axis = lmtrain.expert_axis(cfg, mesh)
    cap = (expert_capacity(mb * s, cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor)
           if cfg.n_experts else None)

    def attend(q, k, v_):
        return attention(q, k, v_, causal=True)

    def chunk_blocks(x, lap):
        """This rank's layer chunk of the given lap (the local leaves are
        (v, L/(v*P)) stacked lap-major): (x, the MoE aux summed over the
        chunk's layers, None for a dense model)."""
        auxes = []
        for i in range(lap * cl, (lap + 1) * cl):
            def block(x, i=i):
                return tfm.transformer_block(x, tfm._layer(params, i, dt), cfg, attend, tp_axis,
                                             ep_axis, cap)

            x, aux = tfm.remat_block(block, x, cfg) if cfg.remat else block(x)
            auxes.append(aux)
        return x, (torch.stack(auxes).sum() if cfg.n_experts else None)

    # exit blocks: microbatch j = g*P + mm finishes its last lap on the last
    # stage at tick g*v*P + mm + v*P - 1 (garbage on the other stages)
    j = np.arange(m)
    exit_ticks = (j // n_pipe) * (v * n_pipe) + j % n_pipe + v * n_pipe - 1
    exits = {}
    aux_sum = torch.zeros((), device=tokens.device) if cfg.n_experts else None
    n_ticks = v * m + n_pipe - 1
    perm = [(i, (i + 1) % n_pipe) for i in range(n_pipe)]
    feed = torch.ones((), dtype=torch.bool, device=tokens.device)
    x_in = torch.zeros(mb, s, cfg.d_model, dtype=dt, device=tokens.device)
    for t in range(n_ticks):
        # invert the schedule at this rank: work (g, m_in_group, lap) runs
        # here at tick t = g*v*P + m + lap*P + stage
        u = t - stage
        vp = v * n_pipe
        g = u // vp
        r = u - g * vp
        lap = min(max(r // n_pipe, 0), v - 1)
        if stage == 0 and r < n_pipe:
            # stage 0 feeds a fresh microbatch at its lap-0 ticks; the block
            # it received still feeds the graph (its gradient is zero), so
            # that ppermute's backward runs here as on every rank
            mb_idx = min(max(g * n_pipe + r, 0), m - 1)
            fresh = params["embed"][tok_mb[mb_idx]].to(dt) + pe
            x = torch.where(feed, fresh, x_in)
        else:
            x = x_in
        out, aux = chunk_blocks(x, lap)
        if cfg.n_experts and 0 <= u < v * m:
            # a bubble tick computes on garbage: its aux is masked as its
            # output is discarded
            aux_sum = aux_sum + aux
        if t in exit_ticks:
            exits[t] = out
        if t < n_ticks - 1:  # the last tick's rotation would feed nothing
            x_in = ppermute(out, perm, pipe)

    mp = -(-m // n_pipe) * n_pipe
    k = mp // n_pipe
    blocks = [exits[t] for t in exit_ticks.tolist()]
    if mp > m:
        blocks += [torch.zeros_like(blocks[0])] * (mp - m)
        tgt_mb = torch.cat([tgt_mb, tgt_mb.new_zeros(mp - m, mb, s)], 0)
    w_mb = (torch.arange(mp, device=tokens.device) < m).float()
    # deal the microbatches round-robin over the stages: after the
    # all-to-all, rows [(P-1)*k, P*k) on stage q are the LAST stage's exits
    # of the global microbatches [q*k, (q+1)*k)
    dealt = all_to_all(torch.stack(blocks), 0, 0, pipe)
    mine = dealt[(n_pipe - 1) * k:n_pipe * k]
    my_tgt = tgt_mb[stage * k:(stage + 1) * k]
    my_w = w_mb[stage * k:(stage + 1) * k]
    rows = k * mb
    h = tfm._layer_norm(mine, params["lnf_scale"], params["lnf_bias"]).to(dt)
    n_chunks = loss_chunks or lmtrain.auto_loss_chunks(rows, s, cfg.vocab_size)
    if s % n_chunks:
        raise ValueError(f"loss chunks {n_chunks} must divide the sequence length {s}")
    loss_sum = head_ce(h.reshape(rows, s, cfg.d_model), params["head"], my_tgt.reshape(rows, s),
                       my_w.repeat_interleave(mb), n_chunks)
    # the global token count: every data shard holds tokens.numel() tokens
    loss = loss_sum / float(tokens.numel() * mesh.data.size)
    if cfg.n_experts:
        # summed over (data, pipe): every stage and lap of m microbatches on
        # each data shard, m x L layer instances a shard
        loss = loss + lmtrain.AUX_WEIGHT * aux_sum / float(m * cfg.n_layers * mesh.data.size)
    return loss


class PPTrainStep(lmtrain.LMTrainStep):
    """`step(params, mom, tokens, targets, step_i=None)` -> the global mean
    loss; the `train/lm.py` step (its program, loop transforms, optimizers
    and ZeRO split) with the pipeline's forward and backward and its sync:
    the layer leaves' gradients summed over the data axis, the
    pipe-replicated leaves' and the loss over (data, pipe), none divided
    (each rank's loss is its share of the global mean). Under overlap the
    buckets never mix the two (leaves grouped by spec) and each reduces over
    its own group; the clip / health norm sums the layer leaves over the
    pipe axis (their specs). See `make_pp_train_step`."""

    def __init__(self, cfg, *, n_microbatches, interleave, **kw):
        super().__init__(cfg, attn_impl="full", with_health=False, **kw)
        mesh = self.mesh
        self.n_microbatches, self.interleave = n_microbatches, interleave
        self.divisor = 1
        ep = self.ep_axis is not None
        self.inner = mesh.pp > 1 or mesh.tp > 1 or ep
        self.norm_collective = mesh.pp > 1 or mesh.tp > 1 or ep

    def _one(self, params):
        cfg, mesh = self.cfg, self.mesh
        m, v, chunks = self.n_microbatches, self.interleave, self.loss_chunks

        leaves = tree_leaves(params)

        def one(tok, tgt):
            loss = pipeline_lm_loss(params, tok, tgt, cfg, mesh=mesh, n_microbatches=m,
                                    loss_chunks=chunks, interleave=v)
            loss.backward()
            with torch.no_grad():
                for p in leaves:
                    if p.grad is None:  # embed off stage 0: its part of the sum is zero
                        p.grad = torch.zeros_like(p)
            return loss.detach()

        return one

    def _replicated(self, n_leaves: int):
        """The indices of the leaves replicated over the pipe axis."""
        specs = tree_leaves(self.specs)
        assert len(specs) == n_leaves
        return [i for i, s in enumerate(specs) if PIPE_AXIS not in tuple(s)]

    def _sync_sets(self, n_leaves: int):
        rep = self._replicated(n_leaves)
        experts = lmtrain.expert_leaf_indices(self.specs) if self.ep_axis is not None else []
        stage = [i for i in range(n_leaves) if i not in rep and i not in experts]
        sets = [(self.mesh.data_pipe, rep), (self.mesh.data, stage)]
        # the stage's expert leaves vary over the data axis: summed over nothing
        return sets + [(Axis("experts"), experts)] if experts else sets

    def _bucket_replicated(self, layout, n_leaves: int) -> list:
        rep = set(self._replicated(n_leaves))
        # a bucket never mixes specs, so its first leaf speaks for it
        return [lo in rep for lo, _ in layout.buckets]

    def _reducer(self, layout, dev):
        mesh = self.mesh
        rep = self._bucket_replicated(layout, len(layout.shapes))
        if self.optimizer.startswith("zero"):
            return zero.ShardReducer(layout, mesh, dev, divisor=1,
                                     extra=[mesh.pipe.group if r else None for r in rep])
        return BucketReducer(layout, mesh, dev, divisor=1,
                             groups=[(mesh.data_pipe if r else mesh.data).group for r in rep])


def make_pp_train_step(cfg, mesh: ProcessMesh, *, device=None, n_microbatches: int = 2,
                       lr: float = 0.1, momentum: float = 0.9, loss_chunks: int = 0,
                       interleave: int = 1, lr_schedule=None, clip_norm: float = 0.0,
                       weight_decay: float = 0.0, optimizer: str = "sgd", accum_steps: int = 1,
                       grad_sync: str = "end", bucket_mb: float = 4.0) -> PPTrainStep:
    """The pipeline-parallel step over a (data, pipe, model) mesh: `step(params,
    mom, tokens, targets, step_i=None)` -> loss, parameters and state
    updated in place (the JAX package's returns new trees).

    tokens / targets: this rank's data shard, (B/dp, S), B divisible by dp *
    accum_steps * n_microbatches; parameters from `shard_pp_params(...,
    interleave=interleave)`. accum_steps = k > 1 runs k schedule passes over
    B/k-row slices and averages the gradients (each pass pays its own
    bubble). The loop transforms as `train/lm.py` `make_lm_train_step`: lr
    from `lr_schedule(step_i)`, clip by the mesh-aware global norm (layer
    leaves summed over the pipe axis and any model axis, the replicated ones
    counted once), decoupled weight decay; optimizer sgd, adam, zero or
    zero-adam (ZeRO-1: each rank's flat shard of its stage-local leaves over
    the data axis, `init_pp_zero_state`; not with a model axis).
    grad_sync="overlap" (accum_steps >= 2) reduces per micro-batch and leaf
    bucket, leaves grouped by spec (a stage chunk never shares a bucket with
    the replicated leaves): the layer buckets over the data axis, the
    replicated ones over (data, pipe)."""
    _check_schedule(cfg, mesh, n_microbatches, interleave)
    if optimizer not in ("sgd", "adam", "zero", "zero-adam"):
        raise ValueError(
            f"pipeline optimizer must be one of sgd/adam/zero/zero-adam, "
            f"got {optimizer!r}"
        )
    if optimizer.startswith("zero") and mesh.tp > 1:
        raise ValueError(
            f"optimizer={optimizer!r} under --pp shards optimizer state "
            "over the data axis per stage-local leaf; tensor-sharded "
            "leaves (tp > 1) additionally vary over 'model', which the "
            "flat per-leaf layout does not track - use 'sgd'/'adam' with "
            "tp (matches the dp x sp x tp mesh path's rule)"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _, ep, _, specs = pp_wiring(cfg, mesh)
    if optimizer.startswith("zero") and ep:
        raise ValueError(
            f"optimizer={optimizer!r} under --pp cannot combine with expert parallelism: "
            "expert-sharded leaves vary over the data axis, which is exactly the axis the "
            "per-leaf ZeRO layout shards state over (same rule as the mesh path)")
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"unknown grad_sync {grad_sync!r} (use one of {GRAD_SYNCS})")
    if grad_sync == "overlap" and ep:
        raise ValueError(
            "grad_sync='overlap' psums every gradient bucket over the data axis, but "
            "expert-sharded leaves VARY over that axis - use grad_sync='end' with expert "
            "parallelism (same rule as the mesh path)")
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    validate_spec_tree(pp_optimizer_state_specs(optimizer, specs), mesh.shape,
                       root="optimizer state")
    return PPTrainStep(cfg, n_microbatches=n_microbatches, interleave=interleave, mesh=mesh,
                       device=device, lr=lr, momentum=momentum, optimizer=optimizer,
                       loss_chunks=loss_chunks, lr_schedule=lr_schedule, clip_norm=clip_norm,
                       accum_steps=accum_steps, weight_decay=weight_decay, grad_sync=grad_sync,
                       bucket_bytes=max(int(bucket_mb * 2**20), 1), specs=specs)


class PPEvalLoss(lmtrain.EvalLoss):
    """(params, tokens, targets) -> the held-out mean loss through the same
    schedule, no gradient: every rank passes its data shard's rows, and the
    shares are summed over (data, pipe). One program at the shape of its
    first call (under gloo one eager part: collectives inside)."""

    def __init__(self, cfg, *, mesh: ProcessMesh, n_microbatches: int, loss_chunks: int,
                 interleave: int):
        super().__init__(cfg, attn_impl="full", loss_chunks=loss_chunks, mesh=mesh)
        self.n_microbatches, self.interleave = n_microbatches, interleave

    def __call__(self, params, tokens, targets):
        cfg, mesh, out = self.cfg, self.mesh, self._out
        m, v, chunks = self.n_microbatches, self.interleave, self.loss_chunks

        def build(tok, tgt):
            @torch.no_grad()
            def fn():
                loss = pipeline_lm_loss(params, tok, tgt, cfg, mesh=mesh, n_microbatches=m,
                                        loss_chunks=chunks, interleave=v)
                group = mesh.data_pipe.group
                if group is not None:
                    dist.all_reduce(loss, group=group)
                out["loss"] = loss

            if mesh.joined and mesh.backend != "nccl":
                return [lmtrain.Eager(fn, "eager forward (pipe/model collectives inside)")]
            return [fn]

        self._run(self._bind(tree_leaves(params), (tokens, targets), build), (tokens, targets),
                  [])
        return out["loss"].clone()


def make_pp_eval_fn(cfg, mesh: ProcessMesh, *, n_microbatches: int = 2, loss_chunks: int = 0,
                    interleave: int = 1) -> PPEvalLoss:
    """(params, tokens, targets) -> the held-out mean loss through the
    training schedule, no gradient (`PPEvalLoss`); the wiring is the step's."""
    _check_schedule(cfg, mesh, n_microbatches, interleave)
    return PPEvalLoss(cfg, mesh=mesh, n_microbatches=n_microbatches, loss_chunks=loss_chunks,
                      interleave=interleave)
