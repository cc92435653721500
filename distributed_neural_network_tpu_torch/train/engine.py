"""The training engine: one trainer, three regimes (counterpart of the JAX
package's `train/engine.py`).

- ``single``        - one worker, the full split;
- ``replication``   - N workers, each training the full split with its own
                      shuffle; the split is one tensor that all share;
- ``data_parallel`` - N workers on contiguous 1/N row shards (remainder
                      dropped) of one tensor.

The N workers form a replica group (`parallel/mesh.py`). A process holds a
contiguous block of them, all N unless it joined a torch.distributed group
of w ranks (`parallel/distributed.py`), then N/w. Its workers are stacked
on a leading axis: one `ReplicaNetwork` holds their parameters as (N/w,
...) tensors, the momentum is stacked alike, and one step of the model
serves all of them (the counterpart of the JAX engine's `shard_map` over N
devices). Per epoch:

1. **train** - `sync_mode="epoch"`: every worker's local-SGD epoch (faithful
   local SGD; momentum reset per epoch when `reset_momentum`).
   `sync_mode="step"`: the same steps with a gradient mean over the group,
   gathered in one buffer (``grad_sync="end"``) or one per leaf bucket of
   at most ``bucket_mb`` MiB a replica (``"overlap"``, one collective
   each); both give the same bits.
2. **sync** - the fault-masked parameter mean over the group, and the global
   train loss as sum(loss sums)/sum(batch counts) over live workers.
3. **eval** - over the test split padded to N equal per-worker partitions
   (padding rows weigh 0), as the JAX engine does, so `val_loss` - a mean of
   per-batch means - groups batches exactly as JAX does.

Every value that crosses workers (parameters with the loss sums, step
gradients, eval sums) is packed into one buffer and gathered over the ranks
(`parallel/collectives.py` `RowGather`: one collective per sync), and every
rank reduces the same (N, ...) stack, so the metrics are equal on every rank
and the sync is the one-process sync, bit for bit, for any layout. The global
live mask and every worker's shuffle are keyed by the global worker index,
so a worker sees the same rows wherever it runs.

Data (``input_mode``): ``hbm`` uploads this rank's part of the split once
(its workers' shards under data_parallel, else the full split) and each
step gathers its rows on the device; ``stream`` keeps the train split in
host RAM (uint8 where the loader kept it), assembles each step's batch for
this rank's workers on the host (`data/stream.py`, native gather +
normalize, prefetched on a thread) and copies it from pinned memory into the
step program's static buffers. Eval stays on the device either way.
``compute_dtype="bfloat16"`` runs the model's convolutions in bf16
(`models/cnn.py`); parameters, momentum and the loss stay f32.

Each phase is a `train/graphs.py` `Program` over static buffers (the
epoch's stacked plan or batch, the live mask, a step counter on the device,
the gather buffers): on the card CUDA graphs, captured at the first epoch,
so a phase issues no per-kernel launch from the host and reads nothing
back; on the CPU the same functions run eagerly. A collective under NCCL is
captured with the rest; under gloo it runs eagerly between the graphs of
its program. `run_span` runs several epochs with one read of their metrics
at the end (the JAX `--fused` span). `_capture = False` before the first
epoch runs the programs eagerly on the card too (the graphed run is held to
that run bit for bit).

The shuffle orders and fault masks come from `torch.Generator`s (in stream
mode the shuffle is numpy's, the JAX stream's own) and differ from the JAX
package's; `orders` and `masks` hooks let a caller inject any.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..data.cifar10 import Split
from ..data.pipeline import gather_batch, shuffle_generator, stacked_plan
from ..data.stream import HostStream, prefetch
from ..device import resolve_device
from ..models.cnn import (
    COMPUTE_DTYPES,
    KERNELS,
    ReplicaNetwork,
    from_jax_params,
    to_jax_params,
)
from ..ops import fused_head
from ..ops.sgd import init_momentum
from ..ops.schedule import GRAD_SYNCS
from ..ops.train import GradSync, apply_mean_grads, eval_epoch, grad_step, train_step
from ..parallel.collectives import (
    RowGather,
    effective_mask,
    masked_mean,
    pack,
    unpack,
    weighted_mean_scalar,
)
from ..parallel.fault import live_mask, straggler_sleep
from ..parallel.mesh import create_mesh, device_count
from ..parallel.partition import shard_size
from ..utils import timers as T
from ..utils import tracing as TR
from ..utils.goodput import LEDGER
from .graphs import Eager, Program, capture_all

REGIMES = ("single", "data_parallel", "replication")
SYNC_MODES = ("epoch", "step")
INPUT_MODES = ("hbm", "stream")

SLICE4 = "slice 4, robustness + observability (ROADMAP.md Queue 1 item 4)"

# TrainConfig fields this port leaves for later: (default, the item that brings it)
LATER_FIELDS = {
    "dynamics": (False, SLICE4),
}


@dataclass
class TrainConfig:
    """Typed config; field names follow the JAX package's TrainConfig."""

    lr: float = 0.001
    momentum: float = 0.9
    batch_size: int = 16
    epochs: int = 25
    nb_proc: int | None = None  # replica-group size; None = one per device
    regime: str = "data_parallel"
    sync_mode: str = "epoch"  # "epoch" = faithful local SGD; "step" = grad mean
    reset_momentum: bool = True
    failure_probability: float = 0.0
    failure_duration: float = 0.0
    seed: int = 0
    eval_batch_size: int | None = None
    kernels: str = "torch"  # "cuda" = the hand-written fused head kernel
    reference_compat: bool = False  # True: N-1 workers as in the reference
    input_mode: str = "hbm"  # "stream": the train split stays in host RAM
    stream_prefetch: int = 2  # stream mode: batches assembled ahead on a thread
    # sync_mode="step": "end" = one gather of every gradient, "overlap" = one
    # per size-capped contiguous leaf bucket (ops/train.py GradSync); the
    # same values either way; no effect in "epoch" mode
    grad_sync: str = "end"
    bucket_mb: float = 4.0
    compute_dtype: str = "float32"  # "bfloat16": the convolutions in bf16
    dynamics: bool = False

    def __post_init__(self):
        for name, allowed in (("regime", REGIMES), ("sync_mode", SYNC_MODES),
                              ("kernels", KERNELS), ("input_mode", INPUT_MODES),
                              ("compute_dtype", tuple(COMPUTE_DTYPES))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)}")
        if self.grad_sync not in GRAD_SYNCS:
            raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got {self.grad_sync}")
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")
        if self.stream_prefetch < 0:
            raise ValueError(f"stream_prefetch must be >= 0, got {self.stream_prefetch}")
        for name, (default, later) in LATER_FIELDS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet; it comes with {later}"
                )


@dataclass
class EpochMetrics:
    epoch: int
    train_loss: float
    val_loss: float | None
    val_acc: float | None
    n_live: int


def _float32(images: np.ndarray, what: str) -> np.ndarray:
    if images.dtype != np.float32:
        raise TypeError(f"{what} must be normalized float32 images, got {images.dtype} "
                        "(only input_mode='stream' takes a uint8 train split)")
    return images


class Engine:
    """`orders(epoch, worker)` returns that worker's row order for the epoch
    (a permutation of its local rows; `worker` is the global index);
    `masks(epoch)` returns the epoch's global live mask. Both default to the
    port's own streams; in stream mode the stream's shuffle is the order.

    Telemetry (the JAX engine's): `tracer` (`utils/tracing.py`) gets the
    ``train_step`` / ``train_span``, ``sync``, ``eval`` and ``straggler``
    spans on their tracks, each closed after the phase's fence; a
    `StepStats` set as ``engine.step_stats`` one record per epoch or span
    (the first, which builds the kernels and captures the graphs, the
    compile step); the process's `utils/goodput.py` LEDGER (a no-op until
    started) one step span per epoch or span, train and sync."""

    def __init__(self, config: TrainConfig, train_split: Split,
                 test_split: Split | None, *, device="cuda", orders=None,
                 masks=None, tracer=None):
        self.config = c = config
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else TR.NULL_TRACER
        self.step_stats = None
        # cuDNN runs float32 convolutions in TF32 by default (about three
        # decimal digits); the port's numbers are held to the float32
        # numpy oracle, so both TF32 switches stay off. Deterministic cuDNN
        # algorithms keep the trajectory bitwise reproducible run to run,
        # as the fused head's backward is.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        if c.regime == "single":
            n_workers = 1
        else:
            n = c.nb_proc if c.nb_proc is not None else device_count(self.device)
            n_workers = (n - 1) if c.reference_compat else n
            if n_workers < 1:
                raise ValueError(f"need >=1 workers, got nb_proc={c.nb_proc}")
        if orders is not None and c.input_mode == "stream":
            raise ValueError("input_mode='stream' shuffles with its own streams; "
                             "orders= applies to input_mode='hbm'")
        self.n_workers = n_workers
        self.mesh = create_mesh(n_workers, self.device)
        self._orders = orders
        self._masks = masks
        self._place_data(train_split, test_split)
        self._build_state()
        self._build_programs()
        self._capture = self.device.type == "cuda"
        self._recaptured = False
        self.history: list[EpochMetrics] = []

    # ---------------------------------------------------------------- data

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def _place_data(self, train_split: Split, test_split: Split | None):
        """This rank's part of the data. `bounds[i]` is the row range of its
        i-th worker (a data_parallel shard, else the whole split); in hbm
        mode one device tensor holds their union and `train_offsets[i]` is
        worker i's first row in it. The test split is padded to N equal
        partitions, of which the rank uploads its workers'."""
        c, g = self.config, self.mesh
        if c.regime == "data_parallel":
            p = shard_size(len(train_split), self.n_workers)
            if p < 1:
                raise ValueError(
                    f"{len(train_split)} rows cannot shard over {self.n_workers} workers")
            bounds = [(d * p, (d + 1) * p) for d in g.workers]
        else:  # single / replication: every worker reads the full split
            p = len(train_split)
            bounds = [(0, p)] * g.local
        self.local_train_rows = p
        self.train_images = self.train_labels = self._host_train = None
        if c.input_mode == "stream":
            self._host_train = (train_split.images, train_split.labels, bounds)
        else:
            lo, hi = bounds[0][0], bounds[-1][1]
            images = _float32(train_split.images, "the hbm train split")
            self.train_images = self._to_device(images[lo:hi])
            self.train_labels = self._to_device(train_split.labels[lo:hi], torch.int64)
            self.train_offsets = [b[0] - lo for b in bounds]
        self.test_images = None
        if test_split is not None:
            total, n = len(test_split), self.n_workers
            q = -(-total // n)
            pad = n * q - total
            rows = slice(g.first * q, (g.first + g.local) * q)
            images = _float32(test_split.images, "the test split")
            self.test_images = self._to_device(np.concatenate(
                [images, np.zeros((pad, *images.shape[1:]), np.float32)])[rows])
            self.test_labels = self._to_device(
                np.concatenate([test_split.labels, np.zeros(pad, np.int32)])[rows],
                torch.int64)
            self.test_weights = self._to_device(
                np.concatenate([np.ones(total, np.float32), np.zeros(pad, np.float32)])[rows])
            self.local_test_rows = q
            # the rank's workers' partitions in order (the JAX eval plan), stacked
            self.eval_idx, self.eval_w = stacked_plan(
                [torch.arange(q)] * g.local, q, c.eval_batch_size or c.batch_size,
                [i * q for i in range(g.local)], self.device)

    def default_order(self, epoch: int, worker: int) -> torch.Tensor:
        """The port's shuffle for (seed, epoch, global worker): in stream
        mode the numpy stream `HostStream` draws, else a torch.Generator's."""
        c, n = self.config, self.local_train_rows
        if c.input_mode == "stream":
            return torch.from_numpy(np.random.default_rng((c.seed, epoch, worker)).permutation(n))
        return torch.randperm(n, generator=shuffle_generator(c.seed, epoch, worker))

    def epoch_plan(self, epoch: int):
        """The epoch's stacked plan (idx, w), each (N/w, steps, batch), on
        the host: this rank's workers, offset into its train tensor."""
        order = self._orders or self.default_order
        return stacked_plan([order(epoch, d) for d in self.mesh.workers],
                            self.local_train_rows, self.config.batch_size, self.train_offsets)

    def epoch_mask(self, epoch: int) -> np.ndarray:
        """The epoch's global (N,) live mask (the same on every rank)."""
        c = self.config
        return live_mask(c.seed, epoch, self.n_workers, c.failure_probability,
                         mask=None if self._masks is None else self._masks(epoch))

    def _stream_batches(self, epoch: int):
        """Stream mode: the epoch's batches for this rank's workers, each
        (images (N/w, B, 32, 32, 3) float32, labels (N/w, B) int64, weights
        (N/w, B) float32) as CPU tensors, pinned for the card; assembled
        `stream_prefetch` steps ahead on a thread."""
        c = self.config
        images, labels, bounds = self._host_train
        streams = [HostStream(images[lo:hi], labels[lo:hi], c.batch_size,
                              seed=(c.seed, epoch, d))
                   for d, (lo, hi) in zip(self.mesh.workers, bounds)]
        pin = self.device.type == "cuda"

        def assemble():
            for batches in zip(*(s.epoch() for s in streams)):
                x, y, w = (np.stack(parts) for parts in zip(*batches))
                out = [torch.from_numpy(a) for a in (x, y.astype(np.int64), w)]
                # the caching host allocator keeps a pinned block until the
                # copy that reads it has run
                yield [t.pin_memory() for t in out] if pin else out

        return prefetch(assemble(), c.stream_prefetch) if c.stream_prefetch else assemble()

    # --------------------------------------------------------------- state

    def _build_state(self):
        """The stacked parameters and momentum (every worker starts from the
        one `Network` the seed draws) and the programs' static buffers."""
        c, n, dev = self.config, self.mesh.local, self.device
        g = torch.Generator()
        g.manual_seed(c.seed)
        self.net = ReplicaNetwork(n, kernels=c.kernels, generator=g,
                                  compute_dtype=COMPUTE_DTYPES[c.compute_dtype]).to(dev)
        self.params = list(self.net.parameters())
        self.mom = init_momentum(self.params)
        steps = -(-self.local_train_rows // c.batch_size)
        if c.input_mode == "stream":
            self.batch = (torch.zeros(n, c.batch_size, 32, 32, 3, device=dev),
                          torch.zeros(n, c.batch_size, dtype=torch.int64, device=dev),
                          torch.zeros(n, c.batch_size, device=dev))
        else:
            self.plan_idx = torch.zeros(n, steps, c.batch_size, dtype=torch.int64, device=dev)
            self.plan_w = torch.zeros(n, steps, c.batch_size, device=dev)
        self.steps = steps
        self.mask = torch.ones(self.n_workers, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.loss_sums = torch.zeros(n, device=dev)
        # train_loss, n_live, val_loss, val_acc of the last epoch
        self.metrics = torch.zeros(4, device=dev)

    def _state(self):
        return [*self.params, *self.mom, self.step, self.loss_sums, self.metrics]

    def state_tree(self):
        """{"params", "mom"} in the JAX engine's tree form with numpy
        leaves: the synced params (the first local worker's) and every
        worker's momentum stacked on a leading axis (N, ...). Across ranks
        each rank's rows are gathered (a collective: every rank calls it)."""
        state = self.net.state_dict()
        names = list(state)
        return {"params": to_jax_params({k: v[0] for k, v in state.items()}),
                "mom": to_jax_params(dict(zip(names, map(self._all_rows, self.mom))))}

    def _all_rows(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's (N/w, ...) rows gathered into the (N, ...) stack."""
        g = self.mesh
        if not g.joined:
            return local
        from ..parallel.collectives import all_gather, collective_form

        out = torch.empty(g.size * local[0].numel(), dtype=local.dtype, device=local.device)
        all_gather(out, local.reshape(-1), rank=g.rank, form=collective_form())
        return out.view(g.size, *local.shape[1:])

    def load_state_tree(self, tree) -> None:
        """Install a JAX-form state tree (inverse of `state_tree`): the
        params into every worker, and from an (N, ...) momentum stack this
        rank's workers' rows."""
        params, mom = from_jax_params(tree["params"]), from_jax_params(tree["mom"])
        rows = self.mesh.workers
        with torch.no_grad():
            for (name, p), m in zip(self.net.named_parameters(), self.mom):
                p.copy_(params[name].expand_as(p))
                m.copy_(mom[name][rows.start:rows.stop])

    def mesh_meta(self) -> dict:
        """The checkpoint meta's save-time topology (`parallel/reshard.py`
        `mesh_topology`): the workers as the data axis."""
        from ..parallel.reshard import mesh_topology

        return mesh_topology(self.mesh, n_workers=self.n_workers)

    @property
    def images_per_epoch(self) -> int:
        """Images trained on per epoch over all workers (each trains its
        rows once; replication counts every replica's pass)."""
        return self.local_train_rows * self.n_workers

    def flops_per_epoch(self) -> tuple[float, str]:
        """(FLOPs of one train epoch, source): the analytic LeNet count
        (`models/cnn.py` `flops_per_image`, forward + 2x backward); PyTorch
        has no compiled cost analysis to read instead."""
        from ..models.cnn import flops_per_image

        return 3.0 * flops_per_image() * self.images_per_epoch, "analytic"

    # ------------------------------------------------------------ programs

    def _build_programs(self):
        """The four programs. Each closes over the tensors it reads and
        writes, never over the engine, so that dropping an engine frees its
        graphs at once (a cycle would leave them to the garbage collector,
        which may run during another capture and spoil it)."""
        c, g, counters = self.config, self.mesh, (fused_head.LAUNCHES,)
        net, params, mom = self.net, self.params, self.mom
        at, loss_sums, metrics, mask = self.step, self.loss_sums, self.metrics, self.mask
        n_params = sum(p[0].numel() for p in params)
        n_batches = float(self.steps)
        # the collective part of a program: captured under NCCL, eager
        # between the graphs under gloo, absent in one process
        graphable = g.joined and dist.get_backend() == "nccl"

        def collective(*gathers):
            if not g.joined:
                return ()
            return tuple(x.reduce if graphable else Eager(x.reduce) for x in gathers)

        if c.input_mode == "stream":
            batch_x, batch_y, batch_w = self.batch

            def batch():
                return batch_x, batch_y, batch_w
        else:
            plan_idx, plan_w = self.plan_idx, self.plan_w
            images, labels = self.train_images, self.train_labels

            def batch():
                x, y = gather_batch(images, labels, plan_idx.index_select(1, at).squeeze(1))
                return x, y, plan_w.index_select(1, at).squeeze(1)

        def begin():
            at.zero_()
            loss_sums.zero_()
            if c.reset_momentum:
                torch._foreach_zero_(mom)

        if c.sync_mode == "step":
            sync = GradSync(g, params, grad_sync=c.grad_sync,
                            bucket_bytes=int(c.bucket_mb * 2**20))

            def step_grads():
                loss_sums.add_(grad_step(net, *batch(), sync))

            def step_apply():
                apply_mean_grads(net, mom, sync, lr=c.lr, momentum=c.momentum)
                at.add_(1)

            step_parts = (step_grads, *collective(*sync.gathers), step_apply)
        else:
            def step():
                loss_sums.add_(train_step(net, mom, *batch(), lr=c.lr, momentum=c.momentum))
                at.add_(1)

            step_parts = (step,)

        # the parameters and the loss sums, one row per worker: one collective
        state = RowGather(g, (n_params + 1,))

        @torch.no_grad()
        def sync_put():
            state.put(torch.cat([pack(params, g.local), loss_sums.unsqueeze(1)], 1))

        @torch.no_grad()
        def sync_mean():
            buf = state.buf
            for p, avg in zip(params, unpack(masked_mean(buf[:, :n_params], mask), params)):
                p.copy_(avg.expand_as(p))
            w_eff = effective_mask(mask)
            metrics[0] = weighted_mean_scalar(buf[:, n_params] * w_eff, n_batches * w_eff)
            metrics[1] = mask.sum()

        self._begin = Program(begin, counters=counters, name="the CNN epoch's start")
        self._step = Program(*step_parts, counters=counters, name="the CNN train step")
        self._sync = Program(sync_put, *collective(state), sync_mean, counters=counters,
                             name="the CNN replica sync")
        self._eval = None
        if self.test_images is not None:
            test = (self.test_images, self.test_labels, self.test_weights, self.eval_idx,
                    self.eval_w)
            sums = RowGather(g, (4,))

            def eval_local():
                sums.put(eval_epoch(net, *test).T)

            def eval_mean():
                loss_sum, n_eval, correct, n_valid = sums.buf.sum(0)
                metrics[2] = loss_sum / n_eval.clamp(min=1.0)
                metrics[3] = 100.0 * correct / n_valid.clamp(min=1.0)

            self._eval = Program(eval_local, *collective(sums), eval_mean, counters=counters,
                                 name="the CNN eval")

    def _programs(self):
        return [p for p in (self._begin, self._step, self._sync, self._eval) if p is not None]

    def compile(self) -> None:
        """Capture the programs as CUDA graphs (once; on the card only, and
        only while `_capture` holds). The state is left as it was."""
        if self._capture and self._step.segments is None:
            capture_all(self._programs(), self._state(), self.device)

    def _load(self, idx, w, mask) -> None:
        """The epoch's plan and live mask into the static buffers (host or
        device sources; a device source is a copy on the card's queue)."""
        self.plan_idx.copy_(idx)
        self.plan_w.copy_(w)
        self.mask.copy_(mask)

    def _train(self, epoch: int) -> None:
        self._begin()
        if self._host_train is None:
            self._step(self.steps)
            return
        # stream: each batch from pinned host memory into the static
        # buffers, queued on the stream that then replays the step; the
        # per-batch spans are not fenced (host assembly and queueing)
        for i, batch in enumerate(self._stream_batches(epoch)):
            with self.tracer.span(TR.TRAIN_STEP, track="train", step=i, epoch=epoch,
                                  input_mode="stream", fenced=False,
                                  rows=int(batch[0].shape[1])):
                for dst, src in zip(self.batch, batch):
                    dst.copy_(src, non_blocking=True)
                self._step()

    # --------------------------------------------------------------- epochs

    def run_epoch(self, epoch: int, *, timers: T.PhaseTimers | None = None,
                  do_eval: bool = True, log=print) -> EpochMetrics:
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        tracer, c = self.tracer, self.config
        mask = self.epoch_mask(epoch)
        straggler_sleep(mask, c.failure_duration, workers=self.mesh.workers, log=log,
                        tracer=tracer)
        # the span and the step's wall close after the phase's fence; the
        # first epoch's hold the graphs' capture (and the kernels' build)
        t_step = time.perf_counter()
        with tracer.span("train_epoch" if self._host_train is not None else TR.TRAIN_STEP,
                         track="train", step=epoch, regime=c.regime, input_mode=c.input_mode):
            # a rebuild's capture is compile time, not this epoch's step
            with LEDGER.interval("compile") if self._recaptured else nullcontext():
                self.compile()
            self._recaptured = False
            if self._host_train is None:
                self._load(*self.epoch_plan(epoch), torch.tensor(mask))
            else:
                self.mask.copy_(torch.tensor(mask))
            with timers.phase(T.TRAINING):
                self._train(epoch)
        if self.step_stats is not None:
            self.step_stats.record(epoch, time.perf_counter() - t_step,
                                   items=self.images_per_epoch)
        with tracer.span(TR.SYNC, track="sync", step=epoch):
            with timers.phase(T.COMMUNICATION):
                self._sync()
        # goodput: train and sync are the epoch's progress; eval falls to idle_other
        LEDGER.step_span(epoch, time.perf_counter() - t_step, tokens=self.images_per_epoch)
        do_eval = do_eval and self._eval is not None
        if do_eval:
            with tracer.span(TR.EVAL, track="eval", step=epoch):
                with timers.phase(T.EVALUATION):
                    self._eval()
        if self.step_stats is not None:
            self.step_stats.capture_memory(tracer)
        train_loss, _, val_loss, val_acc = self.metrics.tolist()
        m = EpochMetrics(epoch, train_loss, val_loss if do_eval else None,
                         val_acc if do_eval else None, int(mask.sum()))
        self.history.append(m)
        return m

    def run_span(self, epoch0: int, span: int, *, eval_inside: bool = True,
                 timers: T.PhaseTimers | None = None) -> list[EpochMetrics]:
        """Run `span` epochs starting at `epoch0` with no host read between
        them (the JAX engine's fused span): each epoch is train, masked sync
        and (with `eval_inside` and a test split) eval, replayed from the
        captured programs; the plans and the (span, N) fault masks are
        uploaded first, and the per-epoch metrics come back as one stacked
        tensor read at the end. Fault masks are those of `run_epoch`;
        straggler sleeps do not apply inside a span. Timing is charged to
        TRAINING, eval included, as the JAX engine does. Needs hbm data."""
        if self._host_train is not None:
            raise ValueError("run_span needs HBM-resident data; input_mode='stream' "
                             "runs per epoch")
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        eval_inside = eval_inside and self._eval is not None
        epochs = range(epoch0, epoch0 + span)
        masks = np.stack([self.epoch_mask(e) for e in epochs])
        plans = [self.epoch_plan(e) for e in epochs]
        idx = torch.stack([i for i, _ in plans]).to(self.device)
        w = torch.stack([w for _, w in plans]).to(self.device)
        masks_dev = torch.from_numpy(masks).to(self.device)
        out = torch.zeros(span, 4, device=self.device)
        t_step = time.perf_counter()
        with self.tracer.span(TR.TRAIN_SPAN, track="train", epoch0=epoch0, span=span,
                              eval_inside=eval_inside):
            self.compile()
            with timers.phase(T.TRAINING):
                for i in range(span):
                    self._load(idx[i], w[i], masks_dev[i])
                    self._train(epochs[i])
                    self._sync()
                    if eval_inside:
                        self._eval()
                    out[i].copy_(self.metrics)
        wall = time.perf_counter() - t_step
        # one span is one record and one ledger step over its epochs
        if self.step_stats is not None:
            self.step_stats.record(epoch0, wall, items=span * self.images_per_epoch)
            self.step_stats.capture_memory(self.tracer)
        LEDGER.step_span(epoch0 + span - 1, wall, tokens=span * self.images_per_epoch)
        metrics = [
            EpochMetrics(e, tl, vl if eval_inside else None, va if eval_inside else None,
                         int(nl))
            for e, (tl, nl, vl, va) in zip(epochs, out.tolist())
        ]
        self.history.extend(metrics)
        return metrics

    # ------------------------------------------------------------------ run

    def run(self, *, timers: T.PhaseTimers | None = None, run=None, log=print,
            eval_every: int = 1, fused: bool = False, checkpointer=None,
            start_epoch: int = 0, preemption=None, guard=None) -> list[EpochMetrics]:
        """Full training run; `run` is a MetricsRun-like sink
        (`utils/metrics.py`). `fused=True` runs multi-epoch spans
        (`run_span`, split at checkpoint and eval boundaries) instead of one
        read per epoch; stream mode (no HBM-resident data), straggler
        sleeps (`failure_duration`, which can only fall between epochs) and
        the guard force the per-epoch path, each with a line saying so.
        `checkpointer` (`utils/checkpoint.py` `Checkpointer`) saves at epoch
        edges; `start_epoch` > 0 resumes a restored run. `preemption`
        (`train/guard.py` `PreemptionGuard`): when its flag is up on any
        rank at an epoch (or span) boundary, an emergency checkpoint of the
        completed epochs is written (with a `checkpointer`) and the run
        returns early; a resume replays the remaining epochs exactly.

        `guard` (`train/guard.py` `TrainingGuard`) checks the run at epoch
        granularity, as the JAX engine's: one epoch is one step here, so the
        guard observes each epoch's global train loss. 'warn' counts and
        logs; 'skip' drops an anomalous epoch's whole update (the pre-epoch
        snapshot restored, training goes on at the next epoch); 'rollback'
        restores the rolling snapshot, scales the lr down (the programs,
        which hold the lr as a constant, are built and captured again) and
        runs again from the snapshot's epoch; 'abort' raises GuardAbort.
        Every rank observes the same global loss, so the ranks agree."""
        if fused and self.config.input_mode == "stream":
            log("(fused mode needs HBM-resident data; input_mode=stream uses the "
                "per-epoch path)")
            fused = False
        if fused and self.config.failure_duration > 0:
            log(
                "(fused mode does not support --failure-duration straggler "
                "sleeps; using the per-epoch path)"
            )
            fused = False
        if fused and guard is not None:
            log("(fused mode cannot observe per-epoch health inside one dispatch; --guard "
                "uses the per-epoch path)")
            fused = False
        if fused:
            return self._run_fused(timers=timers, run=run, log=log, eval_every=eval_every,
                                   checkpointer=checkpointer, start_epoch=start_epoch,
                                   preemption=preemption)
        base_lr = self.config.lr
        epoch = start_epoch
        while epoch < self.config.epochs:
            if preemption is not None and preemption.agreed():
                self._emergency_save(epoch - 1, checkpointer, preemption, log)
                break
            if guard is not None:
                guard.maybe_snapshot(epoch, self.state_tree, first_step=start_epoch)
            log(f"Starting epoch  {epoch}")
            do_eval = eval_every > 0 and (epoch + 1) % eval_every == 0
            m = self.run_epoch(epoch, timers=timers, do_eval=do_eval, log=log)
            if guard is not None:
                v = guard.observe(epoch, m.train_loss)
                if v.action == "skip" and guard.has_snapshot:
                    # drop this epoch's whole update: the pre-epoch params and
                    # momentum back (the metrics stay in history: they say
                    # what happened)
                    snap_epoch, state = guard.peek_snapshot()
                    self.load_state_tree(state)
                    log(f"(guard: epoch {epoch} update dropped; params restored to epoch "
                        f"{snap_epoch} snapshot)")
                elif v.action == "rollback":
                    rb = guard.rollback(at_step=epoch + 1)  # raises GuardAbort on budget
                    if rb is not None:
                        snap_epoch, state = rb
                        self.load_state_tree(state)
                        # the lr is a constant of the captured programs: build
                        # them again at the scaled lr, captured at the next epoch
                        self.config.lr = base_lr * guard.lr_scale
                        self.rebuild_programs()
                        self.history = [h for h in self.history if h.epoch < snap_epoch]
                        epoch = snap_epoch
                        continue
                    log("(guard: rollback requested but no snapshot yet; continuing with a "
                        "warning)")
            self._log_epoch(m, run, log, start=False)
            if checkpointer is not None:
                checkpointer.maybe_save(epoch, self)
            epoch += 1
        return self.history

    def rebuild_programs(self) -> None:
        """Build the programs again (after a change of `config.lr`, which
        they hold as a constant); the old graphs are freed before the next
        capture (a graph the collector frees during another capture spoils
        it), and that capture counts as compile time in the ledger."""
        import gc

        self._begin = self._step = self._sync = self._eval = None
        gc.collect()
        self._build_programs()
        self._recaptured = True

    def _emergency_save(self, last_epoch, checkpointer, preemption, log) -> None:
        name = preemption.signame
        if last_epoch >= 0 and checkpointer is not None:
            checkpointer.save(last_epoch, self)
            log(f"({name}: emergency checkpoint written at epoch {last_epoch}; resume with "
                "--resume to continue bit-exactly)")
        else:
            log(f"({name}: stopping before the next epoch"
                + ("; no checkpointer configured - progress since the last checkpoint is "
                   "lost)" if checkpointer is None else "; nothing completed yet)"))

    def _run_fused(self, *, timers, run, log, eval_every: int, checkpointer,
                   start_epoch: int, preemption) -> list[EpochMetrics]:
        epochs = self.config.epochs
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        eval_in = eval_every == 1 and self._eval is not None
        e = start_epoch
        while e < epochs:
            if preemption is not None and preemption.agreed():
                # span boundaries are the fused path's step boundaries
                self._emergency_save(e - 1, checkpointer, preemption, log)
                break
            span = epochs - e
            if checkpointer is not None and checkpointer.every > 0:
                span = min(span, checkpointer.every - (e % checkpointer.every))
            if eval_every > 1 and self._eval is not None:
                span = min(span, eval_every - (e % eval_every))
            metrics = self.run_span(e, span, eval_inside=eval_in, timers=timers)
            e += span
            last = metrics[-1]
            if not eval_in and self._eval is not None and eval_every > 0 and e % eval_every == 0:
                with self.tracer.span(TR.EVAL, track="eval", step=e - 1):
                    with timers.phase(T.EVALUATION):
                        self._eval()
                last.val_loss, last.val_acc = self.metrics[2:].tolist()
            for m in metrics:
                self._log_epoch(m, run, log, start=True)
            if checkpointer is not None:
                checkpointer.maybe_save(e - 1, self)
        return self.history

    @staticmethod
    def _log_epoch(m: EpochMetrics, run, log, *, start: bool) -> None:
        if start:
            log(f"Starting epoch  {m.epoch}")
        log(f"Global Average Training Loss: {m.train_loss}")
        if run is not None:
            run.append("train/loss", m.train_loss)
        if m.val_acc is not None:
            log(f"Validation loss of updated master model:  {m.val_loss}")
            log(f"Validation Accuracy: {m.val_acc:.2f} %")
            if run is not None:
                run.append("val/loss", m.val_loss)
                run.append("val/acc", m.val_acc)
