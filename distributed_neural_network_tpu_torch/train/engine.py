"""The training engine: one trainer, three regimes (counterpart of the JAX
package's `train/engine.py`).

- ``single``        - one worker, the full split;
- ``replication``   - N workers, each training the full split with its own
                      shuffle; the split is one tensor that all share;
- ``data_parallel`` - N workers on contiguous 1/N row shards (remainder
                      dropped) of one tensor.

The split is uploaded to the device once. The N workers are a replica group
in one process (`parallel/mesh.py`), stacked on a leading axis: one
`ReplicaNetwork` holds every worker's parameters as (N, ...) tensors, the
momentum is stacked alike, and one step of the model serves all N (the
counterpart of the JAX engine's `shard_map` over N devices). Per epoch:

1. **train** - `sync_mode="epoch"`: every worker's local-SGD epoch (faithful
   local SGD; momentum reset per epoch when `reset_momentum`).
   `sync_mode="step"`: the same steps with a gradient mean over the group.
2. **sync** - the fault-masked parameter mean over the group, and the global
   train loss as sum(loss sums)/sum(batch counts) over live workers.
3. **eval** - over the test split padded to N equal per-worker partitions
   (padding rows weigh 0), as the JAX engine does, so `val_loss` - a mean of
   per-batch means - groups batches exactly as JAX does.

Each phase is a `train/graphs.py` `Program` over static buffers (the
epoch's stacked plan, the live mask, a step counter on the device): on the
card one CUDA graph each (the train step replayed once per step), captured
at the first epoch, so a phase issues no per-kernel launch from the host and
reads nothing back; on the CPU the same functions run eagerly. `run_span`
runs several epochs with one read of their metrics at the end (the JAX
`--fused` span). `_capture = False` before the first epoch runs the programs
eagerly on the card too (the graphed run is held to that run bit for bit).

The shuffle orders and fault masks come from `torch.Generator`s and differ
from the JAX package's; `orders` and `masks` hooks let a caller inject any.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.cifar10 import Split
from ..data.pipeline import shuffle_generator, stacked_plan
from ..device import resolve_device
from ..models.cnn import KERNELS, ReplicaNetwork, from_jax_params, to_jax_params
from ..ops import fused_head
from ..ops.sgd import init_momentum
from ..ops.train import eval_epoch, train_step
from ..parallel.collectives import effective_mask, masked_mean_tree, weighted_mean_scalar
from ..parallel.fault import live_mask, straggler_sleep
from ..parallel.mesh import create_mesh, device_count
from ..parallel.partition import shard_size
from ..utils import timers as T
from .graphs import Program, capture_all

REGIMES = ("single", "data_parallel", "replication")
SYNC_MODES = ("epoch", "step")

SLICE1_LATER = "a later slice-1 PR (ROADMAP.md Queue 1)"
SLICE4 = "slice 4, robustness + observability (ROADMAP.md Queue 1 item 13)"

# TrainConfig fields this slice leaves for later: (default, the slice that brings it)
LATER_FIELDS = {
    "input_mode": ("hbm", SLICE1_LATER + ": host streaming, data/stream.py"),
    "grad_sync": ("end", SLICE1_LATER + ": bucketed gradient sync"),
    "compute_dtype": ("float32", SLICE1_LATER + ": bfloat16 convolutions"),
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
    input_mode: str = "hbm"
    grad_sync: str = "end"
    compute_dtype: str = "float32"
    dynamics: bool = False

    def __post_init__(self):
        if self.regime not in REGIMES:
            raise ValueError(f"regime must be one of {REGIMES}, got {self.regime}")
        if self.sync_mode not in SYNC_MODES:
            raise ValueError(
                f"sync_mode must be one of {SYNC_MODES}, got {self.sync_mode}"
            )
        if self.kernels not in KERNELS:
            raise ValueError(f"kernels must be one of {KERNELS}, got {self.kernels}")
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


class Engine:
    """`orders(epoch, worker)` returns that worker's row order for the epoch
    (a permutation of its local rows); `masks(epoch)` returns the epoch's
    live mask. Both default to the port's own `torch.Generator` streams."""

    def __init__(self, config: TrainConfig, train_split: Split,
                 test_split: Split | None, *, device="cuda", orders=None,
                 masks=None):
        self.config = c = config
        self.device = resolve_device(device)
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
        self.n_workers = n_workers
        self.mesh = create_mesh(n_workers, self.device)
        self._orders = orders
        self._masks = masks
        self._place_data(train_split, test_split)
        self._build_state()
        self._build_programs()
        self._capture = self.device.type == "cuda"
        self.history: list[EpochMetrics] = []

    # ---------------------------------------------------------------- data

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def _place_data(self, train_split: Split, test_split: Split | None):
        """One device tensor per split; `train_offsets[d]` is worker d's
        first row in it (its shard under data_parallel, else 0)."""
        c, n = self.config, self.n_workers
        if c.regime == "data_parallel":
            p = shard_size(len(train_split), n)
            if p < 1:
                raise ValueError(f"{len(train_split)} rows cannot shard over {n} workers")
            self.train_offsets, rows = [d * p for d in range(n)], n * p
        else:  # single / replication: every worker reads the one full tensor
            p = rows = len(train_split)
            self.train_offsets = [0] * n
        self.train_images = self._to_device(train_split.images[:rows])
        self.train_labels = self._to_device(train_split.labels[:rows], torch.int64)
        self.local_train_rows = p
        self.test_images = None
        if test_split is not None:
            total = len(test_split)
            q = -(-total // n)
            pad = n * q - total
            self.test_images = self._to_device(np.concatenate(
                [test_split.images, np.zeros((pad, *test_split.images.shape[1:]), np.float32)]
            ))
            self.test_labels = self._to_device(
                np.concatenate([test_split.labels, np.zeros(pad, np.int32)]), torch.int64
            )
            self.test_weights = self._to_device(
                np.concatenate([np.ones(total, np.float32), np.zeros(pad, np.float32)])
            )
            self.local_test_rows = q
            # every worker's partition in order (the JAX eval plan), stacked
            self.eval_idx, self.eval_w = stacked_plan(
                [torch.arange(q)] * n, q, c.eval_batch_size or c.batch_size,
                [d * q for d in range(n)], self.device)

    def default_order(self, epoch: int, worker: int) -> torch.Tensor:
        """The port's shuffle for (seed, epoch, worker)."""
        return torch.randperm(
            self.local_train_rows,
            generator=shuffle_generator(self.config.seed, epoch, worker),
        )

    def epoch_plan(self, epoch: int):
        """The epoch's stacked plan (idx, w), each (N, steps, batch), on the host."""
        order = self._orders or self.default_order
        return stacked_plan([order(epoch, d) for d in range(self.n_workers)],
                            self.local_train_rows, self.config.batch_size, self.train_offsets)

    def epoch_mask(self, epoch: int) -> np.ndarray:
        c = self.config
        return live_mask(c.seed, epoch, self.n_workers, c.failure_probability,
                         mask=None if self._masks is None else self._masks(epoch))

    # --------------------------------------------------------------- state

    def _build_state(self):
        """The stacked parameters and momentum (every worker starts from the
        one `Network` the seed draws) and the programs' static buffers."""
        c, n, dev = self.config, self.n_workers, self.device
        g = torch.Generator()
        g.manual_seed(c.seed)
        self.net = ReplicaNetwork(n, kernels=c.kernels, generator=g).to(dev)
        self.params = list(self.net.parameters())
        self.mom = init_momentum(self.params)
        steps = -(-self.local_train_rows // c.batch_size)
        self.plan_idx = torch.zeros(n, steps, c.batch_size, dtype=torch.int64, device=dev)
        self.plan_w = torch.zeros(n, steps, c.batch_size, device=dev)
        self.mask = torch.ones(n, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.loss_sums = torch.zeros(n, device=dev)
        # train_loss, n_live, val_loss, val_acc of the last epoch
        self.metrics = torch.zeros(4, device=dev)

    def _state(self):
        return [*self.params, *self.mom, self.step, self.loss_sums, self.metrics]

    def state_tree(self):
        """{"params", "mom"} in the JAX engine's tree form with numpy
        leaves: the synced params (worker 0's) and the per-worker momentum
        stacked on a leading axis."""
        state = self.net.state_dict()
        names = list(state)
        return {"params": to_jax_params({k: v[0] for k, v in state.items()}),
                "mom": to_jax_params(dict(zip(names, self.mom)))}

    def load_state_tree(self, tree) -> None:
        """Install a JAX-form state tree (inverse of `state_tree`)."""
        params, mom = from_jax_params(tree["params"]), from_jax_params(tree["mom"])
        with torch.no_grad():
            for (name, p), m in zip(self.net.named_parameters(), self.mom):
                p.copy_(params[name].expand_as(p))
                m.copy_(mom[name])

    # ------------------------------------------------------------ programs

    def _build_programs(self):
        """The four programs. Each closes over the tensors it reads and
        writes, never over the engine, so that dropping an engine frees its
        graphs at once (a cycle would leave them to the garbage collector,
        which may run during another capture and spoil it)."""
        c, counters = self.config, (fused_head.LAUNCHES,)
        net, params, mom = self.net, self.params, self.mom
        at, loss_sums, metrics = self.step, self.loss_sums, self.metrics
        plan_idx, plan_w, mask = self.plan_idx, self.plan_w, self.mask
        images, labels = self.train_images, self.train_labels

        def begin():
            at.zero_()
            loss_sums.zero_()
            if c.reset_momentum:
                torch._foreach_zero_(mom)

        def step():
            loss_sums.add_(train_step(
                net, mom, images, labels, plan_idx.index_select(1, at).squeeze(1),
                plan_w.index_select(1, at).squeeze(1), lr=c.lr, momentum=c.momentum,
                sync=c.sync_mode == "step",
            ))
            at.add_(1)

        @torch.no_grad()
        def sync():
            for p, avg in zip(params, masked_mean_tree(params, mask)):
                p.copy_(avg.expand_as(p))
            w_eff = effective_mask(mask)
            n_batches = float(plan_idx.shape[1])
            metrics[0] = weighted_mean_scalar(loss_sums * w_eff, n_batches * w_eff)
            metrics[1] = mask.sum()

        self._begin = Program(begin, counters)
        self._step = Program(step, counters)
        self._sync = Program(sync, counters)
        self._eval = None
        if self.test_images is not None:
            test = (self.test_images, self.test_labels, self.test_weights, self.eval_idx,
                    self.eval_w)

            def evaluate():
                loss_sum, n_batches, correct, n_valid = eval_epoch(net, *test).sum(1)
                metrics[2] = loss_sum / n_batches.clamp(min=1.0)
                metrics[3] = 100.0 * correct / n_valid.clamp(min=1.0)

            self._eval = Program(evaluate, counters)

    def _programs(self):
        return [p for p in (self._begin, self._step, self._sync, self._eval) if p is not None]

    def compile(self) -> None:
        """Capture the programs as CUDA graphs (once; on the card only, and
        only while `_capture` holds). The state is left as it was."""
        if self._capture and self._step.graph is None:
            capture_all(self._programs(), self._state(), self.device)

    def _load(self, idx, w, mask) -> None:
        """The epoch's plan and live mask into the static buffers (host or
        device sources; a device source is a copy on the card's queue)."""
        self.plan_idx.copy_(idx)
        self.plan_w.copy_(w)
        self.mask.copy_(mask)

    def _train(self) -> None:
        self._begin()
        self._step(self.plan_idx.shape[1])

    # --------------------------------------------------------------- epochs

    def run_epoch(self, epoch: int, *, timers: T.PhaseTimers | None = None,
                  do_eval: bool = True, log=print) -> EpochMetrics:
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        mask = self.epoch_mask(epoch)
        straggler_sleep(mask, self.config.failure_duration, log=log)
        self.compile()
        self._load(*self.epoch_plan(epoch), torch.tensor(mask))
        with timers.phase(T.TRAINING):
            self._train()
        with timers.phase(T.COMMUNICATION):
            self._sync()
        do_eval = do_eval and self._eval is not None
        if do_eval:
            with timers.phase(T.EVALUATION):
                self._eval()
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
        TRAINING, eval included, as the JAX engine does."""
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        eval_inside = eval_inside and self._eval is not None
        epochs = range(epoch0, epoch0 + span)
        masks = np.stack([self.epoch_mask(e) for e in epochs])
        plans = [self.epoch_plan(e) for e in epochs]
        idx = torch.stack([i for i, _ in plans]).to(self.device)
        w = torch.stack([w for _, w in plans]).to(self.device)
        masks_dev = torch.from_numpy(masks).to(self.device)
        out = torch.zeros(span, 4, device=self.device)
        self.compile()
        with timers.phase(T.TRAINING):
            for i in range(span):
                self._load(idx[i], w[i], masks_dev[i])
                self._train()
                self._sync()
                if eval_inside:
                    self._eval()
                out[i].copy_(self.metrics)
        metrics = [
            EpochMetrics(e, tl, vl if eval_inside else None, va if eval_inside else None,
                         int(nl))
            for e, (tl, nl, vl, va) in zip(epochs, out.tolist())
        ]
        self.history.extend(metrics)
        return metrics

    # ------------------------------------------------------------------ run

    def run(self, *, timers: T.PhaseTimers | None = None, run=None, log=print,
            eval_every: int = 1, fused: bool = False) -> list[EpochMetrics]:
        """Full training run; `run` is a MetricsRun-like sink
        (`utils/metrics.py`). `fused=True` runs multi-epoch spans
        (`run_span`, split only at eval boundaries) instead of one read per
        epoch; straggler sleeps (`failure_duration`) force the per-epoch
        path, the only one where they can fall between epochs."""
        if fused and self.config.failure_duration > 0:
            log(
                "(fused mode does not support --failure-duration straggler "
                "sleeps; using the per-epoch path)"
            )
            fused = False
        if fused:
            return self._run_fused(timers=timers, run=run, log=log, eval_every=eval_every)
        for epoch in range(self.config.epochs):
            log(f"Starting epoch  {epoch}")
            do_eval = eval_every > 0 and (epoch + 1) % eval_every == 0
            m = self.run_epoch(epoch, timers=timers, do_eval=do_eval, log=log)
            self._log_epoch(m, run, log, start=False)
        return self.history

    def _run_fused(self, *, timers, run, log, eval_every: int) -> list[EpochMetrics]:
        epochs = self.config.epochs
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        eval_in = eval_every == 1 and self._eval is not None
        e = 0
        while e < epochs:
            span = epochs - e
            if eval_every > 1 and self._eval is not None:
                span = min(span, eval_every - (e % eval_every))
            metrics = self.run_span(e, span, eval_inside=eval_in, timers=timers)
            e += span
            last = metrics[-1]
            if not eval_in and self._eval is not None and eval_every > 0 and e % eval_every == 0:
                with timers.phase(T.EVALUATION):
                    self._eval()
                last.val_loss, last.val_acc = self.metrics[2:].tolist()
            for m in metrics:
                self._log_epoch(m, run, log, start=True)
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
