"""The training engine: one trainer, three regimes (counterpart of the JAX
package's `train/engine.py`).

- ``single``        - one worker, the full split;
- ``replication``   - N workers, each training the full split with its own
                      shuffle; the split is one tensor that all share;
- ``data_parallel`` - N workers on contiguous 1/N row shards (remainder
                      dropped), views of one tensor.

The split is uploaded to the device once. The N workers are a replica group
in one process (`parallel/mesh.py`): each has its own `Network` and momentum
on the same device. Per epoch:

1. **train** - `sync_mode="epoch"`: each worker runs a local-SGD epoch
   (faithful local SGD; momentum reset per epoch when `reset_momentum`).
   `sync_mode="step"`: steps outside, workers inside, and a gradient mean
   over the group each step.
2. **sync** - the fault-masked parameter mean over the group, and the global
   train loss as sum(loss sums)/sum(batch counts) over live workers.
3. **eval** - over the test split padded to N equal per-worker partitions
   (padding rows weigh 0), as the JAX engine does, so `val_loss` - a mean of
   per-batch means - groups batches exactly as JAX does.

The shuffle orders and fault masks come from `torch.Generator`s and differ
from the JAX package's; `orders` and `masks` hooks let a caller inject any.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..data.cifar10 import Split
from ..data.pipeline import epoch_plan, gather_batch, shuffle_generator
from ..device import resolve_device
from ..models.cnn import KERNELS, Network, from_jax_params, to_jax_params
from ..ops.sgd import init_momentum, sgd_step
from ..ops.train import eval_epoch, loss_and_grads, sync_grads, train_epoch
from ..parallel.collectives import effective_mask, masked_mean_tree, weighted_mean_scalar
from ..parallel.fault import live_mask, straggler_sleep
from ..parallel.mesh import create_mesh, device_count
from ..parallel.partition import shard_size
from ..utils import timers as T

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
        self._orders = orders if orders is not None else self.default_order
        self._masks = masks
        self._place_data(train_split, test_split)
        self._build_state()
        self.history: list[EpochMetrics] = []

    # ---------------------------------------------------------------- data

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def _place_data(self, train_split: Split, test_split: Split | None):
        c, n = self.config, self.n_workers
        if c.regime == "data_parallel":
            p = shard_size(len(train_split), n)
            if p < 1:
                raise ValueError(f"{len(train_split)} rows cannot shard over {n} workers")
            images = self._to_device(train_split.images[: n * p])
            labels = self._to_device(train_split.labels[: n * p], torch.int64)
            self.train_views = [
                (images[d * p : (d + 1) * p], labels[d * p : (d + 1) * p])
                for d in range(n)
            ]
        else:  # single / replication: every worker reads the one full tensor
            p = len(train_split)
            images = self._to_device(train_split.images)
            labels = self._to_device(train_split.labels, torch.int64)
            self.train_views = [(images, labels)] * n
        self.local_train_rows = p
        self.test_views = None
        if test_split is not None:
            total = len(test_split)
            q = -(-total // n)
            pad = n * q - total
            images = self._to_device(np.concatenate(
                [test_split.images, np.zeros((pad, *test_split.images.shape[1:]), np.float32)]
            ))
            labels = self._to_device(
                np.concatenate([test_split.labels, np.zeros(pad, np.int32)]), torch.int64
            )
            weights = self._to_device(
                np.concatenate([np.ones(total, np.float32), np.zeros(pad, np.float32)])
            )
            self.local_test_rows = q
            self.test_views = [
                (images[d * q : (d + 1) * q], labels[d * q : (d + 1) * q],
                 weights[d * q : (d + 1) * q])
                for d in range(n)
            ]

    def default_order(self, epoch: int, worker: int) -> torch.Tensor:
        """The port's shuffle for (seed, epoch, worker)."""
        return torch.randperm(
            self.local_train_rows,
            generator=shuffle_generator(self.config.seed, epoch, worker),
        )

    # --------------------------------------------------------------- state

    def _build_state(self):
        c = self.config
        g = torch.Generator()
        g.manual_seed(c.seed)
        base = Network(kernels=c.kernels, generator=g)
        self.workers = [copy.deepcopy(base).to(self.device) for _ in range(self.n_workers)]
        self.mom = [init_momentum(w.parameters()) for w in self.workers]

    @property
    def model(self) -> Network:
        """The synced model (every worker holds it after a sync)."""
        return self.workers[0]

    def state_tree(self):
        """{"params", "mom"} in the JAX engine's tree form with numpy
        leaves: the synced params and the per-worker momentum stacked on a
        leading axis."""
        names = [k for k, _ in self.model.named_parameters()]
        moms = [to_jax_params(dict(zip(names, m))) for m in self.mom]
        stacked = {
            layer: {k: np.stack([t[layer][k] for t in moms]) for k in moms[0][layer]}
            for layer in moms[0]
        }
        return {"params": to_jax_params(self.model.state_dict()), "mom": stacked}

    def load_state_tree(self, tree) -> None:
        """Install a JAX-form state tree (inverse of `state_tree`)."""
        state = from_jax_params(tree["params"])
        for w in self.workers:
            w.load_state_dict(state)
        names = [k for k, _ in self.model.named_parameters()]
        with torch.no_grad():
            for d, mom in enumerate(self.mom):
                tree_d = {
                    layer: {k: np.asarray(v)[d] for k, v in leaves.items()}
                    for layer, leaves in tree["mom"].items()
                }
                state_d = from_jax_params(tree_d)
                for m, name in zip(mom, names):
                    m.copy_(state_d[name])

    # --------------------------------------------------------------- epochs

    def _local_epochs(self, epoch: int):
        c = self.config
        loss_sums, n_batches = [], []
        for d, (model, (images, labels)) in enumerate(zip(self.workers, self.train_views)):
            self.mom[d], loss_sum, nb = train_epoch(
                model, self.mom[d], images, labels, self._orders(epoch, d),
                batch_size=c.batch_size, lr=c.lr, momentum=c.momentum,
                reset_momentum=c.reset_momentum,
            )
            loss_sums.append(loss_sum)
            n_batches.append(nb)
        return torch.stack(loss_sums), torch.tensor(n_batches, dtype=torch.float32)

    def _step_epoch(self, epoch: int):
        c, n = self.config, self.n_workers
        plans = [
            epoch_plan(self._orders(epoch, d), self.local_train_rows, c.batch_size, self.device)
            for d in range(n)
        ]
        if c.reset_momentum:
            self.mom = [init_momentum(w.parameters()) for w in self.workers]
        params = [list(w.parameters()) for w in self.workers]
        loss_sums = torch.zeros(n, device=self.device)
        steps = plans[0][0].shape[0]
        for s in range(steps):
            grads = []
            for d, (model, (images, labels)) in enumerate(zip(self.workers, self.train_views)):
                idx, w = plans[d]
                x, y = gather_batch(images, labels, idx[s])
                loss, g = loss_and_grads(model, x, y, w[s])
                loss_sums[d] += loss
                grads.append(g)
            mean = sync_grads(grads)
            for d in range(n):
                sgd_step(params[d], self.mom[d], mean, c.lr, c.momentum)
        return loss_sums, torch.full((n,), float(steps))

    @torch.no_grad()
    def _sync(self, mask, loss_sums, n_batches) -> float:
        avg = masked_mean_tree([list(w.parameters()) for w in self.workers], mask)
        for w in self.workers:
            for p, a in zip(w.parameters(), avg):
                p.copy_(a)
        w_eff = effective_mask(mask)
        return float(weighted_mean_scalar(
            loss_sums.cpu() * w_eff, n_batches * w_eff
        ))

    def evaluate(self) -> tuple[float, float]:
        """(val_loss, val_acc %) of the synced model over the test split."""
        eval_bs = self.config.eval_batch_size or self.config.batch_size
        totals = torch.zeros(4, device=self.device)
        for images, labels, weights in self.test_views:
            totals += torch.stack(
                eval_epoch(self.model, images, labels, weights, batch_size=eval_bs)
            )
        loss_sum, n_batches, correct, n_valid = totals.tolist()
        return loss_sum / max(n_batches, 1.0), 100.0 * correct / max(n_valid, 1.0)

    def run_epoch(self, epoch: int, *, timers: T.PhaseTimers | None = None,
                  do_eval: bool = True, log=print) -> EpochMetrics:
        c = self.config
        timers = timers if timers is not None else T.PhaseTimers(self.device)
        mask = live_mask(
            c.seed, epoch, self.n_workers, c.failure_probability,
            mask=None if self._masks is None else self._masks(epoch),
        )
        straggler_sleep(mask, c.failure_duration, log=log)
        with timers.phase(T.TRAINING):
            if c.sync_mode == "epoch":
                loss_sums, n_batches = self._local_epochs(epoch)
            else:
                loss_sums, n_batches = self._step_epoch(epoch)
        with timers.phase(T.COMMUNICATION):
            train_loss = self._sync(mask, loss_sums, n_batches)
        val_loss = val_acc = None
        if do_eval and self.test_views is not None:
            with timers.phase(T.EVALUATION):
                val_loss, val_acc = self.evaluate()
        m = EpochMetrics(epoch, train_loss, val_loss, val_acc, int(mask.sum()))
        self.history.append(m)
        return m

    def run(self, *, timers: T.PhaseTimers | None = None, run=None, log=print,
            eval_every: int = 1) -> list[EpochMetrics]:
        """Full training run; `run` is a MetricsRun-like sink
        (`utils/metrics.py`)."""
        for epoch in range(self.config.epochs):
            log(f"Starting epoch  {epoch}")
            do_eval = eval_every > 0 and (epoch + 1) % eval_every == 0
            m = self.run_epoch(epoch, timers=timers, do_eval=do_eval, log=log)
            log(f"Global Average Training Loss: {m.train_loss}")
            if run is not None:
                run.append("train/loss", m.train_loss)
            if m.val_acc is not None:
                log(f"Validation loss of updated master model:  {m.val_loss}")
                log(f"Validation Accuracy: {m.val_acc:.2f} %")
                if run is not None:
                    run.append("val/loss", m.val_loss)
                    run.append("val/acc", m.val_acc)
        return self.history
