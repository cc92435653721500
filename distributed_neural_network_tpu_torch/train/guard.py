"""Self-healing training: in-step health signals, guard policies, rollback,
and preemption-safe exact resume (the port of the JAX package's
`train/guard.py`).

Three pieces, on the host (the in-step halves live next to the code they
guard):

- **Health signals** (`ops/schedule.py` `health_bundle`): a guarded train
  step returns a bundle of three 0-d tensors - the loss, the global
  gradient norm (the one `clip_by_global_norm` computes when clipping is
  on) and an all-finite flag derived from those two (a NaN or Inf anywhere
  in the gradients makes the norm non-finite, so the flag costs O(1)); on
  the card they are copied to pinned host memory behind the step, with a
  CUDA event, ``ready``, recorded after the copy. `HealthPipe` reads the
  bundle one step late, after the next step has been launched, waiting on
  that event: reading a device tensor would wait for the whole stream, the
  step just launched too, and the card would idle while the host launches
  the next.
- **Policy loop** (`TrainingGuard`): an EMA loss-spike detector and
  non-finite detection, mapped through a policy - ``warn`` (count and
  log), ``skip`` (non-finite updates are dropped inside the step, on the
  device: `ops/sgd.py` `guarded_sgd_step`, `ops/adam.py`
  `guarded_adam_step`, so the step stays one CUDA graph), ``rollback``
  (restore the rolling host snapshot, or the newest checkpoint, and retry
  with an lr backoff under a bounded budget), ``abort`` (raise `GuardAbort`
  with a message that says what to do). Anomalies go to `utils/tracing.py`
  StepStats, ``guard`` instant events to the Chrome trace, the counters to
  the metrics registry and every event to the flight recorder
  (`utils/obs.py` `flight_event`), under the JAX package's names.
- **Preemption** (`PreemptionGuard`): SIGTERM / SIGINT become a flag that
  the training loops read at each step (LM) or epoch (CNN) boundary: they
  write an emergency checkpoint and leave cleanly, so the run resumes from
  that step instead of losing it. Under torchrun every rank gets the signal
  (the launcher forwards it); the loops still agree on the stop with a max
  all-reduce of the flag, so that no rank enters a collective the others
  left. `resume_cursor` / `check_cursor` are the checkpoint meta's cursor.

Used by `lm_train.py` (per step) and `train/engine.py` / `train/cli.py`
(per epoch: one epoch is one step there). The injectors that exercise every
policy live in `parallel/fault.py` (`StepFaultPlan`, `ChaosMonkey`).
"""

from __future__ import annotations

import math
import signal
import threading
from dataclasses import dataclass

from ..utils.obs import flight_event

POLICIES = ("off", "warn", "skip", "rollback", "abort")

# the checkpoint meta's cursor block version (the JAX package's)
GUARD_META_VERSION = 1


class GuardAbort(RuntimeError):
    """Training aborted by the guard policy; the message says why and what
    to do (inspect the run's guard trace events, resume from the newest
    checkpoint with a lower lr, or rerun with --guard warn to observe)."""


@dataclass
class GuardConfig:
    """Knobs of `TrainingGuard`; the CLIs map them 1:1 (--guard,
    --guard-spike-zscore, --snapshot-every, --max-retries)."""

    policy: str = "warn"
    # a loss more than this many EMA standard deviations above the EMA mean
    # is a spike; a non-finite loss or gradient norm is always an anomaly
    spike_zscore: float = 6.0
    # EMA decay of the spike detector's running mean and variance
    ema_decay: float = 0.9
    # observations before the spike detector arms (the first steps of a run
    # move fast); non-finite detection is active from step 0
    warmup_steps: int = 10
    # rollback retry budget, then GuardAbort; it refills after
    # `warmup_steps` healthy observations in a row
    max_retries: int = 3
    # lr multiplier of each rollback (cumulative: scale *= backoff)
    lr_backoff: float = 0.5
    # steps between rolling host snapshots; a rollback rewinds at most this many
    snapshot_every: int = 50

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"guard policy must be one of {POLICIES}, got {self.policy!r}")
        if self.spike_zscore <= 0:
            raise ValueError(f"spike_zscore must be > 0, got {self.spike_zscore}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0,1), got {self.ema_decay}")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError(f"lr_backoff must be in (0,1], got {self.lr_backoff}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {self.snapshot_every}")


@dataclass
class Verdict:
    """One observation's outcome. `action` is what the caller must do:
    'ok' / 'warn' (continue), 'skip' (the step already dropped the update;
    bookkeeping only), 'rollback' (call `TrainingGuard.rollback()` and
    restore), 'abort' (`observe` already raised GuardAbort)."""

    action: str
    step: int
    reason: str | None = None
    zscore: float | None = None


class SpikeDetector:
    """EMA mean / variance loss-spike detector.

    `check(loss)` gives the z-score of an observation against the running
    EMA (None while warming up); `accept(loss)` folds a healthy observation
    into the EMA - an anomalous loss is never folded in, so a spike cannot
    poison the baseline it is judged against. `reset()` warms up again after
    a rollback."""

    def __init__(self, *, decay: float = 0.9, warmup: int = 10):
        self.decay = decay
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def check(self, loss: float) -> float | None:
        if self.count < self.warmup:
            return None
        sd = math.sqrt(max(self.var, 1e-12))
        return (loss - self.mean) / sd

    def accept(self, loss: float) -> None:
        if self.count == 0:
            self.mean = loss
            self.var = 0.0
        else:
            d = self.decay
            delta = loss - self.mean
            self.mean = d * self.mean + (1.0 - d) * loss
            self.var = d * (self.var + (1.0 - d) * delta * delta)
        self.count += 1


def _host_copy(x):
    """A host copy of one snapshot leaf: a tensor copied to the CPU (always
    a new tensor, also from a CPU tensor), anything else a numpy copy."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class TrainingGuard:
    """The guard policy on the host: consumes each step's health, keeps the
    rolling snapshot, and decides warn / skip / rollback / abort. The
    training loops here observe and roll back on their own thread."""

    def __init__(self, config: GuardConfig | None = None, *, tracer=None, step_stats=None,
                 registry=None, log=print, provenance=None):
        self.cfg = config if config is not None else GuardConfig()
        self.tracer = tracer
        self.step_stats = step_stats
        # a `step -> layer path or None` lookup naming the first layer whose
        # gradients went non-finite at that step (the dynamics sink's, when
        # there is one); consulted on the non-finite path only
        self.provenance = provenance
        # the live-metrics registry (utils/obs.py; None = off)
        if registry is None:
            from ..utils.obs import NULL_REGISTRY

            registry = NULL_REGISTRY
        self._anomaly_counter = registry.counter(
            "guard_anomalies_total", "Guard anomalies observed, by kind (train/guard.py)")
        self._rollback_counter = registry.counter("guard_rollbacks_total",
                                                  "Guard rollback restores")
        self._lr_scale_gauge = registry.gauge("guard_lr_scale",
                                              "Cumulative guard LR-backoff factor")
        self._lr_scale_gauge.set(1.0)
        # the z-score of every healthy observation (0 while warming up),
        # beside the --guard-spike-zscore threshold it is judged against
        self._zscore_gauge = registry.gauge(
            "guard_spike_zscore",
            "Last observed loss z-score vs the spike detector's EMA (0 during warmup)")
        self._zscore_gauge.set(0.0)
        self.log = log
        self.detector = SpikeDetector(decay=self.cfg.ema_decay, warmup=self.cfg.warmup_steps)
        self.counters = {"nonfinite": 0, "spikes": 0, "skipped": 0, "rollbacks": 0,
                         "warnings": 0}
        self.retries_used = 0
        self.lr_scale = 1.0
        self._healthy_streak = 0
        self._snapshot = None  # (step, host state tree)

    # ---------------------------------------------------------- snapshots

    @property
    def has_snapshot(self) -> bool:
        return self._snapshot is not None

    @property
    def snapshot_step(self) -> int | None:
        return self._snapshot[0] if self._snapshot else None

    def snapshot(self, step: int, state) -> None:
        """Keep a host copy of `state` (a tree of tensors and numpy arrays)
        as the last good rollback point: every tensor copied to the CPU,
        leaf order and dtypes as given. Size the cadence (`snapshot_every`)
        to what the copy costs."""
        from ..utils.tree import tree_map

        self._snapshot = (int(step), tree_map(_host_copy, state))

    def maybe_snapshot(self, step: int, state, *, first_step: int = 0) -> bool:
        """Snapshot at the configured cadence (always on the first call).
        `state` may be a function of no arguments that returns the tree, so
        that a caller builds it only on the steps that keep it."""
        if self._snapshot is not None and (step - first_step) % self.cfg.snapshot_every:
            return False
        self.snapshot(step, state() if callable(state) else state)
        return True

    def peek_snapshot(self):
        """(step, host state) of the rolling snapshot, or None, without
        spending a retry (the epoch-level 'skip' restores through it)."""
        return self._snapshot

    def drop_snapshot(self) -> None:
        """Invalidate the rolling snapshot (a snapshot of another layout must
        never be rolled back into the run; the next cadence takes one)."""
        self._snapshot = None

    # -------------------------------------------------------- observation

    def observe(self, step: int, loss: float, *, grad_norm: float | None = None,
                all_finite: bool | None = None) -> Verdict:
        """Judge one step's health; returns the policy's Verdict. Raises
        GuardAbort itself under the 'abort' policy, so that a caller that
        drops the verdict cannot ignore it."""
        loss = float(loss)
        finite = math.isfinite(loss)
        if grad_norm is not None:
            finite = finite and math.isfinite(float(grad_norm))
        if all_finite is not None:
            finite = finite and bool(all_finite)
        if not finite:
            layer = self.provenance(step) if self.provenance is not None else None
            reason = (f"non-finite step (loss={loss}, grad_norm={grad_norm}, "
                      f"all_finite={all_finite})")
            if layer is not None:
                reason += f"; first non-finite grads in layer {layer!r}"
            return self._anomaly(step, "nonfinite", reason, None, layer=layer)
        z = self.detector.check(loss)
        self._zscore_gauge.set(z if z is not None else 0.0)
        if z is not None and z > self.cfg.spike_zscore:
            return self._anomaly(
                step, "spikes",
                f"loss spike: {loss:.6g} is {z:.1f} EMA sigma above the running mean "
                f"{self.detector.mean:.6g} (threshold {self.cfg.spike_zscore})", z)
        self.detector.accept(loss)
        self._healthy_streak += 1
        if self.retries_used and self._healthy_streak >= self.cfg.warmup_steps:
            self.retries_used = 0  # the incident closed: refill the budget
        return Verdict(action="ok", step=step)

    def _anomaly(self, step, kind, reason, zscore, *, layer=None) -> Verdict:
        self.counters[kind] += 1
        self._anomaly_counter.labels(kind=kind).inc()
        self._healthy_streak = 0
        policy = self.cfg.policy
        action = {"warn": "warn", "skip": "skip", "rollback": "rollback",
                  "abort": "abort"}.get(policy, "warn")
        if action == "skip" and kind == "spikes":
            # the in-step skip gates on the finite flag only; a finite spike
            # has no drop path there, so the skip policy warns on it
            action = "warn"
        if action == "skip":
            self.counters["skipped"] += 1
        elif action == "warn":
            self.counters["warnings"] += 1
        extra = {} if layer is None else {"layer": layer}
        if self.tracer is not None:
            self.tracer.instant("guard", track="guard", step=int(step), action=action,
                                kind=kind, zscore=zscore, **extra)
        flight_event("guard_anomaly", step=int(step), action=action, anomaly=kind,
                     zscore=zscore, **extra)
        if self.step_stats is not None:
            self.step_stats.count_anomaly(kind)
        self.log(f"(guard: step {step} {kind} -> {action}: {reason})")
        if action == "abort":
            raise GuardAbort(
                f"guard policy 'abort': {reason} at step {step}. "
                "Inspect the run's guard trace events "
                "(tools/trace_summary.py), resume from the newest "
                "checkpoint with a lower LR, or rerun with --guard warn "
                "to observe without stopping.")
        return Verdict(action=action, step=step, reason=reason, zscore=zscore)

    # ----------------------------------------------------------- rollback

    def rollback(self, at_step: int | None = None):
        """Spend one retry and return (step, host state) of the rolling
        snapshot - or None when there is none yet (the caller then falls back
        to the newest checkpoint on disk). Applies the lr backoff (`lr_scale
        *= lr_backoff`) and records a ``guard`` restore event. Raises
        GuardAbort when the retry budget is spent.

        ``at_step`` (the step the loop had reached) sizes the goodput
        ledger's recompute window: the ``at_step - snapshot_step`` replayed
        steps re-earn lost progress, so their wall time counts as
        ``rollback_recompute``, not goodput (`utils/goodput.py`)."""
        self.retries_used += 1
        if self.retries_used > self.cfg.max_retries:
            raise GuardAbort(
                f"guard retry budget exhausted ({self.cfg.max_retries} "
                f"rollback(s) without {self.cfg.warmup_steps} consecutive "
                "healthy steps between incidents). The anomaly recurs "
                "after restore + LR backoff - likely a data or numerics "
                "problem, not a transient: check the input batch at the "
                "failing step, lower the base LR, or enable gradient "
                "clipping (--clip-norm).")
        self.counters["rollbacks"] += 1
        self._rollback_counter.inc()
        flight_event("guard_rollback", lr_scale=self.lr_scale * self.cfg.lr_backoff,
                     retries_used=self.retries_used)
        self.lr_scale *= self.cfg.lr_backoff
        self._lr_scale_gauge.set(self.lr_scale)
        self.detector.reset()  # warm up again against the restored trajectory
        if self.step_stats is not None:
            self.step_stats.count_anomaly("rollbacks")
        if self._snapshot is None:
            return None
        step, state = self._snapshot
        if at_step is not None and at_step > step:
            from ..utils.goodput import LEDGER

            LEDGER.mark_recompute(at_step - step)
        if self.tracer is not None:
            self.tracer.instant("guard", track="guard", step=step, action="restore",
                                kind="rollback", lr_scale=self.lr_scale,
                                retries_used=self.retries_used)
        self.log(f"(guard: rolling back to snapshot at step {step}, "
                 f"lr_scale={self.lr_scale:g}, "
                 f"retry {self.retries_used}/{self.cfg.max_retries})")
        return step, state

    def summary(self) -> dict:
        return {"policy": self.cfg.policy, "lr_scale": self.lr_scale,
                "retries_used": self.retries_used,
                **{k: int(v) for k, v in self.counters.items()}}


class HealthPipe:
    """Health read one step late.

    Reading a step's health bundle at once would wait for the card to finish
    that step before the next is launched. The pipe holds step i's bundle
    (three 0-d device tensors) while step i+1 is launched and reads it only
    then (by which time it is long computed), so the loop keeps one step
    queued ahead. The price: warn and rollback act one step late (the
    snapshot cadence absorbs that); the non-finite 'skip' is inside the step
    and never waits for the host.

    `perturb(step, loss, grad_norm, all_finite) -> (loss, grad_norm,
    all_finite)` hooks host-side fault injection (`parallel/fault.py`
    ChaosMonkey) into the observation."""

    def __init__(self, guard: TrainingGuard, *, perturb=None):
        self.guard = guard
        self.perturb = perturb
        self._pending = None

    def push(self, step: int, health) -> Verdict | None:
        """Stash this step's bundle; returns the previous step's verdict
        (None at the first call)."""
        v = self.flush()
        self._pending = (int(step), health)
        return v

    def flush(self) -> Verdict | None:
        """Observe the pending bundle now (waits for its values)."""
        if self._pending is None:
            return None
        step, health = self._pending
        self._pending = None
        ready = health.get("ready")
        if ready is not None:
            # the step's event: waits for that step alone (its values were
            # copied to the host behind it), not for the steps launched since
            ready.synchronize()
        loss = float(health["loss"])
        gn = float(health["grad_norm"])
        ok = bool(health["all_finite"])
        if self.perturb is not None:
            loss, gn, ok = self.perturb(step, loss, gn, ok)
        return self.guard.observe(step, loss, grad_norm=gn, all_finite=ok)

    def clear(self) -> None:
        """Drop the pending bundle (after a rollback the step in flight
        belongs to the abandoned trajectory)."""
        self._pending = None


# ------------------------------------------------------------- preemption


class PreemptionGuard:
    """Cooperative SIGTERM/SIGINT handling for step-boundary emergency
    checkpoints.

    `install()` replaces the handlers with a flag-setter; the training loop
    checks `requested` at each step boundary, writes an emergency
    checkpoint and exits cleanly. A second signal restores the previous
    handler and delivers it again (the way out when the loop is wedged); a
    first signal that finds the flag already up (a `request()`, or a peer's
    flag taken by `agreed()`) asks for the same stop and forces nothing, so
    a supervisor's SIGTERM to a rank already stopping for a peer does not
    cut its emergency checkpoint short.
    As a context manager the handlers are restored on exit. Handlers can
    only be installed on the main thread: elsewhere `install()` is a no-op
    (`requested` stays False unless `request()` is called)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), *, log=print):
        self.signals = tuple(signals)
        self.log = log
        self.requested = False
        self.signame: str | None = None
        self.signalled = False
        self._prev = {}

    def _handler(self, signum, frame):
        if self.signalled:
            # second delivery: restore + re-raise via the original handler
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.signalled = True
        if self.requested:
            self.log(f"({signal.Signals(signum).name} received: already stopping "
                     f"[{self.signame}]; send again to force)")
            return
        self.requested = True
        self.signame = signal.Signals(signum).name
        flight_event("preempt", signal=self.signame)
        self.log(
            f"({self.signame} received: finishing the current step, then "
            "writing an emergency checkpoint and exiting; send again to "
            "force)"
        )

    def request(self, reason: str = "REQUEST") -> None:
        """Raise the same flag a SIGTERM would, from any thread (no signal
        involved); idempotent."""
        if self.requested:
            return
        self.requested = True
        self.signame = reason
        flight_event("preempt", signal=reason)
        self.log(
            f"({reason} preemption requested: finishing the current step, "
            "then writing an emergency checkpoint and exiting)"
        )

    def agreed(self) -> bool:
        """Whether this rank or any rank of the process group has the flag
        up (this rank's flag off a group): one max all-reduce of the flag,
        on a gloo group (host memory, so no wait for the card), at a step
        boundary every rank reaches. Every rank then stops at the same
        step, and none enters a collective the others left."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return self.requested
        flag = torch.tensor([int(self.requested)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=_host_group())
        if flag.item() and not self.requested:
            self.requested, self.signame = True, "PEER"
        return self.requested

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


# the default group -> a gloo group over its ranks, made once per default group
_HOST_GROUP = {}


def _host_group():
    """A gloo group over the default group's ranks (the default group itself
    when it is gloo): made at the first call, which every rank makes at the
    same step boundary."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    default = dist.group.WORLD
    if _HOST_GROUP.get("world") is not default:
        _HOST_GROUP.update(world=default, group=dist.new_group(backend="gloo"))
    return _HOST_GROUP["group"]


def resume_cursor(*, step: int, seed: int, **extra) -> dict:
    """The versioned checkpoint-meta block that makes resume exact.

    Every data and random stream of the port is a function of (seed, step):
    the copy task and `data/tokens.py` `sample_batch(step=...)` for the LM,
    the shuffle generators and fault masks keyed by (seed, epoch, worker)
    for the CNN. So the two integers pin the batches the continuation must
    see."""
    return {
        "meta_version": GUARD_META_VERSION,
        "cursor": {"step": int(step), "seed": int(seed), **extra},
    }


def check_cursor(meta: dict, *, seed: int, what: str = "run") -> None:
    """Validate a restored meta's cursor against this run's settings:
    checkpoints without a cursor pass (they make no claim); a newer meta
    version or another seed raises (resuming a seeded run under another
    seed changes its data order mid-trajectory)."""
    ver = meta.get("meta_version")
    if ver is not None and ver > GUARD_META_VERSION:
        raise ValueError(
            f"checkpoint meta_version {ver} is newer than this build's "
            f"{GUARD_META_VERSION} - resume with the build that wrote it"
        )
    cur = meta.get("cursor")
    if not isinstance(cur, dict):
        return
    if "seed" in cur and int(cur["seed"]) != int(seed):
        raise ValueError(
            f"checkpoint was written with seed={cur['seed']}, this {what} "
            f"has seed={seed} - the data order and PRNG streams would "
            "diverge from the recorded trajectory; resume with the "
            "original seed"
        )
