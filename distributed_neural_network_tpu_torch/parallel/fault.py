"""Fault injection: seeded per-epoch worker failures and the step-level
chaos injectors of the guard layer (counterpart of the JAX package's
`parallel/fault.py` `live_mask`, `epoch_key`, `straggler_sleep`,
`StepFaultPlan`, `inject_step_faults`, `ChaosMonkey`, `KillEvent` and
`ProcessChaos`).

Each epoch each worker fails independently with probability p; a failed
worker is left out of the epoch's parameter average and rejoins at the next
epoch. The Bernoulli draws come from a `torch.Generator`, so the masks differ
from the JAX package's for the same seed; a caller can inject a mask. Every
rank of a process group draws the same global mask; a straggler sleeps on
the rank that hosts the failed worker, and the other ranks wait for it in
the next collective, as the reference's parent waits for its children.

Step-level injectors (for `train/guard.py`): `StepFaultPlan` corrupts the
gradients or the loss inside the step at chosen step indices (the step index
a 0-d device buffer, so a captured step's graph fires on it at replay), so
the guard's in-step skip is exercised in the graph, not simulated;
`ChaosMonkey` perturbs the host's observation stream, stalls the loop or
delivers a real SIGTERM at a step boundary. Each host fault fires once, so
a rollback that replays the step does not trip it again (the transient
model; a recurring fault is what the retry budget is for).

Process-level injectors (for `train/supervisor.py`): `ProcessChaos` is a
plan of `KillEvent`s, each a SIGKILL or SIGTERM the supervisor sends one
worker once its heartbeat reaches a step. numpy and torch are imported by
the functions that use them, so the supervisor's launcher, which imports
this module, imports no torch.
"""

from __future__ import annotations

import os
import re
import signal as _signal
import time
from dataclasses import dataclass, field

_FAULT_SALT = 0x5EEDFA17


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of one epoch's fault draws, independent of the shuffle stream."""
    return (((seed ^ _FAULT_SALT) & 0xFFFF_FFFF) << 32) | (epoch & 0xFFFF_FFFF)


def live_mask(seed: int, epoch: int, n_workers: int, failure_probability: float,
              *, mask=None) -> np.ndarray:
    """(n_workers,) float32 {0,1}: 1 = the worker takes part this epoch.

    `mask` (any array of n_workers {0,1} values) is returned as given. p == 0
    is all-live without drawing.
    """
    import numpy as np
    import torch

    if mask is not None:
        out = np.asarray(mask, np.float32).reshape(-1)
        if out.shape != (n_workers,) or not np.isin(out, (0.0, 1.0)).all():
            raise ValueError(f"mask must be {n_workers} values in {{0, 1}}, got {mask!r}")
        return out
    if failure_probability <= 0.0:
        return np.ones(n_workers, np.float32)
    g = torch.Generator()
    g.manual_seed(epoch_seed(seed, epoch))
    fail = torch.rand(n_workers, generator=g) < failure_probability
    return (~fail).numpy().astype(np.float32)


def straggler_sleep(mask_host, failure_duration: float, *, workers=None,
                    log=print, tracer=None) -> None:
    """Optional host-side sleep keeping the reference's straggler timing:
    one sleep per epoch in which one of `workers` (global indices; default
    all) failed, and the same fail/wake lines per such worker. `tracer`
    (`utils/tracing.py`) records the sleep as a ``straggler`` span on the
    ``fault`` track."""
    if failure_duration <= 0.0:
        return
    workers = range(len(mask_host)) if workers is None else workers
    failed = [d for d in workers if not mask_host[d]]
    if not failed:
        return
    for d in failed:
        log(f"Device {d} failed! Sleeping for {failure_duration} seconds.")
    if tracer is None:
        from ..utils.tracing import NULL_TRACER as tracer
    with tracer.span("straggler", track="fault", failed_devices=failed,
                     duration_s=float(failure_duration)):
        time.sleep(failure_duration)
    for d in failed:
        log(f"Device {d} woke up!")


# ---------------------------------------------------- step-level injectors


@dataclass(frozen=True)
class StepFaultPlan:
    """The in-step faults of a train step (`train/lm.py`
    `make_lm_train_step(fault_plan=...)`; the step then takes its step
    index).

    nan_grads_at: step indices whose gradients are replaced with NaN after
      the backward (and the gradient sync): the all-finite flag drops, and
      the 'skip' policy's gated update must leave the state as it was.
    spike_loss_at: step indices whose (reported) loss is multiplied by
      `spike_scale` inside the step; the gradients are untouched.
    nan_layer: restrict the NaN to the gradient leaves whose ``/``-joined
      path (`parallel/rules.py` `named_leaves`) `re.search`-matches this
      pattern; None NaNs every leaf. A pattern that matches no leaf raises.
    """

    nan_grads_at: tuple = ()
    spike_loss_at: tuple = ()
    spike_scale: float = 100.0
    nan_layer: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "nan_grads_at", tuple(int(s) for s in self.nan_grads_at))
        object.__setattr__(self, "spike_loss_at", tuple(int(s) for s in self.spike_loss_at))

    def __bool__(self):
        return bool(self.nan_grads_at or self.spike_loss_at)


def fault_leaves(grads, plan: StepFaultPlan) -> list:
    """The gradient leaves `plan` NaNs: all of them, or those whose
    `named_leaves` path matches `plan.nan_layer` (a ValueError naming the
    paths when none does)."""
    from .rules import named_leaves

    flat = named_leaves(grads)
    if plan.nan_layer is None:
        return [g for _, g in flat]
    pat = re.compile(plan.nan_layer)
    hit = [g for path, g in flat if pat.search(path)]
    if not hit:
        raise ValueError(f"nan_layer pattern {plan.nan_layer!r} matches no gradient leaf path "
                         f"(have: {[p for p, _ in flat]})")
    return hit


def inject_step_faults(step_i, loss, grads, plan: StepFaultPlan, *, at=None):
    """Apply `plan` to one step's (loss, grads): the chosen gradient leaves
    (a tree of tensors, `fault_leaves`) filled with NaN in place at the
    plan's steps, and the loss spiked; returns (loss, grads). `step_i` is
    an int or a 0-d integer tensor (a captured step's buffer): every rank
    passes the same index, so the same fault fires on every rank. `at`
    (`fault_masks(plan, device)`) holds the plan's steps on the device,
    made outside a graph capture; without it they are made here."""
    import torch

    with torch.no_grad():
        if at is None:
            at = fault_masks(plan, torch.as_tensor(step_i).device)
        if plan.nan_grads_at:
            bad = (at["nan"] == step_i).any()
            for g in fault_leaves(grads, plan):
                g.masked_fill_(bad, float("nan"))
        if plan.spike_loss_at:
            spike = (at["spike"] == step_i).any()
            loss = torch.where(spike, loss * plan.spike_scale, loss)
    return loss, grads


def fault_masks(plan: StepFaultPlan, device) -> dict:
    """The plan's step lists as int64 tensors on `device` (made once, before
    a graph capture, which cannot copy from the host)."""
    import torch

    return {"nan": torch.tensor(plan.nan_grads_at or (-1,), dtype=torch.int64, device=device),
            "spike": torch.tensor(plan.spike_loss_at or (-1,), dtype=torch.int64,
                                  device=device)}


@dataclass
class ChaosMonkey:
    """Host-side chaos for the guard's observation path and the preemption
    handler; each listed fault fires once, so a rollback that replays the
    step sees a healthy run (the transient model the rollback policy is
    for; a `StepFaultPlan` fault recurs on replay and spends the budget).

    spike_at: step indices whose observed loss is multiplied by
      `spike_scale` before the guard sees it (`perturb`, plugged into
      `train/guard.py` `HealthPipe(perturb=...)`).
    sigterm_after: after this step, deliver a real SIGTERM to this process
      (`after_step`): the PreemptionGuard, emergency checkpoint and exact
      resume path end to end.
    stall_at: after these steps, sleep `stall_s` seconds on the host (the
      loop wedged; a ``straggler`` span on the ``fault`` track when a
      tracer is attached).
    shrink_at: after this step, raise a cooperative SHRINK preemption on
      the attached `preempt` guard (the elastic resume answers it).
    """

    spike_at: tuple = ()
    spike_scale: float = 100.0
    sigterm_after: int | None = None
    stall_at: tuple = ()
    stall_s: float = 2.0
    shrink_at: int | None = None
    preempt: object = None
    tracer: object = None
    log: object = print
    _fired: set = field(default_factory=set)

    def perturb(self, step, loss, grad_norm, all_finite):
        if step in self.spike_at and ("spike", step) not in self._fired:
            self._fired.add(("spike", step))
            self._flight("spike", step, scale=float(self.spike_scale))
            self.log(f"(chaos: spiking observed loss at step {step} x{self.spike_scale:g})")
            loss = loss * self.spike_scale
        return loss, grad_norm, all_finite

    @staticmethod
    def _flight(what, step, **fields):
        # the injected fault sits in the flight ring right before what it causes
        from ..utils.obs import flight_event

        flight_event("chaos", step=int(step), what=what, **fields)

    def after_step(self, step) -> None:
        if step in self.stall_at and ("stall", step) not in self._fired:
            self._fired.add(("stall", step))
            self._flight("stall", step, seconds=float(self.stall_s))
            self.log(f"(chaos: stalling the step loop for {self.stall_s:g}s after step {step})")
            tracer = self.tracer
            if tracer is None:
                from ..utils.tracing import NULL_TRACER as tracer
            with tracer.span("straggler", track="fault", step=int(step),
                             duration_s=float(self.stall_s), kind="stall"):
                time.sleep(self.stall_s)
        if self.shrink_at is not None and step == self.shrink_at and "shrink" not in self._fired:
            self._fired.add("shrink")
            self._flight("shrink", step)
            self.log(f"(chaos: requesting SHRINK preemption after step {step})")
            if self.preempt is not None:
                self.preempt.request("SHRINK")
        if (self.sigterm_after is not None and step == self.sigterm_after
                and "sigterm" not in self._fired):
            self._fired.add("sigterm")
            self._flight("sigterm", step)
            self.log(f"(chaos: delivering SIGTERM after step {step})")
            os.kill(os.getpid(), _signal.SIGTERM)


# ------------------------------------------------ process-level injectors


@dataclass(frozen=True)
class KillEvent:
    """One process-level fault: deliver `sig` ('KILL' or 'TERM') to worker
    `rank` once its heartbeat reports step >= `at_step`. Rank 0 hosts the
    process group's TCPStore (at ``MASTER_PORT``), so killing it is the
    coordinator-death scenario. Fires exactly once (the ChaosMonkey
    convention: the induced death is then handled - or not - by the
    supervisor's ordinary failure path)."""

    rank: int
    at_step: int = 0
    sig: str = "KILL"

    def __post_init__(self):
        if self.sig not in ("KILL", "TERM"):
            raise ValueError(f"KillEvent signal must be 'KILL' or 'TERM', got {self.sig!r}")
        if self.rank < 0:
            raise ValueError(f"rank must be >= 0, got {self.rank}")

    @property
    def signum(self) -> int:
        return _signal.SIGKILL if self.sig == "KILL" else _signal.SIGTERM


@dataclass
class ProcessChaos:
    """Process-level fault plan driven by the SUPERVISOR
    (`train/supervisor.py`, ``python -m distributed_neural_network_tpu_torch.launch
    --chaos-kill-*``), the real-OS sibling of the in-process ChaosMonkey:
    instead of perturbing an observation stream it kills group members -
    SIGKILL for a crash (no emergency checkpoint, the group restarts from the
    last periodic save), SIGTERM for a preemption notice (the worker's
    cooperative path writes its checkpoint first), rank 0 for the death of
    the TCPStore's host. The supervisor polls worker heartbeats and calls
    `due(steps)` each tick; every event fires once.
    """

    events: tuple = ()
    _fired: set = field(default_factory=set)

    def __post_init__(self):
        self.events = tuple(self.events)
        for e in self.events:
            if not isinstance(e, KillEvent):
                raise TypeError(f"ProcessChaos events must be KillEvent, got {e!r}")

    def __bool__(self):
        return bool(self.events)

    def due(self, steps: dict) -> list:
        """[(rank, signum)] for events whose rank has reached its step.

        `steps` maps rank -> last heartbeat step (None before the first
        beat). at_step=0 fires as soon as the rank heartbeats at all, so
        rendezvous itself can be chaos-tested.
        """
        out = []
        for i, e in enumerate(self.events):
            if i in self._fired or e.rank not in steps:
                continue
            step = steps[e.rank]
            if e.at_step <= 0 or (step is not None and step >= e.at_step):
                self._fired.add(i)
                out.append((e.rank, e.signum))
        return out
