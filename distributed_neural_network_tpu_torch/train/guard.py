"""Preemption and exact resume: the part of the JAX package's `train/guard.py`
that checkpoints and resume need (`PreemptionGuard`, `resume_cursor`,
`check_cursor`). The training guard itself (`TrainingGuard`, `HealthPipe`,
`SpikeDetector`, ``--guard``) comes with ROADMAP Queue 1 item 4, step 4.

`PreemptionGuard` turns SIGTERM / SIGINT into a flag that the training
loops read at each step (LM) or epoch (CNN) boundary: they write an
emergency checkpoint and leave cleanly, so the run resumes from that step
instead of losing it. Under torchrun every rank gets the signal (the
launcher forwards it); the loops still agree on the stop with a max
all-reduce of the flag, so that no rank enters a collective the others
left.
"""

from __future__ import annotations

import signal
import threading

# the checkpoint meta's cursor block version (the JAX package's)
GUARD_META_VERSION = 1


class PreemptionGuard:
    """Cooperative SIGTERM/SIGINT handling for step-boundary emergency
    checkpoints.

    `install()` replaces the handlers with a flag-setter; the training loop
    checks `requested` at each step boundary, writes an emergency
    checkpoint and exits cleanly. A second signal restores the previous
    handler and delivers it again (the way out when the loop is wedged).
    As a context manager the handlers are restored on exit. Handlers can
    only be installed on the main thread: elsewhere `install()` is a no-op
    (`requested` stays False unless `request()` is called)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), *, log=print):
        self.signals = tuple(signals)
        self.log = log
        self.requested = False
        self.signame: str | None = None
        self._prev = {}

    def _handler(self, signum, frame):
        if self.requested:
            # second delivery: restore + re-raise via the original handler
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signame = signal.Signals(signum).name
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
