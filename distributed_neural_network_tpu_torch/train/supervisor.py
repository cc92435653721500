"""Elastic multi-process supervisor: rendezvous, failure detection, and
shrink/grow group restarts across real process boundaries (the port of the
JAX package's `train/supervisor.py`, the training half).

One dead rank kills a whole ``torchrun`` job. This module is the process
layer that keeps the run going instead - the single-node analog of a
cluster manager's job controller, launched with ``python -m
distributed_neural_network_tpu_torch.launch``:

- **Rendezvous.** The supervisor owns the rendezvous port (`reserve_port`)
  and spawns N workers with torchrun's environment: ``MASTER_ADDR``,
  ``MASTER_PORT`` (the reserved port, where rank 0's TCPStore listens),
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, so a
  worker joins through `parallel/distributed.py` `initialize()` (bounded
  retry on the worker side) and picks its card and backend there. A group
  that dies *before* every worker has come up (port stolen between
  allocation and bind, a straggler host) is a **rendezvous failure**: the
  whole group is torn down and relaunched at the same size on a FRESH port,
  under its own bounded retry budget.
- **Failure detection.** Workers are monitored via exit codes and a
  heartbeat file each one writes (`utils/obs.py` `HeartbeatFileWriter`,
  armed by ``DNN_TPU_HEARTBEAT_FILE`` in `train/monitor.py`
  `attach_monitor`: writer liveness + last step). A non-zero exit, a
  delivered signal, or (optionally) a stale heartbeat marks the worker dead.
- **Shrink restart.** On a worker death the survivors get SIGTERM - the
  cooperative-preemption path (finish the step, write an emergency
  checkpoint, exit) when they are not wedged in a collective with the dead
  peer - then SIGKILL after a grace window. The group relaunches with the
  surviving worker count; the worker command's ``{nprocs}``/``{devices}``
  tokens re-substitute, so an ``lm_train --resume --elastic`` workload
  reshards the newest consistent checkpoint onto the smaller mesh and
  continues with the global batch and data cursor intact
  (`train/elastic.py`).
- **Grow/rejoin.** When the group runs below target and capacity returns
  (``capacity_fn``; full target on a single node), a *planned* restart -
  graceful SIGTERM, emergency checkpoints, relaunch at the larger size -
  rejoins the freed slots. Opt-in via ``grow_after_s`` (the healthy-time
  hysteresis that stops a flapping host from thrashing the group).
- **Restart budget.** Failure restarts consume a bounded budget with
  exponential backoff between attempts; a crash-looping group exhausts it
  and fails FAST with the last failure named (`SUPERVISOR ABORT`), never
  flapping forever. Rendezvous retries are budgeted separately (they are
  startup races, not workload crashes).

How a torch worker exits, which is what the supervisor reads (`lm_train.py`
under ``DNN_TPU_SUPERVISOR``): a rank stopped by its own preemption request
(a signal, the watchdog) writes its emergency checkpoint and run record and
exits ``PREEMPT_RC``; a rank that stopped only because a peer asked (the
agreed flag, `train/guard.py` `PreemptionGuard.agreed`) exits 0, and so
does a rank whose collective failed because a peer is gone (gloo raises as
soon as the peer's socket closes): each is collateral, so one lost rank
shrinks the group by one instead of reading as a whole-group failure.
Under NCCL a survivor blocks on the card, where no Python handler runs, and
ends by the supervisor's SIGKILL after the grace window (also collateral).

Process-level chaos (`parallel/fault.py` `ProcessChaos`: kill rank R with
SIGKILL/SIGTERM once its heartbeat reaches step S; rank 0 = the death of the
TCPStore's host) is driven from this loop, so the whole
detect -> checkpoint -> reshard -> resume story is exercised end to end
across genuine process boundaries (``launch --chaos-kill-*``).

- **Goodput accounting** (`utils/goodput.py`): every worker gets a
  ``DNN_TPU_RUN_RECORD`` path next to its heartbeat/flight files; the
  supervisor aggregates the per-rank write-through run records plus its
  own restart-gap measurements (death -> respawn, with a failure-
  relaunched generation's init+compile reclassified into the
  ``restart_gap`` bucket) into one fleet record - exported live as
  ``goodput_ratio`` / ``badput_seconds_total{cause}``, written to
  ``run_dir/run_record.json``, and embedded in ``postmortem.json`` and
  the ``SUPERVISOR_SUMMARY`` line.
- **Fleet federation + postmortems**: `FleetFederation` turns the
  per-worker heartbeat files and (when workers open ``--metrics-port``)
  their scraped ``/metrics`` endpoints into rank-labeled fleet metrics with
  per-step straggler attribution (``fleet_worker_step{rank}``,
  ``fleet_step_skew_seconds``, ``fleet_straggler_rank``); on every failure
  restart or abort the supervisor bundles each rank's crash flight-recorder
  dump (`utils/obs.py` `FlightRecorder`, pointed at ``run_dir/flight/...``
  via ``DNN_TPU_FLIGHT_FILE``) plus exit causes into ``postmortem.json``.

The files, metric names, the ``SUPERVISOR_SUMMARY {json}`` line, the
``DNN_TPU_*`` variables and the exit codes (0, 3, 4; ``PREEMPT_RC`` 75) are
the JAX package's, so the stdlib tools (``tools/live_top.py``,
``tools/trace_merge.py``) read this supervisor unchanged. Differences:

- ``devices_per_proc``: a torch rank drives one device, so it is accepted
  at 1 and refused above it (`SupervisorConfig`); ``{devices}`` equals
  ``{nprocs}``.
- ``force_host_devices`` is kept for the launcher's flags but writes no
  ``XLA_FLAGS``: torch ranks read no XLA device count.
- `ReplicaSupervisor` (the serving fleet's operator) is not here: it comes
  with the serving fleet (ROADMAP Queue 1 item 5), whose replicas must first
  write a heartbeat file.

The module is stdlib-only at import (the package's own ``__init__`` imports
torch) and never calls ``torch.cuda``: the supervisor holds no CUDA context
on the card through the workers' restarts, and keeps running when a
worker's runtime is wedged. Live metrics ride the same registry as
everything else (`utils/obs.py`): ``supervisor_group_size``,
``worker_failures_total{signal}``, ``elastic_restarts_total{direction}``,
``supervisor_restart_seconds``, the ``fleet_*`` family - rendered by
``tools/live_top.py``'s fleet view.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

HEARTBEAT_ENV = "DNN_TPU_HEARTBEAT_FILE"
FLIGHT_ENV = "DNN_TPU_FLIGHT_FILE"
RUN_RECORD_ENV = "DNN_TPU_RUN_RECORD"

# exit code a SUPERVISED worker uses for "preempted cleanly" (emergency
# checkpoint written, exiting on request) - EX_TEMPFAIL. Exit 0 means the
# workload is DONE; without a distinct code the supervisor could not tell
# a finished worker from one that was asked to step aside and must be
# relaunched (lm_train.py returns this when DNN_TPU_SUPERVISOR is set).
PREEMPT_RC = 75

# restart-latency histogram bounds: sub-second dummy-worker relaunches up
# to multi-minute real-group teardowns (grace + SIGKILL + rendezvous)
RESTART_SECONDS_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


def reserve_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port from the OS.

    The OS hands out a distinct ephemeral port per call, which makes the
    classic allocate->close->bind race *rare*, not impossible - another
    process can still take it before the coordinator binds. The fix is
    not a cleverer allocator but ownership: the supervisor reserves a
    FRESH port for every group launch and treats a group that dies during
    rendezvous as retryable (`SupervisorConfig.rendezvous_retries`), so a
    lost race costs one relaunch instead of a failed run.
    """
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return int(s.getsockname()[1])


def read_heartbeat(path: str) -> dict | None:
    """Parse one heartbeat file (`utils/obs.py HeartbeatFileWriter`
    schema: {"t", "beat_unix", "step", "pid", "rank", "hostname",
    "metrics_url"} - the last three are fleet-attribution additions and
    absent from old files, which stay parseable); None when absent or
    torn (the writer publishes atomically, but the first write may not
    have landed yet)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def signal_label(returncode: int) -> str:
    """Prometheus-friendly failure label: killed-by-signal exits name the
    signal (SIGKILL/SIGTERM/...), a clean preemption exit is "preempt",
    plain failures are exit:<code>."""
    if returncode == PREEMPT_RC:
        return "preempt"
    if returncode < 0:
        try:
            return signal.Signals(-returncode).name
        except ValueError:
            return f"signal:{-returncode}"
    return f"exit:{returncode}"


# step-skew histogram bounds (seconds): sub-poll-resolution lockstep up
# to a multi-minute wedged straggler
SKEW_SECONDS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)


class FleetFederation:
    """Aggregate per-rank worker telemetry into the SUPERVISOR's registry
    - the fleet view a single-process `/metrics` endpoint cannot give.

    Two input channels per worker, both already flowing:

    - the **heartbeat file** (`utils/obs.py HeartbeatFileWriter`:
      begin_step + step + rank + metrics_url), read every supervisor
      poll. Step ARRIVALS are timestamped here: the first poll at which
      rank r reports step >= S is r's arrival at S (resolution = the
      poll cadence, fine for straggler work - a stall is seconds, a
      poll is 0.2 s). From arrivals come ``fleet_worker_step{rank}``,
      ``fleet_worker_step_seconds{rank}`` (per-rank step time), and two
      attribution signals: **begin-step divergence** - in a
      synchronized SPMD group a host-wedged rank sits at begin_step S
      while its peers (already dispatched, blocked in the collective)
      report S+1, so the minimum-begin rank is the straggler even
      though COMPLETIONS are delayed equally on every rank - and
      **arrival skew**: once every live rank has arrived at step S, the
      arrival spread is one ``fleet_step_skew_seconds`` histogram
      observation and spreads over ``attrib_min_skew_s`` attribute the
      last arriver (``fleet_straggler_rank`` gauge +
      ``fleet_straggler_total{rank}``; lockstep spreads with no begin
      divergence set the gauge to -1).
    - the worker's **/metrics endpoint** when it opened one
      (``--metrics-port``; the URL is advertised in the heartbeat file),
      scraped every ``scrape_interval_s``: a whitelist of families is
      re-exported with a ``rank`` label (``fleet_train_loss{rank}``,
      ``fleet_train_steps_total{rank}``, ...), and the worker's
      ``train_step_seconds`` histogram sum/count deltas refine the
      heartbeat-derived step-time gauge with fenced wall time.

    Validated against the `parallel/fault.py` stall injector: a
    ``--chaos-stall-step`` rank arrives late at its next step and is
    flagged as the straggler (tests/test_torch_supervisor.py). Stdlib-only,
    like everything else in this module.
    """

    SCRAPE_FAMILIES = (
        "train_loss",
        "train_steps_total",
        "train_throughput_items_per_s",
        "recompiles_total",
        "watchdog_stall_total",
        "guard_rollbacks_total",
        # per-rank goodput (utils/goodput.py ledger export) -> the fleet
        # view shows each worker's own efficiency next to the aggregate
        "goodput_ratio",
    )

    def __init__(
        self,
        registry,
        *,
        scrape_interval_s: float = 2.0,
        http_timeout_s: float = 1.0,
        attrib_min_skew_s: float = 0.25,
    ):
        self.registry = registry
        self.scrape_interval_s = float(scrape_interval_s)
        self.http_timeout_s = float(http_timeout_s)
        self.attrib_min_skew_s = float(attrib_min_skew_s)
        self._m_step = registry.gauge(
            "fleet_worker_step", "Last heartbeat step, per rank"
        )
        self._m_up = registry.gauge(
            "fleet_worker_up", "1 while the rank's process is alive"
        )
        self._m_step_s = registry.gauge(
            "fleet_worker_step_seconds",
            "Per-rank step time (heartbeat arrivals, refined by scrape)",
        )
        self._m_straggler = registry.gauge(
            "fleet_straggler_rank",
            "Rank attributed straggler of the newest completed step "
            "(-1 = none / lockstep)",
        )
        self._m_straggler_total = registry.counter(
            "fleet_straggler_total",
            "Steps on which a rank was attributed straggler, by rank",
        )
        self._m_skew_last = registry.gauge(
            "fleet_last_step_skew_seconds",
            "Arrival spread (max-min) of the newest completed step",
        )
        self._m_skew = registry.histogram(
            "fleet_step_skew_seconds",
            "Per-step cross-rank arrival spread (max-min)",
            buckets=SKEW_SECONDS_BUCKETS,
        )
        self._m_scrapes = registry.counter(
            "fleet_scrapes_total", "Worker /metrics scrapes attempted"
        )
        self._m_scrape_errors = registry.counter(
            "fleet_scrape_errors_total", "Worker /metrics scrapes failed"
        )
        self._m_straggler.set(-1)
        # per-rank (step, t) of the newest arrival; per-step {rank: t}
        self._arrival: dict[int, tuple[int, float]] = {}
        self._step_t: dict[int, dict[int, float]] = {}
        self._begin: dict[int, int] = {}
        self._last_begin_attrib: tuple | None = None
        self._last_scrape: dict[int, float] = {}
        self._scrape_hist: dict[int, tuple[float, float]] = {}

    def observe(self, rank: int, hb: dict, *, alive: bool = True,
                now: float | None = None) -> None:
        """One rank's heartbeat doc, once per poll."""
        now = time.time() if now is None else now
        r = str(rank)
        self._m_up.labels(rank=r).set(1 if alive else 0)
        begin = hb.get("begin_step")
        if begin is not None:
            self._begin[rank] = int(begin)
        step = hb.get("step")
        if step is None:
            return
        step = int(step)
        self._m_step.labels(rank=r).set(step)
        last = self._arrival.get(rank)
        if last is None or step > last[0]:
            if last is not None:
                per = (now - last[1]) / (step - last[0])
                self._m_step_s.labels(rank=r).set(per)
            self._arrival[rank] = (step, now)
            self._step_t.setdefault(step, {})[rank] = now

    def finish_poll(self, live_ranks) -> None:
        """Close out this poll's attribution. Two signals, by failure
        shape:

        - **begin-step divergence** (synchronized SPMD wedges): a rank
          stalled host-side sits at begin_step S while its peers -
          whose NEXT steps are already dispatched and merely blocked in
          the collective - report S+1; the minimum-begin rank is the
          straggler. Completion times cannot tell them apart (the
          collective delays everyone equally), begins can.
        - **arrival skew** (unsynchronized phases, distinct processes):
          once every live rank has arrived at step S, the arrival
          spread feeds the skew histogram, and spreads over
          ``attrib_min_skew_s`` attribute the last arriver.
        """
        live = set(live_ranks)
        if not live:
            return
        begins = {
            r: self._begin[r] for r in live if r in self._begin
        }
        lagging = None
        if len(begins) > 1 and max(begins.values()) > min(begins.values()):
            lagging = min(begins, key=lambda r: begins[r])
            self._m_straggler.set(lagging)
            key = (lagging, begins[lagging])
            if key != self._last_begin_attrib:
                self._last_begin_attrib = key
                self._m_straggler_total.labels(rank=str(lagging)).inc()
        for step in sorted(self._step_t):
            t = self._step_t[step]
            if not live <= set(t):
                continue
            if len(live) > 1:
                # skew/straggler only exist across >= 2 ranks; a group
                # shrunk to one rank keeps its last attribution instead
                # of being reset by meaningless single-rank "steps"
                ts = {r: t[r] for r in live}
                skew = max(ts.values()) - min(ts.values())
                self._m_skew.observe(skew)
                self._m_skew_last.set(skew)
                if skew >= self.attrib_min_skew_s:
                    straggler = max(ts, key=lambda r: ts[r])
                    self._m_straggler.set(straggler)
                    self._m_straggler_total.labels(
                        rank=str(straggler)
                    ).inc()
                elif lagging is None:
                    # lockstep arrivals only clear the gauge when no
                    # begin-divergence attribution is live this poll
                    self._m_straggler.set(-1)
            del self._step_t[step]
        # bound memory: a rank that died mid-step leaves its steps open
        if len(self._step_t) > 128:
            for step in sorted(self._step_t)[:-64]:
                del self._step_t[step]

    def drop_rank(self, rank: int) -> None:
        """Forget a dead rank's arrival state (a relaunch re-learns it)."""
        self._arrival.pop(rank, None)
        self._begin.pop(rank, None)
        self._last_scrape.pop(rank, None)
        self._scrape_hist.pop(rank, None)
        self._m_up.labels(rank=str(rank)).set(0)

    # ------------------------------------------------------------ scraping

    def maybe_scrape(self, rank: int, url: str,
                     now: float | None = None) -> bool:
        """Scrape one worker's /metrics (rate-limited) and re-export the
        whitelisted families with a rank label. Returns True on a scrape
        attempt (tests drive cadence with the now parameter)."""
        now = time.time() if now is None else now
        last = self._last_scrape.get(rank)
        if last is not None and now - last < self.scrape_interval_s:
            return False
        self._last_scrape[rank] = now
        self._m_scrapes.inc()
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + "/metrics", timeout=self.http_timeout_s
            ) as r:
                text = r.read().decode()
        except (urllib.error.URLError, OSError, ValueError):
            self._m_scrape_errors.inc()
            return True
        self.ingest(rank, text)
        return True

    def ingest(self, rank: int, text: str) -> None:
        """Fold one scraped exposition body into the fleet registry."""
        from ..utils.obs import parse_prom_samples

        fams = parse_prom_samples(text)
        r = str(rank)
        for name in self.SCRAPE_FAMILIES:
            fam = fams.get(name)
            if not fam:
                continue
            counter = name.endswith("_total")
            m = (
                self.registry.counter(f"fleet_{name}")
                if counter else self.registry.gauge(f"fleet_{name}")
            )
            for key, val in fam.items():
                labels = dict(key)
                labels["rank"] = r
                child = m.labels(**labels)
                # re-exported counters move monotonically even if a
                # scrape raced a worker restart
                (child.set_max if counter else child.set)(val)
        # refine the per-rank step time with the worker's own fenced
        # step-seconds histogram (sum/count delta since the last scrape)
        s = sum((fams.get("train_step_seconds_sum") or {}).values())
        c = sum((fams.get("train_step_seconds_count") or {}).values())
        if c > 0:
            ps, pc = self._scrape_hist.get(rank, (0.0, 0.0))
            if c > pc:
                self._m_step_s.labels(rank=r).set((s - ps) / (c - pc))
            self._scrape_hist[rank] = (s, c)


@dataclass
class SupervisorPolicy:
    """The failure-response POLICY half of the supervisor's knobs: what
    the supervisor DOES when workers die (how many restarts, at what
    backoff, down to what size, growing back after how long) - as
    opposed to HOW it runs processes (ports, polling, device flags,
    `SupervisorConfig` below).

    Extracted as its own type so the fleet digital twin
    (the JAX package's `analysis/fleetsim.py`, ROADMAP Queue 1 item 6)
    replays EXACTLY the struct the real
    supervisor executes: one config type, two consumers - a policy tuned
    in simulation is the object a launch runs, field for field, and a
    knob added here is automatically a searchable dimension there.
    """

    nprocs: int
    min_procs: int = 1
    # failure-restart budget for the whole run; exhausted -> fail fast
    max_restarts: int = 3
    restart_backoff_s: float = 1.0
    backoff_cap_s: float = 30.0
    # SIGTERM -> SIGKILL grace when stopping survivors (long enough for a
    # healthy worker to finish its step + emergency checkpoint)
    grace_s: float = 10.0
    # 0 = never grow; > 0 = after a shrunk group has been healthy this
    # long AND capacity_fn() reports free slots, do a planned grow restart
    grow_after_s: float = 0.0

    def __post_init__(self):
        if self.nprocs < 1:
            raise ValueError(f"nprocs must be >= 1, got {self.nprocs}")
        if not 1 <= self.min_procs <= self.nprocs:
            raise ValueError(
                f"min_procs must be in [1, nprocs={self.nprocs}], got "
                f"{self.min_procs}"
            )
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        for name in ("restart_backoff_s", "grace_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")

    def backoff_for(self, attempt: int) -> float:
        """Backoff pause before failure restart number ``attempt``
        (1-based): exponential from ``restart_backoff_s``, capped."""
        return min(
            self.restart_backoff_s * (2 ** (max(int(attempt), 1) - 1)),
            self.backoff_cap_s,
        )

    def policy_dict(self) -> dict:
        """The policy as a plain JSON-safe dict (fleetsim records embed
        it so a simulated ranking names the exact knobs it ranked)."""
        import dataclasses

        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(SupervisorPolicy)
        }

    @classmethod
    def from_policy_dict(cls, doc: dict) -> "SupervisorPolicy":
        """Inverse of `policy_dict`; unknown keys are ignored so a
        config-shaped dict (or an older record) loads as its policy."""
        import dataclasses

        known = {f.name for f in dataclasses.fields(SupervisorPolicy)}
        return cls(**{k: v for k, v in doc.items() if k in known})


@dataclass
class SupervisorConfig(SupervisorPolicy):
    """Knobs for `Supervisor`; the launcher (`launch.py`) maps them 1:1 to
    flags. Extends `SupervisorPolicy` (the failure-response knobs the
    fleetsim twin shares) with the process-runner half: devices,
    rendezvous, heartbeat staleness, polling."""

    # a torch rank drives one device: 1 is the only value (module docs)
    devices_per_proc: int = 1
    # the JAX field (force the workers' XLA host device count); kept for the
    # launcher's flags, it writes nothing here: torch ranks read no XLA_FLAGS
    force_host_devices: bool = True
    # startup races (coordinator port lost, worker died before the full
    # group ever heartbeat) retry on a fresh port under their own budget
    rendezvous_retries: int = 2
    rendezvous_timeout_s: float = 120.0
    # after a failure is detected, wait this long (or until everyone has
    # exited) before freezing the failure set: a gang crash's deaths
    # straddle poll boundaries, and without the settle a whole-group
    # crash can be misread as a partial one (spurious below-min-procs
    # abort instead of a same-size restart)
    failure_settle_s: float = 0.5
    # 0 = exit codes only; > 0 additionally treats a worker whose TRAINING
    # heartbeat (beat_unix) is older than this as dead (armed only after
    # the worker's first beat - compilation produces none)
    heartbeat_timeout_s: float = 0.0
    poll_s: float = 0.2
    host: str = "127.0.0.1"

    def __post_init__(self):
        super().__post_init__()
        if self.devices_per_proc < 1:
            raise ValueError(
                f"devices_per_proc must be >= 1, got {self.devices_per_proc}"
            )
        if self.devices_per_proc > 1:
            raise ValueError(
                f"devices_per_proc must be 1, got {self.devices_per_proc}: a "
                "torch worker drives one device (its card is picked from "
                "LOCAL_RANK), so a group of N cards is N worker processes - "
                "pass --nprocs N instead"
            )
        if self.rendezvous_retries < 0:
            raise ValueError("rendezvous_retries must be >= 0")
        if self.poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        if self.failure_settle_s < 0:
            raise ValueError("failure_settle_s must be >= 0")

    def policy(self) -> SupervisorPolicy:
        """The pure-policy view of this config (a `SupervisorPolicy`
        copy - what the fleetsim twin simulates)."""
        return SupervisorPolicy.from_policy_dict(self.policy_dict())


@dataclass
class _Worker:
    rank: int
    proc: subprocess.Popen
    hb_path: str
    log_path: str
    log_file: object
    flight_path: str = ""
    returncode: int | None = None
    ever_beat: bool = False

    def poll(self) -> int | None:
        if self.returncode is None:
            rc = self.proc.poll()
            if rc is not None:
                self.returncode = rc
                try:
                    self.log_file.close()
                except Exception:
                    pass
        return self.returncode

    def alive(self) -> bool:
        return self.poll() is None

    def kill(self, sig: int) -> None:
        if self.alive():
            try:
                self.proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass


class Supervisor:
    """Spawn and babysit one elastic training group (see module docs).

    ``command`` is the worker argv; every element may carry the tokens
    ``{rank}`` (this worker's process id), ``{nprocs}`` (the CURRENT
    group size), and ``{devices}`` (nprocs * devices_per_proc - what an
    ``lm_train.py --dp {devices}`` mesh should span), re-substituted on
    every (re)launch so a shrink/grow restart reshapes the workload.
    ``capacity_fn() -> int`` reports how many worker slots are currently
    available (defaults to the full target - the single-node case);
    ``chaos`` is a `parallel/fault.py ProcessChaos` plan driven from the
    monitor loop. `run()` blocks until the group completes (rc 0), the
    restart budget is exhausted (rc 3), or rendezvous never succeeds
    (rc 4), and prints one machine-readable ``SUPERVISOR_SUMMARY {json}``
    line either way.
    """

    def __init__(
        self,
        command: list,
        config: SupervisorConfig,
        *,
        run_dir: str,
        chaos=None,
        base_env: dict | None = None,
        registry=None,
        capacity_fn=None,
        federation: FleetFederation | None = None,
        log=print,
    ):
        self.command = [str(c) for c in command]
        self.cfg = config
        self.run_dir = os.path.abspath(run_dir)
        self.chaos = chaos
        self.base_env = dict(base_env if base_env is not None else os.environ)
        self.capacity_fn = capacity_fn or (lambda: config.nprocs)
        self.log = log
        if registry is None:
            from ..utils.obs import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self._m_size = registry.gauge(
            "supervisor_group_size", "Live worker count of the elastic group"
        )
        self._m_target = registry.gauge(
            "supervisor_target_size", "Configured target worker count"
        )
        self._m_budget = registry.gauge(
            "supervisor_restart_budget_remaining",
            "Failure restarts left before the group fails fast",
        )
        self._m_failures = registry.counter(
            "worker_failures_total",
            "Worker deaths observed, by signal/exit label",
        )
        self._m_restarts = registry.counter(
            "elastic_restarts_total",
            "Group restarts, by direction (shrink/grow/rendezvous)",
        )
        self._m_restart_s = registry.histogram(
            "supervisor_restart_seconds",
            "Failure detection -> group respawned latency",
            buckets=RESTART_SECONDS_BUCKETS,
        )
        self._m_postmortems = registry.counter(
            "supervisor_postmortems_total",
            "Postmortem bundles written (failure restarts + aborts)",
        )
        # fleet goodput accounting (utils/goodput.py): the supervisor
        # aggregates the per-worker write-through run records plus its
        # own restart-gap measurements and re-exports the fleet view
        self._m_goodput = registry.gauge(
            "goodput_ratio",
            "Fleet fraction of capacity-seconds spent in steady steps",
        )
        self._m_badput = registry.counter(
            "badput_seconds_total",
            "Fleet capacity-seconds lost to non-goodput causes, by cause",
        )
        self._m_gap_last = registry.gauge(
            "supervisor_restart_gap_seconds",
            "Newest worker-death -> first-post-restart-step window",
        )
        # per-rank fleet metrics + straggler attribution + /metrics
        # federation, on the same registry the launcher serves
        self.federation = (
            federation if federation is not None
            else FleetFederation(registry)
        )
        self.postmortem_path = os.path.join(self.run_dir, "postmortem.json")
        self.postmortems_written = 0
        self.workers: list[_Worker] = []
        self.generation = -1
        self.n = config.nprocs
        self.port: int | None = None
        self.restarts_used = 0
        self.rendezvous_used = 0
        self.failures: list[dict] = []
        self._group_started = 0.0
        self._healthy_since: float | None = None
        # goodput bookkeeping: supervisor-measured restart gaps
        # (death -> respawn, in capacity-seconds at the relaunched size),
        # the generations that exist BECAUSE of a failure restart (their
        # ranks' init+compile reclassify into restart_gap at aggregation),
        # and the open death -> first-post-restart-step window
        self.restart_gaps: list[dict] = []
        self.restart_generations: set[int] = set()
        self._gap_open: float | None = None
        self._goodput_published = 0.0
        self.fleet_goodput: dict | None = None
        # a reused run dir must not leak the previous run's liveness or
        # crash state into this one (mirrors the checkpointers' stale
        # step_*.tmp sweep): a relaunch reading an old heartbeat would
        # see a phantom live worker, an old flight dump would corrupt the
        # next postmortem, an old run record the goodput aggregation
        swept = self._sweep_stale_run_dir()
        if swept:
            self.log(
                f"(supervisor: swept {swept} stale heartbeat/flight/"
                f"record/postmortem file(s) from reused {self.run_dir})"
            )
        os.makedirs(os.path.join(self.run_dir, "hb"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "logs"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "flight"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "records"), exist_ok=True)
        self._m_target.set(config.nprocs)
        self._m_budget.set(config.max_restarts)

    def _sweep_stale_run_dir(self) -> int:
        """Remove a previous run's state files from this run dir (the
        subdirs this supervisor owns, plus postmortem.json and the fleet
        run_record.json); never raises - a sweep failure must not block
        the launch. Logs are kept (they are the previous run's evidence,
        and generation-numbered names make them non-ambiguous)."""
        swept = 0
        for sub in ("hb", "flight", "records"):
            d = os.path.join(self.run_dir, sub)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if not (name.endswith(".json") or ".json.tmp" in name):
                    continue
                try:
                    os.unlink(os.path.join(d, name))
                    swept += 1
                except OSError:
                    pass
        for name in ("postmortem.json", "run_record.json"):
            try:
                os.unlink(os.path.join(self.run_dir, name))
                swept += 1
            except OSError:
                pass
        return swept

    # ------------------------------------------------------------- spawn

    def _worker_argv(self, rank: int, n: int) -> list:
        devices = n * self.cfg.devices_per_proc
        sub = {
            "{rank}": str(rank), "{nprocs}": str(n),
            "{devices}": str(devices),
        }
        out = []
        for arg in self.command:
            for k, v in sub.items():
                arg = arg.replace(k, v)
            out.append(arg)
        return out

    def _worker_env(self, rank: int, n: int, port: int, hb_path: str,
                    flight_path: str, record_path: str = "") -> dict:
        env = dict(self.base_env)
        # torchrun's rendezvous variables (`parallel/distributed.py`
        # `initialize`): rank 0's TCPStore listens on the reserved port; all
        # ranks are on this host, so the local rank and world are the global
        # ones (`rank_device` and `backend_for` read them)
        env.update(MASTER_ADDR=self.cfg.host, MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n))
        env[HEARTBEAT_ENV] = hb_path
        # per-worker crash flight recorder (utils/obs.py FLIGHT): the
        # worker's write-through dump lands here and is bundled into
        # postmortem.json on failure - even after a SIGKILL
        env[FLIGHT_ENV] = flight_path
        if record_path:
            # per-worker goodput run record (utils/goodput.py LEDGER):
            # write-through like the flight dump, aggregated fleet-wide
            env[RUN_RECORD_ENV] = record_path
        env["DNN_TPU_SUPERVISOR"] = "1"
        env["DNN_TPU_SUPERVISOR_GEN"] = str(self.generation)
        return env

    def _spawn_group(self, n: int) -> None:
        self.generation += 1
        self.n = n
        self.port = reserve_port(self.cfg.host)
        self.workers = []
        g = self.generation
        for rank in range(n):
            hb_path = os.path.join(
                self.run_dir, "hb", f"gen{g}_rank{rank}.json"
            )
            log_path = os.path.join(
                self.run_dir, "logs", f"gen{g}_rank{rank}.log"
            )
            flight_path = os.path.join(
                self.run_dir, "flight", f"gen{g}_rank{rank}.json"
            )
            record_path = os.path.join(
                self.run_dir, "records", f"gen{g}_rank{rank}.json"
            )
            log_file = open(log_path, "w")
            argv = self._worker_argv(rank, n)
            proc = subprocess.Popen(
                argv,
                env=self._worker_env(
                    rank, n, self.port, hb_path, flight_path, record_path
                ),
                stdout=log_file,
                stderr=subprocess.STDOUT,
            )
            self.workers.append(
                _Worker(rank, proc, hb_path, log_path, log_file,
                        flight_path)
            )
        self._group_started = time.monotonic()
        self._healthy_since = None
        self._m_size.set(n)
        self.log(
            f"(supervisor: gen {g} - {n} worker(s) x "
            f"{self.cfg.devices_per_proc} device(s), coordinator "
            f"{self.cfg.host}:{self.port}, logs {self.run_dir}/logs)"
        )

    # -------------------------------------------------------------- stop

    def _stop_group(self, *, reason: str) -> None:
        """SIGTERM every living worker (the cooperative emergency-
        checkpoint path), SIGKILL whatever outlives the grace window."""
        living = [w for w in self.workers if w.alive()]
        if living:
            self.log(
                f"(supervisor: stopping {len(living)} worker(s) - {reason}; "
                f"SIGTERM, then SIGKILL after {self.cfg.grace_s:g}s)"
            )
        for w in living:
            w.kill(signal.SIGTERM)
        deadline = time.monotonic() + self.cfg.grace_s
        while time.monotonic() < deadline and any(
            w.alive() for w in self.workers
        ):
            time.sleep(min(self.cfg.poll_s, 0.1))
        for w in self.workers:
            if w.alive():
                self.log(
                    f"(supervisor: rank {w.rank} ignored SIGTERM for "
                    f"{self.cfg.grace_s:g}s; SIGKILL)"
                )
                w.kill(signal.SIGKILL)
        for w in self.workers:
            try:
                w.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover - defensive
                pass
            w.poll()

    def _tail(self, w: _Worker, lines: int = 20) -> str:
        try:
            with open(w.log_path, errors="replace") as f:
                return "".join(f.readlines()[-lines:])
        except OSError:
            return "(no log)"

    # --------------------------------------------------------- postmortem

    def _write_postmortem(self, failed: list, *, reason: str) -> str | None:
        """Bundle the stopped generation into ``postmortem.json``: per
        rank the exit cause, last heartbeat, flight-recorder dump (the
        write-through ring survives even a SIGKILL - utils/obs.py
        FlightRecorder), and a log tail; plus the run-level failure
        history. Written atomically on every failure restart and on
        SUPERVISOR ABORT - the newest bundle describes the newest crash.
        Never raises (a postmortem must not break the restart path)."""
        from ..utils.obs import read_flight_dump

        failed_ranks = {w.rank for w in failed}
        workers = []
        for w in self.workers:
            rc = w.poll()
            workers.append({
                "rank": w.rank,
                "pid": w.proc.pid,
                "generation": self.generation,
                "returncode": rc,
                "cause": signal_label(rc) if rc is not None else None,
                "failed": w.rank in failed_ranks,
                "ever_beat": w.ever_beat,
                "heartbeat": read_heartbeat(w.hb_path),
                "flight": read_flight_dump(w.flight_path),
                "log_tail": self._tail(w, 10),
            })
        doc = {
            "version": 1,
            "written_unix": time.time(),
            "reason": reason,
            "generation": self.generation,
            "group_size": self.n,
            "target_nprocs": self.cfg.nprocs,
            "restarts_used": self.restarts_used,
            "rendezvous_used": self.rendezvous_used,
            "failures": list(self.failures),
            # fleet goodput accounting as of this crash (the killed
            # rank's write-through record is already folded in)
            "goodput": self._publish_goodput(),
            "workers": workers,
        }
        tmp = self.postmortem_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, self.postmortem_path)
        except OSError:
            return None
        self.postmortems_written += 1
        self._m_postmortems.inc()
        self.log(f"(supervisor: postmortem bundle -> {self.postmortem_path})")
        return self.postmortem_path

    # ------------------------------------------------------------ monitor

    def _observe(self) -> dict:
        """One poll: worker liveness + heartbeat steps + fleet federation
        (per-rank gauges, step-arrival skew, /metrics scrapes); fires due
        chaos."""
        steps: dict[int, int | None] = {}
        beating: list[int] = []
        for w in self.workers:
            # read even for dead workers: the file's existence proves the
            # worker got through rendezvous, however briefly it lived
            hb = read_heartbeat(w.hb_path)
            if hb is not None:
                w.ever_beat = True
                if not w.alive():
                    self.federation.drop_rank(w.rank)
                    continue
                self.federation.observe(w.rank, hb, alive=True)
                if hb.get("step") is not None:
                    beating.append(w.rank)
                url = hb.get("metrics_url")
                if url:
                    self.federation.maybe_scrape(w.rank, url)
                steps[w.rank] = hb.get("step")
                if self.cfg.heartbeat_timeout_s > 0:
                    beat = hb.get("beat_unix")
                    if (
                        beat is not None
                        and time.time() - float(beat)
                        > self.cfg.heartbeat_timeout_s
                    ):
                        self.log(
                            f"(supervisor: rank {w.rank} heartbeat is "
                            f"{time.time() - float(beat):.1f}s stale "
                            f"(budget {self.cfg.heartbeat_timeout_s:g}s); "
                            "declaring it dead)"
                        )
                        w.kill(signal.SIGKILL)
        self.federation.finish_poll(beating)
        if self._gap_open is not None and beating:
            # first post-restart step: the issue-defined restart window
            # (worker death -> first step of the relaunched group)
            self._m_gap_last.set(time.monotonic() - self._gap_open)
            self._gap_open = None
        now = time.monotonic()
        if now - self._goodput_published >= 5.0:
            self._goodput_published = now
            self._publish_goodput()
        if self.chaos is not None:
            for rank, sig in self.chaos.due(steps):
                for w in self.workers:
                    if w.rank == rank and w.alive():
                        self.log(
                            f"(supervisor chaos: sending "
                            f"{signal.Signals(sig).name} to rank {rank}"
                            + (" [the coordinator process]"
                               if rank == 0 else "")
                            + f" at step {steps.get(rank)})"
                        )
                        w.kill(sig)
        return steps

    def _group_ready(self) -> bool:
        return all(w.ever_beat for w in self.workers)

    # ------------------------------------------------------------- goodput

    def _publish_goodput(self) -> dict | None:
        """Aggregate every generation's per-rank run records (partial
        write-through ones from killed workers included) plus the
        supervisor-measured restart gaps into ONE fleet record
        (`utils/goodput.py fleet_goodput_record`), re-exported as
        ``goodput_ratio`` / ``badput_seconds_total{cause}`` on the
        supervisor's registry and stashed for the postmortem bundle and
        SUPERVISOR_SUMMARY. Never raises."""
        from ..utils.goodput import (
            BADPUT_CAUSES,
            fleet_goodput_record,
            validate_record,
        )

        records = []
        d = os.path.join(self.run_dir, "records")
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    records.append(validate_record(json.load(f), name))
            except (OSError, ValueError):
                continue  # torn/partial write or a non-record file
        if not records and not self.restart_gaps:
            return None
        try:
            fleet = fleet_goodput_record(
                records,
                restart_gaps=self.restart_gaps,
                restart_generations=self.restart_generations,
            )
        except ValueError:
            return None
        self.fleet_goodput = fleet
        if fleet.get("goodput_ratio") is not None:
            self._m_goodput.set(fleet["goodput_ratio"])
        for cause in BADPUT_CAUSES:
            v = (fleet.get("badput_s") or {}).get(cause, 0.0)
            if v > 0:
                self._m_badput.labels(cause=cause).set_max(v)
        return fleet

    def _goodput_brief(self) -> dict | None:
        """The compact fleet-goodput block for log-line summaries."""
        fleet = self.fleet_goodput
        if fleet is None:
            return None
        return {
            "goodput_ratio": fleet.get("goodput_ratio"),
            "wall_s": fleet.get("wall_s"),
            "goodput_s": fleet.get("goodput_s"),
            "badput_s": {
                k: v for k, v in (fleet.get("badput_s") or {}).items()
                if v > 0
            },
            "n_records": fleet.get("n_records"),
        }

    # --------------------------------------------------------------- run

    def run(self) -> int:
        self._spawn_group(self.n)
        rc = self._loop()
        self._summary(rc)
        return rc

    def _loop(self) -> int:
        cfg = self.cfg
        while True:
            time.sleep(cfg.poll_s)
            self._observe()
            exited = [w for w in self.workers if not w.alive()]
            failed = [w for w in exited if w.returncode != 0]
            if failed:
                rc = self._handle_failure(failed)
                if rc is not None:
                    return rc
                continue
            if len(exited) == len(self.workers):
                self.log(
                    f"(supervisor: all {self.n} worker(s) exited cleanly)"
                )
                return 0
            ready = self._group_ready()
            if not ready and (
                time.monotonic() - self._group_started
                > cfg.rendezvous_timeout_s
            ):
                self.log(
                    "(supervisor: group did not finish rendezvous within "
                    f"{cfg.rendezvous_timeout_s:g}s)"
                )
                rc = self._handle_failure([], rendezvous_timeout=True)
                if rc is not None:
                    return rc
                continue
            if ready:
                if self._healthy_since is None:
                    self._healthy_since = time.monotonic()
                grow_rc = self._maybe_grow()
                if grow_rc is not None:
                    return grow_rc

    def _maybe_grow(self) -> int | None:
        cfg = self.cfg
        if cfg.grow_after_s <= 0 or self.n >= cfg.nprocs:
            return None
        if (
            self._healthy_since is None
            or time.monotonic() - self._healthy_since < cfg.grow_after_s
        ):
            return None
        capacity = min(int(self.capacity_fn()), cfg.nprocs)
        if capacity <= self.n:
            return None
        self.log(
            f"(supervisor: capacity is back ({capacity} slot(s)); planned "
            f"grow restart {self.n} -> {capacity} - graceful SIGTERM so "
            "every worker writes its emergency checkpoint first)"
        )
        t0 = time.monotonic()
        self._stop_group(reason="planned grow restart")
        bad = [
            w for w in self.workers
            if w.returncode not in (0, None, PREEMPT_RC)
        ]
        if bad:
            # a worker that cannot even stop cleanly is a real failure -
            # fall through to the failure path (budgeted) instead of
            # growing on top of a corrupt group
            return self._handle_failure(bad)
        self._m_restarts.labels(direction="grow").inc()
        self._spawn_group(capacity)
        self._m_restart_s.observe(time.monotonic() - t0)
        return None

    def _handle_failure(
        self, failed: list, *, rendezvous_timeout: bool = False
    ) -> int | None:
        """Tear the group down and decide: relaunch (None) or abort (rc)."""
        cfg = self.cfg
        t0 = time.monotonic()
        if failed and not rendezvous_timeout and cfg.failure_settle_s > 0:
            # settle: a gang crash's other deaths may be microseconds
            # behind the one this poll caught - wait briefly (or until
            # nobody is left) and re-collect, so the failure set is the
            # EVENT's, not one poll's worth of it
            deadline = time.monotonic() + cfg.failure_settle_s
            while time.monotonic() < deadline and any(
                w.alive() for w in self.workers
            ):
                time.sleep(min(cfg.poll_s, 0.05))
            failed = [
                w for w in self.workers
                if w.poll() is not None and w.returncode != 0
            ]
        rendezvous = rendezvous_timeout or not self._group_ready()
        for w in failed:
            label = signal_label(w.returncode)
            self._m_failures.labels(signal=label).inc()
            self.failures.append(
                {"gen": self.generation, "rank": w.rank, "cause": label}
            )
            self.log(
                f"(supervisor: rank {w.rank} died [{label}]"
                + (" during rendezvous" if rendezvous else "")
                + f"; last output:\n{self._tail(w)})"
            )
        self._stop_group(
            reason="worker failure" if failed else "rendezvous timeout"
        )
        # deaths BY OUR OWN STOP are collateral (cooperative exit 0 /
        # PREEMPT_RC, or our SIGTERM/SIGKILL): not new failures. A worker
        # that exits with its own non-zero code during the teardown,
        # though, crashed in the same event - its death just straddled a
        # poll. Folding those in keeps a whole-group crash detected as
        # one (same-size restart) instead of racing the poll cadence
        # into a spurious below-min-procs abort.
        if failed:
            collateral = {0, None, PREEMPT_RC,
                          -int(signal.SIGTERM), -int(signal.SIGKILL)}
            late = [
                w for w in self.workers
                if w not in failed and w.returncode not in collateral
            ]
            for w in late:
                label = signal_label(w.returncode)
                self._m_failures.labels(signal=label).inc()
                self.failures.append(
                    {"gen": self.generation, "rank": w.rank, "cause": label}
                )
                self.log(
                    f"(supervisor: rank {w.rank} also died [{label}] "
                    "during the group stop - counting it into the same "
                    "failure)"
                )
            failed = failed + late
        self._write_postmortem(
            failed,
            reason="rendezvous failure" if rendezvous else "worker failure",
        )
        if rendezvous:
            self.rendezvous_used += 1
            if self.rendezvous_used > cfg.rendezvous_retries:
                self.log(
                    "SUPERVISOR ABORT: rendezvous failed "
                    f"{self.rendezvous_used} time(s) (budget "
                    f"{cfg.rendezvous_retries}); the group never came up. "
                    "Check the worker logs for the real error (import "
                    "failure, bad flags, unreachable coordinator) - "
                    f"{self.run_dir}/logs"
                )
                return 4
            self._m_restarts.labels(direction="rendezvous").inc()
            self.log(
                f"(supervisor: rendezvous retry "
                f"{self.rendezvous_used}/{cfg.rendezvous_retries} on a "
                "fresh port)"
            )
            self._spawn_group(self.n)
            self._m_restart_s.observe(time.monotonic() - t0)
            return None
        self.restarts_used += 1
        self._m_budget.set(max(cfg.max_restarts - self.restarts_used, 0))
        last = self.failures[-1] if self.failures else {"cause": "unknown"}
        if self.restarts_used > cfg.max_restarts:
            self.log(
                f"SUPERVISOR ABORT: restart budget ({cfg.max_restarts}) "
                f"exhausted after {self.restarts_used} failure(s); last "
                f"failure: rank {last.get('rank')} [{last.get('cause')}] "
                f"in gen {last.get('gen')}. The group is crash-looping - "
                "inspect the worker logs "
                f"({self.run_dir}/logs), fix the cause, and relaunch; the "
                "newest consistent checkpoint is intact."
            )
            return 3
        if len(failed) >= len(self.workers):
            # the WHOLE group died at once (e.g. a coordinator crash took
            # everyone down): there is no survivor count to shrink onto,
            # but the newest checkpoint still allows a same-size restart
            new_n = self.n
        else:
            new_n = self.n - len(failed)
            if new_n < cfg.min_procs:
                self.log(
                    f"SUPERVISOR ABORT: only {new_n} worker(s) survive "
                    f"but --min-procs is {cfg.min_procs}; not enough "
                    "capacity to continue. Last failure: rank "
                    f"{last.get('rank')} [{last.get('cause')}]."
                )
                return 3
        pause = cfg.backoff_for(self.restarts_used)
        direction = "shrink" if new_n < self.n else "same"
        self.log(
            f"(supervisor: restart {self.restarts_used}/{cfg.max_restarts} "
            f"[{direction}] {self.n} -> {new_n} worker(s) after "
            f"{pause:.1f}s backoff; resuming from the newest consistent "
            "checkpoint)"
        )
        time.sleep(pause)
        self._m_restarts.labels(direction=direction).inc()
        self._spawn_group(new_n)
        gap = time.monotonic() - t0
        self._m_restart_s.observe(gap)
        # goodput: death-detection -> respawn is capacity the fleet lost
        # with NO worker process alive - the supervisor-side half of the
        # restart_gap bucket (the relaunched generation's init+compile is
        # the other half, reclassified at aggregation; utils/goodput.py
        # fleet_goodput_record). The death -> first-post-restart-step
        # window closes in _observe once the new group heartbeats a step.
        # backoff_s is recorded separately so distribution extraction
        # (utils/goodput.py extract_distributions) can report the gap NET
        # of the policy's own pause - the fleetsim twin re-adds whatever
        # backoff the SIMULATED policy chooses instead of baking this
        # run's schedule into the empirical sample
        self.restart_gaps.append({
            "seconds": round(gap, 3), "group_size": new_n,
            "generation": self.generation, "detected_unix": time.time(),
            "backoff_s": round(pause, 3),
        })
        self.restart_generations.add(self.generation)
        self._gap_open = t0
        return None

    def _summary(self, rc: int) -> None:
        fleet = self._publish_goodput()
        if fleet is not None:
            # the final fleet-level record, checkable by tools/goodput.py
            # (render / --diff / --check against a baseline)
            from ..utils.goodput import _atomic_write_json

            path = os.path.join(self.run_dir, "run_record.json")
            if _atomic_write_json(path, fleet):
                self.log(f"(supervisor: fleet goodput record -> {path})")
        self.log("SUPERVISOR_SUMMARY " + json.dumps({
            "exit": {0: "ok", 3: "budget", 4: "rendezvous"}.get(rc, "error"),
            "rc": rc,
            "target_nprocs": self.cfg.nprocs,
            "final_size": self.n,
            "generations": self.generation + 1,
            "restarts": self.restarts_used,
            "rendezvous_retries": self.rendezvous_used,
            "worker_failures": self.failures,
            "postmortems": self.postmortems_written,
            "postmortem_path": (
                self.postmortem_path if self.postmortems_written else None
            ),
            "goodput": self._goodput_brief(),
        }))



def main(argv=None) -> int:  # pragma: no cover - thin alias
    """`python -m distributed_neural_network_tpu_torch.train.supervisor` =
    `python -m distributed_neural_network_tpu_torch.launch`."""
    from ..launch import main as launch_main

    return launch_main(argv)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
