"""Runtime watchdog: stall, recompile-storm and checkpoint-staleness
detection over the live metrics registry (`utils/obs.py`), the on-demand
profiler, and the CLIs' monitor wiring (counterpart of the JAX package's
`train/monitor.py`; the same names, metric names, trace instants and flight
events).

The guard (`train/guard.py`) judges what a step reports (loss, gradient
norm, finite flag); this module judges whether steps are happening at all:
a wedged collective, a dead host thread, a storm of re-captured programs,
or a checkpointer that stopped writing. None of those raise; they stop the
run, or burn it, until someone reads a trace after the fact.

Three detectors on one polling thread (default 1 s cadence, off the step
loop):

- **stall**: the training loop beats the registry at each step boundary
  (`registry.beat(step)`); the threshold is ``stall_factor x p95`` of the
  observed beat intervals, clamped to [``min_stall_s``, ``max_stall_s``].
  One flag per episode (latched until the next beat): a ``watchdog/stall``
  trace instant, ``watchdog_stall_total`` and a ``watchdog_stall`` flight
  event; the no-beat window goes to the goodput ledger as ``stall``.
  Escalation (``escalate_after_polls``) calls
  `train/guard.py` `PreemptionGuard.request("WATCHDOG")`: the run writes its
  emergency checkpoint and exits. The port's preemption flag is agreed by
  every rank at the next step's launch (`PreemptionGuard.agreed`), so a
  watchdog that escalates on one rank stops every rank at the same step.
- **recompile storm**: `RecompileDetector.observe()` reads the step's
  ``_cache_size()`` once a step. The port has no jit cache: the step objects
  (`train/lm.py` `LMTrainStep`, `EvalLoss`, `parallel/pipeline.py`
  `PPTrainStep`, the CNN engine's `train/graphs.py` `Program`) count the
  programs they have built (on the card: captured as CUDA graphs; on the
  CPU: the first eager build). The first is the compile; any later one is a
  miss, counted in ``recompiles_total``. More than ``recompile_storm`` of
  them within ``recompile_window_s`` flags the storm.
- **checkpoint staleness**: the checkpointers publish
  ``checkpoint_last_save_timestamp_seconds`` (`utils/checkpoint.py`); an age
  beyond ``checkpoint_stale_s`` flags once per stale save.

`ProfileController` captures N steps with `torch.profiler` on request
(``GET /profile?steps=N``), driven by the registry's beat hook.
`attach_monitor()` is the shared wiring of ``--metrics-port`` for
`lm_train.py` and `train/cli.py`: registry, server, watchdog, heartbeat
file, flight recorder and profiler, one handle to close.

Threads: the watchdog's, the heartbeat writer's and the HTTP server's
threads touch no CUDA tensor and make no CUDA call; they read host floats
the step loop published (beat times, gauges, counters). So they can run
while the step loop captures a CUDA graph (captures run with
``capture_error_mode="thread_local"``, `train/graphs.py`). The profiler
starts and stops on the step loop's own thread, at a beat, never while a
capture is under way.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from ..utils import obs as O
from ..utils import tracing as TR
from ..utils.obs import flight_event

WATCHDOG_STALL = "watchdog/stall"
WATCHDOG_RECOMPILE = "watchdog/recompile_storm"
WATCHDOG_CKPT_STALE = "watchdog/checkpoint_stale"


@dataclass
class WatchdogConfig:
    """Detection knobs. The stall threshold is adaptive (N x the steady p95
    beat interval), so one config serves millisecond CPU steps and
    multi-minute fused spans; ``min_stall_s`` floors it against noise on
    short steps, ``max_stall_s`` caps it so a run whose p95 one outlier
    poisoned is still flagged."""

    poll_interval_s: float = 1.0
    stall_factor: float = 10.0
    min_stall_s: float = 5.0
    max_stall_s: float = 600.0
    # beats observed before the stall detector arms (the first steps'
    # intervals hold the kernels' build and the captures)
    warmup_beats: int = 3
    # recompile storm: more than this many recompiles inside the window
    recompile_storm: int = 3
    recompile_window_s: float = 60.0
    # a checkpoint is stale after this many seconds without a save (0: off)
    checkpoint_stale_s: float = 0.0
    # escalate a stall that persists this many polls after its flag into
    # PreemptionGuard.request(); 0: off
    escalate_after_polls: int = 0

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError(f"poll_interval_s must be > 0, got {self.poll_interval_s}")
        if self.stall_factor <= 1.0:
            raise ValueError(f"stall_factor must be > 1, got {self.stall_factor}")
        if self.min_stall_s < 0 or self.max_stall_s < self.min_stall_s:
            raise ValueError(
                f"need 0 <= min_stall_s <= max_stall_s, got "
                f"{self.min_stall_s}/{self.max_stall_s}"
            )


class RecompileDetector:
    """Counts the step's programs built after its first.

    ``observe()`` after each call reads ``fn._cache_size()`` (the step
    objects' count of built programs; a function without it makes detection
    a no-op) and counts growth beyond the first build into
    ``recompiles_total``, a ``watchdog/recompile`` trace instant and a
    ``recompile`` flight event. The watchdog turns a burst of them into the
    storm flag. ``swap(fn)`` rebinds after a deliberate rebuild (the CNN
    rollback's programs, built again at the backed-off lr), which must not
    count.
    """

    def __init__(self, fn=None, *, registry=O.NULL_REGISTRY, tracer=TR.NULL_TRACER):
        self.registry = registry
        self.tracer = tracer
        self.counter = registry.counter(
            "recompiles_total",
            "Compile-cache misses of the jitted train step after the first compile",
        )
        self.events: list[float] = []  # unix times, read by the watchdog
        self._lock = threading.Lock()
        self._fn = None
        self._baseline = None
        if fn is not None:
            self.swap(fn)

    @staticmethod
    def cache_size(fn) -> int | None:
        get = getattr(fn, "_cache_size", None)
        if get is None:
            return None
        try:
            return int(get())
        except Exception:
            return None

    def swap(self, fn) -> None:
        """Track a (new) step; its current count becomes the baseline, so
        deliberate rebuilds do not count as misses."""
        self._fn = fn
        self._baseline = self.cache_size(fn)

    def observe(self, step: int | None = None) -> int:
        """Call after a step completes; returns the recompiles counted so
        far. The first growth from 0 is the compile, not a miss."""
        size = self.cache_size(self._fn)
        if size is None:
            return len(self.events)
        if self._baseline is None or size <= self._baseline:
            self._baseline = size if self._baseline is None else self._baseline
            return len(self.events)
        grew = size - self._baseline
        if self._baseline == 0:
            grew -= 1  # the first compile is expected
        self._baseline = size
        if grew <= 0:
            return len(self.events)
        now = time.time()
        with self._lock:
            self.events.extend([now] * grew)
        self.counter.inc(grew)
        self.tracer.instant("watchdog/recompile", track="watchdog", step=step,
                            new_entries=grew, cache_size=size)
        flight_event("recompile", step=step, new_entries=grew, cache_size=size)
        return len(self.events)

    def recent(self, window_s: float) -> int:
        cut = time.time() - window_s
        with self._lock:
            return sum(1 for t in self.events if t >= cut)


class Watchdog:
    """The polling thread. start()/stop(), or use as a context manager."""

    def __init__(self, registry, *, config: WatchdogConfig | None = None,
                 tracer=TR.NULL_TRACER, recompiles: RecompileDetector | None = None,
                 preemption=None, log=print):
        self.registry = registry
        self.cfg = config if config is not None else WatchdogConfig()
        self.tracer = tracer
        self.recompiles = recompiles
        self.preemption = preemption
        self.log = log
        self.stall_counter = registry.counter(
            "watchdog_stall_total", "Stalled-step episodes flagged by the watchdog")
        self.storm_counter = registry.counter(
            "watchdog_recompile_storm_total", "Recompile-storm episodes flagged by the watchdog")
        self.ckpt_stale_counter = registry.counter(
            "watchdog_checkpoint_stale_total",
            "Checkpoint-staleness episodes flagged by the watchdog")
        self.threshold_gauge = registry.gauge(
            "watchdog_stall_threshold_seconds",
            "Current adaptive stall threshold (stall_factor x steady p95)")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # episode latches
        self._stall_flagged_at_step: int | None = None
        self._stall_polls = 0
        self._escalated = False
        self._storm_flagged = False
        self._ckpt_flagged_for: float | None = None

    # ------------------------------------------------------------ control

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- detect

    def stall_threshold_s(self) -> float | None:
        """stall_factor x p95 of the recent beat intervals, clamped to
        [min_stall_s, max_stall_s]; None while under warmup_beats."""
        intervals = self.registry.beat_intervals()
        if len(intervals) < self.cfg.warmup_beats:
            return None
        p95 = TR.percentile(intervals, 95)
        return min(max(self.cfg.stall_factor * p95, self.cfg.min_stall_s),
                   self.cfg.max_stall_s)

    def _model_health(self) -> dict:
        """The last model-health gauges, for the stall's flight event (was
        the model already sick when the heartbeat stopped?); empty when no
        one publishes them."""
        out = {}
        for key, name in (("last_grad_norm", "dynamics_grad_norm"),
                          ("last_upd_ratio_max", "dynamics_upd_ratio_max"),
                          ("last_loss_zscore", "guard_spike_zscore")):
            g = self.registry.get(name)
            if g is not None:
                out[key] = round(g.value, 6)
        return out

    def check_once(self) -> dict:
        """One poll of the three detectors (the thread's body; callable
        from tests). Returns {stall, storm, ckpt_stale}: the new flags this
        poll raised."""
        raised = {"stall": False, "storm": False, "ckpt_stale": False}
        # ---- stall
        thr = self.stall_threshold_s()
        if thr is not None:
            self.threshold_gauge.set(thr)
            age = self.registry.heartbeat_age()
            step = self.registry.last_step()
            if age is not None and age > thr:
                # the no-beat window is stall badput, reported again each
                # poll as [now - age, now]; the ledger's sweep merges the
                # growing episode, and the step that ends it outranks it
                from ..utils.goodput import LEDGER

                LEDGER.add_ending_now("stall", age)
                if self._stall_flagged_at_step != step:
                    self._stall_flagged_at_step = step
                    self._stall_polls = 0
                    self._escalated = False
                    self.stall_counter.inc()
                    self.tracer.instant(WATCHDOG_STALL, track="watchdog", step=step,
                                        heartbeat_age_s=round(age, 3),
                                        threshold_s=round(thr, 3))
                    flight_event("watchdog_stall", step=step, heartbeat_age_s=round(age, 3),
                                 threshold_s=round(thr, 3), **self._model_health())
                    self.log(
                        f"(watchdog: STALL - no step heartbeat for {age:.1f}s, threshold "
                        f"{thr:.1f}s [{self.cfg.stall_factor}x steady p95], last step {step})"
                    )
                    raised["stall"] = True
                else:
                    self._stall_polls += 1
                    if (self.cfg.escalate_after_polls > 0 and self.preemption is not None
                            and not self._escalated
                            and self._stall_polls >= self.cfg.escalate_after_polls):
                        self._escalated = True
                        self.tracer.instant(WATCHDOG_STALL, track="watchdog", step=step,
                                            action="escalate")
                        flight_event("watchdog_escalate", step=step, action="preempt")
                        self.log(
                            "(watchdog: stall persists - requesting cooperative preemption "
                            "[emergency checkpoint at the next step boundary])"
                        )
                        self.preemption.request("WATCHDOG")
            elif self._stall_flagged_at_step is not None and (age is None or age <= thr):
                # the heartbeat came back: the episode is over
                self._stall_flagged_at_step = None
                self._stall_polls = 0
                self._escalated = False
        # ---- recompile storm
        if self.recompiles is not None:
            n = self.recompiles.recent(self.cfg.recompile_window_s)
            if n > self.cfg.recompile_storm and not self._storm_flagged:
                self._storm_flagged = True
                self.storm_counter.inc()
                self.tracer.instant(WATCHDOG_RECOMPILE, track="watchdog",
                                    recompiles_in_window=n,
                                    window_s=self.cfg.recompile_window_s)
                flight_event("watchdog_recompile_storm", recompiles_in_window=n,
                             window_s=self.cfg.recompile_window_s)
                self.log(
                    f"(watchdog: RECOMPILE STORM - {n} recompiles within "
                    f"{self.cfg.recompile_window_s:.0f}s; a step input's "
                    "shape/dtype/static arg is changing per call)"
                )
                raised["storm"] = True
            elif n <= self.cfg.recompile_storm:
                self._storm_flagged = False
        # ---- checkpoint staleness
        if self.cfg.checkpoint_stale_s > 0:
            g = self.registry.get("checkpoint_last_save_timestamp_seconds")
            last = g.value if g is not None else 0.0
            if last > 0:
                age = time.time() - last
                if age > self.cfg.checkpoint_stale_s and self._ckpt_flagged_for != last:
                    self._ckpt_flagged_for = last
                    self.ckpt_stale_counter.inc()
                    self.tracer.instant(WATCHDOG_CKPT_STALE, track="watchdog",
                                        checkpoint_age_s=round(age, 1),
                                        threshold_s=self.cfg.checkpoint_stale_s)
                    flight_event("watchdog_checkpoint_stale", checkpoint_age_s=round(age, 1),
                                 threshold_s=self.cfg.checkpoint_stale_s)
                    self.log(
                        f"(watchdog: checkpoint is {age:.0f}s old "
                        f"[threshold {self.cfg.checkpoint_stale_s:.0f}s] "
                        "- the checkpointer may have stopped writing)"
                    )
                    raised["ckpt_stale"] = True
        return raised

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.poll_interval_s):
            try:
                self.check_once()
            except Exception as e:  # a detector's fault must never kill a run
                self.log(f"(watchdog: internal error {type(e).__name__}: {e}; continuing)")


# ------------------------------------------------- on-demand profiling


class ProfileController:
    """An on-demand `torch.profiler` capture, armed from the live HTTP layer.

    ``GET /profile?steps=N`` (`utils/obs.py` `ObsServer`) calls
    ``request(N)``; the capture starts at the next step boundary and stops
    N steps later. Step boundaries come from the registry's beat hook
    (`MetricsRegistry.beat_hook`), which both training loops drive, so no
    step loop changes. The activities are the CPU's, and the card's when
    ``device`` is a GPU. Each capture writes a Chrome trace,
    ``profile_step{S}_x{N}/trace.json`` under ``out_dir`` (next to the run's
    Chrome trace when it has one), and a ``profile_capture`` flight event.

    The idle path is two attribute reads a step. Profiler errors (another
    profiler already active, an unwritable directory, a capture of a CUDA
    graph under way) are caught, kept in ``error`` and reported by the next
    ``/profile`` answer, never raised into the step loop.
    """

    def __init__(self, out_dir: str, *, device=None, log=print):
        self.out_dir = os.path.abspath(out_dir)
        self.device = device
        self.log = log
        self._lock = threading.Lock()
        self._pending = 0
        self._stop_at: int | None = None
        self._active_dir: str | None = None
        self._prof = None
        self.captures = 0
        self.last_dir: str | None = None
        self.error: str | None = None

    def _on_card(self) -> bool:
        import torch

        return self.device is not None and torch.device(self.device).type == "cuda"

    def request(self, steps: int) -> dict:
        """Arm a capture of the next ``steps`` steps (the /profile body)."""
        with self._lock:
            if self._pending or self._stop_at is not None:
                return {"ok": False, "error": "a profile capture is already pending/active",
                        "dir": self._active_dir}
            self._pending = int(steps)
        doc = {"ok": True, "steps": int(steps), "out_dir": self.out_dir,
               "note": "capture starts at the next step boundary",
               "captures_completed": self.captures}
        if self.error:
            doc["last_error"] = self.error
        return doc

    def on_step(self, step) -> None:
        """The step-boundary hook (the registry's beat): starts and stops
        captures."""
        if not self._pending and self._stop_at is None:
            return
        with self._lock:
            pending, stop_at = self._pending, self._stop_at
            if pending and stop_at is None:
                self._pending = 0
                i = int(step) if step is not None else 0
                d = os.path.join(self.out_dir, f"profile_step{i}_x{pending}")
                try:
                    import torch
                    from torch.profiler import ProfilerActivity, profile

                    card = self._on_card()
                    if card and torch.cuda.is_current_stream_capturing():
                        raise RuntimeError("a CUDA graph capture is under way")
                    os.makedirs(d, exist_ok=True)
                    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
                    prof = profile(activities=acts)
                    prof.start()
                except Exception as e:
                    self.error = f"{type(e).__name__}: {e}"
                    self.log(f"(profile: start failed - {self.error})")
                    return
                self._prof = prof
                self._stop_at = i + pending
                self._active_dir = d
                self.log(f"(profile: capturing {pending} step(s) -> {d})")
                return
            if stop_at is not None and step is not None and int(step) >= stop_at:
                self._finish_locked()

    def _finish_locked(self) -> None:
        d, prof = self._active_dir, self._prof
        self._stop_at = self._active_dir = self._prof = None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
            self.log(f"(profile: stop failed - {self.error})")
            return
        self.captures += 1
        self.last_dir = d
        flight_event("profile_capture", dir=d)
        self.log(f"(profile: capture complete - {d})")

    def close(self) -> None:
        """Stop a capture left active at the run's end (its trace is still
        written)."""
        with self._lock:
            if self._stop_at is not None:
                self._finish_locked()
            self._pending = 0


# ----------------------------------------------------------- CLI wiring


class Monitor:
    """registry + server + watchdog + heartbeat + flight + profiler, one
    close()."""

    def __init__(self, registry, server=None, watchdog=None,
                 recompiles: RecompileDetector | None = None, heartbeat=None, flight=None,
                 profiler=None):
        self.registry = registry
        self.server = server
        self.watchdog = watchdog
        self.recompiles = recompiles
        self.heartbeat = heartbeat
        self.flight = flight
        self.profiler = profiler
        self._closed = False

    @property
    def url(self) -> str | None:
        return self.server.url if self.server is not None else None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.profiler is not None:
            self.profiler.close()
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.server is not None:
            self.server.close()
        if self.heartbeat is not None:
            self.heartbeat.close()
        if self.flight is not None:
            # the ring's last state with a clean cause (a crash never gets
            # here: each event already wrote the file through)
            self.flight.dump(cause="close")


def attach_monitor(*, metrics_port: int | None, tracer=TR.NULL_TRACER, preemption=None,
                   watchdog: bool = True, config: WatchdogConfig | None = None,
                   profile_dir: str | None = None, rank: int | None = None, device=None,
                   log=print) -> Monitor:
    """The shared ``--metrics-port`` wiring of both CLIs.

    ``metrics_port=None`` returns an inert monitor over ``NULL_REGISTRY``
    (every publish site a no-op), unless ``DNN_TPU_HEARTBEAT_FILE`` is set
    (a supervisor's per-worker file): then a real registry is built anyway,
    with a `utils/obs.py` `HeartbeatFileWriter` mirroring its heartbeat into
    that file. A port (0: an ephemeral one) also starts the HTTP server, the
    recompile detector and (unless ``watchdog=False``) the watchdog thread.
    The caller logs ``monitor.url`` and closes the monitor at the end.

    ``DNN_TPU_RUN_RECORD`` (`utils/goodput.py` `RUN_RECORD_ENV`) arms the
    process goodput ledger's run record, and a real registry gets the
    ledger's ``goodput_ratio`` / ``badput_seconds_total{cause}`` export.
    ``DNN_TPU_FLIGHT_FILE`` (`utils/obs.py` `FLIGHT_ENV`) arms the flight
    recorder's write-through dump and records ``run_start``. ``rank``
    stamps the heartbeat file and the flight dump; the heartbeat advertises
    ``metrics_url`` when a server is up. ``profile_dir`` (with a server)
    wires ``/profile?steps=N`` (`ProfileController`, on ``device``), driven
    from the registry's beat hook.
    """
    flight = None
    fl_path = os.environ.get(O.FLIGHT_ENV)
    if fl_path:
        O.FLIGHT.configure(fl_path, rank=rank)
        flight = O.FLIGHT
        flight_event("run_start", pid=os.getpid())
        log(f"(flight recorder: {fl_path})")
    from ..utils import goodput as GP

    rec_path = os.environ.get(GP.RUN_RECORD_ENV)
    if rec_path:
        GP.LEDGER.arm(rec_path)
        log(f"(goodput run record: {rec_path})")
    hb_path = os.environ.get("DNN_TPU_HEARTBEAT_FILE")
    if metrics_port is None and not hb_path:
        return Monitor(O.NULL_REGISTRY, flight=flight)
    registry = O.MetricsRegistry()
    GP.LEDGER.publish(registry)
    server = prof = None
    if metrics_port is not None:
        if profile_dir:
            prof = ProfileController(profile_dir, device=device, log=log)
            registry.beat_hook = prof.on_step
        server = O.ObsServer(registry, port=metrics_port, profiler=prof)
    hb = None
    if hb_path:
        hb = O.HeartbeatFileWriter(registry, hb_path, rank=rank,
                                   metrics_url=server.url if server is not None else None)
        log(f"(supervisor heartbeat file: {hb_path})")
    if server is None:
        return Monitor(registry, heartbeat=hb, flight=flight)
    rec = RecompileDetector(registry=registry, tracer=tracer)
    dog = None
    if watchdog:
        dog = Watchdog(registry, config=config, tracer=tracer, recompiles=rec,
                       preemption=preemption, log=log).start()
    log(
        f"(metrics server: {server.url}/metrics , {server.url}/healthz"
        + (f" , {server.url}/profile" if prof is not None else "")
        + (" ; watchdog on)" if dog is not None else " ; watchdog off)")
    )
    return Monitor(registry, server, dog, rec, heartbeat=hb, flight=flight, profiler=prof)
