"""Step-level telemetry: span tracing and StepStats (the port of the JAX
package's `utils/tracing.py`, with the same Chrome trace-event schema, so
its `tools/trace_summary.py` and `tools/trace_merge.py` read the port's
traces unchanged).

- ``Tracer``: ``with tracer.span("x", step=i): ...`` records one Chrome
  "complete" event; spans nest (a per-thread stack gives each its
  parent), the event list is locked, and a disabled tracer returns one
  shared no-op span. ``export()`` writes strict JSON (``allow_nan=False``,
  non-finite args as null) to ``<path>.tmp`` and renames it into place.
- ``StepStats``: compile step against steady state, throughput, the
  ``step/*`` series into a MetricsRun sink, device memory
  (``device_memory_snapshot``: `torch.cuda.memory_stats` per card, read
  as it stands, never as a difference around a graph capture, which
  empties the allocator's cache), collective bytes and MFU. PyTorch has no
  compiled cost analysis, so the FLOPs are the analytic count
  (`models/cnn.py` `flops_per_image`, `train/measure.py`
  `model_flops_per_token`) and ``flops_source`` says ``"analytic"``; the
  peak is `train/measure.py`'s H100 table.

Timing: a span measures host wall time between enter and exit. The
callers close each span after the `PhaseTimers` fence
(`torch.cuda.synchronize`, `utils/timers.py`), so device time lands in the
span that queued it; a span around a graph replay is one span per replay.
Unfenced spans carry ``fenced: false``. torch is imported only by the
memory snapshot.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass, field

# span names the engine/CLI emit; tools/trace_summary.py groups by these
TRAIN_STEP = "train_step"
TRAIN_SPAN = "train_span"
SYNC = "sync"
EVAL = "eval"
DATA_LOADING = "data_loading"
# instant events from the guard layer (train/guard.py: one per anomaly /
# restore) and the fault simulator's straggler stall span (parallel/fault.py)
GUARD = "guard"
STRAGGLER = "straggler"
# elastic resume/shrink events (train/elastic.py): the reshard span wraps
# one whole checkpoint->new-mesh redistribution on the "elastic" track
RESHARD = "reshard"
# model-health counter tracks (train/dynamics.py DynamicsSink: per-layer
# grad norms, update-to-weight ratios, gradient-noise scale) and the
# engine's replica-divergence samples before each averaging sync
DYNAMICS = "dynamics"


class _NullSpan:
    """Shared no-op span: the disabled tracer's entire overhead is one
    attribute check and returning this singleton."""

    __slots__ = ()
    dur_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "track", "args", "_t0", "dur_s")

    def __init__(self, tracer, name, track, args):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.dur_s = 0.0

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        if stack:
            self.args.setdefault("parent", stack[-1])
        stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self.dur_s = (t1 - self._t0) / 1e9
        tr._record(
            self.name,
            "X",
            (self._t0 - tr._epoch_ns) / 1e3,
            track=self.track,
            dur_us=(t1 - self._t0) / 1e3,
            args=self.args,
        )
        return False


@dataclass
class TraceEvent:
    """One recorded event, Chrome trace-event-shaped (ts/dur in µs)."""

    name: str
    ph: str
    ts: float
    tid: int
    dur: float | None = None
    args: dict = field(default_factory=dict)


class Tracer:
    """Span-based structured tracer with Chrome trace-event JSON export.

    ``enabled=False`` (the default for the module-level ``NULL_TRACER``)
    makes every recording call a near-zero no-op, so instrumented hot
    paths cost nothing when tracing is off.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: list[TraceEvent] = []
        self._tracks: dict[str, int] = {}
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self.epoch_unix = time.time()
        # fleet identity (set_process): rank-stamped process metadata so
        # per-rank trace shards merge into one readable timeline
        # (tools/trace_merge.py) that stays stable across supervisor
        # relaunches - pids change per (re)launch, ranks do not
        self.rank: int | None = None
        self.hostname: str | None = None
        self.label: str | None = None

    def set_process(
        self, *, rank: int | None = None, hostname: str | None = None,
        label: str | None = None,
    ) -> "Tracer":
        """Stamp this tracer's process identity. With a rank set, the
        exported Chrome document's ``process_name`` metadata becomes
        ``rank{N}`` (not the pid-keyed default) and ``otherData`` carries
        ``rank``/``hostname`` - the keys `tools/trace_merge.py` aligns
        and labels shards by. ``label`` overrides the process name for
        non-rank processes (the serve stack exports ``serve:{port}``
        lanes this way; the merge preserves such labels verbatim)."""
        self.rank = int(rank) if rank is not None else None
        self.hostname = hostname
        if label is not None:
            self.label = str(label)
        return self

    # ------------------------------------------------------------ recording

    def span(self, name: str, *, track: str | None = None, **args):
        """Context manager timing a block as one complete ("X") event.

        ``track`` names the trace track (tid) the span lands on; default is
        the recording thread's name. Extra kwargs become the event's
        ``args`` (step index, epoch, fenced flag, ...). The yielded handle
        exposes ``dur_s`` after exit.
        """
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, track, args)

    def instant(self, name: str, *, track: str | None = None, **args) -> None:
        """A zero-duration marker event (ph "i")."""
        if not self.enabled:
            return
        self._record(
            name, "i", (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            track=track, args=args,
        )

    def counter(self, name: str, values: dict, *, track: str | None = None) -> None:
        """A counter sample (ph "C") - e.g. per-device memory bytes."""
        if not self.enabled:
            return
        self._record(
            name, "C", (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            track=track, args=dict(values),
        )

    # Explicit-timestamp recording: callers that already measured an
    # interval on this tracer's clock (``now_s()``) can land it after
    # the fact - serve/reqtrace.py emits whole request lifecycles this
    # way when a record finalizes.

    def now_s(self) -> float:
        """Seconds on this tracer's span clock (the ``ts`` basis)."""
        return (time.perf_counter_ns() - self._epoch_ns) / 1e9

    def complete(self, name: str, t0_s: float, t1_s: float, *,
                 track: str | None = None, **args) -> None:
        """Record an already-measured complete ("X") event with explicit
        endpoints in ``now_s()`` seconds."""
        if not self.enabled:
            return
        self._record(
            name, "X", t0_s * 1e6, track=track,
            dur_us=max(t1_s - t0_s, 0.0) * 1e6, args=args,
        )

    def instant_at(self, name: str, t_s: float, *,
                   track: str | None = None, **args) -> None:
        """A marker event (ph "i") at an explicit ``now_s()`` time."""
        if not self.enabled:
            return
        self._record(name, "i", t_s * 1e6, track=track, args=args)

    # ------------------------------------------------------------ internals

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _tid(self, track: str | None) -> int:
        label = track if track is not None else (
            threading.current_thread().name
        )
        tid = self._tracks.get(label)
        if tid is None:
            tid = self._tracks[label] = len(self._tracks)
        return tid

    def _record(self, name, ph, ts_us, *, track, dur_us=None, args=None):
        with self._lock:
            self._events.append(
                TraceEvent(
                    name=name, ph=ph, ts=ts_us, tid=self._tid(track),
                    dur=dur_us, args=dict(args or {}),
                )
            )

    # -------------------------------------------------------------- export

    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    def to_chrome(self, *, step_stats: "StepStats | None" = None,
                  goodput: dict | None = None) -> dict:
        """The Chrome trace-event document as a dict (sorted by ts).

        Perfetto/chrome://tracing load the ``traceEvents`` list; the
        ``stepStats`` key (ignored by viewers) embeds the StepStats summary
        so tools/trace_summary.py can report throughput/MFU from the trace
        file alone. ``goodput`` embeds the run's goodput record
        (utils/goodput.py) the same way - `tools/trace_summary.py
        --goodput` cross-checks its span-derived breakdown against it.
        """
        pid = os.getpid()
        if self.label is not None:
            pname = self.label
        elif self.rank is not None:
            pname = f"rank{self.rank}"
        else:
            pname = "dnn-tpu-train"
        events = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "ts": 0, "args": {"name": pname}},
        ]
        with self._lock:
            tracks = dict(self._tracks)
            recorded = list(self._events)
        for label, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "ts": 0, "args": {"name": label}}
            )
        for ev in sorted(recorded, key=lambda e: e.ts):
            out = {
                "name": ev.name, "ph": ev.ph, "ts": ev.ts,
                "pid": pid, "tid": ev.tid, "cat": "phase",
                "args": _finite_tree(ev.args),
            }
            if ev.ph == "X":
                out["dur"] = ev.dur if ev.dur is not None else 0.0
            events.append(out)
        other = {"epoch_unix": self.epoch_unix, "pid": pid}
        if self.rank is not None:
            other["rank"] = self.rank
        if self.hostname is not None:
            other["hostname"] = self.hostname
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }
        if step_stats is not None:
            doc["stepStats"] = _finite_tree(step_stats.summary())
        if goodput is not None:
            doc["goodput"] = _finite_tree(goodput)
        return doc

    def export(self, path: str, *, step_stats: "StepStats | None" = None,
               goodput: dict | None = None) -> str:
        """Write strict Chrome trace-event JSON (never a bare NaN/Inf
        token - `allow_nan=False` with non-finite floats nulled first).

        Crash-safe: the document is written to ``<path>.tmp`` and
        atomically renamed over ``path``, so a SIGTERM (reachable
        mid-export via the watchdog's preemption escalation,
        train/monitor.py) or a serializer error can never leave a
        truncated half-JSON trace where a previous good one stood - the
        reader sees the old complete file or the new complete file,
        never a partial write."""
        doc = self.to_chrome(step_stats=step_stats, goodput=goodput)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, allow_nan=False)
                f.write("\n")
            os.replace(tmp, path)  # atomic publish
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return path


NULL_TRACER = Tracer(enabled=False)


def _finite_tree(x):
    """Replace non-finite floats with None so strict JSON never breaks."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _finite_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite_tree(v) for v in x]
    return x


# ---------------------------------------------------------------- StepStats


@dataclass
class StepRecord:
    step: int
    wall_s: float
    items: float = 0.0
    is_compile: bool = False


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile of a non-empty sequence (p in [0, 100])."""
    ys = sorted(xs)
    if not ys:
        raise ValueError("percentile of empty sequence")
    k = max(0, min(len(ys) - 1, int(math.ceil(p / 100.0 * len(ys))) - 1))
    return ys[k]


class StepStats:
    """Per-step aggregator: compile vs steady-state wall time, throughput,
    device memory, collective bytes, and MFU.

    ``record()`` both accumulates and (when a MetricsRun-like ``sink`` is
    given) streams the per-step record under ``step/*`` series, so a run
    killed mid-training still has its step telemetry on disk.

    The first record is the compile step unless flagged otherwise: the
    port's first call builds the kernels and captures the CUDA graphs, so
    folding it into a mean would dominate every short run's throughput
    number.
    """

    def __init__(
        self,
        *,
        item_label: str = "items",
        sink=None,
        series_prefix: str = "step",
        n_devices: int = 1,
        comm_bytes_per_step: int | None = None,
        static_comm_bytes_per_step: int | None = None,
        flops_per_step: float | None = None,
        flops_source: str | None = None,
        peak_flops_per_device: float | None = None,
        grad_sync: str | None = None,
        comm_bucket_bytes: list | tuple | None = None,
        compilation_cache_dir: str | None = None,
        registry=None,
    ):
        self.item_label = item_label
        self.sink = sink
        # live-metrics registry (utils/obs.py; None = off): anomaly
        # counters and device-memory gauges surface on /metrics as they
        # are recorded. Step counting/heartbeat stays with the training
        # loops (engine / make_traced_step) - StepStats is opt-in, the
        # liveness signal is not.
        if registry is None:
            from .obs import NULL_REGISTRY

            registry = NULL_REGISTRY
        self._reg_mem = registry.gauge(
            "device_memory_bytes_in_use",
            "Peak bytes_in_use per device (device.memory_stats)",
        )
        if comm_bytes_per_step is not None:
            registry.gauge(
                "collective_bytes_per_step",
                "Estimated per-device collective payload bytes per step",
            ).set(comm_bytes_per_step)
        self.series_prefix = series_prefix
        self.n_devices = int(n_devices)
        self.comm_bytes_per_step = comm_bytes_per_step
        # the shardlint static trace's logical payload bytes per step
        # (analysis/trace.py), when the caller ran the analyzer - the
        # cross-check against the runtime ring estimate above
        self.static_comm_bytes_per_step = static_comm_bytes_per_step
        self.flops_per_step = flops_per_step
        self.flops_source = flops_source
        self.peak_flops_per_device = peak_flops_per_device
        # gradient-sync schedule attribution: which schedule produced
        # comm_bytes_per_step, and (overlap) the per-bucket payloads so a
        # trace reader can match collective cost to the bucket plan
        self.grad_sync = grad_sync
        self.comm_bucket_bytes = (
            [int(b) for b in comm_bucket_bytes]
            if comm_bucket_bytes is not None else None
        )
        # persistent-compilation-cache provenance: compile_s with a warm
        # cache is the cache-hit (deserialize) time, not a fresh compile
        self.compilation_cache_dir = compilation_cache_dir
        self.records: list[StepRecord] = []
        self.memory_peak: dict[str, int] = {}
        # guard-layer anomaly counters (train/guard.py observe/rollback):
        # kind -> count; lands in summary()/report() and the trace embed
        self.anomalies: dict[str, int] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- recording

    def record(
        self,
        step: int,
        wall_s: float,
        *,
        items: float = 0.0,
        is_compile: bool | None = None,
    ) -> StepRecord:
        with self._lock:
            if is_compile is None:
                is_compile = not self.records
            rec = StepRecord(
                step=int(step), wall_s=float(wall_s), items=float(items),
                is_compile=bool(is_compile),
            )
            self.records.append(rec)
        if self.sink is not None:
            p = self.series_prefix
            self.sink.append(f"{p}/wall_s", rec.wall_s)
            if rec.items and rec.wall_s > 0 and not rec.is_compile:
                self.sink.append(
                    f"{p}/{self.item_label}_per_s", rec.items / rec.wall_s
                )
        return rec

    def count_anomaly(self, kind: str, n: int = 1) -> None:
        """Bump a guard anomaly counter (and stream it when sinking).
        The /metrics counterpart (guard_anomalies_total) is published by
        the guard itself (train/guard.py) - the sole anomaly producer -
        so counts never double when both are wired to one registry."""
        with self._lock:
            self.anomalies[kind] = self.anomalies.get(kind, 0) + int(n)
        if self.sink is not None:
            self.sink.append(
                f"{self.series_prefix}/anomaly_{kind}", self.anomalies[kind]
            )

    def set_flops(self, flops_per_step: float | None, source: str | None) -> None:
        self.flops_per_step = flops_per_step
        self.flops_source = source

    def capture_memory(self, tracer: Tracer | None = None) -> dict | None:
        """Sample ``device.memory_stats()`` on every device, keep the peak
        ``bytes_in_use`` per device, and (optionally) emit a counter event.
        Backends without memory stats (CPU) return None - no crash."""
        snap = device_memory_snapshot()
        if not snap:
            return None
        for label, stats in snap.items():
            b = stats.get("bytes_in_use")
            if b is None:
                continue
            self.memory_peak[label] = max(self.memory_peak.get(label, 0), int(b))
            self._reg_mem.labels(device=label).set_max(int(b))
        if tracer is not None and self.memory_peak:
            tracer.counter(
                "device_memory_bytes_in_use",
                {k: v for k, v in self.memory_peak.items()}, track="memory",
            )
        if self.sink is not None and self.memory_peak:
            self.sink.append(
                f"{self.series_prefix}/mem_bytes_in_use_max",
                max(self.memory_peak.values()),
            )
        return snap

    # ------------------------------------------------------------- summary

    def summary(self) -> dict:
        """Aggregate dict; ``steady_includes_compile`` flags the 1-step
        fallback (a single compiled dispatch has no steady state - its one
        sample is reported rather than nothing)."""
        with self._lock:
            records = list(self.records)
        compile_recs = [r for r in records if r.is_compile]
        steady = [r for r in records if not r.is_compile]
        steady_includes_compile = False
        if not steady and records:
            steady = records
            steady_includes_compile = True
        out = {
            "steps": len(records),
            "item_label": self.item_label,
            "n_devices": self.n_devices,
            "compile_steps": len(compile_recs),
            "compile_s": round(sum(r.wall_s for r in compile_recs), 6)
            if compile_recs else None,
            "steady_steps": len(steady),
            "steady_includes_compile": steady_includes_compile,
            "comm_bytes_per_step": self.comm_bytes_per_step,
            "static_comm_bytes_per_step": self.static_comm_bytes_per_step,
            "grad_sync": self.grad_sync,
            "comm_buckets": (
                {
                    "count": len(self.comm_bucket_bytes),
                    "bytes_per_bucket": list(self.comm_bucket_bytes),
                }
                if self.comm_bucket_bytes is not None else None
            ),
            "compilation_cache_dir": self.compilation_cache_dir,
            "anomalies": dict(self.anomalies) or None,
            "flops_per_step": self.flops_per_step,
            "flops_source": self.flops_source,
            "peak_flops_per_device": self.peak_flops_per_device,
            "device_memory_peak_bytes": dict(self.memory_peak) or None,
        }
        if steady:
            walls = [r.wall_s for r in steady]
            total = sum(walls)
            items = sum(r.items for r in steady)
            out.update(
                steady_total_s=round(total, 6),
                steady_mean_s=round(total / len(walls), 6),
                steady_p50_s=round(percentile(walls, 50), 6),
                steady_p95_s=round(percentile(walls, 95), 6),
                steady_min_s=round(min(walls), 6),
                steady_max_s=round(max(walls), 6),
            )
            thr = items / total if total > 0 and items else None
            out["throughput_items_per_s"] = round(thr, 3) if thr else None
        else:
            out.update(
                steady_total_s=None, steady_mean_s=None, steady_p50_s=None,
                steady_p95_s=None, steady_min_s=None, steady_max_s=None,
                throughput_items_per_s=None,
            )
        out["mfu_pct"], out["mfu_note"] = self._mfu(out["steady_mean_s"])
        return out

    def _mfu(self, steady_mean_s) -> tuple[float | None, str | None]:
        if self.flops_per_step is None:
            return None, "unavailable: no FLOPs estimate (cost_analysis and analytic both absent)"
        if self.peak_flops_per_device is None:
            return None, "unavailable: no peak FLOP/s table entry for this device kind"
        if not steady_mean_s or steady_mean_s <= 0:
            return None, "unavailable: no timed steps"
        mfu = (
            self.flops_per_step
            / steady_mean_s
            / (self.peak_flops_per_device * max(self.n_devices, 1))
            * 100.0
        )
        return round(mfu, 3), None

    def report(self) -> str:
        """Human-readable multi-line summary (the --step-stats printout)."""
        s = self.summary()
        lines = [
            f"Step stats ({s['steps']} steps, {s['n_devices']} device(s)):",
            f"  compile: {s['compile_steps']} step(s), "
            + (f"{s['compile_s']:.4f} s" if s["compile_s"] is not None else "n/a"),
        ]
        if s["steady_mean_s"] is not None:
            extra = (
                " [single-dispatch run: includes compile]"
                if s["steady_includes_compile"] else ""
            )
            lines.append(
                f"  steady-state: {s['steady_steps']} step(s), mean "
                f"{s['steady_mean_s']:.4f} s, p50 {s['steady_p50_s']:.4f} s, "
                f"p95 {s['steady_p95_s']:.4f} s{extra}"
            )
        else:
            lines.append("  steady-state: n/a (no steps recorded)")
        thr = s["throughput_items_per_s"]
        lines.append(
            f"  throughput: "
            + (f"{thr:,.1f} {s['item_label']}/s" if thr else "n/a")
        )
        if s["comm_bytes_per_step"] is not None:
            sched = f", schedule: {s['grad_sync']}" if s["grad_sync"] else ""
            lines.append(
                f"  collective payload: {s['comm_bytes_per_step']:,} "
                f"bytes/step (ring all-reduce estimate{sched})"
            )
        if s["static_comm_bytes_per_step"] is not None:
            lines.append(
                f"  static analysis payload: "
                f"{s['static_comm_bytes_per_step']:,} bytes/step "
                "(shardlint logical payload; tools/trace_summary.py --lint)"
            )
        if s["comm_buckets"]:
            bb = s["comm_buckets"]["bytes_per_bucket"]
            lines.append(
                f"  gradient buckets: {len(bb)} per microbatch "
                f"({min(bb):,}-{max(bb):,} B each)"
            )
        if s["anomalies"]:
            lines.append(
                "  guard anomalies: "
                + ", ".join(
                    f"{k}={v}" for k, v in sorted(s["anomalies"].items())
                )
            )
        mem = s["device_memory_peak_bytes"]
        lines.append(
            "  device memory peak: "
            + (", ".join(f"{k}={v:,} B" for k, v in sorted(mem.items()))
               if mem else "unavailable (backend reports no memory_stats)")
        )
        if s["mfu_pct"] is not None:
            lines.append(
                f"  MFU: {s['mfu_pct']:.2f}% (FLOPs source: {s['flops_source']})"
            )
        else:
            lines.append(f"  MFU: {s['mfu_note']}")
        return "\n".join(lines)


# ----------------------------------------------------------------- helpers


def detect_rank() -> int | None:
    """This process's rank in a torchrun group (``RANK``), None for a
    plain single-process run. An environment read only."""
    v = os.environ.get("RANK")
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def rank_trace_path(path: str, rank: int | None) -> str:
    """Per-rank trace-shard path: ``trace.json`` -> ``trace_rank{N}.json``
    (every rank runs the same argv; `tools/trace_merge.py` reassembles the
    shards). rank=None (one process) returns the path unchanged."""
    if rank is None:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_rank{int(rank)}{ext or '.json'}"


def _leaves(tree) -> list:
    from .tree import tree_leaves

    return tree_leaves(tree)


def _nbytes(leaf) -> int | None:
    """Bytes of a torch tensor or of anything with size and dtype (numpy)."""
    if hasattr(leaf, "element_size") and hasattr(leaf, "numel"):
        return int(leaf.numel()) * int(leaf.element_size())
    size, dtype = getattr(leaf, "size", None), getattr(leaf, "dtype", None)
    if size is None or dtype is None or callable(size):
        return None
    return int(size) * int(dtype.itemsize)


def param_bytes(tree) -> int:
    """Total bytes of a tree (nested dicts / lists) of tensors or arrays."""
    return sum(b for b in map(_nbytes, _leaves(tree)) if b is not None)


def collective_bytes_per_sync(tree, n_devices: int, algorithm: str = "ring") -> int:
    """Per-device payload bytes of one all-reduce of the tree over
    ``n_devices``: ``ring`` (reduce-scatter + all-gather) sends 2(n-1)/n of
    the tree; ``naive`` (the reference's parent star) twice the tree."""
    if n_devices <= 1:
        return 0
    pb = param_bytes(tree)
    if algorithm == "ring":
        return int(pb * 2 * (n_devices - 1) / n_devices)
    if algorithm == "naive":
        return 2 * pb
    raise ValueError(f"unknown algorithm {algorithm!r} (ring | naive)")


def overlapped_collective_bytes(
    bucket_bytes, n_devices: int, accum_steps: int = 1,
    algorithm: str = "ring",
) -> int:
    """Per-device payload bytes of one step under the overlapped gradient
    sync: one collective per bucket and micro-batch, so accum_steps x the
    bucketed tree's ring cost."""
    if n_devices <= 1:
        return 0
    total = int(sum(bucket_bytes))
    if algorithm == "ring":
        per = int(total * 2 * (n_devices - 1) / n_devices)
    elif algorithm == "naive":
        per = 2 * total
    else:
        raise ValueError(f"unknown algorithm {algorithm!r} (ring | naive)")
    return per * max(int(accum_steps), 1)


GRAD_BUCKET = "grad_bucket"


def record_bucket_plan(
    tracer: Tracer, bucket_bytes, *, schedule: str, op: str,
    axis_size: int, accum_steps: int = 1, track: str = "collective",
) -> None:
    """One `grad_bucket` instant event per bucket of the gradient-sync plan
    (bytes, op, schedule, axis size): the collectives run inside the step's
    graph, where no host span sees them."""
    for i, b in enumerate(bucket_bytes):
        tracer.instant(
            GRAD_BUCKET, track=track, bucket=i, bytes=int(b), op=op,
            schedule=schedule, axis_size=int(axis_size),
            per_microbatch=int(accum_steps),
        )


def device_memory_snapshot() -> dict[str, dict] | None:
    """``{"dev<i>": stats}`` from `torch.cuda.memory_stats` for every card
    this process has touched, or None (the CPU, or no card in use). The
    stats carry the JAX names StepStats reads: ``bytes_in_use`` (allocated
    now), ``peak_bytes_in_use``, ``bytes_reserved`` and ``bytes_limit``
    (the card's memory)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    snap = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        snap[f"dev{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return snap or None
