"""Goodput ledger: wall-clock accounting over a closed badput taxonomy, run
records, and their fleet aggregation (the port's copy of the JAX package's
stdlib-only `utils/goodput.py`: the same taxonomies, priority sweep, record
schema and readers, so its `tools/goodput.py` reads the port's records
unchanged).

**Training taxonomy** (every wall-clock second in exactly one bucket):
``init`` (process start to the first step: group rendezvous, data, model),
``compile`` (the first step: in the port the kernels' build and every CUDA
graph capture), ``steady_step`` (the goodput bucket), ``data_wait``,
``checkpoint_save``, ``reshard``, ``rollback_recompute``, ``stall``,
``restart_gap`` and the residual ``idle_other`` (eval, logging, host work).

**Serving taxonomy** (``GoodputLedger(taxonomy="serve")``): ``queue_wait``,
``prefill``, ``decode`` (goodput), ``batch_formation_idle``,
``kv_alloc_stall``, ``idle_other``.

Overlaps resolve by a priority sweep (instrumented intervals beat the
coarse stall window and the fill intervals), and ``finalize()`` asserts the
buckets sum to the wall clock. A record's ``wall_s`` is the sum of its
rounded buckets, so it conserves at its own precision. While a run is live
the ledger writes its record through at a bounded cadence (atomic tmp +
rename), so a killed worker's accounting is on disk. ``finalize()``
records a ``goodput_final`` event on the flight recorder (`utils/obs.py`).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time

# bump when the run-record schema changes shape; readers accept same-or-
# older versions and refuse newer ones with a clear message.
# v1: training taxonomy only. v2: adds the `taxonomy` field ("train" |
# "serve") and the serving cause set; v1 records (no taxonomy field)
# still parse and render as training records.
RECORD_VERSION = 2

# env var naming the per-worker run-record path; the elastic supervisor
# (train/supervisor.py) exports it next to the heartbeat/flight files
RUN_RECORD_ENV = "DNN_TPU_RUN_RECORD"

# the closed TRAINING taxonomy, in report order. steady_step is goodput;
# idle_other is the computed residual (never recorded directly).
GOODPUT_CAUSE = "steady_step"
IDLE_CAUSE = "idle_other"
CAUSES = (
    "init",
    "compile",
    GOODPUT_CAUSE,
    "data_wait",
    "checkpoint_save",
    "reshard",
    "rollback_recompute",
    "stall",
    "restart_gap",
    IDLE_CAUSE,
)
BADPUT_CAUSES = tuple(c for c in CAUSES if c != GOODPUT_CAUSE)

# the closed SERVING taxonomy (serve/scheduler.py's ledger): decode -
# tokens reaching users - is the goodput bucket; prefill is real work
# but not yet user-visible tokens, queue_wait is time requests sat
# admitted-but-unserved while the engine had no free capacity,
# batch_formation_idle is scheduler overhead between having runnable
# work and dispatching the step, kv_alloc_stall is progress blocked on
# KV-block exhaustion.
SERVE_GOODPUT_CAUSE = "decode"
SERVE_CAUSES = (
    "queue_wait",
    "prefill",
    SERVE_GOODPUT_CAUSE,
    "batch_formation_idle",
    "kv_alloc_stall",
    IDLE_CAUSE,
)
SERVE_BADPUT_CAUSES = tuple(
    c for c in SERVE_CAUSES if c != SERVE_GOODPUT_CAUSE
)

# overlap-resolution priority (lower wins): precisely instrumented
# intervals (step walls, checkpoint saves, reshard spans, data waits)
# always beat the watchdog's coarse stall window, which covers the idle
# gap between heartbeats and may overhang into the next completed step.
# Fill intervals (internal: the untelemetered fast path's whole-window
# coarse attribution, and the synthesized open-init prefix) rank below
# everything, so any precisely recorded interval carves itself out of a
# fill instead of being swallowed by it.
_PRIORITY = {c: 0 for c in CAUSES}
_PRIORITY["stall"] = 1
_PRIORITY["restart_gap"] = 1
_FILL_CAUSES = {"_steady_fill": GOODPUT_CAUSE, "_init_fill": "init"}
_PRIORITY["_steady_fill"] = 2
_PRIORITY["_init_fill"] = 3

# serving overlap resolution: the engine's precisely fenced compute
# spans (prefill/decode/kv_alloc_stall/batch_formation_idle) always win;
# queue_wait is recorded per request over its whole admitted-but-queued
# window and may overlap the engine serving OTHER requests, so it only
# claims otherwise-idle seconds (the capacity-pressure signal).
_SERVE_PRIORITY = {c: 0 for c in SERVE_CAUSES}
_SERVE_PRIORITY["queue_wait"] = 1

# taxonomy registry: name -> (causes, goodput cause, priority map,
# fill-cause map). `GoodputLedger(taxonomy=...)` and every record
# reader resolve through this table.
TAXONOMIES = {
    "train": (CAUSES, GOODPUT_CAUSE, _PRIORITY, _FILL_CAUSES),
    "serve": (SERVE_CAUSES, SERVE_GOODPUT_CAUSE, _SERVE_PRIORITY, {}),
}


def record_taxonomy(rec: dict) -> tuple:
    """``(causes, goodput_cause)`` for a record: v2 records carry a
    ``taxonomy`` field, v1 records are training records. Unknown
    taxonomy names (a future build's record that still validated as
    version <= RECORD_VERSION) fall back to the record's own badput
    keys so rendering never drops a bucket."""
    name = rec.get("taxonomy") or "train"
    if name in TAXONOMIES:
        causes, goodput, _, _ = TAXONOMIES[name]
        return causes, goodput
    bad = tuple((rec.get("badput_s") or {}).keys())
    return ("goodput",) + bad, "goodput"


class _Interval:
    __slots__ = ("t0", "t1", "cause")

    def __init__(self, t0: float, t1: float, cause: str):
        self.t0 = t0
        self.t1 = t1
        self.cause = cause


class _LedgerSpan:
    """Context manager recording one interval on exit (never raises)."""

    __slots__ = ("_ledger", "cause", "_t0", "dur_s")

    def __init__(self, ledger, cause):
        self._ledger = ledger
        self.cause = cause
        self.dur_s = 0.0

    def __enter__(self):
        self._t0 = self._ledger._now()
        return self

    def __exit__(self, *exc):
        t1 = self._ledger._now()
        self.dur_s = t1 - self._t0
        self._ledger.add(self.cause, self._t0, t1)
        return False


class _NullSpan:
    __slots__ = ()
    dur_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def attribute_intervals(
    intervals, start: float, end: float, *, priority=None,
    causes=CAUSES, fills=None,
) -> dict:
    """Sweep-line attribution: partition ``[start, end]`` over the
    recorded intervals so every second is counted exactly once.

    Overlaps are resolved by ``(priority, start-time, sequence)`` - the
    highest-priority (lowest number), earliest interval owns the overlap;
    uncovered time is ``idle_other``. Same-cause overlapping intervals
    (the watchdog re-reporting a growing stall episode every poll)
    therefore coalesce instead of double-counting. Returns a full
    ``{cause: seconds}`` dict over `CAUSES`; the values sum to
    ``end - start`` to float precision BY CONSTRUCTION - the conservation
    rule `GoodputLedger.finalize` asserts.
    """
    import heapq

    prio = priority if priority is not None else _PRIORITY
    fill_map = fills if fills is not None else _FILL_CAUSES
    out = {c: 0.0 for c in causes}
    if end <= start:
        return out
    ivs = sorted(
        (
            (max(iv.t0, start), min(iv.t1, end), iv.cause, seq)
            for seq, iv in enumerate(intervals)
            if iv.t1 > start and iv.t0 < end and iv.t1 > iv.t0
        ),
        key=lambda x: x[0],
    )
    heap: list = []  # (priority, t0, seq, t1, cause)
    t = start
    i = 0
    n = len(ivs)
    while t < end:
        while i < n and ivs[i][0] <= t:
            t0, t1, cause, seq = ivs[i]
            if t1 > t:
                heapq.heappush(
                    heap, (prio.get(cause, 0), t0, seq, t1, cause)
                )
            i += 1
        while heap and heap[0][3] <= t:
            heapq.heappop(heap)
        next_start = ivs[i][0] if i < n else end
        if heap:
            winner_t1, winner_cause = heap[0][3], heap[0][4]
            seg_end = min(winner_t1, next_start, end)
            out[winner_cause] = out.get(winner_cause, 0.0) + (seg_end - t)
        else:
            seg_end = min(next_start, end)
            out[IDLE_CAUSE] += seg_end - t
        t = seg_end
    # fold internal fill causes into their public buckets
    for fill, public in fill_map.items():
        if fill in out:
            out[public] += out.pop(fill)
    return out


class GoodputLedger:
    """Event-sourced wall-clock accounting for one process.

    Disabled by default (every call is a cheap no-op - the `NULL_TRACER`
    / `NULL_REGISTRY` convention); ``start()`` arms it. Thread-safe: the
    step loop, the watchdog thread, and the checkpoint writer all publish
    into one ledger, and the sweep (`attribute_intervals`) guarantees
    each second is attributed once regardless of interleaving.

    Feeds (all optional, all additive):
    - ``step_span(step, dur_s)``  - one completed step's wall time
      (`train/lm.py make_traced_step`, `train/engine.py run_epoch`).
      The first span closes the implicit ``init`` interval and counts as
      ``compile`` unless told otherwise; spans inside a rollback-replay
      window count as ``rollback_recompute`` (see ``mark_recompute``).
    - ``interval(cause)``         - context manager for instrumented
      blocks (checkpoint saves, reshards, data waits).
    - ``add`` / ``add_ending_now``- retroactive attribution (the
      watchdog's stall episodes).
    - ``mark_recompute(n)``       - the next ``n`` step spans are
      rollback recompute, not goodput (`train/guard.py rollback`).

    ``taxonomy`` selects the cause set: ``"train"`` (the default - the
    original closed training taxonomy) or ``"serve"`` (the serving
    ledger: queue_wait / prefill / decode / batch_formation_idle /
    kv_alloc_stall, `serve/scheduler.py`). A serving ledger records via
    ``interval``/``add``/``add_ending_now`` + ``note_steps``; the
    training-specific feeds (``step_span``, ``fill_ending_now``,
    ``mark_recompute``) reject the serve taxonomy loudly.
    """

    def __init__(self, *, clock=time.monotonic, taxonomy: str = "train"):
        if taxonomy not in TAXONOMIES:
            raise ValueError(
                f"unknown ledger taxonomy {taxonomy!r} "
                f"(known: {', '.join(sorted(TAXONOMIES))})"
            )
        self.taxonomy = taxonomy
        (self._causes, self._goodput_cause, self._priority,
         self._fills) = TAXONOMIES[taxonomy]
        self._badput_causes = tuple(
            c for c in self._causes if c != self._goodput_cause
        )
        self._clock = clock
        self._lock = threading.Lock()
        self.enabled = False
        self.reset()

    # ------------------------------------------------------------- control

    def reset(self) -> None:
        """Back to the disarmed zero state (test hygiene for `LEDGER`)."""
        with self._lock:
            self.enabled = False
            self._intervals: list[_Interval] = []
            self._t_start: float | None = None
            self._t_init_open: float | None = None
            self.started_unix: float | None = None
            self.steps = 0
            self.goodput_steps = 0
            self.tokens = 0.0
            self._recompute_budget = 0
            self._seen_compile = False
            self.path: str | None = None
            self.write_interval_s = 5.0
            self._last_write = 0.0
            self.publish_interval_s = 2.0
            self._last_publish = 0.0
            self._registry = None
            self._m_ratio = None
            self._m_badput = None
            self.config: dict = {}
            self.config_fingerprint: str | None = None
            self.mesh: dict = {}
            self.rank: int | None = None
            self.generation: int | None = None
            self.metrics: dict = {}

    def start(self, *, rank: int | None = None) -> "GoodputLedger":
        """Arm the ledger; wall-clock zero is NOW and an ``init``
        interval opens, closed by the first ``step_span``."""
        with self._lock:
            self.enabled = True
            self._t_start = self._clock()
            # "init" and its synthesized fill exist only in the training
            # taxonomy; a serving ledger's pre-first-request prefix is
            # plain idle_other
            self._t_init_open = (
                self._t_start if self.taxonomy == "train" else None
            )
            self.started_unix = time.time()
            if rank is not None:
                self.rank = int(rank)
            elif self.rank is None:
                env = os.environ.get("RANK")  # torchrun's
                try:
                    self.rank = int(env) if env is not None else None
                except ValueError:
                    self.rank = None
            gen = os.environ.get("DNN_TPU_SUPERVISOR_GEN")
            try:
                self.generation = int(gen) if gen is not None else None
            except ValueError:
                self.generation = None
        return self

    def arm(self, path: str, *, write_interval_s: float = 5.0) -> None:
        """Write the (partial) run record through to ``path`` at a
        bounded cadence - the SIGKILL-survival channel (armed from
        `RUN_RECORD_ENV` by `train/monitor.py attach_monitor`)."""
        self.path = os.path.abspath(path)
        self.write_interval_s = float(write_interval_s)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.write_record(final=False)

    def publish(self, registry) -> None:
        """Export ``goodput_ratio`` + ``badput_seconds_total{cause}`` on
        ``registry`` (utils/obs.py), refreshed at a bounded cadence from
        ``step_span`` and once on ``finalize``."""
        self._registry = registry
        self._m_ratio = registry.gauge(
            "goodput_ratio",
            "Fraction of wall-clock spent in steady training steps",
        )
        self._m_badput = registry.counter(
            "badput_seconds_total",
            "Wall-clock lost to non-goodput causes (utils/goodput.py)",
        )

    def describe(self, *, config: dict | None = None, mesh: dict | None = None,
                 metrics: dict | None = None) -> None:
        """Attach run identity to the record: ``config`` is fingerprinted
        (sha256 over sorted JSON), ``mesh`` is the topology block,
        ``metrics`` the final numbers (merged - call any time)."""
        if config is not None:
            self.config = _json_safe(config)
            self.config_fingerprint = config_fingerprint(config)
        if mesh is not None:
            self.mesh = _json_safe(mesh)
        if metrics is not None:
            self.metrics.update(_json_safe(metrics))

    # ------------------------------------------------------------ recording

    def _now(self) -> float:
        return self._clock()

    def _check_cause(self, cause: str) -> None:
        if cause not in self._causes or cause == IDLE_CAUSE:
            raise ValueError(
                f"unknown {self.taxonomy} goodput cause {cause!r} "
                f"(closed taxonomy: "
                f"{', '.join(c for c in self._causes if c != IDLE_CAUSE)}; "
                f"{IDLE_CAUSE} is the computed residual)"
            )

    def interval(self, cause: str, **_meta):
        """``with ledger.interval("checkpoint_save"): ...`` - no-op when
        disarmed."""
        if not self.enabled:
            return _NULL_SPAN
        self._check_cause(cause)
        return _LedgerSpan(self, cause)

    def add(self, cause: str, t0: float, t1: float) -> None:
        """Record one closed interval on the ledger's own clock."""
        if not self.enabled or t1 <= t0:
            return
        self._check_cause(cause)
        with self._lock:
            self._intervals.append(_Interval(t0, t1, cause))

    def add_ending_now(self, cause: str, dur_s: float) -> None:
        """Record an interval of ``dur_s`` seconds ending now - the
        retroactive form (the watchdog knows how long the heartbeat has
        been missing, not when the stall will end; re-reporting a growing
        episode every poll coalesces in the sweep)."""
        if not self.enabled or dur_s <= 0:
            return
        now = self._now()
        self.add(cause, now - dur_s, now)

    def now(self) -> float:
        """The ledger's own clock (for retroactive ``add`` timestamps)."""
        return self._now()

    def fill_ending_now(self, cause: str, dur_s: float) -> None:
        """Record a COARSE fill interval of ``dur_s`` seconds ending now:
        it ranks below every precisely recorded interval in the sweep, so
        instrumented activity inside the window (checkpoint saves, stall
        episodes) still carves out its own attribution - the
        untelemetered fast path's whole-steady-window accounting
        (`lm_train.py` without trace/metrics, where fencing each step
        just to time it would change the run)."""
        if not self.enabled or dur_s <= 0:
            return
        fill = {v: k for k, v in self._fills.items()}.get(cause)
        if fill is None:
            raise ValueError(
                f"no fill bucket for cause {cause!r} in the "
                f"{self.taxonomy} taxonomy "
                f"(fills: {sorted(self._fills.values())})"
            )
        now = self._now()
        with self._lock:
            self._intervals.append(_Interval(now - dur_s, now, fill))

    def mark_recompute(self, n_steps: int) -> None:
        """The next ``n_steps`` completed steps are rollback replay
        (lost progress being re-earned), attributed to
        ``rollback_recompute`` instead of ``steady_step``."""
        if not self.enabled or n_steps <= 0:
            return
        with self._lock:
            self._recompute_budget += int(n_steps)

    def note_steps(self, n: int, *, tokens: float = 0.0) -> None:
        """Bookkeeping-only step counting for callers that attribute
        wall-clock coarsely via ``add``/``add_ending_now`` instead of
        per-step spans (the untelemetered fast path, where fencing every
        step just to time it would change the run being accounted)."""
        if not self.enabled or n <= 0:
            return
        with self._lock:
            self.steps += int(n)
            self.goodput_steps += int(n)
            self.tokens += float(tokens)
            self._seen_compile = True

    def step_span(
        self, step: int, dur_s: float, *,
        tokens: float = 0.0, is_compile: bool | None = None,
    ) -> None:
        """One completed training step of ``dur_s`` seconds ending now.

        The first span (unless ``is_compile=False``) is the compile step;
        it also closes the implicit ``init`` interval at its own start.
        """
        if not self.enabled:
            return
        if self.taxonomy != "train":
            raise ValueError(
                "step_span is the training ledger's feed; a "
                f"{self.taxonomy!r} ledger records via interval()/add() "
                "+ note_steps()"
            )
        now = self._now()
        t0 = now - max(float(dur_s), 0.0)
        with self._lock:
            if self._t_init_open is not None:
                if t0 > self._t_init_open:
                    self._intervals.append(
                        _Interval(self._t_init_open, t0, "init")
                    )
                self._t_init_open = None
            if is_compile is None:
                is_compile = not self._seen_compile
            if is_compile:
                cause = "compile"
                self._seen_compile = True
            elif self._recompute_budget > 0:
                self._recompute_budget -= 1
                cause = "rollback_recompute"
            else:
                cause = GOODPUT_CAUSE
                self.goodput_steps += 1
                self.tokens += float(tokens)
            self.steps += 1
            self._intervals.append(_Interval(t0, now, cause))
        self.maybe_publish(at=now)
        self.maybe_write(at=now)

    def maybe_publish(self, *, at: float | None = None,
                      force: bool = False) -> None:
        """Refresh the registry export at the bounded cadence - called
        from `step_span` on the training path and from the serve loop
        (`serve/scheduler.py`), whose feed is `add`/`interval` and so
        never passes through `step_span`."""
        if self._registry is None or not self.enabled:
            return
        now = self._now() if at is None else at
        if force or now - self._last_publish >= self.publish_interval_s:
            self._last_publish = now
            self._publish_breakdown(self.breakdown(at=now))

    def maybe_write(self, *, at: float | None = None) -> None:
        """Write-through at the bounded cadence (same split as
        `maybe_publish`)."""
        if self.path is None or not self.enabled:
            return
        now = self._now() if at is None else at
        if now - self._last_write >= self.write_interval_s:
            self._last_write = now
            self.write_record(final=False)

    # ------------------------------------------------------------- summary

    def breakdown(self, at: float | None = None) -> dict:
        """``{cause: seconds}`` over the full taxonomy up to ``at`` (now
        by default); values sum to total wall-clock by construction."""
        if self._t_start is None:
            return {c: 0.0 for c in self._causes}
        end = self._now() if at is None else at
        with self._lock:
            intervals = list(self._intervals)
            if self._t_init_open is not None:
                # init never closed by a step span: synthesize the prefix
                # up to the first recorded activity (whole window when
                # nothing was recorded), as a low-priority fill so
                # retroactive adds that reach back before the first
                # activity still win their overlap
                first = min((iv.t0 for iv in intervals), default=end)
                stop = min(max(first, self._t_init_open), end)
                if stop > self._t_init_open:
                    intervals.append(
                        _Interval(self._t_init_open, stop, "_init_fill")
                    )
        return attribute_intervals(
            intervals, self._t_start, end, priority=self._priority,
            causes=self._causes, fills=self._fills,
        )

    def wall_s(self, at: float | None = None) -> float:
        if self._t_start is None:
            return 0.0
        return (self._now() if at is None else at) - self._t_start

    def _publish_breakdown(self, buckets: dict) -> None:
        total = sum(buckets.values())
        if total > 0:
            self._m_ratio.set(buckets[self._goodput_cause] / total)
        for cause in self._badput_causes:
            if buckets[cause] > 0:
                # set_max: totals only accumulate, so a re-publish (or a
                # sweep re-resolution shaving an overlap) never regresses
                # the counter
                self._m_badput.labels(cause=cause).set_max(buckets[cause])

    def finalize(self, *, metrics: dict | None = None) -> dict:
        """Close the ledger into a run record: compute the breakdown,
        ASSERT conservation (buckets sum to total wall-clock, every
        bucket non-negative), publish the final registry export, write
        the record through when armed, and return it."""
        if metrics is not None:
            self.describe(metrics=metrics)
        end = self._now()
        buckets = self.breakdown(at=end)
        total = self.wall_s(at=end)
        attributed = sum(buckets.values())
        if any(v < 0 for v in buckets.values()) or (
            abs(attributed - total) > max(1e-6 * max(total, 1.0), 1e-9)
        ):
            raise AssertionError(
                "goodput conservation violated: buckets sum to "
                f"{attributed:.9f}s over a {total:.9f}s wall clock "
                f"({json.dumps({k: round(v, 6) for k, v in buckets.items()})})"
                " - an interval was attributed twice or clocks ran "
                "backwards; this is a ledger bug, please report it"
            )
        if self._registry is not None:
            self._publish_breakdown(buckets)
        rec = self._record(buckets, total, final=True)
        if self.path is not None:
            _atomic_write_json(self.path, rec)
        try:
            from .obs import flight_event

            flight_event("goodput_final", goodput_ratio=rec["goodput_ratio"],
                         wall_s=rec["wall_s"])
        except Exception:
            pass
        return rec

    def _event_stats(self) -> dict:
        """Per-cause duration statistics over the RAW recorded intervals
        (pre-sweep; the watchdog's re-reported stall episodes appear as
        they were reported, coarse fills are excluded). This is the
        record's ``events`` block - the empirical-distribution input the
        fleet digital twin samples from (`extract_distributions`,
        analysis/fleetsim.py): how long a checkpoint save, a reshard, or
        a steady step ACTUALLY takes on this hardware."""
        with self._lock:
            ivs = list(self._intervals)
        durs: dict = {}
        for iv in ivs:
            if iv.cause in self._fills:
                continue
            durs.setdefault(iv.cause, []).append(iv.t1 - iv.t0)
        return {c: _dist_summary(d) for c, d in sorted(durs.items())}

    def _record(self, buckets: dict, total: float, *, final: bool) -> dict:
        rounded = {c: round(v, 6) for c, v in buckets.items()}
        return {
            "version": RECORD_VERSION,
            "kind": "rank" if self.taxonomy == "train" else self.taxonomy,
            "taxonomy": self.taxonomy,
            "final": final,
            "rank": self.rank,
            "generation": self.generation,
            "hostname": _hostname(),
            "pid": os.getpid(),
            "started_unix": self.started_unix,
            "written_unix": time.time(),
            "config_fingerprint": self.config_fingerprint,
            "config": self.config,
            "mesh": self.mesh,
            "steps": self.steps,
            "goodput_steps": self.goodput_steps,
            "tokens": self.tokens,
            # the sum of the rounded buckets, so that the record conserves
            # at its own precision (finalize checked the unrounded sum)
            "wall_s": round(sum(rounded.values()), 6),
            "goodput_s": rounded[self._goodput_cause],
            "goodput_ratio": round(
                buckets[self._goodput_cause] / total, 6
            ) if total > 0 else None,
            "badput_s": {c: rounded[c] for c in self._badput_causes},
            # per-cause event-duration stats (additive, version-1
            # compatible): the distribution inputs for the fleet twin
            "events": self._event_stats(),
            "metrics": self.metrics,
        }

    def write_record(self, *, final: bool = False) -> str | None:
        """Atomically write the current record (partial unless ``final``)
        to the armed path; never raises (full-disk rule)."""
        if self.path is None or self._t_start is None:
            return None
        end = self._now()
        try:
            rec = self._record(self.breakdown(at=end),
                               self.wall_s(at=end), final=final)
            return _atomic_write_json(self.path, rec)
        except Exception:
            return None


LEDGER = GoodputLedger()


def ledger_interval(cause: str, **meta):
    """The one-line call-site hook (mirrors `obs.flight_event`):
    ``with ledger_interval("checkpoint_save"): ...`` on the process
    ledger - a shared no-op when the ledger is disarmed."""
    return LEDGER.interval(cause, **meta)


# ---------------------------------------------------------------- records


def config_fingerprint(config: dict) -> str:
    """Stable sha256 over the sorted JSON form of a config dict - two
    runs with the same fingerprint trained the same thing."""
    blob = json.dumps(_json_safe(config), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def read_record(path: str) -> dict:
    """Load + validate one record (rank or fleet); raises ValueError with
    an actionable message on schema problems."""
    with open(path) as f:
        doc = json.load(f)
    return validate_record(doc, what=path)


def validate_record(doc, what: str = "record") -> dict:
    if not isinstance(doc, dict):
        raise ValueError(f"{what}: not a JSON object")
    ver = doc.get("version")
    if not isinstance(ver, int):
        raise ValueError(
            f"{what}: missing integer 'version' - not a goodput run record"
        )
    if ver > RECORD_VERSION:
        raise ValueError(
            f"{what}: record version {ver} is newer than this build's "
            f"{RECORD_VERSION} - read it with the build that wrote it"
        )
    if "badput_s" not in doc or "wall_s" not in doc:
        raise ValueError(
            f"{what}: missing badput_s/wall_s - not a goodput run record"
        )
    # forward compat inside a version: unknown badput causes are carried
    # through untouched (rendered under their own name), never dropped
    return doc


def fleet_goodput_record(
    records: list, *,
    restart_gaps: list | None = None,
    restart_generations=None,
) -> dict:
    """Aggregate per-rank records (+ supervisor-side restart gaps) into
    one fleet-level record.

    - ``records``: per-rank rank records (partial ones from SIGKILLed
      workers included - their write-through accounting stands).
    - ``restart_gaps``: ``[{"seconds", "group_size", ...}]`` - the
      supervisor-measured death -> respawn windows, charged to
      ``restart_gap`` x the relaunched group size (capacity-seconds in
      which no worker existed - disjoint from every rank record).
    - ``restart_generations``: generations launched BY a failure restart;
      their ranks' ``init`` + ``compile`` seconds are reclassified into
      ``restart_gap`` (re-rendezvous and recompile are restart cost, not
      fresh-run startup) - together the bucket spans the whole restart
      window: worker death -> first post-restart step.

    Conservation holds in capacity-seconds: fleet ``wall_s`` =
    sum(rank walls) + sum(gap x size), and the buckets partition it.
    """
    restart_gens = set(restart_generations or ())
    buckets = {c: 0.0 for c in CAUSES}
    wall = 0.0
    steps = goodput_steps = 0
    tokens = 0.0
    ranks = []
    pooled_events: dict = {}
    for rec in records:
        rec = validate_record(rec)
        for cause, info in (rec.get("events") or {}).items():
            pool = pooled_events.setdefault(
                cause, {"count": 0, "total_s": 0.0, "samples": []}
            )
            pool["count"] += int(info.get("count") or 0)
            pool["total_s"] += float(info.get("total_s") or 0.0)
            pool["samples"].extend(info.get("samples_s") or ())
        bad = dict(rec.get("badput_s") or {})
        reclassified = 0.0
        if rec.get("generation") in restart_gens:
            reclassified = float(bad.get("init", 0.0)) + float(
                bad.get("compile", 0.0)
            )
            bad["restart_gap"] = bad.get("restart_gap", 0.0) + reclassified
            bad["init"] = bad["compile"] = 0.0
        for c, v in bad.items():
            buckets[c] = buckets.get(c, 0.0) + float(v)
        buckets[GOODPUT_CAUSE] += float(rec.get("goodput_s") or 0.0)
        wall += float(rec.get("wall_s") or 0.0)
        steps += int(rec.get("steps") or 0)
        goodput_steps += int(rec.get("goodput_steps") or 0)
        tokens += float(rec.get("tokens") or 0.0)
        ranks.append({
            "rank": rec.get("rank"),
            "generation": rec.get("generation"),
            "final": rec.get("final"),
            "wall_s": rec.get("wall_s"),
            "goodput_ratio": rec.get("goodput_ratio"),
            "steps": rec.get("steps"),
            "restart_reclassified_s": round(reclassified, 6),
        })
    gap_capacity = 0.0
    for g in restart_gaps or ():
        gap_capacity += float(g.get("seconds", 0.0)) * max(
            int(g.get("group_size", 1)), 1
        )
    buckets["restart_gap"] += gap_capacity
    wall += gap_capacity
    return {
        "version": RECORD_VERSION,
        "kind": "fleet",
        "final": all(r.get("final", False) for r in ranks) if ranks else False,
        "written_unix": time.time(),
        "n_records": len(ranks),
        "restart_gaps": list(restart_gaps or ()),
        "steps": steps,
        "goodput_steps": goodput_steps,
        "tokens": tokens,
        "wall_s": round(wall, 6),
        "goodput_s": round(buckets[GOODPUT_CAUSE], 6),
        "goodput_ratio": round(buckets[GOODPUT_CAUSE] / wall, 6)
        if wall > 0 else None,
        "badput_s": {
            c: round(v, 6) for c, v in buckets.items()
            if c != GOODPUT_CAUSE
        },
        # per-cause event samples pooled across ranks (each rank's
        # summary keeps count/total exactly; the sample list is the
        # union of the ranks' quantile-preserving subsamples), so a
        # fleet record alone feeds `extract_distributions`
        "events": {
            c: _dist_summary(
                p["samples"], count=p["count"], total_s=p["total_s"]
            )
            for c, p in sorted(pooled_events.items())
        },
        "ranks": ranks,
    }


# ----------------------------------------------- distribution extraction

# distributions-document schema version (tools/goodput.py --distributions
# writes it; analysis/fleetsim.py Distributions reads it)
DISTRIBUTIONS_VERSION = 1

# events-block sample cap: sorted durations are subsampled evenly so
# quantiles survive the cap deterministically
_DIST_MAX_SAMPLES = 64


def _dist_summary(samples, *, count: int | None = None,
                  total_s: float | None = None,
                  max_samples: int = _DIST_MAX_SAMPLES) -> dict:
    """Summarize a list of durations into the events/distribution shape:
    count, total, mean, p50/p95, max, plus an evenly-subsampled SORTED
    sample list (deterministic, quantile-preserving) bounded to
    ``max_samples`` - small enough to embed in every write-through
    record, rich enough to resample from."""
    xs = sorted(float(x) for x in samples if float(x) >= 0.0)
    n = count if count is not None else len(xs)
    tot = total_s if total_s is not None else sum(xs)
    out = {
        "count": int(n),
        "total_s": round(float(tot), 6),
        "mean_s": round(tot / n, 6) if n else 0.0,
    }
    if xs:
        import math

        def rank(q):  # nearest-rank quantile over the sorted samples
            return xs[max(0, math.ceil(q * len(xs)) - 1)]

        out["p50_s"] = round(rank(0.50), 6)
        out["p95_s"] = round(rank(0.95), 6)
        out["max_s"] = round(xs[-1], 6)
        if len(xs) > max_samples:
            step = (len(xs) - 1) / (max_samples - 1)
            xs = [xs[round(i * step)] for i in range(max_samples)]
        out["samples_s"] = [round(x, 6) for x in xs]
    return out


def extract_distributions(records) -> dict:
    """Pool per-cause event-duration distributions out of run records -
    the empirical inputs the fleet digital twin (`analysis/fleetsim.py`)
    samples restart-gap / checkpoint-save / reshard / step durations
    from, instead of guessing them.

    ``records`` is an iterable of record dicts (rank, fleet, or sim).
    Three source channels, all additive:

    - each record's ``events`` block (raw recorded interval durations,
      quantile-preserving subsamples);
    - rank records WITHOUT events (the untelemetered ``note_steps`` fast
      path, or pre-events builds): their aggregate ``badput_s`` /
      ``goodput_s``-per-step values contribute single fallback samples;
    - fleet records' ``restart_gaps``: the supervisor-measured
      death -> respawn windows as ``restart_gap`` samples, NET of each
      entry's recorded ``backoff_s`` (the simulated policy re-adds its
      OWN backoff - this run's schedule must not leak into the sample).

    Pass either the rank records or their fleet aggregate, not both -
    the fleet record already pools its ranks' events.

    Returns ``{"version", "kind": "distributions", "n_records",
    "causes": {cause: {count, mean_s, p50_s, p95_s, max_s, samples_s}},
    "derived": {"step_overhead_s": ...}}`` where ``step_overhead_s`` is
    the pooled per-step host overhead (idle_other seconds per executed
    step) - the twin charges it on every simulated step so predictions
    include the host time real runs measurably spend between steps.
    """
    pooled: dict = {}
    idle_s = 0.0
    idle_steps = 0
    n_records = 0

    def pool(cause, samples, count=None, total=None):
        p = pooled.setdefault(
            cause, {"count": 0, "total_s": 0.0, "samples": []}
        )
        xs = [float(x) for x in samples if float(x) > 0.0]
        p["samples"].extend(xs)
        p["count"] += int(count if count is not None else len(xs))
        p["total_s"] += float(total if total is not None else sum(xs))

    for rec in records:
        rec = validate_record(rec)
        n_records += 1
        events = rec.get("events") or {}
        for cause, info in events.items():
            pool(cause, info.get("samples_s") or (),
                 count=info.get("count"), total=info.get("total_s"))
        if not events:
            # aggregate-only fallback: one sample per cause total, and a
            # mean step time when the record counted steps
            bad = rec.get("badput_s") or {}
            for cause in ("init", "compile", "checkpoint_save", "reshard"):
                v = float(bad.get(cause) or 0.0)
                if v > 0:
                    pool(cause, [v])
            gsteps = int(rec.get("goodput_steps") or 0)
            gs = float(rec.get("goodput_s") or 0.0)
            if gsteps > 0 and gs > 0:
                pool(GOODPUT_CAUSE, [gs / gsteps], count=gsteps, total=gs)
        for gap in rec.get("restart_gaps") or ():
            net = float(gap.get("seconds") or 0.0) - float(
                gap.get("backoff_s") or 0.0
            )
            if net > 0:
                pool("restart_gap", [net])
        idle_s += float((rec.get("badput_s") or {}).get(IDLE_CAUSE) or 0.0)
        idle_steps += int(rec.get("steps") or 0)
    return {
        "version": DISTRIBUTIONS_VERSION,
        "kind": "distributions",
        "n_records": n_records,
        "causes": {
            c: _dist_summary(
                p["samples"], count=p["count"], total_s=p["total_s"]
            )
            for c, p in sorted(pooled.items())
        },
        "derived": {
            "step_overhead_s": round(idle_s / idle_steps, 6)
            if idle_steps > 0 else 0.0,
        },
    }


def extract_serve_distributions(request_records, client_rows=None) -> dict:
    """The SERVE variant of `extract_distributions`: pool the workload
    and service-time distributions a serve-mode fleet twin
    (analysis/fleetsim.py) samples from, out of per-request trace
    records (serve/reqtrace.py ``detail()`` dicts - a ``GET
    /v1/requests?full=1`` dump's ``recent`` list qualifies) plus,
    optionally, the loadgen client's ``--out-requests`` JSONL rows.

    Pooled causes (names chosen so they cannot collide with ledger
    causes - these are workload/service pools, not wall-clock buckets):

    - ``prompt_len`` / ``output_len``: the request mix (tokens);
    - ``inter_arrival``: client send-time deltas (needs ``client_rows``);
    - ``acceptance_rate``: per-request spec-decode accepted/proposed;
    - ``decode_tick_s`` / ``prefill_token_s``: measured engine service
      times per decode tick / per prefill token, from each finalized
      request's fenced ``engine_s`` apportionment - the empirical
      pricing the twin prefers over the roofline when replaying a
      measured run (``--validate``), exactly as the training twin
      prefers measured ``steady_step`` samples.

    Returns the `extract_distributions` document shape with
    ``taxonomy: "serve"`` added."""
    pooled: dict = {}

    def pool(cause, samples):
        p = pooled.setdefault(
            cause, {"count": 0, "total_s": 0.0, "samples": []}
        )
        xs = [float(x) for x in samples if float(x) >= 0.0]
        p["samples"].extend(xs)
        p["count"] += len(xs)
        p["total_s"] += sum(xs)

    n_requests = 0
    for det in request_records or ():
        if not isinstance(det, dict) or det.get("state") != "done":
            continue
        n_requests += 1
        pool("prompt_len", [int(det.get("prompt_len") or 0)])
        pool("output_len", [int(det.get("tokens_emitted") or 0)])
        if det.get("proposed_tokens"):
            pool("acceptance_rate",
                 [float(det.get("acceptance_rate") or 0.0)])
        eng = det.get("engine_s") or {}
        ticks = int(det.get("decode_ticks") or 0)
        dec = float(eng.get("decode") or 0.0)
        if ticks > 0 and dec > 0:
            pool("decode_tick_s", [dec / ticks])
        ptoks = int(det.get("prefill_tokens") or 0)
        pre = float(eng.get("prefill") or 0.0)
        if ptoks > 0 and pre > 0:
            pool("prefill_token_s", [pre / ptoks])
    sends = sorted(
        float(row.get("t_send_unix") or 0.0)
        for row in client_rows or ()
        if row.get("t_send_unix")
    )
    pool("inter_arrival", [b - a for a, b in zip(sends, sends[1:])])
    return {
        "version": DISTRIBUTIONS_VERSION,
        "kind": "distributions",
        "taxonomy": "serve",
        "n_records": n_requests,
        "causes": {
            c: _dist_summary(
                p["samples"], count=p["count"], total_s=p["total_s"]
            )
            for c, p in sorted(pooled.items())
        },
        "derived": {},
    }


def aggregate_records_dir(path: str) -> dict:
    """Fleet-aggregate a directory of per-worker ``gen{g}_rank{r}.json``
    records ON THE FLY - the render path for a run that crashed before
    the supervisor wrote ``run_dir/run_record.json`` (its write-through
    worker records are all that survived).

    ``path`` may be the ``records/`` directory itself or a run dir
    containing one. Without the supervisor's own bookkeeping the
    death -> respawn gaps are unknowable (no process was alive to
    measure them), and which generations were FAILURE relaunches is
    approximated as every generation after the earliest seen - right
    for crashed runs, pessimistic for planned grows (noted on the
    record as ``aggregation: "directory"``)."""
    d = path
    sub = os.path.join(path, "records")
    if os.path.isdir(sub):
        d = sub
    records = []
    skipped = 0
    try:
        names = sorted(os.listdir(d))
    except OSError as e:
        raise ValueError(f"{path}: {e}")
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                records.append(validate_record(json.load(f), name))
        except (OSError, ValueError):
            skipped += 1  # torn write-through tail or a non-record file
    if not records:
        raise ValueError(
            f"{path}: no readable goodput run records "
            f"({skipped} file(s) skipped) - expected per-worker "
            "gen{g}_rank{r}.json records (utils/goodput.py)"
        )
    gens = [
        int(r["generation"]) for r in records
        if isinstance(r.get("generation"), int)
    ]
    restart_gens = (
        set(g for g in gens if g > min(gens)) if gens else set()
    )
    fleet = fleet_goodput_record(
        records, restart_generations=restart_gens
    )
    fleet["aggregation"] = "directory"
    fleet["skipped_files"] = skipped
    return fleet


# ------------------------------------------------------- trace derivation

# span/cause mapping for the trace-derived breakdown: the same taxonomy
# computed from a (merged) Chrome trace alone - tools/trace_summary.py
# --goodput; cross-checked against the ledger record by tests
_TRACE_SPAN_CAUSE = {
    "train_step": None,  # compile/steady split below
    "straggler": "stall",
    "reshard": "reshard",
    "data_loading": "data_wait",
    "checkpoint_save": "checkpoint_save",
}


def breakdown_from_trace(doc: dict) -> dict:
    """Derive the taxonomy breakdown from a Chrome trace document
    (single-rank or `tools/trace_merge.py` merged).

    Per pid (rank): ``train_step`` spans become compile (first span) /
    steady intervals, ``straggler`` spans stall, ``reshard``/
    ``data_loading``/``checkpoint_save`` their causes; the window is
    [0, last event end] (the tracer's clock zero is tracer creation, so
    the pre-first-step prefix is ``init``); uncovered time inside the
    window is ``idle_other``. Multi-rank docs aggregate the per-rank
    breakdowns (capacity-seconds, like the fleet record). Returns
    ``{"wall_s", "goodput_ratio", "goodput_s", "badput_s", "per_rank"}``.
    """
    per_pid: dict = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name")
        if name not in _TRACE_SPAN_CAUSE:
            continue
        pid = ev.get("pid", 0)
        t0 = float(ev.get("ts", 0.0)) / 1e6
        t1 = t0 + float(ev.get("dur") or 0.0) / 1e6
        per_pid.setdefault(pid, []).append((t0, t1, name))
    buckets = {c: 0.0 for c in CAUSES}
    wall = 0.0
    per_rank = {}
    for pid, spans in sorted(per_pid.items()):
        spans.sort()
        intervals = []
        first_step = True
        first_step_t0 = None
        for t0, t1, name in spans:
            cause = _TRACE_SPAN_CAUSE[name]
            if cause is None:
                cause = "compile" if first_step else GOODPUT_CAUSE
                if first_step:
                    first_step_t0 = t0
                first_step = False
            intervals.append(_Interval(t0, t1, cause))
        if first_step_t0 is not None and first_step_t0 > 0:
            intervals.append(_Interval(0.0, first_step_t0, "init"))
        end = max(iv.t1 for iv in intervals)
        b = attribute_intervals(intervals, 0.0, end)
        per_rank[pid] = {
            "wall_s": round(end, 6),
            "goodput_ratio": round(b[GOODPUT_CAUSE] / end, 6)
            if end > 0 else None,
            "buckets": {c: round(v, 6) for c, v in b.items()},
        }
        for c, v in b.items():
            buckets[c] += v
        wall += end
    return {
        "kind": "trace",
        "wall_s": round(wall, 6),
        "goodput_s": round(buckets[GOODPUT_CAUSE], 6),
        "goodput_ratio": round(buckets[GOODPUT_CAUSE] / wall, 6)
        if wall > 0 else None,
        "badput_s": {
            c: round(v, 6) for c, v in buckets.items()
            if c != GOODPUT_CAUSE
        },
        "per_rank": per_rank,
    }


# ------------------------------------------------------ rendering / gate


def record_causes(rec: dict) -> dict:
    """Full ``{cause: seconds}`` view of a record (goodput + badput,
    unknown forward-compat causes preserved), keyed by the record's own
    taxonomy (`record_taxonomy`)."""
    causes, goodput = record_taxonomy(rec)
    out = {c: 0.0 for c in causes}
    out[goodput] = float(rec.get("goodput_s") or 0.0)
    for c, v in (rec.get("badput_s") or {}).items():
        out[c] = out.get(c, 0.0) + float(v)
    return out


def render_record(rec: dict, *, title: str | None = None) -> str:
    """Human-readable breakdown table of one record (rank/fleet/serve/
    trace)."""
    tax_causes, goodput_cause = record_taxonomy(rec)
    causes = record_causes(rec)
    total = float(rec.get("wall_s") or sum(causes.values()) or 0.0)
    lines = []
    head = title or f"Goodput breakdown ({rec.get('kind', 'rank')} record)"
    lines.append(head)
    ratio = rec.get("goodput_ratio")
    meta = []
    if ratio is not None:
        meta.append(f"goodput {100.0 * ratio:.2f}%")
    meta.append(f"wall {total:.2f}s")
    if rec.get("steps"):
        meta.append(f"{rec['steps']} step(s)")
    if rec.get("tokens"):
        meta.append(f"{rec['tokens']:,.0f} tokens")
    if rec.get("final") is False:
        meta.append("PARTIAL (write-through; the run did not finalize)")
    lines.append("  " + ", ".join(meta))
    lines.append(f"  {'cause':<20} {'seconds':>12} {'share':>8}")
    order = [c for c in tax_causes if c in causes] + sorted(
        c for c in causes if c not in tax_causes
    )
    for c in order:
        v = causes[c]
        if v <= 0 and c not in (goodput_cause, IDLE_CAUSE):
            continue
        share = v / total if total > 0 else 0.0
        tag = "  <- goodput" if c == goodput_cause else ""
        lines.append(f"  {c:<20} {v:>12.3f} {share:>7.2%}{tag}")
    return "\n".join(lines)


def diff_records(a: dict, b: dict, name_a: str = "A",
                 name_b: str = "B") -> str:
    """Side-by-side share comparison of two records."""
    tax_causes, _ = record_taxonomy(a)
    ca, cb = record_causes(a), record_causes(b)
    ta = float(a.get("wall_s") or sum(ca.values()) or 0.0)
    tb = float(b.get("wall_s") or sum(cb.values()) or 0.0)
    lines = [
        f"Goodput diff: {name_a} vs {name_b}",
        f"  wall: {ta:.2f}s vs {tb:.2f}s; goodput ratio: "
        f"{_fmt_ratio(a.get('goodput_ratio'))} vs "
        f"{_fmt_ratio(b.get('goodput_ratio'))}",
        f"  {'cause':<20} {name_a:>12} {name_b:>12} {'d-share':>9}",
    ]
    order = [c for c in tax_causes if c in ca or c in cb] + sorted(
        set(list(ca) + list(cb)) - set(tax_causes)
    )
    for c in order:
        va, vb = ca.get(c, 0.0), cb.get(c, 0.0)
        if va <= 0 and vb <= 0:
            continue
        sa = va / ta if ta > 0 else 0.0
        sb = vb / tb if tb > 0 else 0.0
        lines.append(
            f"  {c:<20} {va:>11.3f}s {vb:>11.3f}s {sb - sa:>+8.2%}"
        )
    return "\n".join(lines)


def _fmt_ratio(r) -> str:
    return f"{100.0 * r:.2f}%" if r is not None else "n/a"


DEFAULT_RATIO_TOL = 0.10
DEFAULT_SHARE_TOL = 0.10


def check_record(
    current: dict, baseline: dict, *,
    ratio_tol: float | None = None,
    share_tol: float | None = None,
    cause_tols: dict | None = None,
) -> list:
    """The regression gate: compare a record against a checked-in
    baseline in SHARES of wall-clock (so runs of different length and
    hardware speed compare), returning a list of violation strings
    (empty = pass).

    - ``goodput_ratio`` may not DROP more than ``ratio_tol`` (absolute).
    - each badput cause's share may not GROW more than its tolerance
      (``cause_tols[cause]``, falling back to ``share_tol``); causes the
      baseline never saw are held to the same tolerance from zero.

    Tolerances resolve CLI > baseline-embedded ``check_tolerances``
    block > defaults - so the committed baseline carries its own
    contract, shardlint-manifest style. Records are compared within one
    taxonomy; gating a serving record against a training baseline (or
    vice versa) is a usage error, named.
    """
    tax_cur = current.get("taxonomy") or "train"
    tax_base = baseline.get("taxonomy") or "train"
    if tax_cur != tax_base:
        raise ValueError(
            f"taxonomy mismatch: current record is {tax_cur!r}, baseline "
            f"is {tax_base!r} - gate serving records against a serving "
            "baseline (tools/goodput.py --baseline ...)"
        )
    causes, goodput_cause = record_taxonomy(current)
    badput_causes = tuple(c for c in causes if c != goodput_cause)
    embedded = baseline.get("check_tolerances") or {}
    if ratio_tol is None:
        ratio_tol = float(embedded.get("goodput_ratio", DEFAULT_RATIO_TOL))
    if share_tol is None:
        share_tol = float(embedded.get("share", DEFAULT_SHARE_TOL))
    tols = dict(embedded.get("causes") or {})
    tols.update(cause_tols or {})
    for c in tols:
        if c not in badput_causes:
            raise ValueError(
                f"unknown badput cause {c!r} in tolerances "
                f"(known: {', '.join(badput_causes)})"
            )
    problems = []
    r_cur = current.get("goodput_ratio")
    r_base = baseline.get("goodput_ratio")
    if r_base is not None:
        if r_cur is None:
            problems.append(
                "goodput_ratio: absent from the current record "
                f"(baseline {r_base:.4f})"
            )
        elif r_base - r_cur > ratio_tol:
            problems.append(
                f"goodput_ratio: {r_cur:.4f} dropped more than "
                f"{ratio_tol:.3f} below the baseline {r_base:.4f}"
            )
    cc, cb = record_causes(current), record_causes(baseline)
    t_cur = float(current.get("wall_s") or 0.0)
    t_base = float(baseline.get("wall_s") or 0.0)
    for c in sorted(set(list(cc) + list(cb))):
        if c == goodput_cause:
            continue
        s_cur = cc.get(c, 0.0) / t_cur if t_cur > 0 else 0.0
        s_base = cb.get(c, 0.0) / t_base if t_base > 0 else 0.0
        tol = float(tols.get(c, share_tol))
        if s_cur - s_base > tol:
            problems.append(
                f"badput '{c}': share {s_cur:.2%} grew more than "
                f"{tol:.2%} over the baseline {s_base:.2%} "
                f"({cc.get(c, 0.0):.3f}s of {t_cur:.3f}s)"
            )
    return problems


# ----------------------------------------------------------------- helpers


def _hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:  # pragma: no cover - defensive
        return "unknown"


def _json_safe(x):
    import math

    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, (str, int, bool)) or x is None:
        return x
    return repr(x)


def _atomic_write_json(path: str, doc: dict) -> str | None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, allow_nan=False)
        os.replace(tmp, path)
    except (OSError, ValueError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path
