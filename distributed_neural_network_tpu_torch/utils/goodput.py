"""Serving goodput ledger: wall-clock accounting over the closed serving
taxonomy, written out as a run record.

A copy of the serving half of the JAX package's `utils/goodput.py`
(stdlib only). Every second of the serve loop lands in exactly one cause:
``queue_wait``, ``prefill``, ``decode`` (the goodput bucket),
``batch_formation_idle``, ``kv_alloc_stall``, or the residual
``idle_other``. Overlaps resolve by a priority sweep (the engine's fenced
spans beat ``queue_wait``), and ``finalize()`` asserts that the buckets sum
to the wall clock. The record keeps the JAX package's schema (version 2,
``taxonomy: "serve"``), so its `tools/goodput.py` reads the port's records
unchanged.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import socket
import threading
import time

RECORD_VERSION = 2

IDLE_CAUSE = "idle_other"
SERVE_GOODPUT_CAUSE = "decode"
SERVE_CAUSES = (
    "queue_wait",
    "prefill",
    SERVE_GOODPUT_CAUSE,
    "batch_formation_idle",
    "kv_alloc_stall",
    IDLE_CAUSE,
)
SERVE_BADPUT_CAUSES = tuple(c for c in SERVE_CAUSES if c != SERVE_GOODPUT_CAUSE)

# overlap resolution (lower wins): the engine's fenced compute spans beat
# queue_wait, which is recorded per request over its whole queued window
# and so only claims otherwise-idle seconds
_SERVE_PRIORITY = {c: 0 for c in SERVE_CAUSES}
_SERVE_PRIORITY["queue_wait"] = 1

_DIST_MAX_SAMPLES = 64

class _Interval:
    __slots__ = ("t0", "t1", "cause")

    def __init__(self, t0: float, t1: float, cause: str):
        self.t0 = t0
        self.t1 = t1
        self.cause = cause


def attribute_intervals(
    intervals, start: float, end: float, *, priority=None,
    causes=SERVE_CAUSES,
) -> dict:
    """Sweep-line attribution: partition ``[start, end]`` over the
    recorded intervals so every second is counted exactly once.

    Overlaps are resolved by ``(priority, start-time, sequence)`` - the
    highest-priority (lowest number), earliest interval owns the overlap;
    uncovered time is ``idle_other``. Returns a full ``{cause: seconds}``
    dict over ``causes``; the values sum to
    ``end - start`` to float precision BY CONSTRUCTION - the conservation
    rule `GoodputLedger.finalize` asserts.
    """
    import heapq

    prio = priority if priority is not None else _SERVE_PRIORITY
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
    return out


class GoodputLedger:
    """Event-sourced wall-clock accounting for one serving process.

    Disabled until ``start()`` (every call before it is a cheap no-op).
    Thread-safe: the serve loop records fenced spans with ``add`` and step
    counts with ``note_steps``, and the sweep attributes each second once.
    ``taxonomy`` must be ``"serve"``; the training taxonomy comes with the
    port's training slices.
    """

    def __init__(self, *, clock=time.monotonic, taxonomy: str = "serve"):
        if taxonomy != "serve":
            raise NotImplementedError(
                f"ledger taxonomy {taxonomy!r}: the port carries the serving "
                "ledger only; the training taxonomy comes with slice 4 (the run record)"
            )
        self.taxonomy = taxonomy
        self._causes = SERVE_CAUSES
        self._clock = clock
        self._lock = threading.Lock()
        self.enabled = False
        self._intervals: list[_Interval] = []
        self._t_start: float | None = None
        self.started_unix: float | None = None
        self.steps = 0
        self.goodput_steps = 0
        self.tokens = 0.0
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
        self.metrics: dict = {}

    # ------------------------------------------------------------- control

    def start(self) -> "GoodputLedger":
        """Arm the ledger; wall-clock zero is now."""
        with self._lock:
            self.enabled = True
            self._t_start = self._clock()
            self.started_unix = time.time()
        return self

    def arm(self, path: str, *, write_interval_s: float = 5.0) -> None:
        """Write the (partial) run record through to ``path`` at a bounded
        cadence, so a killed server's accounting is on disk."""
        self.path = os.path.abspath(path)
        self.write_interval_s = float(write_interval_s)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.write_record(final=False)

    def publish(self, registry) -> None:
        """Export ``goodput_ratio`` + ``badput_seconds_total{cause}`` on
        ``registry`` (utils/obs.py)."""
        self._registry = registry
        self._m_ratio = registry.gauge(
            "goodput_ratio",
            "Fraction of wall-clock spent in steady training steps",
        )
        self._m_badput = registry.counter(
            "badput_seconds_total",
            "Wall-clock lost to non-goodput causes (utils/goodput.py)",
        )

    def describe(self, *, config: dict | None = None,
                 metrics: dict | None = None) -> None:
        """Attach run identity: ``config`` is fingerprinted (sha256 over
        sorted JSON), ``metrics`` merged into the final numbers."""
        if config is not None:
            self.config = _json_safe(config)
            self.config_fingerprint = config_fingerprint(config)
        if metrics is not None:
            self.metrics.update(_json_safe(metrics))

    # ------------------------------------------------------------ recording

    def now(self) -> float:
        """The ledger's own clock (for ``add`` timestamps)."""
        return self._clock()

    def add(self, cause: str, t0: float, t1: float) -> None:
        """Record one closed interval on the ledger's own clock."""
        if not self.enabled or t1 <= t0:
            return
        if cause not in self._causes or cause == IDLE_CAUSE:
            raise ValueError(
                f"unknown serve goodput cause {cause!r} (closed taxonomy: "
                f"{', '.join(c for c in self._causes if c != IDLE_CAUSE)}; "
                f"{IDLE_CAUSE} is the computed residual)"
            )
        with self._lock:
            self._intervals.append(_Interval(t0, t1, cause))

    def note_steps(self, n: int, *, tokens: float = 0.0) -> None:
        """Count ``n`` engine steps that moved ``tokens`` decode tokens."""
        if not self.enabled or n <= 0:
            return
        with self._lock:
            self.steps += int(n)
            self.goodput_steps += int(n)
            self.tokens += float(tokens)

    def maybe_publish(self, *, at: float | None = None) -> None:
        """Refresh the registry export at its bounded cadence."""
        if self._registry is None or not self.enabled:
            return
        now = self.now() if at is None else at
        if now - self._last_publish >= self.publish_interval_s:
            self._last_publish = now
            self._publish_breakdown(self.breakdown(at=now))

    def maybe_write(self, *, at: float | None = None) -> None:
        """Write the record through at its bounded cadence."""
        if self.path is None or not self.enabled:
            return
        now = self.now() if at is None else at
        if now - self._last_write >= self.write_interval_s:
            self._last_write = now
            self.write_record(final=False)

    # ------------------------------------------------------------- summary

    def breakdown(self, at: float | None = None) -> dict:
        """``{cause: seconds}`` up to ``at`` (now by default); the values sum
        to the wall clock by construction."""
        if self._t_start is None:
            return {c: 0.0 for c in self._causes}
        end = self.now() if at is None else at
        with self._lock:
            intervals = list(self._intervals)
        return attribute_intervals(intervals, self._t_start, end)

    def wall_s(self, at: float | None = None) -> float:
        if self._t_start is None:
            return 0.0
        return (self.now() if at is None else at) - self._t_start

    def _publish_breakdown(self, buckets: dict) -> None:
        total = sum(buckets.values())
        if total > 0:
            self._m_ratio.set(buckets[SERVE_GOODPUT_CAUSE] / total)
        for cause in SERVE_BADPUT_CAUSES:
            if buckets[cause] > 0:
                # totals only accumulate: a re-publish never regresses them
                self._m_badput.labels(cause=cause).set_max(buckets[cause])

    def finalize(self, *, metrics: dict | None = None) -> dict:
        """Close the ledger into a run record: ASSERT conservation (buckets
        sum to the wall clock, none negative), publish, write the record
        when armed, and return it."""
        if metrics is not None:
            self.describe(metrics=metrics)
        end = self.now()
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
            )
        if self._registry is not None:
            self._publish_breakdown(buckets)
        rec = self._record(buckets, total, final=True)
        if self.path is not None:
            _atomic_write_json(self.path, rec)
        return rec

    def _event_stats(self) -> dict:
        """Per-cause duration statistics over the raw recorded intervals
        (the record's ``events`` block)."""
        with self._lock:
            ivs = list(self._intervals)
        durs: dict = {}
        for iv in ivs:
            durs.setdefault(iv.cause, []).append(iv.t1 - iv.t0)
        return {c: _dist_summary(d) for c, d in sorted(durs.items())}

    def _record(self, buckets: dict, total: float, *, final: bool) -> dict:
        rounded = {c: round(v, 6) for c, v in buckets.items()}
        return {
            "version": RECORD_VERSION,
            "kind": self.taxonomy,
            "taxonomy": self.taxonomy,
            "final": final,
            "rank": None,
            "generation": None,
            "hostname": _hostname(),
            "pid": os.getpid(),
            "started_unix": self.started_unix,
            "written_unix": time.time(),
            "config_fingerprint": self.config_fingerprint,
            "config": self.config,
            "mesh": {},
            "steps": self.steps,
            "goodput_steps": self.goodput_steps,
            "tokens": self.tokens,
            # the sum of the rounded buckets, so that the record conserves
            # at its own precision (finalize checked the unrounded sum)
            "wall_s": round(sum(rounded.values()), 6),
            "goodput_s": rounded[SERVE_GOODPUT_CAUSE],
            "goodput_ratio": round(
                buckets[SERVE_GOODPUT_CAUSE] / total, 6
            ) if total > 0 else None,
            "badput_s": {c: rounded[c] for c in SERVE_BADPUT_CAUSES},
            "events": self._event_stats(),
            "metrics": self.metrics,
        }

    def write_record(self, *, final: bool = False) -> str | None:
        """Atomically write the current record (partial unless ``final``)
        to the armed path; never raises."""
        if self.path is None or self._t_start is None:
            return None
        end = self.now()
        try:
            rec = self._record(self.breakdown(at=end), self.wall_s(at=end), final=final)
            return _atomic_write_json(self.path, rec)
        except Exception:
            return None


# ---------------------------------------------------------------- records


def config_fingerprint(config: dict) -> str:
    """Stable sha256 over the sorted JSON form of a config dict."""
    blob = json.dumps(_json_safe(config), sort_keys=True, separators=(",", ":"))
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


def _hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:  # pragma: no cover - defensive
        return "unknown"


def _json_safe(x):
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
