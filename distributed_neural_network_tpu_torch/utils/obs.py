"""Live observability: an in-process metrics registry rendered as
Prometheus text, the HTTP server that carries ``/metrics``, ``/healthz``
and the serving routes, and the crash flight recorder.

A copy of the parts of the JAX package's `utils/obs.py` that the port uses
(stdlib only): ``MetricsRegistry``, ``NullRegistry`` / ``NULL_REGISTRY``,
``parse_prom_samples``, ``ObsServer``, and ``FLIGHT_ENV``,
``FlightRecorder``, ``FLIGHT``, ``flight_event`` and ``read_flight_dump``
(the training guard and the chaos injectors record their events there).
The metric names, the exposition format and the flight dump's schema are
the same, so the JAX package's dashboards and parsers read the port's
output unchanged.
"""

from __future__ import annotations

import http.server
import json
import math
import os
import socket
import threading
import time
from collections import deque

# env var naming the per-worker flight-recorder dump file (the JAX
# package's name, so a supervisor exports one path for either package)
FLIGHT_ENV = "DNN_TPU_FLIGHT_FILE"

# default histogram bucket bounds (seconds) for step-time histograms:
# spans 1 ms compiled CPU smoke steps to multi-minute fused spans
DEFAULT_TIME_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(
            f"invalid Prometheus metric/label name {name!r} "
            "(use [a-zA-Z_:][a-zA-Z0-9_:]*)"
        )
    return name


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr,
    non-finite as +Inf/-Inf/NaN (legal in the exposition format)."""
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    esc = lambda s: str(s).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n"
    )
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in labels) + "}"


class _Child:
    """One (metric, label-set) sample. Publishing is a plain float
    attribute update - resolve the child once, then every ``inc``/``set``
    is lock-free (CPython attribute stores are atomic; a lost increment
    under a torn race would be a sub-sample error in a monitoring counter,
    which the render-side lock does not need to prevent)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)

    def set_max(self, value: float) -> None:
        """Monotonic set: only moves forward (republishing accumulated
        totals - e.g. phase_seconds_total - can never regress a counter)."""
        v = float(value)
        if v > self.value:
            self.value = v


class _HistChild:
    """Histogram sample: fixed bucket bounds, cumulative counts on render."""

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        # observe() mutates three fields; a tiny lock keeps render()'s
        # cumulative math consistent (observe is not the per-step hot
        # path's inner loop - one call per step)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if v <= b:
                i = j
                break
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> float | None:
        """Approximate quantile from bucket counts (upper bound of the
        bucket containing the q-th observation); None when empty. Used by
        the watchdog and dashboard, not by Prometheus (which computes
        histogram_quantile server-side)."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if not total:
            return None
        target = q * total
        acc = 0
        for j, c in enumerate(counts):
            acc += c
            if acc >= target:
                return (
                    self.bounds[j] if j < len(self.bounds)
                    else self.bounds[-1]
                )
        return self.bounds[-1]


class _Metric:
    def __init__(self, name, help_, kind, buckets=None):
        self.name = _check_name(name)
        self.help = help_
        self.kind = kind
        self.buckets = buckets
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        for k in labels:
            _check_name(k)
        key = tuple(sorted(labels.items()))
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = (
                        _HistChild(self.buckets)
                        if self.kind == "histogram" else _Child()
                    )
                    self._children[key] = child
        return child

    # label-less convenience: metric.inc()/set()/observe() act on the
    # empty-label child (resolved once, cached on the instance)
    def _default(self):
        d = self.__dict__.get("_default_child")
        if d is None:
            d = self.__dict__["_default_child"] = self.labels()
        return d

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def set_max(self, value: float) -> None:
        self._default().set_max(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def quantile(self, q: float):
        return self._default().quantile(q)

    @property
    def value(self) -> float:
        return self._default().value

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            children = list(self._children.items())
        for key, child in sorted(children):
            if self.kind == "histogram":
                with child._lock:
                    counts = list(child.counts)
                    s, n = child.sum, child.count
                acc = 0
                for j, b in enumerate(child.bounds):
                    acc += counts[j]
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(key + (('le', _fmt_value(float(b))),))}"
                        f" {acc}"
                    )
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key + (('le', '+Inf'),))} {n}"
                )
                lines.append(
                    f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(s)}"
                )
                lines.append(f"{self.name}_count{_fmt_labels(key)} {n}")
            else:
                lines.append(
                    f"{self.name}{_fmt_labels(key)} "
                    f"{_fmt_value(child.value)}"
                )
        return lines


class MetricsRegistry:
    """Metric factory + heartbeat state + Prometheus text renderer.

    ``counter``/``gauge``/``histogram`` are idempotent by name (the same
    metric object comes back, so independent modules can wire the same
    series without coordination); a kind mismatch on an existing name
    raises - two subsystems silently sharing a name with different types
    is exactly the bug a registry exists to catch.
    """

    def __init__(self, *, beat_window: int = 64):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self.started_unix = time.time()
        # heartbeat state (read by /healthz and the watchdog)
        self._beat_lock = threading.Lock()
        self._last_beat: float | None = None
        self._last_step: int | None = None
        self._last_begin: int | None = None
        self._intervals: deque[float] = deque(maxlen=beat_window)
        self.ready = False
        self._ready_unix: float | None = None
        # optional per-beat callback (step) - the step-boundary hook both
        # training loops already drive via beat(); the on-demand profiler
        # (train/monitor.py ProfileController) rides it so no step-loop
        # signature changes are needed. Exceptions are swallowed: a hook
        # bug must never kill a training step.
        self.beat_hook = None

    # ------------------------------------------------------------ metrics

    def _get(self, name, help_, kind, buckets=None) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = _Metric(name, help_, kind, buckets)
                    self._metrics[name] = m
        if m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> _Metric:
        return self._get(name, help, "counter")

    def gauge(self, name: str, help: str = "") -> _Metric:
        return self._get(name, help, "gauge")

    def histogram(
        self, name: str, help: str = "",
        buckets=DEFAULT_TIME_BUCKETS,
    ) -> _Metric:
        return self._get(name, help, "histogram", tuple(buckets))

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    # ---------------------------------------------------------- heartbeat

    def beat(self, step: int | None = None) -> None:
        """One liveness heartbeat (call at each step boundary). Records
        the interval since the previous beat - the window the watchdog
        derives its stall threshold (N x steady p95) from."""
        now = time.time()
        with self._beat_lock:
            if self._last_beat is not None:
                self._intervals.append(now - self._last_beat)
            self._last_beat = now
            if step is not None:
                self._last_step = int(step)
        hook = self.beat_hook
        if hook is not None:
            try:
                hook(step)
            except Exception:
                pass

    def begin_step(self, step: int) -> None:
        """Mark step ``step`` as STARTED (called before the dispatch,
        where ``beat`` marks completion). The begin/beat pair is the
        fleet straggler-attribution channel for synchronized SPMD
        groups: a rank wedged host-side never begins step S+1 while its
        peers (blocked in the collective, steps already dispatched)
        have - so begin-step divergence names the guilty rank even
        though every rank's COMPLETION is delayed equally
        (`train/supervisor.py FleetFederation`)."""
        with self._beat_lock:
            self._last_begin = int(step)

    def last_begin_step(self) -> int | None:
        with self._beat_lock:
            return self._last_begin

    def mark_ready(self) -> None:
        """Flip readiness (first compiled step completed). /healthz
        reports ready=false until then, so a scraper can tell 'still
        compiling' from 'serving but stalled'."""
        if not self.ready:
            self.ready = True
            self._ready_unix = time.time()

    def heartbeat_age(self) -> float | None:
        with self._beat_lock:
            if self._last_beat is None:
                return None
            return time.time() - self._last_beat

    def last_step(self) -> int | None:
        with self._beat_lock:
            return self._last_step

    def beat_intervals(self) -> list[float]:
        with self._beat_lock:
            return list(self._intervals)

    def health(self, *, stall_after_s: float = 300.0) -> dict:
        """The /healthz JSON body. ``alive`` = a heartbeat arrived within
        ``stall_after_s`` (or none expected yet - a run still compiling
        step 0 is alive, just not ready)."""
        age = self.heartbeat_age()
        return {
            "alive": age is None or age < stall_after_s,
            "ready": self.ready,
            "heartbeat_age_s": round(age, 3) if age is not None else None,
            "step": self.last_step(),
            "uptime_s": round(time.time() - self.started_unix, 3),
            "ready_unix": self._ready_unix,
        }

    # -------------------------------------------------------------- render

    def render(self) -> str:
        """Prometheus text exposition (0.0.4) of every registered metric
        plus the heartbeat/readiness gauges."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            lines.extend(m.render())
        with self._beat_lock:
            beat, step = self._last_beat, self._last_step
        lines.append("# HELP process_start_time_seconds Unix start time")
        lines.append("# TYPE process_start_time_seconds gauge")
        lines.append(
            f"process_start_time_seconds {_fmt_value(self.started_unix)}"
        )
        lines.append("# HELP train_ready 1 once the first step compiled")
        lines.append("# TYPE train_ready gauge")
        lines.append(f"train_ready {1 if self.ready else 0}")
        if beat is not None:
            lines.append(
                "# HELP train_heartbeat_timestamp_seconds Unix time of "
                "the last step heartbeat"
            )
            lines.append("# TYPE train_heartbeat_timestamp_seconds gauge")
            lines.append(
                f"train_heartbeat_timestamp_seconds {_fmt_value(beat)}"
            )
        if step is not None:
            lines.append("# HELP train_heartbeat_step Last heartbeat step")
            lines.append("# TYPE train_heartbeat_step gauge")
            lines.append(f"train_heartbeat_step {step}")
        return "\n".join(lines) + "\n"


class _NullMetric:
    """No-op metric/child: every method swallows its arguments."""

    __slots__ = ()
    value = 0.0

    def labels(self, **labels):
        return self

    def inc(self, amount: float = 1.0) -> None: ...

    def set(self, value: float) -> None: ...

    def set_max(self, value: float) -> None: ...

    def observe(self, value: float) -> None: ...

    def quantile(self, q: float):
        return None

    def render(self):
        return []


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The disabled registry (mirrors tracing.NULL_TRACER): one shared
    no-op metric for every name, no state, nothing rendered."""

    ready = False

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "", buckets=()) -> _NullMetric:
        return _NULL_METRIC

    def get(self, name: str):
        return None

    def beat(self, step: int | None = None) -> None: ...

    def begin_step(self, step: int) -> None: ...

    def last_begin_step(self):
        return None

    def mark_ready(self) -> None: ...

    def heartbeat_age(self):
        return None

    def last_step(self):
        return None

    def beat_intervals(self):
        return []

    def health(self, *, stall_after_s: float = 300.0) -> dict:
        return {"alive": True, "ready": False, "heartbeat_age_s": None,
                "step": None, "uptime_s": 0.0, "ready_unix": None}

    def render(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()


# ------------------------------------------------------- flight recorder


def _hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:  # pragma: no cover - defensive
        return "unknown"


def _json_safe(x):
    """Sanitize a flight event for strict JSON: non-finite floats become
    None, anything non-serializable becomes its repr."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, (str, int, bool)) or x is None:
        return x
    return repr(x)


class FlightRecorder:
    """Crash flight recorder: a bounded in-memory ring of structured events
    (guard anomalies, rollbacks, chaos injections, preemptions) with an
    atomic write-through dump.

    A hard-killed worker gets no exit path, so the last-seconds record must
    already be on disk. Events are therefore low-rate by contract
    (step-boundary anomalies and lifecycle transitions, never per-step
    hot-path publishes), which makes write-through affordable: every
    ``record()`` on a configured recorder rewrites the dump file atomically
    (tmp + rename), so the file on disk is always the whole current ring.
    ``DNN_TPU_FLIGHT_FILE`` (`FLIGHT_ENV`) names the dump path a supervisor
    hands each worker.

    Unconfigured (no path, the default), the ring still records in memory:
    one deque append per event, dumpable on demand. The module-level
    ``FLIGHT`` is the process's recorder; call sites use
    ``flight_event(kind, step=..., **fields)``.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self.path: str | None = None
        self.rank: int | None = None
        self.hostname = _hostname()
        self.started_unix = time.time()

    def configure(self, path: str, *, rank: int | None = None,
                  hostname: str | None = None) -> None:
        """Arm write-through dumping to ``path`` (an immediate dump marks
        the recorder live). Without ``rank``, torchrun's ``RANK`` names it."""
        self.path = os.path.abspath(path)
        if rank is not None:
            self.rank = int(rank)
        elif self.rank is None:
            env_rank = os.environ.get("RANK")
            try:
                self.rank = int(env_rank) if env_rank is not None else None
            except ValueError:
                self.rank = None
        if hostname is not None:
            self.hostname = hostname
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.dump()

    def record(self, kind: str, /, *, step: int | None = None, **fields) -> dict:
        """Append one structured event (and write through when armed).
        ``kind`` is positional-only so a field may also be named kind; the
        reserved keys (t, kind) shadow rather than being shadowed."""
        ev = {"t": round(time.time(), 3), "kind": str(kind)}
        if step is not None:
            ev["step"] = int(step)
        for k, v in fields.items():
            k = str(k)
            if k in ("t", "kind"):
                k = f"arg_{k}"
            ev[k] = _json_safe(v)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
        if self.path is not None:
            self.dump()
        return ev

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def snapshot(self, *, cause: str | None = None) -> dict:
        """The dump document (the JAX package's schema, version 1)."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        return {
            "version": 1, "pid": os.getpid(), "rank": self.rank, "hostname": self.hostname,
            "started_unix": self.started_unix, "written_unix": time.time(), "cause": cause,
            "capacity": self.capacity, "dropped": dropped, "events": events,
        }

    def dump(self, *, cause: str | None = None, path: str | None = None):
        """Atomically write the ring to ``path`` (default the configured
        one); returns the path, or None when there is nowhere to write.
        Never raises: a full disk must not kill the run being recorded."""
        p = path or self.path
        if p is None:
            return None
        doc = self.snapshot(cause=cause)
        tmp = f"{p}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, allow_nan=False)
            os.replace(tmp, p)
        except (OSError, ValueError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return p

    def reset(self) -> None:
        """Clear the ring and the configuration (for the shared singleton
        between runs in one process)."""
        with self._lock:
            self._events.clear()
            self.dropped = 0
        self.path = None
        self.rank = None


FLIGHT = FlightRecorder()


def flight_event(kind: str, /, *, step: int | None = None, **fields) -> dict:
    """Record one event on the process flight recorder (`FLIGHT`): a deque
    append, plus one small atomic file write when a dump path is armed."""
    return FLIGHT.record(kind, step=step, **fields)


def read_flight_dump(path: str) -> dict | None:
    """Parse one flight-recorder dump; None when absent or torn."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def parse_prom_samples(text: str) -> dict:
    """{metric_name: {((label, value), ...): float}} from Prometheus text
    exposition - the supervisor-side parser the federation scraper uses
    (`train/supervisor.py`). Histogram series keep their _bucket/_sum/
    _count suffixes as distinct names; malformed lines are skipped.
    `tools/live_top.py` carries its own equivalent copy by design: the
    dashboard must stay free of repo imports.
    """
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labels_s, value_s = rest.rsplit("}", 1)
                labels = []
                for part in _split_label_pairs(labels_s):
                    k, v = part.split("=", 1)
                    labels.append((k, _prom_unescape(v.strip('"'))))
                key = tuple(sorted(labels))
            else:
                name, value_s = line.rsplit(None, 1)
                key = ()
            v = value_s.strip()
            value = float("inf") if v == "+Inf" else (
                float("-inf") if v == "-Inf" else float(v)
            )
        except ValueError:
            continue
        out.setdefault(name.strip(), {})[key] = value
    return out


def _prom_unescape(s: str) -> str:
    return (
        s.replace("\\\\", "\0")
        .replace('\\"', '"')
        .replace("\\n", "\n")
        .replace("\0", "\\")
    )


def _split_label_pairs(s: str):
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    parts, buf, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
            continue
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in (p.strip() for p in parts) if p]


# ------------------------------------------------------------- HTTP server


class _ObsHandler(http.server.BaseHTTPRequestHandler):
    # the registry rides on the server instance (set by ObsServer)

    def _dispatch_route(self, method: str) -> bool:
        """Pluggable route table (``ObsServer(routes=...)``): the
        serving layer (`serve/http.py`) mounts its endpoints - incl.
        long-lived SSE streams - on the same server as /metrics and
        /healthz. A route handler owns the whole response; a client
        disconnect mid-stream must be handled inside it (the serving
        handler turns it into a request cancel)."""
        routes = getattr(self.server, "routes", None)
        if not routes:
            return False
        fn = routes.get((method, self.path.split("?", 1)[0]))
        if fn is None:
            return False
        fn(self)
        return True

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        if self._dispatch_route("POST"):
            return
        body = b"not found\n"
        self.send_response(404)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        if self._dispatch_route("GET"):
            return
        reg = self.server.registry  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = reg.render().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
        elif path in ("/healthz", "/health"):
            h = reg.health(
                stall_after_s=self.server.stall_after_s  # type: ignore
            )
            body = (json.dumps(h) + "\n").encode()
            # liveness maps onto the status code so `curl -f` and k8s
            # httpGet probes work without parsing the body
            self.send_response(200 if h["alive"] else 503)
            self.send_header("Content-Type", "application/json")
        elif path == "/":
            text = (
                "distributed_neural_network_tpu_torch server\n"
                "endpoints: /metrics (Prometheus), /healthz (JSON)\n"
            )
            # mounted route-table endpoints (the serving layer's /v1/*)
            # listed dynamically so the index never goes stale
            mounted = getattr(self.server, "routes", None) or {}
            if mounted:
                text += "routes: " + ", ".join(
                    f"{m} {p}" for m, p in sorted(mounted)
                ) + "\n"
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class _ObsHTTPServer(http.server.ThreadingHTTPServer):
    # socketserver's default listen backlog is 5; a serving burst (the
    # 429 overflow probe fires dozens of connections at once) would get
    # kernel connection resets before admission control ever saw them
    request_queue_size = 128


class ObsServer:
    """Background-thread HTTP server for one training process.

    ``port=0`` binds an ephemeral port (CI/tests); the bound port is on
    ``.port`` and the full scrape URL on ``.url``. The serving thread is
    a daemon - a hung scrape can never hold the training process open -
    and ``close()`` shuts it down deterministically (both CLIs call it
    in their exit path).
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        stall_after_s: float = 300.0,
        routes: dict | None = None,
    ):
        self.registry = registry
        self._httpd = _ObsHTTPServer((host, port), _ObsHandler)
        self._httpd.daemon_threads = True
        self._httpd.registry = registry  # type: ignore[attr-defined]
        self._httpd.stall_after_s = stall_after_s  # type: ignore
        # extra {(method, path): fn(handler)} routes (serve/http.py)
        self._httpd.routes = dict(routes or {})  # type: ignore
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="obs-server",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
