"""Per-request lifecycle tracing: latency attribution for every
request the serving stack touches.

A copy of the JAX package's `serve/reqtrace.py` (stdlib only): the
records, their Chrome-trace lanes (one ``slot{N}`` track per concurrent
request, through `utils/tracing.py`'s ``complete`` / ``instant_at``) and
the percentile helpers (`percentile`, `clipped_causes`, `decompose`).
What follows is that module's note.

The serving ledger (`scheduler.py` + `utils/goodput.py` taxonomy
"serve") partitions the SERVER's wall clock - it can say "the fleet
spent 12% of this hour stalled on KV blocks" but not "THIS request's
p99 TTFT was 62% queue_wait". This module is the per-request dual: an
event-sourced recorder that walks every request through a CLOSED
taxonomy mirroring the serve goodput causes -

- ``queue_wait``      - arrival -> the admission loop picks it up;
- ``admission``       - wiring into the engine (sequence build + add);
- ``prefill``         - consuming prompt tokens (incl. chunked prefill
                        and post-preemption replay);
- ``decode``          - generating tokens (the goodput phase). With
                        speculative decoding on, ``draft_s``/``verify_s``
                        sub-attribute the device seconds INSIDE this
                        cause (counters on the record, not new taxonomy
                        members) along with proposed/accepted token
                        counts;
- ``kv_alloc_stall``  - parked: block exhaustion blocked this sequence
                        this tick;
- ``preempted_wait``  - evicted (blocks freed, pos reset), waiting for
                        re-admission at the front of the queue;
- ``stream_write``    - engine-side done -> the streaming channel
                        finished writing (the SSE flush window).

**Conservation rule** (same discipline as `utils/goodput.py`): a
request's spans PARTITION its ``arrival -> terminal`` wall-clock -
contiguous, non-overlapping, summing to the request's total lifetime
within ``max(1e-6 * max(total, 1), 1e-9)`` seconds. `finalize()`
asserts it; a request whose seconds leak is a bug, not a metric.

The recorder is the single source for three export surfaces:

- ``GET /v1/requests`` (serve/http.py) - in-flight summaries plus a
  bounded ring of finalized records (``?id=N`` for one request's full
  span sequence, ``?full=1`` for every ringed record with spans);
- Chrome trace lanes - with a `utils/tracing.py` Tracer attached
  (``--trace-out``), each request's spans land on a per-slot lane
  (``slot0..slotN``) with preemption instants, so
  `tools/trace_merge.py` / Perfetto render serving timelines next to
  training shards;
- `tools/request_trace.py` - decomposes TTFT/E2E percentiles by cause,
  prints slow-request exemplars, gates SLOs, and joins client-observed
  latency (tools/loadgen.py ``--out-requests``) against these records.

Two accountings ride each record:

- ``spans``    - the request's OWN wall-clock partition (conservation
                 asserted). Concurrent requests overlap freely here: a
                 tick that decodes a batch of 8 puts "decode" time on
                 all 8 records at once.
- ``engine_s`` - engine step seconds APPORTIONED per request exactly
                 the way the serve ledger splits them (by token counts
                 within each tick; equal split of stalled ticks across
                 parked sequences). Summed over all records these
                 reconcile with the ledger's prefill / decode /
                 kv_alloc_stall buckets to float precision when no
                 record has been evicted from the ring
                 (`tools/request_trace.py --ledger` gates it).

Thread-safety: one lock; writers are the scheduler loop (marks, ticks),
`submit()` callers (arrive), and the HTTP threads (stream completion) -
same seams the scheduler already serializes. Stdlib-only; importable
without jax.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque

# The CLOSED per-request taxonomy. Order is presentation order in
# /v1/requests and tools/request_trace.py.
REQUEST_CAUSES = (
    "queue_wait",
    "admission",
    "prefill",
    "decode",
    "kv_alloc_stall",
    "preempted_wait",
    "stream_write",
)

# the subset of causes that reconcile against the serve goodput ledger
# buckets (the apportioned engine seconds; see module docstring)
ENGINE_CAUSES = ("prefill", "decode", "kv_alloc_stall")

# "migrated" = drained off this replica mid-flight (serve/fleet.py):
# terminal HERE - the request's remaining lifetime continues as a fresh
# record on the peer replica the router re-dispatched it to
TERMINAL_STATES = ("done", "cancelled", "error", "migrated")


def _tolerance(total: float) -> float:
    """The conservation tolerance, same rule as GoodputLedger.finalize."""
    return max(1e-6 * max(total, 1.0), 1e-9)


class RequestRecord:
    """One request's lifecycle: open-span state machine + counters."""

    __slots__ = (
        "req_id", "tenant", "prompt_len", "max_new_tokens",
        "t_arrival", "t_first_token", "t_terminal", "state",
        "spans", "_open_cause", "_open_t0", "_last_t",
        "tokens_emitted", "decode_ticks", "prefill_tokens",
        "replayed_ticks", "preemptions", "episodes", "engine_s", "lane",
        "draft_s", "verify_s", "proposed_tokens", "accepted_tokens",
        "router_retries", "router_retry_s",
    )

    def __init__(self, req_id, tenant, prompt_len, max_new_tokens, t, lane):
        self.req_id = int(req_id)
        self.tenant = str(tenant)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.t_arrival = float(t)
        self.t_first_token: float | None = None
        self.t_terminal: float | None = None
        self.state = "queue_wait"          # open cause; terminal later
        self.spans: list[tuple[str, float, float]] = []
        self._open_cause = "queue_wait"
        self._open_t0 = float(t)
        self._last_t = float(t)
        self.tokens_emitted = 0
        self.decode_ticks = 0
        self.prefill_tokens = 0
        self.replayed_ticks = 0
        self.preemptions = 0
        self.episodes: list[dict] = []
        self.engine_s = {c: 0.0 for c in ENGINE_CAUSES}
        self.lane = lane
        # speculative-decoding sub-attribution: draft_s + verify_s live
        # INSIDE the decode cause (they are device seconds of the decode
        # spans, not new taxonomy members - conservation is untouched)
        self.draft_s = 0.0
        self.verify_s = 0.0
        self.proposed_tokens = 0
        self.accepted_tokens = 0
        # router failover provenance (serve/fleet.py): how many times
        # the fleet router re-dispatched this request before it reached
        # this replica, and the seconds those episodes cost the client.
        # Record-level counters like the preemption ``episodes`` - NOT
        # spans, so per-request conservation (this replica's own
        # arrival -> terminal partition) is untouched
        self.router_retries = 0
        self.router_retry_s = 0.0

    # ------------------------------------------------------------- views

    @property
    def open(self) -> bool:
        return self.t_terminal is None

    def causes(self) -> dict:
        """Closed-span seconds by cause (the open span excluded)."""
        out = {c: 0.0 for c in REQUEST_CAUSES}
        for cause, t0, t1 in self.spans:
            out[cause] += t1 - t0
        return {c: v for c, v in out.items() if v > 0}

    def dominant_cause(self, now: float | None = None) -> str:
        """Largest-seconds cause; an open record counts its live span."""
        acc = {c: 0.0 for c in REQUEST_CAUSES}
        for cause, t0, t1 in self.spans:
            acc[cause] += t1 - t0
        if self.open and now is not None and now > self._open_t0:
            acc[self._open_cause] += now - self._open_t0
        best = max(acc.items(), key=lambda kv: kv[1])
        return best[0] if best[1] > 0 else self._open_cause

    def ttft_s(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival

    def e2e_s(self) -> float | None:
        if self.t_terminal is None:
            return None
        return self.t_terminal - self.t_arrival

    def acceptance_rate(self) -> float | None:
        """accepted / proposed draft tokens; None if the request never
        took a speculative step."""
        if not self.proposed_tokens:
            return None
        return self.accepted_tokens / self.proposed_tokens

    def summary(self, now: float | None = None) -> dict:
        doc = {
            "req_id": self.req_id,
            "tenant": self.tenant,
            "state": self.state,
            "tokens_emitted": self.tokens_emitted,
            "preemptions": self.preemptions,
            "dominant_cause": self.dominant_cause(now),
        }
        if self.open:
            doc["age_s"] = (
                round(now - self.t_arrival, 6) if now is not None else None
            )
        else:
            ttft, e2e = self.ttft_s(), self.e2e_s()
            doc["ttft_s"] = round(ttft, 6) if ttft is not None else None
            doc["e2e_s"] = round(e2e, 6) if e2e is not None else None
        return doc

    def detail(self, now: float | None = None) -> dict:
        """The full record: spans relative to arrival, both accountings,
        preemption episodes with replay provenance."""
        doc = self.summary(now)
        doc.update(
            prompt_len=self.prompt_len,
            max_new_tokens=self.max_new_tokens,
            decode_ticks=self.decode_ticks,
            prefill_tokens=self.prefill_tokens,
            replayed_ticks=self.replayed_ticks,
            t_first_token_rel=(
                round(self.t_first_token - self.t_arrival, 9)
                if self.t_first_token is not None else None
            ),
            spans=[
                [c, round(t0 - self.t_arrival, 9),
                 round(t1 - self.t_arrival, 9)]
                for c, t0, t1 in self.spans
            ],
            causes={c: round(v, 9) for c, v in self.causes().items()},
            engine_s={
                c: round(v, 9) for c, v in self.engine_s.items() if v > 0
            },
            episodes=list(self.episodes),
        )
        if self.proposed_tokens:
            doc.update(
                proposed_tokens=self.proposed_tokens,
                accepted_tokens=self.accepted_tokens,
                acceptance_rate=round(self.acceptance_rate(), 6),
                draft_s=round(self.draft_s, 9),
                verify_s=round(self.verify_s, 9),
            )
        if self.router_retries:
            doc["router_retry"] = {
                "episodes": self.router_retries,
                "seconds": round(self.router_retry_s, 9),
            }
        return doc


class RequestTraceRecorder:
    """Event-sources request lifecycles; bounded ring of finalized
    records; optional Chrome-trace lane emission."""

    def __init__(self, *, ring: int = 256, clock=time.monotonic,
                 tracer=None):
        self._clock = clock
        self._lock = threading.Lock()
        self._open: dict[int, RequestRecord] = {}
        self._ring: deque[RequestRecord] = deque()
        self._ring_max = max(int(ring), 1)
        self._by_id: dict[int, RequestRecord] = {}
        self._rejected: dict[str, int] = {}
        self._by_state: dict[str, int] = {}
        self.finalized_total = 0
        self.evicted_total = 0
        self._tracer = tracer if (
            tracer is not None and getattr(tracer, "enabled", False)
        ) else None
        # recorder-clock -> tracer-clock offset (both monotonic; the
        # delta is fixed at construction)
        self._trace_off = (
            self._tracer.now_s() - clock() if self._tracer else 0.0
        )
        # per-request trace lane: lowest free slot index, freed on
        # finalize - requests stack onto slot lanes like engine slots
        self._free_lanes: list[int] = []
        self._next_lane = 0

    def now(self) -> float:
        return self._clock()

    # --------------------------------------------------------- lifecycle

    def arrive(self, req_id: int, tenant: str, prompt_len: int,
               max_new_tokens: int) -> None:
        """Open a record; the queue_wait span starts now."""
        with self._lock:
            if self._free_lanes:
                lane = heapq.heappop(self._free_lanes)
            else:
                lane = self._next_lane
                self._next_lane += 1
            rec = RequestRecord(
                req_id, tenant, prompt_len, max_new_tokens,
                self._clock(), lane,
            )
            self._open[rec.req_id] = rec
            self._by_id[rec.req_id] = rec

    def note_rejected(self, reason: str) -> None:
        """An admission rejection (429) - counted, no lifecycle."""
        with self._lock:
            self._rejected[reason] = self._rejected.get(reason, 0) + 1

    def note_router_retry(self, req_id: int, episodes: int,
                          seconds: float) -> None:
        """Failover provenance from the fleet router (X-Router-Retries
        headers): this request was re-dispatched ``episodes`` times
        before arriving here, losing ``seconds`` of client-visible
        time on dead/drained replicas. Carried as record-level
        counters (like preemption episodes), never as spans - the
        lost seconds happened BEFORE this replica's arrival clock
        started, so span conservation stays exact."""
        with self._lock:
            rec = self._open.get(req_id)
            if rec is not None:
                rec.router_retries = max(int(episodes), 0)
                rec.router_retry_s = max(float(seconds), 0.0)

    def mark(self, req_id: int, cause: str) -> None:
        """Transition a request to ``cause`` now: closes the open span,
        opens the next. No-op for unknown/finalized ids and for repeated
        marks of the current cause."""
        if cause not in REQUEST_CAUSES:
            raise ValueError(
                f"unknown request cause {cause!r} "
                f"(taxonomy: {REQUEST_CAUSES})"
            )
        with self._lock:
            rec = self._open.get(req_id)
            if rec is not None:
                self._mark_locked(rec, cause)

    def note_token(self, req_id: int) -> None:
        """One NEW token streamed to the client (replay re-derivations
        never reach here - the engine drops them before emitting)."""
        with self._lock:
            rec = self._open.get(req_id)
            if rec is None:
                return
            rec.tokens_emitted += 1
            if rec.t_first_token is None:
                rec.t_first_token = self._now_locked(rec)

    def observe_step(self, stats: dict, t0: float, t1: float) -> None:
        """Digest one engine tick: per-sequence state transitions,
        tick counters, apportioned engine seconds, preempt episodes.

        ``stats`` is `ServeEngine.step`'s dict (``per_seq`` +
        ``preempted``); ``t0``/``t1`` bound the tick on the recorder's
        clock (the scheduler measures them, same as for the ledger).
        The apportioning mirrors the ledger exactly: the tick span
        splits across sequences by token counts; an all-parked tick
        splits equally across the parked sequences - so per-cause sums
        over every record equal the ledger buckets.
        """
        per = stats.get("per_seq") or {}
        if not per:
            return
        span = max(float(t1) - float(t0), 0.0)
        total_tokens = (
            stats.get("decode_tokens", 0) + stats.get("prefill_tokens", 0)
        )
        parked_n = sum(1 for d in per.values() if d.get("parked"))
        with self._lock:
            for sid, d in per.items():
                rec = self._by_id.get(sid)
                if rec is None:
                    continue
                rec.decode_ticks += d.get("decode", 0)
                rec.prefill_tokens += d.get("prefill", 0)
                rec.replayed_ticks += d.get("replayed", 0)
                rec.proposed_tokens += d.get("proposed", 0)
                rec.accepted_tokens += d.get("accepted", 0)
                rec.draft_s += d.get("draft_s", 0.0)
                rec.verify_s += d.get("verify_s", 0.0)
                if span > 0:
                    if total_tokens > 0:
                        if d.get("prefill"):
                            rec.engine_s["prefill"] += (
                                span * d["prefill"] / total_tokens
                            )
                        if d.get("decode"):
                            rec.engine_s["decode"] += (
                                span * d["decode"] / total_tokens
                            )
                    elif parked_n and d.get("parked"):
                        rec.engine_s["kv_alloc_stall"] += span / parked_n
                # state transition - but never past the engine-side
                # finish: a request already in stream_write (done mid-
                # tick via the token callback) keeps that state
                if rec.open and rec._open_cause != "stream_write":
                    if d.get("parked"):
                        self._mark_locked(rec, "kv_alloc_stall")
                    elif d.get("decode"):
                        self._mark_locked(rec, "decode")
                    elif d.get("prefill"):
                        self._mark_locked(rec, "prefill")
            for info in stats.get("preempted") or ():
                rec = self._open.get(info.get("seq_id"))
                if rec is None:
                    continue
                rec.preemptions += 1
                rec.episodes.append({
                    "t_rel": round(
                        self._now_locked(rec) - rec.t_arrival, 9
                    ),
                    "tokens_held": int(info.get("tokens_held", 0)),
                    "wait_s": None,   # filled when re-admitted
                })
                self._mark_locked(rec, "preempted_wait")

    def finalize(self, req_id: int, state: str) -> dict | None:
        """Seal a record with a terminal state; asserts conservation
        (spans partition arrival->terminal), moves it to the ring,
        emits its trace lane. Idempotent - a second finalize (e.g. the
        HTTP ack racing a cancel sweep) is a no-op returning None."""
        if state not in TERMINAL_STATES:
            raise ValueError(
                f"terminal state must be one of {TERMINAL_STATES}, "
                f"got {state!r}"
            )
        with self._lock:
            rec = self._open.pop(req_id, None)
            if rec is None:
                return None
            t = self._now_locked(rec)
            if t > rec._open_t0:
                rec.spans.append((rec._open_cause, rec._open_t0, t))
            rec.t_terminal = t
            rec.state = state
            self._assert_conserved(rec)
            self._by_state[state] = self._by_state.get(state, 0) + 1
            self.finalized_total += 1
            self._ring.append(rec)
            if len(self._ring) > self._ring_max:
                old = self._ring.popleft()
                self._by_id.pop(old.req_id, None)
                self.evicted_total += 1
            heapq.heappush(self._free_lanes, rec.lane)
            self._emit_trace(rec)
            return rec.detail()

    def finalize_all(self) -> int:
        """Shutdown sweep: seal every still-open record. A request the
        engine finished but the stream never acked counts ``done``
        (the work happened); everything else is an ``error`` (the
        server went away under it). Returns how many were sealed."""
        with self._lock:
            ids = [
                (rid, "done" if rec._open_cause == "stream_write"
                 else "error")
                for rid, rec in self._open.items()
            ]
        n = 0
        for rid, state in ids:
            if self.finalize(rid, state) is not None:
                n += 1
        return n

    # --------------------------------------------------------- queries

    def get(self, req_id: int) -> dict | None:
        """Full detail for one request (open or ringed), else None."""
        with self._lock:
            rec = self._by_id.get(req_id)
            if rec is None:
                return None
            return rec.detail(self._clock())

    def in_flight(self) -> list[dict]:
        """Open-request summaries, oldest first (the /v1/status and
        live_top 'slowest in-flight' source)."""
        with self._lock:
            now = self._clock()
            recs = sorted(self._open.values(), key=lambda r: r.t_arrival)
            return [r.summary(now) for r in recs]

    def snapshot(self, *, full: bool = False) -> dict:
        """The GET /v1/requests document."""
        with self._lock:
            now = self._clock()
            recent = [
                (r.detail() if full else r.summary()) for r in self._ring
            ]
            return {
                "taxonomy": list(REQUEST_CAUSES),
                "counts": {
                    "in_flight": len(self._open),
                    "finalized": self.finalized_total,
                    "ring": len(self._ring),
                    "evicted": self.evicted_total,
                    "by_state": dict(self._by_state),
                    "rejected": dict(self._rejected),
                },
                "in_flight": [
                    r.summary(now) for r in sorted(
                        self._open.values(), key=lambda r: r.t_arrival
                    )
                ],
                "recent": recent,
            }

    # -------------------------------------------------------- internals

    def _now_locked(self, rec: RequestRecord) -> float:
        """A timestamp that never runs backwards within one record (the
        span chain must stay contiguous even if the clock is coarse)."""
        t = max(self._clock(), rec._last_t)
        rec._last_t = t
        return t

    def _mark_locked(self, rec: RequestRecord, cause: str) -> None:
        if rec._open_cause == cause:
            return
        t = self._now_locked(rec)
        if t > rec._open_t0:
            rec.spans.append((rec._open_cause, rec._open_t0, t))
        if (
            rec._open_cause == "preempted_wait"
            and rec.episodes
            and rec.episodes[-1].get("wait_s") is None
        ):
            rec.episodes[-1]["wait_s"] = round(t - rec._open_t0, 9)
        rec._open_cause = cause
        rec._open_t0 = t
        rec.state = cause

    def _assert_conserved(self, rec: RequestRecord) -> None:
        total = rec.t_terminal - rec.t_arrival
        attributed = sum(t1 - t0 for _, t0, t1 in rec.spans)
        tol = _tolerance(total)
        ok = abs(attributed - total) <= tol
        if ok and rec.spans:
            ok = abs(rec.spans[0][1] - rec.t_arrival) <= tol and abs(
                rec.spans[-1][2] - rec.t_terminal
            ) <= tol
            for (_, _, a1), (_, b0, _) in zip(rec.spans, rec.spans[1:]):
                ok = ok and abs(b0 - a1) <= tol
        if not ok:
            raise AssertionError(
                f"request span conservation violated: req {rec.req_id} "
                f"attributed {attributed:.9f}s != lifetime {total:.9f}s "
                f"(tolerance {tol:.2e}; spans {rec.spans!r})"
            )

    def _emit_trace(self, rec: RequestRecord) -> None:
        tr = self._tracer
        if tr is None:
            return
        track = f"slot{rec.lane}"
        off = self._trace_off
        for cause, t0, t1 in rec.spans:
            tr.complete(
                cause, t0 + off, t1 + off, track=track,
                req_id=rec.req_id, tenant=rec.tenant, state=rec.state,
            )
        for ep in rec.episodes:
            tr.instant_at(
                "preempt", rec.t_arrival + ep["t_rel"] + off, track=track,
                req_id=rec.req_id, tokens_held=ep["tokens_held"],
            )


# ------------------------------------- percentile decomposition (shared)
#
# The canonical TTFT/E2E percentile decomposition over finalized request
# records - ONE implementation consumed by three readers: the fleet
# SLO readout / autoscaler (serve/fleet.py slo_readout), the offline
# report + gates (tools/request_trace.py mirrors it stdlib-side, no
# package import), and the serve-mode digital twin
# (analysis/fleetsim.py), which must decompose its SIMULATED records
# with the very arithmetic the measured ones are judged by.


def percentile(xs, q: float):
    """Nearest-rank percentile over unsorted samples (None if empty)."""
    if not xs:
        return None
    import math

    s = sorted(xs)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def clipped_causes(rec: dict, metric: str) -> dict:
    """Per-cause seconds of one record's spans, clipped at first-token
    time for ``metric="ttft"`` (unclipped for ``"e2e"``). Records that
    never produced a token have no TTFT decomposition ({})."""
    if metric == "ttft":
        hi = rec.get("t_first_token_rel")
        if hi is None:
            return {}
    else:
        hi = float("inf")
    out: dict = {}
    for cause, t0, t1 in rec.get("spans") or ():
        lo, up = float(t0), min(float(t1), hi)
        if up > lo:
            out[cause] = out.get(cause, 0.0) + (up - lo)
    return out


def decompose(records, metric: str, q: float):
    """Decompose one latency percentile by cause over the TAIL (records
    at or beyond the percentile value): ``{"value", "shares",
    "dominant"}`` or None when no record carries the metric."""
    vals = [
        (r, v) for r in records
        if (v := r.get("ttft_s" if metric == "ttft" else "e2e_s"))
        is not None
    ]
    if not vals:
        return None
    pv = percentile([v for _, v in vals], q)
    tail = [r for r, v in vals if v >= pv - 1e-12]
    acc: dict = {}
    for r in tail:
        for cause, s in clipped_causes(r, metric).items():
            acc[cause] = acc.get(cause, 0.0) + s
    total = sum(acc.values())
    shares = {c: acc[c] / total for c in acc} if total > 0 else {}
    dominant = max(shares, key=shares.get) if shares else None
    return {"value": pv, "shares": shares, "dominant": dominant}
