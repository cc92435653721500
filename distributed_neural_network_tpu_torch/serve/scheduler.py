"""Request scheduling: admission control, per-tenant fairness, the
serve loop, and the serving goodput ledger.

The port of the JAX package's `serve/scheduler.py`, host code that carries
over nearly line for line. Not ported: the graceful drain that migrates
live sequences to peer replicas (`drain()` raises; it comes with the fleet
slice).

The scheduler is the single writer of the engine: one daemon loop
thread admits requests, drives `ServeEngine.step`, and streams tokens
back through per-request queues. Everything user-facing rides three
policies:

- **Admission control**: a bounded global queue - overflow is an
  `AdmissionError` the HTTP layer turns into 429 (the load-balancer
  backoff signal), never an unbounded memory ramp. Requests that could
  never run (prompt + max_new > max_seq_len) are rejected up front
  (400), not admitted to die later.
- **Per-tenant fairness**: each API key gets its own FIFO and a token
  bucket (``tenant_rate`` requests/s, ``tenant_burst`` size - 429 when
  empty); admission drains the per-key FIFOs round-robin, so one
  chatty tenant queues behind itself, not in front of everyone else.
- **KV backpressure**: a request is only admitted when the paged pool
  has blocks for its prompt (plus ``block_headroom``); mid-flight
  exhaustion parks sequences and may preempt the youngest
  (`engine.py`) - preempted sequences re-enter at the FRONT of the
  admission order (they hold streamed state a client is watching).

**Serving ledger** (`utils/goodput.py` taxonomy "serve"): every
wall-clock second of the loop lands in exactly one bucket -

- ``decode``  (goodput)       - step time apportioned to generated
                                tokens;
- ``prefill``                 - step + chunked-prefill time apportioned
                                to prompt tokens;
- ``kv_alloc_stall``          - ticks where block exhaustion blocked
                                every runnable sequence (incl.
                                preemption work);
- ``batch_formation_idle``    - loop time spent assembling batches /
                                admitting while work existed;
- ``queue_wait``              - each request's arrival->admission
                                window, low-priority in the sweep so it
                                claims only otherwise-idle seconds
                                (capacity pressure, not double-counted
                                compute);
- ``idle_other``              - the residual (an empty server).

Conservation is asserted at `close()` (ledger.finalize), the record is
written through to ``run_record`` when configured, and
``goodput_ratio`` / ``badput_seconds_total{cause}`` export live on the
metrics registry next to the QPS/TTFT/KV-occupancy series.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..utils.goodput import GoodputLedger
from ..utils.obs import NULL_REGISTRY
from .engine import ServeEngine, Sequence
from .reqtrace import RequestTraceRecorder

# histogram buckets for TTFT / inter-token latency: 1 ms .. 60 s
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class AdmissionError(Exception):
    """Rejection with an HTTP status: 429 (queue full / rate limited)
    or 400 (a request that could never run)."""

    def __init__(self, status: int, reason: str, message: str):
        self.status = status
        self.reason = reason
        super().__init__(message)


@dataclass
class ServeRequest:
    """One client request + its streaming channel. The HTTP layer (or a
    test) reads ``events`` - a queue of ``("token", id)``,
    ``("done", summary)``, ``("error", message)`` tuples - and sets
    ``cancelled`` on client disconnect."""

    prompt: list
    max_new_tokens: int
    api_key: str = "anonymous"
    temperature: float = 0.0
    seed: int = 0
    # fleet-router failover provenance (X-Router-Retries headers):
    # re-dispatch episode count + client-visible seconds lost before
    # this replica saw the request (serve/reqtrace.py router_retry)
    router_retries: int = 0
    router_retry_s: float = 0.0
    req_id: int = 0
    t_arrival: float = 0.0
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    status: str = "new"
    tokens: list = field(default_factory=list)
    events: object = None       # queue.Queue, created by submit()
    cancelled: threading.Event = field(default_factory=threading.Event)
    # True when a streaming channel (the HTTP layer) owns the tail of
    # the request's lifecycle: the per-request trace record then stays
    # open in ``stream_write`` until `finish_stream` acks the flush
    stream_owner: bool = False
    _seq: object = None
    _t_arrival_ledger: float = 0.0
    _t_prev_token: float | None = None

    def summary(self) -> dict:
        return {
            "req_id": self.req_id,
            "status": self.status,
            "prompt_len": len(self.prompt),
            "tokens": list(self.tokens),
            "n_tokens": len(self.tokens),
            "ttft_s": (
                round(self.t_first_token - self.t_arrival, 6)
                if self.t_first_token is not None else None
            ),
            "total_s": (
                round(self.t_done - self.t_arrival, 6)
                if self.t_done is not None else None
            ),
        }


@dataclass(frozen=True)
class SchedulerConfig:
    max_queue: int = 64          # global bound -> 429 on overflow
    tenant_rate: float = 0.0     # requests/s per API key (0 = unlimited)
    tenant_burst: int = 8        # token-bucket size per API key
    block_headroom: int = 0      # extra free blocks required to admit
    idle_poll_s: float = 0.02    # loop wakeup when completely idle
    run_record: str | None = None  # serving goodput record path
    request_ring: int = 256      # finalized per-request records kept


class _TokenBucket:
    """Per-tenant request-rate limiter (refill-on-read)."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = max(int(burst), 1)
        self.level = float(self.burst)
        self.t_last = time.monotonic()

    def try_take(self) -> bool:
        now = time.monotonic()
        self.level = min(
            self.burst, self.level + (now - self.t_last) * self.rate
        )
        self.t_last = now
        if self.level >= 1.0:
            self.level -= 1.0
            return True
        return False


class ServeScheduler:
    """Owns the engine + queues; `start()` spawns the loop thread."""

    def __init__(
        self,
        engine: ServeEngine,
        cfg: SchedulerConfig | None = None,
        *,
        registry=NULL_REGISTRY,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._tenants: dict[str, deque] = {}
        self._tenant_order: deque = deque()
        self._buckets: dict[str, _TokenBucket] = {}
        self._queued = 0
        self._by_seq: dict[int, ServeRequest] = {}
        self._ids = itertools.count(1)
        self._running = False
        self._thread: threading.Thread | None = None
        self.ledger = GoodputLedger(taxonomy="serve", clock=clock)
        self.ledger.start()
        # per-request lifecycle records on the ledger's clock, so the
        # two accountings reconcile (tools/request_trace.py --ledger)
        self.reqtrace = RequestTraceRecorder(
            ring=self.cfg.request_ring, clock=self.ledger.now,
        )
        if self.cfg.run_record:
            self.ledger.arm(self.cfg.run_record)
        self.ledger.describe(
            config={
                "engine": {
                    "max_batch": engine.ecfg.max_batch,
                    "num_blocks": engine.ecfg.num_blocks,
                    "block_size": engine.ecfg.block_size,
                    "max_seq_len": engine.ecfg.max_seq_len,
                    "prefill_chunk": engine.ecfg.prefill_chunk,
                    "kv_dtype": engine.ecfg.kv_dtype,
                    "weight_dtype": engine.ecfg.weight_dtype,
                    "spec_decode": engine.ecfg.spec_decode,
                    "spec_draft_layers": (
                        engine.draft_layers if engine.spec_k else 0
                    ),
                },
                "scheduler": {
                    "max_queue": self.cfg.max_queue,
                    "tenant_rate": self.cfg.tenant_rate,
                    "tenant_burst": self.cfg.tenant_burst,
                },
            },
        )
        # ---- metrics (resolved once; the publish path is lock-free)
        r = registry
        self._m_requests = r.counter(
            "serve_requests_total",
            "Requests by terminal status (serve/scheduler.py)",
        )
        self._m_rejected = r.counter(
            "serve_rejected_total", "Admission rejections by reason"
        )
        self._m_tokens = r.counter(
            "serve_tokens_total", "Tokens processed, by kind"
        )
        self._m_queue = r.gauge("serve_queue_depth", "Queued requests")
        self._m_active = r.gauge(
            "serve_active_sequences", "Sequences in the decode batch"
        )
        self._m_kv_used = r.gauge(
            "serve_kv_blocks_in_use", "Paged-KV blocks allocated"
        )
        self._m_kv_total = r.gauge(
            "serve_kv_blocks_total", "Paged-KV usable block count"
        )
        self._m_kv_total.set(engine.kv.cfg.usable_blocks)
        # occupancy in the bytes the pool ACTUALLY allocates (int8 KV
        # halves them; analysis/cost.py kv_block_bytes incl. scales) +
        # the effective concurrent-sequence capacity at max_seq_len -
        # the number an operator can compare across kv dtypes, unlike a
        # raw block count whose byte value silently changed
        from ..analysis.cost import kv_capacity_sequences

        self._kv_block_bytes = engine.kv_block_bytes()
        self._m_kv_dtype = r.gauge(
            "serve_kv_dtype",
            "KV-pool storage dtype (1 at the active label)",
        )
        self._m_kv_dtype.labels(dtype=engine.kv_dtype_name()).set(1)
        self._m_kv_bytes_used = r.gauge(
            "serve_kv_bytes_in_use",
            "Allocated paged-KV bytes at the pool dtype (incl. scales)",
        )
        self._m_kv_bytes_total = r.gauge(
            "serve_kv_bytes_total",
            "Usable paged-KV pool bytes at the pool dtype (incl. scales)",
        )
        self._m_kv_bytes_total.set(
            engine.kv.cfg.usable_blocks * self._kv_block_bytes
        )
        self._m_kv_capacity = r.gauge(
            "serve_kv_capacity_sequences",
            "Concurrent max_seq_len sequences the pool holds",
        )
        self._m_kv_capacity.set(kv_capacity_sequences(
            engine.kv.cfg.usable_blocks, engine.ecfg.block_size,
            engine.ecfg.max_seq_len,
        ))
        self._m_ttft = r.histogram(
            "serve_ttft_seconds", "Time to first token",
            buckets=LATENCY_BUCKETS,
        )
        self._m_intertoken = r.histogram(
            "serve_intertoken_seconds", "Gap between streamed tokens",
            buckets=LATENCY_BUCKETS,
        )
        self._m_preempt = r.counter(
            "serve_preemptions_total", "Sequences preempted on KV pressure"
        )
        self._m_steps = r.counter(
            "serve_engine_steps_total", "Engine decode steps executed"
        )
        # speculative decoding: proposed/accepted draft tokens plus a
        # per-slot-step acceptance histogram (integer buckets 0..k -
        # "how many of this step's k drafts survived verification")
        self._m_spec_proposed = r.counter(
            "serve_spec_proposed_tokens_total",
            "Draft tokens proposed by the speculative drafter",
        )
        self._m_spec_accepted = r.counter(
            "serve_spec_accepted_tokens_total",
            "Draft tokens accepted by target-model verification",
        )
        spec_k = max(int(getattr(engine, "spec_k", 0)), 1)
        self._m_spec_accept_hist = r.histogram(
            "serve_spec_accepted_per_step",
            "Accepted draft tokens per speculative slot-step",
            buckets=tuple(float(i) for i in range(spec_k)),
        )
        if r is not NULL_REGISTRY:
            self.ledger.publish(r)

    # --------------------------------------------------------- admission

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Admit a request to the queue (any thread). Raises
        `AdmissionError` (429/400/503); on success the request will
        stream through ``req.events``."""
        ecfg = self.engine.ecfg
        if not req.prompt:
            raise AdmissionError(400, "empty_prompt", "empty prompt")
        total = len(req.prompt) + req.max_new_tokens
        if req.max_new_tokens < 1:
            raise AdmissionError(
                400, "bad_max_new_tokens",
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}",
            )
        if total > ecfg.max_seq_len:
            raise AdmissionError(
                400, "too_long",
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} = {total} exceeds max_seq_len "
                f"{ecfg.max_seq_len}",
            )
        vmax = self.engine.cfg.vocab_size
        if any(not (0 <= int(t) < vmax) for t in req.prompt):
            raise AdmissionError(
                400, "bad_token",
                f"prompt token out of range [0, {vmax})",
            )
        if self.cfg.tenant_rate > 0:
            with self._lock:
                bucket = self._buckets.get(req.api_key)
                if bucket is None:
                    bucket = self._buckets[req.api_key] = _TokenBucket(
                        self.cfg.tenant_rate, self.cfg.tenant_burst
                    )
            if not bucket.try_take():
                self._m_rejected.labels(reason="rate_limited").inc()
                self.reqtrace.note_rejected("rate_limited")
                raise AdmissionError(
                    429, "rate_limited",
                    f"tenant {req.api_key!r} over "
                    f"{self.cfg.tenant_rate:g} req/s "
                    f"(burst {self.cfg.tenant_burst})",
                )
        with self._work:
            if self._queued >= self.cfg.max_queue:
                self._m_rejected.labels(reason="queue_full").inc()
                self.reqtrace.note_rejected("queue_full")
                raise AdmissionError(
                    429, "queue_full",
                    f"admission queue full ({self.cfg.max_queue})",
                )
            req.req_id = next(self._ids)
            req.t_arrival = time.monotonic()
            req._t_arrival_ledger = self.ledger.now()
            req.events = queue_mod.Queue()
            req.status = "queued"
            self.reqtrace.arrive(
                req.req_id, req.api_key, len(req.prompt),
                req.max_new_tokens,
            )
            if req.router_retries:
                self.reqtrace.note_router_retry(
                    req.req_id, req.router_retries, req.router_retry_s
                )
            fifo = self._tenants.get(req.api_key)
            if fifo is None:
                fifo = self._tenants[req.api_key] = deque()
                self._tenant_order.append(req.api_key)
            fifo.append(req)
            self._queued += 1
            self._m_queue.set(self._queued)
            self._m_requests.labels(status="accepted").inc()
            self._work.notify()
        return req

    def cancel(self, req: ServeRequest) -> None:
        """Client-side cancel (disconnect): flagged here, enacted by the
        loop at the next step boundary."""
        req.cancelled.set()
        with self._work:
            self._work.notify()

    def finish_stream(self, req: ServeRequest) -> None:
        """Streaming-channel ack (any thread): the owner finished
        writing the request's tail, so its trace record's
        ``stream_write`` span closes and the record seals. Only acts on
        a request already at a terminal status - a mid-flight stream
        error stays with the loop (cancel / shutdown paths)."""
        if req.req_id and req.status in (
            "done", "cancelled", "error", "migrated"
        ):
            self.reqtrace.finalize(
                req.req_id, req.status  # idempotent vs the loop's seal
            )

    # ------------------------------------------------------------- loop

    def start(self) -> "ServeScheduler":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="serve-scheduler", daemon=True
        )
        self._thread.start()
        return self

    def close(self, *, finalize: bool = True) -> dict | None:
        """Stop the loop, fail queued/active requests, finalize the
        serving ledger (conservation asserted) and return the record."""
        self._running = False
        with self._work:
            self._work.notify()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # drain every remaining request with a shutdown error
        with self._work:
            pending = [r for f in self._tenants.values() for r in f]
            for f in self._tenants.values():
                f.clear()
            self._queued = 0
            self._m_queue.set(0)
        for req in pending + list(self._by_seq.values()):
            if req.status not in ("done", "cancelled", "error", "migrated"):
                req.status = "error"
                if req.events is not None:
                    req.events.put(("error", "server shutting down"))
        self.reqtrace.finalize_all()
        if finalize:
            return self.ledger.finalize()
        return None

    # ------------------------------------------------------------ drain

    @property
    def draining(self) -> bool:
        return False

    def drain(self, timeout: float = 30.0) -> dict:
        """Migrating live sequences to peer replicas comes with the fleet
        slice of the port (serve/fleet.py)."""
        raise NotImplementedError(
            "drain/migration comes with the fleet slice of the port (serve/fleet.py)"
        )

    def _next_request(self):
        """Round-robin over tenant FIFOs (caller holds the lock)."""
        for _ in range(len(self._tenant_order)):
            key = self._tenant_order[0]
            self._tenant_order.rotate(-1)
            fifo = self._tenants.get(key)
            if fifo:
                self._queued -= 1
                return fifo.popleft()
        return None

    def _admit_one(self, req: ServeRequest) -> None:
        """Wire a queued request into the engine (loop thread)."""
        if req.cancelled.is_set():
            req.status = "cancelled"
            req.t_done = time.monotonic()
            self._m_requests.labels(status="cancelled").inc()
            self.reqtrace.finalize(req.req_id, "cancelled")
            if req.events is not None:
                req.events.put(("done", req.summary()))
            return
        self.reqtrace.mark(req.req_id, "admission")
        seq = Sequence(
            seq_id=req.req_id,
            prompt=[int(t) for t in req.prompt],
            max_new_tokens=int(req.max_new_tokens),
            temperature=float(req.temperature),
            seed=int(req.seed),
            on_token=self._on_token,
        )
        req._seq = seq
        self._by_seq[seq.seq_id] = req
        self.engine.add(seq)
        req.t_admitted = time.monotonic()
        req.status = "active"
        self.reqtrace.mark(req.req_id, "prefill")
        # the request's whole queued window, attributed once the sweep
        # resolves overlaps (it only claims otherwise-idle seconds)
        self.ledger.add(
            "queue_wait", req._t_arrival_ledger, self.ledger.now()
        )

    def _on_token(self, seq: Sequence, tok: int, done: bool) -> None:
        """Engine callback (loop thread): stream + latency metrics."""
        req = self._by_seq.get(seq.seq_id)
        if req is None:
            return
        now = time.monotonic()
        req.tokens.append(int(tok))
        self.reqtrace.note_token(seq.seq_id)
        if req.t_first_token is None:
            req.t_first_token = now
            self._m_ttft.observe(now - req.t_arrival)
        elif req._t_prev_token is not None:
            self._m_intertoken.observe(now - req._t_prev_token)
        req._t_prev_token = now
        if req.events is not None:
            req.events.put(("token", int(tok)))
        if done:
            req.status = "done"
            req.t_done = now
            self._m_requests.labels(status="completed").inc()
            self._by_seq.pop(seq.seq_id, None)
            # the stream_write window opens BEFORE the done event is
            # visible to the streaming thread; with no stream owner the
            # record seals immediately (zero-length flush)
            self.reqtrace.mark(seq.seq_id, "stream_write")
            if not req.stream_owner:
                self.reqtrace.finalize(seq.seq_id, "done")
            if req.events is not None:
                req.events.put(("done", req.summary()))

    def _enact_cancels(self) -> None:
        for sid, req in list(self._by_seq.items()):
            if req.cancelled.is_set() and req.status == "active":
                self.engine.cancel(sid)
                self._by_seq.pop(sid, None)
                req.status = "cancelled"
                req.t_done = time.monotonic()
                self._m_requests.labels(status="cancelled").inc()
                self.reqtrace.finalize(sid, "cancelled")
                if req.events is not None:
                    req.events.put(("done", req.summary()))
        # preempted sequences whose request was cancelled while parked
        self.engine.preempted = deque(
            s for s in self.engine.preempted
            if self._by_seq.get(s.seq_id) is not None
        )

    def _loop(self) -> None:
        eng = self.engine
        kv = eng.kv
        cfg = self.cfg
        while self._running:
            with self._work:
                have_queued = self._queued > 0
            if not have_queued and not eng.has_work() and not eng.preempted:
                with self._work:
                    self._work.wait(timeout=cfg.idle_poll_s)
                continue

            t_form0 = self.ledger.now()
            self._enact_cancels()
            # re-admit preempted sequences first (streamed state)
            while eng.preempted and len(eng.active) < eng.ecfg.max_batch:
                s = eng.preempted[0]
                if not kv.can_fit(s.prompt_len + 1):
                    break
                eng.preempted.popleft()
                eng.add(s)
                # replay starts at pos 0: back to prefill until the
                # engine re-derives the held tokens
                self.reqtrace.mark(s.seq_id, "prefill")
            # admit new requests round-robin while capacity lasts
            while len(eng.active) < eng.ecfg.max_batch:
                with self._work:
                    nxt = self._next_request() if self._queued > 0 else None
                    if nxt is not None:
                        self._m_queue.set(self._queued)
                if nxt is None:
                    break
                need = kv.cfg.blocks_for_tokens(len(nxt.prompt) + 1)
                if need + cfg.block_headroom > kv.free_blocks:
                    # no room for this prompt yet: back to the head of
                    # its tenant FIFO (it keeps its place; 429 pressure
                    # builds behind the queue bound), stop admitting
                    with self._work:
                        self._tenants[nxt.api_key].appendleft(nxt)
                        self._queued += 1
                        self._m_queue.set(self._queued)
                    break
                self._admit_one(nxt)
            t_form1 = self.ledger.now()
            if t_form1 > t_form0:
                self.ledger.add("batch_formation_idle", t_form0, t_form1)

            if not eng.has_work():
                continue
            preempted_before = len(eng.preempted)
            t0 = self.ledger.now()
            stats = eng.step()
            t1 = self.ledger.now()
            self._m_steps.inc()
            self.reqtrace.observe_step(stats, t0, t1)
            if len(eng.preempted) > preempted_before:
                self._m_preempt.inc(len(eng.preempted) - preempted_before)
            spec = stats.get("spec")
            if spec:
                if spec["proposed"]:
                    self._m_spec_proposed.inc(spec["proposed"])
                if spec["accepted"]:
                    self._m_spec_accepted.inc(spec["accepted"])
                for a in spec.get("per_slot", ()):
                    self._m_spec_accept_hist.observe(float(a))
            dec, pre = stats["decode_tokens"], stats["prefill_tokens"]
            span = t1 - t0
            if dec + pre > 0 and span > 0:
                # one fenced step span, apportioned to the two phases by
                # token counts - prefill and decode genuinely share the
                # batch (token-level continuous batching), so the split
                # is the honest per-phase cost
                t_split = t0 + span * (pre / (dec + pre))
                if pre > 0:
                    self.ledger.add("prefill", t0, t_split)
                if dec > 0:
                    self.ledger.add("decode", t_split, t1)
                self._m_tokens.labels(kind="prefill").inc(pre)
                self._m_tokens.labels(kind="decode").inc(dec)
                self.ledger.note_steps(1, tokens=float(dec))
            elif span > 0:
                # a tick that moved nothing: block exhaustion (possibly
                # including preemption work)
                self.ledger.add("kv_alloc_stall", t0, t1)
            self._m_active.set(len(eng.active))
            self._m_kv_used.set(kv.blocks_in_use)
            self._m_kv_bytes_used.set(
                kv.blocks_in_use * self._kv_block_bytes
            )
            self.ledger.maybe_publish()
            self.ledger.maybe_write()
            self.registry.beat(eng.ticks)
            if not self.registry.ready and eng.ticks > 0:
                self.registry.mark_ready()
