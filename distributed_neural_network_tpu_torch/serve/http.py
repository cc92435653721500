"""HTTP face of the serving stack + the `python -m
distributed_neural_network_tpu_torch.serve` CLI.

The port of the JAX package's `serve/http.py`. One `utils/obs.py ObsServer`
carries ``/metrics`` and ``/healthz`` plus the serving routes:

- ``POST /v1/generate`` - body ``{"prompt": [int, ...] | "text": str,
  "max_new_tokens": N, "temperature": t, "seed": s, "stream": bool,
  "api_key": k}`` (the key may also ride the ``X-API-Key`` header). With
  ``stream`` (default true) the response is server-sent events: one
  ``data: {"token": id}`` frame per generated token, then ``data:
  {"done": true, ...summary}``. A client disconnect mid-stream cancels the
  request at the next step boundary. Without ``stream``, one JSON body after
  completion. Admission rejections map to 429 (with ``Retry-After``) and
  400.
- ``GET /v1/status`` - one JSON snapshot (active/queued/KV occupancy).
- ``GET /v1/requests`` - the per-request lifecycle records
  (``?full=1`` with spans, ``?id=N`` for one request).

The CLI builds a seeded-random model (`models/transformer.py init_params`;
the port's stream, not the JAX package's, so `tools/loadgen.py
--check-oracle` does not apply to a port server), runs it on ``--device``
(cuda by default), prints the bound URL, and on SIGTERM/SIGINT finalizes
the serving goodput ledger before printing a ``SERVE_SUMMARY`` JSON line.
`build_server(argv)` builds the same stack without serving forever.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from urllib.parse import parse_qs, urlsplit

import torch

from ..device import resolve_device
from ..models.transformer import TransformerConfig, init_params
from ..utils.obs import MetricsRegistry, ObsServer
from .engine import EngineConfig, ServeEngine
from .scheduler import (
    AdmissionError,
    SchedulerConfig,
    ServeRequest,
    ServeScheduler,
)

# how long a streaming reader waits on the next token before declaring
# the stream wedged (a generous multiple of any sane step time)
STREAM_TIMEOUT_S = 300.0


def _json_response(handler, code: int, doc: dict,
                   extra_headers=()) -> None:
    body = (json.dumps(doc) + "\n").encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    for k, v in extra_headers:
        handler.send_header(k, v)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class ServeServer:
    """The scheduler behind an ObsServer with /v1/* routes mounted."""

    def __init__(
        self,
        scheduler: ServeScheduler,
        registry: MetricsRegistry,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        replica_id: str | None = None,
    ):
        self.scheduler = scheduler
        self.registry = registry
        self.replica_id = replica_id
        self.obs = ObsServer(
            registry,
            port=port,
            host=host,
            routes={
                ("POST", "/v1/generate"): self._generate,
                ("GET", "/v1/status"): self._status,
                ("GET", "/v1/requests"): self._requests,
            },
        )
        self.port = self.obs.port
        self.url = self.obs.url

    def close(self) -> None:
        self.obs.close()

    # ------------------------------------------------------------ routes

    def _status(self, handler) -> None:
        eng = self.scheduler.engine
        blk_bytes = eng.kv_block_bytes()
        _json_response(handler, 200, {
            "replica": self.replica_id,
            "draining": self.scheduler.draining,
            "active_sequences": len(eng.active),
            "queued": self.scheduler._queued,
            "kv_blocks_in_use": eng.kv.blocks_in_use,
            "kv_blocks_total": eng.kv.cfg.usable_blocks,
            "kv_utilization": round(eng.kv.utilization(), 4),
            "kv_dtype": eng.kv_dtype_name(),
            "kv_bytes_in_use": eng.kv.blocks_in_use * blk_bytes,
            "kv_bytes_total": eng.kv.cfg.usable_blocks * blk_bytes,
            "engine_ticks": eng.ticks,
            "decode_tokens": eng.decode_tokens,
            "prefill_tokens": eng.prefill_tokens,
            # per-bucket-family compiled-program counts: reconcile a
            # live deployment against its servelint grid manifest
            # (after warmup() the counts match the manifest and must
            # never grow - analysis/serve_trace.py)
            "compiled_programs": eng.compiled_programs(),
            "weight_dtype": eng.weight_dtype_name(),
            "spec_decode": eng.spec_k,
            "spec_draft_layers": eng.draft_layers if eng.spec_k else 0,
            "spec_proposed_tokens": eng.spec_proposed_tokens,
            "spec_accepted_tokens": eng.spec_accepted_tokens,
            "spec_steps": eng.spec_steps,
            "spec_acceptance_rate": (
                round(eng.spec_accepted_tokens
                      / eng.spec_proposed_tokens, 4)
                if eng.spec_proposed_tokens else None
            ),
            "requests": self.scheduler.reqtrace.in_flight(),
            "requests_finalized":
                self.scheduler.reqtrace.finalized_total,
        })

    def _requests(self, handler) -> None:
        # the route table keys on the query-stripped path; the raw
        # request line still carries ?id= / ?full=
        qs = parse_qs(urlsplit(handler.path).query)
        rid = qs.get("id", [None])[0]
        if rid is not None:
            try:
                rid = int(rid)
            except ValueError:
                _json_response(
                    handler, 400, {"error": "id must be an integer"}
                )
                return
            doc = self.scheduler.reqtrace.get(rid)
            if doc is None:
                _json_response(handler, 404, {
                    "error": f"request {rid} not found "
                    "(never seen, or evicted from the ring)",
                })
            else:
                _json_response(handler, 200, {"request": doc})
            return
        full = qs.get("full", ["0"])[0] not in ("0", "", "false")
        _json_response(
            handler, 200, self.scheduler.reqtrace.snapshot(full=full)
        )

    def _parse_request(self, handler):
        try:
            n = int(handler.headers.get("Content-Length") or 0)
        except ValueError:
            n = 0
        try:
            body = json.loads(handler.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            raise AdmissionError(400, "bad_json", f"invalid JSON body: {e}")
        is_text = False
        prompt = body.get("prompt")
        if prompt is None and isinstance(body.get("text"), str):
            vocab = self.scheduler.engine.cfg.vocab_size
            if vocab < 256:
                raise AdmissionError(
                    400, "no_text_tokens",
                    f"text prompts are byte-tokenized and need "
                    f"vocab_size >= 256 (model has {vocab}); send "
                    "integer 'prompt' tokens instead",
                )
            prompt = list(body["text"].encode())
            is_text = True
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt
        ):
            raise AdmissionError(
                400, "bad_prompt",
                "body needs 'prompt': [int token ids] or 'text': str",
            )
        api_key = (
            handler.headers.get("X-API-Key")
            or body.get("api_key")
            or "anonymous"
        )
        # fleet-router failover provenance (serve/fleet.py re-dispatch)
        try:
            retries = int(handler.headers.get("X-Router-Retries") or 0)
            retry_s = float(
                handler.headers.get("X-Router-Retry-Seconds") or 0.0
            )
        except ValueError:
            retries, retry_s = 0, 0.0
        req = ServeRequest(
            prompt=prompt,
            max_new_tokens=int(body.get("max_new_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            seed=int(body.get("seed", 0)),
            api_key=str(api_key),
            router_retries=retries,
            router_retry_s=retry_s,
            stream_owner=True,  # this handler acks the stream tail
        )
        return req, bool(body.get("stream", True)), is_text

    def _generate(self, handler) -> None:
        try:
            req, stream, is_text = self._parse_request(handler)
            self.scheduler.submit(req)
        except AdmissionError as e:
            extra = (
                (("Retry-After", "1"),) if e.status == 429 else ()
            )
            _json_response(handler, e.status, {
                "error": str(e), "reason": e.reason,
            }, extra)
            return
        if stream:
            self._stream_response(handler, req, is_text)
        else:
            self._block_response(handler, req, is_text)

    def _drain(self, req):
        """Yield events until done/error/timeout (generator)."""
        import queue as queue_mod

        while True:
            try:
                kind, payload = req.events.get(timeout=STREAM_TIMEOUT_S)
            except queue_mod.Empty:
                yield "error", "stream timeout"
                return
            yield kind, payload
            if kind in ("done", "error"):
                return

    def _summary_doc(self, req, is_text) -> dict:
        doc = req.summary()
        if self.replica_id is not None:
            doc["replica"] = self.replica_id
        if is_text:
            doc["text"] = bytes(
                t for t in req.tokens if 0 <= t < 256
            ).decode("utf-8", "replace")
        return doc

    def _stream_response(self, handler, req, is_text) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-store")
        handler.send_header("Connection", "close")
        handler.end_headers()
        try:
            for kind, payload in self._drain(req):
                if kind == "token":
                    frame = {"token": payload}
                elif kind == "done":
                    frame = dict(self._summary_doc(req, is_text))
                    frame["done"] = True
                else:
                    frame = {"error": payload}
                handler.wfile.write(
                    f"data: {json.dumps(frame)}\n\n".encode()
                )
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream: free its slot + KV blocks
            self.scheduler.cancel(req)
        finally:
            # seals the trace record's stream_write span (no-op unless
            # the request already reached a terminal status - a wedged
            # stream stays with the loop's cancel/shutdown paths)
            self.scheduler.finish_stream(req)

    def _block_response(self, handler, req, is_text) -> None:
        last_err = None
        for kind, payload in self._drain(req):
            if kind == "error":
                last_err = payload
        try:
            if last_err is not None and req.status != "done":
                _json_response(handler, 500, {"error": last_err})
                return
            _json_response(handler, 200, self._summary_doc(req, is_text))
        finally:
            self.scheduler.finish_stream(req)


# ----------------------------------------------------------------- CLI


def build_model(args, device):
    """Seeded-random model from CLI geometry, on ``device``."""
    cfg = TransformerConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_layers=args.n_layers,
        d_ff=args.d_ff,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
    )
    return init_params(args.seed, cfg, device), cfg


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model-geometry flags (the JAX server's)."""
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--seed", type=int, default=0,
                   help="init_params seed (the oracle contract)")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_neural_network_tpu_torch.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--port", type=int, default=8000,
                   help="0 = ephemeral (the bound URL is printed)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    add_model_args(p)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--num-blocks", type=int, default=128)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--prefill-chunk", type=int, default=1,
                   help="prompt tokens per chunked-prefill call (1 = "
                   "exact token-at-a-time prefill)")
    p.add_argument("--precision", default="bf16",
                   help="comma-separated set from {bf16, int8-kv, int8-w}: "
                   "'int8-kv' stores the paged KV pool as int8 codes with "
                   "per-(block, head) f32 scales; 'int8-w' comes with a "
                   "later slice")
    p.add_argument("--spec-decode", type=int, default=0, metavar="K",
                   help="speculative decoding (a later slice; 0 = off)")
    p.add_argument("--spec-draft-layers", type=int, default=0, metavar="E")
    p.add_argument("--decode-impl", choices=("auto", "torch", "cuda"),
                   default="auto",
                   help="decode attention: 'cuda' = the hand-written "
                   "kernel (csrc/decode_attention.cu), 'torch' = its plain "
                   "PyTorch version, 'auto' = cuda on a CUDA device, torch "
                   "on the CPU (the JAX server's pallas / xla / auto)")
    p.add_argument("--eos-token", type=int, default=None)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--tenant-rate", type=float, default=0.0,
                   help="per-API-key token-bucket rate (req/s; 0 = off)")
    p.add_argument("--tenant-burst", type=int, default=8)
    p.add_argument("--run-record",
                   default=os.environ.get("DNN_TPU_RUN_RECORD"),
                   help="write the serving goodput record here (default "
                   "$DNN_TPU_RUN_RECORD)")
    p.add_argument("--trace-out", default=None,
                   help="Chrome trace of request lanes (a later slice)")
    p.add_argument("--request-ring", type=int, default=256,
                   help="finalized per-request records kept for "
                   "GET /v1/requests")
    p.add_argument("--warmup", action="store_true",
                   help="capture every (batch, width) bucket's CUDA graph "
                   "(on the CPU: run it once) before binding the port, so "
                   "no capture, kernel build or library set-up lands on a "
                   "request")
    p.add_argument("--replica-id",
                   default=os.environ.get("DNN_TPU_REPLICA_ID"),
                   help="replica identity stamped on summaries and "
                   "/v1/status (default $DNN_TPU_REPLICA_ID)")
    p.add_argument("--heartbeat-file", default=None,
                   help="liveness heartbeat for fleet discovery (the "
                   "fleet slice)")
    return p


def build_server(argv=None, *, log=print):
    """Parse ``argv`` as `main` does and build the serving stack: the
    seeded model on ``--device``, the engine (warmed up under
    ``--warmup``), the scheduler loop (started) and the HTTP server
    (bound). Returns ``(server, scheduler, engine)``; the caller closes
    ``scheduler`` then ``server``."""
    p = _parser()
    args = p.parse_args(argv)
    precision = {s.strip() for s in args.precision.split(",") if s.strip()}
    bad = precision - {"bf16", "int8-kv", "int8-w"}
    if bad:
        p.error(f"--precision: unknown mode(s) {sorted(bad)} "
                "(choose from bf16, int8-kv, int8-w)")
    later = "a later slice of the port (ROADMAP.md)"
    if "int8-w" in precision:
        raise NotImplementedError(f"--precision int8-w (int8 weights) comes with {later}")
    if args.spec_decode:
        raise NotImplementedError(f"--spec-decode comes with {later}")
    if args.trace_out:
        raise NotImplementedError(f"--trace-out comes with {later} (utils/tracing.py)")
    if args.heartbeat_file:
        raise NotImplementedError(f"--heartbeat-file comes with the fleet slice, {later}")

    device = resolve_device(args.device)
    params, cfg = build_model(args, device)
    engine = ServeEngine(params, cfg, EngineConfig(
        max_batch=args.max_batch,
        num_blocks=args.num_blocks,
        block_size=args.block_size,
        max_seq_len=args.max_seq_len,
        prefill_chunk=args.prefill_chunk,
        eos_token=args.eos_token,
        kv_dtype="int8" if "int8-kv" in precision else "bf16",
        decode_impl=args.decode_impl,
        spec_draft_layers=args.spec_draft_layers,
    ))
    if args.warmup:
        n = engine.warmup()
        log(f"(warmup: {n} bucket programs {'captured' if engine._capture else 'run'})")
    registry = MetricsRegistry()
    scheduler = ServeScheduler(
        engine,
        SchedulerConfig(
            max_queue=args.max_queue,
            tenant_rate=args.tenant_rate,
            tenant_burst=args.tenant_burst,
            run_record=args.run_record,
            request_ring=args.request_ring,
        ),
        registry=registry,
    ).start()
    server = ServeServer(
        scheduler, registry, port=args.port, host=args.host,
        replica_id=args.replica_id,
    )
    log(
        f"serving on {server.url} "
        f"(model d{args.d_model}/L{args.n_layers}/H{args.n_heads} "
        f"vocab {args.vocab} seed {args.seed} on {device}; "
        f"{engine.kv.cfg.usable_blocks} KV blocks x "
        f"{args.block_size} tokens [{engine.kv_dtype_name()}, "
        f"{engine.kv_block_bytes():,} B/block]; decode attention "
        f"{engine.attn_route}; endpoints: "
        "POST /v1/generate, GET /v1/status, GET /v1/requests, "
        "/metrics, /healthz)"
    )
    return server, scheduler, engine


def main(argv=None) -> int:
    server, scheduler, engine = build_server(
        argv, log=lambda line: print(line, flush=True))
    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    while not stop.wait(0.2):
        pass
    record = scheduler.close()
    server.close()
    print("SERVE_SUMMARY " + json.dumps({
        "requests_completed": int(
            server.registry.counter("serve_requests_total")
            .labels(status="completed").value
        ),
        "decode_tokens": engine.decode_tokens,
        "prefill_tokens": engine.prefill_tokens,
        "goodput_ratio": record.get("goodput_ratio") if record else None,
        "run_record": scheduler.cfg.run_record,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
