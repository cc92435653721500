"""The LM inference service, ported from the JAX package's `serve/`:
continuous batching over a paged KV cache, streamed over HTTP.

- `kv_cache.py`  - the block/paged KV-cache allocator (a copy);
- `engine.py`    - the model-executing engine: one decode step per tick over
  a (batch, table-width) bucket, chunked prefill, int8 KV, preemption; its
  decode attention is the CUDA kernel of `ops/decode_attention.py`;
- `scheduler.py` - admission control (429s), per-tenant fairness, the serve
  loop and the serving goodput ledger;
- `reqtrace.py`  - per-request lifecycle records;
- `http.py`      - `POST /v1/generate` (SSE or blocking), `GET /v1/status`,
  `GET /v1/requests`, `/metrics`, `/healthz`, and the `python -m
  distributed_neural_network_tpu_torch.serve` CLI.
"""

from .engine import EngineConfig, Sequence, ServeEngine  # noqa: F401
from .kv_cache import KVCacheConfig, OutOfBlocks, PagedKVCache  # noqa: F401
from .reqtrace import REQUEST_CAUSES, RequestRecord, RequestTraceRecorder  # noqa: F401
from .scheduler import (  # noqa: F401
    AdmissionError,
    SchedulerConfig,
    ServeRequest,
    ServeScheduler,
)
