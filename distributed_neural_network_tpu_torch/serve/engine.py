"""Continuous-batching decode engine over the paged KV cache.

The port of the JAX package's `serve/engine.py`. Every engine tick runs ONE
decode step in which each active slot consumes exactly one token: a prompt
token while the sequence is still prefilling (its logits discarded, except
at the last prompt position, which yields the first generated token), a
just-generated token afterwards. Sequences therefore JOIN the batch at any
step boundary and RETIRE without draining anyone else. KV state lives in
the shared paged pool (`kv_cache.py`): the step writes each slot's new K/V
at ``block_table[pos // bs] * bs + pos % bs`` and gathers each slot's whole
table for attention.

Batch size and table width round up to powers of two (the JAX package's
compile buckets); the port keeps them so that a tick's shapes, and with
them its numbers, are those of the JAX engine. Every decode tick's
attention runs the decode kernel of `ops/decode_attention.py` on the
default route of a CUDA device (``decode_impl`` ``auto`` or ``cuda``), the
kernel's plain version under ``torch``; the kernel reads the gathered
(B, S, H, Dh) slab through its (B, H, S, Dh) view, without a copy.

Chunked prefill (``prefill_chunk > 1``) runs up to that many prompt tokens
of one sequence per call (causal within the chunk plus the cached history),
bounded per tick by ``prefill_token_budget``. A call takes a whole chunk or
the prompt's rest; unlike the JAX engine, a budget's smaller leftover waits
for the next tick rather than start a second prompt off the chunk grid, so
a prompt's chunks, and under int8 KV its codes, do not depend on what else
the engine serves. Its attention is the decode tick's, with one query row
per prompt token at its own position: the kernel on the ``cuda`` route.
The JAX prefill instead rounds its scores to the model dtype and
normalises before P.V; the port's choice makes a chunked
prompt give the same bits as one fed token by token, as the offline
`generate()` feeds it, so at bf16 the engine's greedy streams equal
generate()'s on the card.

``kv_dtype="int8"`` stores the pools as int8 codes with one f32 scale per
(block, head) and layer: quantize on append, re-quantizing a block's slab
when its scale grows, and dequantize in the decode kernel.

Backpressure: a sequence whose next position needs a block the pool cannot
give is parked for the tick; if nothing at all could run, the youngest
parked sequence is preempted (blocks freed, position reset) and replayed
later. Greedy decoding and per-(seed, position) sampling make the replay
deterministic, and already-streamed tokens are not re-emitted.

Sampling (temperature > 0) is a Gumbel-max draw from uniform noise made by
a CPU `torch.Generator` seeded from (seed, position): deterministic across
preemption and devices, but not the JAX package's stream. Every decode call
takes a noise row per slot (zeros for greedy slots, whose token is the
argmax either way), so one program serves greedy and sampled batches, as the
JAX step always computes its sample.

Each bucket is one `train/graphs.py` `Program` over static buffers (the
counterpart of the JAX engine's jitted step per bucket): decode (B, W) reads
tok, pos, table, temps and noise and leaves nxt and the logits; prefill (C,
W) reads the chunk's tokens, its first position, the table and its valid
length. A bucket's inputs lie in one device buffer, written by one copy from
one pinned host block per call. On the card every bucket is a CUDA graph,
all of one engine's graphs in one memory pool, captured by `warmup()` over
the JAX engine's grid, or at its first use for a bucket warmup did not
cover (from the zeros its fresh buffers hold, whose writes land in the
scratch block, which is put back after the capture's warm-up; a bucket is
kept only once captured). A tick is then one staging copy (a sampled slot's
noise row written in place, a row the last call drew for zeroed), one
replay per call and one read of the next tokens.
On the CPU the same functions run eagerly. `_capture = False` before the
first call runs them eagerly on the card too (the graphed engine is held to
that run bit for bit). The pools stay persistent tensors updated in place.

Not ported here: speculative decoding and int8 weights (``spec_decode``,
``weight_dtype="int8"``) raise `NotImplementedError` naming their slice.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.transformer import (
    DECODE_IMPLS,
    TransformerConfig,
    _layer_norm,
    _sinusoid_pe,
    layer_params,
    mlp_residual,
    resolve_decode_impl,
    sample_gumbel,
)
from ..ops import decode_attention as da
from ..ops.decode_attention import (
    decode_attention_plain,
    decode_cache_attention,
    decode_kernel_ok,
)
from ..train.graphs import Program, capture_all
from .kv_cache import KVCacheConfig, OutOfBlocks, PagedKVCache

_INT8_MAX = 127.0
_SCALE_EPS = 1e-30
_LATER = "a later slice of the port (speculative decoding and int8 weights, ROADMAP.md)"


@dataclass(frozen=True)
class EngineConfig:
    """Serving-side knobs (model geometry lives in TransformerConfig)."""

    max_batch: int = 8          # decode-slot cap = largest batch bucket
    num_blocks: int = 64        # shared pool size (incl. scratch block)
    block_size: int = 16        # tokens per KV block
    max_seq_len: int = 512      # prompt + generation hard cap
    prefill_chunk: int = 1      # 1 = exact token-at-a-time prefill
    prefill_token_budget: int = 0   # 0 = one chunk call per tick
    eos_token: int | None = None    # retire on this token id
    # "bf16" = pool in the model dtype; "int8" = int8 codes with
    # per-(block, head) f32 scales
    kv_dtype: str = "bf16"
    # decode attention: "cuda" = the hand-written kernel, "torch" = its
    # plain version, "auto" = cuda on a CUDA device, torch on the CPU (the
    # JAX package's pallas / xla / auto)
    decode_impl: str = "auto"
    spec_decode: int = 0
    spec_draft_layers: int = 0
    weight_dtype: str = "bf16"

    def __post_init__(self):
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {self.kv_dtype!r}")
        if self.weight_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"weight_dtype must be 'bf16' or 'int8', got {self.weight_dtype!r}")
        if self.decode_impl not in DECODE_IMPLS:
            raise ValueError(f"decode_impl must be auto/torch/cuda, got {self.decode_impl!r}")
        if self.spec_decode < 0 or self.spec_draft_layers < 0:
            raise ValueError("spec_decode and spec_draft_layers must be >= 0")
        if self.spec_decode:
            raise NotImplementedError(f"speculative decoding comes with {_LATER}")
        if self.weight_dtype == "int8":
            raise NotImplementedError(f"int8 weights come with {_LATER}")

    def kv(self) -> KVCacheConfig:
        return KVCacheConfig(
            num_blocks=self.num_blocks,
            block_size=self.block_size,
            max_seq_len=self.max_seq_len,
        )


@dataclass
class Sequence:
    """One in-flight request's decode state (engine-internal; the
    scheduler owns queueing/streaming around it)."""

    seq_id: int
    prompt: list
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    on_token: object = None  # callable(seq, token_id, done) or None

    pos: int = 0               # tokens consumed (= KV entries written)
    out: list = field(default_factory=list)
    emitted: int = 0           # tokens already streamed (preempt replay)
    finished: bool = False
    preemptions: int = 0
    t_first_token: float | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def in_prefill(self) -> bool:
        return self.pos < self.prompt_len

    def next_input(self) -> int:
        """The token this sequence consumes at its current position."""
        if self.pos < self.prompt_len:
            return int(self.prompt[self.pos])
        return int(self.out[self.pos - self.prompt_len])

    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


def export_descriptor(seq: Sequence) -> dict:
    """A live sequence as a migration descriptor: prompt + the tokens the
    client has already seen, from which any replica re-derives the rest of
    the stream by deterministic re-prefill replay."""
    emitted = [int(t) for t in seq.out[: seq.emitted]]
    return {
        "seq_id": int(seq.seq_id),
        "prompt": [int(t) for t in seq.prompt],
        "emitted": emitted,
        "max_new_tokens": int(seq.max_new_tokens),
        "remaining_tokens": int(seq.max_new_tokens) - len(emitted),
        "temperature": float(seq.temperature),
        "seed": int(seq.seed),
        "preemptions": int(seq.preemptions),
    }


def resume_request(desc: dict) -> dict:
    """The re-dispatch request body for a migration descriptor: emitted
    tokens fold into the prompt and the budget shrinks by them. Raises
    ValueError when nothing remains to generate."""
    emitted = [int(t) for t in desc.get("emitted") or ()]
    remaining = int(desc["max_new_tokens"]) - len(emitted)
    if remaining < 1:
        raise ValueError(
            f"descriptor for seq {desc.get('seq_id')} has no tokens "
            f"left to generate ({len(emitted)} already emitted)"
        )
    return {
        "prompt": [int(t) for t in desc["prompt"]] + emitted,
        "max_new_tokens": remaining,
        "temperature": float(desc.get("temperature", 0.0)),
        "seed": int(desc.get("seed", 0)),
    }


def resume_sequence(desc: dict, *, seq_id: int | None = None,
                    on_token=None) -> Sequence:
    """Import a migration descriptor as a fresh `Sequence` (the HTTP-less
    form of `resume_request`)."""
    body = resume_request(desc)
    return Sequence(
        seq_id=int(desc["seq_id"]) if seq_id is None else int(seq_id),
        prompt=body["prompt"],
        max_new_tokens=body["max_new_tokens"],
        temperature=body["temperature"],
        seed=body["seed"],
        on_token=on_token,
    )


def _bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _pow2_upto(n: int) -> list[int]:
    out, b = [], 1
    while b <= n:
        out.append(b)
        b *= 2
    return out


def _quantize(x):
    return torch.round(x).clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)


def _append_q8(pool, scales, val, blk, rows, flat):
    """Decode-form quantize-on-append into one layer's int8 pool: a token
    whose amax outgrows its block's scale re-quantizes the block's slab
    under the new scale, so every stored code is ``value / scales[block]``.
    pool (slots, H, Dh) int8, scales (num_blocks, H) f32, val (B, H, Dh),
    blk (B,), rows (B, bs) the blocks' slots, flat (B,) the new slots."""
    a = val.float().abs().amax(-1)                       # (B, H)
    s_old = scales[blk]
    s_new = torch.maximum(s_old, a / _INT8_MAX)
    ratio = torch.where(s_new > 0.0, s_old / s_new.clamp_min(_SCALE_EPS), 1.0)
    pool[rows] = _quantize(pool[rows].float() * ratio[:, None, :, None])
    pool[flat] = _quantize(val.float() / s_new[..., None].clamp_min(_SCALE_EPS))
    scales[blk] = s_new


def _append_q8_chunk(pool, scales, val, valid, blkv, flat, table, gather_idx, bs):
    """Chunk form: the chunk's per-block amax arrives by scatter-max, the
    table's whole span is re-quantized under the grown scales, then the
    chunk is written at its final scales. val (C, H, Dh), valid (C,),
    blkv (C,) block ids (scratch for the dead tail), table (W,)."""
    a = torch.where(valid[:, None], val.float().abs().amax(-1), 0.0)  # (C, H)
    idx = blkv[:, None].expand_as(a)
    new_scales = scales.scatter_reduce(0, idx, a / _INT8_MAX, "amax")
    ratio = torch.where(new_scales > 0.0, scales / new_scales.clamp_min(_SCALE_EPS), 1.0)
    ratio_slot = ratio[table].repeat_interleave(bs, dim=0)            # (S, H)
    pool[gather_idx] = _quantize(pool[gather_idx].float() * ratio_slot[..., None])
    s_tok = new_scales[blkv]
    pool[flat] = _quantize(val.float() / s_tok[..., None].clamp_min(_SCALE_EPS))
    scales.copy_(new_scales)


class _Bucket:
    """One decode (B, W) or prefill (C, W) bucket: its static inputs as
    views of one device buffer (`fields`: name -> (shape, dtype)), filled by
    one copy from one pinned host block per call, the outputs of its last
    run (`out`) and its `Program`, made by `make_fn(inputs, out)`."""

    def __init__(self, name: str, fields: dict, device, make_fn):
        offsets, total = {}, 0
        for key, (shape, dtype) in fields.items():
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            offsets[key] = (total, n)
            total += -(-n // 16) * 16  # each field 16-byte aligned
        cuda = device.type == "cuda"
        self.host = torch.zeros(total, dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.zeros(total, dtype=torch.uint8, device=device)
        self.inputs, self.staged = {}, {}
        for key, (shape, dtype) in fields.items():
            o, n = offsets[key]
            self.inputs[key] = self.dev[o:o + n].view(dtype).view(shape)
            self.staged[key] = self.host[o:o + n].view(dtype).view(shape).numpy()
        # the last copy out of `host`, which must land before `host` is rewritten
        self.copied = torch.cuda.Event() if cuda else None
        self.noisy = []  # decode: the rows of staged noise that hold draws
        self.out = {}
        self.program = Program(make_fn(self.inputs, self.out), name=f"the serving {name}",
                               counters=(da.LAUNCHES, da.ROUTE_LAUNCHES))

    def stage(self) -> dict:
        """The staged host arrays, free to write once the last copy out of
        them has landed."""
        if self.copied is not None:
            self.copied.synchronize()
        return self.staged

    def send(self) -> None:
        """Copy the staged block in."""
        self.dev.copy_(self.host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()

    def load(self, **values) -> None:
        """Stage `values` (arrays or numbers, by field) and copy them in."""
        staged = self.stage()
        for key, x in values.items():
            staged[key][...] = x
        self.send()


class ServeEngine:
    """The model executor: owns the parameters and KV pools on one device
    and advances all active sequences one tick at a time. Single-threaded
    by contract: one caller (the scheduler loop) drives `step()`;
    admission/cancel mutate the active set under `lock` between ticks."""

    def __init__(self, params, cfg: TransformerConfig, ecfg: EngineConfig):
        if cfg.n_experts:
            raise ValueError("the serving engine supports dense models; MoE decode routes "
                             "through models/transformer.py generate()")
        self.cfg = cfg
        self.ecfg = ecfg
        self.kv = PagedKVCache(ecfg.kv())
        self.device = params["embed"].device
        self.attn_route = resolve_decode_impl(ecfg.decode_impl, self.device)
        if self.attn_route == "cuda" and not decode_kernel_ok(cfg.head_dim):
            raise ValueError(f"head dim {cfg.head_dim} is outside the decode kernel's range")
        dt = cfg.dtype
        self.params = params
        self.layers = layer_params(params, cfg)
        # the step multiplies the model-dtype hidden state by the
        # model-dtype-rounded head in f32, as the JAX engine does
        self.head_f32 = params["head"].to(dt).float()
        n_l, n_h, d_h = cfg.n_layers, cfg.n_heads, cfg.head_dim
        slots = self.kv.cfg.pool_slots
        self.quantized = ecfg.kv_dtype == "int8"
        # The pools are persistent tensors updated in place: the port's
        # counterpart of the JAX engine donating them to every jitted step.
        pool_dtype = torch.int8 if self.quantized else dt
        self.k_pool = torch.zeros(n_l, slots, n_h, d_h, dtype=pool_dtype, device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        if self.quantized:
            self.k_scale = torch.zeros(n_l, ecfg.num_blocks, n_h, device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        else:
            self.k_scale = self.v_scale = None
        self.lock = threading.Lock()
        self.active: list[Sequence] = []
        # (B, W) decode and (C, W) prefill buckets, each a program
        self._programs = {"decode": {}, "prefill": {}}
        self._capture = self.device.type == "cuda"
        self._pool = self._stream = None  # one memory pool and side stream for the graphs
        self.ticks = 0
        self.decode_calls = 0
        self.prefill_calls = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.stall_events = 0
        # the speculative-decoding surface of the JAX engine, inert here
        self.spec_k = 0
        self.draft_layers = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_steps = 0
        self.preempted: deque[Sequence] = deque()

    # --------------------------------------------------------- lifecycle

    def add(self, seq: Sequence) -> None:
        """Join the batch at the next step boundary. Raises ValueError on
        an over-long request; block availability is the scheduler's gate."""
        if seq.total_len() > self.ecfg.max_seq_len:
            raise ValueError(
                f"request needs {seq.total_len()} positions "
                f"(prompt {seq.prompt_len} + {seq.max_new_tokens} new) "
                f"> max_seq_len {self.ecfg.max_seq_len}"
            )
        if not seq.prompt:
            raise ValueError("empty prompt")
        if len(self.active) >= self.ecfg.max_batch:
            raise ValueError(
                f"engine full ({self.ecfg.max_batch} slots) - the "
                "scheduler should hold admission"
            )
        with self.lock:
            self.active.append(seq)

    def cancel(self, seq_id: int) -> bool:
        """Drop a sequence mid-flight (client disconnect); frees its
        blocks. True when it was active."""
        with self.lock:
            for i, s in enumerate(self.active):
                if s.seq_id == seq_id:
                    self.active.pop(i)
                    self._free_seq(seq_id)
                    s.finished = True
                    return True
        return False

    def has_work(self) -> bool:
        with self.lock:
            return bool(self.active)

    # ------------------------------------------------- bytes + kv dtype

    def kv_dtype_name(self) -> str:
        """The /metrics ``serve_kv_dtype`` label value."""
        if self.quantized:
            return "int8"
        return "bf16" if self.cfg.dtype == torch.bfloat16 else "f32"

    def weight_dtype_name(self) -> str:
        return "bf16" if self.cfg.dtype == torch.bfloat16 else "f32"

    def kv_block_bytes(self) -> int:
        """Device bytes of one paged block at this engine's kv dtype."""
        from ..analysis.cost import kv_block_bytes

        cfg = self.cfg
        return kv_block_bytes(cfg.n_layers, cfg.n_heads, cfg.head_dim,
                              self.ecfg.block_size, self.kv_dtype_name())

    def compiled_programs(self) -> dict:
        """Per-family program counts (plus ``total``) under the JAX
        engine's /v1/status key: the (batch, width) decode and (chunk,
        width) prefill buckets built so far, each a captured CUDA graph on
        the card. After ``warmup()`` they equal its grid; a growth while
        serving is an un-warmed bucket captured on a live request."""
        fams = {"decode": len(self._programs["decode"]),
                "prefill": len(self._programs["prefill"]), "draft": 0, "verify": 0}
        fams["total"] = sum(fams.values())
        return fams

    def _free_seq(self, seq_id: int) -> int:
        """Free a sequence's blocks; under int8 KV also zero the freed
        blocks' scales, so a reused block starts from scale 0."""
        if not self.quantized:
            return self.kv.free(seq_id)
        blocks = self.kv.seq_block_ids(seq_id)
        n = self.kv.free(seq_id)
        if blocks:
            idx = torch.as_tensor(blocks, device=self.device)
            self.k_scale[:, idx, :] = 0.0
            self.v_scale[:, idx, :] = 0.0
        return n

    # ------------------------------------------------------------ steps

    def _attend(self, q, ks, vs, pos, k_slot=None, v_slot=None):
        """One decode tick's attention: q (B, H, Dh) against the gathered
        (B, S, H, Dh) slab, read as its (B, H, S, Dh) view."""
        fn = decode_cache_attention if self.attn_route == "cuda" else decode_attention_plain
        kw = {}
        if k_slot is not None:
            kw = {"k_scale": k_slot.transpose(1, 2), "v_scale": v_slot.transpose(1, 2)}
        return fn(q, ks.transpose(1, 2), vs.transpose(1, 2), pos, **kw)

    @torch.no_grad()
    def _decode(self, tok, pos, table, temps, noise):
        """One decode step over a (B, W) bucket; returns the next tokens
        (B,) and the f32 logits (B, V). tok/pos (B,), table (B, W) int64,
        temps (B,) f32, noise (B, V) uniform draws (zero rows where greedy)."""
        cfg, dt = self.cfg, self.cfg.dtype
        n_h, d_h = cfg.n_heads, cfg.head_dim
        bs = self.kv.cfg.block_size
        b, w = table.shape
        ar = torch.arange(bs, device=self.device)
        x = self.params["embed"][tok].to(dt) + _sinusoid_pe(pos, cfg.d_model, dt)
        blk = table[torch.arange(b, device=self.device), pos // bs]
        flat = blk * bs + pos % bs
        gather_idx = ((table * bs)[:, :, None] + ar).reshape(b, w * bs)
        rows = blk[:, None] * bs + ar
        for i, lp in enumerate(self.layers):
            h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]).to(dt)
            q = (h @ lp["wq"]).reshape(b, n_h, d_h)
            k = (h @ lp["wk"]).reshape(b, n_h, d_h)
            v = (h @ lp["wv"]).reshape(b, n_h, d_h)
            kp, vp = self.k_pool[i], self.v_pool[i]
            if self.quantized:
                _append_q8(kp, self.k_scale[i], k, blk, rows, flat)
                _append_q8(vp, self.v_scale[i], v, blk, rows, flat)
                k_slot = self.k_scale[i][table].repeat_interleave(bs, dim=1)  # (B, S, H)
                v_slot = self.v_scale[i][table].repeat_interleave(bs, dim=1)
                o = self._attend(q, kp[gather_idx], vp[gather_idx], pos, k_slot, v_slot)
            else:
                kp[flat] = k
                vp[flat] = v
                o = self._attend(q, kp[gather_idx], vp[gather_idx], pos)
            x = x + o.reshape(b, n_h * d_h) @ lp["wo"]
            x = mlp_residual(x, lp, dt)
        h = _layer_norm(x, self.params["lnf_scale"], self.params["lnf_bias"]).to(dt)
        logits = h.float() @ self.head_f32
        nxt = torch.argmax(logits, dim=-1)
        sampled = sample_gumbel(logits, temps.clamp_min(1e-6)[:, None], noise)
        return torch.where(temps > 0.0, sampled, nxt), logits

    @torch.no_grad()
    def _prefill(self, toks, pos0, table, n_valid) -> None:
        """Up to C prompt tokens of one sequence at positions pos0.. in one
        call; its attention is the decode tick's (`_attend`) with C query
        rows. toks (C,), table (W,) int64, pos0 and n_valid 0-d int64
        tensors (a graph's inputs, not constants); rows past n_valid are a
        dead tail whose writes land in the scratch block."""
        cfg, dt = self.cfg, self.cfg.dtype
        n_h, d_h = cfg.n_heads, cfg.head_dim
        bs = self.kv.cfg.block_size
        c, w = toks.shape[0], table.shape[0]
        s = w * bs
        dev = self.device
        pv = pos0 + torch.arange(c, device=dev)
        valid = torch.arange(c, device=dev) < n_valid
        x = self.params["embed"][toks].to(dt) + _sinusoid_pe(pv, cfg.d_model, dt)
        # dead-tail positions may lie past the table: clamp, then discard
        blk_all = table[torch.clamp(pv // bs, max=w - 1)]
        flat = torch.where(valid, blk_all * bs + pv % bs, 0)
        blkv = torch.where(valid, blk_all, 0)
        gather_idx = ((table * bs)[:, None] + torch.arange(bs, device=dev)).reshape(s)
        for i, lp in enumerate(self.layers):
            h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]).to(dt)
            q = (h @ lp["wq"]).reshape(c, n_h, d_h)
            k = (h @ lp["wk"]).reshape(c, n_h, d_h)
            v = (h @ lp["wv"]).reshape(c, n_h, d_h)
            kp, vp = self.k_pool[i], self.v_pool[i]
            if self.quantized:
                ksc, vsc = self.k_scale[i], self.v_scale[i]
                _append_q8_chunk(kp, ksc, k, valid, blkv, flat, table, gather_idx, bs)
                _append_q8_chunk(vp, vsc, v, valid, blkv, flat, table, gather_idx, bs)
                slots = [t[table].repeat_interleave(bs, dim=0)[None].expand(c, -1, -1)
                         for t in (ksc, vsc)]  # (C, S, H)
            else:
                kp[flat] = k
                vp[flat] = v
                slots = []
            # each of the C rows attends as a decode row at its own position
            # (the slab broadcast over the rows, not copied), so a prompt
            # token's K/V are the same bits whether it was prefilled or decoded
            ks, vs = (t[gather_idx][None].expand(c, -1, -1, -1) for t in (kp, vp))
            o = self._attend(q, ks, vs, pv, *slots)
            x = x + o.reshape(c, n_h * d_h) @ lp["wo"]
            x = mlp_residual(x, lp, dt)

    # ---------------------------------------------------------- programs

    def _state(self) -> list:
        """The tensors the programs write: the pools (and scales)."""
        return [t for t in (self.k_pool, self.v_pool, self.k_scale, self.v_scale)
                if t is not None]

    def _make_bucket(self, kind: str, key) -> _Bucket:
        """The bucket's program; its function reaches the engine through a
        weak reference, so the engine and its graphs form no cycle and a
        dropped engine frees them at once."""
        me = weakref.ref(self)
        dev, i64 = self.device, torch.int64
        if kind == "decode":
            b, w = key
            fields = {"tok": ((b,), i64), "pos": ((b,), i64), "table": ((b, w), i64),
                      "temps": ((b,), torch.float32),
                      "noise": ((b, self.cfg.vocab_size), torch.float32)}

            def make_fn(x, out):
                def fn():
                    out["nxt"], out["logits"] = me()._decode(
                        x["tok"], x["pos"], x["table"], x["temps"], x["noise"])
                return fn
        else:
            c, w = key
            fields = {"toks": ((c,), i64), "pos0": ((), i64), "table": ((w,), i64),
                      "n_valid": ((), i64)}

            def make_fn(x, out):
                def fn():
                    me()._prefill(x["toks"], x["pos0"], x["table"], x["n_valid"])
                return fn
        return _Bucket(f"{kind} bucket {key}", fields, dev, make_fn)

    def _build(self, keys, *, run: bool) -> None:
        """Make the buckets of `keys` ((kind, key) pairs) that do not exist
        yet and, on the card, capture them from the zeros of their fresh
        buffers; eagerly (`_capture` false, or the CPU) run each once on
        them if `run`. Their dummy writes land in the scratch block, which
        is put back as it was. A bucket is kept only once built: a capture
        that fails raises, naming its bucket, and keeps none of them."""
        new = {(kind, key): self._make_bucket(kind, key) for kind, key in keys
               if key not in self._programs[kind]}
        if not new:
            return
        programs = [b.program for b in new.values()]
        # the scratch block 0 (slots [0, bs) and its scales): the only
        # memory a zero table at position 0 writes
        bs = self.kv.cfg.block_size
        scratch = [self.k_pool[:, :bs], self.v_pool[:, :bs]]
        if self.quantized:
            scratch += [self.k_scale[:, 0], self.v_scale[:, 0]]
        if self._capture:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            # under the lock: no cancel() touches the pools on another
            # thread while a capture runs
            with self.lock:
                capture_all(programs, scratch, self.device, stream=self._stream,
                            pool=self._pool)
        elif run:
            saved = [t.clone() for t in scratch]
            for p in programs:
                p()
            for t, v in zip(scratch, saved):
                t.copy_(v)
        for (kind, key), bucket in new.items():
            self._programs[kind][key] = bucket

    def _bucket(self, kind: str, key) -> _Bucket:
        """The bucket `key` of `kind`, made (and on the card captured) at
        its first use when warmup did not cover it."""
        if key not in self._programs[kind]:
            self._build([(kind, key)], run=False)
        return self._programs[kind][key]

    def warmup(self, *, max_width_blocks: int | None = None) -> int:
        """Build every (batch, width) decode bucket and (chunk, width)
        prefill bucket of the JAX engine's grid (pow2 batches up to
        max_batch x pow2 widths; chunks with C <= W * block_size): on the
        card each is captured, off it each runs once, with dummy inputs
        whose writes land in the scratch block, which is left as it was. The first request then pays no capture, kernel build or
        library set-up. Returns the grid's size (the JAX engine's count)."""
        widths = _pow2_upto(_bucket(max_width_blocks or self.kv.cfg.max_blocks_per_seq))
        keys = [("decode", (b, w)) for b in _pow2_upto(self.ecfg.max_batch) for w in widths]
        if self.ecfg.prefill_chunk > 1:
            bs = self.kv.cfg.block_size
            keys += [("prefill", (c, w)) for c in _pow2_upto(self.ecfg.prefill_chunk)
                     for w in widths if c <= w * bs]
        self._build(keys, run=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(keys)

    def _run_decode(self, tok, pos, table, temps, draws: dict) -> list:
        """One decode call from host arrays: the (B, W) bucket's inputs
        copied in, one run; returns the next tokens (read before any other
        program runs: the graphs share their memory). `draws` maps the
        sampled slots to their noise rows; the other rows stay zero."""
        bucket = self._bucket("decode", table.shape)
        staged = bucket.stage()
        staged["tok"][...] = tok
        staged["pos"][...] = pos
        staged["table"][...] = table
        staged["temps"][...] = temps
        noise = staged["noise"]
        noise[bucket.noisy] = 0.0  # the rows the last call drew for
        for i, row in draws.items():
            noise[i] = row
        bucket.noisy = list(draws)
        bucket.send()
        bucket.program()
        self.decode_calls += 1
        return bucket.out["nxt"].tolist()

    def _run_prefill(self, toks, pos0: int, table, n_valid: int) -> None:
        bucket = self._bucket("prefill", (toks.shape[0], table.shape[0]))
        bucket.load(toks=toks, pos0=pos0, table=table, n_valid=n_valid)
        bucket.program()
        self.prefill_calls += 1

    # ------------------------------------------------------------ the tick

    def _sample_noise(self, seq: Sequence) -> torch.Tensor:
        """Per-(sequence, position) uniform draws for sampling, from a CPU
        generator: deterministic across preemption replay and devices."""
        g = torch.Generator().manual_seed((seq.seed * 1_000_003 + seq.pos) % 2**63)
        return torch.rand(self.cfg.vocab_size, generator=g)

    def _emit(self, seq: Sequence, tok: int) -> None:
        """One NEW generated token: record, maybe retire, stream."""
        seq.out.append(tok)
        done = (
            len(seq.out) >= seq.max_new_tokens
            or (self.ecfg.eos_token is not None and tok == self.ecfg.eos_token)
        )
        if done:
            seq.finished = True
        seq.emitted = len(seq.out)
        if seq.on_token is not None:
            seq.on_token(seq, tok, done)

    def _retire_finished(self) -> list:
        done = [s for s in self.active if s.finished]
        if done:
            with self.lock:
                self.active = [s for s in self.active if not s.finished]
            for s in done:
                self._free_seq(s.seq_id)
        return done

    def _preempt_youngest(self, parked: list) -> Sequence:
        """Nothing could run: evict the youngest parked sequence (blocks
        freed, position reset; generated tokens kept for replay dedup)."""
        victim = parked[-1]
        with self.lock:
            self.active = [s for s in self.active if s.seq_id != victim.seq_id]
        self._free_seq(victim.seq_id)
        victim.pos = 0
        victim.preemptions += 1
        self.preempted.append(victim)
        self.stall_events += 1
        return victim

    def step(self) -> dict:
        """One engine tick. Returns per-tick stats for the scheduler's
        ledger/metrics: ``{"decode_tokens", "prefill_tokens", "finished",
        "parked", "batch", "per_seq", "preempted"}``, with ``per_seq`` =
        ``{seq_id: {"prefill", "decode", "replayed", "parked", "proposed",
        "accepted", "draft_s", "verify_s"}}`` for every sequence the tick
        touched (the JAX engine's schema; the speculative fields stay 0)."""
        ecfg = self.ecfg
        bs = self.kv.cfg.block_size
        with self.lock:
            todo = list(self.active)
        parked: list[Sequence] = []
        stats = {"decode_tokens": 0, "prefill_tokens": 0, "finished": 0,
                 "parked": 0, "batch": 0, "per_seq": {}, "preempted": []}

        def seqstat(s: Sequence) -> dict:
            d = stats["per_seq"].get(s.seq_id)
            if d is None:
                d = stats["per_seq"][s.seq_id] = {
                    "prefill": 0, "decode": 0, "replayed": 0, "parked": False,
                    "proposed": 0, "accepted": 0, "draft_s": 0.0, "verify_s": 0.0,
                }
            return d

        # ---- chunked prefill phase (prefill_chunk > 1 only)
        if ecfg.prefill_chunk > 1:
            budget = ecfg.prefill_token_budget or ecfg.prefill_chunk
            chunk = min(ecfg.prefill_chunk, budget)
            for seq in todo:
                if budget <= 0:
                    break
                if not seq.in_prefill or seq.finished:
                    continue
                # the LAST prompt token goes to the decode batch, whose
                # logits give the first generated token
                remaining = seq.prompt_len - 1 - seq.pos
                if remaining <= 0:
                    continue
                # a whole chunk or the prompt's rest, never a smaller
                # leftover of the tick's budget: the chunk boundaries are
                # then the prompt's alone, and under int8 KV so are its
                # codes (a block that two chunks write is quantized twice)
                n = min(remaining, chunk)
                if n > budget:
                    continue
                try:
                    self.kv.ensure_range(seq.seq_id, seq.pos + n - 1)
                except OutOfBlocks:
                    parked.append(seq)
                    seqstat(seq)["parked"] = True
                    continue
                c = _bucket(n)
                w = _bucket((seq.pos + n - 1) // bs + 1)
                toks = np.zeros((c,), np.int64)
                toks[:n] = seq.prompt[seq.pos: seq.pos + n]
                self._run_prefill(toks, seq.pos, self.kv.table([seq.seq_id], w)[0], n)
                seq.pos += n
                budget -= n
                self.prefill_tokens += n
                stats["prefill_tokens"] += n
                seqstat(seq)["prefill"] += n

        # ---- decode batch: one token per slot
        batch: list[Sequence] = []
        for seq in todo:
            if seq.finished or seq in parked:
                continue
            if ecfg.prefill_chunk > 1 and seq.pos < seq.prompt_len - 1:
                continue  # still mid-chunked-prefill; next tick
            try:
                self.kv.ensure(seq.seq_id, seq.pos)
            except OutOfBlocks:
                parked.append(seq)
                seqstat(seq)["parked"] = True
                continue
            batch.append(seq)

        stats["parked"] = len(parked)
        if parked:
            self.stall_events += 1
        if not batch:
            if parked:
                # every active sequence is parked on blocks: preempt the
                # youngest so the others' next allocation can succeed
                victim = self._preempt_youngest(parked)
                stats["preempted"].append({
                    "seq_id": victim.seq_id,
                    "tokens_held": len(victim.out),
                    "preemptions": victim.preemptions,
                })
            return stats

        b = min(_bucket(len(batch)), ecfg.max_batch)
        batch = batch[:b]
        w = _bucket(max(s.pos // bs + 1 for s in batch))
        tok = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        for i, s in enumerate(batch):
            tok[i] = s.next_input()
            pos[i] = s.pos
            temps[i] = s.temperature
        draws = {i: self._sample_noise(s).numpy() for i, s in enumerate(batch)
                 if s.temperature > 0.0}
        table = self.kv.table([s.seq_id for s in batch] + [-1] * (b - len(batch)), w)
        nxt = self._run_decode(tok, pos, table, temps, draws)
        for i, s in enumerate(batch):
            consumed_at = s.pos
            s.pos += 1
            if consumed_at >= s.prompt_len - 1:
                # prediction for generated-token index j; a preemption
                # replay re-derives tokens the sequence already holds
                # (j < len(out)): they are dropped, not re-streamed
                j = consumed_at + 1 - s.prompt_len
                if j == len(s.out):
                    self._emit(s, int(nxt[i]))
                else:
                    seqstat(s)["replayed"] += 1
                self.decode_tokens += 1
                stats["decode_tokens"] += 1
                seqstat(s)["decode"] += 1
            else:
                self.prefill_tokens += 1
                stats["prefill_tokens"] += 1
                seqstat(s)["prefill"] += 1
        self.ticks += 1
        stats["batch"] = len(batch)
        stats["finished"] = len(self._retire_finished())
        return stats
