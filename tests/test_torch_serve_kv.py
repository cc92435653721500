"""The port's copies of the JAX package's JAX-free serving pieces, held
against the originals: the paged KV allocator (`serve/kv_cache.py`), the
pool byte math (`analysis/cost.py`) and the per-request recorder
(`serve/reqtrace.py`). The same operation sequence must give the same
tables, free lists, `OutOfBlocks` points and records."""

import numpy as np
import pytest

from distributed_neural_network_tpu.analysis import cost as jcost
from distributed_neural_network_tpu.serve import kv_cache as jkv
from distributed_neural_network_tpu.serve import reqtrace as jrt
from distributed_neural_network_tpu_torch.analysis import cost
from distributed_neural_network_tpu_torch.serve import kv_cache as kv
from distributed_neural_network_tpu_torch.serve import reqtrace as rt


def _drive(mod, seed):
    """A seeded mix of ensure / ensure_range / rewind / free on a small pool;
    returns everything observable after each operation."""
    rng = np.random.default_rng(seed)
    cache = mod.PagedKVCache(mod.KVCacheConfig(num_blocks=9, block_size=4, max_seq_len=40))
    used = {}
    trace = []
    for _ in range(300):
        sid = int(rng.integers(0, 5))
        op = rng.choice(["ensure", "range", "rewind", "free"], p=[0.45, 0.2, 0.15, 0.2])
        try:
            if op == "ensure":
                pos = min(used.get(sid, 0), 39)
                cache.ensure(sid, pos)
                used[sid] = pos + 1
                res = "ok"
            elif op == "range":
                end = min(used.get(sid, 0) + int(rng.integers(0, 9)), 39)
                cache.ensure_range(sid, end)
                used[sid] = max(used.get(sid, 0), end + 1)
                res = "ok"
            elif op == "rewind":
                n = int(rng.integers(0, used.get(sid, 0) + 1))
                res = cache.rewind(sid, n)
                if sid in used:
                    used[sid] = n
            else:
                res = cache.free(sid)
                used.pop(sid, None)
        except mod.OutOfBlocks as e:
            res = ("OutOfBlocks", e.need, e.free, e.total)
        trace.append((
            str(op), sid, res, cache.free_blocks, cache.blocks_in_use,
            cache.waste_slots(), cache.max_blocks_live(),
            cache.table(list(range(5)), 10).tolist(), cache.can_fit(9),
        ))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_copy(seed):
    want, got = _drive(jkv, seed), _drive(kv, seed)
    assert any(isinstance(t[2], tuple) for t in want), "pool was never exhausted"
    assert got == want


def test_allocator_config_and_errors_match():
    for m in (jkv, kv):
        with pytest.raises(ValueError):
            m.KVCacheConfig(num_blocks=1)
        c = m.PagedKVCache(m.KVCacheConfig(num_blocks=4, block_size=2, max_seq_len=8))
        with pytest.raises(ValueError, match="max_seq_len"):
            c.ensure(0, 8)
        c.ensure_range(0, 5)
        with pytest.raises(ValueError, match="table width"):
            c.table([0], 2)
    assert kv.SCRATCH_BLOCK == jkv.SCRATCH_BLOCK == 0


def test_pool_byte_math_matches_jax():
    for args in [(8, 8, 64, 16, "bf16"), (8, 8, 64, 16, "int8"), (2, 4, 8, 4, "f32")]:
        assert cost.kv_block_bytes(*args) == jcost.kv_block_bytes(*args)
    for args in [(128, 16, 256), (32, 4, 64), (5, 16, 17)]:
        assert cost.kv_capacity_sequences(*args) == jcost.kv_capacity_sequences(*args)


def test_request_recorder_matches_jax_copy():
    """One scripted lifecycle (queue, admission, prefill, a preemption,
    decode, a stall, stream write) through both recorders on a fake clock."""

    def run(mod):
        t = [0.0]
        rec = mod.RequestTraceRecorder(ring=4, clock=lambda: t[0])
        for rid in (1, 2):
            rec.arrive(rid, "tenant", 5, 4)
        for rid, cause in ((1, "admission"), (1, "prefill"), (2, "admission")):
            t[0] += 0.01
            rec.mark(rid, cause)
        for tick in range(6):
            t0 = t[0]
            t[0] += 0.02
            per_seq = {1: {"prefill": 0, "decode": 1, "replayed": 0, "parked": False},
                       2: {"prefill": 1, "decode": 0, "replayed": 0, "parked": tick == 2}}
            pre = [{"seq_id": 2, "tokens_held": 0, "preemptions": 1}] if tick == 3 else []
            rec.observe_step({"decode_tokens": 1, "prefill_tokens": 1, "per_seq": per_seq,
                              "preempted": pre}, t0, t[0])
            rec.note_token(1)
        rec.mark(1, "stream_write")
        t[0] += 0.005
        rec.finalize(1, "done")
        rec.note_rejected("queue_full")
        t[0] += 0.01
        rec.finalize_all()
        return rec.snapshot(full=True), rec.get(1), rec.in_flight()

    assert run(rt) == run(jrt)
    assert rt.REQUEST_CAUSES == jrt.REQUEST_CAUSES
