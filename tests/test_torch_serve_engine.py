"""The port's continuous-batching engine (`serve/engine.py`) at f32, held
against the port's own offline `generate()` and against the JAX package's
`ServeEngine` fed the same requests with the same parameters (a JAX tree
carried across with `from_jax_params`).

Bars: greedy streams token-exact against both, under staggered joins and
retires, chunked prefill (chunks 4 and 8), preemption replay and cancel;
every block freed at the end; the int8 KV pool within one code of the JAX
engine's after the same ticks, and its streams agreeing per token >= 0.99;
sampling deterministic per seed; the decode-kernel route (its plain version
on the CPU) giving the same streams as the plain route; a prompt's prefill
chunks on the chunk grid, and its bf16 and int8 K/V the bits it gets alone,
whatever else the engine serves (a difference from the JAX engine, whose
budget leftover starts a second prompt off the grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.serve import engine as jeng
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.serve import engine as peng

GEOM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG, CFG = jtfm.TransformerConfig(**GEOM), tfm.TransformerConfig(**GEOM)


@pytest.fixture(scope="module")
def both_params():
    jp = jtfm.init_params(jax.random.key(0), JCFG)
    return jp, tfm.from_jax_params(jax.tree.map(np.asarray, jp))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 32, size=n).tolist()


def _oracle(params, prompt, n_new):
    out = tfm.generate(params, torch.tensor([prompt]), CFG, max_new_tokens=n_new)
    return out[0, len(prompt):].tolist()


def _engine(mod, params, **ecfg):
    cfg = JCFG if mod is jeng else CFG
    return mod.ServeEngine(params, cfg, mod.EngineConfig(**ecfg))


def _drain(eng, max_ticks=2000):
    t = 0
    while (eng.has_work() or eng.preempted) and t < max_ticks:
        eng.step()
        if eng.preempted and eng.kv.can_fit(4):
            eng.add(eng.preempted.popleft())
        t += 1
    assert not eng.has_work() and not eng.preempted


def _staggered(mod, params, **ecfg):
    """A long request mid-decode when two short ones join; the short ones
    retire first."""
    eng = _engine(mod, params, max_batch=4, num_blocks=32, block_size=4, max_seq_len=64, **ecfg)
    long = mod.Sequence(0, _prompt(10, 4), 20)
    eng.add(long)
    for _ in range(6):
        eng.step()
    short = [mod.Sequence(1, _prompt(11, 7), 4), mod.Sequence(2, _prompt(12, 3), 4)]
    for s in short:
        eng.add(s)
    while not all(s.finished for s in short):
        eng.step()
    assert not long.finished
    _drain(eng)
    assert eng.kv.blocks_in_use == 0
    return [s.out for s in (long, *short)], [s.prompt for s in (long, *short)]


def _chunked(mod, params, chunk, **ecfg):
    eng = _engine(mod, params, max_batch=4, num_blocks=32, block_size=4, max_seq_len=64,
                  prefill_chunk=chunk, **ecfg)
    seqs = [mod.Sequence(i, _prompt(20 + i, n), 6) for i, n in enumerate((13, 9, 1))]
    for s in seqs:
        eng.add(s)
    _drain(eng)
    assert eng.kv.blocks_in_use == 0
    return [s.out for s in seqs], [s.prompt for s in seqs]


def _preempting(mod, params):
    """5 usable blocks of 2 slots for three 10-token requests."""
    eng = _engine(mod, params, max_batch=4, num_blocks=6, block_size=2, max_seq_len=16)
    streamed = {i: [] for i in range(3)}
    seqs = [mod.Sequence(i, _prompt(30 + i, 4), 6,
                         on_token=lambda sq, t, d: streamed[sq.seq_id].append(t))
            for i in range(3)]
    for s in seqs:
        eng.add(s)
    _drain(eng)
    assert sum(s.preemptions for s in seqs) > 0 and eng.stall_events > 0
    assert eng.kv.blocks_in_use == 0
    return [s.out for s in seqs], [streamed[i] for i in range(3)], [s.prompt for s in seqs]


def test_staggered_joins_match_generate_and_jax_engine(n_devices, both_params):
    jp, tp = both_params
    got, prompts = _staggered(peng, tp)
    want, _ = _staggered(jeng, jp)
    assert got == want
    assert got == [_oracle(tp, p, len(o)) for p, o in zip(prompts, got)]


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_prefill_matches_generate_and_jax_engine(n_devices, both_params, chunk):
    jp, tp = both_params
    got, prompts = _chunked(peng, tp, chunk)
    assert got == _chunked(jeng, jp, chunk)[0]
    assert got == [_oracle(tp, p, 6) for p in prompts]


def test_preemption_replays_exactly_and_never_restreams(n_devices, both_params):
    jp, tp = both_params
    got, streamed, prompts = _preempting(peng, tp)
    want = [_oracle(tp, p, 6) for p in prompts]
    assert got == want and streamed == want  # no duplicates, no gaps
    assert got == _preempting(jeng, jp)[0]


def test_kernel_route_gives_the_plain_route_streams(both_params):
    """`attn_route = "cuda"` sends every tick through `decode_cache_attention`
    with the gathered slab's transposed views (its plain version on CPU
    tensors, as on the card the kernel): same streams as the plain route."""
    _, tp = both_params
    for kv_dtype in ("bf16", "int8"):
        plain = _chunked(peng, tp, 4, kv_dtype=kv_dtype)[0]
        eng = _engine(peng, tp, max_batch=4, num_blocks=32, block_size=4, max_seq_len=64,
                      prefill_chunk=4, kv_dtype=kv_dtype)
        eng.attn_route = "cuda"
        seqs = [peng.Sequence(i, _prompt(20 + i, n), 6) for i, n in enumerate((13, 9, 1))]
        for s in seqs:
            eng.add(s)
        _drain(eng)
        assert [s.out for s in seqs] == plain


def test_prefill_attends_as_decode_rows(both_params):
    """The chunked prefill's attention is the decode tick's: one query row
    per prompt token at its own position, against the gathered slab
    broadcast over the rows (stride 0, no copy)."""
    _, tp = both_params
    for kv_dtype in ("bf16", "int8"):
        eng = _engine(peng, tp, max_batch=4, num_blocks=32, block_size=4, max_seq_len=64,
                      prefill_chunk=4, kv_dtype=kv_dtype)
        seen, attend = [], eng._attend

        def spy(q, ks, vs, pos, *scales, attend=attend):
            seen.append((q.shape[0], ks.stride(0), pos.tolist(),
                         [s.stride(0) for s in scales]))
            return attend(q, ks, vs, pos, *scales)

        eng._attend = spy
        eng.add(peng.Sequence(0, _prompt(90, 9), 2))
        eng.step()  # prompt positions 0-3 in one chunk; position 4 waits
        scale_strides = [0, 0] if kv_dtype == "int8" else []
        assert seen == [(4, 0, [0, 1, 2, 3], scale_strides)] * CFG.n_layers
        assert (eng.prefill_calls, eng.decode_calls) == (1, 0)


def test_int8_pool_tracks_jax_engine(n_devices, both_params):
    """Same requests, same ticks: every int8 code within 1 of the JAX
    engine's (rounding of values that differ in the last float bits), the
    scales within 1e-5, and the streams agreeing per token >= 0.99."""
    jp, tp = both_params
    engines = [_engine(m, p, max_batch=4, num_blocks=32, block_size=4, max_seq_len=64,
                       prefill_chunk=4, kv_dtype="int8") for m, p in ((jeng, jp), (peng, tp))]
    seqs = [[m.Sequence(i, _prompt(40 + i, n), 8) for i, n in enumerate((13, 9, 5))]
            for m in (jeng, peng)]
    for eng, ss in zip(engines, seqs):
        for s in ss:
            eng.add(s)
        for _ in range(7):
            eng.step()
    je, pe = engines
    for jpool, ppool in ((je.k_pool, pe.k_pool), (je.v_pool, pe.v_pool)):
        diff = np.abs(np.asarray(jpool, np.int32) - ppool.numpy().astype(np.int32))
        assert diff.max() <= 1
    for js, ps in ((je.k_scale, pe.k_scale), (je.v_scale, pe.v_scale)):
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-8)
    for eng in engines:
        _drain(eng)
        assert eng.kv.blocks_in_use == 0
        assert not np.asarray(eng.k_scale)[:, 1:].any()  # freed blocks' scales reset
    pairs = [(a, b) for js, ps in zip(*seqs) for a, b in zip(js.out, ps.out)]
    assert len(pairs) == 24
    assert sum(a == b for a, b in pairs) / len(pairs) >= 0.99


def _prompt_codes(params, kv_dtype, company):
    """Prompt B's prefill chunk starts, the K/V codes and scales of the
    blocks its chunks fill (the next block also holds a token decoded in a
    batch whose size, and so its rounding, depends on the company), and
    its stream, served after the requests of `company`."""
    eng = _engine(peng, params, max_batch=4, num_blocks=32, block_size=4, max_seq_len=64,
                  prefill_chunk=4, kv_dtype=kv_dtype)
    starts, run_prefill = {}, eng._run_prefill

    def spy(toks, pos0, table, n_valid):
        starts.setdefault(int(table[0]), []).append(pos0)
        return run_prefill(toks, pos0, table, n_valid)

    eng._run_prefill = spy
    seqs = [peng.Sequence(i, _prompt(70 + i, n), 4) for i, n in enumerate(company)]
    seqs.append(peng.Sequence(len(company), _prompt(79, 10), 4))
    for s in seqs:
        eng.add(s)
    b = seqs[-1]
    while b.pos < b.prompt_len:
        eng.step()
    blocks = torch.as_tensor(eng.kv.table([b.seq_id], 3)[0][:2], dtype=torch.int64)
    slots = (blocks[:, None] * 4 + torch.arange(4)).reshape(-1)
    pools = [p[:, slots].clone() for p in (eng.k_pool, eng.v_pool)]
    if kv_dtype == "int8":
        pools += [s[:, blocks].clone() for s in (eng.k_scale, eng.v_scale)]
    _drain(eng)
    return starts[int(blocks[0])], pools, list(b.out)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_chunks_keep_the_grid_whatever_else_is_served(both_params, kv_dtype):
    """A budget's leftover (prompt A's 1-token rest leaves 3 of 4) waits for
    the next tick instead of starting prompt B off the chunk grid, so B's
    chunks, K/V codes and scales, and stream are those of B served alone."""
    _, tp = both_params
    alone = _prompt_codes(tp, kv_dtype, ())
    shared = _prompt_codes(tp, kv_dtype, (6,))
    assert alone[0] == shared[0] == [0, 4, 8]
    for a, s in zip(alone[1], shared[1]):
        assert torch.equal(a, s)
    assert alone[2] == shared[2]


def test_cancel_frees_blocks_mid_flight(both_params):
    _, tp = both_params
    eng = _engine(peng, tp, max_batch=2, num_blocks=16, block_size=2, max_seq_len=32)
    eng.add(peng.Sequence(0, _prompt(80, 6), 20))
    for _ in range(4):
        eng.step()
    assert eng.kv.blocks_in_use > 0
    assert eng.cancel(0) is True
    assert eng.kv.blocks_in_use == 0 and not eng.has_work()
    assert eng.cancel(0) is False


def test_sampling_deterministic_per_seed(both_params):
    _, tp = both_params

    def run(seed):
        eng = _engine(peng, tp, max_batch=2, num_blocks=16, block_size=4, max_seq_len=64)
        s = peng.Sequence(0, _prompt(40, 4), 12, temperature=1.0, seed=seed)
        eng.add(s)
        _drain(eng)
        return list(s.out)

    a1, a2, b = run(7), run(7), run(8)
    assert a1 == a2 and a1 != b
    assert all(0 <= t < 32 for t in a1)


def test_warmup_leaves_state_clean_and_eos_retires(both_params):
    _, tp = both_params
    for kv_dtype in ("bf16", "int8"):
        eng = _engine(peng, tp, max_batch=4, num_blocks=8, block_size=4, max_seq_len=32,
                      prefill_chunk=4, kv_dtype=kv_dtype)
        assert eng.warmup() == 3 * 4 + 3 * 4  # 3 batches, 3 chunks, 4 widths each
        s = peng.Sequence(0, _prompt(50, 5), 8)
        eng.add(s)
        _drain(eng)
        assert s.out == _oracle(tp, s.prompt, 8)
    p = _prompt(60, 5)
    want = _oracle(tp, p, 16)
    k = next(i for i in range(1, 16) if want[i] not in want[:i])
    eng = _engine(peng, tp, max_batch=2, num_blocks=16, block_size=4, max_seq_len=64,
                  eos_token=want[k])
    s = peng.Sequence(0, p, 16)
    eng.add(s)
    _drain(eng)
    assert s.out == want[: k + 1] and s.finished


def test_admission_validation_and_later_slices(both_params):
    _, tp = both_params
    eng = _engine(peng, tp, max_batch=1, num_blocks=8, block_size=4, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.add(peng.Sequence(0, _prompt(70, 10), 10))
    with pytest.raises(ValueError, match="empty"):
        eng.add(peng.Sequence(1, [], 4))
    eng.add(peng.Sequence(2, _prompt(71, 4), 4))
    with pytest.raises(ValueError, match="engine full"):
        eng.add(peng.Sequence(3, _prompt(72, 4), 4))
    with pytest.raises(NotImplementedError, match="later slice"):
        peng.EngineConfig(spec_decode=4)
    with pytest.raises(NotImplementedError, match="later slice"):
        peng.EngineConfig(weight_dtype="int8")
    with pytest.raises(ValueError, match="CUDA device"):
        _engine(peng, tp, decode_impl="cuda")


def test_migration_descriptor_round_trip():
    s = peng.Sequence(5, [3, 4, 5], 6, temperature=0.5, seed=9)
    s.out, s.emitted = [7, 8], 2
    desc = peng.export_descriptor(s)
    assert desc == jeng.export_descriptor(jeng.Sequence(5, [3, 4, 5], 6, temperature=0.5,
                                                        seed=9, out=[7, 8], emitted=2))
    r = peng.resume_sequence(desc)
    assert r.prompt == [3, 4, 5, 7, 8] and r.max_new_tokens == 4
    assert peng._bucket(5) == jeng._bucket(5) == 8
