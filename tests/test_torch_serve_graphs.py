"""The serving engine's bucket programs (`serve/engine.py`): one program per
(B, W) decode and (C, W) prefill bucket over static buffers, the port's
counterpart of the JAX engine's jitted bucket steps.

On the CPU every program runs eagerly; the bookkeeping is the same as on
the card, where each is a CUDA graph. Held to the JAX package's
`ServeEngine` (f32, parameters carried across with `from_jax_params`):
`warmup()`'s count and `compiled_programs()` after warmup and after a bucket
first met while serving; the streams and pools of a prefill whose first
position and valid length are tensors of the bucket's buffers, at nonzero
positions and two widths (streams token-exact; the f32 pool within 2e-5,
two float stacks summing in other orders; the int8 pool within one code and
its scales within 1e-5, as in test_torch_serve_engine.py). The card's own
check, the graphed engine bitwise the same engine run eagerly, is in
test_torch_graphs.py (a file without JAX, so it runs on the card's
machine) and in chip_smoke.py phase 20.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.serve import engine as jeng
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.serve import engine as peng

GEOM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG, CFG = jtfm.TransformerConfig(**GEOM), tfm.TransformerConfig(**GEOM)
TOL = 2e-5


@pytest.fixture(scope="module")
def both_params():
    jp = jtfm.init_params(jax.random.key(0), JCFG)
    return jp, tfm.from_jax_params(jax.tree.map(np.asarray, jp))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 32, size=n).tolist()


def _engine(mod, params, **ecfg):
    cfg = JCFG if mod is jeng else CFG
    return mod.ServeEngine(params, cfg, mod.EngineConfig(**ecfg))


def _drain(eng, max_ticks=500):
    for _ in range(max_ticks):
        if not eng.has_work():
            return
        eng.step()
    raise AssertionError("the engine did not finish")


GRIDS = {
    "decode only": dict(max_batch=2, num_blocks=16, block_size=4, max_seq_len=16),
    "chunked prefill": dict(max_batch=4, num_blocks=16, block_size=4, max_seq_len=32,
                            prefill_chunk=4),
    "int8 kv": dict(max_batch=2, num_blocks=16, block_size=4, max_seq_len=16, prefill_chunk=8,
                    kv_dtype="int8"),
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_warmup_builds_the_jax_grid(n_devices, both_params, grid):
    """warmup() returns the JAX engine's count for the same EngineConfig and
    leaves compiled_programs() equal to the JAX engine's; the pools are left
    as they were (all zeros)."""
    jp, tp = both_params
    je, pe = _engine(jeng, jp, **GRIDS[grid]), _engine(peng, tp, **GRIDS[grid])
    assert pe.compiled_programs() == je.compiled_programs()
    n = pe.warmup()
    assert n == je.warmup()
    assert pe.compiled_programs() == je.compiled_programs()
    assert pe.compiled_programs()["total"] == n
    assert all(not t.any() for t in pe._state())


def test_an_unwarmed_bucket_adds_one_program_at_first_use(n_devices, both_params):
    """Warmed up to one block of width, a sequence that grows to two blocks
    builds exactly one more program (decode (1, 2)) at the tick that first
    needs it, as the JAX engine compiles one; nothing else grows."""
    jp, tp = both_params
    ecfg = dict(max_batch=2, num_blocks=16, block_size=4, max_seq_len=16)
    engines = [_engine(m, p, **ecfg) for m, p in ((jeng, jp), (peng, tp))]
    seqs = [m.Sequence(0, _prompt(3, 3), 4) for m in (jeng, peng)]
    for eng, seq in zip(engines, seqs):
        assert eng.warmup(max_width_blocks=1) == 2
        eng.add(seq)
    counts = []
    while engines[1].has_work():
        for eng in engines:
            eng.step()
        got, want = (e.compiled_programs() for e in engines)
        assert got == want
        counts.append(got["total"])
    assert counts[0] == 2 and counts[-1] == 3
    assert sum(b - a for a, b in zip(counts, counts[1:])) == 1
    assert (1, 2) in engines[1]._programs["decode"]
    assert seqs[0].out == seqs[1].out


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_with_tensor_positions_matches_jax(n_devices, both_params, kv_dtype):
    """A 21-token prompt in chunks of 4 (first positions 0, 4, 8, 12, 16 at
    widths 1, 2, 4, 4, 8): the (4, 4) bucket runs twice, its first position
    and valid length read from its 0-d buffers; streams and pools as the
    JAX engine's after the same ticks."""
    jp, tp = both_params
    ecfg = dict(max_batch=2, num_blocks=16, block_size=4, max_seq_len=32, prefill_chunk=4,
                kv_dtype=kv_dtype)
    engines = [_engine(m, p, **ecfg) for m, p in ((jeng, jp), (peng, tp))]
    seqs = [[m.Sequence(0, _prompt(7, 21), 5), m.Sequence(1, _prompt(8, 6), 5)]
            for m in (jeng, peng)]
    pe = engines[1]
    seen = []
    run = pe._run_prefill

    def spy(toks, pos0, table, n_valid):
        seen.append((toks.shape[0], table.shape[0], pos0, n_valid))
        run(toks, pos0, table, n_valid)
        bucket = pe._programs["prefill"][(toks.shape[0], table.shape[0])]
        assert bucket.inputs["pos0"].dim() == 0 and bucket.inputs["n_valid"].dim() == 0
        assert int(bucket.inputs["pos0"]) == pos0 and int(bucket.inputs["n_valid"]) == n_valid

    pe._run_prefill = spy
    for eng, ss in zip(engines, seqs):
        for s in ss:
            eng.add(s)
        for _ in range(6):
            eng.step()
    assert [(c, w, p0) for c, w, p0, _ in seen if c == 4][:5] == [
        (4, 1, 0), (4, 2, 4), (4, 4, 8), (4, 4, 12), (4, 8, 16)]
    je = engines[0]
    if kv_dtype == "int8":
        for jpool, ppool in ((je.k_pool, pe.k_pool), (je.v_pool, pe.v_pool)):
            diff = np.abs(np.asarray(jpool, np.int32) - ppool.numpy().astype(np.int32))
            assert diff.max() <= 1
        for js, ps in ((je.k_scale, pe.k_scale), (je.v_scale, pe.v_scale)):
            np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-8)
    else:
        for jpool, ppool in ((je.k_pool, pe.k_pool), (je.v_pool, pe.v_pool)):
            np.testing.assert_allclose(ppool.numpy(), np.asarray(jpool), atol=TOL, rtol=TOL)
    for eng in engines:
        _drain(eng)
    js, ps = seqs
    if kv_dtype == "int8":
        pairs = [(a, b) for j, p in zip(js, ps) for a, b in zip(j.out, p.out)]
        assert sum(a == b for a, b in pairs) / len(pairs) >= 0.99
    else:
        assert [s.out for s in ps] == [s.out for s in js]


def test_greedy_streams_unchanged_beside_a_sampled_request(both_params):
    """Every decode call takes a noise row per slot (zeros where greedy):
    greedy sequences batched with a sampled one emit generate()'s greedy
    streams, and the sampled one differs from its own greedy stream."""
    _, tp = both_params
    prompts = [_prompt(40 + i, n) for i, n in enumerate((5, 7, 6))]
    eng = _engine(peng, tp, max_batch=4, num_blocks=32, block_size=4, max_seq_len=32,
                  prefill_chunk=4)
    seqs = [peng.Sequence(i, p, 10, temperature=1.0 if i == 1 else 0.0, seed=3)
            for i, p in enumerate(prompts)]
    for s in seqs:
        eng.add(s)
    _drain(eng)
    greedy = [tfm.generate(tp, torch.tensor([p]), CFG, max_new_tokens=10)[0, len(p):].tolist()
              for p in prompts]
    assert seqs[0].out == greedy[0] and seqs[2].out == greedy[2]
    assert seqs[1].out != greedy[1]


def test_decode_noise_is_staged_in_place_and_cleared_after_use(both_params):
    """A decode call writes the sampled slots' noise rows straight into its
    bucket's staged block and zeroes the rows the bucket's previous call drew
    for: a greedy slot's row is zero on the card's input too."""
    _, tp = both_params
    eng = _engine(peng, tp, max_batch=4, num_blocks=16, block_size=4, max_seq_len=16)
    v = CFG.vocab_size
    z = np.zeros(4, np.int64)
    table = np.zeros((4, 1), np.int64)
    g = np.random.default_rng(0)
    r0, r1 = (g.random(v, dtype=np.float32) for _ in range(2))
    temps = np.array([0.5, 0.7, 0.0, 0.0], np.float32)
    eng._run_decode(z, z, table, temps, {0: r0, 1: r1})
    bucket = eng._programs["decode"][(4, 1)]
    assert bucket.noisy == [0, 1]
    eng._run_decode(z, z, table, np.array([0.0, 0.7, 0.0, 0.0], np.float32), {1: r0})
    want = np.zeros((4, v), np.float32)
    want[1] = r0
    assert np.array_equal(bucket.staged["noise"], want)
    assert np.array_equal(bucket.inputs["noise"].numpy(), want)
    assert bucket.noisy == [1]


def test_dropped_engine_frees_its_programs_at_once(both_params):
    """The bucket programs reach the engine by a weak reference: an engine
    and its programs form no cycle, so dropping the engine frees them (on
    the card their graphs) without the garbage collector, which could
    otherwise run inside another capture and spoil it."""
    _, tp = both_params
    gc.disable()
    try:
        eng = _engine(peng, tp, max_batch=2, num_blocks=16, block_size=4, max_seq_len=16,
                      prefill_chunk=4)
        eng.warmup()
        eng.add(peng.Sequence(0, _prompt(9, 6), 3))
        _drain(eng)
        refs = [weakref.ref(b.program) for fam in eng._programs.values() for b in fam.values()]
        refs.append(weakref.ref(eng))
        assert len(refs) > 1
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
