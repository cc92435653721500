"""The LM train step and eval loss as programs (`train/lm.py` `LMTrainStep`,
`EvalLoss`): one program over static buffers, bound to the parameter and
optimizer-state tensors of its first call, whose lr and Adam bias
corrections are 0-d f32 buffers written by the host before each run.

Held to the JAX package's `make_lm_train_step` on a 1x1x1 mesh for three
steps under a cosine schedule, Adam and clip + weight decay, from the same
parameters and numpy tokens, at test_torch_lm_step.py's tolerance (f32:
losses within 2e-5 relative, parameters atol = rtol = 2e-5); the buffers
hold the host schedule's f32 bits (and the JAX schedule's) at every step;
the eval program gives the plain loss's bits and the JAX loss within 2e-5.
The card's own check, the graphed step and eval bitwise the same programs
run eagerly, is in test_torch_graphs.py (a file without JAX, so it runs on
the card's machine) and in chip_smoke.py phase 20.
"""

import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.ops import adam as jadam
from distributed_neural_network_tpu.ops import schedule as jsched
from distributed_neural_network_tpu.train import lm as jlm
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.ops import adam as tadam
from distributed_neural_network_tpu_torch.ops import schedule as tsched
from distributed_neural_network_tpu_torch.train import lm as tlm
from test_torch_lm_step import CASES

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG, CFG = jtfm.TransformerConfig(**KW), tfm.TransformerConfig(**KW)
TOL = 2e-5
SCHED = dict(total_steps=3, warmup_steps=1, min_lr_frac=0.1)


def _batch(seed=0, b=4, s=16):
    toks = np.random.default_rng(seed).integers(2, 32, size=(b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _torch(x):
    return torch.from_numpy(x).long()


@pytest.fixture(scope="module")
def jparams_np():
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), JCFG))


def _bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


@pytest.mark.parametrize("case", ["cosine-clip-wd", "adam", "adam-cosine-clip-wd-flash"])
def test_device_scalar_step_matches_jax(n_devices, jparams_np, case):
    """Three steps of one program (the same `Program` every call) against
    the JAX step, and each step's lr / correction buffers holding the host
    schedule's f32 bits, which are also the JAX schedule's."""
    kw = dict(lr=0.1, momentum=0.9, attn_impl="ring", optimizer="sgd", loss_chunks=0,
              clip_norm=0.0, accum_steps=1, weight_decay=0.0)
    kw.update(CASES[case])
    sched = kw.pop("lr_schedule", None)
    sk = dict(base_lr=kw["lr"], **SCHED)
    mesh = jlm.create_lm_mesh(1, 1, 1)
    jparams, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np), JCFG, mesh)
    jmom = jlm.init_lm_momentum(jparams, mesh, kw["optimizer"])
    jstep = jlm.make_lm_train_step(
        JCFG, mesh, lr_schedule=functools.partial(jsched.warmup_cosine, **sk) if sched else None,
        **kw)
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params, kw["optimizer"])
    host_lr = functools.partial(tsched.warmup_cosine, **sk) if sched else None
    step = tlm.make_lm_train_step(CFG, device="cpu", lr_schedule=host_lr, **kw)
    program = None
    for i in range(3):
        toks, tgts = _batch(seed=i)
        extra = (jnp.int32(i),) if sched else ()
        jparams, jmom, jloss = jstep(jparams, jmom, jnp.asarray(toks), jnp.asarray(tgts), *extra)
        loss = step(params, mom, _torch(toks), _torch(tgts), i)
        assert float(loss) == pytest.approx(float(jloss), rel=TOL), f"step {i}"
        program = program or step.program
        assert step.program is program
        lr_buf, c1_buf, c2_buf = step._scalars
        want_lr = host_lr(i) if sched else kw["lr"]
        assert _bits(lr_buf) == _bits(want_lr)
        if sched:
            assert _bits(lr_buf) == _bits(jsched.warmup_cosine(jnp.int32(i), **sk))
        if kw["optimizer"] == "adam":
            assert mom["t"] == i + 1
            want = tadam.bias_corrections(i + 1, kw["momentum"], tadam.B2)
            jwant = jadam.bias_corrections(jnp.int32(i + 1), kw["momentum"], 0.999)
            assert [_bits(c1_buf), _bits(c2_buf)] == [_bits(x) for x in want]
            assert [_bits(x) for x in want] == [_bits(x) for x in jwant]
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = [p.detach().numpy() for p in tlm.tree_leaves(params)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_step_refuses_other_tensors_after_its_first_call(jparams_np):
    """The program is bound to its first call's parameter and state tensors
    and token shape: other parameters, another momentum or another batch
    shape raise rather than run on what the program does not hold."""
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params)
    step = tlm.make_lm_train_step(CFG, lr=0.1)
    toks, tgts = (_torch(x) for x in _batch())
    step(params, mom, toks, tgts)
    step(params, mom, toks, tgts)
    other = tfm.from_jax_params(jparams_np)
    with pytest.raises(ValueError, match="other parameter"):
        step(other, mom, toks, tgts)
    with pytest.raises(ValueError, match="other parameter"):
        step(params, tlm.init_lm_momentum(params), toks, tgts)
    small = [x[:2] for x in (toks, tgts)]
    with pytest.raises(ValueError, match="shapes"):
        step(params, mom, *small)
    # the same tensors in a new dict are the same program's
    step(tlm.tree_unflatten(params, tlm.tree_leaves(params)), mom, toks, tgts)
    # a refused call writes nothing: Adam's step counter stays
    adam = tlm.init_lm_momentum(params, "adam")
    astep = tlm.make_lm_train_step(CFG, lr=0.01, optimizer="adam")
    astep(params, adam, toks, tgts)
    with pytest.raises(ValueError, match="other parameter"):
        astep(other, adam, toks, tgts)
    assert adam["t"] == 1


def test_eval_program_equals_the_plain_loss(n_devices, jparams_np):
    """The eval program, run on two batches through its buffers, gives the
    bits of `lm_loss` under no_grad and the JAX loss within 2e-5."""
    params = tfm.from_jax_params(jparams_np)
    ev = tlm.make_eval_fn(CFG, attn_impl="flash", loss_chunks=2)
    for seed in (3, 4):
        toks, tgts = _batch(seed=seed)
        got = ev(params, _torch(toks), _torch(tgts))
        with torch.no_grad():
            want = tlm.lm_loss(params, _torch(toks), _torch(tgts), CFG, attn_impl="flash",
                               loss_chunks=2)
        assert torch.equal(got, want)
        jloss = jlm.lm_loss(jax.tree.map(jnp.asarray, jparams_np), jnp.asarray(toks),
                            jnp.asarray(tgts), JCFG, seq_axis=None, tp_axis=None,
                            attn_impl="flash", axes=())
        assert float(got) == pytest.approx(float(jloss), rel=TOL)
    with pytest.raises(ValueError, match="other parameter"):
        ev(tfm.from_jax_params(jparams_np), _torch(toks), _torch(tgts))


def test_dropped_step_frees_its_program_at_once(jparams_np):
    """The step's function closes over its buffers and tensors, not over
    the step: dropping the step frees the program (on the card its graph)
    without the garbage collector."""
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params, "adam")
    gc.disable()
    try:
        step = tlm.make_lm_train_step(CFG, lr=0.01, optimizer="adam", with_health=True)
        loss, health = step(params, mom, *(_torch(x) for x in _batch()))
        assert set(health) == {"loss", "grad_norm", "all_finite"} and bool(health["all_finite"])
        refs = [weakref.ref(step.program), weakref.ref(step)]
        del step
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
