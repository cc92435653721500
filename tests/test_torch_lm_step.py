"""The slice gate: the port's `make_lm_train_step` against the JAX package's
on a 1x1x1 mesh, from the same parameters (a JAX `init_params` tree carried
across with `from_jax_params`) and the same numpy tokens, for three steps.

Off the TPU both JAX attention routes (``ring`` at sp 1 and ``flash``) are
the plain attention; the port's ``flash`` route is the flash kernels' plain
version (the CPU route of the same autograd Function).

Tolerances (f32): the loss of every step within 2e-5 relative; every
parameter after three steps within atol = rtol = 2e-5 (two float stacks
summing in other orders, compounded over three updates).

The guard's step (`skip_nonfinite` with a `StepFaultPlan` NaN-ing step 1's
gradients) is held the same way against the JAX step with the same
arguments, for every optimizer; the skipped step must leave the state and
Adam's counter as they were, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.ops import schedule as jsched
from distributed_neural_network_tpu.train import lm as jlm
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.ops import schedule as tsched
from distributed_neural_network_tpu_torch.train import lm as tlm

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG, CFG = jtfm.TransformerConfig(**KW), tfm.TransformerConfig(**KW)
TOL = 2e-5


def _batch(seed=0, b=4, s=16):
    toks = np.random.default_rng(seed).integers(2, 32, size=(b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.fixture(scope="module")
def jparams_np():
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), JCFG))


CASES = {
    "sgd-ring": {},
    "sgd-flash": {"attn_impl": "flash"},
    "adam": {"optimizer": "adam", "lr": 0.01},
    "cosine-clip-wd": {"lr_schedule": "cosine", "clip_norm": 0.5, "weight_decay": 0.01},
    "adam-cosine-clip-wd-flash": {"optimizer": "adam", "lr": 0.01, "lr_schedule": "cosine",
                                  "clip_norm": 0.5, "weight_decay": 0.01,
                                  "attn_impl": "flash"},
    "accum2": {"accum_steps": 2},
    "chunks4": {"loss_chunks": 4},
    "chunks1-flash": {"loss_chunks": 1, "attn_impl": "flash"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(n_devices, jparams_np, case):
    kw = dict(lr=0.1, momentum=0.9, attn_impl="ring", optimizer="sgd", loss_chunks=0,
              clip_norm=0.0, accum_steps=1, weight_decay=0.0)
    kw.update(CASES[case])
    sched = kw.pop("lr_schedule", None)
    sk = dict(base_lr=kw["lr"], total_steps=3, warmup_steps=1, min_lr_frac=0.1)
    mesh = jlm.create_lm_mesh(1, 1, 1)
    jparams, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np), JCFG, mesh)
    jmom = jlm.init_lm_momentum(jparams, mesh, kw["optimizer"])
    jstep = jlm.make_lm_train_step(
        JCFG, mesh, lr_schedule=functools.partial(jsched.warmup_cosine, **sk) if sched else None,
        **kw)
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params, kw["optimizer"])
    step = tlm.make_lm_train_step(
        CFG, device="cpu",
        lr_schedule=functools.partial(tsched.warmup_cosine, **sk) if sched else None, **kw)
    for i in range(3):
        toks, tgts = _batch(seed=i)
        extra = (jnp.int32(i),) if sched else ()
        jparams, jmom, jloss = jstep(jparams, jmom, jnp.asarray(toks), jnp.asarray(tgts), *extra)
        loss = step(params, mom, torch.from_numpy(toks).long(), torch.from_numpy(tgts).long(), i)
        assert float(loss) == pytest.approx(float(jloss), rel=TOL), f"step {i}"
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = [p.detach().numpy() for p in tlm.tree_leaves(params)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "zero", "zero-adam"])
def test_skip_step_matches_jax_and_freezes_the_skipped_step(n_devices, jparams_np,
                                                             optimizer):
    """The guarded step with NaN gradients at step 1, three steps, against
    JAX `make_lm_train_step` with the same arguments: the losses, the health
    and the parameters within TOL; step 1 leaves the parameters, the
    optimizer state and Adam's counter as they were, bit for bit."""
    from distributed_neural_network_tpu.parallel.fault import StepFaultPlan as JPlan
    from distributed_neural_network_tpu_torch.parallel.fault import StepFaultPlan

    mesh = jlm.create_lm_mesh(1, 1, 1)
    jcfg = JCFG
    jparams, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np), jcfg, mesh)
    jmom = jlm.init_lm_momentum(jparams, mesh, optimizer)
    lr = 0.01 if "adam" in optimizer else 0.1
    jstep = jlm.make_lm_train_step(jcfg, mesh, lr=lr, optimizer=optimizer, skip_nonfinite=True,
                                   fault_plan=JPlan(nan_grads_at=(1,)))
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params, optimizer)
    step = tlm.make_lm_train_step(CFG, device="cpu", lr=lr, optimizer=optimizer,
                                  skip_nonfinite=True,
                                  fault_plan=StepFaultPlan(nan_grads_at=(1,)))
    for i in range(3):
        toks, tgts = _batch(seed=i)
        jparams, jmom, jloss, jh = jstep(jparams, jmom, jnp.asarray(toks), jnp.asarray(tgts),
                                         jnp.int32(i))
        before = _guarded_state(params, mom)
        t_before = tlm.adam_count(mom) if isinstance(mom, dict) else None
        loss, h = step(params, mom, torch.from_numpy(toks).long(),
                       torch.from_numpy(tgts).long(), i)
        assert float(loss) == pytest.approx(float(jloss), rel=TOL)
        assert bool(h["all_finite"]) == bool(jh["all_finite"]) == (i != 1)
        if i == 1:
            assert all(torch.equal(a, b) for a, b in zip(before, _guarded_state(params, mom)))
            if t_before is not None:
                assert tlm.adam_count(mom) == t_before == 1
        else:
            assert float(h["grad_norm"]) == pytest.approx(float(jh["grad_norm"]), rel=1e-4)
    if isinstance(mom, dict):
        assert tlm.adam_count(mom) == int(jmom["t"]) == 2
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = [p.detach().numpy() for p in tlm.tree_leaves(params)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def _guarded_state(params, mom):
    state = mom if isinstance(mom, list) else mom["m"] + mom["v"]
    return [x.detach().clone() for x in tlm.tree_leaves(params) + state]




@pytest.mark.parametrize("remat", ["remat", "remat_attn"])
def test_remat_gives_the_same_numbers(jparams_np, remat):
    """Recomputing blocks (or only attention) in backward changes no number."""
    toks, tgts = (torch.from_numpy(x).long() for x in _batch(seed=5))
    results = []
    for cfg in (CFG, tfm.TransformerConfig(**KW, **{remat: True})):
        params = tfm.from_jax_params(jparams_np)
        mom = tlm.init_lm_momentum(params)
        step = tlm.make_lm_train_step(cfg, lr=0.1, attn_impl="flash")
        losses = [float(step(params, mom, toks, tgts)) for _ in range(2)]
        results.append((losses, [p.detach().clone() for p in tlm.tree_leaves(params)]))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("attn", ["ring", "flash"])
def test_int8_forward_loss_matches_jax(n_devices, jparams_np, attn):
    """--precision int8's forward loss at S = 16 (below every k tile, so the
    kernel's per-tile p codes are per-row): the port's flash route (the
    quantized kernel's plain version) and ring route (quantized_attention)
    against the JAX lm_loss, which runs quantized_attention off the TPU."""
    toks, tgts = _batch(seed=7)
    want = jlm.lm_loss(jax.tree.map(jnp.asarray, jparams_np), jnp.asarray(toks),
                       jnp.asarray(tgts), jtfm.TransformerConfig(**KW, attn_quant="int8"),
                       seq_axis=None, tp_axis=None, attn_impl=attn, axes=())
    got = tlm.lm_loss(tfm.from_jax_params(jparams_np), torch.from_numpy(toks).long(),
                      torch.from_numpy(tgts).long(), tfm.TransformerConfig(**KW, attn_quant="int8"),
                      attn_impl=attn)
    assert float(got) == pytest.approx(float(want), rel=TOL)


def test_copy_task_and_chunking():
    toks, tgts = tlm.make_copy_task(torch.Generator().manual_seed(0), batch=3, seq_len=9,
                                    vocab=20)
    assert torch.equal(toks[:, :4], toks[:, 5:9]) and torch.equal(tgts, toks.roll(-1, 1))
    assert int(toks.min()) >= 2 and int(toks.max()) < 20
    for b, s, v in ((16, 2048, 32768), (4, 16, 32), (2, 100, 50000)):
        assert tlm.auto_loss_chunks(b, s, v) == jlm.auto_loss_chunks(b, s, v)
    # zero at dp 1 holds one shard, the whole of each leaf; a sequence axis
    # needs a process group of its size (torchrun)
    params = tfm.init_params(0, CFG)
    assert [m.shape for m in tlm.init_lm_momentum(params, "zero")] == [
        (p.numel(),) for p in tlm.tree_leaves(params)]
    assert tlm.make_lm_train_step(CFG, grad_sync="overlap").overlap is False
    with pytest.raises(ValueError, match="--nproc-per-node 2 .* --dp 1 --sp 2"):
        tlm.create_lm_mesh(1, 2, 1, device="cpu")
