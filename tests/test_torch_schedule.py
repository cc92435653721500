"""The port's `ops/schedule.py` against the JAX package's, on the same
numpy inputs.

Tolerances: learning rates within 1e-6 relative (numpy's and XLA's f32 cos
differ in the last bit, and 1 + cos cancels near the end of the decay); norms, clipped gradients, decayed params and the EMA
within atol = rtol = 1e-6 (f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops import schedule as js
from distributed_neural_network_tpu_torch.ops import schedule as ts

TOL = 1e-6


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]


@pytest.mark.parametrize("warmup,min_frac", [(0, 0.0), (3, 0.1), (10, 0.0)])
def test_schedules_match_jax(warmup, min_frac):
    kw = dict(base_lr=0.3, total_steps=10, warmup_steps=warmup, min_lr_frac=min_frac)
    for step in range(14):
        want = float(js.warmup_cosine(jnp.int32(step), **kw))
        assert ts.warmup_cosine(step, **kw) == pytest.approx(want, rel=1e-6)
        assert ts.constant_lr(step, base_lr=0.3) == float(js.constant_lr(jnp.int32(step),
                                                                          base_lr=0.3))
    assert set(ts.SCHEDULES) == set(js.SCHEDULES)
    with pytest.raises(ValueError, match="warmup_steps"):
        ts.warmup_cosine(0, base_lr=0.1, total_steps=5, warmup_steps=6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_norms_clip_and_health_match_jax(max_norm):
    g = _leaves(1, scale=2.0)
    jg = [jnp.asarray(x) for x in g]
    tg = [torch.from_numpy(x.copy()) for x in g]
    want_norm = float(js.global_norm(jg))
    assert float(ts.global_norm(tg)) == pytest.approx(want_norm, rel=TOL)
    for a, b in zip(ts.per_leaf_sq_norms(tg), js.per_leaf_sq_norms(jg)):
        assert float(a) == pytest.approx(float(b), rel=TOL)
    clipped, jnorm = js.clip_by_global_norm(jg, max_norm)
    norm = ts.clip_by_global_norm(tg, max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=TOL)
    for a, b in zip(tg, clipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    health = ts.health_bundle(torch.tensor(2.5), norm)
    jhealth = js.health_bundle(jnp.float32(2.5), jnorm)
    assert bool(health["all_finite"]) == bool(jhealth["all_finite"])
    assert not bool(ts.health_bundle(torch.tensor(float("nan")), norm)["all_finite"])
    # mesh-aware: replicated specs on the data axis add nothing in one
    # process (the step has already summed their gradients); the specs
    # must align with the leaves
    from distributed_neural_network_tpu_torch.parallel.partition import PartitionSpec as P

    specs = [P()] * len(tg)
    assert float(ts.global_norm(tg, specs=specs, axes=("data",))) == float(ts.global_norm(tg))
    with pytest.raises(ValueError, match="specs"):
        ts.global_norm(tg, specs=specs[:1], axes=("data",))


def test_weight_decay_and_ema_match_jax():
    p = _leaves(2)
    tp = [torch.from_numpy(x.copy()) for x in p]
    ts.apply_decoupled_weight_decay(tp, 0.1, 0.01)
    want = js.apply_decoupled_weight_decay([jnp.asarray(x) for x in p], jnp.float32(0.1), 0.01)
    for a, b in zip(tp, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    ema, new = _leaves(3), _leaves(4)
    tema = [torch.from_numpy(x.copy()) for x in ema]
    ts.make_ema_update(0.9)(tema, [torch.from_numpy(x) for x in new])
    want = js.make_ema_update(0.9)([jnp.asarray(x) for x in ema], [jnp.asarray(x) for x in new])
    for a, b in zip(tema, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="decay"):
        ts.make_ema_update(1.0)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_accumulation_matches_jax(k):
    """Mean loss and mean gradient of a toy least-squares loss over k
    micro-batches, against the JAX end-sync accumulation scan."""
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(3,)).astype(np.float32)
    xs = rng.normal(size=(8, 3)).astype(np.float32)
    ys = rng.normal(size=(8, 1)).astype(np.float32)  # (B, 1), as the scan slices targets

    def jloss(w, x, y):
        return jnp.mean(((x @ w)[:, None] - y) ** 2)

    want_loss, want_g = js.accumulate_fwd_bwd(jax.value_and_grad(jloss), k)(
        jnp.asarray(w0), jnp.asarray(xs), jnp.asarray(ys))
    w = torch.from_numpy(w0.copy()).requires_grad_()

    def one(x, y):
        loss = (((x @ w)[:, None] - y) ** 2).mean()
        loss.backward()
        return loss.detach()

    loss = ts.accumulate_fwd_bwd(one, k)([w], torch.from_numpy(xs), torch.from_numpy(ys))
    assert float(loss) == pytest.approx(float(want_loss), rel=TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_g), atol=TOL, rtol=TOL)
    # the overlapped form (collective inside the loop; here the identity
    # reduce of one device) against JAX's, and k = 1 refused by both
    if k == 1:
        with pytest.raises(ValueError, match="accum_steps >= 2"):
            ts.accumulate_fwd_bwd_overlap(one, k, reduce_fn=list, finalize_fn=list)
        with pytest.raises(ValueError, match="accum_steps >= 2"):
            js.accumulate_fwd_bwd_overlap(None, k, reduce_fn=None, finalize_fn=None)
        return
    jl, jg = js.accumulate_fwd_bwd_overlap(
        lambda w, x, y: jax.value_and_grad(jloss)(w, x, y), k, reduce_fn=lambda g: (g,),
        finalize_fn=lambda r: r[0])(jnp.asarray(w0), jnp.asarray(xs), jnp.asarray(ys))
    w.grad = None
    loss, grads = ts.accumulate_fwd_bwd_overlap(one, k, reduce_fn=list, finalize_fn=list)(
        [w], torch.from_numpy(xs), torch.from_numpy(ys))
    assert w.grad is None
    assert float(loss) == pytest.approx(float(jl), rel=TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg), atol=TOL, rtol=TOL)
