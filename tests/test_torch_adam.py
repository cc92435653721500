"""The port's `ops/adam.py` against the JAX package's: three Adam/AdamW
steps from the same parameters, gradients and state, within atol = rtol =
1e-6 (f32 elementwise math; the two may fuse a multiply-add differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops import adam as ja
from distributed_neural_network_tpu_torch.ops import adam as ta

TOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}


def _order(tree):
    return [tree["a"], tree["b"]["c"]]


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("b1", [0.9, 0.5])
def test_adam_steps_match_jax(weight_decay, b1):
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = ja.init_adam(jp)
    tp = [torch.from_numpy(x.copy()) for x in _order(params)]
    tstate = ta.init_adam(tp)
    for i in range(3):
        g = _tree(10 + i)
        jp, jstate = ja.adam_step(jp, jstate, jax.tree.map(jnp.asarray, g), 0.01, b1=b1,
                                  weight_decay=weight_decay)
        ta.adam_step(tp, tstate, [torch.from_numpy(x) for x in _order(g)], 0.01, b1=b1,
                     weight_decay=weight_decay)
    assert tstate["t"] == int(jstate["t"]) == 3
    for got, want in ((tp, _order(jp)), (tstate["m"], _order(jstate["m"])),
                      (tstate["v"], _order(jstate["v"]))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_bias_corrections_and_guard():
    for t in (1, 2, 10):
        c1, c2 = ta.bias_corrections(t, 0.9, 0.999)
        j1, j2 = ja.bias_corrections(jnp.int32(t), 0.9, 0.999)
        assert (c1, c2) == pytest.approx((float(j1), float(j2)), rel=1e-7)
    params = [torch.ones(3)]
    state = ta.init_adam(params)
    # the guarded step counts on the device: its counter is a 0-d tensor
    state["t"] = torch.zeros((), dtype=torch.int32)
    ta.guarded_adam_step(params, state, [torch.ones(3)], 0.1, ok=torch.tensor(False))
    assert int(state["t"]) == 0 and torch.equal(params[0], torch.ones(3))
    ta.guarded_adam_step(params, state, [torch.ones(3)], 0.1, ok=True)
    assert int(state["t"]) == 1 and not torch.equal(params[0], torch.ones(3))
