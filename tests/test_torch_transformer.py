"""The port's transformer (`models/transformer.py`) against the JAX
package's: the same parameters (a JAX `init_params` tree carried across with
`from_jax_params`) and the same numpy tokens through both.

Tolerances: teacher-forced logits at f32 atol = rtol = 1e-4 (two float
stacks, sums in other orders); greedy `generate` tokens exactly equal at f32
(the JAX default XLA route against the port's CPU route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu_torch.models import transformer as tfm

JCFG = jtfm.TransformerConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
CFG = tfm.TransformerConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return tfm.from_jax_params(jax.tree.map(np.asarray, jparams))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(2, 32, size=shape).astype(np.int32)


def test_apply_logits_match_jax(n_devices, jparams, params):
    toks = _tokens(1, (2, 12))
    want = jtfm.apply(jparams, jnp.asarray(toks), JCFG, attn_impl="full")
    got = tfm.apply(params, torch.from_numpy(toks).long(), CFG)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prompt_len,new", [(5, 10), (1, 6)])
def test_greedy_generate_matches_jax(n_devices, jparams, params, prompt_len, new):
    prompt = _tokens(2 + prompt_len, (3, prompt_len))
    want = np.asarray(jtfm.generate(jparams, jnp.asarray(prompt), JCFG, max_new_tokens=new))
    got = tfm.generate(params, torch.from_numpy(prompt).long(), CFG, max_new_tokens=new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_left_padded_generate_matches_jax(n_devices, jparams, params):
    prompt = _tokens(9, (2, 6))
    lens = np.array([6, 3], np.int32)
    want = np.asarray(jtfm.generate(jparams, jnp.asarray(prompt), JCFG, max_new_tokens=5,
                                    prompt_lens=jnp.asarray(lens)))
    got = tfm.generate(params, torch.from_numpy(prompt).long(), CFG, max_new_tokens=5,
                       prompt_lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_from_jax_params_round_trip(jparams, params):
    tree = jax.tree.map(np.asarray, jparams)
    back = tfm.to_numpy(params)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tfm.param_count(params) == jtfm.param_count(jparams)
    # the port's own seeded init has the JAX package's shapes
    own = tfm.to_numpy(tfm.init_params(0, CFG))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree)


def test_pieces_match_jax():
    """gelu is the tanh form (jax.nn.gelu's default); the sinusoid table is
    sin then cos, concatenated; the layer norm is the JAX package's."""
    x = np.random.default_rng(4).normal(size=(3, 32)).astype(np.float32)
    np.testing.assert_allclose(tfm.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert not np.allclose(tfm.gelu(torch.from_numpy(x)).numpy(),
                           np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                           rtol=1e-6, atol=1e-6)
    pos = np.arange(40)
    np.testing.assert_allclose(
        tfm._sinusoid_pe(torch.from_numpy(pos), 32, torch.float32).numpy(),
        np.asarray(jtfm._sinusoid_pe(jnp.asarray(pos), 32, jnp.float32)), rtol=1e-5, atol=1e-5)
    sc, b = np.linspace(0.5, 1.5, 32, dtype=np.float32), np.linspace(-1, 1, 32, dtype=np.float32)
    np.testing.assert_allclose(
        tfm._layer_norm(*map(torch.from_numpy, (x, sc, b))).numpy(),
        np.asarray(jtfm._layer_norm(*map(jnp.asarray, (x, sc, b)))), rtol=1e-5, atol=1e-5)


def test_sampling_is_seeded_and_filters_hold(params):
    prompt = torch.from_numpy(_tokens(5, (2, 4))).long()

    def run(seed, **kw):
        return tfm.generate(params, prompt, CFG, max_new_tokens=8, temperature=1.0,
                            generator=torch.Generator().manual_seed(seed), **kw)

    a, b = run(3), run(3)
    assert torch.equal(a, b)
    assert not torch.equal(run(3), run(4))
    greedy = tfm.generate(params, prompt, CFG, max_new_tokens=8)
    assert torch.equal(run(5, top_k=1), greedy)
    assert torch.equal(run(6, top_p=1e-6), greedy)
    with pytest.raises(ValueError, match="generator"):
        tfm.generate(params, prompt, CFG, max_new_tokens=2, temperature=1.0)


def test_later_slice_features_raise(params):
    # a config with experts (tests/test_torch_lm_moe.py) takes the JAX MoE
    # defaults and the JAX parameter skeleton
    moe = tfm.TransformerConfig(n_experts=2)
    jmoe = jtfm.TransformerConfig(n_experts=2)
    for f in ("moe_top_k", "moe_capacity_factor", "moe_dispatch", "moe_z_weight"):
        assert getattr(moe, f) == getattr(jmoe, f), f
    assert tfm.param_skeleton(moe) == jtfm.param_skeleton(jmoe)
    with pytest.raises(ValueError, match="moe_dispatch"):
        tfm.TransformerConfig(n_experts=2, moe_dispatch="scatter")
    # named remat policies run now (tests/test_torch_remat.py); a factory name
    # or a name jax.checkpoint_policies lacks is refused
    tfm.TransformerConfig(remat=True, remat_policy="dots_saveable")
    with pytest.raises(TypeError, match="factory"):
        tfm.TransformerConfig(remat=True, remat_policy="save_only_these_names")
    with pytest.raises(ValueError, match="not a jax.checkpoint_policies name"):
        tfm.TransformerConfig(remat=True, remat_policy="bogus")
    with pytest.raises(ValueError, match="attn impl"):
        tfm.apply(params, torch.zeros(1, 4, dtype=torch.long), CFG, attn_impl="sharded")
    with pytest.raises(ValueError, match="CUDA device"):
        tfm.generate(params, torch.zeros(1, 4, dtype=torch.long), CFG, max_new_tokens=2,
                     decode_impl="cuda")


@pytest.mark.parametrize("attn_impl", ["ring", "flash"])
def test_differentiable_forward_grads_match_jax(n_devices, jparams, attn_impl):
    """Gradients of sum(logits * w) with respect to every f32 leaf, through
    the port's autograd (the per-layer casts inside the graph) against
    jax.grad of the JAX forward; flash is the kernels' plain route here."""
    toks = _tokens(11, (2, 10))
    w = np.random.default_rng(12).normal(size=(2, 10, 32)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jtfm.apply(p, jnp.asarray(toks), JCFG, attn_impl=attn_impl) * w)

    want = jax.grad(jloss)(jparams)
    params = tfm.from_jax_params(jax.tree.map(np.asarray, jparams))
    leaves = [p.requires_grad_() for p in jax.tree.leaves(params)]
    logits, aux = tfm.apply_with_aux(params, torch.from_numpy(toks).long(), CFG,
                                     attn_impl=attn_impl)
    assert float(aux) == 0.0
    (logits * torch.from_numpy(w)).sum().backward()
    for got, exp in zip(leaves, jax.tree.leaves(want)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", ["remat", "remat_attn"])
def test_remat_changes_no_number(params, flag):
    toks = torch.from_numpy(_tokens(13, (2, 8))).long()
    outs = []
    for cfg in (CFG, tfm.TransformerConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2,
                                           d_ff=64, **{flag: True})):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in params["layers"].items()}
        p = {**params, "layers": leaves}
        logits = tfm.apply(p, toks, cfg, attn_impl="flash")
        logits.square().sum().backward()
        outs.append((logits.detach(), [leaves[k].grad for k in sorted(leaves)]))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-6, rtol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
