"""Named remat policies (`remat_policy`, a `jax.checkpoint_policies` name)
in the port, on one process on the CPU: `models/transformer.py`
`remat_block` maps dots_saveable / checkpoint_dots (save every matmul's
output), dots_with_no_batch_dims_saveable /
checkpoint_dots_with_no_batch_dims (the 2-D products only),
nothing_saveable (recompute the block) and everything_saveable (recompute
nothing) onto torch's selective activation checkpointing; the six other
names are factories, which the JAX package cannot use bare (TypeError at
its first step) and the port refuses with a TypeError.

Held here: each mapped policy's loss and gradients bitwise the run without
remat (plain attention and the flash kernels' plain versions), and within
2e-5 of JAX `lm_loss` under the same policy (tests/test_transformer.py's
pattern); the policies keep different amounts between forward and
backward: the bytes a forward leaves allocated (torch.profiler's CPU
memory events; an outer `saved_tensors_hooks` sees only the checkpoint's
input under every policy) order as nothing_saveable < the no-batch dots <
dots_saveable < everything_saveable; the CLI trains with each policy (the
same losses as --remat), and its two errors are the JAX CLI's texts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.train import lm as jlm
from distributed_neural_network_tpu_torch import lm_train
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.train import lm as tlm

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, S, TOL = 4, 16, 2e-5
POLICIES = ("", "dots_saveable", "checkpoint_dots", "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims", "nothing_saveable", "everything_saveable")
TINY = ["--device", "cpu", "--steps", "3", "--batch-size", "4", "--seq-len", "16",
        "--vocab", "32", "--d-model", "32", "--n-heads", "4", "--n-layers", "2",
        "--d-ff", "64", "--log-every", "1"]


def _batch():
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 32, size=(B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.fixture(scope="module")
def jparams_np():
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(4),
                                                     jtfm.TransformerConfig(**KW)))


def _port_loss_grads(jparams_np, cfg, attn):
    params = tfm.from_jax_params(jparams_np)
    leaves = tlm.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    toks, tgts = (torch.from_numpy(x).long() for x in _batch())
    loss = tlm.lm_loss(params, toks, tgts, cfg, attn_impl=attn)
    loss.backward()
    return loss.detach(), [x.grad for x in leaves]


def test_the_names_are_jax_checkpoint_policies():
    names = tuple(n for n in dir(jax.checkpoint_policies) if not n.startswith("_"))
    assert tfm.REMAT_POLICIES == names
    assert set(tfm.REMAT_SAVES) | set(tfm.REMAT_FACTORIES) == set(names)


@pytest.mark.parametrize("attn", ["ring", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_changes_no_number(jparams_np, policy, attn):
    """Loss and gradients under the policy bitwise those without remat."""
    base = tfm.TransformerConfig(**KW)
    l0, g0 = _port_loss_grads(jparams_np, base, attn)
    l1, g1 = _port_loss_grads(jparams_np, dataclasses.replace(base, remat=True,
                                                              remat_policy=policy), attn)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_under_the_same_policy(n_devices, jparams_np, policy):
    cfg = jtfm.TransformerConfig(**KW, remat=True, remat_policy=policy)
    toks, tgts = (jnp.asarray(x) for x in _batch())
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, toks, tgts, cfg, seq_axis=None, tp_axis=None,
                              attn_impl="full", axes=())))(jax.tree.map(jnp.asarray, jparams_np))
    got_l, got_g = _port_loss_grads(
        jparams_np, tfm.TransformerConfig(**KW, remat=True, remat_policy=policy), "ring")
    assert float(got_l) == pytest.approx(float(want_l), rel=TOL)
    for a, b in zip(got_g, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def _forward_bytes(policy):
    """The bytes a forward leaves allocated for its backward (its outputs
    included): the sum of torch.profiler's CPU memory events over it."""
    from torch.profiler import ProfilerActivity, profile

    cfg = tfm.TransformerConfig(**dict(KW, d_model=64, d_ff=256), remat=True,
                                remat_policy=policy)
    params = tfm.init_params(0, cfg)
    for x in tlm.tree_leaves(params):
        x.requires_grad_(True)
    toks = torch.randint(0, 32, (B, 2 * S), generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        x, _ = tfm.apply_hidden(params, toks, cfg, attn_impl="ring")
    held = sum(e.self_cpu_memory_usage for e in prof.events())
    x.float().sum().backward()
    return held


def test_policies_differ_in_what_they_keep():
    held = {p: _forward_bytes(p) for p in ("nothing_saveable", "dots_with_no_batch_dims_saveable",
                                            "dots_saveable", "everything_saveable", "")}
    assert held[""] == held["nothing_saveable"]
    assert (held["nothing_saveable"] < held["dots_with_no_batch_dims_saveable"]
            < held["dots_saveable"] < held["everything_saveable"]), held


def test_saved_tensor_hooks_see_only_the_checkpoint_input():
    """Why the bytes above come from the profiler: an outer
    `saved_tensors_hooks` sees the same tensors under every policy that
    checkpoints (the blocks' inputs; the policy's saves live inside the
    checkpoint)."""
    seen = {}
    for policy in ("nothing_saveable", "dots_saveable"):
        cfg = tfm.TransformerConfig(**KW, remat=True, remat_policy=policy)
        params = tfm.init_params(0, cfg)
        x = torch.randn(B, S, KW["d_model"], generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, _ = tfm.remat_block(lambda x: tfm.transformer_block(
                x, tfm._layer(params, 0, cfg.dtype), cfg,
                lambda q, k, v: tfm.attention(q, k, v, causal=True)), x, cfg)
        y.sum().backward()
        seen[policy] = sizes
    assert seen["nothing_saveable"] == seen["dots_saveable"]


@pytest.mark.parametrize("name", tfm.REMAT_FACTORIES)
def test_factory_names_fail_in_jax_and_raise_in_the_port(n_devices, name):
    """A factory used bare as a policy: the JAX package raises TypeError at
    its first step; the port refuses it with a TypeError up front."""
    cfg = jtfm.TransformerConfig(**KW, remat=True, remat_policy=name)
    params = jtfm.init_params(jax.random.key(0), cfg)
    toks, tgts = (jnp.asarray(x) for x in _batch())
    with pytest.raises(TypeError):
        jax.value_and_grad(lambda p: jlm.lm_loss(p, toks, tgts, cfg, seq_axis=None, tp_axis=None,
                                                 attn_impl="full", axes=()))(params)
    with pytest.raises(TypeError, match="factory"):
        tfm.TransformerConfig(**KW, remat=True, remat_policy=name)


@pytest.mark.parametrize("policy", [p for p in POLICIES if p])
def test_cli_trains_with_each_policy(policy):
    """`--remat --remat-policy NAME`: the losses of `--remat` alone."""
    def losses(extra):
        lines = []
        assert lm_train.main(TINY + ["--remat"] + extra, log=lines.append) == 0
        return [line for line in lines if line.startswith("step ")]

    assert losses(["--remat-policy", policy]) == losses([])


@pytest.mark.parametrize("argv", [["--remat-policy", "dots_saveable"],
                                  ["--remat", "--remat-policy", "bogus"]])
def test_cli_errors_are_the_jax_texts(n_devices, monkeypatch, capsys, argv):
    from test_torch_lm_cli import _jax_cli_error, _port_error

    args = [a for a in TINY if a not in ("--device", "cpu")] + argv
    assert _port_error(capsys, args) == _jax_cli_error(monkeypatch, capsys, args)
