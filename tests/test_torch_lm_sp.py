"""The sequence axis: the port's `parallel/ring.py` and the LM train step on
a sequence axis, on gloo ranks on the CPU (tests/torch_rank_worker.py, one
launch per world size with all of its cases, every rank at
OMP_NUM_THREADS=1), against the JAX package.

- `ring_attention`, `ulysses_attention`, `zigzag_ring_attention`: each
  rank's shard of the output and of the gradients of sum(o * w) against
  the JAX functions under `shard_map` over a ``seq`` mesh of as many
  devices (tests/test_ring.py's inputs: B 2, S 64, H 8, D 16), causal and
  not, zigzag at 2 and 4 ranks (outputs within 2e-5, gradients within
  tests/test_ring.py's 5e-5); the indivisible-heads error; the one-device
  ring and the squeezed single head in this process.
- The train step against JAX `make_lm_train_step` on the same
  `create_lm_mesh(dp, sp, tp)`: world 2 (1, 2, 1) ring, ulysses and zigzag
  (the batch in the zigzag layout, as both CLIs feed it), world 4 (2, 2, 1)
  ring and zero, (1, 4, 1) zigzag, world 8 (2, 2, 2) ring (the JAX test's
  own mesh). The LM width and tolerance are tests/test_torch_lm_tp.py's:
  every step's loss within 2e-5 relative, every gathered parameter and
  optimizer-state element within atol = rtol = 2e-5.
- flash and a quantized attention on a sequence axis raise the JAX
  ValueErrors.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.parallel import ring as jring
from distributed_neural_network_tpu.train import lm as jlm

from torch_rank_worker import launch

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, S, STEPS, TOL = 8, 16, 3, 2e-5
ENV = {"OMP_NUM_THREADS": "1"}
# tests/test_ring.py's attention inputs
AB, AS, AH, AD = 2, 64, 8, 16
ATTN_TOL = 2e-5

# name -> (world, mesh, make_lm_train_step arguments, both packages')
CASES = {
    "sp2-ring": (2, (1, 2, 1), {"attn_impl": "ring"}),
    "sp2-ulysses": (2, (1, 2, 1), {"attn_impl": "ulysses"}),
    "sp2-zigzag": (2, (1, 2, 1), {"attn_impl": "zigzag"}),
    "dp2sp2-ring": (4, (2, 2, 1), {"attn_impl": "ring"}),
    "dp2sp2-zero": (4, (2, 2, 1), {"attn_impl": "ring", "optimizer": "zero"}),
    "sp4-zigzag": (4, (1, 4, 1), {"attn_impl": "zigzag"}),
    "dp2sp2tp2-ring": (8, (2, 2, 2), {"attn_impl": "ring"}),
}
# name -> (world, fn, causal, heads)
ATTN = {
    "ring-causal": (4, "ring", True, None),
    "ring-full": (4, "ring", False, None),
    "ulysses-causal": (4, "ulysses", True, None),
    "ulysses-full": (4, "ulysses", False, None),
    "zigzag4": (4, "zigzag", True, None),
    "zigzag2": (2, "zigzag", True, None),
    "ring2-causal": (2, "ring", True, None),
    "ulysses-indivisible": (4, "ulysses", False, 2),
}
WORLDS = (2, 4, 8)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batches():
    rng = np.random.default_rng(11)
    toks = rng.integers(2, 32, size=(STEPS, B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=2)


def _qkvw():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(AB, AS, AH, AD)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jparams_np():
    return jax.tree.map(np.asarray,
                        jtfm.init_params(jax.random.key(3), jtfm.TransformerConfig(**KW)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jparams_np):
    """{case: [each rank's npz dict]} for the LM and attention cases."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("lm_sp")
    np.savez(d / "params.npz", **_flat(jparams_np))
    toks, tgts = _batches()
    np.savez(d / "batches.npz", tokens=toks, targets=tgts)
    q, k, v, w = _qkvw()
    np.savez(d / "qkv.npz", q=q, k=k, v=v, w=w)
    jobs = {}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for wd in WORLDS:
            (d / f"w{wd}").mkdir()
            cases = [{"name": n, "mesh": list(m), "kw": kw, "steps": STEPS}
                     for n, (world, m, kw) in CASES.items() if world == wd]
            attn = [{"name": n, "fn": fn, "causal": causal, "heads": heads}
                    for n, (world, fn, causal, heads) in ATTN.items() if world == wd]
            spec = {"device": "cpu", "out": str(d / f"w{wd}"),
                    "lm": {"params": str(d / "params.npz"), "batches": str(d / "batches.npz"),
                           "cfg": KW, "cases": cases},
                    "attn": {"qkv": str(d / "qkv.npz"), "cases": attn} if attn else None}
            jobs[wd] = pool.submit(launch, wd, spec, timeout=300, env=ENV)
        for wd, fut in jobs.items():
            for p in fut.result():
                assert p.returncode == 0, f"world {wd}: {p.stderr[-3000:]}"
    out = {n: [dict(np.load(d / f"w{w}" / f"lm_{n}_rank{r}.npz")) for r in range(w)]
           for n, (w, *_) in CASES.items()}
    out.update({n: [dict(np.load(d / f"w{w}" / f"attn_{n}_rank{r}.npz")) for r in range(w)]
                for n, (w, *_) in ATTN.items()})
    return out


def _jax_attention(n, fn, causal, q, k, v, w):
    """JAX `fn` under shard_map over a ``seq`` mesh of n devices: the whole
    output and the gradients of sum(o * w) (inputs already in the layout
    the ranks shard)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    if fn == "zigzag":
        def body(a, b, c):
            return jring.zigzag_ring_attention(a, b, c, "seq")
    else:
        f = jring.ring_attention if fn == "ring" else jring.ulysses_attention

        def body(a, b, c):
            return f(a, b, c, "seq", causal=causal)

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(JP(None, "seq"),) * 3,
                            out_specs=JP(None, "seq"))

    def loss(a, b, c):
        return (sharded(a, b, c) * w).sum()

    args = [jnp.asarray(x) for x in (q, k, v)]
    return np.asarray(jax.jit(sharded)(*args)), [
        np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]


@pytest.mark.parametrize("case", [c for c in ATTN if c != "ulysses-indivisible"])
def test_sequence_attention_matches_jax(n_devices, ranks, case):
    n, fn, causal, _ = ATTN[case]
    q, k, v, w = _qkvw()
    if fn == "zigzag":
        perm = jring.zigzag_order(AS, n)
        q, k, v, w = (x[:, perm] for x in (q, k, v, w))
    want_o, want_g = _jax_attention(n, fn, causal, q, k, v, jnp.asarray(w))
    got = ranks[case]
    whole = {x: np.concatenate([g[x] for g in got], axis=1) for x in ("o", "dq", "dk", "dv")}
    np.testing.assert_allclose(whole["o"], want_o, rtol=ATTN_TOL, atol=ATTN_TOL)
    for x, want in zip(("dq", "dk", "dv"), want_g):
        np.testing.assert_allclose(whole[x], want, rtol=5e-5, atol=5e-5, err_msg=x)


def test_ulysses_rejects_indivisible_heads(ranks):
    q = jnp.zeros((AB, AS, 2, AD), jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    with pytest.raises(ValueError) as want:
        jax.shard_map(lambda a: jring.ulysses_attention(a, a, a, "seq"), mesh=mesh,
                      in_specs=JP(None, "seq"), out_specs=JP(None, "seq"))(q)
    for g in ranks["ulysses-indivisible"]:
        assert str(g["error"]) == str(want.value)


def test_one_rank_ring_is_full_attention(n_devices):
    """An axis of one rank (or none): ring attention is the full attention,
    as JAX's ring over a one-device mesh."""
    import torch

    from distributed_neural_network_tpu_torch.parallel import ring
    from distributed_neural_network_tpu_torch.parallel.mesh import Axis

    q, k, v, w = _qkvw()
    want, _ = _jax_attention(1, "ring", True, q, k, v, jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for axis in (None, Axis("seq")):
        got = ring.ring_attention(tq, tk, tv, axis, causal=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ring.attention(tq, tk, tv, causal=True).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_single_head_squeezed_path_matches_jax(n_devices, causal):
    """H == 1 in all three takes the squeezed 3-D contraction, in value and
    gradient as JAX's (an offset causal mask included)."""
    import torch

    from distributed_neural_network_tpu_torch.parallel import ring

    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(AB, AS, 1, AD)).astype(np.float32) for _ in range(3))
    off = 3 if causal else 0
    want = jring.attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, q_offset=off)
    gw = jax.grad(lambda *a: (jring.attention(*a, causal=causal, q_offset=off) ** 2).sum(),
                  argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = ring.attention(*leaves, causal=causal, q_offset=off)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for t, g in zip(leaves, gw):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-5)
    # one q head against multi-head k/v keeps the generic broadcast
    kv = torch.from_numpy(rng.normal(size=(AB, AS, 4, AD)).astype(np.float32))
    assert ring.attention(leaves[0].detach(), kv, kv).shape == (AB, AS, 4, AD)


def _jax_run(jparams_np, mesh_shape, kw):
    mesh = jlm.create_lm_mesh(*mesh_shape)
    cfg = jtfm.TransformerConfig(**KW)
    opt = kw.get("optimizer", "sgd")
    params, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np), cfg, mesh)
    mom = jlm.init_lm_momentum(params, mesh, opt)
    step = jlm.make_lm_train_step(cfg, mesh, **kw)
    toks, tgts = _batches()
    if kw.get("attn_impl") == "zigzag":
        # the JAX CLI's zigzag layout of the global batch
        perm = jring.zigzag_order(S, mesh_shape[1])
        toks, tgts = toks[:, :, perm], tgts[:, :, perm]
    losses = []
    for i in range(STEPS):
        params, mom, loss = step(params, mom, jnp.asarray(toks[i]), jnp.asarray(tgts[i]))
        losses.append(float(loss))
    state = {k: v for k, v in mom.items() if k != "t"} if isinstance(mom, dict) else mom
    return (losses, _flat(jax.tree.map(np.asarray, params)),
            [np.asarray(x) for x in jax.tree.leaves(state)])


def _state_keys(got, prefix="state/"):
    keys = [k for k in got if k.startswith(prefix)]

    def order(k):
        return [int(p) if p.isdigit() else p for p in k[len(prefix):].split("/")]

    return sorted(keys, key=order)


@pytest.mark.parametrize("case", list(CASES))
def test_sp_step_matches_jax(n_devices, jparams_np, ranks, case):
    _, (dp, sp, tp), kw = CASES[case]
    want_loss, want_params, want_state = _jax_run(jparams_np, (dp, sp, tp), kw)
    got = ranks[case]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], want_loss, rtol=TOL, err_msg=f"rank {r}")
        for k, v in want_params.items():
            np.testing.assert_allclose(g["params/" + k], v, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} {k}")
            assert np.array_equal(g["params/" + k], got[0]["params/" + k]), (r, k)
    keys = _state_keys(got[0])
    assert len(keys) == len(want_state)
    # ZeRO: the rank at data index d holds shard d; JAX one (dp*S,) array
    data_ranks = [d * sp * tp for d in range(dp)]
    for k, want in zip(keys, want_state):
        if kw.get("optimizer", "sgd").startswith("zero"):
            whole = np.concatenate([got[r][k] for r in data_ranks])
        else:
            whole = got[0][k]
        np.testing.assert_allclose(whole.reshape(want.shape), want, atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_flash_and_quant_on_a_sequence_axis_raise_the_jax_errors(n_devices):
    import torch

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.mesh import Axis, ProcessMesh
    from distributed_neural_network_tpu_torch.train import lm as tlm

    x = jnp.zeros((1, 4, 2, 8))
    for impl, quant in (("flash", ""), ("ring", "int8"), ("zigzag", "fp8")):
        with pytest.raises(ValueError) as want:
            jtfm._attend(x, x, x, impl=impl, seq_axis="seq", s_local=4, quant=quant)
        with pytest.raises(ValueError) as got:
            tfm._attend_fn(impl, tfm.TransformerConfig(**KW, attn_quant=quant),
                           Axis("seq", 2, 0))
        assert str(got.value) == str(want.value)
    # both steps refuse flash with a sequence axis when they are made
    with pytest.raises(ValueError) as want:
        jlm.make_lm_train_step(jtfm.TransformerConfig(**KW), jlm.create_lm_mesh(1, 2, 1),
                               attn_impl="flash")
    with pytest.raises(ValueError) as got:
        tlm.make_lm_train_step(tfm.TransformerConfig(**KW),
                               mesh=ProcessMesh(1, torch.device("cpu"), sp=2), attn_impl="flash")
    assert str(got.value) == str(want.value)
