"""The LM on the model axis: the port's `make_lm_train_step` on process
groups of 2 and 4 gloo ranks on the CPU (tests/torch_rank_worker.py, one
launch per world size with all of its cases, every rank at
OMP_NUM_THREADS=1) against the JAX package's `make_lm_train_step` on the
same `create_lm_mesh(dp, sp, tp)` over the 8 virtual CPU devices, from one
JAX `init_params` tree (handed to the ranks as numpy and cut per rank by
`shard_params`) and the same global numpy batches, for three steps.

Cases: (1, 1, 2) sgd, flash (the kernels' plain versions on the CPU), adam
with clip 0.5 and weight decay 0.01, and attn_quant="int8" (against
`jax.grad` of the JAX loss whose flash attention is the quantized Pallas
kernel in interpret mode: a straight-through backward, as the port's);
(2, 1, 2) sgd and overlap at accum 2 with ~10 KB buckets; (1, 1, 4) sgd.
The int8 case is one step (its loss, parameters and momentum, which is the
gradient), as the quantized cases of tests/test_torch_flash.py hold one
gradient: after an update the two packages' parameters differ by ~1e-6, and
an attention probability at a rounding boundary then takes the next int8
code in one of them (in one process as at tp 2).
Tolerance (f32): every step's loss within 2e-5 relative, every gathered
parameter and optimizer-state element (`gather_params`) within atol = rtol
= 2e-5; every rank's gathered parameters the same bits. Plus: zero with a
model axis raises the JAX ValueError, the rule table cuts the leaves as
JAX's specs shard them, and `per_leaf_sq_norms` at tp 2 (each rank its
shards) sums to the norm of the whole tree.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.train import lm as jlm

from torch_rank_worker import launch

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, S, STEPS, TOL = 8, 16, 3, 2e-5
SMALL_MB = 0.01  # ~10 KB: several buckets at this width
ENV = {"OMP_NUM_THREADS": "1"}
ADAM = {"optimizer": "adam", "lr": 0.01, "clip_norm": 0.5, "weight_decay": 0.01}
OVERLAP = {"grad_sync": "overlap", "accum_steps": 2, "bucket_mb": SMALL_MB}

# name -> (world, mesh, the port's make_lm_train_step arguments, the JAX
# reference's (None: the int8 reference), config fields over KW, steps)
CASES = {
    "tp2-sgd": (2, (1, 1, 2), {}, {}, {}, STEPS),
    "tp2-flash": (2, (1, 1, 2), {"attn_impl": "flash"}, {"attn_impl": "flash"}, {}, STEPS),
    "tp2-adam-clip-wd": (2, (1, 1, 2), ADAM, ADAM, {}, STEPS),
    "tp2-int8": (2, (1, 1, 2), {"attn_impl": "flash"}, None, {"attn_quant": "int8"}, 1),
    "dp2tp2-sgd": (4, (2, 1, 2), {}, {}, {}, STEPS),
    "dp2tp2-overlap": (4, (2, 1, 2), OVERLAP, OVERLAP, {}, STEPS),
    "tp4-sgd": (4, (1, 1, 4), {}, {}, {}, STEPS),
}
WORLDS = (2, 4)


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


@pytest.fixture(scope="module")
def jparams_np():
    return jax.tree.map(np.asarray,
                        jtfm.init_params(jax.random.key(3), jtfm.TransformerConfig(**KW)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jparams_np):
    """{case: [each rank's npz dict]}, and each world's per-rank norms."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("lm_tp")
    np.savez(d / "params.npz", **_flat(jparams_np))
    toks, tgts = _batches()
    np.savez(d / "batches.npz", tokens=toks, targets=tgts)
    jobs = {}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for w in WORLDS:
            (d / f"w{w}").mkdir()
            cases = [{"name": n, "mesh": list(m), "kw": kw, "cfg": c, "steps": steps}
                     for n, (world, m, kw, _, c, steps) in CASES.items() if world == w]
            spec = {"device": "cpu", "out": str(d / f"w{w}"),
                    "lm": {"params": str(d / "params.npz"), "batches": str(d / "batches.npz"),
                           "cfg": KW, "cases": cases},
                    "norms": {"seed": 5, "cfg": KW} if w == 2 else None}
            jobs[w] = pool.submit(launch, w, spec, timeout=240, env=ENV)
        for w, fut in jobs.items():
            for p in fut.result():
                assert p.returncode == 0, f"world {w}: {p.stderr[-3000:]}"
    out = {n: [dict(np.load(d / f"w{w}" / f"lm_{n}_rank{r}.npz")) for r in range(w)]
           for n, (w, *_) in CASES.items()}
    out["norms"] = [dict(np.load(d / "w2" / f"norms_rank{r}.npz")) for r in range(2)]
    return out


def _jax_run(jparams_np, mesh_shape, kw):
    """Three JAX steps on create_lm_mesh(*mesh_shape): (losses, flat
    params, state leaves)."""
    mesh = jlm.create_lm_mesh(*mesh_shape)
    cfg = jtfm.TransformerConfig(**KW)
    opt = kw.get("optimizer", "sgd")
    params, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np), cfg, mesh)
    mom = jlm.init_lm_momentum(params, mesh, opt)
    step = jlm.make_lm_train_step(cfg, mesh, **kw)
    toks, tgts = _batches()
    losses = []
    for i in range(STEPS):
        params, mom, loss = step(params, mom, jnp.asarray(toks[i]), jnp.asarray(tgts[i]))
        losses.append(float(loss))
    state = {k: v for k, v in mom.items() if k != "t"} if isinstance(mom, dict) else mom
    return (losses, _flat(jax.tree.map(np.asarray, params)),
            [np.asarray(x) for x in jax.tree.leaves(state)])


def _jax_int8_run(jparams_np, monkeypatch, steps):
    """`steps` SGD steps on `jax.grad` of the JAX `lm_loss` at attn_quant
    int8, its flash attention the quantized Pallas kernel in interpret mode
    (one tile: bq = bk = S)."""
    from distributed_neural_network_tpu.ops import flash as jflash
    from distributed_neural_network_tpu.ops.flash_pallas import FlashBlocks, flash_mha
    from distributed_neural_network_tpu.ops.sgd import init_momentum, sgd_step

    def interpreted(q, k, v, *, causal=True, impl=None, quant=None):
        return flash_mha(q, k, v, causal=causal, quant=quant, interpret=True,
                         blocks=FlashBlocks(bq=S, bk=S))

    monkeypatch.setattr(jflash, "flash_local_attention", interpreted)
    cfg = jtfm.TransformerConfig(**KW, attn_quant="int8")
    params = jax.tree.map(jnp.asarray, jparams_np)
    mom = init_momentum(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, a, b: jlm.lm_loss(p, a, b, cfg, seq_axis=None, tp_axis=None,
                                    attn_impl="flash", axes=())))
    toks, tgts = _batches()
    losses = []
    for i in range(steps):
        loss, grads = grad_fn(params, jnp.asarray(toks[i]), jnp.asarray(tgts[i]))
        params, mom = sgd_step(params, mom, grads, 0.1, 0.9)
        losses.append(float(loss))
    return (losses, _flat(jax.tree.map(np.asarray, params)),
            [np.asarray(x) for x in jax.tree.leaves(mom)])


def _state_keys(got, prefix="state/"):
    keys = [k for k in got if k.startswith(prefix)]

    def order(k):
        return [int(p) if p.isdigit() else p for p in k[len(prefix):].split("/")]

    return sorted(keys, key=order)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_jax(n_devices, jparams_np, ranks, case, monkeypatch):
    _, mesh_shape, _, jkw, _, steps = CASES[case]
    if jkw is None:
        want_loss, want_params, want_state = _jax_int8_run(jparams_np, monkeypatch, steps)
    else:
        want_loss, want_params, want_state = _jax_run(jparams_np, mesh_shape, jkw)
    got = ranks[case]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], want_loss, rtol=TOL, err_msg=f"rank {r}")
        for k, v in want_params.items():
            np.testing.assert_allclose(g["params/" + k], v, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} {k}")
            assert np.array_equal(g["params/" + k], got[0]["params/" + k]), (r, k)
    keys = _state_keys(got[0])
    assert len(keys) == len(want_state)
    for k, want in zip(keys, want_state):
        np.testing.assert_allclose(got[0][k].reshape(want.shape), want, atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_tp_overlap_buckets_never_mix_specs(ranks):
    """The overlap plan groups leaves by spec: its bucket count is
    `plan_buckets`' over the rank's (cut) leaves with the model-axis specs
    as keys, more than one replicated / sharded run."""
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.collectives import plan_buckets
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
    from distributed_neural_network_tpu_torch.train import lm as tlm

    import torch

    cfg = tfm.TransformerConfig(**KW)
    mesh = ProcessMesh(2, torch.device("cpu"), tp=2)
    params, specs = tlm.shard_params(tfm.init_params(0, cfg), cfg, mesh)
    keys = [str(s) for s in tlm.tree_leaves(specs)]
    assert len(set(keys)) > 2
    layout = plan_buckets(tlm.tree_leaves(params), bucket_bytes=int(SMALL_MB * 2**20),
                          group_keys=keys)
    for lo, hi in layout.buckets:
        assert len({keys[i] for i in range(lo, hi)}) == 1
    assert int(ranks["dp2tp2-overlap"][0]["n_buckets"]) == layout.n_buckets
    # the forward and backward run through copy_to_model / reduce_from_model:
    # on the CPU nothing is captured
    assert str(ranks["tp2-sgd"][0]["segments"]) == "eager (not captured)"


def test_shard_params_cuts_as_the_jax_specs(n_devices, jparams_np):
    """Each rank's block of every leaf is the shard JAX's `shard_params`
    places on that rank's device of create_lm_mesh(1, 1, 2)."""
    import torch

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
    from distributed_neural_network_tpu_torch.parallel.rules import named_leaves
    from distributed_neural_network_tpu_torch.train import lm as tlm

    cfg = tfm.TransformerConfig(**KW)
    jmesh = jlm.create_lm_mesh(1, 1, 2)
    jparams, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np),
                                  jtfm.TransformerConfig(**KW), jmesh)
    devices = list(jmesh.devices.reshape(-1))
    for r in range(2):
        mine, specs = tlm.shard_params(tfm.from_jax_params(jparams_np), cfg,
                                       ProcessMesh(1, torch.device("cpu"), rank=r, tp=2))
        for k, v in named_leaves(mine):
            leaf = jparams
            for part in k.split("/"):
                leaf = leaf[part]
            shard = next(s for s in leaf.addressable_shards if s.device == devices[r])
            np.testing.assert_array_equal(v.numpy(), np.asarray(shard.data),
                                          err_msg=f"rank {r} {k}")
    assert tuple(specs["layers"]["wq"]) == (None, None, "model")
    assert tuple(specs["layers"]["w2"]) == (None, "model", None)


def test_zero_with_a_model_axis_raises_the_jax_error(n_devices):
    import torch

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
    from distributed_neural_network_tpu_torch.train import lm as tlm

    for opt in ("zero", "zero-adam"):
        with pytest.raises(ValueError) as want:
            jlm.lm_wiring(jtfm.TransformerConfig(**KW), jlm.create_lm_mesh(1, 1, 2), opt)
        with pytest.raises(ValueError) as got:
            tlm.lm_wiring(tfm.TransformerConfig(**KW), ProcessMesh(1, torch.device("cpu"), tp=2),
                          opt)
        assert str(got.value) == str(want.value)


def test_norms_at_tp2_sum_to_the_whole_tree(ranks):
    """`per_leaf_sq_norms` with the model-axis specs: each rank's sums (of
    its shards, sharded leaves all-reduced over the model axis) are the
    whole tree's, and a replicated leaf counts once."""
    from torch_rank_worker import norm_inputs

    whole = norm_inputs(5, KW)
    want = [float(np.square(x.astype(np.float64)).sum()) for x in whole]
    for g in ranks["norms"]:
        np.testing.assert_allclose(g["per_leaf"], want, rtol=1e-5)
        assert float(g["global"]) == pytest.approx(np.sqrt(sum(want)), rel=1e-5)



@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2), (2, 2, 2), (2, 2, 1)])
def test_axis_groups_one_per_distinct_slice_made_once(shape, monkeypatch):
    """`make_axis_groups` makes one group for each distinct slice of more
    than one rank, in the same order on every rank (axes over the same
    ranks share it: at sp 1 the sync slices are the data slices), uses the
    default group for a slice that is the whole world, and makes a
    layout's groups once per process group."""
    from types import SimpleNamespace

    from distributed_neural_network_tpu_torch.parallel import mesh as M

    dp, sp, tp = shape
    world = dp * sp * tp
    made = []

    def new_group(ranks):
        made.append(tuple(ranks))
        return ("group",) + tuple(ranks)

    fake = SimpleNamespace(new_group=new_group, group=SimpleNamespace(WORLD=("group", "world")))
    monkeypatch.setattr(M, "dist", fake)
    monkeypatch.setattr(M, "_MADE", {"world": None})
    coords = [M.ProcessMesh(dp, "cpu", rank=r, sp=sp, tp=tp).coords for r in range(world)]
    free = {"data": (0,), "seq": (1,), "model": (2,), "sync": (0, 1)}
    orders = []
    for rank in range(world):
        M._MADE.clear()  # each rank's process makes the groups anew
        M._MADE["world"] = None
        made.clear()
        got = M.make_axis_groups(dp, sp, tp, rank)
        orders.append(list(made))
        assert len(made) == len(set(made))
        for name, axes in free.items():
            fixed = [i for i in range(3) if i not in axes]
            members = tuple(r for r in range(world)
                            if all(coords[r][i] == coords[rank][i] for i in fixed))
            if len(members) == 1:
                assert got[name] is None, name
            elif len(members) == world:
                assert got[name] is fake.group.WORLD, name
            else:
                assert got[name] == ("group",) + members, (name, rank)
        if sp == 1:
            assert got["sync"] is got["data"]
        # a second mesh of the layout in the same process group: no new group
        made.clear()
        assert M.make_axis_groups(dp, sp, tp, rank) is got and not made
    assert all(o == orders[0] for o in orders)
    # a new process group: the groups are made anew
    fake.group.WORLD = ("group", "world 2")
    made.clear()
    M.make_axis_groups(dp, sp, tp, 0)
    assert made == orders[0]
