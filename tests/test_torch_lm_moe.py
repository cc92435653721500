"""The LM with mixture-of-experts layers: the port's `models/transformer.py`,
`train/lm.py` and `parallel/pipeline.py` with ``n_experts`` against the JAX
package's, from one JAX `init_params` tree (d32/L2/H4, d_ff 64, vocab 32,
4 experts at the JAX defaults: top-2, capacity factor 2.0, sort dispatch,
z-loss weight 0.1) and the same numpy batches.

- `apply_with_aux`: logits and aux (the sort and dense dispatch, and under
  --remat) within 1e-4, as tests/test_torch_transformer.py's logits.
- `make_lm_train_step`, 3 steps at (dp, sp, tp) = (1, 1, 1) sgd and adam in
  this process, and on gloo ranks (tests/torch_rank_worker.py, one launch
  per world size, OMP_NUM_THREADS=1): (2, 1, 1) sgd (the experts over the
  data axis), adam with clip 0.5 (the norm sums the expert leaves over the
  data axis) and the dense dispatch; (2, 1, 2) and (2, 2, 1) sgd; against
  JAX `make_lm_train_step` on the same `create_lm_mesh`.
- `make_pp_train_step`, 3 steps at (dp, pp, tp) = (1, 2, 1) and (2, 2, 1)
  (the experts over the data axis of each stage) against JAX's.
- the eval loss (`make_eval_fn`) with the aux, as the JAX CLI's eval, in
  this process and on the ranks at (2, 1, 1) (each rank its own rows, the
  loss averaged over the sync axis), (2, 1, 2) and (2, 2, 1), within 2e-5
  relative of JAX `lm_loss` under shard_map with the batch over (data,
  seq).
- `generate`: greedy tokens equal to JAX's at f32 (the dense dispatch at a
  capacity of the batch).
- The refusals with the JAX texts: experts that do not divide over the
  data axis, ZeRO and the overlapped sync with an expert axis (mesh and
  pipeline), and the serving engine with a MoE config.
- `parallel/distributed.py` `create_hybrid_mesh` against JAX's
  `_hybrid_device_array` with stub devices (hosts for slices), and its
  errors.

Tolerance (f32): every step's loss within 2e-5 relative, every gathered
parameter within atol = rtol = 2e-5 (the expert leaves included: a dp 2
step leaves them as JAX's dp 2 step does, so their gradients were not
summed over the data axis; under Adam the elements where its update is well
conditioned, all but at most 1 in 200, as tests/test_torch_pp.py); every
rank's gathered parameters the same bits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.parallel import distributed as jdist
from distributed_neural_network_tpu.parallel import pipeline as jpp
from distributed_neural_network_tpu.train import lm as jlm
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.parallel import distributed as tdist
from distributed_neural_network_tpu_torch.parallel import pipeline as tpp
from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
from distributed_neural_network_tpu_torch.train import lm as tlm

from torch_rank_worker import launch

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_experts=4)
KW4 = dict(KW, n_layers=4)
B, S, STEPS, TOL = 8, 16, 3, 2e-5
ENV = {"OMP_NUM_THREADS": "1"}
ADAM = {"optimizer": "adam", "lr": 0.001, "clip_norm": 0.5}
CPU = torch.device("cpu")

# name -> (world, (dp, sp, tp), make_lm_train_step arguments (both packages'),
# config fields over KW)
LM_CASES = {
    "dp2-sgd": (2, (2, 1, 1), {}, {}),
    "dp2-adam-clip": (2, (2, 1, 1), ADAM, {}),
    "dp2-dense": (2, (2, 1, 1), {}, {"moe_dispatch": "dense"}),
    "dp2tp2-sgd": (4, (2, 1, 2), {}, {}),
    "dp2sp2-ring": (4, (2, 2, 1), {"attn_impl": "ring"}, {}),
}
# the LM cases whose ranks also run the eval loss (`make_eval_fn`)
EVAL_CASES = ("dp2-sgd", "dp2tp2-sgd", "dp2sp2-ring")
# name -> (world, (dp, pp, tp), microbatches)
PP_CASES = {"pp2": (2, (1, 2, 1), 2), "dp2pp2": (4, (2, 2, 1), 2)}
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
    return {key: jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                           jtfm.TransformerConfig(**kw)))
            for key, seed, kw in (("L2", 3, KW), ("L4", 4, KW4))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jparams_np):
    """{case: [each rank's npz dict]} of every LM and pipeline case."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("lm_moe")
    for key, tree in jparams_np.items():
        np.savez(d / f"params_{key}.npz", **_flat(tree))
    toks, tgts = _batches()
    np.savez(d / "batches.npz", tokens=toks, targets=tgts)
    jobs = {}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for w in WORLDS:
            (d / f"w{w}").mkdir()
            lm = [{"name": n, "mesh": list(m), "kw": kw, "cfg": c, "steps": STEPS,
                   "eval": n in EVAL_CASES}
                  for n, (world, m, kw, c) in LM_CASES.items() if world == w]
            pp = [{"name": n, "kind": "train", "mesh": list(m), "params": "L4", "cfg": KW4,
                   "m": mb, "v": 1, "rows": B, "kw": {}, "steps": STEPS}
                  for n, (world, m, mb) in PP_CASES.items() if world == w]
            spec = {"device": "cpu", "out": str(d / f"w{w}"),
                    "lm": {"params": str(d / "params_L2.npz"), "batches": str(d / "batches.npz"),
                           "cfg": KW, "cases": lm},
                    "pp": {"params": {"L4": str(d / "params_L4.npz")},
                           "batches": str(d / "batches.npz"), "cases": pp}}
            jobs[w] = pool.submit(launch, w, spec, timeout=300, env=ENV)
        for w, fut in jobs.items():
            for p in fut.result():
                assert p.returncode == 0, f"world {w}: {p.stderr[-3000:]}"
    out = {n: [dict(np.load(d / f"w{w}" / f"lm_{n}_rank{r}.npz")) for r in range(w)]
           for n, (w, *_) in LM_CASES.items()}
    out.update({n: [dict(np.load(d / f"w{w}" / f"pp_{n}_rank{r}.npz")) for r in range(w)]
                for n, (w, *_) in PP_CASES.items()})
    return out


def _jax_lm(jparams_np, mesh_shape, kw, cfg_kw):
    """STEPS JAX steps on create_lm_mesh(*mesh_shape): (losses, flat params,
    the Adam-conditioned elements or None)."""
    from distributed_neural_network_tpu_torch.ops.adam import B2, EPS  # the JAX defaults

    mesh = jlm.create_lm_mesh(*mesh_shape)
    cfg = jtfm.TransformerConfig(**{**KW, **cfg_kw})
    params, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np["L2"]), cfg, mesh)
    adam = kw.get("optimizer", "sgd") == "adam"
    mom = jlm.init_lm_momentum(params, mesh, kw.get("optimizer", "sgd"))
    step = jlm.make_lm_train_step(cfg, mesh, **kw)
    toks, tgts = _batches()
    losses = []
    keep = jax.tree.map(lambda x: np.ones(x.shape, bool), params) if adam else None
    for i in range(STEPS):
        params, mom, loss = step(params, mom, jnp.asarray(toks[i]), jnp.asarray(tgts[i]))
        losses.append(float(loss))
        if adam:
            keep = jax.tree.map(lambda k, v, t=i + 1: k & _conditioned(np.asarray(v), t, B2, EPS),
                                keep, mom["v"])
    return losses, _flat(jax.tree.map(np.asarray, params)), keep and _flat(keep)


def _conditioned(v, t, b2, eps):
    """Where Adam's update is well conditioned after step t: the root mean
    square gradient sqrt(v / (1 - b2^t)) zero (no update) or at least 100
    eps, as tests/test_torch_pp.py `_adam_conditioned`. Adam's g / (sqrt(v)
    + eps) turns a relative difference e of a gradient into a difference of
    about lr x e in the update; the two packages' gradients at this width
    differ by up to 1.9e-8 (measured at the first step: float reassociation
    on gradients of scale 1e-2), which near 100 eps is e ~ 1e-2: hence
    ADAM's lr of 1e-3, so that lr x e stays under TOL."""
    rms = np.sqrt(v / (1 - b2 ** t))
    return (rms >= 100 * eps) | (rms == 0)


def _assert_run(got_losses, got_params, want_losses, want_params, keep=None):
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL, atol=0)
    assert sorted(got_params) == sorted(want_params)
    if keep is not None:
        # experts that get few of a step's 128 tokens have small gradients: more
        # ill-conditioned elements than the dense model's (69 of 44,352 with clip)
        n = sum(x.size for x in keep.values())
        assert sum((~x).sum() for x in keep.values()) <= 5e-3 * n
    for k, want in want_params.items():
        sel = keep[k] if keep is not None else np.ones(want.shape, bool)
        np.testing.assert_allclose(got_params[k][sel], want[sel], atol=TOL, rtol=TOL, err_msg=k)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(2, 32, size=shape).astype(np.int32)


@pytest.mark.parametrize("extra", [{}, {"moe_dispatch": "dense"}, {"remat": True}])
def test_apply_with_aux_matches_jax(n_devices, jparams_np, extra):
    toks = _tokens(1, (2, 12))
    jcfg, cfg = jtfm.TransformerConfig(**KW, **extra), tfm.TransformerConfig(**KW, **extra)
    want, want_aux = jtfm.apply_with_aux(jparams_np["L2"], jnp.asarray(toks), jcfg,
                                         attn_impl="full")
    params = tfm.from_jax_params(jparams_np["L2"])
    got, aux = tfm.apply_with_aux(params, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert float(want_aux) > 0 and abs(float(aux) - float(want_aux)) <= 1e-4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_one_process_step_matches_jax(n_devices, jparams_np, opt):
    kw = ADAM if opt == "adam" else {}
    want = _jax_lm(jparams_np, (1, 1, 1), kw, {})
    cfg = tfm.TransformerConfig(**KW)
    params = tfm.from_jax_params(jparams_np["L2"])
    mom = tlm.init_lm_momentum(params, kw.get("optimizer", "sgd"))
    step = tlm.make_lm_train_step(cfg, **kw)
    toks, tgts = _batches()
    losses = [float(step(params, mom, torch.from_numpy(toks[i]).long(),
                         torch.from_numpy(tgts[i]).long(), i)) for i in range(STEPS)]
    _assert_run(losses, _flat(tfm.to_numpy(params)), *want)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_mesh_step_matches_jax(n_devices, jparams_np, ranks, case):
    _, mesh_shape, kw, cfg_kw = LM_CASES[case]
    want = _jax_lm(jparams_np, mesh_shape, kw, cfg_kw)
    got = ranks[case]
    params = {k[len("params/"):]: v for k, v in got[0].items() if k.startswith("params/")}
    _assert_run(got[0]["losses"], params, *want)
    for r in got[1:]:
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])
        for k in params:
            np.testing.assert_array_equal(r["params/" + k], got[0]["params/" + k])


@pytest.mark.parametrize("case", list(PP_CASES))
def test_pipeline_step_matches_jax(n_devices, jparams_np, ranks, case):
    _, mesh_shape, m = PP_CASES[case]
    cfg = jtfm.TransformerConfig(**KW4)
    mesh = jpp.create_pp_mesh(*mesh_shape)
    params, specs = jpp.shard_pp_params(jax.tree.map(jnp.asarray, jparams_np["L4"]), cfg, mesh)
    mom = jax.tree.map(jnp.zeros_like, params)
    step = jpp.make_pp_train_step(cfg, mesh, n_microbatches=m)
    toks, tgts = _batches()
    losses = []
    for i in range(STEPS):
        params, mom, loss = step(params, mom, jnp.asarray(toks[i]), jnp.asarray(tgts[i]))
        losses.append(float(loss))
    got = ranks[case]
    mine = {k[len("params/"):]: v for k, v in got[0].items() if k.startswith("params/")}
    _assert_run(got[0]["losses"], mine, losses, _flat(jax.tree.map(np.asarray, params)))
    for r in got[1:]:
        for k in mine:
            np.testing.assert_array_equal(r["params/" + k], got[0]["params/" + k])


def test_eval_loss_holds_the_aux_as_jax(n_devices, jparams_np):
    """`make_eval_fn` on a MoE model: the JAX CLI's eval value, `lm_loss`
    with the weighted aux."""
    toks, tgts = _batches()
    jc = jtfm.TransformerConfig(**KW)
    want = jlm.lm_loss(jax.tree.map(jnp.asarray, jparams_np["L2"]), jnp.asarray(toks[0]),
                       jnp.asarray(tgts[0]), jc, seq_axis=None, tp_axis=None, attn_impl="ring",
                       axes=())
    ev = tlm.make_eval_fn(tfm.TransformerConfig(**KW))
    got = ev(tfm.from_jax_params(jparams_np["L2"]), torch.from_numpy(toks[0]).long(),
             torch.from_numpy(tgts[0]).long())
    assert not ev.sharded_rows
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=0)


@pytest.mark.parametrize("case", EVAL_CASES)
def test_mesh_eval_loss_matches_jax(n_devices, jparams_np, ranks, case):
    """`make_eval_fn` on a mesh with an expert axis: each step's batch at
    the initial parameters, against the JAX CLI's eval (`lm_loss` under
    shard_map, the rows over data and the columns over seq, summed over
    both)."""
    from jax.sharding import PartitionSpec as JP

    _, (dp, sp, tp), kw, cfg_kw = LM_CASES[case]
    mesh = jlm.create_lm_mesh(dp, sp, tp)
    cfg = jtfm.TransformerConfig(**{**KW, **cfg_kw})
    params, specs = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np["L2"]), cfg, mesh)
    rows = JP(jlm.DATA_AXIS, jlm.SEQ_AXIS)
    fn = jax.jit(jax.shard_map(
        lambda p, tok, tgt: jlm.lm_loss(
            p, tok, tgt, cfg, seq_axis=jlm.SEQ_AXIS if sp > 1 else None,
            tp_axis=jlm.TP_AXIS if tp > 1 else None, ep_axis=jlm._ep_axis(cfg, mesh),
            attn_impl=kw.get("attn_impl", "ring"), axes=(jlm.DATA_AXIS, jlm.SEQ_AXIS)),
        mesh=mesh, in_specs=(specs, rows, rows), out_specs=JP()))
    toks, tgts = _batches()
    want = [float(fn(params, jnp.asarray(toks[i]), jnp.asarray(tgts[i]))) for i in range(STEPS)]
    got = ranks[case]
    np.testing.assert_allclose(got[0]["eval"], want, rtol=TOL, atol=0)
    for r in got[1:]:
        np.testing.assert_array_equal(r["eval"], got[0]["eval"])


def test_generate_greedy_matches_jax(n_devices, jparams_np):
    prompt = _tokens(7, (2, 5))
    want = jtfm.generate(jax.tree.map(jnp.asarray, jparams_np["L2"]), jnp.asarray(prompt),
                         jtfm.TransformerConfig(**KW),
                         max_new_tokens=8)
    got = tfm.generate(tfm.from_jax_params(jparams_np["L2"]), torch.from_numpy(prompt).long(),
                       tfm.TransformerConfig(**KW), max_new_tokens=8, decode_impl="torch")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _same_error(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["indivisible", "zero", "overlap", "pp-zero", "pp-overlap",
                                  "serve"])
def test_refusals_are_the_jax_texts(n_devices, jparams_np, name):
    if name == "indivisible":
        jc, tc = jtfm.TransformerConfig(**dict(KW, n_experts=3)), \
            tfm.TransformerConfig(**dict(KW, n_experts=3))
        _same_error(lambda: jlm.lm_wiring(jc, jlm.create_lm_mesh(2, 1, 1)),
                    lambda: tlm.lm_wiring(tc, ProcessMesh(2, CPU)))
        return
    jc, tc = jtfm.TransformerConfig(**KW), tfm.TransformerConfig(**KW)
    if name == "zero":
        _same_error(lambda: jlm.lm_wiring(jc, jlm.create_lm_mesh(2, 1, 1), "zero"),
                    lambda: tlm.lm_wiring(tc, ProcessMesh(2, CPU), "zero"))
    elif name == "overlap":
        _same_error(lambda: jlm.make_lm_train_step(jc, jlm.create_lm_mesh(2, 1, 1),
                                                   grad_sync="overlap", accum_steps=2),
                    lambda: tlm.make_lm_train_step(tc, mesh=ProcessMesh(2, CPU),
                                                   grad_sync="overlap", accum_steps=2))
    elif name in ("pp-zero", "pp-overlap"):
        kw = {"optimizer": "zero"} if name == "pp-zero" else {"grad_sync": "overlap",
                                                               "accum_steps": 2}
        jc4, tc4 = jtfm.TransformerConfig(**KW4), tfm.TransformerConfig(**KW4)
        _same_error(lambda: jpp.make_pp_train_step(jc4, jpp.create_pp_mesh(2, 2, 1), **kw),
                    lambda: tpp.make_pp_train_step(tc4, ProcessMesh(2, CPU, pp=2), **kw))
    else:
        from distributed_neural_network_tpu.serve import engine as jeng
        from distributed_neural_network_tpu_torch.serve import engine as teng

        _same_error(lambda: jeng.ServeEngine(jparams_np["L2"], jc, jeng.EngineConfig()),
                    lambda: teng.ServeEngine(tfm.from_jax_params(jparams_np["L2"]), tc,
                                             teng.EngineConfig()))


class _StubDev:
    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index


# name -> (slice of each of 8 devices, dcn sizes, ici sizes)
HYBRID = {
    "one host": ([0] * 8, (2,), (2, 2)),
    "two hosts": ([i // 4 for i in range(8)], (2,), (2, 2)),
    "two hosts, a part": ([i // 4 for i in range(8)], (2,), (2,)),
    "interleaved hosts": ([i % 2 for i in range(8)], (2,), (4,)),
    "host count mismatch": ([i // 4 for i in range(8)], (3,), (2,)),
    "uneven hosts": ([0 if i < 5 else 1 for i in range(8)], (2,), (2, 2)),
}


@pytest.mark.parametrize("name", list(HYBRID))
def test_hybrid_layout_is_the_jax_one(name):
    slices, dcn, ici = HYBRID[name]
    devs = [_StubDev(i, s) for i, s in enumerate(slices)]
    try:
        want = np.vectorize(lambda d: d.id)(jdist._hybrid_device_array(devs, dcn, ici))
    except ValueError:
        with pytest.raises(ValueError):
            tdist._hybrid_rank_array(list(range(8)), slices, dcn, ici)
        return
    got = tdist._hybrid_rank_array(list(range(8)), slices, dcn, ici)
    np.testing.assert_array_equal(got, want)


def test_hybrid_mesh_axes_and_errors(n_devices):
    mesh = tdist.create_hybrid_mesh({"seq": 2, "model": 2}, {"data": 2}, ranks=range(8))
    want = jdist.create_hybrid_mesh({"seq": 2, "model": 2}, {"data": 2})
    assert mesh.axis_names == want.axis_names and mesh.shape == dict(want.shape)
    np.testing.assert_array_equal(mesh.ranks, np.vectorize(lambda d: d.id)(want.devices))
    assert tdist.create_hybrid_mesh({"data": 1}).shape == {"data": 1}  # this process alone
    for bad, match in (({"data": 16}, "needs 16 ranks"), ({"data": 0}, "positive")):
        with pytest.raises(ValueError):
            jdist.create_hybrid_mesh(bad)
        with pytest.raises(ValueError, match=match):
            tdist.create_hybrid_mesh(bad, ranks=range(8))
