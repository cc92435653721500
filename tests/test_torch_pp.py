"""The pipeline axis: the port's `parallel/pipeline.py` on process groups of
2, 4 and 8 gloo ranks on the CPU (tests/torch_rank_worker.py, one launch
per world size with all of its cases, every rank at OMP_NUM_THREADS=1)
against the JAX package's `pipeline_lm_loss` / `make_pp_train_step` on the
same `create_pp_mesh(dp, pp, tp)` over the 8 virtual CPU devices, from one
JAX `init_params` tree per depth (handed to the ranks as numpy and cut per
rank by `shard_pp_params`) and the same numpy batches.

Cases, as tests/test_pipeline.py's: the loss at pp 4 and M 1, 2 and 4; the
gradients at pp 4 (and at pp 2, which also counts the collectives); the
interleaved schedule at (v, M) = (2, 4), (2, 8) and (1, 4) on pp 4, and v 4
at M 2 and 4 on pp 2; the interleaved chunk with remat, with no policy and
with dots_saveable (loss and gradients); three train steps of (dp, pp, tp) =
(2, 2, 2) sgd, of adam at pp 4 v 2 with clip 1.0, of sgd, zero, adam and
zero-adam at (2, 2, 1) with clip 1.0 and weight decay 0.01, and of
accumulation 2 with --grad-sync overlap (sgd and zero-adam) against the
JAX end schedule. The gradients and the gathered parameters compare in the
JAX sharded tree's layer order: `gather_params` concatenates the stages'
blocks, which under interleave is the permuted order
(`interleave_layer_order`) that `shard_pp_params` gives JAX's global array.

Tolerance (f32): losses within 2e-5 relative; gradients, gathered
parameters and optimizer state within atol = rtol = 2e-5 (under Adam the
parameters where its update is well conditioned, `_adam_conditioned`: all
but a few elements in 10^4 whose gradient is within 100 eps of zero); every
rank's gathered parameters the same bits; ZeRO's parameters bitwise the
replicated optimizer's. Plus: every rank issues the same number of block
exchanges (ppermute and all-to-all, forward and backward: 2(T-1) + 2 for T
ticks), the backward completing under the launch's timeout; the head runs
once a forward on ceil(M/P) microbatches of rows per stage, never per tick;
the JAX errors for indivisible layers, the interleave checks, zero with
tp, and zero or the overlapped sync with MoE experts over the data axis.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.parallel import pipeline as jpp

from torch_rank_worker import launch

KW4 = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=4, d_ff=64)
KW8 = dict(KW4, n_layers=8)
S, STEPS, TOL = 16, 3, 2e-5
ENV = {"OMP_NUM_THREADS": "1"}
SMALL_MB = 0.01  # ~10 KB: several buckets at this width
ZERO_KW = {"lr": 0.02, "clip_norm": 1.0, "weight_decay": 0.01}
OVERLAP = {"accum_steps": 2, "grad_sync": "overlap", "bucket_mb": SMALL_MB, "lr": 0.05,
           "clip_norm": 1.0}

# name -> (world, kind, mesh, params, cfg, M, v, rows, make_pp_train_step arguments)
CASES = {
    "loss-pp4-m1": (4, "loss", (1, 4, 1), "L4", KW4, 1, 1, 8, {}),
    "loss-pp4-m2": (4, "loss", (1, 4, 1), "L4", KW4, 2, 1, 8, {}),
    "loss-pp4-m4": (4, "loss", (1, 4, 1), "L4", KW4, 4, 1, 8, {}),
    "grads-pp4": (4, "grads", (1, 4, 1), "L4", KW4, 2, 1, 8, {}),
    "interleave-v2-m4": (4, "loss", (1, 4, 1), "L8", KW8, 4, 2, 8, {}),
    "interleave-v2-m8": (4, "loss", (1, 4, 1), "L8", KW8, 8, 2, 8, {}),
    "interleave-v1-m4": (4, "loss", (1, 4, 1), "L8", KW8, 4, 1, 8, {}),
    "remat-v2": (4, "grads", (1, 4, 1), "L8", dict(KW8, remat=True), 4, 2, 8, {}),
    "remat-v2-dots": (4, "grads", (1, 4, 1), "L8",
                      dict(KW8, remat=True, remat_policy="dots_saveable"), 4, 2, 8, {}),
    "adam-pp4-v2": (4, "train", (1, 4, 1), "L8", KW8, 4, 2, 16,
                    {"optimizer": "adam", "lr": 0.01, "clip_norm": 1.0}),
    "sgd-dp2pp2": (4, "train", (2, 2, 1), "L4", KW4, 2, 1, 16, ZERO_KW),
    "zero-dp2pp2": (4, "train", (2, 2, 1), "L4", KW4, 2, 1, 16, dict(ZERO_KW, optimizer="zero")),
    "adam-dp2pp2": (4, "train", (2, 2, 1), "L4", KW4, 2, 1, 16, dict(ZERO_KW, optimizer="adam")),
    "zero-adam-dp2pp2": (4, "train", (2, 2, 1), "L4", KW4, 2, 1, 16,
                         dict(ZERO_KW, optimizer="zero-adam")),
    "overlap-dp2pp2": (4, "train", (2, 2, 1), "L4", KW4, 2, 1, 16, OVERLAP),
    "overlap-zero-adam-dp2pp2": (4, "train", (2, 2, 1), "L4", KW4, 2, 1, 16,
                                 dict(OVERLAP, optimizer="zero-adam", lr=0.01)),
    "grads-pp2": (2, "grads", (1, 2, 1), "L4", KW4, 2, 1, 8, {}),
    "deep-v4-m2": (2, "loss", (1, 2, 1), "L8", KW8, 2, 4, 8, {}),
    "deep-v4-m4": (2, "loss", (1, 2, 1), "L8", KW8, 4, 4, 8, {}),
    "sgd-dp2pp2tp2": (8, "train", (2, 2, 2), "L4", KW4, 2, 1, 16, {"lr": 0.3}),
}
WORLDS = (2, 4, 8)
# ZeRO against the replicated optimizer of the same run
ZERO_PAIRS = {"zero-dp2pp2": "sgd-dp2pp2", "zero-adam-dp2pp2": "adam-dp2pp2"}


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
    rng = np.random.default_rng(13)
    toks = rng.integers(2, 32, size=(STEPS, 16, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=2)


@pytest.fixture(scope="module")
def jparams_np():
    return {key: jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                           jtfm.TransformerConfig(**kw)))
            for key, seed, kw in (("L4", 3, KW4), ("L8", 5, KW8))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jparams_np):
    """{case: [each rank's npz dict]}."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("pp")
    for key, tree in jparams_np.items():
        np.savez(d / f"params_{key}.npz", **_flat(tree))
    toks, tgts = _batches()
    np.savez(d / "batches.npz", tokens=toks, targets=tgts)
    jobs = {}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for w in WORLDS:
            (d / f"w{w}").mkdir()
            cases = [{"name": n, "kind": kind, "mesh": list(mesh), "params": pk, "cfg": cfg,
                      "m": m, "v": v, "rows": rows, "kw": kw, "steps": STEPS}
                     for n, (world, kind, mesh, pk, cfg, m, v, rows, kw) in CASES.items()
                     if world == w]
            spec = {"device": "cpu", "out": str(d / f"w{w}"),
                    "pp": {"params": {k: str(d / f"params_{k}.npz") for k in jparams_np},
                           "batches": str(d / "batches.npz"), "cases": cases}}
            jobs[w] = pool.submit(launch, w, spec, timeout=300, env=ENV)
        for w, fut in jobs.items():
            for p in fut.result():
                assert p.returncode == 0, f"world {w}: {p.stderr[-3000:]}"
    return {n: [dict(np.load(d / f"w{w}" / f"pp_{n}_rank{r}.npz")) for r in range(w)]
            for n, (w, *_) in CASES.items()}


def _jax_placed(jparams_np, case):
    _, _, mesh_shape, pk, cfg_kw, m, v, rows, kw = CASES[case]
    cfg = jtfm.TransformerConfig(**cfg_kw)
    mesh = jpp.create_pp_mesh(*mesh_shape)
    params, specs = jpp.shard_pp_params(jax.tree.map(jnp.asarray, jparams_np[pk]), cfg, mesh,
                                        interleave=v)
    return cfg, mesh, params, specs


def _jax_loss_grads(jparams_np, case, grads):
    """The JAX loss (and gradients, as the global sharded tree) of batch 0."""
    _, _, _, _, _, m, v, rows, _ = CASES[case]
    cfg, mesh, params, specs = _jax_placed(jparams_np, case)
    toks, tgts = _batches()
    tp = jpp.TP_AXIS if mesh.shape.get(jpp.TP_AXIS, 1) > 1 else None

    def loss_fn(p, tok, tgt):
        return jpp.pipeline_lm_loss(p, tok, tgt, cfg, n_microbatches=m, tp_axis=tp,
                                    sync_axes=(jpp.DATA_AXIS,), interleave=v)

    fn = jax.value_and_grad(loss_fn) if grads else loss_fn
    out_specs = (JP(), specs) if grads else JP()
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(specs, JP(jpp.DATA_AXIS),
                                                          JP(jpp.DATA_AXIS)),
                                out_specs=out_specs))(params, jnp.asarray(toks[0][:rows]),
                                                      jnp.asarray(tgts[0][:rows]))
    if grads:
        return float(out[0]), _flat(jax.tree.map(np.asarray, out[1]))
    return float(out), None


def _jax_train(jparams_np, case, jkw=None, trace=None):
    """STEPS JAX pipeline steps: (losses, flat params, state leaves);
    `trace`, a list, gets each step's state leaves."""
    from distributed_neural_network_tpu.ops.adam import init_adam

    _, _, _, _, _, m, v, rows, kw = CASES[case]
    kw = dict(kw if jkw is None else jkw)
    cfg, mesh, params, specs = _jax_placed(jparams_np, case)
    opt = kw.get("optimizer", "sgd")
    if opt == "adam":
        mom = init_adam(params)
    elif opt == "sgd":
        mom = jax.tree.map(jnp.zeros_like, params)
    else:
        mom = jpp.init_pp_zero_state(params, specs, mesh, opt)
    step = jpp.make_pp_train_step(cfg, mesh, n_microbatches=m, interleave=v, **kw)
    toks, tgts = _batches()
    losses = []
    for i in range(STEPS):
        params, mom, loss = step(params, mom, jnp.asarray(toks[i][:rows]),
                                 jnp.asarray(tgts[i][:rows]))
        losses.append(float(loss))
        if trace is not None:
            trace.append(_state_leaves(mom))
    return losses, _flat(jax.tree.map(np.asarray, params)), _state_leaves(mom)


def _state_leaves(mom):
    state = {k: x for k, x in mom.items() if k != "t"} if isinstance(mom, dict) and "t" in mom \
        else mom
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _state_keys(got, prefix="state/"):
    keys = [k for k in got if k.startswith(prefix)]

    def order(k):
        return [int(p) if p.isdigit() else p for p in k[len(prefix):].split("/")]

    return sorted(keys, key=order)


@pytest.mark.parametrize("case", [n for n, c in CASES.items() if c[1] in ("loss", "grads")])
def test_pp_loss_and_grads_match_jax(n_devices, jparams_np, ranks, case):
    kind = CASES[case][1]
    want_loss, want_grads = _jax_loss_grads(jparams_np, case, kind == "grads")
    got = ranks[case]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], [want_loss], rtol=TOL, err_msg=f"rank {r}")
    if want_grads is not None:
        for r, g in enumerate(got):
            for k, want in want_grads.items():
                np.testing.assert_allclose(g["grads/" + k], want, atol=TOL, rtol=TOL,
                                           err_msg=f"rank {r} {k}")


def _adam_conditioned(jparams_np, case, jkw):
    """{param path: the elements whose Adam updates are well conditioned}:
    where, after every step of the JAX adam run, the root mean square
    gradient (sqrt(v / (1 - b2^t))) is zero (no update) or at least 100 eps.
    Below that Adam's g / (sqrt(v) + eps) turns a float-reassociation
    difference of a near-zero gradient into a difference of order lr
    (measured at pp 4 v 2: 3 of 49,152 layer elements, gradients 2.5e-9 to
    9e-9 against a median 8e-4, parameters 2e-4 apart after one step at lr
    0.01)."""
    from distributed_neural_network_tpu_torch.ops.adam import B2, EPS  # the JAX defaults

    kw = dict(CASES[case][8] if jkw is None else jkw, optimizer="adam")
    trace = []
    _, want_params, _ = _jax_train(jparams_np, case, kw, trace=trace)
    keep = [np.ones(x.shape, bool) for x in want_params.values()]
    for t, state in enumerate(trace, start=1):
        v = state[len(state) // 2:]  # m's leaves, then v's, in the tree order
        for i, x in enumerate(v):
            rms = np.sqrt(x / (1 - B2 ** t))
            keep[i] &= (rms >= 100 * EPS) | (rms == 0)
    return dict(zip(want_params, keep))


@pytest.mark.parametrize("case", [n for n, c in CASES.items() if c[1] == "train"])
def test_pp_train_steps_match_jax(n_devices, jparams_np, ranks, case):
    kw = CASES[case][8]
    # the overlap schedule against the JAX end schedule at the same
    # accumulation (the same sums up to float reassociation)
    jkw = dict(kw, grad_sync="end") if kw.get("grad_sync") == "overlap" else None
    want_loss, want_params, want_state = _jax_train(jparams_np, case, jkw)
    adam = kw.get("optimizer", "sgd") in ("adam", "zero-adam")
    keep = _adam_conditioned(jparams_np, case, jkw) if adam else {}
    if adam:
        n = sum(x.size for x in keep.values())
        assert sum((~x).sum() for x in keep.values()) <= 1e-3 * n
    got = ranks[case]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], want_loss, rtol=TOL, err_msg=f"rank {r}")
        for k, v in want_params.items():
            sel = keep.get(k, np.ones(v.shape, bool))
            np.testing.assert_allclose(g["params/" + k][sel], v[sel], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} {k}")
            assert np.array_equal(g["params/" + k], got[0]["params/" + k]), (r, k)
    if not kw.get("optimizer", "sgd").startswith("zero"):
        keys = _state_keys(got[0])
        assert len(keys) == len(want_state)
        for k, want in zip(keys, want_state):
            np.testing.assert_allclose(got[0][k].reshape(want.shape), want, atol=TOL, rtol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", list(ZERO_PAIRS))
def test_pp_zero_is_bitwise_the_replicated_optimizer(ranks, case):
    """ZeRO-1 under dp2 x pp2 updates each rank's shards of the same summed
    gradients with the same elementwise rule: the parameters are the
    replicated optimizer's, bit for bit."""
    got, ref = ranks[case], ranks[ZERO_PAIRS[case]]
    np.testing.assert_array_equal(got[0]["losses"], ref[0]["losses"])
    for k in (k for k in ref[0] if k.startswith("params/")):
        for r in range(len(got)):
            assert np.array_equal(got[r][k], ref[r][k]), (r, k)


def test_overlap_buckets_never_mix_pipe_and_replicated_leaves(ranks):
    """Under overlap the layout groups leaves by spec: the replicated
    leaves (embed, head; lnf_*) and the stage chunk never share a bucket,
    so each bucket reduces over one group."""
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel import pipeline as ppl
    from distributed_neural_network_tpu_torch.parallel.collectives import plan_buckets
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

    import torch

    cfg = tfm.TransformerConfig(**KW4)
    mesh = ProcessMesh(2, torch.device("cpu"), rank=0, pp=2)
    specs = ppl.pp_param_specs(cfg)
    whole = tfm.init_params(0, cfg)
    local = [x.narrow(0, 0, x.shape[0] // 2) if "pipe" in tuple(s) else x
             for x, s in zip(tree_leaves(whole), tree_leaves(specs))]
    keys = [str(s) for s in tree_leaves(specs)]
    layout = plan_buckets(local, bucket_bytes=int(SMALL_MB * 2**20), group_keys=keys)
    for lo, hi in layout.buckets:
        assert len({keys[i] for i in range(lo, hi)}) == 1
    assert all(int(r["n_buckets"]) == layout.n_buckets for r in ranks["overlap-dp2pp2"])
    assert mesh.desc == "data2xpipe2"


@pytest.mark.parametrize("case", ["grads-pp2", "grads-pp4", "remat-v2"])
def test_every_rank_runs_the_same_collectives(ranks, case):
    """The forward and backward pipeline completes (each launch has a
    timeout) and every rank issues the same block exchanges: T-1 ppermutes
    and one all-to-all forward, as many backward."""
    _, _, (_, pp, _), _, _, m, v, _, _ = CASES[case]
    ticks = v * m + pp - 1
    counts = [int(r["exchanges"]) for r in ranks[case]]
    assert counts == [2 * (ticks - 1) + 2] * pp, counts


@pytest.mark.parametrize("case", ["loss-pp4-m1", "loss-pp4-m2", "loss-pp4-m4",
                                  "interleave-v2-m8", "deep-v4-m2"])
def test_head_runs_once_per_microbatch_never_per_tick(ranks, case):
    """JAX test_interior_ticks_do_no_vocab_work: each stage runs the head
    once a forward, on ceil(M/P) microbatches of rows (padding included),
    whatever the tick count."""
    _, _, (dp, pp, _), _, _, m, _, rows, _ = CASES[case]
    mb = rows // dp // m
    for r in ranks[case]:
        assert int(r["head_calls"]) == 1
        assert int(r["head_rows"]) == -(-m // pp) * mb


def test_schedule_and_optimizer_errors_are_the_jax_texts(n_devices):
    """The JAX make_pp_train_step errors, with its texts: layers not
    divisible by pp x v, the interleaved schedule's whole groups, an unknown
    optimizer, zero with a model axis, zero and overlap with an expert axis."""
    import torch

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel import pipeline as ppl
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh

    def both(jcfg, jmesh, tcfg, tmesh, **kw):
        with pytest.raises((ValueError, AssertionError)) as want:
            jpp.make_pp_train_step(jcfg, jmesh, **kw)
        with pytest.raises(ValueError) as got:
            ppl.make_pp_train_step(tcfg, tmesh, **kw)
        assert str(got.value) == str(want.value)

    cpu = torch.device("cpu")
    cfg4, cfg8 = tfm.TransformerConfig(**KW4), tfm.TransformerConfig(**KW8)
    cfg6 = tfm.TransformerConfig(**dict(KW4, n_layers=6))
    j4, j8 = jtfm.TransformerConfig(**KW4), jtfm.TransformerConfig(**KW8)
    j6 = jtfm.TransformerConfig(**dict(KW4, n_layers=6))
    both(j4, jpp.create_pp_mesh(1, 3, 1), cfg4, ProcessMesh(1, cpu, pp=3))
    both(j8, jpp.create_pp_mesh(1, 4, 1), cfg8, ProcessMesh(1, cpu, pp=4), n_microbatches=2,
         interleave=2)
    both(j6, jpp.create_pp_mesh(1, 4, 1), cfg6, ProcessMesh(1, cpu, pp=4), n_microbatches=4,
         interleave=2)
    both(j8, jpp.create_pp_mesh(1, 4, 1), cfg8, ProcessMesh(1, cpu, pp=4), optimizer="rmsprop")
    both(j4, jpp.create_pp_mesh(2, 2, 2), cfg4, ProcessMesh(2, cpu, pp=2, tp=2),
         optimizer="zero-adam")
    # MoE runs under the pipeline now (tests/test_torch_lm_moe.py); with the
    # experts over the data axis, ZeRO and the overlapped sync are the JAX errors
    moe, jmoe = tfm.TransformerConfig(**KW4, n_experts=4), jtfm.TransformerConfig(**KW4,
                                                                                  n_experts=4)
    both(jmoe, jpp.create_pp_mesh(2, 2, 1), moe, ProcessMesh(2, cpu, pp=2), optimizer="zero")
    both(jmoe, jpp.create_pp_mesh(2, 2, 1), moe, ProcessMesh(2, cpu, pp=2),
         grad_sync="overlap", accum_steps=2)
    with pytest.raises(ValueError, match="not both"):
        ProcessMesh(1, cpu, sp=2, pp=2)


def test_interleave_layer_order_is_the_jax_one():
    from distributed_neural_network_tpu_torch.parallel import pipeline as ppl

    for n, pp, v in ((16, 4, 2), (8, 2, 4), (8, 4, 1), (12, 2, 3)):
        for inverse in (False, True):
            assert np.array_equal(ppl.interleave_layer_order(n, pp, v, inverse=inverse),
                                  jpp.interleave_layer_order(n, pp, v, inverse=inverse))
    with pytest.raises(ValueError, match="divisible by pipeline size"):
        ppl.interleave_layer_order(6, 4, 2)


def test_pipe_axis_groups_and_coords(monkeypatch):
    """The pipeline mesh's layout: rank (d*pp + p)*tp + t, `shape` and
    `desc` in the JAX mesh's order, and one group per distinct slice: the
    pipe slices, the sync (data) slices and the (data, pipe) slices (shared
    with the whole world or the pipe slices where they hold the same
    ranks)."""
    from types import SimpleNamespace

    from distributed_neural_network_tpu_torch.parallel import mesh as M

    dp, pp, tp = 2, 2, 2
    made = []

    def new_group(ranks):
        made.append(tuple(ranks))
        return ("group",) + tuple(ranks)

    fake = SimpleNamespace(new_group=new_group, group=SimpleNamespace(WORLD=("group", "world")))
    monkeypatch.setattr(M, "dist", fake)
    monkeypatch.setattr(M, "_MADE", {"world": None})
    rank = 5  # (d, p, t) = (1, 0, 1)
    mesh = M.ProcessMesh(dp, "cpu", rank=rank, pp=pp, tp=tp,
                         groups=M.make_axis_groups(dp, 1, tp, rank, pp=pp))
    assert mesh.coords == (1, 0, 1) and mesh.shape == {"data": 2, "pipe": 2, "model": 2}
    assert mesh.desc == "data2xpipe2xmodel2"
    assert mesh.pipe.group == ("group", 5, 7) and mesh.pipe.index == 0
    assert mesh.data.group == ("group", 1, 5) and mesh.sync.group is mesh.data.group
    assert mesh.model.group == ("group", 4, 5)
    assert mesh.data_pipe.group == ("group", 1, 3, 5, 7) and mesh.data_pipe.index == 2
    assert len(made) == len(set(made))
