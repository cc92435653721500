"""The LM on the data axis: the port's `make_lm_train_step` on a process
group of 2 and of 4 gloo ranks on the CPU (tests/torch_rank_worker.py, one
launch per world size, every rank at OMP_NUM_THREADS=1) against the JAX
package's `make_lm_train_step` on `create_lm_mesh(dp, 1, 1)` over the 8
virtual CPU devices, from the same parameters (one JAX `init_params` tree,
handed to the ranks as numpy) and the same global numpy batches, for three
steps.

Cases: sgd, adam, zero, zero-adam (with clip and weight decay too), the
overlapped sync at accum 2 with a bucket cap small enough for many buckets
(against JAX overlap), and ZeRO overlap held to JAX END sync (JAX's own ZeRO
overlap at dp 4 is a known failure, ROADMAP "Known traps"). Tolerance (f32):
every step's loss within 2e-5 relative, every parameter and optimizer-state
element within atol = rtol = 2e-5. Inside the port, bitwise: zero against
sgd, zero-adam against adam (the update is elementwise on the same summed
gradient), and overlap at accum 1 against end; every rank's parameters are
the same bits. Then `lm_train` under `torch.distributed.run
--nproc-per-node 2 --device cpu`: both ranks' SUMMARY lines equal, ``mesh``
the JAX CLI's ``data2``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.train import lm as jlm

from torch_rank_worker import ROOT, launch

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, S, STEPS, TOL = 8, 16, 3, 2e-5
SMALL_MB = 0.01  # ~10 KB: several buckets at this width
ENV = {"OMP_NUM_THREADS": "1"}

# name -> (the port's make_lm_train_step arguments, the JAX reference's)
CASES = {
    "sgd": ({}, {}),
    "adam": ({"optimizer": "adam", "lr": 0.01}, {"optimizer": "adam", "lr": 0.01}),
    "zero": ({"optimizer": "zero"}, {"optimizer": "zero"}),
    "zero-adam": ({"optimizer": "zero-adam", "lr": 0.01},
                  {"optimizer": "zero-adam", "lr": 0.01}),
    "zero-clip-wd": ({"optimizer": "zero", "clip_norm": 0.5, "weight_decay": 0.01},
                     {"optimizer": "zero", "clip_norm": 0.5, "weight_decay": 0.01}),
    "end-accum2": ({"accum_steps": 2}, {"accum_steps": 2}),
    "overlap": ({"grad_sync": "overlap", "accum_steps": 2, "bucket_mb": SMALL_MB},
                {"grad_sync": "overlap", "accum_steps": 2, "bucket_mb": SMALL_MB}),
    # ZeRO overlap against JAX end sync
    "zero-overlap": ({"optimizer": "zero", "grad_sync": "overlap", "accum_steps": 2,
                      "bucket_mb": SMALL_MB}, {"optimizer": "zero", "accum_steps": 2}),
    "zero-adam-overlap": ({"optimizer": "zero-adam", "lr": 0.01, "grad_sync": "overlap",
                           "accum_steps": 2, "bucket_mb": SMALL_MB},
                          {"optimizer": "zero-adam", "lr": 0.01, "accum_steps": 2}),
    "overlap-accum1": ({"grad_sync": "overlap", "bucket_mb": SMALL_MB}, None),
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
    """Every case at world 2 and 4: {world: {case: [each rank's npz dict]}}."""
    d = tmp_path_factory.mktemp("lm_dp")
    np.savez(d / "params.npz", **_flat(jparams_np))
    toks, tgts = _batches()
    np.savez(d / "batches.npz", tokens=toks, targets=tgts)
    cases = [{"name": n, "kw": kw, "steps": STEPS} for n, (kw, _) in CASES.items()]
    out = {}
    from concurrent.futures import ThreadPoolExecutor

    jobs = {}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for w in WORLDS:
            (d / f"w{w}").mkdir()
            spec = {"device": "cpu", "out": str(d / f"w{w}"),
                    "lm": {"params": str(d / "params.npz"), "batches": str(d / "batches.npz"),
                           "cfg": KW, "cases": cases}}
            jobs[w] = pool.submit(launch, w, spec, timeout=240, env=ENV)
        for w, fut in jobs.items():
            for p in fut.result():
                assert p.returncode == 0, f"world {w}: {p.stderr[-3000:]}"
    for w in WORLDS:
        out[w] = {n: [dict(np.load(d / f"w{w}" / f"lm_{n}_rank{r}.npz")) for r in range(w)]
                  for n in CASES}
    return out


def _jax_run(jparams_np, dp, kw):
    """Three JAX steps on a (dp, 1, 1) mesh: (losses, flat params, state leaves)."""
    kw = dict(kw)
    mesh = jlm.create_lm_mesh(dp, 1, 1)
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


def _state_keys(got, prefix="state/"):
    """The rank's state leaves in the JAX tree order (numeric keys sort as
    numbers)."""
    keys = [k for k in got if k.startswith(prefix)]

    def order(k):
        return [int(p) if p.isdigit() else p for p in k[len(prefix):].split("/")]

    return sorted(keys, key=order)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c, (_, j) in CASES.items() if j is not None])
def test_dp_step_matches_jax(n_devices, jparams_np, ranks, world, case):
    want_loss, want_params, want_state = _jax_run(jparams_np, world, CASES[case][1])
    got = ranks[world][case]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], want_loss, rtol=TOL, err_msg=f"rank {r}")
        for k, v in want_params.items():
            np.testing.assert_allclose(g["params/" + k], v, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r} {k}")
            # every rank holds the same bits
            assert np.array_equal(g["params/" + k], got[0]["params/" + k]), (r, k)
    keys = _state_keys(got[0])
    assert len(keys) == len(want_state)
    for k, want in zip(keys, want_state):
        if CASES[case][0].get("optimizer", "sgd").startswith("zero"):
            # ZeRO: rank r holds shard r of each padded leaf; JAX holds it as
            # one (n*S,) global array
            whole = np.concatenate([g[k] for g in got])
            assert whole.shape == want.shape, k
        else:
            whole = got[0][k]
        np.testing.assert_allclose(whole.reshape(want.shape), want, atol=TOL, rtol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,like", [("zero", "sgd"), ("zero-adam", "adam"),
                                       ("overlap-accum1", "sgd")])
def test_bitwise_in_the_port(ranks, world, case, like):
    """ZeRO is the replicated update on the same summed gradient; overlap at
    accum 1 is the end schedule."""
    for a, b in zip(ranks[world][case], ranks[world][like]):
        assert np.array_equal(a["losses"], b["losses"])
        for k in a:
            if k.startswith("params/"):
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("world", WORLDS)
def test_overlap_buckets_and_collectives(ranks, world):
    """The overlap plan has several buckets, reduced by one collective part
    per micro-batch (one all-reduce or reduce-scatter per bucket), then the
    loss's all-reduce and, under ZeRO, the buckets' all-gather; end sync is
    one all-reduce; ZeRO adds the all-gather of the updated shards."""
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.collectives import plan_buckets
    from distributed_neural_network_tpu_torch.train import lm as tlm

    params = tfm.init_params(0, tfm.TransformerConfig(**KW))
    specs = tfm.param_specs(tfm.TransformerConfig(**KW))
    layout = plan_buckets(tlm.tree_leaves(params), bucket_bytes=int(SMALL_MB * 2**20),
                          group_keys=[str(s) for s in tlm.tree_leaves(specs)])
    assert layout.n_buckets > 1
    runs = ranks[world]
    assert int(runs["overlap"][0]["n_buckets"]) == layout.n_buckets
    assert int(runs["overlap"][0]["n_collectives"]) == 2 + 1
    assert int(runs["zero-overlap"][0]["n_collectives"]) == 2 + 1 + 1 + 1
    assert int(runs["sgd"][0]["n_collectives"]) == 1
    assert int(runs["zero"][0]["n_collectives"]) == 2


def test_lm_train_under_torchrun(tmp_path):
    env = dict(os.environ, **ENV)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "distributed_neural_network_tpu_torch.lm_train", "--device", "cpu",
           "--dp", "2", "--optimizer", "zero", "--steps", "3", "--batch-size", "8",
           "--seq-len", "16", "--vocab", "32", "--d-model", "32", "--n-heads", "4",
           "--n-layers", "2", "--d-ff", "64", "--log-every", "1"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=150, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    summaries = [l for l in lines if l.startswith("SUMMARY ")]
    assert len(summaries) == 2 and summaries[0] == summaries[1]
    summary = json.loads(summaries[0][8:])
    assert summary["mesh"] == "data2" and summary["final_loss"] < summary["first_loss"]
    for r in range(2):
        assert f"(Multi-process: rank {r}/2, backend gloo, device cpu)" in lines
    # the loss lines are the group's: each whole, the same on both ranks
    steps = [l for l in lines if l.startswith("step ")]
    assert len(steps) == 6 and all(steps.count(l) == 2 for l in steps)


def test_dp_without_a_card_raises_before_joining(monkeypatch):
    """No fallback: --dp 2 on the default device without a card is refused
    before any group is joined."""
    import torch

    from distributed_neural_network_tpu_torch import lm_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lm_train.main(["--dp", "2", "--steps", "1"], log=lambda line: None)


def test_distribute_host_data_gives_the_jax_rows(n_devices):
    """Rank r's block is the rows JAX's P("data") sharding puts on device r,
    from the full copy and from the local rows alike."""
    import torch
    from jax.sharding import NamedSharding, PartitionSpec

    from distributed_neural_network_tpu_torch.parallel.distributed import distribute_host_data
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh

    x = np.arange(8 * 3).reshape(8, 3)
    mesh = jlm.create_lm_mesh(4, 1, 1)
    arr = jax.device_put(x, NamedSharding(mesh, PartitionSpec("data")))
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, dev in enumerate(mesh.devices.reshape(-1)):
        pm = ProcessMesh(4, torch.device("cpu"), rank=r)
        got = distribute_host_data(x, pm)
        np.testing.assert_array_equal(got.numpy(), shards[dev])
        local = distribute_host_data(shards[dev], pm, full_copy=False)
        np.testing.assert_array_equal(local.numpy(), shards[dev])
    with pytest.raises(ValueError, match="--dp"):
        distribute_host_data(x[:6], ProcessMesh(4, torch.device("cpu")))


@pytest.mark.parametrize("kw", [{"optimizer": "zero"},
                                {"optimizer": "zero-adam", "grad_sync": "overlap",
                                 "accum_steps": 2, "bucket_mb": SMALL_MB},
                                {"grad_sync": "overlap", "accum_steps": 2,
                                 "bucket_mb": SMALL_MB, "with_health": True}])
def test_dropped_data_axis_step_frees_its_program_at_once(kw):
    """The data-axis step's parts (collectives, reducers, ZeRO shards) close
    over buffers, not over the step: dropping it frees the program without
    the garbage collector (a graph freed by the collector inside another
    capture would spoil that capture)."""
    import gc
    import weakref

    import torch

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.train import lm as tlm

    cfg = tfm.TransformerConfig(**KW)
    params = tfm.init_params(0, cfg)
    mom = tlm.init_lm_momentum(params, kw.get("optimizer", "sgd"))
    toks, tgts = (torch.from_numpy(x[0]).long() for x in _batches())
    gc.disable()
    try:
        step = tlm.make_lm_train_step(cfg, device="cpu", **kw)
        step(params, mom, toks, tgts, 0)
        assert step.synced
        refs = [weakref.ref(step.program), weakref.ref(step)]
        del step
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
