"""Checkpoint and exact resume in the port (`utils/checkpoint.py`,
`train/guard.py`, `train/engine.py` `run(checkpointer=...)`, the two CLIs),
on the CPU at small shapes.

1. The JAX package's `tests/test_checkpoint.py` cases on the port's engine
   and backend: a resumed run equals the uninterrupted one bit for bit (per
   epoch and fused, with a fault mask); retention; worker-count and regime
   mismatches; a corrupt newest checkpoint falls back; a wrong layout names
   the leaf; all corrupt raises; a stale tmp directory is swept; a tree
   (bf16 and int leaves included) round-trips, and `orbax` raises the JAX
   text.
2. Cross-reads in both directions, npz: a JAX Engine checkpoint resumes in
   the port and the continued epoch matches the JAX uninterrupted run
   within tests/test_torch_engine.py's bounds; a port checkpoint resumes in
   the JAX `Checkpointer` (the state bit for bit) and the JAX run continues
   within the same bounds; a JAX `TreeCheckpointer` LM tree from
   `make_lm_train_step` resumes in the port's step (and the port's in the
   JAX step) within tests/test_torch_lm_step.py's tolerance.
3. The CLIs: the CNN's --checkpoint-dir then --resume equals the
   uninterrupted run bitwise; the LM's --stop-at-step then --resume on one
   process (Adam, a cosine schedule) and at --dp 2 --tp 2 on four gloo
   ranks (`port_probes/ckpt_world.py`, whose trace shards merge with
   tools/trace_merge.py), and ZeRO-Adam, experts, zigzag sequence
   parallelism and the interleaved pipeline with ZeRO on two; a SIGTERM
   mid-run writes an emergency checkpoint
   and the resume is exact.
"""

import dataclasses
import functools
import json
import os
import shutil
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.data.cifar10 import load_split as jax_load_split
from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.ops import schedule as jsched
from distributed_neural_network_tpu.parallel.fault import epoch_key
from distributed_neural_network_tpu.parallel.fault import live_mask as jax_live_mask
from distributed_neural_network_tpu.train import lm as jlm
from distributed_neural_network_tpu.train.engine import Engine as JaxEngine
from distributed_neural_network_tpu.train.engine import TrainConfig as JaxConfig
from distributed_neural_network_tpu.utils import checkpoint as jck
from distributed_neural_network_tpu_torch import lm_train
from distributed_neural_network_tpu_torch.data.cifar10 import load_split
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.ops import schedule as tsched
from distributed_neural_network_tpu_torch.train import cli
from distributed_neural_network_tpu_torch.train import lm as tlm
from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig
from distributed_neural_network_tpu_torch.train.guard import PreemptionGuard
from distributed_neural_network_tpu_torch.utils import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WORKERS = 4


def _engine(epochs=4, p_fail=0.5, seed=3, rows=96, **kw):
    cfg = TrainConfig(nb_proc=2, lr=0.05, batch_size=16, epochs=epochs, seed=seed,
                      failure_probability=p_fail, **kw)
    return Engine(cfg, load_split(True, source="synthetic", synthetic_size=rows, seed=seed),
                  load_split(False, source="synthetic", synthetic_size=20, seed=seed),
                  device="cpu")


def _history(eng) -> list:
    return [dataclasses.asdict(m) for m in eng.history]


def _state_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(tlm.tree_leaves(a), tlm.tree_leaves(b)))


# ------------------------------------------------------------- 1. the engine


@pytest.mark.parametrize("fused", [False, True])
def test_resume_equals_uninterrupted_bitwise(tmp_path, fused):
    """2 epochs with a checkpointer, then a new engine resumed to 4: the
    params, the momentum stack and every epoch's metrics are the
    uninterrupted run's, with a fault mask (the cursor: seed and epoch)."""
    ref = _engine(reset_momentum=False)
    ref.run(log=lambda _: None, fused=fused)
    a = _engine(epochs=2, reset_momentum=False)
    a.run(log=lambda _: None, fused=fused, checkpointer=ck.Checkpointer(str(tmp_path)))
    b = _engine(reset_momentum=False)
    start = ck.Checkpointer(str(tmp_path)).restore_latest(b, log=lambda _: None)
    assert start == 2 and b.history == a.history
    b.run(log=lambda _: None, fused=fused, start_epoch=start)
    assert b.history == ref.history and len({m.n_live for m in ref.history}) > 1
    assert _state_equal(b.state_tree(), ref.state_tree())


def test_retention_and_every(tmp_path):
    eng = _engine(epochs=5, p_fail=0.0)
    c = ck.Checkpointer(str(tmp_path), every=2, keep=2)
    eng.run(log=lambda _: None, checkpointer=c)
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_3"]
    assert c.latest_epoch() == 3


@pytest.mark.parametrize("what", ["workers", "regime"])
def test_mismatch_raises_naming_the_fix(tmp_path, what):
    eng = _engine(epochs=1, p_fail=0.0)
    eng.run(log=lambda _: None, checkpointer=ck.Checkpointer(str(tmp_path)))
    other = (Engine(TrainConfig(nb_proc=4, epochs=1), load_split(True, source="synthetic",
                                                                 synthetic_size=96, seed=3),
                    None, device="cpu") if what == "workers" else
             _engine(epochs=1, p_fail=0.0, regime="replication"))
    match = "n_workers=2, engine has 4" if what == "workers" else "regime mismatch"
    with pytest.raises(ValueError, match=match):
        ck.Checkpointer(str(tmp_path)).restore_latest(other, log=lambda _: None)


def _tree_ckpt(tmp_path):
    c = ck.TreeCheckpointer(str(tmp_path), keep=5)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"x": np.ones(2, np.int32)}}
    for step in (1, 2):
        c.save(step, {k: v for k, v in tree.items()}, {"step": step})
    return c, tree


def test_corrupt_newest_falls_back(tmp_path):
    c, tree = _tree_ckpt(tmp_path)
    with open(tmp_path / "step_2" / "state.npz", "wb") as f:
        f.write(b"not a zip")
    warnings = []
    state, meta, step = c.restore_latest(tree, log=warnings.append)
    assert step == 1 and meta == {"step": 1} and _state_equal(state, tree)
    assert "step 2" in warnings[0] and "falling back" in warnings[0]
    assert c.latest_meta(log=lambda _: None) == (2, {"step": 2})


def test_wrong_layout_names_the_leaf(tmp_path):
    c, tree = _tree_ckpt(tmp_path)
    bad = {"w": np.zeros((3, 2), np.float32), "b": {"x": np.ones(2, np.int32)}}
    with pytest.raises(ck.CheckpointCorruptError, match=r"\['w'\] shape \(2, 3\)"):
        ck._NpzBackend(str(tmp_path), 5).restore(2, bad)
    with pytest.raises(ck.CheckpointCorruptError, match=r"\['b'\]\['x'\] dtype int32"):
        ck._NpzBackend(str(tmp_path), 5).restore(2, {**tree, "b": {"x": np.ones(2, np.float32)}})


def test_all_corrupt_raises(tmp_path):
    c, tree = _tree_ckpt(tmp_path)
    for step in (1, 2):
        os.remove(tmp_path / f"step_{step}" / "state.npz")
    with pytest.raises(ck.CheckpointCorruptError, match="step 1"):
        c.restore_latest(tree, log=lambda _: None)


def test_stale_tmp_swept_and_orbax_refused(tmp_path):
    (tmp_path / "step_7.tmp").mkdir()
    (tmp_path / "step_7.tmp" / "state.npz").write_bytes(b"half")
    (tmp_path / "notes.tmp").mkdir()
    c = ck.TreeCheckpointer(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["notes.tmp"] and c.backend_name == "npz"
    with pytest.raises(RuntimeError, match="orbax backend requested but orbax is not "
                                           "importable"):
        ck.TreeCheckpointer(str(tmp_path), backend="orbax")


def test_tree_round_trip_bf16_as_the_jax_backend_writes_it(tmp_path):
    """A tree of tensors (bf16 and int32 among them) round-trips through the
    port and reads in the JAX backend: the bf16 leaf is stored as JAX
    stores one (raw two bytes an element, numpy V2)."""
    tree = {"a": torch.randn(3, 4), "h": torch.randn(5).to(torch.bfloat16),
            "t": np.asarray(7, np.int32)}
    c = ck.TreeCheckpointer(str(tmp_path))
    c.save(0, tree, {"k": 1})
    template = tlm.tree_map(lambda x: x, tree)
    state, meta, step = c.restore_latest(template)
    assert meta == {"k": 1} and step == 0 and c.last_save[1] == 3 * 4 * 4 + 5 * 2 + 4
    assert torch.equal(ck.to_torch(state["h"]), tree["h"]) and state["t"] == 7
    assert torch.equal(ck.to_torch(state["a"]), tree["a"])
    leaves, jmeta = jck._NpzBackend(str(tmp_path), 3).restore(0)
    jbf16 = np.asarray(jnp.asarray(tree["h"].float().numpy(), jnp.bfloat16))
    assert leaves[1].dtype == np.dtype("V2") and leaves[1].tobytes() == jbf16.tobytes()


# ------------------------------------------------------------ 2. cross-reads


def _jax_order(seed, epoch, worker, n_rows):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), jnp.uint32(epoch)),
                             jnp.int32(worker))
    return np.asarray(jax.random.permutation(key, n_rows))


def test_cnn_checkpoints_cross_read_with_the_jax_package(n_devices, tmp_path):
    """JAX writes epoch 0, the port resumes it and trains epoch 1; the port
    writes epoch 0 (from JAX's initial state, JAX's orders and masks), the
    JAX Checkpointer restores it bit for bit and trains epoch 1: both
    continuations within test_torch_engine.py's bounds of the JAX
    uninterrupted run."""
    seed, p_fail = 1, 0.5
    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=2, nb_proc=N_WORKERS,
              regime="data_parallel", seed=seed, failure_probability=p_fail, eval_batch_size=8)
    size = dict(source="synthetic", synthetic_size=128, seed=seed)
    test_size = dict(source="synthetic", synthetic_size=30, seed=seed)
    test_split = load_split(False, **test_size)

    def port():
        return Engine(TrainConfig(**kw), load_split(True, **size), test_split, device="cpu",
                      orders=lambda e, d: _jax_order(seed, e, d, 128 // N_WORKERS),
                      masks=lambda e: np.asarray(jax_live_mask(epoch_key(seed, e), N_WORKERS,
                                                               p_fail)))

    jeng = JaxEngine(JaxConfig(**kw), jax_load_split(True, **size), jax_load_split(False,
                                                                                   **test_size))
    state0 = jax.tree.map(np.asarray, jeng.state_tree())
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng.run_epoch(0)
    jck.Checkpointer(jdir, backend="npz").save(0, jeng)
    want = jeng.run_epoch(1)
    want_params = jax.tree.map(np.asarray, jeng.params)

    resumed = port()
    assert ck.Checkpointer(jdir).restore_latest(resumed, log=lambda _: None) == 1
    assert _history(resumed) == _history(jeng)[:1]
    got = resumed.run_epoch(1)

    writer = port()
    writer.load_state_tree(state0)
    writer.run_epoch(0)
    ck.Checkpointer(pdir).save(0, writer)
    # the JAX engine itself resumes the port's epoch 0 (its programs are built)
    assert jck.Checkpointer(pdir, backend="npz").restore_latest(jeng, log=lambda _: None) == 1
    assert _state_equal(jax.tree.map(np.asarray, jeng.state_tree()), writer.state_tree())
    assert _history(jeng) == _history(writer)
    jgot = jeng.run_epoch(1)
    for m, params in ((got, resumed.state_tree()["params"]),
                      (jgot, jax.tree.map(np.asarray, jeng.params))):
        assert m.n_live == want.n_live
        assert abs(m.train_loss - want.train_loss) < 5e-4
        assert abs(m.val_loss - want.val_loss) < 5e-4
        assert abs(m.val_acc - want.val_acc) <= 100.0 / len(test_split) + 1e-9
        rel = max(float(np.max(np.abs(np.asarray(x) - y) / (np.abs(y) + 1e-3)))
                  for x, y in zip(jax.tree.leaves(params), jax.tree.leaves(want_params)))
        assert rel < 2e-3


def _lm_batch(i):
    toks = np.random.default_rng(i).integers(2, 32, size=(4, 16)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def test_lm_trees_cross_read_with_the_jax_package(n_devices, tmp_path):
    """The JAX trainer's {"params", "mom"} tree (Adam, a cosine schedule)
    after one step, saved by the JAX `TreeCheckpointer`, resumes in the
    port's step, and the port's after one step in the JAX step: two more
    steps each, within tests/test_torch_lm_step.py's 2e-5 of the JAX
    uninterrupted run (losses and parameters)."""
    tol = 2e-5
    kwc = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    jcfg, cfg = jtfm.TransformerConfig(**kwc), tfm.TransformerConfig(**kwc)
    sk = dict(base_lr=0.01, total_steps=3, warmup_steps=1, min_lr_frac=0.1)
    mesh = jlm.create_lm_mesh(1, 1, 1)
    jparams_np = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), jcfg))

    jstep = jlm.make_lm_train_step(jcfg, mesh, lr=0.01, optimizer="adam",
                                   lr_schedule=functools.partial(jsched.warmup_cosine, **sk))

    def jax_run(params, mom, steps):
        losses = []
        for i in steps:
            toks, tgts = _lm_batch(i)
            params, mom, loss = jstep(params, mom, jnp.asarray(toks), jnp.asarray(tgts),
                                      jnp.int32(i))
            losses.append(float(loss))
        return params, mom, losses

    jp0, _ = jlm.shard_params(jax.tree.map(jnp.asarray, jparams_np), jcfg, mesh)
    jp1, jm1, _ = jax_run(jp0, jlm.init_lm_momentum(jp0, mesh, "adam"), [0])
    jck.TreeCheckpointer(str(tmp_path / "jax"), backend="npz").save(
        0, {"params": jp1, "mom": jm1}, {"step": 0})
    jp3, _, want = jax_run(jp1, jm1, [1, 2])
    want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, jp3))

    def port_step():
        return tlm.make_lm_train_step(
            cfg, device="cpu", lr=0.01, optimizer="adam",
            lr_schedule=functools.partial(tsched.warmup_cosine, **sk))

    specs = tfm.param_specs(cfg)
    mom_specs = tlm.optimizer_state_specs("adam", specs)
    mesh_p = tlm.ProcessMesh(1, torch.device("cpu"))
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params, "adam")
    template = tlm.checkpoint_template(params, mom, specs, mom_specs, mesh_p, "adam")
    state, _, _ = ck.TreeCheckpointer(str(tmp_path / "jax")).restore_latest(template)
    tlm.load_checkpoint_state(state, params, mom, specs, mom_specs, mesh_p, "adam")
    assert mom["t"] == 1
    step = port_step()
    for i, w in zip((1, 2), want):
        toks, tgts = (torch.from_numpy(x).long() for x in _lm_batch(i))
        assert float(step(params, mom, toks, tgts, i)) == pytest.approx(w, rel=tol)
    for a, b in zip(tlm.tree_leaves(params), want_leaves):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=tol, rtol=tol)

    # the port's tree after one step, into the JAX step
    params = tfm.from_jax_params(jparams_np)
    mom = tlm.init_lm_momentum(params, "adam")
    toks, tgts = (torch.from_numpy(x).long() for x in _lm_batch(0))
    port_step()(params, mom, toks, tgts, 0)
    ck.TreeCheckpointer(str(tmp_path / "port")).save(
        0, tlm.checkpoint_state(params, mom, specs, mom_specs, mesh_p, "adam"), {"step": 0})
    jstate, _, _ = jck.TreeCheckpointer(str(tmp_path / "port"), backend="npz").restore_latest(
        {"params": jp1, "mom": jm1})
    jp3b, _, got = jax_run(jax.tree.map(jnp.asarray, jstate["params"]),
                           jax.tree.map(jnp.asarray, jstate["mom"]), [1, 2])
    assert got == pytest.approx(want, rel=tol)
    for a, b in zip(jax.tree.leaves(jp3b), want_leaves):
        np.testing.assert_allclose(np.asarray(a), b, atol=tol, rtol=tol)


# ----------------------------------------------------------------- 3. CLIs

TINY_CNN = ["--device", "cpu", "--synthetic-size", "96", "--nb-proc", "2", "--lr", "0.05",
            "--failure-probability", "0.5", "--seed", "3", "--kernels", "cuda"]


@pytest.mark.parametrize("fused", [[], ["--fused"]])
def test_cnn_cli_resume_is_bitwise(tmp_path, fused):
    def run(name, *extra):
        lines = []
        assert cli.main([*TINY_CNN, *fused, "--log-dir", str(tmp_path / "log"),
                         "--checkpoint-dir", str(tmp_path / name), *extra],
                        log=lines.append) == 0
        return [l for l in lines if l.startswith(("Global", "Validation"))]

    whole = run("a", "--epochs", "4")
    first = run("b", "--epochs", "2")
    rest = run("b", "--epochs", "4", "--resume")
    assert first + rest == whole
    a, b = (ck._NpzBackend(str(tmp_path / n), 3) for n in ("a", "b"))
    (sa, ma), (sb, mb) = a.restore(3), b.restore(3)
    assert ma == mb and all(np.array_equal(x, y) for x, y in zip(sa, sb))


LM = ["--device", "cpu", "--batch-size", "4", "--seq-len", "16", "--vocab", "32",
      "--d-model", "32", "--n-heads", "4", "--n-layers", "2", "--d-ff", "64", "--log-every",
      "1", "--attn", "flash", "--optimizer", "adam", "--lr", "0.01", "--lr-schedule",
      "cosine", "--warmup-steps", "1", "--steps", "4"]


def _lm(*extra, log=None):
    res, lines = {}, []

    def keep(line):
        lines.append(line)
        if log is not None:
            log(line)

    assert lm_train.main([*LM, *extra], log=keep, result=res) == 0
    summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
    return res, summary


def _same_run(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(tlm.tree_leaves(a["params"]),
                                                   tlm.tree_leaves(b["params"])))
            and a["mom"]["t"] == b["mom"]["t"]
            and all(torch.equal(x, y) for k in ("m", "v")
                    for x, y in zip(a["mom"][k], b["mom"][k])))


def test_lm_cli_stop_and_resume_is_bitwise(tmp_path):
    whole, _ = _lm()
    first, s1 = _lm("--checkpoint-dir", str(tmp_path), "--stop-at-step", "2")
    rest, s2 = _lm("--checkpoint-dir", str(tmp_path), "--resume", "--stop-at-step", "4")
    assert (s1["last_step"], s2["start_step"], s2["last_step"]) == (1, 2, 3)
    assert first["losses"] + rest["losses"] == whole["losses"] and _same_run(rest, whole)
    with pytest.raises(SystemExit, match="already contains checkpoints"):
        _lm("--checkpoint-dir", str(tmp_path))
    with pytest.raises(SystemExit, match="optimizer='adam', this run has 'sgd'"):
        _lm("--checkpoint-dir", str(tmp_path), "--resume", "--optimizer", "sgd")


def test_sigterm_writes_an_emergency_checkpoint_and_the_resume_is_exact(tmp_path):
    """A real SIGTERM, delivered to this process as step 1 is logged: the
    flag is read when the next step is launched (the ranks agree on it
    while the card runs that step), so the loop finishes step 2, writes an
    emergency checkpoint and stops; the resume continues the uninterrupted
    run bit for bit."""
    whole, _ = _lm()

    def kill_at_step_1(line):
        if line.startswith("step     1"):
            os.kill(os.getpid(), signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    first, s1 = _lm("--checkpoint-dir", str(tmp_path), log=kill_at_step_1)
    assert signal.getsignal(signal.SIGTERM) is handler  # put back
    assert s1["preempted"] and s1["last_step"] == 2 and os.listdir(tmp_path) == ["step_2"]
    rest, s2 = _lm("--checkpoint-dir", str(tmp_path), "--resume", "--stop-at-step", "4")
    assert not s2["preempted"] and first["losses"] + rest["losses"] == whole["losses"]
    assert _same_run(rest, whole)
    guard = PreemptionGuard(log=lambda _: None)
    guard.request("TEST")
    assert guard.agreed() and guard.signame == "TEST"


MESH_RUNS = {
    4: [("dp2tp2", ["--dp", "2", "--tp", "2", "--attn", "flash", "--optimizer", "adam",
                    "--lr-schedule", "cosine", "--warmup-steps", "1"])],
    2: [("dp2-zero-adam", ["--dp", "2", "--optimizer", "zero-adam", "--lr-schedule", "cosine"]),
        ("dp2-experts", ["--dp", "2", "--experts", "4", "--optimizer", "adam"]),
        ("sp2-zigzag", ["--sp", "2", "--attn", "zigzag"]),
        ("pp2-v2-zero", ["--pp", "2", "--pp-interleave", "2", "--microbatches", "4",
                         "--optimizer", "zero"])],
}


@pytest.mark.parametrize("world", [4, 2])
def test_lm_resume_on_gloo_ranks(tmp_path, world):
    """port_probes/ckpt_world.py's flow at a tiny width on CPU ranks: at
    world 4 --dp 2 --tp 2 (flash, Adam, cosine), at world 2 ZeRO-Adam,
    experts over the data axis, zigzag sequence parallelism and the
    interleaved pipeline with ZeRO: each resumed run's losses and final
    gathered tree are the uninterrupted run's bit for bit, every rank
    agrees, and each stopped run's trace shards merge."""
    sys.path[:0] = [os.path.join(ROOT, "port_probes")]
    try:
        import ckpt_world as W
    finally:
        sys.path.remove(os.path.join(ROOT, "port_probes"))
    tiny = ["--batch-size", "8", "--seq-len", "16", "--vocab", "32", "--d-model", "32",
            "--n-heads", "4", "--n-layers", "4", "--d-ff", "64", "--lr", "0.01"]
    runs = MESH_RUNS[world]
    out = str(tmp_path / "out")
    ranks = W.run_world(world, out, tiny, runs, device="cpu", timeout=240,
                        env={"OMP_NUM_THREADS": "1"})
    res = W.check(ranks, runs, out)
    assert [res[name]["mesh"] for name, _ in runs] == (
        ["data2xmodel2"] if world == 4 else ["data2", "data2", "seq2", "pipe2"])
    for name, _ in runs:
        with open(os.path.join(out, f"{name}_trace_merged.json")) as f:
            merged = json.load(f)
        pids = {e["pid"] for e in merged["traceEvents"] if e.get("name") == "train_step"}
        assert pids == set(range(world))
    shutil.rmtree(out)
