"""Elastic resume in the port (`train/elastic.py`, `lm_train.py --elastic`
and ``--chaos-shrink-at-step``, `utils/checkpoint.py`
`Checkpointer.restore_latest(elastic=True)`), on the CPU:

- `elastic_restore` of checkpoints the JAX package wrote on its 8 CPU
  devices gives JAX `elastic_restore`'s host state bitwise, and the same
  log lines: dp 8 -> dp 4 and (2, 1, 2), zero -> zero (re-padded), zero ->
  sgd, zero-adam -> adam, and the interleaved pipeline's ZeRO (pp 2, v 2)
  -> dp 1;
- the LM entry point across gloo ranks (as JAX `tests/test_reshard.py`'s
  CLI tests, `port_probes/elastic_world.py`'s flow at a tiny width): a
  SIGTERM at dp 4, then ``--resume --elastic`` at dp 2 and at (2, 1, 2);
  a zero (dp 4) checkpoint resumed as sgd (dp 2); the in-process shrink 4
  -> 2, whose ranks 2-3 exit 0: every continuation within 1e-3 of the
  uninterrupted run, the steps before the shrink bitwise;
- the CNN engine's momentum stack: 4 workers -> 2 and -> 8 in one process,
  and 2 ranks x 2 workers -> one process of 2 workers, the surviving rows
  bitwise the saved ones.

The ranks run at OMP_NUM_THREADS=1 (tests/torch_rank_worker.py `launch`).
"""

import json
import math
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributed_neural_network_tpu_torch.models import transformer as ptfm
from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
from distributed_neural_network_tpu_torch.train import elastic as PE
from distributed_neural_network_tpu_torch.utils.checkpoint import Checkpointer as PCheckpointer
from distributed_neural_network_tpu_torch.utils.checkpoint import TreeCheckpointer
from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_probes"))

import elastic_world as EW  # noqa: E402
from torch_rank_worker import launch  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1"}
# --steps after elastic_world.py's own (the later flag wins)
TINY = ["--steps", "8", "--batch-size", "16", "--seq-len", "16", "--vocab", "32",
        "--d-model", "32", "--n-heads", "4", "--n-layers", "2", "--d-ff", "64", "--lr", "0.05",
        "--seed", "0"]
STEPS, KILL = 8, 3  # the SIGTERM after step 3 stops the run after step 4
SHRINK = 3


def _close(a, b, rtol=1e-3):
    """The JAX gate (`tests/test_reshard.py` `_losses_close`)."""
    assert len(a) == len(b), (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert math.isfinite(x) and math.isfinite(y)
        assert abs(x - y) <= rtol * max(abs(x), abs(y), 1e-3), (i, x, y)


# ------------------------------------------- JAX-written checkpoints


def _no_seconds(lines):
    return [re.sub(r" in [0-9.]+s\)$", ")", line) for line in lines]


def _jax_case(tmp_path, name):
    """(JAX checkpointer, cfg kwargs, the target (dp, tp), optimizer, the
    current meta's batch) of one case, its checkpoint written by JAX."""
    import test_reshard as JT

    if name.startswith("pp2v2"):
        kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64)
        ck, *_ = JT._save_pp_zero_checkpoint(tmp_path, JT._cfg(n_layers=4), interleave=2)
        return ck, kw, (1, 1), "sgd", 16
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    saved, target = name.split("->")
    ck, *_ = JT._save_checkpoint(tmp_path, JT._cfg(), dp=8, optimizer=saved.split("-", 1)[1])
    dp, tp, optimizer = {"dp4": (4, 1, "sgd"), "2x1x2": (2, 2, "sgd"),
                         "dp4-zero": (4, 1, "zero"), "dp2-sgd": (2, 1, "sgd"),
                         "dp4-adam": (4, 1, "adam")}[target]
    return ck, kw, (dp, tp), optimizer, 32


@pytest.mark.parametrize("name", ["dp8-sgd->dp4", "dp8-sgd->2x1x2", "dp8-zero->dp4-zero",
                                  "dp8-zero->dp2-sgd", "dp8-zero-adam->dp4-adam",
                                  "pp2v2-zero->dp1-sgd"])
def test_elastic_restore_of_a_jax_checkpoint_is_jax_s_host_state(tmp_path, n_devices, name):
    import jax

    from distributed_neural_network_tpu.models import transformer as jtfm
    from distributed_neural_network_tpu.train import elastic as JE
    from distributed_neural_network_tpu.train import lm as jlm

    ck, kw, (dp, tp), optimizer, batch = _jax_case(tmp_path, name)
    mesh = jlm.create_lm_mesh(dp, 1, tp)
    specs, ps, ms = jlm.make_lm_shardings(jtfm.TransformerConfig(**kw), mesh, optimizer)
    jlog, plog = [], []
    jstate, jmeta, jstep, jres = JE.elastic_restore(
        ck, cfg=jtfm.TransformerConfig(**kw), mesh=mesh, specs=specs, optimizer=optimizer,
        param_shardings=ps, mom_shardings=ms,
        current_meta=JE.lm_mesh_meta(mesh, specs, optimizer, batch=batch, accum_steps=1),
        log=jlog.append)
    ck.close()
    pcfg = ptfm.TransformerConfig(**kw)
    pmesh = ProcessMesh(dp, torch.device("cpu"), tp=tp)
    pspecs = ptfm.param_specs(pcfg, tp_axis="model" if tp > 1 else None)
    pstate, pmeta, pstep, pres = PE.elastic_restore(
        TreeCheckpointer(str(tmp_path / "ck")), cfg=pcfg, mesh=pmesh, specs=pspecs,
        optimizer=optimizer,
        current_meta=PE.lm_mesh_meta(pmesh, pspecs, optimizer, batch=batch, accum_steps=1),
        log=plog.append)
    assert (pres, pstep, pmeta) == (jres, jstep, jmeta) and pres
    jl, pl = jax.tree.leaves(jstate), tree_leaves(pstate)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert _no_seconds(plog) == _no_seconds(jlog)
    assert any("(elastic: resharded checkpoint step" in line for line in plog)


# ---------------------------------------------- the LM across gloo ranks


def _runs4(out):
    k, z, s = (os.path.join(out, d) for d in ("killed", "zero_killed", "shrink"))
    dp4 = ["--dp", "4"]
    kill = ["--checkpoint-every", "100", "--chaos-sigterm-after", str(KILL)]
    return [
        ["whole", dp4, {}],
        ["killed", dp4 + kill + ["--checkpoint-dir", k], {}],
        ["r2x1x2", ["--dp", "2", "--tp", "2", "--resume", "--elastic", "--stop-at-step",
                    str(STEPS), "--checkpoint-dir", k + "_2x1x2"], {"copy": [k, k + "_2x1x2"]}],
        ["zero_whole", dp4 + ["--optimizer", "zero"], {}],
        ["zero_killed", dp4 + ["--optimizer", "zero", "--checkpoint-dir", z] + kill, {}],
        ["shrink", dp4 + ["--chaos-shrink-at-step", str(SHRINK), "--chaos-shrink-to", "2",
                          "--checkpoint-dir", s], {}],
    ]


def _runs2(out):
    return [
        ["r2", ["--dp", "2", "--resume", "--elastic", "--stop-at-step", str(STEPS),
                "--checkpoint-dir", os.path.join(out, "killed")], {}],
        ["zero_as_sgd", ["--dp", "2", "--optimizer", "sgd", "--resume", "--elastic",
                         "--stop-at-step", str(STEPS), "--checkpoint-dir",
                         os.path.join(out, "zero_killed")], {}],
    ]


CNN = {"name": "el", "resume": {"stop": 2},
       "config": dict(lr=0.05, momentum=0.9, batch_size=8, epochs=3, nb_proc=4,
                      regime="data_parallel", seed=1, kernels="cuda", failure_probability=0.5,
                      reset_momentum=False),
       "train": {"size": 256, "seed": 3}, "test": {"size": 64, "seed": 3}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of 4 ranks over `_runs4`, then one of 2 ranks over
    `_runs2` (the LM), beside one launch of 2 ranks x 2 workers of the CNN
    engine writing its checkpoints (`torch_rank_worker` "resume")."""
    out = str(tmp_path_factory.mktemp("lm"))
    cnn = str(tmp_path_factory.mktemp("cnn"))
    with ThreadPoolExecutor(2) as pool:
        cnn_job = pool.submit(launch, 2, {"device": "cpu", "out": cnn, "runs": [CNN]},
                              timeout=150, env=ENV)
        four = EW.run_world(4, out, TINY, _runs4(out), device="cpu", env=ENV, timeout=150)
        two = EW.run_world(2, os.path.join(out, "two"), TINY, _runs2(out), device="cpu", env=ENV,
                           timeout=150)
        for p in cnn_job.result():
            assert p.returncode == 0, p.stderr[-3000:]
    return {"four": four, "two": two, "cnn": cnn}


def _same_on_ranks(recs, name):
    got = [r["runs"][name] for r in recs]
    assert all(g["losses"] == got[0]["losses"] for g in got), name
    return got[0]


def test_kill_at_dp4_resumes_elastically_at_dp2_and_2x1x2(ranks):
    """SIGTERM mid-run at dp 4 -> emergency checkpoint -> --elastic resume
    at dp 2 (2 ranks) and at dp 2 x tp 2 (4 ranks): the continued losses
    within 1e-3 of the uninterrupted dp-4 run (the loss sum reassociates
    across dp; the data stream is exact), the JAX lines."""
    whole = _same_on_ranks(ranks["four"], "whole")["losses"]
    killed = _same_on_ranks(ranks["four"], "killed")
    assert len(whole) == STEPS and killed["losses"] == whole[:KILL + 2]
    assert killed["summary"]["preempted"] is True
    assert f"(emergency checkpoint at step {KILL + 1}; resume with --resume to continue " \
           "bit-exactly)" in killed["log"]
    for recs, name, mesh in ((ranks["two"], "r2", "data2"),
                             (ranks["four"], "r2x1x2", "data2xmodel2")):
        rec = _same_on_ranks(recs, name)
        assert rec["start_step"] == KILL + 2 and rec["mesh"] == mesh
        assert f"(Resumed from step {KILL + 1}; continuing at {KILL + 2})" in rec["log"]
        assert "(elastic: mesh axis 'data': saved 4, target 2)" in rec["log"]
        assert any(l.startswith(f"(elastic: resharded checkpoint step {KILL + 1} [data4, sgd] "
                                f"-> [{mesh}, sgd]") for l in rec["log"])
        assert "(elastic: accum-steps 1 -> 2 keeps the global batch 16 - and with it the data " \
               "cursor - exact across the dp change)" in rec["log"]
        assert rec["summary"]["accum_steps"] == 2 and rec["summary"]["last_step"] == STEPS - 1
        (r,) = rec["reshards"]
        assert r["step"] == KILL + 1 and r["bytes"] > 0
        _close(rec["losses"], whole[KILL + 2:])


def test_zero_checkpoint_resumes_as_sgd(ranks):
    """Optimizer-layout elasticity from the CLI: a zero (dp 4) checkpoint
    resumes as sgd (dp 2) on the matching trajectory."""
    whole = _same_on_ranks(ranks["four"], "zero_whole")["losses"]
    rec = _same_on_ranks(ranks["two"], "zero_as_sgd")
    assert "(elastic: optimizer layout: saved 'zero', target 'sgd')" in rec["log"]
    _close(rec["losses"], whole[KILL + 2:])


def test_inprocess_shrink_4_to_2(ranks):
    """--chaos-shrink-at-step drives the preempt -> checkpoint -> reshard ->
    resume path inside the run: ranks 2-3 leave with exit 0 (their record
    says so), ranks 0-1 finish every step on data2 with accum 2, the steps
    before the shrink bitwise the uninterrupted run's, the rest within 1e-3,
    SUMMARY preempted false (the JAX CLI test's checks)."""
    whole = _same_on_ranks(ranks["four"], "whole")["losses"]
    recs = [r["runs"]["shrink"] for r in ranks["four"]]
    for r, rec in enumerate(recs):
        assert rec["left"] == (r >= 2)
    for r, rec in enumerate(recs[2:], 2):
        assert rec["summary"] is None and rec["losses"] == whole[:SHRINK + 1]
        assert (f"(elastic: rank {r} of 4 leaves after step {SHRINK}; ranks 0-1 continue on "
                "the shrunk mesh)") in rec["log"]
    kept = _same_on_ranks(ranks["four"][:2], "shrink")
    assert f"(emergency checkpoint at step {SHRINK}; SHRINK preemption -> resharding onto " \
           "the surviving ranks)" in kept["log"]
    assert any(l.startswith(f"(elastic: resharded checkpoint step {SHRINK} [data4, sgd] -> "
                            "[data2, sgd]") for l in kept["log"])
    assert f"(elastic: continuing at step {SHRINK + 1} on mesh data2, accum_steps=2)" \
        in kept["log"]
    s = kept["summary"]
    assert s["preempted"] is False and s["last_step"] == STEPS - 1 and s["mesh"] == "data2"
    assert math.isfinite(s["final_loss"]) and s["accum_steps"] == 2
    assert kept["losses"][:SHRINK + 1] == whole[:SHRINK + 1]
    _close(kept["losses"][SHRINK + 1:], whole[SHRINK + 1:])


# ---------------------------------------------- the CNN's momentum stack


def _cnn(n, epochs=2):
    from distributed_neural_network_tpu_torch.data.cifar10 import load_split
    from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

    train = load_split(True, source="synthetic", synthetic_size=256, seed=3)
    test = load_split(False, source="synthetic", synthetic_size=64, seed=3)
    return Engine(TrainConfig(**{**CNN["config"], "nb_proc": n, "epochs": epochs}), train,
                  test, device="cpu")


def _saved(ck):
    """The newest checkpoint's (momentum stack leaves, params leaves)."""
    with np.load(os.path.join(ck._b.dir, f"step_{ck.latest_epoch()}", "state.npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    return leaves[:len(leaves) // 2], leaves[len(leaves) // 2:]


def _restored(eng):
    leaves = [np.asarray(x) for x in tree_leaves(eng.state_tree())]
    return leaves[:len(leaves) // 2], leaves[len(leaves) // 2:]


@pytest.mark.parametrize("n", [2, 8])
def test_cnn_restore_latest_elastic_across_worker_counts(tmp_path, n):
    """elastic=True accepts a checkpoint of another worker count: a shrink
    keeps the surviving workers' momentum rows, a grow zero-pads the new
    workers, the params re-place unchanged, the meta records the topology;
    without it the mismatch names --elastic (JAX `tests/test_checkpoint.py`)."""
    ck = PCheckpointer(str(tmp_path / "e"), every=1)
    eng = _cnn(4)
    eng.run(log=lambda *_: None, checkpointer=ck)
    meta = ck._b.load_meta(ck.latest_epoch())
    assert meta["mesh_meta"]["axes"] == {"data": 4} and meta["mesh_meta"]["n_workers"] == 4
    mom, params = _saved(ck)
    other = _cnn(n, epochs=3)
    with pytest.raises(ValueError, match="--elastic"):
        ck.restore_latest(other)
    logs = []
    assert ck.restore_latest(other, elastic=True, log=logs.append) == 2
    kind = "surviving workers keep their buffers" if n < 4 else "new workers start with zero " \
        "momentum"
    assert logs == [f"(elastic: momentum stack resharded 4 -> {n} workers; {kind})"]
    got_mom, got_params = _restored(other)
    assert all(np.array_equal(a, b) for a, b in zip(got_params, params))
    for a, b in zip(got_mom, mom):
        assert a.shape[0] == n
        assert np.array_equal(a[:min(n, 4)], b[:min(n, 4)]) and not np.any(a[4:])
    hist = other.run(log=lambda *_: None, start_epoch=2)
    assert [m.epoch for m in hist] == [0, 1, 2]
    ck.close()


def test_cnn_checkpoint_of_two_ranks_resumes_elastically_in_one_process(ranks):
    """2 ranks x 2 workers wrote the checkpoint (rank 0 the rows gathered
    from both); one process of 2 workers restores it elastically: the first
    2 workers' rows (rank 0's) and the params bitwise, and it trains on."""
    ck = PCheckpointer(os.path.join(ranks["cnn"], "el_whole"))
    mom, params = _saved(ck)
    eng = _cnn(2, epochs=4)
    logs = []
    assert ck.restore_latest(eng, elastic=True, log=logs.append) == 3
    assert logs == ["(elastic: momentum stack resharded 4 -> 2 workers; surviving workers "
                    "keep their buffers)"]
    got_mom, got_params = _restored(eng)
    assert all(np.array_equal(a, b) for a, b in zip(got_params, params))
    assert all(np.array_equal(a, b[:2]) for a, b in zip(got_mom, mom))
    assert not all(np.array_equal(b[0], b[2]) for b in mom)  # the rows differ by worker
    assert [m.epoch for m in eng.run(log=lambda *_: None, start_epoch=3)] == [0, 1, 2, 3]
    legs = json.loads(open(os.path.join(ranks["cnn"], "el_rank0.json")).read())
    assert len(legs["whole"]["history"]) == 3
