"""The training guard of the port (`train/guard.py`, `parallel/fault.py`,
`ops/sgd.py` / `ops/adam.py` guarded steps, the flight recorder of
`utils/obs.py`, the guarded LM step, the CNN engine's guard and both
CLIs' guard and chaos flags) on the CPU, held to the JAX package's
functions wherever there is one:

- the policy machinery: `GuardConfig`'s checks with the JAX texts, the same
  z-scores, verdicts, counters and log lines from the same observations,
  the abort and exhausted-budget texts, snapshots as host copies, the
  one-step lag of `HealthPipe`, StepStats and the trace's guard table;
- the in-step halves: `health_bundle`, `guarded_sgd_step` and
  `guarded_adam_step` (bitwise the unguarded step when ok, frozen - Adam's
  counter too - when not, and the JAX values), `inject_step_faults`
  (nan_layer included) and `ChaosMonkey` (once-only faults);
- the flight recorder (the JAX tests' cases on the port's copy);
- `with_health` and `skip_nonfinite` as observation only on a healthy
  step, bitwise (the guarded step against the JAX step for sgd, adam, zero
  and zero-adam is `tests/test_torch_lm_step.py`'s, and `Engine.run(guard=)`
  against the JAX engine `tests/test_torch_engine.py`'s, where the JAX
  programs of those files are already built);
- the CLIs in process: skip survives the NaN, rollback with backoff (its
  trace and run record), abort, ``--chaos-sigterm-after`` then
  ``--resume`` bitwise, the flags' errors with the JAX CLI's texts, the CNN
  CLI's guard flags; and two gloo ranks of ``--dp 2 --guard skip`` through
  `port_probes/guard_world.py`'s flow (one launch for the file).
"""

import importlib.util
import json
import math
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops import adam as jadam
from distributed_neural_network_tpu.ops import sgd as jsgd
from distributed_neural_network_tpu.parallel import fault as JF
from distributed_neural_network_tpu.train import guard as JG
from distributed_neural_network_tpu_torch import lm_train
from distributed_neural_network_tpu_torch.ops import adam as A
from distributed_neural_network_tpu_torch.ops import sgd as S
from distributed_neural_network_tpu_torch.ops.schedule import global_norm, health_bundle
from distributed_neural_network_tpu_torch.parallel import fault as F
from distributed_neural_network_tpu_torch.train import guard as G
from distributed_neural_network_tpu_torch.utils import obs
from distributed_neural_network_tpu_torch.utils import tracing as TR
from test_torch_lm_cli import _jax_cli_error, _port_error

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5  # tests/test_torch_lm_step.py's


def _quiet(*_):
    pass


@pytest.fixture(autouse=True)
def _clean_flight():
    """The process's flight recorder must not carry events between tests."""
    obs.FLIGHT.reset()
    yield
    obs.FLIGHT.reset()


# ------------------------------------------------------- policy machinery


@pytest.mark.parametrize("kw", [dict(policy="explode"), dict(spike_zscore=0.0),
                                dict(ema_decay=1.0), dict(lr_backoff=0.0),
                                dict(max_retries=-1), dict(snapshot_every=0)])
def test_guard_config_checks_are_the_jax_ones(kw):
    with pytest.raises(ValueError) as want:
        JG.GuardConfig(**kw)
    with pytest.raises(ValueError) as got:
        G.GuardConfig(**kw)
    assert str(got.value) == str(want.value)
    assert G.POLICIES == JG.POLICIES


# a loss stream with a NaN, an Inf, a healthy stretch and two spikes
LOSSES = [2.0, 1.9, 1.85, 1.8, 1.78, 1.7, float("nan"), 1.65, 1.6, 160.0, 1.55, 1.5, 1.52,
          float("inf"), 1.45, 1.43, 1.41, 300.0, 1.4]


def _observe(mod, policy):
    logs = []
    g = mod.TrainingGuard(mod.GuardConfig(policy=policy, warmup_steps=4, spike_zscore=3.0,
                                          max_retries=5), log=logs.append)
    g.snapshot(0, {"w": np.ones(2, np.float32)})
    out = []
    for i, loss in enumerate(LOSSES):
        v = g.observe(i, loss, grad_norm=1.0, all_finite=math.isfinite(loss))
        if v.action == "rollback":
            g.rollback(at_step=i)
        out.append((v.action, v.zscore, g.detector.mean, g.detector.var))
    return out, g.summary(), logs


@pytest.mark.parametrize("policy", ["warn", "skip", "rollback"])
def test_same_observations_give_the_jax_verdicts(policy):
    """The same losses through the JAX guard and the port's: the same
    actions, z-scores, EMA state, counters and log lines."""
    want, got = _observe(JG, policy), _observe(G, policy)
    assert got == want
    # under rollback the detector warms up again after each restore, and
    # both spikes fall inside a warm-up
    assert got[1]["nonfinite"] == 2 and got[1]["spikes"] == (0 if policy == "rollback" else 2)


def test_abort_and_exhausted_budget_texts_are_the_jax_ones():
    texts = []
    for mod in (JG, G):
        g = mod.TrainingGuard(mod.GuardConfig(policy="abort"), log=_quiet)
        with pytest.raises(mod.GuardAbort) as e:
            g.observe(3, float("inf"))
        h = mod.TrainingGuard(mod.GuardConfig(policy="rollback", max_retries=0), log=_quiet)
        with pytest.raises(mod.GuardAbort) as f:
            h.rollback()
        texts.append((str(e.value), str(f.value)))
    assert texts[0] == texts[1] and "--guard warn" in texts[1][0]


def test_rollback_budget_refill_and_backoff():
    g = G.TrainingGuard(G.GuardConfig(policy="rollback", warmup_steps=3, max_retries=2,
                                      lr_backoff=0.5), log=_quiet)
    g.snapshot(4, {"w": torch.ones(2)})
    assert g.observe(5, float("nan")).action == "rollback"
    step, state = g.rollback(at_step=5)
    assert step == 4 and state["w"].device.type == "cpu"
    assert g.lr_scale == 0.5 and g.retries_used == 1
    for i in range(6, 9):
        g.observe(i, 1.0)
    assert g.retries_used == 0  # three healthy observations close the incident
    for i in (9, 10):
        g.observe(i, float("nan"))
        g.rollback()
    g.observe(11, float("nan"))
    with pytest.raises(G.GuardAbort, match="retry budget exhausted"):
        g.rollback()
    assert g.counters["rollbacks"] == 3 and g.lr_scale == 0.125
    kinds = [e["kind"] for e in obs.FLIGHT.events()]
    assert kinds.count("guard_rollback") == 3 and kinds.count("guard_anomaly") == 4


def test_snapshots_are_host_copies_at_the_cadence():
    g = G.TrainingGuard(G.GuardConfig(policy="rollback", snapshot_every=4), log=_quiet)
    assert g.rollback() is None  # no snapshot yet: the caller falls back to disk
    w = torch.arange(4.0)
    calls = []

    def tree():
        calls.append(1)
        return {"w": w, "h": w.to(torch.bfloat16), "t": np.int32(7)}

    assert g.maybe_snapshot(0, tree, first_step=0)
    assert not g.maybe_snapshot(2, tree, first_step=0) and len(calls) == 1
    w.add_(1.0)  # the snapshot is a copy
    step, snap = g.peek_snapshot()
    assert step == 0 and torch.equal(snap["w"], torch.arange(4.0))
    assert snap["h"].dtype == torch.bfloat16 and snap["t"] == 7
    assert g.maybe_snapshot(4, tree, first_step=0) and g.snapshot_step == 4
    g.drop_snapshot()
    assert not g.has_snapshot and g.maybe_snapshot(6, tree, first_step=0)


def test_health_pipe_lags_one_step_and_perturbs():
    g = G.TrainingGuard(G.GuardConfig(policy="warn", warmup_steps=1, spike_zscore=3.0),
                        log=_quiet)
    monkey = F.ChaosMonkey(spike_at=(2,), spike_scale=1000.0, log=_quiet)
    pipe = G.HealthPipe(g, perturb=monkey.perturb)

    def health(v):
        return health_bundle(torch.tensor(v), torch.tensor(1.0))

    assert pipe.push(0, health(1.0)) is None  # nothing pending yet
    v = pipe.push(1, health(1.0))
    assert v.step == 0 and v.action == "ok"
    pipe.push(2, health(1.0))
    v = pipe.push(3, health(1.0))  # step 2's observation, spiked x1000
    assert v.step == 2 and v.action == "warn" and g.counters["spikes"] == 1
    assert pipe.flush().action == "ok"  # the monkey fires once
    assert pipe.flush() is None
    pipe.push(4, health(1.0))
    pipe.clear()
    assert pipe.flush() is None


def test_health_pipe_waits_on_the_bundles_event():
    """On the card a bundle carries a CUDA event recorded behind its step's
    host copy: the pipe waits on it (that step alone) before reading."""
    calls = []

    class Ready:
        def synchronize(self):
            calls.append("sync")

    class Loss(float):
        def __float__(self):
            calls.append("read")
            return float.__float__(self)

    pipe = G.HealthPipe(G.TrainingGuard(G.GuardConfig(policy="warn"), log=_quiet))
    pipe.push(0, {"loss": Loss(1.0), "grad_norm": 1.0, "all_finite": True, "ready": Ready()})
    assert calls == [] and pipe.flush().action == "ok" and calls == ["sync", "read"]


def test_step_stats_trace_and_trace_summary_guard_table(tmp_path):
    tracer = TR.Tracer(enabled=True)
    stats = TR.StepStats()
    g = G.TrainingGuard(G.GuardConfig(policy="rollback", warmup_steps=2), tracer=tracer,
                        step_stats=stats, log=_quiet)
    g.snapshot(0, {"w": torch.zeros(1)})
    g.observe(0, float("nan"))
    g.rollback(at_step=1)
    assert stats.summary()["anomalies"] == {"nonfinite": 1, "rollbacks": 1}
    path = str(tmp_path / "t.json")
    tracer.export(path, step_stats=stats)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"), path],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("Guard events:"))
    assert line == "Guard events: restore=1, rollback=1  (kinds: nonfinite=1, rollback=1)"


def test_preemption_records_a_flight_event():
    p = G.PreemptionGuard(log=_quiet)
    p.request("TEST")
    assert obs.FLIGHT.events()[-1]["kind"] == "preempt"


# ----------------------------------------------------- in-step primitives


def _tree(seed=0):
    g = np.random.default_rng(seed)
    return {"b": g.standard_normal(3).astype(np.float32),
            "w": g.standard_normal((4, 5)).astype(np.float32)}


def _leaves(tree):
    return [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]


def test_health_bundle_flags_nonfinite_through_the_norm():
    grads = [torch.ones(3), torch.ones(2, 2)]
    assert bool(health_bundle(torch.tensor(1.0), global_norm(grads))["all_finite"])
    grads[1][0, 0] = float("inf")
    assert not bool(health_bundle(torch.tensor(1.0), global_norm(grads))["all_finite"])
    assert not bool(health_bundle(torch.tensor(float("nan")), torch.tensor(1.0))["all_finite"])


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_guarded_sgd_bitwise_when_ok_frozen_when_not(wd):
    p0, g0 = _tree(0), _tree(1)
    ref_p, ref_m = _leaves(p0), [torch.zeros_like(x) for x in _leaves(p0)]
    S.sgd_step(ref_p, ref_m, _leaves(g0), 0.1, 0.9)
    from distributed_neural_network_tpu_torch.ops.schedule import apply_decoupled_weight_decay

    apply_decoupled_weight_decay(ref_p, 0.1, wd)
    ok_p, ok_m = _leaves(p0), [torch.zeros_like(x) for x in _leaves(p0)]
    S.guarded_sgd_step(ok_p, ok_m, _leaves(g0), torch.tensor(0.1), 0.9, ok=torch.tensor(True),
                       weight_decay=wd)
    assert all(torch.equal(a, b) for a, b in zip(ref_p + ref_m, ok_p + ok_m))
    jp, jm = jsgd.guarded_sgd_step(p0, jsgd.init_momentum(p0), g0, 0.1, 0.9,
                                   ok=jnp.bool_(True), weight_decay=wd)
    for a, b in zip(ok_p + ok_m, [jp[k] for k in sorted(jp)] + [jm[k] for k in sorted(jm)]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    no_p, no_m = _leaves(p0), [torch.full_like(x, 0.5) for x in _leaves(p0)]
    bad = [x * float("nan") for x in _leaves(g0)]
    S.guarded_sgd_step(no_p, no_m, bad, 0.1, 0.9, ok=torch.tensor(False), weight_decay=wd)
    assert all(torch.equal(a, b) for a, b in zip(no_p, _leaves(p0)))
    assert all(bool((m == 0.5).all()) for m in no_m)


def test_guarded_adam_bitwise_when_ok_frozen_with_its_counter_when_not():
    p0, g0 = _tree(2), _tree(3)
    ref_p, ref_s = _leaves(p0), A.init_adam(_leaves(p0))
    ok_p, ok_s = _leaves(p0), A.init_adam(_leaves(p0))
    ok_s["t"] = torch.zeros((), dtype=torch.int32)
    jp, js = p0, jadam.init_adam(p0)
    for _ in range(3):
        A.adam_step(ref_p, ref_s, _leaves(g0), 0.01, weight_decay=0.01)
        A.guarded_adam_step(ok_p, ok_s, _leaves(g0), 0.01, ok=torch.tensor(True),
                            weight_decay=0.01)
        jp, js = jadam.guarded_adam_step(jp, js, g0, 0.01, ok=jnp.bool_(True),
                                         weight_decay=0.01)
    assert all(torch.equal(a, b) for a, b in zip(ref_p + ref_s["m"] + ref_s["v"],
                                                 ok_p + ok_s["m"] + ok_s["v"]))
    assert int(ok_s["t"]) == ref_s["t"] == int(js["t"]) == 3
    for a, b in zip(ok_p, [jp[k] for k in sorted(jp)]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    before = [x.clone() for x in ok_p + ok_s["m"] + ok_s["v"]]
    A.guarded_adam_step(ok_p, ok_s, [x * float("nan") for x in _leaves(g0)], 0.01,
                        ok=torch.tensor(False))
    assert int(ok_s["t"]) == 3
    assert all(torch.equal(a, b) for a, b in zip(before, ok_p + ok_s["m"] + ok_s["v"]))
    with pytest.raises(TypeError, match="counts on the device"):
        A.guarded_adam_step(ok_p, ref_s, _leaves(g0), 0.01, ok=torch.tensor(True))


def test_correction_table_holds_the_host_corrections():
    for b1 in (0.9, 0.5):
        table = A.correction_table(b1)
        rows = table.numpy()
        assert all((float(rows[t, 0]), float(rows[t, 1])) == A.bias_corrections(t, b1, A.B2)
                   for t in range(1, len(rows)))
        last = len(rows) - 1
        assert A.bias_corrections(last + 1000, b1, A.B2) == (1.0, 1.0)
        c1, c2 = A.table_corrections(table, torch.tensor(last + 1000))
        assert (float(c1), float(c2)) == (1.0, 1.0)


def test_inject_step_faults_matches_jax():
    plan = F.StepFaultPlan(nan_grads_at=(2, 5), spike_loss_at=(7,), spike_scale=50.0)
    jplan = JF.StepFaultPlan(nan_grads_at=(2, 5), spike_loss_at=(7,), spike_scale=50.0)
    assert bool(plan) and not bool(F.StepFaultPlan())
    g0 = {"layers": {"w1": np.ones((2, 3), np.float32), "wq": np.ones(4, np.float32)},
          "head": np.ones(2, np.float32)}
    at = F.fault_masks(plan, "cpu")
    for i in range(9):
        jloss, jg = JF.inject_step_faults(jnp.int32(i), jnp.float32(2.0), g0, jplan)
        grads = jax.tree.map(lambda x: torch.from_numpy(x.copy()), g0)
        loss, grads = F.inject_step_faults(torch.tensor(i), torch.tensor(2.0), grads, plan, at=at)
        assert float(loss) == float(jloss)
        for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jg)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    layer = dict(nan_grads_at=(1,), nan_layer="layers/w")
    _, jg = JF.inject_step_faults(jnp.int32(1), jnp.float32(1.0), g0, JF.StepFaultPlan(**layer))
    grads = jax.tree.map(lambda x: torch.from_numpy(x.copy()), g0)
    F.inject_step_faults(1, torch.tensor(1.0), grads, F.StepFaultPlan(**layer))
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(torch.isnan(grads["layers"]["w1"]).all()) and not bool(
        torch.isnan(grads["head"]).any())
    miss = dict(nan_grads_at=(1,), nan_layer="nowhere")
    with pytest.raises(ValueError) as want:
        JF.inject_step_faults(jnp.int32(1), jnp.float32(1.0), g0, JF.StepFaultPlan(**miss))
    with pytest.raises(ValueError) as got:
        F.inject_step_faults(1, torch.tensor(1.0), jax.tree.map(torch.from_numpy, g0),
                             F.StepFaultPlan(**miss))
    assert str(got.value) == str(want.value)


def test_chaos_monkey_fires_each_fault_once(monkeypatch):
    kills, logs = [], []
    monkeypatch.setattr(F.os, "kill", lambda pid, sig: kills.append((pid, sig)))
    tracer = TR.Tracer(enabled=True)
    p = G.PreemptionGuard(log=logs.append)  # not installed: the flag only
    m = F.ChaosMonkey(spike_at=(3,), spike_scale=10.0, sigterm_after=4, stall_at=(2,),
                      stall_s=0.01, shrink_at=5, preempt=p, tracer=tracer, log=logs.append)
    assert m.perturb(3, 2.0, 1.0, True) == (20.0, 1.0, True)
    assert m.perturb(3, 2.0, 1.0, True) == (2.0, 1.0, True)  # the replay is healthy
    for step in (2, 2, 4, 4, 5, 5):
        m.after_step(step)
    assert kills == [(os.getpid(), signal.SIGTERM)]
    assert p.requested and p.signame == "SHRINK"
    spans = [e for e in tracer.events() if e.name == "straggler"]
    assert len(spans) == 1 and spans[0].args["kind"] == "stall"
    whats = [e["what"] for e in obs.FLIGHT.events() if e["kind"] == "chaos"]
    assert whats == ["spike", "stall", "sigterm", "shrink"]


# -------------------------------------------------------- flight recorder


def test_flight_ring_bounds():
    fr = obs.FlightRecorder(capacity=8)
    for i in range(20):
        fr.record("e", step=i)
    assert [e["step"] for e in fr.events()] == list(range(12, 20)) and fr.dropped == 12
    with pytest.raises(ValueError, match="capacity"):
        obs.FlightRecorder(capacity=0)


def test_flight_write_through_and_the_jax_schema(tmp_path):
    from distributed_neural_network_tpu.utils import obs as jobs

    fr = obs.FlightRecorder(capacity=16)
    path = tmp_path / "fl.json"
    fr.configure(str(path), rank=3)
    assert path.exists()  # configure() writes the live marker at once
    fr.record("guard_anomaly", step=7, anomaly="spikes", zscore=9.5)
    fr.record("weird", step=8, bad=float("nan"), obj={"x": (1, 2)})
    doc = obs.read_flight_dump(str(path))
    assert sorted(doc) == sorted(jobs.FlightRecorder().snapshot())
    assert doc["version"] == 1 and doc["rank"] == 3 and doc["pid"] == os.getpid()
    assert doc["events"][-2] == {**doc["events"][-2], "kind": "guard_anomaly", "step": 7,
                                 "zscore": 9.5}
    assert doc["events"][-1]["bad"] is None and isinstance(doc["events"][-1]["obj"], dict)
    assert [p for p in os.listdir(tmp_path) if ".tmp" in p] == []
    assert obs.FLIGHT_ENV == jobs.FLIGHT_ENV


def test_flight_dump_survives_sigterm(tmp_path):
    path = tmp_path / "fl.json"
    # utils/obs.py alone (stdlib only), without the package and its torch
    code = ("import importlib.util, time\n"
            "spec = importlib.util.spec_from_file_location('obs', "
            f"{os.path.join(ROOT, 'distributed_neural_network_tpu_torch', 'utils', 'obs.py')!r})\n"
            "obs = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(obs)\n"
            "FLIGHT, flight_event = obs.FLIGHT, obs.flight_event\n"
            f"FLIGHT.configure({str(path)!r}, rank=1)\n"
            "flight_event('chaos', step=3, what='stall')\n"
            "flight_event('guard_rollback', step=4)\n"
            "print('READY', flush=True)\n"
            "time.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGTERM
    doc = obs.read_flight_dump(str(path))
    assert doc["rank"] == 1 and [e["kind"] for e in doc["events"]] == ["chaos", "guard_rollback"]


def test_flight_singleton_unconfigured_is_memory_only(tmp_path):
    ev = obs.flight_event("x", step=1)
    assert ev["kind"] == "x" and obs.FLIGHT.events()[-1]["step"] == 1
    assert obs.FLIGHT.dump() is None  # nowhere to write
    p = obs.FLIGHT.dump(path=str(tmp_path / "demand.json"), cause="test")
    assert obs.read_flight_dump(p)["cause"] == "test"


# ------------------------------------------------------- the guarded step


KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _batch(seed, b=4, s=16):
    toks = np.random.default_rng(seed).integers(2, 32, size=(b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_step(optimizer, **kw):
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.train import lm as tlm

    params = tfm.init_params(0, tfm.TransformerConfig(**KW))
    mom = tlm.init_lm_momentum(params, optimizer)
    lr = 0.01 if "adam" in optimizer else 0.1
    return tlm.make_lm_train_step(tfm.TransformerConfig(**KW), device="cpu", lr=lr,
                                  optimizer=optimizer, **kw), params, mom


def _state(params, mom):
    from distributed_neural_network_tpu_torch.train import lm as tlm

    leaves = tlm.tree_leaves(params)
    state = mom if isinstance(mom, list) else mom["m"] + mom["v"]
    return [x.detach().clone() for x in leaves + state]


def test_with_health_only_observes_and_skip_is_bitwise_when_ok():
    """The health output and the skip gate change no bit of a healthy step
    (Adam with a cosine schedule, clip and weight decay)."""
    import functools

    from distributed_neural_network_tpu_torch.ops.schedule import warmup_cosine

    kw = dict(clip_norm=0.5, weight_decay=0.01, lr_schedule=functools.partial(
        warmup_cosine, base_lr=0.01, total_steps=3, warmup_steps=1))
    runs = []
    for extra in ({}, {"with_health": True}, {"skip_nonfinite": True}):
        step, params, mom = _port_step("adam", **kw, **extra)
        losses = []
        for i in range(3):
            toks, tgts = (torch.from_numpy(x).long() for x in _batch(seed=i))
            out = step(params, mom, toks, tgts, i)
            losses.append(float(out if not extra else out[0]))
        runs.append((losses, _state(params, mom)))
    for losses, state in runs[1:]:
        assert losses == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(state, runs[0][1]))


def test_capture_warm_up_puts_the_device_counter_back(monkeypatch):
    """A capture first runs the step once on a side stream and puts back
    what it wrote (`train/graphs.py` `capture_all`): with Adam under skip
    that includes the device counter. Emulated on the CPU: the warm-up run
    and the put-back of `capture_all`, then the step runs as usual."""
    from distributed_neural_network_tpu_torch.train import lm as tlm

    def warm_up_only(programs, state, device, **kw):
        saved = [t.detach().clone() for t in state]
        for p in programs:
            p.fn()
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)

    monkeypatch.setattr(tlm, "capture_all", warm_up_only)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    runs = []
    for kw in ({"skip_nonfinite": True, "fault_plan": F.StepFaultPlan(nan_grads_at=(1,))}, {}):
        step, params, mom = _port_step("zero-adam", **kw)
        step._capture = True
        steps = (0, 1, 2) if kw else (0, 2)
        for i in steps:
            step(params, mom, *(torch.from_numpy(x).long() for x in _batch(seed=i)), i)
        runs.append((tlm.adam_count(mom), _state(params, mom)))
    assert runs[0][0] == runs[1][0] == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_dropped_guarded_step_frees_itself_at_once():
    """A guarded step that counts on the device sits in no reference cycle
    (its `DeviceCount` in ``mom["t"]`` holds the counter, not the step), so
    dropping it frees it without the collector (ROADMAP trap 2: a graph the
    collector frees during another capture spoils that capture)."""
    import gc
    import weakref

    step, params, mom = _port_step("adam", skip_nonfinite=True,
                                   fault_plan=F.StepFaultPlan(nan_grads_at=(0,)))
    step(params, mom, *(torch.from_numpy(x).long() for x in _batch(seed=0)), 0)
    ref = weakref.ref(step)
    gc.disable()
    try:
        del step
        assert ref() is None
    finally:
        gc.enable()


# ------------------------------------------------------------------ CLIs


TINY = ["--device", "cpu", "--batch-size", "8", "--seq-len", "16", "--vocab", "32",
        "--d-model", "32", "--n-heads", "4", "--n-layers", "2", "--d-ff", "64",
        "--log-every", "1"]


def _lm(*flags, steps=8, log=None):
    lines, res = [], {}
    assert lm_train.main(TINY + ["--steps", str(steps), *flags], log=log or lines.append,
                         result=res) == 0
    summary = json.loads(next(ln for ln in lines if ln.startswith("SUMMARY "))[8:]) \
        if lines else None
    return lines, summary, res


def test_cli_skip_survives_the_nan_and_is_bitwise_the_unguarded_run():
    """--guard skip --chaos-nan-step 2 --stop-at-step 3 ends where the
    unguarded --stop-at-step 2 run ends (Adam's state and counter too)."""
    from distributed_neural_network_tpu_torch.train import lm as tlm

    adam = ["--optimizer", "adam", "--lr", "0.01"]
    lines, summary, res = _lm("--guard", "skip", "--chaos-nan-step", "2", *adam)
    assert any("step 2 nonfinite -> skip" in ln for ln in lines)
    assert summary["guard"] == "skip" and summary["guard_summary"]["skipped"] == 1
    assert math.isfinite(summary["final_loss"])
    _, _, skip3 = _lm("--guard", "skip", "--chaos-nan-step", "2", "--stop-at-step", "3", *adam)
    _, _, plain2 = _lm("--stop-at-step", "2", *adam)
    assert skip3["losses"][:2] == plain2["losses"] and skip3["mom"]["t"] == plain2["mom"]["t"] == 2
    assert all(torch.equal(a, b) for a, b in zip(
        _state(skip3["params"], skip3["mom"]), _state(plain2["params"], plain2["mom"])))
    assert tlm.adam_count(res["mom"]) == 7


def test_cli_rollback_backs_off_and_records_the_replay(tmp_path):
    """A spike observed at step 12: the snapshot of step 10 restored, the lr
    halved (the step kept), the losses before the snapshot those of the
    unguarded run; the trace's guard table and the record's
    rollback_recompute."""
    trace, record = str(tmp_path / "t.json"), str(tmp_path / "r.json")
    flags = ["--lr-schedule", "cosine", "--warmup-steps", "1"]
    lines, summary, res = _lm("--guard", "rollback", "--chaos-spike-step", "12",
                              "--snapshot-every", "5", "--trace-out", trace,
                              "--run-record", record, *flags, steps=16)
    _, _, plain = _lm(*flags, steps=16)
    assert any(ln.startswith("(guard: resuming from step 10 at lr_scale=0.5") for ln in lines)
    gs = summary["guard_summary"]
    assert gs["rollbacks"] == 1 and gs["lr_scale"] == 0.5 and math.isfinite(
        summary["final_loss"])
    assert res["losses"][:10] == plain["losses"][:10] and len(res["losses"]) == 16
    assert res["losses"][10:] != plain["losses"][10:]
    assert [s for s, _, _ in res["guard"]["snapshots"]] == [0, 5, 10, 10, 15]
    with open(record) as f:
        assert json.load(f)["badput_s"]["rollback_recompute"] > 0
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                           trace], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "Guard events: restore=1, rollback=1" in proc.stdout


def test_cli_abort_raises_and_exits_nonzero(monkeypatch):
    with pytest.raises(G.GuardAbort, match="guard policy 'abort'"):
        _lm("--guard", "abort", "--chaos-nan-step", "1", steps=4)
    monkeypatch.setattr(sys, "argv", ["lm_train"] + TINY + [
        "--steps", "4", "--guard", "abort", "--chaos-nan-step", "1"])
    with pytest.raises(SystemExit) as e:
        lm_train.cli()
    assert str(e.value.code).startswith("GUARD ABORT: guard policy 'abort'")


def test_cli_chaos_sigterm_then_resume_is_bitwise(tmp_path):
    """--chaos-sigterm-after 2 delivers a real SIGTERM to this process: the
    flag is read when the next step is launched, so the emergency
    checkpoint is at step 3; the resume continues the uninterrupted run bit
    for bit."""
    _, _, whole = _lm(steps=6)
    lines, s1, first = _lm("--checkpoint-dir", str(tmp_path), "--chaos-sigterm-after", "2",
                           steps=6)
    assert "(chaos: delivering SIGTERM after step 2)" in lines
    assert s1["preempted"] and s1["last_step"] == 3 and os.listdir(tmp_path) == ["step_3"]
    _, _, rest = _lm("--checkpoint-dir", str(tmp_path), "--resume", "--stop-at-step", "6",
                     steps=6)
    assert first["losses"] + rest["losses"] == whole["losses"]
    assert all(torch.equal(a, b) for a, b in zip(_state(rest["params"], rest["mom"]),
                                                 _state(whole["params"], whole["mom"])))


def test_cli_stall_sleeps_in_a_fault_span(tmp_path):
    trace = str(tmp_path / "t.json")
    lines, _, _ = _lm("--chaos-stall-step", "1", "--chaos-stall-seconds", "0.05",
                      "--trace-out", trace, steps=3)
    assert "(chaos: stalling the step loop for 0.05s after step 1)" in lines
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert [e["args"]["kind"] for e in events if e.get("name") == "straggler"] == ["stall"]


GUARD_ERRORS = {
    "stall seconds": ["--chaos-stall-step", "1", "--chaos-stall-seconds", "0"],
    "stall rank without a step": ["--chaos-stall-rank", "1"],
    "nan layer without a step": ["--chaos-nan-layer", "layers"],
    "snapshot cadence": ["--guard", "warn", "--snapshot-every", "0"],
    "retries": ["--guard", "rollback", "--max-retries", "-1"],
}


@pytest.mark.parametrize("name", list(GUARD_ERRORS))
def test_guard_flag_errors_are_the_jax_cli_texts(n_devices, monkeypatch, capsys, name):
    args = [a for a in TINY if a not in ("--device", "cpu")] + GUARD_ERRORS[name]
    assert _port_error(capsys, args) == _jax_cli_error(monkeypatch, capsys, args)


def test_nan_layer_names_the_leaves_when_nothing_matches():
    with pytest.raises(ValueError, match="matches no gradient leaf path"):
        _lm("--chaos-nan-step", "1", "--chaos-nan-layer", "nowhere", steps=2)
    lines, summary, _ = _lm("--guard", "skip", "--chaos-nan-step", "1", "--chaos-nan-layer",
                            "layers/w1", steps=3)
    assert summary["guard_summary"]["nonfinite"] == 1 and summary["guard_summary"]["skipped"] == 1


CNN = ["--device", "cpu", "--synthetic-size", "96", "--epochs", "3", "--nb-proc", "2",
       "--lr", "0.05"]


@pytest.mark.parametrize("policy", ["warn", "skip", "rollback", "abort"])
def test_cnn_cli_guard_flags_run(tmp_path, policy):
    """--guard (with --guard-spike-zscore, --snapshot-every, --max-retries)
    runs on the CNN CLI: --fused falls back to the per-epoch path with the
    JAX line, the guard summary line and the SUMMARY's policy; a healthy run
    keeps every bit of the unguarded one."""
    from distributed_neural_network_tpu_torch.train import cli

    runs = []
    for extra in ([], ["--guard", policy, "--guard-spike-zscore", "5", "--snapshot-every", "2",
                       "--max-retries", "1", "--fused"]):
        lines = []
        cli.main(CNN + ["--log-dir", str(tmp_path)] + extra, log=lines.append)
        runs.append(lines)
    plain, guarded = runs
    assert ("(fused mode cannot observe per-epoch health inside one dispatch; --guard uses "
            "the per-epoch path)") in guarded
    summary = json.loads(next(ln for ln in guarded if ln.startswith("SUMMARY "))[8:])
    assert summary["guard"] == policy
    assert any(ln.startswith('(guard summary: {"policy": "' + policy) for ln in guarded)
    assert ([ln for ln in plain if ln.startswith("Global")]
            == [ln for ln in guarded if ln.startswith("Global")])


# ------------------------------------------------------------- two ranks


def test_two_gloo_ranks_skip_together(tmp_path):
    """port_probes/guard_world.py's flow on two gloo ranks at a tiny width
    (one launch): --dp 2 --guard skip --chaos-nan-step 2 --stop-at-step 3
    on sgd (flash route) and zero-adam, each bitwise the unguarded
    --stop-at-step 2 run on both ranks (the final gathered checkpoint,
    Adam's counter included), both ranks skipping step 2; and off against
    warn, the losses equal."""
    spec = importlib.util.spec_from_file_location(
        "guard_world", os.path.join(ROOT, "port_probes", "guard_world.py"))
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)
    tiny = TINY[2:] + ["--lr", "0.01"]
    runs = (("dp2", ["--dp", "2", "--attn", "flash"]),
            ("dp2-zero-adam", ["--dp", "2", "--optimizer", "zero-adam"]))
    out = str(tmp_path / "out")
    ranks = W.run_world(2, out, tiny, runs, device="cpu", timeout=240,
                        env={"OMP_NUM_THREADS": "1"}, ab=(("dp2", ["--dp", "2"]),))
    res = W.check(ranks, runs, out)
    assert [res[name]["mesh"] for name, _ in runs] == ["data2", "data2"]
    assert set(W.check_ab(ranks)["dp2"]) == {"off", "warn"}
