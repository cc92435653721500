"""The port's elastic supervisor (`train/supervisor.py`, `launch.py`,
`parallel/fault.py` `KillEvent` / `ProcessChaos`) against the JAX package's.

The JAX tests of `tests/test_supervisor.py` run here on the port's
supervisor, with plain-python dummy workers (no torch in the children) that
read torchrun's variables when they are set and the JAX ones otherwise, so
one worker serves both supervisors. Each scenario the two packages share
(`SCENARIOS`) runs once through each: its ported case checks the port's run,
and `test_summary_parity` holds the port's SUPERVISOR_SUMMARY fields to the
JAX run's. Then: `ProcessChaos.due` and `FleetFederation` against JAX's on
the same inputs, postmortem.json's keys, the launcher's cases
(`python -m distributed_neural_network_tpu_torch.launch`), and the two
supervised cases of `tests/test_fleet_obs.py` (straggler attribution, the
postmortem after a SIGKILL) whose workers import the port's flight recorder.
A real group of the port's LM workers is `tests/test_torch_supervisor_group.py`.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time
import types

import pytest

from distributed_neural_network_tpu.parallel import fault as jax_fault
from distributed_neural_network_tpu.train import supervisor as jax_sup
from distributed_neural_network_tpu.utils import obs as jax_obs
from distributed_neural_network_tpu_torch import launch
from distributed_neural_network_tpu_torch.parallel import fault
from distributed_neural_network_tpu_torch.parallel.fault import KillEvent, ProcessChaos
from distributed_neural_network_tpu_torch.train import supervisor as sup_mod
from distributed_neural_network_tpu_torch.train.supervisor import (
    PREEMPT_RC,
    FleetFederation,
    Supervisor,
    SupervisorConfig,
    SupervisorPolicy,
    read_heartbeat,
    reserve_port,
    signal_label,
)
from distributed_neural_network_tpu_torch.utils.obs import (
    FLIGHT,
    MetricsRegistry,
    parse_prom_samples,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = types.SimpleNamespace(name="port", Supervisor=Supervisor,
                             SupervisorConfig=SupervisorConfig,
                             MetricsRegistry=MetricsRegistry, KillEvent=KillEvent,
                             ProcessChaos=ProcessChaos)
JAX = types.SimpleNamespace(name="jax", Supervisor=jax_sup.Supervisor,
                            SupervisorConfig=jax_sup.SupervisorConfig,
                            MetricsRegistry=jax_obs.MetricsRegistry,
                            KillEvent=jax_fault.KillEvent, ProcessChaos=jax_fault.ProcessChaos)

# Dummy worker: heartbeats like a real one (utils/obs.py schema), waits at
# its first beat until every rank of its generation has beaten, records
# its env/argv per generation, honors SIGTERM like the cooperative
# preemption path (exit 0), and follows a per-(gen, rank) behavior spec
# passed as JSON: {"g0": {"1": {...}, "*": {...}}, ...} with knobs
#   steps / dt     heartbeat cadence;        rc / fail_at   die mid-run
#   no_beat        die before any heartbeat (rendezvous failure)
#   freeze_beat    keep beating the SAME beat_unix (a wedged step loop)
#   hang           never exit (needs SIGTERM/SIGKILL or staleness kill)
# The rank, world and rendezvous address come from torchrun's variables
# (the port's supervisor) or the JAX ones (the JAX package's).
WORKER = """\
import json, os, signal, sys, time

hb_path = os.environ["DNN_TPU_HEARTBEAT_FILE"]
if "MASTER_PORT" in os.environ:
    rank = int(os.environ["RANK"])
    nprocs = int(os.environ["WORLD_SIZE"])
    coord = os.environ["MASTER_ADDR"] + ":" + os.environ["MASTER_PORT"]
else:
    rank = int(os.environ["JAX_PROCESS_ID"])
    nprocs = int(os.environ["JAX_NUM_PROCESSES"])
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
gen = int(os.environ["DNN_TPU_SUPERVISOR_GEN"])
out_dir, spec = sys.argv[1], json.loads(sys.argv[2])
with open(os.path.join(out_dir, f"seen_g{gen}_r{rank}.json"), "w") as f:
    json.dump({"rank": rank, "gen": gen, "nprocs": nprocs,
               "argv_rank": sys.argv[3] if len(sys.argv) > 3 else None,
               "coord": coord, "local": [os.environ.get("LOCAL_RANK"),
                                         os.environ.get("LOCAL_WORLD_SIZE")],
               "xla_flags": os.environ.get("XLA_FLAGS", "")}, f)
me = spec.get(f"g{gen}", {}).get(str(rank)) or \\
     spec.get(f"g{gen}", {}).get("*") or {}
signal.signal(signal.SIGTERM,
              lambda s, f: sys.exit(me.get("term_rc", 0)))

# goodput run record (utils/goodput.py schema): written up front like the
# real ledger's write-through, so even a killed worker leaves one for the
# supervisor's fleet aggregation
rr = os.environ.get("DNN_TPU_RUN_RECORD")
if rr and not me.get("no_record"):
    with open(rr, "w") as f:
        json.dump({"version": 1, "kind": "rank", "final": True,
                   "rank": rank, "generation": gen, "wall_s": 1.0,
                   "goodput_s": 0.6, "goodput_ratio": 0.6, "steps": 3,
                   "goodput_steps": 2, "tokens": 48.0,
                   "badput_s": {"init": 0.2, "compile": 0.2}}, f)

def beat(step, beat_unix):
    tmp = hb_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"t": time.time(), "beat_unix": beat_unix, "step": step,
                   "pid": os.getpid()}, f)
    os.replace(tmp, hb_path)

if me.get("no_beat"):
    time.sleep(me.get("sleep", 0.05))
    sys.exit(me.get("rc", 1))
t0 = time.time()
for s in range(me.get("steps", 3)):
    beat(s, t0 if me.get("freeze_beat") else time.time())
    if s == 0:
        # the group's rendezvous: a rank goes on once every rank of its
        # generation has beaten (as a real group's first collective waits),
        # so a death after it never reads as a rendezvous failure
        peers = [hb_path.replace(f"_rank{rank}.json", f"_rank{r}.json")
                 for r in range(nprocs)]
        deadline = time.time() + 60
        while not all(os.path.exists(p) for p in peers) and time.time() < deadline:
            time.sleep(0.01)
    if me.get("fail_at") is not None and s >= me["fail_at"]:
        sys.exit(me.get("rc", 1))
    time.sleep(me.get("dt", 0.05))
while me.get("hang"):
    time.sleep(0.05)
sys.exit(me.get("final_rc", 0))
"""


def _fast_cfg(pkg=PORT, **kw):
    base = dict(
        nprocs=2, devices_per_proc=1, poll_s=0.03, grace_s=2.0,
        restart_backoff_s=0.05, rendezvous_timeout_s=20.0,
    )
    base.update(kw)
    return pkg.SupervisorConfig(**base)


def _supervise(tmp_path, spec, cfg, *, pkg=PORT, chaos=None, registry=None,
               capacity_fn=None):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    out_dir = tmp_path / "out"
    out_dir.mkdir(exist_ok=True)
    logs = []
    sup = pkg.Supervisor(
        [sys.executable, str(worker), str(out_dir), json.dumps(spec),
         "{rank}"],
        cfg,
        run_dir=str(tmp_path / "run"),
        chaos=chaos,
        registry=registry,
        capacity_fn=capacity_fn,
        log=lambda *a: logs.append(" ".join(str(x) for x in a)),
    )
    rc = sup.run()
    summary = json.loads(next(
        ln for ln in logs if ln.startswith("SUPERVISOR_SUMMARY ")
    )[len("SUPERVISOR_SUMMARY "):])
    return rc, summary, logs, sup, out_dir


def _seen(out_dir):
    out = {}
    for name in os.listdir(out_dir):
        if name.startswith("seen_"):
            with open(os.path.join(out_dir, name)) as f:
                doc = json.load(f)
            out[(doc["gen"], doc["rank"])] = doc
    return out


# ------------------------------------------------ the shared scenarios

_SHRINK_SPEC = {
    "g0": {"1": {"fail_at": 1, "rc": 1, "steps": 50},
           "*": {"steps": 1000, "dt": 0.02}},
}
# name -> (worker spec, config knobs, chaos events as (rank, at_step, sig))
SCENARIOS = {
    "clean": ({"g0": {"*": {"steps": 3}}}, {}, ()),
    "shrink": ({"g0": {"2": {"fail_at": 1, "rc": 1, "steps": 50},
                       "*": {"steps": 1000, "dt": 0.02}},
                "g1": {"*": {"steps": 3}}}, {"nprocs": 3}, ()),
    "budget": ({f"g{g}": {"*": {"fail_at": 0, "rc": 7, "steps": 5}} for g in range(5)},
               {"nprocs": 1, "max_restarts": 1}, ()),
    "whole group": ({"g0": {"*": {"fail_at": 1, "rc": 2, "steps": 5}},
                     "g1": {"*": {"steps": 3}}}, {"nprocs": 2, "min_procs": 2}, ()),
    "min-procs": (_SHRINK_SPEC, {"nprocs": 2, "min_procs": 2}, ()),
    # rank 0 dies before ever heartbeating: the group never finishes
    # rendezvous (the bind-race shape)
    "rendezvous retry": ({"g0": {"0": {"no_beat": True, "rc": 1},
                                 "*": {"steps": 1000, "dt": 0.02}},
                          "g1": {"*": {"steps": 3}}}, {}, ()),
    "rendezvous budget": ({f"g{g}": {"*": {"no_beat": True, "rc": 1}} for g in range(4)},
                          {"nprocs": 1, "rendezvous_retries": 1}, ()),
    "chaos KILL": ({"g0": {"*": {"steps": 1000, "dt": 0.02}}, "g1": {"*": {"steps": 3}}},
                   {"nprocs": 2}, ((1, 3, "KILL"),)),
    "coordinator death": ({"g0": {"*": {"steps": 1000, "dt": 0.02, "term_rc": 75}},
                           "g1": {"*": {"steps": 3}}}, {"nprocs": 2}, ((0, 2, "TERM"),)),
    # rank 1 beats twice with a FROZEN beat_unix then hangs: a wedged step
    # loop whose writer thread is still alive
    "stale heartbeat": ({"g0": {"1": {"steps": 2, "freeze_beat": True, "hang": True,
                                      "dt": 0.02},
                                "*": {"steps": 1000, "dt": 0.02}},
                         "g1": {"*": {"steps": 3}}},
                        {"nprocs": 2, "heartbeat_timeout_s": 0.4}, ()),
    # gen 1 (shrunk to 1) beats long enough for the grow hysteresis
    "grow": ({**_SHRINK_SPEC, "g1": {"*": {"steps": 1000, "dt": 0.02}},
              "g2": {"*": {"steps": 3}}}, {"nprocs": 2, "grow_after_s": 0.3}, ()),
}
# the SUPERVISOR_SUMMARY fields held equal across the packages
PARITY_FIELDS = ("exit", "rc", "final_size", "generations", "restarts",
                 "rendezvous_retries", "worker_failures")
_RUNS = {}


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """`scenario(name, pkg)`: the scenario's run through `pkg`'s supervisor,
    made once per module: (rc, summary, logs, supervisor, out dir,
    registry)."""
    def get(name, pkg=PORT):
        key = (name, pkg.name)
        if key not in _RUNS:
            spec, knobs, events = SCENARIOS[name]
            reg = pkg.MetricsRegistry()
            chaos = (pkg.ProcessChaos(events=tuple(pkg.KillEvent(rank=r, at_step=s, sig=g)
                                                   for r, s, g in events))
                     if events else None)
            tmp = tmp_path_factory.mktemp(f"{pkg.name}_{name.replace(' ', '_')}")
            _RUNS[key] = (*_supervise(tmp, spec, _fast_cfg(pkg, **knobs), pkg=pkg,
                                      chaos=chaos, registry=reg), reg)
        return _RUNS[key]

    return get


# ------------------------------------------------------------- primitives


def test_reserve_port_is_bindable():
    port = reserve_port()
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))  # would raise if taken


def test_signal_label():
    assert signal_label(1) == "exit:1"
    assert signal_label(0) == "exit:0"
    assert signal_label(-9) == "SIGKILL"
    assert signal_label(-15) == "SIGTERM"
    assert signal_label(PREEMPT_RC) == "preempt" == jax_sup.signal_label(75)
    for rc in (1, 0, -9, -15, 75, -64, 3):
        assert signal_label(rc) == jax_sup.signal_label(rc)


def test_read_heartbeat_absent_and_torn(tmp_path):
    assert read_heartbeat(str(tmp_path / "nope.json")) is None
    p = tmp_path / "torn.json"
    p.write_text("{not json")
    assert read_heartbeat(str(p)) is None
    p.write_text('{"t": 1.0, "step": 3}')
    assert read_heartbeat(str(p))["step"] == 3


def test_process_chaos_fires_once_per_event():
    chaos = ProcessChaos(events=(
        KillEvent(rank=1, at_step=5, sig="KILL"),
        KillEvent(rank=0, at_step=0, sig="TERM"),
    ))
    assert bool(chaos)
    # rank 0 fires as soon as it appears; rank 1 waits for step >= 5
    assert chaos.due({0: None, 1: 2}) == [(0, 15)]
    assert chaos.due({0: 3, 1: 4}) == []
    assert chaos.due({1: 5}) == [(1, 9)]
    assert chaos.due({0: 9, 1: 9}) == []  # both spent


def test_kill_event_validation():
    with pytest.raises(ValueError, match="KILL"):
        KillEvent(rank=0, sig="HUP")
    with pytest.raises(ValueError, match="rank"):
        KillEvent(rank=-1)
    with pytest.raises(ValueError, match="min_procs"):
        SupervisorConfig(nprocs=2, min_procs=3)
    with pytest.raises(ValueError, match="nprocs"):
        SupervisorConfig(nprocs=0)
    with pytest.raises(TypeError, match="KillEvent"):
        ProcessChaos(events=((1, 3, "KILL"),))
    # one device a torch rank: devices_per_proc above 1 is refused, naming why
    with pytest.raises(ValueError, match="one device"):
        SupervisorConfig(nprocs=2, devices_per_proc=2)
    # the policy half keeps the JAX schema (fleetsim reads it)
    cfg = SupervisorConfig(nprocs=3, max_restarts=2, grace_s=4.0)
    assert cfg.policy_dict() == jax_sup.SupervisorConfig(
        nprocs=3, max_restarts=2, grace_s=4.0).policy_dict()
    assert SupervisorPolicy.from_policy_dict(cfg.policy_dict()) == cfg.policy()


# ----------------------------------------------------------- happy path


def test_group_completes_cleanly(scenario):
    rc, summary, logs, sup, out, reg = scenario("clean")
    assert rc == 0 and summary["exit"] == "ok"
    assert summary["generations"] == 1 and summary["restarts"] == 0
    assert summary["worker_failures"] == []
    seen = _seen(out)
    assert set(seen) == {(0, 0), (0, 1)}
    # {rank}/{nprocs} tokens substituted per worker; torchrun's rendezvous
    # variables wired, and no XLA device count written (torch ranks)
    for (g, r), doc in seen.items():
        assert doc["argv_rank"] == str(r)
        assert doc["nprocs"] == 2
        assert doc["coord"] == f"127.0.0.1:{sup.port}"
        assert doc["local"] == [str(r), "2"]
        assert doc["xla_flags"] == os.environ.get("XLA_FLAGS", "")
    assert reg.get("supervisor_group_size").value == 2
    assert reg.get("worker_failures_total") is not None
    assert sum(
        c.value for c in reg.get("worker_failures_total")._children.values()
    ) == 0


# ------------------------------------------------------- failure restarts


def test_worker_death_shrinks_group(scenario):
    rc, summary, logs, sup, out, reg = scenario("shrink")
    assert rc == 0 and summary["exit"] == "ok"
    assert summary["restarts"] == 1 and summary["final_size"] == 2
    assert summary["worker_failures"] == [
        {"gen": 0, "rank": 2, "cause": "exit:1"}
    ]
    # gen 1 re-substituted the smaller group into the tokens
    seen = _seen(out)
    assert seen[(1, 0)]["nprocs"] == 2 and (1, 2) not in seen
    assert reg.get("elastic_restarts_total").labels(
        direction="shrink"
    ).value == 1
    assert reg.get("worker_failures_total").labels(
        signal="exit:1"
    ).value == 1
    assert reg.get("supervisor_restart_seconds").labels().count == 1
    assert any("restart 1/" in ln and "3 -> 2" in ln for ln in logs)


def test_restart_budget_exhaustion_fails_fast(scenario):
    t0 = time.monotonic()
    rc, summary, logs, _, _, _ = scenario("budget")
    assert rc == 3 and summary["exit"] == "budget"
    assert summary["restarts"] == 2  # budget 1 + the exhausting failure
    assert time.monotonic() - t0 < 30  # fails fast, no crash loop
    abort = next(ln for ln in logs if ln.startswith("SUPERVISOR ABORT"))
    assert "restart budget (1) exhausted" in abort
    assert "exit:7" in abort  # the last failure is named


def test_whole_group_crash_restarts_same_size(scenario):
    rc, summary, logs, _, out, _ = scenario("whole group")
    assert rc == 0
    assert summary["final_size"] == 2 and summary["restarts"] == 1
    assert _seen(out)[(1, 0)]["nprocs"] == 2


def test_shrink_below_min_procs_aborts(scenario):
    rc, summary, logs, _, _, _ = scenario("min-procs")
    assert rc == 3 and summary["exit"] == "budget"
    assert any("--min-procs is 2" in ln for ln in logs)


# ------------------------------------------------------------- rendezvous


def test_rendezvous_failure_retries_on_fresh_port(scenario):
    rc, summary, logs, sup, out, reg = scenario("rendezvous retry")
    assert rc == 0 and summary["exit"] == "ok"
    assert summary["rendezvous_retries"] == 1
    assert summary["restarts"] == 0  # startup races don't burn the budget
    seen = _seen(out)
    # the retry ran at FULL size on a different rendezvous port
    assert seen[(1, 0)]["nprocs"] == 2
    assert seen[(1, 0)]["coord"] != seen[(0, 1)]["coord"]
    assert reg.get("elastic_restarts_total").labels(
        direction="rendezvous"
    ).value == 1


def test_rendezvous_budget_exhaustion(scenario):
    rc, summary, logs, _, _, _ = scenario("rendezvous budget")
    assert rc == 4 and summary["exit"] == "rendezvous"
    assert any(
        "rendezvous failed" in ln and "never came up" in ln for ln in logs
    )


# ------------------------------------------------------------ chaos kills


def test_chaos_sigkill_shrinks_and_labels_signal(scenario):
    rc, summary, logs, _, out, reg = scenario("chaos KILL")
    assert rc == 0
    assert summary["worker_failures"] == [
        {"gen": 0, "rank": 1, "cause": "SIGKILL"}
    ]
    assert summary["final_size"] == 1
    assert reg.get("worker_failures_total").labels(
        signal="SIGKILL"
    ).value == 1
    assert any("supervisor chaos" in ln and "SIGKILL" in ln for ln in logs)


def test_chaos_coordinator_death_preempt_exit_restarts(scenario):
    """TERM chaos on rank 0 = the death of the TCPStore's host by preemption
    notice: the worker's cooperative path exits PREEMPT_RC (checkpoint
    written), and the supervisor treats that as a group-restart trigger -
    NOT as the workload finishing - labeled 'preempt'."""
    rc, summary, logs, _, _, _ = scenario("coordinator death")
    assert rc == 0
    assert any("[the coordinator process]" in ln for ln in logs)
    assert {"gen": 0, "rank": 0, "cause": "preempt"} in \
        summary["worker_failures"]
    assert summary["final_size"] == 1


# ---------------------------------------------------- heartbeat staleness


def test_stale_heartbeat_declares_worker_dead(scenario):
    rc, summary, logs, _, _, _ = scenario("stale heartbeat")
    assert rc == 0
    assert summary["worker_failures"] == [
        {"gen": 0, "rank": 1, "cause": "SIGKILL"}
    ]
    assert any("heartbeat is" in ln and "stale" in ln for ln in logs)


# ------------------------------------------------------------------ grow


def test_grow_restart_when_capacity_returns(scenario):
    rc, summary, logs, _, out, reg = scenario("grow")
    assert rc == 0 and summary["exit"] == "ok"
    assert summary["final_size"] == 2
    assert summary["restarts"] == 1  # the failure; grow is planned, free
    seen = _seen(out)
    assert seen[(2, 0)]["nprocs"] == 2 and (2, 1) in seen
    assert reg.get("elastic_restarts_total").labels(
        direction="grow"
    ).value == 1
    assert any("planned grow restart 1 -> 2" in ln for ln in logs)


def test_grow_respects_capacity_fn(tmp_path):
    calls = []

    def capacity():
        calls.append(1)
        return 1  # capacity never returns

    spec = {
        "g0": {"1": {"fail_at": 1, "rc": 1, "steps": 50},
               "*": {"steps": 30, "dt": 0.02}},
        "g1": {"*": {"steps": 20, "dt": 0.02}},
    }
    rc, summary, logs, _, _ = _supervise(
        tmp_path, spec, _fast_cfg(nprocs=2, grow_after_s=0.1),
        capacity_fn=capacity,
    )
    assert rc == 0
    assert summary["final_size"] == 1  # never grew
    assert calls  # but capacity was consulted


# ---------------------------------------------- parity with the JAX package


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_summary_parity(scenario, name):
    """The same spec, config and chaos through the JAX supervisor and the
    port's: the SUPERVISOR_SUMMARY fields a reader acts on are equal."""
    port, ref = scenario(name, PORT)[1], scenario(name, JAX)[1]
    assert {k: port[k] for k in PARITY_FIELDS} == {k: ref[k] for k in PARITY_FIELDS}
    assert set(port) == set(ref)


def test_postmortem_keys_match_jax(scenario):
    docs = []
    for pkg in (PORT, JAX):
        sup = scenario("shrink", pkg)[3]
        with open(sup.postmortem_path) as f:
            docs.append(json.load(f))
    port, ref = docs
    assert set(port) == set(ref)
    assert [set(w) for w in port["workers"]] == [set(w) for w in ref["workers"]]
    assert set(port["goodput"]) == set(ref["goodput"])
    assert port["failures"] == ref["failures"]
    assert [(w["rank"], w["cause"], w["failed"]) for w in port["workers"]] == [
        (w["rank"], w["cause"], w["failed"]) for w in ref["workers"]]


def test_process_chaos_due_matches_jax_on_a_seeded_schedule():
    rng = random.Random(19)
    for _ in range(40):
        events = [(rng.randrange(4), rng.randrange(7), rng.choice(("KILL", "TERM")))
                  for _ in range(rng.randrange(1, 5))]
        port = ProcessChaos(events=tuple(KillEvent(rank=r, at_step=s, sig=g)
                                         for r, s, g in events))
        ref = jax_fault.ProcessChaos(events=tuple(jax_fault.KillEvent(rank=r, at_step=s, sig=g)
                                                  for r, s, g in events))
        assert [e.signum for e in port.events] == [e.signum for e in ref.events]
        steps = {r: None for r in range(4)}
        for _ in range(12):
            for r in range(4):
                if rng.random() < 0.2:
                    steps.pop(r, None)  # the rank is down this tick
                elif rng.random() < 0.7:
                    steps[r] = (steps.get(r) or 0) + rng.randrange(3)
            assert port.due(dict(steps)) == ref.due(dict(steps))


SCRAPE = """\
# HELP train_loss x
# TYPE train_loss gauge
train_loss 2.5
train_steps_total 40
recompiles_total 1
goodput_ratio 0.8
train_step_seconds_sum 4.0
train_step_seconds_count 40
other_metric 7
"""


def test_fleet_federation_renders_the_same_samples_as_jax():
    """The same heartbeats (arrival times given) and scrape texts into the
    port's federation and JAX's: the same fleet samples."""
    rng = random.Random(7)
    regs = (MetricsRegistry(), jax_obs.MetricsRegistry())
    feds = [FleetFederation(regs[0], attrib_min_skew_s=0.1),
            jax_sup.FleetFederation(regs[1], attrib_min_skew_s=0.1)]
    steps = {0: 0, 1: 0, 2: 0}
    now = 100.0
    for tick in range(30):
        now += 0.2
        live = [r for r in steps if not (r == 2 and 12 <= tick < 16)]
        for r in live:
            if rng.random() < (0.3 if r == 1 else 0.8):
                steps[r] += 1
            hb = {"step": steps[r], "begin_step": steps[r] + (rng.random() < 0.5),
                  "beat_unix": now}
            for fed in feds:
                fed.observe(r, hb, now=now)
        if tick == 14:
            for fed in feds:
                fed.drop_rank(2)
        for fed in feds:
            fed.finish_poll(live)
        if tick % 5 == 0:
            text = SCRAPE.replace("40", str(40 + tick)).replace("4.0", str(4.0 + tick * 0.1))
            for fed in feds:
                fed.ingest(tick % 3, text)
    port, ref = (parse(reg.render()) for parse, reg in
                 zip((parse_prom_samples, jax_obs.parse_prom_samples), regs))
    fleet = sorted(k for k in port if k.startswith("fleet_"))
    assert fleet == sorted(k for k in ref if k.startswith("fleet_"))
    assert {k: port[k] for k in fleet} == {k: ref[k] for k in fleet}
    assert port["fleet_straggler_total"] and port["fleet_train_loss"]


# ------------------------------------------------------- live_top render


def test_live_top_renders_supervisor_metrics():
    """The dashboard renders the supervisor family from the port's registry:
    group/target size, failures by signal, restart directions - parsed
    from the registry's own Prometheus rendering (the same path a live
    scrape takes)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import live_top

    reg = MetricsRegistry()
    reg.gauge("supervisor_group_size").set(2)
    reg.gauge("supervisor_target_size").set(3)
    reg.counter("worker_failures_total").labels(signal="SIGKILL").inc()
    reg.counter("elastic_restarts_total").labels(direction="shrink").inc()
    reg.histogram(
        "supervisor_restart_seconds", buckets=(0.5, 5.0)
    ).observe(0.3)
    snap = {"metrics": live_top.parse_prometheus(reg.render()),
            "health": None, "loss_history": [], "source": "test"}
    frame = live_top.render(snap, color=False)
    assert "supervisor  group 2/3" in frame
    assert "SIGKILL=1" in frame
    assert "shrink=1" in frame
    assert "restart p95<=0.5" in frame


# ------------------------------------------------------------- goodput


def test_stale_run_dir_sweep(tmp_path):
    """A reused run dir's previous-run heartbeat/flight/record/postmortem
    files are swept at supervisor start, so a relaunch can never read a
    dead run's liveness or crash state. Logs are kept."""
    run = tmp_path / "run"
    for sub in ("hb", "flight", "records", "logs"):
        (run / sub).mkdir(parents=True)
    stale = [
        run / "hb" / "gen0_rank0.json",
        run / "flight" / "gen0_rank1.json",
        run / "records" / "gen0_rank0.json",
        run / "postmortem.json",
        run / "run_record.json",
    ]
    for p in stale:
        p.write_text("{}")
    keep = run / "logs" / "gen0_rank0.log"
    keep.write_text("old log\n")
    logs = []
    Supervisor(
        ["true"], _fast_cfg(), run_dir=str(run),
        registry=MetricsRegistry(),
        log=lambda *a: logs.append(" ".join(str(x) for x in a)),
    )
    for p in stale:
        assert not p.exists(), p
    assert keep.exists()
    assert any("swept 5 stale" in ln for ln in logs)


def test_fleet_goodput_aggregation_and_restart_gap(tmp_path):
    """Workers' run records (written via the exported DNN_TPU_RUN_RECORD)
    aggregate into one fleet record: restart_gap covers the supervisor-
    measured death->respawn window PLUS the relaunched generation's
    reclassified init+compile, the registry exports goodput_ratio /
    badput_seconds_total, and the fleet record lands in run_record.json
    and the SUPERVISOR_SUMMARY line."""
    reg = MetricsRegistry()
    spec = {**_SHRINK_SPEC, "g1": {"*": {"steps": 3}}}
    rc, summary, logs, sup, out = _supervise(
        tmp_path, spec, _fast_cfg(nprocs=2), registry=reg,
    )
    assert rc == 0 and summary["restarts"] == 1
    # per-worker records were exported and collected (both generations)
    rec_dir = tmp_path / "run" / "records"
    names = sorted(os.listdir(rec_dir))
    assert "gen0_rank0.json" in names and "gen1_rank0.json" in names
    fleet = sup.fleet_goodput
    assert fleet is not None and fleet["kind"] == "fleet"
    # the supervisor-side gap (death -> respawn) is in capacity-seconds,
    # and gen 1 (a failure restart) had its init+compile reclassified
    assert sup.restart_generations == {1}
    gap = sup.restart_gaps[0]
    assert gap["seconds"] > 0 and gap["generation"] == 1
    # the policy's backoff pause is recorded separately
    assert gap["backoff_s"] == pytest.approx(
        sup.cfg.backoff_for(1), rel=0.01)
    assert gap["seconds"] >= gap["backoff_s"] - 1e-6
    assert fleet["badput_s"]["restart_gap"] >= gap["seconds"] + 0.4 - 1e-6
    total = fleet["goodput_s"] + sum(fleet["badput_s"].values())
    assert total == pytest.approx(fleet["wall_s"], rel=1e-6)
    # registry export + summary embed + on-disk fleet record
    assert 0 < reg.get("goodput_ratio").value < 1
    assert reg.get("badput_seconds_total").labels(
        cause="restart_gap"
    ).value > 0
    assert summary["goodput"]["goodput_ratio"] == fleet["goodput_ratio"]
    from distributed_neural_network_tpu_torch.utils.goodput import read_record

    on_disk = read_record(str(tmp_path / "run" / "run_record.json"))
    assert on_disk["kind"] == "fleet"
    assert on_disk["badput_s"]["restart_gap"] == pytest.approx(
        fleet["badput_s"]["restart_gap"], rel=0.5
    )


def test_postmortem_carries_goodput_block(tmp_path):
    spec = {**_SHRINK_SPEC, "g1": {"*": {"steps": 3}}}
    rc, summary, logs, sup, out = _supervise(
        tmp_path, spec, _fast_cfg(nprocs=2), registry=MetricsRegistry(),
    )
    with open(tmp_path / "run" / "postmortem.json") as f:
        pm = json.load(f)
    assert pm["goodput"] is not None
    assert pm["goodput"]["kind"] == "fleet"
    # the postmortem's aggregation already includes the dead worker's
    # write-through record (gen 0 both ranks)
    gens = {r["generation"] for r in pm["goodput"]["ranks"]}
    assert 0 in gens


def test_live_top_renders_goodput_line():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import live_top

    reg = MetricsRegistry()
    reg.gauge("goodput_ratio").set(0.42)
    bad = reg.counter("badput_seconds_total")
    bad.labels(cause="restart_gap").inc(12.0)
    bad.labels(cause="stall").inc(3.5)
    snap = {"metrics": live_top.parse_prometheus(reg.render()),
            "health": None, "loss_history": [], "source": "test"}
    frame = live_top.render(snap, color=False)
    assert "goodput      42.0%" in frame
    assert "restart_gap=12.0s" in frame
    assert "stall=3.5s" in frame


# ------------------------------------------------------------ launch CLI

LAUNCH = [sys.executable, "-m", "distributed_neural_network_tpu_torch.launch"]


def test_launch_cli_happy_path(tmp_path):
    worker = tmp_path / "w.py"
    worker.write_text(WORKER)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    proc = subprocess.run(
        [*LAUNCH, "--nprocs", "2", "--poll", "0.05", "--run-dir",
         str(tmp_path / "run"), "--",
         sys.executable, str(worker), str(out_dir),
         json.dumps({"g0": {"*": {"steps": 2}}}), "{rank}"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SUPERVISOR_SUMMARY" in proc.stdout
    summary = json.loads(next(
        ln for ln in proc.stdout.splitlines()
        if ln.startswith("SUPERVISOR_SUMMARY ")
    )[len("SUPERVISOR_SUMMARY "):])
    assert summary["exit"] == "ok" and summary["target_nprocs"] == 2


def test_launch_cli_rendezvous_abort_rc4(tmp_path):
    proc = subprocess.run(
        [*LAUNCH, "--nprocs", "1", "--poll", "0.05", "--rendezvous-retries", "0",
         "--run-dir", str(tmp_path / "run"), "--",
         sys.executable, "-c", "import sys; sys.exit(1)"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 4, proc.stdout + proc.stderr
    assert "SUPERVISOR ABORT: rendezvous failed" in proc.stdout


def test_launch_cli_rejects_dangling_chaos_flags(capsys):
    with pytest.raises(SystemExit) as e:
        launch.main(["--nprocs", "1", "--chaos-kill-at-step", "3", "--",
                     sys.executable, "-c", "pass"])
    assert e.value.code == 2
    assert "--chaos-kill-rank" in capsys.readouterr().err


def test_launch_cli_refuses_devices_per_proc_above_one(capsys):
    """A torch rank drives one device: --devices-per-proc 2 is an argument
    error naming the fix, not a silently wrong mesh."""
    with pytest.raises(SystemExit) as e:
        launch.main(["--nprocs", "2", "--devices-per-proc", "2", "--",
                     sys.executable, "-c", "pass"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--devices-per-proc 2" in err and "--nprocs" in err


# ----------------------------------------- supervised runs (fleet workers)

# the tests/test_fleet_obs.py worker on the port: heartbeats with rank
# metadata at a per-rank cadence after every rank of its generation has
# come up, and writes a flight dump through the port's recorder
# (write-through) so the postmortem bundle has something to collect
FLEET_WORKER = """\
import json, os, signal, sys, time

hb_path = os.environ["DNN_TPU_HEARTBEAT_FILE"]
fl_path = os.environ["DNN_TPU_FLIGHT_FILE"]
rank = int(os.environ["RANK"])
world = int(os.environ["WORLD_SIZE"])
spec = json.loads(sys.argv[1])
me = spec.get(str(rank)) or spec.get("*") or {}
signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))

sys.path.insert(0, %r)
from distributed_neural_network_tpu_torch.utils.obs import FLIGHT, flight_event
FLIGHT.configure(fl_path, rank=rank)
flight_event("run_start", pid=os.getpid())

def beat(step):
    tmp = hb_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"t": time.time(), "beat_unix": time.time(),
                   "step": step, "pid": os.getpid(), "rank": rank,
                   "hostname": "testhost", "metrics_url": None}, f)
    os.replace(tmp, hb_path)

# the rendezvous: the heartbeat file says this rank is up; steps start when
# every rank of the generation is
beat(None)
peers = [hb_path.replace(f"_rank{rank}.json", f"_rank{r}.json") for r in range(world)]
while not all(os.path.exists(p) for p in peers):
    time.sleep(0.01)
for s in range(me.get("steps", 5)):
    beat(s)
    flight_event("step_note", step=s)
    time.sleep(me.get("dt", 0.05))
sys.exit(0)
""" % (REPO,)


@pytest.fixture
def _clean_flight():
    FLIGHT.reset()
    yield
    FLIGHT.reset()


def _run_fleet_group(tmp_path, spec, cfg, *, chaos=None, registry=None, federation=None):
    worker = tmp_path / "worker.py"
    worker.write_text(FLEET_WORKER)
    logs = []
    sup = Supervisor(
        [sys.executable, str(worker), json.dumps(spec)],
        cfg,
        run_dir=str(tmp_path / "run"),
        chaos=chaos,
        registry=registry,
        federation=federation,
        log=lambda *a: logs.append(" ".join(str(x) for x in a)),
    )
    rc = sup.run()
    return rc, sup, logs


def _fleet_cfg():
    # a wide rendezvous window: the workers import torch before their first beat
    return SupervisorConfig(nprocs=2, poll_s=0.03, grace_s=2.0, restart_backoff_s=0.05,
                            rendezvous_timeout_s=90.0)


def test_supervised_straggler_attribution_flags_slow_rank(tmp_path, _clean_flight):
    """End-to-end over real processes: rank 1 steps 12x slower than rank
    0 (rank 0 runs long enough to outlive rank 1's steps); the supervisor's
    federation attributes rank 1 as the straggler from heartbeat arrivals
    alone."""
    reg = MetricsRegistry()
    fed = FleetFederation(reg, attrib_min_skew_s=0.1)
    spec = {"0": {"steps": 80, "dt": 0.03}, "1": {"steps": 5, "dt": 0.36}}
    rc, sup, logs = _run_fleet_group(tmp_path, spec, _fleet_cfg(), registry=reg,
                                     federation=fed)
    assert rc == 0, logs
    assert reg.get("fleet_straggler_rank").value == 1
    assert reg.get("fleet_straggler_total").labels(rank="1").value >= 1
    assert reg.get("fleet_step_skew_seconds").labels().count >= 1
    # per-rank rows exist for both ranks
    parsed = parse_prom_samples(reg.render())
    assert (("rank", "0"),) in parsed["fleet_worker_step"]
    assert (("rank", "1"),) in parsed["fleet_worker_step"]


def test_postmortem_bundle_on_chaos_sigkill(tmp_path, _clean_flight):
    """A chaos-SIGKILLed rank leaves no exit path, but its write-through
    flight dump is on disk: the supervisor's postmortem.json bundles both
    ranks' dumps, names the SIGKILL, and counts the bundle."""
    reg = MetricsRegistry()
    spec = {"*": {"steps": 60, "dt": 0.05}}
    chaos = ProcessChaos(events=(KillEvent(rank=1, at_step=3, sig="KILL"),))
    rc, sup, logs = _run_fleet_group(tmp_path, spec, _fleet_cfg(), chaos=chaos, registry=reg)
    assert rc == 0, logs
    pm_path = os.path.join(str(tmp_path / "run"), "postmortem.json")
    assert sup.postmortem_path == pm_path
    assert os.path.exists(pm_path)
    with open(pm_path) as f:
        pm = json.load(f)
    assert pm["reason"] == "worker failure"
    by_rank = {w["rank"]: w for w in pm["workers"]}
    assert set(by_rank) == {0, 1}
    assert by_rank[1]["failed"] and by_rank[1]["cause"] == "SIGKILL"
    # the killed rank's flight dump made it into the bundle, with the
    # pre-kill events intact
    fl = by_rank[1]["flight"]
    assert fl is not None and fl["rank"] == 1
    kinds = [e["kind"] for e in fl["events"]]
    assert "run_start" in kinds and "step_note" in kinds
    # heartbeat attribution rides the file CONTENT, not the path
    assert by_rank[1]["heartbeat"]["rank"] == 1
    assert by_rank[1]["heartbeat"]["hostname"] == "testhost"
    assert reg.get("supervisor_postmortems_total").value >= 1
    assert sup.postmortems_written >= 1
    assert any("postmortem bundle" in ln for ln in logs)


def test_supervisor_module_stays_light():
    """The launcher imports no torch (so it can hold no CUDA context on the
    card through the workers' restarts), and the supervisor, the launcher
    and the process chaos call nothing of torch.cuda."""
    code = ("import sys, distributed_neural_network_tpu_torch.launch\n"
            "assert 'torch' not in sys.modules and 'numpy' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for mod in (sup_mod, launch, fault):
        assert "torch.cuda." not in open(mod.__file__).read(), mod.__file__
