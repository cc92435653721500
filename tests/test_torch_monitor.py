"""The monitor of the port (`train/monitor.py`; `utils/obs.py`
`HeartbeatFileWriter`, `publish_phase_timers` and the ``/profile`` route;
the live registry of `train/lm.py` `make_traced_step` and of the CNN
`Engine`; the step objects' ``_cache_size``) on the CPU, held exactly to the
JAX package's functions on the same inputs (these are host values: the
tolerance is none). The cases are those of the JAX package's
`tests/test_monitor.py`, `tests/test_obs.py` (the phase-timer export) and
`tests/test_fleet_obs.py` (heartbeat, /profile, the fleet wiring), each run
on both packages where both can run it; the watchdog's timing margins are
wide (a flagged stall sleeps 10-100x its threshold)."""

import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.parallel import fault as j_fault
from distributed_neural_network_tpu.train import guard as j_guard
from distributed_neural_network_tpu.train import lm as j_lm
from distributed_neural_network_tpu.train import monitor as j_mon
from distributed_neural_network_tpu.utils import obs as j_obs
from distributed_neural_network_tpu.utils import timers as j_timers
from distributed_neural_network_tpu.utils import tracing as j_tr
from distributed_neural_network_tpu_torch.parallel import fault as t_fault
from distributed_neural_network_tpu_torch.train import guard as t_guard
from distributed_neural_network_tpu_torch.train import lm as t_lm
from distributed_neural_network_tpu_torch.train import monitor as t_mon
from distributed_neural_network_tpu_torch.utils import obs as t_obs
from distributed_neural_network_tpu_torch.utils import timers as t_timers
from distributed_neural_network_tpu_torch.utils import tracing as t_tr


class Pkg:
    def __init__(self, name, mon, obs, tr, guard, fault, lm, timers, rank_env):
        self.name, self.mon, self.obs, self.tr, self.guard = name, mon, obs, tr, guard
        self.fault, self.lm, self.timers, self.rank_env = fault, lm, timers, rank_env


JAX = Pkg("jax", j_mon, j_obs, j_tr, j_guard, j_fault, j_lm, j_timers, "JAX_PROCESS_ID")
PORT = Pkg("torch", t_mon, t_obs, t_tr, t_guard, t_fault, t_lm, t_timers, "RANK")
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])


def _quiet(*_):
    pass


@pytest.fixture(autouse=True)
def _clean_flight():
    """Neither process-wide flight recorder carries events between tests."""
    for o in (j_obs, t_obs):
        o.FLIGHT.reset()
    yield
    for o in (j_obs, t_obs):
        o.FLIGHT.reset()


def beat_n(reg, n, *, interval=0.0, start=0):
    """n heartbeats with a primed steady interval (no sleeping)."""
    for i in range(n):
        reg.beat(start + i)
        if interval and reg._intervals:
            reg._intervals[-1] = interval
    return reg


def _names(tracer):
    return [e["name"] for e in tracer.to_chrome()["traceEvents"] if e.get("ph") == "i"]


def _kinds(pkg):
    return [e["kind"] for e in pkg.obs.FLIGHT.events()]


def _dog(pkg, reg, **cfg_kw):
    cfg = pkg.mon.WatchdogConfig(**{"min_stall_s": 0.0, **cfg_kw})
    tracer = pkg.tr.Tracer(enabled=True)
    return pkg.mon.Watchdog(reg, config=cfg, tracer=tracer, log=_quiet), tracer


def test_the_names_are_the_jax_ones():
    for name in ("WATCHDOG_STALL", "WATCHDOG_RECOMPILE", "WATCHDOG_CKPT_STALE"):
        assert getattr(t_mon, name) == getattr(j_mon, name)
    for cls in ("WatchdogConfig", "Watchdog", "RecompileDetector", "ProfileController",
                "Monitor"):
        assert hasattr(t_mon, cls)
    assert t_mon.WatchdogConfig() == t_mon.WatchdogConfig(**vars(j_mon.WatchdogConfig()))


# ------------------------------------------------------- WatchdogConfig


@pytest.mark.parametrize("kw", [{"poll_interval_s": 0.0}, {"stall_factor": 1.0},
                                {"min_stall_s": -1.0},
                                {"min_stall_s": 10.0, "max_stall_s": 5.0}])
def test_watchdog_config_checks_are_the_jax_ones(kw):
    with pytest.raises(ValueError) as want:
        j_mon.WatchdogConfig(**kw)
    with pytest.raises(ValueError) as got:
        t_mon.WatchdogConfig(**kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- stall detector


@BOTH
def test_stall_threshold_adapts_to_steady_p95_with_clamps(pkg):
    reg = beat_n(pkg.obs.MetricsRegistry(), 10, interval=0.01)
    assert _dog(pkg, reg, stall_factor=10.0)[0].stall_threshold_s() == pytest.approx(0.1)
    assert _dog(pkg, reg, stall_factor=10.0, min_stall_s=5.0)[0].stall_threshold_s() == 5.0
    slow = beat_n(pkg.obs.MetricsRegistry(), 10, interval=120.0)
    assert _dog(pkg, slow, max_stall_s=600.0)[0].stall_threshold_s() == 600.0


def _stall_episodes(pkg):
    """Two stall episodes of a registry primed at 5 ms beats (threshold 10
    ms; each stall sleeps 0.2 s, the poll after a beat comes within
    microseconds): what each poll raised, the counter and threshold gauge
    after each, and the trace's instants."""
    pkg.obs.FLIGHT.reset()
    reg = beat_n(pkg.obs.MetricsRegistry(), 8, interval=5e-3)
    dog, tracer = _dog(pkg, reg, stall_factor=2.0, warmup_beats=3)
    polls = []

    def poll():
        polls.append((dog.check_once(), dog.stall_counter.value,
                      round(dog.threshold_gauge.value, 9)))

    time.sleep(0.2)
    poll()
    poll()  # latched inside the episode
    reg.beat(100)
    reg._intervals[-1] = 5e-3
    poll()  # the beat closed the episode
    time.sleep(0.2)
    poll()
    return polls, _names(tracer), [e.get("step") for e in pkg.obs.FLIGHT.events()
                                   if e["kind"] == "watchdog_stall"]


@BOTH
def test_stall_flagged_once_per_episode_and_rearms(pkg):
    polls, names, steps = _stall_episodes(pkg)
    raised = [p[0]["stall"] for p in polls]
    assert raised == [True, False, False, True]
    assert [p[1] for p in polls] == [1, 1, 1, 2]
    assert all(p[2] == pytest.approx(1e-2) for p in polls)
    assert names == [j_mon.WATCHDOG_STALL] * 2 and steps == [7, 100]


def test_stall_episodes_equal_the_jax_ones():
    (jp, jn, js), (tp, tn, ts) = _stall_episodes(JAX), _stall_episodes(PORT)
    assert [(p[0], p[1]) for p in tp] == [(p[0], p[1]) for p in jp]
    assert tn == jn and ts == js


@BOTH
def test_stall_detector_stays_disarmed_under_warmup(pkg):
    reg = beat_n(pkg.obs.MetricsRegistry(), 2, interval=0.001)
    dog, _ = _dog(pkg, reg, warmup_beats=5)
    assert dog.stall_threshold_s() is None
    assert dog.check_once() == {"stall": False, "storm": False, "ckpt_stale": False}


class _Requests:
    """A preemption stand-in counting `request` calls."""

    def __init__(self):
        self.calls = []

    def request(self, reason="REQUEST"):
        self.calls.append(reason)


@BOTH
def test_stall_escalates_into_one_preemption_request(pkg):
    reg = beat_n(pkg.obs.MetricsRegistry(), 8, interval=1e-4)
    cfg = pkg.mon.WatchdogConfig(min_stall_s=0.0, stall_factor=2.0, warmup_beats=3,
                                 escalate_after_polls=2)
    stub = _Requests()
    tracer = pkg.tr.Tracer(enabled=True)
    dog = pkg.mon.Watchdog(reg, config=cfg, preemption=stub, tracer=tracer, log=_quiet)
    time.sleep(0.01)
    assert dog.check_once()["stall"] is True and stub.calls == []
    dog.check_once()
    dog.check_once()  # the second persistent poll escalates
    dog.check_once()
    dog.check_once()
    assert stub.calls == ["WATCHDOG"]
    assert _names(tracer) == [j_mon.WATCHDOG_STALL] * 2
    assert _kinds(pkg) == ["watchdog_stall", "watchdog_escalate"]
    # the real guard: the flag up, the reason WATCHDOG, a preempt event
    guard = pkg.guard.PreemptionGuard(log=_quiet)
    dog.preemption, dog._escalated, dog._stall_polls = guard, False, 1
    dog.check_once()
    assert guard.requested and guard.signame == "WATCHDOG"
    assert _kinds(pkg)[-1] == "preempt"


# --------------------------------------------------- recompile detector


class _Sized:
    """A step whose `_cache_size()` walks through `sizes`."""

    def __init__(self, sizes):
        self.sizes = list(sizes)

    def _cache_size(self):
        return self.sizes.pop(0) if len(self.sizes) > 1 else self.sizes[0]


def _recompiles(pkg):
    pkg.obs.FLIGHT.reset()
    reg = pkg.obs.MetricsRegistry()
    tracer = pkg.tr.Tracer(enabled=True)
    det = pkg.mon.RecompileDetector(registry=reg, tracer=tracer)
    out = []
    det.swap(_Sized([0, 1, 1, 2, 4]))  # baseline 0; the compile; a hit; 1 miss; 2 misses
    out += [det.observe(i) for i in range(4)]
    out.append(reg.counter("recompiles_total").value)
    det.swap(_Sized([0, 1, 2]))  # a deliberate rebuild: its first build is no miss
    out += [det.observe(i) for i in (4, 5)]
    out.append(reg.counter("recompiles_total").value)
    out.append(det.recent(window_s=60.0))
    return out, _names(tracer), [(e["step"], e["new_entries"], e["cache_size"])
                                 for e in pkg.obs.FLIGHT.events() if e["kind"] == "recompile"]


@BOTH
def test_recompile_detector_counts_misses_not_the_first_build(pkg):
    got = _recompiles(pkg)
    assert got == ([0, 0, 1, 3, 3, 3, 4, 4, 4], ["watchdog/recompile"] * 3,
                   [(2, 1, 2), (3, 2, 4), (5, 1, 2)])
    assert got == _recompiles(JAX)


@BOTH
def test_recompile_detector_is_a_noop_without_the_count(pkg):
    det = pkg.mon.RecompileDetector(lambda x: x)
    assert pkg.mon.RecompileDetector.cache_size(lambda x: x) is None
    assert det.observe(0) == 0


@BOTH
def test_recompile_storm_flags_on_a_burst(pkg):
    reg = pkg.obs.MetricsRegistry()
    tracer = pkg.tr.Tracer(enabled=True)
    det = pkg.mon.RecompileDetector(registry=reg, tracer=tracer)
    dog = pkg.mon.Watchdog(reg, config=pkg.mon.WatchdogConfig(recompile_storm=3),
                           tracer=tracer, recompiles=det, log=_quiet)
    det.events.extend([time.time()] * 4)
    raised = [dog.check_once()["storm"], dog.check_once()["storm"]]
    det.events.clear()
    dog.check_once()
    det.events.extend([time.time()] * 4)
    raised.append(dog.check_once()["storm"])
    assert raised == [True, False, True] and dog.storm_counter.value == 2
    assert _names(tracer) == [j_mon.WATCHDOG_RECOMPILE] * 2


# ------------------------------------------------- checkpoint staleness


@BOTH
def test_checkpoint_staleness_flags_once_per_stale_save(pkg):
    reg = pkg.obs.MetricsRegistry()
    tracer = pkg.tr.Tracer(enabled=True)
    dog = pkg.mon.Watchdog(reg, config=pkg.mon.WatchdogConfig(checkpoint_stale_s=10.0),
                           tracer=tracer, log=_quiet)
    raised = [dog.check_once()["ckpt_stale"]]
    g = reg.gauge("checkpoint_last_save_timestamp_seconds")
    g.set(time.time() - 60.0)
    raised += [dog.check_once()["ckpt_stale"], dog.check_once()["ckpt_stale"]]
    g.set(time.time() - 61.0)  # a newer, still stale, save
    raised.append(dog.check_once()["ckpt_stale"])
    assert raised == [False, True, False, True] and dog.ckpt_stale_counter.value == 2
    assert _names(tracer) == [j_mon.WATCHDOG_CKPT_STALE] * 2
    assert _kinds(pkg) == ["watchdog_checkpoint_stale"] * 2


@BOTH
def test_checkpointer_publishes_the_save_and_its_flight_event(pkg, tmp_path):
    if pkg is JAX:
        from distributed_neural_network_tpu.utils.checkpoint import TreeCheckpointer
        tree = {"w": jnp.ones((2,))}
    else:
        from distributed_neural_network_tpu_torch.utils.checkpoint import TreeCheckpointer
        tree = {"w": torch.ones(2)}
    reg = pkg.obs.MetricsRegistry()
    t0 = time.time()
    TreeCheckpointer(str(tmp_path), backend="npz", registry=reg).save(7, tree, {"loss": 1.0})
    assert reg.counter("checkpoint_saves_total").value == 1
    assert reg.gauge("checkpoint_last_step").value == 7
    assert reg.gauge("checkpoint_last_save_timestamp_seconds").value >= t0
    assert [(e["kind"], e["step"]) for e in pkg.obs.FLIGHT.events()] == [("checkpoint_save", 7)]


@BOTH
def test_goodput_finalize_records_its_flight_event(pkg):
    if pkg is JAX:
        from distributed_neural_network_tpu.utils.goodput import GoodputLedger
    else:
        from distributed_neural_network_tpu_torch.utils.goodput import GoodputLedger
    led = GoodputLedger()
    led.start()
    rec = led.finalize()
    ev = pkg.obs.FLIGHT.events()[-1]
    assert ev["kind"] == "goodput_final" and sorted(ev) == ["goodput_ratio", "kind", "t",
                                                            "wall_s"]
    assert ev["wall_s"] == rec["wall_s"]


# -------------------------------------------------- the watchdog thread


@BOTH
def test_watchdog_thread_survives_internal_errors(pkg):
    class Broken(pkg.obs.MetricsRegistry):
        def beat_intervals(self):
            raise RuntimeError("boom")

    logs = []
    dog = pkg.mon.Watchdog(Broken(), config=pkg.mon.WatchdogConfig(poll_interval_s=0.01),
                           log=logs.append)
    with dog:
        time.sleep(0.1)
        assert dog._thread.is_alive()
    assert any("internal error RuntimeError: boom; continuing" in s for s in logs)


@BOTH
def test_watchdog_start_stop_are_idempotent(pkg):
    dog = pkg.mon.Watchdog(pkg.obs.MetricsRegistry(), log=_quiet)
    dog.start()
    dog.start()
    dog.stop()
    dog.stop()
    assert dog._thread is None


# ------------------------------------------------------ heartbeat file


@BOTH
def test_heartbeat_file_has_the_jax_keys_and_the_env_rank(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(pkg.rank_env, "3")
    reg = pkg.obs.MetricsRegistry()
    reg.begin_step(6)
    reg.beat(5)
    path = tmp_path / "hb.json"
    hb = pkg.obs.HeartbeatFileWriter(reg, str(path), metrics_url="http://127.0.0.1:9")
    hb.close()
    doc = json.loads(path.read_text())
    assert sorted(doc) == ["beat_unix", "begin_step", "hostname", "metrics_url", "pid", "rank",
                           "role", "step", "t"]
    assert (doc["rank"], doc["step"], doc["begin_step"], doc["metrics_url"]) == (
        3, 5, 6, "http://127.0.0.1:9")
    hb = pkg.obs.HeartbeatFileWriter(reg, str(path), rank=7)
    hb.close()
    assert json.loads(path.read_text())["rank"] == 7
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_heartbeat_write_swallows_os_errors(tmp_path):
    reg = t_obs.MetricsRegistry()
    hb = t_obs.HeartbeatFileWriter(reg, str(tmp_path / "hb.json"))
    hb.path = str(tmp_path / "gone" / "hb.json")  # its directory is missing
    hb.close()  # the final write fails quietly


# ------------------------------------------------------ phase timers


def test_publish_phase_timers_renders_the_jax_samples():
    docs = []
    for pkg in (JAX, PORT):
        timers = pkg.timers.PhaseTimers()
        timers.totals.update({"data_loading": 1.5, "training": 2.25, "evaluation": 0.5,
                              "communication": 0.125})
        reg = pkg.obs.MetricsRegistry()
        pkg.obs.publish_phase_timers(reg, timers)
        timers.totals["data_loading"] = 1.0  # a regression never shows
        pkg.obs.publish_phase_timers(reg, timers)
        docs.append(reg.render())
    assert docs[0].split("process_start_time")[0] == docs[1].split("process_start_time")[0]
    samples = t_obs.parse_prom_samples(docs[1])["phase_seconds_total"]
    assert samples[(("phase", "data_loading"),)] == 1.5 and len(samples) == 4


# ------------------------------------------------------ /profile route


def _status(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _profile_answers(pkg, tmp_path):
    reg = pkg.obs.MetricsRegistry()
    out = []
    srv = pkg.obs.ObsServer(reg, port=0)
    try:
        out.append(_status(srv.url + "/profile?steps=2"))
    finally:
        srv.close()
    prof = pkg.mon.ProfileController(str(tmp_path / pkg.name), log=_quiet)
    srv = pkg.obs.ObsServer(reg, port=0, profiler=prof)
    try:
        for q in ("steps=x", "steps=0", "steps=2", "steps=1"):
            out.append(_status(srv.url + "/profile?" + q))
    finally:
        srv.close()
    return [(code, sorted(doc), doc.get("ok"), doc.get("steps")) for code, doc in out]


def test_profile_route_answers_as_the_jax_one(tmp_path):
    got = _profile_answers(PORT, tmp_path)
    assert [a[0] for a in got] == [501, 400, 400, 200, 409]
    assert got == _profile_answers(JAX, tmp_path)


def test_profile_controller_writes_a_chrome_trace_of_n_steps(tmp_path):
    pc = t_mon.ProfileController(str(tmp_path), device="cpu", log=_quiet)
    r = pc.request(2)
    assert r["ok"] and r["steps"] == 2
    assert not pc.request(1)["ok"]  # pending
    pc.on_step(10)  # starts
    assert not pc.request(1)["ok"]  # active
    with torch.profiler.record_function("step_11"):
        torch.ones(4).sum()
    pc.on_step(11)
    assert pc.captures == 0
    with torch.profiler.record_function("step_12"):
        torch.ones(4).sum()
    pc.on_step(12)  # 12 >= 10 + 2: stops
    assert pc.captures == 1, pc.error
    assert pc.last_dir == os.path.join(str(tmp_path), "profile_step10_x2")
    with open(os.path.join(pc.last_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step_11", "step_12"} <= names
    assert [e["dir"] for e in t_obs.FLIGHT.events() if e["kind"] == "profile_capture"] == [
        pc.last_dir]
    assert pc.request(1)["ok"]  # armed again
    pc.close()
    assert pc.captures == 1  # nothing started: nothing to stop


def test_profile_controller_errors_never_reach_the_step_loop(tmp_path):
    (tmp_path / "f").write_text("")
    pc = t_mon.ProfileController(str(tmp_path / "f"), log=_quiet)  # a file, not a dir
    pc.request(1)
    pc.on_step(0)
    pc.on_step(1)
    assert pc.captures == 0 and pc.error
    assert pc.request(1)["last_error"] == pc.error


# ------------------------------------------------------ attach_monitor


@BOTH
def test_attach_monitor_none_is_inert(pkg):
    m = pkg.mon.attach_monitor(metrics_port=None, log=_quiet)
    assert m.registry is pkg.obs.NULL_REGISTRY
    assert m.server is None and m.watchdog is None and m.url is None
    m.close()
    m.close()


@BOTH
def test_attach_monitor_serves_and_closes(pkg):
    logs = []
    m = pkg.mon.attach_monitor(metrics_port=0, watchdog=False, log=logs.append)
    try:
        assert m.watchdog is None and m.recompiles is not None
        assert logs == [f"(metrics server: {m.url}/metrics , {m.url}/healthz ; watchdog off)"]
        m.registry.counter("train_steps_total").inc(2)
        with urllib.request.urlopen(m.url + "/metrics", timeout=5) as r:
            assert "train_steps_total 2" in r.read().decode()
    finally:
        m.close()


def _fleet(pkg, tmp_path, monkeypatch):
    d = tmp_path / pkg.name
    monkeypatch.setenv("DNN_TPU_HEARTBEAT_FILE", str(d / "hb.json"))
    monkeypatch.setenv("DNN_TPU_FLIGHT_FILE", str(d / "fl.json"))
    kw = {"device": "cpu"} if pkg is PORT else {}
    m = pkg.mon.attach_monitor(metrics_port=0, watchdog=False, profile_dir=str(d / "prof"),
                               rank=1, log=_quiet, **kw)
    try:
        assert m.flight is pkg.obs.FLIGHT and pkg.obs.FLIGHT.rank == 1
        assert m.registry.beat_hook == m.profiler.on_step
        hb = json.loads((d / "hb.json").read_text())
        assert hb["rank"] == 1 and hb["metrics_url"] == m.url
        code, body = _status(m.url + "/profile?steps=1")
        m.registry.beat(0)
        m.registry.beat(1)
        captures = m.profiler.captures
        names = sorted(m.registry._metrics)
    finally:
        m.close()
    doc = json.loads((d / "fl.json").read_text())
    return (code, sorted(body), captures, names, doc["cause"], doc["rank"],
            [e["kind"] for e in doc["events"]], sorted(hb))


def test_attach_monitor_fleet_wiring_is_the_jax_one(tmp_path, monkeypatch):
    got = _fleet(PORT, tmp_path, monkeypatch)
    assert got[0] == 200 and got[2] == 1 and got[4] == "close"
    assert got[6] == ["run_start", "profile_capture"]
    assert got == _fleet(JAX, tmp_path, monkeypatch)


@BOTH
def test_attach_monitor_heartbeat_only_arms_flight(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("DNN_TPU_HEARTBEAT_FILE", str(tmp_path / "h.json"))
    monkeypatch.setenv("DNN_TPU_FLIGHT_FILE", str(tmp_path / "f.json"))
    m = pkg.mon.attach_monitor(metrics_port=None, log=_quiet)
    try:
        assert m.server is None and m.heartbeat is not None and m.flight is pkg.obs.FLIGHT
        assert m.registry is not pkg.obs.NULL_REGISTRY and m.recompiles is None
        assert json.loads((tmp_path / "h.json").read_text())["metrics_url"] is None
    finally:
        m.close()
    assert json.loads((tmp_path / "f.json").read_text())["cause"] == "close"


# ------------------------------------- the traced step under a chaos stall


def _toy_step(pkg):
    if pkg is JAX:
        return jax.jit(lambda x: x + 1.0), jnp.zeros((8,))
    return (lambda x: x + 1.0), torch.zeros(8)


@BOTH
def test_watchdog_flags_an_injected_stall_within_one_detection_window(pkg):
    """The traced step beats the registry; `ChaosMonkey.stall_at` wedges the
    loop for 1 s against a 0.1 s threshold; the polling watchdog raises
    ``watchdog_stall_total`` and the ``watchdog/stall`` instant."""
    tracer = pkg.tr.Tracer(enabled=True)
    reg = pkg.obs.MetricsRegistry()
    cfg = pkg.mon.WatchdogConfig(poll_interval_s=0.02, stall_factor=3.0, min_stall_s=0.1,
                                 warmup_beats=3)
    dog = pkg.mon.Watchdog(reg, config=cfg, tracer=tracer, log=_quiet)
    monkey = pkg.fault.ChaosMonkey(stall_at=(10,), stall_s=1.0, tracer=tracer, log=_quiet)
    fn, x = _toy_step(pkg)
    traced = pkg.lm.make_traced_step(fn, tracer=tracer, step_stats=None, items_per_step=8,
                                     registry=reg)
    with dog:
        for i in range(11):
            x = traced(x)
            monkey.after_step(i)
        deadline = time.time() + 2.0
        while time.time() < deadline and dog.stall_counter.value == 0:
            time.sleep(0.02)
    assert dog.stall_counter.value >= 1
    assert j_mon.WATCHDOG_STALL in _names(tracer)
    assert reg.last_step() == 10 and float(x[0]) == 11.0


def _traced_names(pkg):
    reg = pkg.obs.MetricsRegistry()
    det = pkg.mon.RecompileDetector(registry=reg)
    fn, x = _toy_step(pkg)
    traced = pkg.lm.make_traced_step(fn, tracer=pkg.tr.NULL_TRACER, step_stats=None,
                                     items_per_step=100, registry=reg, recompiles=det)
    ready = [reg.ready]
    for _ in range(3):
        x = traced(x)
        ready.append(reg.ready)
    assert reg.counter("train_steps_total").value == 3
    assert reg.histogram("train_step_seconds").labels().count == 3
    assert reg.gauge("train_throughput_items_per_s").value > 0
    assert reg.last_step() == 2 and reg.last_begin_step() == 2
    return sorted(pkg.obs.parse_prom_samples(reg.render())), ready


def test_traced_step_publishes_the_jax_metrics():
    assert _traced_names(PORT) == _traced_names(JAX)
    assert _traced_names(PORT)[1] == [False, True, True, True]


# ------------------------------------------- the steps' build counts


def _tiny_lm():
    from distributed_neural_network_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                                dtype=torch.float32)
    mesh = t_lm.create_lm_mesh(1, 1, 1, device="cpu")
    params, _ = t_lm.shard_params(tfm.init_params(0, cfg), cfg, mesh)
    mom = t_lm.init_lm_momentum(params, "adam", mesh)
    tok, tgt = t_lm.make_copy_task(torch.Generator().manual_seed(1), batch=4, seq_len=16,
                                   vocab=32)
    return cfg, mesh, params, mom, tok, tgt


def test_lm_steps_count_one_build():
    cfg, mesh, params, mom, tok, tgt = _tiny_lm()
    step = t_lm.make_lm_train_step(cfg, mesh=mesh, device="cpu", lr=0.01, optimizer="adam")
    det = t_mon.RecompileDetector(step, registry=t_obs.MetricsRegistry())
    sizes = [step._cache_size()]
    for i in range(3):
        step(params, mom, tok, tgt, i)
        sizes.append(step._cache_size())
        det.observe(i)
    assert sizes == [0, 1, 1, 1] and det.counter.value == 0
    ev = t_lm.make_eval_fn(cfg, mesh=mesh)
    assert ev._cache_size() == 0
    ev(params, tok, tgt)
    ev(params, tok, tgt)
    assert ev._cache_size() == 1


N_WORKERS = 4


class _Spiked:
    """A rollback guard whose observation of epoch 2 is x100 once."""

    def __init__(self, mod):
        self.g = mod.TrainingGuard(mod.GuardConfig(policy="rollback", warmup_steps=2),
                                   log=_quiet)
        self.fired = False

    def observe(self, epoch, loss, **kw):
        if epoch == 2 and not self.fired:
            self.fired, loss = True, loss * 100.0
        return self.g.observe(epoch, loss, **kw)

    def __getattr__(self, name):
        return getattr(self.g, name)


def test_cnn_engine_publishes_the_jax_metrics_and_its_rollback_is_no_recompile(n_devices):
    """`Engine(registry=)` with the recompile detector on its step, the JAX
    CLI's way, through a rollback (epoch 2's loss x100): the same metric
    names as the JAX Engine, the same step, epoch and dispatch counts, the
    loss gauge within the engines' bound, and no recompile counted on either
    side (the rollback's rebuild re-baselines)."""
    from distributed_neural_network_tpu.data.cifar10 import load_split as j_load
    from distributed_neural_network_tpu.train.engine import Engine as JEngine
    from distributed_neural_network_tpu.train.engine import TrainConfig as JConfig
    from distributed_neural_network_tpu_torch.data.cifar10 import load_split
    from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

    kw = dict(lr=0.05, momentum=0.9, batch_size=16, epochs=4, nb_proc=N_WORKERS,
              regime="data_parallel", seed=1)
    size = dict(source="synthetic", synthetic_size=128, seed=1)
    out = {}
    for name in ("jax", "torch"):
        reg = (j_obs if name == "jax" else t_obs).MetricsRegistry()
        mon = j_mon if name == "jax" else t_mon
        if name == "jax":
            eng = JEngine(JConfig(**kw), j_load(True, **size), None, registry=reg)
            fn, guard = eng._train_fn, _Spiked(j_guard)
        else:
            eng = Engine(TrainConfig(**kw), load_split(True, **size), None, device="cpu",
                         registry=reg)
            fn, guard = eng._step, _Spiked(t_guard)
        det = mon.RecompileDetector(fn, registry=reg)
        eng.recompiles = det
        hist = eng.run(log=_quiet, guard=guard)
        samples = t_obs.parse_prom_samples(reg.render())
        out[name] = {"names": sorted(samples), "rollbacks": guard.summary()["rollbacks"],
                     "epochs": [m.epoch for m in hist],
                     "steps": samples["train_steps_total"][()],
                     "epoch": samples["train_epoch"][()],
                     # a counter never raised has no sample: 0
                     "recompiles": det.counter.value,
                     "loss": samples["train_loss"][()], "beat": reg.last_step()}
    j, t = out["jax"], out["torch"]
    assert abs(t.pop("loss") - j.pop("loss")) < 5e-4
    assert t == j
    assert t["rollbacks"] == 1 and t["recompiles"] == 0 and t["steps"] == 4 + 3
