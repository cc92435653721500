"""The port across processes (`parallel/distributed.py`, `parallel/mesh.py`,
`parallel/collectives.py`, the engine under torch.distributed), on the CPU
with gloo.

1. `initialize`: the counterparts of the JAX package's tests/test_distributed.py
   (the no-op, each missing variable, retrying until the rendezvous comes
   up, an actionable message when the attempts run out, the deadline
   cutting retries, the deadline that remains passed as the timeout, the
   environment defaults), through its seams with no processes; and the
   backend and device rules.
2. The gathered sync (`RowGather` + `masked_mean`) at world 2 (2 x 2
   workers) and world 4 (4 x 1): for the same (4, P) stack and five live
   masks (all dead among them) bitwise the in-process masked mean.
3. The engine at world 2 x 2 workers (data_parallel and replication, sync
   per epoch and per step, and data_parallel streaming; 256 train and 64
   test rows, batch 8, 2 epochs, the head through `--kernels cuda`'s plain
   version): every rank's history equal; bitwise the in-process 4-worker
   run (one process, no group; every process at OMP_NUM_THREADS=1, since
   the CPU's reductions may split by thread); held to tests/oracle_numpy.py
   with the port's orders (train loss 5e-4, params max-rel 2e-3; per step
   by the numpy `step_trajectory` below); and the step sync in leaf buckets
   (--grad-sync overlap) bitwise the one-buffer (end) run.
4. The CLI under `python -m torch.distributed.run --nproc-per-node 2`: both
   ranks' SUMMARY metrics equal, the backend printed, rank-suffixed files.

The ranks run as subprocesses (tests/torch_rank_worker.py) on a free
localhost port, each under a time limit.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_neural_network_tpu_torch.data.cifar10 import load_split
from distributed_neural_network_tpu_torch.data.pipeline import shuffle_generator
from distributed_neural_network_tpu_torch.parallel import distributed as dist
from distributed_neural_network_tpu_torch.parallel.mesh import ReplicaGroup, create_mesh

import oracle_numpy as O
from torch_rank_worker import ROOT, launch

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE")

# ------------------------------------------------------------- initialize


@pytest.fixture
def clean_env(monkeypatch):
    for v in ENV_VARS + ("DNN_TPU_COORDINATOR_RETRIES", "DNN_TPU_COORDINATOR_DEADLINE_S",
                         "DNN_TPU_COORDINATOR_BACKOFF_S"):
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_initialize_single_process_noop(clean_env):
    assert dist.initialize(device="cpu") is False
    assert dist.initialize(device="cpu") is False  # idempotent
    assert not dist.joined()
    clean_env.setenv("MASTER_ADDR", "localhost")
    clean_env.setenv("WORLD_SIZE", "1")
    assert dist.initialize(device="cpu") is False  # a world of one joins nothing
    assert create_mesh(4, "cpu") == ReplicaGroup(4, torch.device("cpu"))


@pytest.mark.parametrize("missing,env", [
    ("MASTER_ADDR", {"WORLD_SIZE": "2", "RANK": "0", "MASTER_PORT": "1234"}),
    ("WORLD_SIZE", {"MASTER_ADDR": "localhost", "RANK": "0", "MASTER_PORT": "1234"}),
    ("RANK", {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2", "MASTER_PORT": "1234"}),
    ("MASTER_PORT", {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2", "RANK": "1"}),
])
def test_partial_configuration_names_the_missing_variable(clean_env, missing, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match=missing):
        dist.initialize(device="cpu", _connect=lambda **kw: pytest.fail("connected"))


def test_nonpositive_world_is_refused(clean_env):
    clean_env.setenv("MASTER_ADDR", "localhost")
    clean_env.setenv("WORLD_SIZE", "0")
    with pytest.raises(ValueError, match="positive"):
        dist.initialize(device="cpu")


def _retry_env(monkeypatch, world="4"):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "9999")
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setenv("RANK", "1")


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_initialize_retries_until_rendezvous_appears(clean_env):
    _retry_env(clean_env)
    clock = _FakeClock()
    calls, sleeps = [], []

    def connect(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise ConnectionError("connection refused")

    def sleep(s):
        sleeps.append(s)
        clock.sleep(s)

    assert dist.initialize(device="cpu", backoff_s=1.0, max_retries=5, deadline_s=300.0,
                           log=lambda *_: None, _connect=connect, _sleep=sleep,
                           _clock=clock) is True
    assert len(calls) == 3
    assert sleeps == [1.0, 2.0]  # exponential backoff
    assert calls[0]["init_method"] == "tcp://10.0.0.1:9999"
    assert calls[0]["world_size"] == 4 and calls[0]["rank"] == 1
    assert calls[0]["backend"] == "gloo" and "device_id" not in calls[0]


def test_initialize_exhaustion_is_actionable(clean_env):
    _retry_env(clean_env)
    clock = _FakeClock()

    def connect(**kw):
        raise TimeoutError("deadline exceeded")

    with pytest.raises(RuntimeError) as e:
        dist.initialize(device="cpu", backoff_s=1.0, max_retries=2, deadline_s=300.0,
                        log=lambda *_: None, _connect=connect, _sleep=clock.sleep,
                        _clock=clock)
    msg = str(e.value)
    assert "10.0.0.1:9999" in msg and "3 attempt(s)" in msg
    assert "MASTER_ADDR" in msg and "RANK" in msg and "WORLD_SIZE" in msg
    assert "DNN_TPU_COORDINATOR_DEADLINE_S" in msg and "TimeoutError" in msg


def test_initialize_deadline_cuts_retries(clean_env):
    _retry_env(clean_env)
    clock = _FakeClock()
    calls = []

    def connect(**kw):
        calls.append(kw)
        clock.sleep(40.0)  # each attempt burns 40 s of the fake clock
        raise ConnectionError("refused")

    with pytest.raises(RuntimeError, match="deadline 100"):
        dist.initialize(device="cpu", backoff_s=1.0, max_retries=50, deadline_s=100.0,
                        log=lambda *_: None, _connect=connect, _sleep=clock.sleep,
                        _clock=clock)
    assert len(calls) <= 3  # 100 s of deadline over 40 s attempts, not 50 retries


def test_initialize_passes_remaining_deadline_as_timeout(clean_env):
    _retry_env(clean_env)
    clock = _FakeClock()
    seen = []

    def connect(**kw):
        seen.append(kw["timeout"])
        clock.sleep(30.0)
        if len(seen) < 2:
            raise ConnectionError("refused")

    assert dist.initialize(device="cpu", backoff_s=2.0, max_retries=3, deadline_s=120.0,
                           log=lambda *_: None, _connect=connect, _sleep=clock.sleep,
                           _clock=clock) is True
    assert seen[0] == datetime.timedelta(seconds=120)
    assert seen[1] < seen[0]  # shrinks with the elapsed clock


def test_initialize_retry_env_defaults(clean_env):
    _retry_env(clean_env)
    clean_env.setenv("DNN_TPU_COORDINATOR_RETRIES", "0")
    clean_env.setenv("DNN_TPU_COORDINATOR_DEADLINE_S", "50")
    clock = _FakeClock()
    calls = []

    def connect(**kw):
        calls.append(kw)
        raise ConnectionError("refused")

    with pytest.raises(RuntimeError, match="retry budget 0"):
        dist.initialize(device="cpu", log=lambda *_: None, _connect=connect,
                        _sleep=clock.sleep, _clock=clock)
    assert len(calls) == 1  # zero retries = exactly one attempt
    assert calls[0]["timeout"] == datetime.timedelta(seconds=50)


@pytest.mark.parametrize("local_world,cards,backend,device1", [
    ("2", 1, "gloo", "cuda:0"),  # two ranks share the one card
    ("2", 2, "nccl", "cuda:1"),  # a card each
    ("4", 2, "gloo", "cuda:1"),
])
def test_backend_and_device_follow_the_cards(clean_env, local_world, cards, backend, device1):
    clean_env.setenv("LOCAL_WORLD_SIZE", local_world)
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist.backend_for("cpu") == "gloo" and dist.rank_device("cpu").type == "cpu"
    assert dist.backend_for("cuda") == backend
    assert str(dist.rank_device("cuda")) == device1
    # what initialize hands to init_process_group on the card
    _retry_env(clean_env, world=local_world)
    clean_env.setattr(torch.cuda, "set_device", lambda d: None)
    calls = []
    assert dist.initialize(device="cuda", log=lambda *_: None,
                           _connect=lambda **kw: calls.append(kw)) is True
    assert calls[0]["backend"] == backend
    assert (calls[0].get("device_id") == torch.device(device1)) == (backend == "nccl")


def test_workers_must_split_evenly_over_the_ranks():
    g = ReplicaGroup(8, torch.device("cpu"), rank=2, world=4, joined=True)
    assert (g.local, g.first, list(g.workers)) == (2, 4, [4, 5])


# ------------------------------------------------------- across processes

SIZE, TEST_SIZE, SEED, LR = 256, 64, 1, 0.05
CASES = [(r, s, "hbm") for r in ("data_parallel", "replication") for s in ("epoch", "step")]
CASES.append(("data_parallel", "epoch", "stream"))
# the step sync in leaf buckets of at most 10 KB a replica (several buckets)
CASES.append(("data_parallel", "step", "hbm", "overlap"))
ENV = {"OMP_NUM_THREADS": "1"}


def _config(regime, sync_mode, input_mode, grad_sync="end"):
    return dict(lr=LR, momentum=0.9, batch_size=8, epochs=2, nb_proc=4, regime=regime,
                sync_mode=sync_mode, seed=SEED, kernels="cuda", input_mode=input_mode,
                grad_sync=grad_sync, bucket_mb=0.01)


def _name(case):
    return "_".join(case)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at world 2 (2 ranks x 2 workers) and in one process
    (4 workers, no group), and the sync check at world 2 and world 4."""
    spec_runs = [{"name": _name(c), "config": _config(*c), "train": {"size": SIZE, "seed": 3},
                  "test": {"size": TEST_SIZE, "seed": 3}} for c in CASES]
    out = {}
    for label in ("w2", "w1", "w4"):
        out[label] = tmp_path_factory.mktemp(label)
    from concurrent.futures import ThreadPoolExecutor

    sync = {"n": 4, "p": 5000, "seed": 0}
    jobs = {"w2": (2, {"device": "cpu", "out": str(out["w2"]), "sync": sync, "runs": spec_runs},
                   True),
            "w1": (1, {"device": "cpu", "out": str(out["w1"]), "runs": spec_runs}, False),
            "w4": (4, {"device": "cpu", "out": str(out["w4"]), "sync": sync}, True)}
    with ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(launch, w, spec, timeout=150, joined=j, env=ENV)
                   for k, (w, spec, j) in jobs.items()}
        done = {k: f.result() for k, f in futures.items()}
    for label, procs in done.items():
        for p in procs:
            assert p.returncode == 0, f"{label}: {p.stderr[-3000:]}"
    return out


def _load(d, case, rank):
    h = json.loads((d / f"{_name(case)}_rank{rank}.json").read_text())
    return h, dict(np.load(d / f"{_name(case)}_rank{rank}.npz"))


@pytest.mark.parametrize("world", [2, 4])
def test_gathered_sync_is_bitwise_the_in_process_sync(runs, world):
    for rank in range(world):
        got = json.loads((runs[f"w{world}"] / f"sync_rank{rank}.json").read_text())
        assert got == {"bitwise": [True] * 5, "world": world, "local": 4 // world}


def _tree(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            layer, leaf = k[len(prefix) + 1:].split("/")
            tree.setdefault(layer, {})[leaf] = v
    return tree


def step_trajectory(params0, images, labels, *, n_workers, batch_size, epochs, lr, momentum,
                    orders, regime):
    """The numpy oracle of `sync_mode="step"`: every worker takes each step
    with the mean of the workers' gradients (all workers stay equal), with
    the momentum reset per epoch; float64, on tests/oracle_numpy.py's
    forward and backward."""
    images = np.asarray(images, np.float64)
    params = O.to_f64(params0)
    p = len(images) // n_workers if regime == "data_parallel" else len(images)
    lo = [d * p if regime == "data_parallel" else 0 for d in range(n_workers)]
    steps = -(-p // batch_size)
    history = []
    for e in range(epochs):
        mom = O._tree_map(np.zeros_like, params)
        loss_sum = 0.0
        plans = []
        for d in range(n_workers):
            order = np.asarray(orders[e][d], np.int64)
            pad = steps * batch_size - p
            plans.append((np.concatenate([order, np.zeros(pad, np.int64)]) + lo[d],
                          np.concatenate([np.ones(p), np.zeros(pad)])))
        for s in range(steps):
            rows = slice(s * batch_size, (s + 1) * batch_size)
            results = [O.batch_loss_and_grads(params, images[i[rows]], labels[i[rows]], w[rows])
                       for i, w in plans]
            grads = O._tree_map(lambda *g: sum(g) / n_workers, *[g for _, g in results])
            mom = O._tree_map(lambda m, g: momentum * m + g, mom, grads)
            params = O._tree_map(lambda q, m: q - lr * m, params, mom)
            loss_sum += sum(loss for loss, _ in results)
        history.append({"params": params, "train_loss": loss_sum / (n_workers * steps)})
    return history


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_engine_across_processes(runs, case):
    regime, sync_mode, input_mode = case[:3]
    ref_hist, ref = _load(runs["w1"], case, 0)
    ranks = [_load(runs["w2"], case, r) for r in range(2)]
    for r, (hist, flat) in enumerate(ranks):
        assert hist["world"] == 2 and hist["workers"] == [2 * r, 2 * r + 1]
        assert hist["backend"] == "gloo" and not hist["captured"]
        # every rank's metrics, and bit for bit the one-process run's
        assert hist["history"] == ref_hist["history"]
        assert all(np.array_equal(flat[k], ref[k]) for k in ref), r
    assert ref_hist["world"] == 1 and ref_hist["backend"] is None
    # the numpy oracle with the port's orders
    split = load_split(True, source="synthetic", synthetic_size=SIZE, seed=3)
    rows = SIZE // 4 if regime == "data_parallel" else SIZE
    if input_mode == "stream":
        orders = [[np.random.default_rng((SEED, e, d)).permutation(rows) for d in range(4)]
                  for e in range(2)]
    else:
        orders = [[torch.randperm(rows, generator=shuffle_generator(SEED, e, d)).numpy()
                   for d in range(4)] for e in range(2)]
    oracle = step_trajectory if sync_mode == "step" else O.reference_trajectory
    want = oracle(_tree(ref, "params0"), split.images, split.labels, n_workers=4,
                  batch_size=8, epochs=2, lr=LR, momentum=0.9, orders=orders, regime=regime)
    for e in range(2):
        assert abs(ref_hist["history"][e]["train_loss"] - want[e]["train_loss"]) < 5e-4, e
    final = _tree(ref, "params")
    rel = max(float(np.max(np.abs(final[l][k] - want[-1]["params"][l][k])
                           / (np.abs(want[-1]["params"][l][k]) + 1e-3)))
              for l in final for k in final[l])
    assert rel < 2e-3


def test_step_sync_in_buckets_across_ranks_is_bitwise_end(runs):
    """--sync-mode step --grad-sync overlap on 2 ranks x 2 workers (one
    gather per bucket, each its own collective) is the end run bit for bit."""
    end, over = ("data_parallel", "step", "hbm"), ("data_parallel", "step", "hbm", "overlap")
    for r in range(2):
        (h_end, p_end), (h_over, p_over) = _load(runs["w2"], end, r), _load(runs["w2"], over, r)
        assert h_over["history"] == h_end["history"]
        assert all(np.array_equal(p_over[k], p_end[k]) for k in p_end)


def test_cli_under_torchrun(tmp_path):
    """Two ranks through the user's entry point: the backend printed, both
    SUMMARY lines' metrics equal, rank 1's files under _rank1 names."""
    env = dict(os.environ, **ENV)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    for k in ENV_VARS:
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "distributed_neural_network_tpu_torch.train.cli", "--device", "cpu",
           "--nb-proc", "4", "--synthetic-size", "128", "--epochs", "2", "--lr", "0.05",
           "--batch-size", "8", "--log-dir", str(tmp_path / "log"),
           "--metrics-jsonl", str(tmp_path / "m.jsonl")]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    # each line whole: the ranks share one stdout, and no rank's line may
    # land inside another's
    assert sum(l.count("SUMMARY ") for l in lines) == 2
    assert sum(l.count("Starting epoch") for l in lines) == 4
    assert lines.count("Starting epoch  0") == lines.count("Starting epoch  1") == 2
    for r in range(2):
        assert f"(Multi-process: rank {r}/2, backend gloo, device cpu)" in lines
    summaries = [json.loads(l[len("SUMMARY "):]) for l in lines if l.startswith("SUMMARY ")]
    assert sorted(s["rank"] for s in summaries) == [0, 1]
    keys = ("final_train_loss", "final_val_acc", "best_val_acc", "world")
    assert [summaries[0][k] for k in keys] == [summaries[1][k] for k in keys]
    assert summaries[0]["world"] == 2
    files = sorted(os.listdir(tmp_path / "log"))
    assert files == sorted(f"bs8_log_epochs2_proc4_{role}{suffix}.txt"
                           for role in ("parent", "children") for suffix in ("", "_rank1"))
    for name in ("m.jsonl", "m_rank1.jsonl"):
        series = [json.loads(l)["series"] for l in (tmp_path / name).read_text().splitlines()]
        assert series.count("train/loss") == 2
