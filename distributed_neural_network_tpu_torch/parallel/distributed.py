"""Joining a process group (counterpart of the JAX package's
`parallel/distributed.py` `initialize`).

The reference runs ``mpiexec -n N`` and its parent gathers and averages the
workers' state dicts. The port runs one process per rank under
``python -m torch.distributed.run`` (torchrun) and joins them with
`torch.distributed`: `initialize()` reads torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), where the JAX package reads ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, and keeps its rules:

- no address and a world of at most 1: a single process, nothing to join;
- a partial configuration raises `ValueError` naming the missing variable;
- idempotent: a second call in a joined process returns True;
- bounded: up to ``max_retries`` + 1 attempts, backing off from
  ``backoff_s`` and doubling (capped at 30 s), all within ``deadline_s``;
  each attempt passes the deadline that remains as `init_process_group`'s
  ``timeout``. Defaults: ``DNN_TPU_COORDINATOR_RETRIES``,
  ``DNN_TPU_COORDINATOR_BACKOFF_S``, ``DNN_TPU_COORDINATOR_DEADLINE_S``, else
  5, 1 s and 300 s. Exhaustion raises a `RuntimeError` naming the address,
  the attempts and the variables to check.

The backend follows the device (`backend_for`): gloo on the CPU; on the card
NCCL when every local rank has a card of its own (rank r on
``cuda:LOCAL_RANK``), gloo when ranks share a card (as on a one-GPU machine:
NCCL refuses two ranks on one GPU). The CLI prints the choice.

`shrink_group` re-forms the default group over its first ranks, the
survivors of an elastic shrink (`lm_train.py --chaos-shrink-at-step`): JAX
drops devices and keeps its process, a torchrun rank is a process, so the
others leave.

`create_hybrid_mesh` is the JAX package's DCN x ICI mesh as a rank layout
(`RankMesh`): its outer ("dcn") axes cross hosts, its inner ("ici") axes
stay within one host, ranks grouped by host as JAX groups devices by
``slice_index``; on one host it is the flat rank order. A layout, not a
launcher: no entry point takes it (none does in JAX either).

`distribute_host_data` is the rank's share of a host batch on the mesh:
the contiguous block of B/dp rows (and, with a sequence axis, of S/sp
columns) that the JAX package's ``P("data", "seq")`` sharding gives the
rank's device, from a full copy of the batch or from this rank's block
alone.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_COORDINATOR_RETRIES = 5
DEFAULT_COORDINATOR_DEADLINE_S = 300.0
DEFAULT_COORDINATOR_BACKOFF_S = 1.0
_BACKOFF_CAP_S = 30.0


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def joined() -> bool:
    """True in a process that belongs to a torch.distributed group."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> tuple[int, int]:
    """(LOCAL_RANK, LOCAL_WORLD_SIZE) from torchrun's environment; a
    process started without them is rank 0 of 1 on its host."""
    world = _env_int("LOCAL_WORLD_SIZE") or _env_int("WORLD_SIZE") or 1
    return _env_int("LOCAL_RANK") or 0, world


def backend_for(device: str | torch.device) -> str:
    """gloo on the CPU; on the card NCCL when each local rank has a card
    of its own, else gloo (ranks that share a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    _, local_world = local_rank()
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: the CPU as asked, or its own card
    (``cuda:LOCAL_RANK``), or with more local ranks than cards the card
    ``LOCAL_RANK`` mod the count (on one GPU: ``cuda:0`` for every rank)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank, _ = local_rank()
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def initialize(
    master_addr: str | None = None,
    master_port: int | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    device: str | torch.device = "cuda",
    max_retries: int | None = None,
    deadline_s: float | None = None,
    backoff_s: float | None = None,
    log=print,
    _connect=None,
    _sleep=time.sleep,
    _clock=time.monotonic,
) -> bool:
    """Join the process group; returns True if this process is in one.

    Explicit arguments win over torchrun's environment. Call it before
    anything touches the card: it picks this rank's card (`rank_device`)
    and the backend (`backend_for`). `_connect`, `_sleep` and `_clock` are
    test seams (`_connect` stands for `torch.distributed.init_process_group`).
    """
    if joined():
        return True
    addr = master_addr or os.environ.get("MASTER_ADDR")
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    port = master_port if master_port is not None else _env_int("MASTER_PORT")
    if addr is None:
        # a partial configuration fails loudly, never as N independent runs
        if world is not None and world > 1:
            raise ValueError(f"WORLD_SIZE={world} is set but MASTER_ADDR is not; set it to "
                             "rank 0's host (torchrun sets both)")
        return False
    if world is None:
        raise ValueError("MASTER_ADDR is set but WORLD_SIZE is not; set it to the number "
                         "of processes")
    if world <= 0:
        raise ValueError(f"WORLD_SIZE must be positive, got {world}")
    if world == 1:
        return False
    if rank is None:
        raise ValueError("MASTER_ADDR and WORLD_SIZE are set but RANK is not; set it to "
                         "this process's rank in [0, WORLD_SIZE)")
    if port is None:
        raise ValueError("MASTER_ADDR, WORLD_SIZE and RANK are set but MASTER_PORT is not; "
                         "set it to a free port on rank 0's host")
    dev = rank_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                  rank=rank)
    if backend == "nccl":
        kwargs["device_id"] = dev  # the communicator is built now, not at first use
    retries = (max_retries if max_retries is not None
               else _env_int("DNN_TPU_COORDINATOR_RETRIES"))
    _connect_with_retry(
        _connect if _connect is not None else dist.init_process_group, kwargs,
        addr=f"{addr}:{port}",
        max_retries=retries if retries is not None else DEFAULT_COORDINATOR_RETRIES,
        deadline_s=(deadline_s if deadline_s is not None else _env_float(
            "DNN_TPU_COORDINATOR_DEADLINE_S", DEFAULT_COORDINATOR_DEADLINE_S)),
        backoff_s=(backoff_s if backoff_s is not None else _env_float(
            "DNN_TPU_COORDINATOR_BACKOFF_S", DEFAULT_COORDINATOR_BACKOFF_S)),
        log=log, sleep=_sleep, clock=_clock,
    )
    return True


def shrink_group(n: int, *, device, timeout_s: float = DEFAULT_COORDINATOR_DEADLINE_S) -> bool:
    """Re-form the process group over its first `n` ranks (the survivors of
    an elastic shrink); True on a survivor, False on a rank that left.

    Every rank of the old group calls it at the same point. Rank 0 opens a
    fresh `TCPStore` on the rendezvous host (``MASTER_ADDR``, as torchrun
    sets it; else this host) and broadcasts its port over
    the old group; then every rank destroys the old group (and every group
    made in it: the mesh's axis groups, the preemption flag's gloo twin),
    and the survivors join a new default group of `n` ranks through that
    store, on the old backend, each keeping its rank and card. So every
    later collective - the mesh's groups (`parallel/mesh.py`
    `make_axis_groups`), the checkpoint's barrier, the preemption
    agreement, `collective_form` - runs over the survivors alone, and no
    rank calls a collective of the old group after this. At `n` 1 the one
    survivor leaves the group and runs as a single process. Under NCCL the
    CUDA graphs that captured the old groups' collectives must be freed
    before the call."""
    rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    if not 1 <= n < world:
        raise ValueError(f"a shrink keeps 1 to {world - 1} of the {world} ranks, not {n}")
    addr = os.environ.get("MASTER_ADDR") or "localhost"
    timeout = datetime.timedelta(seconds=timeout_s)
    store = None
    if rank == 0 and n > 1:
        store = dist.TCPStore(addr, 0, n, is_master=True, wait_for_workers=False,
                              timeout=timeout)
    port = torch.tensor([store.port if store is not None else 0], dtype=torch.int64,
                        device=device if backend == "nccl" else "cpu")
    dist.broadcast(port, src=0)
    port = int(port.item())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dist.destroy_process_group()
    if rank >= n:
        return False
    if n > 1:
        if store is None:
            store = dist.TCPStore(addr, port, n, is_master=False, timeout=timeout)
        kwargs = dict(backend=backend, store=store, rank=rank, world_size=n, timeout=timeout)
        if backend == "nccl":
            kwargs["device_id"] = torch.device(device)
        dist.init_process_group(**kwargs)
    return True


def _connect_with_retry(connect, kwargs, *, addr, max_retries, deadline_s, backoff_s, log,
                        sleep, clock) -> int:
    """Call `connect(**kwargs, timeout=<the deadline that remains>)` until it
    returns, backing off between failures; returns the attempt that
    succeeded or raises an actionable RuntimeError."""
    start = clock()
    attempt = 0
    last = None
    while True:
        attempt += 1
        remaining = deadline_s - (clock() - start)
        if remaining <= 0:
            break
        try:
            connect(**kwargs, timeout=datetime.timedelta(seconds=max(int(remaining), 1)))
            return attempt
        except Exception as e:  # noqa: BLE001 - retrying is the handling
            last = e
            if attempt > max_retries:
                break
            remaining = deadline_s - (clock() - start)
            if remaining <= 0:
                break
            pause = min(backoff_s * (2 ** (attempt - 1)), _BACKOFF_CAP_S, remaining)
            log(f"(rendezvous attempt {attempt}/{max_retries + 1} failed: "
                f"{type(e).__name__}: {e}; retrying in {pause:.1f}s)")
            sleep(pause)
    raise RuntimeError(
        f"could not join the process group at {addr} after {attempt} attempt(s) over "
        f"{clock() - start:.1f}s (deadline {deadline_s:g}s, retry budget {max_retries}). "
        "Check that rank 0 is up and that MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK "
        "match on every process; raise DNN_TPU_COORDINATOR_DEADLINE_S or "
        "DNN_TPU_COORDINATOR_RETRIES for slow starts. Last error: "
        f"{type(last).__name__ if last is not None else None}: {last}"
    ) from last


@dataclass(frozen=True)
class RankMesh:
    """Named axes over process ranks: ``ranks`` (*sizes) holds the rank at
    each coordinate (the JAX `Mesh`'s device array, ranks for devices)."""

    axis_names: tuple
    ranks: np.ndarray

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))


def _rank_hosts() -> list:
    """Each rank's host name, in rank order (this process alone off a group)."""
    if not joined():
        return [socket.gethostname()]
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts


def create_hybrid_mesh(ici_axes: dict, dcn_axes: dict | None = None, *,
                       ranks=None) -> RankMesh:
    """Mesh with the DCN axes outermost and the ICI axes inner (the JAX
    `create_hybrid_mesh`): the layout's axis order is (*dcn, *ici), so
    per-step collectives (put their axes in ``ici_axes``) stay within a
    host and low-frequency ones cross hosts. ``ranks`` (default: the
    process group's, or this process alone) are the ranks to lay out, each
    on the host its process reports; on one host the flat rank order is
    used."""
    dcn_axes = dcn_axes or {}
    names = (*dcn_axes, *ici_axes)
    sizes = (*dcn_axes.values(), *ici_axes.values())
    if any(s <= 0 for s in sizes):
        raise ValueError(f"axis sizes must be positive: {dict(zip(names, sizes))}")
    if ranks is None:
        ranks = list(range(dist.get_world_size() if joined() else 1))
    ranks = list(ranks)
    total = int(np.prod(sizes))
    if total > len(ranks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} ranks, have "
                         f"{len(ranks)}")
    every = _rank_hosts() if joined() else None
    hosts = [every[r] for r in ranks] if every else [0] * len(ranks)
    arr = _hybrid_rank_array(ranks, hosts, tuple(dcn_axes.values()),
                             tuple(ici_axes.values()))
    return RankMesh(names, arr)


def _hybrid_rank_array(ranks, hosts, dcn_sizes: tuple, ici_sizes: tuple) -> np.ndarray:
    """(*dcn, *ici)-shaped rank array with host boundaries on the dcn axes
    (the JAX `_hybrid_device_array`, hosts for slices). Across hosts the
    ranks are grouped by host (in order of first appearance); the dcn axes
    must cover the host count exactly and each host gives its first
    ici-total ranks, so every dcn hop crosses hosts and every ici hop stays
    inside one. One host: the flat rank order."""
    dcn_total = int(np.prod(dcn_sizes)) if dcn_sizes else 1
    ici_total = int(np.prod(ici_sizes)) if ici_sizes else 1
    shape = (*dcn_sizes, *ici_sizes)
    groups: dict = {}
    for r, h in zip(ranks, hosts):
        groups.setdefault(h, []).append(r)
    if len(groups) <= 1:
        return np.asarray(ranks[: dcn_total * ici_total]).reshape(shape)
    if len(groups) != dcn_total:
        raise ValueError(
            f"dcn axes {dcn_sizes} multiply to {dcn_total} but {len(groups)} hosts are present "
            "(host count mismatch): the dcn axes must exactly cover the hosts, or pass an "
            "explicit `ranks=` subset to deliberately leave hosts idle")
    ordered = []
    for h, g in groups.items():
        if len(g) < ici_total:
            raise ValueError(f"host {h} has {len(g)} ranks, ici axes {ici_sizes} need "
                             f"{ici_total} (uneven hosts cannot form this mesh)")
        ordered.append(np.asarray(g[:ici_total]).reshape(ici_sizes))
    return np.stack(ordered).reshape(shape)


def distribute_host_data(host_array, mesh, *, full_copy: bool = True, device=None,
                         rows: bool = True):
    """This rank's block of a host batch on `mesh`, as a tensor on `device`
    (default the mesh's). ``full_copy=True``: `host_array` is the whole
    batch (B, S, ...), the same on every rank, and the rank at data index d
    takes rows ``[d*B/dp, (d+1)*B/dp)`` and, with a sequence axis, at seq
    index s the columns ``[s*S/sp, (s+1)*S/sp)`` (``rows=False``: every row,
    the columns only, as an eval batch); ``full_copy=False``: it is already
    this rank's block. B must divide by dp, S by sp."""
    x = host_array if isinstance(host_array, torch.Tensor) else torch.from_numpy(
        np.array(host_array))
    sp = mesh.sp
    dev = mesh.device if device is None else torch.device(device)
    if full_copy:
        d, s, _ = mesh.coords
        if rows:
            dp = mesh.dp
            if x.shape[0] % dp:
                raise ValueError(f"a batch of {x.shape[0]} rows does not split evenly over "
                                 f"the data axis of {dp} ranks; make --batch-size a multiple "
                                 "of --dp")
            b = x.shape[0] // dp
            x = x[d * b:(d + 1) * b]
        if sp > 1:
            if x.shape[1] % sp:
                raise ValueError(f"a sequence of {x.shape[1]} does not split evenly over the "
                                 f"sequence axis of {sp} ranks; make --seq-len a multiple of "
                                 "--sp")
            c = x.shape[1] // sp
            x = x[:, s * c:(s + 1) * c]
    return x.to(dev)
