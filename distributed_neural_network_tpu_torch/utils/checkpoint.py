"""Checkpoint and resume (the port of the JAX package's `utils/checkpoint.py`).

The reference persisted nothing: the parent's averaged state at an epoch
edge (`data_parallelism_train.py:244`) was lost when the process exited.
Here the state is written at a configurable interval with retention and
resume from the newest valid checkpoint:

- `Checkpointer`: the CNN engine's sync-boundary state (the averaged
  parameters, every worker's momentum, the metric history), at epoch
  edges (`maybe_save(epoch, engine)`, `restore_latest(engine)`);
- `TreeCheckpointer`: any tree plus JSON meta (the LM trainer's parameters
  and optimizer state, `lm_train.py`).

The on-disk form is the JAX package's ``npz`` backend, byte for byte in
its layout: ``step_{N}/state.npz`` holding ``leaf_{i}`` in `jax.tree.leaves`
order (nested dict keys sorted, `utils/tree.py`) plus ``meta.json``,
written into ``step_{N}.tmp`` and renamed into place, the last ``keep``
steps kept, stale ``.tmp`` directories swept at start. So a JAX checkpoint
resumes in the port and a port checkpoint in the JAX package. A bf16 leaf
is written as the JAX backend writes one, two raw bytes an element (numpy
``V2``), and read back as bf16. The JAX package's other backend, orbax,
is not available to the port (no orbax on the card's machine): ``auto``
picks ``npz`` and ``orbax`` raises the JAX text. That is a backend
difference, not a fault.

Leaves come as torch tensors (any device) or numpy arrays and are written
from host copies. In a process group the callers hand every rank the whole
tree (the CNN engine gathers its momentum rows, the LM trainer its shards);
rank 0 writes and every rank then waits at a barrier. Restore validates
the leaf count, each shape and dtype against a template, naming the leaf's
path on a mismatch, and falls back past a corrupt newest checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time

import numpy as np

from .tree import is_node, tree_leaves, tree_unflatten

BF16_STORAGE = np.dtype("V2")  # how the JAX npz backend stores a bf16 leaf


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _is_writer_rank() -> bool:
    """Rank 0 of the process group, or the one process: the one that
    touches the checkpoint directory."""
    import torch.distributed as dist

    return not _joined() or dist.get_rank() == 0


def _barrier() -> None:
    """Every rank waits until rank 0 has written (nothing off a group)."""
    if _joined():
        import torch.distributed as dist

        dist.barrier()


def host_leaf(x) -> np.ndarray:
    """One leaf as a host numpy array: a torch tensor copied off its device
    (bf16 as its raw two bytes an element, the JAX npz form), anything else
    through `np.asarray`."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(BF16_STORAGE)
        return x.cpu().numpy().copy()
    return np.asarray(x)


def tree_nbytes(leaves) -> int:
    """The bytes a checkpoint of these leaves holds (a bf16 leaf two an
    element, as `host_leaf` stores it), read off the leaves without a copy:
    the ranks that do not write count their save by it."""
    return sum(int(x.nbytes) if hasattr(x, "nbytes") else np.asarray(x).nbytes
               for x in leaves)


def _template_dtype(ref) -> np.dtype:
    """The numpy dtype a leaf of the template's is stored as."""
    import torch

    if isinstance(ref, torch.Tensor):
        if ref.dtype == torch.bfloat16:
            return BF16_STORAGE
        return torch.empty(0, dtype=ref.dtype).numpy().dtype
    dt = getattr(ref, "dtype", None)
    return np.dtype(dt if dt is not None else np.asarray(ref).dtype)


def to_torch(leaf: np.ndarray):
    """A stored leaf as a CPU tensor (a ``V2`` leaf as bf16)."""
    import torch

    if leaf.dtype == BF16_STORAGE:
        return torch.from_numpy(np.ascontiguousarray(leaf).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(leaf))


def tree_paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path as `jax.tree_util.keystr` writes it
    (``['params']['conv1']['kernel']``), in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if is_node(tree):
        return [p for i, x in enumerate(tree) for p in tree_paths(x, f"{prefix}[{i}]")]
    return [prefix]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A template leaf by shape and dtype only (the JAX `ShapeDtypeStruct`)."""

    shape: tuple
    dtype: np.dtype


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed validation against the restore template (missing
    files, wrong leaf count, shape/dtype mismatch, unreadable archive).
    `restore_latest` catches this and falls back to the previous step."""

    def __init__(self, step: int, detail: str):
        super().__init__(
            f"corrupt/truncated checkpoint (step {step}): {detail}"
        )
        self.step = step


class _NpzBackend:
    """One `step_{N}/state.npz` + `meta.json` per checkpoint, keep-last-K."""

    _STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep: int):
        self.dir = os.path.abspath(directory)
        self.keep = keep
        if _is_writer_rank():
            os.makedirs(self.dir, exist_ok=True)
            # sweep stale step_*.tmp staging dirs: a crash between the tmp
            # write and the atomic rename leaves one behind, which nothing
            # else would ever remove
            for name in os.listdir(self.dir):
                if self._STEP_RE.match(name[:-4]) and name.endswith(".tmp"):
                    shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}")

    def save(self, step: int, leaves, meta: dict) -> None:
        """Write `leaves` (host arrays in tree order) and `meta` as `step`."""
        d = self._step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(
            os.path.join(tmp, "state.npz"),
            **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
        )
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.rename(tmp, d)  # atomic publish: partial writes never look live
        if self.keep > 0:
            for old in self.all_steps()[: -self.keep]:
                shutil.rmtree(self._step_dir(old))

    def all_steps(self):
        if not os.path.isdir(self.dir):
            return []
        steps = []
        for name in os.listdir(self.dir):
            m = self._STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_meta(self, step: int) -> dict:
        """Only the JSON meta of one step (no array reads)."""
        try:
            with open(os.path.join(self._step_dir(step), "meta.json")) as f:
                return json.load(f)
        except Exception as e:
            raise CheckpointCorruptError(
                step, f"{type(e).__name__}: {e}"
            ) from e

    def restore(self, step: int, template=None):
        """(tree of numpy leaves shaped as `template`, or the list of stored
        leaves without one; meta). With a template the leaf count, every
        shape and every dtype are checked as each leaf is read, and a
        mismatch raises `CheckpointCorruptError` naming the leaf's path."""
        d = self._step_dir(step)
        try:
            z = np.load(os.path.join(d, "state.npz"))
        except Exception as e:  # unreadable zip, missing file
            raise CheckpointCorruptError(
                step, f"{type(e).__name__}: {e}"
            ) from e
        with z:
            meta = self.load_meta(step)
            n_stored = len(z.files)
            if template is None:
                try:
                    leaves = [z[f"leaf_{i}"] for i in range(n_stored)]
                except Exception as e:
                    raise CheckpointCorruptError(
                        step, f"{type(e).__name__}: {e}"
                    ) from e
                return leaves, meta
            refs = tree_leaves(template)
            if n_stored != len(refs):
                raise CheckpointCorruptError(
                    step,
                    f"{n_stored} stored leaves, template has {len(refs)} - "
                    "truncated archive or a different model/optimizer "
                    "layout",
                )
            leaves = []
            for i, (path, ref) in enumerate(zip(tree_paths(template), refs)):
                name = path or f"leaf_{i}"
                try:
                    got = z[f"leaf_{i}"]
                except Exception as e:
                    raise CheckpointCorruptError(
                        step, f"{name}: {type(e).__name__}: {e}"
                    ) from e
                ref_shape = tuple(getattr(ref, "shape", np.shape(ref)))
                if tuple(got.shape) != ref_shape:
                    raise CheckpointCorruptError(
                        step,
                        f"{name} shape {tuple(got.shape)} != template "
                        f"{ref_shape}",
                    )
                ref_dt = _template_dtype(ref)
                if np.dtype(got.dtype) != ref_dt:
                    raise CheckpointCorruptError(
                        step,
                        f"{name} dtype {got.dtype} != template {ref_dt}",
                    )
                leaves.append(got)
        return tree_unflatten(template, leaves), meta

    def close(self) -> None:
        pass


def _make_backend(backend: str, directory: str, keep: int):
    """Backend selection for both checkpointers: ``auto`` is ``npz`` here
    (the port has no orbax); ``orbax`` raises the JAX package's text."""
    if backend == "auto":
        backend = "npz"
    if backend == "orbax":
        raise RuntimeError("orbax backend requested but orbax is not importable")
    return backend, _NpzBackend(directory, keep)


class _CkptMetrics:
    """Live metrics of both checkpointers (`utils/obs.py`; registry=None is
    a no-op): saves, the last save's time (what a staleness watchdog ages
    against) and its step."""

    def __init__(self, registry=None):
        if registry is None:
            from .obs import NULL_REGISTRY

            registry = NULL_REGISTRY
        self.saves = registry.counter(
            "checkpoint_saves_total", "Checkpoints written this run"
        )
        self.last_save = registry.gauge(
            "checkpoint_last_save_timestamp_seconds",
            "Unix time of the newest checkpoint save",
        )
        self.last_step = registry.gauge(
            "checkpoint_last_step", "Step/epoch of the newest checkpoint"
        )

    def saved(self, step: int) -> None:
        self.saves.inc()
        self.last_save.set(time.time())
        self.last_step.set(int(step))


class TreeCheckpointer:
    """Save/restore a tree (nested dicts / lists of tensors or arrays) with
    JSON meta: the LM trainer's checkpointer. Every rank calls `save` with
    the whole tree; rank 0 writes."""

    def __init__(self, directory: str, *, keep: int = 3, backend: str = "auto",
                 registry=None):
        self.backend_name, self._b = _make_backend(backend, directory, keep)
        self._metrics = _CkptMetrics(registry)
        # (seconds, bytes) of the last save and restore, for the caller's report
        self.last_save = self.last_restore = None

    def save(self, step: int, state, meta: dict | None = None) -> None:
        from .goodput import ledger_interval

        # the whole save (host copies + write) blocks the step loop:
        # checkpoint_save badput on the goodput ledger
        t0 = time.perf_counter()
        leaves = tree_leaves(state)
        with ledger_interval("checkpoint_save"):
            if _is_writer_rank():
                self._b.save(step, [host_leaf(x) for x in leaves], meta or {})
            _barrier()
        self.last_save = (time.perf_counter() - t0, tree_nbytes(leaves))
        self._metrics.saved(step)

    def latest_step(self):
        return self._b.latest_step()

    def latest_meta(self, *, log=print):
        """(step, meta) of the newest checkpoint with readable meta, or None."""
        for step in reversed(self._b.all_steps()):
            try:
                return step, self._b.load_meta(step)
            except CheckpointCorruptError as e:
                log(f"(WARNING: {e}; falling back to the previous "
                    "checkpoint)")
        return None

    def restore_latest(self, template, *, log=print):
        """(state, meta, step) from the newest valid checkpoint, or None.

        `template` gives the tree's structure, shapes and dtypes (tensors,
        arrays or `LeafSpec`s); the state comes back as numpy leaves in its
        shape, for the caller to copy into its tensors. A newest
        checkpoint that fails validation is skipped with a warning and the
        previous one tried; only if every retained one is corrupt does the
        error propagate."""
        steps = self._b.all_steps()
        if not steps:
            return None
        last_err = None
        t0 = time.perf_counter()
        for step in reversed(steps):
            try:
                state, meta = self._b.restore(step, template)
            except CheckpointCorruptError as e:
                log(f"(WARNING: {e}; falling back to the previous "
                    "checkpoint)")
                last_err = e
                continue
            self.last_restore = (time.perf_counter() - t0,
                                 sum(x.nbytes for x in tree_leaves(state)))
            return state, meta, step
        raise last_err

    def close(self) -> None:
        self._b.close()


class Checkpointer:
    """Save/restore an Engine's sync-boundary state.

    `maybe_save(epoch, engine)` after each epoch; `restore_latest(engine)`
    before training to resume. The tree is `engine.state_tree()` (the JAX
    engine's form), so the checkpoint is portable between the packages
    and between the card and the CPU.
    """

    def __init__(self, directory: str, *, every: int = 1, keep: int = 3,
                 backend: str = "auto", registry=None):
        self.backend_name, self._b = _make_backend(backend, directory, keep)
        self._metrics = _CkptMetrics(registry)
        self.every = every
        self.last_save = self.last_restore = None

    # ------------------------------------------------------------------ save

    def maybe_save(self, epoch: int, engine) -> bool:
        if self.every <= 0 or (epoch + 1) % self.every != 0:
            return False
        self.save(epoch, engine)
        return True

    def save(self, epoch: int, engine) -> None:
        from ..train.guard import resume_cursor
        from .goodput import ledger_interval

        t0 = time.perf_counter()
        with ledger_interval("checkpoint_save"):
            leaves = tree_leaves(engine.state_tree())
            meta = {
                "epoch": epoch,
                "n_workers": engine.n_workers,
                "regime": engine.config.regime,
                "history": [dataclasses.asdict(m) for m in engine.history],
                # save-time topology: a restore into another worker count
                # is detected by name
                "mesh_meta": engine.mesh_meta(),
                # the exact-resume cursor: every shuffle and fault stream is
                # a function of (seed, epoch, worker)
                **resume_cursor(step=epoch, seed=engine.config.seed),
            }
            if _is_writer_rank():
                self._b.save(epoch, [host_leaf(x) for x in leaves], meta)
            _barrier()
        self.last_save = (time.perf_counter() - t0, tree_nbytes(leaves))
        self._metrics.saved(epoch)

    # --------------------------------------------------------------- restore

    def latest_epoch(self):
        return self._b.latest_step()

    def restore_latest(self, engine, *, log=print) -> int:
        """Load the newest valid checkpoint into `engine`; returns the next
        epoch to run (0 if no checkpoint exists). A corrupt newest
        checkpoint is skipped with a warning. A checkpoint of another worker
        count (validated against its own stack shape) or another regime
        raises, naming the fix."""
        steps = self._b.all_steps()
        if not steps:
            return 0
        state = meta = None
        last_err = None
        want = engine.state_tree()
        t0 = time.perf_counter()
        for step in reversed(steps):
            try:
                n_saved = int(self._b.load_meta(step).get("n_workers", engine.n_workers))
                template = want
                if n_saved != engine.n_workers:
                    # validate against the SAVED stack shape; the worker-count
                    # error comes after the meta checks below
                    template = {
                        "params": want["params"],
                        "mom": {k: {n: LeafSpec((n_saved, *m.shape[1:]), m.dtype)
                                    for n, m in v.items()}
                                for k, v in want["mom"].items()},
                    }
                state, meta = self._b.restore(step, template)
                break
            except CheckpointCorruptError as e:
                log(f"(WARNING: {e}; falling back to the previous "
                    "checkpoint)")
                last_err = e
        if meta is None:
            raise last_err
        if meta["n_workers"] != engine.n_workers:
            raise ValueError(
                f"checkpoint was written with "
                f"n_workers={meta['n_workers']}, engine has "
                f"{engine.n_workers} - momentum buffers don't map; "
                "pass elastic=True (CLI: --elastic) to reshard the "
                "momentum stack onto this worker count"
            )
        if meta["regime"] != engine.config.regime:
            raise ValueError(
                f"checkpoint regime mismatch: written by a {meta['regime']!r} "
                f"run, engine is {engine.config.regime!r} - resuming would "
                "silently change the data-placement policy mid-trajectory"
            )
        from ..train.engine import EpochMetrics
        from ..train.guard import check_cursor

        check_cursor(meta, seed=engine.config.seed, what="engine")
        engine.load_state_tree(state)
        engine.history = [EpochMetrics(**m) for m in meta["history"]]
        self.last_restore = (time.perf_counter() - t0,
                             sum(x.nbytes for x in tree_leaves(state)))
        return meta["epoch"] + 1

    def close(self) -> None:
        self._b.close()
