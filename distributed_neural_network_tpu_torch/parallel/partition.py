"""Row partitions of a split over workers and the check of partition specs
(counterpart of the JAX package's `parallel/partition.py`).

- The shard helpers: contiguous 1/N shards with the remainder dropped, or
  the full split for every worker.
- `PartitionSpec`: the port's own spec type, since it may not import
  `jax.sharding.PartitionSpec`: a tuple of per-dimension entries, each
  ``None`` (not sharded), a mesh axis name, or a tuple of names. Its repr is
  JAX's, so the error texts read the same.
- `validate_partition_spec` / `validate_spec_tree`: a spec that names an
  axis the mesh lacks, uses an axis twice, is longer than the array's rank
  or shards a dim unevenly raises `ValueError` naming the leaf, with the
  JAX package's texts. Trees are nested dicts / lists (`utils/tree.py`),
  paths are written as `jax.tree_util.keystr` writes them (``['layers']['wq']``).
"""

from __future__ import annotations

import numpy as np

from ..utils.tree import is_node


class PartitionSpec(tuple):
    """Per-dimension sharding of one array: ``PartitionSpec(None, "data")``
    shards dim 1 over the mesh axis ``data``; trailing dims left out are not
    sharded, and ``PartitionSpec()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({tuple.__repr__(self)[1:-1]})"

    __str__ = __repr__


P = PartitionSpec


def spec_axes(spec) -> tuple:
    """The mesh axis names a spec shards over, in order."""
    return tuple(a for entry in spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else tuple(entry)))


def validate_partition_spec(spec, mesh_axes, *, shape=None, name="array"):
    """Check one spec against a mesh's axes (``mesh_axes``: axis name ->
    size) and, when ``shape`` is given, against the array's rank and the
    divisibility of every sharded dim; raises `ValueError` naming the bad
    axis, the leaf and the axes the mesh has. Specs shorter than the rank
    are valid (trailing dims unsharded)."""
    entries = tuple(spec)
    available = tuple(mesh_axes)
    seen = []
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in mesh_axes:
                raise ValueError(
                    f"PartitionSpec for {name} names mesh axis {a!r} (dim {d} of {spec}), "
                    f"but the mesh only has axes {available} - fix the spec or build the "
                    "mesh with that axis")
            if a in seen:
                raise ValueError(
                    f"PartitionSpec for {name} uses mesh axis {a!r} twice ({spec}): each "
                    "mesh axis may shard at most one dim of one array")
            seen.append(a)
    if shape is None:
        return
    if len(entries) > len(shape):
        raise ValueError(
            f"PartitionSpec for {name} has {len(entries)} entries ({spec}) but the array "
            f"has rank {len(shape)} (shape {tuple(shape)}); specs may be shorter than the "
            "rank, never longer")
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in axes:
            n *= int(mesh_axes[a])
        if n > 0 and shape[d] % n:
            raise ValueError(
                f"PartitionSpec for {name} shards dim {d} (size {shape[d]}) over {axes} "
                f"(total {n} shards), which does not divide evenly - pad the dim or change "
                "the spec")


def _spec_paths(tree, keys=()):
    """[(keys, spec)] over a spec tree: each spec with the dict keys and
    sequence indices that lead to it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_paths(tree[k], keys + (k,))]
    if is_node(tree):
        return [x for i, t in enumerate(tree) for x in _spec_paths(t, keys + (i,))]
    return [(keys, tree)]


def keystr(keys) -> str:
    """A path as `jax.tree_util.keystr` writes it: ``['layers']['wq']``, ``[0]``."""
    return "".join(f"[{k!r}]" for k in keys)


def _subtree(tree, keys):
    """The node of `tree` at `keys` (None where it has none)."""
    for k in keys:
        if isinstance(tree, dict):
            tree = tree.get(k)
        elif is_node(tree) and isinstance(k, int) and k < len(tree):
            tree = tree[k]
        else:
            return None
    return tree


def _shapes_under(arr):
    """The shapes a spec covers: one array, a shape tuple, or every array
    leaf under a subtree (a spec may stand for a whole subtree)."""
    if arr is None:
        return [None]
    if hasattr(arr, "shape"):
        return [tuple(arr.shape)]
    if isinstance(arr, tuple) and all(isinstance(i, int) for i in arr):
        return [arr]
    from ..utils.tree import tree_leaves

    return [tuple(x.shape) for x in tree_leaves(arr) if hasattr(x, "shape")] or [None]


def validate_spec_tree(specs, mesh_axes, *, shapes=None, root="params"):
    """`validate_partition_spec` over a tree of specs (and, when given, the
    leaf-aligned tree of arrays or shapes), naming each failing leaf by its
    path."""
    for keys, spec in _spec_paths(specs):
        arr = _subtree(shapes, keys) if shapes is not None else None
        for shape in _shapes_under(arr):
            validate_partition_spec(spec, mesh_axes, shape=shape, name=f"{root}{keystr(keys)}")


def shard_size(total: int, n_shards: int) -> int:
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    return total // n_shards


def shard_bounds(total: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) row bounds per shard; remainder dropped."""
    p = shard_size(total, n_shards)
    return [(d * p, (d + 1) * p) for d in range(n_shards)]


def shard_rows(total: int, n_shards: int) -> np.ndarray:
    """(n_shards, p) row-index matrix: row d is worker d's contiguous shard."""
    p = shard_size(total, n_shards)
    return np.arange(n_shards * p, dtype=np.int32).reshape(n_shards, p)


def replicated_rows(total: int, n_shards: int) -> np.ndarray:
    """(n_shards, total): every worker sees the full split."""
    return np.broadcast_to(
        np.arange(total, dtype=np.int32), (n_shards, total)
    ).copy()
