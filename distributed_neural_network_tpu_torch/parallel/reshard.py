"""Mesh-portable checkpoint resharding: load any saved layout onto any mesh
(the port of the JAX package's `parallel/reshard.py`, with its JSON keys,
error texts and bitwise host transforms).

A checkpoint of the port holds the whole tree (`train/lm.py`
`checkpoint_state`: every shard gathered, the ZeRO buffers padded for the
saved data-axis size), in the JAX package's layout. Three layers:

- **Topology metadata** (`mesh_topology`, `topology_mismatch`,
  `spec_tree_to_json` / `spec_tree_from_json`): every checkpoint records
  the mesh it was saved under (the axes and their sizes, the device (rank)
  and process counts, the optimizer's layout, the parameters' specs), so a
  restore into another layout is detected up front with a named
  difference.
- **Leaf-wise resharder** (`reshard_state`, `place_tree`,
  `convert_optimizer_state`): maps any saved layout onto any target mesh,
  on the host, in numpy. The ZeRO flat buffers are re-padded for the new
  data-axis size (`reshard_zero_tree`), the ZeRO-under-pp per-stage split
  is rebuilt (`pp_zero_tree_to_momentum` / `momentum_to_pp_zero_tree`),
  and optimizer state converts between the replicated and ZeRO layouts of
  one family (sgd <-> zero, adam <-> zero-adam) bitwise. Placement is
  memory-bounded: a leaf is placed by cutting the whole host leaf into
  this rank's block (`put_leaf`, `train/lm.py` `_local_shard`), one leaf at
  a time, never a whole tree on the device.
- **Collective transfer** (`make_zero_gather_fn`, `make_pp_zero_gather_fn`):
  the same-mesh collective form of the ZeRO reassembly, one all-gather a
  leaf over the mesh's data group (and a second over the pipe group for a
  stage-split leaf), in the form `parallel/collectives.py`
  `collective_form` picks; each bitwise its host transform.

`reshard_step_program` and `reshard_pp_step_program` (the gathers as
traceable StepPrograms for the static analyzer) wait for the port's
`StepProgram` (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import numpy as np

from ..utils.tree import tree_map
from .partition import PartitionSpec as P

RESHARD_META_VERSION = 1

# optimizer families: state converts bitwise within a family (same logical
# values, different layout); across families there is nothing to map
_OPTIMIZER_FAMILY = {
    "sgd": "sgd", "zero": "sgd", "adam": "adam", "zero-adam": "adam",
}


# ------------------------------------------------- PartitionSpec (de)serde


def spec_to_json(spec) -> list:
    """One PartitionSpec as a JSON list (tuple entries become lists)."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def spec_from_json(entries) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _is_enc(d) -> bool:
    return isinstance(d, dict) and "__spec__" in d


def spec_tree_to_json(tree):
    """A tree of PartitionSpecs as nested JSON; each spec becomes
    ``{"__spec__": [...]}`` so subtrees and specs stay apart."""
    return tree_map(lambda s: {"__spec__": spec_to_json(s)}, tree)


def spec_tree_from_json(doc):
    """The inverse of `spec_tree_to_json`."""
    if _is_enc(doc):
        return spec_from_json(doc["__spec__"])
    if isinstance(doc, dict):
        return {k: spec_tree_from_json(v) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return type(doc)(spec_tree_from_json(v) for v in doc)
    return doc


def spec_axes(spec) -> tuple:
    """Flattened mesh-axis names a PartitionSpec shards over (tuple or list
    entries - e.g. ``P(('pipe','data'))`` - are expanded)."""
    out = []
    for e in tuple(spec):
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            out.extend(e)
        else:
            out.append(e)
    return tuple(out)


# ----------------------------------------------------- topology metadata


def mesh_topology(mesh, *, specs=None, optimizer: str | None = None, **extra) -> dict:
    """The JSON save-time topology block of a checkpoint's meta: the axes
    and sizes (`ProcessMesh.shape`; the CNN's replica group as ``{"data":
    workers}``), the ranks (``devices``: one card or CPU process each) and
    processes, the platform (the device type), the optimizer layout and the
    parameters' specs; ``extra`` lands as given (global batch, accum_steps,
    pp_interleave, ...)."""
    if hasattr(mesh, "shape"):  # a ProcessMesh
        axes, ranks = mesh.shape, mesh.world
    else:  # the CNN engine's ReplicaGroup
        axes, ranks = {"data": mesh.size}, mesh.world
    topo = {
        "version": RESHARD_META_VERSION,
        "axes": {str(k): int(v) for k, v in axes.items()},
        "devices": int(ranks),
        "process_count": int(ranks),
        "platform": mesh.device.type,
    }
    if optimizer is not None:
        topo["optimizer"] = str(optimizer)
    if specs is not None:
        topo["specs"] = spec_tree_to_json(specs)
    topo.update(extra)
    return topo


def topology_mismatch(saved: dict, current: dict) -> list:
    """Human-readable differences between two `mesh_topology` blocks, by
    the fields that carry a layout (axes, device count, optimizer,
    pp_interleave); empty when the saved layout drops onto the current
    mesh unchanged. The platform is not compared: checkpoints move between
    the card and the CPU."""
    diffs = []
    if saved.get("version", 0) > RESHARD_META_VERSION:
        diffs.append(
            f"checkpoint mesh meta version {saved.get('version')} is newer "
            f"than this build's {RESHARD_META_VERSION}"
        )
    a, b = saved.get("axes") or {}, current.get("axes") or {}
    for name in sorted(set(a) | set(b)):
        sa, sb = int(a.get(name, 1)), int(b.get(name, 1))
        if sa != sb:
            diffs.append(f"mesh axis {name!r}: saved {sa}, target {sb}")
    if saved.get("devices") != current.get("devices"):
        diffs.append(
            f"device count: saved {saved.get('devices')}, "
            f"target {current.get('devices')}"
        )
    so, co = saved.get("optimizer"), current.get("optimizer")
    if so is not None and co is not None and so != co:
        diffs.append(f"optimizer layout: saved {so!r}, target {co!r}")
    si, ci = saved.get("pp_interleave", 1), current.get("pp_interleave", 1)
    if int(si) != int(ci):
        diffs.append(f"pp_interleave: saved {si}, target {ci}")
    return diffs


# ------------------------------------------------- memory-bounded placement


def put_leaf(x, sharding):
    """Place ONE whole host leaf (numpy array or tensor) onto a
    `parallel/mesh.py` `NamedSharding`: this rank's block of it on the
    mesh's device (`train/lm.py` `_local_shard`), a new tensor. A Python or
    0-d integer (Adam's counter) stays on the host as an int. The peak
    footprint is one leaf."""
    import torch

    from ..train.lm import _local_shard
    from ..utils.checkpoint import to_torch

    if isinstance(x, (int, np.integer)) or (
            isinstance(x, np.ndarray) and x.ndim == 0 and x.dtype.kind in "iu"):
        return int(x)
    t = x if isinstance(x, torch.Tensor) else to_torch(np.asarray(x))
    return _local_shard(t.to(sharding.mesh.device), sharding.spec, sharding.mesh)


def place_tree(tree, shardings):
    """Leaf-wise `put_leaf` over a host tree."""
    return tree_map(put_leaf, tree, shardings)


# --------------------------------------------------- ZeRO layout transforms


def _size(ref) -> int:
    return int(np.prod(tuple(ref.shape), dtype=np.int64))


def reshard_zero_leaf(buf, size: int, new_n: int):
    """Re-pad one flat ZeRO buffer for a new shard count.

    The buffer holds the leaf's `size` logical elements plus zero padding
    to a multiple of the OLD shard count (`parallel/zero.py`
    `leaf_shard_size`); the padding length changes with the shard count, so
    a dp change must unpad to the logical elements and re-pad - values are
    untouched (bitwise round trip).
    """
    from .zero import leaf_shard_size

    buf = np.asarray(buf)
    if buf.ndim != 1 or buf.shape[0] < size:
        raise ValueError(
            f"ZeRO buffer of shape {buf.shape} cannot hold {size} logical "
            "elements - not a flat per-leaf ZeRO buffer"
        )
    flat = buf[:size]
    total = leaf_shard_size(size, new_n) * new_n
    out = np.zeros((total,), buf.dtype)
    out[:size] = flat
    return out


def reshard_zero_tree(flat_tree, params_template, new_n: int):
    """`reshard_zero_leaf` over a per-leaf ZeRO buffer tree; logical sizes
    come from the aligned `params_template` leaves."""
    return tree_map(lambda buf, ref: reshard_zero_leaf(buf, _size(ref), new_n),
                    flat_tree, params_template)


def zero_tree_to_momentum(flat_tree, params_template):
    """ZeRO per-leaf flat buffers -> the replicated momentum tree (each
    leaf unpadded and reshaped to its parameter's shape). Values bitwise."""
    def leaf(buf, ref):
        size = _size(ref)
        buf = np.asarray(buf)
        if buf.shape[0] < size:
            raise ValueError(
                f"ZeRO buffer ({buf.shape[0]} elements) smaller than its "
                f"parameter ({size}) - layout mismatch"
            )
        return buf[:size].reshape(tuple(ref.shape))

    return tree_map(leaf, flat_tree, params_template)


def momentum_to_zero_tree(mom_tree, n_shards: int):
    """Replicated momentum tree -> ZeRO per-leaf flat buffers padded for
    `n_shards` (inverse of `zero_tree_to_momentum`; f32, the ZeRO state
    dtype). Values bitwise."""
    from .zero import leaf_shard_size

    def leaf(m):
        m = np.asarray(m, np.float32).reshape(-1)
        total = leaf_shard_size(m.size, n_shards) * n_shards
        out = np.zeros((total,), np.float32)
        out[: m.size] = m
        return out

    return tree_map(leaf, mom_tree)


# ------------------------------------------ ZeRO-under-pp layout transforms


def pp_zero_tree_to_momentum(flat_tree, params_template, pp_specs, pp: int):
    """ZeRO-under-pp per-leaf flat buffers -> the replicated momentum tree.

    The pipeline ZeRO layout (`parallel/pipeline.py` `init_pp_zero_state`,
    the DeepSpeed ZeRO-1 + PP convention; gathered stage-major, the
    ``P(("pipe", "data"))`` state spec) flattens each pipe-sharded leaf
    STAGE-MAJOR: pp segments of ``dp * ceil((size/pp)/dp)`` elements, each
    holding one stage's contiguous layer chunk plus per-stage dp padding.
    Unpadding each segment and concatenating in stage order recovers the
    row-major flattened logical leaf. Pipe-replicated leaves (embed / head
    / final norm) carry the plain dp-padded layout. Values bitwise;
    `pp_specs` (`pp_param_specs(cfg)`) says which leaves carry the split.
    """
    def leaf(buf, ref, spec):
        buf = np.asarray(buf)
        size = _size(ref)
        if pp > 1 and "pipe" in spec_axes(spec):
            if size % pp or buf.shape[0] % pp:
                raise ValueError(
                    f"pipe-sharded leaf of {size} elements / buffer "
                    f"{buf.shape} does not split over {pp} stages"
                )
            local = size // pp
            seg = buf.shape[0] // pp
            if seg < local:
                raise ValueError(
                    f"ZeRO-under-pp segment ({seg} elements) smaller than "
                    f"its stage chunk ({local}) - layout mismatch"
                )
            flat = buf.reshape(pp, seg)[:, :local].reshape(-1)
        else:
            if buf.shape[0] < size:
                raise ValueError(
                    f"ZeRO buffer ({buf.shape[0]} elements) smaller than "
                    f"its parameter ({size}) - layout mismatch"
                )
            flat = buf[:size]
        return flat.reshape(tuple(ref.shape))

    return tree_map(leaf, flat_tree, params_template, pp_specs)


def momentum_to_pp_zero_tree(mom_tree, pp_specs, pp: int, dp: int):
    """Replicated momentum tree -> ZeRO-under-pp per-leaf flat buffers
    (inverse of `pp_zero_tree_to_momentum`; f32). Pipe-sharded leaves
    re-split stage-major with per-stage dp padding; pipe-replicated leaves
    pad like the mesh path. Values bitwise."""
    from .zero import leaf_shard_size

    def leaf(m, spec):
        m = np.asarray(m, np.float32).reshape(-1)
        if pp > 1 and "pipe" in spec_axes(spec):
            if m.size % pp:
                raise ValueError(
                    f"leaf of {m.size} elements does not split over {pp} "
                    "stages"
                )
            local = m.size // pp
            seg = dp * leaf_shard_size(local, dp)
            out = np.zeros((pp, seg), np.float32)
            out[:, :local] = m.reshape(pp, local)
            return out.reshape(-1)
        total = dp * leaf_shard_size(m.size, dp)
        out = np.zeros((total,), np.float32)
        out[: m.size] = m
        return out

    return tree_map(leaf, mom_tree, pp_specs)


# ------------------------------------------- optimizer layout conversion


def convert_optimizer_state(
    mom, *, src: str, dst: str, params_template, src_dp: int, dst_dp: int,
    src_pp: int = 1, dst_pp: int = 1, pp_specs=None,
):
    """Map optimizer state between layouts (host-level, values bitwise).

    Within a family the state is the same logical values under a different
    partition: sgd <-> zero re-flattens/pads the momentum tree,
    adam <-> zero-adam does the same for both moment trees (the step
    counter passes through). Across families (sgd <-> adam) there is no
    meaningful mapping and a ValueError names the supported conversions.

    ``src_pp``/``dst_pp`` > 1 mark ZeRO state laid out under pipeline
    parallelism; those conversions route through the canonical replicated
    momentum tree and need ``pp_specs`` (the pipeline param-spec tree that
    says which leaves carry the split).
    """
    for name, o in (("saved", src), ("target", dst)):
        if o not in _OPTIMIZER_FAMILY:
            raise ValueError(f"unknown {name} optimizer {o!r}")
    if _OPTIMIZER_FAMILY[src] != _OPTIMIZER_FAMILY[dst]:
        raise ValueError(
            f"cannot convert optimizer state {src!r} -> {dst!r}: the "
            "layouts carry different quantities. Supported conversions: "
            "sgd<->zero, adam<->zero-adam, and any optimizer to itself "
            "across mesh shapes."
        )
    src_zero = src in ("zero", "zero-adam")
    dst_zero = dst in ("zero", "zero-adam")
    if (src_zero and src_pp > 1) or (dst_zero and dst_pp > 1):
        if pp_specs is None:
            raise ValueError(
                "ZeRO state under pipeline parallelism carries a per-stage "
                "split; pass pp_specs (parallel/pipeline.py "
                "pp_param_specs) so the converter knows which leaves "
                "split over 'pipe'"
            )
        if (src, src_dp, src_pp) == (dst, dst_dp, dst_pp):
            return mom

        def to_mom(flat):
            if src_pp > 1:
                return pp_zero_tree_to_momentum(flat, params_template, pp_specs, src_pp)
            return zero_tree_to_momentum(flat, params_template)

        def to_zero(tree):
            if dst_pp > 1:
                return momentum_to_pp_zero_tree(tree, pp_specs, dst_pp, dst_dp)
            return momentum_to_zero_tree(tree, dst_dp)

        if _OPTIMIZER_FAMILY[src] == "sgd":
            mid = to_mom(mom) if src_zero else mom
            return to_zero(mid) if dst_zero else mid
        mid_m = to_mom(mom["m"]) if src_zero else mom["m"]
        mid_v = to_mom(mom["v"]) if src_zero else mom["v"]
        if dst_zero:
            mid_m, mid_v = to_zero(mid_m), to_zero(mid_v)
        return {"m": mid_m, "v": mid_v, "t": mom["t"]}
    if src == dst:
        if src in ("zero", "zero-adam") and src_dp != dst_dp:
            if src == "zero":
                return reshard_zero_tree(mom, params_template, dst_dp)
            return {
                "m": reshard_zero_tree(mom["m"], params_template, dst_dp),
                "v": reshard_zero_tree(mom["v"], params_template, dst_dp),
                "t": mom["t"],
            }
        return mom
    if (src, dst) == ("zero", "sgd"):
        return zero_tree_to_momentum(mom, params_template)
    if (src, dst) == ("sgd", "zero"):
        return momentum_to_zero_tree(mom, dst_dp)
    if (src, dst) == ("zero-adam", "adam"):
        return {
            "m": zero_tree_to_momentum(mom["m"], params_template),
            "v": zero_tree_to_momentum(mom["v"], params_template),
            "t": mom["t"],
        }
    if (src, dst) == ("adam", "zero-adam"):
        return {
            "m": momentum_to_zero_tree(mom["m"], dst_dp),
            "v": momentum_to_zero_tree(mom["v"], dst_dp),
            "t": mom["t"],
        }
    raise AssertionError(f"unhandled conversion {src!r} -> {dst!r}")


def reshard_state(
    state,
    *,
    saved_optimizer: str,
    saved_dp: int,
    optimizer: str,
    dp: int,
    params_template,
    param_shardings=None,
    mom_shardings=None,
    saved_pp: int = 1,
    pp: int = 1,
    pp_specs=None,
):
    """The leaf-wise resharder: one saved ``{"params", "mom"}`` whole host
    tree (any mesh of origin) onto a new layout.

    Parameters are layout-invariant logical arrays - only their placement
    changes. Optimizer state goes through `convert_optimizer_state`. With
    shardings given (`parallel/mesh.py` `NamedSharding` trees), leaves are
    placed memory-boundedly (`place_tree`: this rank's blocks); without,
    the whole host trees come back for the caller to place.
    """
    params = state["params"]
    mom = convert_optimizer_state(
        state["mom"], src=saved_optimizer, dst=optimizer,
        params_template=params_template, src_dp=saved_dp, dst_dp=dp,
        src_pp=saved_pp, dst_pp=pp, pp_specs=pp_specs,
    )
    if param_shardings is not None:
        params = place_tree(params, param_shardings)
    if mom_shardings is not None:
        mom = place_tree(mom, mom_shardings)
    return {"params": params, "mom": mom}


# ----------------------------------------------- batch / accumulation math


def rescale_accum(global_batch: int, old_dp: int, new_dp: int, accum: int) -> int:
    """Gradient-accumulation steps after a dp change, global batch FIXED.

    The exact-resume cursor pins the data stream as a function of
    (seed, step, global batch) - so elasticity must never change the
    global batch. What can change is how it is sliced: prefer keeping the
    per-rank microbatch row count constant (accum scales by old_dp/new_dp -
    a shrink accumulates more, a growth less); fall back to the old accum
    when the new dp still divides; last resort accum=1. Raises when
    `global_batch` is not divisible by `new_dp` at all.
    """
    for name, v in (
        ("global_batch", global_batch), ("old_dp", old_dp),
        ("new_dp", new_dp), ("accum", accum),
    ):
        if int(v) < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    if global_batch % new_dp:
        raise ValueError(
            f"global batch {global_batch} does not divide over the new "
            f"data-parallel size {new_dp} - the elastic contract keeps the "
            "global batch (and so the data cursor) exact; choose a target "
            "dp that divides the batch"
        )
    scaled = accum * old_dp
    if scaled % new_dp == 0:
        k = scaled // new_dp
        if global_batch % (new_dp * k) == 0:
            return k
    if global_batch % (new_dp * accum) == 0:
        return accum
    return 1


# --------------------------------------------- engine (CNN) momentum stack


def reshard_momentum_stack(mom_stack, n_new: int):
    """The CNN engine's per-worker momentum stack onto a new worker count.

    Shrink: the first `n_new` rows survive (their workers keep training
    with their own buffers - the buffers of removed workers are dropped
    with the workers). Grow: new workers start with ZERO momentum (the
    fresh-optimizer state the reference's per-epoch SGD re-creation gives
    every worker every epoch). Host-level, leaf-wise.
    """
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")

    def leaf(m):
        m = np.asarray(m)
        n_old = m.shape[0]
        if n_new <= n_old:
            return m[:n_new]
        pad = np.zeros((n_new - n_old, *m.shape[1:]), m.dtype)
        return np.concatenate([m, pad], axis=0)

    return tree_map(leaf, mom_stack)


# ------------------------------------------------- collective transfer


def _gather_flat(buf, axis):
    """The axis's ranks' (S,) `buf` side by side, rank-major (S*n,): one
    all-gather over the axis's group in its collective form; the buffer
    itself off a group."""
    import torch

    from .collectives import all_gather

    if axis.group is None:
        return buf
    out = torch.empty(buf.numel() * axis.size, dtype=buf.dtype, device=buf.device)
    all_gather(out, buf.contiguous(), rank=axis.index, form=axis.form, group=axis.group)
    return out


def make_zero_gather_fn(params_template, mesh, axis_name: str = "data"):
    """Same-mesh ZeRO reassembly: this rank's per-leaf flat shards (the ZeRO
    state, `parallel/zero.py`) -> the replicated momentum tree, one
    all-gather a leaf over the mesh's `axis_name` group
    (`collectives.all_gather` in the group's collective form), sliced to
    the logical size and reshaped: the collective form of
    `zero_tree_to_momentum`, bitwise. Every rank of the axis must call it."""
    axis = mesh.axis(axis_name)

    def gather(flat_tree):
        def leaf(buf, ref):
            full = _gather_flat(buf, axis)
            return full[:_size(ref)].reshape(tuple(ref.shape)).float()

        return tree_map(leaf, flat_tree, params_template)

    return gather


def make_pp_zero_gather_fn(params_template, mesh, *, data_axis: str = "data",
                           pipe_axis: str = "pipe"):
    """Same-mesh ZeRO-under-pp reassembly: this rank's per-stage flat
    shards (`parallel/pipeline.py` `init_pp_zero_state`) -> the replicated
    momentum tree. Per pipe-sharded leaf, one all-gather over the data
    group rebuilds this stage's padded segment, the per-stage padding is
    sliced off, and a second all-gather over the pipe group concatenates
    the stage chunks in stage order; pipe-replicated leaves take the mesh
    path's single data gather. The collective form of
    `pp_zero_tree_to_momentum`, bitwise; `params_template` is the whole
    (logical) parameter tree."""
    pp = mesh.axis(pipe_axis).size
    data, pipe = mesh.axis(data_axis), mesh.axis(pipe_axis)
    specs = pp_param_specs_for_tree(params_template)

    def gather(flat_tree):
        def leaf(buf, ref, spec):
            size = _size(ref)
            if pp > 1 and "pipe" in spec_axes(spec):
                seg = _gather_flat(buf, data)
                flat = _gather_flat(seg[:size // pp].contiguous(), pipe)
            else:
                flat = _gather_flat(buf, data)[:size]
            return flat.reshape(tuple(ref.shape)).float()

        return tree_map(leaf, flat_tree, params_template, specs)

    return gather


def pp_param_specs_for_tree(params_template):
    """The pipeline PartitionSpec tree for any transformer-shaped param
    tree: every `layers` leaf stage-sharded over 'pipe' on its leading
    (layer) axis, everything else replicated - derived from the tree
    itself, so callers without a TransformerConfig never re-derive it."""
    def sub(tree, piped: bool):
        def leaf(p):
            rank = len(tuple(p.shape)) if hasattr(p, "shape") else np.ndim(p)
            if piped:
                return P("pipe", *([None] * (rank - 1)))
            return P(*([None] * rank))

        return tree_map(leaf, tree)

    return {k: sub(v, k == "layers") for k, v in params_template.items()}
