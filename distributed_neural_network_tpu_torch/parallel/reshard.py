"""Checkpoint topology metadata: the part of the JAX package's
`parallel/reshard.py` that every checkpoint needs (`mesh_topology`,
`topology_mismatch`, the specs as JSON), with the same JSON keys.

Every checkpoint records the mesh it was saved under: the axes and their
sizes, the device (rank) and process counts, the optimizer's layout and the
parameters' specs, so a restore into another layout is detected up front
with a named difference. The resharder itself (`reshard_state`,
`convert_optimizer_state`, the ZeRO re-padding) and the elastic resume that
drives it come with ROADMAP Queue 1 item 4, step 9.
"""

from __future__ import annotations

from ..utils.tree import tree_map

RESHARD_META_VERSION = 1


def spec_to_json(spec) -> list:
    """One PartitionSpec as a JSON list (tuple entries become lists)."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def spec_tree_to_json(tree):
    """A tree of PartitionSpecs as nested JSON; each spec becomes
    ``{"__spec__": [...]}`` so subtrees and specs stay apart."""
    return tree_map(lambda s: {"__spec__": spec_to_json(s)}, tree)


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
