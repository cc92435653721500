"""Elastic resume: restore any checkpoint onto any mesh and keep training
(the port of the JAX package's `train/elastic.py`, over
`parallel/reshard.py`):

- `lm_mesh_meta` stamps the LM trainer's checkpoint meta with the
  save-time topology (mesh axes, specs, optimizer, global batch, accum),
  so a later restore can detect and plan a reshard.
- `elastic_restore` is the resume path: peek the newest checkpoint's
  meta, rebuild the SAVED state's template from it (`saved_state_template`,
  so the npz validation still checks every leaf), restore on the host, run
  the leaf-wise resharder (`reshard_state`) and hand the whole host tree of
  this run's layout to the caller's `load` (`train/lm.py`
  `load_checkpoint_state`: each leaf cut to this rank's block and copied
  into the step's own tensors) - emitting a ``reshard`` trace span, the
  ``reshard`` goodput bucket, ``elastic_events_total`` /
  ``reshard_seconds`` live metrics and an ``elastic_reshard`` flight event.
- `rescaled_accum_steps` keeps the global batch (and with it the
  exact-resume data cursor) fixed across a dp change by re-slicing it
  into microbatches.

`lm_train.py` uses all three for ``--resume --elastic`` and for the
in-process ``--chaos-shrink-at-step`` preempt -> checkpoint -> reshard ->
resume path; `train/cli.py --elastic` rides `Checkpointer.restore_latest(
engine, elastic=True)`, which reshards the engine's per-worker momentum
stack with `reshard_momentum_stack`.
"""

from __future__ import annotations

import time

import numpy as np

from ..parallel.reshard import (
    convert_optimizer_state,
    mesh_topology,
    reshard_state,
    rescale_accum,
    spec_axes,
    topology_mismatch,
)
from ..utils.tree import tree_map

ELASTIC_KINDS = ("restore", "shrink", "grow")


def _metrics(registry):
    if registry is None:
        from ..utils.obs import NULL_REGISTRY

        registry = NULL_REGISTRY
    events = registry.counter(
        "elastic_events_total",
        "Elastic reshard events, by kind (train/elastic.py)",
    )
    seconds = registry.histogram(
        "reshard_seconds", "Wall time of one checkpoint reshard"
    )
    return events, seconds


def lm_mesh_meta(mesh, specs, optimizer: str, *, batch: int, accum_steps: int,
                 **extra) -> dict:
    """The LM trainer's `mesh_meta` block (`mesh_topology` plus the global
    batch and the accumulation steps `rescaled_accum_steps` needs)."""
    return mesh_topology(mesh, specs=specs, optimizer=optimizer, global_batch=int(batch),
                         accum_steps=int(accum_steps), **extra)


def saved_state_template(cfg, saved: dict):
    """Template (`utils/checkpoint.py` `LeafSpec` leaves) of a checkpoint's
    SAVED ``{"params", "mom"}`` layout, rebuilt from its recorded topology,
    so the restore still validates every leaf's shape and dtype when the
    saved layout differs from the run's.

    Params are layout-invariant (the whole logical tree, f32); the
    optimizer state's shapes depend on the saved optimizer and - for the
    ZeRO variants, whose flat buffers are padded per shard count - the
    saved data-axis size, plus (under pipeline parallelism) the recorded
    stage count: ZeRO-under-pp buffers carry the per-stage split of
    `parallel/pipeline.py` `init_pp_zero_state`.
    """
    from ..models import transformer as tfm
    from ..parallel.zero import leaf_shard_size
    from ..utils.checkpoint import LeafSpec

    f32, i32 = np.dtype(np.float32), np.dtype(np.int32)
    optimizer = saved.get("optimizer", "sgd")
    axes = saved.get("axes") or {}
    dp = int(axes.get("data", 1))
    pp = int(axes.get("pipe", 1))

    def spec_of(node):
        if isinstance(node, dict):
            return {k: spec_of(v) for k, v in node.items()}
        return LeafSpec(tuple(node), f32)

    params = spec_of(tfm.param_shapes(cfg))
    count = LeafSpec((), i32)
    if optimizer == "sgd":
        mom = params
    elif optimizer == "adam":
        mom = {"m": params, "v": params, "t": count}
    elif optimizer in ("zero", "zero-adam"):
        if pp > 1:
            from ..parallel.pipeline import pp_param_specs

            specs = pp_param_specs(cfg)
        else:
            specs = tree_map(lambda p: None, params)

        def buf(p, spec):
            size = int(np.prod(p.shape, dtype=np.int64))
            if pp > 1 and "pipe" in spec_axes(spec):
                n = pp * dp * leaf_shard_size(size // pp, dp)
            else:
                n = dp * leaf_shard_size(size, dp)
            return LeafSpec((n,), f32)

        flat = tree_map(buf, params, specs)
        mom = flat if optimizer == "zero" else {"m": flat, "v": flat, "t": count}
    else:
        raise ValueError(f"checkpoint records unknown optimizer {optimizer!r}")
    return {"params": params, "mom": mom}


def rescaled_accum_steps(saved: dict, *, batch: int, new_dp: int,
                         accum_steps: int) -> int:
    """This run's accumulation steps given the saved topology: keep the
    GLOBAL batch exact across the dp change (`rescale_accum`); checkpoints
    without the batch facts (or with a changed global batch - the
    operator overrode it deliberately) keep the requested value."""
    if int(saved.get("global_batch", -1)) != int(batch):
        return accum_steps
    old_dp = int((saved.get("axes") or {}).get("data", 1))
    return rescale_accum(
        batch, old_dp, new_dp, int(saved.get("accum_steps", accum_steps))
    )


def elastic_restore(
    ck,
    *,
    cfg,
    mesh,
    specs,
    optimizer: str,
    current_meta: dict | None = None,
    template=None,
    load=None,
    tracer=None,
    registry=None,
    log=print,
):
    """Restore the newest checkpoint of `ck` (a `utils/checkpoint.py`
    `TreeCheckpointer`) onto THIS run's mesh, resharding when the saved
    topology differs.

    Returns ``(state, meta, step, resharded)`` or None when the directory
    holds no checkpoint. `state` is the whole host tree in this run's
    layout (numpy leaves); `load(state)`, when given, places it: copies each
    leaf's block into the run's own tensors (inside the reshard span:
    placement is part of the reshard), so a captured step keeps its
    tensors. Matching topology
    (or a checkpoint without a `mesh_meta` block) takes the plain restore
    against `template` (default: this run's layout rebuilt from `mesh`); a
    mismatch logs the named differences, restores against the saved
    template (`saved_state_template`) and runs the leaf-wise resharder
    under a ``reshard`` trace span with live metrics.
    """
    from ..parallel.pipeline import interleave_layer_order
    from ..utils import tracing as TR
    from ..utils.goodput import ledger_interval
    from ..utils.obs import flight_event

    latest = ck.latest_meta(log=log)
    if latest is None:
        return None
    _, meta = latest
    saved = meta.get("mesh_meta")
    current = current_meta or lm_mesh_meta(mesh, specs, optimizer, batch=-1, accum_steps=1)
    diffs = topology_mismatch(saved, current) if saved else []
    if template is None:
        template = saved_state_template(cfg, {"optimizer": optimizer, "axes": dict(mesh.shape)})

    if not diffs:
        restored = ck.restore_latest(template, log=log)
        if restored is None:
            return None
        state, meta, step = restored
        if load is not None:
            load(state)
        return state, meta, step, False

    events, seconds = _metrics(registry)
    tracer = tracer if tracer is not None else TR.NULL_TRACER
    for d in diffs:
        log(f"(elastic: {d})")
    saved_optimizer = saved.get("optimizer", "sgd")
    saved_axes = saved.get("axes") or {}
    saved_dp = int(saved_axes.get("data", 1))
    saved_pp = int(saved_axes.get("pipe", 1))
    dp = int(mesh.shape.get("data", 1))
    dst_pp = int(mesh.shape.get("pipe", 1))
    pp_specs = None
    if (saved_optimizer.startswith("zero") and saved_pp > 1) or (
        optimizer.startswith("zero") and dst_pp > 1
    ):
        from ..parallel.pipeline import pp_param_specs

        pp_specs = pp_param_specs(cfg)
    t0 = time.perf_counter()
    with tracer.span(
        TR.RESHARD, track="elastic",
        saved_axes=dict(saved_axes),
        target_axes={k: int(v) for k, v in mesh.shape.items()},
        saved_optimizer=saved_optimizer, optimizer=optimizer,
    ), ledger_interval("reshard"):
        saved_template = saved_state_template(cfg, saved)
        restored = ck.restore_latest(saved_template, log=log)
        if restored is None:
            return None
        state, meta, step = restored
        v0 = int(saved.get("pp_interleave", meta.get("pp_interleave", 1)))
        v1 = int(current.get("pp_interleave", 1))
        if v0 != v1:
            # the interleaved pipeline schedule permutes the layer axis;
            # route through canonical order so any v -> any v maps. ZeRO-
            # under-pp buffers follow the PLACED layer order, so they are
            # first reassembled into the replicated family layout (the same
            # permutation then applies to params and momentum alike); the
            # target layout is rebuilt by reshard_state below.
            if saved_optimizer.startswith("zero"):
                family = "sgd" if saved_optimizer == "zero" else "adam"
                state = {
                    **state,
                    "mom": convert_optimizer_state(
                        state["mom"], src=saved_optimizer, dst=family,
                        params_template=state["params"],
                        src_dp=saved_dp, dst_dp=1,
                        src_pp=saved_pp, pp_specs=pp_specs,
                    ),
                }
                saved_optimizer, saved_dp, saved_pp = family, 1, 1
            pp0 = int(saved_axes.get("pipe", 1))
            pp1 = int(current.get("axes", {}).get("pipe", 1))
            perms = []
            if v0 > 1:
                perms.append(interleave_layer_order(cfg.n_layers, pp0, v0, inverse=True))
            if v1 > 1:
                perms.append(interleave_layer_order(cfg.n_layers, pp1, v1))
            state = {
                "params": _reorder_layers(state["params"], perms),
                "mom": (
                    {
                        "m": _reorder_layers(state["mom"]["m"], perms),
                        "v": _reorder_layers(state["mom"]["v"], perms),
                        "t": state["mom"]["t"],
                    }
                    if saved_optimizer == "adam"
                    else _reorder_layers(state["mom"], perms)
                    if saved_optimizer == "sgd"
                    else state["mom"]
                ),
            }
        state = reshard_state(
            state,
            saved_optimizer=saved_optimizer, saved_dp=saved_dp,
            optimizer=optimizer, dp=dp,
            saved_pp=saved_pp, pp=dst_pp, pp_specs=pp_specs,
            params_template=template["params"],
        )
        if load is not None:
            load(state)
    dt = time.perf_counter() - t0
    kind = "shrink" if current.get("devices", 0) < saved.get("devices", 0) \
        else "grow" if current.get("devices", 0) > saved.get("devices", 0) \
        else "restore"
    events.labels(kind=kind).inc()
    seconds.observe(dt)
    flight_event(
        "elastic_reshard", step=step, what=kind, seconds=round(dt, 3),
        saved=_axes_desc(saved_axes), target=_axes_desc(dict(mesh.shape)),
    )
    log(
        f"(elastic: resharded checkpoint step {step} "
        f"[{_axes_desc(saved_axes)}, {saved_optimizer}] -> "
        f"[{_axes_desc(dict(mesh.shape))}, {optimizer}] in {dt:.2f}s)"
    )
    return state, meta, step, True


def _axes_desc(axes: dict) -> str:
    return "x".join(f"{k}{v}" for k, v in axes.items() if int(v) > 1) or "single"


def _reorder_layers(tree, perms) -> dict:
    """Apply layer-axis permutations (in order) to every `layers` leaf of a
    param-shaped host tree (the stacked layer dim is axis 0)."""
    layers = tree["layers"]
    for order in perms:
        idx = np.asarray(order)
        layers = tree_map(lambda x: np.asarray(x)[idx], layers)
    return {**tree, "layers": layers}
