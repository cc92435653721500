"""The LM trainer's checkpoint topology block: `lm_mesh_meta`, the part of
the JAX package's `train/elastic.py` every LM checkpoint carries. The
elastic resume itself (`elastic_restore`, `rescaled_accum_steps`,
``--elastic``) comes with ROADMAP Queue 1 item 4, step 9.
"""

from __future__ import annotations

from ..parallel.reshard import mesh_topology


def lm_mesh_meta(mesh, specs, optimizer: str, *, batch: int, accum_steps: int,
                 **extra) -> dict:
    """The LM trainer's `mesh_meta` block (`mesh_topology` plus the global
    batch and the accumulation steps)."""
    return mesh_topology(mesh, specs=specs, optimizer=optimizer, global_batch=int(batch),
                         accum_steps=int(accum_steps), **extra)
