"""Phase-time log files with the reference's exact names and lines
(counterpart of the JAX package's `utils/logfiles.py`):
``bs{bs}_log_epochs{E}_proc{N}_{parent,children}.txt``, "parent" holding the
eval-side phases and "children" the train-side ones. Ranks above 0 of a process group write
``..._{parent,children}_rank{r}.txt`` (`rank_path`), so ranks on one host
keep their own files."""

from __future__ import annotations

import os

from .timers import COMMUNICATION, DATA_LOADING, EVALUATION, TRAINING, PhaseTimers


def log_basename(bs: int, epochs: int, nb_proc: int, role: str) -> str:
    return f"bs{bs}_log_epochs{epochs}_proc{nb_proc}_{role}.txt"


def rank_path(path: str, rank: int | None) -> str:
    """``name.ext`` -> ``name_rank{r}.ext`` for a rank above 0 (the JAX
    package's `utils/tracing.py` `rank_trace_path` suffix); rank 0 and a
    single process (None) keep the name."""
    if not rank:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_rank{int(rank)}{ext}"


def write_phase_logs(
    log_dir: str,
    *,
    bs: int,
    epochs: int,
    nb_proc: int,
    timers: PhaseTimers,
    eval_data_loading: float | None = None,
    rank: int | None = None,
) -> tuple[str, str]:
    """Write the parent+children phase-log pair (this rank's); returns their paths."""
    os.makedirs(log_dir, exist_ok=True)
    parent, children = (rank_path(os.path.join(log_dir, log_basename(bs, epochs, nb_proc, r)),
                                  rank) for r in ("parent", "children"))
    eval_load = (
        eval_data_loading
        if eval_data_loading is not None
        else timers.get(DATA_LOADING)
    )
    with open(parent, "w") as f:
        f.write("Eval data loading time: {0}\n".format(eval_load))
        f.write("Time spent on evaluation: {0}\n".format(timers.get(EVALUATION)))
        f.write(
            "Time spent on parent communication and param sync: {0}\n".format(
                timers.get(COMMUNICATION)
            )
        )
    with open(children, "w") as f:
        f.write("Train data loading time: {0}\n".format(timers.get(DATA_LOADING)))
        f.write("Time spent on training: {0}\n".format(timers.get(TRAINING)))
        f.write(
            "Time spent on children communication: {0}\n".format(
                timers.get(COMMUNICATION)
            )
        )
    return parent, children
