"""Phase timers fenced on the device (counterpart of the JAX package's
`utils/timers.py`): the same canonical phases, phrasing and `report()`.
A phase on a CUDA device ends with `torch.cuda.synchronize(device)` before
the clock is read, so device work is charged to the phase that queued it."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

DATA_LOADING = "data_loading"
TRAINING = "training"
EVALUATION = "evaluation"
COMMUNICATION = "communication"

CANONICAL_PHASES = (DATA_LOADING, TRAINING, EVALUATION, COMMUNICATION)

REPORT_LABELS = {
    DATA_LOADING: "Train data loading time",
    TRAINING: "Time spent on training",
    EVALUATION: "Time spent on evaluation",
    COMMUNICATION: "Time spent on parent communication and param sync",
}


def fence(device: torch.device | None) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.totals: dict[str, float] = defaultdict(float)

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            fence(self.device)
            self.totals[name] += time.perf_counter() - start

    def get(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def report(self) -> str:
        """Canonical phases first in the reference's order and phrasing, then
        any extra phases alphabetically as ``<name>: <seconds>``."""
        lines = [
            f"{REPORT_LABELS[name]}: {self.totals.get(name, 0.0)}"
            for name in CANONICAL_PHASES
        ]
        for name in sorted(set(self.totals) - set(CANONICAL_PHASES)):
            lines.append(f"{name}: {self.totals[name]}")
        return "\n".join(lines)
