"""Experiment metrics with the reference's series names (counterpart of the
JAX package's `utils/metrics.py`, JSONL and null sinks): `train/loss`,
`val/loss`, `val/acc` and a `parameters` dict."""

from __future__ import annotations

import json
import math
import os
import time


def _sanitize(value):
    """(json-safe value, invalid-repr-or-None): non-finite floats become
    null with their repr kept, since strict JSON has no NaN."""
    if isinstance(value, float) and not math.isfinite(value):
        return None, repr(value)
    return value, None


def _sanitize_tree(x):
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _sanitize_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize_tree(v) for v in x]
    return x


class MetricsRun:
    """`run.append(series, value)`, `run["parameters"] = {...}` over sinks."""

    def __init__(self, sinks):
        self.sinks = list(sinks)

    def __setitem__(self, key: str, value) -> None:
        for s in self.sinks:
            s.set_value(key, value)

    def append(self, series: str, value) -> None:
        for s in self.sinks:
            s.append(series, float(value))

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def stop(self) -> None:
        for s in self.sinks:
            s.stop()


class JsonlSink:
    """One JSON object per event: {"t", "series", "step", "value"} or
    {"t", "series", "data"}."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._step: dict[str, int] = {}

    def set_value(self, key, value):
        self._write({"t": time.time(), "series": key, "data": _sanitize_tree(value)})

    def append(self, series, value):
        step = self._step.get(series, 0)
        self._step[series] = step + 1
        v, invalid = _sanitize(float(value))
        obj = {"t": time.time(), "series": series, "step": step, "value": v}
        if invalid is not None:
            obj["invalid"] = invalid
        self._write(obj)

    def _write(self, obj):
        self._f.write(json.dumps(obj, allow_nan=False) + "\n")

    def flush(self):
        if not self._f.closed:
            self._f.flush()

    def stop(self):
        self.flush()
        self._f.close()


class NullSink:
    def set_value(self, key, value): ...

    def append(self, series, value): ...

    def flush(self): ...

    def stop(self): ...


def init_run(jsonl_path: str | None = None) -> MetricsRun:
    return MetricsRun([JsonlSink(jsonl_path)] if jsonl_path else [NullSink()])
