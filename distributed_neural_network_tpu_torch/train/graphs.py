"""Captured programs: the port's counterpart of the JAX engine's compiled
dispatches (`jax.jit` of a `shard_map`), as CUDA graphs.

A `Program` wraps a function of no arguments that reads and writes only
tensors that live as long as it does (the engine's static buffers: plans,
mask, parameters, momentum, accumulators, metrics). On the card `capture`
records it once as a CUDA graph and each call replays that graph `times`
times: the host issues one graph launch per replay, never one per kernel.
Off the card (a caller asked for the CPU) a call runs the function eagerly
`times` times; that is not a fallback, and on the card nothing runs eagerly
unless the caller asks for it (`Program.capture` is simply not called).

Capture follows PyTorch's recipe for graphs that hold `autograd.grad` and
in-place optimizer updates: one warm-up run of every program on a side
stream (which builds the libraries' handles, cuDNN's plans and the kernels'
attributes), then the capture on that same stream. The warm-up changes the
state, so `capture_all` puts every state tensor back as it was.

Launch accounting: the kernel wrappers count a launch where they issue one
(`ops/fused_head.py` `LAUNCHES`). During a capture nothing executes, so a
program records each counter's change during its capture, puts the counters
back, and adds change x replays at every call; the warm-up's launches are
taken back too. So a counter keeps counting kernel executions of the
programs' calls, on the card as on the CPU, where each call runs and counts
for itself.
"""

from __future__ import annotations

import gc

import torch


class Program:
    """`fn` run `times` times per call: eagerly, or as replays of its graph
    once `capture` has recorded it. `counters` are dicts of launch counts."""

    def __init__(self, fn, counters=()):
        self.fn = fn
        self.counters = counters
        self.graph = None
        self.delta = None

    def capture(self, stream: torch.cuda.Stream) -> None:
        """Record `fn` as a CUDA graph on `stream`; raises if it cannot be."""
        before = [dict(c) for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: freeing another graph
        # there (cyclic garbage) would invalidate this one
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                self.fn()
        finally:
            gc.enable()
        self.delta = [{k: c[k] - b[k] for k in c} for c, b in zip(self.counters, before)]
        for c, b in zip(self.counters, before):
            c.update(b)
        self.graph = graph

    def __call__(self, times: int = 1) -> None:
        if self.graph is None:
            for _ in range(times):
                self.fn()
            return
        for _ in range(times):
            self.graph.replay()
        for c, d in zip(self.counters, self.delta):
            for k, v in d.items():
                c[k] += v * times


def capture_all(programs, state, device: torch.device) -> None:
    """Warm every program up once on a side stream, give each tensor of
    `state` its value back, and capture every program on that stream."""
    counts = [dict(c) for p in programs for c in p.counters]
    # detached: a clone that tracked gradients would keep each parameter's
    # AccumulateGrad node alive, tied to the default stream, and autograd
    # would then make that stream wait on the capture
    saved = [t.detach().clone() for t in state]
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for p in programs:
            p.fn()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
    torch.cuda.current_stream(device).wait_stream(stream)
    for c, v in zip((c for p in programs for c in p.counters), counts):
        c.update(v)
    for p in programs:
        p.capture(stream)
