"""Captured programs: the port's counterpart of the JAX engine's compiled
dispatches (`jax.jit` of a `shard_map`), as CUDA graphs.

A `Program` wraps functions of no arguments (its parts, run in order) that
read and write only tensors that live as long as it does (the engine's
static buffers: plans, batches, mask, parameters, momentum, accumulators,
gather buffers, metrics). On the card `capture` records it once and each
call replays it `times` times: the host issues one graph launch per replay,
never one per kernel. Off the card (a caller asked for the CPU) a call runs
the parts eagerly `times` times; that is not a fallback, and on the card
nothing runs eagerly unless the caller asks for it (`Program.capture` is
simply not called) or a part is marked `Eager`.

`Eager` marks a part that no graph can hold: a gloo collective (gloo runs
on the host, so a stream capture cannot record it). Such a program is
captured as one graph per run of other parts, and each call replays them
with the eager part between, so it crosses the host there. An NCCL
collective is an ordinary part and is captured with the rest; the warm-up
below builds its communicator's state on the capture stream first.

Capture follows PyTorch's recipe for graphs that hold `autograd.grad` and
in-place optimizer updates: one warm-up run of every program on a side
stream (which builds the libraries' handles, cuDNN's plans, the kernels'
attributes and NCCL's), then the capture on that same stream. The warm-up
changes the state, so `capture_all` puts every state tensor back as it was.

An owner with many programs that run one at a time on one stream (the
serving engine's bucket graphs) passes one `torch.cuda.graph_pool_handle()`
and one side stream to every `capture_all`: the graphs then share a memory
pool, so the intermediates of one reuse those of another (only tensors a
program keeps, such as its outputs, stay its own; read them before the next
replay), and the libraries' per-stream workspaces are built once. A program
captured later than the others (a serving bucket first met mid-serve) is
captured the same way, from the dummy values its fresh static buffers hold:
`capture_all` puts the state back after the warm-up, so the capture leaves
the state as it found it.

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


class Eager:
    """A part of a `Program` that runs outside any graph (a gloo collective,
    or a forward and backward that hold gloo collectives); `label` names
    it in `Program.describe`."""

    def __init__(self, fn, label: str = "eager"):
        self.fn = fn
        self.label = label


class Program:
    """Its parts run in order, `times` times per call: eagerly, or as
    replays of the graphs `capture` recorded (one per run of parts between
    `Eager` ones, which run eagerly between the replays). `counters` are
    dicts of launch counts; `name` says what it is in a capture's error.
    `_cache_size()` is 1 once the program is captured (or, never captured,
    has run once eagerly): the count `train/monitor.py` `RecompileDetector`
    reads."""

    def __init__(self, *parts, counters=(), name: str = "a program"):
        self.parts = parts
        self.counters = counters
        self.name = name
        self.graphs = []
        self.segments = None  # after capture: graph replays and eager parts, in order
        self.kinds = None  # after capture: "graph", or the eager part's label, per segment
        self.delta = None
        self._builds = 0

    def _cache_size(self) -> int:
        return self._builds

    @property
    def graph(self):
        """The first captured graph (None before capture)."""
        return self.graphs[0] if self.graphs else None

    def describe(self) -> str:
        """The captured segments in order ("graph", or an eager part's
        label), or that the parts run eagerly (not captured)."""
        if self.kinds is None:
            return "eager (not captured)"
        return " + ".join(self.kinds)

    def fn(self) -> None:
        """One eager run of every part."""
        for p in self.parts:
            (p.fn if isinstance(p, Eager) else p)()

    def _record(self, fns, stream, pool):
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (NCCL's watchdog, the stream's
        # prefetch thread pinning host memory) may call CUDA meanwhile
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            for f in fns:
                f()
        self.graphs.append(graph)
        return graph.replay

    def capture(self, stream: torch.cuda.Stream, pool=None) -> None:
        """Record the parts as CUDA graphs on `stream`, in memory pool `pool`
        (None: a pool of their own); raises if they cannot be."""
        before = [dict(c) for c in self.counters]
        segments, kinds, run = [], [], []
        # no garbage collection inside a capture: freeing another graph
        # there (cyclic garbage) would invalidate this one
        gc.disable()
        try:
            for p in self.parts:
                if isinstance(p, Eager):
                    if run:
                        segments.append(self._record(run, stream, pool))
                        kinds.append("graph")
                    segments.append(p.fn)
                    kinds.append(p.label)
                    run = []
                else:
                    run.append(p)
            if run:
                segments.append(self._record(run, stream, pool))
                kinds.append("graph")
        finally:
            gc.enable()
        # the eager parts did not run during the capture: only graphs count
        self.delta = [{k: c[k] - b[k] for k in c} for c, b in zip(self.counters, before)]
        for c, b in zip(self.counters, before):
            c.update(b)
        self.segments, self.kinds = segments, kinds
        self._builds += 1

    def __call__(self, times: int = 1) -> None:
        if self.segments is None:
            self._builds = self._builds or 1
            for _ in range(times):
                self.fn()
            return
        for _ in range(times):
            for s in self.segments:
                s()
        for c, d in zip(self.counters, self.delta):
            for k, v in d.items():
                c[k] += v * times


def capture_all(programs, state, device: torch.device, *, stream=None, pool=None) -> None:
    """Warm every program up once on a side stream (`stream`, or a new
    one), give each tensor of `state` its value back, and capture every
    program on that stream, into memory pool `pool` (None: each graph its
    own). A failure raises naming the program it hit; the programs are
    then to be dropped, the captured ones with the rest."""
    counts = [dict(c) for p in programs for c in p.counters]
    # detached: a clone that tracked gradients would keep each parameter's
    # AccumulateGrad node alive, tied to the default stream, and autograd
    # would then make that stream wait on the capture
    saved = [t.detach().clone() for t in state]
    if stream is None:
        stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for p in programs:
            try:
                p.fn()
            except Exception as e:
                raise RuntimeError(f"warming up {p.name} for its capture failed") from e
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
    torch.cuda.current_stream(device).wait_stream(stream)
    for c, v in zip((c for p in programs for c in p.counters), counts):
        c.update(v)
    for p in programs:
        try:
            p.capture(stream, pool)
        except Exception as e:
            raise RuntimeError(f"capturing {p.name} as a CUDA graph failed") from e
