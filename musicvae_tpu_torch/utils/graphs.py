"""Captured CUDA graphs: the port's counterpart of the JAX package's
jitted programs.

A ``Program`` wraps a function of no arguments that reads its inputs from
tensors that outlive it (static buffers its caller refills, the train
state, the resident data) and returns its outputs. On a CUDA device,
outside ``utils/debug.py`` ``debug_mode``, its first run is eager on the
device's capture stream: the one-time set-ups (the kernels' build, cuDNN's
and cuBLAS's choices, the BCE kernels' and cuBLAS's workspaces of that
stream) happen there, outside any capture. Its second run captures it into
a ``torch.cuda.CUDAGraph`` and replays it, and so does every run after:
one host launch for the whole function. Elsewhere (the CPU, a caller that
asks for eager runs, ``debug_mode``) every run is eager: the same function
over the same buffers.

Capture runs nothing; the function's writes happen at each replay, on the
caller's current stream. The generators the function draws from are
registered with the graph, so each replay draws the numbers an eager run
draws and advances the generators as far. The kernel launches a capture
records (ops/_kernels.py ``LAUNCHES``), and the tracer's counters it is
given (utils/trace.py ``capture_counts``), are counted at every replay.
A function may hold NCCL collectives (the data-parallel train step's
all-reduce): their communicator exists before the capture, made by an
earlier collective or by the eager first run, and every process of the
group captures and replays the same sequence of them. The
outputs of a replay are the graph's own tensors, which the next replay
overwrites: a caller that keeps them copies them. A failure to capture or
to replay raises; nothing falls back to the eager run.

``StaticProgram`` is one argument signature of a function of tensors, the
counterpart of one program of a jitted function: its static input buffers,
generators of its own, and a ``Program`` over them; a call copies the
arguments in and the generator states in and out, and returns a copy of
the outputs.

Every program on a device is warmed up and captured on the one capture
stream, so graphs that launch the BCE sum kernels (K2, K4) or the conv
epilogue's backward share that stream's workspace (ops/_kernels.py
``workspace``). Replays, and
warm-ups, are ordered on the caller's current stream: the programs of one
thread never run two at once, and a process runs its programs from one
thread at a time (the train loop, serve's device lock or batcher).

Capture runs in ``thread_local`` mode: other threads (a serve reload
building its state on the card, a checkpoint writer) may use the card
while one thread captures. One thread runs a program at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from musicvae_tpu_torch.ops import _kernels
from musicvae_tpu_torch.utils import debug, trace

_capture_streams: Dict[torch.device, Any] = {}


def capture_stream(device: torch.device):
    """The stream every program on ``device`` warms up and is captured
    on, made at first use."""
    s = _capture_streams.get(device)
    if s is None:
        s = _capture_streams[device] = torch.cuda.Stream(device)
    return s


def enabled(device: torch.device) -> bool:
    """Whether programs on ``device`` run as graphs now: a CUDA device,
    outside anomaly mode and ``debug_mode(disable_jit=True)``."""
    return (device.type == "cuda" and not torch.is_anomaly_enabled()
            and not debug.jit_disabled())


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


class Program:
    """``fn`` run as one captured CUDA graph (see the module docstring).
    ``generators``: every generator ``fn`` draws from; ``graphable``
    False runs it eagerly always (a body with collectives a graph cannot
    hold: gloo's, tensor parallelism's).
    ``info`` after the capture: ``capture_ms`` and ``instantiate_ms``
    (host clock: the lengths of the ``graph.capture`` and
    ``graph.instantiate`` spans, utils/trace.py) and ``pool_bytes``, the
    memory the device's allocator reserved during the capture (the
    graph's private pool); ``replays`` counts the replays. The first,
    eager run is the span ``graph.warmup``."""

    def __init__(self, fn: Callable[[], Any], device: torch.device,
                 generators: Sequence[torch.Generator] = (),
                 graphable: bool = True):
        self.fn, self.device = fn, torch.device(device)
        self.generators = tuple(generators)
        self.graphable = graphable
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}
        self.counted: Dict[str, float] = {}
        self.info: Dict[str, float] = {}
        self.replays = 0
        self._warm = False

    def __call__(self):
        if not (self.graphable and enabled(self.device)):
            return self.fn()
        if self.graph is None:
            if not self._warm:
                self._warm = True
                return self._warm_up()
            self._capture()
        self.graph.replay()
        self.replays += 1
        _kernels.count_replay(self.launches)
        trace.add_counts(self.counted)
        return self.outputs

    def _warm_up(self):
        cur = torch.cuda.current_stream(self.device)
        stream = capture_stream(self.device)
        stream.wait_stream(cur)
        with trace.span("graph.warmup"), torch.cuda.stream(stream):
            out = self.fn()
        cur.wait_stream(stream)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.generators:
            graph.register_generator_state(g)
        reserved = torch.cuda.memory_reserved(self.device)
        stream = capture_stream(self.device)
        with trace.span("graph.capture") as capture, \
                torch.cuda.stream(stream), \
                _kernels.capture_launches(stream.cuda_stream) as launches, \
                trace.capture_counts() as counted:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = self.fn()
            finally:
                graph.capture_end()
        with trace.span("graph.instantiate") as inst:
            graph.instantiate()
            pool = torch.cuda.memory_reserved(self.device) - reserved
            inst.set(pool_bytes=pool)
        self.info = {"capture_ms": capture.seconds * 1e3,
                     "instantiate_ms": inst.seconds * 1e3,
                     "pool_bytes": pool}
        self.graph, self.outputs = graph, outputs
        self.launches, self.counted = launches, counted


def signature(given: Dict[Any, torch.Tensor]) -> tuple:
    """The key of a call's given tensors: each one's name, shape and
    dtype."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in given.items())


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(v) for v in out)
    return out


class StaticProgram:
    """One argument signature of a function of tensors, run as a
    ``Program``: ``body(static, generators)`` reads its inputs from
    ``static``, buffers shaped as ``given``'s tensors (name → tensor), and
    draws from ``generators``, ``draws`` generators of its own on
    ``device``, registered with the graph. A call copies the given values
    into the buffers (enqueued device copies), sets each own generator to
    its caller's generator's state, runs the program, gives each caller's
    generator the state its own reached, and returns a copy of the outputs
    (a replay's outputs are the graph's, which the next replay overwrites).
    The draws, and so the outputs, are an eager run's on the callers'
    generators. Not for two threads at once."""

    def __init__(self, body: Callable[[dict, list], Any],
                 device: torch.device, given: Dict[Any, torch.Tensor],
                 draws: int = 0):
        dev = torch.device(device)
        self.static = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                       for k, v in given.items()}
        self.generators = [torch.Generator(dev) for _ in range(draws)]
        self.program = Program(lambda: body(self.static, self.generators),
                               dev, self.generators)

    def __call__(self, given: Dict[Any, torch.Tensor],
                 generators: Sequence[torch.Generator] = ()):
        for k, v in given.items():
            self.static[k].copy_(v)
        for own, g in zip(self.generators, generators, strict=True):
            own.set_state(g.get_state())
        out = _clone(self.program())
        for own, g in zip(self.generators, generators):
            g.set_state(own.get_state())
        return out
