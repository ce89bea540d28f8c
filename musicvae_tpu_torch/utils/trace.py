"""The port's tracer: named spans and counters where the work happens (the
train dispatch, the graph programs, the kernels' build, the streaming
producer, the TCP service), on the clock of the profiler's events.

Two levels:

- Always on: a span adds one to its name's count and its seconds to its
  name's total (two ``time.perf_counter_ns`` reads and a dict update
  under a lock), and ``count`` and ``peak`` update counters. The
  operator's ``{"cmd": "stats"}`` answer, ``graphs.Program.info`` and
  ``_kernels.build_info`` read these.
- While a ``torch.profiler`` runs in the process (from ``profile.start()``
  to ``stop()``, ``torch.autograd.profiler._is_profiler_enabled``): a span
  is also kept as an event, ``{"name", "id", "parent", "rid", "thread",
  "start_ns", "end_ns", "attrs"}``, and entered as a profiler range of the
  same name (the user range ``torch.profiler.record_function`` draws,
  entered by ``_RecordFunctionFast``, whose entry runs no Python). Its
  times are ``time.time_ns()``, the clock of the profiler's events
  (``start_ns()``), read next to the range's own, so every event lines up
  with the device's operations in the profiler's trace, and the trace's
  host ranges name the program's stages.

Nothing else turns events on: no flag, no environment variable. The
newest ``EVENTS_KEPT`` events are kept, so a long run under the profiler
holds a bounded number.

While a graph is captured on a thread (``capture_counts``), ``count``
on that thread adds to the capture's record instead: capture runs
nothing, and the capturing program adds the record at each replay
(``add_counts``), so a counter counts what the card is given to do.

Spans nest per thread: a span's ``parent`` is the ``id`` of the span open
around it on the same thread. A span without a ``rid`` takes its parent's,
so the stages of one request carry its id; ``tag`` gives the request's id
to the spans already open when it becomes known. ``record`` adds a span
whose ends two threads saw (a request's wait in a queue that another
thread drains): it enters the totals, and the events while profiling, but
draws no profiler range. Spans, counters and events may be added from any
thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import operator
import threading
import time
from typing import Any, Deque, Dict, Iterator, List

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _Range

_lock = threading.Lock()
_totals: Dict[str, List] = {}          # name → [count, seconds]
_counters: Dict[str, float] = {}
EVENTS_KEPT = 1 << 16
_events: Deque[dict] = collections.deque(maxlen=EVENTS_KEPT)
_ids = itertools.count(1)
_local = threading.local()
_ranges_ready = False     # a profiler range was entered once in this process
_call = operator.call


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(name: str, seconds: float) -> None:
    with _lock:
        total = _totals.get(name)
        if total is None:
            _totals[name] = [1, seconds]
        else:
            total[0] += 1
            total[1] += seconds


def _ready_ranges() -> None:
    """Enter and leave one profiler range while none runs: the first range
    of a process starts about 1 ms away from the clock read next to it,
    later ones within microseconds."""
    global _ranges_ready
    _ranges_ready = True
    with _Range("trace.ready"):
        pass


class Span:
    """One span (``span``): after it closes, ``seconds`` is its length on
    the host clock. ``set`` adds attributes while it is open."""

    __slots__ = ("name", "rid", "attrs", "id", "parent", "seconds", "_t0",
                 "_start_ns", "_range")

    def __init__(self, name: str, rid: Any, attrs: dict):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.seconds = 0.0
        self._range = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            # the range's entry and the clock's read called from C, with
            # no bytecode between them: no other thread can take the
            # interpreter lock after the profiler has read the start
            _, self._start_ns = map(_call, (self._range.__enter__,
                                            time.time_ns))
        elif not _ranges_ready:
            _ready_ranges()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = (time.perf_counter_ns() - self._t0) * 1e-9
        _stack().pop()
        _add(self.name, self.seconds)
        if self._range is not None:
            end_ns, _ = map(_call, (time.time_ns, self._range.__exit__))
            self._range = None
            event = {"name": self.name, "id": self.id, "parent": self.parent,
                     "rid": self.rid, "thread": threading.get_ident(),
                     "start_ns": self._start_ns, "end_ns": end_ns,
                     "attrs": self.attrs}
            with _lock:
                _events.append(event)


def span(name: str, rid: Any = None, **attrs) -> Span:
    """A context manager that traces the block as span ``name`` with
    request id ``rid`` (else its parent's) and attributes ``attrs``."""
    return Span(name, rid, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A span that ran from ``start_ns`` to ``end_ns`` (``time.time_ns()``
    readings, possibly taken on other threads), under the span open on
    this thread."""
    _add(name, (end_ns - start_ns) * 1e-9)
    if _profiler._is_profiler_enabled:
        stack = _stack()
        parent = stack[-1] if stack else None
        event = {"name": name, "id": next(_ids),
                 "parent": parent.id if parent is not None else None,
                 "rid": parent.rid if parent is not None else None,
                 "thread": threading.get_ident(), "start_ns": start_ns,
                 "end_ns": end_ns, "attrs": attrs}
        with _lock:
            _events.append(event)


def tag(rid: Any) -> None:
    """Give request id ``rid`` to the spans open on this thread that have
    none."""
    for s in _stack():
        if s.rid is None:
            s.rid = rid


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` (to the capture's record while this
    thread captures a graph, ``capture_counts``)."""
    record = getattr(_local, "capture", None)
    if record is not None:
        record[name] = record.get(name, 0) + n
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def capturing() -> bool:
    """Whether this thread is capturing a graph (``capture_counts``)."""
    return getattr(_local, "capture", None) is not None


@contextlib.contextmanager
def capture_counts() -> Iterator[Dict[str, float]]:
    """While this thread captures a graph: the counts ``count`` is given on
    it, into the dict this yields, which is what one replay counts."""
    record: Dict[str, float] = {}
    _local.capture = record
    try:
        yield record
    finally:
        _local.capture = None


def add_counts(record: Dict[str, float]) -> None:
    """Count one replay of a graph whose capture recorded ``record``."""
    for name, n in record.items():
        count(name, n)


def peak(name: str, value: float) -> None:
    """Raise counter ``name`` to ``value`` if that is higher."""
    with _lock:
        if name not in _counters or value > _counters[name]:
            _counters[name] = value


def totals() -> Dict[str, List]:
    """{span name: [count, seconds]} since the last ``reset``."""
    with _lock:
        return {k: list(v) for k, v in _totals.items()}


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def snapshot() -> Dict[str, Any]:
    """The totals, the counters, the kernel launches
    (ops/_kernels.py ``LAUNCHES``) and the events kept so far (the newest
    ``EVENTS_KEPT``)."""
    from musicvae_tpu_torch.ops import _kernels

    with _lock:
        return {"totals": {k: list(v) for k, v in _totals.items()},
                "counters": dict(_counters),
                "kernels": dict(_kernels.LAUNCHES),
                "events": list(_events)}


def reset() -> None:
    """Clear the totals, the counters and the events (not the kernel
    launches: ``_kernels.reset_launches``)."""
    with _lock:
        _totals.clear()
        _counters.clear()
        _events.clear()

