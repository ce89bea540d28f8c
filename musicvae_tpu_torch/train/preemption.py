"""Graceful preemption: the first SIGTERM or SIGINT becomes a cooperative
stop.

Counterpart of the JAX package's train/preemption.py. Batch schedulers
preempt with SIGTERM and a grace period before SIGKILL; the train loop
(train/trainer.py ``train``) finishes the dispatch in flight, checkpoints
the exact step it reached, and returns normally, so the CLI can say how to
resume. Resume from any step draws the ids a continuous run would
(``make_id_schedule``) and keeps the dispatch size (``dispatch_sizes``).
This class is one process's flag; under multi-process training the loop
decides collectively, once a dispatch, and every process stops when any
of them was signalled (a scheduler may signal only some).
"""

from __future__ import annotations

import signal
import threading


class GracefulStop:
    """First SIGTERM/SIGINT → a cooperative ``requested`` flag.

    Use as a context manager around the training loop, in the process's
    MAIN thread (CPython installs handlers only there; entering from any
    other thread is a no-op: the flag never sets and training runs to
    completion).

    Escalation: handling the first delivery re-arms the signal with its
    PREVIOUS handler, so a second SIGTERM (a scheduler escalating before
    SIGKILL) or a second ^C behaves exactly as it would have without this
    guard: a wedged run can still be killed.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self.requested = False

    def __enter__(self) -> "GracefulStop":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def _handle(self, signum, frame) -> None:
        self.requested = True
        signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))

    def __exit__(self, *exc) -> bool:
        # restore any handler the first delivery hasn't already restored
        for s, h in self._prev.items():
            if signal.getsignal(s) is self._handle:
                signal.signal(s, h)
        self._prev.clear()
        return False
