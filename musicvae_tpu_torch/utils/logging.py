"""Metrics logging: console + JSONL (+ TensorBoard when available).

Counterpart of the JAX package's utils/logging.py. The train step returns
scalars; this host-side writer is the only logging I/O.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 use_tensorboard: bool = True, echo: bool = True):
        self.echo = echo
        self._jsonl = None
        self._tb = None
        self._t0 = time.monotonic()
        self._last = (0, self._t0)  # (step, time) for steps/sec
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                except ImportError:
                    pass                     # tensorboardX is optional
                else:
                    self._tb = SummaryWriter(log_dir)

    def __call__(self, step: int, metrics: Dict) -> None:
        vals = {k: float(v) for k, v in metrics.items()}
        now = time.monotonic()
        dstep, dt = step - self._last[0], now - self._last[1]
        if dstep > 0 and dt > 0:
            vals["steps_per_sec"] = dstep / dt
        self._last = (step, now)
        if self.echo:
            msg = " ".join(f"{k}={v:.5g}" for k, v in sorted(vals.items()))
            print(f"step {step}: {msg}", file=sys.stderr)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **vals}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in vals.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
