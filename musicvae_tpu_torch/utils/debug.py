"""Debug mode: NaN checking and eager runs, the counterpart of the JAX
package's utils/debug.py.

Inside ``debug_mode`` autograd runs in anomaly mode
(``torch.autograd.set_detect_anomaly``: a backward op that returns a NaN
raises, naming the forward op that made it), and the train step checks
that its loss is finite before the backward and raises FloatingPointError
otherwise, as ``jax_debug_nans`` raises. The check reads the loss on the
host every step, so it costs a synchronisation a step, and the train
dispatches, the evals, the sweeps and the reconstruction run eagerly, not
as captured CUDA graphs (utils/graphs.py). ``disable_jit`` runs them
eagerly too, as ``jax_disable_jit`` runs the JAX package's programs op
by op.
"""

from __future__ import annotations

import contextlib

import torch

_jit_disabled = 0          # depth of debug_mode(disable_jit=True) blocks


def jit_disabled() -> bool:
    """Whether a ``debug_mode(disable_jit=True)`` block is open."""
    return _jit_disabled > 0


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """NaN checking for the block when ``nans``; with ``disable_jit``
    every program that would run as a captured CUDA graph runs eagerly."""
    global _jit_disabled
    _jit_disabled += int(disable_jit)
    try:
        with torch.autograd.set_detect_anomaly(nans):
            yield
    finally:
        _jit_disabled -= int(disable_jit)
