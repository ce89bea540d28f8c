"""Debug mode: NaN checking, the counterpart of the JAX package's
utils/debug.py.

Inside ``debug_mode`` autograd runs in anomaly mode
(``torch.autograd.set_detect_anomaly``: a backward op that returns a NaN
raises, naming the forward op that made it), and the train step checks
that its loss is finite before the backward and raises FloatingPointError
otherwise, as ``jax_debug_nans`` raises. The check reads the loss on the
host every step, so it costs a synchronisation a step.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """NaN checking for the block when ``nans``. ``disable_jit`` is
    accepted for the JAX package's signature and does nothing: the port
    runs eagerly, with nothing compiled to disable."""
    with torch.autograd.set_detect_anomaly(nans):
        yield
