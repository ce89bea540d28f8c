"""Pitch-crop mask and the roll → SMF export path (SEMANTICS.md §5, §7).

Host-side numpy, copied from the JAX package's midi/tensorize.py, plus the
[P] crop mask as a torch tensor. Ingestion (SMF → bars) comes with the
data pipeline in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from musicvae_tpu_torch.config import MidiSpec
from musicvae_tpu_torch.midi import smf


def pitch_mask(spec: MidiSpec, device=None) -> torch.Tensor:
    """§5 crop mask over the pitch axis: f32 [P], 1 inside [lo, hi)."""
    p = torch.arange(spec.num_pitches, device=device)
    return ((p >= spec.pitch_lo) & (p < spec.pitch_hi)).to(torch.float32)


def roll_to_note_arrays(roll: np.ndarray, spec: MidiSpec,
                        ticks_per_quarter: int = 480):
    """Maximal horizontal runs of 1s → (pitch, start_tick, end_tick)
    arrays, sorted by (start, pitch, end)."""
    roll = np.asarray(roll)
    if roll.ndim == 3:  # bars → flat roll
        roll = roll.reshape(-1, roll.shape[-1])
    binary = roll > spec.binarize_threshold if roll.dtype.kind == "f" \
        else roll.astype(bool)
    if ticks_per_quarter % spec.steps_per_quarter:
        raise ValueError("tpq must be a multiple of steps_per_quarter "
                         "for exact round-trip (SEMANTICS.md §7)")
    ticks_per_step = ticks_per_quarter // spec.steps_per_quarter
    # pitch-major padded layout: each pitch's column is an independent
    # False-bracketed lane, so one diff yields every run boundary; within
    # a pitch the k-th start pairs with the k-th end (runs don't nest)
    t_total, n_pitch = binary.shape
    padded = np.zeros((n_pitch, t_total + 2), dtype=bool)
    padded[:, 1:-1] = binary.T
    on = padded[:, 1:] & ~padded[:, :-1]
    off = ~padded[:, 1:] & padded[:, :-1]
    pitch, start_step = np.nonzero(on)
    _, end_step = np.nonzero(off)
    start = start_step.astype(np.int64) * ticks_per_step
    end = end_step.astype(np.int64) * ticks_per_step
    idx = np.lexsort((end, pitch, start))
    return pitch[idx], start[idx], end[idx]


def bars_to_midi_bytes(bars: np.ndarray, spec: MidiSpec,
                       ticks_per_quarter: int = 480) -> bytes:
    """[N,T,P] (or [T,P]) binary bars → SMF format-0 bytes, declaring the
    config's meter and tempo."""
    pitch, start, end = roll_to_note_arrays(np.asarray(bars), spec,
                                            ticks_per_quarter)
    tempo = int(round(60_000_000 / spec.tempo_bpm))
    return smf.write_smf_arrays(pitch, start, end, ticks_per_quarter,
                                tempo, velocity=spec.velocity,
                                meter=spec.meter)
