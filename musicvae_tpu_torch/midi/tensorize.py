"""MIDI tensorization: quantize → rasterize → bar-chunk → crop, and the
roll → SMF export path (SEMANTICS.md §§1-5, §7).

The port's copy of the JAX package's midi/tensorize.py. Ingestion is
host-side numpy (and the native parser of musicvae_tpu_torch/native when
it builds), with the device rasterizer ``events_to_roll`` as a torch
function on an explicit device; export is host-side numpy; the [P] crop
mask is a torch tensor. Normative semantics: musicvae_tpu/midi/SEMANTICS.md.

Rasterization has no dynamic shapes: each note contributes +1 at
(s_on, pitch) and -1 at (s_off, pitch) into a delta grid [T+1, 128]; an
inclusive cumulative sum over time yields live-note counts; the roll is
(count > 0). Padded event slots use s_on == s_off == 0 so their
contributions cancel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from musicvae_tpu_torch.config import MidiSpec
from musicvae_tpu_torch.midi import smf


def quantize_ticks(ticks: np.ndarray, tpq: int, steps_per_quarter: int
                   ) -> np.ndarray:
    """SEMANTICS.md §2: step(t) = floor(t*spq/tpq + 1/2), exact integers."""
    t = np.asarray(ticks, dtype=np.int64)
    return (2 * t * steps_per_quarter + tpq) // (2 * tpq)


def check_time_signatures(timesigs, spec: MidiSpec) -> None:
    """SEMANTICS.md §1: every declared time signature must imply the
    config's bar length — steps/bar = steps_per_quarter · 4·num/den must
    equal spec.steps_per_bar (exact integer cross-multiplication, so
    equivalent meters like 8/8 vs 4/4 pass). A mismatch is a hard
    SMFError: chunking a 3/4 file on a 4/4 grid silently corrupts every
    bar boundary. ``spec.ignore_time_signature`` (CLI
    --ignore-time-signature) forces config-meter chunking anyway.
    ``timesigs``: (num, den) pairs; empty = none declared (SMF default
    4/4, always accepted)."""
    if spec.ignore_time_signature:
        return
    timesigs = tuple(timesigs or ())
    if len(timesigs) > 4:
        # acceptance parity with the native parser, which records at most
        # 4 distinct signatures and fails closed beyond that
        raise smf.SMFError(
            f"file declares {len(timesigs)} distinct time signatures; "
            f"pass --ignore-time-signature to force config-meter chunking")
    spq, spb = spec.steps_per_quarter, spec.steps_per_bar
    cfg_meter = "{}/{}".format(*spec.meter)
    for num, den in timesigs:
        if num <= 0 or den <= 0 or spq * 4 * num != spb * den:
            implied = spq * 4 * num / den if den else float("nan")
            raise smf.SMFError(
                f"file declares time signature {num}/{den} "
                f"(~{implied:g} steps/bar) but the config chunks "
                f"{cfg_meter} bars of {spb} steps; fix the "
                f"corpus or pass --ignore-time-signature "
                f"(MidiSpec.ignore_time_signature) to force "
                f"{cfg_meter} chunking")


def notes_to_events(
    midi: smf.MidiFile,
    spec: MidiSpec,
    max_events: int = None,
) -> Tuple[np.ndarray, int]:
    """Host-side: quantize a parsed MIDI file into a padded event tensor.

    Returns (events[max_events, 3] int32 with columns (s_on, s_off, pitch),
    total_steps) where total_steps is the §3 bar-padded length. Padded slots
    are all-zero (s_on == s_off ⇒ no contribution). ``max_events`` defaults
    to ``spec.max_events``.
    """
    if max_events is None:
        max_events = spec.max_events
    check_time_signatures(midi.time_signatures, spec)
    spq = spec.steps_per_quarter
    spb = spec.steps_per_bar
    n = len(midi.notes)
    if n > max_events:
        # SMFError (not ValueError): an input-data limit, and the native
        # path maps its overflow to SMFError — both paths must surface
        # identically to callers (the CLI's clean-error handling included)
        raise smf.SMFError(
            f"{n} notes > max_events={max_events}; raise the cap with "
            f"--max-events (MidiSpec.max_events)")
    events = np.zeros((max_events, 3), dtype=np.int32)
    max_off = 0
    if n:
        starts = quantize_ticks(
            np.array([nt.start_tick for nt in midi.notes]),
            midi.ticks_per_quarter, spq)
        ends = quantize_ticks(
            np.array([nt.end_tick for nt in midi.notes]),
            midi.ticks_per_quarter, spq)
        ends = np.maximum(ends, starts + 1)          # §2 min length 1
        pitches = np.array([nt.pitch for nt in midi.notes], dtype=np.int64)
        events[:n, 0] = starts
        events[:n, 1] = ends
        events[:n, 2] = pitches
        max_off = int(ends.max())
    total_steps = max(1, -(-max_off // spb)) * spb   # §3: ceil to bars, >= 1
    return events, total_steps


def events_to_roll(events, total_steps: int, num_pitches: int = 128,
                   device=None) -> torch.Tensor:
    """Device-side rasterization (§3). events[N,3] int32 → roll[T,P] f32
    on ``device``: a scatter-add of ±1 into a flat [T+1, P] int32 delta
    grid, a cumulative sum over time, ``> 0``.

    Events whose s_off exceeds total_steps are clipped; events entirely
    outside [0, total_steps) contribute nothing.
    """
    ev = torch.as_tensor(events, device=device).long()
    s_on = ev[:, 0].clamp(0, total_steps)
    s_off = ev[:, 1].clamp(0, total_steps)
    pitch = ev[:, 2].clamp(0, num_pitches - 1)
    ones = torch.ones(ev.shape[0], dtype=torch.int32, device=ev.device)
    delta = torch.zeros((total_steps + 1) * num_pitches, dtype=torch.int32,
                        device=ev.device)
    delta.index_add_(0, s_on * num_pitches + pitch, ones)
    delta.index_add_(0, s_off * num_pitches + pitch, -ones)
    count = delta.view(total_steps + 1, num_pitches)[:-1].cumsum(
        0, dtype=torch.int32)
    return (count > 0).to(torch.float32)


def chunk_bars(roll, steps_per_bar: int = 96):
    """§4: roll[T,P] → bars[T/spb, spb, P] by reshape (T must divide)."""
    t, p = roll.shape
    if t % steps_per_bar:
        raise ValueError(f"T={t} not a multiple of steps_per_bar")
    return roll.reshape(t // steps_per_bar, steps_per_bar, p)


def pitch_mask(spec: MidiSpec, device=None) -> torch.Tensor:
    """§5 crop mask over the pitch axis: f32 [P], 1 inside [lo, hi)."""
    p = torch.arange(spec.num_pitches, device=device)
    return ((p >= spec.pitch_lo) & (p < spec.pitch_hi)).to(torch.float32)


def crop_view(roll_or_bars, spec: MidiSpec):
    """§5 hard slice along the last (pitch) axis, for export (an array or
    a tensor, as a view)."""
    return roll_or_bars[..., spec.pitch_lo:spec.pitch_hi]


def midi_bytes_to_bars(data: bytes, spec: MidiSpec,
                       max_events: int = None,
                       use_native: bool = True,
                       device=None) -> torch.Tensor:
    """Full pipeline: SMF bytes → bars[n_bars, steps_per_bar, 128] float32
    on ``device``.

    Host-side parse+quantize runs through the C++ component
    (musicvae_tpu_torch/native) when built — identical semantics; the
    pure-Python codec is the fallback. ``max_events`` defaults to
    ``spec.max_events``.
    """
    if max_events is None:
        max_events = spec.max_events
    events = total_steps = None
    if use_native:
        from musicvae_tpu_torch import native
        if native.available():
            try:
                nat_notes, tpq, _, timesigs = native.parse_smf(
                    data, max_notes=max_events)
                check_time_signatures(timesigs, spec)
                events, total_steps = native.quantize_events(
                    nat_notes, tpq, spec.steps_per_quarter,
                    spec.steps_per_bar, max_events)
            except ValueError as e:
                raise smf.SMFError(str(e)) from None
    if events is None:
        midi = smf.parse_smf(data)
        events, total_steps = notes_to_events(midi, spec, max_events)
    roll = events_to_roll(events, total_steps, spec.num_pitches, device)
    return chunk_bars(roll, spec.steps_per_bar)


def events_to_roll_np(events: np.ndarray, total_steps: int,
                      num_pitches: int = 128) -> np.ndarray:
    """Host (numpy) rasterization — same §3 semantics as events_to_roll;
    corpus preprocessing is host-side work."""
    s_on = np.clip(events[:, 0], 0, total_steps)
    s_off = np.clip(events[:, 1], 0, total_steps)
    pitch = np.clip(events[:, 2], 0, num_pitches - 1)
    delta = np.zeros((total_steps + 1, num_pitches), dtype=np.int32)
    np.add.at(delta, (s_on, pitch), 1)
    np.add.at(delta, (s_off, pitch), -1)
    count = np.cumsum(delta[:-1], axis=0)
    return (count > 0).astype(np.float32)


def corpus_to_bars(datas: Sequence[bytes], spec: MidiSpec,
                   max_events: int = None, as_uint8: bool = False,
                   use_native: bool = True) -> list:
    """Corpus tensorization, all host-side: one multithreaded C++ pass when
    the native library is built (and ``use_native``), else the pure-Python
    + numpy path; the two give identical bars. ``max_events`` defaults to
    ``spec.max_events``.

    Returns a list of [n_bars_i, steps_per_bar, 128] arrays — float32 by
    default, uint8 with ``as_uint8`` (the dataset cache format; the f32
    cast happens per batch / on device).
    """
    from musicvae_tpu_torch import native

    if max_events is None:
        max_events = spec.max_events
    dtype = np.uint8 if as_uint8 else np.float32
    if use_native and native.available():
        try:
            rolls = native.tensorize_corpus(
                list(datas), spec.steps_per_quarter, spec.steps_per_bar,
                max_notes=max_events,
                strict_timesig=not spec.ignore_time_signature)
        except ValueError as e:
            raise smf.SMFError(str(e)) from None
        return [(r if as_uint8 else r.astype(np.float32)).reshape(
                    -1, spec.steps_per_bar, spec.num_pitches)
                for r in rolls]

    out = []
    for data in datas:
        events, total = notes_to_events(smf.parse_smf(data), spec,
                                        max_events)
        roll = events_to_roll_np(events, total, spec.num_pitches)
        out.append(roll.astype(dtype).reshape(-1, spec.steps_per_bar,
                                              spec.num_pitches))
    return out


def roll_to_notes(roll: np.ndarray, spec: MidiSpec,
                  ticks_per_quarter: int = 480) -> list:
    """Maximal horizontal runs of 1s become ``smf.Note``s, sorted by
    (start, pitch, end) (host side, numpy): ``roll_to_note_arrays`` as
    note objects."""
    pitch, start, end = roll_to_note_arrays(roll, spec, ticks_per_quarter)
    return [smf.Note(pitch=int(p), start_tick=int(s), end_tick=int(e),
                     velocity=spec.velocity)
            for p, s, e in zip(pitch, start, end)]


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
