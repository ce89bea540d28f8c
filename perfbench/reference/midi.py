"""The reference's MIDI: a plain writer and reader of the standard MIDI
files a served response carries (format 0, one track: the tempo and
time-signature meta events, then a note-on and a note-off a note at
``velocity``, a note being a maximal run of on cells of one pitch), at 480
ticks a quarter on the configuration's grid."""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

TPQ = 480


def _grid(spec: dict) -> Tuple[int, int]:
    """(grid steps a bar, ticks a grid step)."""
    midi = spec["midi"]
    steps = midi["bar_steps"] or (midi["steps_per_quarter"]
                                  * midi["quarters_per_bar"])
    return steps, TPQ // midi["steps_per_quarter"]


def _varlen(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.insert(0, 0x80 | (v & 0x7F))
        v >>= 7
    return bytes(out)


def _meter(spec: dict) -> Tuple[int, int]:
    midi = spec["midi"]
    if midi["meter_numerator"] > 0 and midi["meter_denominator"] > 0:
        return midi["meter_numerator"], midi["meter_denominator"]
    return midi["quarters_per_bar"], 4


def write(bars: np.ndarray, spec: dict) -> bytes:
    """[N, T, P] 0/1 bars → the SMF bytes: notes in order of (start, pitch,
    end), each a note-on at its start and a note-off at its end, events in
    order of tick with a tick's note-offs first."""
    _, tps = _grid(spec)
    roll = np.asarray(bars).reshape(-1, bars.shape[-1]).astype(bool)
    notes: List[Tuple[int, int, int]] = []
    for pitch in range(roll.shape[1]):
        edges = np.diff(np.concatenate([[0], roll[:, pitch], [0]]).astype(
            np.int8))
        for s, e in zip(np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)):
            notes.append((int(s) * tps, pitch, int(e) * tps))
    notes.sort()
    vel = spec["midi"]["velocity"]
    events = []
    for start, pitch, end in notes:
        events.append((start, 1, bytes([0x90, pitch, vel])))
        events.append((end, 0, bytes([0x80, pitch, 0])))
    events.sort(key=lambda e: (e[0], e[1]))
    tempo = int(round(60_000_000 / spec["midi"]["tempo_bpm"]))
    num, den = _meter(spec)
    track = bytearray(b"\x00\xff\x51\x03" + tempo.to_bytes(3, "big"))
    track += b"\x00\xff\x58\x04" + bytes([num, den.bit_length() - 1, 24, 8])
    last = 0
    for tick, _, payload in events:
        track += _varlen(tick - last) + payload
        last = tick
    track += b"\x00\xff\x2f\x00"
    return (struct.pack(">4sIHHH", b"MThd", 6, 0, 1, TPQ)
            + struct.pack(">4sI", b"MTrk", len(track)) + bytes(track))


def read(data: bytes, spec: dict, n_bars: int) -> np.ndarray:
    """The [n_bars, T, P] uint8 bars of an SMF file of that form; raises
    ValueError on anything else (another format, a note outside the bars,
    an event other than note-on, note-off and meta)."""
    steps, tps = _grid(spec)
    pitches = spec["midi"]["num_pitches"]
    if data[:4] != b"MThd" or struct.unpack(">IHHH", data[4:14]) != \
            (6, 0, 1, TPQ) or data[14:18] != b"MTrk":
        raise ValueError("not a one-track format-0 file at 480 ticks")
    (length,) = struct.unpack(">I", data[18:22])
    track, pos = data[22:22 + length], 0
    if 22 + length != len(data):
        raise ValueError("bytes after the track")
    roll = np.zeros((n_bars * steps, pitches), np.uint8)
    tick, on = 0, {}
    while pos < len(track):
        delta = 0
        while True:
            b = track[pos]
            pos += 1
            delta = (delta << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        tick += delta
        status = track[pos]
        if status == 0xFF:
            n = track[pos + 2]
            pos += 3 + n
            continue
        pitch, vel = track[pos + 1], track[pos + 2]
        pos += 3
        if status == 0x90 and vel > 0:
            on[pitch] = tick
        elif status in (0x80, 0x90):
            start = on.pop(pitch)
            if start % tps or tick % tps or tick > roll.shape[0] * tps:
                raise ValueError("a note off the grid or past the bars")
            roll[start // tps:tick // tps, pitch] = 1
        else:
            raise ValueError(f"unexpected status byte {status:#x}")
    if on:
        raise ValueError("a note without its note-off")
    return roll.reshape(n_bars, steps, pitches)
