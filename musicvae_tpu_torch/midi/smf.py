"""Standard MIDI File (SMF) reader/writer — pure Python, host side.

The port's own copy of the JAX package's codec (musicvae_tpu/midi/smf.py),
byte for byte in behaviour. Semantics are normative in
musicvae_tpu/midi/SEMANTICS.md §1 and §7. The port uses
``write_smf_arrays`` to export generated bars and ``parse_smf`` to read
exports back.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Note:
    pitch: int        # 0..127
    start_tick: int   # absolute ticks, >= 0
    end_tick: int     # absolute ticks, > start_tick (after open-note closing)
    velocity: int     # 1..127 (onset velocity)


@dataclasses.dataclass(frozen=True)
class MidiFile:
    ticks_per_quarter: int
    notes: Tuple[Note, ...]          # sorted by (start_tick, pitch, end_tick)
    tempo_us_per_quarter: int = 500_000   # first tempo meta, default 120bpm
    # DISTINCT declared time signatures (numerator, denominator) in order
    # of appearance across all tracks; empty = none declared (SMF default
    # 4/4). The tensorizer validates these against MidiSpec so a 3/4 or
    # 6/8 corpus can never silently mis-chunk into 4/4 bars
    # (midi/tensorize.check_time_signatures, SEMANTICS.md §1).
    time_signatures: Tuple[Tuple[int, int], ...] = ()


class SMFError(ValueError):
    pass


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------

def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    """Variable-length quantity; returns (value, new_pos)."""
    value = 0
    for _ in range(4):
        if pos >= len(data):
            raise SMFError("truncated varlen")
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos
    raise SMFError("varlen too long")


def parse_smf(data: bytes) -> MidiFile:
    """Parse SMF bytes (format 0/1) into a merged, sorted note list.

    SEMANTICS.md §1: tracks merged, channels ignored, note_on vel=0 is
    note_off, FIFO open-note matching, open notes closed at track end.
    """
    if len(data) < 14 or data[:4] != b"MThd":
        raise SMFError("not an SMF file (missing MThd)")
    hlen, fmt, ntrks, division = struct.unpack(">IHHH", data[4:14])
    if hlen < 6:
        raise SMFError("bad MThd length")
    if division & 0x8000:
        raise SMFError("SMPTE division unsupported (SEMANTICS.md §1)")
    if division == 0:
        raise SMFError("zero ticks-per-quarter")
    if fmt not in (0, 1):
        raise SMFError(f"unsupported SMF format {fmt}")

    pos = 8 + hlen
    notes: List[Note] = []
    tempo: Optional[int] = None
    timesigs: List[Tuple[int, int]] = []

    for _ in range(ntrks):
        if pos + 8 > len(data):
            break  # tolerate short files with fewer tracks than declared
        if data[pos:pos + 4] != b"MTrk":
            raise SMFError("expected MTrk chunk")
        (tlen,) = struct.unpack(">I", data[pos + 4:pos + 8])
        if pos + 8 + tlen > len(data):
            raise SMFError("truncated event")  # declared length beyond EOF
        track = data[pos + 8:pos + 8 + tlen]
        pos += 8 + tlen

        tick = 0
        running_status = 0
        # FIFO of open (start_tick, velocity) per pitch
        open_notes: dict = {}
        tpos = 0
        last_tick = 0
        while tpos < len(track):
            delta, tpos = _read_varlen(track, tpos)
            tick += delta
            if tick > 0x7FFFFFFF:
                # keep acceptance parity with the JAX package's int32
                # native parser instead of silently diverging on extreme
                # cumulative delta times
                raise SMFError("tick overflow (> INT32_MAX)")
            last_tick = tick
            if tpos >= len(track):
                raise SMFError("truncated event")
            status = track[tpos]
            if status & 0x80:
                tpos += 1
                if status < 0xF0:
                    running_status = status
            else:
                if running_status == 0:
                    raise SMFError("data byte without running status")
                status = running_status

            kind = status & 0xF0
            if kind in (0x80, 0x90):  # note off / note on
                if tpos + 2 > len(track):
                    raise SMFError("truncated note event")
                pitch, vel = track[tpos], track[tpos + 1]
                if pitch > 127:
                    # a data byte with the high bit set is malformed SMF
                    raise SMFError("invalid pitch data byte")
                if vel > 127:
                    # same rule for the velocity byte — otherwise parse
                    # accepts a Note the writer would reject (round-trip
                    # asymmetry; the native parser mirrors this check)
                    raise SMFError("invalid velocity data byte")
                tpos += 2
                is_on = kind == 0x90 and vel > 0
                if is_on:
                    open_notes.setdefault(pitch, []).append((tick, vel))
                else:
                    stack = open_notes.get(pitch)
                    if stack:
                        start, v = stack.pop(0)  # FIFO (§1)
                        if tick > start:
                            notes.append(Note(pitch, start, tick, v))
                        # zero-length in ticks: dropped here; quantization
                        # min-length (§2) only applies to tick-positive notes
            elif kind in (0xA0, 0xB0, 0xE0):  # 2-byte channel messages
                if tpos + 2 > len(track):
                    raise SMFError("truncated event")
                tpos += 2
            elif kind in (0xC0, 0xD0):        # 1-byte channel messages
                if tpos + 1 > len(track):
                    raise SMFError("truncated event")
                tpos += 1
            elif status == 0xFF:              # meta
                if tpos >= len(track):
                    raise SMFError("truncated meta event")
                meta_type = track[tpos]
                tpos += 1
                mlen, tpos = _read_varlen(track, tpos)
                if tpos + mlen > len(track):
                    raise SMFError("truncated event")
                payload = track[tpos:tpos + mlen]
                tpos += mlen
                if meta_type == 0x51 and mlen == 3 and tempo is None:
                    tempo = int.from_bytes(payload, "big")
                if meta_type == 0x58 and mlen >= 2:
                    # time signature: numerator, denominator = 2^dd
                    # (clock/32nd bytes ignored — grid-irrelevant)
                    ts = (payload[0], 1 << payload[1])
                    if ts not in timesigs:
                        timesigs.append(ts)
                if meta_type == 0x2F:         # end of track
                    break
            elif status in (0xF0, 0xF7):      # sysex
                slen, tpos = _read_varlen(track, tpos)
                if tpos + slen > len(track):
                    raise SMFError("truncated event")
                tpos += slen
            else:
                raise SMFError(f"unknown status byte 0x{status:02x}")

        # close notes left open at end of track (§1)
        for pitch, stack in open_notes.items():
            for start, v in stack:
                if last_tick > start:
                    notes.append(Note(pitch, start, last_tick, v))

    notes.sort(key=lambda n: (n.start_tick, n.pitch, n.end_tick))
    return MidiFile(
        ticks_per_quarter=division,
        notes=tuple(notes),
        tempo_us_per_quarter=tempo if tempo is not None else 500_000,
        time_signatures=tuple(timesigs),
    )


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def _varlen(value: int) -> bytes:
    if value < 0:
        raise SMFError("negative varlen")
    out = bytearray([value & 0x7F])
    value >>= 7
    while value:
        out.insert(0, 0x80 | (value & 0x7F))
        value >>= 7
    return bytes(out)


def _timesig_meta(quarters_per_bar: int,
                  meter: Optional[Tuple[int, int]]) -> bytes:
    """The 0x58 time-signature meta event. ``meter`` (numerator,
    denominator) wins when given — a 6/8 model declares 6/8, not the
    grid-equivalent 3/4; ``quarters_per_bar`` is the legacy qpb/4
    spelling."""
    num, den = meter if meter is not None else (quarters_per_bar, 4)
    if num <= 0 or den <= 0 or den & (den - 1):
        raise SMFError(f"bad time signature {num}/{den} "
                       "(denominator must be a power of two)")
    return _varlen(0) + bytes([0xFF, 0x58, 0x04,
                               num, den.bit_length() - 1, 24, 8])


def write_smf(
    notes: List[Note],
    ticks_per_quarter: int = 480,
    tempo_us_per_quarter: int = 500_000,
    velocity: Optional[int] = None,
    quarters_per_bar: int = 4,
    meter: Optional[Tuple[int, int]] = None,
) -> bytes:
    """Serialize notes to SMF format 0 (SEMANTICS.md §7).

    ``meter`` (num, den) sets the declared time-signature meta exactly;
    without it, ``quarters_per_bar`` declares quarters_per_bar/4 (a
    3/4-configured model exports 3/4 files)."""
    events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
    for n in notes:
        vel = velocity if velocity is not None else n.velocity
        # vel=0 would serialize as a note_on that re-parses as note_off
        # (§1), silently corrupting the round trip — reject instead.
        if not 1 <= vel <= 127:
            raise SMFError(f"velocity {vel} out of range 1..127")
        if not 0 <= n.pitch <= 127:
            raise SMFError(f"pitch {n.pitch} out of range 0..127")
        if n.start_tick < 0 or n.end_tick <= n.start_tick:
            raise SMFError(f"bad note interval [{n.start_tick}, {n.end_tick})")
        # order: note_offs (0) before note_ons (1) at the same tick, so
        # back-to-back runs re-parse as separate notes.
        events.append((n.start_tick, 1, bytes([0x90, n.pitch, vel])))
        events.append((n.end_tick, 0, bytes([0x80, n.pitch, 0])))
    events.sort(key=lambda e: (e[0], e[1]))

    track = bytearray()
    track += _varlen(0) + bytes([0xFF, 0x51, 0x03])
    track += tempo_us_per_quarter.to_bytes(3, "big")
    track += _timesig_meta(quarters_per_bar, meter)
    last_tick = 0
    for tick, _, payload in events:
        track += _varlen(tick - last_tick) + payload
        last_tick = tick
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    header = struct.pack(">4sIHHH", b"MThd", 6, 0, 1, ticks_per_quarter)
    return header + struct.pack(">4sI", b"MTrk", len(track)) + bytes(track)


def write_smf_arrays(
    pitch,
    start_tick,
    end_tick,
    ticks_per_quarter: int = 480,
    tempo_us_per_quarter: int = 500_000,
    velocity: int = 100,
    quarters_per_bar: int = 4,
    meter: Optional[Tuple[int, int]] = None,
) -> bytes:
    """Vectorized ``write_smf`` for uniform-velocity note arrays.

    Byte-identical to ``write_smf`` on the same notes (asserted by
    tests/test_midi.py): events are built in the same per-note on/off
    order and stably lexsorted by (tick, off-before-on), and the
    variable-length delta encoding is filled with numpy masks instead of
    a per-event Python loop. This is the generation/serving export hot
    path.
    """
    import numpy as np

    if not 1 <= velocity <= 127:
        raise SMFError(f"velocity {velocity} out of range 1..127")
    pitch = np.asarray(pitch, np.int64)
    start = np.asarray(start_tick, np.int64)
    end = np.asarray(end_tick, np.int64)
    n = int(pitch.size)
    if n:
        if pitch.min() < 0 or pitch.max() > 127:
            raise SMFError("pitch out of range 0..127")
        if start.min() < 0 or bool((end <= start).any()):
            raise SMFError("bad note interval (need 0 <= start < end)")

    # interleaved per-note (on, off) build order + a stable lexsort by
    # (tick, off-before-on) reproduces write_smf's tie ordering exactly
    ticks = np.empty(2 * n, np.int64)
    ticks[0::2] = start
    ticks[1::2] = end
    order = np.empty(2 * n, np.int8)
    order[0::2] = 1                      # note_on
    order[1::2] = 0                      # note_off sorts first at same tick
    status = np.empty(2 * n, np.uint8)
    status[0::2] = 0x90
    status[1::2] = 0x80
    pp = np.repeat(pitch, 2).astype(np.uint8)
    vv = np.empty(2 * n, np.uint8)
    vv[0::2] = velocity
    vv[1::2] = 0
    idx = np.lexsort((order, ticks))
    ticks, status, pp, vv = ticks[idx], status[idx], pp[idx], vv[idx]

    deltas = np.diff(ticks, prepend=np.int64(0))
    vl = (np.where(deltas < 1 << 7, 1,
          np.where(deltas < 1 << 14, 2,
          np.where(deltas < 1 << 21, 3, 4)))).astype(np.int64)
    if n and deltas.size and int(deltas.max()) >= 1 << 28:
        raise SMFError("delta time exceeds 4-byte varlen")
    ev_len = vl + 3
    ends = np.cumsum(ev_len)
    buf = np.zeros(int(ends[-1]) if n else 0, np.uint8)
    buf[ends - 3] = status
    buf[ends - 2] = pp
    buf[ends - 1] = vv
    pos = ends - 4                       # last (low-7-bits) varlen byte
    buf[pos] = deltas & 0x7F
    for k in (1, 2, 3):                  # continuation bytes, high bit set
        m = vl > k
        if m.any():
            buf[pos[m] - k] = 0x80 | ((deltas[m] >> (7 * k)) & 0x7F)

    track = bytearray()
    track += _varlen(0) + bytes([0xFF, 0x51, 0x03])
    track += tempo_us_per_quarter.to_bytes(3, "big")
    track += _timesig_meta(quarters_per_bar, meter)
    track += buf.tobytes()
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    header = struct.pack(">4sIHHH", b"MThd", 6, 0, 1, ticks_per_quarter)
    return header + struct.pack(">4sI", b"MTrk", len(track)) + bytes(track)
