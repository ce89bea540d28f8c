"""Synthetic MIDI corpus generator (the port's copy of the JAX package's
data/synthetic.py) — deterministic, seedable, musically-structured enough
that a VAE has something to learn (scales, chords, rhythmic patterns).

Produces real SMF bytes so the corpus exercises the full parse→tensorize
path, exactly like user MIDI would.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from musicvae_tpu_torch.midi import smf

MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])
MINOR = np.array([0, 2, 3, 5, 7, 8, 10])


def synth_midi(seed: int, n_bars: int = 8, tpq: int = 480,
               base_pitch: int = 60,
               quarters_per_bar: int = 4,
               meter: Tuple[int, int] = None) -> Tuple[bytes, int, int]:
    """One synthetic piece. Returns (smf_bytes, chord_class, key_class).

    chord/key classes are in [0, 24): root (12) x {major=0, minor=1}
    (the C4 conditioning vocabulary, config.ModelSpec.cond_*_classes).
    ``meter`` (numerator, denominator) shapes the bars AND the declared
    time signature, so a --meter run's synthetic fallback corpus passes
    the meter validation instead of dying on its own 4/4 meta — 7/8
    pieces have 7 eighth-note melody slots per 3.5-quarter bar.
    ``quarters_per_bar`` is the legacy spelling of meter=(qpb, 4).
    """
    if meter is None:
        meter = (quarters_per_bar, 4)
    num, den = meter
    eighths_per_bar = 8 * num // den     # melody slots (6/8 → 6, 7/8 → 7)
    if (8 * num) % den or (4 * tpq * num) % den:
        raise ValueError(f"meter {num}/{den} does not fit the eighth-note "
                         f"melody grid at tpq={tpq}")
    rng = np.random.default_rng(seed)
    root = int(rng.integers(0, 12))
    minor = int(rng.integers(0, 2))
    scale = (MINOR if minor else MAJOR) + base_pitch + root
    key_class = root * 2 + minor
    chord_class = key_class

    ticks_per_bar = 4 * tpq * num // den
    notes: List[smf.Note] = []
    # melody: random walk on the scale, 8th notes with rests
    deg = int(rng.integers(0, 7))
    for bar in range(n_bars):
        t0 = bar * ticks_per_bar
        for i in range(eighths_per_bar):
            if rng.random() < 0.2:
                continue
            deg = int(np.clip(deg + rng.integers(-2, 3), 0, 6))
            start = t0 + i * (tpq // 2)
            dur = int(rng.choice([tpq // 4, tpq // 2, tpq]))
            # clip to the bar so odd meters keep exact bar content
            dur = min(dur, ticks_per_bar - i * (tpq // 2))
            notes.append(smf.Note(int(scale[deg]), start, start + dur, 100))
        # chord pad: triad on the downbeat, half the bars
        if bar % 2 == 0:
            for off in (0, 2, 4):
                p = int(scale[off]) - 12
                notes.append(smf.Note(p, t0, t0 + ticks_per_bar, 80))
    notes.sort(key=lambda n: (n.start_tick, n.pitch, n.end_tick))
    return (smf.write_smf(notes, tpq, meter=meter),
            chord_class, key_class)


def synth_corpus(num_pieces: int, n_bars: int, seed: int = 0,
                 quarters_per_bar: int = 4,
                 meter: Tuple[int, int] = None
                 ) -> List[Tuple[bytes, int, int]]:
    return [synth_midi(seed * 100003 + i, n_bars,
                       quarters_per_bar=quarters_per_bar, meter=meter)
            for i in range(num_pieces)]
