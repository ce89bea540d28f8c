"""Chord/key label inference for real MIDI corpora (the port's copy of
the JAX package's midi/labels.py).

The C4 conditional VAE conditions on chord/key classes in [0, 24):
``root * 2 + minor`` — 12 pitch-class roots x {major=0, minor=1}, the same
vocabulary data/synthetic.py emits. Synthetic pieces carry ground-truth
labels; real ``.mid`` files don't. This module infers labels host-side
from the tensorized bar rolls (uint8 [n_bars, T, 128]) during preprocessing:

- key: Krumhansl-Schmuckler — duration-weighted pitch-class histogram
  correlated against the 24 rotated K-S major/minor profiles (Krumhansl
  1990, public profile constants), argmax.
- chord: duration-weighted triad template match per window — 24 templates
  (root major {0,4,7} / minor {0,3,7}) with ROLE WEIGHTS (root 1.5,
  third/fifth 1.0): the root emphasis is what separates relative
  major/minor (C:{0,4,7} vs Am:{9,0,4} share two pitch classes; a flat
  in-triad-mass score cannot rank them when the shared classes dominate).

Both are deterministic pure-numpy functions of the roll; an explicit
sidecar label file always wins (cli.py --labels). For corpus-scale
inference over overlapping windows, precompute per-bar histograms once
(``bar_pc_histograms``) and score windows via ``*_from_hist`` — summing
num_bars 12-vectors per window instead of re-histogramming the whole
[num_bars*T, 128] roll.
"""

from __future__ import annotations

import numpy as np

# Krumhansl-Schmuckler key profiles (probe-tone ratings, C root).
KS_MAJOR = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09,
                     2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
KS_MINOR = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53,
                     2.54, 4.75, 3.98, 2.69, 3.34, 3.17])

_TRIAD_OFFSETS = (np.array([0, 4, 7]), np.array([0, 3, 7]))  # major, minor


# role weights (root, third, fifth): root emphasis breaks the
# relative-major/minor tie — see module docstring
_TRIAD_WEIGHTS = np.array([1.5, 1.0, 1.0])


def pc_histogram(roll: np.ndarray) -> np.ndarray:
    """Duration-weighted pitch-class histogram of a roll.

    roll: uint8/float [..., T, 128] (any leading dims). Active cells count
    once per time step, i.e. weight == duration on the step grid.
    """
    per_pitch = np.asarray(roll, dtype=np.float64).reshape(-1, 128).sum(0)
    return np.bincount(np.arange(128) % 12, weights=per_pitch, minlength=12)


def bar_pc_histograms(bars: np.ndarray) -> np.ndarray:
    """Per-bar pitch-class histograms: [n, T, 128] → [n, 12].

    The precompute for corpus-scale window labeling: window s..s+k scores
    from ``hists[s:s+k].sum(0)`` instead of re-histogramming the roll.
    """
    per_pitch = np.asarray(bars, dtype=np.float64).sum(axis=-2)   # [n, 128]
    out = np.zeros((*per_pitch.shape[:-1], 12))
    for pc in range(12):
        out[..., pc] = per_pitch[..., pc::12].sum(-1)
    return out


def key_from_hist(hist: np.ndarray) -> int:
    """K-S key class in [0, 24) from a 12-bin histogram; 0 if silent."""
    if hist.sum() <= 0:
        return 0
    scores = np.empty(24)
    for root in range(12):
        rotated = np.roll(hist, -root)
        for minor, profile in ((0, KS_MAJOR), (1, KS_MINOR)):
            scores[root * 2 + minor] = _pearson(rotated, profile)
    return int(np.argmax(scores))


def chord_from_hist(hist: np.ndarray, fallback: int = 0) -> int:
    """Best triad class in [0, 24) from a 12-bin histogram.

    Score = role-weighted in-triad mass (root 1.5, third/fifth 1.0);
    the root weight makes relative major/minor separable (a symmetric
    in-triad sum cannot rank C vs Am when their shared {0,4} dominate).
    Returns ``fallback`` (typically the piece key) for silent windows.
    """
    if hist.sum() <= 0:
        return int(fallback)
    scores = np.empty(24)
    for root in range(12):
        for minor, offs in enumerate(_TRIAD_OFFSETS):
            scores[root * 2 + minor] = (
                _TRIAD_WEIGHTS * hist[(root + offs) % 12]).sum()
    return int(np.argmax(scores))


def estimate_key(roll: np.ndarray) -> int:
    """K-S key class in [0, 24) (root*2 + minor); 0 (C major) if silent."""
    return key_from_hist(pc_histogram(roll))


def estimate_chord(roll: np.ndarray, fallback: int = 0) -> int:
    """Best-matching triad class in [0, 24) for one window's roll."""
    return chord_from_hist(pc_histogram(roll), fallback)


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0
