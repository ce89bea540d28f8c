"""Corpus-referenced generation-quality statistics (`eval-gen`); the port's
copy of the JAX package's utils/genmetrics.py.

The reference validated generations by listening (SURVEY §4: no test
suite; "correctness was evidently validated by listening to generated
MIDI"). This module gives that judgment numbers: descriptive statistics
of a batch of generated piano-roll bars, and divergences against the same
statistics of a reference corpus — the standard sample-quality proxies in
the music-VAE literature (PAPERS.md: pitch-class/duration histogram
comparisons in the PocketVAE / Bach-style comparative studies).

Semantics: all statistics are BAR-LEVEL — notes are runs of consecutive
active cells along a bar's time axis, truncated at bar boundaries. That
makes a [S, N, T, P] generated sweep and a dataset's [K, T, P] bar cache
directly comparable (both flatten to a bar stack), at the cost of
counting a note held across a barline as two notes — the same convention
on both sides of every comparison, so divergences are unbiased.

Host-side numpy by design: stats run on already-pulled generation output
(the CLI pulls bars for MIDI export anyway) and on memory-mapped dataset
caches; everything is vectorized (no per-note Python loops).

Note: midi/labels.py has its own (unnormalized, P=128) pitch-class
fold for label inference; this module's is normalized and
generic-P for host-side statistics. If pitch-class semantics ever change
(e.g. a pitch_lo offset), change BOTH.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: scalar keys produced by bar_stats (histograms are separate keys)
SCALAR_KEYS = ("frac_empty_bars", "notes_per_bar", "active_cells_per_bar",
               "mean_note_len", "polyphony", "mean_pitch", "pitch_range")


def bar_stats(bars: np.ndarray) -> Dict[str, np.ndarray]:
    """Descriptive statistics of a stack of binary piano-roll bars.

    ``bars``: [..., T, P] in {0,1} (any dtype); leading axes flatten to a
    bar stack [K, T, P]. Returns a dict of python floats plus two
    normalized histograms: ``pitch_hist`` [P] and ``pitch_class_hist``
    [12] (both all-zero if no cell is active).

    - frac_empty_bars: fraction of bars with no active cell.
    - notes_per_bar: mean onset count per bar (onset = active cell whose
      previous time step is inactive; bar-truncated runs, see module doc).
    - active_cells_per_bar: mean active-cell count per bar (density).
    - mean_note_len: active cells / onsets — mean note duration in steps.
    - polyphony: mean simultaneously-active pitches over NONEMPTY steps.
    - mean_pitch: active-cell-mass mean of the pitch axis.
    - pitch_range: mean (highest - lowest active pitch) over nonempty bars.
    """
    a = np.asarray(bars)
    if a.ndim < 3:
        raise ValueError(f"bars must be [..., T, P]; got shape {a.shape}")
    t, p = a.shape[-2:]
    a = (a.reshape(-1, t, p) != 0)
    k = a.shape[0]
    if k == 0:
        raise ValueError("empty bar stack")

    cells_per_bar = a.sum(axis=(1, 2))                       # [K]
    nonempty = cells_per_bar > 0
    onsets = a & ~np.concatenate(
        [np.zeros((k, 1, p), bool), a[:, :-1]], axis=1)      # [K,T,P]
    n_onsets = int(onsets.sum())
    n_cells = int(cells_per_bar.sum())

    per_step = a.sum(axis=2)                                 # [K,T]
    live_steps = per_step[per_step > 0]

    pitch_mass = a.sum(axis=(0, 1)).astype(np.float64)       # [P]
    pitch_hist = (pitch_mass / n_cells) if n_cells else pitch_mass
    pc_hist = pitch_hist.reshape(-1, 12).sum(axis=0) \
        if p % 12 == 0 else np.concatenate(
            [pitch_hist, np.zeros(12 - p % 12)]).reshape(-1, 12).sum(axis=0)
    pitches = np.arange(p, dtype=np.float64)
    mean_pitch = float(pitch_hist @ pitches) if n_cells else 0.0

    if nonempty.any():
        any_pitch = a.any(axis=1)                            # [K,P]
        lo = np.argmax(any_pitch, axis=1)
        hi = p - 1 - np.argmax(any_pitch[:, ::-1], axis=1)
        pitch_range = float(np.mean((hi - lo)[nonempty]))
    else:
        pitch_range = 0.0

    return {
        "frac_empty_bars": float(np.mean(~nonempty)),
        "notes_per_bar": n_onsets / k,
        "active_cells_per_bar": n_cells / k,
        "mean_note_len": (n_cells / n_onsets) if n_onsets else 0.0,
        "polyphony": float(live_steps.mean()) if live_steps.size else 0.0,
        "mean_pitch": mean_pitch,
        "pitch_range": pitch_range,
        "pitch_hist": pitch_hist,
        "pitch_class_hist": pc_hist,
    }


def js_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen–Shannon divergence (nats) between two histograms; inputs are
    normalized here, so raw counts are fine. Bounded [0, ln 2]; 0 iff the
    (normalized) distributions are identical. All-zero inputs → 0."""
    p = np.asarray(p, np.float64).ravel()
    q = np.asarray(q, np.float64).ravel()
    if p.shape != q.shape:
        raise ValueError(f"histogram shapes differ: {p.shape} vs {q.shape}")
    ps, qs = p.sum(), q.sum()
    if ps == 0 or qs == 0:
        return 0.0 if ps == qs else float(np.log(2.0))
    p, q = p / ps, q / qs
    m = 0.5 * (p + q)

    def _kl(a, b):
        nz = a > 0
        return float(np.sum(a[nz] * np.log(a[nz] / b[nz])))

    return 0.5 * _kl(p, m) + 0.5 * _kl(q, m)


def compare_stats(gen: Dict, ref: Dict) -> Dict[str, float]:
    """Divergence summary between two bar_stats results: JS divergences of
    the pitch / pitch-class histograms plus per-scalar absolute and
    relative differences. A relative diff against a (near-)zero reference
    value is undefined and reported as None (JSON null) rather than an
    arbitrary huge number — consumers should read the absolute diff there."""
    out = {
        "js_pitch": js_divergence(gen["pitch_hist"], ref["pitch_hist"]),
        "js_pitch_class": js_divergence(gen["pitch_class_hist"],
                                        ref["pitch_class_hist"]),
    }
    for key in SCALAR_KEYS:
        g, r = float(gen[key]), float(ref[key])
        out[f"abs_diff_{key}"] = abs(g - r)
        out[f"rel_diff_{key}"] = (abs(g - r) / abs(r)
                                  if abs(r) > 1e-9 else None)
    return out


def to_jsonable(stats: Dict) -> Dict:
    """np arrays → lists, np scalars → python floats, None passes through
    (for json.dump)."""
    return {k: (np.asarray(v).round(6).tolist()
                if isinstance(v, np.ndarray)
                else (None if v is None else float(v)))
            for k, v in stats.items()}
