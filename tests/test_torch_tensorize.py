"""The port's MIDI ingestion against the JAX package's: meter grids, the
quantize → rasterize → bar-chunk pipeline (native and pure-Python paths),
its errors, chord/key labels, the synthetic corpus, ``from_corpus`` and the
generation statistics. Every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu import config as jcfg
from musicvae_tpu import native as jnative
from musicvae_tpu.data import PianoRollDataset as JDataset
from musicvae_tpu.data.synthetic import synth_corpus as j_synth_corpus
from musicvae_tpu.midi import labels as jlabels
from musicvae_tpu.midi import smf as jsmf
from musicvae_tpu.midi import tensorize as jtens
from musicvae_tpu.utils import genmetrics as jgen
from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch import native
from musicvae_tpu_torch.data.dataset import PianoRollDataset
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.midi import labels, smf, tensorize
from musicvae_tpu_torch.utils import genmetrics
from torch_port_helpers import port_midi_spec

METERS = [(4, 4), (3, 4), (6, 8), (5, 4), (7, 8)]


def _specs(meter=(4, 4), **kw):
    """(JAX MidiSpec, port MidiSpec) realizing ``meter``."""
    jspec = jcfg.MidiSpec(**{**jcfg.meter_grid(*meter), **kw})
    return jspec, port_midi_spec(jspec)


@pytest.mark.parametrize("meter", METERS + [(2, 2), (12, 8), (7, 16)])
@pytest.mark.parametrize("steps_per_bar", [96, 120])
def test_meter_grid_matches_jax(meter, steps_per_bar):
    got = tcfg.meter_grid(*meter, steps_per_bar)
    assert got == jcfg.meter_grid(*meter, steps_per_bar)
    spec = tcfg.MidiSpec(**got)
    assert spec.meter == meter
    if meter in ((5, 4), (7, 8)):
        assert spec.steps_per_bar == {(5, 4): 120, (7, 8): 84}[meter]


@pytest.mark.parametrize("meter", [(3, 5), (0, 4), (4, 0), (1, 64)])
def test_meter_grid_errors_match_jax(meter):
    with pytest.raises(ValueError) as want:
        jcfg.meter_grid(*meter)
    with pytest.raises(ValueError) as got:
        tcfg.meter_grid(*meter)
    assert str(got.value) == str(want.value)


def test_quantize_ticks_matches_jax():
    rng = np.random.default_rng(0)
    ticks = rng.integers(0, 2 ** 30, 4000)
    for tpq, spq in ((480, 24), (96, 32), (1000, 24), (7, 3)):
        np.testing.assert_array_equal(tensorize.quantize_ticks(ticks, tpq, spq),
                                      jtens.quantize_ticks(ticks, tpq, spq))


@pytest.mark.parametrize("meter", METERS)
def test_events_and_rasterizers_match_jax(meter):
    """notes_to_events, events_to_roll_np and the torch events_to_roll (on
    the CPU) against the JAX events_to_roll, for one synthetic piece and
    for out-of-range events."""
    jspec, tspec = _specs(meter)
    data = synth_corpus(1, 6, seed=4, meter=meter)[0][0]
    events, total = tensorize.notes_to_events(smf.parse_smf(data), tspec)
    j_events, j_total = jtens.notes_to_events(jsmf.parse_smf(data), jspec)
    np.testing.assert_array_equal(events, j_events)
    assert total == j_total == 6 * tspec.steps_per_bar
    wild = np.array([[-5, 3, 60], [total - 2, total + 50, 200],
                     [10, 10, 64], [0, 0, 0], [3, 1, -4]], np.int32)
    for ev in (events, wild):
        want = np.asarray(jtens.events_to_roll(jnp.asarray(ev), total))
        np.testing.assert_array_equal(tensorize.events_to_roll_np(ev, total),
                                      want)
        got = tensorize.events_to_roll(ev, total, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    bars = tensorize.chunk_bars(tensorize.events_to_roll_np(events, total),
                                tspec.steps_per_bar)
    assert bars.shape == (6, tspec.steps_per_bar, 128) and bars.sum() > 0
    for use_native in (True, False):
        got = tensorize.midi_bytes_to_bars(data, tspec,
                                           use_native=use_native)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jtens.midi_bytes_to_bars(data, jspec)))


def _python_path(monkeypatch, *mods):
    """Make ``native.available()`` false in each module (the port's or the
    JAX package's), so its tensorizer takes the pure-Python codec."""
    for mod in mods:
        monkeypatch.setattr(mod, "available", lambda: False)


@pytest.mark.parametrize("meter", METERS)
def test_corpus_to_bars_native_and_python_match_jax(meter, monkeypatch):
    assert native.available(), "g++ builds the native library here"
    jspec, tspec = _specs(meter)
    datas = [p[0] for p in synth_corpus(8, 8, seed=2, meter=meter)]
    got_native = tensorize.corpus_to_bars(datas, tspec, as_uint8=True)
    got_python = tensorize.corpus_to_bars(datas, tspec, as_uint8=True,
                                          use_native=False)
    want = jtens.corpus_to_bars(datas, jspec, as_uint8=True)
    _python_path(monkeypatch, jnative)
    want_python = jtens.corpus_to_bars(datas, jspec)
    assert len(got_native) == len(got_python) == len(want) == 8
    for a, b, c, d in zip(got_native, got_python, want, want_python):
        assert a.dtype == b.dtype == np.uint8
        assert a.shape == (8, tspec.steps_per_bar, 128)
        for x in (b, c, d):
            np.testing.assert_array_equal(a, x)
    f32 = tensorize.corpus_to_bars(datas[:2], tspec)
    assert f32[0].dtype == np.float32
    np.testing.assert_array_equal(f32[0], got_native[0])


def _raises_both(fn_port, fn_jax, match):
    with pytest.raises(smf.SMFError, match=match):
        fn_port()
    with pytest.raises(jsmf.SMFError, match=match):
        fn_jax()


@pytest.mark.parametrize("path", ["native", "python"])
def test_ingestion_errors_match_jax(path, monkeypatch):
    """A time signature that disagrees with the grid, and a piece over
    max_events, raise SMFError in both packages on both paths; the override
    and a raised cap let the same bytes through."""
    if path == "python":
        _python_path(monkeypatch, native, jnative)
    jspec, tspec = _specs((4, 4))
    waltz = [synth_corpus(1, 4, seed=1, meter=(3, 4))[0][0]]
    _raises_both(lambda: tensorize.corpus_to_bars(waltz, tspec),
                 lambda: jtens.corpus_to_bars(waltz, jspec),
                 "time signature")
    _raises_both(lambda: tensorize.midi_bytes_to_bars(waltz[0], tspec),
                 lambda: jtens.midi_bytes_to_bars(waltz[0], jspec),
                 "time signature")
    ji, ti = _specs((4, 4), ignore_time_signature=True)
    np.testing.assert_array_equal(tensorize.corpus_to_bars(waltz, ti)[0],
                                  jtens.corpus_to_bars(waltz, ji)[0])
    piece = [synth_corpus(1, 4, seed=3)[0][0]]
    n_notes = len(smf.parse_smf(piece[0]).notes)
    _raises_both(
        lambda: tensorize.corpus_to_bars(piece, tspec, n_notes - 1),
        lambda: jtens.corpus_to_bars(piece, jspec, n_notes - 1),
        "max-events|overflow")
    assert tensorize.corpus_to_bars(piece, tspec, n_notes)[0].shape[0] == 4


def test_labels_match_jax():
    datas = [p[0] for p in synth_corpus(6, 8, seed=5)]
    spec = tcfg.MidiSpec()
    rng = np.random.default_rng(5)
    rolls = tensorize.corpus_to_bars(datas, spec, as_uint8=True)
    rolls.append(np.zeros((2, 96, 128), np.uint8))          # silence
    rolls.append((rng.random((3, 96, 128)) < 0.2).astype(np.uint8))
    for bars in rolls:
        hists = labels.bar_pc_histograms(bars)
        np.testing.assert_array_equal(hists, jlabels.bar_pc_histograms(bars))
        np.testing.assert_array_equal(labels.pc_histogram(bars),
                                      jlabels.pc_histogram(bars))
        k = labels.key_from_hist(hists.sum(0))
        assert k == jlabels.key_from_hist(hists.sum(0))
        assert labels.estimate_key(bars) == jlabels.estimate_key(bars)
        for s in range(bars.shape[0]):
            h = hists[s:s + 2].sum(0)
            assert labels.chord_from_hist(h, k) == \
                jlabels.chord_from_hist(h, k)
            assert labels.estimate_chord(bars[s:s + 2], 7) == \
                jlabels.estimate_chord(bars[s:s + 2], 7)


@pytest.mark.parametrize("meter", METERS + [None])
def test_synth_corpus_byte_identical(meter):
    got = synth_corpus(4, 5, seed=9, meter=meter)
    assert got == j_synth_corpus(4, 5, seed=9, meter=meter)
    assert all(isinstance(d, bytes) and 0 <= c < 24 and 0 <= k < 24
               for d, c, k in got)


@pytest.mark.parametrize("infer", [False, True])
def test_from_corpus_matches_jax(infer):
    """Half the pieces unlabeled: labels inferred (or 0), the rest kept;
    the same windows, labels, piece ids and grid."""
    jspec, tspec = _specs((3, 4))
    pieces = [(d, None, None) if i % 2 else (d, c, k) for i, (d, c, k)
              in enumerate(synth_corpus(6, 7, seed=6, meter=(3, 4)))]
    got = PianoRollDataset.from_corpus(pieces, tspec, 4, infer_labels=infer)
    want = JDataset.from_corpus(pieces, jspec, 4, infer_labels=infer)
    assert got.grid == want.grid == (32, 3) and got.num_bars == 4
    assert len(got) == 6 * 4
    for f in ("bars", "starts", "chords", "keys", "piece_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if not infer:
        assert (got.keys[got.piece_ids % 2 == 1] == 0).all()
    with pytest.raises(ValueError, match="no windows"):
        PianoRollDataset.from_corpus(pieces[:1], tspec, 8)


def test_genmetrics_match_jax():
    rng = np.random.default_rng(7)
    gen = (rng.random((3, 4, 96, 128)) < 0.03).astype(np.uint8)
    gen[0, 0] = 0                                     # an empty bar
    ref = tensorize.corpus_to_bars(
        [p[0] for p in synth_corpus(4, 4, seed=7)], tcfg.MidiSpec(),
        as_uint8=True)
    ref = np.concatenate(ref)
    for bars in (gen, ref, gen[:, :, :, :120]):
        got, want = genmetrics.bar_stats(bars), jgen.bar_stats(bars)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    g, r = genmetrics.bar_stats(gen), genmetrics.bar_stats(ref)
    assert genmetrics.compare_stats(g, r) == jgen.compare_stats(
        jgen.bar_stats(gen), jgen.bar_stats(ref))
    assert genmetrics.to_jsonable(genmetrics.compare_stats(g, r)) == \
        jgen.to_jsonable(jgen.compare_stats(g, r))
    z = np.zeros(12)
    assert genmetrics.js_divergence(z, z) == jgen.js_divergence(z, z) == 0.0


def test_native_library_builds_under_build_dir():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR
    assert lib.parent.parent.name == "build" and lib.exists()
    notes, tpq, tempo, sigs = native.parse_smf(
        synth_corpus(1, 2, seed=1, meter=(6, 8))[0][0])
    j = jnative.parse_smf(synth_corpus(1, 2, seed=1, meter=(6, 8))[0][0])
    np.testing.assert_array_equal(notes, j[0])
    assert (tpq, tempo, sigs) == j[1:] and sigs == ((6, 8),)
    assert dataclasses.asdict(tcfg.MidiSpec()) == \
        dataclasses.asdict(jcfg.MidiSpec())
