"""The port's MIDI commands in-process on the CPU: ``preprocess`` against
the JAX package's, then MIDI in → ``train --midi-glob`` (c2 at tiny f32
widths, batch 2) → ``generate`` / ``reconstruct`` / ``eval-gen`` / ``eval``
→ MIDI out from the checkpoint, ``serve --sample-mode bernoulli``, and the
error paths with the JAX package's messages."""

import contextlib
import io as stdio
import json
import os
import sys

import numpy as np
import pytest

import musicvae_tpu.cli as jax_cli
from musicvae_tpu_torch.checkpoints import io
from musicvae_tpu_torch.cli import main
from musicvae_tpu_torch.config import MidiSpec
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.midi import tensorize
from torch_port_helpers import one_torch_thread  # noqa: F401

WIDTHS = ["--enc-channels", "4,8,8,8,8", "--dec-channels", "8,8,8,8,8"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six 8-bar 4/4 pieces (p*.mid) and four 6-bar 3/4 pieces (w*.mid),
    with a label sidecar for every other file."""
    root = tmp_path_factory.mktemp("midi_corpus")
    sidecar = {}
    for prefix, meter, n in (("p", (4, 4), 6), ("w", (3, 4), 4)):
        for i, (data, chord, key) in enumerate(
                synth_corpus(n, 8 if prefix == "p" else 6, seed=n,
                             meter=meter)):
            (root / f"{prefix}{i}.mid").write_bytes(data)
            if i % 2 == 0:
                sidecar[f"{prefix}{i}.mid"] = {"chord": chord, "key": key}
    (root / "labels.json").write_text(json.dumps(sidecar))
    (root / "bad_labels.json").write_text(json.dumps(
        {"p1.mid": {"chord": 24, "key": 0}}))
    return root


def _run(argv, capsys, fn=main):
    rc = fn([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("case", ["synthetic", "midi", "waltz", "no_infer"])
def test_preprocess_matches_jax(corpus, tmp_path, capsys, case):
    """The same flags give the same .npz arrays in both packages."""
    args = {"synthetic": ["--synthetic-pieces", 5],
            "midi": ["--midi-glob", corpus / "p*.mid", "--labels",
                     corpus / "labels.json"],
            "waltz": ["--midi-glob", corpus / "w*.mid", "--labels",
                      corpus / "labels.json", "--meter", "3/4"],
            "no_infer": ["--midi-glob", corpus / "p*.mid",
                         "--no-infer-labels"]}[case]
    common = ["preprocess", "--config", "c2_gru_4bar", *args]
    rc, out, _ = _run([*common, "--out", tmp_path / "port.npz"], capsys)
    assert rc == 0 and "windows of 4 bars" in out
    assert _run([*common, "--out", tmp_path / "jax.npz"], capsys,
                jax_cli.main)[0] == 0
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        assert a["bars"].dtype == np.uint8
        assert tuple(a["grid"]) == ((32, 3) if case == "waltz"
                                    else (24, 4))


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """(rc, stdout, stderr, ckpt dir) of ``train --midi-glob`` over the 4/4
    pieces with the label sidecar, 2 steps of the tiny c2 at batch 2 with
    the first-conv kernel's path and EMA weights."""
    root = tmp_path_factory.mktemp("midi_train")
    out, err = stdio.StringIO(), stdio.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in (
            "train", "--midi-glob", corpus / "p*.mid", "--labels",
            corpus / "labels.json", "--steps", 2, "--batch-size", 2,
            "--log-every", 1, "--ema-decay", 0.9, "--use-pallas-conv1",
            *WIDTHS, *CPU, "--ckpt-dir", root / "ck", "--log-dir",
            root / "logs")])
    return rc, out.getvalue(), err.getvalue(), str(root / "ck")


def test_train_midi_glob(trained):
    """``train --midi-glob --labels`` tensorizes the files in-process and
    trains; the checkpoint keeps the first-conv flag and the grid."""
    rc, out, err, ck = trained
    assert rc == 0, err
    assert "tensorized 6 MIDI files" in err and "final metrics" in out
    metrics = json.loads(out.split("final metrics: ")[1].replace("'", '"'))
    assert np.isfinite(metrics["loss"])
    cfg = io.restore_config(io.make_manager(ck))
    assert cfg.model.use_pallas_conv1 and cfg.model.enc_channels[0] == 4
    assert cfg.midi.steps_per_bar == 96


def _retensorized(path, n_bars):
    """The bars of an exported MIDI file, zero-padded to ``n_bars`` (a
    sample's trailing silent bars write no notes). An untrained model's
    Bernoulli bars hold far more notes than the default cap."""
    bars = tensorize.corpus_to_bars([open(path, "rb").read()], MidiSpec(),
                                    max_events=1 << 20, as_uint8=True)[0]
    assert bars.shape[0] <= n_bars
    return np.concatenate([bars, np.zeros((n_bars - bars.shape[0], 96, 128),
                                          np.uint8)])


@pytest.mark.parametrize("mode", ["bernoulli", "threshold"])
def test_generate_continues_and_morphs_real_midi(trained, corpus, tmp_path,
                                                 capsys, mode):
    """--seed-midi A --encode --interpolate --interp-midi-b B: rolls.npy
    and the MIDI files, which tensorize back to the same bars; one seed
    gives one result."""
    ck = trained[3]
    rolls = []
    for run in ("a", "b"):
        rc, out, err = _run([
            "generate", "--ckpt-dir", ck, "--seed-midi", corpus / "p0.mid",
            "--encode", "--interpolate", "--interp-midi-b",
            corpus / "p1.mid", "--sample-mode", mode, "--bars", 5,
            "--samples", 3, "--write-midis", 2, "--seed", 4,
            "--out-dir", tmp_path / run, *CPU], capsys)
        assert rc == 0, err
        assert "generated 3 x 5 bars" in out and "timing: sweep_ms=" in err
        r = np.load(tmp_path / run / "rolls.npy")
        assert r.dtype == np.uint8 and r.shape == (3, 5, 96, 128)
        assert set(np.unique(r)) <= {0, 1}
        assert sorted(os.listdir(tmp_path / run)) == [
            "rolls.npy", "sample_0000.mid", "sample_0001.mid"]
        for i in range(2):
            np.testing.assert_array_equal(
                _retensorized(tmp_path / run / f"sample_{i:04d}.mid", 5),
                r[i])
        rolls.append(r)
    np.testing.assert_array_equal(*rolls)


def test_generate_uses_ema_weights(trained, tmp_path, capsys):
    rc, _, err = _run(["generate", "--ckpt-dir", trained[3], "--ema",
                       "--bars", 2, "--samples", 1, "--out-dir", tmp_path,
                       *CPU], capsys)
    assert rc == 0 and "using EMA weights" in err
    assert np.load(tmp_path / "rolls.npy").shape == (1, 2, 96, 128)


def test_reconstruct(trained, corpus, tmp_path, capsys):
    rc, out, err = _run(["reconstruct", "--ckpt-dir", trained[3],
                         "--midi-glob", corpus / "p[01].mid",
                         "--out-dir", tmp_path, *CPU], capsys)
    assert rc == 0, err
    lines = out.splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):
        assert line.startswith(f"{corpus / f'p{i}.mid'}: 8 bars -> ")
        scores = dict(kv.split("=") for kv in line.split()[-3:])
        assert sorted(scores) == ["f1", "precision", "recall"]
        assert all(0.0 <= float(v) <= 1.0 for v in scores.values())
        recon = tmp_path / f"p{i}.recon.mid"
        assert recon.exists()
        assert _retensorized(recon, 8).shape == (8, 96, 128)


@pytest.mark.parametrize("ref", ["midi_glob", "data"])
def test_eval_gen(trained, corpus, tmp_path, capsys, ref):
    argv = ["eval-gen", "--ckpt-dir", trained[3], "--bars", 3, "--samples",
            2, *CPU]
    if ref == "data":
        assert main(["preprocess", "--midi-glob", str(corpus / "p*.mid"),
                     "--out", str(tmp_path / "c.npz")]) == 0
        argv += ["--data", tmp_path / "c.npz"]
    else:
        argv += ["--midi-glob", corpus / "p*.mid"]
    capsys.readouterr()
    rc, out, err = _run(argv, capsys)
    assert rc == 0, err
    res = json.loads(out)
    assert sorted(res) == ["bars_per_sample", "compare", "gen", "ref",
                           "samples"]
    assert (res["samples"], res["bars_per_sample"]) == (2, 3)
    assert len(res["gen"]["pitch_hist"]) == 128
    assert 0.0 <= res["compare"]["js_pitch"] <= np.log(2.0)
    assert res["ref"]["notes_per_bar"] > 0


def test_eval_midi_glob(trained, corpus, capsys):
    """``eval --midi-glob`` scores the MIDI files directly."""
    rc, out, err = _run(["eval", "--ckpt-dir", trained[3], "--midi-glob",
                         corpus / "p*.mid", "--batches", 2, *CPU], capsys)
    assert rc == 0, err
    got = dict(kv.split("=") for kv in out.split())
    assert sorted(got) == ["f1", "kl", "loss", "precision", "recall",
                           "recon"]
    assert all(np.isfinite(float(v)) for v in got.values())


def test_serve_bernoulli(trained, capsys, monkeypatch):
    """``serve --sample-mode bernoulli`` serves; one seed, one answer."""
    monkeypatch.setattr(sys, "stdin", stdio.StringIO(
        '{"id": 1, "seed": 3}\n{"id": 2, "seed": 3}\n{"id": 3, "seed": 4}\n'
        '{"id": 4, "cmd": "stats"}\n'))
    rc, out, err = _run(["serve", "--ckpt-dir", trained[3], "--sample-mode",
                         "bernoulli", "--bars", 2, "--samples", 2, *CPU],
                        capsys)
    assert rc == 0, err
    r1, r2, r3, stats = [json.loads(ln) for ln in out.splitlines()]
    assert len(r1["midi_b64"]) == 2 and r1["midi_b64"] == r2["midi_b64"]
    assert r3["midi_b64"] != r1["midi_b64"]
    assert stats["stats"]["served"] == 3 and stats["stats"]["errors"] == 0


def _garbage(corpus):
    path = corpus / "garbage" / "x.mid"
    path.parent.mkdir(exist_ok=True)
    path.write_bytes(b"MThd not a midi file")
    return path


@pytest.mark.parametrize("case", ["no_match", "bad_label", "bad_meter",
                                  "wrong_meter", "malformed"])
def test_preprocess_errors_match_jax(corpus, tmp_path, capsys, case):
    args = {"no_match": ["--midi-glob", tmp_path / "none" / "*.mid"],
            "bad_label": ["--midi-glob", corpus / "p*.mid", "--labels",
                          corpus / "bad_labels.json"],
            "bad_meter": ["--meter", "3/5"],
            "wrong_meter": ["--midi-glob", corpus / "w*.mid"],
            "malformed": ["--midi-glob", _garbage(corpus)]}[case]
    argv = ["preprocess", "--config", "c2_gru_4bar", *args, "--out",
            tmp_path / "x.npz"]
    got = _run(argv, capsys)
    want = _run(argv, capsys, jax_cli.main)
    assert got[0] == want[0] == (1 if case == "no_match" else 2)
    assert got[2] == want[2] and got[2]
    assert not (tmp_path / "x.npz").exists()


@pytest.mark.parametrize("argv,rc,needle", [
    (["generate", "--encode"], 2, "error: --encode needs --seed-midi"),
    (["generate", "--seed-midi", "{corpus}/p0.mid", "--interp-midi-b",
      "{corpus}/p1.mid"], 2,
     "error: --interp-midi-b morphs between two encoded pieces; it needs "
     "--seed-midi, --encode and --interpolate"),
    (["generate", "--seed-midi", "{corpus}/garbage/x.mid"], 2,
     "error: malformed MIDI"),
    (["reconstruct", "--midi-glob", "{corpus}/none*.mid"], 1,
     "no MIDI files match"),
    (["eval-gen", "--midi-glob", "{corpus}/none*.mid"], 1,
     "no MIDI files match"),
    (["eval", "--midi-glob", "{corpus}/none*.mid"], 1,
     "no MIDI files match"),
    (["eval", "--midi-glob", "{corpus}/p*.mid", "--max-events", "3"], 2,
     "error: malformed MIDI"),
    (["train", "--midi-glob", "{corpus}/p*.mid", "--labels",
      "{corpus}/bad_labels.json"], 2, "out of range 0..23"),
    (["train", "--midi-glob", "{corpus}/none*.mid"], 2,
     "no MIDI files match"),
    # --chord/--key: range-checked on a cond model (random c4_cond weights
    # here), ignored by the other kinds, as in the JAX package
    (["generate", "--config", "c4_cond", "--ckpt-dir", "{corpus}/none",
      "--chord", "24"], 2, "error: --chord 24 out of range 0..23"),
    (["generate", "--chord", "3", "--key", "3", "--bars", "1"], 0,
     "timing: sweep_ms="),
])
def test_midi_command_errors(trained, corpus, tmp_path, capsys, argv, rc,
                             needle):
    _garbage(corpus)
    argv = [a.format(corpus=corpus) for a in argv]
    if argv[0] != "train":
        if "--ckpt-dir" not in argv:
            argv += ["--ckpt-dir", trained[3]]
    else:
        argv += ["--ckpt-dir", tmp_path / "ck", "--log-dir", tmp_path]
    extra = (["--out-dir", tmp_path] if argv[0] in ("generate",
                                                     "reconstruct") else [])
    got, _, err = _run([*argv, *extra, *CPU], capsys)
    assert got == rc and needle in err, err


def test_generate_from_random_init(tmp_path, capsys):
    """No checkpoint in --ckpt-dir: random weights for --config with the
    JAX package's warning; --ema then has no weights to use."""
    argv = ["generate", "--ckpt-dir", tmp_path / "none", "--bars", 1,
            "--samples", 1, "--out-dir", tmp_path / "gen", *CPU]
    rc, out, err = _run(argv, capsys)
    assert rc == 0
    assert "warning: no checkpoint found, generating from random init" in err
    assert np.load(tmp_path / "gen" / "rolls.npy").shape == (1, 1, 96, 128)
    rc, out, err = _run([*argv, "--ema"], capsys)
    assert rc == 2 and jax_cli._EMA_ERROR in err
