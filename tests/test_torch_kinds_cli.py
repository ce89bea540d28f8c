"""The port's commands on the conv bar-VAE (C1), the hierarchical VAE (C3)
and the chord/key VAE (C4), in-process on the CPU at narrow widths
(``--enc-channels/--dec-channels``, batch 2): ``preprocess`` → ``train``
(with an eval, then ``--resume``) → ``eval`` → ``generate`` (``--chord``/
``--key``, ``--seed-midi --encode`` and the morph) → ``reconstruct`` →
``describe`` → ``eval-gen`` → ``serve``. A cond request's omitted
chord/key classes are the JAX server's numpy draws for its seed, and
stdin ``--coalesce``, ``--pipeline`` and the TCP transport answer as
serial serving does."""

import base64
import dataclasses
import io as stdio
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from musicvae_tpu import checkpoints as jax_ckpt
from musicvae_tpu.models import init_params as j_init_params
from musicvae_tpu_torch import cli
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.data.dataset import PianoRollDataset
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.models.vae import draw_eps
from musicvae_tpu_torch.utils.metrics import make_eval_fn
from torch_port_helpers import KINDS, one_torch_thread  # noqa: F401

WIDTHS = ["--enc-channels", "4,8,8,8,8", "--dec-channels", "8,8,8,8,8"]
CPU = ["--device", "cpu"]


def _run(argv, capsys):
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{kind: (checkpoint dir, bar cache)}: each kind trained 2 steps at
    batch 2 from a 3-piece synthetic cache, with an eval at step 2; and
    two MIDI files."""
    root = tmp_path_factory.mktemp("kinds_cli")
    for i, (data, _, _) in enumerate(synth_corpus(2, 6, seed=5)):
        (root / f"m{i}.mid").write_bytes(data)
    out = {}
    for name in KINDS:
        cache, ck = root / f"{name}.npz", root / f"ck_{name}"
        assert cli.main(["preprocess", "--config", name,
                         "--synthetic-pieces", "3", "--out",
                         str(cache)]) == 0
        assert cli.main([str(a) for a in (
            "train", "--config", name, *WIDTHS, "--data", cache,
            "--batch-size", 2, "--steps", 2, "--log-every", 1,
            "--eval-every", 2, "--eval-batches", 1, "--holdout-frac", 0.3,
            "--ckpt-dir", ck, "--log-dir", root / "logs", *CPU)]) == 0
        out[name] = (str(ck), str(cache))
    return root, out


@pytest.mark.parametrize("name", KINDS)
def test_train_checkpoints_and_resumes(trained, name, capsys):
    root, runs = trained
    ck, cache = runs[name]
    assert ckpt_io.make_manager(ck).all_steps() == [2]
    assert ckpt_io.make_manager(os.path.join(ck, "best")).all_steps() == [2]
    rc, out, err = _run(["train", "--data", cache, "--ckpt-dir", ck,
                         "--resume", "--steps", 3, "--log-dir",
                         root / "logs", *CPU], capsys)
    assert rc == 0 and "resumed from step 2" in err, err
    assert "final metrics" in out
    assert ckpt_io.make_manager(ck).latest_step() == 3
    assert ckpt_io.restore_config(ckpt_io.make_manager(ck)).name == name


def _restored(ck):
    return cli.restore_checkpoint(ck, "cpu")


@pytest.mark.parametrize("name", KINDS)
def test_eval_scores_with_the_labels(trained, name, capsys):
    """``eval --data``: every window once in the fixed order, each level's
    noise from the batch's seed, cond windows under their cached labels;
    the printed means equal the eval function's on the same batch."""
    _, runs = trained
    ck, cache = runs[name]
    rc, out, err = _run(["eval", "--ckpt-dir", ck, "--data", cache,
                         "--batches", 1, *CPU], capsys)
    assert rc == 0, err
    got = dict(kv.split("=") for kv in out.split())
    cfg, state = _restored(ck)
    ds = PianoRollDataset.load_npy(cache)
    b = cfg.train.batch_size
    idx = np.random.default_rng(0).permutation(len(ds))[:b].astype(np.int32)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(idx).items()}
    want = make_eval_fn(cfg, state.model)(
        batch["x"], draw_eps(cfg.model, b, torch.Generator().manual_seed(0)),
        None, batch["chord"], batch["key_sig"])
    for k, v in want.items():
        assert got[k] == f"{float(v):.5g}", k
    if name == "c4_cond":    # other labels, another score
        other = make_eval_fn(cfg, state.model)(
            batch["x"], draw_eps(cfg.model, b,
                                 torch.Generator().manual_seed(0)),
            None, (batch["chord"] + 5) % 24, batch["key_sig"])
        assert float(other["loss"]) != float(want["loss"])


def _rolls(out_dir):
    return np.load(os.path.join(out_dir, "rolls.npy"))


@pytest.mark.parametrize("name", KINDS)
def test_generate_chord_and_key(trained, name, tmp_path, capsys):
    """cond: --chord/--key condition every sample and bar, equal to the
    sweep given those classes, and a class out of range exits 2 with the
    JAX package's message; other kinds ignore the flags."""
    _, runs = trained
    ck, _ = runs[name]
    base = ["generate", "--ckpt-dir", ck, "--bars", 3, "--samples", 2,
            "--seed", 4, *CPU]
    rc, _, err = _run([*base, "--chord", 3, "--key", 5, "--out-dir",
                       tmp_path / "a"], capsys)
    assert rc == 0, err
    rc, _, err = _run([*base, "--out-dir", tmp_path / "b"], capsys)
    assert rc == 0, err
    a, b = _rolls(tmp_path / "a"), _rolls(tmp_path / "b")
    assert a.shape == (2, 3, 96, 128)
    if name != "c4_cond":
        np.testing.assert_array_equal(a, b)
        return
    cfg, state = _restored(ck)
    cfg = cfg.replace(gen=GenSpec(num_bars=3, num_samples=2))
    want = sampler.make_generate_fn(cfg, state.model)(
        torch.Generator().manual_seed(4), chord=torch.full((2, 3), 3),
        key_sig=torch.full((2,), 5))
    np.testing.assert_array_equal(a, want.numpy())
    for flag in ("--chord", "--key"):
        rc, _, err = _run([*base, flag, 24, "--out-dir", tmp_path / "c"],
                          capsys)
        assert rc == 2 and f"error: {flag} 24 out of range 0..23" in err


@pytest.mark.parametrize("name", KINDS)
def test_generate_encode_and_morph(trained, name, tmp_path, capsys):
    """``--seed-midi A --encode --interpolate --interp-midi-b B``: A's
    posterior starts the path and B's ends it (for hier the phrase
    latent's morph); the MIDI files are written."""
    root, runs = trained
    ck, _ = runs[name]
    rc, out, err = _run([
        "generate", "--ckpt-dir", ck, "--bars", 4, "--samples", 2,
        "--seed-midi", root / "m0.mid", "--encode", "--interpolate",
        "--interp-midi-b", root / "m1.mid", "--out-dir", tmp_path, *CPU],
        capsys)
    assert rc == 0, err
    assert "generated 2 x 4 bars" in out and "timing: sweep_ms=" in err
    assert sorted(os.listdir(tmp_path)) == ["rolls.npy", "sample_0000.mid",
                                            "sample_0001.mid"]


@pytest.mark.parametrize("name", KINDS)
def test_reconstruct(trained, name, tmp_path, capsys):
    root, runs = trained
    ck, _ = runs[name]
    rc, out, err = _run(["reconstruct", "--ckpt-dir", ck, "--midi-glob",
                         root / "m*.mid", "--out-dir", tmp_path, *CPU],
                        capsys)
    assert rc == 0, err
    assert out.count("precision=") == 2
    assert sorted(os.listdir(tmp_path)) == ["m0.recon.mid", "m1.recon.mid"]


@pytest.mark.parametrize("name", KINDS)
def test_describe_counts_the_jax_params(trained, name, capsys):
    """``describe`` reports the kind and the JAX model's parameter count
    (its ``init_params`` shapes) for the checkpoint's config."""
    _, runs = trained
    ck, _ = runs[name]
    rc, out, _ = _run(["describe", "--ckpt-dir", ck], capsys)
    assert rc == 0
    info = json.loads(out)
    cfg = ckpt_io.restore_config(ckpt_io.make_manager(ck))
    jcfg = jax_ckpt.config_from_json(ckpt_io.config_to_json(cfg))
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k)[1],
                            jax.random.key(0))
    assert info["model_kind"] == cfg.model.kind
    assert info["params"] == sum(int(np.prod(leaf.shape))
                                 for leaf in jax.tree.leaves(shapes))


def _jax_server_labels(cfg, req, seed):
    """The JAX server's ``cond_kwargs`` (musicvae_tpu/cli.py cmd_serve)
    line for line, with numpy arrays in place of its jnp ones."""
    b, n = cfg.gen.num_samples, cfg.gen.num_bars
    rng = np.random.default_rng(seed)
    if req.get("chord") is not None:
        chord = np.full((b, n), int(req["chord"]), np.int32)
    else:
        chord = np.asarray(rng.integers(
            0, cfg.model.cond_chord_classes, (b, n)), np.int32)
    if req.get("key") is not None:
        key_sig = np.full((b,), int(req["key"]), np.int32)
    else:
        key_sig = np.asarray(rng.integers(
            0, cfg.model.cond_key_classes, (b,)), np.int32)
    return chord, key_sig


_REQS = [{"id": 0, "seed": 3}, {"id": 1, "seed": 4, "chord": 5},
         {"id": 2, "seed": 6, "key": 7}, {"id": 3, "seed": 8, "chord": 1,
                                          "key": 2},
         {"id": 4, "seed": 9, "chord": 30}, {"id": 5, "seed": 10,
                                             "key": -1}]


def test_serve_cond_labels_are_the_jax_servers(trained):
    """Each answered request's MIDI equals the sweep for its seed under
    the labels the JAX server would use: given ones everywhere, omitted
    ones drawn from np.random.default_rng(seed), chords first. A class
    out of range is answered in-band."""
    _, runs = trained
    cfg, state = _restored(runs["c4_cond"][0])
    cfg = cfg.replace(gen=GenSpec(num_bars=3, num_samples=2))
    service = cli.Service(cfg, state.model)
    for req in _REQS:
        resp = service.handle(json.dumps(req))
        if req["id"] >= 4:
            field = "chord" if "chord" in req and req["chord"] == 30 \
                else "key"
            assert resp["error"] == (f"ValueError: {field} "
                                     f"{req[field]} out of range")
            continue
        chord, key_sig = _jax_server_labels(cfg, req, req["seed"])
        got_c, got_k = cli.request_labels(cfg, req, req["seed"])
        np.testing.assert_array_equal(got_c, chord)
        np.testing.assert_array_equal(got_k, key_sig)
        bars = sampler.make_generate_fn(cfg, state.model)(
            sampler.seed_generator(req["seed"], "cpu"),
            chord=torch.from_numpy(chord), key_sig=torch.from_numpy(key_sig))
        want = [base64.b64encode(sampler.bars_to_midi(b, cfg)).decode()
                for b in bars.numpy()]
        assert resp["midi_b64"] == want, req
    assert cli.request_labels(
        cfg.replace(model=dataclasses.replace(cfg.model, kind="hier")),
        {"chord": 99}, 0) == (None, None)


def _serve(argv, lines, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", stdio.StringIO(lines))
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    assert rc == 0, err
    return [{k: v for k, v in json.loads(ln).items() if k != "latency_ms"}
            for ln in out.splitlines()]


@pytest.mark.parametrize("name", KINDS)
def test_serve_coalesce_equals_serial(trained, name, capsys, monkeypatch):
    """The same lines (cond labels given, omitted and out of range)
    through serial ``serve``, ``--coalesce 3`` and ``--pipeline``: the
    same responses."""
    _, runs = trained
    base = ["serve", "--ckpt-dir", runs[name][0], "--bars", 3,
            "--samples", 2, *CPU]
    lines = "".join(json.dumps(r) + "\n" for r in _REQS)
    serial = _serve(base, lines, capsys, monkeypatch)
    for extra in (["--coalesce", 3], ["--pipeline"]):
        assert _serve([*base, *extra], lines, capsys, monkeypatch) \
            == serial, extra
    assert [("error" in r) for r in serial] == (
        [False] * 4 + [True] * 2 if name == "c4_cond" else [False] * 6)
    if name == "c4_cond":      # the labels change the music
        assert serial[1]["midi_b64"] != serial[3]["midi_b64"]


@pytest.mark.parametrize("coalesce", [1, 3])
def test_tcp_answers_cond_requests_as_stdin(trained, coalesce):
    """The TCP transport (its device lock, or the batcher under
    ``--coalesce 3``): a client's cond requests, labels given and
    omitted, get the stdin path's MIDI, and a class out of range comes
    back in-band."""
    import threading

    from musicvae_tpu_torch.client import ServeClient, ServeError

    _, runs = trained
    cfg, state = _restored(runs["c4_cond"][0])
    cfg = cfg.replace(gen=GenSpec(num_bars=2, num_samples=2))
    service = cli.Service(cfg, state.model)
    runner = cli._CoalescedRunner(service, coalesce) if coalesce > 1 \
        else None
    ready, res = threading.Event(), {}
    t = threading.Thread(target=lambda: res.update(rc=cli.serve_socket(
        service, "127.0.0.1", 0, 4, runner, "test",
        on_listen=lambda h, p: (res.update(port=p), ready.set()))),
        daemon=True)
    t.start()
    assert ready.wait(60)
    reqs = [dict(seed=3), dict(seed=4, chord=5), dict(seed=6, key=7)]
    with ServeClient(port=res["port"], timeout=60) as c:
        got = [c.generate(**r) for r in reqs]
        with pytest.raises(ServeError, match="chord 24 out of range"):
            c.generate(seed=1, chord=24)
    t.join(60)
    assert not t.is_alive() and res["rc"] == 0
    for r, midis in zip(reqs, got):
        want = service.handle(json.dumps(r))["midi_b64"]
        assert [base64.b64encode(m).decode() for m in midis] == want, r


@pytest.mark.parametrize("name", KINDS)
def test_eval_gen(trained, name, capsys):
    """``eval-gen`` scores the kind's generations against the cache."""
    _, runs = trained
    ck, cache = runs[name]
    rc, out, err = _run(["eval-gen", "--ckpt-dir", ck, "--data", cache,
                         "--bars", 2, "--samples", 3, *CPU], capsys)
    assert rc == 0, err
    result = json.loads(out)
    assert (result["samples"], result["bars_per_sample"]) == (3, 2)
    assert {"gen", "ref", "compare"} <= set(result)
