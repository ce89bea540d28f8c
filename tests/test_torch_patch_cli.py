"""The port's commands on a patch-stem model with the attention core
(c2_trf) and one with the GRU core (c3_mxu), in-process on the CPU at
narrow stem widths (``--enc-channels/--dec-channels``, batch 2):
``train`` (with an eval, then ``--resume``) → ``eval`` → ``generate`` →
``reconstruct`` → ``eval-gen`` → ``serve`` (stdin, ``--coalesce 2``, and
``--use-pallas-conv1``, which the patch stem ignores) → ``describe``; and
``convert``, which refuses both families as the JAX package's
``torch_convert`` does."""

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
from musicvae_tpu.checkpoints import torch_convert as jconvert
from musicvae_tpu.models import init_params as j_init_params
from musicvae_tpu_torch import cli
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.checkpoints.convert import (UnconvertibleConfig,
                                                    canonical_state_dict)
from musicvae_tpu_torch.config import GenSpec, get_config
from musicvae_tpu_torch.data.dataset import PianoRollDataset
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.models.vae import draw_eps
from musicvae_tpu_torch.utils.metrics import make_eval_fn
from torch_port_helpers import one_torch_thread  # noqa: F401

NAMES = ("c2_trf", "c3_mxu")
WIDTHS = ["--enc-channels", "8,8,16", "--dec-channels", "16,8,8"]
CPU = ["--device", "cpu"]


def _run(argv, capsys):
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{name: (checkpoint dir, bar cache)}: each config trained 2 steps at
    batch 2 from a 3-piece synthetic cache, with an eval at step 2; and
    two MIDI files."""
    root = tmp_path_factory.mktemp("patch_cli")
    for i, (data, _, _) in enumerate(synth_corpus(2, 6, seed=5)):
        (root / f"m{i}.mid").write_bytes(data)
    out = {}
    for name in NAMES:
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


@pytest.mark.parametrize("name", NAMES)
def test_train_checkpoints_and_resumes(trained, name, capsys):
    root, runs = trained
    ck, cache = runs[name]
    assert ckpt_io.make_manager(ck).all_steps() == [2]
    rc, out, err = _run(["train", "--data", cache, "--ckpt-dir", ck,
                         "--resume", "--steps", 3, "--log-dir",
                         root / "logs", *CPU], capsys)
    assert rc == 0 and "resumed from step 2" in err, err
    assert "final metrics" in out
    cfg = ckpt_io.restore_config(ckpt_io.make_manager(ck))
    assert cfg.name == name and cfg.model.enc_channels == (8, 8, 16)


@pytest.mark.parametrize("name", NAMES)
def test_eval_scores_the_cache(trained, name, capsys):
    """``eval --data``: the printed means equal the eval function's on the
    same batch and noise (K2's plain version on the CPU)."""
    _, runs = trained
    ck, cache = runs[name]
    rc, out, err = _run(["eval", "--ckpt-dir", ck, "--data", cache,
                         "--batches", 1, *CPU], capsys)
    assert rc == 0, err
    got = dict(kv.split("=") for kv in out.split())
    cfg, state = cli.restore_checkpoint(ck, "cpu")
    ds = PianoRollDataset.load_npy(cache)
    b = cfg.train.batch_size
    idx = np.random.default_rng(0).permutation(len(ds))[:b].astype(np.int32)
    x = torch.from_numpy(ds.batch(idx)["x"])
    want = make_eval_fn(cfg, state.model)(
        x, draw_eps(cfg.model, b, torch.Generator().manual_seed(0)))
    for k, v in want.items():
        assert got[k] == f"{float(v):.5g}", k


@pytest.mark.parametrize("name", NAMES)
def test_generate_reconstruct_and_eval_gen(trained, name, tmp_path, capsys):
    """``generate`` equals the sampler's sweep for its seed; then
    ``reconstruct`` two MIDI files and ``eval-gen`` against the cache."""
    root, runs = trained
    ck, cache = runs[name]
    rc, _, err = _run(["generate", "--ckpt-dir", ck, "--bars", 5,
                       "--samples", 2, "--seed", 4, "--out-dir",
                       tmp_path / "gen", *CPU], capsys)
    assert rc == 0, err
    rolls = np.load(tmp_path / "gen" / "rolls.npy")
    cfg, state = cli.restore_checkpoint(ck, "cpu")
    cfg = cfg.replace(gen=GenSpec(num_bars=5, num_samples=2))
    want = sampler.make_generate_fn(cfg, state.model)(
        torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(rolls, want.numpy())
    rc, out, err = _run(["reconstruct", "--ckpt-dir", ck, "--midi-glob",
                         root / "m*.mid", "--out-dir", tmp_path / "rec",
                         *CPU], capsys)
    assert rc == 0 and out.count("precision=") == 2, err
    rc, out, err = _run(["eval-gen", "--ckpt-dir", ck, "--data", cache,
                         "--bars", 2, "--samples", 3, *CPU], capsys)
    assert rc == 0, err
    assert json.loads(out)["samples"] == 3


def _serve(argv, lines, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", stdio.StringIO(lines))
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    assert rc == 0, err
    return [{k: v for k, v in json.loads(ln).items() if k != "latency_ms"}
            for ln in out.splitlines()]


@pytest.mark.parametrize("name", NAMES)
def test_serve_coalesce_and_conv1_flag(trained, name, capsys, monkeypatch):
    """The same lines through serial ``serve``, ``--coalesce 2`` and
    serial ``--use-pallas-conv1`` (ignored by the patch stem, as the JAX
    package ignores it): the same responses, each a sweep's MIDI."""
    _, runs = trained
    base = ["serve", "--ckpt-dir", runs[name][0], "--bars", 3,
            "--samples", 2, *CPU]
    lines = "".join(json.dumps({"id": i, "seed": 3 + i}) + "\n"
                    for i in range(3))
    serial = _serve(base, lines, capsys, monkeypatch)
    assert [r["id"] for r in serial] == [0, 1, 2]
    assert all(len(r["midi_b64"]) == 2 for r in serial)
    for extra in (["--coalesce", 2], ["--use-pallas-conv1"]):
        assert _serve([*base, *extra], lines, capsys, monkeypatch) \
            == serial, extra


@pytest.mark.parametrize("name", NAMES)
def test_describe_counts_the_jax_params(trained, name, capsys):
    _, runs = trained
    rc, out, _ = _run(["describe", "--ckpt-dir", runs[name][0]], capsys)
    assert rc == 0
    info = json.loads(out)
    cfg = ckpt_io.restore_config(ckpt_io.make_manager(runs[name][0]))
    jcfg = jax_ckpt.config_from_json(ckpt_io.config_to_json(cfg))
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k)[1],
                            jax.random.key(0))
    assert info["params"] == sum(int(np.prod(leaf.shape))
                                 for leaf in jax.tree.leaves(shapes))
    assert (info["stem"], info["temporal"]) == (
        "patch", "attn" if name == "c2_trf" else "gru")


@pytest.mark.parametrize("name", NAMES)
def test_convert_refuses(trained, name, tmp_path, capsys):
    """Both directions exit 2 with the JAX package's words (the stem is
    checked first), and write nothing."""
    _, runs = trained
    words = "MXU patch stem"
    rc, _, err = _run(["convert", "--to-safetensors", runs[name][0], "--out",
                       tmp_path / "m.safetensors", *CPU], capsys)
    assert rc == 2 and err.startswith("error:") and words in err, err
    src = tmp_path / "any.pt"
    torch.save({}, src)
    rc, _, err = _run(["convert", "--from-torch", src, "--config", name,
                       "--out", tmp_path / "ck", *CPU], capsys)
    assert rc == 2 and words in err, err
    assert sorted(os.listdir(tmp_path)) == ["any.pt"]


@pytest.mark.parametrize("name,model_kw", [
    ("c2_mxu", {}), ("c2_trf", {}),
    ("c2_gru_4bar", dict(temporal="attn"))])
def test_canonical_state_dict_refuses_with_the_jax_words(name, model_kw):
    from musicvae_tpu.config import get_config as jget

    cfg = get_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    jc = jget(name)
    jc = jc.replace(model=dataclasses.replace(jc.model, **model_kw))
    with pytest.raises(ValueError) as want:
        jconvert.torch_state_dict_to_flax({}, jc)
    with pytest.raises(UnconvertibleConfig) as got:
        canonical_state_dict({}, cfg)
    assert str(got.value) == str(want.value)
