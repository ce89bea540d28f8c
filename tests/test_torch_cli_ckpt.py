"""The port's CLI over checkpoints (musicvae_tpu_torch/cli.py ``train
--ckpt-dir/--resume``, ``eval``, ``describe``, ``serve --ckpt-dir``) on
the CPU, over checkpoints of c2 at tiny f32 widths and batch 2 (the
checkpoint's config is what the commands run): train and resume, the
refusals that keep a resumed run consistent, EMA switched across a
resume, describe's keys (the JAX package's ``cmd_describe`` set), eval's
means over a cache that is not a batch multiple, and serving a checkpoint
or its EMA weights."""

import ast
import io as stdio
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import musicvae_tpu.cli as jax_cli
from musicvae_tpu.models import init_params
from musicvae_tpu_torch.checkpoints import io
from musicvae_tpu_torch.cli import main
from musicvae_tpu_torch.midi.tensorize import pitch_mask
from musicvae_tpu_torch.ops import losses
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import bar_dataset, tiny_pair, train_cfg

WIDTHS = ["--enc-channels", "4,8,8,8,8", "--dec-channels", "8,8,8,8,8"]


def _train(root: Path, name: str, **kw) -> None:
    """4 steps of the tiny c2 at batch 2, saved at 2 and 4 into
    ``root/name`` as ``train --ckpt-dir`` saves them (with eval: the best
    checkpoint in ``root/name/best``)."""
    cfg = train_cfg(num_steps=4, ckpt_every=2, **kw)
    ds, eval_ds = bar_dataset(pieces=4), None
    best = None
    if cfg.train.eval_every > 0:
        ds, eval_ds = ds.split(cfg.train.holdout_frac, seed=cfg.train.seed)
        best = io.make_manager(str(root / name / "best"), keep=1)
    mgr = io.make_manager(str(root / name))
    trainer.train(cfg, ds, ckpt_manager=mgr, eval_data=eval_ds,
                  best_ckpt_manager=best, device="cpu")
    mgr.wait_until_finished()
    if best is not None:
        best.wait_until_finished()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A bar cache and two trained checkpoint directories of the tiny c2:
    "ema" (EMA weights, an eval every 2 steps and its best checkpoint) and
    "plain"."""
    root = tmp_path_factory.mktemp("cli_ckpt")
    bar_dataset(pieces=4).save_npy(str(root / "cache.npz"))
    _train(root, "ema", ema_decay=0.9, eval_every=2, eval_batches=1,
           holdout_frac=0.3)
    _train(root, "plain")
    return root


@pytest.fixture
def ckpt(runs, tmp_path):
    """A copy of one of the trained directories, and the cache."""
    def copy(name):
        shutil.copytree(runs / name, tmp_path / name)
        return str(tmp_path / name)
    return copy, str(runs / "cache.npz")


def _resume(ckpt_dir, cache, *extra):
    return main(["train", "--data", cache, "--ckpt-dir", ckpt_dir,
                 "--log-dir", ckpt_dir + "-logs", "--device", "cpu",
                 "--resume", *extra])


def test_train_then_resume(ckpt, capsys):
    copy, cache = ckpt
    d = copy("plain")
    assert io.make_manager(d).all_steps() == [2, 4]
    capsys.readouterr()
    assert _resume(d, cache, "--steps", "6") == 0
    err = capsys.readouterr().err
    assert "resumed from step 4" in err
    assert "resumed with CLI overrides: {'num_steps': 6}" in err
    mgr = io.make_manager(d)
    assert mgr.all_steps() == [2, 4, 6]
    cfg = io.restore_config(mgr)
    assert cfg.train.num_steps == 6 and cfg.train.batch_size == 2
    assert cfg.model.enc_channels == (4, 8, 8, 8, 8)
    # the run is done: resuming it again trains nothing and saves nothing
    assert _resume(d, cache, "--steps", "6") == 0
    assert io.make_manager(d).all_steps() == [2, 4, 6]


@pytest.mark.parametrize("case", ["fresh_run", "lr_schedule", "widths"])
def test_train_refuses_what_would_break_a_run(ckpt, capsys, case):
    copy, cache = ckpt
    d = copy("plain")
    if case == "fresh_run":
        rc = main(["train", "--data", cache, "--ckpt-dir", d, "--device",
                   "cpu", *WIDTHS])
        needle = "already contains a checkpoint at step 4"
    elif case == "lr_schedule":
        rc = _resume(d, cache, "--lr-schedule", "cosine")
        needle = "cannot change --lr-schedule on resume"
    else:
        rc = _resume(d, cache, "--enc-channels", "8,8,8,8,8")
        needle = "cannot change the model's widths on resume"
    assert rc == 2 and needle in capsys.readouterr().err
    assert io.make_manager(d).all_steps() == [2, 4]


@pytest.mark.parametrize("name,decay", [("plain", "0.9"), ("ema", "0")])
def test_ema_switched_across_a_resume(ckpt, capsys, name, decay):
    """Switched on, the average starts at the resumed weights; switched
    off, it is dropped; the next checkpoint follows."""
    copy, cache = ckpt
    d = copy(name)
    assert _resume(d, cache, "--steps", "6", "--ema-decay", decay) == 0
    err = capsys.readouterr().err
    assert ("ema enabled on resume" in err) == (name == "plain")
    sd = torch.load(os.path.join(d, "6", io.STATE_FILE), weights_only=True)
    assert (sd["ema"] is not None) == (name == "plain")
    assert io.restore_config(io.make_manager(d)).train.ema_decay == \
        float(decay)


def _jax_describe_keys() -> set:
    """The keys ``cmd_describe`` of the JAX package prints: its ``info``
    dict and the keys it sets on it afterwards."""
    tree = ast.parse(Path(jax_cli.__file__).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "cmd_describe")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "info":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and getattr(
                node.value, "id", None) == "info" and isinstance(
                    node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def test_describe_prints_the_jax_packages_keys(ckpt, capsys):
    copy, _ = ckpt
    d = copy("ema")
    os.rename(os.path.join(d, "2"), os.path.join(d, "2.corrupt"))
    capsys.readouterr()
    assert main(["describe", "--ckpt-dir", d]) == 0
    info = json.loads(capsys.readouterr().out)
    assert set(info) == _jax_describe_keys()
    assert info["steps"] == [4] and info["latest_step"] == 4
    assert info["quarantined"] == ["2.corrupt"] and info["ema"] is True
    assert info["best"]["step"] in (2, 4)
    assert (info["config"], info["roll"], info["meter"]) == (
        "c2_gru_4bar", "96x128", "4/4")
    # the JAX model's parameter count at the same widths
    jc, _ = tiny_pair()
    shapes = jax.eval_shape(lambda k: init_params(jc, k)[1],
                            jax.random.key(0))
    assert info["params"] == sum(int(np.prod(x.shape))
                                 for x in jax.tree.leaves(shapes))
    assert main(["describe", "--ckpt-dir", d + "-none"]) == 2
    assert not os.path.exists(d + "-none")


def _eval_means(ckpt_dir, cache_path, batches):
    """eval's means recomputed per window: the same batches and noise,
    each real window's loss terms once, the pad rows left out."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset

    _, state = trainer.create_state(io.restore_config(io.make_manager(
        ckpt_dir)), device="cpu")
    state, cfg = io.restore(io.make_manager(ckpt_dir), state)
    ds = PianoRollDataset.load_npy(cache_path)
    b = cfg.train.batch_size
    perm = np.random.default_rng(0).permutation(len(ds))
    recon, kl, naive = [], [], []
    mask = pitch_mask(cfg.midi, torch.device("cpu"))
    for i in range(min(batches, -(-len(ds) // b))):
        idx = perm[i * b:(i + 1) * b]
        n_real = idx.shape[0]
        x = torch.from_numpy(ds.batch(np.resize(idx, b),
                                      x_dtype=np.uint8)["x"])
        eps = torch.randn((b, cfg.model.z_dim),
                          generator=torch.Generator().manual_seed(i))
        with torch.no_grad():
            logits, [(mu, lv)] = state.model(x, eps)
        r = torch.sum(losses.bce_with_logits(logits, x) * mask,
                      dim=(1, 2, 3))
        k = -0.5 * torch.sum(1.0 + lv - mu.square() - torch.exp(lv), dim=1)
        recon += r[:n_real].tolist()
        kl += k[:n_real].tolist()
        naive.append(float(r.mean()))
    return {"recon": np.mean(recon), "kl": np.mean(kl),
            "loss": np.mean(recon) + cfg.train.beta_max * np.mean(kl),
            "naive_recon": np.mean(naive)}


@pytest.mark.parametrize("batches", [8, 2])
def test_eval_weights_means_by_real_windows(ckpt, tmp_path, capsys, batches):
    """5 windows at batch 2: the third batch holds one real window and a
    pad row of weight 0; with --batches 2 the sweep stops early."""
    copy, _ = ckpt
    src = io.make_manager(copy("plain"))
    # louder decoder output, so that the windows' losses differ widely
    _, state = trainer.create_state(io.restore_config(src), device="cpu")
    state, cfg = io.restore(src, state)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            if n.startswith("head.deconvs"):
                p.mul_(4.0)
    d = str(tmp_path / "loud")
    assert io.save(io.make_manager(d), state, cfg, wait=True)
    cache = str(tmp_path / "five.npz")
    five = bar_dataset(seed=4, pieces=1)
    five.bars[4:] = five.bars[4:] | (np.random.default_rng(1).random(
        five.bars[4:].shape) < 0.3)
    five.save_npy(cache)
    capsys.readouterr()
    assert main(["eval", "--ckpt-dir", d, "--data", cache, "--device",
                 "cpu", "--batches", str(batches)]) == 0
    got = dict(kv.split("=") for kv in capsys.readouterr().out.split())
    assert set(got) == {"loss", "recon", "kl", "precision", "recall", "f1"}
    want = _eval_means(d, cache, batches)
    for k in ("loss", "recon", "kl"):
        assert float(got[k]) == pytest.approx(want[k], rel=1e-4), k
    if batches == 8:      # the pad row would have moved the mean by far
        #                       more than the tolerance above
        assert abs(want["naive_recon"] - want["recon"]) > \
            1e-3 * want["recon"]


@pytest.mark.parametrize("argv,needle", [
    (["--ema"], jax_cli._EMA_ERROR),
    (["--ckpt-dir", "nowhere"], "no checkpoint in nowhere"),
])
def test_eval_refusals(ckpt, capsys, argv, needle):
    copy, cache = ckpt
    d = copy("plain")
    assert main(["eval", "--ckpt-dir", d, "--data", cache, "--device",
                 "cpu", *argv]) == 2
    assert needle in capsys.readouterr().err


@pytest.mark.parametrize("name,ema", [("plain", False), ("ema", False),
                                      ("ema", True), ("plain", True)])
def test_serve_a_checkpoint(ckpt, capsys, monkeypatch, name, ema):
    copy, _ = ckpt
    d = copy(name)
    monkeypatch.setattr(sys, "stdin", stdio.StringIO(
        '{"id": 1, "seed": 3}\n{"id": 2, "cmd": "stats"}\n'))
    capsys.readouterr()
    rc = main(["serve", "--ckpt-dir", d, "--device", "cpu", "--bars", "2",
               "--samples", "1"] + (["--ema"] if ema else []))
    out, err = capsys.readouterr()
    if ema and name == "plain":
        assert rc == 2 and jax_cli._EMA_ERROR in err and out == ""
        return
    assert rc == 0
    resp, stats = [json.loads(ln) for ln in out.splitlines()]
    assert resp["id"] == 1 and len(resp["midi_b64"]) == 1
    assert stats["stats"]["step"] == 4 and stats["stats"]["bars"] == 2
    assert ("EMA weights" in err) == ema
