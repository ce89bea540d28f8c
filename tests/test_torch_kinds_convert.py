"""Weights of the conv bar-VAE (C1), the hierarchical VAE (C3) and the
chord/key VAE (C4) across the two packages: the port's flax → torch
converter against the JAX package's ``flax_params_to_torch_state_dict``
key for key and value for value, with and without the prev-bar
conditioning; ``canonical_state_dict`` (every GRU's r/z hidden biases
folded, hier's conductor included) against the JAX package's round trip;
``convert`` in its four directions at the registered widths; the Orbax
importer for each kind; and a checkpoint of one kind refused by a state
of another."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import import_orbax_checkpoint as importer
from musicvae_tpu import checkpoints as jax_ckpt
from musicvae_tpu.checkpoints.torch_convert import (
    flax_params_to_torch_state_dict, torch_state_dict_to_flax)
from musicvae_tpu.config import get_config as j_get_config
from musicvae_tpu.train.trainer import TrainState, make_optimizer
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.checkpoints import safetensors_io
from musicvae_tpu_torch.checkpoints.convert import (
    canonical_state_dict, flax_params_to_state_dict,
    flax_train_state_to_state_dict)
from musicvae_tpu_torch.cli import main
from musicvae_tpu_torch.config import get_config
from musicvae_tpu_torch.models.vae import PianoRollVAE, build_model
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import (KINDS, jax_params, kind_pair,
                                one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("prev_bar", [False, True])
@pytest.mark.parametrize("name", KINDS)
def test_converter_matches_jax_export(name, prev_bar):
    jc, tc = kind_pair(name, use_prev_bar=prev_bar)
    _, params = jax_params(jc, tc, 3)
    mine = flax_params_to_state_dict(params, tc)
    theirs = flax_params_to_torch_state_dict(params, jc)
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0)
    assert any(k.startswith("prev_feat") for k in mine) == prev_bar
    model = PianoRollVAE(tc.model, tc.midi)
    assert sorted(model.state_dict()) == sorted(mine)
    model.load_state_dict(theirs, strict=True)


def _state_dict(cfg, seed):
    """A torch state dict for ``cfg`` with every bias random, the GRUs'
    r/z hidden biases included (a reference-style model's)."""
    sd = build_model(cfg, device="cpu", seed=seed).state_dict()
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if "bias" in k else v)
            for k, v in sd.items()}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", KINDS)
def test_canonical_state_dict_matches_jax_round_trip(name):
    jc, tc = kind_pair(name)
    sd = _state_dict(tc, 4)
    got = canonical_state_dict(sd, tc)
    _same(got, flax_params_to_torch_state_dict(
        torch_state_dict_to_flax(sd, jc), jc))
    h = tc.model.gru_hidden
    grus = [k[:-len(".bias_hh")] for k in got if k.endswith("bias_hh")]
    assert sorted(grus) == sorted(
        {"c1_conv_bar": [], "c3_hier_16bar": ["conductor", "dec_gru",
                                              "enc_gru"],
         "c4_cond": ["dec_gru", "enc_gru"]}[name])
    for g in grus:
        assert not got[f"{g}.bias_hh"][:2 * h].any(), g
        torch.testing.assert_close(
            got[f"{g}.bias_ih"][:2 * h],
            sd[f"{g}.bias_ih"][:2 * h] + sd[f"{g}.bias_hh"][:2 * h])
    _same(canonical_state_dict(got, tc), got)


@pytest.mark.parametrize("name", KINDS)
def test_convert_four_directions_match_jax(name, tmp_path, capsys):
    """Registered widths: --from-torch → --to-safetensors →
    --from-safetensors → --to-torch gives the JAX package's round trip of
    the same state dict bit for bit; a file of another kind is refused
    before anything is written."""
    cfg = get_config(name)
    sd = _state_dict(cfg, 5)
    src = tmp_path / "ref.pt"
    torch.save(sd, src)
    cpu = ["--device", "cpu"]
    ck1, ck2 = tmp_path / "ck1", tmp_path / "ck2"
    st, back = tmp_path / "m.safetensors", tmp_path / "back.pt"
    for argv in (["--from-torch", src, "--config", name, "--out", ck1],
                 ["--to-safetensors", ck1, "--out", st],
                 ["--from-safetensors", st, "--config", name, "--out", ck2,
                  "--step", 3],
                 ["--to-torch", ck2, "--out", back]):
        assert main(["convert", *map(str, argv), *cpu]) == 0, \
            capsys.readouterr().err
    jc = j_get_config(name)
    _same(torch.load(back, weights_only=True),
          flax_params_to_torch_state_dict(torch_state_dict_to_flax(sd, jc),
                                          jc))
    assert safetensors_io.load_file(str(st))[1]["config"] == name
    other = "c4_cond" if name != "c4_cond" else "c3_hier_16bar"
    capsys.readouterr()
    assert main(["convert", "--from-torch", str(src), "--config", other,
                 "--out", str(tmp_path / "bad"), *cpu]) == 2
    assert f"does not match config '{other}'" in capsys.readouterr().err
    assert not (tmp_path / "bad").exists()


def _moved(tree, rng, positive=False):
    out = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), tree)
    return jax.tree.map(jnp.abs, out) if positive else out


@pytest.mark.parametrize("name", KINDS)
def test_orbax_checkpoint_of_each_kind_imports(name, tmp_path, capsys):
    """A JAX train state of the kind (moved params and moments, EMA
    weights), saved with Orbax, imports into the port's format and
    restores into a state of its config."""
    jc, tc = kind_pair(name)
    jc = jc.replace(train=dataclasses.replace(jc.train, ema_decay=0.5))
    rng = np.random.default_rng(1)
    params = _moved(jax_params(jc, tc)[1], rng)
    opt_state = make_optimizer(jc).init(params)
    state = TrainState(params=params, opt_state=opt_state,
                       step=jnp.asarray(5, jnp.int32), rng=jax.random.key(0),
                       ema_params=_moved(params, rng))
    jax_ckpt.save(jax_ckpt.make_manager(str(tmp_path / "jax")), state, jc,
                  wait=True)
    assert importer.main(["--ckpt-dir", str(tmp_path / "jax"), "--out",
                          str(tmp_path / "port")]) == 0
    assert f"imported {name} step 5" in capsys.readouterr().out
    mgr = ckpt_io.make_manager(str(tmp_path / "port"))
    cfg = ckpt_io.restore_config(mgr)
    assert cfg.model == tc.model.__class__(**dataclasses.asdict(jc.model))
    _, fresh = trainer.create_state(cfg, device="cpu", seed=11)
    restored, _ = ckpt_io.restore(mgr, fresh)
    np_ = lambda t: jax.tree.map(np.asarray, t)            # noqa: E731
    adam = importer.adam_state(state.opt_state)
    want = flax_train_state_to_state_dict(
        cfg, np_(params), np_(adam.mu), np_(adam.nu), 0, 5,
        np_(state.ema_params))
    got = restored.state_dict()
    for part in ("params", "ema"):
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)
    assert int(got["step"]) == 5


def test_restore_into_another_kind_is_refused(tmp_path):
    """A hier checkpoint restored into a cond state fails for every step
    and quarantines nothing, in the JAX package's wording."""
    _, th = kind_pair("c3_hier_16bar")
    _, tcond = kind_pair("c4_cond")
    _, state = trainer.create_state(th, device="cpu", seed=0)
    mgr = ckpt_io.make_manager(str(tmp_path / "ck"))
    assert ckpt_io.save(mgr, state, th, wait=True)
    _, other = trainer.create_state(tcond, device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="nothing was deleted or "
                                           "quarantined — if this is a "
                                           "config/template mismatch"):
        ckpt_io.restore(mgr, other)
    assert ckpt_io.make_manager(str(tmp_path / "ck")).all_steps() == [0]
