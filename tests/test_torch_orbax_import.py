"""``import_orbax_checkpoint.py`` (repo root): a JAX train state saved by
the JAX package with Orbax, at tiny f32 widths with moved moments and EMA
weights, comes into the port's format; the port's ``io.restore`` then
gives the params, the Adam moments and count, the step and the EMA of
``flax_train_state_to_state_dict`` of the same JAX state, and the same
config JSON. One Orbax save and one restore."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import import_orbax_checkpoint as importer
from musicvae_tpu import checkpoints as jax_ckpt
from musicvae_tpu.train.trainer import TrainState, make_optimizer
from musicvae_tpu_torch.checkpoints import io
from musicvae_tpu_torch.checkpoints.convert import \
    flax_train_state_to_state_dict
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import jax_params, tiny_pair


def _moved(tree, rng, positive=False):
    out = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), tree)
    return jax.tree.map(jnp.abs, out) if positive else out


def test_orbax_checkpoint_imports_into_the_port(tmp_path, capsys):
    jc, tc = tiny_pair()
    jc = jc.replace(train=dataclasses.replace(
        jc.train, ema_decay=0.5, grad_clip_norm=1.0, ckpt_keep=2))
    rng = np.random.default_rng(0)
    params = _moved(jax_params(jc, tc)[1], rng)
    state = TrainState(params=params, opt_state=make_optimizer(jc).init(
        params), step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))

    def move(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(count=jnp.asarray(7, jnp.int32),
                              mu=_moved(s.mu, rng),
                              nu=_moved(s.nu, rng, positive=True))
        return s

    state = state.replace(
        step=jnp.asarray(7, jnp.int32),
        ema_params=_moved(state.params, rng),
        opt_state=jax.tree.map(move, state.opt_state, is_leaf=lambda s:
                               isinstance(s, optax.ScaleByAdamState)))
    jax_ckpt.save(jax_ckpt.make_manager(str(tmp_path / "jax")), state, jc,
                  wait=True)

    # the port refuses the Orbax directory and names the importer
    with pytest.raises(io.OrbaxLayoutError, match=importer.__name__):
        io.restore_config(io.make_manager(str(tmp_path / "jax")))

    assert importer.main(["--ckpt-dir", str(tmp_path / "jax"), "--out",
                          str(tmp_path / "port")]) == 0
    assert "imported c2_gru_4bar step 7" in capsys.readouterr().out
    mgr = io.make_manager(str(tmp_path / "port"))
    assert mgr.all_steps() == [7]
    cfg = io.restore_config(mgr)
    assert io.config_to_json(cfg) == jax_ckpt.config_to_json(jc)
    _, fresh = trainer.create_state(cfg, device="cpu", seed=11)
    restored, _ = io.restore(mgr, fresh)

    adam = importer.adam_state(state.opt_state)
    np_ = lambda t: jax.tree.map(np.asarray, t)            # noqa: E731
    want = flax_train_state_to_state_dict(
        cfg, np_(state.params), np_(adam.mu), np_(adam.nu), 7, 7,
        np_(state.ema_params))
    got = restored.state_dict()
    for part in ("params", "ema"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)
    for part in ("mu", "nu"):
        for k in want["opt"][part]:
            assert torch.equal(got["opt"][part][k],
                               want["opt"][part][k]), (part, k)
    assert int(got["opt"]["count"]) == 7 and int(got["step"]) == 7
