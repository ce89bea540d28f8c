"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py):
tiny f32 configs, one set of random weights in both packages, and jitted
JAX calls (op-by-op dispatch of an unjitted flax apply costs seconds of
compiles on the CPU backend)."""

import dataclasses
import functools

import jax
import numpy as np

from musicvae_tpu import config as jcfg
from musicvae_tpu.checkpoints.torch_convert import torch_state_dict_to_flax
from musicvae_tpu.models import build_model as jax_build_model
from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.models.vae import build_model as torch_build_model

TINY = dict(enc_channels=(4, 8, 8, 8, 8), dec_channels=(8, 8, 8, 8, 8),
            z_dim=16, gru_hidden=32, bar_feat_dim=32, dtype="float32")


def tiny_pair(name: str = "c2_gru_4bar", **model_kw):
    """(JAX config, port config): the registered config ``name`` at tiny
    f32 widths, with ``model_kw`` on top, identical in both packages."""
    kw = {**TINY, **model_kw}
    j = jcfg.get_config(name)
    j = j.replace(model=dataclasses.replace(j.model, **kw))
    t = tcfg.get_config(name)
    t = t.replace(model=dataclasses.replace(t.model, **kw))
    return j, t


def port_midi_spec(spec) -> tcfg.MidiSpec:
    return tcfg.MidiSpec(**dataclasses.asdict(spec))


def jax_params(jc, tc, seed: int = 0):
    """(flax model, flax params as numpy) for random weights from
    ``seed``, made by the port's init and carried into flax by the JAX
    package's oracle importer."""
    sd = torch_build_model(tc, device="cpu", seed=seed).state_dict()
    params = jax.tree.map(np.asarray, torch_state_dict_to_flax(sd, jc))
    return jax_build_model(jc), params


def port_model(tc, params):
    """The port's model on the CPU with flax ``params`` loaded through the
    port's converter, strictly."""
    model = torch_build_model(tc, device="cpu", seed=12345)
    model.load_state_dict(flax_params_to_state_dict(params, tc),
                          strict=True)
    return model


@functools.lru_cache(maxsize=None)
def jitted(jmodel, method: str):
    """jit of ``jmodel.apply(..., method=method)``; flax modules hash by
    their fields, so one compile per (config, method, shapes)."""
    fn = getattr(jmodel, method)
    return jax.jit(lambda params, *a, **kw: jmodel.apply(
        {"params": params}, *a, method=fn, **kw))


def bars(rng: np.random.Generator, shape, density: float = 0.05):
    return (rng.random(shape) < density).astype(np.float32)
