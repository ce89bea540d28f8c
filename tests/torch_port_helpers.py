"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py):
tiny f32 configs, one set of random weights in both packages, and jitted
JAX calls (op-by-op dispatch of an unjitted flax apply costs seconds of
compiles on the CPU backend)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

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


TRAIN_KW = dict(batch_size=2, log_every=2, ckpt_every=0, eval_every=0,
                beta_warmup_steps=4, seed=3)


def train_cfg(**train_kw):
    """The port's tiny c2 config with a short-run TrainSpec
    (``TRAIN_KW``, then ``train_kw``)."""
    _, tc = tiny_pair()
    return tc.replace(train=dataclasses.replace(
        tc.train, **{**TRAIN_KW, **train_kw}))


def bar_dataset(seed=0, pieces=6, bars_per_piece=8, num_bars=4):
    """A port PianoRollDataset of Bernoulli(0.05) bars whose windows never
    cross a piece."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset

    rng = np.random.default_rng(seed)
    bars = (rng.random((pieces * bars_per_piece, 96, 128)) < 0.05
            ).astype(np.uint8)
    per = bars_per_piece - num_bars + 1
    starts = (np.arange(pieces)[:, None] * bars_per_piece
              + np.arange(per)[None, :]).reshape(-1)
    return PianoRollDataset(
        bars, starts, num_bars, rng.integers(0, 24, starts.shape[0]),
        rng.integers(0, 24, starts.shape[0]),
        np.repeat(np.arange(pieces), per), grid=(24, 4, 0))


def state_tensors(state) -> list:
    """Every tensor of a port TrainState, the generator's state included,
    in a fixed order."""
    sd = state.state_dict()
    return ([sd["step"], sd["opt"]["count"], sd["rng"]]
            + [t for k in ("params", "ema") for t in (sd[k] or {}).values()]
            + [t for k in ("mu", "nu") for t in sd["opt"][k].values()])


def same_state(a, b) -> bool:
    ta, tb = state_tensors(a), state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The importing module's torch work on one thread: the suite runs as
    several workers on a few cores, where torch's default of a thread a
    core oversubscribes them many times over; unloaded, one thread costs
    these tiny shapes nothing. The previous count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the other parity kinds at tiny widths: hier at 3 bars, hidden 16 and an
# 8-wide phrase latent
KINDS = ("c1_conv_bar", "c3_hier_16bar", "c4_cond")
KIND_KW = {"c1_conv_bar": {},
           "c3_hier_16bar": dict(num_bars=3, gru_hidden=16, z_phrase_dim=8),
           "c4_cond": {}}


def kind_pair(name: str, **model_kw):
    """``tiny_pair`` of a registered config with its kind's tiny sizes."""
    return tiny_pair(name, **{**KIND_KW.get(name, {}), **model_kw})


def kind_inputs(rng: np.random.Generator, spec, b: int = 2,
                density: float = 0.05):
    """(x [B,N,T,P] f32, eps (one array a latent level), labels {} or
    {"chord" [B,N], "key_sig" [B]} int32) for a model spec, numpy."""
    x = bars(rng, (b, spec.num_bars, 96, 128), density)
    if spec.kind == "hier":
        eps = (rng.standard_normal((b, spec.z_phrase_dim)),
               rng.standard_normal((b, spec.num_bars, spec.z_dim)))
    else:
        eps = (rng.standard_normal((b, spec.z_dim)),)
    eps = tuple(e.astype(np.float32) for e in eps)
    labels = {}
    if spec.kind == "cond":
        labels = {"chord": rng.integers(0, spec.cond_chord_classes,
                                        (b, spec.num_bars)).astype(np.int32),
                  "key_sig": rng.integers(0, spec.cond_key_classes,
                                          (b,)).astype(np.int32)}
    return x, eps, labels


def to_jax(tree):
    return jax.tree.map(jax.numpy.asarray, tree)


def to_torch(tree):
    return jax.tree.map(torch.tensor, tree)
