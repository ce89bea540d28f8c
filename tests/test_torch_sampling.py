"""The port's stochastic and seeded generation against the JAX package's:
Bernoulli sampling, bit-packing, pinned latent paths, the posterior encode,
the Bernoulli and seeded sweeps of ``make_generate_fn`` and
``reconstruct_fn``. JAX draws its noise from its keys; the port is handed
the same draws (normals, uniforms, eps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.generate import sampler as jsampler
from musicvae_tpu.midi.tensorize import pitch_mask as j_pitch_mask
from musicvae_tpu.ops import pack as jpack
from musicvae_tpu.ops.binarize import sample_bernoulli_logits as j_bernoulli
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.midi.tensorize import pitch_mask
from musicvae_tpu_torch.ops import pack
from musicvae_tpu_torch.ops.binarize import sample_bernoulli_logits
from torch_port_helpers import (bars, jax_params, jitted, port_model,
                                tiny_pair)
from torch_port_helpers import one_torch_thread  # noqa: F401

U_MARGIN = 1e-6       # |u − σ(l/T)| below which a Bernoulli cell may flip
L_MARGIN = 5e-4       # |logit − logit(threshold)| below which a cell may flip
Z_TOL = 3e-5          # posterior samples, as tests/test_torch_parity.py


@pytest.mark.parametrize("temperature", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("cropped", [False, True])
def test_bernoulli_matches_jax(temperature, cropped):
    """The same uniforms in, the same cells out, except cells whose
    uniform lies within U_MARGIN of their probability (counted)."""
    jc, tc = tiny_pair("c2_cropped" if cropped else "c2_gru_4bar")
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 96, 128))).astype(np.float32)
    key = jax.random.key(int(10 * temperature) + cropped)
    want = np.asarray(j_bernoulli(key, jnp.asarray(logits), temperature,
                                  j_pitch_mask(jc.midi), dtype=jnp.uint8))
    u = np.asarray(jax.random.uniform(key, logits.shape))
    got = sample_bernoulli_logits(torch.tensor(u), torch.tensor(logits),
                                  temperature, pitch_mask(tc.midi),
                                  dtype=torch.uint8)
    assert got.dtype == torch.uint8
    p = np.asarray(jax.nn.sigmoid(jnp.asarray(logits) / temperature))
    near = np.abs(u - p) < U_MARGIN
    diff = got.numpy() != want
    assert not (diff & ~near).any()
    print(f"bernoulli parity: {int(diff.sum())} flips, {int(near.sum())} "
          f"cells within {U_MARGIN}")
    assert diff.sum() <= 3 and 0.1 < want.mean() < 0.9 - 0.2 * cropped
    if cropped:
        assert not got[..., :24].any() and not got[..., 108:].any()


def test_pack_bits_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.random((2, 3, 96, 128)) < 0.3).astype(np.uint8)
    x[0, 0, 0] = 7                                  # nonzero counts as 1
    want = np.asarray(jpack.pack_bits(jnp.asarray(x)))
    got = pack.pack_bits(torch.tensor(x))
    assert got.dtype == torch.uint8 and got.shape == (2, 3, 96, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pack.pack_bits_np(x),
                                  jpack.pack_bits_np(x))
    ones = (x != 0).astype(np.uint8)
    np.testing.assert_array_equal(pack.unpack_bits_np(got.numpy()), ones)
    back = pack.unpack_bits(torch.tensor(pack.pack_bits_np(x)))
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), ones)
    np.testing.assert_array_equal(
        pack.unpack_bits(got, torch.uint8).numpy(),
        np.asarray(jpack.unpack_bits(jnp.asarray(want), jnp.uint8)))
    for fn in (pack.pack_bits, pack.pack_bits_np):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(torch.zeros(2, 12) if fn is pack.pack_bits
               else np.zeros((2, 12)))


def _jax_noise(key, interpolate, batch, num_bars, z_dim=16):
    """The normals the JAX latent_path draws from ``key``."""
    if interpolate:
        k_a, k_b = jax.random.split(key)
        return np.stack([np.asarray(jax.random.normal(k, (batch, z_dim)))
                         for k in (k_a, k_b)])
    return np.asarray(jax.random.normal(key, (-(-num_bars // 4), batch,
                                              z_dim)))


@pytest.mark.parametrize("interpolate,pins", [
    (False, "z0"), (True, "z0"), (True, "z1"), (True, "z0z1")])
def test_pinned_latent_path_matches_jax(interpolate, pins):
    jc, tc = tiny_pair()
    rng = np.random.default_rng(3)
    batch, num_bars, temp = 3, 9, 0.7
    pin = {k: rng.standard_normal((batch, 16)).astype(np.float32)
           for k in ("z0", "z1") if k in pins}
    key = jax.random.key(4)
    z_j, reset_j = jsampler.latent_path(
        key, jc, batch, num_bars, interpolate, temp,
        **{k: jnp.asarray(v) for k, v in pin.items()})
    z, reset = sampler.latent_path(
        tc, batch, num_bars, interpolate, temp,
        noise=torch.tensor(_jax_noise(key, interpolate, batch, num_bars)),
        **{k: torch.tensor(v) for k, v in pin.items()})
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-6)
    np.testing.assert_array_equal(reset.numpy(), np.asarray(reset_j))
    if "z0" in pin and not interpolate:     # a slerp rounds at t = 0
        np.testing.assert_array_equal(z[:, 0].numpy(), pin["z0"])


def test_z1_needs_interpolate_in_both():
    jc, tc = tiny_pair()
    z1 = np.zeros((2, 16), np.float32)
    with pytest.raises(ValueError, match="interpolate=True"):
        jsampler.latent_path(jax.random.key(0), jc, 2, 4, False,
                             z1=jnp.asarray(z1))
    with pytest.raises(ValueError, match="interpolate=True"):
        sampler.latent_path(tc, 2, 4, False, generator=torch.Generator(),
                            z1=torch.tensor(z1))


def _models(seed, **model_kw):
    jc, tc = tiny_pair(**model_kw)
    jmodel, params = jax_params(jc, tc, seed)
    return jc, tc, jmodel, params, port_model(tc, params)


@pytest.mark.parametrize("pallas_conv1", [False, True])
def test_encode_matches_jax(pallas_conv1):
    jc, tc, jmodel, params, model = _models(11, use_pallas_conv1=pallas_conv1)
    x = bars(np.random.default_rng(11), (3, 4, 96, 128), 0.08)
    key = jax.random.key(12)
    want = jsampler.make_encode_fn(jc, jmodel)(params, jnp.asarray(x), key)
    eps = np.asarray(jax.random.normal(key, (3, 16)))
    got = sampler.make_encode_fn(tc, model)(torch.tensor(x),
                                            eps=torch.tensor(eps))
    assert sorted(got) == sorted(want) == ["z0"]
    np.testing.assert_allclose(got["z0"].numpy(), np.asarray(want["z0"]),
                               atol=Z_TOL)


def _compare_sweeps(got, want, may_flip):
    """Bar by bar while the bars so far agree: cells may differ only where
    ``may_flip`` (from the JAX logits); after a flip the feedback differs
    and the comparison stops. Returns (bars compared, flips)."""
    flips = compared = 0
    for k in range(want.shape[1]):
        diff = got[:, k] != want[:, k]
        assert not (diff & ~may_flip(k)).any(), f"bar {k}: flip outside " \
                                                 "the margin"
        compared += 1
        flips += int(diff.sum())
        if flips:
            break
    return compared, flips


def _sweep_case(mode, **gen_kw):
    """Both packages' configs with a 2-sample, 6-bar GenSpec."""
    jc, tc, jmodel, params, model = _models(13, use_pallas_conv1=True)
    gen = dict(num_bars=6, num_samples=2, sample_mode=mode, **gen_kw)
    jc = jc.replace(gen=dataclasses.replace(jc.gen, **gen))
    tc = tc.replace(gen=GenSpec(**gen))
    return jc, tc, jmodel, params, model


def test_bernoulli_sweep_matches_jax():
    """make_generate_fn in Bernoulli mode: the JAX sweep's per-bar keys
    (``bin_keys``) give the uniforms handed to the port."""
    jc, tc, jmodel, params, model = _sweep_case(
        "bernoulli", sample_temperature=0.8, temperature=0.9)
    key = jax.random.key(14)
    want = np.asarray(jsampler.make_generate_fn(jc, jmodel)(params, key))
    k_z, _, _, _, k_bin = jax.random.split(key, 5)
    bin_keys = jax.random.split(k_bin, 6)
    u = np.stack([np.asarray(jax.random.uniform(bk, (2, 96, 128)))
                  for bk in bin_keys], axis=1)                 # [B,N,T,P]
    # the JAX logits, from the same path through its model
    z_j, reset_j = jsampler.latent_path(k_z, jc, 2, 6, False, 0.9)
    logits_j, bars_j = jitted(jmodel, "generate")(
        params, z_j, reset_j, bin_keys=bin_keys, sample_temperature=0.8)
    np.testing.assert_array_equal(np.asarray(bars_j), want)
    p = np.asarray(jax.nn.sigmoid(logits_j / 0.8))
    got = sampler.make_generate_fn(tc, model)(
        None, noise=torch.tensor(_jax_noise(k_z, False, 2, 6)),
        uniforms=torch.tensor(u))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    compared, flips = _compare_sweeps(
        got.numpy(), want, lambda k: np.abs(u[:, k] - p[:, k]) < U_MARGIN)
    print(f"bernoulli sweep: {compared} bars compared, {flips} flips")
    assert compared >= 1 and 0.05 < want.mean() < 0.95


def test_seeded_sweep_matches_jax():
    """A threshold sweep from a seed bar with both latent endpoints pinned
    (the --seed-midi --encode --interp-midi-b path)."""
    jc, tc, jmodel, params, model = _sweep_case("threshold",
                                                interpolate=True)
    rng = np.random.default_rng(15)
    seed_bar = bars(rng, (2, 96, 128), 0.1).astype(np.uint8)
    z0, z1 = (rng.standard_normal((2, 16)).astype(np.float32)
              for _ in range(2))
    key = jax.random.key(16)
    want = np.asarray(jsampler.make_generate_fn(jc, jmodel)(
        params, key, seed_bar=jnp.asarray(seed_bar), z0=jnp.asarray(z0),
        z1=jnp.asarray(z1)))
    k_z = jax.random.split(key, 5)[0]
    z_j, reset_j = jsampler.latent_path(k_z, jc, 2, 6, True, 1.0,
                                        z0=jnp.asarray(z0),
                                        z1=jnp.asarray(z1))
    logits_j, bars_j = jitted(jmodel, "generate")(params, z_j, reset_j,
                                                  jnp.asarray(seed_bar))
    np.testing.assert_array_equal(np.asarray(bars_j), want)
    logits_j = np.asarray(logits_j)
    got = sampler.make_generate_fn(tc, model)(
        None, seed_bar=torch.tensor(seed_bar), z0=torch.tensor(z0),
        z1=torch.tensor(z1), noise=torch.zeros(2, 2, 16))
    compared, flips = _compare_sweeps(
        got.numpy(), want,
        lambda k: np.abs(logits_j[:, k]) <= L_MARGIN)   # logit(0.5) = 0
    print(f"seeded sweep: {compared} bars compared, {flips} flips")
    assert compared >= 1


def test_reconstruct_matches_jax():
    jc, tc, jmodel, params, model = _models(17, use_pallas_conv1=True)
    x = bars(np.random.default_rng(17), (2, 4, 96, 128), 0.08)
    key = jax.random.key(18)
    want = np.asarray(jsampler.reconstruct_fn(jc, jmodel)(
        params, jnp.asarray(x), key))

    def draw(mdl, x):
        k = mdl.make_rng("latent")
        mu, _ = mdl.encode(x)["z"]
        return jax.random.normal(k, mu.shape, mu.dtype)
    eps = jax.jit(lambda p, x, key: jmodel.apply(
        {"params": p}, x, method=draw, rngs={"latent": key}))(
            params, jnp.asarray(x), key)
    logits_j, _ = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                             eps=(eps,))
    logits_j = np.asarray(logits_j)
    got = sampler.reconstruct_fn(tc, model)(torch.tensor(x),
                                            eps=torch.tensor(np.asarray(eps)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = got.numpy() != want
    assert not (diff & (np.abs(logits_j) > L_MARGIN)).any()
    print(f"reconstruct: {int(diff.sum())} flips")
    assert diff.sum() <= 3


def test_bernoulli_sweep_from_a_generator_is_seeded():
    """With no uniforms handed in, the generator draws them bar by bar on
    the model's device: one seed, one result; threshold mode ignores
    them."""
    _, tc, _, _, model = _sweep_case("bernoulli")
    sweep = sampler.make_generate_fn(tc, model)
    a, b, c = (sweep(torch.Generator().manual_seed(s)) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    thr = sampler.make_generate_fn(
        tc.replace(gen=dataclasses.replace(tc.gen, sample_mode="threshold")),
        model)
    assert torch.equal(thr(torch.Generator().manual_seed(5)),
                       thr(torch.Generator().manual_seed(5)))
    with pytest.raises(ValueError, match="sample_mode"):
        sampler.make_generate_fn(
            tc.replace(gen=dataclasses.replace(tc.gen, sample_mode="x")),
            model)
