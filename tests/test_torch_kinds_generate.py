"""Generation of the conv bar-VAE (C1), the hierarchical VAE (C3) and the
chord/key VAE (C4) against the JAX package's, at tiny f32 widths, with
the noise injected: JAX draws its latent path, its cond labels and its
phrase latent from split keys, and the port is handed the same numbers.
Bars are compared as tests/test_torch_sampling.py compares them: bar by
bar while the bars agree, a cell may differ only where the JAX logit lies
within L_MARGIN of the threshold (counted). Then hier's phrase latent and
its morph end, cond's labels, the posterior encode, reconstruction, the
generator's draw order, and the coalesced sweep against the lone one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.generate import sampler as jsampler
from musicvae_tpu.midi.tensorize import pitch_mask as j_pitch_mask
from musicvae_tpu.ops.binarize import binarize_logits as j_binarize
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.models.vae import draw_eps
from musicvae_tpu_torch.ops.pack import unpack_bits_np
from torch_port_helpers import (KINDS, bars, jax_params, jitted,
                                kind_inputs, kind_pair,
                                one_torch_thread,  # noqa: F401
                                port_model, to_jax, to_torch)

L_MARGIN = 5e-4       # |logit − logit(threshold)| below which a cell may flip
Z_TOL = 3e-5          # posterior samples, as tests/test_torch_parity.py
SAMPLES, BARS = 2, 5


def _case(name, seed, **gen_kw):
    jc, tc = kind_pair(name, use_pallas_conv1=True)
    jmodel, params = jax_params(jc, tc, seed)
    gen = dict(num_bars=BARS, num_samples=SAMPLES, **gen_kw)
    jc = jc.replace(gen=dataclasses.replace(jc.gen, **gen))
    tc = tc.replace(gen=GenSpec(**gen))
    return jc, tc, jmodel, params, port_model(tc, params)


def _jax_draws(key, jc):
    """What the JAX sweep draws from ``key``: its latent path's normals
    (unscaled, as the port's ``noise``), cond's chord/key classes and
    hier's phrase latent (scaled by the temperature)."""
    g, spec = jc.gen, jc.model
    k_z, k_c, k_k, k_p, _ = jax.random.split(key, 5)
    if g.interpolate:
        noise = np.stack([np.asarray(jax.random.normal(k, (SAMPLES,
                                                           spec.z_dim)))
                          for k in jax.random.split(k_z)])
    else:
        phrase = 1 if spec.kind == "hier" else spec.num_bars
        noise = np.asarray(jax.random.normal(
            k_z, (-(-BARS // phrase), SAMPLES, spec.z_dim)))
    out = {"noise": noise}
    if spec.kind == "cond":
        out["chord"] = np.asarray(jax.random.randint(
            k_c, (SAMPLES, BARS), 0, spec.cond_chord_classes))
        out["key_sig"] = np.asarray(jax.random.randint(
            k_k, (SAMPLES,), 0, spec.cond_key_classes))
    if spec.kind == "hier":
        out["z_phrase0"] = np.asarray(jax.random.normal(
            k_p, (SAMPLES, spec.z_phrase_dim))) * g.temperature
    return k_z, out


def _compare(got, want, logits_j):
    """Bar by bar while the bars agree; returns (bars compared, flips)."""
    compared = flips = 0
    for k in range(want.shape[1]):
        diff = got[:, k] != want[:, k]
        near = np.abs(logits_j[:, k]) <= L_MARGIN     # logit(0.5) = 0
        assert not (diff & ~near).any(), f"bar {k}: flip outside margin"
        compared += 1
        flips += int(diff.sum())
        if flips:
            break
    return compared, flips


def _jax_logits(jc, jmodel, params, k_z, draws, extra=None):
    """The JAX logits of the sweep, from the same path and conditioning
    through its model's ``generate``."""
    extra = extra or {}
    z_j, reset_j = jsampler.latent_path(
        k_z, jc, SAMPLES, BARS, jc.gen.interpolate, jc.gen.temperature,
        z0=extra.get("z0"), z1=extra.get("z1"))
    kw = {k: jnp.asarray(draws[k]) for k in ("chord", "key_sig")
          if k in draws}
    if "z_phrase" in extra:
        kw["z_phrase"] = extra["z_phrase"]
    elif "z_phrase0" in draws:
        kw["z_phrase"] = jnp.asarray(draws["z_phrase0"])
    logits, bars_j = jitted(jmodel, "generate")(params, z_j, reset_j, **kw)
    return np.asarray(logits), np.asarray(bars_j)


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("name", KINDS)
def test_sweep_matches_jax(name, interpolate):
    jc, tc, jmodel, params, model = _case(name, 5, interpolate=interpolate,
                                          temperature=0.9)
    key = jax.random.key(6)
    want = np.asarray(jsampler.make_generate_fn(jc, jmodel)(params, key))
    k_z, draws = _jax_draws(key, jc)
    logits_j, bars_j = _jax_logits(jc, jmodel, params, k_z, draws)
    np.testing.assert_array_equal(bars_j, want)
    got = sampler.make_generate_fn(tc, model)(
        None, **{k: torch.tensor(v) for k, v in draws.items()})
    assert got.dtype == torch.uint8 and got.shape == want.shape
    compared, flips = _compare(got.numpy(), want, logits_j)
    print(f"{name} sweep: {compared} bars compared, {flips} flips")
    assert compared >= 2 and 0.05 < want.mean() < 0.95


def test_hier_phrase_morph_matches_jax():
    """hier under interpolate: z_phrase0 → z_phrase1 slerped bar by bar
    (the phrase-identity morph) with the per-bar z path's endpoints
    pinned too, against the JAX sweep given the same latents."""
    jc, tc, jmodel, params, model = _case("c3_hier_16bar", 7,
                                          interpolate=True)
    rng = np.random.default_rng(7)
    zp0, zp1 = (rng.standard_normal((SAMPLES, 8)).astype(np.float32)
                for _ in range(2))
    z0, z1 = (rng.standard_normal((SAMPLES, 16)).astype(np.float32)
              for _ in range(2))
    key = jax.random.key(8)
    pins = dict(z0=jnp.asarray(z0), z1=jnp.asarray(z1),
                z_phrase0=jnp.asarray(zp0), z_phrase1=jnp.asarray(zp1))
    want = np.asarray(jsampler.make_generate_fn(jc, jmodel)(params, key,
                                                            **pins))
    ts = jnp.linspace(0.0, 1.0, BARS)
    from musicvae_tpu.models.latent import slerp as jslerp
    path = jnp.swapaxes(jax.vmap(lambda t: jslerp(pins["z_phrase0"],
                                                  pins["z_phrase1"], t))(ts),
                        0, 1)
    k_z, draws = _jax_draws(key, jc)
    logits_j, _ = _jax_logits(jc, jmodel, params, k_z, draws,
                              dict(z0=pins["z0"], z1=pins["z1"],
                                   z_phrase=path))
    got = sampler.make_generate_fn(tc, model)(
        None, noise=torch.zeros(2, SAMPLES, 16),
        **{k: torch.tensor(np.asarray(v)) for k, v in pins.items()})
    compared, flips = _compare(got.numpy(), want, logits_j)
    print(f"hier morph: {compared} bars compared, {flips} flips")
    assert compared >= 2
    # the morph moves the music: the path's two ends differ
    same_ends = sampler.make_generate_fn(tc, model)(
        None, noise=torch.zeros(2, SAMPLES, 16),
        **{k: torch.tensor(np.asarray(v)) for k, v in pins.items()
           if k != "z_phrase1"})
    assert not torch.equal(got, same_ends)


@pytest.mark.parametrize("name,interpolate", [("c3_hier_16bar", False),
                                              ("c4_cond", True)])
def test_z_phrase1_needs_hier_and_interpolate(name, interpolate):
    _, tc, _, _, model = _case(name, 9, interpolate=interpolate)
    with pytest.raises(ValueError, match="z_phrase1 morphs the hier phrase "
                                         "latent and needs kind='hier' "
                                         "plus interpolate=True"):
        sampler.make_generate_fn(tc, model)(
            torch.Generator().manual_seed(0), z_phrase1=torch.zeros(2, 8))


def test_cond_labels_steer_the_sweep():
    """Given chord/key classes replace the drawn ones (the generator then
    draws only the latent path), and other classes give other music."""
    _, tc, _, _, model = _case("c4_cond", 10)
    sweep = sampler.make_generate_fn(tc, model)
    chord = torch.full((SAMPLES, BARS), 3)
    key_sig = torch.full((SAMPLES,), 7)
    a = sweep(torch.Generator().manual_seed(1), chord=chord, key_sig=key_sig)
    noise = sampler.latent_noise(tc, SAMPLES, BARS, False,
                                 torch.Generator().manual_seed(1))
    b = sweep(None, noise=noise, chord=chord, key_sig=key_sig)
    assert torch.equal(a, b)
    c = sweep(None, noise=noise, chord=chord + 6, key_sig=key_sig)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("name", KINDS)
def test_generator_draw_order(name):
    """A sweep from a generator equals the sweep handed a twin
    generator's draws in the documented order: the latent normals, cond's
    chord then key classes, hier's phrase latent (then, in Bernoulli
    mode, each bar's uniforms from the generator)."""
    _, tc, _, _, model = _case(name, 11, sample_mode="bernoulli",
                               temperature=0.8)
    sweep = sampler.make_generate_fn(tc, model)
    want = sweep(torch.Generator().manual_seed(12))
    twin = torch.Generator().manual_seed(12)
    noise = torch.randn((-(-BARS // (1 if name == "c3_hier_16bar" else
                                     tc.model.num_bars)), SAMPLES,
                         tc.model.z_dim), generator=twin)
    kw = {}
    if name == "c4_cond":
        kw["chord"] = torch.randint(0, 24, (SAMPLES, BARS), generator=twin)
        kw["key_sig"] = torch.randint(0, 24, (SAMPLES,), generator=twin)
    if name == "c3_hier_16bar":
        kw["z_phrase0"] = torch.randn((SAMPLES, 8), generator=twin) * 0.8
    got = sweep(twin, noise=noise, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", KINDS)
def test_encode_matches_jax(name):
    """The posterior sample of the seed window: z0, or hier's phrase
    latent z_phrase0; cond encodes under the window's labels."""
    jc, tc, jmodel, params, model = _case(name, 13)
    x, _, labels = kind_inputs(np.random.default_rng(13), jc.model, 3, 0.08)
    key = jax.random.key(14)
    want = jsampler.make_encode_fn(jc, jmodel)(params, jnp.asarray(x), key,
                                               **to_jax(labels))
    (level, w), = want.items()
    assert level == ("z_phrase0" if name == "c3_hier_16bar" else "z0")
    eps = np.asarray(jax.random.normal(key, w.shape))
    got = sampler.make_encode_fn(tc, model)(
        torch.tensor(x), eps=torch.tensor(eps), **to_torch(labels))
    assert sorted(got) == [level]
    np.testing.assert_allclose(got[level].numpy(), np.asarray(w), atol=Z_TOL)
    # with a generator, the draw has the level's shape
    drawn = sampler.make_encode_fn(tc, model)(
        torch.tensor(x), torch.Generator().manual_seed(0),
        **to_torch(labels))[level]
    assert drawn.shape == w.shape


@pytest.mark.parametrize("name", KINDS)
def test_reconstruct_matches_jax(name):
    """encode → posterior sample (each level's noise handed in) →
    teacher-forced decode → binarize, against the JAX forward on the same
    noise; flips only within L_MARGIN of the threshold."""
    jc, tc, jmodel, params, model = _case(name, 15)
    x, eps, labels = kind_inputs(np.random.default_rng(15), jc.model, 2,
                                 0.08)
    logits_j, _ = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                             eps=to_jax(eps),
                                             **to_jax(labels))
    want = np.asarray(j_binarize(logits_j, 0.5, j_pitch_mask(jc.midi)))
    got = sampler.reconstruct_fn(tc, model)(torch.tensor(x),
                                            eps=to_torch(eps),
                                            **to_torch(labels))
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = got.numpy() != want
    assert not (diff & (np.abs(np.asarray(logits_j)) > L_MARGIN)).any()
    assert diff.sum() <= 3
    # without eps, each level's noise comes from the generator in order
    g = torch.Generator().manual_seed(3)
    a = sampler.reconstruct_fn(tc, model)(torch.tensor(x), g,
                                          **to_torch(labels))
    b = sampler.reconstruct_fn(tc, model)(
        torch.tensor(x), eps=draw_eps(tc.model, 2,
                                      torch.Generator().manual_seed(3)),
        **to_torch(labels))
    assert torch.equal(a, b)


def _seed_bars(w, rng):
    sb = np.zeros((w, SAMPLES, 96, 128), np.uint8)
    sb[1] = bars(rng, (SAMPLES, 96, 128), 0.1).astype(np.uint8)
    return sb


@pytest.mark.parametrize("mode", ["threshold", "bernoulli"])
@pytest.mark.parametrize("name", KINDS)
def test_coalesced_slots_equal_the_lone_sweep(name, mode):
    """W=3 (the middle slot seeded): slot i's bars equal the lone sweep's
    for generator i exactly; for cond the first slot's labels are given
    and the others' drawn from their generators, as a lone sweep draws
    them."""
    _, tc, _, _, model = _case(name, 16, sample_mode=mode,
                               interpolate=mode == "bernoulli")
    sb = _seed_bars(3, np.random.default_rng(16))
    seeds = (5, 9, 2 ** 40)
    labels = [None] * 3
    kw = {}
    if name == "c4_cond":
        labels[0] = (torch.full((SAMPLES, BARS), 4), torch.tensor([1, 13]))
        kw = {"chords": [lab and lab[0] for lab in labels],
              "key_sigs": [lab and lab[1] for lab in labels]}
    packed = sampler.make_coalesced_generate_fn(tc, model)(
        [sampler.seed_generator(s, "cpu") for s in seeds],
        torch.from_numpy(sb), **kw)
    got = unpack_bits_np(packed.numpy())
    single = sampler.make_generate_fn(tc, model)
    for i, s in enumerate(seeds):
        lone = {}
        if labels[i] is not None:
            lone = {"chord": labels[i][0], "key_sig": labels[i][1]}
        want = single(sampler.seed_generator(s, "cpu"),
                      seed_bar=torch.from_numpy(sb[i]) if i == 1 else None,
                      **lone)
        np.testing.assert_array_equal(got[i], want.numpy(), err_msg=str(i))
    assert not np.array_equal(got[0], got[2])
