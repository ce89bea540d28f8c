"""The posterior encode and the reconstruction of the patch-stem and
attention configs (c2_trf, c3_trf, c2_mxu, c3_mxu) against the JAX
package, at tiny f32 widths on weights from the JAX package's own
``init_params`` (torch_port_helpers.jax_init_params), with each latent
level's noise handed in: the posterior sample to Z_TOL, the reconstructed
bars with no flipped cell; and the coalesced sweep of three requests, one
of them seeded, against each request's lone sweep, bit for bit, on the
CPU."""

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
from musicvae_tpu_torch.ops.pack import unpack_bits_np
from torch_port_helpers import (bars, jax_init_params, jax_port_model,
                                jitted, kind_inputs,
                                one_torch_thread,  # noqa: F401
                                patch_pair, to_jax, to_torch)

NAMES = ("c2_trf", "c3_trf", "c2_mxu", "c3_mxu")
Z_TOL = 3e-5          # posterior samples, as tests/test_torch_parity.py
SAMPLES, BARS = 2, 3


def _case(name, **gen_kw):
    """(JAX config, the port's, the flax model, its params, the port's
    model on them): one set of weights a config, initialised once."""
    jc, tc = patch_pair(name)
    jmodel, params = jax_init_params(jc, 0)
    gen = dict(num_bars=BARS, num_samples=SAMPLES, **gen_kw)
    tc = tc.replace(gen=GenSpec(**gen))
    return jc, tc, jmodel, params, jax_port_model(tc, params)


def _inputs(jc, seed, b):
    x, eps, labels = kind_inputs(np.random.default_rng(seed), jc.model, b,
                                 0.08)
    return x[:, :, :jc.midi.steps_per_bar], eps, labels


@pytest.mark.parametrize("name", NAMES)
def test_encode_matches_jax(name):
    """The posterior sample of a window: z0, or for hier the phrase
    latent z_phrase0."""
    jc, tc, jmodel, params, model = _case(name)
    x, _, _ = _inputs(jc, 21, 3)
    key = jax.random.key(22)
    want = jax.jit(jsampler.make_encode_fn(jc, jmodel))(
        params, jnp.asarray(x), key)
    (level, w), = want.items()
    assert level == ("z_phrase0" if jc.model.kind == "hier" else "z0")
    eps = np.asarray(jax.random.normal(key, w.shape))
    got = sampler.make_encode_fn(tc, model)(torch.tensor(x),
                                            eps=torch.tensor(eps))
    assert sorted(got) == [level]
    np.testing.assert_allclose(got[level].numpy(), np.asarray(w), atol=Z_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_reconstruct_matches_jax(name):
    """encode → posterior sample → teacher-forced decode → binarize: the
    same bars as the JAX forward on the same noise, no cell flipped."""
    jc, tc, jmodel, params, model = _case(name)
    x, eps, _ = _inputs(jc, 23, 2)
    logits_j, _ = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                             eps=to_jax(eps))
    want = np.asarray(j_binarize(logits_j, 0.5, j_pitch_mask(jc.midi)))
    got = sampler.reconstruct_fn(tc, model)(torch.tensor(x),
                                            eps=to_torch(eps))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert 0.05 < want.mean() < 0.95          # bars with notes and rests
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["threshold", "bernoulli"])
@pytest.mark.parametrize("name", NAMES)
def test_coalesced_slots_equal_the_lone_sweep(name, mode):
    """Three requests in one sweep (the middle one seeded): slot i's bars
    equal the lone sweep's for generator i exactly."""
    _, tc, _, _, model = _case(name, sample_mode=mode,
                               interpolate=mode == "bernoulli")
    sb = np.zeros((3, SAMPLES, 96, 128), np.uint8)
    sb[1] = bars(np.random.default_rng(24), (SAMPLES, 96, 128),
                 0.1).astype(np.uint8)
    seeds = (5, 9, 2 ** 40)
    packed = sampler.make_coalesced_generate_fn(tc, model)(
        [sampler.seed_generator(s, "cpu") for s in seeds],
        torch.from_numpy(sb))
    got = unpack_bits_np(packed.numpy())
    single = sampler.make_generate_fn(tc, model)
    for i, s in enumerate(seeds):
        want = single(sampler.seed_generator(s, "cpu"),
                      seed_bar=torch.from_numpy(sb[i]) if i == 1 else None)
        np.testing.assert_array_equal(got[i], want.numpy(), err_msg=str(i))
    assert 0.0 < got.mean() < 1.0
    assert not np.array_equal(got[0], got[2])


def test_per_slot_runs_each_slot_at_the_lone_shape():
    """``layers.per_slot``: the function sees one slot's rows of every
    argument at a time, and the results come back in slot order."""
    from musicvae_tpu_torch.models.layers import per_slot

    seen = []

    def fn(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return a * 2 + b.sum(-1, keepdim=True)

    a, b = torch.arange(12.0).reshape(6, 2), torch.ones(6, 3)
    got = per_slot(fn, 3, a, b)
    assert seen == [((2, 2), (2, 3))] * 3
    assert torch.equal(got, a * 2 + 3)
    seen.clear()
    assert torch.equal(per_slot(fn, 1, a, b), got) and len(seen) == 1
