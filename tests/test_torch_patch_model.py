"""The port's patch stem (space-to-depth trunk and head, ModelSpec.stem
"patch") against the JAX package's, at tiny widths on weights that the
JAX package initialised and the port's converter carried: the layout
functions bit for bit, the forward's (mu, logvar) within 3e-5 and its
logits within 5e-4 in f32 (4 bf16 ulps of the largest magnitude in
bf16, as tests/test_torch_kinds_model.py holds bf16), the bar-adapting
meters, and the refusals and parameter counts of both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu import config as jcfg
from musicvae_tpu.models import init_params as jax_init
from musicvae_tpu.models import layers as jlayers
from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch.models import layers
from musicvae_tpu_torch.models.vae import (PianoRollVAE, check_supported,
                                           param_count)
from torch_port_helpers import (check_forward, close, forward_pair,
                                jax_init_params, jax_port_model, jitted,
                                kind_inputs,
                                one_torch_thread,  # noqa: F401
                                patch_pair, to_jax, to_torch)

PATCH_NAMES = ("c2_mxu", "c3_mxu", "c2_mxu_wide", "c2_mxu_16bar",
               "c2_mxu_32bar")
ATTN_NAMES = ("c2_trf", "c3_trf", "c2_trf_16bar", "c2_trf_32bar")


@pytest.mark.parametrize("shape,patch", [((3, 96, 128), (8, 16)),
                                         ((2, 16, 8), (4, 2)),
                                         ((1, 6, 6), (3, 2))])
def test_space_to_depth_is_the_jax_layout(shape, patch):
    """Channel i_t·pp + i_p, bit for bit, and depth_to_space undoes it
    in both packages."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = layers.space_to_depth(torch.tensor(x), *patch)
    want = np.asarray(jlayers.space_to_depth(jnp.asarray(x), *patch))
    np.testing.assert_array_equal(got.numpy(), want)
    back = layers.depth_to_space(got, *patch)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jlayers.depth_to_space(jnp.asarray(want), *patch)))


def test_space_to_depth_refuses_a_patch_that_does_not_tile():
    with pytest.raises(ValueError, match="does not tile a"):
        layers.space_to_depth(torch.zeros(1, 84, 128), 8, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_is_flax_layernorm(dtype):
    """flax nn.LayerNorm: f32 statistics, E[x²] − E[x]², epsilon 1e-6, the
    result in the compute dtype; on inputs of a variance near 1e-5,
    where torch's default epsilon would differ by several percent."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 24)) * 0.003 + 0.001).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(24)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ln = fnn.LayerNorm(dtype=jdt, param_dtype=jnp.float32)
    want = ln.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x).astype(jdt))
    mod = layers.LayerNorm(24, dtype)
    with torch.no_grad():
        mod.weight.copy_(torch.tensor(scale))
        mod.bias.copy_(torch.tensor(bias))
        got = mod(torch.tensor(x).to(layers.dtype_of(dtype)))
    assert got.dtype == layers.dtype_of(dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,model_kw", [
    ("c2_mxu", {}), ("c3_mxu", {}), ("c2_mxu_wide", {}),
    ("c1_conv_bar", dict(stem="patch"))],
    ids=["c2_mxu", "c3_mxu", "c2_mxu_wide", "conv_bar_patch"])
def test_forward_matches_jax(name, model_kw, dtype):
    check_forward(name, dtype, **model_kw)


@pytest.mark.parametrize("name,model_kw", [
    ("c2_mxu", dict(use_prev_bar=False)), ("c4_cond", dict(stem="patch"))],
    ids=["c2_mxu_no_prev", "cond_patch"])
def test_forward_matches_jax_f32(name, model_kw):
    check_forward(name, **model_kw)


def test_first_conv_flag_is_ignored_by_the_patch_stem():
    """use_pallas_conv1 on a patch config: the JAX package's BarFeat
    ignores it, and so does the port (no K1 call, the same logits)."""
    jc, (logits_j, _), (logits, _) = forward_pair(
        "c2_mxu", seed=3, use_pallas_conv1=True)
    close(logits, logits_j, 5e-4, False, "logits")
    _, tc = patch_pair("c2_mxu", use_pallas_conv1=True)
    model = PianoRollVAE(tc.model, tc.midi)
    assert not model.enc_feat.first_conv_kernel
    assert not model.prev_feat.first_conv_kernel


@pytest.mark.parametrize("meter", [(5, 4), (7, 8)])
def test_meters_through_the_patch_stem(meter):
    """120- and 84-step bars: the trunk zero-pads time to whole patches,
    the head ceil-pads then crops; the cropped logits stay contiguous."""
    midi = jcfg.meter_grid(*meter)
    jc, tc = patch_pair("c2_mxu")
    jc = jc.replace(midi=dataclasses.replace(jc.midi, **midi))
    tc = tc.replace(midi=dataclasses.replace(tc.midi, **midi))
    assert tc.midi.steps_per_bar == {(5, 4): 120, (7, 8): 84}[meter]
    jmodel, params = jax_init_params(jc, 4)
    model = jax_port_model(tc, params)
    x, eps, _ = kind_inputs(np.random.default_rng(4), jc.model, 2)
    x = np.concatenate([x, x], axis=2)[:, :, :tc.midi.steps_per_bar]
    logits_j, lat_j = jitted(jmodel, "__call__")(
        params, jnp.asarray(x), eps=to_jax(eps))
    with torch.no_grad():
        logits, lat = model(torch.tensor(x), to_torch(eps))
    assert logits.shape == x.shape and logits.is_contiguous()
    close(logits, logits_j, 5e-4, False, "logits")
    close(lat[0][0], lat_j[0][0], 3e-5, False, "mu")


@pytest.mark.parametrize("name,model_kw,words", [
    ("c2_trf", dict(temporal="lstm"), "unknown ModelSpec.temporal"),
    ("c1_conv_bar", dict(temporal="attn"), "has no temporal core"),
    ("c2_trf", dict(num_bars=8, attn_max_bars=4), "exceeds attn_max_bars")])
def test_the_jax_refusals_in_the_jax_words(name, model_kw, words):
    jc, tc = patch_pair(name, **model_kw)
    with pytest.raises(ValueError, match=words) as want:
        jax_init(jc, jax.random.key(0))
    with pytest.raises(ValueError, match=words) as got:
        check_supported(tc.model)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=words):
        PianoRollVAE(tc.model, tc.midi)


@pytest.mark.parametrize("name", PATCH_NAMES + ATTN_NAMES)
def test_param_count_is_the_jax_count(name):
    """At the registered widths, from shapes alone in both packages: the
    count ``describe`` prints (the GRU's r/z hidden biases, which flax
    does not have, left out)."""
    jc = jcfg.get_config(name)
    shapes = jax.eval_shape(lambda k: jax_init(jc, k)[1], jax.random.key(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    tc = tcfg.get_config(name)
    with torch.device("meta"):
        model = PianoRollVAE(tc.model, tc.midi)
    assert param_count(model) == want
