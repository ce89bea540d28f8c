"""The port's ops against the JAX package's, on the same numpy inputs.

K1 (first conv) and K2 (masked BCE sum): on the CPU the port's wrappers
take their plain versions, held here against the JAX Pallas kernels in
interpret mode (automatic off-TPU) and against the XLA layers they
replace. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from musicvae_tpu.ops import binarize as jbin
from musicvae_tpu.ops import losses as jlosses
from musicvae_tpu.ops.conv1_pallas import first_conv_s2 as j_first_conv
from musicvae_tpu.ops.fused_elbo import masked_bce_sum_pallas
from musicvae_tpu.models import latent as jlatent
from musicvae_tpu_torch.ops import _kernels, binarize, conv1, fused_elbo, losses
from musicvae_tpu_torch.models import latent

C = 16


def _conv_inputs(seed, m, c=C, x_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.random((m, 96, 128)) < 0.1).astype(x_dtype)
    w = (rng.standard_normal((3, 3, c)) / 3.0).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m", [1, 4, 9, 32])
def test_conv1_plain_matches_pallas_f32(m):
    """Ragged M (not a multiple of the Pallas 16-image tile) included."""
    x, w, b = _conv_inputs(m, m)
    want = np.asarray(j_first_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), gelu=True,
                                   out_dtype=jnp.float32))
    got = conv1.first_conv_s2(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b), gelu=True,
                              out_dtype=torch.float32)
    assert got.shape == (m, 48, 64, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("x_dtype", [np.float32, np.uint8])
def test_conv1_plain_matches_pallas_bf16(x_dtype):
    """bf16 output: x and w rounded to bf16, f32 accumulate (the Pallas
    contract); a uint8 bar goes in as it is."""
    x, w, b = _conv_inputs(5, 6, x_dtype=x_dtype)
    want = np.asarray(j_first_conv(jnp.asarray(x, jnp.float32),
                                   jnp.asarray(w), jnp.asarray(b), gelu=True,
                                   out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = conv1.first_conv_s2(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b), gelu=True,
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("gelu", [True, False])
def test_conv1_plain_matches_flax_conv(gelu):
    """The layer the kernel replaces: flax nn.Conv (3x3, stride 2, pad
    (1,1)) then nn.gelu."""
    conv = nn.Conv(C, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    x, _, _ = _conv_inputs(7, 3)
    v = conv.init(jax.random.key(0), jnp.zeros((1, 96, 128, 1)))
    want = conv.apply(v, jnp.asarray(x)[..., None])
    if gelu:
        want = nn.gelu(want)
    w = np.asarray(v["params"]["kernel"])[:, :, 0, :]
    b = np.asarray(v["params"]["bias"])
    got = conv1.first_conv_s2_ref(torch.tensor(x), torch.tensor(w),
                                  torch.tensor(b), gelu=gelu,
                                  out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_conv1_cpu_dispatch_counts_no_launch():
    x, w, b = _conv_inputs(1, 2)
    before = dict(_kernels.LAUNCHES)
    conv1.first_conv_s2(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    assert _kernels.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    """Neither a CPU tensor's plain path nor the kernel: a device that is
    neither raises."""
    x = torch.empty((2, 96, 128), device="meta")
    w, b = torch.empty((3, 3, C), device="meta"), torch.empty(C,
                                                              device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1.first_conv_s2(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_elbo.masked_bce_sum(x, x, torch.empty(128, device="meta"))


def _bce_inputs(seed, shape, logit_dtype=np.float32, x_dtype=np.float32):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal(shape)).astype(logit_dtype)
    x = (rng.random(shape) < 0.05).astype(x_dtype)
    return logits, x


def _mask(lo, hi):
    p = np.arange(128)
    return ((p >= lo) & (p < hi)).astype(np.float32)


@pytest.mark.parametrize("shape,lo,hi,x_dtype", [
    ((4, 4, 96, 128), 0, 128, np.float32),     # 1536 rows: ragged tile
    ((3, 96, 128), 24, 108, np.float32),       # cropped mask (c2_cropped)
    ((2, 4, 96, 128), 24, 108, np.uint8),      # uint8 targets
    ((1000, 128), 0, 128, np.uint8),           # rows < one Pallas tile
])
def test_bce_plain_matches_pallas(shape, lo, hi, x_dtype):
    logits, x = _bce_inputs(len(shape) + lo, shape, x_dtype=x_dtype)
    mask = _mask(lo, hi)
    want = float(masked_bce_sum_pallas(jnp.asarray(logits),
                                       jnp.asarray(x, jnp.float32),
                                       jnp.asarray(mask)))
    got = fused_elbo.masked_bce_sum(torch.tensor(logits), torch.tensor(x),
                                    torch.tensor(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_bce_plain_bf16_logits_matches_jnp():
    logits, x = _bce_inputs(3, (2, 96, 128))
    lb = torch.tensor(logits).bfloat16()
    mask = _mask(0, 128)
    want = float(jlosses.masked_bce_sum(
        jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(x), jnp.asarray(mask)))
    got = float(losses.masked_bce_sum(lb, torch.tensor(x),
                                      torch.tensor(mask)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_bce_and_kl_elementwise_match_jnp():
    logits, x = _bce_inputs(4, (8, 128))
    np.testing.assert_allclose(
        losses.bce_with_logits(torch.tensor(logits), torch.tensor(x)).numpy(),
        np.asarray(jlosses.bce_with_logits(jnp.asarray(logits),
                                           jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((4, 16)).astype(np.float32)
    lv = rng.standard_normal((4, 16)).astype(np.float32)
    want = float(jlosses.kl_diag_gaussian(jnp.asarray(mu), jnp.asarray(lv)))
    got = float(losses.kl_diag_gaussian(torch.tensor(mu), torch.tensor(lv)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("threshold,lo,hi", [(0.5, 0, 128), (0.3, 24, 108)])
def test_binarize_matches_jax(threshold, lo, hi):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 96, 128)).astype(np.float32)
    logits[0, 0, :4] = [0.0, -0.0, 1e-7, -1e-7]      # strict > at the edge
    mask = _mask(lo, hi)
    want = np.asarray(jbin.binarize_logits(jnp.asarray(logits), threshold,
                                           jnp.asarray(mask),
                                           dtype=jnp.uint8))
    got = binarize.binarize_logits(torch.tensor(logits), threshold,
                                   torch.tensor(mask), dtype=torch.uint8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_slerp_and_reparameterize_match_jax():
    rng = np.random.default_rng(7)
    za = rng.standard_normal((5, 16)).astype(np.float32)
    zb = rng.standard_normal((5, 16)).astype(np.float32)
    zb[0] = 2.0 * za[0]                              # collinear: lerp path
    for t in (0.0, 0.25, 0.5, 1.0):
        np.testing.assert_allclose(
            latent.slerp(torch.tensor(za), torch.tensor(zb), t).numpy(),
            np.asarray(jlatent.slerp(jnp.asarray(za), jnp.asarray(zb), t)),
            rtol=1e-5, atol=1e-5)
    eps = rng.standard_normal((5, 16)).astype(np.float32)
    got = latent.reparameterize(torch.tensor(za), torch.tensor(zb),
                                torch.tensor(eps))
    np.testing.assert_allclose(got.numpy(), za + eps * np.exp(0.5 * zb),
                               rtol=1e-6, atol=1e-6)
