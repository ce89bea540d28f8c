"""The port's training ops against the JAX package's, on the same numpy
inputs: the β schedule, free bits, the ELBO, the differentiable BCE and KL
wrappers (the Pallas kernels run in interpret mode off-TPU), the first
conv's backward and the transpose augmentation.

On the CPU every wrapper takes its kernel's plain version, so these tests
hold the plain versions (and the autograd.Function plumbing around them)
against JAX; chip_smoke.py holds the CUDA kernels against the plain
versions on the card. Tolerances are those of tests/test_fused_elbo.py:
sums 1e-5 relative, gradients 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.ops import augment as jaugment
from musicvae_tpu.ops import fused_elbo as jfused
from musicvae_tpu.ops import losses as jlosses
from musicvae_tpu.ops.conv1_pallas import first_conv_s2 as j_first_conv
from musicvae_tpu_torch.ops import (_kernels, augment, conv1, fused_elbo,
                                    losses)


def _elbo_inputs(seed, shape=(3, 1, 96, 128), z=16, lo=0, hi=128):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    x = (rng.random(shape) < 0.1).astype(np.float32)
    p = np.arange(shape[-1])
    mask = ((p >= lo) & (p < hi)).astype(np.float32)
    mu = rng.standard_normal((shape[0], z)).astype(np.float32)
    lv = (0.5 * rng.standard_normal((shape[0], z))).astype(np.float32)
    return logits, x, mask, mu, lv


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


# -- (a) schedule, free bits, ELBO --------------------------------------------

@pytest.mark.parametrize("mode,warmup,hold,cycle", [
    ("linear", 2000, 0, 0), ("linear", 100, 50, 0), ("linear", 0, 0, 0),
    ("cyclical", 40, 0, 100), ("cyclical", 40, 10, 100)])
def test_beta_schedule_matches_jax(mode, warmup, hold, cycle):
    for step in (0, 1, 7, 49, 50, 51, 99, 100, 149, 150, 1999, 2000, 5000):
        want = float(jlosses.beta_schedule(jnp.asarray(step, jnp.int32), 0.7,
                                           warmup, hold, mode, cycle))
        got = losses.beta_schedule(torch.tensor(step, dtype=torch.int32),
                                   0.7, warmup, hold, mode, cycle)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-7, (step, float(got), want)


def test_beta_schedule_refuses_what_jax_refuses():
    step = torch.tensor(3)
    with pytest.raises(ValueError, match="cycle_steps"):
        losses.beta_schedule(step, 1.0, 10, mode="cyclical")
    with pytest.raises(ValueError, match="unknown beta schedule"):
        losses.beta_schedule(step, 1.0, 10, mode="cosine")


@pytest.mark.parametrize("free_bits", [0.0, 0.05, 0.5, 5.0])
def test_kl_free_bits_value_and_grads_match_jax(free_bits):
    _, _, _, mu, lv = _elbo_inputs(1, z=24)
    want = jlosses.kl_free_bits(jnp.asarray(mu), jnp.asarray(lv), free_bits)
    wmu, wlv = jax.grad(jlosses.kl_free_bits, argnums=(0, 1))(
        jnp.asarray(mu), jnp.asarray(lv), free_bits)
    tmu, tlv = _t(mu, True), _t(lv, True)
    got = losses.kl_free_bits(tmu, tlv, free_bits)
    got.backward()
    assert abs(float(got.detach()) - float(want)) \
        <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(tmu.grad.numpy(), np.asarray(wmu), atol=1e-6)
    np.testing.assert_allclose(tlv.grad.numpy(), np.asarray(wlv), atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lo,hi", [(0, 128), (24, 108)])
def test_elbo_value_and_grads_match_jax(fused, lo, hi):
    """``elbo_loss`` against the jnp reference, and ``fused_elbo`` (the
    Function wrappers) against the JAX package's Pallas ``fused_elbo``."""
    logits, x, mask, mu, lv = _elbo_inputs(2, lo=lo, hi=hi)
    beta = 0.37
    jfn = jfused.fused_elbo if fused else jlosses.elbo_loss
    tfn = fused_elbo.fused_elbo if fused else losses.elbo_loss

    def jloss(l, m, v):
        return jfn(l, jnp.asarray(x), jnp.asarray(mask), m, v, beta)[0]

    want, aux = jfn(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(mask),
                    jnp.asarray(mu), jnp.asarray(lv), beta)
    wgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(logits), jnp.asarray(mu), jnp.asarray(lv))
    leaves = [_t(logits, True), _t(mu, True), _t(lv, True)]
    got, taux = tfn(leaves[0], _t(x), _t(mask), leaves[1], leaves[2], beta)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for k in ("recon", "kl"):
        assert abs(float(taux[k]) - float(aux[k])) \
            <= 1e-5 * abs(float(aux[k]))
    for leaf, w in zip(leaves, wgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-6)


# -- (b) the differentiable BCE wrappers ------------------------------------------

_BCE_FNS = {
    "single": (fused_elbo.masked_bce_sum, jfused.masked_bce_sum_pallas),
    "dual": (fused_elbo.masked_bce_sum_dual,
             jfused.masked_bce_sum_pallas_dual),
}


@pytest.mark.parametrize("which", ["single", "dual"])
@pytest.mark.parametrize("t_steps", [96, 67])          # 67: ragged rows
@pytest.mark.parametrize("g", [1.0, 3.5])
def test_bce_wrappers_value_and_dlogits_match_pallas(which, t_steps, g):
    tfn, jfn = _BCE_FNS[which]
    logits, x, mask, _, _ = _elbo_inputs(3, shape=(3, 1, t_steps, 128),
                                         lo=24, hi=108)
    want = float(jfn(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(mask)))
    wgrad = jax.grad(lambda l: g * jfn(l, jnp.asarray(x), jnp.asarray(mask))
                     )(jnp.asarray(logits))
    leaf = _t(logits, True)
    got = tfn(leaf, _t(x), _t(mask))
    (g * got).backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wgrad),
                               atol=1e-6 * max(1.0, g))


@pytest.mark.parametrize("which", ["single", "dual"])
def test_bce_wrappers_target_and_mask_cotangents_match_pallas(which):
    tfn, jfn = _BCE_FNS[which]
    logits, x, mask, _, _ = _elbo_inputs(4, shape=(2, 1, 96, 128))
    jl, jx, jm = jnp.asarray(logits), jnp.asarray(x), jnp.asarray(mask)
    wdx = jax.grad(lambda xx: jfn(jl, xx, jm))(jx)
    wdm = jax.grad(lambda mm: jfn(jl, jx, mm))(jm)
    tx, tm = _t(x, True), _t(mask, True)
    tfn(_t(logits), tx, tm).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), atol=1e-5)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(wdm), rtol=1e-5)


@pytest.mark.parametrize("which", ["single", "dual"])
def test_bce_wrappers_bf16_target_cotangent_dtype(which):
    tfn, jfn = _BCE_FNS[which]
    logits, x, mask, _, _ = _elbo_inputs(5, shape=(2, 1, 96, 128))
    wdx = jax.grad(lambda xx: jfn(jnp.asarray(logits), xx, jnp.asarray(mask))
                   )(jnp.asarray(x).astype(jnp.bfloat16))
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    tfn(_t(logits), tx, _t(mask)).backward()
    assert tx.grad.dtype == torch.bfloat16 and wdx.dtype == jnp.bfloat16
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(wdx, np.float32), rtol=2e-2,
                               atol=1e-2)


@pytest.mark.parametrize("which", ["single", "dual"])
def test_bce_wrappers_uint8_targets_and_bf16_logits(which):
    """uint8 targets need no gradient and change nothing; bf16 logits get
    a bf16 gradient: the f32 tile times g, then the cast (the plain
    backward's arithmetic)."""
    tfn, _ = _BCE_FNS[which]
    logits, x, mask, _, _ = _elbo_inputs(6, shape=(2, 1, 96, 128))
    a = _t(logits, True)
    b = _t(logits, True)
    fa = tfn(a, _t(x), _t(mask))
    fb = tfn(b, torch.tensor(x).to(torch.uint8), _t(mask))
    fa.backward()
    fb.backward()
    assert torch.equal(fa, fb) and torch.equal(a.grad, b.grad)
    lb = torch.tensor(logits).bfloat16().requires_grad_(True)
    (3.5 * tfn(lb, _t(x), _t(mask))).backward()
    want = fused_elbo.masked_bce_bwd_plain(lb.detach(), _t(x), _t(mask), 3.5)
    assert lb.grad.dtype == torch.bfloat16 and torch.equal(lb.grad, want)


def test_bce_single_and_dual_agree_bit_for_bit_on_cpu():
    logits, x, mask, _, _ = _elbo_inputs(7, shape=(2, 1, 96, 128))
    a, b = _t(logits, True), _t(logits, True)
    fa = fused_elbo.masked_bce_sum(a, _t(x), _t(mask))
    fb = fused_elbo.masked_bce_sum_dual(b, _t(x), _t(mask))
    (fa * 0.25).backward()
    (fb * 0.25).backward()
    assert torch.equal(fa, fb) and torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("shape", [(3, 24), (64, 128), (7, 3, 50)])
def test_kl_sum_value_and_grads_match_pallas(shape):
    """The seed-8 [3,24] latents, the main path's [64,128] and a ragged
    [7,3,50]."""
    if shape == (3, 24):
        _, _, _, mu, lv = _elbo_inputs(8, z=24)
    else:
        rng = np.random.default_rng(8)
        mu = rng.standard_normal(shape).astype(np.float32)
        lv = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    for g in (1.0, 3.5):
        want = float(jfused.kl_sum_pallas(jnp.asarray(mu), jnp.asarray(lv)))
        wmu, wlv = jax.grad(lambda m, v: g * jfused.kl_sum_pallas(m, v),
                            argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(lv))
        tmu, tlv = _t(mu, True), _t(lv, True)
        got = fused_elbo.kl_sum(tmu, tlv)
        (g * got).backward()
        assert abs(float(got) - want) <= 1e-5 * abs(want)
        np.testing.assert_allclose(tmu.grad.numpy(), np.asarray(wmu),
                                   atol=1e-6 * max(1.0, g))
        np.testing.assert_allclose(tlv.grad.numpy(), np.asarray(wlv),
                                   atol=1e-6 * max(1.0, g))


def test_kl_sum_bf16_inputs_keep_their_dtype():
    _, _, _, mu, lv = _elbo_inputs(9, shape=(4, 1, 96, 128), z=8)
    tmu = torch.tensor(mu).bfloat16().reshape(2, 2, 8).requires_grad_(True)
    tlv = torch.tensor(lv).bfloat16().reshape(2, 2, 8).requires_grad_(True)
    got = fused_elbo.kl_sum(tmu, tlv)
    got.backward()
    want = losses.kl_diag_gaussian(tmu.detach().float(), tlv.detach().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert tmu.grad.dtype == tlv.grad.dtype == torch.bfloat16
    assert tmu.grad.shape == tmu.shape


def test_training_wrappers_count_no_launch_on_cpu():
    logits, x, mask, mu, lv = _elbo_inputs(10, shape=(2, 1, 96, 128))
    before = dict(_kernels.LAUNCHES)
    leaves = [_t(logits, True), _t(mu, True), _t(lv, True)]
    fused_elbo.fused_elbo(leaves[0], _t(x), _t(mask), leaves[1], leaves[2],
                          0.5)[0].backward()
    fused_elbo.masked_bce_sum_dual(_t(logits, True), _t(x),
                                   _t(mask)).backward()
    assert _kernels.LAUNCHES == before
    assert set(before) == {"first_conv_s2", "first_conv_s2_bwd",
                           "masked_bce_sum", "masked_bce_sum_dual",
                           "masked_bce_bwd", "kl_sum", "kl_bwd",
                           "conv_epilogue", "conv_epilogue_bwd",
                           "head_out_fwd", "head_out_bwd"}


def test_training_wrappers_refuse_other_devices():
    m = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_elbo.masked_bce_sum_dual(m, m, torch.empty(128, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_elbo.kl_sum(m, m)


# -- (c) the first conv's backward ----------------------------------------------------

def _conv_inputs(seed, m, c=8):
    rng = np.random.default_rng(seed)
    x = (rng.random((m, 96, 128)) < 0.1).astype(np.float32)
    w = (rng.standard_normal((3, 3, c)) / 3.0).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tgt = rng.standard_normal((m, 48, 64, c)).astype(np.float32)
    return x, w, b, tgt


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_first_conv_grads_match_jax(gelu, out_dtype):
    """dw/db of the Function against jax.grad through the JAX package's
    first_conv_s2 (its custom VJP: the f32 recompute with un-rounded w,
    also under a bf16 forward). f32: 1e-4 relative to the largest entry
    (different summation orders over 12k positions); bf16 forward: the
    upstream gradient carries the forward's bf16 rounding of y, 2e-2."""
    x, w, b, tgt = _conv_inputs(11, 4)
    jdt = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if out_dtype == "float32" else torch.bfloat16

    def jloss(w, b):
        y = j_first_conv(jnp.asarray(x), w, b, gelu=gelu, out_dtype=jdt)
        return jnp.sum((y.astype(jnp.float32) - jnp.asarray(tgt)) ** 2)

    wdw, wdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    tw, tb = _t(w, True), _t(b, True)
    tx = _t(x, True)
    y = conv1.first_conv_s2(tx, tw, tb, gelu=gelu, out_dtype=tdt)
    assert y.dtype == tdt
    ((y.float() - _t(tgt)) ** 2).sum().backward()
    tol = 1e-4 if out_dtype == "float32" else 2e-2
    for got, want in ((tw.grad, wdw), (tb.grad, wdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=tol * np.abs(want).max(), rtol=tol)
    assert float(tx.grad.abs().max()) == 0.0       # dx = 0 by contract


def test_first_conv_function_matches_autograd_through_plain():
    """On the CPU the Function's dw/db equal autograd through the plain
    forward in f32, and a uint8 bar needs (and gets) no gradient."""
    x, w, b, tgt = _conv_inputs(12, 3, c=16)
    tw, tb = _t(w, True), _t(b, True)
    y = conv1.first_conv_s2(torch.tensor(x).to(torch.uint8), tw, tb,
                            out_dtype=torch.float32)
    (y * _t(tgt)).sum().backward()
    rw, rb = _t(w, True), _t(b, True)
    (conv1.first_conv_s2_ref(_t(x), rw, rb, out_dtype=torch.float32)
     * _t(tgt)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), rw.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), rb.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_first_conv_backward_takes_a_permuted_gradient():
    """The trunk permutes the kernel's NHWC output to NCHW, so the
    gradient arrives as a permuted view."""
    x, w, b, tgt = _conv_inputs(13, 2)
    tw, tb = _t(w, True), _t(b, True)
    y = conv1.first_conv_s2(_t(x), tw, tb, out_dtype=torch.float32)
    (y.permute(0, 3, 1, 2) * _t(tgt).permute(0, 3, 1, 2)).sum().backward()
    dw, db = conv1.first_conv_s2_bwd_ref(_t(x), _t(w), _t(b), _t(tgt))
    np.testing.assert_allclose(tw.grad.numpy(), dw.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), db.numpy(), rtol=1e-6,
                               atol=1e-6)


# -- (d) transpose augmentation ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_transpose_rolls_bit_equal_to_jax(kind):
    rng = np.random.default_rng(14)
    shape = (6, 2, 12, 128)
    if kind == "uint8":
        x = (rng.random(shape) < 0.2).astype(np.uint8)
    else:
        x = rng.standard_normal(shape).astype(np.float32)   # non-binary
    shifts = np.array([0, 5, -5, 127, -128, 1], np.int32)
    want = np.asarray(jaugment.transpose_rolls(jnp.asarray(x),
                                               jnp.asarray(shifts)))
    got = augment.transpose_rolls(torch.tensor(x), torch.tensor(shifts))
    assert got.dtype == torch.tensor(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_rotate_chord_classes_equal_to_jax():
    classes = np.arange(24, dtype=np.int32).reshape(6, 4)
    shifts = np.array([0, 5, -5, 11, -13, 24], np.int32)
    want = np.asarray(jaugment.rotate_chord_classes(
        jnp.asarray(classes), jnp.asarray(shifts)[:, None]))
    got = augment.rotate_chord_classes(torch.tensor(classes),
                                       torch.tensor(shifts)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)
    want_k = np.asarray(jaugment.rotate_chord_classes(
        jnp.asarray(classes[:, 0]), jnp.asarray(shifts)))
    got_k = augment.rotate_chord_classes(torch.tensor(classes[:, 0]),
                                         torch.tensor(shifts))
    np.testing.assert_array_equal(got_k.numpy(), want_k)


def test_random_shifts_range_and_generator():
    a = augment.random_shifts(torch.Generator().manual_seed(3), 4096, 5)
    b = augment.random_shifts(torch.Generator().manual_seed(3), 4096, 5)
    assert torch.equal(a, b) and a.shape == (4096,)
    assert int(a.min()) == -5 and int(a.max()) == 5
