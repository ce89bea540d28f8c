"""The benchmark's plain reference of the chord/key-conditional VAE
(perfbench/reference/cond.py) against the port's ``cond`` model on the
CPU, at tiny f32 widths, on seeded random weights (the reference's own
draw, loaded into the port's model by name): the logits, the latent
posterior, the ELBO and the gradient of every parameter. The reference
rounded through fp8 (its control, the precision below the configuration's
bf16) must miss the same tolerances.

Each tolerance is f32 round-off between two orders of the same sums: the
port runs the convs through its conv blocks (bias and GELU after the
conv, NHWC), the reference through ``F.conv2d`` with its bias; the GRU
gates and the dense layers are the same products summed in other
groupings. At these widths that moves a logit by ~3e-9, the loss not at
all and the worst gradient leaf by ~1.2e-6 of its norm; the tolerances
sit two orders of magnitude above. The fp8 control moves a logit by
~4e-3 and the worst gradient leaf by ~0.6 of its norm (its loss, a sum
over every cell, stays within ~3e-7): it misses the logit tolerance
~20-fold and the gradient one by over three orders of magnitude.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from musicvae_tpu_torch.config import get_config  # noqa: E402
from musicvae_tpu_torch.models.vae import PianoRollVAE  # noqa: E402
from musicvae_tpu_torch.train import trainer  # noqa: E402
from perfbench.reference import cond as ref_cond  # noqa: E402
from perfbench.reference import model as ref  # noqa: E402
from torch_port_helpers import bench_spec, one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LATENT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4      # a leaf's gradient distance over its norm (or 1e-3)
BATCH = 3


def _config():
    base = get_config("c4_cond")
    return base.replace(
        model=dataclasses.replace(
            base.model, enc_channels=(4, 8, 8, 8, 8),
            dec_channels=(8, 8, 8, 8, 4), bar_feat_dim=16, gru_hidden=16,
            z_dim=8, cond_embed_dim=4, dtype="float32"),
        train=dataclasses.replace(base.train, batch_size=BATCH,
                                  beta_warmup_steps=4))


def _inputs(cfg, seed=5):
    gen = torch.Generator().manual_seed(seed)
    m = cfg.model
    x = (torch.rand((BATCH, m.num_bars, 96, 128), generator=gen) < 0.1
         ).to(torch.uint8)
    chord = torch.randint(0, m.cond_chord_classes, (BATCH,), generator=gen)
    chord = chord[:, None].expand(-1, m.num_bars).contiguous()
    key = torch.randint(0, m.cond_key_classes, (BATCH,), generator=gen)
    eps = torch.randn((BATCH, m.z_dim), generator=gen)
    return x, chord, key, eps


def _both(q=ref.exact, weight_seed=3):
    """(program, reference) each as (logits, latents, loss, grads)."""
    cfg = _config()
    spec = bench_spec(cfg)
    params = ref.make_params(ref_cond.param_shapes(spec), weight_seed, "cpu")
    model = PianoRollVAE(cfg.model, cfg.midi, cfg.train.remat_encoder)
    model.load_state_dict({k: v.clone() for k, v in params.items()},
                          strict=True)
    assert list(params) == [n for n, _ in model.named_parameters()]
    x, chord, key, eps = _inputs(cfg)
    beta = ref.beta_at(spec["train"], 2)

    logits, latents = model(x, (eps,), chord=chord, key_sig=key)
    loss, _ = trainer.elbo_from_outputs(cfg, logits, x, latents, beta)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    prog = (logits.detach(), [(m.detach(), v.detach()) for m, v in latents],
            float(loss.detach()), dict(zip(params, grads)))

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    r_logits, r_lat = ref_cond.forward(p, x, [eps], chord, key, spec, q)
    r_loss = ref.elbo(r_logits, x, r_lat, beta, ref.pitch_mask(spec))
    r_grads = torch.autograd.grad(r_loss, list(p.values()))
    reference = (r_logits.detach(),
                 [(m.detach(), v.detach()) for m, v in r_lat],
                 float(r_loss.detach()), dict(zip(p, r_grads)))
    return prog, reference


def _worst_grad_gap(prog, reference):
    norms = {k: float(g.norm()) for k, g in reference.items()}
    median = float(np.median(list(norms.values())))
    return max(float((prog[k] - g).norm()) / max(norms[k], 1e-3 * median)
               for k, g in reference.items())


def _agree(prog, reference) -> None:
    logits, latents, loss, grads = prog
    r_logits, r_lat, r_loss, r_grads = reference
    torch.testing.assert_close(logits, r_logits, **LOGIT_TOL)
    for (mu, lv), (rmu, rlv) in zip(latents, r_lat):
        torch.testing.assert_close(mu, rmu, **LATENT_TOL)
        torch.testing.assert_close(lv, rlv, **LATENT_TOL)
    assert abs(loss - r_loss) <= LOSS_RTOL * abs(r_loss), (loss, r_loss)
    assert _worst_grad_gap(grads, r_grads) <= GRAD_TOL


def test_shapes_are_the_programs():
    cfg = _config()
    model = PianoRollVAE(cfg.model, cfg.midi, False)
    shapes = ref_cond.param_shapes(bench_spec(cfg))
    assert shapes == {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("weight_seed", [3, 11])
def test_reference_matches_the_program(weight_seed):
    prog, reference = _both(weight_seed=weight_seed)
    _agree(prog, reference)
    # the GRUs' hidden r/z biases take no gradient in either
    for name in ("enc_gru", "dec_gru"):
        h = _config().model.gru_hidden
        assert not reference[3][name + ".bias_hh"][:2 * h].any()
        assert not prog[3][name + ".bias_hh"][:2 * h].any()


def test_the_fp8_reference_misses_the_tolerances():
    prog, _ = _both()
    _, control = _both(q=ref.fp8)
    with pytest.raises(AssertionError):
        _agree(prog, control)
    assert _worst_grad_gap(prog[3], control[3]) > 10 * GRAD_TOL
