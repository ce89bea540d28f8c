"""The port's compiled generation sweep (generate/sampler.py
``make_generate_fn``: a static-input ``graphs.Program`` a signature, a
captured CUDA graph on the card) on the CPU at tiny f32 widths, where the
same program runs eagerly over the same buffers:

- (a) one sweep of each model family, in both sample modes, reads nothing
  back to the host and makes no tensor from host data, which capture
  requires;
- (c) for each argument signature the CLI's serve and generate commands
  use, repeated calls equal ``_sweep_body`` run eagerly on the caller's
  arguments, bit for bit; the bars a call returned are unchanged by the
  next call; the caller's generator ends where the eager sweep leaves
  it; and each signature has a program of its own.

Graph against eager on the card is ``chip_smoke.py``'s serve, kinds and
patch_attn phases; the sweep against the JAX package's is
tests/test_torch_sampling.py and tests/test_torch_kinds_generate.py.
"""

import numpy as np
import pytest
import torch

from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.models.vae import build_model
from torch_port_helpers import (FAMILIES, family_config, no_host_reads,
                                one_torch_thread)  # noqa: F401

SAMPLES, BARS = 2, 3


def _model(name, **gen_kw):
    cfg = family_config(name)
    cfg = cfg.replace(gen=GenSpec(num_bars=BARS, num_samples=SAMPLES,
                                  **gen_kw))
    return cfg, build_model(cfg, device="cpu", seed=5)


@pytest.mark.parametrize("mode", ["threshold", "bernoulli"])
@pytest.mark.parametrize("name", FAMILIES)
def test_sweep_reads_nothing_back(name, mode):
    cfg, model = _model(name, sample_mode=mode)
    sweep = sampler.make_generate_fn(cfg, model)
    seed_bar = torch.zeros(SAMPLES, 96, 128, dtype=torch.uint8)
    with no_host_reads():
        bars = sweep(torch.Generator().manual_seed(1))
        seeded = sweep(torch.Generator().manual_seed(1), seed_bar=seed_bar)
    assert bars.shape == (SAMPLES, BARS, 96, 128) and bars.dtype == torch.uint8
    assert torch.equal(bars, seeded)        # a zero seed bar is the default


def _encoded(cfg, rng):
    """What ``generate --seed-midi --encode`` hands the sweep: a seed bar
    and the encoded latent (hier: the phrase latent)."""
    z = "z_phrase0" if cfg.model.kind == "hier" else "z0"
    width = (cfg.model.z_phrase_dim if cfg.model.kind == "hier"
             else cfg.model.z_dim)
    return {"seed_bar": torch.from_numpy(
                (rng.random((SAMPLES, 96, 128)) < 0.1).astype(np.uint8)),
            z: torch.from_numpy(rng.standard_normal(
                (SAMPLES, width)).astype(np.float32))}


def _labels(cfg, rng):
    """A cond request's classes (serve's ``request_labels``,
    ``generate --chord --key``)."""
    return {"chord": torch.from_numpy(rng.integers(
                0, cfg.model.cond_chord_classes, (SAMPLES, BARS))),
            "key_sig": torch.from_numpy(rng.integers(
                0, cfg.model.cond_key_classes, (SAMPLES,)))}


# (config, GenSpec settings, the given arguments) of each signature:
# serve plain and seeded (cond with its labels), generate from a seed bar,
# --encode, --encode --interpolate --interp-midi-b, and cond's --chord
# --key; Bernoulli through generate --sample-mode
SIGNATURES = {
    "serve": ("c2_gru_4bar", {}, lambda cfg, rng: {}),
    "serve_seeded": ("c2_gru_4bar", {}, lambda cfg, rng: {
        "seed_bar": _encoded(cfg, rng)["seed_bar"]}),
    "serve_cond": ("c4_cond", {}, _labels),
    "serve_cond_seeded": ("c4_cond", {}, lambda cfg, rng: {
        **_labels(cfg, rng), "seed_bar": _encoded(cfg, rng)["seed_bar"]}),
    "generate_encode": ("c2_gru_4bar", {}, _encoded),
    "generate_morph": ("c2_gru_4bar", {"interpolate": True},
                       lambda cfg, rng: {
                           **_encoded(cfg, rng),
                           "z1": _encoded(cfg, rng)["z0"]}),
    "generate_hier_morph": ("c3_hier_16bar", {"interpolate": True},
                            lambda cfg, rng: {
                                **_encoded(cfg, rng),
                                "z_phrase1": _encoded(cfg, rng)["z_phrase0"]}),
    "generate_bernoulli": ("c2_gru_4bar", {"sample_mode": "bernoulli"},
                           _encoded),
    "generate_conv_bar": ("c1_conv_bar", {"sample_mode": "bernoulli"},
                          lambda cfg, rng: {}),
    "generate_cond_labels": ("c4_cond", {"sample_mode": "bernoulli"},
                             _labels),
}


@pytest.mark.parametrize("sig", sorted(SIGNATURES))
def test_sweep_equals_the_eager_body(sig):
    """Three calls with other seeds and arguments: each equals the eager
    body on the same arguments and a generator at the same state, the
    callers' generators end at the same state, and an earlier call's bars
    stay as they were. Random weights give dense bars (~50 % of cells),
    so other seeds give other bars."""
    name, gen_kw, args = SIGNATURES[sig]
    cfg, model = _model(name, **gen_kw)
    sweep = sampler.make_generate_fn(cfg, model)
    body = sampler._sweep_body(cfg, model)
    rng = np.random.default_rng(3)
    kept = []
    for seed in (11, 12, 13):
        kw = args(cfg, rng)
        g_graph = torch.Generator().manual_seed(seed)
        g_eager = torch.Generator().manual_seed(seed)
        got = sweep(g_graph, **kw)
        with torch.inference_mode():
            want = body(SAMPLES, g_eager, kw.get("seed_bar"), kw.get("z0"),
                        kw.get("z1"), None, None, kw.get("chord"),
                        kw.get("key_sig"), kw.get("z_phrase0"),
                        kw.get("z_phrase1"))
        assert torch.equal(got, want), (sig, seed)
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        kept.append((got, want))
    for got, want in kept:
        assert torch.equal(got, want)
    assert len(sweep.programs) == 1
    assert not torch.equal(kept[0][0], kept[1][0])    # other seeds, bars


def test_each_signature_has_its_own_program():
    cfg, model = _model("c2_gru_4bar")
    sweep = sampler.make_generate_fn(cfg, model)
    seed_bar = torch.zeros(SAMPLES, 96, 128, dtype=torch.uint8)
    plain = sweep(torch.Generator().manual_seed(1))
    sweep(torch.Generator().manual_seed(1), seed_bar=seed_bar)
    sweep(torch.Generator().manual_seed(2))
    assert len(sweep.programs) == 2
    again = sweep(torch.Generator().manual_seed(1))
    assert torch.equal(plain, again)
    noise = torch.zeros(1, SAMPLES, cfg.model.z_dim)
    quiet = sweep(None, noise=noise)
    assert len(sweep.programs) == 3 and quiet.shape == plain.shape
