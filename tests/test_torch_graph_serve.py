"""The port's compiled coalesced sweep (generate/sampler.py
``make_coalesced_generate_fn``, ``serve --coalesce``) and reconstruction
(``reconstruct_fn``, the ``reconstruct`` command): a static-input
``graphs.StaticProgram`` a signature, a captured CUDA graph on the card,
here on the CPU at tiny f32 widths, where the same programs run eagerly
over the same buffers:

- (a) each model family's coalesced sweep, in both sample modes, and its
  reconstruction read nothing back to the host and make no tensor from
  host data, which capture requires;
- (b) repeated calls equal the eager body on the callers' own generators
  and tensors, bit for bit, every slot's generator (the reconstruction's
  generator) ending where the eager run leaves it, and the bars a call
  returned stay as they were;
- (c) each signature (the width, which slots draw, the handed-in tensors;
  the reconstruction's given tensors) has a program of its own, and the
  serve runner's warm-up runs each tier twice;
- (d) every coalesced slot equals its lone sweep, bit for bit, and the
  reconstruction equals the JAX package's jitted ``reconstruct_fn`` on
  the same weights and noise with no cell flipped.

Graph against eager on the card is ``chip_smoke.py``'s serve and eval
phases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.generate import sampler as jsampler
from musicvae_tpu_torch import cli
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.models.vae import build_model, draw_eps
from musicvae_tpu_torch.ops.binarize import binarize_logits
from musicvae_tpu_torch.ops.pack import pack_bits, unpack_bits_np
from torch_port_helpers import (FAMILIES, HandedEps, family_config,
                                jax_init_params, jax_params, jax_port_model,
                                kind_inputs, kind_pair, no_host_reads,
                                one_torch_thread,  # noqa: F401
                                patch_pair, port_model)

SAMPLES, BARS, W = 2, 3, 3


def _model(name, **gen_kw):
    cfg = family_config(name)
    cfg = cfg.replace(gen=GenSpec(num_bars=BARS, num_samples=SAMPLES,
                                  **gen_kw))
    return cfg, build_model(cfg, device="cpu", seed=5)


def _seed_bars(rng, w=W, seeded=(1,)):
    sb = np.zeros((w, SAMPLES, 96, 128), np.uint8)
    for i in seeded:
        sb[i] = (rng.random((96, 128)) < 0.1).astype(np.uint8)
    return torch.from_numpy(sb)


def _labels(cfg, rng, w=W):
    """cond's serve labels for slot 0, the other slots drawing theirs."""
    if cfg.model.kind != "cond":
        return {}
    chords = [torch.from_numpy(rng.integers(
        0, cfg.model.cond_chord_classes, (SAMPLES, BARS)))] + [None] * (w - 1)
    keys = [torch.from_numpy(rng.integers(
        0, cfg.model.cond_key_classes, (SAMPLES,)))] + [None] * (w - 1)
    return {"chords": chords, "key_sigs": keys}


def _eager_coalesced(cfg, model, generators, seed_bars, chords=None,
                     key_sigs=None):
    """The coalesced sweep run eagerly on the callers' generators: each
    slot's ``sweep_draws``, concatenated, one sweep at W·B with the slots'
    generators drawing each bar's uniforms, packed."""
    body = sampler._sweep_body(cfg, model)
    w = len(generators)
    slots = [sampler.sweep_draws(
        cfg, SAMPLES, gen, None, None,
        None if chords is None else chords[i],
        None if key_sigs is None else key_sigs[i])
        for i, gen in enumerate(generators)]
    noise, chord, key_sig, z_phrase = (
        None if parts[0] is None else
        torch.cat(list(parts), dim=1 if j == 0 else 0)
        for j, parts in enumerate(zip(*slots)))
    bars = body(w * SAMPLES, None, seed_bars.reshape(
        w * SAMPLES, *seed_bars.shape[2:]), None, None, noise,
        list(generators), chord, key_sig, z_phrase, slots=w)
    packed = pack_bits(bars)
    return packed.reshape(w, SAMPLES, *packed.shape[1:])


# On the CPU a row of F.linear depends on the batch for some shapes (at M
# = 6 against 2, K = 48, N = 96: 468 of 576 outputs differ, by up to
# 5.7e-6), and hier's decoder at these tiny widths has such shapes, so a
# coalesced hier slot may flip a cell whose logit lies at the threshold
# against its lone sweep (ROADMAP.md §C.8); there a cell may differ only
# within L_MARGIN, bar by bar while the bars agree
CPU_BATCH_DEPENDENT = ("c3_hier_16bar",)
L_MARGIN = 5e-4       # |logit − logit(threshold)| below which a cell may flip


def _flips_near_threshold(cfg, model, seed, seed_bar, labels, got, want,
                          what):
    """Threshold mode: ``got`` differs from the lone sweep ``want`` only
    at cells whose lone logit lies within L_MARGIN of the threshold
    (logit 0), compared bar by bar up to the first bar that differs."""
    gen = sampler.seed_generator(seed, "cpu")
    g = cfg.gen
    with torch.inference_mode():
        noise, chord, key_sig, z_phrase = sampler.sweep_draws(
            cfg, SAMPLES, gen, None, None, labels.get("chord"),
            labels.get("key_sig"))
        z_bars, reset = sampler.latent_path(cfg, SAMPLES, g.num_bars,
                                            g.interpolate, g.temperature,
                                            noise=noise)
        logits = model.generate(z_bars, reset, seed_bar, chord=chord,
                                key_sig=key_sig, z_phrase=z_phrase)[0]
    near = np.abs(logits.numpy()) < L_MARGIN
    for k in range(BARS):
        diff = got[:, k] != want[:, k]
        assert not (diff & ~near[:, k]).any(), f"{what} bar {k}"
        if diff.any():
            break


# -- (a) no host read in the program bodies -----------------------------------

@pytest.mark.parametrize("mode", ["threshold", "bernoulli"])
@pytest.mark.parametrize("name", FAMILIES)
def test_coalesced_sweep_reads_nothing_back(name, mode):
    cfg, model = _model(name, sample_mode=mode)
    fn = sampler.make_coalesced_generate_fn(cfg, model)
    rng = np.random.default_rng(1)
    sb, labels = _seed_bars(rng), _labels(cfg, rng)
    gens = [sampler.seed_generator(s, "cpu") for s in range(W)]
    with no_host_reads():
        packed = fn(gens, sb, **labels)
    assert packed.shape == (W, SAMPLES, BARS, 96, 16)


@pytest.mark.parametrize("name", FAMILIES)
def test_reconstruct_reads_nothing_back(name):
    cfg, model = _model(name)
    x, eps, labels = kind_inputs(np.random.default_rng(2), cfg.model, 2)
    x = torch.from_numpy(x[:, :, :cfg.midi.steps_per_bar])
    labels = {k: torch.from_numpy(v) for k, v in labels.items()}
    rec = sampler.reconstruct_fn(cfg, model)
    eps = tuple(map(torch.from_numpy, eps))
    with no_host_reads():
        drawn = rec(x, torch.Generator().manual_seed(3), **labels)
        handed = rec(x, eps=eps, **labels)
    assert drawn.shape == handed.shape == x.shape
    assert drawn.dtype == torch.float32


# -- (b) the programs against their eager bodies, (d) coalesced == lone -------

@pytest.mark.parametrize("mode", ["threshold", "bernoulli"])
@pytest.mark.parametrize("name", FAMILIES)
def test_coalesced_equals_the_eager_body_and_the_lone_sweeps(name, mode):
    """Three coalesced calls of W=3 through one program, with other seeds
    and seed bars (cond: slot 0's labels given, the others drawn): each
    equals the eager coalesced body on generators at the same states, bit
    for bit, with every slot's generator ending at the same state, and
    each slot equals its lone sweep; an earlier call's bars stay as they
    were."""
    cfg, model = _model(name, sample_mode=mode,
                        interpolate=mode == "bernoulli")
    fn = sampler.make_coalesced_generate_fn(cfg, model)
    lone = sampler.make_generate_fn(cfg, model)
    rng = np.random.default_rng(4)
    kept = []
    for call in range(3):
        seeds = [100 * call + s for s in (5, 2 ** 40, 9)]
        sb, labels = _seed_bars(rng), _labels(cfg, rng)
        g_graph = [sampler.seed_generator(s, "cpu") for s in seeds]
        g_eager = [sampler.seed_generator(s, "cpu") for s in seeds]
        got = fn(g_graph, sb, **labels)
        with torch.inference_mode():
            want = _eager_coalesced(cfg, model, g_eager, sb, **labels)
        assert torch.equal(got, want), call
        assert all(torch.equal(a.get_state(), b.get_state())
                   for a, b in zip(g_graph, g_eager))
        for i, s in enumerate(seeds):
            kw = {}
            if labels and labels["chords"][i] is not None:
                kw = {"chord": labels["chords"][i],
                      "key_sig": labels["key_sigs"][i]}
            seed_bar = sb[i] if i == 1 else None
            alone = lone(sampler.seed_generator(s, "cpu"),
                         seed_bar=seed_bar, **kw).numpy()
            slot = unpack_bits_np(got[i].numpy())
            if mode == "threshold" and name in CPU_BATCH_DEPENDENT:
                _flips_near_threshold(cfg, model, s, seed_bar, kw, slot,
                                      alone, f"call {call} slot {i}")
            else:
                np.testing.assert_array_equal(
                    slot, alone, err_msg=f"call {call} slot {i}")
        kept.append((got, want))
    for got, want in kept:
        assert torch.equal(got, want)
    assert len(fn.programs) == 1
    assert not torch.equal(kept[0][0], kept[1][0])


@pytest.mark.parametrize("name", ["c2_gru_4bar", "c3_hier_16bar",
                                  "c4_cond", "c2_mxu"])
def test_reconstruct_equals_the_eager_body(name):
    """Three windows through one program, each with a generator of its
    own (``reconstruct``'s posterior seed a window): each equals the
    forward on noise drawn from a generator at the same state, binarized,
    bit for bit, the generators ending at the same state; an earlier
    window's output stays as it was."""
    cfg, model = _model(name)
    rec = sampler.reconstruct_fn(cfg, model)
    rng = np.random.default_rng(6)
    kept = []
    for w in range(3):
        x, _, labels = kind_inputs(rng, cfg.model, 1, 0.08)
        x = torch.from_numpy(x[:, :, :cfg.midi.steps_per_bar])
        labels = {k: torch.from_numpy(v) for k, v in labels.items()}
        g_graph = torch.Generator().manual_seed(40 + w)
        g_eager = torch.Generator().manual_seed(40 + w)
        got = rec(x, g_graph, **labels)
        with torch.inference_mode():
            logits, _ = model(x, draw_eps(cfg.model, 1, g_eager), **labels)
            want = binarize_logits(logits, cfg.midi.binarize_threshold,
                                   model.pitch_mask)
        assert torch.equal(got, want), w
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        kept.append((got, want))
    for got, want in kept:
        assert torch.equal(got, want)
    assert len(rec.programs) == 1
    assert not torch.equal(kept[0][0], kept[1][0])


# -- (c) a program a signature ------------------------------------------------

def test_each_coalesced_signature_has_its_own_program():
    """A width, which slots draw and the handed-in tensors key a program;
    a plain and a seeded request share one (a zero seed bar is the
    default); a generator given for two slots is refused."""
    cfg, model = _model("c2_gru_4bar", sample_mode="bernoulli")
    fn = sampler.make_coalesced_generate_fn(cfg, model)
    rng = np.random.default_rng(7)

    def gens(n, base=0):
        return [sampler.seed_generator(base + s, "cpu") for s in range(n)]

    fn(gens(W), _seed_bars(rng, seeded=()))
    fn(gens(W, 10), _seed_bars(rng))
    assert len(fn.programs) == 1
    fn(gens(1), _seed_bars(rng, 1, ()))
    assert len(fn.programs) == 2
    noises = [torch.zeros(1, SAMPLES, cfg.model.z_dim)] * W
    uniforms = [torch.full((SAMPLES, BARS, 96, 128), 0.5)] * W
    handed = fn([None] * W, _seed_bars(rng), noises=noises,
                uniforms=uniforms)
    assert len(fn.programs) == 3
    sb = _seed_bars(np.random.default_rng(70))
    first = fn([None] * W, sb, noises=noises, uniforms=uniforms)
    assert torch.equal(first, fn([None] * W, sb, noises=noises,
                                 uniforms=uniforms))
    assert len(fn.programs) == 3 and handed.shape == first.shape
    g = sampler.seed_generator(1, "cpu")
    with pytest.raises(ValueError, match="two slots"):
        fn([g, g, sampler.seed_generator(2, "cpu")], _seed_bars(rng))


def test_serve_warm_up_runs_each_tier_twice(monkeypatch):
    """``--coalesce W``'s warm-up sweeps the lone tier (W=1) and the full
    width twice each, on distinct generators: each program's first run
    (eager) and its capture on the card, so no request pays either."""
    cfg, model = _model("c2_gru_4bar")
    service = cli.Service(cfg, model)
    runner = cli._CoalescedRunner(service, 4)
    calls = []
    real = service.weights.coalesced

    def counting(generators, *a, **kw):
        calls.append(len(generators))
        assert len({id(g) for g in generators}) == len(generators)
        return real(generators, *a, **kw)

    monkeypatch.setattr(service.weights, "coalesced", counting)
    runner.warm()
    assert calls == [1, 1, 4, 4]
    assert sorted(k[0] for k in real.programs) == [1, 4]


def test_each_reconstruct_signature_has_its_own_program():
    cfg, model = _model("c4_cond")
    rec = sampler.reconstruct_fn(cfg, model)
    x, eps, labels = kind_inputs(np.random.default_rng(8), cfg.model, 1)
    x = torch.from_numpy(x)
    eps = tuple(map(torch.from_numpy, eps))
    labels = {k: torch.from_numpy(v) for k, v in labels.items()}
    first = rec(x, torch.Generator().manual_seed(1), **labels)
    rec(x, torch.Generator().manual_seed(2), **labels)
    assert len(rec.programs) == 1
    rec(x, eps=eps, **labels)                    # the noise handed in
    rec(x, torch.Generator().manual_seed(1), eps=eps, **labels)
    assert len(rec.programs) == 2                # a generator not drawn
    rec(x.to(torch.uint8), torch.Generator().manual_seed(1), **labels)
    assert len(rec.programs) == 3
    again = rec(x, torch.Generator().manual_seed(1), **labels)
    assert torch.equal(first, again)


# -- (d) the reconstruction against the JAX package ---------------------------

@pytest.mark.parametrize("name", ["c2_gru_4bar", "c1_conv_bar",
                                  "c3_hier_16bar", "c4_cond", "c2_mxu"])
def test_reconstruct_matches_jax(name):
    """Two windows through one program against the JAX package's jitted
    ``reconstruct_fn`` with the same noise (its latent draws handed in):
    the same bars, no cell flipped."""
    if name in ("c2_trf", "c2_mxu"):
        jc, tc = patch_pair(name)
        jmodel, params = jax_init_params(jc, 0)
        model = jax_port_model(tc, params)
    else:
        jc, tc = kind_pair(name)
        jmodel, params = jax_params(jc, tc, 0)
        model = port_model(tc, params)
    rec = sampler.reconstruct_fn(tc, model)
    rng = np.random.default_rng(9)
    for window in range(2):
        x, eps, labels = kind_inputs(rng, jc.model, 1, 0.08)
        x = x[:, :, :jc.midi.steps_per_bar]
        want = np.asarray(jsampler.reconstruct_fn(jc, HandedEps(
            jmodel, eps))(params, jnp.asarray(x), jax.random.key(0),
                          **{k: jnp.asarray(v) for k, v in labels.items()}))
        got = rec(torch.from_numpy(x), eps=tuple(map(torch.from_numpy, eps)),
                  **{k: torch.from_numpy(v) for k, v in labels.items()})
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert 0.0 < want.mean() < 1.0, window    # bars with notes and rests
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} window {window}")
    assert len(rec.programs) == 1
