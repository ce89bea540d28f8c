"""Bar-by-bar generation, latent paths, posterior encode and reconstruction.

Counterpart of the JAX package's generate/sampler.py (kind ``gru_seq``).
Random draws come from an explicit ``torch.Generator`` on the model's
device or are handed in (``noise``, ``uniforms``, ``eps``): the two
frameworks' generators cannot be matched bit for bit, so the tests give
both packages the same draws.

Latent paths: one z ~ N(0, I)·temperature per phrase (phrase =
``model.num_bars`` bars), held within the phrase, with the GRU state reset
at phrase starts; under ``interpolate`` z slerps from z_a to z_b across
phrases. ``z0``/``z1`` pin the first phrase (the slerp start) and the
slerp end, typically to encoded posterior samples of real music
(``make_encode_fn``).

``make_coalesced_generate_fn`` runs W requests, each with its own
generator and seed bar, as one [W·B]-batched sweep (``serve
--coalesce``); ``seed_generator`` is the one map from a request's seed to
its draws on every serve path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.midi import tensorize
from musicvae_tpu_torch.models.latent import reparameterize, slerp
from musicvae_tpu_torch.models.vae import PianoRollVAE
from musicvae_tpu_torch.ops.binarize import binarize_logits
from musicvae_tpu_torch.ops.pack import pack_bits


def seed_generator(seed: int, device) -> torch.Generator:
    """The generator of a request's ``seed`` on ``device``: every serve
    path maps a seed to its draws through here, so a seed gives the same
    music whether it runs alone or coalesced. A seed torch cannot take
    (outside [-2**63, 2**64)) raises ValueError."""
    try:
        return torch.Generator(device).manual_seed(seed)
    except (RuntimeError, ValueError, OverflowError):
        raise ValueError(f"seed {seed} is outside the range a generator "
                         f"takes, [-2**63, 2**64)") from None


def latent_noise(cfg: Config, batch: int, num_bars: int, interpolate: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The N(0,1) draws ``latent_path`` makes from ``generator``: [2, B, z]
    (z_a, z_b) under ``interpolate``, else one [B, z] a phrase."""
    phrase = 1 if cfg.model.kind == "hier" else max(1, cfg.model.num_bars)
    shape = (2 if interpolate else -(-num_bars // phrase), batch,
             cfg.model.z_dim)
    return torch.randn(shape, generator=generator,
                       device=generator.device if generator else None)


def latent_path(cfg: Config, batch: int, num_bars: int, interpolate: bool,
                temperature: float = 1.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                z0: Optional[torch.Tensor] = None,
                z1: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bar latent path z [B, num_bars, z] and reset mask [B, num_bars].

    ``noise``: N(0,1) draws, [2, B, z] (z_a, z_b) under ``interpolate``,
    else [n_phrases, B, z]; drawn from ``generator``, on its device, when
    None. ``z0`` [B, z] pins the first phrase's z (the slerp start under
    ``interpolate``); later phrases still come from the prior. ``z1``
    [B, z] pins the slerp END — with both endpoints encoded from real
    pieces the sweep morphs from piece A to piece B; it needs
    ``interpolate``."""
    z_dim = cfg.model.z_dim
    phrase = 1 if cfg.model.kind == "hier" else max(1, cfg.model.num_bars)
    n_phrases = -(-num_bars // phrase)
    if z1 is not None and not interpolate:
        raise ValueError("z1 pins the slerp endpoint and only makes sense "
                         "with interpolate=True")
    if noise is None:
        noise = latent_noise(cfg, batch, num_bars, interpolate, generator)
    if interpolate:
        z_a = z0 if z0 is not None else noise[0] * temperature
        z_b = z1 if z1 is not None else noise[1] * temperature
        ts = (torch.linspace(0.0, 1.0, n_phrases, device=noise.device)
              if n_phrases > 1 else torch.tensor([0.5], device=noise.device))
        z_phrases = slerp(z_a, z_b, ts[:, None, None])      # [n, B, z]
    else:
        z_phrases = noise * temperature
        if z0 is not None:
            z_phrases = torch.cat([z0[None].to(z_phrases.dtype),
                                   z_phrases[1:]])
    # each phrase's z repeated over its bars (expand, not
    # repeat_interleave, which may wait on the card for its output size)
    z_bars = z_phrases[:, None].expand(-1, phrase, -1, -1).reshape(
        n_phrases * phrase, batch, z_dim)[:num_bars]
    z_bars = z_bars.transpose(0, 1)                          # [B,N,z]
    p = max(1, cfg.model.num_bars)
    bar_idx = torch.arange(num_bars, device=z_bars.device)
    reset = (bar_idx % p == 0).to(torch.float32).expand(batch, num_bars)
    return z_bars, reset


def _sweep_body(cfg: Config, model: PianoRollVAE):
    """The sweep both generate functions run: (batch, generator,
    seed_bar, z0, z1, noise, uniforms) → bars [batch, num_bars, T, P]
    uint8, for the settings in ``cfg.gen``."""
    g = cfg.gen
    if g.sample_mode not in ("threshold", "bernoulli"):
        raise ValueError(f"unknown GenSpec.sample_mode {g.sample_mode!r}; "
                         "expected 'threshold' or 'bernoulli'")

    def body(batch, generator, seed_bar, z0, z1, noise, uniforms):
        z_bars, reset = latent_path(cfg, batch, g.num_bars, g.interpolate,
                                    g.temperature, generator=generator,
                                    noise=noise, z0=z0, z1=z1)
        kw = {}
        if g.sample_mode == "bernoulli":
            kw = {"uniforms": generator if uniforms is None else uniforms,
                  "sample_temperature": g.sample_temperature}
        return model.generate(z_bars, reset, seed_bar, **kw)[1]

    return body


def make_generate_fn(cfg: Config, model: PianoRollVAE):
    """Sweep function for the shape, latent and sampling settings in
    ``cfg.gen``: (generator, seed_bar=None, z0=None, z1=None, noise=None,
    uniforms=None) → bars [num_samples, num_bars, T, P] uint8 on the
    model's device.

    ``seed_bar`` [B,T,P] is the first prev-bar condition (a real bar);
    ``z0``/``z1`` pin the latent path (``latent_path``). The generator,
    on the model's device, draws the latent path's normals unless
    ``noise`` is given and, in Bernoulli mode, each bar's uniforms unless
    ``uniforms`` ([B,N,T,P]) is given."""
    body = _sweep_body(cfg, model)

    @torch.inference_mode()
    def sweep(generator: Optional[torch.Generator],
              seed_bar: Optional[torch.Tensor] = None,
              z0: Optional[torch.Tensor] = None,
              z1: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        return body(cfg.gen.num_samples, generator, seed_bar, z0, z1, noise,
                    uniforms)

    return sweep


def make_coalesced_generate_fn(cfg: Config, model: PianoRollVAE):
    """Dynamic batching for ``serve --coalesce``: W requests, each with its
    own generator and seed bar, as ONE sweep at batch W·B.

    Returns fn(generators [W], seed_bars [W,B,T,P] uint8, noises=None,
    uniforms=None) → bars [W,B,N,T,P/8] uint8, 1-bit packed along the
    pitch axis on the model's device (ops/pack.py). A zero seed bar is
    exactly the unseeded default (``generate`` starts from zeros when
    seed_bar is None), so plain and seeded requests share the one call.
    ``noises`` and ``uniforms`` hand in slot i's draws (``make_generate_fn``'s
    ``noise`` and ``uniforms``, one a slot) in place of generator i's.

    Slot i draws what ``make_generate_fn`` draws for generator i, in the
    same order: its latent normals first, then each bar's uniforms in
    Bernoulli mode. The bars are computed at batch W·B instead of B, so
    where a library picks another algorithm for the larger batch a logit
    at the threshold may round to the other side. The chord/key
    conditioning of the cond kind waits for that kind (ROADMAP.md A9)."""
    body = _sweep_body(cfg, model)
    g = cfg.gen

    @torch.inference_mode()
    def coalesced(generators: Sequence[Optional[torch.Generator]],
                  seed_bars: torch.Tensor,
                  noises: Optional[Sequence[torch.Tensor]] = None,
                  uniforms: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
        w, b = len(generators), g.num_samples
        if noises is None:
            noises = [latent_noise(cfg, b, g.num_bars, g.interpolate, gen)
                      for gen in generators]
        u = list(generators) if uniforms is None else torch.cat(uniforms)
        bars = body(w * b, None, seed_bars.reshape(w * b,
                                                   *seed_bars.shape[2:]),
                    None, None, torch.cat(list(noises), dim=1), u)
        packed = pack_bits(bars)
        return packed.reshape(w, b, *packed.shape[1:])

    return coalesced


def _eps(x: torch.Tensor, cfg: Config,
         generator: Optional[torch.Generator],
         eps: Optional[torch.Tensor]) -> torch.Tensor:
    """The posterior noise [B, z]: ``eps``, else drawn from ``generator``
    on x's device."""
    if eps is not None:
        return eps
    return torch.randn((x.shape[0], cfg.model.z_dim), generator=generator,
                       device=x.device)


def make_encode_fn(cfg: Config, model: PianoRollVAE):
    """Posterior encode for seeded continuation: (x [B, num_bars, T, P],
    generator=None, eps=None) → {"z0": [B, z]}, one posterior sample
    mu + eps·exp(logvar/2) per row, eps [B, z] ~ N(0, I) drawn from
    ``generator`` unless given."""

    @torch.inference_mode()
    def encode(x: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> dict:
        mu, logvar = model.encode(x)
        return {"z0": reparameterize(mu, logvar,
                                     _eps(x, cfg, generator, eps))}

    return encode


def reconstruct_fn(cfg: Config, model: PianoRollVAE):
    """Reconstruction: (x [B, num_bars, T, P], generator=None, eps=None) →
    encode → posterior sample → teacher-forced decode → binarize, as f32
    {0,1} [B, num_bars, T, P] (the reference's eval-time reconstruct)."""

    @torch.inference_mode()
    def reconstruct(x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits, _ = model(x, _eps(x, cfg, generator, eps))
        return binarize_logits(logits, cfg.midi.binarize_threshold,
                               model.pitch_mask)

    return reconstruct


def bars_to_midi(bars, cfg: Config) -> bytes:
    """Host-side export of one generated sample: [N,T,P] → SMF bytes."""
    return tensorize.bars_to_midi_bytes(np.asarray(bars), cfg.midi)
