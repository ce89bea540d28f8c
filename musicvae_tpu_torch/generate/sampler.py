"""Bar-by-bar generation and latent paths (threshold mode).

Counterpart of the JAX package's generate/sampler.py. Random draws come
from an explicit ``torch.Generator`` or are handed in as ``noise``: the two
frameworks' generators cannot be matched bit for bit, so the tests give
both packages the same normals.

Latent paths: one z ~ N(0, I)·temperature per phrase (phrase =
``model.num_bars`` bars), held within the phrase, with the GRU state reset
at phrase starts; under ``interpolate`` z slerps from z_a to z_b across
phrases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.midi import tensorize
from musicvae_tpu_torch.models.latent import slerp
from musicvae_tpu_torch.models.vae import PianoRollVAE


def latent_path(cfg: Config, batch: int, num_bars: int, interpolate: bool,
                temperature: float = 1.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bar latent path z [B, num_bars, z] and reset mask [B, num_bars].

    ``noise``: N(0,1) draws, [2, B, z] (z_a, z_b) under ``interpolate``,
    else [n_phrases, B, z]; drawn from ``generator``, on its device, when
    None."""
    z_dim = cfg.model.z_dim
    phrase = 1 if cfg.model.kind == "hier" else max(1, cfg.model.num_bars)
    n_phrases = -(-num_bars // phrase)
    if noise is None:
        shape = (2 if interpolate else n_phrases, batch, z_dim)
        noise = torch.randn(shape, generator=generator,
                            device=generator.device if generator else None)
    if interpolate:
        ts = (torch.linspace(0.0, 1.0, n_phrases, device=noise.device)
              if n_phrases > 1 else torch.tensor([0.5], device=noise.device))
        z_phrases = slerp(noise[0] * temperature, noise[1] * temperature,
                          ts[:, None, None])                # [n, B, z]
    else:
        z_phrases = noise * temperature
    # each phrase's z repeated over its bars (expand, not
    # repeat_interleave, which may wait on the card for its output size)
    z_bars = z_phrases[:, None].expand(-1, phrase, -1, -1).reshape(
        n_phrases * phrase, batch, z_dim)[:num_bars]
    z_bars = z_bars.transpose(0, 1)                          # [B,N,z]
    p = max(1, cfg.model.num_bars)
    bar_idx = torch.arange(num_bars, device=z_bars.device)
    reset = (bar_idx % p == 0).to(torch.float32).expand(batch, num_bars)
    return z_bars, reset


def make_generate_fn(cfg: Config, model: PianoRollVAE):
    """Sweep function: (generator, seed_bar=None) → bars [num_samples,
    num_bars, T, P] uint8 on the model's device, for the shape and latent
    settings in ``cfg.gen``. The generator must live on that device."""
    g = cfg.gen
    if g.sample_mode != "threshold":
        raise NotImplementedError(
            f"GenSpec.sample_mode={g.sample_mode!r}: the port generates in "
            "threshold mode so far (see ROADMAP.md)")

    @torch.inference_mode()
    def sweep(generator: torch.Generator,
              seed_bar: Optional[torch.Tensor] = None) -> torch.Tensor:
        z_bars, reset = latent_path(cfg, g.num_samples, g.num_bars,
                                    g.interpolate, g.temperature,
                                    generator=generator)
        _, bars = model.generate(z_bars, reset, seed_bar)
        return bars

    return sweep


def bars_to_midi(bars, cfg: Config) -> bytes:
    """Host-side export of one generated sample: [N,T,P] → SMF bytes."""
    return tensorize.bars_to_midi_bytes(np.asarray(bars), cfg.midi)
