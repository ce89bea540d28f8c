"""The piano-roll VAE, kind ``gru_seq`` with the parity conv stem (C2).

Counterpart of the JAX package's models/vae.py. As there, the decode-path
weights serve two entry points: ``teacher`` (training decode: the prev-bar
features and the head run batched over all B·N bars, only the GRU steps
bar by bar) and ``step`` (one closed-loop generation bar: prev-bar
features → GRU → head → binarize → feed back), which ``generate`` loops
over the bars. In the JAX package these live on a separate ``BarDecoder``
module; here ``PianoRollVAE`` inherits them from ``BarDecoder`` so that
every module keeps the oracle's top-level state-dict name.

The other kinds (conv_bar, hier, cond), the patch stem and the attention
core are later slices: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from musicvae_tpu_torch.config import Config, MidiSpec, ModelSpec
from musicvae_tpu_torch.midi.tensorize import pitch_mask
from musicvae_tpu_torch.models import layers
from musicvae_tpu_torch.models.latent import reparameterize
from musicvae_tpu_torch.ops.binarize import (binarize_logits,
                                             sample_bernoulli_logits)

Latents = List[Tuple[torch.Tensor, torch.Tensor]]   # [(mu, logvar), ...]


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU: a
    CUDA device with no GPU present raises rather than quietly running on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def check_supported(spec: ModelSpec) -> None:
    if spec.kind != "gru_seq" or spec.stem != "conv" \
            or spec.temporal != "gru":
        raise NotImplementedError(
            f"the PyTorch port runs kind='gru_seq' with stem='conv' and "
            f"temporal='gru' so far; got kind={spec.kind!r}, "
            f"stem={spec.stem!r}, temporal={spec.temporal!r} (see "
            f"ROADMAP.md)")


class BarDecoder(nn.Module):
    """Decode-path weights and the two decode modes."""

    def __init__(self, spec: ModelSpec, midi: MidiSpec):
        super().__init__()
        check_supported(spec)
        self.spec, self.midi = spec, midi
        self.compute_dtype = layers.dtype_of(spec.dtype)
        t, p = midi.steps_per_bar, midi.num_pitches
        gru_in = spec.z_dim
        if spec.use_prev_bar:
            self.prev_feat = layers.BarFeat(
                spec.bar_feat_dim, spec.enc_channels, spec.dtype,
                spec.use_pallas_conv1, steps=t, pitches=p)
            gru_in += spec.bar_feat_dim
        self.h_init = layers.Dense(spec.z_dim, spec.gru_hidden, spec.dtype)
        self.dec_gru = layers.GRUCell(gru_in, spec.gru_hidden, spec.dtype)
        self.head = layers.BarDecoderHead(
            spec.dec_channels, spec.gru_hidden, t, p, spec.dtype,
            spec.logits_dtype)
        self.register_buffer("pitch_mask", pitch_mask(midi),
                             persistent=False)

    def teacher(self, z_bars: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decode: z_bars [B,N,z], x [B,N,T,P] → logits
        [B,N,T,P]. Bar k is conditioned on x[:, k-1] (zeros for k = 0)."""
        b, n, t, p = x.shape
        dt = self.compute_dtype
        parts = [z_bars.to(dt)]
        if self.spec.use_prev_bar:
            prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
            parts.append(self.prev_feat(prev.reshape(b * n, t, p))
                         .reshape(b, n, -1))
        gru_in = torch.cat(parts, dim=-1)
        h = torch.tanh(self.h_init(z_bars[:, 0]))       # reset at bar 0
        outs = []
        for k in range(n):
            h = self.dec_gru(gru_in[:, k], h)
            outs.append(h)
        out = torch.stack(outs, dim=1).reshape(b * n, -1)
        return self.head(out).reshape(b, n, t, p)

    def step(self, h: torch.Tensor, prev_bar: torch.Tensor,
             z: torch.Tensor, reset: torch.Tensor,
             u: Optional[torch.Tensor] = None,
             sample_temperature: float = 1.0):
        """One closed-loop bar. h [B,H], prev_bar [B,T,P] uint8, z [B,z],
        reset [B] (1 where the GRU state re-initializes). Returns (h,
        logits [B,T,P], bar [B,T,P] uint8).

        The bar is the threshold binarization of the logits, or, when
        ``u`` (U[0,1) draws [B,T,P]) is given, their Bernoulli sample at
        ``sample_temperature`` (GenSpec.sample_mode "bernoulli").

        At a reset bar the GRU restarts from tanh(h_init(z)) while the
        previous bar keeps conditioning across the phrase seam, as in the
        JAX package's ``BarDecoder.step``."""
        dt = self.compute_dtype
        parts = [z.to(dt)]
        if self.spec.use_prev_bar:
            parts.append(self.prev_feat(prev_bar))
        h0 = torch.tanh(self.h_init(z))
        h = torch.where(reset[:, None] > 0, h0, h.to(dt))
        h = self.dec_gru(torch.cat(parts, dim=-1), h)
        logits = self.head(h)
        if u is None:
            bar = binarize_logits(logits, self.midi.binarize_threshold,
                                  self.pitch_mask, dtype=torch.uint8)
        else:
            bar = sample_bernoulli_logits(u, logits, sample_temperature,
                                          self.pitch_mask, dtype=torch.uint8)
        return h, logits, bar


class PianoRollVAE(BarDecoder):
    """Encoder + reparameterized latent + the decoder.

    ``remat_encoder`` (TrainSpec.remat_encoder): under autograd the per-bar
    encoder features are recomputed in the backward pass instead of being
    kept (the JAX package wraps the same module in ``nn.remat``). The
    values and gradients are the same either way."""

    def __init__(self, spec: ModelSpec, midi: MidiSpec,
                 remat_encoder: bool = False):
        super().__init__(spec, midi)
        self.remat_encoder = remat_encoder
        t, p = midi.steps_per_bar, midi.num_pitches
        self.enc_feat = layers.BarFeat(
            spec.bar_feat_dim, spec.enc_channels, spec.dtype,
            spec.use_pallas_conv1, steps=t, pitches=p)
        self.enc_gru = layers.GRUCell(spec.bar_feat_dim, spec.gru_hidden,
                                      spec.dtype)
        self.z_head = layers.GaussianHead(spec.gru_hidden, spec.z_dim,
                                          spec.dtype)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior (mu, logvar), each f32 [B,z], of x [B,N,T,P]."""
        b, n, t, p = x.shape
        bars = x.reshape(b * n, t, p)
        if self.remat_encoder and torch.is_grad_enabled():
            # no random op inside: no generator state to save and restore
            f = checkpoint(self.enc_feat, bars, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            f = self.enc_feat(bars)
        f = f.reshape(b, n, -1)
        h = torch.zeros(b, self.spec.gru_hidden, dtype=self.compute_dtype,
                        device=x.device)
        for k in range(n):
            h = self.enc_gru(f[:, k], h)
        return self.z_head(h)

    def forward(self, x: torch.Tensor,
                eps: torch.Tensor) -> Tuple[torch.Tensor, Latents]:
        """Teacher-forced ELBO forward: x [B,N,T,P], eps [B,z] N(0,1) noise
        → (logits [B,N,T,P], [(mu, logvar)])."""
        n = x.shape[1]
        mu, logvar = self.encode(x)
        z = reparameterize(mu, logvar, eps)
        z_bars = z[:, None, :].expand(-1, n, -1)
        return self.teacher(z_bars, x), [(mu, logvar)]

    def generate(self, z_bars: torch.Tensor, reset: torch.Tensor,
                 seed_bar: Optional[torch.Tensor] = None,
                 uniforms: Union[torch.Tensor, torch.Generator,
                                 Sequence[torch.Generator], None] = None,
                 sample_temperature: float = 1.0):
        """Closed-loop generation: z_bars [B,N,z] per-bar latent path, reset
        [B,N] (1.0 at phrase starts), seed_bar [B,T,P] (the first prev-bar
        condition, zeros when None) → (logits [B,N,T,P], bars [B,N,T,P]
        uint8).

        Bars are threshold-binarized unless ``uniforms`` is given: then
        each bar is a Bernoulli sample at ``sample_temperature`` from the
        U[0,1) draws ``uniforms[:, k]`` ([B,N,T,P]), or from draws of
        ``uniforms`` itself, a generator on the model's device, made bar
        by bar. A sequence of W generators splits the batch into W equal
        slots (coalesced requests): each bar, slot i's rows are drawn from
        generator i, as a lone sweep of B/W rows would draw them."""
        b, n = z_bars.shape[:2]
        t, p = self.midi.steps_per_bar, self.midi.num_pitches
        prev = (seed_bar.to(torch.uint8) if seed_bar is not None else
                torch.zeros(b, t, p, dtype=torch.uint8,
                            device=z_bars.device))
        h = torch.zeros(b, self.spec.gru_hidden, dtype=self.compute_dtype,
                        device=z_bars.device)
        gens = None
        if isinstance(uniforms, torch.Generator):
            gens = [uniforms]
        elif isinstance(uniforms, (list, tuple)):
            gens = list(uniforms)
            if b % len(gens):
                raise ValueError(f"batch {b} does not split into "
                                 f"{len(gens)} equal slots")
        all_logits, bars = [], []
        for k in range(n):
            if gens is not None:
                draws = [torch.rand((b // len(gens), t, p), generator=g,
                                    device=g.device) for g in gens]
                u = draws[0] if len(draws) == 1 else torch.cat(draws)
            else:
                u = None if uniforms is None else uniforms[:, k]
            h, logits, prev = self.step(h, prev, z_bars[:, k], reset[:, k],
                                        u, sample_temperature)
            all_logits.append(logits)
            bars.append(prev)
        return torch.stack(all_logits, dim=1), torch.stack(bars, dim=1)


@torch.no_grad()
def init_like_flax(model: nn.Module) -> None:
    """Redraw the parameters from the JAX package's initializers: flax's
    lecun-normal (truncated at two standard deviations) for every kernel,
    orthogonal GRU recurrences, zero biases. The same distributions as
    ``musicvae_tpu.models.init_params``, not the same bits."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            # weight[0] spans flax's fan-in for all three layouts
            std = (1.0 / mod.weight[0].numel()) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                  b=2 * std)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, layers.GRUCell):
            std = (1.0 / mod.weight_ih.shape[1]) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(mod.weight_ih, std=std, a=-2 * std,
                                  b=2 * std)
            for block in mod.weight_hh.chunk(3, dim=0):
                nn.init.orthogonal_(block)
            nn.init.zeros_(mod.bias_ih)
            nn.init.zeros_(mod.bias_hh)


def build_model(cfg: Config, device="cuda",
                seed: Optional[int] = None) -> PianoRollVAE:
    """The model for ``cfg`` on ``device``, in eval mode, with random
    weights drawn as ``init_like_flax`` draws them. ``seed`` makes them
    reproducible without touching the global RNG."""
    dev = resolve_device(device)
    ctx = torch.random.fork_rng(devices=[]) if seed is not None \
        else contextlib.nullcontext()
    with ctx:
        if seed is not None:
            torch.manual_seed(seed)
        model = PianoRollVAE(cfg.model, cfg.midi,
                             cfg.train.remat_encoder)
        init_like_flax(model)
    return model.to(dev).eval()
