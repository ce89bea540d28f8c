"""The piano-roll VAE family: the conv bar-VAE (kind ``conv_bar``, C1),
the GRU sequence-VAE (``gru_seq``, C2), the hierarchical bar→phrase VAE
(``hier``, C3) and the chord/key-conditional VAE (``cond``, C4), each with
the parity conv stem or the space-to-depth patch stem (``stem``), and the
sequence kinds with the GRU or the attention core over the bars
(``temporal``).

Counterpart of the JAX package's models/vae.py. As there, the decode-path
weights serve two entry points: ``teacher`` (training decode: the prev-bar
features and the head run batched over all B·N bars; the GRU steps bar by
bar, the attention core takes every bar at once) and ``step`` /
``attn_step`` (one closed-loop generation bar: prev-bar features →
temporal core → head → binarize → feed back), which ``generate`` loops
over the bars. In the JAX package these live on a separate ``BarDecoder``
module; here ``PianoRollVAE`` inherits them from ``BarDecoder`` so that
every module keeps the oracle's top-level state-dict name.
"""

from __future__ import annotations

import contextlib
import functools
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


KINDS = ("conv_bar", "gru_seq", "hier", "cond")

# the latent levels' noise a forward takes, one tensor a level
Eps = Union[torch.Tensor, Sequence[torch.Tensor]]


def check_supported(spec: ModelSpec) -> None:
    """The JAX package's own refusals (its ``PianoRollVAE.setup``), in its
    words, and the unknown kind."""
    if spec.kind not in KINDS:
        raise ValueError(f"unknown ModelSpec.kind {spec.kind!r}; expected "
                         f"one of {KINDS}")
    if spec.temporal not in ("gru", "attn"):
        raise ValueError(f"unknown ModelSpec.temporal "
                         f"{spec.temporal!r}; expected 'gru' or 'attn'")
    if spec.temporal == "attn" and spec.kind == "conv_bar":
        raise ValueError(
            "temporal='attn' needs a bar-sequence model; "
            "kind='conv_bar' has no temporal core")
    if spec.temporal == "attn" and spec.num_bars > spec.attn_max_bars:
        raise ValueError(
            f"num_bars={spec.num_bars} exceeds attn_max_bars="
            f"{spec.attn_max_bars} (the learned position table)")


def eps_shapes(spec: ModelSpec, batch: int) -> List[Tuple[int, ...]]:
    """The shape of each latent level's noise for a batch: [(B, z)], or
    [(B, z_phrase), (B, N, z)] for hier."""
    if spec.kind == "hier":
        return [(batch, spec.z_phrase_dim), (batch, spec.num_bars, spec.z_dim)]
    return [(batch, spec.z_dim)]


def draw_eps(spec: ModelSpec, batch: int,
             generator: Optional[torch.Generator],
             device=None) -> Tuple[torch.Tensor, ...]:
    """N(0,1) noise for every latent level (``eps_shapes``), drawn from
    ``generator`` in level order: the phrase level, then the bar level."""
    dev = generator.device if generator is not None else device
    return tuple(torch.randn(shape, generator=generator, device=dev)
                 for shape in eps_shapes(spec, batch))


class BarDecoder(nn.Module):
    """Decode-path weights and the two decode modes.

    The per-kind pieces, as in the JAX package: conv_bar has no temporal
    core (the head reads z and the previous bar's features); gru_seq and
    cond run ``dec_gru`` over the bars (cond feeds it the chord/key vector
    and hands the vector on to the head); hier adds the conductor, a second
    GRU over the phrase latent whose output joins the head input. Both
    recurrences restart at a reset bar. Under ``temporal="attn"`` the
    causal ``seq_attn`` takes the GRU's place, hier has no conductor (the
    phrase latent joins the attention input instead), and a reset bar
    starts a new attention segment."""

    def __init__(self, spec: ModelSpec, midi: MidiSpec):
        super().__init__()
        check_supported(spec)
        self.spec, self.midi = spec, midi
        self.compute_dtype = layers.dtype_of(spec.dtype)
        self.attn = spec.temporal == "attn"
        patch = spec.patch_size if spec.stem == "patch" else None
        t, p = midi.steps_per_bar, midi.num_pitches
        cond_dim = 2 * spec.cond_embed_dim if spec.kind == "cond" else 0
        feat_dim = spec.bar_feat_dim if spec.use_prev_bar else 0
        if spec.use_prev_bar:
            self.prev_feat = layers.BarFeat(
                spec.bar_feat_dim, spec.enc_channels, spec.dtype,
                spec.use_pallas_conv1, steps=t, pitches=p, patch=patch)
        if spec.kind == "conv_bar":
            head_in = spec.z_dim + feat_dim
        elif self.attn:
            zp_dim = spec.z_phrase_dim if spec.kind == "hier" else 0
            self.seq_attn = layers.AttnStack(
                spec.z_dim + feat_dim + cond_dim + zp_dim, spec.gru_hidden,
                spec.attn_layers, spec.attn_heads, spec.attn_max_bars,
                causal=True, dtype=spec.dtype)
            head_in = spec.gru_hidden + cond_dim
        else:
            self.h_init = layers.Dense(spec.z_dim, spec.gru_hidden,
                                       spec.dtype)
            self.dec_gru = layers.GRUCell(spec.z_dim + feat_dim + cond_dim,
                                          spec.gru_hidden, spec.dtype)
            head_in = spec.gru_hidden + cond_dim
        if spec.kind == "hier" and not self.attn:
            self.cond_init = layers.Dense(spec.z_phrase_dim, spec.gru_hidden,
                                          spec.dtype)
            self.conductor = layers.GRUCell(spec.z_phrase_dim,
                                            spec.gru_hidden, spec.dtype)
            head_in = 2 * spec.gru_hidden
        if patch is not None:
            self.head = layers.PatchHead(
                spec.dec_channels, head_in, patch, t, p, spec.dtype,
                spec.logits_dtype)
        else:
            self.head = layers.BarDecoderHead(
                spec.dec_channels, head_in, t, p, spec.dtype,
                spec.logits_dtype)
        self.register_buffer("pitch_mask", pitch_mask(midi),
                             persistent=False)

    def _head_in(self, z, feat, cond, out, c) -> torch.Tensor:
        """The head's input, the same in both decode modes: z ⊕ feat for
        conv_bar, else the GRU output ⊕ the cond vector (cond) ⊕ the
        conductor output (hier)."""
        dt = self.compute_dtype
        if self.spec.kind == "conv_bar":
            parts = [z.to(dt)] + ([] if feat is None else [feat])
        else:
            parts = [out] + ([] if cond is None else [cond.to(dt)]) \
                + ([] if c is None else [c])
        return torch.cat(parts, dim=-1)

    def _start(self, z, z_phrase):
        """The recurrences' state at a reset bar: tanh(h_init(z)) and, for
        hier, tanh(cond_init(z_phrase)) (None otherwise)."""
        h0 = torch.tanh(self.h_init(z))
        if self.spec.kind != "hier":
            return h0, None
        return h0, torch.tanh(self.cond_init(z_phrase.to(self.compute_dtype)))

    def _recur(self, h, hc, gru_in, z_phrase):
        """One bar of the recurrences, teacher and generation alike: the
        GRU on ``gru_in`` and, for hier, the conductor on the phrase
        latent. Returns (h, hc)."""
        h = self.dec_gru(gru_in, h)
        if self.spec.kind == "hier":
            hc = self.conductor(z_phrase.to(self.compute_dtype), hc)
        return h, hc

    def _seq_in(self, z, feat, cond, z_phrase) -> torch.Tensor:
        """The temporal core's input, the same in both decode modes: z ⊕
        feat ⊕ the cond vector (cond) ⊕ the phrase latent (hier with
        attention, where it stands in for the conductor)."""
        dt = self.compute_dtype
        parts = [z.to(dt)] + ([] if feat is None else [feat])
        if self.spec.kind == "cond":
            parts.append(cond.to(dt))
        if self.attn and self.spec.kind == "hier":
            parts.append(z_phrase.to(dt))
        return torch.cat(parts, dim=-1)

    def teacher(self, z_bars: torch.Tensor, x: torch.Tensor,
                cond_vec: Optional[torch.Tensor] = None,
                z_phrase_bars: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Teacher-forced decode: z_bars [B,N,z], x [B,N,T,P], cond_vec
        [B,N,2E] (cond), z_phrase_bars [B,N,z_phrase] (hier) → logits
        [B,N,T,P]. Bar k is conditioned on x[:, k-1] (zeros for k = 0);
        the recurrences start at bar 0, and the attention core sees bars
        0..k."""
        b, n, t, p = x.shape
        spec = self.spec
        feats = None
        if spec.use_prev_bar:
            prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
            feats = self.prev_feat(prev.reshape(b * n, t, p)).reshape(
                b, n, -1)
        out = c = None
        if spec.kind != "conv_bar":
            seq_in = self._seq_in(z_bars, feats, cond_vec, z_phrase_bars)
            if self.attn:
                out = self.seq_attn(seq_in).reshape(b * n, -1)
            else:
                zp = [None] * n if z_phrase_bars is None else \
                    z_phrase_bars.unbind(1)
                h, hc = self._start(z_bars[:, 0], zp[0])  # reset at bar 0
                outs, cs = [], []
                for k in range(n):
                    h, hc = self._recur(h, hc, seq_in[:, k], zp[k])
                    outs.append(h)
                    cs.append(hc)
                out = torch.stack(outs, dim=1).reshape(b * n, -1)
                if spec.kind == "hier":
                    c = torch.stack(cs, dim=1).reshape(b * n, -1)
        head_in = self._head_in(
            z_bars.reshape(b * n, -1),
            None if feats is None else feats.reshape(b * n, -1),
            cond_vec.reshape(b * n, -1) if spec.kind == "cond" else None,
            out, c)
        return self.head(head_in).reshape(b, n, t, p)

    def _emit(self, logits: torch.Tensor, u: Optional[torch.Tensor],
              sample_temperature: float) -> torch.Tensor:
        """A generated bar from its logits: the threshold binarization, or
        with ``u`` (U[0,1) draws [B,T,P]) the Bernoulli sample at
        ``sample_temperature`` (GenSpec.sample_mode "bernoulli")."""
        if u is None:
            return binarize_logits(logits, self.midi.binarize_threshold,
                                   self.pitch_mask, dtype=torch.uint8)
        return sample_bernoulli_logits(u, logits, sample_temperature,
                                       self.pitch_mask, dtype=torch.uint8)

    def step(self, h, prev_bar: torch.Tensor, z: torch.Tensor,
             reset: torch.Tensor, u: Optional[torch.Tensor] = None,
             sample_temperature: float = 1.0,
             cond: Optional[torch.Tensor] = None,
             z_phrase: Optional[torch.Tensor] = None):
        """One closed-loop bar of the GRU core. h: the recurrent state,
        [B,H] (gru_seq, cond), the pair ([B,H], [B,H]) of the GRU and the
        conductor (hier) or None (conv_bar); prev_bar [B,T,P] uint8, z
        [B,z], reset [B] (1 where the recurrences re-initialize), cond
        [B,2E] (cond), z_phrase [B,z_phrase] (hier). Returns (h, logits
        [B,T,P], bar [B,T,P] uint8), h in the structure it came in; the
        bar as ``_emit`` makes it from ``u``.

        At a reset bar the recurrences restart while the previous bar
        keeps conditioning across the phrase seam, as in the JAX
        package's ``BarDecoder.step``."""
        spec, dt = self.spec, self.compute_dtype
        feat = out = c = None
        if spec.use_prev_bar:
            feat = self.prev_feat(prev_bar)
        if spec.kind != "conv_bar":
            h, hc = h if spec.kind == "hier" else (h, None)
            h0, hc0 = self._start(z, z_phrase)
            reset = reset[:, None] > 0
            h = torch.where(reset, h0, h.to(dt))
            if hc is not None:
                hc = torch.where(reset, hc0, hc.to(dt))
            out, c = self._recur(h, hc, self._seq_in(z, feat, cond, None),
                                 z_phrase)
            h = (out, c) if spec.kind == "hier" else out
        logits = self.head(self._head_in(z, feat, cond, out, c))
        return h, logits, self._emit(logits, u, sample_temperature)

    def attn_step(self, state, prev_bar: torch.Tensor, z: torch.Tensor,
                  reset: torch.Tensor, u: Optional[torch.Tensor] = None,
                  sample_temperature: float = 1.0,
                  cond: Optional[torch.Tensor] = None,
                  z_phrase: Optional[torch.Tensor] = None,
                  slots: int = 1):
        """One closed-loop bar of the attention core, the arguments of
        ``step`` but the state: (KV cache (``layers.attn_cache``), pos (the
        bar's index in the sweep), start [B] int64 (each row's segment
        start)). A reset bar starts a new segment (start ← pos) while the
        previous bar keeps conditioning across the seam. ``slots``: the
        batch's equal slots of coalesced requests (``AttnStack.step``).
        Returns (state, logits, bar)."""
        cache, pos, start = state
        feat = None
        if self.spec.use_prev_bar:
            feat = self.prev_feat(prev_bar)
        start = torch.where(reset > 0, pos, start)
        out = self.seq_attn.step(cache, self._seq_in(z, feat, cond, z_phrase),
                                 pos, start, slots)
        logits = self.head(self._head_in(z, feat, cond, out, None))
        return ((cache, pos + 1, start), logits,
                self._emit(logits, u, sample_temperature))


class PianoRollVAE(BarDecoder):
    """Encoder + reparameterized latent(s) + the decoder.

    The encoder per kind: conv_bar runs ``enc_trunk`` on the window's
    first bar into ``z_head``; the others run ``enc_feat`` on every bar
    and ``enc_gru`` over the bars (or, under ``temporal="attn"``, the
    bidirectional ``enc_attn``; cond appends the chord/key vector to each
    bar's features), then ``z_head`` on the last bar's state, or for hier
    ``phrase_head`` (the phrase latent) and ``bar_head`` (each bar's
    latent from its features and the phrase latent).

    ``remat_encoder`` (TrainSpec.remat_encoder): under autograd the per-bar
    encoder features are recomputed in the backward pass instead of being
    kept (the JAX package wraps the same module in ``nn.remat``). The
    values and gradients are the same either way."""

    def __init__(self, spec: ModelSpec, midi: MidiSpec,
                 remat_encoder: bool = False):
        super().__init__(spec, midi)
        self.remat_encoder = remat_encoder
        patch = spec.patch_size if spec.stem == "patch" else None
        t, p = midi.steps_per_bar, midi.num_pitches
        if spec.kind == "conv_bar":
            self.enc_trunk = layers.ConvTrunk(spec.enc_channels, spec.dtype,
                                              spec.use_pallas_conv1, patch)
            self.z_head = layers.GaussianHead(
                self.enc_trunk.flat_dim(t, p), spec.z_dim, spec.dtype)
            return
        cond_dim = 2 * spec.cond_embed_dim if spec.kind == "cond" else 0
        self.enc_feat = layers.BarFeat(
            spec.bar_feat_dim, spec.enc_channels, spec.dtype,
            spec.use_pallas_conv1, steps=t, pitches=p, patch=patch)
        if self.attn:
            self.enc_attn = layers.AttnStack(
                spec.bar_feat_dim + cond_dim, spec.gru_hidden,
                spec.attn_layers, spec.attn_heads, spec.attn_max_bars,
                causal=False, dtype=spec.dtype)
        else:
            self.enc_gru = layers.GRUCell(spec.bar_feat_dim + cond_dim,
                                          spec.gru_hidden, spec.dtype)
        if spec.kind == "hier":
            self.phrase_head = layers.GaussianHead(
                spec.gru_hidden, spec.z_phrase_dim, spec.dtype)
            self.bar_head = layers.GaussianHead(
                spec.bar_feat_dim + spec.z_phrase_dim, spec.z_dim,
                spec.dtype)
        else:
            self.z_head = layers.GaussianHead(spec.gru_hidden, spec.z_dim,
                                              spec.dtype)
        if spec.kind == "cond":
            self.chord_emb = layers.Embed(spec.cond_chord_classes,
                                          spec.cond_embed_dim)
            self.key_emb = layers.Embed(spec.cond_key_classes,
                                        spec.cond_embed_dim)

    def cond_vector(self, chord: torch.Tensor,
                    key_sig: torch.Tensor) -> torch.Tensor:
        """[B,N] chord ids + [B] key ids → [B,N,2E] f32 conditioning (cond);
        N comes from chord's shape."""
        ce = self.chord_emb(chord.long())
        ke = self.key_emb(key_sig.long())[:, None, :].expand(
            -1, ce.shape[1], -1)
        return torch.cat([ce, ke], dim=-1)

    def _bar_feats(self, x: torch.Tensor) -> torch.Tensor:
        b, n, t, p = x.shape
        bars = x.reshape(b * n, t, p)
        if self.remat_encoder and torch.is_grad_enabled():
            # no random op inside: no generator state to save and restore
            f = checkpoint(self.enc_feat, bars, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            f = self.enc_feat(bars)
        return f.reshape(b, n, -1)

    def encode(self, x: torch.Tensor,
               cond_vec: Optional[torch.Tensor] = None):
        """Posterior of x [B,N,T,P]: (mu, logvar), each f32 [B,z]; for hier
        the phrase posterior and the bar features, (mu_p, logvar_p, feats
        [B,N,F]). ``cond_vec`` [B,N,2E] joins each bar's features (cond)."""
        if self.spec.kind == "conv_bar":
            return self.z_head(self.enc_trunk(x[:, 0]))
        f = self._bar_feats(x)
        if cond_vec is not None:
            # the JAX concatenation promotes the bf16 features to f32;
            # enc_gru rounds both back to its compute dtype
            f = torch.cat([f.float(), cond_vec], dim=-1)
        if self.attn:   # bidirectional: the last bar sees the window
            h = self.enc_attn(f)[:, -1]
        else:
            h = torch.zeros(x.shape[0], self.spec.gru_hidden,
                            dtype=self.compute_dtype, device=x.device)
            for k in range(x.shape[1]):
                h = self.enc_gru(f[:, k], h)
        if self.spec.kind == "hier":
            return (*self.phrase_head(h), f)
        return self.z_head(h)

    def forward(self, x: torch.Tensor, eps: Eps,
                chord: Optional[torch.Tensor] = None,
                key_sig: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Latents]:
        """Teacher-forced ELBO forward: x [B,N,T,P] and ``eps``, the N(0,1)
        noise of each latent level (``eps_shapes``: (eps_z [B,z],), or for
        hier (eps_phrase [B,z_phrase], eps_bar [B,N,z]); a bare tensor is
        the one level), chord [B,N] and key_sig [B] for cond → (logits
        [B,N,T,P], [(mu, logvar) per level])."""
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        b, n = x.shape[:2]
        cond_vec = None
        if self.spec.kind == "cond":
            cond_vec = self.cond_vector(chord, key_sig)
        if self.spec.kind == "hier":
            mu_p, lv_p, f = self.encode(x)
            z_phrase = reparameterize(mu_p, lv_p, eps[0])
            zp_b = z_phrase[:, None, :].expand(-1, n, -1)
            mu_b, lv_b = self.bar_head(torch.cat([f, zp_b.to(f.dtype)],
                                                 dim=-1))
            z_bars = reparameterize(mu_b, lv_b, eps[1])
            logits = self.teacher(z_bars, x, z_phrase_bars=zp_b)
            return logits, [(mu_p, lv_p), (mu_b, lv_b)]
        mu, logvar = self.encode(x, cond_vec)
        z = reparameterize(mu, logvar, eps[0])
        z_bars = z[:, None, :].expand(-1, n, -1)
        return self.teacher(z_bars, x, cond_vec), [(mu, logvar)]

    def generate(self, z_bars: torch.Tensor, reset: torch.Tensor,
                 seed_bar: Optional[torch.Tensor] = None,
                 uniforms: Union[torch.Tensor, torch.Generator,
                                 Sequence[torch.Generator], None] = None,
                 sample_temperature: float = 1.0,
                 chord: Optional[torch.Tensor] = None,
                 key_sig: Optional[torch.Tensor] = None,
                 z_phrase: Optional[torch.Tensor] = None,
                 slots: int = 1):
        """Closed-loop generation: z_bars [B,N,z] per-bar latent path, reset
        [B,N] (1.0 at phrase starts), seed_bar [B,T,P] (the first prev-bar
        condition, zeros when None) → (logits [B,N,T,P], bars [B,N,T,P]
        uint8). cond takes chord [B,N] and key_sig [B]; hier takes
        z_phrase, [B,z_phrase] for the whole sweep or a per-bar path
        [B,N,z_phrase] (a phrase-identity morph).

        Bars are threshold-binarized unless ``uniforms`` is given: then
        each bar is a Bernoulli sample at ``sample_temperature`` from the
        U[0,1) draws ``uniforms[:, k]`` ([B,N,T,P]), or from draws of
        ``uniforms`` itself, a generator on the model's device, made bar
        by bar. A sequence of W generators splits the batch into W equal
        slots (coalesced requests): each bar, slot i's rows are drawn from
        generator i, as a lone sweep of B/W rows would draw them.

        The attention core steps through an N-bar KV cache made once for
        the sweep; N may not exceed ``attn_max_bars``. ``slots`` > 1 says
        the batch is that many equal slots of coalesced requests: the
        attention core then gives each slot the bits a lone sweep of its
        rows gives (``layers.per_slot``)."""
        spec = self.spec
        b, n = z_bars.shape[:2]
        t, p = self.midi.steps_per_bar, self.midi.num_pitches
        dev = z_bars.device
        cond_vec = zp = None
        if spec.kind == "cond":
            cond_vec = self.cond_vector(chord, key_sig)
        if spec.kind == "hier":
            if z_phrase is None:
                raise ValueError("a hier model generates from a phrase "
                                 "latent: pass z_phrase")
            if z_phrase.dim() == 3 and tuple(z_phrase.shape[:2]) != (b, n):
                raise ValueError(
                    f"per-bar z_phrase path has shape "
                    f"{tuple(z_phrase.shape)}; its leading axes must match "
                    f"(batch, num_bars)=({b}, {n}) — a z_phrase1 morph path "
                    f"must supply one phrase latent per generated bar")
            zp = (z_phrase if z_phrase.dim() == 3 else
                  z_phrase[:, None, :].expand(-1, n, -1))
        prev = (seed_bar.to(torch.uint8) if seed_bar is not None else
                torch.zeros(b, t, p, dtype=torch.uint8, device=dev))
        step, h = self.step, None
        if self.attn:
            if n > spec.attn_max_bars:
                raise ValueError(
                    f"{n}-bar sweep exceeds attn_max_bars="
                    f"{spec.attn_max_bars} (the learned position table); "
                    "raise ModelSpec.attn_max_bars or shorten the sweep")
            step = functools.partial(self.attn_step, slots=slots)
            h = (layers.attn_cache(b, n, spec.attn_layers, spec.gru_hidden,
                                   self.compute_dtype, dev),
                 0, torch.zeros(b, dtype=torch.long, device=dev))
        elif spec.kind != "conv_bar":
            h = torch.zeros(b, spec.gru_hidden, dtype=self.compute_dtype,
                            device=dev)
            if spec.kind == "hier":
                h = (h, h)
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
            h, logits, prev = step(
                h, prev, z_bars[:, k], reset[:, k], u, sample_temperature,
                None if cond_vec is None else cond_vec[:, k],
                None if zp is None else zp[:, k])
            all_logits.append(logits)
            bars.append(prev)
        return torch.stack(all_logits, dim=1), torch.stack(bars, dim=1)


def param_count(model: nn.Module) -> int:
    """The number of parameters of the JAX package's model: the port's
    less each GRU cell's r/z hidden biases, constants that flax's GRU
    does not have."""
    return sum(p.numel() for p in model.parameters()) - sum(
        2 * m.weight_hh.shape[1] for m in model.modules()
        if isinstance(m, layers.GRUCell))


@torch.no_grad()
def init_like_flax(model: nn.Module) -> None:
    """Redraw the parameters from the JAX package's initializers: flax's
    lecun-normal (truncated at two standard deviations) for every kernel,
    orthogonal GRU recurrences, zero biases, flax ``nn.Embed``'s normal
    embeddings (``layers.Embed``), the attention core's N(0, 0.02²)
    position table, and LayerNorm scales of one. The same distributions as
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
        elif isinstance(mod, (layers.Embed, layers.AttnStack)):
            mod.reset_parameters()
        elif isinstance(mod, layers.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


def init_params(cfg: Config, generator: torch.Generator):
    """(model, state dict) for ``cfg``, its weights drawn as
    ``build_model`` draws them from a seed taken from ``generator``; the
    model lives on the generator's device (a CUDA generator: the card).
    The counterpart of the JAX package's ``init_params(cfg, rng)``."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    model = build_model(cfg, device=generator.device, seed=seed)
    return model, model.state_dict()


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
