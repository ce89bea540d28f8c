"""Bar-by-bar generation, latent paths, posterior encode and reconstruction.

Counterpart of the JAX package's generate/sampler.py, for the four parity
kinds.
Random draws come from an explicit ``torch.Generator`` on the model's
device or are handed in (``noise``, ``uniforms``, ``eps``): the two
frameworks' generators cannot be matched bit for bit, so the tests give
both packages the same draws.

Latent paths: one z ~ N(0, I)·temperature per phrase (phrase =
``model.num_bars`` bars; one bar for hier, whose bar latents vary bar by
bar under its phrase latent), held within the phrase, with the recurrent
state reset at phrase starts; under ``interpolate`` z slerps from z_a to
z_b across phrases. ``z0``/``z1`` pin the first phrase (the slerp start)
and the slerp end, typically to encoded posterior samples of real music
(``make_encode_fn``).

``make_coalesced_generate_fn`` runs W requests, each with its own
generator, seed bar and labels, as one [W·B]-batched sweep (``serve
--coalesce``); ``seed_generator`` is the one map from a request's seed to
its draws on every serve path.

On the card ``make_generate_fn``'s sweep, the coalesced sweep and the
reconstruction are each a captured CUDA graph a signature
(utils/graphs.py ``StaticProgram``), replayed from their second call on;
the encode runs eagerly (a command encodes once or twice).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.midi import tensorize
from musicvae_tpu_torch.models.latent import reparameterize, slerp
from musicvae_tpu_torch.models.vae import PianoRollVAE, draw_eps
from musicvae_tpu_torch.ops.binarize import binarize_logits
from musicvae_tpu_torch.ops.pack import pack_bits
from musicvae_tpu_torch.utils import graphs


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
              if n_phrases > 1 else torch.full((1,), 0.5,
                                               device=noise.device))
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


def sweep_draws(cfg: Config, batch: int,
                generator: Optional[torch.Generator], device=None,
                noise: Optional[torch.Tensor] = None,
                chord: Optional[torch.Tensor] = None,
                key_sig: Optional[torch.Tensor] = None,
                z_phrase0: Optional[torch.Tensor] = None):
    """What a sweep takes from its generator before its first bar, each
    draw made only where the caller gives no value, in this order: the
    latent path's normals (``latent_noise``); for cond, chord classes
    [B, num_bars] and key classes [B], uniform over the classes; for
    hier, the phrase latent [B, z_phrase] ~ N(0, I)·temperature. Returns
    (noise, chord, key_sig, z_phrase), None where the kind has none."""
    g, spec = cfg.gen, cfg.model
    dev = generator.device if generator is not None else device
    if noise is None:
        noise = latent_noise(cfg, batch, g.num_bars, g.interpolate,
                             generator)
    if spec.kind == "cond":
        if chord is None:
            chord = torch.randint(0, spec.cond_chord_classes,
                                  (batch, g.num_bars), generator=generator,
                                  device=dev)
        if key_sig is None:
            key_sig = torch.randint(0, spec.cond_key_classes, (batch,),
                                    generator=generator, device=dev)
    else:
        chord = key_sig = None
    z_phrase = None
    if spec.kind == "hier":
        z_phrase = z_phrase0
        if z_phrase is None:
            z_phrase = torch.randn((batch, spec.z_phrase_dim),
                                   generator=generator,
                                   device=dev) * g.temperature
    return noise, chord, key_sig, z_phrase


def _sweep_body(cfg: Config, model: PianoRollVAE):
    """The sweep both generate functions run: (batch, generator,
    seed_bar, z0, z1, noise, uniforms, chord, key_sig, z_phrase0,
    z_phrase1) → bars [batch, num_bars, T, P] uint8, for the settings in
    ``cfg.gen``. The generator's draws: ``sweep_draws``, then in
    Bernoulli mode each bar's uniforms.

    hier: ``z_phrase0`` [B, z_phrase] pins the phrase latent (the piece
    identity), and under ``interpolate`` ``z_phrase1`` slerps it bar by
    bar from z_phrase0 to z_phrase1 while the per-bar z path keeps its own
    granularity (``z0``/``z1`` pin that path's endpoints: the two knobs
    compose)."""
    g = cfg.gen
    if g.sample_mode not in ("threshold", "bernoulli"):
        raise ValueError(f"unknown GenSpec.sample_mode {g.sample_mode!r}; "
                         "expected 'threshold' or 'bernoulli'")
    dev = next(model.parameters()).device

    def body(batch, generator, seed_bar, z0, z1, noise, uniforms,
             chord=None, key_sig=None, z_phrase0=None, z_phrase1=None,
             slots=1):
        if z_phrase1 is not None and not (cfg.model.kind == "hier"
                                          and g.interpolate):
            raise ValueError("z_phrase1 morphs the hier phrase latent and "
                             "needs kind='hier' plus interpolate=True")
        noise, chord, key_sig, z_phrase = sweep_draws(
            cfg, batch, generator, dev, noise, chord, key_sig, z_phrase0)
        z_bars, reset = latent_path(cfg, batch, g.num_bars, g.interpolate,
                                    g.temperature, noise=noise, z0=z0,
                                    z1=z1)
        if z_phrase1 is not None:
            ts = (torch.linspace(0.0, 1.0, g.num_bars, device=noise.device)
                  if g.num_bars > 1
                  else torch.full((1,), 0.5, device=noise.device))
            z_phrase = slerp(z_phrase[None], z_phrase1[None],
                             ts[:, None]).transpose(0, 1)   # [B,N,z_phrase]
        kw = {"chord": chord, "key_sig": key_sig, "z_phrase": z_phrase}
        if g.sample_mode == "bernoulli":
            kw.update(uniforms=generator if uniforms is None else uniforms,
                      sample_temperature=g.sample_temperature)
        return model.generate(z_bars, reset, seed_bar, slots=slots, **kw)[1]

    return body


_SWEEP_ARGS = ("seed_bar", "z0", "z1", "noise", "uniforms", "chord",
               "key_sig", "z_phrase0", "z_phrase1")


def make_generate_fn(cfg: Config, model: PianoRollVAE):
    """Sweep function for the shape, latent and sampling settings in
    ``cfg.gen``: (generator, seed_bar=None, z0=None, z1=None, noise=None,
    uniforms=None, chord=None, key_sig=None, z_phrase0=None,
    z_phrase1=None) → bars [num_samples, num_bars, T, P] uint8 on the
    model's device, a tensor of the caller's own.

    ``seed_bar`` [B,T,P] is the first prev-bar condition (a real bar);
    ``z0``/``z1`` pin the latent path (``latent_path``); cond takes chord
    [B, num_bars] and key_sig [B] classes, hier the phrase latent
    ``z_phrase0`` and its morph end ``z_phrase1`` (``_sweep_body``). The
    generator, on the model's device, draws what is not given
    (``sweep_draws``) and, in Bernoulli mode, each bar's uniforms unless
    ``uniforms`` ([B,N,T,P]) is given.

    Each signature (which arguments are given, their shapes and dtypes,
    whether a generator is) has its own static inputs and its own
    generator, and runs as a ``graphs.StaticProgram``: on a CUDA device
    outside ``utils/debug.py`` ``debug_mode`` its first sweep is eager,
    its second is captured as one CUDA graph and every later one is a
    replay of it,
    as the JAX package jits one program a signature. A call copies the
    given tensors into the signature's buffers, sets the signature's
    generator to the caller's state, sweeps, leaves the caller's
    generator where the sweep left it, and returns a copy of the bars
    made on the stream (the next sweep overwrites the graph's). The
    draws, and so the bars, are an eager sweep's. Not for two threads at
    once."""
    body = _sweep_body(cfg, model)
    dev = next(model.parameters()).device
    sweeps: dict = {}

    @torch.inference_mode()
    def sweep(generator: Optional[torch.Generator],
              seed_bar: Optional[torch.Tensor] = None,
              z0: Optional[torch.Tensor] = None,
              z1: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              uniforms: Optional[torch.Tensor] = None,
              chord: Optional[torch.Tensor] = None,
              key_sig: Optional[torch.Tensor] = None,
              z_phrase0: Optional[torch.Tensor] = None,
              z_phrase1: Optional[torch.Tensor] = None) -> torch.Tensor:
        args = dict(zip(_SWEEP_ARGS, (seed_bar, z0, z1, noise, uniforms,
                                      chord, key_sig, z_phrase0,
                                      z_phrase1)))
        given = {k: v for k, v in args.items() if v is not None}
        drawing = [] if generator is None else [generator]
        key = (len(drawing), graphs.signature(given))
        run = sweeps.get(key)
        if run is None:
            run = sweeps[key] = graphs.StaticProgram(
                lambda static, gens: body(
                    cfg.gen.num_samples, gens[0] if gens else None,
                    **{k: static.get(k) for k in _SWEEP_ARGS}),
                dev, given, len(drawing))
        return run(given, drawing)

    sweep.programs = sweeps
    return sweep


def make_coalesced_generate_fn(cfg: Config, model: PianoRollVAE):
    """Dynamic batching for ``serve --coalesce``: W requests, each with its
    own generator, seed bar and (cond) labels, as ONE sweep at batch W·B.

    Returns fn(generators [W], seed_bars [W,B,T,P] uint8, noises=None,
    uniforms=None, chords=None, key_sigs=None) → bars [W,B,N,T,P/8]
    uint8, 1-bit packed along the pitch axis on the model's device
    (ops/pack.py). A zero seed bar is exactly the unseeded default
    (``generate`` starts from zeros when seed_bar is None), so plain and
    seeded requests share the one call. ``noises``, ``uniforms``,
    ``chords`` ([B,N] classes) and ``key_sigs`` ([B]) hand in slot i's
    values (``make_generate_fn``'s ``noise``, ``uniforms``, ``chord`` and
    ``key_sig``, one a slot, None where the slot has none) in place of
    generator i's draws; the labels are ignored for kinds other than
    cond.

    Slot i draws what ``make_generate_fn`` draws for generator i, in the
    same order (``sweep_draws``, then each bar's uniforms in Bernoulli
    mode), and gets the bars a lone sweep gives it: the sweep runs at
    batch W·B, and the attention core runs the ops whose rows depend on
    the batch on the card a slot at a time (``layers.per_slot``).

    Each width W and signature (which slots draw from a generator, the
    shapes and dtypes of the seed bars and of the handed-in noises,
    uniforms and labels) has its own static inputs and W generators of
    its own, and runs as a ``graphs.StaticProgram``, as
    ``make_generate_fn``'s sweep does: the draws, the slots'
    concatenation, the sweep and the packing are one captured CUDA graph
    on the card from its second call on. A call leaves each slot's
    generator where its slot's draws left it. The generators must be W
    distinct objects (or None). Not for two threads at once."""
    body = _sweep_body(cfg, model)
    b = cfg.gen.num_samples
    dev = next(model.parameters()).device
    cond = cfg.model.kind == "cond"
    programs: dict = {}

    def program_body(w: int, drawing: Tuple[bool, ...]):
        def run(static, gens):
            own = iter(gens)
            slot_gens = [next(own) if d else None for d in drawing]
            slots = [sweep_draws(
                cfg, b, gen, dev, static.get(("noises", i)),
                static.get(("chords", i)), static.get(("key_sigs", i)))
                for i, gen in enumerate(slot_gens)]
            noise, chord, key_sig, z_phrase = (
                None if parts[0] is None else
                torch.cat(list(parts), dim=1 if j == 0 else 0)
                for j, parts in enumerate(zip(*slots)))
            u = (slot_gens if ("uniforms", 0) not in static else
                 torch.cat([static[("uniforms", i)] for i in range(w)]))
            seed_bars = static["seed_bars"]
            bars = body(w * b, None,
                        seed_bars.reshape(w * b, *seed_bars.shape[2:]),
                        None, None, noise, u, chord, key_sig, z_phrase,
                        slots=w)
            packed = pack_bits(bars)
            return packed.reshape(w, b, *packed.shape[1:])
        return run

    @torch.inference_mode()
    def coalesced(generators: Sequence[Optional[torch.Generator]],
                  seed_bars: torch.Tensor,
                  noises: Optional[Sequence[torch.Tensor]] = None,
                  uniforms: Optional[Sequence[torch.Tensor]] = None,
                  chords: Optional[Sequence] = None,
                  key_sigs: Optional[Sequence] = None) -> torch.Tensor:
        drawing = [gen for gen in generators if gen is not None]
        if len({id(gen) for gen in drawing}) < len(drawing):
            raise ValueError("a generator is given for two slots; each "
                             "slot draws from its own")
        given = {"seed_bars": seed_bars}
        for name, values in (("noises", noises), ("uniforms", uniforms),
                             ("chords", chords if cond else None),
                             ("key_sigs", key_sigs if cond else None)):
            for i, v in enumerate(values or ()):
                if v is not None:
                    given[(name, i)] = v
        w = len(generators)
        key = (w, tuple(gen is not None for gen in generators),
               graphs.signature(given))
        run = programs.get(key)
        if run is None:
            run = programs[key] = graphs.StaticProgram(
                program_body(w, key[1]), dev, given, len(drawing))
        return run(given, drawing)

    coalesced.programs = programs
    return coalesced


def _posterior_noise(cfg: Config, x: torch.Tensor,
                     generator: Optional[torch.Generator], eps):
    """The posterior noise of every latent level (``vae.eps_shapes``):
    ``eps``, else drawn from ``generator`` on x's device."""
    if eps is not None:
        return eps
    return draw_eps(cfg.model, x.shape[0], generator, x.device)


def make_encode_fn(cfg: Config, model: PianoRollVAE):
    """Posterior encode for seeded continuation: (x [B, num_bars, T, P],
    generator=None, eps=None, chord=None, key_sig=None) → one posterior
    sample mu + eps·exp(logvar/2) a row: {"z0": [B, z]}, or for hier
    {"z_phrase0": [B, z_phrase]} (the phrase latent, the piece identity;
    the sweep draws the per-bar z from the prior). eps ~ N(0, I) of that
    shape, drawn from ``generator`` unless given. cond takes the window's
    labels, chord [B, num_bars] and key_sig [B]."""
    hier = cfg.model.kind == "hier"

    @torch.inference_mode()
    def encode(x: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None,
               chord: Optional[torch.Tensor] = None,
               key_sig: Optional[torch.Tensor] = None) -> dict:
        cond_vec = None
        if cfg.model.kind == "cond":
            cond_vec = model.cond_vector(chord, key_sig)
        mu, logvar = model.encode(x, cond_vec)[:2]
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=x.device)
        return {"z_phrase0" if hier else "z0":
                reparameterize(mu, logvar, eps)}

    return encode


def reconstruct_fn(cfg: Config, model: PianoRollVAE):
    """Reconstruction: (x [B, num_bars, T, P], generator=None, eps=None,
    chord=None, key_sig=None) → encode → posterior sample → teacher-forced
    decode → binarize, as f32 {0,1} [B, num_bars, T, P] (the reference's
    eval-time reconstruct), a tensor of the caller's own. ``eps``: each
    latent level's noise (``vae.eps_shapes``), drawn from ``generator``
    unless given; cond takes the window's labels.

    Each signature (the shapes and dtypes of the given tensors, whether
    the generator draws) has its own static inputs and generator and runs
    as a ``graphs.StaticProgram``, as ``make_generate_fn``'s sweep does:
    one captured CUDA graph on the card from its second call on, the
    caller's generator left where the draw leaves it. Not for two threads
    at once."""
    dev = next(model.parameters()).device
    threshold = cfg.midi.binarize_threshold
    programs: dict = {}

    def body(static, gens):
        x = static["x"]
        eps = None
        if ("eps", 0) in static:
            eps = tuple(v for k, v in static.items()
                        if isinstance(k, tuple))
        logits, _ = model(
            x, _posterior_noise(cfg, x, gens[0] if gens else None, eps),
            chord=static.get("chord"), key_sig=static.get("key_sig"))
        return binarize_logits(logits, threshold, model.pitch_mask)

    @torch.inference_mode()
    def reconstruct(x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    eps=None, chord: Optional[torch.Tensor] = None,
                    key_sig: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        given = {"x": x}
        given.update({("eps", i): e for i, e in enumerate(eps or ())})
        if chord is not None:
            given["chord"] = chord
        if key_sig is not None:
            given["key_sig"] = key_sig
        drawing = ([generator] if generator is not None and eps is None
                   else [])
        key = (len(drawing), graphs.signature(given))
        run = programs.get(key)
        if run is None:
            run = programs[key] = graphs.StaticProgram(body, dev, given,
                                                       len(drawing))
        return run(given, drawing)

    reconstruct.programs = programs
    return reconstruct


def bars_to_midi(bars, cfg: Config) -> bytes:
    """Host-side export of one generated sample: [N,T,P] → SMF bytes."""
    return tensorize.bars_to_midi_bytes(np.asarray(bars), cfg.midi)
