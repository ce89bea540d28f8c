"""Frozen configuration dataclasses and the registered configs.

The port's own copy of the JAX package's vocabulary: every field, default
and registered config is the same, so a config (or a checkpoint's embedded
config) means the same model in both packages. The tests hold
``dataclasses.asdict`` of every registered config equal across the two.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MidiSpec:
    """Piano-roll tensorization semantics (musicvae_tpu/midi/SEMANTICS.md)."""

    steps_per_quarter: int = 24          # grid resolution
    quarters_per_bar: int = 4            # whole quarters per bar (0 when
    #                                      the meter isn't a whole number
    #                                      of quarters — see bar_steps)
    # The bar TENSOR length in grid steps; 0 derives it as
    # steps_per_quarter * quarters_per_bar (96 on the 4/4 default).
    bar_steps: int = 0
    # The DECLARED meter, written into exports; 0/0 falls back to
    # quarters_per_bar/4. Use the ``meter`` property.
    meter_numerator: int = 0
    meter_denominator: int = 0
    num_pitches: int = 128               # full MIDI pitch axis
    pitch_lo: int = 0                    # crop [lo, hi) — loss-masked region
    pitch_hi: int = 128
    binarize_threshold: float = 0.5      # generation-time threshold
    velocity: int = 100                  # writer: velocity for emitted notes
    tempo_bpm: float = 120.0             # writer: fixed tempo
    max_events: int = 4096               # ingestion cap: notes per file
    ignore_time_signature: bool = False  # force config-meter chunking

    @property
    def steps_per_bar(self) -> int:
        return self.bar_steps or \
            self.steps_per_quarter * self.quarters_per_bar  # 96 on 4/4

    @property
    def meter(self) -> Tuple[int, int]:
        """The declared time signature (numerator, denominator)."""
        if self.meter_numerator > 0 and self.meter_denominator > 0:
            return (self.meter_numerator, self.meter_denominator)
        return (self.quarters_per_bar, 4)

    @property
    def cropped_pitches(self) -> int:
        return self.pitch_hi - self.pitch_lo


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture hyperparameters shared across the VAE family."""

    kind: str = "conv_bar"               # conv_bar | gru_seq | hier | cond
    z_dim: int = 64                      # bar-level latent
    z_phrase_dim: int = 256              # phrase-level latent (hier only)
    enc_channels: Tuple[int, ...] = (16, 32, 64, 128, 128)
    dec_channels: Tuple[int, ...] = (128, 128, 64, 32, 16)
    # "conv": the parity pyramid. "patch": the space-to-depth stem and
    # head over patch_size patches (models/layers.py), enc_channels the
    # patch stack's widths (first conv stride 1) and dec_channels the
    # head's.
    stem: str = "conv"
    patch_size: Tuple[int, int] = (8, 16)
    bar_feat_dim: int = 256              # per-bar feature vector (GRU input)
    gru_hidden: int = 256                # temporal core / conductor width
    # Temporal core over the bar axis: "gru", or "attn" (a pre-LN
    # transformer, causal in the decoder; hier then has no conductor).
    temporal: str = "gru"
    attn_layers: int = 2                 # transformer depth (temporal="attn")
    attn_heads: int = 4                  # attention heads
    attn_max_bars: int = 128             # learned-position table length
    num_bars: int = 1                    # bars per training example
    cond_chord_classes: int = 24         # 12 roots x {maj, min}
    cond_key_classes: int = 24
    cond_embed_dim: int = 16
    use_prev_bar: bool = True            # decoder conditions on previous bar
    dtype: str = "bfloat16"              # compute dtype (params stay fp32)
    logits_dtype: str = "float32"        # decoder-head logits dtype
    # First encoder conv through the hand-written kernel (the port's
    # ops/conv1.py; in the JAX package, ops/conv1_pallas.py). The
    # checkpoint layout is the same either way.
    use_pallas_conv1: bool = False


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    batch_size: int = 16
    learning_rate: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_mu_dtype: str = "float32"       # dtype of Adam's first moment
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0          # 0 disables
    # KL annealing: "linear" ramps 0 -> beta_max over warmup steps after
    # beta_hold_steps at 0; "cyclical" repeats the ramp every
    # beta_cycle_steps.
    beta_schedule: str = "linear"
    beta_max: float = 1.0
    beta_warmup_steps: int = 2000
    beta_hold_steps: int = 0
    beta_cycle_steps: int = 0
    free_bits: float = 0.0               # per-dimension KL floor, 0 = off
    lr_schedule: str = "constant"        # "constant" | "cosine"
    lr_warmup_steps: int = 0
    lr_min_ratio: float = 0.0
    ema_decay: float = 0.0               # 0 disables EMA weights
    num_steps: int = 10000
    log_every: int = 100
    ckpt_every: int = 1000
    ckpt_keep: int = 3
    eval_every: int = 0                  # 0 disables periodic eval
    eval_batches: int = 4
    holdout_frac: float = 0.1
    seed: int = 0
    transpose_aug: int = 0               # pitch-shift augmentation, 0 = off
    corpus_layout: str = "replicated"    # "replicated" | "sharded"
    remat_encoder: bool = False          # recompute encoder activations
    use_pallas_loss: bool = True         # fused masked-BCE kernel in training


@dataclasses.dataclass(frozen=True)
class GenSpec:
    num_bars: int = 4                    # autoregressive generation length
    num_samples: int = 1                 # batched sweep width
    interpolate: bool = False            # slerp z_a -> z_b over num_bars
    temperature: float = 1.0             # latent-space z scale
    # "threshold" = deterministic binarize at midi.binarize_threshold;
    # "bernoulli" = per-cell Bernoulli(sigmoid(logits/sample_temperature))
    sample_mode: str = "threshold"
    sample_temperature: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Device-mesh axes: data = batch sharding, model = tensor-parallel."""

    data: int = 1
    model: int = 1

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("data", "model")


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "c1_conv_bar"
    midi: MidiSpec = dataclasses.field(default_factory=MidiSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    train: TrainSpec = dataclasses.field(default_factory=TrainSpec)
    gen: GenSpec = dataclasses.field(default_factory=GenSpec)
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# C1: single-bar piano-roll conv VAE, batch 16, f32
C1_CONV_BAR = Config(
    name="c1_conv_bar",
    model=ModelSpec(kind="conv_bar", num_bars=1, use_prev_bar=False,
                    dtype="float32"),
    train=TrainSpec(batch_size=16),
)

# C2: 4-bar GRU sequence VAE with KL annealing, batch 64 — the port's
# main path
C2_GRU_4BAR = Config(
    name="c2_gru_4bar",
    model=ModelSpec(kind="gru_seq", num_bars=4, z_dim=128),
    train=TrainSpec(batch_size=64, beta_warmup_steps=4000),
)

# C3: hierarchical bar→phrase VAE, 16-bar context, batch 128
C3_HIER_16BAR = Config(
    name="c3_hier_16bar",
    model=ModelSpec(kind="hier", num_bars=16, z_dim=64, z_phrase_dim=256),
    train=TrainSpec(batch_size=128, remat_encoder=False),
)

# C4: chord/key-conditional VAE, batch 256 over 8 data shards
C4_COND = Config(
    name="c4_cond",
    model=ModelSpec(kind="cond", num_bars=4, z_dim=128),
    train=TrainSpec(batch_size=256),
    mesh=MeshSpec(data=8),
)

# C5: 64-bar generation with latent interpolation, 1024-sample sweep
C5_GEN_SWEEP = Config(
    name="c5_gen_sweep",
    model=ModelSpec(kind="gru_seq", num_bars=4, z_dim=128),
    gen=GenSpec(num_bars=64, num_samples=1024, interpolate=True),
    mesh=MeshSpec(data=8),
)

# C2 restricted to the 84-key playing range [24, 108): the crop is a
# loss/generation mask, rolls stay 128 wide
C2_CROPPED = Config(
    name="c2_cropped",
    midi=MidiSpec(pitch_lo=24, pitch_hi=108),
    model=ModelSpec(kind="gru_seq", num_bars=4, z_dim=128),
    train=TrainSpec(batch_size=64, beta_warmup_steps=4000),
)

# The patch-stem variant of C2 (space-to-depth stem and head, wide
# channels), with the KL floor and transpose augmentation on
C2_MXU = Config(
    name="c2_mxu",
    model=ModelSpec(kind="gru_seq", num_bars=4, z_dim=128,
                    stem="patch", patch_size=(8, 16),
                    enc_channels=(256, 256, 512),
                    dec_channels=(512, 256, 256),
                    bar_feat_dim=256, gru_hidden=512),
    train=TrainSpec(batch_size=64, beta_warmup_steps=4000,
                    free_bits=0.125, transpose_aug=5),
)

# c2_mxu with the attention temporal core and transformer training
# hygiene (grad clip, lr warmup, cosine decay)
C2_TRF = Config(
    name="c2_trf",
    model=ModelSpec(kind="gru_seq", num_bars=4, z_dim=128,
                    stem="patch", patch_size=(8, 16),
                    enc_channels=(256, 256, 512),
                    dec_channels=(512, 256, 256),
                    bar_feat_dim=256, gru_hidden=512,
                    temporal="attn", attn_layers=2, attn_heads=8),
    train=TrainSpec(batch_size=64, beta_warmup_steps=4000,
                    free_bits=0.125, transpose_aug=5,
                    grad_clip_norm=1.0, lr_schedule="cosine",
                    lr_warmup_steps=1000, lr_min_ratio=0.1),
)

# The patch stem under the C3 hierarchical architecture
C3_MXU = Config(
    name="c3_mxu",
    model=ModelSpec(kind="hier", num_bars=16, z_dim=64, z_phrase_dim=256,
                    stem="patch", patch_size=(8, 16),
                    enc_channels=(256, 256, 512),
                    dec_channels=(512, 256, 256),
                    bar_feat_dim=256, gru_hidden=512),
    train=TrainSpec(batch_size=128, free_bits=0.125, transpose_aug=5),
)

# hier + attention core; the lr stays constant after warmup
# (lr_min_ratio=1.0), unlike the flat attention configs
C3_TRF = Config(
    name="c3_trf",
    model=ModelSpec(kind="hier", num_bars=16, z_dim=64, z_phrase_dim=256,
                    stem="patch", patch_size=(8, 16),
                    enc_channels=(256, 256, 512),
                    dec_channels=(512, 256, 256),
                    bar_feat_dim=256, gru_hidden=512,
                    temporal="attn", attn_layers=2, attn_heads=8),
    train=TrainSpec(batch_size=128, free_bits=0.125, transpose_aug=5,
                    grad_clip_norm=1.0, lr_schedule="cosine",
                    lr_warmup_steps=1000, lr_min_ratio=1.0),
)

# The long-context pair: c2_mxu / c2_trf at 16- and 32-bar windows, at a
# constant 512 bar-images per step
C2_MXU_16BAR = C2_MXU.replace(
    name="c2_mxu_16bar",
    model=dataclasses.replace(C2_MXU.model, num_bars=16),
    train=dataclasses.replace(C2_MXU.train, batch_size=32),
)
C2_TRF_16BAR = C2_TRF.replace(
    name="c2_trf_16bar",
    model=dataclasses.replace(C2_TRF.model, num_bars=16),
    train=dataclasses.replace(C2_TRF.train, batch_size=32),
)
C2_MXU_32BAR = C2_MXU.replace(
    name="c2_mxu_32bar",
    model=dataclasses.replace(C2_MXU.model, num_bars=32),
    train=dataclasses.replace(C2_MXU.train, batch_size=16),
)
C2_TRF_32BAR = C2_TRF.replace(
    name="c2_trf_32bar",
    model=dataclasses.replace(C2_TRF.model, num_bars=32),
    train=dataclasses.replace(C2_TRF.train, batch_size=16),
)

# c2_mxu with its patch stack collapsed into two 512-wide layers
C2_MXU_WIDE = C2_MXU.replace(
    name="c2_mxu_wide",
    model=dataclasses.replace(C2_MXU.model,
                              enc_channels=(512, 512),
                              dec_channels=(512, 512)),
)

_CONFIGS = {c.name: c for c in
            (C1_CONV_BAR, C2_GRU_4BAR, C3_HIER_16BAR, C4_COND, C5_GEN_SWEEP,
             C2_CROPPED, C2_MXU, C2_TRF, C3_MXU, C3_TRF,
             C2_MXU_16BAR, C2_TRF_16BAR, C2_MXU_32BAR, C2_TRF_32BAR,
             C2_MXU_WIDE)}


# native grid resolution: 24 steps/quarter = 96 steps/whole-note — the
# 4/4 default bar, and the resolution bar-adapting meters keep
_NATIVE_SPQ = 24


def meter_grid(numerator: int, denominator: int,
               steps_per_bar: int = 96) -> dict:
    """MidiSpec overrides realizing the meter ``numerator/denominator``
    (keys: steps_per_quarter, quarters_per_bar, bar_steps,
    meter_numerator, meter_denominator). SEMANTICS.md §1.

    Shape-preserving when possible: a meter spanning a whole number of
    quarters that divides ``steps_per_bar`` keeps the bar TENSOR at
    ``steps_per_bar`` steps and adapts the grid RESOLUTION instead —
    3/4 → three 32-step quarters per 96-step bar.

    Otherwise the BAR LENGTH adapts at the native 24-step/quarter
    resolution: 5/4 → 120-step bars (24 × 5 quarters), 7/8 → 84-step bars
    (bar_steps override; 3.5 quarters is not a whole number, so
    quarters_per_bar is 0 and exports/validation go through the meter
    fields). Raises ValueError only for meters the integer grid cannot
    represent (denominator not a power of two, or bar length not a whole
    number of steps)."""
    if numerator <= 0 or denominator <= 0 or \
            denominator & (denominator - 1):
        raise ValueError(f"bad meter {numerator}/{denominator} "
                         "(denominator must be a power of two)")
    if (4 * numerator) % denominator == 0:
        qpb = 4 * numerator // denominator
        if steps_per_bar % qpb == 0:
            # shape-preserving: resolution adapts, bar stays
            return dict(steps_per_quarter=steps_per_bar // qpb,
                        quarters_per_bar=qpb, bar_steps=0,
                        meter_numerator=numerator,
                        meter_denominator=denominator)
        # whole quarters that don't divide the default bar (5/4, 7/4):
        # bar adapts at native resolution — 5/4 → 24 × 5 = 120 steps
        return dict(steps_per_quarter=_NATIVE_SPQ, quarters_per_bar=qpb,
                    bar_steps=0, meter_numerator=numerator,
                    meter_denominator=denominator)
    # fractional quarters (7/8 = 3.5): bar = 4·spq·num/den grid steps
    spb4 = 4 * _NATIVE_SPQ * numerator
    if spb4 % denominator:
        raise ValueError(
            f"meter {numerator}/{denominator} is "
            f"{spb4 / denominator:g} grid steps per bar at "
            f"{_NATIVE_SPQ} steps/quarter — not a whole number; "
            f"unsupported")
    return dict(steps_per_quarter=_NATIVE_SPQ, quarters_per_bar=0,
                bar_steps=spb4 // denominator,
                meter_numerator=numerator, meter_denominator=denominator)


def get_config(name: str) -> Config:
    """Look up a registered config by name."""
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(_CONFIGS)}") from None


def all_config_names() -> Tuple[str, ...]:
    return tuple(sorted(_CONFIGS))
