"""Building blocks of the parity (``stem="conv"``, ``temporal="gru"``) VAEs.

Counterparts of the JAX package's models/layers.py, with the state-dict
names of the torch oracle (tests/oracle/oracle_model.py), so converted JAX
params load with ``strict=True``.

Dtypes follow flax's ``dtype``/``param_dtype``: parameters stay f32, and
each layer casts its input, weight and bias to the compute dtype at use;
the latent heads return f32. ``torch.autocast`` is not used: its cast
points differ from flax's. Convs compute in NCHW but every flatten and
reshape keeps the JAX package's NHWC element order.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from musicvae_tpu_torch.ops.conv1 import first_conv_s2


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")    # == flax nn.gelu's default


def _halved(n: int, times: int) -> int:
    """Size after ``times`` stride-2 pad-1 3x3 convs: ceil-halving."""
    for _ in range(times):
        n = -(-n // 2)
    return n


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s dtype semantics."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: str = "float32"):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype_of(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvTrunk(nn.Module):
    """Stride-2 conv pyramid over one bar: [B,T,P] → [B,F] (NHWC flatten).

    ``first_conv_kernel`` (ModelSpec.use_pallas_conv1) sends the first
    conv, with its GELU, through ops/conv1.py ``first_conv_s2`` on 96x128
    bars; the parameters are the same ``convs.0`` either way."""

    def __init__(self, channels: Sequence[int], dtype: str = "bfloat16",
                 first_conv_kernel: bool = False):
        super().__init__()
        chans = [1, *channels]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1)
            for i in range(len(channels)))
        self.compute_dtype = dtype_of(dtype)
        self.first_conv_kernel = first_conv_kernel

    def flat_dim(self, steps: int, pitches: int) -> int:
        n = len(self.convs)
        return (_halved(steps, n) * _halved(pitches, n)
                * self.convs[-1].out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        convs = list(self.convs)
        if self.first_conv_kernel and tuple(x.shape[1:]) == (96, 128):
            c0 = convs.pop(0)
            w = c0.weight[:, 0].permute(1, 2, 0).contiguous()    # [3,3,C]
            h = first_conv_s2(x, w, c0.bias, gelu=True, out_dtype=dt)
            h = h.permute(0, 3, 1, 2)                    # NHWC → NCHW view
        else:
            h = x.to(dt)[:, None]
        for conv in convs:
            h = _gelu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt),
                               stride=2, padding=1))
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class BarFeat(ConvTrunk):
    """Per-bar feature vector: trunk → dense → tanh. [B,T,P] → [B,F]."""

    def __init__(self, feat_dim: int, channels: Sequence[int],
                 dtype: str = "bfloat16", first_conv_kernel: bool = False,
                 steps: int = 96, pitches: int = 128):
        super().__init__(channels, dtype, first_conv_kernel)
        self.fc = Dense(self.flat_dim(steps, pitches), feat_dim, dtype)

    def forward(self, bar: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.fc(super().forward(bar)))


class Embed(nn.Embedding):
    """Class-id embedding (the cond kind's chord and key tables), f32 like
    flax ``nn.Embed`` with ``param_dtype=float32``, drawn as flax's
    default embedding initializer draws: a plain normal of variance
    1/features (``variance_scaling(1, "fan_in", "normal", out_axis=0)``)."""

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, std=self.embedding_dim ** -0.5)


class GaussianHead(Dense):
    """Dense → (mu, logvar) in f32, logvar soft-clamped to 8·tanh(lv/8)."""

    def __init__(self, in_features: int, z_dim: int,
                 dtype: str = "bfloat16"):
        super().__init__(in_features, 2 * z_dim, dtype)

    def forward(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, logvar = super().forward(h).float().chunk(2, dim=-1)
        return mu, 8.0 * torch.tanh(logvar / 8.0)


class BarDecoderHead(nn.Module):
    """Vector → single-bar logits: dense → [t0,p0,c0] (NHWC order) → stride-2
    transposed convs with GELU between → 1-channel [B,T,P] logits.

    Each ConvTranspose2d runs with ``padding=0`` and is cropped to twice its
    input, which aligns with flax's SAME-padded transposed conv; the last
    crop takes [T, P] of the ceil-padded grid."""

    def __init__(self, channels: Sequence[int], in_dim: int,
                 steps: int = 96, pitches: int = 128,
                 dtype: str = "bfloat16", logits_dtype: str = "float32"):
        super().__init__()
        n_up = len(channels)
        self.t0 = -(-steps // 2 ** n_up)
        self.p0 = -(-pitches // 2 ** n_up)
        self.steps, self.pitches = steps, pitches
        self.fc = Dense(in_dim, self.t0 * self.p0 * channels[0], dtype)
        chans = [*channels, 1]
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(chans[i], chans[i + 1], 3, stride=2, padding=0)
            for i in range(n_up))
        self.compute_dtype = dtype_of(dtype)
        self.logits_dtype = dtype_of(logits_dtype)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = _gelu(self.fc(v))
        h = h.reshape(h.shape[0], self.t0, self.p0, -1).permute(0, 3, 1, 2)
        for i, d in enumerate(self.deconvs):
            t, p = h.shape[2], h.shape[3]
            h = F.conv_transpose2d(h, d.weight.to(dt), d.bias.to(dt),
                                   stride=2)[:, :, :2 * t, :2 * p]
            if i + 1 < len(self.deconvs):
                h = _gelu(h)
        # contiguous: the crop is a view when no cast copies it (f32)
        return h[:, 0, :self.steps, :self.pitches].to(
            self.logits_dtype).contiguous()


class GRUCell(nn.Module):
    """GRU cell with flax ``nn.GRUCell``'s equations and torch
    ``nn.GRUCell``'s parameter names and layout ([r; z; n] stacked):

        r = σ(W_ir x + b_ir + W_hr h + b_hr)
        z = σ(W_iz x + b_iz + W_hz h + b_hz)
        n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn))
        h' = (1 − z) ⊙ n + z ⊙ h

    Flax has no b_hr/b_hz; a converted checkpoint holds them as zeros with
    flax's r/z biases folded into b_ir/b_iz. They are constants here too:
    no gradient reaches them, so training moves b_ir/b_iz alone, as it
    moves flax's single r/z biases (two trained copies of one bias would
    move it twice as fast under Adam)."""

    def __init__(self, input_size: int, hidden: int,
                 dtype: str = "bfloat16"):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden))
        self.compute_dtype = dtype_of(dtype)
        bound = 1.0 / math.sqrt(hidden)     # torch nn.GRUCell's init
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = h.to(dt)
        gi = F.linear(x.to(dt), self.weight_ih.to(dt), self.bias_ih.to(dt))
        bias_hh = self.bias_hh
        if torch.is_grad_enabled() and bias_hh.requires_grad:
            rz = 2 * bias_hh.shape[0] // 3
            bias_hh = torch.cat([bias_hh[:rz].detach(), bias_hh[rz:]])
        gh = F.linear(h, self.weight_hh.to(dt), bias_hh.to(dt))
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h
