"""Building blocks of the VAE family: the parity conv stem and the GRU
cell, the space-to-depth patch stem (``stem="patch"``: ``ConvTrunk`` with
a ``patch``, ``PatchHead``) and the attention core (``temporal="attn"``:
``AttnStack``).

Counterparts of the JAX package's models/layers.py. The parity modules
carry the state-dict names of the torch oracle
(tests/oracle/oracle_model.py), so converted JAX params load with
``strict=True``; the patch stem and the attention core, which have no
oracle, mirror their flax names (checkpoints/convert.py lists them).

Dtypes follow flax's ``dtype``/``param_dtype``: parameters stay f32, and
each layer casts its input, weight and bias to the compute dtype at use;
the latent heads return f32. ``torch.autocast`` is not used: its cast
points differ from flax's. The conv pyramid keeps its activations NHWC
(the JAX package's element order): ops/conv_epilogue.py ``conv_block``
runs each conv on their channels-last NCHW view and, on the card, its
bias, crop and GELU in the epilogue kernels (the decoder head's last,
one-channel layer whole in ops/head_out.py's).

Under tensor parallelism (parallel/tp.py ``shard_params``) a layer whose
weight holds one model rank's output slice computes that slice and
gathers the full output (``column_in``, ``column_out``): the GRU cell its
new hidden state, every dense, conv and transposed conv its output
channels. Each such class declares, as ``column``, the weight layout its
computation takes (``shard_params`` reads it). A replicated layer runs as
it is.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from musicvae_tpu_torch.ops.conv1 import first_conv_s2
from musicvae_tpu_torch.ops.conv_epilogue import conv_block
from musicvae_tpu_torch.parallel.tp import (Layout, column_in, column_out,
                                            shard_of)


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

    column = Layout(0)         # output features

    def __init__(self, in_features: int, out_features: int,
                 dtype: str = "float32"):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype_of(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(column_in(x, self).to(dt), self.weight.to(dt),
                     self.bias.to(dt))
        return column_out(y, -1, self)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` as a parameter holder: ``ConvTrunk`` and ``PatchHead``
    run its op themselves, column-parallel on its output channels."""

    column = Layout(0)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` as a parameter holder: ``_upsample`` runs its
    op, column-parallel on its output channels ([in,out,kh,kw] dim 1)."""

    column = Layout(1)


def space_to_depth(x: torch.Tensor, pt: int, pp: int) -> torch.Tensor:
    """[B,T,P] → [B,T/pt,P/pp,pt·pp]: each (pt × pp) patch folded into
    channels, channel i_t·pp + i_p, the JAX package's order."""
    b, t, p = x.shape
    if t % pt or p % pp:
        raise ValueError(f"patch {(pt, pp)} does not tile a [{t}, {p}] "
                         f"bar (ModelSpec.patch_size must divide "
                         f"steps_per_bar x num_pitches)")
    x = x.reshape(b, t // pt, pt, p // pp, pp).permute(0, 1, 3, 2, 4)
    return x.reshape(b, t // pt, p // pp, pt * pp)


def depth_to_space(x: torch.Tensor, pt: int, pp: int) -> torch.Tensor:
    """The inverse of ``space_to_depth``: [B,t0,p0,pt·pp] → [B,t0·pt,p0·pp]
    (a permuted view where the reshape allows one)."""
    b, t0, p0, _ = x.shape
    x = x.reshape(b, t0, p0, pt, pp).permute(0, 1, 3, 2, 4)
    return x.reshape(b, t0 * pt, p0 * pp)


class ConvTrunk(nn.Module):
    """Conv pyramid over one bar: [B,T,P] → [B,F] (NHWC flatten).

    The parity stem (``patch`` None): stride-2 3x3 convs from one input
    channel. ``first_conv_kernel`` (ModelSpec.use_pallas_conv1) sends the
    first conv, with its GELU, through ops/conv1.py ``first_conv_s2`` on
    96x128 bars; the parameters are the same ``convs.0`` either way.

    The patch stem (``patch`` = (pt, pp), the JAX package's PatchTrunk):
    time zero-padded to whole patches, ``space_to_depth`` to pt·pp
    channels, then a stride-1 conv and stride-2 convs. It has no
    first-conv kernel: the flag is ignored, as the JAX package ignores
    it."""

    def __init__(self, channels: Sequence[int], dtype: str = "bfloat16",
                 first_conv_kernel: bool = False,
                 patch: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.patch = None if patch is None else tuple(patch)
        chans = [1 if patch is None else patch[0] * patch[1], *channels]
        self.convs = nn.ModuleList(
            Conv2d(chans[i], chans[i + 1], 3,
                   stride=1 if patch is not None and i == 0 else 2,
                   padding=1)
            for i in range(len(channels)))
        self.compute_dtype = dtype_of(dtype)
        self.first_conv_kernel = first_conv_kernel and patch is None

    def flat_dim(self, steps: int, pitches: int) -> int:
        n = len(self.convs)
        if self.patch is not None:
            steps, pitches, n = (-(-steps // self.patch[0]),
                                 pitches // self.patch[1], n - 1)
        return (_halved(steps, n) * _halved(pitches, n)
                * self.convs[-1].out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        convs = list(self.convs)
        if self.patch is not None:
            pt, pp = self.patch
            h = x.to(dt)
            if h.shape[1] % pt:     # bar-adapting meters: silent steps
                h = F.pad(h, (0, 0, 0, pt - h.shape[1] % pt))
            h = space_to_depth(h, pt, pp)
        elif self.first_conv_kernel and tuple(x.shape[1:]) == (96, 128):
            c0 = convs.pop(0)
            w = c0.weight[:, 0].permute(1, 2, 0).contiguous()    # [3,3,C]
            h = first_conv_s2(x, w, c0.bias, gelu=True, out_dtype=dt)
            h = column_out(h, -1, c0)
        else:
            h = x.to(dt)[..., None]
        for conv in convs:          # h: NHWC
            h = column_out(conv_block(column_in(h, conv), conv.weight.to(dt),
                                      conv.bias.to(dt), conv.stride,
                                      conv.padding), -1, conv)
        return h.reshape(h.shape[0], -1)


class BarFeat(ConvTrunk):
    """Per-bar feature vector: trunk → dense → tanh. [B,T,P] → [B,F]."""

    def __init__(self, feat_dim: int, channels: Sequence[int],
                 dtype: str = "bfloat16", first_conv_kernel: bool = False,
                 steps: int = 96, pitches: int = 128,
                 patch: Optional[Tuple[int, int]] = None):
        super().__init__(channels, dtype, first_conv_kernel, patch)
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
            ConvTranspose2d(chans[i], chans[i + 1], 3, stride=2, padding=0)
            for i in range(n_up))
        self.compute_dtype = dtype_of(dtype)
        self.logits_dtype = dtype_of(logits_dtype)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.fc(v))
        h = h.reshape(h.shape[0], self.t0, self.p0, -1)
        # the last transposed conv: no GELU, its [T, P] crop of the
        # ceil-padded grid as the logits
        h = _upsample(h, self.deconvs, self.compute_dtype,
                      last=((self.steps, self.pitches), False,
                            self.logits_dtype))
        return h[..., 0].contiguous()   # a view on the CPU


def _upsample(h: torch.Tensor, deconvs, dt: torch.dtype,
              last=None) -> torch.Tensor:
    """The stride-2 transposed convs of a decoder head on NHWC activations,
    each cropped to twice its input with a GELU after it; ``last`` gives
    the last one's (crop, gelu, out_dtype) instead."""
    for i, d in enumerate(deconvs):
        t, p = h.shape[1], h.shape[2]
        crop, gelu, out_dtype = ((2 * t, 2 * p), True, dt) \
            if last is None or i + 1 < len(deconvs) else last
        h = column_out(conv_block(column_in(h, d), d.weight.to(dt),
                                  d.bias.to(dt), d.stride, d.padding, True,
                                  crop, gelu, out_dtype), -1, d)
    return h


class PatchHead(nn.Module):
    """The patch stem's decoder head (the JAX package's PatchHead): dense →
    GELU → [t0,p0,C0] (NHWC order) → stride-2 transposed convs, each with
    GELU → a stride-1 conv to pt·pp channels → ``depth_to_space`` → the
    [T, P] crop of the ceil-padded grid, contiguous. Names: ``fc``,
    ``deconvs.i``, ``out``."""

    def __init__(self, channels: Sequence[int], in_dim: int,
                 patch: Tuple[int, int] = (8, 16), steps: int = 96,
                 pitches: int = 128, dtype: str = "bfloat16",
                 logits_dtype: str = "float32"):
        super().__init__()
        pt, pp = self.patch = tuple(patch)
        n_up = len(channels) - 1
        self.t0 = -(-steps // (pt * 2 ** n_up))
        self.p0 = -(-pitches // (pp * 2 ** n_up))
        self.steps, self.pitches = steps, pitches
        self.fc = Dense(in_dim, self.t0 * self.p0 * channels[0], dtype)
        self.deconvs = nn.ModuleList(
            ConvTranspose2d(channels[i], channels[i + 1], 3, stride=2,
                            padding=0)
            for i in range(n_up))
        self.out = Conv2d(channels[-1], pt * pp, 3, padding=1)
        self.compute_dtype = dtype_of(dtype)
        self.logits_dtype = dtype_of(logits_dtype)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = _gelu(self.fc(v))
        h = h.reshape(h.shape[0], self.t0, self.p0, -1)
        h = _upsample(h, self.deconvs, dt)
        h = conv_block(column_in(h, self.out), self.out.weight.to(dt),
                       self.out.bias.to(dt), self.out.stride,
                       self.out.padding, gelu=False,
                       out_dtype=self.logits_dtype)
        h = depth_to_space(column_out(h, -1, self.out), *self.patch)
        # contiguous: depth_to_space permutes
        return h[:, :self.steps, :self.pitches].contiguous()


def per_slot(fn, slots: int, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over each of ``slots`` equal row blocks of ``xs``, the
    results concatenated: every call sees the shapes a lone slot gives it.
    On the card a row of the attention's batched matmuls (cuBLAS picks
    their kernel by the batch count) and of LayerNorm's row means (torch
    sizes the reduction's blocks by the number of rows) depends on how
    many rows share the call, so coalesced requests run these ops a slot
    at a time to get the bits a lone request gets."""
    if slots == 1:
        return fn(*xs)
    return torch.cat([fn(*part) for part in zip(*(x.chunk(slots)
                                                   for x in xs))])


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: statistics in f32 whatever
    the input dtype, the variance as E[x²] − E[x]² (flax's
    ``use_fast_variance``) clipped at 0, epsilon 1e-6, scale and bias in
    f32, the result cast to the compute dtype. Names: ``weight`` (flax's
    ``scale``) and ``bias``."""

    def __init__(self, features: int, dtype: str = "bfloat16"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = dtype_of(dtype)

    def forward(self, x: torch.Tensor, slots: int = 1) -> torch.Tensor:
        """``slots`` > 1: the row means a slot at a time (``per_slot``)."""
        xf = x.float()
        mean = per_slot(_row_mean, slots, xf)
        var = (per_slot(_row_mean, slots, xf * xf)
               - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + 1e-6) * self.weight) + self.bias
        return y.to(self.compute_dtype)


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(-1, keepdim=True)


KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqhd,bkhd->bhqk", q, k)


def _weighted(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class AttnStack(nn.Module):
    """Pre-LN transformer over the bar axis, the attention temporal core
    (the JAX package's AttnStack). Two entry points share one set of
    weights and one ``_attend``:

    - ``forward(u)``: [B,N,D] → [B,N,H], every bar at once; causal for the
      decoder, bidirectional for the encoder;
    - ``step(cache, u, pos, start)``: one bar. K and V are written into
      ``cache`` (``attn_cache``) at ``pos``, and the query attends to
      positions [start, pos] of its row: a reset bar starts a new segment
      (start = pos), with positions counted from the segment's start.

    Scores and softmax are f32 whatever the compute dtype, masked with
    -1e30, and the weights are cast to the compute dtype before they
    meet V, as in the JAX package. Names mirror flax's: ``inp``,
    ``pos_emb``, ``ln1.l``, ``ln2.l``, ``qkv.l``, ``wo.l``, ``mlp_up.l``,
    ``mlp_dn.l``, ``ln_f``."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 2,
                 heads: int = 4, max_len: int = 128, causal: bool = True,
                 dtype: str = "bfloat16"):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"attn hidden {hidden} not divisible by "
                             f"{heads} heads")
        self.hidden, self.heads, self.max_len = hidden, heads, max_len
        self.causal = causal
        self.compute_dtype = dtype_of(dtype)

        def layer(make):
            return nn.ModuleList(make() for _ in range(num_layers))

        self.inp = Dense(in_dim, hidden, dtype)
        self.pos_emb = nn.Parameter(torch.zeros(max_len, hidden))
        self.ln1 = layer(lambda: LayerNorm(hidden, dtype))
        self.ln2 = layer(lambda: LayerNorm(hidden, dtype))
        self.qkv = layer(lambda: Dense(hidden, 3 * hidden, dtype))
        self.wo = layer(lambda: Dense(hidden, hidden, dtype))
        self.mlp_up = layer(lambda: Dense(hidden, 4 * hidden, dtype))
        self.mlp_dn = layer(lambda: Dense(4 * hidden, hidden, dtype))
        self.ln_f = LayerNorm(hidden, dtype)

    def reset_parameters(self) -> None:
        """flax's ``normal(0.02)`` position table (untruncated)."""
        nn.init.normal_(self.pos_emb, std=0.02)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.heads, self.hidden // self.heads)

    def _attend(self, q, k, v, mask, slots: int = 1) -> torch.Tensor:
        """q [B,Q,h,d], k and v [B,K,h,d], mask broadcast to [B,h,Q,K] →
        [B,Q,h,d]. f32 operands for QKᵀ: a bf16 matmul would round the
        scores to bf16. ``slots`` > 1: the two batched matmuls a slot at
        a time (``per_slot``)."""
        scores = per_slot(_scores, slots, q.float(), k.float())
        scores = scores * (1.0 / (self.hidden // self.heads) ** 0.5)
        w = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
        return per_slot(_weighted, slots, w.to(self.compute_dtype), v)

    def _block(self, l: int, h: torch.Tensor, q, k, v, mask,
               slots: int = 1) -> torch.Tensor:
        """The rest of layer ``l`` once its attention inputs are known:
        the output projection and its residual, then the MLP's."""
        o = self._attend(self._heads(q), self._heads(k), self._heads(v),
                         mask, slots)
        h = h + self.wo[l](o.reshape(*h.shape[:-1], self.hidden))
        return h + self.mlp_dn[l](_gelu(self.mlp_up[l](
            self.ln2[l](h, slots))))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        n = u.shape[1]
        if n > self.max_len:
            raise ValueError(
                f"sequence of {n} bars exceeds attn_max_bars="
                f"{self.max_len}; raise ModelSpec.attn_max_bars (the "
                "learned position table) for longer windows/sweeps")
        dt = self.compute_dtype
        h = self.inp(u) + self.pos_emb[:n].to(dt)
        mask = torch.ones(n, n, dtype=torch.bool, device=u.device)
        if self.causal:
            mask = mask.tril()
        for l in range(len(self.qkv)):
            q, k, v = self.qkv[l](self.ln1[l](h)).chunk(3, dim=-1)
            h = self._block(l, h, q, k, v, mask)
        return self.ln_f(h)

    def step(self, cache: KVCache, u: torch.Tensor, pos: int,
             start: torch.Tensor, slots: int = 1) -> torch.Tensor:
        """One bar: u [B,D], ``pos`` the bar's index in the sweep, start
        [B] (int64) the first position of each row's segment → [B,H]. The
        cache's tensors are written in place. ``slots`` > 1: the batch is
        that many equal slots of coalesced requests, and each slot's rows
        come out as a sweep of that slot alone computes them
        (``per_slot``)."""
        dt = self.compute_dtype
        h = self.inp(u) + self.pos_emb[pos - start].to(dt)
        idx = torch.arange(cache[0][0].shape[1], device=u.device)
        mask = ((idx[None] >= start[:, None])
                & (idx[None] <= pos))[:, None, None, :]
        for l, (kc, vc) in enumerate(cache):
            q, k, v = self.qkv[l](self.ln1[l](h, slots)).chunk(3, dim=-1)
            kc[:, pos] = k
            vc[:, pos] = v
            h = self._block(l, h[:, None], q[:, None], kc, vc, mask,
                            slots)[:, 0]
        return self.ln_f(h, slots)


def attn_cache(batch: int, length: int, num_layers: int, hidden: int,
               dtype: torch.dtype, device=None) -> KVCache:
    """A zeroed (K, V) pair a layer, [B, length, H] each, for a
    ``length``-bar sweep of ``AttnStack.step``."""
    return [(torch.zeros(batch, length, hidden, dtype=dtype, device=device),
             torch.zeros(batch, length, hidden, dtype=dtype, device=device))
            for _ in range(num_layers)]


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
    move it twice as fast under Adam).

    Sharded over a model axis, each rank holds rows g·H + [r·H/M,
    (r+1)·H/M) of every gate g, computes those units of h' and gathers
    h' once a step."""

    column = Layout(0, 3)      # the hidden units of every gate

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
        h = column_in(h.to(dt), self)
        gi = F.linear(column_in(x, self).to(dt), self.weight_ih.to(dt),
                      self.bias_ih.to(dt))
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
        shard = shard_of(self)
        if shard is not None:     # this rank's units of h
            h = h.narrow(-1, shard.rank * n.shape[-1], n.shape[-1])
        return column_out((1.0 - z) * n + z * h, -1, self)
