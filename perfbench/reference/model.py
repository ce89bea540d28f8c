"""The plain reference of the measured models: the GRU sequence VAE
(``gru_seq``) and the hierarchical VAE (``hier``) of the piano-roll VAE
family, written as functions of a dict of f32 tensors named as the port's
state dict names its parameters.

A frozen copy of the model math of the repository's torch oracle
(tests/oracle/oracle_model.py), without any import of the measured program
or of the JAX package. It runs eagerly in f32, one op at a time, with no
kernel of the program and no captured graph. Two departures from that
oracle follow the measured program's documented semantics:

- the GRU's hidden r/z biases (``bias_hh[:2H]``) are constants: no gradient
  reaches them (flax's GRU has no such biases; the program keeps them at
  zero and frozen);
- every layer may round its inputs, weights and biases through ``q``, the
  precision under test: the identity for the f32 reference, an fp8 round
  trip for the control that must come out as not correct.

``spec`` is a plain dict of the configuration's model and MIDI keys (the
configuration file's ``model`` and ``midi`` groups).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


E4M3_MAX, E5M2_MAX = 448.0, 57344.0


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 forward and the gradient to float8 e5m2
    backward, each saturating at its largest finite value: the arithmetic
    of fp8 training, emulated in f32."""

    @staticmethod
    def forward(ctx, t):
        return t.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(
            t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-E5M2_MAX, E5M2_MAX).to(torch.float8_e5m2).to(
            g.dtype)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


def gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")


def _halved(n: int, times: int) -> int:
    for _ in range(times):
        n = -(-n // 2)
    return n


def param_shapes(spec: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model, by the port's state-dict name."""
    m = spec["model"]
    t, p = _bar_shape(spec)
    enc, dec = m["enc_channels"], m["dec_channels"]
    shapes: Dict[str, Tuple[int, ...]] = {}

    def dense(name, n_in, n_out):
        shapes[name + ".weight"] = (n_out, n_in)
        shapes[name + ".bias"] = (n_out,)

    def gru(name, n_in, hidden):
        shapes[name + ".weight_ih"] = (3 * hidden, n_in)
        shapes[name + ".weight_hh"] = (3 * hidden, hidden)
        shapes[name + ".bias_ih"] = (3 * hidden,)
        shapes[name + ".bias_hh"] = (3 * hidden,)

    def trunk(name):
        chans = [1, *enc]
        for i in range(len(enc)):
            shapes[f"{name}.convs.{i}.weight"] = (chans[i + 1], chans[i], 3, 3)
            shapes[f"{name}.convs.{i}.bias"] = (chans[i + 1],)
        flat = _halved(t, len(enc)) * _halved(p, len(enc)) * enc[-1]
        dense(name + ".fc", flat, m["bar_feat_dim"])

    h, z, f = m["gru_hidden"], m["z_dim"], m["bar_feat_dim"]
    trunk("prev_feat")
    dense("h_init", z, h)
    gru("dec_gru", z + f, h)
    head_in = h
    if m["kind"] == "hier":
        zp = m["z_phrase_dim"]
        dense("cond_init", zp, h)
        gru("conductor", zp, h)
        head_in = 2 * h
    t0, p0 = -(-t // 2 ** len(dec)), -(-p // 2 ** len(dec))
    dense("head.fc", head_in, t0 * p0 * dec[0])
    chans = [*dec, 1]
    for i in range(len(dec)):
        shapes[f"head.deconvs.{i}.weight"] = (chans[i], chans[i + 1], 3, 3)
        shapes[f"head.deconvs.{i}.bias"] = (chans[i + 1],)
    trunk("enc_feat")
    gru("enc_gru", f, h)
    if m["kind"] == "hier":
        dense("phrase_head", h, 2 * m["z_phrase_dim"])
        dense("bar_head", f + m["z_phrase_dim"], 2 * z)
    else:
        dense("z_head", h, 2 * z)
    return shapes


def _bar_shape(spec: dict) -> Tuple[int, int]:
    midi = spec["midi"]
    steps = midi["bar_steps"] or (midi["steps_per_quarter"]
                                  * midi["quarters_per_bar"])
    return steps, midi["num_pitches"]


def pitch_mask(spec: dict, device=None) -> torch.Tensor:
    midi = spec["midi"]
    mask = torch.zeros(midi["num_pitches"], device=device)
    mask[midi["pitch_lo"]:midi["pitch_hi"]] = 1.0
    return mask


# -- layers -------------------------------------------------------------------

def dense(P: Params, name: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    return F.linear(q(x), q(P[name + ".weight"]), q(P[name + ".bias"]))


def gru(P: Params, name: str, x: torch.Tensor, h: torch.Tensor,
        q: Quant) -> torch.Tensor:
    """r = σ(W_ir x + b_ir + W_hr h + b_hr), z likewise, n = tanh(W_in x +
    b_in + r ⊙ (W_hn h + b_hn)), h' = (1 − z) ⊙ n + z ⊙ h; b_hr and b_hz
    take no gradient."""
    b_hh = P[name + ".bias_hh"]
    rz = 2 * b_hh.shape[0] // 3
    b_hh = torch.cat([b_hh[:rz].detach(), b_hh[rz:]])
    gi = F.linear(q(x), q(P[name + ".weight_ih"]), q(P[name + ".bias_ih"]))
    gh = F.linear(q(h), q(P[name + ".weight_hh"]), q(b_hh))
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def bar_feat(P: Params, name: str, bars: torch.Tensor, n_convs: int,
             q: Quant) -> torch.Tensor:
    """[M,T,P] bars → [M,F]: stride-2 3x3 convs with GELU, the NHWC
    flatten, a dense layer and tanh."""
    h = bars.float()[:, None]
    for i in range(n_convs):
        h = gelu(F.conv2d(q(h), q(P[f"{name}.convs.{i}.weight"]),
                          q(P[f"{name}.convs.{i}.bias"]), stride=2,
                          padding=1))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return torch.tanh(dense(P, name + ".fc", h, q))


def head(P: Params, v: torch.Tensor, spec: dict, q: Quant) -> torch.Tensor:
    """[M,D] → [M,T,P] logits: dense, GELU, the NHWC reshape, stride-2
    transposed convs each cropped to twice its input, GELU between."""
    t, p = _bar_shape(spec)
    dec = spec["model"]["dec_channels"]
    t0, p0 = -(-t // 2 ** len(dec)), -(-p // 2 ** len(dec))
    h = gelu(dense(P, "head.fc", v, q))
    h = h.reshape(-1, t0, p0, dec[0]).permute(0, 3, 1, 2)
    for i in range(len(dec)):
        ht, hp = h.shape[2], h.shape[3]
        h = F.conv_transpose2d(q(h), q(P[f"head.deconvs.{i}.weight"]),
                               q(P[f"head.deconvs.{i}.bias"]),
                               stride=2)[:, :, :2 * ht, :2 * hp]
        if i + 1 < len(dec):
            h = gelu(h)
    return h[:, 0, :t, :p]


def gaussian(P: Params, name: str, x: torch.Tensor, q: Quant):
    mu, lv = dense(P, name, x, q).chunk(2, dim=-1)
    return mu, 8.0 * torch.tanh(lv / 8.0)


# -- the model ------------------------------------------------------------------

def forward(P: Params, x: torch.Tensor, eps: List[torch.Tensor], spec: dict,
            q: Quant = exact):
    """Teacher-forced ELBO forward: x [B,N,T,P] (0/1), eps the noise of
    each latent level ([B,z], or [B,z_phrase] and [B,N,z] for hier) →
    (logits [B,N,T,P], [(mu, logvar) a level])."""
    m = spec["model"]
    b, n, t, p = x.shape
    nc = len(m["enc_channels"])
    xf = x.float()
    f = bar_feat(P, "enc_feat", xf.reshape(b * n, t, p), nc, q)
    f = f.reshape(b, n, -1)
    h = torch.zeros(b, m["gru_hidden"], device=x.device)
    for k in range(n):
        h = gru(P, "enc_gru", f[:, k], h, q)
    if m["kind"] == "hier":
        mu_p, lv_p = gaussian(P, "phrase_head", h, q)
        z_p = mu_p + eps[0] * torch.exp(0.5 * lv_p)
        zp_b = z_p[:, None, :].expand(-1, n, -1)
        mu_b, lv_b = gaussian(P, "bar_head", torch.cat([f, zp_b], -1), q)
        z_bars = mu_b + eps[1] * torch.exp(0.5 * lv_b)
        latents = [(mu_p, lv_p), (mu_b, lv_b)]
    else:
        mu, lv = gaussian(P, "z_head", h, q)
        z = mu + eps[0] * torch.exp(0.5 * lv)
        z_bars = z[:, None, :].expand(-1, n, -1)
        z_p = None
        latents = [(mu, lv)]
    prev = torch.cat([torch.zeros_like(xf[:, :1]), xf[:, :-1]], dim=1)
    feats = bar_feat(P, "prev_feat", prev.reshape(b * n, t, p), nc, q)
    feats = feats.reshape(b, n, -1)
    h = torch.tanh(dense(P, "h_init", z_bars[:, 0], q))
    hc = None
    if z_p is not None:
        hc = torch.tanh(dense(P, "cond_init", z_p, q))
    outs = []
    for k in range(n):
        h = gru(P, "dec_gru", torch.cat([z_bars[:, k], feats[:, k]], -1), h,
                q)
        if hc is None:
            outs.append(h)
        else:
            hc = gru(P, "conductor", z_p, hc, q)
            outs.append(torch.cat([h, hc], -1))
    head_in = torch.stack(outs, dim=1).reshape(b * n, -1)
    return head(P, head_in, spec, q).reshape(b, n, t, p), latents


def elbo(logits, x, latents, beta: float, mask: torch.Tensor):
    """recon + beta · KL, each summed over cells (masked) or latent
    dimensions and averaged over the batch."""
    batch = logits.shape[0]
    bce = F.binary_cross_entropy_with_logits(logits, x.float(),
                                             reduction="none")
    recon = (bce * mask).sum() / batch
    kl = sum(-0.5 * (1.0 + lv - mu.square() - lv.exp()).sum()
             for mu, lv in latents) / batch
    return recon + beta * kl


def beta_at(train: dict, step: int) -> float:
    """The KL weight of step ``step`` (the linear schedule)."""
    if train["beta_schedule"] != "linear":
        raise ValueError("the reference follows the linear KL schedule")
    s = max(step - train["beta_hold_steps"], 0)
    if train["beta_warmup_steps"] <= 0:
        return float(train["beta_max"])
    return min(s / train["beta_warmup_steps"], 1.0) * train["beta_max"]


def decode_step_logits(P: Params, served: torch.Tensor, z_bars: torch.Tensor,
                       reset: List[bool], spec: dict, q: Quant = exact
                       ) -> torch.Tensor:
    """The closed-loop sweep of a gru_seq model teacher-forced on the bars
    it served: served [B,N,T,P] (0/1), z_bars [B,N,z], reset [N] → the
    logits [B,N,T,P] each bar had, given the bars before it (zeros before
    the first) and the recurrent state restarted at every reset bar."""
    m = spec["model"]
    b, n, t, p = served.shape
    nc = len(m["enc_channels"])
    h = None
    out = []
    prev = torch.zeros(b, t, p, device=served.device)
    for k in range(n):
        feat = bar_feat(P, "prev_feat", prev, nc, q)
        if reset[k] or h is None:
            h = torch.tanh(dense(P, "h_init", z_bars[:, k], q))
        h = gru(P, "dec_gru", torch.cat([z_bars[:, k], feat], -1), h, q)
        out.append(head(P, h, spec, q))
        prev = served[:, k].float()
    return torch.stack(out, dim=1)


def fan_in(shape: Tuple[int, ...]) -> int:
    """The fan-in a weight's init is scaled by: the size of one output
    unit's slice (``weight[0]``) for dense, conv and transposed-conv
    layouts alike."""
    return int(math.prod(shape[1:]))


def make_params(shapes: Dict[str, Tuple[int, ...]], seed: int,
                device, scale: Optional[Dict[str, float]] = None,
                bias: Optional[Dict[str, float]] = None) -> Params:
    """Weights from ``seed``, made on ``device`` by one generator in one
    draw: every weight N(0, 1/fan_in), every bias 0. ``scale`` multiplies
    named weights, ``bias`` sets named biases to a value."""
    gen = torch.Generator(device).manual_seed(seed)
    names = [k for k in shapes if len(shapes[k]) > 1]
    total = sum(math.prod(shapes[k]) for k in names)
    flat = torch.randn(total, generator=gen, device=device)
    out: Params = {}
    i = 0
    for k in names:
        n = math.prod(shapes[k])
        std = fan_in(shapes[k]) ** -0.5 * (scale or {}).get(k, 1.0)
        out[k] = flat[i:i + n].view(shapes[k]) * std
        i += n
    for k, shape in shapes.items():
        if len(shape) == 1:
            out[k] = torch.full(shape, (bias or {}).get(k, 0.0),
                                device=device)
    return {k: out[k] for k in shapes}
