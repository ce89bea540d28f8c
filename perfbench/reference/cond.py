"""The plain reference of the chord/key-conditional VAE (``cond``) of the
piano-roll VAE family, and its first train steps, built from
reference/model.py's layers and reference/train.py's batches and noise.

A cond model is the GRU sequence VAE (``gru_seq``) with two embedding
tables, ``chord_emb`` [chord classes, E] and ``key_emb`` [key classes,
E]: a window's conditioning vector is its chord's row and its key's row
side by side (2·E a bar), and it joins each bar's input to the encoder
GRU, each bar's input to the decoder GRU (after the latent and the
previous bar's features) and each bar's input to the head (after the
decoder GRU's output). It runs eagerly in f32, one op at a time, with no
kernel of the program, no captured graph and no import of the program or
of the JAX package. The departures from the frozen oracle's model math
are reference/model.py's, which follow the program's documented
semantics:

- the GRUs' hidden r/z biases (``bias_hh[:2H]``) are constants: no
  gradient reaches them;
- every layer may round its inputs, weights and biases through ``q``,
  the precision under test (the embedding tables too);
- the tables are f32 parameters like the others, drawn N(0, 1/E) as
  ``make_params`` draws any weight (fan-in E, as the program's ``Embed``
  draws them).

The parameters are named, and ordered, as the program's state dict
orders them (the decoder's, then the encoder's, then the two tables).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

Params = ref.Params


def gru_seq_spec(spec: dict) -> dict:
    """``spec`` as the GRU sequence VAE that a cond model extends."""
    return dict(spec, model=dict(spec["model"], kind="gru_seq"))


def param_shapes(spec: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of a cond model, by the program's state-dict name:
    the GRU sequence VAE's with the conditioning vector's columns added to
    the two GRUs' input weights and the head's dense layer, then the two
    tables."""
    m = spec["model"]
    e, c = m["cond_embed_dim"], 2 * m["cond_embed_dim"]
    shapes = ref.param_shapes(gru_seq_spec(spec))
    for name in ("enc_gru", "dec_gru"):
        rows, cols = shapes[name + ".weight_ih"]
        shapes[name + ".weight_ih"] = (rows, cols + c)
    rows, cols = shapes["head.fc.weight"]
    shapes["head.fc.weight"] = (rows, cols + c)
    shapes["chord_emb.weight"] = (m["cond_chord_classes"], e)
    shapes["key_emb.weight"] = (m["cond_key_classes"], e)
    return shapes


def cond_vector(P: Params, chord: torch.Tensor, key: torch.Tensor,
                q: ref.Quant) -> torch.Tensor:
    """[B,N] chord ids and [B] key ids → [B,N,2E]."""
    ce = F.embedding(chord.long(), q(P["chord_emb.weight"]))
    ke = F.embedding(key.long(), q(P["key_emb.weight"]))
    return torch.cat([ce, ke[:, None, :].expand(-1, ce.shape[1], -1)], -1)


def forward(P: Params, x: torch.Tensor, eps: List[torch.Tensor],
            chord: torch.Tensor, key: torch.Tensor, spec: dict,
            q: ref.Quant = ref.exact):
    """Teacher-forced ELBO forward: x [B,N,T,P] (0/1), eps [[B,z]], chord
    [B,N], key [B] → (logits [B,N,T,P], [(mu, logvar)])."""
    m = spec["model"]
    b, n, t, p = x.shape
    nc = len(m["enc_channels"])
    xf = x.float()
    cv = cond_vector(P, chord, key, q)
    f = ref.bar_feat(P, "enc_feat", xf.reshape(b * n, t, p), nc, q)
    f = torch.cat([f.reshape(b, n, -1), cv], -1)
    h = torch.zeros(b, m["gru_hidden"], device=x.device)
    for k in range(n):
        h = ref.gru(P, "enc_gru", f[:, k], h, q)
    mu, lv = ref.gaussian(P, "z_head", h, q)
    z = mu + eps[0] * torch.exp(0.5 * lv)
    prev = torch.cat([torch.zeros_like(xf[:, :1]), xf[:, :-1]], dim=1)
    feats = ref.bar_feat(P, "prev_feat", prev.reshape(b * n, t, p), nc, q)
    feats = feats.reshape(b, n, -1)
    h = torch.tanh(ref.dense(P, "h_init", z, q))
    outs = []
    for k in range(n):
        h = ref.gru(P, "dec_gru", torch.cat([z, feats[:, k], cv[:, k]], -1),
                    h, q)
        outs.append(torch.cat([h, cv[:, k]], -1))
    head_in = torch.stack(outs, dim=1).reshape(b * n, -1)
    return ref.head(P, head_in, spec, q).reshape(b, n, t, p), [(mu, lv)]


def gather(bars: np.ndarray, starts: np.ndarray, chords: np.ndarray,
           keys: np.ndarray, ids: np.ndarray, num_bars: int):
    """(x [B,N,T,P], chord [B,N], key [B]) of windows ``ids``: a window's
    chord class over each of its bars, and its key."""
    x = ref_train.gather(bars, starts, ids, num_bars)
    chord = np.repeat(chords[ids][:, None], num_bars, axis=1)
    return x, chord, keys[ids]


def run_steps(spec: dict, params: Params, batches, noise_seed: int, device,
              q=ref.exact, rows=None) -> Dict[str, object]:
    """The first len(batches) steps from ``params`` (not changed), each
    batch an (x, chord, key) triple: each step's loss, the first step's
    gradients and the parameters after the last step, as
    reference/train.py ``run_steps`` gives them for the other kinds (the
    noise drawn for the whole batch from a generator seeded
    ``noise_seed``, optax's Adam at a constant rate). ``rows`` (a slice)
    keeps only those rows of each batch in the loss: a planted fault."""
    t = spec["train"]
    if t["lr_schedule"] != "constant" or t["grad_clip_norm"] > 0 \
            or t["weight_decay"] > 0 or t["free_bits"] > 0 \
            or t["transpose_aug"] or t["ema_decay"] > 0:
        raise ValueError("the reference follows constant-lr Adam without "
                         "clip, decay, free bits, augmentation or EMA")
    names = list(params)
    p = [params[k].detach().clone().float().requires_grad_(True)
         for k in names]
    mu = [torch.zeros_like(v) for v in p]
    nu = [torch.zeros_like(v) for v in p]
    b1, b2, lr = t["adam_b1"], t["adam_b2"], t["learning_rate"]
    gen = torch.Generator(device).manual_seed(noise_seed)
    mask = ref.pitch_mask(spec, device)
    losses, first = [], None
    for step, (xb, cb, kb) in enumerate(batches):
        x, chord, key = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in (xb, cb, kb))
        eps = ref_train.draw_noise(spec, x.shape[0], gen)
        if rows is not None:
            x, chord, key = x[rows], chord[rows], key[rows]
            eps = [e[rows] for e in eps]
        P = dict(zip(names, p))
        logits, latents = forward(P, x, eps, chord, key, spec, q)
        loss = ref.elbo(logits, x, latents, ref.beta_at(t, step), mask)
        grads = torch.autograd.grad(loss, p)
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            c = step + 1
            for i, g in enumerate(grads):
                mu[i].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[i].mul_(b2).add_(g * g, alpha=1.0 - b2)
                upd = (mu[i] / (1.0 - b1 ** c)) / (
                    torch.sqrt(nu[i] / (1.0 - b2 ** c)) + 1e-8)
                p[i].sub_(lr * upd)
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in zip(names, p)}}
