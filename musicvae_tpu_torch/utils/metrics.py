"""Reconstruction-quality metrics and the eval function.

Counterpart of the JAX package's utils/metrics.py: cell-level
precision/recall/F1 of the binarized reconstruction, plus the one-sample
ELBO terms. The unweighted masked-BCE sum goes through
ops/fused_elbo.py ``masked_bce_sum`` (the kernel on the card). On the
card the eval is a captured CUDA graph a signature (utils/graphs.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.midi.tensorize import pitch_mask
from musicvae_tpu_torch.ops import fused_elbo, losses
from musicvae_tpu_torch.ops.binarize import binarize_logits
from musicvae_tpu_torch.utils import graphs


def recon_prf(recon_bin: torch.Tensor, x: torch.Tensor,
              mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cell-level precision/recall/F1 over masked cells. Inputs in {0,1};
    ``mask`` broadcasts against x."""
    x = x.float()
    tp = torch.sum(recon_bin * x * mask)
    fp = torch.sum(recon_bin * (1.0 - x) * mask)
    fn = torch.sum((1.0 - recon_bin) * x * mask)
    precision = tp / torch.clamp_min(tp + fp, 1.0)
    recall = tp / torch.clamp_min(tp + fn, 1.0)
    f1 = 2.0 * precision * recall / torch.clamp_min(precision + recall, 1e-9)
    return {"precision": precision, "recall": recall, "f1": f1}


def eval_metrics(cfg: Config, logits: torch.Tensor, x: torch.Tensor,
                 latents, weights: Optional[torch.Tensor] = None,
                 bce_sum: Callable = fused_elbo.masked_bce_sum
                 ) -> Dict[str, torch.Tensor]:
    """{loss, recon, kl, precision, recall, f1} of a forward's outputs.

    ``weights`` (optional [B], 1.0 = real example, 0.0 = padding) weights
    each example, so a final partial batch padded to the batch shape is
    not double counted. ``bce_sum`` computes the unweighted masked BCE
    sum: the kernel's dispatcher, or losses.masked_bce_sum to score the
    same outputs with the plain version."""
    mask = pitch_mask(cfg.midi, logits.device)
    beta = cfg.train.beta_max
    if weights is None:
        batch = logits.shape[0]
        recon = bce_sum(logits, x, mask) / batch
        kl = sum(losses.kl_diag_gaussian(mu, lv) for mu, lv in latents) / batch
        prf_mask = mask
    else:
        w = weights.float()
        wsum = w.sum()
        nb = tuple(range(1, logits.dim()))              # non-batch axes
        bce_ex = torch.sum(losses.bce_with_logits(logits, x) * mask, dim=nb)
        recon = torch.sum(w * bce_ex) / wsum
        kl = sum(torch.sum(w * (-0.5) * torch.sum(
            1.0 + lv - mu.square() - torch.exp(lv),
            dim=tuple(range(1, mu.dim())))) for mu, lv in latents) / wsum
        prf_mask = mask * w.reshape((-1,) + (1,) * (x.dim() - 1))
    m = {"loss": recon + beta * kl, "recon": recon, "kl": kl}
    recon_bin = binarize_logits(logits, cfg.midi.binarize_threshold, mask)
    m.update(recon_prf(recon_bin, x, prf_mask))
    return m


def make_eval_fn(cfg: Config, model):
    """Eval: (x [B,N,T,P], eps, weights=None, chord=None, key_sig=None) →
    {loss, recon, kl, precision, recall, f1} as 0-d f32 tensors of the
    caller's own, from the one-sample ELBO with the posterior noise
    ``eps`` given by the caller (one tensor a latent level, models/vae.py
    ``eps_shapes``). A cond model takes the window labels chord [B,N] and
    key_sig [B].

    Each signature (x's shape and dtype, each noise level's, and which of
    ``weights`` and the labels are given, with theirs) has its own static
    inputs and runs as a ``graphs.StaticProgram``: one captured CUDA
    graph on the card from its second call on, as the JAX package jits
    its eval. Not for two threads at once."""
    dev = next(model.parameters()).device
    programs: dict = {}

    def body(static, _):
        x = static["x"]
        eps = tuple(v for k, v in static.items() if isinstance(k, tuple))
        logits, latents = model(x, eps, chord=static.get("chord"),
                                key_sig=static.get("key_sig"))
        return eval_metrics(cfg, logits, x, latents, static.get("weights"))

    @torch.inference_mode()
    def eval_fn(x: torch.Tensor, eps,
                weights: Optional[torch.Tensor] = None,
                chord: Optional[torch.Tensor] = None,
                key_sig: Optional[torch.Tensor] = None):
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        given = {"x": x}
        given.update({("eps", i): e for i, e in enumerate(eps)})
        for k, v in (("weights", weights), ("chord", chord),
                     ("key_sig", key_sig)):
            if v is not None:
                given[k] = v
        key = graphs.signature(given)
        run = programs.get(key)
        if run is None:
            run = programs[key] = graphs.StaticProgram(body, dev, given)
        return run(given)

    eval_fn.programs = programs
    return eval_fn
