"""Generation-time binarization (SEMANTICS.md §6): the deterministic
threshold and the stochastic Bernoulli draw. Elementwise torch ops."""

from __future__ import annotations

import numpy as np
import torch


def binarize_logits(logits: torch.Tensor, threshold: float = 0.5,
                    pitch_mask: torch.Tensor | None = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(sigmoid(logits) > threshold) in {0,1} as ``dtype``, strict >,
    crop-masked. Compared in logit space (sigmoid is monotone), with the
    threshold's logit computed in f32 as the JAX package computes it."""
    t = np.float32(threshold)
    logit_t = float(np.log(t) - np.log1p(-t))
    keep = logits > logit_t
    if pitch_mask is not None:
        keep = keep & (pitch_mask > 0)
    return keep.to(dtype)


def sample_bernoulli_logits(u: torch.Tensor, logits: torch.Tensor,
                            temperature: float = 1.0,
                            pitch_mask: torch.Tensor | None = None,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Stochastic alternative (GenSpec.sample_mode "bernoulli"): a cell is
    on where ``u < sigmoid(logits / temperature)``, crop-masked, as
    ``dtype``. ``u`` holds U[0, 1) draws of the logits' shape; they are
    compared in the probabilities' dtype, which is what the JAX package's
    ``jax.random.bernoulli(key, p)`` computes from its own uniforms.
    ``temperature`` sharpens (<1) or flattens (>1) the probabilities."""
    probs = torch.sigmoid(logits / temperature)
    keep = u.to(probs.dtype) < probs
    if pitch_mask is not None:
        keep = keep & (pitch_mask > 0)
    return keep.to(dtype)
