"""Generation-time binarization (SEMANTICS.md §6)."""

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
