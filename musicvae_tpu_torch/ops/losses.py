"""Masked piano-roll BCE and the Gaussian KL — plain torch.

The numerically defined ground truth of the port's loss terms, mirroring
the JAX package's ops/losses.py. ``masked_bce_sum`` here is also the plain
version of the masked-BCE kernel (ops/fused_elbo.py): the CPU path, and the
reference ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Stable per-cell BCE from logits, in f32 whatever the input dtypes:
    max(l, 0) - l*x + log1p(exp(-|l|))."""
    l = logits.float()
    x = targets.float()
    return torch.clamp_min(l, 0.0) - l * x + torch.log1p(torch.exp(-l.abs()))


def masked_bce_sum(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Sum of masked per-cell BCE over ALL axes (batch included); f32
    scalar. ``mask`` broadcasts against the last (pitch) axis."""
    return torch.sum(bce_with_logits(logits, targets) * mask.float())


def kl_diag_gaussian(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, diag(exp(logvar))) || N(0, I)), summed over ALL axes."""
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar))
