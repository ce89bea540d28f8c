"""Masked piano-roll BCE, the Gaussian KL and the KL-annealed ELBO — plain
torch.

The numerically defined ground truth of the port's loss terms, mirroring
the JAX package's ops/losses.py. ``masked_bce_sum``, ``kl_diag_gaussian``
and ``elbo_loss`` here are also the plain versions of the loss kernels
(ops/fused_elbo.py): the reference the CPU tests and ``chip_smoke.py`` hold
the kernels against.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def kl_free_bits(mu: torch.Tensor, logvar: torch.Tensor,
                 free_bits: float,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None) -> torch.Tensor:
    """Free-bits KL objective: each latent dimension's batch-mean KL is
    floored at ``free_bits`` nats before summing, so a dimension below the
    floor contributes a constant (zero gradient).

    Returns the objective summed over latent dims and scaled back by the
    batch size, so ``kl_free_bits(...) / batch`` is a drop-in for
    ``kl_diag_gaussian(...) / batch`` in the minimized loss. ``mu`` and
    ``logvar``: [B, z] (leading batch axis, any trailing latent axes).

    ``reduce``: when these are one process's rows of a batch split evenly
    over a process group, the map from this process's per-dimension KL
    sums [z] (detached) to their mean over the group's processes. The
    floor then applies to the global batch's per-dimension means, as the
    JAX package's sharded batch takes them: the value is the global
    objective (times this process's batch) on every process, and the
    gradient is that of this process's rows under the global mask. None:
    one process holds the whole batch."""
    batch = mu.shape[0]
    per_dim = -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar))
    sums = per_dim.reshape(batch, -1).sum(dim=0)                   # [z]
    shared = sums.detach() if reduce is None else reduce(sums.detach())
    mean = shared / batch
    masked = (sums * (mean >= free_bits)).sum()
    value = torch.sum(torch.clamp_min(mean, free_bits)) * batch
    return masked - masked.detach() + value


def elbo_loss(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
              beta) -> Tuple[torch.Tensor, dict]:
    """Minimized objective recon + beta*kl, batch-mean: (loss, aux). One
    latent level; models with several sum their KLs before annealing. The
    plain version of ops/fused_elbo.py ``fused_elbo``."""
    batch = logits.shape[0]
    recon = masked_bce_sum(logits, targets, mask) / batch
    kl = kl_diag_gaussian(mu, logvar) / batch
    loss = recon + beta * kl
    return loss, {"loss": loss, "recon": recon, "kl": kl, "beta": beta}


def beta_schedule(step: torch.Tensor, beta_max: float, warmup_steps: int,
                  hold_steps: int = 0, mode: str = "linear",
                  cycle_steps: int = 0) -> torch.Tensor:
    """KL-annealing weight as an f32 0-d tensor on ``step``'s device: a
    pure function of the step counter, computed without reading it on the
    host, so it runs inside the train step.

    - ``linear``: 0 for ``hold_steps``, then a linear ramp to ``beta_max``
      over ``warmup_steps``.
    - ``cyclical``: within each ``cycle_steps`` window, ramp 0→beta_max
      over ``warmup_steps`` and hold at beta_max for the remainder."""
    step = torch.as_tensor(step)
    s = torch.clamp_min(step - hold_steps, 0).to(torch.float32)
    if mode == "cyclical":
        if cycle_steps <= 0:
            raise ValueError("cyclical schedule needs cycle_steps > 0")
        s = torch.remainder(s, float(cycle_steps))
    elif mode != "linear":
        raise ValueError(f"unknown beta schedule mode {mode!r}")
    if warmup_steps <= 0:
        return torch.full((), beta_max, dtype=torch.float32,
                          device=step.device)
    frac = torch.clamp_max(s / float(warmup_steps), 1.0)
    return frac * beta_max
