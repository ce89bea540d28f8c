"""Shared latent core: reparameterization with injected noise, and slerp."""

from __future__ import annotations

import torch


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar), with eps ~ N(0, I) given by the
    caller (the two frameworks' generators cannot be matched bit for bit,
    so the noise is an argument)."""
    return mu + eps * torch.exp(0.5 * logvar)


def slerp(z_a: torch.Tensor, z_b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between latents along the last axis.

    ``t`` broadcasts against the leading axes (a scalar or a tensor of
    lower rank than ``z_a`` gains a trailing axis); falls back to lerp
    where the vectors are nearly collinear (sin(omega) ~ 0)."""
    t = torch.as_tensor(t, dtype=z_a.dtype, device=z_a.device)
    a = z_a / (torch.linalg.vector_norm(z_a, dim=-1, keepdim=True) + 1e-9)
    b = z_b / (torch.linalg.vector_norm(z_b, dim=-1, keepdim=True) + 1e-9)
    dot = torch.clamp(torch.sum(a * b, dim=-1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    if t.dim() < z_a.dim():
        t = t[..., None]
    safe = so.abs() > 1e-6
    slerped = (torch.sin((1.0 - t) * omega) * z_a
               + torch.sin(t * omega) * z_b) / torch.where(
                   safe, so, torch.ones_like(so))
    lerped = (1.0 - t) * z_a + t * z_b
    return torch.where(safe, slerped, lerped)
