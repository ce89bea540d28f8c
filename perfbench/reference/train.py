"""The reference's first train steps: the batches a run's steps read,
worked out again from the run's seeds, the noise drawn from a generator of
the reference's own seeded as the program's state is, the ELBO, its
gradients by autograd, and optax's Adam, all in f32 (or, for the control,
in the precision ``q`` emulates)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import model as ref


def resident_ids(seed: int, n: int, batch: int, steps: int) -> List[np.ndarray]:
    """The window ids of the first ``steps`` steps of a resident run:
    epoch 0's permutation, seeded (seed, 0, 0), taken ``batch`` at a
    time."""
    if n < batch:
        raise ValueError("the reference expects a corpus of at least one "
                         "batch of windows")
    perm = np.random.default_rng((seed, 0, 0)).permutation(n)
    return [perm[i * batch:(i + 1) * batch] for i in range(steps)]


def streamed_ids(seed: int, n: int, batch: int, steps: int) -> List[np.ndarray]:
    """The window ids of the first ``steps`` batches of a dataset's
    shuffled iterator seeded ``seed``."""
    perm = np.random.default_rng(seed).permutation(n)
    return [perm[i * batch:(i + 1) * batch] for i in range(steps)]


def gather(bars: np.ndarray, starts: np.ndarray, ids: np.ndarray,
           num_bars: int) -> np.ndarray:
    """[B, num_bars, T, P] windows of the bar array."""
    idx = starts[ids][:, None] + np.arange(num_bars)[None, :]
    return bars[idx]


def draw_noise(spec: dict, batch: int, gen: torch.Generator):
    """One step's latent noise: [B, z], or [B, z_phrase] then [B, N, z]."""
    m = spec["model"]
    shapes = [(batch, m["z_dim"])]
    if m["kind"] == "hier":
        shapes = [(batch, m["z_phrase_dim"]),
                  (batch, m["num_bars"], m["z_dim"])]
    return [torch.randn(s, generator=gen, device=gen.device) for s in shapes]


def run_steps(spec: dict, params: Dict[str, torch.Tensor],
              batches: List[np.ndarray], noise_seed: int, device,
              q=ref.exact, rows=None) -> Dict[str, object]:
    """The first len(batches) steps from ``params`` (not changed): each
    step's loss, the first step's gradients and the parameters after the
    last step. ``rows`` (a slice) keeps only those rows of each batch in
    the loss: a planted fault, not the program's arithmetic."""
    t = spec["train"]
    if t["lr_schedule"] != "constant" or t["grad_clip_norm"] > 0 \
            or t["weight_decay"] > 0 or t["free_bits"] > 0 \
            or t["transpose_aug"] or t["ema_decay"] > 0:
        raise ValueError("the reference follows constant-lr Adam without "
                         "clip, decay, free bits, augmentation or EMA")
    names = list(params)
    p = [params[k].detach().clone().float().requires_grad_(True)
         for k in names]
    mu = [torch.zeros_like(x) for x in p]
    nu = [torch.zeros_like(x) for x in p]
    b1, b2, lr = t["adam_b1"], t["adam_b2"], t["learning_rate"]
    gen = torch.Generator(device).manual_seed(noise_seed)
    mask = ref.pitch_mask(spec, device)
    losses, first = [], None
    for step, xb in enumerate(batches):
        x = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
        eps = draw_noise(spec, x.shape[0], gen)
        if rows is not None:
            x, eps = x[rows], [e[rows] for e in eps]
        P = dict(zip(names, p))
        logits, latents = ref.forward(P, x, eps, spec, q)
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
            "params": {k: x.detach() for k, x in zip(names, p)}}
