"""On-device data augmentation for piano-roll training.

Counterpart of the JAX package's ops/augment.py. Transpose augmentation
shifts each example's rolls along the pitch axis by a random number of
semitones, inside the train step: no host involvement, no second copy of
the corpus, and exact resume (the shifts come from the train state's
generator). Enabled with ``TrainSpec.transpose_aug = K`` (uniform shift in
[-K, +K] per example per step). For cond models the chord/key labels
rotate with the shift (``rotate_chord_classes``).

The JAX function applies the shift as a matmul against a one-hot
permutation matrix, to keep a per-example gather off the TPU's lanes; here
it is a gather along pitch with the out-of-range cells zeroed. The results
are the same bits.
"""

from __future__ import annotations

import torch


def transpose_rolls(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Pitch-shift each example's rolls: x [B, ..., P] (uint8 or any float),
    shifts [B] int (semitones, + = up) → same shape and dtype; pitches
    shifted past either edge drop out and zeros shift in.

    out[b, ..., p] = x[b, ..., p - shifts[b]] where in range, else 0."""
    p_dim = x.shape[-1]
    p = torch.arange(p_dim, device=x.device)
    src = p[None, :] - shifts.to(p.dtype)[:, None]                  # [B, P]
    valid = (src >= 0) & (src < p_dim)
    view = (x.shape[0],) + (1,) * (x.dim() - 2) + (p_dim,)
    idx = src.clamp(0, p_dim - 1).reshape(view).expand(x.shape)
    out = torch.gather(x, -1, idx)
    return out * valid.reshape(view).to(x.dtype)


def random_shifts(generator: torch.Generator, batch: int,
                  max_shift: int) -> torch.Tensor:
    """Uniform per-example shifts in [-max_shift, +max_shift], int64 [batch]
    on the generator's device."""
    return torch.randint(-max_shift, max_shift + 1, (batch,),
                         generator=generator, device=generator.device)


def rotate_chord_classes(classes: torch.Tensor,
                         shifts: torch.Tensor) -> torch.Tensor:
    """Transpose ``root*2 + minor`` chord/key classes by ``shifts``
    semitones: the root moves (root+s) mod 12, the major/minor bit stays.
    Negative shifts work (the remainder is non-negative); shapes broadcast
    (e.g. chord [B,N] against shifts [B,1])."""
    root = torch.div(classes, 2, rounding_mode="floor")
    return torch.remainder(root + shifts, 12) * 2 + torch.remainder(classes, 2)
