"""Bit-packing for binary piano rolls crossing the device→host link.

The port's counterpart of the JAX package's ops/pack.py. Generated rolls
are binary uint8, so ``pack_bits`` packs them on the device along the
128-pitch axis (16 bytes a row) and only 1/8 of the bytes cross to the
host, where ``unpack_bits_np`` restores them before MIDI export. The bit
order is np.packbits' default (MSB first) in every direction, so round
trips are exact for {0,1} rolls: ``unpack_bits(pack_bits_np(x)) == x`` and
``unpack_bits_np(pack_bits(x)) == x``.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_width(p: int) -> None:
    if p % 8 != 0:
        # np.packbits would silently zero-pad and the unpack would then
        # reconstruct a WIDER last axis, corrupting shapes downstream
        raise ValueError(f"last axis {p} not a multiple of 8; "
                         f"bit-pack round-trip would not be exact")


def pack_bits_np(x: np.ndarray) -> np.ndarray:
    """Host-side: binary [..., P] (any dtype, nonzero == 1) → uint8
    [..., P/8]; P must be a multiple of 8 (the pitch axis is 128)."""
    _check_width(x.shape[-1])
    return np.packbits(np.asarray(x) != 0, axis=-1)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Device-side: binary [..., P] (any dtype, nonzero == 1) → uint8
    [..., P/8], MSB first, on x's device. The bits of a byte are distinct,
    so their sum in uint8 is their OR and never wraps."""
    _check_width(x.shape[-1])
    bits = (x != 0).to(torch.uint8).reshape(*x.shape[:-1],
                                            x.shape[-1] // 8, 8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def unpack_bits_np(packed: np.ndarray, dtype=np.uint8) -> np.ndarray:
    """Host-side inverse of ``pack_bits``: uint8 [..., P/8] → dtype
    [..., P]."""
    return np.unpackbits(np.asarray(packed), axis=-1).astype(
        dtype, copy=False)


def unpack_bits(packed: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Device-side inverse: uint8 [..., P/8] → dtype [..., P]."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1],
                        packed.shape[-1] * 8).to(dtype)
