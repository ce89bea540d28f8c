"""The grad-free masked BCE sum through a hand-written CUDA kernel
(csrc/masked_bce.cu).

Counterpart of the JAX package's ops/fused_elbo.py ``masked_bce_sum_pallas``
forward, the eval scoring kernel. ``masked_bce_sum`` launches the kernel for
a CUDA tensor and takes the plain version, ops/losses.py
``masked_bce_sum``, only for a CPU tensor. The training kernels (the
dual-output forward, the backward and the KL pair) come with training.
"""

from __future__ import annotations

import torch

from musicvae_tpu_torch.ops import _kernels, losses

_THREADS = 256                # csrc/masked_bce.cu THREADS
_CELLS_PER_THREAD = 16        # 4 grid-stride steps of 4 cells
_MAX_BLOCKS = 1024


def partial_blocks(n: int) -> int:
    """Pass-1 grid size for ``n`` cells: a function of ``n`` alone, so the
    reduction order, and the sum's bits, never change between runs."""
    per_block = _THREADS * _CELLS_PER_THREAD
    return max(1, min(-(-n // per_block), _MAX_BLOCKS))


def masked_bce_sum(logits: torch.Tensor, x: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """sum(mask * bce_with_logits(logits, x)) over all cells, as an f32
    0-d tensor on the logits' device.

    logits [..., P] f32 or bf16; x of the same shape, f32, bf16 or uint8;
    mask [P] f32 (the pitch-crop mask)."""
    if logits.device.type == "cpu":
        return losses.masked_bce_sum(logits, x, mask)
    if logits.device.type != "cuda":
        raise ValueError(f"masked_bce_sum: unsupported device "
                         f"{logits.device}")
    name = "masked_bce_sum"
    p = logits.shape[-1]
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: logits dtype {logits.dtype} not f32/bf16")
    if x.dtype not in _kernels.KINDS:
        raise ValueError(f"{name}: x dtype {x.dtype} not in "
                         f"{tuple(_kernels.KINDS)}")
    if x.shape != logits.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and logits "
                         f"{tuple(logits.shape)} differ")
    if tuple(mask.shape) != (p,) or mask.dtype != torch.float32:
        raise ValueError(f"{name}: mask must be f32 [{p}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    _kernels.check_cuda_inputs(name, logits.device, logits=logits, x=x,
                               mask=mask)
    n = logits.numel()
    blocks = partial_blocks(n)
    partials = torch.empty(blocks, dtype=torch.float32, device=logits.device)
    out = torch.empty((), dtype=torch.float32, device=logits.device)
    rc = _kernels.lib().mvk_masked_bce_sum(
        logits.data_ptr(), _kernels.KINDS[logits.dtype], x.data_ptr(),
        _kernels.KINDS[x.dtype], mask.data_ptr(), partials.data_ptr(),
        out.data_ptr(), n, p, blocks, _kernels.stream_of(logits))
    _kernels.check(rc, name)
    _kernels.LAUNCHES[name] += 1
    return out
