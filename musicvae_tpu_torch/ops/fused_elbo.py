"""The masked BCE sum and the Gaussian KL sum of the ELBO through
hand-written CUDA kernels (csrc/masked_bce.cu, csrc/kl.cu).

Counterpart of the JAX package's ops/fused_elbo.py, with its five kernels:

- ``masked_bce_sum``: the single-output forward (the eval scoring kernel);
  differentiated, its backward launches the backward kernel, which reads
  the logits again;
- ``masked_bce_sum_dual``: the same sum plus the gradient tile
  (σ(l) − x)·mask from one pass over the logits, for differentiated graphs
  (the train step); its backward is one scale of the saved f32 tile;
- ``kl_sum``: the KL sum forward and backward kernels;
- ``fused_elbo``: the drop-in for ops/losses.py ``elbo_loss``.

Each function launches its kernel for a CUDA tensor and takes its plain
version only for a CPU tensor: ops/losses.py for the sums, the ``_plain``
functions below for the gradients. The cotangents for the targets and the
mask are a cold path (the targets are data, the mask a constant) and stay
plain torch on either device, computed only when asked for.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from musicvae_tpu_torch.ops import _kernels, losses

_THREADS = 256                # csrc/masked_bce.cu THREADS

# Launch geometry of the BCE kernels K2, K4 and K3, mirrored from
# csrc/masked_bce.cu (``sum_geometry``): a chunk is SUM_CHUNK consecutive
# cells, thread t of a block takes cells 4t..4t+3 of it, block b takes
# chunks b, b + blocks, ...; the grid is a block a chunk, at most
# SUM_MAX_BLOCKS.
SUM_GROUP = 4
SUM_CHUNK = _THREADS * SUM_GROUP
SUM_MAX_BLOCKS = _kernels.WORKSPACE_PARTIALS   # the partials in a workspace


class SumGeometry(NamedTuple):
    chunks: int
    blocks: int
    fixed_col: bool           # p divides SUM_CHUNK: a thread's 4 columns
    #                           never change, its mask values stay in registers


def sum_geometry(n: int, p: int) -> SumGeometry:
    """The BCE kernels' launch for ``n`` cells of ``p`` pitches: the blocks
    are a function of ``n`` alone (never of the card or the pointers), and
    so are the order of the additions and the sum's bits."""
    chunks = -(-n // SUM_CHUNK)
    return SumGeometry(chunks, max(1, min(chunks, SUM_MAX_BLOCKS)),
                       SUM_CHUNK % p == 0)


def _check_bce(name: str, logits, x, mask) -> None:
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


# -- forward and backward of the BCE sum: kernel or plain, by device ---------

def _bce_sum(logits, x, mask, dual: bool):
    """(sum, tile or None). The kernels on a CUDA tensor."""
    name = "masked_bce_sum_dual" if dual else "masked_bce_sum"
    if _kernels.on_cpu(name, logits):
        total = losses.masked_bce_sum(logits, x, mask)
        return total, (bce_grad_tile_plain(logits, x, mask) if dual else None)
    _check_bce(name, logits, x, mask)
    n, p = logits.numel(), logits.shape[-1]
    dev, stream = logits.device, _kernels.stream_of(logits)
    partials, ticket = _kernels.workspace(dev, stream)
    out = torch.empty((), dtype=torch.float32, device=dev)
    args = (logits.data_ptr(), _kernels.KINDS[logits.dtype], x.data_ptr(),
            _kernels.KINDS[x.dtype], mask.data_ptr(), partials.data_ptr(),
            ticket.data_ptr(), out.data_ptr())
    if dual:
        tile = torch.empty(logits.shape, dtype=torch.float32, device=dev)
        rc = _kernels.lib().mvk_masked_bce_sum_dual(*args, tile.data_ptr(),
                                                    n, p, stream)
    else:
        tile = None
        rc = _kernels.lib().mvk_masked_bce_sum(*args, n, p, stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return out, tile


def bce_grad_tile_plain(logits, x, mask) -> torch.Tensor:
    """Plain version of the dual kernel's second output: (σ(l) − x)·mask,
    f32, in the logits' shape."""
    return (torch.sigmoid(logits.float()) - x.float()) * mask


def masked_bce_bwd_plain(logits, x, mask, g) -> torch.Tensor:
    """Plain version of the backward kernel: (σ(l) − x)·mask·g in the
    logits' dtype, the arithmetic in f32."""
    return (bce_grad_tile_plain(logits, x, mask) * g).to(logits.dtype)


def _bce_bwd(logits, x, mask, g):
    name = "masked_bce_bwd"
    if _kernels.on_cpu(name, logits):
        return masked_bce_bwd_plain(logits, x, mask, g)
    _check_bce(name, logits, x, mask)
    g = g.to(torch.float32).contiguous()
    _kernels.check_cuda_inputs(name, logits.device, g=g)
    n, p = logits.numel(), logits.shape[-1]
    dl = torch.empty_like(logits)
    stream = _kernels.stream_of(logits)
    rc = _kernels.lib().mvk_masked_bce_bwd(
        logits.data_ptr(), _kernels.KINDS[logits.dtype], x.data_ptr(),
        _kernels.KINDS[x.dtype], mask.data_ptr(), g.data_ptr(),
        dl.data_ptr(), n, p, stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return dl


def _xmask_cotangents(ctx, logits, x, mask, g):
    """Cotangents for the targets and the mask, each only when asked for:
    the per-cell term is bce(l, x)·mask, so d/dx = −l·mask and d/dmask =
    bce(l, x) summed over all but the pitch axis."""
    dx = dmask = None
    if ctx.needs_input_grad[1]:
        dx = (-logits.float() * mask * g).to(x.dtype)
    if ctx.needs_input_grad[2]:
        bce_g = losses.bce_with_logits(logits, x) * g
        dmask = bce_g.reshape(-1, mask.shape[0]).sum(dim=0).to(mask.dtype)
    return dx, dmask


class _MaskedBCESum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, x, mask):
        ctx.save_for_backward(logits, x, mask)
        return _bce_sum(logits, x, mask, dual=False)[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logits, x, mask = ctx.saved_tensors
        dl = _bce_bwd(logits, x, mask, g) if ctx.needs_input_grad[0] \
            else None
        return (dl, *_xmask_cotangents(ctx, logits, x, mask, g))


class _MaskedBCESumDual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, x, mask):
        total, tile = _bce_sum(logits, x, mask, dual=True)
        ctx.save_for_backward(tile, logits, x, mask)
        return total

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        tile, logits, x, mask = ctx.saved_tensors
        # the hot path: one scale of the saved f32 tile, then the cast
        dl = (tile * g).to(logits.dtype) if ctx.needs_input_grad[0] else None
        return (dl, *_xmask_cotangents(ctx, logits, x, mask, g))


def masked_bce_sum(logits: torch.Tensor, x: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """sum(mask * bce_with_logits(logits, x)) over all cells, as an f32
    0-d tensor on the logits' device.

    logits [..., P] f32 or bf16; x of the same shape, f32, bf16 or uint8;
    mask [P] f32 (the pitch-crop mask). Differentiable: the backward for
    the logits is a second kernel that reads them again. Grad-free callers
    (eval) pay the forward alone."""
    return _MaskedBCESum.apply(logits, x, mask)


def masked_bce_sum_dual(logits: torch.Tensor, x: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """``masked_bce_sum`` with the gradient tile computed in the forward
    pass and saved in f32. For differentiated graphs (the train step);
    grad-free callers keep ``masked_bce_sum``, which skips the tile's
    write."""
    return _MaskedBCESumDual.apply(logits, x, mask)


# -- the KL sum ---------------------------------------------------------------

def _check_kl(name: str, mu, logvar) -> None:
    if mu.dtype not in (torch.float32, torch.bfloat16) \
            or logvar.dtype != mu.dtype:
        raise ValueError(f"{name}: mu and logvar must both be f32 or both "
                         f"bf16, got {mu.dtype} and {logvar.dtype}")
    if mu.shape != logvar.shape:
        raise ValueError(f"{name}: mu {tuple(mu.shape)} and logvar "
                         f"{tuple(logvar.shape)} differ")
    _kernels.check_cuda_inputs(name, mu.device, mu=mu, logvar=logvar)


def kl_bwd_plain(mu, logvar, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the KL backward kernel: dmu = mu·g, dlv =
    0.5·(exp(lv) − 1)·g, f32 arithmetic, the inputs' dtypes out."""
    dmu = (mu.float() * g).to(mu.dtype)
    dlv = (0.5 * (torch.exp(logvar.float()) - 1.0) * g).to(logvar.dtype)
    return dmu, dlv


def _kl_fwd(mu, logvar):
    name = "kl_sum"
    if _kernels.on_cpu(name, mu):
        return losses.kl_diag_gaussian(mu.float(), logvar.float())
    _check_kl(name, mu, logvar)
    out = torch.empty((), dtype=torch.float32, device=mu.device)
    stream = _kernels.stream_of(mu)
    rc = _kernels.lib().mvk_kl_sum(
        mu.data_ptr(), logvar.data_ptr(), _kernels.KINDS[mu.dtype],
        out.data_ptr(), mu.numel(), stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return out


def _kl_bwd(mu, logvar, g):
    name = "kl_bwd"
    if _kernels.on_cpu(name, mu):
        return kl_bwd_plain(mu, logvar, g)
    _check_kl(name, mu, logvar)
    g = g.to(torch.float32).contiguous()
    _kernels.check_cuda_inputs(name, mu.device, g=g)
    dmu, dlv = torch.empty_like(mu), torch.empty_like(logvar)
    stream = _kernels.stream_of(mu)
    rc = _kernels.lib().mvk_kl_bwd(
        mu.data_ptr(), logvar.data_ptr(), _kernels.KINDS[mu.dtype],
        g.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), mu.numel(), stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return dmu, dlv


class _KLSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar):
        ctx.save_for_backward(mu, logvar)
        return _kl_fwd(mu, logvar)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _kl_bwd(*ctx.saved_tensors, g)


def kl_sum(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, diag(exp(logvar))) || N(0, I)) summed over all axes, an f32
    0-d tensor. mu, logvar: any [..., z] shape, both f32 or both bf16; the
    arithmetic is f32 and the gradients come back in the inputs' dtype."""
    return _KLSum.apply(mu, logvar)


def fused_elbo(logits, x, mask, mu, logvar, beta) -> Tuple[torch.Tensor,
                                                           dict]:
    """Drop-in for ops/losses.py ``elbo_loss`` (same conventions) through
    the single-output BCE kernel and the KL kernel, forward and backward."""
    batch = logits.shape[0]
    recon = masked_bce_sum(logits, x, mask) / batch
    kl = kl_sum(mu, logvar) / batch
    loss = recon + beta * kl
    return loss, {"loss": loss, "recon": recon, "kl": kl, "beta": beta}
