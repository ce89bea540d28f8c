"""The parity trunk's first conv (3x3, stride 2, pad 1, 1→C channels, bias,
tanh-GELU) through a hand-written CUDA kernel (csrc/conv1.cu).

Counterpart of the JAX package's ops/conv1_pallas.py ``first_conv_s2``,
forward and backward, in the same NHWC layout. ``first_conv_s2`` launches
the forward kernel for a CUDA tensor and takes the plain version
``first_conv_s2_ref`` only for a CPU tensor; differentiated, its backward
launches the backward kernel (csrc/conv1_bwd.cu) for a CUDA tensor and
takes ``first_conv_s2_bwd_ref`` only for a CPU tensor.

Gradient contract, as the JAX package's: ``dw`` and ``db`` are exact; ``dx``
is zero, because every caller feeds data or binarized samples, never a
differentiated activation. The backward recomputes the pre-activation from
``(x, w, b)`` in f32 with un-rounded ``w`` (also when the forward rounded to
bf16), so the forward's output is not kept for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from musicvae_tpu_torch.ops import _kernels

T_IN, P_IN = 96, 128          # bar roll
T_OUT, P_OUT = 48, 64         # stride-2 output
CHANNELS = (4, 8, 16, 32)     # output widths the kernel is built for
_OUT_DTYPES = (torch.bfloat16, torch.float32)

# Launch geometry of both kernels, mirrored from csrc/conv1.cuh
# (``Geometry``): a tile is ``rows`` output rows of one bar, all pitches and
# channels, 4 channels a thread; each kernel launches at most as many blocks
# as an H100 holds at once, and a block walks tiles blockIdx, blockIdx +
# blocks, ...
MAX_THREADS = 256
TARGET_TILES = 264            # two for each of an H100's 132 SMs
FWD_BLOCKS = 4 * 132          # forward: 4 blocks an SM (64 registers)
BWD_BLOCKS = 2 * 132          # backward: 2 blocks an SM (128 registers)
_ROW_TILES = (8, 4, 2, 1)


class Geometry(NamedTuple):
    rows: int                 # output rows a tile
    tiles: int
    threads: int              # threads a block
    fwd_blocks: int
    bwd_blocks: int           # also the backward's partials per term


def geometry(m: int, c: int) -> Geometry:
    """The first-conv kernels' launch for ``m`` bars of ``c`` channels, a
    function of M and C alone (never of the card, so the backward's sum
    order is the same everywhere): the largest row tile that keeps a thread
    at no more than 8 positions and still gives ``TARGET_TILES`` tiles,
    else one row. The backward's partials are ``[10·c, bwd_blocks]``."""
    rows = next((r for r in _ROW_TILES
                 if r <= 128 // c and m * (T_OUT // r) >= TARGET_TILES), 1)
    tiles = m * (T_OUT // rows)
    return Geometry(rows, tiles, min(MAX_THREADS, rows * P_OUT * c // 4),
                    min(tiles, FWD_BLOCKS), min(tiles, BWD_BLOCKS))


def first_conv_s2_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      gelu: bool = True,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: x [M,96,128] (uint8/bf16/f32), w [3,3,C], b [C] →
    [M,48,64,C] in ``out_dtype``. When ``out_dtype`` is bf16, x and w are
    rounded to bf16 first (the TPU kernel's contract); the conv, bias and
    GELU run in f32."""
    xf, wf = x.float(), w.float()
    if out_dtype == torch.bfloat16:
        xf = xf.bfloat16().float()
        wf = wf.bfloat16().float()
    y = F.conv2d(xf[:, None], wf.permute(2, 0, 1)[:, None], b.float(),
                 stride=2, padding=1)                      # [M,C,48,64]
    if gelu:
        y = F.gelu(y, approximate="tanh")
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def first_conv_s2_bwd_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          dy: torch.Tensor, gelu: bool = True):
    """Plain version of the backward: (dw [3,3,C], db [C]) in f32, by
    autograd through ``first_conv_s2_ref`` in f32 with the upcast ``dy``."""
    with torch.enable_grad():
        wf = w.detach().float().requires_grad_(True)
        bf = b.detach().float().requires_grad_(True)
        y = first_conv_s2_ref(x.detach(), wf, bf, gelu, torch.float32)
        return torch.autograd.grad(y, (wf, bf), dy.float())


def _check(name: str, x, w, b) -> int:
    if x.dim() != 3 or tuple(x.shape[1:]) != (T_IN, P_IN):
        raise ValueError(f"{name}: x must be [M,{T_IN},{P_IN}], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _kernels.KINDS:
        raise ValueError(f"{name}: x dtype {x.dtype} not in "
                         f"{tuple(_kernels.KINDS)}")
    c = w.shape[-1]
    if tuple(w.shape) != (3, 3, c) or tuple(b.shape) != (c,):
        raise ValueError(f"{name}: w must be [3,3,C] and b [C], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if c not in CHANNELS:
        raise ValueError(f"{name}: C={c} not in {CHANNELS}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"{name}: w and b must be float32")
    _kernels.check_cuda_inputs(name, x.device, x=x, w=w, b=b)
    _kernels.check_aligned(name, x=x)
    return c


def _forward(x, w, b, gelu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return first_conv_s2_ref(x, w, b, gelu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"first_conv_s2: unsupported device {x.device}")
    name = "first_conv_s2"
    c = _check(name, x, w, b)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not in "
                         f"{_OUT_DTYPES}")
    m = x.shape[0]
    out = torch.empty((m, T_OUT, P_OUT, c), dtype=out_dtype, device=x.device)
    stream = _kernels.stream_of(x)
    rc = _kernels.lib().mvk_first_conv_s2(
        x.data_ptr(), _kernels.KINDS[x.dtype], w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _kernels.KINDS[out_dtype], m, c, int(gelu), stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return out


def _backward(x, w, b, dy, gelu: bool):
    """(dw, db) in f32: the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return first_conv_s2_bwd_ref(x, w, b, dy, gelu)
    name = "first_conv_s2_bwd"
    c = _check(name, x, w, b)
    m = x.shape[0]
    if tuple(dy.shape) != (m, T_OUT, P_OUT, c) or dy.dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: dy must be [{m},{T_OUT},{P_OUT},{c}] in "
                         f"bf16 or f32, got {dy.dtype} {tuple(dy.shape)}")
    _kernels.check_cuda_inputs(name, x.device, dy=dy)
    _kernels.check_aligned(name, dy=dy)
    if m == 0:
        return torch.zeros_like(w), torch.zeros_like(b)
    partials = torch.empty((10 * c, geometry(m, c).bwd_blocks),
                           dtype=torch.float32, device=x.device)
    out = torch.empty(10 * c, dtype=torch.float32, device=x.device)
    stream = _kernels.stream_of(x)
    rc = _kernels.lib().mvk_first_conv_s2_bwd(
        x.data_ptr(), _kernels.KINDS[x.dtype], w.data_ptr(), b.data_ptr(),
        dy.data_ptr(), _kernels.KINDS[dy.dtype], partials.data_ptr(),
        out.data_ptr(), m, c, int(gelu), stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return out[:9 * c].view(3, 3, c), out[9 * c:]


class _FirstConvS2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, gelu, out_dtype):
        ctx.save_for_backward(x, w, b)      # not y: the backward needs z
        ctx.gelu = gelu
        return _forward(x, w, b, gelu, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        # the trunk's cuDNN conv hands dy over contiguous NHWC (checked on
        # the card, chip_smoke.py `_conv1_dy_layout`), so this copies
        # nothing there; other callers may pass a permuted view
        dw, db = _backward(x, w, b, dy.contiguous(), ctx.gelu)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return dx, dw.to(w.dtype), db.to(b.dtype), None, None


def first_conv_s2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  gelu: bool = True,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stride-2 3x3 single-channel conv + bias (+ tanh-GELU).

    x [M,96,128] (uint8, bf16 or f32), w [3,3,C] f32, b [C] f32 →
    [M,48,64,C] in ``out_dtype`` (bf16 or f32). On a CUDA tensor this is
    the kernel, forward and backward; on a CPU tensor, the plain versions.
    Differentiable in w and b; the gradient to x is zero by contract."""
    return _FirstConvS2.apply(x, w, b, gelu, out_dtype)
