"""The decoder head's last layer (models/layers.py ``BarDecoderHead``): its
one-channel, stride-2, 3x3 transposed conv with the [:ho, :wo] crop, the
bias and the logits' cast, in one hand-written CUDA pass each way
(csrc/head_out.cu).

The JAX package has no kernel here (XLA fuses the layer). On the card this
takes the place of cuDNN's NCHW engine for a transposed conv to one channel,
the two layout transposes of x that cuDNN wraps around it, and the conv
epilogue's launches for the layer.

``head_out`` launches the forward kernel for a CUDA tensor and takes the
plain version ``head_out_ref`` only for a CPU tensor; differentiated, its
backward launches the backward kernel for a CUDA tensor and takes
``head_out_bwd_ref`` only for a CPU tensor. The plain versions are the
path the kernels replace: ATen's ``conv_transpose2d`` without its bias,
then the conv epilogue's plain versions (ops/conv_epilogue.py), and the
card holds the kernels to them (chip_smoke.py ``head_out``).
``conv_epilogue.conv_block`` sends a CUDA call of this layer's shape here
(``takes``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

# conv_epilogue imports this module too (conv_block): each binds the other
# as a module, read at call time
from musicvae_tpu_torch.ops import _kernels, conv_epilogue as ce

# Launch geometry, the kernels' own (csrc/head_out.cu): a block of THREADS
# threads takes ROWS rows of x of one bar at a time; the backward launches
# a block for each such unit, at most BWD_MAX_BLOCKS (2 on each of an
# H100's 132 SMs), so that its last block sums few partials. x's channels
# come in quads: 4 to MAX_CIN, 4 times a power of two. Both kernels' shared
# memory stays under the 48 KB a launch may take without opting in, which
# MAX_W, x's width, keeps.
THREADS = 256
ROWS = 8
BWD_MAX_BLOCKS = 2 * 132
MAX_CIN = 128
MAX_W = 128
_DTYPES = (torch.bfloat16, torch.float32)

Crop = Optional[Tuple[int, int]]


def takes(weight: torch.Tensor, stride, padding, transposed: bool) -> bool:
    """Whether a conv of the pyramid is this layer: a transposed conv to one
    channel, 3x3 (weight [Cin, 1, 3, 3]), stride 2, padding 0."""
    pair = (lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v, v))
    return (transposed and tuple(weight.shape[1:]) == (1, 3, 3)
            and pair(stride) == (2, 2) and pair(padding) == (0, 0))


def bwd_blocks(n: int, h: int) -> int:
    """The backward's blocks for x [n, h, ...]: one a unit of ROWS rows, at
    most BWD_MAX_BLOCKS; a function of the shape alone, so the order of
    dW's and db's sums (partials [blocks, partial_cols]) is the same on
    every card and every run."""
    return max(1, min(n * -(-h // ROWS), BWD_MAX_BLOCKS))


def partial_cols(cin: int) -> int:
    """A block's partials: dW's 9·Cin sums and db's, padded to a multiple
    of 4 (the last block reads them by float4)."""
    return (9 * cin + 4) & ~3


def _kept(x: torch.Tensor, crop: Crop) -> Tuple[int, int]:
    return ((2 * x.shape[1] + 1, 2 * x.shape[2] + 1) if crop is None
            else tuple(crop))


def head_out_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 crop: Crop = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: x [N,h,w,Cin] NHWC, weight [Cin,1,3,3] and bias [1] in
    x's dtype → y [N,ho,wo,1] contiguous in ``out_dtype`` (default x's):
    ATen's stride-2 ``conv_transpose2d`` without its bias on x's NCHW
    view, then the epilogue's plain version without the GELU (c + b, the
    [:ho, :wo] ``crop``, the cast)."""
    c = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, None, stride=2)
    return ce.conv_epilogue_ref(c, bias, crop, False, out_dtype or x.dtype)


def head_out_bwd_ref(x: torch.Tensor, weight: torch.Tensor,
                     dy: torch.Tensor, crop: Crop = None):
    """Plain version of the backward: (dx [N,h,w,Cin] NHWC contiguous, dW,
    db [1]), all in x's dtype, from dy [N,ho,wo,1], by the ops autograd
    runs for the chain: the epilogue's backward without the GELU (dy
    rounded to x's dtype, zero on the cropped edge, db its sum), then
    ``convolution_backward`` of the transposed conv for dx and dW."""
    n, h, w, _ = x.shape
    grid = torch.zeros((n, 1, 2 * h + 1, 2 * w + 1), dtype=x.dtype,
                       device=x.device)
    dc, db = ce.conv_epilogue_bwd_ref(
        grid, torch.zeros(1, dtype=x.dtype, device=x.device), dy, crop, False)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dc, x.permute(0, 3, 1, 2), weight, None, [2, 2], [0, 0], [1, 1],
        True, [0, 0], 1, [True, True, False])
    return dx.permute(0, 2, 3, 1).contiguous(), dw, db


def check(name: str, x: torch.Tensor, weight: torch.Tensor, crop: Crop,
          out_dtype: torch.dtype, bias: Optional[torch.Tensor] = None,
          dy: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """What the kernels take, raised on otherwise (the wrappers run it for a
    CUDA tensor; it reads nothing of the card): x [N,h,w,Cin] contiguous in
    bf16 or f32, Cin 4 to MAX_CIN and 4 times a power of two, w at most
    MAX_W, fewer than 2^31 elements, 16-byte aligned; weight [Cin,1,3,3]
    and the forward's ``bias`` [1] contiguous in x's dtype; the crop inside
    the [2h+1, 2w+1] grid; a bf16 or f32 output (the backward's: dy, which
    must be [N,ho,wo,1] contiguous); every tensor on x's device. Returns
    the kept grid (ho, wo)."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [N,h,w,Cin], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"{name}: x {x.dtype} and out_dtype {out_dtype} "
                         f"must each be one of {_DTYPES}")
    n, h, w, cin = x.shape
    quads = cin // 4
    if cin % 4 or not 1 <= quads <= MAX_CIN // 4 or quads & (quads - 1):
        raise ValueError(f"{name}: Cin={cin} must be 4 to {MAX_CIN} and 4 "
                         f"times a power of two")
    if w > MAX_W:
        raise ValueError(f"{name}: x's width {w} is over {MAX_W}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: x has {x.numel()} elements, 2^31 or more")
    if tuple(weight.shape) != (cin, 1, 3, 3) or weight.dtype != x.dtype:
        raise ValueError(f"{name}: weight must be [{cin},1,3,3] in "
                         f"{x.dtype}, got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    if bias is not None and (tuple(bias.shape) != (1,)
                             or bias.dtype != x.dtype):
        raise ValueError(f"{name}: bias must be [1] in {x.dtype}, got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    ho, wo = _kept(x, crop)
    if not (0 < ho <= 2 * h + 1 and 0 < wo <= 2 * w + 1):
        raise ValueError(f"{name}: crop {(ho, wo)} outside the "
                         f"{(2 * h + 1, 2 * w + 1)} grid")
    if dy is not None and tuple(dy.shape) != (n, ho, wo, 1):
        raise ValueError(f"{name}: dy must be [{n},{ho},{wo},1], got "
                         f"{tuple(dy.shape)}")
    given = {k: t for k, t in (("bias", bias), ("dy", dy)) if t is not None}
    _kernels.check_cuda_inputs(name, x.device, x=x, weight=weight, **given)
    _kernels.check_aligned(name, x=x)
    return ho, wo


def _forward(x, weight, bias, crop: Crop, out_dtype: torch.dtype):
    name = "head_out_fwd"
    if _kernels.on_cpu(name, x):
        return head_out_ref(x, weight, bias, crop, out_dtype)
    ho, wo = check(name, x, weight, crop, out_dtype, bias=bias)
    n, h, w, cin = x.shape
    y = torch.empty((n, ho, wo, 1), dtype=out_dtype, device=x.device)
    if n == 0:
        return y
    stream = _kernels.stream_of(x)
    rc = _kernels.lib().mvk_head_out_fwd(
        x.data_ptr(), _kernels.KINDS[x.dtype], weight.data_ptr(),
        bias.data_ptr(), y.data_ptr(), _kernels.KINDS[out_dtype], n, h, w,
        cin, ho, wo, stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return y


def _backward(x, weight, dy, crop: Crop):
    """(dx, dW, db): the kernel on a CUDA tensor."""
    name = "head_out_bwd"
    if _kernels.on_cpu(name, x):
        return head_out_bwd_ref(x, weight, dy, crop)
    ho, wo = check(name, x, weight, crop, dy.dtype, dy=dy)
    n, h, w, cin = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    db = torch.empty(1, dtype=x.dtype, device=x.device)
    if n == 0:
        return dx, dw.zero_(), db.zero_()
    grid = bwd_blocks(n, h)
    partials = torch.empty((grid, partial_cols(cin)), dtype=torch.float32,
                           device=x.device)
    stream = _kernels.stream_of(x)
    rc = _kernels.lib().mvk_head_out_bwd(
        dy.data_ptr(), _kernels.KINDS[dy.dtype], x.data_ptr(),
        _kernels.KINDS[x.dtype], weight.data_ptr(), dx.data_ptr(),
        partials.data_ptr(), _kernels.ticket(x.device, stream).data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, h, w, cin, ho, wo, grid, stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return dx, dw, db


class _HeadOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, crop, out_dtype):
        ctx.save_for_backward(x, weight)
        ctx.crop = crop
        return _forward(x, weight, bias, crop, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = _backward(x, weight, dy.contiguous(), ctx.crop)
        return dx, dw, db, None, None


def head_out(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             crop: Crop = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The decoder head's last layer: x [N,h,w,Cin] NHWC contiguous, weight
    [Cin,1,3,3] and bias [1] in x's dtype → y [N,ho,wo,1] contiguous in
    ``out_dtype`` (default x's): the stride-2 transposed conv to one
    channel, its [:ho, :wo] ``crop`` (None keeps the whole [2h+1, 2w+1]
    grid), plus the bias, without a GELU. On a CUDA tensor this is the
    kernel, forward and backward; on a CPU tensor, the plain versions.
    Differentiable in x, weight and bias."""
    return _HeadOut.apply(x, weight, bias, crop, out_dtype or x.dtype)
