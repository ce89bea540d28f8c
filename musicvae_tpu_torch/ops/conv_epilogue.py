"""The epilogue of every cuDNN conv and transposed conv of the conv pyramid
(models/layers.py ``ConvTrunk``, ``_upsample``, ``PatchHead``): bias, the
transposed conv's crop and the tanh-GELU forward; GELU′, the cropped
edge's zero gradient and the bias gradient backward, in one hand-written
CUDA pass each way (csrc/conv_epilogue.cu).

The JAX package has no kernel here (XLA fuses the same work into its conv);
this takes the place of ATen's chain around a conv called with a bias: the
broadcast bias add, the strided GELU on the cropped view, and in the
backward ``gelu_backward``, ``slice_backward``'s NCHW zero fill and copy,
the copy back to the saved input's channels-last layout and the bias
gradient's reduction. The convs run with ``bias=None``.

``conv_epilogue`` launches the forward kernel for a CUDA tensor and takes
the plain version ``conv_epilogue_ref`` only for a CPU tensor;
differentiated, its backward launches the backward kernel for a CUDA
tensor and takes ``conv_epilogue_bwd_ref`` only for a CPU tensor. Both
plain versions are ATen's chain itself, and the card holds the kernels to
them (chip_smoke.py ``epilogue``). ``conv_block`` is what the layers call:
the conv and its epilogue on NHWC activations, on the CPU ATen's conv with
its bias and the same chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from musicvae_tpu_torch.ops import _kernels
# head_out imports this module too (its plain versions): bound as a module,
# read at call time
from musicvae_tpu_torch.ops import head_out as _head_out

# Launch geometry, the kernels' own (csrc/conv_epilogue.cu): a thread takes
# GROUP consecutive elements at a time, a block THREADS threads, and the
# grid strides over the groups. The forward launches a block for every
# THREADS groups, at most FWD_MAX_BLOCKS (4 on each of an H100's 132 SMs);
# the backward one for every BWD_GROUPS_A_THREAD · THREADS groups, at most
# BWD_MAX_BLOCKS (2 an SM), so that the last block sums few partials. The
# channel count must divide CHUNK, so that a thread's channels never
# change.
THREADS = 256
GROUP = 8
CHUNK = THREADS * GROUP
FWD_MAX_BLOCKS = 4 * 132
BWD_MAX_BLOCKS = 2 * 132
BWD_GROUPS_A_THREAD = 4
_DTYPES = (torch.bfloat16, torch.float32)

Crop = Optional[Tuple[int, int]]


def fwd_blocks(elements: int) -> int:
    """The forward's blocks for ``elements`` written elements."""
    return max(1, min(-(-elements // CHUNK), FWD_MAX_BLOCKS))


def bwd_blocks(elements: int) -> int:
    """The backward's blocks for a conv output of ``elements`` elements: a
    function of the shape alone, so the bias gradient's sum order (its
    partials ``[blocks, C]``) is the same on every card and every run."""
    return max(1, min(-(-elements // (BWD_GROUPS_A_THREAD * CHUNK)),
                      BWD_MAX_BLOCKS))


def _kept(c: torch.Tensor, crop: Crop) -> Tuple[int, int]:
    return tuple(c.shape[2:]) if crop is None else crop


def _chain(h: torch.Tensor, crop: Crop, gelu: bool,
           out_dtype: torch.dtype) -> torch.Tensor:
    """ATen's chain after the bias: the [:ho, :wo] ``crop`` of h [N,C,H,W],
    the tanh-GELU (``gelu``), the cast, as an NHWC view."""
    if crop is not None:
        h = h[:, :, :crop[0], :crop[1]]
    if gelu:
        h = F.gelu(h, approximate="tanh")
    return h.to(out_dtype).permute(0, 2, 3, 1)


def conv_epilogue_ref(c: torch.Tensor, b: torch.Tensor, crop: Crop = None,
                      gelu: bool = True,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: ATen's chain after a conv with a bias. c [N,C,H,W]
    (the conv's output, any layout) and b [C] in the compute dtype →
    y [N,ho,wo,C] contiguous in ``out_dtype`` (default c's): c + b, the
    [:ho, :wo] ``crop``, the tanh-GELU (``gelu``), the cast."""
    return _chain(c + b.view(1, -1, 1, 1), crop, gelu,
                  out_dtype or c.dtype).contiguous()


def conv_epilogue_bwd_ref(c: torch.Tensor, b: torch.Tensor,
                          dy: torch.Tensor, crop: Crop = None,
                          gelu: bool = True):
    """Plain version of the backward: (dc [N,C,H,W] in c's dtype, db [C])
    from dy [N,ho,wo,C], by the ops autograd runs for the chain: the
    cast's backward, ``gelu_backward``, with a crop ``slice_backward``'s
    contiguous NCHW gradient, zero on the cropped edge, and the bias
    gradient's sum over dc."""
    g = dy.permute(0, 3, 1, 2).to(c.dtype)
    s = c + b.view(1, -1, 1, 1)
    if crop is not None:
        s = s[:, :, :crop[0], :crop[1]]
    if gelu:
        g = torch.ops.aten.gelu_backward(g, s, approximate="tanh")
    if crop is None:
        dc = g
    else:
        dc = torch.zeros(c.shape, dtype=c.dtype, device=c.device)
        dc[:, :, :crop[0], :crop[1]] = g
    return dc, dc.sum((0, 2, 3))


def check(name: str, c: torch.Tensor, b: torch.Tensor, crop: Crop,
          out_dtype: torch.dtype) -> Tuple[int, int]:
    """What the kernels take, raised on otherwise (the wrapper runs it for
    a CUDA tensor; it reads nothing of the card): c [N,C,H,W] channels-last
    dense in bf16 or f32, C dividing CHUNK, fewer than 2^31 elements; b [C]
    in c's dtype; the crop inside the grid; a bf16 or f32 output; every
    tensor 16-byte aligned. Returns the kept grid (ho, wo)."""
    if c.dim() != 4:
        raise ValueError(f"{name}: c must be [N,C,H,W], got {tuple(c.shape)}")
    if c.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"{name}: c {c.dtype} and out_dtype {out_dtype} "
                         f"must each be one of {_DTYPES}")
    n, ch, hc, wc = c.shape
    if CHUNK % ch:
        raise ValueError(f"{name}: C={ch} must divide {CHUNK}")
    if not c.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError(f"{name}: c must be channels-last (NHWC) dense, "
                         f"got strides {c.stride()}")
    if c.numel() >= 2 ** 31:
        raise ValueError(f"{name}: c has {c.numel()} elements, 2^31 or more")
    if tuple(b.shape) != (ch,) or b.dtype != c.dtype:
        raise ValueError(f"{name}: b must be [{ch}] in {c.dtype}, got "
                         f"{b.dtype} {tuple(b.shape)}")
    _kernels.check_cuda_inputs(name, c.device, b=b)
    ho, wo = _kept(c, crop)
    if not (0 < ho <= hc and 0 < wo <= wc):
        raise ValueError(f"{name}: crop {(ho, wo)} outside the {(hc, wc)} "
                         f"grid")
    _kernels.check_aligned(name, c=c, b=b)
    return ho, wo


def _forward(c, b, crop: Crop, gelu: bool, out_dtype: torch.dtype):
    name = "conv_epilogue"
    if _kernels.on_cpu(name, c):
        return conv_epilogue_ref(c, b, crop, gelu, out_dtype)
    ho, wo = check(name, c, b, crop, out_dtype)
    n, ch, hc, wc = c.shape
    y = torch.empty((n, ho, wo, ch), dtype=out_dtype, device=c.device)
    if n == 0:
        return y
    stream = _kernels.stream_of(c)
    rc = _kernels.lib().mvk_conv_epilogue(
        c.data_ptr(), _kernels.KINDS[c.dtype], b.data_ptr(), y.data_ptr(),
        _kernels.KINDS[out_dtype], n, hc, wc, ch, ho, wo, int(gelu),
        fwd_blocks(y.numel()), stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return y


def _backward(c, b, dy, crop: Crop, gelu: bool):
    """(dc, db): the kernel on a CUDA tensor."""
    name = "conv_epilogue_bwd"
    if _kernels.on_cpu(name, c):
        return conv_epilogue_bwd_ref(c, b, dy, crop, gelu)
    ho, wo = check(name, c, b, crop, dy.dtype)
    n, ch, hc, wc = c.shape
    if tuple(dy.shape) != (n, ho, wo, ch):
        raise ValueError(f"{name}: dy must be [{n},{ho},{wo},{ch}], got "
                         f"{tuple(dy.shape)}")
    _kernels.check_cuda_inputs(name, c.device, dy=dy)
    _kernels.check_aligned(name, dy=dy)
    # c's channels-last strides; with one channel the memory is NCHW's too,
    # and NCHW strides, as slice_backward's gradient had, keep cuDNN's
    # weight-gradient engine for the head's last layer (with channels-last
    # ones it takes a generic NHWC engine, 0.14 ms slower a c3 step)
    dc = torch.empty_like(c, memory_format=torch.contiguous_format
                          if ch == 1 else torch.preserve_format)
    db = torch.empty_like(b)
    if n == 0:
        return dc, db.zero_()
    grid = bwd_blocks(c.numel())
    partials = torch.empty((grid, ch), dtype=torch.float32, device=c.device)
    stream = _kernels.stream_of(c)
    rc = _kernels.lib().mvk_conv_epilogue_bwd(
        dy.data_ptr(), _kernels.KINDS[dy.dtype], c.data_ptr(),
        _kernels.KINDS[c.dtype], b.data_ptr(), dc.data_ptr(),
        partials.data_ptr(), _kernels.ticket(c.device, stream).data_ptr(),
        db.data_ptr(), n, hc, wc, ch, ho, wo, int(gelu), grid, stream)
    _kernels.check(rc, name)
    _kernels.launched(name, stream)
    return dc, db


class _ConvEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, b, crop, gelu, out_dtype):
        ctx.save_for_backward(c, b)     # not y: the backward recomputes c + b
        ctx.crop, ctx.gelu = crop, gelu
        return _forward(c, b, crop, gelu, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        c, b = ctx.saved_tensors
        # the next conv's input gradient arrives channels-last, so dy is
        # contiguous NHWC there and this copies nothing; a model-parallel
        # gather's slice of it is not
        dc, db = _backward(c, b, dy.contiguous(), ctx.crop, ctx.gelu)
        return dc, db, None, None, None


def conv_epilogue(c: torch.Tensor, b: torch.Tensor, crop: Crop = None,
                  gelu: bool = True,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The epilogue of a conv called without its bias: c [N,C,H,W] (the
    conv's output, channels-last on the card), b [C] in c's dtype →
    y [N,ho,wo,C] contiguous NHWC in ``out_dtype`` (default c's):
    gelu(c + b) over the kept grid [:ho, :wo] (``crop``; None keeps it
    whole), without the GELU when ``gelu`` is False. On a CUDA tensor
    this is the kernel, forward and backward; on a CPU tensor, the plain
    versions. Differentiable in c and b; the cropped edge's gradient is
    zero."""
    return _ConvEpilogue.apply(c, b, crop, gelu, out_dtype or c.dtype)


def conv_block(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stride, padding, transposed: bool = False, crop: Crop = None,
               gelu: bool = True,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A conv (``transposed``: a transposed conv) of the pyramid with its
    epilogue, on NHWC activations: x [N,H,W,Cin] → [N,ho,wo,C] in
    ``out_dtype`` (default x's): the conv by ``weight`` and ``bias`` (in
    x's dtype), the [:ho, :wo] ``crop``, the tanh-GELU (``gelu``).

    On a CUDA tensor cuDNN runs the conv without its bias on x's NCHW view
    (channels-last, so its output is too) and ``conv_epilogue``'s kernels
    do the rest, into a contiguous tensor; but the decoder head's last
    layer, a transposed conv to one channel (``head_out.takes``: weight
    [Cin,1,3,3], stride 2, padding 0), for which cuDNN has no channels-last
    engine, is ``head_out``'s kernels whole (no GELU: it raises on one).
    On a CPU tensor it is the plain version: ATen's conv with its bias and
    the plain versions' chain after it, returned as an NHWC view, the bits
    the CPU tests hold against the JAX package (a
    CPU conv may add its bias before rounding its output, where cuDNN and
    the epilogue add it after)."""
    op = F.conv_transpose2d if transposed else F.conv2d
    out_dtype = out_dtype or x.dtype
    if _kernels.on_cpu("conv_block", x):
        return _chain(op(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                         padding=padding), crop, gelu, out_dtype)
    if _head_out.takes(weight, stride, padding, transposed):
        if gelu:
            raise ValueError("conv_block: the one-channel transposed conv "
                             "(head_out) takes no GELU")
        return _head_out.head_out(x, weight, bias, crop, out_dtype)
    return conv_epilogue(op(x.permute(0, 3, 1, 2), weight, None,
                            stride=stride, padding=padding),
                         bias, crop, gelu, out_dtype)
