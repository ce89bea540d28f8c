"""The parity trunk's first conv (3x3, stride 2, pad 1, 1→C channels, bias,
tanh-GELU) through a hand-written CUDA kernel (csrc/conv1.cu).

Counterpart of the JAX package's ops/conv1_pallas.py ``first_conv_s2``,
forward only, in the same NHWC layout. ``first_conv_s2`` launches the
kernel for a CUDA tensor and takes the plain version ``first_conv_s2_ref``
only for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from musicvae_tpu_torch.ops import _kernels

T_IN, P_IN = 96, 128          # bar roll
T_OUT, P_OUT = 48, 64         # stride-2 output
CHANNELS = (4, 8, 16, 32)     # output widths the kernel is built for
_OUT_DTYPES = (torch.bfloat16, torch.float32)


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


def first_conv_s2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  gelu: bool = True,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stride-2 3x3 single-channel conv + bias (+ tanh-GELU).

    x [M,96,128] (uint8, bf16 or f32), w [3,3,C] f32, b [C] f32 →
    [M,48,64,C] in ``out_dtype`` (bf16 or f32). On a CUDA tensor this is
    the kernel; on a CPU tensor, ``first_conv_s2_ref``."""
    if x.device.type == "cpu":
        return first_conv_s2_ref(x, w, b, gelu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"first_conv_s2: unsupported device {x.device}")
    name = "first_conv_s2"
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
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not in "
                         f"{_OUT_DTYPES}")
    _kernels.check_cuda_inputs(name, x.device, x=x, w=w, b=b)
    m = x.shape[0]
    out = torch.empty((m, T_OUT, P_OUT, c), dtype=out_dtype, device=x.device)
    rc = _kernels.lib().mvk_first_conv_s2(
        x.data_ptr(), _kernels.KINDS[x.dtype], w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _kernels.KINDS[out_dtype], m, c, int(gelu),
        _kernels.stream_of(x))
    _kernels.check(rc, name)
    _kernels.LAUNCHES[name] += 1
    return out
