"""The benchmark's arithmetic: the card's peaks, the model FLOPs of a train
step and of a generation sweep, and each hand-written kernel's bytes and
operations, all functions of the configuration's shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity).
FLOPs count a multiply-add as two; a model's FLOPs are its convolutions,
transposed convolutions, dense layers and GRU matmuls, and leave out the
elementwise work. A kernel's bytes count each input byte read once and
each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # HBM3

# the first conv's output grid (stride 2 over a 96 x 128 bar)
_CONV1_OUT = (48, 64)


def _halved(n: int) -> int:
    return -(-n // 2)


def _bar(spec: dict) -> Tuple[int, int]:
    midi = spec["midi"]
    steps = midi["bar_steps"] or (midi["steps_per_quarter"]
                                  * midi["quarters_per_bar"])
    return steps, midi["num_pitches"]


def trunk_macs(spec: dict) -> Dict[str, int]:
    """Multiply-adds of one bar through the conv stem: ``first`` (the
    first conv), ``rest`` (the other convs) and ``fc`` (the dense layer
    to the bar feature)."""
    t, p = _bar(spec)
    chans = [1, *spec["model"]["enc_channels"]]
    out = {"first": 0, "rest": 0}
    for i in range(len(chans) - 1):
        t, p = _halved(t), _halved(p)
        macs = t * p * chans[i] * chans[i + 1] * 9
        out["first" if i == 0 else "rest"] += macs
    out["fc"] = t * p * chans[-1] * spec["model"]["bar_feat_dim"]
    return out


def head_macs(spec: dict, head_in: int) -> int:
    """Multiply-adds of one bar through the decoder head: the dense layer
    and the stride-2 transposed convs (each input pixel scatters a 3x3
    window to every output channel)."""
    t, p = _bar(spec)
    dec = spec["model"]["dec_channels"]
    t, p = -(-t // 2 ** len(dec)), -(-p // 2 ** len(dec))
    macs = head_in * t * p * dec[0]
    chans = [*dec, 1]
    for i in range(len(dec)):
        macs += t * p * chans[i] * chans[i + 1] * 9
        t, p = 2 * t, 2 * p
    return macs


def _gru_macs(n_in: int, hidden: int) -> int:
    return 3 * hidden * (n_in + hidden)


def train_forward_macs(spec: dict, batch: int) -> Dict[str, int]:
    """A teacher-forced forward's multiply-adds by part, for ``batch``
    windows."""
    m = spec["model"]
    n, h, z, f = m["num_bars"], m["gru_hidden"], m["z_dim"], m["bar_feat_dim"]
    bars = batch * n
    tr = trunk_macs(spec)
    hier = m["kind"] == "hier"
    parts = {
        "enc_conv1": bars * tr["first"],
        "prev_conv1": bars * tr["first"],
        "stems": 2 * bars * (tr["rest"] + tr["fc"]),
        "enc_gru": bars * _gru_macs(f, h),
        "dec_gru": bars * _gru_macs(z + f, h),
        "h_init": batch * z * h,
        "head": bars * head_macs(spec, 2 * h if hier else h),
    }
    if hier:
        zp = m["z_phrase_dim"]
        parts["latent_heads"] = batch * h * 2 * zp + bars * (f + zp) * 2 * z
        parts["conductor"] = bars * _gru_macs(zp, h) + batch * zp * h
    else:
        parts["latent_heads"] = batch * h * 2 * z
    return parts


def train_step_flops(spec: dict, batch: int) -> float:
    """Model FLOPs of one train step: the forward's three times (forward,
    and the backward's input and weight gradients), less the first convs'
    input gradients, which the step never computes (their input is
    data)."""
    parts = train_forward_macs(spec, batch)
    fwd = sum(parts.values())
    return 2.0 * (3 * fwd - parts["enc_conv1"] - parts["prev_conv1"])


def sweep_flops(spec: dict, batch: int, bars: int, phrase: int) -> float:
    """Model FLOPs of a closed-loop generation sweep of a gru_seq model:
    ``bars`` bars of ``batch`` rows, the recurrent state started from z
    every ``phrase`` bars."""
    m = spec["model"]
    h, z, f = m["gru_hidden"], m["z_dim"], m["bar_feat_dim"]
    tr = trunk_macs(spec)
    per_bar = (sum(tr.values()) + _gru_macs(z + f, h) + head_macs(spec, h))
    starts = -(-bars // phrase)
    return 2.0 * batch * (bars * per_bar + starts * z * h)


def bound_s(nbytes: float, f32_ops: float) -> Tuple[float, str]:
    """A kernel's least time: the larger of its bytes over the HBM rate and
    its f32 operations over the f32 rate, and which one it is."""
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = f32_ops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound_s(m: int, c: int, out_bytes: int = 2) -> float:
    """K1, the first conv forward (csrc/conv1.cu) on ``m`` uint8 bars to
    ``c`` channels: x read, w and b read, the output written; 27
    operations an output (9 multiply-adds, the bias, the tanh-GELU)."""
    outs = m * _CONV1_OUT[0] * _CONV1_OUT[1] * c
    nbytes = m * 96 * 128 + 4 * (9 * c + c) + out_bytes * outs
    return bound_s(nbytes, outs * (2 * 9 + 1 + 8))[0]


def k1b_bound_s(m: int, c: int, dy_bytes: int = 2) -> float:
    """K1b, the first conv backward (csrc/conv1_bwd.cu): x and dy read, w
    and b read and their gradients written; 48 operations a dy element
    (the recomputed pre-activation, the GELU derivative, the weight and
    bias gradient terms)."""
    dy = m * _CONV1_OUT[0] * _CONV1_OUT[1] * c
    nbytes = m * 96 * 128 + dy_bytes * dy + 4 * 2 * (9 * c + c)
    return bound_s(nbytes, dy * (2 * 9 + 2 * 9 + 12))[0]


def k4_bound_s(n: int, pitches: int = 128) -> float:
    """K4, the masked BCE sum with its gradient tile (csrc/masked_bce.cu,
    dual mode): f32 logits and uint8 x read, the f32 tile written, the
    mask read and the sum written; 15 operations a cell."""
    return bound_s(4 * n + n + 4 * n + 4 * pitches + 4, 15 * n)[0]
