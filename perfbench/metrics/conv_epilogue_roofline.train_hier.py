"""The conv pyramid's epilogue (musicvae_tpu_torch/ops/conv_epilogue.py →
csrc/conv_epilogue.cu, ``conv_epilogue_fwd`` and ``conv_epilogue_bwd``):
one train step's least time for their work over the two kernels' time a
step in the trace.

The least time is the step's bytes over the HBM rate
(``yardstick.bound_s``), computed from the configuration's shapes, each
input byte read once and each output byte written once: for every conv of
the parity stem's two trunks (the encoder's and the previous bar's; the
first conv too where no first-conv kernel takes it) and every transposed
conv of the decoder head, over every bar of the batch, the forward reads
the conv output over its kept grid and the bias and writes the activation
(the last layer: the logits); the backward reads the incoming gradient,
the conv output over the kept grid and the bias (for the GELU′: not in the
last layer, which has none), and writes the gradient over the whole
uncropped grid and the bias gradient. The operations (a few
tens of f32 operations an element) bound it ten times lower.

Read in the hierarchical model's cell alone: there a layer's conv output
(up to 209 MB) is far larger than the 50 MB L2, so the kernels read it
from HBM; c2's fit in L2, where a share of an HBM bound could pass 100 %.
A program without the kernels has no such entries: no reading."""

from perfbench import yardstick


def _halved(n: int) -> int:
    return -(-n // 2)


def _bytes(n: int, ch: int, grid, kept, e: int, o: int,
           gelu: bool) -> int:
    """One layer's forward and backward bytes over ``n`` bars: c [n, *grid,
    ch] of ``e`` bytes an element, the output of ``o``. Without the GELU
    the backward's dc is dy's rounding alone: it reads neither c nor the
    bias."""
    k = n * kept[0] * kept[1] * ch
    full = n * grid[0] * grid[1] * ch
    forward = k * e + ch * e + k * o
    backward = k * o + full * e + ch * e + (k * e + ch * e if gelu else 0)
    return forward + backward


def step_bytes(spec: dict) -> int:
    """The epilogue's bytes in one train step of a conv-stem model."""
    m, midi = spec["model"], spec["midi"]
    size = {"bfloat16": 2, "float32": 4}
    e, logits = size[m["dtype"]], size[m["logits_dtype"]]
    steps = midi["bar_steps"] or (midi["steps_per_quarter"]
                                  * midi["quarters_per_bar"])
    pitches = midi["num_pitches"]
    bars = spec["train"]["batch_size"] * m["num_bars"]
    total = 0
    trunks = 2 if m["use_prev_bar"] else 1
    t, p = steps, pitches
    for i, ch in enumerate(m["enc_channels"]):
        t, p = _halved(t), _halved(p)
        if i > 0 or not m["use_pallas_conv1"]:
            total += trunks * _bytes(bars, ch, (t, p), (t, p), e, e, True)
    dec = m["dec_channels"]
    t, p = -(-steps // 2 ** len(dec)), -(-pitches // 2 ** len(dec))
    chans = [*dec, 1]
    for i in range(len(dec)):
        grid = (2 * t + 1, 2 * p + 1)
        last = i + 1 == len(dec)
        kept = (steps, pitches) if last else (2 * t, 2 * p)
        total += _bytes(bars, chans[i + 1], grid, kept, e,
                        logits if last else e, not last)
        t, p = 2 * t, 2 * p
    return total


def read(run):
    kernels = run.trace.get("kernels", {})
    seconds = sum(s for name, (_, s) in kernels.items()
                  if "conv_epilogue_" in name)
    steps = run.trace.get("steps")
    if not seconds or not steps or run.spec["model"]["stem"] != "conv":
        return None
    least = yardstick.bound_s(step_bytes(run.spec), 0.0)[0]
    return 100.0 * least / (seconds / steps)
