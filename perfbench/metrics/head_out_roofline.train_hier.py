"""The decoder head's last layer (musicvae_tpu_torch/ops/head_out.py →
csrc/head_out.cu, ``head_out_fwd`` and ``head_out_bwd``): one train step's
least time for its work over the two kernels' time a step in the trace.

The least time is ``yardstick.bound_s`` of the step's bytes and f32
operations, computed from the configuration's shapes, each input byte read
once and each output byte written once: over every bar of the batch, the
forward reads x (the last transposed conv's input, [h, w, Cin] a bar) and
writes the logits over the kept [steps, pitches] grid; the backward reads
the logits' gradient and x and writes x's gradient; the weight and bias
are read once each way and their gradients written once (a few hundred
bytes). The operations are the layer's multiply-adds three times (the
forward, x's gradient, the weight's), 2 a multiply-add: bytes bound it.

Read in the hierarchical model's cell alone: there x (201 MB at c3's 2,048
bars) is far larger than the 50 MB L2, so the kernels read it from HBM;
c2's 25 MB x fits in L2, where a share of an HBM bound could pass 100 %. A
program without the kernels has no such entries: no reading."""

from perfbench import yardstick


def _shapes(spec: dict):
    """(bars, x's [h, w, Cin], the kept grid, x's and the logits' bytes an
    element) of a conv-stem model's last head layer."""
    m, midi = spec["model"], spec["midi"]
    size = {"bfloat16": 2, "float32": 4}
    steps = midi["bar_steps"] or (midi["steps_per_quarter"]
                                  * midi["quarters_per_bar"])
    pitches = midi["num_pitches"]
    dec = m["dec_channels"]
    up, scale = 2 ** len(dec), 2 ** (len(dec) - 1)
    h, w = -(-steps // up) * scale, -(-pitches // up) * scale
    bars = spec["train"]["batch_size"] * m["num_bars"]
    return (bars, (h, w, dec[-1]), (steps, pitches), size[m["dtype"]],
            size[m["logits_dtype"]])


def step_bytes(spec: dict) -> int:
    """The layer's bytes in one train step, forward and backward."""
    bars, (h, w, cin), (ho, wo), e, o = _shapes(spec)
    x, y = bars * h * w * cin * e, bars * ho * wo * o
    weights = (9 * cin + 1) * e
    forward = x + y + weights
    backward = y + x + x + weights + weights
    return forward + backward


def step_ops(spec: dict) -> int:
    """The layer's f32 operations in one train step: 9 multiply-adds a
    channel of every x pixel, for the forward, x's gradient and the
    weight's."""
    bars, (h, w, cin), _, _, _ = _shapes(spec)
    return 3 * 2 * 9 * bars * h * w * cin


def read(run):
    kernels = run.trace.get("kernels", {})
    seconds = sum(s for name, (_, s) in kernels.items()
                  if "head_out_" in name)
    steps = run.trace.get("steps")
    if not seconds or not steps or run.spec["model"]["stem"] != "conv":
        return None
    least = yardstick.bound_s(step_bytes(run.spec), step_ops(run.spec))[0]
    return 100.0 * least / (seconds / steps)
