"""The train step's model FLOPs over the traced window, as a share of the
card's dense bf16 peak."""

from perfbench import yardstick


def read(run):
    t = run.trace
    if not t.get("steps") or not t.get("window_s"):
        return None
    flops = t["flops_per_step"] * t["steps"]
    return 100.0 * flops / (t["window_s"] * yardstick.PEAK_BF16_FLOPS)
