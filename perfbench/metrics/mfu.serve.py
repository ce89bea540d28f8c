"""The coalesced sweeps' model FLOPs over their spans on the device (each
sweep's first device operation to its last), as a share of the card's
dense bf16 peak. A sweep of one request runs at width 1, of more at the
full coalescing width."""

from perfbench import yardstick


def read(run):
    t = run.trace
    runs = t.get("runs")
    if not runs:
        return None
    spec = run.spec
    flops = sum(yardstick.sweep_flops(
        spec, (1 if r["items"] == 1 else t["coalesce"]) * t["samples"],
        t["bars"], spec["model"]["num_bars"]) for r in runs)
    device_s = sum(r["device_s"] for r in runs)
    return 100.0 * flops / (device_s * yardstick.PEAK_BF16_FLOPS)
