"""K1 (ops/conv1.py first_conv_s2 → csrc/conv1.cu, the previous bar's
first conv, once a bar of a sweep): its least time from its bytes (or
operations) over its time in the trace, summed over the sweeps' launches;
a launch covers the sweep's rows (width × samples bars)."""

from perfbench import yardstick


def read(run):
    t = run.trace
    runs = [r for r in t.get("runs", ()) if r["k1_calls"]]
    if not runs:
        return None
    c = run.spec["model"]["enc_channels"][0]
    bound = sum(r["k1_calls"] * yardstick.k1_bound_s(
        (1 if r["items"] == 1 else t["coalesce"]) * t["samples"], c)
        for r in runs)
    return 100.0 * bound / sum(r["k1_s"] for r in runs)
