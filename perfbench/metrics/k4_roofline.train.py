"""K4 (ops/fused_elbo.py masked_bce_sum_dual → csrc/masked_bce.cu, the
train step's BCE sum with its gradient tile): its least time from its
bytes over its mean time in the trace. Every ``bce_sum`` kernel of a train
step is K4's."""

from perfbench import yardstick


def read(run):
    calls = [v for name, v in run.trace.get("kernels", {}).items()
             if "bce_sum<" in name]
    n_calls = sum(c for c, _ in calls)
    if not n_calls:
        return None
    m = run.spec["model"]
    cells = (run.spec["train"]["batch_size"] * m["num_bars"] * 96
             * run.spec["midi"]["num_pitches"])
    mean_s = sum(s for _, s in calls) / n_calls
    return 100.0 * yardstick.k4_bound_s(cells) / mean_s
