"""K1b (ops/conv1.py first_conv_s2's backward → csrc/conv1_bwd.cu, its
partial sums and its finishing kernel): the larger of its byte and
operation bounds over its mean time a call in the trace. A train step
calls it once a first conv (the encoder's and the previous-bar stem's),
each over every bar of the batch, with a bf16 dy."""

from perfbench import yardstick


def read(run):
    kernels = run.trace.get("kernels", {})
    calls = sum(c for name, (c, _) in kernels.items()
                if "conv1_bwd_kernel" in name)
    if not calls:
        return None
    total = sum(s for name, (_, s) in kernels.items()
                if "conv1_bwd_kernel" in name or "conv1_bwd_finish" in name)
    m = run.spec["model"]
    bars = run.spec["train"]["batch_size"] * m["num_bars"]
    return 100.0 * yardstick.k1b_bound_s(bars, m["enc_channels"][0]) / (
        total / calls)
