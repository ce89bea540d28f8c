"""The streaming producer's host time a step: the spans the benchmark
records around ``_stack_host_batches`` (stacking, checking and packing K
host batches) and ``_StackUploader.put`` (staging and the copies'
enqueue) on the producer thread, summed over the stacks made while the
profiler ran and divided by their steps."""


def read(run):
    t = run.trace
    if not t.get("producer_stacks"):
        return None
    return 1e3 * t["producer_s"] / (t["producer_stacks"] * t["k"])
