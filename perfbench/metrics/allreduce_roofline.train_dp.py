"""The data-parallel train step's gradient all-reduce (NCCL's kernel, in
the step's graph or eager) on rank 0's card: its least time, the bucket's
bytes over one direction of the card's NVLink (perfbench/yardstick_dp.py),
over the mean device time a step of the trace's NCCL kernels. Every NCCL
kernel of the window counts against the steps: the step's all-reduce and,
once a dispatch, the stop's one-element all-reduce."""

from perfbench import yardstick_dp


def read(run):
    t = run.trace
    calls = [v for name, v in t.get("kernels", {}).items()
             if "nccl" in name.lower()]
    seconds = sum(s for _, s in calls)
    if not calls or not seconds or not t.get("steps"):
        return None
    return 100.0 * yardstick_dp.allreduce_bound_s(run.spec) / (
        seconds / t["steps"])
