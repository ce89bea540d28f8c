"""The process group's set-up in rank 0's process, read from the program's
own span ``dist.init`` (musicvae_tpu_torch/utils/trace.py totals, kept
whether or not the profiler runs): the rendezvous and, over NCCL, the
first collective, which makes the communicator. Part of ``setup_s``."""


def seconds(snapshot: dict):
    """Seconds from a tracer snapshot; None where it holds no such span."""
    total = snapshot.get("totals", {}).get("dist.init")
    return None if total is None else total[1]


def read(run):
    try:
        from musicvae_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    return seconds(trace.snapshot())
