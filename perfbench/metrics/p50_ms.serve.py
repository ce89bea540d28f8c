"""The service's median latency as its users feel it: over every request
due in the traced window, from when it was due to the last byte of its
answer at the client (perfbench/runners/serve.py ``latency_metrics``; a
failed or unanswered request counts as infinitely late)."""


def read(run):
    return run.trace.get("p50_ms")
