"""The coalescing layer's width in use: requests a call of
``_CoalescedRunner.run`` (cli.py, fed by ``_Batcher``) carried, over the
calls of the traced window."""


def read(run):
    runs = run.trace.get("runs")
    if not runs:
        return None
    return sum(r["items"] for r in runs) / len(runs)
