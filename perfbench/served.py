"""The serve cell's server: the program's ``serve`` command, run through
its own ``cli.main`` with the arguments after ``--``, in a process of its
own on the card.

    python3 perfbench/served.py --report <file> [--trace] -- serve ...

On exit it writes ``--report``: the card's memory peak, the forbidden
modules (``harness.FORBIDDEN``) this process had loaded once the server
stopped, and, with ``--trace``, what the traced window showed. Traced, the profiler runs
from the moment the server listens (after its warm-up) until it stops,
and host spans wrap, at their call sites, each call to ``bars_to_midi``
(the export of one sample) and to ``_CoalescedRunner.run`` (one coalesced
sweep: its items, and the device work it launched). The trace is reduced
over the window the load generator names in ``<report>.window`` (two
epoch nanosecond times, written before it stops the server).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _install_spans(cli, runs: list, exports: list):
    """Wrap the export and the coalesced sweep in host spans; ``runs``
    gets (start ns, end ns, items) of each sweep and ``exports`` (start
    ns, end ns) of each export."""
    from torch.profiler import record_function

    export = cli.bars_to_midi

    def bars_to_midi(*a, **kw):
        t0 = time.time_ns()
        with record_function("perfbench.export"):
            out = export(*a, **kw)
        exports.append((t0, time.time_ns()))
        return out

    run = cli._CoalescedRunner.run

    def coalesced_run(self, items):
        t0 = time.time_ns()
        with record_function("perfbench.coalesced_run"):
            out = run(self, items)
        runs.append((t0, time.time_ns(), len(items)))
        return out

    cli.bars_to_midi = bars_to_midi
    cli._CoalescedRunner.run = coalesced_run


def sweeps(runs: list, device: list) -> list:
    """Each coalesced sweep's items, its device span (its first device
    operation's start to its last one's end, seconds) and its K1 launches'
    count and seconds: the device work that starts inside the sweep's host
    span (the sweep ends by reading its bars back, so its work ends inside
    it too)."""
    starts = [s for s, _, _ in device]
    out = []
    for t0, t1, items in runs:
        mine = device[bisect.bisect_left(starts, t0):
                      bisect.bisect_left(starts, t1)]
        if not mine:
            continue
        k1 = [(e - s) * 1e-9 for s, e, n in mine if "conv1_kernel" in n]
        out.append({"items": items,
                    "device_s": (max(e for _, e, _ in mine)
                                 - min(s for s, _, _ in mine)) * 1e-9,
                    "k1_calls": len(k1), "k1_s": sum(k1)})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv[:split])
    sys.path.insert(0, ROOT)
    import torch
    from musicvae_tpu_torch import cli
    from perfbench import harness

    runs, exports, prof = [], [], None
    if args.trace:
        _install_spans(cli, runs, exports)
        serve_socket = cli.serve_socket

        def traced_serve_socket(*a, **kw):
            nonlocal prof
            prof = harness.profiler()
            prof.start()
            return serve_socket(*a, **kw)

        cli.serve_socket = traced_serve_socket
    rc = cli.main(argv[split + 1:])
    report = {"memory_peak_bytes": torch.cuda.max_memory_allocated(),
              "forbidden": harness.forbidden_loaded()}
    if prof is not None:
        prof.stop()
        with open(args.report + ".window") as f:
            w0, w1 = json.load(f)
        trace = harness.reduce_events(prof.profiler.kineto_results.events(),
                                      (w0, w1))
        trace["runs"] = sweeps([r for r in runs if r[0] >= w0 and r[1] <= w1],
                               trace.pop("device"))
        trace["export_s"] = [(e - s) * 1e-9 for s, e in exports
                             if s >= w0 and e <= w1]
        report["trace"] = trace
    with open(args.report, "w") as f:
        json.dump(report, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
