"""The knee of a serve cell: one server, then windows of the cell's load at
rising rates, each reporting the rate offered and served, the latency's
median and 95th percentile, how late the generator ran, and how many
answers came after the window closed (a backlog that grew).

    python3 perfbench/sweep.py --workload <serve cell> --seed <n> \
        --seconds <s> --rates 10,20,40

The knee is the highest rate whose window serves the rate offered with no
answer left over at the close; the cell's mix runs at about four fifths
of it. Results are JSON lines on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness, traffic  # noqa: E402
from perfbench.runners import serve  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    _, spec, mix = harness.cell(harness.benchmark(), args.workload)
    ctx = harness.Ctx(args.workload, spec, mix, args.seed, args.seconds,
                      False, args.device)
    with serve.Serving(ctx, serve.serve_params(ctx), args.seconds) as sv:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            plan = traffic.schedule(rate, args.seconds,
                                    harness.derived_seed(args.seed, 10 + k))
            t0 = time.perf_counter()
            res = serve.parse(serve.drive(sv.client, plan, t0,
                                          mix["connections"]))
            m = serve.latency_metrics(plan, res, t0, args.seconds,
                                      mix["samples"])
            late = [1e3 * (r["sent"] - t0 - due)
                    for (due, _), r in zip(plan, res) if r is not None]
            print(json.dumps({
                "rate": rate, "requests": len(plan),
                "served_per_s": m["serve_req_per_s"],
                "p50_ms": m["serve_p50_ms"], "p95_ms": m["serve_p95_ms"],
                "late_p99_ms": harness.percentile(late, 99),
                "answered_after_close": sum(
                    1 for r in res
                    if r is not None and r["done"] - t0 > args.seconds)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
