"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration file and its traffic file are found by name
through BENCHMARK.json at the root of the checkout; the traffic file names
the runner (perfbench/runners/<runner>.py) that runs it. ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` profiles a part of
the window and reports the cell's per-layer metrics, each read by
perfbench/metrics/<metric>.py. The last lines on standard error, and the
``checks`` of the result line, give each number compared with the
reference beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "musicvae_tpu_torch")):
        _fail(f"the program (musicvae_tpu_torch/) is not in {ROOT}")
    sys.path.insert(0, ROOT)
    from perfbench import harness

    bench = harness.benchmark()
    entry, spec, mix = harness.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: torch.cuda.is_available() is False", 3)
    if torch.cuda.device_count() < entry["chips"]:
        _fail(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", 3)
    ctx = harness.Ctx(args.workload, spec, mix, args.seed, args.seconds,
                      bool(args.trace), "cuda", entry["chips"], T_START)
    line = execute(bench, ctx)
    print(line, flush=True)
    return 0


def execute(bench: dict, ctx) -> str:
    """Everything a run does after its look for the card: the runner's
    set-up, window and reference, then the metrics, the import check and
    the result line (returned); the checks go to standard error."""
    from perfbench import harness

    runner = importlib.import_module("perfbench.runners." + ctx.mix["runner"])
    outcome = runner.run(ctx)
    metrics = {}
    breakdown = None
    if ctx.trace:
        run = harness.TraceRun(ctx, outcome.trace)
        for m in harness.layer_metrics(bench, ctx.workload):
            value = harness.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = outcome.trace.get("breakdown")
    else:
        for m in harness.end_to_end_metrics(bench, ctx.workload):
            # <quantity>.<qualifier> is the runner's <quantity> under a
            # bound of its own, in the cells it lists
            value = outcome.metrics.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = sorted(set(harness.forbidden_loaded()) | set(outcome.forbidden))
    if found:
        _fail("modules of the JAX stack or package were loaded (here or "
              f"in the server): {found}", 4)
    for name, value in metrics.items():
        if not math.isfinite(value["value"]):
            _fail(f"metric {name} is not finite: {value['value']}", 5)
    device = (harness.device_info(ctx.chips, outcome.memory_peak_bytes)
              if ctx.device == "cuda" else
              {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0})
    if ctx.trace:
        device.update(busy_s=outcome.trace["busy_s"],
                      window_s=outcome.trace["window_s"])
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    return harness.result_line(outcome, metrics, device, breakdown)


if __name__ == "__main__":
    sys.exit(main())
