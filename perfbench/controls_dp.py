"""The readings the data-parallel cell's limits of ``correct`` are set
from, on the cell's cards at its own size (perfbench/controls.py's, for
the cell whose runner is ``train_dp``):

    python3 perfbench/controls_dp.py --workload c4_cond.train-dp4 \
        --seeds 1,2,3 --variants program,skip_allreduce,control,half \
        [--out readings.jsonl]

``program``: every rank's first three steps (eager, capture, replay)
against the reference at the global batch, the worst rank's, and the
replicas' gap after them: one launch of the cell's processes a seed, no
measured window. ``skip_allreduce``: the same with the last rank keeping
its own gradients and metrics (the fault a data-parallel step can have:
the all-reduce still runs, its result dropped). ``control``: the
reference in fp8, the precision below the configuration's bf16, in the
program's place (one process). ``half``: the reference with half of the
global batch left out of the loss (one process). A step that leaves the
state unchanged reads 1 on the change by construction and needs no run.
Each reading is a JSON line on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402

VARIANTS = ("program", "skip_allreduce", "control", "half")


def readings(ctx: harness.Ctx, variant: str) -> dict:
    """The numbers the cell compares, for one seed and variant."""
    import torch
    from perfbench.reference import model as ref
    from perfbench.runners import train as train_runner
    from perfbench.runners import train_dp

    if variant in ("program", "skip_allreduce"):
        faults = ({ctx.chips - 1: "skip_allreduce"}
                  if variant == "skip_allreduce" else {})
        su, _, gap, _, firsts, _ = train_dp.launch(
            ctx, train_runner.PRE_STEPS, faults=faults)
        su.state = su.data = None
        got = train_dp.worst_readings(su, firsts, train_dp.reference_of(su))
        return dict(got, replica=gap)
    if variant not in ("control", "half"):
        raise ValueError(f"unknown variant {variant!r}")
    dev = torch.device(ctx.device)
    su = train_dp.prepare(ctx, dev)
    su.state = su.data = None
    prog = (train_dp.reference_of(su, q=ref.fp8) if variant == "control"
            else train_dp.reference_of(
                su, rows=slice(0, su.cfg.train.batch_size // 2)))
    return train_runner.readings(su.spec, su.p0, prog,
                                 train_dp.reference_of(su))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chips", type=int, default=None,
                    help="processes of a launch (default: the cell's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    entry, spec, mix = harness.cell(bench, args.workload)
    chips = args.chips or entry["chips"]
    out = open(args.out, "a") if args.out else None
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctx = harness.Ctx(args.workload, spec, mix, seed, 0.0, False,
                              args.device, chips)
            line = json.dumps({"workload": args.workload, "variant": variant,
                               "seed": seed, "chips": chips,
                               **readings(ctx, variant),
                               "s": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
