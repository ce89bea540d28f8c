"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size: the program's sound runs over many seeds, the control
(the reference put in the program's place in a lower precision than the
configuration states: fp8 for bf16) and the faults a cell can have,
planted in the reference put in the program's place.

    python3 perfbench/controls.py --workload <cell> --seeds 1,2,3 \
        --variants program,control,half [--out readings.jsonl]

Train cells read the first steps alone (no measured window): ``program``
is the program's first steps; ``control`` the fp8 reference's; ``half``
the reference with half of each batch left out of the loss (the mean
taken over the rest). A step that leaves the state unchanged reads 1 on
the change by construction and needs no run. Serve cells run a short
window at the cell's own load (``--seconds``) and read, over the same
sampled responses, the program's logit gap and the control's: the gap of
the cells the fp8 reference chooses, fed the same served bars (variant
``control``). Each reading is a JSON line on standard output (and in
``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402

VARIANTS = ("program", "control", "half")


def train_readings(ctx: harness.Ctx, variant: str) -> dict:
    """The numbers a train cell compares, for one seed and variant."""
    import torch
    from perfbench.runners import train as train_runner
    from perfbench.reference import model as ref

    su = train_runner.prepare(ctx)
    if variant == "program":
        prog = train_runner.first_steps(su)
    elif variant == "control":
        prog = train_runner.reference_of(su, q=ref.fp8)
    elif variant == "half":
        prog = train_runner.reference_of(su, rows=slice(0, su.cfg.train.batch_size
                                               // 2))
    else:
        raise ValueError(f"unknown variant {variant!r}")
    su.state = su.data = None
    if su.device.type == "cuda":
        torch.cuda.empty_cache()
    return train_runner.readings(su.spec, su.p0, prog, train_runner.reference_of(su))


def serve_readings(ctx: harness.Ctx, seconds: float) -> dict:
    """The program's and the control's logit gaps over one short window's
    sampled responses."""
    from perfbench.runners import serve
    from perfbench.reference import model as ref

    plan, results, _, p0, _ = serve.window(ctx, seconds)
    picks = serve.checked(ctx, plan, results)
    bars, bad = serve.decode_all(ctx.spec, ctx.mix,
                                 [results[i]["resp"] for i in picks])
    seeds = [plan[i][1] for i in picks]
    gap = serve.logit_gap(ctx.spec, ctx.mix, p0, seeds, bars, ctx.device)
    control = serve.logit_gap(ctx.spec, ctx.mix, p0, seeds, bars,
                              ctx.device, control=ref.fp8)
    return {"gap": gap, "control_gap": control, "midi_mismatch": bad,
            "checked": len(picks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    _, spec, mix = harness.cell(bench, args.workload)
    out = open(args.out, "a") if args.out else None
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctx = harness.Ctx(args.workload, spec, mix, seed, args.seconds,
                              False, args.device)
            got = (serve_readings(ctx, args.seconds)
                   if mix["runner"] == "serve" else
                   train_readings(ctx, variant))
            line = json.dumps({"workload": args.workload, "variant": variant,
                               "seed": seed, **got,
                               "s": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
