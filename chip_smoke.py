#!/usr/bin/env python3
"""Drive the PyTorch port (musicvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

1. header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the hand-written kernels from csrc/;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, then timed beside its bound, its
   plain version and one library call;
3. reference: the model in f32 on the card against the same weights on
   the CPU (the path the CPU tests hold against the JAX package);
4. serve: full-width c2_gru_4bar (bf16, first-conv kernel on, seeded
   random weights) answers generation and stats requests through the
   port's serve loop; the first-conv kernel must run every bar;
5. eval: one 64x4-bar batch scored through the masked-BCE kernel, held
   against the same eval with the plain BCE.

The last lines are a "details:" JSON line with every check and timing,
the card's name and power limit, the kernels JSON object, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
K1_REPLACES = "musicvae_tpu/ops/conv1_pallas.py:112"
K2_REPLACES = "musicvae_tpu/ops/fused_elbo.py:58"
SERVE_REQUESTS = 8
SPIN_CYCLES = 2_000_000   # ~1 ms of spin: longer than the host needs to
#                           enqueue one timed kernel call
FLIP_LIMIT = 0.10   # share of generated cells the stock conv may change


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def held_ms(fn, spin_cycles: int = SPIN_CYCLES) -> float:
    """Device time of everything ``fn`` enqueues, in ms: a spin kernel
    holds the stream while the host enqueues ``fn`` between two CUDA
    events, so the events time the card's work alone, without the host's
    launch gaps. Any op in ``fn`` that would wait for the card raises
    (sync debug mode "error"); the run fails if the spin ended before the
    host finished."""
    torch.cuda._sleep(spin_cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    check(not start.query(), f"the spin ended before the host had enqueued "
                             f"the timed call ({enqueue_ms:.1f} ms); raise "
                             f"its cycles")
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, flush: torch.Tensor, iters: int = 30) -> float:
    """Mean device time of one call of ``fn`` (``held_ms``), each call
    from a cold L2: ``flush``, larger than L2, is overwritten first."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        total += held_ms(fn)
    return total / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def header():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}")
    from musicvae_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.lib()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_kernels.build_info['seconds']:.1f} s) -> "
        f"{_kernels.build_info['path']}")
    for line in _kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return card


def kernel_checks(seed: int, dev: torch.device):
    """K1 and K2 against their plain versions, then timed. Returns the
    kernels line's entries (launches filled in later) and details."""
    import torch.nn.functional as F

    from musicvae_tpu_torch.ops import conv1, fused_elbo, losses

    g = torch.Generator(dev).manual_seed(seed)
    details = {"k1": [], "k2": []}
    c = 16
    w = torch.randn((3, 3, c), generator=g, device=dev) / 3.0
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    k1_err = {}
    for m in (4, 256):
        for x_dtype in (torch.uint8, torch.bfloat16):
            x = (torch.rand((m, 96, 128), generator=g, device=dev) < 0.1)
            x = x.to(x_dtype)
            for out_dtype, tol in ((torch.float32, 1e-5),
                                   (torch.bfloat16, 1e-2)):
                got = conv1.first_conv_s2(x, w, b, True, out_dtype).float()
                ref = conv1.first_conv_s2_ref(x, w, b, True,
                                              out_dtype).float()
                err = (got - ref).abs()
                max_abs = float(err.max())
                max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
                ok = bool((err <= tol + tol * ref.abs()).all())
                case = dict(m=m, x=str(x_dtype), out=str(out_dtype),
                            max_abs_err=max_abs, max_rel_err=max_rel,
                            tol=tol, ok=ok)
                details["k1"].append(case)
                log(f"K1 first_conv_s2 {case}")
                check(ok, f"K1 disagrees with its plain version: {case}")
                k1_err[(m, x_dtype, out_dtype)] = max_abs

    crop = torch.zeros(128, device=dev)
    crop[24:108] = 1.0
    full = torch.ones(128, device=dev)
    k2_err = {}
    for shape in ((64, 4, 96, 128), (12345, 128)):
        logits = 3.0 * torch.randn(shape, generator=g, device=dev)
        xb = torch.rand(shape, generator=g, device=dev) < 0.05
        for l_dtype in (torch.float32, torch.bfloat16):
            lg = logits.to(l_dtype)
            for x_dtype in (torch.float32, torch.uint8):
                for mname, mask in (("full", full), ("crop", crop)):
                    got = fused_elbo.masked_bce_sum(lg, xb.to(x_dtype), mask)
                    again = fused_elbo.masked_bce_sum(lg, xb.to(x_dtype),
                                                      mask)
                    ref = losses.masked_bce_sum(lg, xb.to(x_dtype), mask)
                    err = abs(float(got) - float(ref))
                    rel = err / abs(float(ref))
                    case = dict(shape=list(shape), logits=str(l_dtype),
                                x=str(x_dtype), mask=mname, kernel=float(got),
                                plain=float(ref), abs_err=err, rel_err=rel,
                                same_bits_twice=bool(torch.equal(got, again)))
                    details["k2"].append(case)
                    log(f"K2 masked_bce_sum {case}")
                    check(rel <= 1e-5, f"K2 disagrees (rel {rel:.2e} > "
                                       f"1e-5): {case}")
                    check(case["same_bits_twice"],
                          f"K2 is not deterministic: {case}")
                    k2_err[(shape, l_dtype, x_dtype, mname)] = err

    # timing at the main path's shapes, each run from a cold L2
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    entries = []
    for m, path in ((4, "serve"), (256, "eval")):
        x = (torch.rand((m, 96, 128), generator=g, device=dev) < 0.05
             ).to(torch.uint8)
        x_nchw = x[:, None].to(torch.bfloat16)
        w_lib = w.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous()
        b_lib = b.to(torch.bfloat16)
        ms = time_ms(lambda: conv1.first_conv_s2(x, w, b), flush)
        plain = time_ms(lambda: conv1.first_conv_s2_ref(x, w, b), flush)
        lib_ms = time_ms(lambda: F.gelu(F.conv2d(
            x_nchw, w_lib, b_lib, stride=2, padding=1), approximate="tanh"),
            flush)
        outs = m * 48 * 64 * c
        bms, by = bound_ms(x.numel() + 4 * (w.numel() + b.numel()) + 2 * outs,
                           outs * (2 * 9 + 1 + 8))
        entries.append({
            "name": f"first_conv_s2 ({path}, M={m}, uint8 in, bf16 out)",
            "route": "cuda", "source": "musicvae_tpu_torch/csrc/conv1.cu",
            "replaces": K1_REPLACES, "launches": None,
            "max_abs_err": k1_err[(m, torch.uint8, torch.bfloat16)],
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "path": path})

    shape = (64, 4, 96, 128)
    logits = 3.0 * torch.randn(shape, generator=g, device=dev)
    xb = (torch.rand(shape, generator=g, device=dev) < 0.05)
    xu8, xf = xb.to(torch.uint8), xb.to(torch.float32)
    ms = time_ms(lambda: fused_elbo.masked_bce_sum(logits, xu8, full), flush)
    plain = time_ms(lambda: losses.masked_bce_sum(logits, xu8, full), flush)
    lib_ms = time_ms(lambda: F.binary_cross_entropy_with_logits(
        logits, xf, weight=full, reduction="sum"), flush)
    n = logits.numel()
    bms, by = bound_ms(4 * n + n + 4 * 128 + 4, 9 * n)
    entries.append({
        "name": "masked_bce_sum (eval, [64,4,96,128] f32 logits, uint8 x)",
        "route": "cuda", "source": "musicvae_tpu_torch/csrc/masked_bce.cu",
        "replaces": K2_REPLACES, "launches": None,
        "max_abs_err": k2_err[(shape, torch.float32, torch.uint8, "full")],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "path": "eval"})
    for e in entries:
        log(f"timing {e['name']}: kernel {e['ms'] * 1e3:.2f} us, plain "
            f"{e['plain_ms'] * 1e3:.2f} us, library "
            f"{e['library_ms'] * 1e3:.2f} us, bound "
            f"{e['bound_ms'] * 1e3:.2f} us ({e['bound_by']})")
    return entries, details


def reference_check(seed: int, dev: torch.device):
    """Full-width c2 in f32 with the first-conv kernel: the card against
    the CPU on the same weights and inputs (the CPU runs the kernels'
    plain versions)."""
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.models.vae import build_model

    cfg = get_config("c2_gru_4bar")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float32", use_pallas_conv1=True))
    gpu = build_model(cfg, device=dev, seed=seed)
    cpu = build_model(cfg, device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.tensor((rng.random((2, 4, 96, 128)) < 0.05).astype(np.uint8))
    eps = torch.tensor(rng.standard_normal((2, 128)).astype(np.float32))
    with torch.inference_mode():
        lg, [(mu_g, _)] = gpu(x.to(dev), eps.to(dev))
        lc, [(mu_c, _)] = cpu(x, eps)
    err = float((lg.cpu() - lc).abs().max())
    mu_err = float((mu_g.cpu() - mu_c).abs().max())
    log(f"reference: f32 c2 forward card vs CPU: logits max abs diff "
        f"{err:.3e}, mu {mu_err:.3e}")
    check(bool(torch.isfinite(lg).all()), "non-finite logits")
    check(err <= 1e-3 and mu_err <= 1e-4,
          f"card and CPU disagree: logits {err}, mu {mu_err}")
    return {"logits_max_abs_diff": err, "mu_max_abs_diff": mu_err}


def serve_phase(seed: int, dev: torch.device):
    from musicvae_tpu_torch.cli import Service, serve_stream
    from musicvae_tpu_torch.config import GenSpec, get_config
    from musicvae_tpu_torch.midi import smf, tensorize
    from musicvae_tpu_torch.models.vae import build_model
    from musicvae_tpu_torch.ops import _kernels

    base = get_config("c2_gru_4bar")
    cfg = base.replace(
        model=dataclasses.replace(base.model, use_pallas_conv1=True),
        gen=GenSpec(num_bars=16, num_samples=4))
    model = build_model(cfg, device=dev, seed=seed)
    service = Service(cfg, model)
    service.warm()
    seeds = [seed * 1000 + i for i in range(SERVE_REQUESTS)]
    lines = [json.dumps({"id": i, "seed": s}) for i, s in enumerate(seeds)]
    lines.append(json.dumps({"id": "stats", "cmd": "stats"}))
    out = io.StringIO()
    _kernels.reset_launches()
    serve_stream(service, io.StringIO("\n".join(lines) + "\n"), out)
    launches = dict(_kernels.LAUNCHES)
    log(f"serve launches: {launches}")
    check(launches["first_conv_s2"] == 16 * SERVE_REQUESTS,
          f"K1 launched {launches['first_conv_s2']} times, expected "
          f"{16 * SERVE_REQUESTS} (one per generated bar)")
    resp = [json.loads(ln) for ln in out.getvalue().splitlines()]
    check(len(resp) == SERVE_REQUESTS + 1, f"{len(resp)} responses")
    ticks_16_bars = 16 * cfg.midi.quarters_per_bar * 480
    latencies = []
    for r in resp[:-1]:
        check("error" not in r, f"request failed: {r.get('error')}")
        check(len(r["midi_b64"]) == 4, "expected 4 samples")
        check(0.0 <= r["density"] <= 1.0, f"density {r['density']}")
        for m in r["midi_b64"]:
            midi = smf.parse_smf(base64.b64decode(m))
            check(all(nt.end_tick <= ticks_16_bars for nt in midi.notes),
                  "a note beyond 16 bars")
        latencies.append(r["latency_ms"])
    stats = resp[-1]["stats"]
    check(stats["served"] == SERVE_REQUESTS and stats["errors"] == 0,
          f"stats {stats}")
    log(f"serve latency_ms per request: {latencies}")
    log(f"serve densities: {[round(r['density'], 4) for r in resp[:-1]]}")

    # the first response re-derived (16 bars per sample, byte for byte),
    # with its latency split: sweep on the card, pull, MIDI export
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bars = service.generate(torch.Generator(dev).manual_seed(seeds[0]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bars_np = bars.cpu().numpy()
    t2 = time.perf_counter()
    exported = [base64.b64encode(tensorize.bars_to_midi_bytes(
        bars_np[i], cfg.midi)).decode() for i in range(bars_np.shape[0])]
    t3 = time.perf_counter()
    split = {"sweep_ms": (t1 - t0) * 1e3, "pull_ms": (t2 - t1) * 1e3,
             "export_ms": (t3 - t2) * 1e3,
             "notes": int(sum(len(tensorize.roll_to_note_arrays(
                 bars_np[i], cfg.midi)[0]) for i in range(4)))}
    # one generated bar's work on the card, with the host out of the way
    # (a whole sweep is ~1000 launches, more than the launch queue holds)
    b = cfg.gen.num_samples
    h = torch.zeros(b, cfg.model.gru_hidden, dtype=torch.bfloat16,
                    device=dev)
    z = torch.randn(b, cfg.model.z_dim, device=dev)
    reset = torch.ones(b, device=dev)
    prevs = [bars[:, k].contiguous() for k in range(16)]
    with torch.inference_mode():
        bar_ms = [held_ms(lambda: model.step(h, prev, z, reset),
                          spin_cycles=40_000_000) for prev in prevs]
    split["bar_device_ms"] = sum(bar_ms) / len(bar_ms)
    split["device_busy_share"] = 16 * split["bar_device_ms"] / split[
        "sweep_ms"]
    log(f"serve request split: {split} (bar_device_ms: one bar's work on "
        "the card with the host out of the way; the rest host clock)")
    check(exported == resp[0]["midi_b64"], "re-export differs")
    check(tuple(bars.shape) == (4, 16, 96, 128) and bars.dtype == torch.uint8,
          f"bars {tuple(bars.shape)} {bars.dtype}")
    for i, m in enumerate(resp[0]["midi_b64"]):
        raw = base64.b64decode(m)
        check(raw == tensorize.bars_to_midi_bytes(bars_np[i], cfg.midi),
              "response MIDI differs from the sweep's export")
        pitch, start, end = tensorize.roll_to_note_arrays(bars_np[i],
                                                          cfg.midi)
        notes = smf.parse_smf(raw).notes
        check([(n.pitch, n.start_tick, n.end_tick) for n in notes]
              == list(zip(pitch.tolist(), start.tolist(), end.tolist())),
              "parsed notes differ from the 16 generated bars")

    # the same seeds through the stock conv (cuDNN), same weights
    stock_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, use_pallas_conv1=False))
    stock = build_model(stock_cfg, device=dev)
    stock.load_state_dict(model.state_dict(), strict=True)
    stock_service = Service(stock_cfg, stock)
    differ = first_bar_differ = total = 0
    for s in seeds:
        a = service.generate(torch.Generator(dev).manual_seed(s))
        b = stock_service.generate(torch.Generator(dev).manual_seed(s))
        differ += int((a != b).sum())
        first_bar_differ += int((a[:, 0] != b[:, 0]).sum())
        total += a.numel()
    share = differ / total
    log(f"serve kernel vs stock conv: {differ} of {total} cells differ "
        f"({share:.4%}); bar 0: {first_bar_differ} cells")
    check(share <= FLIP_LIMIT, f"{share:.2%} of cells differ from the "
                               f"stock-conv path (limit {FLIP_LIMIT:.0%})")
    return launches, {"latency_ms": latencies, "stats": stats,
                      "request_split": split,
                      "stock_conv_differ_cells": differ,
                      "stock_conv_total_cells": total,
                      "stock_conv_first_bar_differ": first_bar_differ}


def eval_phase(seed: int, dev: torch.device):
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.models.vae import build_model
    from musicvae_tpu_torch.ops import _kernels, losses
    from musicvae_tpu_torch.utils.metrics import eval_metrics, make_eval_fn

    base = get_config("c2_gru_4bar")
    cfg = base.replace(model=dataclasses.replace(
        base.model, use_pallas_conv1=True))
    model = build_model(cfg, device=dev, seed=seed + 1)
    g = torch.Generator(dev).manual_seed(seed)
    x = (torch.rand((64, 4, 96, 128), generator=g, device=dev) < 0.05
         ).to(torch.uint8)
    eps = torch.randn((64, cfg.model.z_dim), generator=g, device=dev)
    eval_fn = make_eval_fn(cfg, model)
    eval_fn(x, eps)                                   # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    m = eval_fn(x, eps)
    got = {k: float(v) for k, v in m.items()}         # syncs
    dt = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    log(f"eval launches: {launches}; eval {dt * 1e3:.2f} ms (host clock)")
    check(launches["masked_bce_sum"] >= 1, "K2 was not launched in eval")
    check(launches["first_conv_s2"] == 2,
          "K1 should run twice in eval (enc_feat, prev_feat)")
    check(all(np.isfinite(v) for v in got.values()), f"non-finite {got}")
    with torch.inference_mode():
        logits, latents = model(x, eps)
        plain = {k: float(v) for k, v in eval_metrics(
            cfg, logits, x, latents, bce_sum=losses.masked_bce_sum).items()}
    log(f"eval kernel: {got}")
    log(f"eval plain:  {plain}")
    for k in ("loss", "recon", "kl", "f1", "precision", "recall"):
        rel = abs(got[k] - plain[k]) / max(abs(plain[k]), 1e-12)
        check(rel <= 1e-5, f"eval {k}: kernel {got[k]} vs plain "
                           f"{plain[k]} (rel {rel:.2e})")
    return launches, {"kernel": got, "plain": plain, "eval_ms_host": dt * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    card = header()
    entries, kdetails = kernel_checks(args.seed, dev)
    ref = reference_check(args.seed, dev)
    serve_launches, serve = serve_phase(args.seed, dev)
    eval_launches, evals = eval_phase(args.seed, dev)

    runs = {"serve": serve_launches, "eval": eval_launches}
    for e in entries:
        kname = e["name"].split()[0]
        e["launches"] = runs[e.pop("path")][kname]
        check(e["launches"] > 0, f"{kname} not launched on its path")

    log("details: " + json.dumps({
        "kernel_checks": kdetails, "reference": ref, "serve": serve,
        "eval": evals, "torch": torch.__version__,
        "cuda": torch.version.cuda}))
    log(card)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
