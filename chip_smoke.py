#!/usr/bin/env python3
"""Drive the PyTorch port (musicvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--only PHASES] [--log-file PATH]

(``--dp-worker`` and ``--tp-worker`` are the processes the parallel and
tp phases start.)

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

1. header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the hand-written kernels from csrc/;
2. kernels: each of the seven TPU kernels' ports against its plain PyTorch version on
   the card, at the shapes the main path gives it and at ragged ones, then
   timed beside its bound, its plain version and one library call;
2b. epilogue: the conv epilogue (ops/conv_epilogue.py): one eager train
   step of c2_gru_4bar and c3_hier_16bar (first-conv kernels on) and of
   c2_mxu at registered width launches its forward and backward kernels
   once for every conv and transposed conv of the pyramid but the head's
   last layer (12 + 12, and that layer's 1 + 1; 9 + 9 for c2_mxu, whose
   patch head has none) and never the plain versions; each of those layers'
   shapes on seeded inputs against the plain versions (forward and dc
   within 1 bf16 ulp, the share not bit-equal printed, dc zero on the
   cropped edge, db within 1 ulp and 1e-5 of the channel's absolute sum),
   then timed from a cold L2 beside the plain versions and the byte
   bound, summed over a step;
2c. head_out: the decoder head's last layer (ops/head_out.py): the ptxas
   report of its kernels; one eager train step of c2_gru_4bar and
   c3_hier_16bar launches them 1 + 1 and the epilogue 12 + 12; at their
   shapes (256 and 2,048 bars) and at ragged ones the kernels against the
   plain versions (forward and dx within 1 ulp of x's dtype at the conv
   sum's size plus the f32 sum's reordering, dW and db within 2^-7
   relative and 1e-5 of their absolute sums), two runs bit-equal, a
   captured graph's replay equal to the eager calls bit for bit; each
   timed from a cold L2 beside its byte bound, the plain versions and the
   path it replaces (cuDNN's transposed conv and its gradients with the
   epilogue's two launches);
3. reference: the model in f32 on the card against the same weights on
   the CPU (the path the CPU tests hold against the JAX package);
4. serve: full-width c2_gru_4bar (bf16, first-conv kernel on, seeded
   random weights) answers generation and stats requests through the
   port's serve loop; the first-conv kernel must run every bar (counted
   through the sweep graph's replays); the served sweep's captured graphs
   equal the eager sweep body bit for bit over 4 seeds, with and without
   a seed bar, and other seeds give other bars; p50 latency and req/s of
   stdin serving, graphs and eager (``debug_mode(disable_jit=True)``) in
   turns; then ``--coalesce 4``'s sweep: the runner's warm-up captures
   both tiers (W=1, W=4; K1 16 times a replay), 3 full-width sweeps and a
   lone one equal eager ones bit for bit with every slot's generator,
   which ends where a serial request's does, the slots' bars held to
   serial serving under the flip rule; the sweep's ms and stdin req/s,
   graph and eager in turns;
5. eval: one 64x4-bar batch scored through the masked-BCE kernel, held
   against the same eval with the plain BCE; the eval of a model and of
   its EMA model as captured graphs, each its own (K1 twice and K2 once
   a replay), 4 batches each equal to eager bit for bit, and ms a batch
   graph and eager in turns; the reconstruction of 6 [1, 4] windows as a
   captured graph (K1 twice a replay), equal to eager bit for bit with
   each window's generator, and ms a window, graph and eager;
6. fused_elbo: ``fused_elbo()`` and its gradients (the single-output BCE
   kernel, its backward kernel and the KL pair) against ``elbo_loss``
   under autograd;
7. train: full-width c2_gru_4bar (bf16, batch 64) takes 20 steps in 5-step
   dispatches through ``train()`` on a seeded bar cache resident on the
   card, each step after the first a replay of the captured step graph.
   The dual-output BCE kernel must run once a step and the loss must
   fall; the same run repeated gives the same loss and parameter bits;
   the run, and the same 20 steps as one-step dispatches, equal 20 eager
   ``make_train_step_indexed`` steps from the same initial bits (every
   step's loss, the parameters, Adam moments, count, step and the
   generator's state, bit for bit); 5 steps with the plain BCE, and 5
   with the first conv's forward and backward kernels, must agree with
   it (K1/K1b twice a step, counted through replays); a dispatch must not
   wait on the card; then steps/s, host and enqueue ms, one step's device
   time and the device-busy share, graph and eager in turns, with and
   without deterministic algorithms, with the capture and instantiate
   times and the graph's pool; a steady graph dispatch is K graph
   launches and no kernel launched from the step body, and its kernels
   by name (torch.profiler) are the launches the wrappers counted, the
   conv epilogue's 12 + 12 a step with the first-conv kernels (14 + 14
   without) and the head's last layer's 1 + 1 among them, graph and
   eager. Then
   the streamed dispatch (``train --stream``'s) as a captured graph:
   ``train()`` on an iterator (20 steps in dispatches of 5 behind the
   producer thread) and 20 one-step streamed dispatches equal 20 eager
   steps on the unpacked rolls bit for bit (every loss, the state, the
   generator; K4 once a replay); streamed dispatches over uploaded
   stacks timed graph and eager in turns as the resident ones are;
   ``train()``'s steps/s streamed (graph and eager) against resident at
   K = 5 and K = 100, and the producer's host ms a stack at both;
8. ckpt: full-width c2_gru_4bar checkpoints: 20 steps with a save every
   10 equal 10 steps restored from disk into a fresh state and 10 more,
   bit for bit; a truncated latest step falls back to the one before and
   is quarantined; the CLI trains, resumes, describes, evaluates (the
   BCE kernel) and serves (the first-conv kernel: the two warm-up
   sweeps, eager then captured, and the request's replay) from the
   checkpoint; save and restore times;
9. corpus: MIDI in → train → MIDI out through the CLI: 64 synthetic
   pieces of 32 bars written as .mid files with a label sidecar; the
   native parser must have built, and it and the pure-Python codec must
   give the same bars; ``preprocess``; ``train --midi-glob
   --use-pallas-conv1`` for 10 steps at batch 64 (K4 once a step, K1b
   twice, K2 once an eval batch; the loss must fall); ``generate
   --seed-midi --encode --interpolate --interp-midi-b`` twice in each of
   Bernoulli and threshold mode (K1 for both encodes and every bar; runs
   with one seed equal bit for bit; the MIDI files tensorize back to
   rolls.npy), and a Bernoulli sweep with the draws handed in, held
   against the CPU; ``reconstruct`` two files; ``eval-gen`` and ``eval
   --midi-glob`` (K2). Host times of each command;
10. serve_stack: the production serve stack, full-width c2_gru_4bar
   (bf16, 4 x 16 bars) on a checkpoint whose config turns the first-conv
   kernel on: serial serving and ``--coalesce 4`` answer 8 seeds, plain
   and seeded, alike under the flip rule (a cell may flip only where
   sigma lies within 1e-3 of the threshold; flips and margins printed),
   K1 at M=4 for a lone request and M=16 for a coalesced one (each
   tier's M at its capture in the warm-up; the sweeps after are
   replays, counted by their launches); ``serve
   --port --coalesce 4 --reload-every 0.5 --max-requests`` in-process
   with 4 concurrent clients, a newer step saved and pushed mid-run
   (``stats`` shows it, later answers are the new weights'); a reload
   pushed to a serial service serves from freshly captured graphs, bit
   for bit the eager sweeps of the new weights; req/s and
   p50/p99 latency for stdin serial, ``--pipeline`` and ``--coalesce 4``
   and TCP with 4 clients; ``convert --to-safetensors`` then
   ``--from-safetensors`` serves the same bits;
11. kinds: the other parity kinds at full registered width, the first-conv
   kernels on: c1_conv_bar (f32, batch 16), c3_hier_16bar (bf16, 128 x
   16 bars) and c4_cond (bf16, 256 x 4 bars) each train 20 steps through
   ``train()`` on a seeded resident cache with labels (K4 a step, K1/K1b
   on each bar-feature conv or C1's encoder trunk, K2 an eval batch; the
   loss must fall; c4_cond repeated bit for bit), then steps/s, launches
   and kernel time a step and the device-busy share, graph and eager; 5
   graphed steps equal 5 eager ones bit for bit; f32 on the card
   against the CPU; 4 x 16 bars generated; 8 serve requests serial and
   ``--coalesce 4`` under the flip rule (c4_cond: half of them with chord
   and key given, half drawn by the server; the serial answers are graph
   replays equal to eager sweeps); c3's ``generate --encode
   --interp-midi-b`` morph; convert to safetensors and back serves the
   same bits. Then c5_gen_sweep's registered 1,024 x 64-bar interpolation
   sweep three times, eager, captured, replayed, equal bit for bit, with
   each run's peak memory (4 samples to MIDI), and K1, K1b, K2 and K4 at
   the kinds' shapes (M = 2,048, 1,024 and C1's f32 M = 16; n = 25.2 M
   and 12.6 M) against their plain versions, timed beside their bounds;
12. patch_attn: the patch stem and the attention core at full registered
   width, the first-conv flag on (the patch stem ignores it: K1 and K1b
   must not launch): c2_trf (bf16, 64 x 4 bars, attention 2 x 8 heads at
   width 512), c3_trf (128 x 16 bars, hier with attention) and c2_mxu
   (the patch stem with the GRU) each train 20 steps through ``train()``
   on a seeded resident cache (K4 a step, K2 an eval batch; the loss must
   fall; c2_trf repeated bit for bit), then steps/s, launches and kernel
   time a step and the device-busy share, graph and eager; 5 graphed
   steps equal 5 eager ones bit for bit; f32 on the card against the
   CPU; the f32 closed loop (4 x 8 bars, one reset) against the
   teacher-forced decode of its own bars, within 1e-4; 4 x 16 bars
   generated; 8 serve requests serial and ``--coalesce 4`` under the
   flip rule; ``convert --to-safetensors`` refuses c2_trf's checkpoint.
   Then c2_mxu_wide, c3_mxu, c2_mxu_16bar and c2_trf_32bar 5 steps each
   (K4 a step; 5 graphed steps equal 5 eager ones), one 4 x 32-bar
   c2_trf_32bar sweep (a 32-position KV cache) eager, then captured and
   replayed, bit for bit, and K4 at the 16/32-bar configs' n = 6,291,456 against its
   plain version, timed beside its bound. c2_trf and c3_trf must serve
   the same bits serial and --coalesce 4; c2_mxu is also served from its
   untrained init, which gives notes;
13. parallel: data-parallel training at full width (c2_gru_4bar, bf16,
   64 x 4, the seeded bar cache): (a) 5 streamed steps (packed, uploaded
   on a side stream) equal 5 single steps bit for bit, ``train --stream``
   through the CLI (K4 a step), one packed 5-stack's upload timed on its
   stream (streamed against resident steps/s: the train phase); (b) an
   NCCL group of
   world size 1 joined through the MVAE_* variables equals the run
   without a group bit for bit, its resident dispatch captured once with
   the all-reduce inside and equal to the same run eager bit for bit,
   the tracer's all-reduce bytes 20 buckets of perfbench/yardstick_dp.py's
   count in both; (c) two processes sharing the card over
   gloo (``--dp-worker``) run ``train`` through the CLI, resident,
   ``--host-sharded`` and ``--corpus-layout sharded``, 20 steps each in
   f32 and in bf16, and equal one process at the global batch (f32: loss
   1e-5 relative, parameter checksum 1e-6; bf16: 1e-3 and 1e-5; each
   bound shown to catch per-process noise on one process), process 0
   alone logging, K4 launched at 32 rows, their steps/s beside one
   process's; (d) a stop asked of one process stops both at step 5,
   saved once, and ``train --resume`` on both continues it to the
   uninterrupted run's bits;
   (e) c2_trf and c3_trf on init weights serve the same bits serial and
   --coalesce 4, and a lone request the bits it gets padded, with the
   req/s of the slot-at-a-time ops beside all slots at once;
   K4 at the per-process shape against its plain version, timed;
14. tp: tensor parallelism (``parallel.tp.shard_params``) at full width
   (c2_gru_4bar, 64 x 4, the seeded bar cache resident), 20 steps (10 for
   bf16, data=2 and the control) of ``make_train_step_indexed_multi`` a
   run on gloo processes sharing the card, one launch of four
   (``--tp-worker``; two of them go on as a group of two): (a) data=1 x
   model=2 in f32 and bf16 against one process at the same global batch
   and seed, (b) 4 processes, data=2 x model=2, f32, (c) (a) in f32 with
   the first-conv kernels on 8-channel shards; f32 held to the
   data-parallel bound, which a control without the column-parallel
   backward's dx all-reduce must miss (bf16 printed); K4 once a step on
   every process; each rank's parameter and Adam bytes; steps/s at model=2,
   at data=2 and on one process, and the collectives a step; (c)'s
   state saved unsharded, restored into one process and served (K1 every
   bar); K1/K1b at C = 8 and K4 at a TP process's shape against their
   plain versions, timed.

The last lines are a "details:" JSON line with every check and timing,
the card's name and power limit, the kernels JSON object, and
{"ok": true, "device": {...}}. ``--log-file`` keeps a copy of everything
printed. ``--only`` runs a subset of the phases for development, and
``--only profile`` a phase the full run leaves out: which parts of a train
step the launch queue can hold, and torch.profiler's kernel table of one
train dispatch. ``--only dp4`` (left out too; it needs four cards) runs
full-width c4_cond on four processes, one a card, over NCCL: on every
rank the captured dispatch, its all-reduce inside, against the eager one
bit for bit, the replicas against rank 0, a steady dispatch's graph
launches and NCCL kernels, the tracer's all-reduce bytes, steps/s graphed
and eager.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
K_REPLACES = {          # kernel → the TPU kernel body it replaces
    "first_conv_s2": "musicvae_tpu/ops/conv1_pallas.py:112",
    "first_conv_s2_bwd": "musicvae_tpu/ops/conv1_pallas.py:189",
    "masked_bce_sum": "musicvae_tpu/ops/fused_elbo.py:58",
    "masked_bce_bwd": "musicvae_tpu/ops/fused_elbo.py:75",
    "masked_bce_sum_dual": "musicvae_tpu/ops/fused_elbo.py:207",
    "kl_sum": "musicvae_tpu/ops/fused_elbo.py:285",
    "kl_bwd": "musicvae_tpu/ops/fused_elbo.py:291",
}
SERVE_REQUESTS = 4
SPIN_CYCLES = 10_000_000  # ~5 ms of spin: longer than the host needs to
#                           enqueue one timed call, autograd included
FLIP_LIMIT = 0.10   # share of generated cells the stock conv may change


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


LOG_FILE = None      # --log-file: a copy of everything log() prints


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def held_ms(fn, spin_cycles: int = SPIN_CYCLES, strict: bool = True):
    """Device time of everything ``fn`` enqueues, in ms: a spin kernel
    holds the stream while the host enqueues ``fn`` between two CUDA
    events, so the events time the card's work alone, without the host's
    launch gaps. Any op in ``fn`` that would wait for the card raises
    (sync debug mode "error"). If the spin ended before the host had
    finished (it was too short, or the launch queue filled and the host
    had to wait for it), the events timed the host too: the run fails, or
    with ``strict=False`` the result is None."""
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
    held = not start.query()
    end.synchronize()
    if not held:
        check(not strict, f"the spin ended before the host had enqueued "
                          f"the timed call ({enqueue_ms:.1f} ms); raise "
                          f"its cycles")
        return None
    return start.elapsed_time(end)


def time_ms(fn, flush: torch.Tensor, iters: int = 30,
            dirty: bool = True) -> float:
    """Mean device time of one call of ``fn`` (``held_ms``), each call
    from a cold L2: ``flush``, larger than L2, is overwritten first, so L2
    holds dirty lines that the call's own traffic must write back, as it
    finds them after other kernels (``dirty=False`` reads ``flush``
    instead, leaving L2 clean). A sample in which the host was too slow to
    stay behind the spin (a busy host) is taken again; the run fails if
    that happens ``iters`` times."""
    for _ in range(3):
        fn()
    samples, missed = [], 0
    while len(samples) < iters:
        if dirty:
            flush.zero_()
        else:
            flush.max()
        ms = held_ms(fn, strict=False)
        if ms is None:
            missed += 1
            check(missed < iters, f"the host could not stay behind the spin "
                                  f"in {missed} timed calls")
        else:
            samples.append(ms)
    return sum(samples) / iters


def kernel_only_parts(fn, flush: torch.Tensor, match: str,
                      reps: int = 10, attempts: int = 3) -> dict:
    """Device time of each kernel of one call of ``fn`` whose name contains
    ``match``, in ms by kernel name, from torch.profiler (CUPTI), each call
    from the same cold L2 as ``time_ms``: the kernels' own time, without
    the launch and event latency that ``time_ms`` includes. A trace that
    recorded no such kernel (CUPTI drops one now and then) is taken again,
    up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        parts = {e.key: e.device_time_total / reps / 1e3
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and match in e.key and e.device_time_total > 0}
        if parts:
            return parts
    check(False, f"torch.profiler recorded no {match} kernel in {attempts} "
                 f"traces")


def kernel_only_ms(fn, flush: torch.Tensor, match: str, reps: int = 10):
    """The sum of ``kernel_only_parts``."""
    return sum(kernel_only_parts(fn, flush, match, reps).values())


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
    _kernels.lib()
    log(f"kernel build + load (span kernels.build): "
        f"{_kernels.build_info['seconds']:.1f} s -> "
        f"{_kernels.build_info['path']}")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                        _kernels.build_info["log"])]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill",
                                          _kernels.build_info["log"])]
    if regs:
        log(f"  ptxas: {len(regs)} kernel instantiations, at most "
            f"{max(regs)} registers a thread, {sum(spills)} bytes spilled")
    return card


def _demangle(names):
    """Readable names for mangled kernel symbols (c++filt or cu++filt where
    the machine has one; the mangled names otherwise)."""
    for tool in ("c++filt", "/usr/local/cuda/bin/cu++filt"):
        try:
            out = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            continue
        lines = out.stdout.splitlines()
        if out.returncode == 0 and len(lines) == len(names):
            return dict(zip(names, lines))
    return {n: n for n in names}


def _ptxas_report(log_text: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    instantiation, from ``nvcc -Xptxas -v``'s log."""
    rep, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = rep.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rep


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)\s*([^;]*);")


def _sass_report(lib_path: str) -> dict:
    """For each kernel in the library, cuobjdump's SASS: the instruction
    count, and the largest loop (a backward branch's span) with its count
    by opcode. Empty where the toolkit has no cuobjdump."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return {"error": out.stderr[-500:]}
    rep, name, instrs = {}, None, []

    def close():
        if name is None:
            return
        loops = []
        for k, (addr, op, _, args) in enumerate(instrs):
            t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if t and int(t.group(1), 16) < addr:
                start = next(i for i, x in enumerate(instrs)
                             if x[0] >= int(t.group(1), 16))
                loops.append(instrs[start:k + 1])
        def hist(body):
            h = {}
            for _, op, sfx, _ in body:
                key = op + sfx if op in ("MUFU", "HMMA", "LDS", "STG",
                                         "LDG", "I2F", "CALL") else op
                h[key] = h.get(key, 0) + 1
            return dict(sorted(h.items(), key=lambda kv: -kv[1]))

        main = max(loops, key=len) if loops else []
        rep[name] = {"instructions": len(instrs),
                     "main_loop_instructions": len(main),
                     "main_loop_ops": hist(main),
                     "loops": [{"instructions": len(lp), "ops": hist(lp)}
                               for lp in loops]}

    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, instrs = m.group(1), []
            continue
        m = _SASS_LINE.search(line)
        if m and name is not None:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3),
                           m.group(4)))
    close()
    return rep


def build_report(match: str, main: str) -> dict:
    """ptxas and SASS numbers of every kernel instantiation whose readable
    name contains ``match``, keyed by that name; every loop's counts only
    for the main path's instantiations (names containing ``main``)."""
    from musicvae_tpu_torch.ops import _kernels

    ptxas = _ptxas_report(_kernels.build_info.get("log", ""))
    sass = _sass_report(_kernels.build_info["path"])
    names = _demangle(sorted(set(ptxas) | set(sass) - {"error"}))
    rep = {}
    for mangled, readable in names.items():
        if match not in readable:
            continue
        short = re.sub(r"^void |\(.*\)$", "", readable.replace(
            "(anonymous namespace)::", "").replace("mvk::", ""))
        rep[short] = {**ptxas.get(mangled, {}), **sass.get(mangled, {})}
        if main not in short:
            rep[short].pop("loops", None)     # every loop: main path only
        log(f"  build {short}: {rep[short]}")
    if "error" in sass:
        log(f"  cuobjdump failed: {sass['error']}")
    return rep


def _case_log(tag: str, case: dict, details: dict, key: str) -> None:
    details[key].append(case)
    log(f"{tag} {case}")


def _k1_checks(g, dev, wb, details):
    """The first conv's forward kernel against its plain version for every
    C the wrapper takes, at the serve shape (M=4), a ragged M, the
    coalesced serve shape (M=16) and the train/eval shape (M=256), both x
    types and both output types.
    Tolerance 1e-5 (+1e-5 relative) for f32 output; 1e-2 for bf16 (one
    bf16 step where the two f32 GELUs round to either side)."""
    from musicvae_tpu_torch.ops import conv1

    err = {}
    for c, (w, b) in wb.items():
        for m in (4, 5, 16, 256):
            for x_dtype in (torch.uint8, torch.bfloat16):
                x = (torch.rand((m, 96, 128), generator=g, device=dev) < 0.1)
                x = x.to(x_dtype)
                for out_dtype, tol in ((torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)):
                    got = conv1.first_conv_s2(x, w, b, True, out_dtype).float()
                    ref = conv1.first_conv_s2_ref(x, w, b, True,
                                                  out_dtype).float()
                    diff = (got - ref).abs()
                    case = dict(c=c, m=m, x=str(x_dtype), out=str(out_dtype),
                                max_abs_err=float(diff.max()),
                                max_rel_err=float(
                                    (diff / ref.abs().clamp_min(1e-6)).max()),
                                tol=tol,
                                ok=bool((diff <= tol + tol * ref.abs()).all()))
                    _case_log("K1 first_conv_s2", case, details, "k1")
                    check(case["ok"], f"K1 disagrees with its plain version: "
                                      f"{case}")
                    err[(c, m, x_dtype, out_dtype)] = case["max_abs_err"]
    return err


def _k1b_checks(g, dev, wb, details):
    """The first conv's backward kernel against autograd through the plain
    forward (cuDNN's f32 backward on the card, TF32 off), for every C, at
    M=4, a ragged M and M=256, both x types and both dy types, and once
    without the GELU. Tolerance as the JAX package's own test: atol 1e-3 +
    rtol 1e-3; two calls must give the same bits."""
    from musicvae_tpu_torch.ops import conv1

    err = {}
    cases = [(c, m, xd, od, True) for c in wb for m in (4, 5, 256)
             for xd in (torch.uint8, torch.bfloat16)
             for od in (torch.float32, torch.bfloat16)]
    cases += [(c, 5, torch.uint8, torch.float32, False) for c in wb]
    for c, m, x_dtype, out_dtype, gelu in cases:
        w, b = wb[c]
        x = (torch.rand((m, 96, 128), generator=g, device=dev) < 0.1
             ).to(x_dtype)
        dy = torch.randn((m, 48, 64, c), generator=g,
                         device=dev).to(out_dtype)
        outs = []
        for _ in range(2):
            wl = w.clone().requires_grad_(True)
            bl = b.clone().requires_grad_(True)
            y = conv1.first_conv_s2(x, wl, bl, gelu, out_dtype)
            outs.append(torch.autograd.grad(y, (wl, bl), dy))
        (dw, db), (dw2, db2) = outs
        rw, rb = conv1.first_conv_s2_bwd_ref(x, w, b, dy, gelu)
        case = dict(c=c, m=m, x=str(x_dtype), dy=str(out_dtype), gelu=gelu)
        ok = True
        for nm, got, ref in (("dw", dw, rw), ("db", db, rb)):
            diff = (got - ref).abs()
            case[f"{nm}_max_abs_err"] = float(diff.max())
            case[f"{nm}_max_rel_err"] = float(
                (diff / ref.abs().clamp_min(1e-3)).max())
            ok = ok and bool((diff <= 1e-3 + 1e-3 * ref.abs()).all())
        case["same_bits_twice"] = bool(torch.equal(dw, dw2)
                                       and torch.equal(db, db2))
        case["ok"] = ok
        _case_log("K1b first_conv_s2_bwd", case, details, "k1b")
        check(ok, f"K1b disagrees with its plain version: {case}")
        check(case["same_bits_twice"], f"K1b is not deterministic: {case}")
        err[(c, m, x_dtype, out_dtype, gelu)] = max(case["dw_max_abs_err"],
                                                    case["db_max_abs_err"])
    return err


def _conv1_geometry_check():
    """ops/conv1.py's mirror of the first-conv kernels' launch geometry
    against the C side's, which sizes the launches (the wrapper sizes the
    backward's partials from the mirror)."""
    import ctypes

    from musicvae_tpu_torch.ops import _kernels, conv1

    fn = _kernels.lib().mvk_first_conv_s2_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    cases = []
    for m in (1, 2, 4, 5, 9, 64, 256, 1024):
        for c in conv1.CHANNELS:
            geo = (ctypes.c_int * 5)()
            fn(m, c, geo)
            cases.append((m, c, tuple(geo), tuple(conv1.geometry(m, c))))
    bad = [cs for cs in cases if cs[2] != cs[3]]
    log(f"first-conv geometry: C and Python agree in {len(cases) - len(bad)} "
        f"of {len(cases)} (m, c); M=256, C=16: {conv1.geometry(256, 16)}; "
        f"M=4, C=16: {conv1.geometry(4, 16)}")
    check(not bad, f"first-conv geometry differs (m, c, C, Python): {bad}")
    # the grids assume their blocks all fit on the card at once
    lib = _kernels.lib()
    resident = {}
    for c in conv1.CHANNELS:
        fwd = lib.mvk_first_conv_s2_resident(256, c)
        bwd = lib.mvk_first_conv_s2_bwd_resident(256, c)
        resident[c] = (fwd, bwd)
        check(fwd >= conv1.FWD_BLOCKS // 132 and bwd >= conv1.BWD_BLOCKS
              // 132, f"C={c}: {fwd} forward and {bwd} backward blocks fit "
                      f"an SM, the grids assume {conv1.FWD_BLOCKS // 132} "
                      f"and {conv1.BWD_BLOCKS // 132}")
    log(f"first-conv blocks resident an SM (forward, backward) by C at "
        f"M=256: {resident}")
    return {"geometry": {f"{m},{c}": list(py) for m, c, _, py in cases},
            "resident_blocks": resident}


def _conv1_dy_layout(dev, w, b):
    """Whether the gradient reaching the first conv's backward in the
    model's trunk (the kernel's NHWC output, viewed NCHW, into a bf16 cuDNN
    conv) is already contiguous NHWC, so that ``dy.contiguous()`` copies
    nothing."""
    import torch.nn.functional as F

    from musicvae_tpu_torch.ops import conv1

    x = torch.zeros((8, 96, 128), dtype=torch.uint8, device=dev)
    w2 = torch.randn((32, w.shape[-1], 3, 3), device=dev,
                     dtype=torch.bfloat16)
    seen = []
    wl = w.clone().requires_grad_(True)
    h = conv1.first_conv_s2(x, wl, b, True, torch.bfloat16)
    h.register_hook(lambda grad: seen.append(
        (grad.is_contiguous(), list(grad.stride()))))
    F.conv2d(h.permute(0, 3, 1, 2), w2, stride=2, padding=1).float().sum(
    ).backward()
    out = {"contiguous": seen[0][0], "stride": seen[0][1]}
    log(f"K1b dy as the trunk hands it over: {out}")
    return out


def _bce_checks(g, dev, details):
    """K2 (sum), K4 (sum + tile) and K3 (backward) against the plain BCE
    under autograd. Sums: 1e-5 relative. Gradients: 1e-6·max(1, g)
    absolute for f32 logits; for bf16 logits one bf16 step at the largest
    gradient, g·2^-7 (both sides round the same f32 value). Cases: 3·randn
    logits at the train shape and a ragged one; trained-like logits (95 %
    of cells confident, where a cell's BCE is about exp(−|l|) and only a
    relative error per cell keeps the sum within 1e-5); p = 100 and 84 (the
    kernels' general mask path); inputs at unaligned addresses (their
    scalar loads), which must give the aligned inputs' bits. Every case:
    the same bits twice, K4's sum equal to K2's bits, K3's dl equal to
    (K4's tile * g).to(logits' dtype), the backward of the dual path."""
    from musicvae_tpu_torch.ops import fused_elbo, losses

    crop = torch.zeros(128, device=dev)
    crop[24:108] = 1.0
    full = torch.ones(128, device=dev)
    err = {"k2": {}, "k3": {}, "k4": {}}

    def run(fn, lg, x, mask, gscale):
        leaf = lg.clone().requires_grad_(True)
        total = fn(leaf, x, mask)
        (grad,) = torch.autograd.grad(total * gscale, leaf)
        return total.detach(), grad

    def one(lg, x, mask, tags):
        """Every check of one (logits, x, mask); returns K2's sum and the
        errors by gradient scale."""
        l_dtype = lg.dtype
        with torch.no_grad():
            k2 = fused_elbo.masked_bce_sum(lg, x, mask)
            k2_again = fused_elbo.masked_bce_sum(lg, x, mask)
        ref = losses.masked_bce_sum(lg, x, mask)
        rel = abs(float(k2) - float(ref)) / abs(float(ref))
        case = dict(**tags, kernel=float(k2), plain=float(ref), rel_err=rel,
                    abs_err=abs(float(k2) - float(ref)),
                    same_bits_twice=bool(torch.equal(k2, k2_again)))
        _case_log("K2 masked_bce_sum", case, details, "k2")
        check(rel <= 1e-5, f"K2 disagrees: {case}")
        check(case["same_bits_twice"], f"K2 is not deterministic: {case}")
        errs = {"k2": case["abs_err"]}
        for gscale in (1.0, 3.5):
            tol = (1e-6 * max(1.0, gscale) if l_dtype == torch.float32
                   else gscale * 2.0 ** -7)
            want = fused_elbo.masked_bce_bwd_plain(lg, x, mask, gscale)
            s4, g4 = run(fused_elbo.masked_bce_sum_dual, lg, x, mask, gscale)
            s4b, g4b = run(fused_elbo.masked_bce_sum_dual, lg, x, mask,
                           gscale)
            s3, g3 = run(fused_elbo.masked_bce_sum, lg, x, mask, gscale)
            _, g3b = run(fused_elbo.masked_bce_sum, lg, x, mask, gscale)
            e4 = float((g4.float() - want.float()).abs().max())
            e3 = float((g3.float() - want.float()).abs().max())
            case = dict(
                **tags, g=gscale, tol=tol,
                k4_grad_max_abs_err=e4, k3_grad_max_abs_err=e3,
                k4_sum_equals_k2_bits=bool(torch.equal(s4, k2)),
                k3_equals_k4_grad_bits=bool(torch.equal(g3, g4)),
                same_bits_twice=bool(
                    torch.equal(s4, s4b) and torch.equal(g4, g4b)
                    and torch.equal(g3, g3b)))
            _case_log("K4/K3 masked_bce dual/bwd", case, details, "k34")
            check(e4 <= tol and e3 <= tol, f"K4/K3 gradient disagrees: {case}")
            check(case["k4_sum_equals_k2_bits"],
                  f"K4's sum is not K2's bits: {case}")
            check(case["k3_equals_k4_grad_bits"],
                  f"K3's dl is not (K4's tile * g).to(dtype): {case}")
            check(bool(torch.equal(s3, k2)),
                  f"K2 under autograd changed its sum: {case}")
            check(case["same_bits_twice"], f"K4/K3 not deterministic: {case}")
            errs[("k4", gscale)], errs[("k3", gscale)] = e4, e3
        return k2, errs

    for shape in ((64, 4, 96, 128), (12345, 128)):
        logits = 3.0 * torch.randn(shape, generator=g, device=dev)
        xb = torch.rand(shape, generator=g, device=dev) < 0.05
        for l_dtype in (torch.float32, torch.bfloat16):
            lg = logits.to(l_dtype)
            for x_dtype in (torch.float32, torch.uint8):
                x = xb.to(x_dtype)
                for mname, mask in (("full", full), ("crop", crop)):
                    _, errs = one(lg, x, mask, dict(
                        shape=list(shape), logits=str(l_dtype),
                        x=str(x_dtype), mask=mname))
                    err["k2"][(shape, l_dtype, x_dtype, mname)] = errs["k2"]
                    for gscale in (1.0, 3.5):
                        key = (shape, l_dtype, x_dtype, mname, gscale)
                        err["k4"][key] = errs[("k4", gscale)]
                        err["k3"][key] = errs[("k3", gscale)]

    # trained-like logits: cells with x = 0 at l ~ -N(10, 2), note cells
    # (5 %) at +N(5, 2); every x type
    shape = (64, 4, 96, 128)
    xb = torch.rand(shape, generator=g, device=dev) < 0.05
    logits = torch.where(
        xb, 5.0 + 2.0 * torch.randn(shape, generator=g, device=dev),
        -10.0 + 2.0 * torch.randn(shape, generator=g, device=dev))
    for l_dtype in (torch.float32, torch.bfloat16):
        for x_dtype in (torch.uint8, torch.bfloat16, torch.float32):
            one(logits.to(l_dtype), xb.to(x_dtype), crop,
                dict(case="trained_like", shape=list(shape),
                     logits=str(l_dtype), x=str(x_dtype), mask="crop"))

    # p that does not divide 1024 (the general mask path); a mask of 0s and
    # 1s and fractional values, and fractional targets
    for p in (100, 84):
        shape = (777, p)
        logits = 3.0 * torch.randn(shape, generator=g, device=dev)
        mask = (torch.rand(p, generator=g, device=dev) < 0.8).float()
        mask[: p // 4] *= 0.5
        xs = torch.rand(shape, generator=g, device=dev)
        for l_dtype in (torch.float32, torch.bfloat16):
            for x_dtype, x in ((torch.uint8, (xs < 0.05).to(torch.uint8)),
                               (torch.float32, xs)):
                one(logits.to(l_dtype), x, mask,
                    dict(case=f"p{p}", shape=list(shape),
                         logits=str(l_dtype), x=str(x_dtype), mask="mixed"))

    # the same values at addresses that are not 16-byte aligned: the
    # kernels' scalar loads and stores, and the aligned inputs' bits
    shape = (300, 128)
    n = shape[0] * shape[1]
    logits = 3.0 * torch.randn(shape, generator=g, device=dev)
    xb = (torch.rand(shape, generator=g, device=dev) < 0.05).to(torch.uint8)
    lbuf = torch.empty(n + 1, device=dev)
    xbuf = torch.empty(n + 1, dtype=torch.uint8, device=dev)
    lu = lbuf[1:].view(shape).copy_(logits)
    xu = xbuf[1:].view(shape).copy_(xb)
    k2_u, _ = one(lu, xu, crop, dict(case="unaligned", shape=list(shape),
                                     logits="torch.float32", x="torch.uint8",
                                     mask="crop"))
    gdev = torch.full((), 3.5, device=dev)
    with torch.no_grad():
        k2_a = fused_elbo.masked_bce_sum(logits, xb, crop)
        s4_u, t4_u = fused_elbo._bce_sum(lu, xu, crop, dual=True)
        s4_a, t4_a = fused_elbo._bce_sum(logits, xb, crop, dual=True)
        d3_u = fused_elbo._bce_bwd(lu, xu, crop, gdev)
        d3_a = fused_elbo._bce_bwd(logits, xb, crop, gdev)
    same = dict(k2=bool(torch.equal(k2_u, k2_a)),
                k4_sum=bool(torch.equal(s4_u, s4_a)),
                k4_tile=bool(torch.equal(t4_u, t4_a)),
                k3=bool(torch.equal(d3_u, d3_a)))
    log(f"K2/K4/K3 unaligned inputs give the aligned inputs' bits: {same}")
    check(all(same.values()),
          f"unaligned inputs change K2/K4/K3's bits: {same}")

    # one launch a call, nothing else on the card
    per_call = {
        "masked_bce_sum": profiled_kernels(
            lambda: fused_elbo._bce_sum(logits, xb, crop, dual=False))[0],
        "masked_bce_sum_dual": profiled_kernels(
            lambda: fused_elbo._bce_sum(logits, xb, crop, dual=True))[0],
        "masked_bce_bwd": profiled_kernels(
            lambda: fused_elbo._bce_bwd(logits, xb, crop, gdev))[0]}
    log(f"K2/K4/K3 device launches a call: {per_call}")
    check(all(v == 1 for v in per_call.values()),
          f"K2/K4/K3 should launch one kernel a call: {per_call}")
    details["bce_launches_per_call"] = per_call
    details["bce_unaligned_same_bits"] = same
    return err


def _bce_geometry_check():
    """ops/fused_elbo.py's mirror of the BCE kernels' launch geometry
    against the C side's, which sizes the launches of K2, K4 and K3 (all
    three launch ``sum_geometry(n, p)``)."""
    import ctypes

    from musicvae_tpu_torch.ops import _kernels, fused_elbo

    fn = _kernels.lib().mvk_masked_bce_sum_geometry
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    cases, bad = 0, []
    for rows in (0, 1, 2, 31, 32, 33, 37 * 4 * 96, 777, 12345, 64 * 4 * 96,
                 16 * 64 * 96, 100_000):
        for p in (1, 2, 3, 84, 100, 128, 1024, 2048):
            n = rows * p
            geo = (ctypes.c_longlong * 5)()
            fn(n, p, geo)
            c_side = (geo[0], geo[1], bool(geo[2]), geo[3], geo[4])
            py = (*fused_elbo.sum_geometry(n, p), fused_elbo.SUM_CHUNK,
                  fused_elbo.SUM_MAX_BLOCKS)
            cases += 1
            if c_side != py:
                bad.append((n, p, c_side, py))
    main = fused_elbo.sum_geometry(64 * 4 * 96 * 128, 128)
    log(f"BCE geometry (K2, K4, K3): C and Python agree in "
        f"{cases - len(bad)} of {cases} (n, p); the train/eval shape: {main}")
    check(not bad, f"BCE geometry differs (n, p, C, Python): {bad}")
    return {"cases": cases, "main": list(main)}


def _kl_checks(g, dev, details):
    """K5 against the plain KL sum (1e-5 relative), K6 against the plain
    gradients (1e-6·max(1, g) absolute in f32; one bf16 step of the
    largest gradient for bf16 inputs), on randn latents; K5 also with lv
    uniform on [−8, 8], the range of the model's clamped logvar, where its
    ex2-based e^lv is held to the same 1e-5; unaligned inputs must give the
    aligned inputs' bits."""
    from musicvae_tpu_torch.ops import fused_elbo, losses

    err = {}
    for shape in ((64, 128), (7, 3, 50)):
        for dtype in (torch.float32, torch.bfloat16):
            mu = torch.randn(shape, generator=g, device=dev).to(dtype)
            lv = torch.randn(shape, generator=g, device=dev).to(dtype)
            ref = losses.kl_diag_gaussian(mu.float(), lv.float())
            for gscale in (1.0, 3.5):
                outs = []
                for _ in range(2):
                    ml = mu.clone().requires_grad_(True)
                    ll = lv.clone().requires_grad_(True)
                    total = fused_elbo.kl_sum(ml, ll)
                    outs.append((total.detach(), *torch.autograd.grad(
                        total * gscale, (ml, ll))))
                (kl, dmu, dlv), (kl2, dmu2, dlv2) = outs
                wmu, wlv = fused_elbo.kl_bwd_plain(mu, lv, gscale)
                rel = abs(float(kl) - float(ref)) / abs(float(ref))
                emu = float((dmu.float() - wmu.float()).abs().max())
                elv = float((dlv.float() - wlv.float()).abs().max())
                gmax = float(torch.maximum(wmu.float().abs().max(),
                                           wlv.float().abs().max()))
                tol = (1e-6 * max(1.0, gscale) if dtype == torch.float32
                       else gmax * 2.0 ** -7)
                case = dict(shape=list(shape), dtype=str(dtype), g=gscale,
                            kernel=float(kl), plain=float(ref), rel_err=rel,
                            abs_err=abs(float(kl) - float(ref)),
                            dmu_max_abs_err=emu, dlv_max_abs_err=elv,
                            tol=tol, same_bits_twice=bool(
                                torch.equal(kl, kl2) and torch.equal(dmu, dmu2)
                                and torch.equal(dlv, dlv2)))
                _case_log("K5/K6 kl_sum/kl_bwd", case, details, "k56")
                check(rel <= 1e-5, f"K5 disagrees: {case}")
                check(emu <= tol and elv <= tol, f"K6 disagrees: {case}")
                check(case["same_bits_twice"],
                      f"K5/K6 not deterministic: {case}")
                err[(shape, dtype, gscale)] = (case["abs_err"],
                                               max(emu, elv))
            # the same values one element past a 16-byte boundary: K5's
            # scalar loads, and the aligned inputs' bits
            n = mu.numel()
            mbuf = torch.empty(n + 1, dtype=dtype, device=dev)
            lbuf = torch.empty(n + 1, dtype=dtype, device=dev)
            mu_u = mbuf[1:].view(shape).copy_(mu)
            lv_u = lbuf[1:].view(shape).copy_(lv)
            with torch.no_grad():
                same = bool(torch.equal(fused_elbo.kl_sum(mu_u, lv_u),
                                        fused_elbo.kl_sum(mu, lv)))
            log(f"K5 unaligned {list(shape)} {dtype}: the aligned inputs' "
                f"bits: {same}")
            check(same, f"unaligned inputs change K5's bits: {shape} {dtype}")
            details["k5_unaligned_same_bits"].append(
                dict(shape=list(shape), dtype=str(dtype), same=same))
            # K6 from the same unaligned views: its scalar loads, the
            # aligned inputs' bits, and one launch a call
            gdev = torch.full((), 3.5, device=dev)
            d_u = fused_elbo._kl_bwd(mu_u, lv_u, gdev)
            d_a = fused_elbo._kl_bwd(mu, lv, gdev)
            same6 = all(torch.equal(u, a) for u, a in zip(d_u, d_a))
            launches6 = (profiled_kernels(lambda: fused_elbo._kl_bwd(
                mu, lv, gdev))[0], profiled_kernels(
                lambda: fused_elbo._kl_bwd(mu_u, lv_u, gdev))[0])
            log(f"K6 unaligned {list(shape)} {dtype}: the aligned inputs' "
                f"bits: {same6}; device launches a call (aligned, "
                f"unaligned): {launches6}")
            check(same6, f"unaligned inputs change K6's bits: {shape} "
                         f"{dtype}")
            check(launches6 == (1, 1), f"K6 should launch one kernel a "
                                       f"call: {launches6}")
            details["k6_unaligned"].append(
                dict(shape=list(shape), dtype=str(dtype), same=same6,
                     launches_per_call=list(launches6)))
            # logvar over the whole of the model's clamp
            lv8 = (16.0 * torch.rand(shape, generator=g, device=dev) - 8.0
                   ).to(dtype)
            ref = losses.kl_diag_gaussian(mu.float(), lv8.float())
            with torch.no_grad():
                kl = fused_elbo.kl_sum(mu, lv8)
            case = dict(shape=list(shape), dtype=str(dtype), lv="U[-8,8]",
                        kernel=float(kl), plain=float(ref),
                        rel_err=abs(float(kl) - float(ref)) / abs(float(ref)))
            _case_log("K5 kl_sum", case, details, "k5_lv8")
            check(case["rel_err"] <= 1e-5, f"K5 disagrees: {case}")
    return err


KL_BWD_VARIANTS = (1024, 256, 128)   # K6 threads a block: 1, 4 and 8
#                                     blocks at the [64,128] latents


def _start_kl_bwd_variants():
    """Start one nvcc for each block size of KL_BWD_VARIANTS: kl.cu with
    its BWD_THREADS line set to that size, built alone into a library of
    its own under build/. Returns {threads: (directory, process)}."""
    import shutil

    from musicvae_tpu_torch.ops import _kernels

    src = (_kernels.CSRC / "kl.cu").read_text()
    line = re.search(r"^constexpr int BWD_THREADS = \d+;", src, re.M)
    check(line is not None, "kl.cu has no BWD_THREADS line")
    root = _kernels.BUILD_ROOT.parent / "kl_bwd_variants"
    started = {}
    for threads in KL_BWD_VARIANTS:
        d = root / str(threads)
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(_kernels.CSRC / "common.cuh", d)
        (d / "kl.cu").write_text(
            src[:line.start()] + f"constexpr int BWD_THREADS = {threads};"
            + src[line.end():])
        started[threads] = (d, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
             str(d / "kl.cu"), "-o", str(d / "libkl.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return started


def _kl_bwd_variants(started, mu, lv, g, flush):
    """Each K6 variant called through its library's ``mvk_kl_bwd`` on the
    kernels line's inputs: the shipped kernel's bits, then timed as K6 is
    (cold L2, and alone)."""
    import ctypes

    from musicvae_tpu_torch.ops import _kernels, fused_elbo

    want = fused_elbo._kl_bwd(mu, lv, g)
    out = []
    for threads, (d, proc) in started.items():
        text = proc.communicate()[0]
        check(proc.returncode == 0,
              f"K6 variant of {threads} threads failed to build: "
              f"{text[-3000:]}")
        lib = ctypes.CDLL(str(d / "libkl.so"))
        p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mvk_kl_bwd.argtypes = [p_, p_, i_, p_, p_, p_, ll_, p_]
        lib.mvk_kl_bwd.restype = i_
        dmu, dlv = torch.empty_like(mu), torch.empty_like(lv)

        def call():
            rc = lib.mvk_kl_bwd(
                mu.data_ptr(), lv.data_ptr(), _kernels.KINDS[mu.dtype],
                g.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), mu.numel(),
                _kernels.stream_of(mu))
            check(rc == 0, f"K6 variant launch failed with CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        same = bool(torch.equal(dmu, want[0]) and torch.equal(dlv, want[1]))
        check(same, f"K6 variant of {threads} threads differs from K6")
        regs = {k: v for k, v in _ptxas_report(text).items()
                if "kl_bwd" in k}
        v = {"threads": threads,
             "blocks": -(-mu.numel() // (8 * threads)),
             "ms": time_ms(call, flush),
             "kernel_only_ms": kernel_only_ms(call, flush, "kl_bwd"),
             "same_bits": same, "ptxas": regs}
        log(f"K6 variant {v}")
        out.append(v)
    return out


def kernel_checks(seed: int, dev: torch.device):
    """Every kernel against its plain version, then timed at the main
    path's shapes. Returns the kernels line's entries (launches filled in
    later) and details."""
    import torch.nn.functional as F

    from musicvae_tpu_torch.ops import conv1, fused_elbo, losses

    g = torch.Generator(dev).manual_seed(seed)
    details = {"k1": [], "k1b": [], "k2": [], "k34": [], "k56": [],
               "k5_lv8": [], "k5_unaligned_same_bits": [],
               "k6_unaligned": []}
    k6_builds = _start_kl_bwd_variants()    # built while the checks run
    wb = {cc: (torch.randn((3, 3, cc), generator=g, device=dev) / 3.0,
               0.1 * torch.randn(cc, generator=g, device=dev))
          for cc in conv1.CHANNELS}
    c = 16                              # the main path's width
    w, b = wb[c]
    # the first-conv kernels (conv1.cu, conv1_bwd.cu): every loop for the
    # main path's uint8 x, bf16 out or dy, C=16
    details["conv1_build"] = build = build_report(
        "conv1", "unsigned char, __nv_bfloat16, 16")
    # the BCE kernels (masked_bce.cu): every loop for f32 logits, uint8 x
    details["bce_build"] = bce_build = build_report(
        "bce", "float, unsigned char")
    # the KL kernels (kl.cu): every loop for the main path's f32 latents
    details["kl_build"] = kl_build = build_report("kl_", "<float>")
    details["conv1_geometry"] = _conv1_geometry_check()
    details["bce_geometry"] = _bce_geometry_check()
    k1_err = _k1_checks(g, dev, wb, details)
    k1b_err = _k1b_checks(g, dev, wb, details)
    details["k1b_dy_layout"] = _conv1_dy_layout(dev, w, b)
    bce_err = _bce_checks(g, dev, details)
    kl_err = _kl_checks(g, dev, details)

    # timing at the main path's shapes, each run from a cold L2
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    csrc = "musicvae_tpu_torch/csrc/"

    def entry(name, source, replaces, err, ms, plain, lib_ms, nbytes, ops,
              path, **extra):
        bms, by = bound_ms(nbytes, ops)
        e = {"name": name, "route": "cuda", "source": csrc + source,
             "replaces": replaces, "launches": None, "max_abs_err": err,
             "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
             "library_ms": lib_ms, "path": path, **extra}
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
        log(f"timing {name}: kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.2f} us, library {lib}, bound {bms * 1e3:.2f} us "
            f"({by})" + "".join(
                f", {k[:-3].replace('_', ' ')} {extra[k] * 1e3:.2f} us"
                for k in ("gelu_off_ms", "clean_l2_ms", "memory_floor_ms",
                          "launch_floor_ms", "kernel_only_ms")
                if k in extra))
        return e

    entries = []
    w_lib = w.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous()
    b_lib = b.to(torch.bfloat16)
    k1_timed = {}
    for m in (4, 16, 256):
        x = (torch.rand((m, 96, 128), generator=g, device=dev) < 0.05
             ).to(torch.uint8)
        x_nchw = x[:, None].to(torch.bfloat16)
        outs = m * 48 * 64 * c
        bms, by = bound_ms(x.numel() + 4 * (w.numel() + b.numel()) + 2 * outs,
                           outs * (2 * 9 + 1 + 8))
        out_like = torch.empty((m, 48, 64, c), dtype=torch.bfloat16,
                               device=dev)
        k1_timed[m] = dict(
            ms=time_ms(lambda: conv1.first_conv_s2(x, w, b), flush),
            gelu_off_ms=time_ms(lambda: conv1.first_conv_s2(x, w, b, False),
                                flush),
            clean_l2_ms=time_ms(lambda: conv1.first_conv_s2(x, w, b), flush,
                                dirty=False),
            kernel_only_ms=kernel_only_ms(
                lambda: conv1.first_conv_s2(x, w, b), flush, "conv1_kernel"),
            memory_floor_ms=time_ms(out_like.zero_, flush),
            plain_ms=time_ms(lambda: conv1.first_conv_s2_ref(x, w, b), flush),
            library_ms=time_ms(lambda: F.gelu(F.conv2d(
                x_nchw, w_lib, b_lib, stride=2, padding=1),
                approximate="tanh"), flush),
            bound_ms=bms, bound_by=by,
            max_abs_err=k1_err[(c, m, torch.uint8, torch.bfloat16)])
    t = k1_timed[256]
    outs = 256 * 48 * 64 * c
    entries.append(entry(
        "first_conv_s2 (train/eval, M=256, uint8 in, bf16 out)", "conv1.cu",
        K_REPLACES["first_conv_s2"], t["max_abs_err"], t["ms"],
        t["plain_ms"], t["library_ms"],
        256 * 96 * 128 + 4 * (w.numel() + b.numel()) + 2 * outs,
        outs * (2 * 9 + 1 + 8), "train_conv1", gelu_off_ms=t["gelu_off_ms"],
        clean_l2_ms=t["clean_l2_ms"], memory_floor_ms=t["memory_floor_ms"],
        kernel_only_ms=t["kernel_only_ms"],
        memory_floor_note="zero_() of a tensor of the output's size, timed "
                          "the same way",
        build={k: v for k, v in build.items() if "bwd" not in k},
        serve_shape={"name": "first_conv_s2 (serve, M=4, uint8 in, bf16 "
                             "out)", **k1_timed[4]},
        coalesced_shape={"name": "first_conv_s2 (serve --coalesce 4, M=16, "
                                 "uint8 in, bf16 out)", **k1_timed[16]}))
    log(f"timing first_conv_s2 (serve, M=4): {k1_timed[4]}")
    log(f"timing first_conv_s2 (serve --coalesce 4, M=16): {k1_timed[16]}")

    # K1b at the train shape: uint8 bars, bf16 dy
    x = (torch.rand((256, 96, 128), generator=g, device=dev) < 0.05
         ).to(torch.uint8)
    dy = torch.randn((256, 48, 64, c), generator=g, device=dev
                     ).to(torch.bfloat16)
    x_nchw = x[:, None].to(torch.bfloat16)
    z_nchw = F.conv2d(x_nchw, w_lib, b_lib, stride=2, padding=1)
    dy_nchw = dy.permute(0, 3, 1, 2)        # channels-last, as it arrives

    def k1b_library():
        dz = torch.ops.aten.gelu_backward(dy_nchw, z_nchw,
                                          approximate="tanh")
        return torch.ops.aten.convolution_backward(
            dz, x_nchw, w_lib, [c], [2, 2], [1, 1], [1, 1], False, [0, 0],
            1, [False, True, True])

    entries.append(entry(
        "first_conv_s2_bwd (train, M=256, uint8 x, bf16 dy)", "conv1_bwd.cu",
        K_REPLACES["first_conv_s2_bwd"],
        k1b_err[(c, 256, torch.uint8, torch.bfloat16, True)],
        time_ms(lambda: conv1._backward(x, w, b, dy, True), flush),
        time_ms(lambda: conv1.first_conv_s2_bwd_ref(x, w, b, dy, True),
                flush),
        time_ms(k1b_library, flush),
        x.numel() + 2 * dy.numel() + 4 * 2 * (w.numel() + b.numel()),
        dy.numel() * (2 * 9 + 2 * 9 + 12), "train_conv1",
        gelu_off_ms=time_ms(lambda: conv1._backward(x, w, b, dy, False),
                            flush),
        clean_l2_ms=time_ms(lambda: conv1._backward(x, w, b, dy, True),
                            flush, dirty=False),
        kernel_only_ms=kernel_only_ms(
            lambda: conv1._backward(x, w, b, dy, True), flush, "conv1_bwd"),
        memory_floor_ms=time_ms(dy.view(torch.float32).sum, flush),
        memory_floor_note="sum() over dy's bytes viewed as f32, timed the "
                          "same way",
        build={k: v for k, v in build.items() if "bwd" in k},
        library_note="gelu_backward + convolution_backward (weight, bias) "
                     "in bf16, given the pre-activation z for free"))

    shape = (64, 4, 96, 128)
    logits = 3.0 * torch.randn(shape, generator=g, device=dev)
    xb = (torch.rand(shape, generator=g, device=dev) < 0.05)
    xu8, xf = xb.to(torch.uint8), xb.to(torch.float32)
    full = torch.ones(128, device=dev)
    n = logits.numel()
    key = (shape, torch.float32, torch.uint8, "full")
    tile_like = torch.empty(shape, dtype=torch.float32, device=dev)

    def extras(fn, match, floor, floor_note, build, main):
        """Kernel alone (each kernel of the call whose name contains
        ``match``), clean L2, a memory floor of the same bytes, and
        ptxas/SASS of the main path's instantiations (names starting with
        ``main``)."""
        parts = kernel_only_parts(fn, flush, match)
        log(f"  kernel alone by kernel: {parts}")
        return dict(kernel_only_ms=sum(parts.values()),
                    kernel_only_parts=parts,
                    clean_l2_ms=time_ms(fn, flush, dirty=False),
                    memory_floor_ms=time_ms(floor, flush),
                    memory_floor_note=floor_note,
                    build={k: v for k, v in build.items()
                           if k.startswith(main)})

    def k2_call():
        return fused_elbo.masked_bce_sum(logits, xu8, full)

    with torch.no_grad():
        entries.append(entry(
            "masked_bce_sum (eval, [64,4,96,128] f32 logits, uint8 x)",
            "masked_bce.cu", K_REPLACES["masked_bce_sum"],
            bce_err["k2"][key],
            time_ms(k2_call, flush),
            time_ms(lambda: losses.masked_bce_sum(logits, xu8, full), flush),
            time_ms(lambda: F.binary_cross_entropy_with_logits(
                logits, xf, weight=full, reduction="sum"), flush),
            4 * n + n + 4 * 128 + 4, 9 * n, "eval",
            **extras(k2_call, "bce", lambda: (logits.sum(),
                                              xu8.view(torch.float32).sum()),
                     "logits.sum() + xu8.view(float32).sum(): reads 4n + n "
                     "bytes as K2 does, in two launches, timed the same way",
                     bce_build, "bce_sum<float, unsigned char, false")))

    gdev = torch.full((), 1.0 / 64, device=dev)
    leaf = logits.clone().requires_grad_(True)

    def plain_dual():
        total = losses.masked_bce_sum(leaf, xu8, full)
        return total, torch.autograd.grad(total, leaf)

    def library_dual():
        total = F.binary_cross_entropy_with_logits(leaf, xf, weight=full,
                                                   reduction="sum")
        return total, torch.autograd.grad(total, leaf)

    def k4_call():
        return fused_elbo._bce_sum(logits, xu8, full, dual=True)

    entries.append(entry(
        "masked_bce_sum_dual (train, [64,4,96,128] f32 logits, uint8 x)",
        "masked_bce.cu", K_REPLACES["masked_bce_sum_dual"],
        bce_err["k4"][key + (1.0,)],
        time_ms(k4_call, flush),
        time_ms(plain_dual, flush), time_ms(library_dual, flush),
        4 * n + n + 4 * n + 4 * 128 + 4, 15 * n, "train",
        library_note="binary_cross_entropy_with_logits(sum) forward + "
                     "autograd.grad",
        **extras(k4_call, "bce", lambda: torch.add(logits, xu8, out=tile_like),
                 "torch.add(logits, xu8, out=f32 tile): reads 4n + n and "
                 "writes 4n bytes as K4 does, timed the same way",
                 bce_build, "bce_sum<float, unsigned char, true")))

    def k3_call():
        return fused_elbo._bce_bwd(logits, xu8, full, gdev)

    entries.append(entry(
        "masked_bce_bwd (fused_elbo backward, [64,4,96,128] f32 logits, "
        "uint8 x)", "masked_bce.cu", K_REPLACES["masked_bce_bwd"],
        bce_err["k3"][key + (1.0,)],
        time_ms(k3_call, flush),
        time_ms(lambda: fused_elbo.masked_bce_bwd_plain(logits, xu8, full,
                                                        gdev), flush),
        time_ms(lambda: (torch.sigmoid(logits) - xf) * full * gdev, flush),
        4 * n + n + 4 * n + 4 * 128 + 4, 10 * n, "fused_elbo",
        library_note="(sigmoid(l) - x) * mask * g, eager, x already f32",
        **extras(k3_call, "bce", lambda: torch.add(logits, xu8, out=tile_like),
                 "torch.add(logits, xu8, out=f32 tile): reads 4n + n and "
                 "writes 4n bytes as K3 does, timed the same way",
                 bce_build, "bce_bwd<float, unsigned char")))

    mu = torch.randn((64, 128), generator=g, device=dev)
    lv = torch.randn((64, 128), generator=g, device=dev)
    nz = mu.numel()
    kkey = ((64, 128), torch.float32, 1.0)
    kl_like, pair_like = torch.empty_like(mu), torch.empty(2 * nz, device=dev)

    launch_floor = dict(
        launch_floor_ms=time_ms(torch.zeros(1, device=dev).zero_, flush),
        launch_floor_note="zero_() of a one-element f32 tensor, timed the "
                          "same way: what one launch costs")

    def k5_call():
        return fused_elbo.kl_sum(mu, lv)

    def k6_call():
        return fused_elbo._kl_bwd(mu, lv, gdev)

    with torch.no_grad():
        entries.append(entry(
            "kl_sum (fused_elbo, [64,128] f32)", "kl.cu",
            K_REPLACES["kl_sum"], kl_err[kkey][0],
            time_ms(k5_call, flush),
            time_ms(lambda: losses.kl_diag_gaussian(mu, lv), flush), None,
            8 * nz + 4, 6 * nz, "fused_elbo",
            **extras(k5_call, "kl_sum", lambda: torch.add(mu, lv, out=kl_like),
                     "torch.add(mu, lv, out=f32 [64,128]): reads 8n bytes "
                     "as K5 does (and writes 4n), one launch, timed the "
                     "same way", kl_build, "kl_sum_kernel<float"),
            **launch_floor))
    entries.append(entry(
        "kl_bwd (fused_elbo backward, [64,128] f32)", "kl.cu",
        K_REPLACES["kl_bwd"], kl_err[kkey][1],
        time_ms(k6_call, flush),
        time_ms(lambda: fused_elbo.kl_bwd_plain(mu, lv, gdev), flush), None,
        8 * nz + 4 + 8 * nz, 5 * nz, "fused_elbo",
        **extras(k6_call, "kl_bwd",
                 lambda: torch.cat((mu.view(-1), lv.view(-1)), out=pair_like),
                 "torch.cat((mu, lv), out=f32 [2n]): reads 8n and writes 8n "
                 "bytes as K6 does, one launch, timed the same way",
                 kl_build, "kl_bwd_kernel<float"),
        variants=_kl_bwd_variants(k6_builds, mu, lv, gdev, flush),
        **launch_floor))
    return entries, details


def reference_check(seed: int, dev: torch.device,
                    name: str = "c2_gru_4bar") -> dict:
    """The config ``name`` at full width in f32 with the first-conv kernel:
    the card against the CPU on the same weights and 2 examples (the CPU
    runs the kernels' plain versions, the path the CPU tests hold against
    the JAX package), every latent level and the logits: logits within
    1e-3, latents within 1e-4."""
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.models.vae import build_model, draw_eps

    cfg = get_config(name)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float32", use_pallas_conv1=True))
    gpu = build_model(cfg, device=dev, seed=seed)
    cpu = build_model(cfg, device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    n = cfg.model.num_bars
    x = torch.tensor((rng.random((2, n, 96, 128)) < 0.05).astype(np.uint8))
    eps = draw_eps(cfg.model, 2, torch.Generator().manual_seed(seed))
    labels = {}
    if cfg.model.kind == "cond":
        labels = {"chord": torch.tensor(rng.integers(0, 24, (2, n))),
                  "key_sig": torch.tensor(rng.integers(0, 24, (2,)))}
    with torch.inference_mode():
        lg, lat_g = gpu(x.to(dev), tuple(e.to(dev) for e in eps),
                        **{k: v.to(dev) for k, v in labels.items()})
        lc, lat_c = cpu(x, eps, **labels)
    err = float((lg.cpu() - lc).abs().max())
    lat_err = max(float((a.cpu() - b).abs().max())
                  for pair_g, pair_c in zip(lat_g, lat_c)
                  for a, b in zip(pair_g, pair_c))
    log(f"reference: f32 {name} forward card vs CPU: logits max abs diff "
        f"{err:.3e}, latents {lat_err:.3e}")
    check(bool(torch.isfinite(lg).all()), f"{name}: non-finite logits")
    check(err <= 1e-3 and lat_err <= 1e-4,
          f"{name}: card and CPU disagree: logits {err}, latents {lat_err}")
    return {"logits_max_abs_diff": err, "latents_max_abs_diff": lat_err,
            "levels": len(lat_g)}


def serve_phase(seed: int, dev: torch.device, card: str):
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
    # the whole sweep's graph replay held the same way: the card's time
    # for the sweep, the graph's own gaps included
    split["sweep_device_ms"] = held_ms(
        lambda: service.generate(torch.Generator(dev).manual_seed(seeds[0])),
        spin_cycles=40_000_000)
    split["device_busy_share"] = split["sweep_device_ms"] / split["sweep_ms"]
    log(f"serve request split: {split} (bar_device_ms: one eager bar's "
        "work on the card with the host out of the way, sweep_device_ms "
        "the sweep graph's; the rest host clock)")
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
    graph = _serve_graph_checks(cfg, model, service, seeds, dev)
    coal_launches, coalesced = _coalesced_graph_checks(
        cfg, model, service, seeds, dev, card)
    return ({"serve": launches, "serve_coalesced": coal_launches},
            {"latency_ms": latencies, "stats": stats,
             "request_split": split,
             "stock_conv_differ_cells": differ,
             "stock_conv_total_cells": total,
             "stock_conv_first_bar_differ": first_bar_differ,
             "graph": graph, "coalesced": coalesced})


COALESCE_W = 4        # serve --coalesce width held graph against eager
COALESCE_ROUNDS = 3   # full-width sweeps held to eager ones (and serial)


def _coalesced_graph_checks(cfg, model, service, seeds, dev, card: str):
    """``serve --coalesce 4``'s sweep (``make_coalesced_generate_fn``
    through ``_CoalescedRunner``) as captured graphs: the runner's warm-up
    runs each tier (W=1, W=4) twice, so both are captured before a
    request; then COALESCE_ROUNDS full-width sweeps (a seeded slot among
    them) and a lone one equal the same sweeps under ``debug_mode``'s
    disable_jit bit for bit, every slot's generator ending at the same
    state, which is the state a serial request's sweep leaves, and each
    slot's bars hold to the serial sweep's under the flip rule; then the
    sweep's ms and stdin ``--coalesce 4``'s req/s, graph and eager in
    turns. Returns (launches of the warm-up and the held sweeps,
    details)."""
    from musicvae_tpu_torch import cli
    from musicvae_tpu_torch.generate import sampler
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.ops.pack import unpack_bits_np
    from musicvae_tpu_torch.utils import debug_mode

    t_block = time.perf_counter()
    b = cfg.gen.num_samples
    bar = service.generate(torch.Generator(dev).manual_seed(seeds[-1]))[
        0, -1].contiguous()             # a generated bar as the seed bar
    runner = cli._CoalescedRunner(service, COALESCE_W)
    _kernels.reset_launches()
    runner.warm()
    coalesced = service.weights.coalesced

    def sweep(round_seeds, seeded):
        gens = [sampler.seed_generator(s, dev) for s in round_seeds]
        sb = torch.zeros((len(gens), b, 96, 128), dtype=torch.uint8,
                         device=dev)
        if seeded is not None:
            sb[seeded] = bar
        return coalesced(gens, sb), [gn.get_state() for gn in gens], sb

    rounds = [([seeds[0] + 100 * r + i for i in range(COALESCE_W)],
               r % COALESCE_W) for r in range(COALESCE_ROUNDS)]
    rounds.append(([seeds[0] + 777], None))             # the lone tier
    got = [sweep(*r) for r in rounds]
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    with debug_mode(nans=False, disable_jit=True):
        want = [sweep(*r) for r in rounds]
    programs = coalesced.programs
    out = {"sweeps": len(rounds),
           "bits_equal": all(torch.equal(a[0], w[0])
                             for a, w in zip(got, want)),
           "slot_generators_equal": all(
               torch.equal(x, y) for a, w in zip(got, want)
               for x, y in zip(a[1], w[1])),
           "programs": {str(k[0]): {
               "graphed": p.program.graph is not None,
               "replays": p.program.replays,
               "launches_per_replay": {n: v for n, v in
                                       p.program.launches.items() if v},
               "graph": p.program.info} for k, p in programs.items()}}
    check(out["bits_equal"] and out["slot_generators_equal"],
          "coalesced: the graphs' sweeps differ from eager ones")
    check(sorted(out["programs"]) == ["1", str(COALESCE_W)]
          and all(p["graphed"] for p in out["programs"].values()),
          f"coalesced: programs {out['programs']}")
    check(out["programs"][str(COALESCE_W)]["replays"] == 1 + COALESCE_ROUNDS
          and out["programs"][str(COALESCE_W)]["launches_per_replay"]
          == {"first_conv_s2": cfg.gen.num_bars,
              # a bar: the previous bar's trunk (4 convs) and the head (4
              # and its last layer)
              "conv_epilogue": 8 * cfg.gen.num_bars,
              "head_out_fwd": cfg.gen.num_bars},
          f"coalesced: {out['programs']}")
    check(launches["first_conv_s2"] == cfg.gen.num_bars * (4 + len(rounds)),
          f"coalesced: K1 launched {launches['first_conv_s2']} times in "
          f"4 warm-up sweeps and {len(rounds)} held ones")
    # against serial serving: each slot's generator state and bars
    refs, results, states = [], [], []
    for (round_seeds, seeded), (packed, gen_states, sb) in zip(rounds, got):
        bars = unpack_bits_np(packed.cpu().numpy())
        for i, s in enumerate(round_seeds):
            gen = sampler.seed_generator(s, dev)
            service.generate(gen, seed_bar=sb[i] if i == seeded else None)
            states.append(torch.equal(gen.get_state(), gen_states[i]))
            refs.append(_serial_reference(
                cfg, model, dev, s,
                None if i != seeded else bar.cpu().numpy()))
            results.append(bars[i])
    out["slot_generators_equal_serial"] = all(states)
    out["vs_serial"] = _agree(results, refs, cfg.midi.binarize_threshold)
    log(f"coalesced graph vs eager and serial: {out}")
    check(out["slot_generators_equal_serial"],
          "coalesced: a slot's generator ends elsewhere than a serial "
          "request's")
    gens = [sampler.seed_generator(s, dev) for s in rounds[0][0]]
    sb0 = torch.zeros((COALESCE_W, b, 96, 128), dtype=torch.uint8,
                      device=dev)
    _, names, kernel_ms, _ = _dispatch_trace(lambda: coalesced(gens, sb0))
    out["kernels_per_replay"] = sum(names.values())
    out["kernel_ms_per_replay"] = kernel_ms
    lines = "".join(json.dumps({"id": i, "seed": seeds[0] + 50 + i}) + "\n"
                    for i in range(SERVE_TIMED))
    timing = {}
    for name in ("graph", "eager", "eager_again", "graph_again"):
        with (contextlib.nullcontext() if name.startswith("graph")
              else debug_mode(nans=False, disable_jit=True)):
            svc = cli.Service(cfg, model)
            r = cli._CoalescedRunner(svc, COALESCE_W)
            r.warm()
            sweep_ms = _timed_calls(
                lambda i: svc.weights.coalesced(
                    [sampler.seed_generator(s + i, dev)
                     for s in rounds[0][0]], sb0).cpu(), 4)
            o = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.serve_stream_coalesced(svc, r, io.StringIO(lines), o)
            dt = time.perf_counter() - t0
        resp = [json.loads(ln) for ln in o.getvalue().splitlines()]
        check(len(resp) == SERVE_TIMED and all("midi_b64" in x
                                                for x in resp),
              f"coalesced timing {name}: {resp[:1]}")
        timing[name] = {**_load_stats([x["latency_ms"] for x in resp],
                                      len(resp), dt, float(np.mean(
                                          [x["density"] for x in resp]))),
                        "sweep_ms": sweep_ms,
                        "graphed": _graphs_captured(svc.weights.coalesced)}
        check(timing[name]["graphed"] == name.startswith("graph"),
              f"coalesced timing {name}: graphed "
              f"{timing[name]['graphed']}")
    out["timing"] = timing
    out["device_busy_share"] = kernel_ms / timing["graph_again"]["sweep_ms"]
    log(f"coalesced --coalesce {COALESCE_W} timing, graph and eager in "
        f"turns ({card}): {timing}")
    out["seconds"] = time.perf_counter() - t_block
    return launches, out


SERVE_TIMED = 8       # requests of each timed serve run, graph and eager


def _serve_graph_checks(cfg, model, service, seeds, dev) -> dict:
    """The served sweep's graphs against the eager sweep body on the same
    generator states, with and without a seed bar, bit for bit; different
    seeds give different bars; then p50 latency and req/s of stdin serial
    serving, graphs and eager (``debug_mode``'s disable_jit) in turns."""
    from musicvae_tpu_torch.cli import Service, serve_stream
    from musicvae_tpu_torch.generate import sampler
    from musicvae_tpu_torch.utils import debug_mode

    body = sampler._sweep_body(cfg, model)
    b = cfg.gen.num_samples
    bar = service.generate(torch.Generator(dev).manual_seed(seeds[-1]))[
        :, -1].contiguous()              # a generated bar as the seed bar
    got = {}
    for name, sb in (("plain", None), ("seeded", bar)):
        got[name] = []
        for s in seeds:
            g = service.generate(torch.Generator(dev).manual_seed(s),
                                 seed_bar=sb)
            with torch.inference_mode():
                want = body(b, torch.Generator(dev).manual_seed(s), sb,
                            None, None, None, None)
            check(torch.equal(g, want), f"serve graph vs eager ({name}, "
                                        f"seed {s}): the bars differ")
            got[name].append(g)
        check(all(not torch.equal(got[name][0], x) for x in got[name][1:]),
              f"serve ({name}): different seeds gave the same bars")
    programs = service.generate.programs
    check(len(programs) == 2 and all(p.program.graph is not None
                                     for p in programs.values()),
          f"serve: {len(programs)} sweep programs, not all captured")
    lines = "".join(json.dumps({"id": i, "seed": seeds[0] + 50 + i}) + "\n"
                    for i in range(SERVE_TIMED))
    timing = {}
    for name in ("graph", "eager", "eager_again", "graph_again"):
        ctx = (contextlib.nullcontext() if name.startswith("graph")
               else debug_mode(nans=False, disable_jit=True))
        with ctx:
            svc = Service(cfg, model)
            svc.warm()
            out = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve_stream(svc, io.StringIO(lines), out)
            dt = time.perf_counter() - t0
        resp = [json.loads(ln) for ln in out.getvalue().splitlines()]
        check(len(resp) == SERVE_TIMED and all("midi_b64" in r
                                                for r in resp),
              f"serve timing {name}: {resp[:1]}")
        timing[name] = _load_stats([r["latency_ms"] for r in resp],
                                   len(resp), dt, float(np.mean(
                                       [r["density"] for r in resp])))
        timing[name]["graphed"] = _graphs_captured(svc.generate)
        check(timing[name]["graphed"] == name.startswith("graph"),
              f"serve timing {name}: graphed {timing[name]['graphed']}")
        timing[name]["graph"] = _graph_info(svc.generate)
    out = {"bits_equal_seeds": len(seeds), "seeded_and_plain": True,
           "timing": timing}
    log(f"serve graph vs eager: {out}")
    return out


EVAL_BATCHES = 4     # batches each eval program is held to its eager runs
EVAL_TIMED = 10      # timed eval batches (reconstructed windows) each way
RECON_WINDOWS = 6    # windows the reconstruction is held to its eager runs


def _timed_calls(fn, n: int) -> float:
    """Mean host ms of ``n`` calls of ``fn``, each waited for (the host
    reads what the call returns, as its callers do)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _eval_graph_checks(cfg, seed: int, dev, card: str):
    """The eval (``make_eval_fn``) of a model and of its EMA model as
    captured graphs: EVAL_BATCHES 64x4 batches through each model's
    program (the first eager, the second captured, then replays) equal
    the same calls under ``debug_mode``'s disable_jit bit for bit, and
    each model has a program of its own; then ms a batch, graph and
    eager in turns, with one host read of the stacked metrics a batch
    (``train()``'s evals). Returns (launches of the graphed evals,
    details)."""
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import debug_mode
    from musicvae_tpu_torch.utils.metrics import make_eval_fn

    t_block = time.perf_counter()
    ecfg = cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=0.9))
    model, state = trainer.create_state(ecfg, device=dev, seed=seed + 2)
    g = torch.Generator(dev).manual_seed(seed + 3)

    def batch():
        return ((torch.rand((64, 4, 96, 128), generator=g, device=dev)
                 < 0.05).to(torch.uint8),
                (torch.randn((64, cfg.model.z_dim), generator=g,
                             device=dev),))

    step = trainer.make_train_step(ecfg, model)
    for _ in range(2):                  # the EMA moves off the weights
        step(state, {"x": batch()[0]})
    batches = [batch() for _ in range(EVAL_BATCHES)]
    fns = {"model": make_eval_fn(cfg, model),
           "ema": make_eval_fn(cfg, state.ema_model)}
    _kernels.reset_launches()
    got = {name: [fn(x, eps) for x, eps in batches]
           for name, fn in fns.items()}
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    with debug_mode(nans=False, disable_jit=True):
        want = {name: [fn(x, eps) for x, eps in batches]
                for name, fn in fns.items()}
    out = {"bits_equal": all(
        torch.equal(a[k], b[k]) for name in fns
        for a, b in zip(got[name], want[name]) for k in a),
        "ema_differs": got["model"][0]["loss"].item()
        != got["ema"][0]["loss"].item()}
    for name, fn in fns.items():
        (p,) = [s.program for s in fn.programs.values()]
        out[name] = {"graphed": p.graph is not None, "replays": p.replays,
                     "launches_per_replay": {k: v for k, v in
                                             p.launches.items() if v},
                     "graph": p.info}
    log(f"eval graph vs eager ({EVAL_BATCHES} batches, model and EMA): "
        f"{out}; launches {launches}")
    check(out["bits_equal"], "eval: the graphs' metrics differ from eager")
    check(out["ema_differs"], "eval: the EMA model scores as the model")
    for name in fns:
        check(out[name]["graphed"]
              and out[name]["replays"] == EVAL_BATCHES - 1
              and out[name]["launches_per_replay"]
              == {"first_conv_s2": 2, "masked_bce_sum": 1,
                  "conv_epilogue": 12, "head_out_fwd": 1},
              f"eval {name}: {out[name]}")
    check(launches["masked_bce_sum"] == 2 * EVAL_BATCHES
          and launches["first_conv_s2"] == 4 * EVAL_BATCHES,
          f"eval: launches {launches}")
    fn = fns["model"]
    x, eps = batches[0]
    _, names, kernel_ms, _ = _dispatch_trace(lambda: fn(x, eps))
    out["kernels_per_replay"] = sum(names.values())
    out["kernel_ms_per_replay"] = kernel_ms
    timing = {}
    for name in ("graph", "eager", "eager_again", "graph_again"):
        with (contextlib.nullcontext() if name.startswith("graph")
              else debug_mode(nans=False, disable_jit=True)):
            timing[name] = _timed_calls(
                lambda i: torch.stack(list(fn(*batches[i % EVAL_BATCHES])
                                           .values())).tolist(), EVAL_TIMED)
    out["ms_per_batch"] = timing
    out["device_busy_share"] = kernel_ms / timing["graph_again"]
    log(f"eval ms a 64x4 batch, graph and eager in turns ({card}): "
        f"{timing}; the graph's kernels {kernel_ms:.3f} ms in "
        f"{out['kernels_per_replay']} kernels")
    out["seconds"] = time.perf_counter() - t_block
    return launches, out


def _reconstruct_graph_checks(cfg, model, seed: int, dev, card: str):
    """``reconstruct_fn`` as a captured graph: RECON_WINDOWS [1, 4, 96,
    128] f32 windows, each with a generator of its own (the
    ``reconstruct`` command's posterior seed a window), the first eager,
    the second captured, then replays, equal to the same windows under
    ``debug_mode``'s disable_jit bit for bit, the generators too; then ms
    a window, graph and eager in turns. Returns (launches, details)."""
    from musicvae_tpu_torch.generate import sampler
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.utils import debug_mode

    t_block = time.perf_counter()
    g = torch.Generator(dev).manual_seed(seed + 4)
    windows = [(torch.rand((1, 4, 96, 128), generator=g, device=dev)
                < 0.08).to(torch.float32) for _ in range(RECON_WINDOWS)]
    rec = sampler.reconstruct_fn(cfg, model)

    def run(w):
        gen = torch.Generator(dev).manual_seed(seed + w)
        return rec(windows[w], gen), gen.get_state()

    _kernels.reset_launches()
    got = [run(w) for w in range(RECON_WINDOWS)]
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    with debug_mode(nans=False, disable_jit=True):
        want = [run(w) for w in range(RECON_WINDOWS)]
    (p,) = [s.program for s in rec.programs.values()]
    out = {"windows": RECON_WINDOWS,
           "bits_equal": all(torch.equal(a[0], b[0])
                             for a, b in zip(got, want)),
           "generators_equal": all(torch.equal(a[1], b[1])
                                   for a, b in zip(got, want)),
           "density": float(torch.stack([o for o, _ in got]).mean()),
           "graphed": p.graph is not None, "replays": p.replays,
           "launches_per_replay": {k: v for k, v in p.launches.items()
                                   if v},
           "graph": p.info}
    log(f"reconstruct graph vs eager: {out}")
    check(out["bits_equal"] and out["generators_equal"],
          "reconstruct: the graph's windows differ from eager ones")
    check(out["graphed"] and out["replays"] == RECON_WINDOWS - 1
          and out["launches_per_replay"] == {"first_conv_s2": 2,
                                             "conv_epilogue": 12,
                                             "head_out_fwd": 1},
          f"reconstruct: {out}")
    check(0.0 < out["density"] < 1.0, f"reconstruct: density "
                                      f"{out['density']}")
    _, names, kernel_ms, _ = _dispatch_trace(lambda: run(0))
    out["kernels_per_replay"] = sum(names.values())
    out["kernel_ms_per_replay"] = kernel_ms
    timing = {}
    for name in ("graph", "eager", "eager_again", "graph_again"):
        with (contextlib.nullcontext() if name.startswith("graph")
              else debug_mode(nans=False, disable_jit=True)):
            timing[name] = _timed_calls(
                lambda i: run(i % RECON_WINDOWS)[0].cpu(), EVAL_TIMED)
    out["ms_per_window"] = timing
    log(f"reconstruct ms a window, graph and eager in turns ({card}): "
        f"{timing}; the graph's kernels {kernel_ms:.3f} ms in "
        f"{out['kernels_per_replay']} kernels")
    out["seconds"] = time.perf_counter() - t_block
    return launches, out


def eval_phase(seed: int, dev: torch.device, card: str):
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
    graph_launches, graph = _eval_graph_checks(cfg, seed, dev, card)
    rec_launches, rec = _reconstruct_graph_checks(cfg, model, seed, dev,
                                                  card)
    return ({"eval": launches, "eval_graph": graph_launches,
             "reconstruct": rec_launches},
            {"kernel": got, "plain": plain, "eval_ms_host": dt * 1e3,
             "graph": graph, "reconstruct": rec})


def profiled_kernels(fn, attempts: int = 3):
    """(kernel launches, summed kernel time in ms) on the card for one call
    of ``fn``, from torch.profiler. The times are the kernels' own; the
    host's launch gaps between them are not in the sum. A trace with no
    device time (CUPTI drops one now and then) is taken again, up to
    ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.count, e.device_time_total) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        if rows:
            return sum(r[0] for r in rows), sum(r[1] for r in rows) / 1e3
    check(False, f"torch.profiler recorded no device time in {attempts} "
                 f"traces")


def fused_elbo_phase(seed: int, dev: torch.device):
    """``fused_elbo`` (the single-output BCE kernel, its backward kernel
    and the KL pair) against ``elbo_loss`` under autograd, at the train
    shapes. Value 1e-5 relative, gradients 1e-6 absolute."""
    from musicvae_tpu_torch.ops import _kernels, fused_elbo, losses

    g = torch.Generator(dev).manual_seed(seed + 7)
    shape = (64, 4, 96, 128)
    logits = 3.0 * torch.randn(shape, generator=g, device=dev)
    x = (torch.rand(shape, generator=g, device=dev) < 0.05).to(torch.uint8)
    mask = torch.ones(128, device=dev)
    mu = torch.randn((64, 128), generator=g, device=dev)
    lv = torch.randn((64, 128), generator=g, device=dev)
    beta = torch.full((), 0.37, device=dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (logits, mu, lv)]
        loss, aux = fn(leaves[0], x, mask, leaves[1], leaves[2], beta)
        return (loss.detach(), aux,
                torch.autograd.grad(loss, leaves))

    _kernels.reset_launches()
    loss, aux, grads = run(fused_elbo.fused_elbo)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    want, _, want_grads = run(losses.elbo_loss)
    rel = abs(float(loss) - float(want)) / abs(float(want))
    errs = {n: float((a - b).abs().max())
            for n, a, b in zip(("dlogits", "dmu", "dlogvar"), grads,
                               want_grads)}
    out = {"kernel_loss": float(loss), "plain_loss": float(want),
           "rel_err": rel, "grad_max_abs_err": errs,
           "recon": float(aux["recon"].detach()),
           "kl": float(aux["kl"].detach())}
    log(f"fused_elbo launches: {launches}")
    log(f"fused_elbo: {out}")
    check(rel <= 1e-5, f"fused_elbo value disagrees (rel {rel:.2e})")
    check(all(e <= 1e-6 for e in errs.values()),
          f"fused_elbo gradients disagree: {errs}")
    for name in ("masked_bce_sum", "masked_bce_bwd", "kl_sum", "kl_bwd"):
        check(launches[name] == 1, f"{name} launched {launches[name]} "
                                   f"times in fused_elbo, expected 1")
    return launches, out


def make_bar_cache(seed: int, pieces: int = 128, bars_per_piece: int = 32,
                   num_bars: int = 4):
    """A seeded uint8 bar cache with musical structure (held notes from a
    per-piece scale on a per-piece rhythm grid), as a PianoRollDataset of
    ``num_bars`` windows that never cross a piece."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset

    rng = np.random.default_rng(seed)
    n = pieces * bars_per_piece
    bars = np.zeros((n, 96, 128), np.uint8)
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    for piece in range(pieces):
        root = rng.integers(36, 60)
        grid = int(rng.choice([6, 12, 24]))
        for bar in range(bars_per_piece):
            roll = bars[piece * bars_per_piece + bar]
            for _ in range(int(rng.integers(6, 14))):
                pitch = root + 12 * rng.integers(0, 3) + rng.choice(scale)
                start = grid * rng.integers(0, 96 // grid)
                roll[start:start + grid * rng.integers(1, 4), pitch] = 1
    per = bars_per_piece - num_bars + 1
    starts = (np.arange(pieces)[:, None] * bars_per_piece
              + np.arange(per)[None, :]).reshape(-1)
    zeros = np.zeros(starts.shape[0], np.int32)
    return PianoRollDataset(bars, starts, num_bars, zeros, zeros,
                            np.repeat(np.arange(pieces), per),
                            grid=(24, 4, 0))


TRAIN_STEPS = 20
TRAIN_K = 5
LOSS_TOL_PLAIN = 1e-3    # kernel loss vs plain BCE under autograd, 5 steps:
#                          the two gradients differ by f32 rounding only
LOSS_TOL_CONV1 = 1e-2    # first-conv kernels vs cuDNN, 5 steps: bf16
#                          rounding at the first conv, fed through Adam
GRAD_NORM_TOL = 0.05     # bf16 step's grad_norm vs the f32 step's


def _resident(ds, dev, cond: bool = False) -> dict:
    """A dataset's resident tensors on the card, as ``train()`` uploads
    them (with the window labels for cond)."""
    data = {"bars": torch.from_numpy(ds.bars).to(dev),
            "starts": torch.from_numpy(ds.starts).to(dev)}
    if cond:
        data["chords"] = torch.from_numpy(ds.chords).to(dev)
        data["keys"] = torch.from_numpy(ds.keys).to(dev)
    return data


def _rng_equal(a, b) -> bool:
    return torch.equal(a.generator.get_state(), b.generator.get_state())


def _graph_info(fn) -> list:
    """capture_ms, instantiate_ms and pool_bytes of each program a graphed
    function holds (utils/graphs.py ``Program.info``)."""
    return [p.program.info for p in fn.programs.values()]


def _graphs_captured(fn) -> bool:
    return bool(fn.programs) and all(p.program.graph is not None
                                     for p in fn.programs.values())


def _graph_vs_eager_steps(cfg, ds, dev, seed: int, steps: int) -> dict:
    """``steps`` steps of one ``make_train_step_indexed_multi`` dispatch
    (the first eager, then the captured graph's replays) against as many
    eager ``make_train_step_indexed`` calls, each from ``create_state``'s
    bits, on the same window ids, under deterministic algorithms: the last
    step's metrics, the state's bits (params, moments, count, step, EMA)
    and the generator's state must be equal."""
    from musicvae_tpu_torch.train import trainer

    data = _resident(ds, dev, cfg.model.kind == "cond")
    ids = trainer.make_id_schedule(seed, len(ds), cfg.train.batch_size)
    idxs = torch.from_numpy(np.stack([ids(j) for j in range(steps)])).to(dev)
    model_g, state_g = trainer.create_state(cfg, device=dev)
    model_e, state_e = trainer.create_state(cfg, device=dev)
    multi = trainer.make_train_step_indexed_multi(cfg, model_g)
    single = trainer.make_train_step_indexed(cfg, model_e)
    with trainer.deterministic_algorithms():
        _, m_g = multi(state_g, data, idxs)
        for j in range(steps):
            _, m_e = single(state_e, data, idxs[j])
    torch.cuda.synchronize()
    same = (all(torch.equal(m_g[k], m_e[k]) for k in m_e)
            and all(torch.equal(a, b) for a, b in zip(
                _state_bits(state_g), _state_bits(state_e)))
            and _rng_equal(state_g, state_e))
    out = {"steps": steps, "bits_equal": same,
           "graphed": _graphs_captured(multi), "graph": _graph_info(multi),
           "loss": float(m_g["loss"])}
    check(out["graphed"], f"{cfg.name}: the dispatch captured no graph")
    check(same, f"{cfg.name}: {steps} graph steps differ from eager ones: "
                f"loss {float(m_g['loss'])!r} vs {float(m_e['loss'])!r}")
    return out


def _dispatch_trace(fn, attempts: int = 3):
    """(host runtime calls by name, device kernels by name with their
    counts, the summed kernel time in ms, the launches the wrappers
    counted) of one call of ``fn``, from torch.profiler
    (``profiled_kernels``' sums). CUPTI drops a trace's device records now
    and then, all of them or one kernel's: a trace with no device time,
    or whose hand-written kernels by name differ from the launches counted
    for the same call (``_traced_kernels_agree``), is taken again, and
    the last is returned if every attempt disagrees."""
    from torch.profiler import ProfilerActivity, profile

    from musicvae_tpu_torch.ops import _kernels

    out = None
    for _ in range(attempts):
        before = dict(_kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counted = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        events = prof.key_averages()
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.device_time_total > 0]
        if device:
            calls = {e.key: e.count for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.key.startswith("cuda")}
            names = {e.key: e.count for e in device}
            out = (calls, names,
                   sum(e.device_time_total for e in device) / 1e3, counted)
            if _traced_kernels_agree(names, counted):
                return out
    check(out is not None, f"torch.profiler recorded no device time in "
                           f"{attempts} traces")
    return out


def _traced_kernels_agree(names: dict, counted: dict) -> bool:
    """Whether a trace holds as many K4, K1, K1b, conv epilogue and head
    kernels by name as their wrappers counted launches for the traced
    call."""
    return (_kernel_calls(names, "bce_sum<")
            >= counted["masked_bce_sum_dual"]
            and _kernel_calls(names, "conv1_kernel")
            == counted["first_conv_s2"]
            and _kernel_calls(names, "conv1_bwd_kernel")
            == counted["first_conv_s2_bwd"]
            and _kernel_calls(names, "conv_epilogue_fwd")
            == counted["conv_epilogue"]
            and _kernel_calls(names, "conv_epilogue_bwd")
            == counted["conv_epilogue_bwd"]
            and _kernel_calls(names, "head_out_fwd")
            == counted["head_out_fwd"]
            and _kernel_calls(names, "head_out_bwd")
            == counted["head_out_bwd"])


def _runtime_calls(calls: dict, prefix: str) -> int:
    return sum(n for k, n in calls.items() if k.startswith(prefix))


def _kernel_calls(kernels: dict, name: str) -> int:
    return sum(n for k, n in kernels.items() if name in k)


STREAM_TIMED = 6      # timed streamed dispatches of TRAIN_K steps, each way
STREAM_TRAIN = 30     # steps of each streamed / resident train() timing run
PRODUCER_KS = (TRAIN_K, 100)   # stack sizes the producer is timed at:
#                                the smoke's K and train()'s cap


def _queued_stacks(uploader, stacks):
    """The uploaded stacks as the producer hands them to the train loop:
    a queue of ("stack", device tensors, event) items."""
    import queue

    q = queue.Queue()
    for stacked in stacks:
        q.put(("stack",) + uploader.put(stacked))
    return q


def _producer_ms(ds, b: int, seed: int, k: int, uploader, reps: int = 3):
    """The streaming producer's host work for one K-stack, by part (host
    clock): the K host batches from the iterator, stacking and packing
    (``_stack_host_batches``), and the upload's staging and enqueue
    (``_StackUploader.put``; its copy runs on the side stream), the
    mean of ``reps`` stacks after one."""
    from musicvae_tpu_torch.train import trainer

    it = ds.iterator(b, seed=seed, x_dtype=np.uint8)
    parts = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        host = [next(it) for _ in range(k)]
        t1 = time.perf_counter()
        stacked = trainer._stack_host_batches(host, cond=False)
        t2 = time.perf_counter()
        uploader.put(stacked)
        t3 = time.perf_counter()
        parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    torch.cuda.synchronize()
    mean = [sum(p[i] for p in parts[1:]) / reps for i in range(3)]
    out = {"k": k, "batches_ms": mean[0], "stack_pack_ms": mean[1],
           "put_ms": mean[2], "stack_ms": sum(mean),
           "stack_ms_per_step": sum(mean) / k,
           "rolls_bytes": k * b * 4 * 96 * 128,
           "packed_bytes": k * b * 4 * 96 * 16}
    return out


def _stream_graph_checks(cfg, ds, dev, seed: int, card: str):
    """The streamed dispatch (``make_train_step_multi(packed_x=True)``)
    as a captured graph. (a) ``train()`` on an iterator of host batches,
    20 steps in dispatches of 5 behind the producer thread, and the same
    20 batches as one-step streamed dispatches (each stack uploaded on
    the producer's side stream and taken through ``_next_stack``), against
    20 eager ``make_train_step`` steps on the unpacked rolls from the same
    initial bits: every loss, the parameters, Adam moments, count, step
    and the generator's state, bit for bit. (b) steps/s, host and enqueue
    ms, kernel ms and the busy share of streamed dispatches over uploaded
    stacks, graph and eager (``debug_mode``'s disable_jit) in turns; a
    steady graph dispatch's runtime calls and kernels. (c) ``train()``'s
    steps/s streamed (graph, eager) against resident (graph), at K = 5 and
    at K = 100, and the producer's host ms a stack at both. The tracer's
    totals of (a)'s ``train()``: its step built once (one warm-up, capture
    and instantiate) and each dispatch's and stack's spans once. Returns
    (launches of the streamed ``train()`` run, details)."""
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import debug_mode, trace

    t_block = time.perf_counter()
    b = cfg.train.batch_size
    scfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_every=0))

    def batches(n):
        it = ds.iterator(b, seed=seed, x_dtype=np.uint8)
        return [next(it) for _ in range(n)]

    host = batches(TRAIN_STEPS)
    # (a) eager single steps, then train() on the iterator, then one-step
    # streamed dispatches
    model_e, state_e = trainer.create_state(scfg, device=dev)
    single = trainer.make_train_step(scfg, model_e)
    with trainer.deterministic_algorithms():
        eager_losses = [single(state_e, {"x": torch.from_numpy(
            h["x"]).to(dev)})[1]["loss"] for h in host]
    eager_losses = [float(v) for v in eager_losses]
    logged = []
    _kernels.reset_launches()
    trace.reset()
    _, state_t, _ = trainer.train(
        scfg, ds.iterator(b, seed=seed, x_dtype=np.uint8),
        num_steps=TRAIN_STEPS, log_fn=lambda s, m: logged.append((s, m)),
        device=dev)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(launches["masked_bce_sum_dual"] == TRAIN_STEPS,
          f"train --stream's path launched K4 "
          f"{launches['masked_bce_sum_dual']} times in {TRAIN_STEPS} steps")
    # the tracer's totals: one signature is built once over the dispatches
    spans = {k: v[0] for k, v in trace.totals().items()}
    log(f"train --stream spans (count): {spans}")
    dispatches = TRAIN_STEPS // TRAIN_K
    check(all(spans.get(n) == 1 for n in (
              "graph.warmup", "graph.capture", "graph.instantiate"))
          and all(spans.get(n) == dispatches for n in (
              "train.prepare", "train.enqueue", "train.read",
              "stream.stack", "stream.upload")),
          f"train --stream's spans over {dispatches} dispatches: {spans}")
    uploader = trainer._StackUploader(dev)
    model_g, state_g = trainer.create_state(scfg, device=dev)
    multi_1 = trainer.make_train_step_multi(scfg, model_g, packed_x=True)
    q = _queued_stacks(uploader, [trainer._stack_host_batches([h], False)
                                  for h in host])
    graph_losses = []
    with trainer.deterministic_algorithms():
        for _ in host:
            graph_losses.append(multi_1(
                state_g, trainer._next_stack(q, dev))[1]["loss"])
    graph_losses = [float(v) for v in graph_losses]
    bits_e = _state_bits(state_e)
    (program,) = [p.program for p in multi_1.programs.values()]
    out = {
        "loss_sequence_equal": graph_losses == eager_losses,
        "train_logged_losses_equal": [m["loss"] for _, m in logged]
        == eager_losses[TRAIN_K - 1::TRAIN_K],
        "train_state_bits_equal": all(torch.equal(x, y) for x, y in zip(
            _state_bits(state_t), bits_e)),
        "train_generator_equal": _rng_equal(state_t, state_e),
        "one_step_dispatches_state_bits_equal": all(
            torch.equal(x, y) for x, y in zip(_state_bits(state_g), bits_e)),
        "one_step_dispatches_generator_equal": _rng_equal(state_g, state_e),
        "graphed": _graphs_captured(multi_1),
        "replays": program.replays,
        "launches_per_replay": {k: v for k, v in program.launches.items()
                                if v}}
    log(f"train stream graph vs eager, {TRAIN_STEPS} steps: {out}")
    check(all(v for k, v in out.items() if k not in (
              "replays", "launches_per_replay")),
          f"streamed graph and eager training differ: {out}")
    check(out["replays"] == TRAIN_STEPS - 1
          # the first conv through cuDNN too: 5 convs a trunk and 4
          # transposed convs, each way, and the head's last layer
          and out["launches_per_replay"] == {"masked_bce_sum_dual": 1,
                                             "conv_epilogue": 14,
                                             "conv_epilogue_bwd": 14,
                                             "head_out_fwd": 1,
                                             "head_out_bwd": 1},
          f"streamed dispatch: {out['replays']} replays, "
          f"{out['launches_per_replay']} a replay")
    del model_e, state_e, model_g, state_g, multi_1, state_t

    # (b) dispatches by hand over uploaded stacks, graph and eager in turns
    n_disp = STREAM_TIMED + 2
    it = ds.iterator(b, seed=seed + 1, x_dtype=np.uint8)
    stacks = [trainer._stack_host_batches([next(it) for _ in range(TRAIN_K)],
                                          False) for _ in range(n_disp + 2)]

    def timed(graph):
        model, state = trainer.create_state(scfg, device=dev)
        multi = trainer.make_train_step_multi(scfg, model, packed_x=True)
        q = _queued_stacks(uploader, stacks)
        ctx = contextlib.ExitStack()
        ctx.enter_context(trainer.deterministic_algorithms())
        if not graph:
            ctx.enter_context(debug_mode(nans=False, disable_jit=True))
        with ctx:
            for _ in range(2):                          # warm-up, capture
                multi(state, trainer._next_stack(q, dev))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                for _ in range(STREAM_TIMED):
                    state, m = multi(state, trainer._next_stack(q, dev))
                enqueue = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            rest = trainer._next_stack(q, dev)
            calls, names, kernel_ms, counted = _dispatch_trace(
                lambda: multi(state, rest))
        steps = STREAM_TIMED * TRAIN_K
        t = {"steps_per_s": steps / host_s,
             "host_ms_per_step": host_s / steps * 1e3,
             "enqueue_ms_per_step": enqueue / steps * 1e3,
             "device_ms_per_step": kernel_ms / TRAIN_K,
             "kernels_per_step": sum(names.values()) / TRAIN_K,
             "loss": float(m["loss"]),
             "graphed": _graphs_captured(multi),
             "graph": _graph_info(multi),
             "dispatch": {
                 "graph_launches": _runtime_calls(calls, "cudaGraphLaunch"),
                 "kernel_launches": _runtime_calls(calls,
                                                   "cudaLaunchKernel"),
                 "memcpy": _runtime_calls(calls, "cudaMemcpy"),
                 "k4_kernels": _kernel_calls(names, "bce_sum<"),
                 "counted": {k: v for k, v in counted.items() if v}}}
        t["device_busy_share"] = t["device_ms_per_step"] / t[
            "host_ms_per_step"]
        check(t["graphed"] == graph, f"streamed timing: graphed "
                                     f"{t['graphed']}, asked {graph}")
        d = t["dispatch"]
        check(d["k4_kernels"] == TRAIN_K
              and d["counted"].get("masked_bce_sum_dual") == TRAIN_K,
              f"streamed dispatch: the profiler's kernels and the counts "
              f"disagree: {d}")
        if graph:
            check(d["graph_launches"] == TRAIN_K
                  and d["kernel_launches"] <= 4 * TRAIN_K + 8,
                  f"a steady streamed graph dispatch made "
                  f"{d['graph_launches']} graph launches and "
                  f"{d['kernel_launches']} kernel launches")
        return t

    timing = {}
    for name in ("graph", "eager", "eager_again", "graph_again"):
        timing[name] = timed(name.startswith("graph"))
        log(f"train stream timing {name} ({card}): {timing[name]}")

    # (c) train() end to end: the producer thread feeding the graphs
    end_to_end = []
    big = PRODUCER_KS[-1]
    for k, path, graph in ((TRAIN_K, "resident", True),
                           (TRAIN_K, "stream", True),
                           (TRAIN_K, "stream", False),
                           (big, "resident", True), (big, "stream", True)):
        steps = STREAM_TRAIN if k == TRAIN_K else 3 * k
        c = scfg.replace(train=dataclasses.replace(
            scfg.train, num_steps=steps, log_every=k))
        data = ds if path == "resident" else ds.iterator(
            b, seed=seed, x_dtype=np.uint8)
        with (contextlib.nullcontext() if graph
              else debug_mode(nans=False, disable_jit=True)):
            _, m, rate, _ = _timed_train(c, data, dev)
        end_to_end.append({"k": k, "path": path, "graph": graph,
                           "steps_per_s": rate,
                           "host_ms_per_step": 1e3 / rate,
                           "loss": float(m["loss"])})
        log(f"train stream end to end ({card}): {end_to_end[-1]}")
    producer = [_producer_ms(ds, b, seed, k, uploader) for k in PRODUCER_KS]
    for p in producer:
        disp = [e["host_ms_per_step"] * p["k"] for e in end_to_end
                if e["k"] == p["k"] and e["path"] == "resident"]
        p["resident_graph_dispatch_ms"] = min(disp)
        p["share_of_dispatch"] = p["stack_ms"] / min(disp)
        log(f"train stream producer ({card}): {p}")
    out.update(timing=timing, end_to_end=end_to_end, producer=producer)
    out["seconds"] = time.perf_counter() - t_block
    return launches, out


def train_phase(seed: int, dev: torch.device, card: str):
    """Full-width c2_gru_4bar in bf16, batch 64, through ``train()`` on a
    resident seeded bar cache; see the module docstring's phase 7."""
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import debug_mode

    base = get_config("c2_gru_4bar")
    tspec = dataclasses.replace(
        base.train, num_steps=TRAIN_STEPS, log_every=TRAIN_K, eval_every=10,
        eval_batches=1, seed=seed)
    cfg = base.replace(train=tspec)
    check(trainer.pick_k(cfg, True) == TRAIN_K, "pick_k")
    train_ds, eval_ds = make_bar_cache(seed).split(0.1, seed=seed)
    log(f"train: {len(train_ds)} train windows, {len(eval_ds)} eval "
        f"windows over {train_ds.bars.shape[0]} resident bars")

    def run(cfg, steps):
        logged = []
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, last = trainer.train(
            cfg, train_ds, num_steps=steps, eval_data=eval_ds,
            log_fn=lambda s, m: logged.append((s, m)), device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(int(state.step) == steps, f"state.step {int(state.step)}")
        return model, state, logged, dict(_kernels.LAUNCHES), dt

    model_a, state_a, logged_a, launches, dt_a = run(cfg, TRAIN_STEPS)
    model_b, _, logged_b, launches_b, _ = run(cfg, TRAIN_STEPS)
    steps_logged = [m for _, m in logged_a if "loss" in m]
    evals_logged = [m for _, m in logged_a if "eval_loss" in m]
    losses_a = [m["loss"] for m in steps_logged]
    log(f"train launches ({TRAIN_STEPS} steps, 2 evals): {launches}; "
        f"{dt_a:.2f} s with start-up")
    for s, m in logged_a:
        log(f"train log step {s}: {m}")
    check(len(steps_logged) == TRAIN_STEPS // TRAIN_K and len(evals_logged)
          == 2, f"logged {len(steps_logged)} steps, {len(evals_logged)} "
                f"evals")
    check(launches["masked_bce_sum_dual"] == TRAIN_STEPS,
          f"K4 launched {launches['masked_bce_sum_dual']} times in "
          f"{TRAIN_STEPS} steps")
    check(launches["masked_bce_sum"] == len(evals_logged),
          f"K2 launched {launches['masked_bce_sum']} times: expected one "
          f"per eval batch and none in training")
    check(launches["masked_bce_bwd"] == 0 and launches["kl_sum"] == 0
          and launches["first_conv_s2"] == 0, f"stray launches {launches}")
    check(all(np.isfinite(v) for m in steps_logged + evals_logged
              for v in m.values()), "a logged metric is not finite")
    check(all(m["nonfinite"] == 0.0 for m in steps_logged), "nonfinite set")
    check(losses_a[-1] < losses_a[0],
          f"the loss did not fall: {losses_a}")
    same_loss = [m for _, m in logged_a] == [m for _, m in logged_b]
    same_params = all(torch.equal(a, b) for a, b in zip(
        model_a.parameters(), model_b.parameters()))
    log(f"train repeated from the same seed: same logged bits "
        f"{same_loss}, same parameter bits {same_params}")
    check(same_loss and same_params and launches == launches_b,
          "a repeated run from the same seed differs")
    del model_b

    # graph against eager: train()'s graphed run against 20 eager single
    # steps from the same initial bits and window ids, and the same 20
    # steps as dispatches of one step each (a loss a step, replays from
    # the second on)
    data_dev = _resident(train_ds, dev)
    ids = trainer.make_id_schedule(seed, len(train_ds), 64)
    step_ids = torch.from_numpy(np.stack([ids(s) for s in range(
        TRAIN_STEPS)])).to(dev)
    model_e, state_e = trainer.create_state(cfg, device=dev)
    single = trainer.make_train_step_indexed(cfg, model_e)
    model_g, state_g = trainer.create_state(cfg, device=dev)
    multi_1 = trainer.make_train_step_indexed_multi(cfg, model_g)
    eager_losses, graph_losses = [], []
    with trainer.deterministic_algorithms():
        for s in range(TRAIN_STEPS):
            eager_losses.append(single(state_e, data_dev, step_ids[s])[1][
                "loss"])
            graph_losses.append(multi_1(state_g, data_dev,
                                        step_ids[s:s + 1])[1]["loss"])
    eager_losses = [float(v) for v in eager_losses]
    graph_losses = [float(v) for v in graph_losses]
    bits_e = _state_bits(state_e)
    graph_eager = {
        "loss_sequence_equal": graph_losses == eager_losses,
        "train_logged_losses_equal": losses_a == eager_losses[
            TRAIN_K - 1::TRAIN_K],
        "train_state_bits_equal": all(torch.equal(a, b) for a, b in zip(
            _state_bits(state_a), bits_e)),
        "train_generator_equal": _rng_equal(state_a, state_e),
        "one_step_dispatches_state_bits_equal": all(
            torch.equal(a, b) for a, b in zip(_state_bits(state_g), bits_e)),
        "one_step_dispatches_generator_equal": _rng_equal(state_g, state_e),
        "graphed": _graphs_captured(multi_1), "eager_losses": eager_losses}
    log(f"train graph vs eager, {TRAIN_STEPS} steps: {graph_eager}")
    check(all(v for k, v in graph_eager.items() if k != "eager_losses"),
          f"graph and eager training differ: {graph_eager}")
    del model_e, state_e, model_g, state_g, multi_1, state_a

    # the same 5 steps with the plain BCE under autograd
    plain_cfg = cfg.replace(train=dataclasses.replace(
        tspec, use_pallas_loss=False))
    _, _, logged_p, launches_p, _ = run(plain_cfg, TRAIN_K)
    check(launches_p["masked_bce_sum_dual"] == 0, "plain run launched K4")
    rel_plain = abs(logged_p[0][1]["loss"] - losses_a[0]) / losses_a[0]
    log(f"train step {TRAIN_K}: kernel loss {losses_a[0]}, plain-BCE loss "
        f"{logged_p[0][1]['loss']} (rel {rel_plain:.2e})")
    check(rel_plain <= LOSS_TOL_PLAIN, f"kernel and plain-BCE training "
                                       f"disagree (rel {rel_plain:.2e})")

    # the same 5 steps with the first conv through its kernels
    conv_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, use_pallas_conv1=True))
    _, _, logged_c, launches_c, _ = run(conv_cfg, TRAIN_K)
    rel_conv = abs(logged_c[0][1]["loss"] - losses_a[0]) / losses_a[0]
    log(f"train conv1 launches ({TRAIN_K} steps): {launches_c}")
    log(f"train step {TRAIN_K}: first-conv kernels loss "
        f"{logged_c[0][1]['loss']} vs stock conv {losses_a[0]} "
        f"(rel {rel_conv:.2e})")
    check(launches_c["first_conv_s2"] == 2 * TRAIN_K
          and launches_c["first_conv_s2_bwd"] == 2 * TRAIN_K,
          f"K1/K1b should each run twice a step: {launches_c}")
    check(launches_c["masked_bce_sum_dual"] == TRAIN_K, "K4 per step")
    check(rel_conv <= LOSS_TOL_CONV1, f"first-conv kernels and stock conv "
                                      f"disagree (rel {rel_conv:.2e})")

    # dispatches by hand: no hidden host wait, then timings, graph and
    # eager (debug_mode's disable_jit) in turns
    n_disp = 8
    idxs = [step_ids[:TRAIN_K]] + [
        torch.from_numpy(np.stack([ids(d * TRAIN_K + j) for j in
                                   range(TRAIN_K)])).to(dev)
        for d in range(1, n_disp)]

    def timed(cfg, deterministic, graph):
        model, state = trainer.create_state(cfg, device=dev)
        multi = trainer.make_train_step_indexed_multi(cfg, model)
        ctx = contextlib.ExitStack()
        if deterministic:
            ctx.enter_context(trainer.deterministic_algorithms())
        if not graph:
            ctx.enter_context(debug_mode(nans=False, disable_jit=True))
        with ctx:
            multi(state, data_dev, idxs[0])                  # warm-up
            multi(state, data_dev, idxs[1])
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                for d in range(2, n_disp):
                    state, m = multi(state, data_dev, idxs[d])
                enqueue = time.perf_counter() - t0
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
            steps = (n_disp - 2) * TRAIN_K
            single = trainer.make_train_step_indexed(cfg, state.model)
            step_ms = [held_ms(lambda: single(state, data_dev, idxs[0][j]),
                               spin_cycles=150_000_000, strict=False)
                       for j in range(TRAIN_K)]
            # a graph dispatch held behind the spin: the card's time for
            # its steps, the gaps between the graph's kernels included
            dispatch_ms = (held_ms(lambda: multi(state, data_dev, idxs[0]),
                                   spin_cycles=150_000_000, strict=False)
                           if graph else None)
            calls, names, kernel_ms, counted = _dispatch_trace(
                lambda: multi(state, data_dev, idxs[0]))
            kernels = sum(names.values())
        held = [v for v in step_ms if v is not None]
        out = {"steps_per_s": steps / host,
               "host_ms_per_step": host / steps * 1e3,
               "enqueue_ms_per_step": enqueue / steps * 1e3,
               "events_ms_per_step": start.elapsed_time(end) / steps,
               "device_ms_per_step": kernel_ms / TRAIN_K,
               "kernels_per_step": kernels / TRAIN_K,
               "held_device_ms_per_step": (sum(held) / len(held) if held
                                           else None),
               "held_dispatch_ms_per_step": (None if dispatch_ms is None
                                             else dispatch_ms / TRAIN_K),
               "steps_held": len(held), "loss": float(m["loss"]),
               "graphed": _graphs_captured(multi),
               "graph": _graph_info(multi),
               "dispatch": {
                   "graph_launches": _runtime_calls(calls,
                                                    "cudaGraphLaunch"),
                   "kernel_launches": _runtime_calls(calls,
                                                     "cudaLaunchKernel"),
                   "memcpy": _runtime_calls(calls, "cudaMemcpy"),
                   "k4_kernels": _kernel_calls(names, "bce_sum<"),
                   "k1_kernels": _kernel_calls(names, "conv1_kernel"),
                   "k1b_kernels": _kernel_calls(names, "conv1_bwd_kernel"),
                   "epilogue_kernels": _kernel_calls(names,
                                                     "conv_epilogue_fwd"),
                   "epilogue_bwd_kernels": _kernel_calls(
                       names, "conv_epilogue_bwd"),
                   "head_kernels": _kernel_calls(names, "head_out_fwd"),
                   "head_bwd_kernels": _kernel_calls(names, "head_out_bwd"),
                   "counted": {k: v for k, v in counted.items() if v}}}
        check(out["graphed"] == graph, f"graphed {out['graphed']}, asked "
                                       f"{graph}")
        return out

    # every option of the step that adds device work, to show that none of
    # them waits on the card or lacks a deterministic algorithm
    options_cfg = cfg.replace(train=dataclasses.replace(
        tspec, transpose_aug=5, ema_decay=0.999, grad_clip_norm=1.0,
        weight_decay=0.01, lr_schedule="cosine", lr_warmup_steps=10,
        num_steps=1000, free_bits=0.125, adam_mu_dtype="bfloat16",
        beta_schedule="cyclical", beta_cycle_steps=100,
        beta_warmup_steps=50))
    timings = {}
    for name, c, det, graph in (
            ("graph", cfg, True, True), ("eager", cfg, True, False),
            ("eager_again", cfg, True, False),
            ("graph_again", cfg, True, True),
            ("graph_default_algorithms", cfg, False, True),
            ("conv1_kernels_graph", conv_cfg, True, True),
            ("conv1_kernels_eager", conv_cfg, True, False),
            ("every_option_graph", options_cfg, True, True)):
        t = timed(c, det, graph)
        t["device_busy_share"] = (t["device_ms_per_step"]
                                  / t["host_ms_per_step"])
        timings[name] = t
        log(f"train timing {name}: {t}")
    log("train timing: steps_per_s and host_ms_per_step by host clock over "
        f"{(n_disp - 2) * TRAIN_K} steps in {n_disp - 2} dispatches, no "
        "host wait inside (sync debug mode 'error'); device_ms_per_step is "
        "the sum of torch.profiler's kernel times over one dispatch, per "
        "step; held_device_ms_per_step is one eager step's work on the "
        "card with the host out of the way (a spin holds the stream while "
        "the host enqueues the step; None where a step has more launches "
        "than the launch queue holds); held_dispatch_ms_per_step the same "
        "for a graph dispatch (the card's time with the graph's own gaps); "
        "events_ms_per_step is CUDA events around the dispatches, host "
        "gaps included; device_busy_share is device_ms_per_step over "
        "host_ms_per_step; graph: the step graph's capture_ms, "
        "instantiate_ms (host clock) and pool_bytes (memory reserved "
        "during the capture); dispatch: one steady dispatch's runtime "
        "calls and kernels by name (torch.profiler) and the launch counts "
        "the wrappers added for it")
    for name, t in timings.items():
        d = t["dispatch"]
        if t["graphed"]:
            # K replays, no kernel launched from the step body by the
            # host: what cudaLaunchKernel remains is each replay's
            # generator set-up (two fills a registered generator) and the
            # metrics' copies after the last step
            check(d["graph_launches"] == TRAIN_K
                  and d["kernel_launches"] <= 4 * TRAIN_K + 8,
                  f"{name}: a steady graph dispatch made "
                  f"{d['graph_launches']} graph launches and "
                  f"{d['kernel_launches']} kernel launches")
        else:
            check(d["graph_launches"] == 0, f"{name}: eager dispatch "
                                            f"launched a graph")
        conv1 = name.startswith("conv1")
        # every conv and transposed conv of the stem and head once a step
        # each way: 12 with the first-conv kernel (the benchmark's c2
        # cell), 14 where the first conv of each trunk takes cuDNN too;
        # the head's last layer its own kernels
        epilogue = TRAIN_K * (EPI_LAUNCHES["c2_gru_4bar"]
                              + (0 if conv1 else 2))
        check(d["counted"].get("conv_epilogue") == epilogue
              and d["counted"].get("conv_epilogue_bwd") == epilogue
              and d["epilogue_kernels"] == epilogue
              and d["epilogue_bwd_kernels"] == epilogue
              and d["counted"].get("head_out_fwd") == TRAIN_K
              and d["counted"].get("head_out_bwd") == TRAIN_K
              and d["head_kernels"] == TRAIN_K
              and d["head_bwd_kernels"] == TRAIN_K,
              f"{name}: {epilogue} conv epilogue launches and {TRAIN_K} of "
              f"the head's last layer each way expected in a dispatch of "
              f"{TRAIN_K} steps, the profiler's kernels and the counts: "
              f"{d}")
        check(d["k4_kernels"] == TRAIN_K
              and d["k1_kernels"] == (2 * TRAIN_K if conv1 else 0)
              and d["k1b_kernels"] == (2 * TRAIN_K if conv1 else 0)
              and d["counted"].get("masked_bce_sum_dual") == TRAIN_K
              and d["counted"].get("first_conv_s2", 0) == d["k1_kernels"]
              and d["counted"].get("first_conv_s2_bwd", 0)
              == d["k1b_kernels"],
              f"{name}: the profiler's kernels and the counts disagree: {d}")

    # bf16 against f32 on one step from the same weights, batch and noise
    norms = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype))
        model, state = trainer.create_state(c, device=dev)
        step = trainer.make_train_step_indexed(c, model)
        eps = torch.randn((64, c.model.z_dim), device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        _, m = step(state, data_dev, idxs[0][0], eps=eps)
        norms[dtype] = float(m["grad_norm"])
    rel_norm = abs(norms["bfloat16"] - norms["float32"]) / norms["float32"]
    log(f"train grad_norm of step 1: {norms} (rel {rel_norm:.2e})")
    check(all(np.isfinite(v) for v in norms.values())
          and rel_norm <= GRAD_NORM_TOL,
          f"bf16 and f32 grad_norm differ by {rel_norm:.2%}")

    stream_launches, stream = _stream_graph_checks(cfg, train_ds, dev, seed,
                                                   card)
    return ({"train": launches, "train_conv1": launches_c,
             "train_stream": stream_launches},
            {"logged": logged_a, "seconds_with_startup": dt_a,
             "stream": stream,
             "repeat_same_bits": same_loss and same_params,
             "graph_vs_eager": graph_eager,
             "plain_bce_rel": rel_plain, "conv1_rel": rel_conv,
             "timings": timings, "grad_norm": norms})


CKPT_STEPS = 20
CKPT_EVERY = 10


def _state_bits(state) -> list:
    """Every tensor of a TrainState in a fixed order: params, moments,
    count, step and EMA."""
    sd = state.state_dict()
    return ([sd["step"], sd["opt"]["count"]]
            + [t for k in ("params", "ema") for t in (sd[k] or {}).values()]
            + [t for k in ("mu", "nu") for t in sd["opt"][k].values()])


def _cli(argv, stdin: str = ""):
    """(rc, stdout, stderr) of the port's CLI run in this process, with
    ``stdin`` as its standard input."""
    from musicvae_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main([str(a) for a in argv])
    finally:
        sys.stdin = saved
    return rc, out.getvalue(), err.getvalue()


def ckpt_phase(seed: int, dev: torch.device, card: str):
    """Checkpoints at full width on the card: (a) 20 steps with a save
    every 10 equal, bit for bit, 10 steps restored from disk into a fresh
    state and 10 more; (b) a truncated latest step falls back to step 10
    and is quarantined; (c) the CLI trains, resumes, describes, evaluates
    (K2 launched) and serves from the checkpoint (K1 launched), with and
    without its EMA weights; (d) save and restore times, bytes on disk,
    beside ``card`` (nvidia-smi's name and power limit)."""
    import shutil
    import tempfile

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer

    base = get_config("c2_gru_4bar")
    cfg = base.replace(train=dataclasses.replace(
        base.train, num_steps=CKPT_STEPS, log_every=5,
        ckpt_every=CKPT_EVERY, eval_every=0, ema_decay=0.999, seed=seed))
    ds = make_bar_cache(seed)
    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_smoke_",
                            dir=_kernels.BUILD_ROOT.parent)
    out, runs = {}, {}
    t_phase = time.perf_counter()
    try:
        # (a) bit-exact resume from disk
        mgr = ckpt_io.make_manager(os.path.join(root, "a"))
        logged_a, logged_b = [], []
        _, state_a, last_a = trainer.train(
            cfg, ds, ckpt_manager=mgr, device=dev,
            log_fn=lambda s, m: logged_a.append((s, m)))
        mgr.wait_until_finished()
        check(mgr.all_steps() == [CKPT_EVERY, CKPT_STEPS],
              f"steps on disk {mgr.all_steps()}")
        _, state_b = trainer.create_state(cfg, device=dev, seed=seed + 1)
        state_b, cfg_b = ckpt_io.restore(mgr, state_b, step=CKPT_EVERY)
        check(int(state_b.step) == CKPT_EVERY, f"restored step "
                                               f"{int(state_b.step)}")
        check(ckpt_io.config_to_json(cfg_b) == ckpt_io.config_to_json(cfg),
              "the restored config differs")
        _, state_b, last_b = trainer.train(
            cfg_b, ds, state=state_b,
            log_fn=lambda s, m: logged_b.append((s, m)))
        bits_a, bits_b = _state_bits(state_a), _state_bits(state_b)
        same_state = len(bits_a) == len(bits_b) and all(
            torch.equal(x, y) for x, y in zip(bits_a, bits_b))
        same_metrics = all(torch.equal(last_a[k], last_b[k]) for k in last_a)
        same_logged = logged_a[-2:] == logged_b
        out["resume"] = {"tensors": len(bits_a), "same_state": same_state,
                         "same_metrics": same_metrics,
                         "same_logged": same_logged,
                         "logged": logged_b}
        log(f"ckpt (a): {CKPT_STEPS} steps against {CKPT_EVERY} restored "
            f"from disk + {CKPT_STEPS - CKPT_EVERY}: same state "
            f"{same_state} ({len(bits_a)} tensors: params, Adam moments, "
            f"count, step, EMA), same metrics {same_metrics}, same logged "
            f"{same_logged}")
        check(same_state and same_metrics and same_logged,
              "a run resumed from disk differs from the uninterrupted run")

        # (d) save (host copy, then the write) and restore times
        saves = []
        for i in range(3):
            m = ckpt_io.make_manager(os.path.join(root, f"t{i}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(ckpt_io.save(m, state_a, cfg), "save refused")
            t1 = time.perf_counter()
            m.wait_until_finished()
            t2 = time.perf_counter()
            step_dir = m.step_dir(CKPT_STEPS)
            nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
            _, fresh = trainer.create_state(cfg, device=dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ckpt_io.restore(m, fresh)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            check(all(torch.equal(x, y) for x, y in zip(
                _state_bits(fresh), bits_a)), "restored state differs")
            saves.append({"host_copy_ms": (t1 - t0) * 1e3,
                          "write_ms": (t2 - t1) * 1e3,
                          "restore_ms": (t4 - t3) * 1e3, "bytes": nbytes})
        n_params = sum(p.numel() for p in state_a.params)
        out["timings"] = {"saves": saves, "params": n_params, "card": card}
        log(f"ckpt (d): {card}: {n_params} params; save, restore and bytes "
            f"on disk, three times: {saves} (host clock; host_copy_ms is "
            f"save() returning after the copy to the host, write_ms the "
            f"background write joined after it)")

        # (b) a truncated latest step
        latest = os.path.join(mgr.step_dir(CKPT_STEPS), ckpt_io.STATE_FILE)
        with open(latest, "r+b") as f:
            f.truncate(os.path.getsize(latest) // 2)
        mgr = ckpt_io.make_manager(mgr.directory)
        _, state_c = trainer.create_state(cfg, device=dev)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            state_c, _ = ckpt_io.restore(mgr, state_c)
        quarantined = sorted(n for n in os.listdir(mgr.directory)
                             if "corrupt" in n)
        out["corrupt_latest"] = {"restored_step": int(state_c.step),
                                 "steps": mgr.all_steps(),
                                 "quarantined": quarantined,
                                 "warnings": err.getvalue().splitlines()}
        log(f"ckpt (b): truncated step {CKPT_STEPS}: {out['corrupt_latest']}")
        check(int(state_c.step) == CKPT_EVERY
              and mgr.all_steps() == [CKPT_EVERY]
              and quarantined == [f"{CKPT_STEPS}.corrupt"],
              f"corrupt latest not handled: {out['corrupt_latest']}")

        # (c) the CLI on the card
        cache = os.path.join(root, "cache.npz")
        ds.save_npy(cache)
        d = os.path.join(root, "cli")
        common = ["--data", cache, "--ckpt-dir", d, "--log-dir",
                  os.path.join(root, "logs"), "--ema-decay", "0.999"]
        rc, o, e = _cli(["train", *common, "--steps", CKPT_EVERY])
        check(rc == 0, f"CLI train: rc {rc}: {e[-2000:]}")
        rc, o, e = _cli(["train", *common, "--steps", CKPT_STEPS,
                         "--resume"])
        check(rc == 0 and f"resumed from step {CKPT_EVERY}" in e,
              f"CLI train --resume: rc {rc}: {e[-2000:]}")
        rc, o, e = _cli(["describe", "--ckpt-dir", d])
        check(rc == 0, f"CLI describe: rc {rc}: {e[-2000:]}")
        described = json.loads(o)
        check(described["steps"] == [CKPT_EVERY, CKPT_STEPS]
              and described["ema"], f"describe: {described}")
        _kernels.reset_launches()
        rc, o, e = _cli(["eval", "--ckpt-dir", d, "--data", cache,
                         "--batches", 2])
        runs["ckpt_eval"] = dict(_kernels.LAUNCHES)
        check(rc == 0, f"CLI eval: rc {rc}: {e[-2000:]}")
        scores = dict(kv.split("=") for kv in o.split())
        check(runs["ckpt_eval"]["masked_bce_sum"] == 2
              and all(np.isfinite(float(v)) for v in scores.values()),
              f"CLI eval: {scores}, launches {runs['ckpt_eval']}")
        served = {}
        for ema in (False, True):
            _kernels.reset_launches()
            rc, o, e = _cli(["serve", "--ckpt-dir", d, "--use-pallas-conv1"]
                            + (["--ema"] if ema else []),
                            stdin='{"id": 1, "seed": 3}\n')
            launches = dict(_kernels.LAUNCHES)
            resp = json.loads(o.splitlines()[0]) if o else {}
            check(rc == 0 and len(resp.get("midi_b64", [])) == 4,
                  f"CLI serve (ema {ema}): rc {rc}, {o[:300]}: "
                  f"{e[-2000:]}")
            # the two warm-up sweeps (eager, then the captured graph's
            # replay) and the request's replay, 16 bars each
            check(launches["first_conv_s2"] == 48,
                  f"CLI serve (ema {ema}): K1 launches {launches}")
            ready = [ln for ln in e.splitlines() if ln.startswith("serving")]
            check(len(ready) == 1 and ("EMA weights" in ready[0]) == ema,
                  f"CLI serve (ema {ema}): {e[-2000:]}")
            served["ema" if ema else "params"] = {
                "density": resp["density"], "launches": launches,
                "log": ready[0]}
        runs["ckpt_serve"] = served["params"]["launches"]
        out["cli"] = {"describe": described, "eval": scores,
                      "serve": served}
        log(f"ckpt (c): CLI describe {described}")
        log(f"ckpt (c): CLI eval {scores}, launches {runs['ckpt_eval']}")
        log(f"ckpt (c): CLI serve {served}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"ckpt phase: {out['seconds']:.1f} s")
    return runs, out


CORPUS_PIECES = 64
CORPUS_BARS = 32
CORPUS_STEPS = 10
CORPUS_EVAL_EVERY = 5
GEN_BARS = 16
GEN_SAMPLES = 4
U_MARGIN = 1e-3    # |u − σ(l/T)| within which a Bernoulli cell may flip
#                    between the card and the CPU: the f32 logits agree
#                    to 1e-3 (reference phase), σ' ≤ 1/4


def _timing(err: str) -> dict:
    """The ``timing:`` line that ``generate`` prints on stderr."""
    line = [ln for ln in err.splitlines() if ln.startswith("timing: ")]
    check(len(line) == 1, f"generate printed no timing line: {err[-2000:]}")
    return {k: float(v) for k, v in
            (kv.split("=") for kv in line[0].split()[1:])}


def _timed_cli(argv):
    """``_cli`` with the host time of the whole command, in ms, and the
    kernel launches it made."""
    from musicvae_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    t0 = time.perf_counter()
    rc, o, e = _cli(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"CLI {argv[0]}: rc {rc}: {e[-2000:]}")
    return o, e, ms, dict(_kernels.LAUNCHES)


def _bernoulli_card_vs_cpu(ck: str, dev: torch.device, seed: int,
                           seed_bar: np.ndarray) -> dict:
    """The trained checkpoint's weights in f32 on the card and on the
    CPU: a Bernoulli sweep of ``make_generate_fn`` on the card from a seed
    bar with both latent endpoints pinned and the uniforms handed in,
    against ``generate`` on the CPU with the same draws. Bar by bar while
    the bars agree, cells may differ only where the uniform lies within
    U_MARGIN of the CPU's probability."""
    from musicvae_tpu_torch.cli import restore_checkpoint
    from musicvae_tpu_torch.config import GenSpec
    from musicvae_tpu_torch.generate import sampler
    from musicvae_tpu_torch.models.vae import build_model

    cfg, state = restore_checkpoint(ck, dev)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32"),
        gen=GenSpec(num_bars=GEN_BARS, num_samples=GEN_SAMPLES,
                    interpolate=True, sample_mode="bernoulli",
                    sample_temperature=0.9))
    weights = state.model.state_dict()
    on_card, cpu = (build_model(cfg, device=d) for d in (dev, "cpu"))
    for m in (on_card, cpu):
        m.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(seed)
    b, z = GEN_SAMPLES, cfg.model.z_dim
    noise = torch.randn((2, b, z), generator=g)
    z0, z1 = torch.randn((2, b, z), generator=g)
    u = torch.rand((b, GEN_BARS, 96, 128), generator=g)
    sb = torch.from_numpy(seed_bar)[None].repeat(b, 1, 1)
    got = sampler.make_generate_fn(cfg, on_card)(
        None, seed_bar=sb.to(dev), z0=z0.to(dev), z1=z1.to(dev),
        noise=noise.to(dev), uniforms=u.to(dev)).cpu()
    z_bars, reset = sampler.latent_path(cfg, b, GEN_BARS, True,
                                        noise=noise, z0=z0, z1=z1)
    with torch.inference_mode():
        logits, want = cpu.generate(z_bars, reset, sb, uniforms=u,
                                    sample_temperature=0.9)
    p = torch.sigmoid(logits / 0.9)
    compared = flips = near = 0
    for k in range(GEN_BARS):
        diff = got[:, k] != want[:, k]
        may = (u[:, k] - p[:, k]).abs() < U_MARGIN
        check(not (diff & ~may).any(),
              f"Bernoulli card vs CPU: bar {k} differs outside the margin")
        compared += 1
        near += int(may.sum())
        flips += int(diff.sum())
        if flips:
            break
    out = {"bars_compared": compared, "flips": flips,
           "cells_within_margin": near, "margin": U_MARGIN,
           "density": float(want.float().mean())}
    log(f"corpus (c): Bernoulli sweep, f32, card vs CPU, same draws: {out}")
    return out


def corpus_phase(seed: int, dev: torch.device, card: str):
    """MIDI in → train → MIDI out at full width on the card, through the
    CLI (see the module docstring's phase 9)."""
    import shutil
    import tempfile

    from musicvae_tpu_torch import native
    from musicvae_tpu_torch.config import MidiSpec
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.data.synthetic import synth_corpus
    from musicvae_tpu_torch.midi import tensorize
    from musicvae_tpu_torch.ops import _kernels

    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="corpus_smoke_",
                            dir=_kernels.BUILD_ROOT.parent)
    out, runs = {"card": card}, {}
    t_phase = time.perf_counter()
    try:
        # (a) ingest: the native parser and the pure-Python codec agree
        pieces = synth_corpus(CORPUS_PIECES, CORPUS_BARS, seed=seed)
        midi_dir = os.path.join(root, "midi")
        os.makedirs(midi_dir)
        sidecar = {}
        for i, (data, chord, key) in enumerate(pieces):
            with open(os.path.join(midi_dir, f"p{i:02d}.mid"), "wb") as f:
                f.write(data)
            if i % 2 == 0:
                sidecar[f"p{i:02d}.mid"] = {"chord": chord, "key": key}
        labels = os.path.join(root, "labels.json")
        with open(labels, "w") as f:
            json.dump(sidecar, f)
        midi_glob = os.path.join(midi_dir, "p*.mid")
        check(native.available(), "the native SMF library did not build "
                                  "(g++) or load")
        datas = [p[0] for p in pieces]
        spec = MidiSpec()
        paths = {}
        for name, use_native in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            bars = tensorize.corpus_to_bars(datas, spec, as_uint8=True,
                                            use_native=use_native)
            ms = (time.perf_counter() - t0) * 1e3
            n_bars = sum(b.shape[0] for b in bars)
            paths[name] = (bars, {"ms": ms, "bars": n_bars,
                                  "bars_per_s": n_bars / ms * 1e3})
        same = all(np.array_equal(a, b) for a, b in
                   zip(paths["native"][0], paths["python"][0]))
        out["tensorize"] = {k: v[1] for k, v in paths.items()}
        out["tensorize"]["same_bars"] = same
        out["tensorize"]["native_library"] = str(native.build())
        log(f"corpus (a): {CORPUS_PIECES} pieces x {CORPUS_BARS} bars, "
            f"host tensorize: {out['tensorize']}")
        check(same and paths["native"][1]["bars"]
              == CORPUS_PIECES * CORPUS_BARS,
              "the native and pure-Python tensorizers disagree")
        cache = os.path.join(root, "cache.npz")
        o, e, ms, _ = _timed_cli(["preprocess", "--midi-glob", midi_glob,
                                  "--labels", labels, "--out", cache])
        ds = PianoRollDataset.load_npy(cache)
        windows = CORPUS_PIECES * (CORPUS_BARS - 3)
        out["preprocess"] = {"ms": ms, "windows": len(ds)}
        log(f"corpus (a): CLI preprocess {ms:.1f} ms (host clock): {o.strip()}")
        check(len(ds) == windows and ds.grid == (24, 4),
              f"preprocess wrote {len(ds)} windows, grid {ds.grid}")
        check(np.array_equal(ds.bars, np.concatenate(paths["native"][0])),
              "the cache's bars differ from the tensorizer's")

        # (b) train from the MIDI files with the first-conv kernels
        ck = os.path.join(root, "ck")
        logs = os.path.join(root, "logs")
        o, e, ms, launches = _timed_cli([
            "train", "--midi-glob", midi_glob, "--labels", labels,
            "--steps", CORPUS_STEPS, "--eval-every", CORPUS_EVAL_EVERY,
            "--log-every", CORPUS_EVAL_EVERY, "--batch-size", 64,
            "--use-pallas-conv1", "--ckpt-dir", ck, "--log-dir", logs])
        runs["corpus_train"] = launches
        n_eval = int(re.search(r"holdout: (\d+) eval windows", e).group(1))
        evals = CORPUS_STEPS // CORPUS_EVAL_EVERY
        eval_batches = evals * min(4, max(1, n_eval // 64))
        logged = [json.loads(ln) for ln in
                  open(os.path.join(logs, "metrics.jsonl"))]
        losses = [ln["loss"] for ln in logged if "loss" in ln]
        out["train"] = {"ms": ms, "launches": launches, "losses": losses,
                        "eval_windows": n_eval,
                        "eval_loss": [ln["eval_loss"] for ln in logged
                                      if "eval_loss" in ln]}
        log(f"corpus (b): CLI train --midi-glob, {CORPUS_STEPS} steps at "
            f"batch 64, eval every {CORPUS_EVAL_EVERY}: {out['train']}")
        check(launches["masked_bce_sum_dual"] == CORPUS_STEPS
              and launches["first_conv_s2_bwd"] == 2 * CORPUS_STEPS
              and launches["masked_bce_sum"] == eval_batches
              and launches["first_conv_s2"] == 2 * (CORPUS_STEPS
                                                    + eval_batches),
              f"train launches {launches} (K4 once a step, K1b twice, K2 "
              f"once an eval batch, {eval_batches} eval batches)")
        check(len(losses) == CORPUS_STEPS // CORPUS_EVAL_EVERY
              and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"the loss did not fall: {losses}")

        # (c) generate: continue A, morph to B
        a, b = (os.path.join(midi_dir, f"p{i:02d}.mid") for i in (0, 1))
        gen_out = {}
        rolls = {}
        for run, mode in (("bernoulli_1", "bernoulli"),
                          ("threshold_1", "threshold"),
                          ("threshold_2", "threshold"),
                          ("bernoulli_2", "bernoulli")):
            gdir = os.path.join(root, run)
            o, e, ms, launches = _timed_cli([
                "generate", "--ckpt-dir", ck, "--seed-midi", a, "--encode",
                "--interpolate", "--interp-midi-b", b, "--samples",
                GEN_SAMPLES, "--bars", GEN_BARS, "--sample-mode", mode,
                "--seed", seed, "--out-dir", gdir])
            runs[f"corpus_generate_{run}"] = launches
            r = np.load(os.path.join(gdir, "rolls.npy"))
            rolls[run] = r
            check(r.shape == (GEN_SAMPLES, GEN_BARS, 96, 128)
                  and r.dtype == np.uint8, f"rolls {r.shape} {r.dtype}")
            # two encodes (A, B) and one prev-bar feature a bar
            check(launches["first_conv_s2"] == 2 + GEN_BARS,
                  f"generate ({run}): K1 launches {launches}")
            for i in range(GEN_SAMPLES):
                with open(os.path.join(gdir, f"sample_{i:04d}.mid"),
                          "rb") as f:
                    back = tensorize.corpus_to_bars(
                        [f.read()], spec, max_events=1 << 22,
                        as_uint8=True)[0]
                n = back.shape[0]
                check(n <= GEN_BARS and np.array_equal(back, r[i, :n])
                      and not r[i, n:].any(),
                      f"generate ({run}): sample {i}'s MIDI does not "
                      f"tensorize back to rolls.npy")
            gen_out[run] = {"ms": ms, **_timing(e),
                            "density": float(r.mean()),
                            "launches": launches}
        same = {mode: np.array_equal(rolls[f"{mode}_1"], rolls[f"{mode}_2"])
                for mode in ("threshold", "bernoulli")}
        gen_out["repeat_same_bits"] = same
        # the export of 4 x 16 bars of the corpus itself: the density a
        # trained model's samples approach
        real = np.concatenate(paths["native"][0][:GEN_SAMPLES]).reshape(
            GEN_SAMPLES, -1, 96, 128)[:, :GEN_BARS]
        t0 = time.perf_counter()
        for i in range(GEN_SAMPLES):
            tensorize.bars_to_midi_bytes(real[i], spec)
        gen_out["export_ms_at_corpus_density"] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "density": float(real.mean())}
        log(f"corpus (c): CLI generate --seed-midi --encode --interpolate "
            f"--interp-midi-b, {GEN_SAMPLES} x {GEN_BARS} bars: {gen_out}")
        check(all(same.values()), f"two runs with one seed differ: {same}")
        with open(a, "rb") as f:
            seed_bar = tensorize.corpus_to_bars([f.read()], spec,
                                                as_uint8=True)[0][-1]
        gen_out["card_vs_cpu"] = _bernoulli_card_vs_cpu(ck, dev, seed,
                                                        seed_bar)
        out["generate"] = gen_out

        # (d) reconstruct two files
        o, e, ms, launches = _timed_cli([
            "reconstruct", "--ckpt-dir", ck, "--midi-glob",
            os.path.join(midi_dir, "p0[01].mid"), "--out-dir",
            os.path.join(root, "recon")])
        runs["corpus_reconstruct"] = launches
        windows = 2 * CORPUS_BARS // 4
        f1 = [float(ln.split("f1=")[1]) for ln in o.splitlines()]
        out["reconstruct"] = {"ms": ms, "ms_per_window": ms / windows,
                              "windows": windows, "f1": f1,
                              "lines": o.splitlines(), "launches": launches}
        log(f"corpus (d): CLI reconstruct: {out['reconstruct']}")
        check(len(f1) == 2 and launches["first_conv_s2"] == 2 * windows,
              f"reconstruct: {o} {launches}")

        # (e) score the generations and the corpus
        o, e, ms, launches = _timed_cli([
            "eval-gen", "--ckpt-dir", ck, "--midi-glob", midi_glob,
            "--samples", 64, "--bars", GEN_BARS])
        runs["corpus_eval_gen"] = launches
        res = json.loads(o)
        out["eval_gen"] = {"ms": ms, "compare": res["compare"],
                           "launches": launches}
        log(f"corpus (e): CLI eval-gen {ms:.1f} ms: {out['eval_gen']}")
        check(sorted(res) == ["bars_per_sample", "compare", "gen", "ref",
                              "samples"]
              and launches["first_conv_s2"] == GEN_BARS,
              f"eval-gen: {sorted(res)}, {launches}")
        o, e, ms, launches = _timed_cli([
            "eval", "--ckpt-dir", ck, "--midi-glob", midi_glob,
            "--batches", 2])
        runs["corpus_eval"] = launches
        scores = dict(kv.split("=") for kv in o.split())
        out["eval"] = {"ms": ms, "scores": scores, "launches": launches}
        log(f"corpus (e): CLI eval --midi-glob: {out['eval']}")
        check(launches["masked_bce_sum"] == 2
              and sorted(scores) == ["f1", "kl", "loss", "precision",
                                     "recall", "recon"]
              and all(np.isfinite(float(v)) for v in scores.values()),
              f"eval --midi-glob: {scores}, {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"corpus phase: {out['seconds']:.1f} s")
    return runs, out


STACK_W = 4            # --coalesce width
STACK_SEEDS = 8        # seeds held serial against coalesced, plain and seeded
STACK_CLIENTS = 4      # concurrent TCP clients
STACK_PER_CLIENT = 4   # requests a client, in each timed mode
FLIP_MARGIN = 1e-3     # |σ(l) − threshold| within which a cell may flip
#                        between a sweep at batch B and one at W·B


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port: int, deadline_s: float = 300.0):
    """A ServeClient on ``port``, retried until the server listens."""
    from musicvae_tpu_torch.client import ServeClient

    t_end = time.monotonic() + deadline_s
    while True:
        try:
            return ServeClient(port=port, timeout=deadline_s)
        except OSError:
            check(time.monotonic() < t_end, f"no server on port {port}")
            time.sleep(0.2)


def _serial_reference(cfg, model, dev, seed: int, seed_bar):
    """(bars, σ) of the serial sweep for ``seed``: the draws a lone
    request makes, through the model's own ``generate``."""
    from musicvae_tpu_torch.generate import sampler

    g, b = cfg.gen, cfg.gen.num_samples
    gen = sampler.seed_generator(seed, dev)
    sb = None
    if seed_bar is not None:
        sb = torch.from_numpy(seed_bar).to(dev)[None].repeat(b, 1, 1)
    with torch.inference_mode():
        z, reset = sampler.latent_path(cfg, b, g.num_bars, g.interpolate,
                                       g.temperature, generator=gen)
        logits, bars = model.generate(z, reset, sb)
    return bars.cpu().numpy(), torch.sigmoid(logits.float()).cpu().numpy()


def _flip_rule(got, want, sig, threshold: float) -> dict:
    """Bar by bar while the bars so far agree: a cell may differ only where
    σ lies within FLIP_MARGIN of the threshold; after a flip the feedback
    differs and the comparison stops."""
    flips = compared = 0
    worst = None
    for k in range(want.shape[1]):
        diff = got[:, k] != want[:, k]
        compared += 1
        if diff.any():
            m = float(np.abs(sig[:, k][diff] - threshold).max())
            check(m <= FLIP_MARGIN, f"bar {k}: a cell {m:.2e} from the "
                                    f"threshold flipped")
            flips, worst = int(diff.sum()), m
            break
    dist = np.abs(sig[:, :compared] - threshold)
    # cells whose logit is exactly the threshold's (a zero logit where no
    # input reaches a transposed-conv output) never flip: counted apart
    return {"bars_compared": compared, "flips": flips,
            "flip_margin_max": worst,
            "nearest_margin": float(dist[dist > 0].min()),
            "cells_at_threshold": int((dist == 0).sum())}


def _agree(results, refs, threshold) -> dict:
    """The flip rule over several responses: totals and extremes."""
    rules = [_flip_rule(got, *refs[i], threshold)
             for i, got in enumerate(results)]
    return {"responses": len(rules),
            "flips": sum(r["flips"] for r in rules),
            "responses_with_flips": sum(r["flips"] > 0 for r in rules),
            "bars_compared": sum(r["bars_compared"] for r in rules),
            "nearest_margin": min(r["nearest_margin"] for r in rules),
            "cells_at_threshold": sum(r["cells_at_threshold"]
                                      for r in rules),
            "flip_margin_max": max((r["flip_margin_max"] or 0.0)
                                   for r in rules)}


def _midi_bars(resp, cfg) -> np.ndarray:
    """The bars of a response's MIDI files, [B, N, T, P] uint8."""
    from musicvae_tpu_torch.midi import tensorize

    out = []
    for m in resp:
        raw = m if isinstance(m, bytes) else base64.b64decode(m)
        b = tensorize.corpus_to_bars([raw], cfg.midi, max_events=1 << 22,
                                     as_uint8=True)[0]
        pad = cfg.gen.num_bars - b.shape[0]
        out.append(np.concatenate([b, np.zeros((pad,) + b.shape[1:],
                                               np.uint8)]) if pad else b)
    return np.stack(out)


def _load_stats(lat, n, seconds, density) -> dict:
    lat = sorted(lat)
    return {"requests": n, "req_per_s": n / seconds, "seconds": seconds,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "density": density}


def _tcp_load(service, runner, seeds) -> dict:
    """STACK_CLIENTS clients at once against serve_socket over
    ``service``, STACK_PER_CLIENT requests each: req/s by host clock from
    the first request to the last response, and the responses'
    latency_ms."""
    import threading

    from musicvae_tpu_torch import cli

    n = STACK_CLIENTS * STACK_PER_CLIENT
    ready, res = threading.Event(), {}
    t = threading.Thread(target=lambda: res.update(rc=cli.serve_socket(
        service, "127.0.0.1", 0, n, runner, "serve_stack",
        on_listen=lambda h, p: (res.update(port=p), ready.set()))),
        daemon=True)
    t.start()
    check(ready.wait(120), "the TCP server did not start")
    lat, dens, errors = [], [], []
    barrier = threading.Barrier(STACK_CLIENTS, timeout=120)

    def client(i):
        try:
            with _connect(res["port"]) as c:
                barrier.wait()
                for s in seeds[i::STACK_CLIENTS]:
                    r = c.request({"seed": s})
                    lat.append(r["latency_ms"])
                    dens.append(r["density"])
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(STACK_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    dt = time.perf_counter() - t0
    t.join(120)
    check(not errors and not t.is_alive() and res.get("rc") == 0,
          f"TCP load: {errors}, rc {res.get('rc')}")
    return _load_stats(lat, n, dt, float(np.mean(dens)))


def _stdin_load(fn, seeds) -> dict:
    """One stdin transport over a backlog of requests: req/s by host clock
    around the whole call, and the responses' latency_ms."""
    lines = "".join(json.dumps({"id": i, "seed": s}) + "\n"
                    for i, s in enumerate(seeds))
    out = io.StringIO()
    t0 = time.perf_counter()
    fn(io.StringIO(lines), out)
    dt = time.perf_counter() - t0
    resp = [json.loads(ln) for ln in out.getvalue().splitlines()]
    check(len(resp) == len(seeds) and all("midi_b64" in r for r in resp),
          f"stdin load: {resp[:2]}")
    check([r["id"] for r in resp] == list(range(len(seeds))),
          "stdin responses out of order")
    return _load_stats([r["latency_ms"] for r in resp], len(seeds), dt,
                       float(np.mean([r["density"] for r in resp])))


def serve_stack_phase(seed: int, dev: torch.device, card: str):
    """The production serve stack at full width (c2_gru_4bar, bf16, 4
    samples x 16 bars) on a checkpoint whose config turns the first-conv
    kernel on: (a) serial and --coalesce 4 answer 8 seeds, plain and
    seeded, in agreement under the flip rule, K1 at M=4 alone and M=16
    coalesced; (b) ``serve --port --coalesce 4 --reload-every 0.5
    --max-requests`` with 4 concurrent clients, a newer step saved and
    pushed mid-run; (c) req/s and latency under load for each transport;
    (d) convert to safetensors and back serves the same bits."""
    import shutil
    import tempfile
    import threading

    from musicvae_tpu_torch import cli
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.config import GenSpec, get_config
    from musicvae_tpu_torch.data.synthetic import synth_corpus
    from musicvae_tpu_torch.midi import tensorize
    from musicvae_tpu_torch.models import layers
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train.trainer import create_state

    base = get_config("c2_gru_4bar")
    gen = GenSpec(num_bars=GEN_BARS, num_samples=GEN_SAMPLES)
    cfg = base.replace(
        model=dataclasses.replace(base.model, use_pallas_conv1=True),
        train=dataclasses.replace(base.train, seed=seed), gen=gen)
    thr = cfg.midi.binarize_threshold
    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="serve_stack_",
                            dir=_kernels.BUILD_ROOT.parent)
    ck = os.path.join(root, "ck")
    out, runs = {"card": card}, {}
    t_phase = time.perf_counter()
    # every K1 call's M, by a wrapper around the model's reference to the
    # kernel's entry point (the launch count stays the wrapper's own)
    k1_m = []
    real_k1 = layers.first_conv_s2

    def k1_recorded(x, *a, **kw):
        k1_m.append(int(x.shape[0]))
        return real_k1(x, *a, **kw)

    layers.first_conv_s2 = k1_recorded
    try:
        def save(step, init_seed):
            _, state = create_state(cfg, device=dev, seed=init_seed)
            state.step.fill_(step)
            check(ckpt_io.save(ckpt_io.make_manager(ck), state, cfg,
                               wait=True), f"step {step} not saved")

        def service_at():
            c, state = cli.restore_checkpoint(ck, dev, lambda x: x.replace(
                gen=gen))
            return cli.Service(c, state.model, int(state.step))

        save(1, seed)
        svc = service_at()
        midi = synth_corpus(1, 8, seed=seed)[0][0]
        seed_bar = tensorize.corpus_to_bars([midi], cfg.midi,
                                            as_uint8=True)[0][-1]
        seeds = [seed * 1000 + 100 + i for i in range(STACK_SEEDS)]

        # (a) serial against coalesced, per seed, plain and seeded. The
        # runner's warm-up runs each tier's sweep eagerly, then captures
        # it: the K1 calls its body makes, at each tier's M; every sweep
        # after is a replay, which launches K1 without a call
        runner = cli._CoalescedRunner(svc, STACK_W)
        del k1_m[:]
        runner.warm()
        warm_m = list(k1_m)
        check(warm_m == [GEN_SAMPLES] * (2 * GEN_BARS)
              + [STACK_W * GEN_SAMPLES] * (2 * GEN_BARS),
              f"warm-up: K1 Ms {sorted(set(warm_m))} x{len(warm_m)}")
        svc.warm(seeded=True)
        torch.cuda.synchronize()
        agree = {}
        for name, sb in (("plain", None), ("seeded", seed_bar)):
            refs = [_serial_reference(cfg, svc.model, dev, s, sb)
                    for s in seeds]
            serial = [cli.to_host(svc.dispatch(
                cli.seed_generator(s, dev), sb)) for s in seeds]
            check(all(np.array_equal(a, r[0]) for a, r in zip(serial, refs)),
                  f"{name}: the serial service differs from its sweep")
            _kernels.reset_launches()
            del k1_m[:]
            coal = []
            for i in range(0, STACK_SEEDS, STACK_W):
                coal += runner.run([(cli.seed_generator(s, dev), sb)
                                    for s in seeds[i:i + STACK_W]])
            torch.cuda.synchronize()
            check(not k1_m and _kernels.LAUNCHES["first_conv_s2"]
                  == GEN_BARS * STACK_SEEDS // STACK_W,
                  f"{name}: coalesced sweeps made K1 calls at Ms "
                  f"{sorted(set(k1_m))} x{len(k1_m)} (replays make none), "
                  f"launches {_kernels.LAUNCHES}")
            agree[name] = _agree(coal, refs, thr)
            log(f"serve_stack (a) {name}: serial vs --coalesce "
                f"{STACK_W}, {STACK_SEEDS} seeds: {agree[name]}")
        _kernels.reset_launches()
        del k1_m[:]
        lone = runner.run([(cli.seed_generator(seeds[0], dev), None)])
        full = runner.run([(cli.seed_generator(seeds[0], dev), None),
                           (cli.seed_generator(seeds[1], dev), None)])
        tiers = {"k1_m_captured": sorted(set(warm_m)),
                 "k1_calls": len(k1_m),
                 "launches": _kernels.LAUNCHES["first_conv_s2"],
                 "lone_equals_full": bool(np.array_equal(lone[0], full[0]))}
        log(f"serve_stack (a) tiers: lone then padded full: {tiers}")
        check(not k1_m and tiers["launches"] == 2 * GEN_BARS,
              f"tiers: K1 calls at Ms {k1_m}, launches "
              f"{tiers['launches']}")
        # the tiers compute at different batches: held by the flip rule
        tiers["lone_vs_full"] = _agree(full[:1], [(lone[0], _serial_reference(
            cfg, svc.model, dev, seeds[0], None)[1])], thr)
        out["coalesce"] = {"agree": agree, "tiers": tiers}

        # (b) the CLI's TCP server, 4 clients, a push reload mid-run
        port = _free_port()
        n_req = STACK_CLIENTS * 4
        argv = ["serve", "--ckpt-dir", ck, "--port", port, "--coalesce",
                STACK_W, "--reload-every", 0.5, "--max-requests", n_req,
                "--bars", GEN_BARS, "--samples", GEN_SAMPLES]
        _kernels.reset_launches()
        del k1_m[:]
        srv = {}
        th = threading.Thread(target=lambda: srv.update(
            rc=cli.main([str(a) for a in argv])), daemon=True)
        th.start()
        phase2 = threading.Barrier(STACK_CLIENTS + 1, timeout=300)
        got, errors, pushes = {}, [], {}

        def client(i):
            try:
                with _connect(port) as c:
                    got[i] = [(s, c.generate(seed=s))
                              for s in seeds[2 * i:2 * i + 2]]
                    phase2.wait()       # the main thread saves step 2
                    phase2.wait()
                    if i == 0:      # the push, timed by the client
                        t_push = time.perf_counter()
                        pushes["reloaded"] = c.reload()
                        pushes["ms"] = (time.perf_counter() - t_push) * 1e3
                        pushes["stats"] = c.stats()
                    phase2.wait()
                    got[i] += [(s + 1000, c.generate(seed=s + 1000))
                               for s in seeds[2 * i:2 * i + 2]]
            except Exception as e:
                errors.append(repr(e))
                phase2.abort()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(STACK_CLIENTS)]
        for t in threads:
            t.start()
        phase2.wait()
        t0 = time.perf_counter()
        save(2, seed + 1)
        save_ms = (time.perf_counter() - t0) * 1e3
        phase2.wait()
        phase2.wait()
        for t in threads:
            t.join(300)
        th.join(120)
        check(not errors and srv.get("rc") == 0 and not th.is_alive(),
              f"TCP serve: rc {srv.get('rc')}, errors {errors}")
        runs["serve_stack"] = dict(_kernels.LAUNCHES)
        tcp_m = list(k1_m)      # the server's K1 calls, warm-up included
        step2 = service_at()
        check(pushes["stats"]["step"] == 2 and step2.step == 2
              and pushes["reloaded"] in (2, None),
              f"reload did not move step: {pushes}")
        old_refs, new_refs, old_got, new_got = [], [], [], []
        for i in range(STACK_CLIENTS):
            for j, (s, midis) in enumerate(got[i]):
                bars = _midi_bars(midis, cfg)
                model = svc.model if j < 2 else step2.model
                ref = _serial_reference(cfg, model, dev, s, None)
                (old_got if j < 2 else new_got).append(bars)
                (old_refs if j < 2 else new_refs).append(ref)
        ms_set = sorted(set(tcp_m))
        k1_launches = runs["serve_stack"]["first_conv_s2"]
        tcp = {"launches": runs["serve_stack"], "k1_m": ms_set,
               "k1_calls": len(tcp_m),
               "sweeps_run_by_the_body": len(tcp_m) // GEN_BARS,
               "sweeps_launched": k1_launches // GEN_BARS,
               "push": pushes, "save_step2_ms": save_ms,
               "before_reload": _agree(old_got, old_refs, thr),
               "after_reload": _agree(new_got, new_refs, thr)}
        log(f"serve_stack (b) TCP --coalesce {STACK_W}, {STACK_CLIENTS} "
            f"clients, push reload: {tcp}")
        # the body's K1 calls (the tiers' eager runs and captures, before
        # and after the reload) come a sweep at a time, at the two tiers'
        # Ms; every sweep launches K1 once a bar, the replays included
        check(k1_launches % GEN_BARS == 0
              and k1_launches // GEN_BARS >= -(-n_req // STACK_W)
              and len(tcp_m) % GEN_BARS == 0
              and all(len(set(tcp_m[i:i + GEN_BARS])) == 1
                      for i in range(0, len(tcp_m), GEN_BARS))
              and set(ms_set) == {GEN_SAMPLES, STACK_W * GEN_SAMPLES},
              f"TCP: K1 calls {len(tcp_m)} at Ms {ms_set}, launches "
              f"{k1_launches}")
        out["tcp"] = tcp

        # (b') a reload pushed to a serial service (the stdin "reload"
        # command): the new weights serve from graphs of their own,
        # captured at their first requests, equal to eager sweeps
        svc_r = cli.Service(cfg, svc.model, 1)
        svc_r.reload_once = cli._make_reload_once(ckpt_io.make_manager(ck),
                                                  svc_r)
        svc_r.warm()
        before_gen = svc_r.generate
        r_seeds = [seed * 1000 + 300 + i for i in range(5)]
        lines = [json.dumps({"id": i, "seed": s})
                 for i, s in enumerate(r_seeds[:2])]
        lines.append(json.dumps({"id": "r", "cmd": "reload"}))
        lines += [json.dumps({"id": 2 + i, "seed": s})
                  for i, s in enumerate(r_seeds[2:])]
        o_r = io.StringIO()
        cli.serve_stream(svc_r, io.StringIO("\n".join(lines) + "\n"), o_r)
        resp_r = [json.loads(ln) for ln in o_r.getvalue().splitlines()]
        check(len(resp_r) == 6 and resp_r[2].get("reloaded") == 2
              and svc_r.step == 2, f"serial push reload: {resp_r[2]}")
        fresh = (svc_r.generate is not before_gen
                 and _graphs_captured(svc_r.generate)
                 and _graphs_captured(before_gen))
        same_r = all(np.array_equal(
            _midi_bars(r["midi_b64"], cfg),
            _serial_reference(cfg, svc.model if i < 2 else step2.model, dev,
                              s, None)[0])
            for i, (r, s) in enumerate(zip(resp_r[:2] + resp_r[3:],
                                           r_seeds)))
        out["serial_reload"] = {"fresh_graphs": fresh,
                                "graph_equals_eager": same_r,
                                "graphs": _graph_info(svc_r.generate)}
        log(f"serve_stack (b') serial push reload: {out['serial_reload']}")
        check(fresh and same_r, f"serial reload: {out['serial_reload']}")
        del svc_r, before_gen

        # (c) throughput and latency by transport, step-2 weights
        load_seeds = [seed * 1000 + 500 + i
                      for i in range(STACK_CLIENTS * STACK_PER_CLIENT)]
        runner2 = cli._CoalescedRunner(step2, STACK_W)
        runner2.warm()
        step2.warm()
        timing = {}
        for name, fn in (
                ("stdin_serial", lambda i, o: cli.serve_stream(step2, i, o)),
                ("stdin_pipeline", lambda i, o: cli.serve_stream(
                    step2, i, o, pipeline=True)),
                ("stdin_coalesce4", lambda i, o: cli.serve_stream_coalesced(
                    step2, runner2, i, o))):
            timing[name] = _stdin_load(fn, load_seeds)
        timing["tcp_serial_4clients"] = _tcp_load(step2, None, load_seeds)
        timing["tcp_coalesce4_4clients"] = _tcp_load(step2, runner2,
                                                     load_seeds)
        for name, row in timing.items():
            log(f"serve_stack (c) {name}: {row['req_per_s']:.2f} req/s, "
                f"latency p50 {row['latency_ms_p50']:.1f} / p99 "
                f"{row['latency_ms_p99']:.1f} ms, density "
                f"{row['density']:.4f} ({card})")
        out["timing"] = timing

        # (d) convert to safetensors and back, on the card
        st = os.path.join(root, "m.safetensors")
        ck2 = os.path.join(root, "ck2")
        t0 = time.perf_counter()
        rc, o, e = _cli(["convert", "--to-safetensors", ck, "--out", st])
        check(rc == 0, f"convert --to-safetensors: {e[-2000:]}")
        rc, o, e = _cli(["convert", "--from-safetensors", st, "--config",
                         "c2_gru_4bar", "--out", ck2, "--step", 2])
        check(rc == 0, f"convert --from-safetensors: {e[-2000:]}")
        convert_ms = (time.perf_counter() - t0) * 1e3
        lines = "".join(json.dumps({"id": i, "seed": s}) + "\n"
                        for i, s in enumerate(seeds[:2]))
        served = {}
        for name, extra in (("original", ["--ckpt-dir", ck]),
                            ("converted", ["--ckpt-dir", ck2,
                                           "--use-pallas-conv1"])):
            rc, o, e = _cli(["serve", *extra, "--bars", GEN_BARS,
                             "--samples", GEN_SAMPLES], stdin=lines)
            check(rc == 0, f"serve {name}: {e[-2000:]}")
            served[name] = [r["midi_b64"] for r in map(
                json.loads, o.splitlines())]
        out["convert"] = {"ms": convert_ms, "bytes": os.path.getsize(st),
                          "same_bits": served["original"]
                          == served["converted"]}
        log(f"serve_stack (d) convert round trip: {out['convert']}")
        check(out["convert"]["same_bits"],
              "the converted checkpoint serves other bits")
    finally:
        layers.first_conv_s2 = real_k1
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serve_stack phase: {out['seconds']:.1f} s")
    return runs, out


KIND_NAMES = ("c1_conv_bar", "c3_hier_16bar", "c4_cond")
KIND_STEPS = 20
KIND_K = 5
KIND_DISPATCHES = 3      # timed dispatches of KIND_K steps a kind
KIND_REQUESTS = 8        # serve requests a kind, serial and --coalesce 4
GRAPH_STEPS = 5          # steps a config's graph is held to eager steps
SWEEP_MIDIS = 4          # c5_gen_sweep samples exported to MIDI


def _kind_config(name: str, seed: int):
    """The registered config with the first-conv kernels on, 20 steps in
    5-step dispatches and an eval every 10 (one batch)."""
    from musicvae_tpu_torch.config import get_config

    base = get_config(name)
    return base.replace(
        model=dataclasses.replace(base.model, use_pallas_conv1=True),
        train=dataclasses.replace(
            base.train, num_steps=KIND_STEPS, log_every=KIND_K,
            eval_every=10, eval_batches=1, seed=seed))


def _kind_cache(seed: int, num_bars: int):
    """``make_bar_cache`` with windows of ``num_bars`` and seeded chord
    (per window) and key (per piece) classes."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset

    ds = make_bar_cache(seed, num_bars=num_bars)
    rng = np.random.default_rng((seed, 9))
    keys = rng.integers(0, 24, ds.piece_ids.max() + 1)[ds.piece_ids]
    return PianoRollDataset(ds.bars, ds.starts, num_bars,
                            rng.integers(0, 24, len(ds)), keys,
                            ds.piece_ids, grid=(24, 4, 0))


def _kind_reference(cfg, model, dev, payload):
    """(bars, σ) of the lone sweep of a prepared serve request (generator,
    seed bar, chord, key), through the sampler's draws and the model's own
    ``generate``: the reference of the flip rule."""
    from musicvae_tpu_torch.generate import sampler

    gen, sb, chord, key_sig = payload
    g, b = cfg.gen, cfg.gen.num_samples
    if sb is not None:
        sb = torch.from_numpy(sb).to(dev)[None].repeat(b, 1, 1)
    if chord is not None:
        chord = torch.from_numpy(chord).to(dev)
        key_sig = torch.from_numpy(key_sig).to(dev)
    with torch.inference_mode():
        noise, chord, key_sig, zp = sampler.sweep_draws(
            cfg, b, gen, dev, chord=chord, key_sig=key_sig)
        z, reset = sampler.latent_path(cfg, b, g.num_bars, g.interpolate,
                                       g.temperature, noise=noise)
        logits, bars = model.generate(z, reset, sb, chord=chord,
                                      key_sig=key_sig, z_phrase=zp)
    return bars.cpu().numpy(), torch.sigmoid(logits.float()).cpu().numpy()


def _kind_requests(name: str, seed: int):
    """KIND_REQUESTS request lines; for cond, even ids pin chord and key
    and odd ids leave them to the server's draws."""
    reqs = []
    for i in range(KIND_REQUESTS):
        r = {"id": i, "seed": seed * 1000 + 700 + i}
        if name == "c4_cond" and i % 2 == 0:
            r.update(chord=(3 * i) % 24, key=(5 * i + 1) % 24)
        reqs.append(r)
    return reqs


def _kind_train(cfg, train_ds, eval_ds, dev, steps: int = KIND_STEPS):
    """One ``train()`` run of ``steps`` steps: (model, state, logged,
    launches, seconds with start-up)."""
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer

    logged = []
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state, _ = trainer.train(
        cfg, train_ds, num_steps=steps, eval_data=eval_ds,
        log_fn=lambda s, m: logged.append((s, m)), device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(int(state.step) == steps, f"state.step {int(state.step)}")
    return model, state, logged, dict(_kernels.LAUNCHES), dt


def _fresh_state(cfg, dev):
    from musicvae_tpu_torch.train import trainer

    return trainer.create_state(cfg, device=dev)[1]


def _kind_timing(cfg, state, train_ds, dev, seed: int,
                 graph: bool = True) -> dict:
    """Steps/s by host clock over KIND_DISPATCHES dispatches of KIND_K
    steps (no host wait inside: sync debug mode "error"), then one
    dispatch's kernels from torch.profiler: launches and device time a
    step, and the device-busy share (device time over host time).
    ``graph`` False: the same dispatches eagerly (``debug_mode``'s
    disable_jit)."""
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import debug_mode

    data_dev = _resident(train_ds, dev, cfg.model.kind == "cond")
    b = cfg.train.batch_size
    ids = trainer.make_id_schedule(seed, len(train_ds), b)
    idxs = [torch.from_numpy(np.stack([ids(d * KIND_K + j)
                                       for j in range(KIND_K)])).to(dev)
            for d in range(KIND_DISPATCHES + 1)]
    multi = trainer.make_train_step_indexed_multi(cfg, state.model)
    eager = (contextlib.nullcontext() if graph
             else debug_mode(nans=False, disable_jit=True))
    with trainer.deterministic_algorithms(), eager:
        multi(state, data_dev, idxs[0])                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            for d in range(1, KIND_DISPATCHES + 1):
                state, m = multi(state, data_dev, idxs[d])
            enqueue = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        kernels, kernel_ms = profiled_kernels(
            lambda: multi(state, data_dev, idxs[0]))
    steps = KIND_DISPATCHES * KIND_K
    out = {"steps_per_s": steps / host,
           "host_ms_per_step": host / steps * 1e3,
           "enqueue_ms_per_step": enqueue / steps * 1e3,
           "device_ms_per_step": kernel_ms / KIND_K,
           "kernels_per_step": kernels / KIND_K,
           "loss": float(m["loss"]), "graphed": _graphs_captured(multi),
           "graph": _graph_info(multi)}
    check(out["graphed"] == graph, f"{cfg.name} timing: graphed "
                                   f"{out['graphed']}, asked {graph}")
    out["device_busy_share"] = (out["device_ms_per_step"]
                                / out["host_ms_per_step"])
    check(np.isfinite(out["loss"]), f"timed dispatches: loss {out['loss']}")
    return out


def _kind_serve(name, cfg, model, dev, seed) -> dict:
    """KIND_REQUESTS requests through stdin serial serving and --coalesce
    4: serial answers equal the lone sweep's bars exactly, coalesced ones
    agree under the flip rule (and ``bits_equal`` says whether they equal
    the serial ones bit for bit); req/s by host clock for each."""
    from musicvae_tpu_torch import cli

    thr = cfg.midi.binarize_threshold
    svc = cli.Service(cfg, model)
    runner = cli._CoalescedRunner(svc, STACK_W)
    svc.warm()
    runner.warm()
    reqs = _kind_requests(name, seed)
    lines = "".join(json.dumps(r) + "\n" for r in reqs)
    refs = [_kind_reference(cfg, model, dev, svc.prepare(json.dumps(r))[2])
            for r in reqs]
    got, timing = {}, {}
    for mode, fn in (("serial", lambda i, o: cli.serve_stream(svc, i, o)),
                     ("coalesce4", lambda i, o: cli.serve_stream_coalesced(
                         svc, runner, i, o))):
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(io.StringIO(lines), out)
        dt = time.perf_counter() - t0
        resp = [json.loads(ln) for ln in out.getvalue().splitlines()]
        check([r.get("id") for r in resp] == [r["id"] for r in reqs]
              and all("midi_b64" in r for r in resp),
              f"{name} serve {mode}: {[r.get('error') for r in resp]}")
        got[mode] = [_midi_bars(r["midi_b64"], cfg) for r in resp]
        timing[mode] = _load_stats([r["latency_ms"] for r in resp],
                                   len(resp), dt, float(np.mean(
                                       [r["density"] for r in resp])))
    # the serial sweeps are replays of the graphs svc.warm() captured,
    # the references eager sweeps: equal bit for bit
    check(_graphs_captured(svc.generate), f"{name}: serial serving "
                                          f"captured no sweep graph")
    check(all(np.array_equal(a, r[0]) for a, r in zip(got["serial"], refs)),
          f"{name}: serial serving differs from the lone sweep")
    agree = _agree(got["coalesce4"], refs, thr)
    if name == "c4_cond":       # the pinned labels reach the music
        check(not np.array_equal(got["serial"][0], got["serial"][2]),
              "cond: two requests with other labels gave the same bars")
    bits_equal = all(np.array_equal(a, b) for a, b in zip(
        got["coalesce4"], got["serial"]))
    return {"timing": timing, "coalesce_vs_serial": agree,
            "bits_equal": bits_equal, "serial_graph_equals_eager": True,
            "sweep_graphs": _graph_info(svc.generate)}


def _kind_convert(name, cfg, ck, root, seed) -> dict:
    """``convert --to-safetensors`` then ``--from-safetensors``; the
    converted checkpoint serves the original's bits."""
    st = os.path.join(root, f"{name}.safetensors")
    ck2 = os.path.join(root, f"{name}_converted")
    t0 = time.perf_counter()
    rc, _, e = _cli(["convert", "--to-safetensors", ck, "--out", st])
    check(rc == 0, f"{name} convert --to-safetensors: {e[-2000:]}")
    rc, _, e = _cli(["convert", "--from-safetensors", st, "--config", name,
                     "--out", ck2, "--step", KIND_STEPS])
    check(rc == 0, f"{name} convert --from-safetensors: {e[-2000:]}")
    convert_ms = (time.perf_counter() - t0) * 1e3
    lines = "".join(json.dumps(r) + "\n"
                    for r in _kind_requests(name, seed)[:2])
    served = {}
    for which, extra in (("original", ["--ckpt-dir", ck]),
                         ("converted", ["--ckpt-dir", ck2,
                                        "--use-pallas-conv1"])):
        rc, o, e = _cli(["serve", *extra, "--bars", GEN_BARS, "--samples",
                         GEN_SAMPLES], stdin=lines)
        check(rc == 0, f"{name} serve {which}: {e[-2000:]}")
        served[which] = [r["midi_b64"] for r in map(json.loads,
                                                      o.splitlines())]
    out = {"ms": convert_ms, "bytes": os.path.getsize(st),
           "same_bits": served["original"] == served["converted"]}
    check(out["same_bits"], f"{name}: the converted checkpoint serves "
                            f"other bits")
    return out


def _kinds_kernel_shapes(seed: int, dev: torch.device, card: str) -> dict:
    """K1, K1b, K2 and K4 at the kinds' train and eval shapes, each against
    its plain version on the same inputs (the kernel phase's tolerances),
    then timed from a cold L2 beside its bound, its plain version and one
    library call. K4's sum must give the same bits on a second call at
    25.2 M logits (its fixed-order finish over SUM_MAX_BLOCKS partials).
    Returns {kernel: [shape rows]}."""
    g = torch.Generator(dev).manual_seed(seed + 90)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {"first_conv_s2": [], "first_conv_s2_bwd": [],
            "masked_bce_sum": [], "masked_bce_sum_dual": []}

    def row(*args, **extra):
        _shape_row(rows, "kinds", card, *args, **extra)

    _conv1_shape_rows(g, dev, flush, row, 16, (
        ("C3 train, M=2048", 2048, torch.bfloat16),
        ("C4 train, M=1024", 1024, torch.bfloat16),
        ("C1 train, M=16, f32", 16, torch.float32)))
    _bce_shape_rows(g, dev, flush, row, (
        ("C3 train, [128,16,96,128]", (128, 16, 96, 128),
         ("masked_bce_sum_dual",)),
        ("C4 train, [256,4,96,128]", (256, 4, 96, 128),
         ("masked_bce_sum_dual",)),
        ("C3 eval, [128,16,96,128]", (128, 16, 96, 128),
         ("masked_bce_sum",))))
    return rows


def _conv1_shape_rows(g, dev, flush, row, c: int, cases) -> None:
    """K1 and K1b at each case's (label, M, out dtype) with C channels
    drawn from ``g``, against their plain versions on the same inputs
    (1e-5 f32 / 1e-2 bf16 on K1, 1e-3 on K1b), then timed from a cold L2
    through ``row`` beside their bounds, plain versions and library
    calls."""
    import torch.nn.functional as F

    from musicvae_tpu_torch.ops import conv1

    w = torch.randn((3, 3, c), generator=g, device=dev) / 3.0
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    for label, m, out_dtype in cases:
        x = (torch.rand((m, 96, 128), generator=g, device=dev) < 0.05
             ).to(torch.uint8)
        got = conv1.first_conv_s2(x, w, b, True, out_dtype).float()
        ref = conv1.first_conv_s2_ref(x, w, b, True, out_dtype).float()
        tol = 1e-5 if out_dtype == torch.float32 else 1e-2
        diff = (got - ref).abs()
        check(bool((diff <= tol + tol * ref.abs()).all()),
              f"K1 at {label} disagrees: {float(diff.max())}")
        osize = 4 if out_dtype == torch.float32 else 2
        outs = m * 48 * 64 * c
        lib_w = w.permute(2, 0, 1)[:, None].to(out_dtype).contiguous()
        x_nchw = x[:, None].to(out_dtype)
        row("first_conv_s2", label, float(diff.max()),
            time_ms(lambda: conv1.first_conv_s2(x, w, b, True, out_dtype),
                    flush),
            time_ms(lambda: conv1.first_conv_s2_ref(x, w, b, True,
                                                    out_dtype), flush),
            time_ms(lambda: F.gelu(F.conv2d(x_nchw, lib_w, b.to(out_dtype),
                                            stride=2, padding=1),
                                   approximate="tanh"), flush),
            x.numel() + 4 * (w.numel() + b.numel()) + osize * outs,
            outs * (2 * 9 + 1 + 8))
        dy = torch.randn((m, 48, 64, c), generator=g, device=dev
                         ).to(out_dtype)
        wl, bl = w.clone().requires_grad_(True), b.clone().requires_grad_(
            True)
        dw, db = torch.autograd.grad(
            conv1.first_conv_s2(x, wl, bl, True, out_dtype), (wl, bl), dy)
        rw, rb = conv1.first_conv_s2_bwd_ref(x, w, b, dy, True)
        errs = [float((a - r).abs().max()) for a, r in ((dw, rw), (db, rb))]
        check(all(bool(((a - r).abs() <= 1e-3 + 1e-3 * r.abs()).all())
                  for a, r in ((dw, rw), (db, rb))),
              f"K1b at {label} disagrees: {errs}")
        z_nchw = F.conv2d(x_nchw, lib_w, b.to(out_dtype), stride=2,
                          padding=1)
        dy_nchw = dy.permute(0, 3, 1, 2)

        def k1b_library():
            dz = torch.ops.aten.gelu_backward(dy_nchw, z_nchw,
                                              approximate="tanh")
            return torch.ops.aten.convolution_backward(
                dz, x_nchw, lib_w, [c], [2, 2], [1, 1], [1, 1], False,
                [0, 0], 1, [False, True, True])

        row("first_conv_s2_bwd", label, max(errs),
            time_ms(lambda: conv1._backward(x, w, b, dy, True), flush),
            time_ms(lambda: conv1.first_conv_s2_bwd_ref(x, w, b, dy, True),
                    flush),
            time_ms(k1b_library, flush),
            x.numel() + osize * dy.numel() + 4 * 2 * (w.numel() + b.numel()),
            dy.numel() * (2 * 9 + 2 * 9 + 12),
            kernel_only_ms=kernel_only_ms(
                lambda: conv1._backward(x, w, b, dy, True), flush,
                "conv1_bwd"))


def _shape_row(rows, phase, card, kernel, label, err, ms, plain, lib,
               nbytes, ops, **extra):
    """One kernel-at-a-shape row: its times beside its bound from
    ``nbytes`` and ``ops``, appended to ``rows[kernel]`` and logged."""
    bms, by = bound_ms(nbytes, ops)
    r = {"name": f"{kernel} ({label})", "max_abs_err": err, "ms": ms,
         "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
         "bound_by": by, "bound_share": bms / ms, **extra}
    rows[kernel].append(r)
    log(f"{phase} kernel {r['name']} ({card}): kernel {ms * 1e3:.2f} us, "
        f"plain {plain * 1e3:.2f} us, library "
        f"{'none' if lib is None else f'{lib * 1e3:.2f} us'}, bound "
        f"{bms * 1e3:.2f} us ({by}, share {bms / ms:.3f}), max abs "
        f"err {err:.3e}")


def _bce_shape_rows(g, dev, flush, row, cases) -> None:
    """K4 (masked_bce_sum_dual) and K2 (masked_bce_sum) at each case's
    [B,N,96,128] shape against the plain BCE: the sum within 1e-5
    relative, the same bits on a second call (the fixed-order finish), K4's
    gradient tile within 1e-6; then timed from a cold L2 beside the plain
    version under autograd (K4) or not (K2) and one library call, each
    passed to ``row``."""
    import torch.nn.functional as F

    from musicvae_tpu_torch.ops import fused_elbo, losses

    full = torch.ones(128, device=dev)
    for label, shape, kernels in cases:
        logits = 3.0 * torch.randn(shape, generator=g, device=dev)
        xb = torch.rand(shape, generator=g, device=dev) < 0.05
        xu8, xf = xb.to(torch.uint8), xb.to(torch.float32)
        n = logits.numel()
        with torch.no_grad():
            ref = losses.masked_bce_sum(logits, xu8, full)
        for kernel in kernels:
            dual = kernel == "masked_bce_sum_dual"
            with torch.no_grad():
                s1, tile = fused_elbo._bce_sum(logits, xu8, full, dual)
                s2, _ = fused_elbo._bce_sum(logits, xu8, full, dual)
            rel = abs(float(s1) - float(ref)) / abs(float(ref))
            check(rel <= 1e-5, f"{kernel} at {label}: rel {rel:.2e}")
            check(bool(torch.equal(s1, s2)),
                  f"{kernel} at {label}: two calls gave other bits")
            err = abs(float(s1) - float(ref))
            extra = {"n": n, "rel_err": rel, "same_bits_twice": True}
            if dual:
                want = fused_elbo.bce_grad_tile_plain(logits, xu8, full)
                terr = float((tile - want).abs().max())
                check(terr <= 1e-6, f"K4 tile at {label}: {terr}")
                extra["tile_max_abs_err"] = terr
                leaf = logits.clone().requires_grad_(True)

                def plain():
                    total = losses.masked_bce_sum(leaf, xu8, full)
                    return total, torch.autograd.grad(total, leaf)

                def library():
                    total = F.binary_cross_entropy_with_logits(
                        leaf, xf, weight=full, reduction="sum")
                    return total, torch.autograd.grad(total, leaf)

                row(kernel, label, err,
                    time_ms(lambda: fused_elbo._bce_sum(logits, xu8, full,
                                                        True), flush),
                    time_ms(plain, flush), time_ms(library, flush),
                    4 * n + n + 4 * n + 4 * 128 + 4, 15 * n, **extra)
            else:
                with torch.no_grad():
                    row(kernel, label, err,
                        time_ms(lambda: fused_elbo.masked_bce_sum(
                            logits, xu8, full), flush),
                        time_ms(lambda: losses.masked_bce_sum(
                            logits, xu8, full), flush),
                        time_ms(lambda: F.binary_cross_entropy_with_logits(
                            logits, xf, weight=full, reduction="sum"),
                            flush),
                        4 * n + n + 4 * 128 + 4, 9 * n, **extra)
        del logits, xb, xu8, xf


def kinds_phase(seed: int, dev: torch.device, card: str):
    """The other parity kinds at full registered width on the card, each
    with the first-conv kernels on: c1_conv_bar (f32, batch 16),
    c3_hier_16bar (bf16, 128 x 16 bars), c4_cond (bf16, 256 x 4 bars, the
    global batch on one card). Per kind: (a) 20 steps through ``train()``
    on a seeded resident cache with labels, an eval every 10 (K4 a step,
    K1/K1b on the encoder trunk or both bar-feature convs, K2 an eval
    batch), the loss finite and falling, c4_cond repeated bit for bit;
    (b) steps/s, launches and kernel time a step, device-busy share; (c)
    f32 on the card against the CPU; (d) 4 x 16 bars generated, 8 serve
    requests serial and --coalesce 4 under the flip rule (cond: half with
    labels given, half drawn), c3's ``generate --encode --interp-midi-b``
    morph; (e) convert to safetensors and back serves the same bits. Then
    c5_gen_sweep's registered 1,024 x 64-bar interpolation sweep once (4
    samples to MIDI), and K1, K1b, K2, K4 at the kinds' shapes against
    their plain versions and timed. Launch counts are read around each
    kind's train, generate and serve, and around the sweep."""
    import shutil
    import tempfile

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.config import GenSpec, get_config
    from musicvae_tpu_torch.data.synthetic import synth_corpus
    from musicvae_tpu_torch.generate import sampler
    from musicvae_tpu_torch.models.vae import build_model
    from musicvae_tpu_torch.ops import _kernels

    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="kinds_smoke_",
                            dir=_kernels.BUILD_ROOT.parent)
    out, total = {"card": card}, {k: 0 for k in _kernels.LAUNCHES}
    t_phase = time.perf_counter()

    def counted(launches):
        for k, v in launches.items():
            total[k] += v

    try:
        midis = []
        for i, (data, _, _) in enumerate(synth_corpus(2, 16, seed=seed)):
            midis.append(os.path.join(root, f"m{i}.mid"))
            with open(midis[-1], "wb") as f:
                f.write(data)
        for name in KIND_NAMES:
            t_kind = time.perf_counter()
            cfg = _kind_config(name, seed)
            nb = cfg.model.num_bars
            train_ds, eval_ds = _kind_cache(seed, nb).split(0.1, seed=seed)
            res = {"windows": len(train_ds), "batch": cfg.train.batch_size,
                   "num_bars": nb, "dtype": cfg.model.dtype}
            model, state, logged, launches, dt = _kind_train(
                cfg, train_ds, eval_ds, dev)
            counted(launches)
            steps = [m for _, m in logged if "loss" in m]
            evals = [m for _, m in logged if "eval_loss" in m]
            losses_ = [m["loss"] for m in steps]
            convs = 1 if name == "c1_conv_bar" else 2
            check(len(steps) == KIND_STEPS // KIND_K and len(evals) == 2,
                  f"{name}: logged {len(steps)} steps, {len(evals)} evals")
            check(all(np.isfinite(v) for m in steps + evals
                      for v in m.values()), f"{name}: a metric not finite")
            check(losses_[-1] < losses_[0], f"{name}: the loss did not "
                                            f"fall: {losses_}")
            want = {"masked_bce_sum_dual": KIND_STEPS,
                    "masked_bce_sum": len(evals),
                    "first_conv_s2": convs * (KIND_STEPS + len(evals)),
                    "first_conv_s2_bwd": convs * KIND_STEPS}
            check(all(launches[k] == v for k, v in want.items()),
                  f"{name}: train launches {launches}, expected {want}")
            res.update(train_launches=launches, losses=losses_,
                       eval_loss=[m["eval_loss"] for m in evals],
                       train_seconds_with_startup=dt)
            log(f"kinds {name} train: losses {losses_}, evals "
                f"{res['eval_loss']}, launches {launches}, {dt:.2f} s")
            if name == "c4_cond":
                model_b, _, logged_b, launches_b, _ = _kind_train(
                    cfg, train_ds, eval_ds, dev)
                counted(launches_b)
                same = ([m for _, m in logged] == [m for _, m in logged_b]
                        and all(torch.equal(a, b) for a, b in zip(
                            model.parameters(), model_b.parameters())))
                res["repeat_same_bits"] = same
                log(f"kinds {name} repeated run: same bits {same}")
                check(same, f"{name}: a repeated run differs")
                del model_b
            ck = os.path.join(root, name)
            check(ckpt_io.save(ckpt_io.make_manager(ck), state, cfg,
                               wait=True), f"{name}: not saved")
            res["timing"] = _kind_timing(cfg, state, train_ds, dev, seed)
            log(f"kinds {name} train timing ({card}): {res['timing']}")
            # on a fresh state: the trained one is served below, as it
            # stands after the graph timing's steps
            res["timing_eager"] = _kind_timing(cfg, _fresh_state(cfg, dev),
                                               train_ds, dev, seed,
                                               graph=False)
            log(f"kinds {name} train timing, eager ({card}): "
                f"{res['timing_eager']}")
            res["graph_vs_eager"] = _graph_vs_eager_steps(
                cfg, train_ds, dev, seed, GRAPH_STEPS)
            log(f"kinds {name} graph vs eager: {res['graph_vs_eager']}")
            res["reference"] = reference_check(seed, dev, name)

            gcfg = cfg.replace(gen=GenSpec(num_bars=GEN_BARS,
                                           num_samples=GEN_SAMPLES))
            _kernels.reset_launches()
            bars = sampler.make_generate_fn(gcfg, model)(
                sampler.seed_generator(seed, dev))
            torch.cuda.synchronize()
            gen_launches = dict(_kernels.LAUNCHES)
            counted(gen_launches)
            check(tuple(bars.shape) == (GEN_SAMPLES, GEN_BARS, 96, 128),
                  f"{name}: generated {tuple(bars.shape)}")
            check(gen_launches["first_conv_s2"]
                  == (0 if name == "c1_conv_bar" else GEN_BARS),
                  f"{name}: generate launches {gen_launches}")
            res["generate"] = {"density": float(bars.float().mean()),
                               "launches": gen_launches}
            _kernels.reset_launches()
            res["serve"] = _kind_serve(name, gcfg, model, dev, seed)
            torch.cuda.synchronize()
            counted(dict(_kernels.LAUNCHES))
            log(f"kinds {name} serve ({card}): {res['serve']}")
            if name == "c3_hier_16bar":
                o, e, ms, morph_launches = _timed_cli([
                    "generate", "--ckpt-dir", ck, "--seed-midi", midis[0],
                    "--encode", "--interpolate", "--interp-midi-b", midis[1],
                    "--bars", GEN_BARS, "--samples", GEN_SAMPLES,
                    "--out-dir", os.path.join(root, "morph")])
                counted(morph_launches)
                rolls = np.load(os.path.join(root, "morph", "rolls.npy"))
                check(rolls.shape == (GEN_SAMPLES, GEN_BARS, 96, 128),
                      f"morph rolls {rolls.shape}")
                res["morph"] = {"ms": ms, "timing": _timing(e),
                                "launches": morph_launches,
                                "density": float(rolls.mean())}
                log(f"kinds {name} morph: {res['morph']}")
            res["convert"] = _kind_convert(name, cfg, ck, root, seed)
            log(f"kinds {name} convert: {res['convert']}")
            res["seconds"] = time.perf_counter() - t_kind
            out[name] = res
            del model, state

        # c5_gen_sweep: 1,024 samples x 64 bars, interpolation: the first
        # call eager, the second captured and replayed, the third a replay
        c5 = get_config("c5_gen_sweep")
        c5 = c5.replace(model=dataclasses.replace(c5.model,
                                                  use_pallas_conv1=True))
        model = build_model(c5, device=dev, seed=seed)
        sweep = sampler.make_generate_fn(c5, model)
        runs5 = {}
        for run in ("eager", "graph_capture", "graph_replay"):
            _kernels.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            bars = sweep(sampler.seed_generator(seed, dev))
            torch.cuda.synchronize()
            runs5[run] = {
                "seconds": time.perf_counter() - t0,
                "peak_bytes_above_held": torch.cuda.max_memory_allocated(dev)
                - held, "launches": dict(_kernels.LAUNCHES),
                "bars": bars}
            counted(runs5[run]["launches"])
            check(tuple(bars.shape) == (1024, 64, 96, 128)
                  and runs5[run]["launches"]["first_conv_s2"] == 64,
                  f"c5 sweep ({run}) {tuple(bars.shape)}, launches "
                  f"{runs5[run]['launches']}")
        same = all(torch.equal(runs5["eager"]["bars"], runs5[r]["bars"])
                   for r in ("graph_capture", "graph_replay"))
        check(same and _graphs_captured(sweep),
              "c5 sweep: the graph's bars differ from the eager sweep's")
        sweep_s = runs5["graph_replay"]["seconds"]
        sweep_launches = runs5["graph_replay"]["launches"]
        bars = runs5["graph_replay"]["bars"]
        for r in runs5.values():
            del r["bars"]
        t0 = time.perf_counter()
        exported = [sampler.bars_to_midi(bars[i].cpu().numpy(), c5)
                    for i in range(SWEEP_MIDIS)]
        export_s = time.perf_counter() - t0
        out["c5_gen_sweep"] = {
            "samples": 1024, "bars": 64, "seconds": sweep_s,
            "bars_per_s": 1024 * 64 / sweep_s,
            "export_seconds_4_samples": export_s,
            "midi_bytes": [len(m) for m in exported],
            "density": float(bars.float().mean()),
            "launches": sweep_launches, "graph_equals_eager": same,
            "runs": runs5, "graph": _graph_info(sweep)}
        log(f"kinds c5_gen_sweep ({card}): {out['c5_gen_sweep']}")
        del bars, model
        torch.cuda.empty_cache()
        out["kernel_shapes"] = _kinds_kernel_shapes(seed, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    log(f"kinds launches: {total}")
    log(f"kinds phase: {out['seconds']:.1f} s")
    return {"kinds": total}, out


PA_NAMES = ("c2_trf", "c3_trf", "c2_mxu")     # full width, 20 steps each
PA_SHORT = ("c2_mxu_wide", "c3_mxu", "c2_mxu_16bar", "c2_trf_32bar")
PA_SHORT_STEPS = 5
PA_LOOP_BARS = 8         # closed loop vs teacher: 4 x 8 bars, f32
PA_LOOP_TOL = 1e-4
PA_BIT_EQUAL = ("c2_trf", "c3_trf")   # coalesced == serial, bit for bit


def _closed_loop_vs_teacher(name: str, seed: int, dev) -> dict:
    """The registered config in f32 on the card: GEN_SAMPLES x
    PA_LOOP_BARS bars generated with one reset at bar 0, then
    teacher-decoded with the same z (and phrase latent): the same
    function, logits within PA_LOOP_TOL."""
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.models.vae import build_model

    cfg = get_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    spec, b, n = cfg.model, GEN_SAMPLES, PA_LOOP_BARS
    model = build_model(cfg, device=dev, seed=seed)
    g = torch.Generator(dev).manual_seed(seed + 5)
    z = torch.randn((b, n, spec.z_dim), generator=g, device=dev)
    reset = torch.zeros((b, n), device=dev)
    reset[:, 0] = 1.0
    zp = zp_bars = None
    if spec.kind == "hier":
        zp = torch.randn((b, spec.z_phrase_dim), generator=g, device=dev)
        zp_bars = zp[:, None].expand(-1, n, -1)
    with torch.inference_mode():
        logits, bars = model.generate(z, reset, z_phrase=zp)
        teacher = model.teacher(z, bars.float(), z_phrase_bars=zp_bars)
    err = float((logits - teacher).abs().max())
    log(f"patch_attn {name}: f32 closed loop vs teacher on the card, "
        f"{b} x {n} bars: logits max abs diff {err:.3e}")
    check(err <= PA_LOOP_TOL, f"{name}: closed loop and teacher disagree: "
                              f"{err}")
    return {"logits_max_abs_diff": err, "bars": n, "samples": b,
            "density": float(bars.float().mean())}


def patch_attn_phase(seed: int, dev: torch.device, card: str):
    """The patch stem and the attention core at full registered width on
    the card, random weights from the seed, the first-conv flag on (the
    patch stem ignores it: K1 and K1b must never launch). c2_trf (bf16,
    64 x 4 bars), c3_trf (128 x 16) and c2_mxu (64 x 4) each: (a) 20
    steps through ``train()`` on a seeded resident cache, an eval every
    10 (K4 a step, K2 an eval batch), the loss finite and falling, c2_trf
    repeated bit for bit; (b) steps/s, launches and kernel time a step,
    device-busy share; (c) f32 on the card against the CPU, and the f32
    closed loop against the teacher-forced decode; (d) 4 x 16 bars
    generated, 8 serve requests serial and --coalesce 4 under the flip
    rule; c2_trf's checkpoint refused by ``convert --to-safetensors``.
    Then c2_mxu_wide, c3_mxu, c2_mxu_16bar and c2_trf_32bar 5 steps each
    (K4 a step), a 32-bar c2_trf_32bar sweep (a 32-position KV cache),
    and K4 at the 16- and 32-bar configs' n = 6,291,456 against its plain
    version, timed."""
    import shutil
    import tempfile

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.config import GenSpec
    from musicvae_tpu_torch.generate import sampler
    from musicvae_tpu_torch.models.vae import build_model
    from musicvae_tpu_torch.ops import _kernels

    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="patch_attn_smoke_",
                            dir=_kernels.BUILD_ROOT.parent)
    out, total = {"card": card}, {k: 0 for k in _kernels.LAUNCHES}
    t_phase = time.perf_counter()

    def counted(launches):
        for k, v in launches.items():
            total[k] += v

    try:
        for name in PA_NAMES:
            t_name = time.perf_counter()
            cfg = _kind_config(name, seed)
            nb = cfg.model.num_bars
            train_ds, eval_ds = _kind_cache(seed, nb).split(0.1, seed=seed)
            res = {"windows": len(train_ds), "batch": cfg.train.batch_size,
                   "num_bars": nb, "dtype": cfg.model.dtype}
            model, state, logged, launches, dt = _kind_train(
                cfg, train_ds, eval_ds, dev)
            counted(launches)
            steps = [m for _, m in logged if "loss" in m]
            evals = [m for _, m in logged if "eval_loss" in m]
            losses_ = [m["loss"] for m in steps]
            check(len(steps) == KIND_STEPS // KIND_K and len(evals) == 2,
                  f"{name}: logged {len(steps)} steps, {len(evals)} evals")
            check(all(np.isfinite(v) for m in steps + evals
                      for v in m.values()), f"{name}: a metric not finite")
            check(losses_[-1] < losses_[0], f"{name}: the loss did not "
                                            f"fall: {losses_}")
            want = {"masked_bce_sum_dual": KIND_STEPS,
                    "masked_bce_sum": len(evals), "first_conv_s2": 0,
                    "first_conv_s2_bwd": 0}
            check(all(launches[k] == v for k, v in want.items()),
                  f"{name}: train launches {launches}, expected {want}")
            res.update(train_launches=launches, losses=losses_,
                       eval_loss=[m["eval_loss"] for m in evals],
                       train_seconds_with_startup=dt)
            log(f"patch_attn {name} train: losses {losses_}, evals "
                f"{res['eval_loss']}, launches {launches}, {dt:.2f} s")
            if name == "c2_trf":
                model_b, _, logged_b, launches_b, _ = _kind_train(
                    cfg, train_ds, eval_ds, dev)
                counted(launches_b)
                same = ([m for _, m in logged] == [m for _, m in logged_b]
                        and all(torch.equal(a, b) for a, b in zip(
                            model.parameters(), model_b.parameters())))
                res["repeat_same_bits"] = same
                log(f"patch_attn {name} repeated run: same bits {same}")
                check(same, f"{name}: a repeated run differs")
                del model_b
            ck = os.path.join(root, name)
            check(ckpt_io.save(ckpt_io.make_manager(ck), state, cfg,
                               wait=True), f"{name}: not saved")
            res["timing"] = _kind_timing(cfg, state, train_ds, dev, seed)
            log(f"patch_attn {name} train timing ({card}): {res['timing']}")
            # on a fresh state: the trained one is served below, as it
            # stands after the graph timing's steps
            res["timing_eager"] = _kind_timing(cfg, _fresh_state(cfg, dev),
                                               train_ds, dev, seed,
                                               graph=False)
            log(f"patch_attn {name} train timing, eager ({card}): "
                f"{res['timing_eager']}")
            res["graph_vs_eager"] = _graph_vs_eager_steps(
                cfg, train_ds, dev, seed, GRAPH_STEPS)
            log(f"patch_attn {name} graph vs eager: "
                f"{res['graph_vs_eager']}")
            res["reference"] = reference_check(seed, dev, name)
            res["closed_loop"] = _closed_loop_vs_teacher(name, seed, dev)

            gcfg = cfg.replace(gen=GenSpec(num_bars=GEN_BARS,
                                           num_samples=GEN_SAMPLES))
            _kernels.reset_launches()
            bars = sampler.make_generate_fn(gcfg, model)(
                sampler.seed_generator(seed, dev))
            torch.cuda.synchronize()
            gen_launches = dict(_kernels.LAUNCHES)
            counted(gen_launches)
            # no TPU kernel's port; the conv epilogue once a conv of the
            # previous bar's trunk and of the head (its output conv too) a bar
            epilogue = (len(cfg.model.enc_channels)
                        + len(cfg.model.dec_channels)) * GEN_BARS
            check(tuple(bars.shape) == (GEN_SAMPLES, GEN_BARS, 96, 128)
                  and gen_launches == {**dict.fromkeys(gen_launches, 0),
                                       "conv_epilogue": epilogue},
                  f"{name}: generated {tuple(bars.shape)}, launches "
                  f"{gen_launches}")
            res["generate"] = {"density": float(bars.float().mean())}
            _kernels.reset_launches()
            res["serve"] = _kind_serve(name, gcfg, model, dev, seed)
            torch.cuda.synchronize()
            counted(dict(_kernels.LAUNCHES))
            log(f"patch_attn {name} serve ({card}): {res['serve']}")
            if name in PA_BIT_EQUAL:
                # the attention core runs its batch-dependent ops a slot
                # at a time: coalesced bars are the serial ones exactly
                check(res["serve"]["bits_equal"],
                      f"{name}: --coalesce 4 bars differ from serial ones")
            if name == "c2_mxu":
                # the trained weights serve near-empty bars: hold the
                # comparison on the untrained init too, which gives notes
                init = build_model(gcfg, device=dev, seed=seed)
                res["serve_init"] = _kind_serve(name, gcfg, init, dev, seed)
                log(f"patch_attn {name} serve, init weights ({card}): "
                    f"{res['serve_init']}")
                dens = res["serve_init"]["timing"]["serial"]["density"]
                check(dens > 0.01, f"{name}: init weights served density "
                                   f"{dens}: no notes to compare")
                del init
            if name == "c2_trf":
                st = os.path.join(root, "c2_trf.safetensors")
                rc, _, e = _cli(["convert", "--to-safetensors", ck, "--out",
                                 st])
                res["convert_refused"] = (rc == 2 and "patch stem" in e
                                          and not os.path.exists(st))
                log(f"patch_attn {name} convert: rc {rc}, {e.strip()}")
                check(res["convert_refused"],
                      f"{name}: convert did not refuse: rc {rc}, {e}")
            res["seconds"] = time.perf_counter() - t_name
            out[name] = res
            del model, state
            torch.cuda.empty_cache()

        for name in PA_SHORT:
            t_name = time.perf_counter()
            cfg = _kind_config(name, seed)
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, num_steps=PA_SHORT_STEPS,
                log_every=PA_SHORT_STEPS, eval_every=0))
            nb = cfg.model.num_bars
            model, state, logged, launches, dt = _kind_train(
                cfg, _kind_cache(seed, nb), None, dev, PA_SHORT_STEPS)
            counted(launches)
            loss = [m["loss"] for _, m in logged if "loss" in m]
            check(launches["masked_bce_sum_dual"] == PA_SHORT_STEPS
                  and launches["first_conv_s2"] == 0
                  and len(loss) == 1 and np.isfinite(loss[0]),
                  f"{name}: launches {launches}, loss {loss}")
            res = {"batch": cfg.train.batch_size, "num_bars": nb,
                   "loss": loss[0], "train_launches": launches,
                   "train_seconds_with_startup": dt}
            res["graph_vs_eager"] = _graph_vs_eager_steps(
                cfg, _kind_cache(seed, nb), dev, seed, GRAPH_STEPS)
            if name == "c2_trf_32bar":
                # eager, then captured and replayed, then a replay
                gcfg = cfg.replace(gen=GenSpec(num_bars=nb,
                                               num_samples=GEN_SAMPLES))
                sweep = sampler.make_generate_fn(gcfg, model)
                swept = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    bars = sweep(sampler.seed_generator(seed, dev))
                    torch.cuda.synchronize()
                    swept.append((time.perf_counter() - t0, bars))
                check(tuple(bars.shape) == (GEN_SAMPLES, nb, 96, 128),
                      f"{name}: swept {tuple(bars.shape)}")
                check(_graphs_captured(sweep) and all(
                    torch.equal(swept[0][1], b) for _, b in swept[1:]),
                      f"{name}: the sweep's graph differs from eager")
                res["sweep"] = {"samples": GEN_SAMPLES, "bars": nb,
                                "seconds": swept[0][0],
                                "seconds_graph": [t for t, _ in swept[1:]],
                                "graph_equals_eager": True,
                                "density": float(bars.float().mean())}
            res["seconds"] = time.perf_counter() - t_name
            log(f"patch_attn {name} ({card}): {res}")
            out[name] = res
            del model, state
            torch.cuda.empty_cache()

        rows = {"masked_bce_sum_dual": []}
        _bce_shape_rows(
            torch.Generator(dev).manual_seed(seed + 91), dev,
            torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev),
            lambda *a, **kw: _shape_row(rows, "patch_attn", card, *a, **kw),
            (("c2_{mxu,trf}_{16,32}bar train, [32,16,96,128]",
              (32, 16, 96, 128), ("masked_bce_sum_dual",)),))
        out["kernel_shapes"] = rows
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    log(f"patch_attn launches: {total}")
    log(f"patch_attn phase: {out['seconds']:.1f} s")
    return {"patch_attn": total}, out


PAR_STEPS = 20           # steps of each data-parallel run, in dispatches of
PAR_K = 5                # PAR_K
PAR_WORLD = 2            # gloo processes sharing the one card
PAR_MODES = ("resident", "host_sharded", "sharded")
PAR_FLAGS = {"resident": [], "host_sharded": ["--host-sharded"],
             "sharded": ["--corpus-layout", "sharded"]}
PAR_F32 = "c2_gru_4bar_f32"   # c2 in f32, registered by this script
PAR_WAIT_S = 600         # bound on the gloo workers
# two processes against one at the global batch, (loss, parameter
# checksum) relative: in f32 tests/test_torch_dp_train.py's tolerances
# (the order of the sums alone differs); in bf16 the rows of a 32-row
# batch also round otherwise than in a 64-row one (cuDNN and cuBLAS pick
# their algorithms by the batch), which 20 Adam steps carry on. Each
# bound must catch the fault ``_noise_control`` emulates, in this run
DP_RTOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-3, 1e-5)}


def _register_f32() -> None:
    """c2_gru_4bar in f32 under ``PAR_F32``, in this process's registry
    of configs, for the command line's ``--config``."""
    from musicvae_tpu_torch import config as config_lib

    base = config_lib.get_config("c2_gru_4bar")
    config_lib._CONFIGS[PAR_F32] = base.replace(
        name=PAR_F32, model=dataclasses.replace(base.model, dtype="float32"))


def _par_config(seed: int, dtype: str = "bfloat16", **train_kw):
    """Full-width c2_gru_4bar (bf16 unless ``dtype``, batch 64),
    PAR_STEPS steps logged every PAR_K, no eval."""
    from musicvae_tpu_torch.config import get_config

    base = get_config("c2_gru_4bar")
    kw = dict(num_steps=PAR_STEPS, log_every=PAR_K, eval_every=0,
              ckpt_every=0, seed=seed)
    return base.replace(
        model=dataclasses.replace(base.model, dtype=dtype),
        train=dataclasses.replace(base.train, **{**kw, **train_kw}))


def _par_argv(mode: str, dtype: str, root: str, run: str, rank: int):
    """The ``train`` command line of a data-parallel run: full-width c2
    (the registered config in bf16, ``PAR_F32`` in f32) on the cache
    <root>/c2.npz, PAR_STEPS steps logged every PAR_K, no eval, into
    <root>/ck_<run> (shared by the processes), logging into
    <root>/logs_<run>_<rank>."""
    return ["train", "--config",
            "c2_gru_4bar" if dtype == "bfloat16" else PAR_F32,
            "--data", os.path.join(root, "c2.npz"), "--steps", PAR_STEPS,
            "--log-every", PAR_K, "--eval-every", 0,
            "--ckpt-dir", os.path.join(root, f"ck_{run}"),
            "--log-dir", os.path.join(root, f"logs_{run}_{rank}"),
            *PAR_FLAGS[mode]]


def _cli_config(argv):
    """The config the ``train`` command line ``argv`` runs (fresh)."""
    from musicvae_tpu_torch import cli

    return cli.train_config(cli.make_parser().parse_args(
        [str(a) for a in argv]))


def _dp_runs():
    """(key, mode, dtype) of every two-process comparison."""
    return [(f"{mode}_{dt}", mode, dt) for dt in DP_RTOL
            for mode in PAR_MODES]


def _param_sum(state) -> float:
    return float(sum(p.detach().double().abs().sum().item()
                     for p in state.params))


def _timed_train(cfg, data, dev, **kw):
    """``train()`` with the host clock read at each log: (state, metrics,
    steps/s between the first and the last log, launches)."""
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer

    stamps = []
    _kernels.reset_launches()
    _, state, metrics = trainer.train(
        cfg, data, device=dev,
        log_fn=lambda s, m: stamps.append((s, time.perf_counter())), **kw)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    rate = None
    if len(stamps) > 1:
        rate = (stamps[-1][0] - stamps[0][0]) / (stamps[-1][1]
                                                 - stamps[0][1])
    return state, metrics, rate, launches


def _one_process_data(mode: str, ds, cfg):
    """What ``train()`` reads on one process at the global batch in
    ``mode``: the global batches the PAR_WORLD processes of that mode make
    between them (each host shard's stream, or each shard's rows of the
    sharded layout's ids, side by side)."""
    from musicvae_tpu_torch.train.sharded_corpus import (
        make_sharded_id_schedule)

    b, seed = cfg.train.batch_size, cfg.train.seed
    if mode == "host_sharded":
        its = [ds.host_shard(p, PAR_WORLD, seed=seed).iterator(
            b // PAR_WORLD, seed=seed, x_dtype=np.uint8)
            for p in range(PAR_WORLD)]

        def merged():
            while True:
                yield {"x": np.concatenate([next(i)["x"] for i in its])}

        return merged()
    if mode == "sharded":
        shards = [ds.host_shard(p, PAR_WORLD, seed=seed)
                  for p in range(PAR_WORLD)]
        ids = make_sharded_id_schedule(
            seed, np.array([len(s) for s in shards]), b)
        half = b // PAR_WORLD

        def drawn():
            step = 0
            while True:
                yield {"x": np.concatenate([
                    s.batch(ids(step)[p * half:(p + 1) * half],
                            np.uint8)["x"] for p, s in enumerate(shards)])}
                step += 1

        return drawn()
    return ds


def _cli_train_run(argv, dev) -> dict:
    """``train`` through the command line in this process: the step and
    parameter checksum of the checkpoint it left, the final loss it
    printed, steps/s from its metrics log (process 0's; between the first
    and the last log) and the launches it made."""
    import ast

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.train import trainer

    args = [str(a) for a in argv]
    _kernels.reset_launches()
    rc, o, e = _cli(args)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(rc == 0 and "final metrics: " in o,
          f"{' '.join(args)}: rc {rc}, {e[-2000:]}")
    final = ast.literal_eval(
        o[o.rindex("final metrics: ") + len("final metrics: "):]
        .splitlines()[0])
    manager = ckpt_io.make_manager(args[args.index("--ckpt-dir") + 1])
    _, state = trainer.create_state(ckpt_io.restore_config(manager),
                                    device=dev)
    state, _ = ckpt_io.restore(manager, state)
    log = os.path.join(args[args.index("--log-dir") + 1], "metrics.jsonl")
    rate = None
    if os.path.exists(log):
        with open(log) as f:
            sps = [json.loads(ln)["steps_per_sec"] for ln in f][1:]
        rate = len(sps) / sum(1.0 / r for r in sps) if sps else None
    out = {"step": int(state.step), "loss": float(final["loss"]),
           "param_sum": _param_sum(state), "steps_per_s": rate,
           "logged": os.path.exists(log), "launches": launches,
           "resumed": "resumed from step" in e}
    del state
    return out


def dp_worker(argv) -> int:
    """One of the PAR_WORLD gloo processes of the parallel phase (run as
    ``chip_smoke.py --dp-worker RANK WORLD HOST:PORT DIR``). It joins the
    group over gloo (the processes share the one card, where NCCL refuses
    two ranks; the command's own join then does nothing) and runs
    ``train`` through the command line for each of ``_dp_runs``; then a
    stop asked of process 1 alone, through ``train()``, and
    ``train --resume`` from the step that stop saved, to the end of the
    run. One JSON line."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.parallel import distributed

    rank, world, coord, work = (int(argv[0]), int(argv[1]), argv[2],
                                argv[3])
    os.environ.update(MVAE_COORDINATOR=coord, MVAE_NUM_PROCS=str(world),
                      MVAE_PROC_ID=str(rank))
    dev = torch.device("cuda", 0)
    check(distributed.initialize_from_env(device=dev, backend="gloo"),
          "no group")
    _register_f32()
    out = {}
    for key, mode, dtype in _dp_runs():
        out[key] = _cli_train_run(_par_argv(mode, dtype, work, key, rank),
                                  dev)

    class Stop:
        requested = rank == 1

    argv_pre = _par_argv("resident", "bfloat16", work, "preempt", rank)
    manager = ckpt_io.make_manager(os.path.join(work, "ck_preempt"))
    state, metrics, _, launches = _timed_train(
        _cli_config(argv_pre),
        PianoRollDataset.load_npy(os.path.join(work, "c2.npz")), dev,
        ckpt_manager=manager, stop=Stop())
    manager.wait_until_finished()
    torch.distributed.barrier()
    manager.reload()
    out["preempt"] = {"step": int(state.step), "launches": launches,
                      "saved_steps": manager.all_steps(),
                      "loss": float(metrics["loss"])}
    del state
    out["resume"] = _cli_train_run(argv_pre + ["--resume"], dev)
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "modes": out}), flush=True)
    return 0


def _noise_control(dev, ds, root: str) -> dict:
    """The fault the two-process comparison must catch, read on one
    process: every process drawing the noise of only its own B/P rows
    from its generator, seeded alike, so that each process's rows get the
    first B/P rows of the global draw. Emulated at the global batch with
    the noise handed in, PAR_STEPS steps of the resident config from one
    seed: the global draw against its first B/P rows repeated. Its
    distance from the sound run (relative, loss and parameter checksum)
    must exceed ``DP_RTOL`` in each dtype."""
    from musicvae_tpu_torch.models.vae import draw_eps
    from musicvae_tpu_torch.train import trainer

    out = {}
    for dtype, rtol in DP_RTOL.items():
        cfg = _cli_config(_par_argv("resident", dtype, root, "control", 0))
        b = cfg.train.batch_size
        ids = trainer.make_id_schedule(cfg.train.seed, len(ds), b)
        gen = torch.Generator(dev).manual_seed(cfg.train.seed + 1)
        eps = [draw_eps(cfg.model, b, gen) for _ in range(PAR_STEPS)]
        res = {}
        for what in ("global", "per_process"):
            _, state = trainer.create_state(cfg, device=dev)
            step = trainer.make_train_step(cfg, state.model)
            with trainer.deterministic_algorithms():
                for j in range(PAR_STEPS):
                    e = eps[j]
                    if what == "per_process":
                        e = tuple(torch.cat([x[:b // PAR_WORLD]] * PAR_WORLD)
                                  for x in e)
                    x = torch.from_numpy(ds.batch(ids(j), x_dtype=np.uint8)
                                         ["x"]).to(dev)
                    _, m = step(state, {"x": x}, e)
            res[what] = (float(m["loss"]), _param_sum(state))
            del state, step
        (lg, sg), (lp, sp) = res["global"], res["per_process"]
        out[dtype] = {"loss_rel_diff": abs(lp - lg) / abs(lg),
                      "param_sum_rel_diff": abs(sp - sg) / sg,
                      "rtol": rtol}
        out[dtype]["caught"] = (out[dtype]["loss_rel_diff"] > rtol[0]
                                or out[dtype]["param_sum_rel_diff"]
                                > rtol[1])
    return out


def _stream_checks(seed: int, dev, ds, card: str) -> dict:
    """(a) K streamed steps equal K single steps bit for bit; the upload
    of one K-stack timed on its side stream beside its host cost."""
    from musicvae_tpu_torch.train import trainer

    cfg = _par_config(seed)
    b = cfg.train.batch_size
    ids = trainer.make_id_schedule(seed, len(ds), b)
    host = [ds.batch(ids(j), x_dtype=np.uint8) for j in range(PAR_K)]
    stacked = trainer._stack_host_batches(host, cond=False)
    uploader = trainer._StackUploader(dev)
    _, state_a = trainer.create_state(cfg, device=dev, seed=seed)
    _, state_b = trainer.create_state(cfg, device=dev, seed=seed)
    multi = trainer.make_train_step_multi(cfg, state_a.model, packed_x=True)
    single = trainer.make_train_step(cfg, state_b.model)
    with trainer.deterministic_algorithms():
        tensors, event = uploader.put(stacked)
        torch.cuda.current_stream(dev).wait_event(event)
        _, m_multi = multi(state_a, tensors)
        for h in host:
            _, m_single = single(state_b, {"x": torch.from_numpy(
                h["x"]).to(dev)})
    torch.cuda.synchronize()
    same = (all(torch.equal(x, y) for x, y in zip(_state_bits(state_a),
                                                   _state_bits(state_b)))
            and all(torch.equal(m_multi[k], m_single[k]) for k in m_single))
    log(f"parallel (a) {PAR_K} streamed steps vs {PAR_K} single steps: "
        f"same bits {same}")
    check(same, "streamed steps differ from single steps")
    # one K-stack's upload: the host's staging and enqueue, and the copy
    # on the side stream (events), repeated
    host_ms, copy_ms = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record(uploader.stream)
        t0 = time.perf_counter()
        _, event = uploader.put(stacked)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end = torch.cuda.Event(enable_timing=True)
        end.record(uploader.stream)
        end.synchronize()
        copy_ms.append(start.elapsed_time(end))
    nbytes = sum(v.nbytes for v in stacked.values())
    up = {"stack_bytes": nbytes, "k": PAR_K,
          "put_host_ms": host_ms[1:], "copy_stream_ms": copy_ms[1:]}
    log(f"parallel (a) upload of one packed {PAR_K}-stack ({nbytes} bytes, "
        f"{card}): {up}")
    del state_a, state_b
    return {"streamed_equals_single": same, "upload": up}


def _spec_of(cfg) -> dict:
    """The configuration groups of ``cfg`` as the benchmark's
    configuration files hold them (perfbench/)."""
    return {g: {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(getattr(cfg, g)).items()}
            for g in ("midi", "model", "train")}


def _nccl_world_one(seed: int, dev, ds) -> tuple:
    """(b) one NCCL process group of world size 1 joined through the
    MVAE_* variables: its run equals the run without a group, bit for
    bit, and so does the same run eager (``debug_mode``): the group's
    resident dispatch is captured once, its all-reduce inside, and its
    replays are the eager NCCL steps. The tracer's all-reduce bytes are
    PAR_STEPS buckets of the benchmark's count (perfbench/yardstick_dp.py)
    in both runs, and its ``dist.allreduce`` span is the graphed run's
    eager first step alone; K4 is counted once a step, replays
    included."""
    from musicvae_tpu_torch.parallel import distributed
    from musicvae_tpu_torch.utils import debug_mode, trace
    from perfbench import yardstick_dp

    cfg = _par_config(seed)
    base, m_base, _, _ = _timed_train(cfg, ds, dev)
    saved = {k: os.environ.get(k) for k in ("MVAE_COORDINATOR",
                                             "MVAE_NUM_PROCS",
                                             "MVAE_PROC_ID")}
    os.environ.update(MVAE_COORDINATOR=f"127.0.0.1:{_free_port()}",
                      MVAE_NUM_PROCS="1", MVAE_PROC_ID="0")
    try:
        check(distributed.initialize_from_env(device=dev), "no group")
        backend = torch.distributed.get_backend()
        check(backend == "nccl", f"backend {backend}")
        trace.reset()
        grp, m_grp, rate, launches = _timed_train(cfg, ds, dev)
        spans = {k: v[0] for k, v in trace.totals().items()}
        graphed_bytes = trace.counters().get("dist.allreduce_bytes")
        trace.reset()
        with debug_mode(nans=False, disable_jit=True):
            eager, m_eager, rate_e, launches_e = _timed_train(cfg, ds, dev)
        eager_spans = {k: v[0] for k, v in trace.totals().items()}
        eager_bytes = trace.counters().get("dist.allreduce_bytes")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def same(a, b, ma, mb):
        return (all(torch.equal(x, y) for x, y in zip(_state_bits(a),
                                                       _state_bits(b)))
                and all(torch.equal(ma[k], mb[k]) for k in ma))

    bucket = yardstick_dp.bucket_bytes(_spec_of(cfg))
    out = {"backend": backend, "same_bits": same(base, grp, m_base, m_grp),
           "graph_equals_eager": same(grp, eager, m_grp, m_eager),
           "loss": float(m_grp["loss"]), "captures": spans.get(
               "graph.capture", 0),
           "allreduce_spans": [spans.get("dist.allreduce", 0),
                               eager_spans.get("dist.allreduce", 0)],
           "allreduce_bytes": [graphed_bytes, eager_bytes],
           "bucket_bytes": bucket,
           "k4": [launches["masked_bce_sum_dual"],
                  launches_e["masked_bce_sum_dual"]],
           "steps_per_s": [rate, rate_e]}
    log(f"parallel (b) NCCL world 1: graphed vs no group, graphed vs "
        f"eager: {out}")
    check(out["same_bits"], "the NCCL world-1 run differs from the run "
                            "without one")
    check(out["graph_equals_eager"] and out["captures"] == 1,
          f"the NCCL world-1 run's graph and its eager run: {out}")
    check(out["allreduce_bytes"] == [PAR_STEPS * bucket] * 2
          and out["allreduce_spans"] == [1, PAR_STEPS]
          and out["k4"] == [PAR_STEPS] * 2,
          f"the NCCL world-1 run's counts: {out}")
    return launches, out


def _c1_bit_equality(seed: int, dev, card: str) -> dict:
    """(e) c2_trf and c3_trf on their untrained init weights: serial and
    --coalesce 4 serve the same bits, and a lone request (W=1) the bits
    it gets padded among others; then the same requests with every slot
    computed at once (``layers.per_slot`` bypassed, the arithmetic it
    replaced), for the req/s that running the batch-dependent ops a slot
    at a time costs."""
    from musicvae_tpu_torch import cli
    from musicvae_tpu_torch.config import GenSpec
    from musicvae_tpu_torch.models import layers
    from musicvae_tpu_torch.models.vae import build_model

    out = {}
    for name in PA_BIT_EQUAL:
        cfg = _kind_config(name, seed).replace(
            gen=GenSpec(num_bars=GEN_BARS, num_samples=GEN_SAMPLES))
        model = build_model(cfg, device=dev, seed=seed)
        real = layers.per_slot

        def at_once():
            layers.per_slot = lambda fn, slots, *xs: fn(*xs)
            try:
                return _kind_serve(name, cfg, model, dev, seed)
            finally:
                layers.per_slot = real

        res = _kind_serve(name, cfg, model, dev, seed)
        res["slots_at_once"] = at_once()
        runner = cli._CoalescedRunner(cli.Service(cfg, model), STACK_W)
        lone = runner.run([(cli.seed_generator(seed + 1, dev), None)])
        full = runner.run([(cli.seed_generator(seed + 1, dev), None),
                           (cli.seed_generator(seed + 2, dev), None)])
        res["lone_equals_full"] = bool(np.array_equal(lone[0], full[0]))
        log(f"parallel (e) {name} init weights, serial vs --coalesce "
            f"{STACK_W} ({card}): {res}")
        check(res["bits_equal"] and res["lone_equals_full"],
              f"{name}: coalesced bars differ from serial ones")
        out[name] = res
        del model, runner
        torch.cuda.empty_cache()
    return out


def parallel_phase(seed: int, dev: torch.device, card: str):
    """A13's data-parallel half on the card at full width (c2_gru_4bar,
    bf16, 64 x 4, the corpus cache of ``make_bar_cache``): (a) streaming:
    K streamed steps equal K single steps bit for bit, ``train --stream``
    through the CLI, and one K-stack's upload timed on its side stream;
    (b) an NCCL group
    of world size 1 through the MVAE_* variables, bit-equal to no group
    and, captured with its all-reduce inside, to its own eager run;
    (c) two processes sharing the card over gloo run ``train`` through
    the CLI, resident, host-sharded and sharded-corpus, in f32 and bf16,
    each against one process at the global batch (``DP_RTOL``, which must
    catch ``_noise_control``'s fault); (d) a stop asked of one process
    stops both at one step, saved once, and ``train --resume`` on both
    continues it to the uninterrupted run's bits; (e) C.1's
    check: c2_trf and c3_trf serve the same bits serial and coalesced.
    K4 is held against its plain version at the per-process shape."""
    import shutil
    import tempfile

    from musicvae_tpu_torch.ops import _kernels

    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="parallel_smoke_",
                            dir=_kernels.BUILD_ROOT.parent)
    out, runs = {"card": card}, {}
    t_phase = time.perf_counter()
    ds = make_bar_cache(seed)
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    try:
        out["stream"] = _stream_checks(seed, dev, ds, card)
        cache = os.path.join(root, "c2.npz")
        ds.save_npy(cache)
        _kernels.reset_launches()
        rc, o, e = _cli(["train", "--data", cache, "--stream", "--steps",
                         PAR_STEPS, "--log-every", PAR_K, "--eval-every", 0,
                         "--ckpt-dir", os.path.join(root, "ck_stream"),
                         "--log-dir", os.path.join(root, "logs")])
        torch.cuda.synchronize()
        runs["parallel_stream"] = dict(_kernels.LAUNCHES)
        check(rc == 0 and "final metrics" in o,
              f"train --stream: rc {rc}, {e[-2000:]}")
        out["stream"]["cli"] = {"rc": rc, "final": o.strip()[-300:]}
        log(f"parallel (a) train --stream: {o.strip()[-300:]}, launches "
            f"{runs['parallel_stream']}")
        # streamed against resident steps/s, and the producer's time a
        # stack against a dispatch's: the train phase

        # (c), (d): the two gloo processes, with the card and the host to
        # themselves while they run (their steps/s are timed)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker",
             str(r), str(PAR_WORLD), coord, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={"GLOO_SOCKET_IFNAME": "lo",
                 **{k: v for k, v in os.environ.items()
                    if not k.startswith("MVAE_")}})
            for r in range(PAR_WORLD)]
        results = []
        for p in procs:
            o, e = p.communicate(timeout=PAR_WAIT_S)
            check(p.returncode == 0, f"dp worker: {e.decode()[-3000:]}")
            lines = [ln for ln in o.decode().splitlines()
                     if ln.startswith("{")]
            check(bool(lines), f"dp worker printed nothing: {o[-2000:]}")
            results.append(json.loads(lines[-1])["modes"])

        runs["parallel_nccl1"], out["nccl_world1"] = _nccl_world_one(
            seed, dev, ds)

        _register_f32()
        one = {}
        for key, mode, dtype in _dp_runs():
            cfg = _cli_config(_par_argv(mode, dtype, root, key, 0))
            state, m, rate, _ = _timed_train(
                cfg, _one_process_data(mode, ds, cfg), dev)
            one[key] = {"step": int(state.step), "loss": float(m["loss"]),
                        "param_sum": _param_sum(state),
                        "steps_per_s": rate}
            del state
        out["noise_control"] = _noise_control(dev, ds, root)
        log(f"parallel (c) control, per-process noise against the global "
            f"draw, one process ({card}): {out['noise_control']}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    failed = []       # (c)'s disagreements, checked after (d) and (e)
    try:
        dp = {}
        for key, mode, dtype in _dp_runs():
            two, ref = [r[key] for r in results], one[key]
            res = {"one_process": ref, "rank0": two[0], "rank1": two[1],
                   "loss_rel_diff": abs(two[0]["loss"] - ref["loss"])
                   / abs(ref["loss"]),
                   "param_sum_rel_diff": abs(two[0]["param_sum"]
                                             - ref["param_sum"])
                   / ref["param_sum"], "rtol": DP_RTOL[dtype]}
            log(f"parallel (c) {key}, 2 gloo processes vs 1 ({card}): "
                f"{res}")
            if not (two[0]["loss"] == two[1]["loss"]
                    and two[0]["param_sum"] == two[1]["param_sum"]):
                failed.append(f"{key}: the two processes differ")
            if [r["logged"] for r in two] != [True, False]:
                failed.append(f"{key}: not process 0 alone logged")
            if not (two[0]["step"] == ref["step"] == PAR_STEPS
                    and res["loss_rel_diff"] <= DP_RTOL[dtype][0]
                    and res["param_sum_rel_diff"] <= DP_RTOL[dtype][1]):
                failed.append(f"{key}: two processes differ from one: "
                              f"{res}")
            runs[f"parallel_dp_{key}"] = {
                k: two[0]["launches"][k] + two[1]["launches"][k]
                for k in two[0]["launches"]}
            dp[key] = res
        pre = [r["preempt"] for r in results]
        log(f"parallel (d) a stop asked of process 1 only: {pre}")
        check(pre[0]["step"] == pre[1]["step"] == PAR_K
              and pre[0]["saved_steps"] == pre[1]["saved_steps"] == [PAR_K]
              and pre[0]["loss"] == pre[1]["loss"],
              f"the collective stop: {pre}")
        runs["parallel_dp_preempt"] = {
            k: pre[0]["launches"][k] + pre[1]["launches"][k]
            for k in pre[0]["launches"]}
        # train --resume on both processes from that step: the bits of
        # the uninterrupted run
        res = [r["resume"] for r in results]
        whole = [r["resident_bfloat16"] for r in results]
        log(f"parallel (d) train --resume from step {PAR_K} on both "
            f"processes: {[(r['step'], r['loss'], r['param_sum']) for r in res]}"
            f", uninterrupted {[(r['step'], r['loss'], r['param_sum']) for r in whole]}")
        check(all(r["resumed"] and (r["step"], r["loss"], r["param_sum"])
                  == (w["step"], w["loss"], w["param_sum"])
                  for r, w in zip(res, whole)),
              f"train --resume on two processes: {res} against {whole}")
        runs["parallel_dp_resume"] = {
            k: res[0]["launches"][k] + res[1]["launches"][k]
            for k in res[0]["launches"]}
        out["dp"], out["preempt"], out["resume"] = dp, pre, res
        for dtype, ctl in out["noise_control"].items():
            check(ctl["caught"], f"DP_RTOL[{dtype!r}] does not catch "
                                 f"per-process noise: {ctl}")
        out["c1"] = _c1_bit_equality(seed, dev, card)
        for path, n in runs.items():
            check(n["masked_bce_sum_dual"] > 0,
                  f"K4 not launched on {path}: {n}")
        rows = {"masked_bce_sum_dual": []}
        _bce_shape_rows(
            torch.Generator(dev).manual_seed(seed + 93), dev,
            torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev),
            lambda *a, **kw: _shape_row(rows, "parallel", card, *a, **kw),
            ((f"c2 one of {PAR_WORLD} processes, [32,4,96,128]",
              (32, 4, 96, 128), ("masked_bce_sum_dual",)),))
        out["kernel_shapes"] = rows
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not failed, "; ".join(failed))
    out["launches"] = runs
    out["seconds"] = time.perf_counter() - t_phase
    log(f"parallel launches: {runs}")
    log(f"parallel phase: {out['seconds']:.1f} s")
    return runs, out


DP4_WORLD = 4            # processes, one a card, over NCCL
DP4_K = 10               # steps a dispatch
DP4_TIMED = 5            # timed dispatches each way, after two
DP4_WAIT_S = 600         # bound on the workers


def _dp4_config(seed: int):
    """The registered c4_cond (bf16, the first-conv kernels on) at its
    deployment's 32 rows a process, a global batch of 32 a process."""
    from musicvae_tpu_torch.config import get_config

    base = get_config("c4_cond")
    return base.replace(
        model=dataclasses.replace(base.model, use_pallas_conv1=True),
        train=dataclasses.replace(base.train, batch_size=32 * DP4_WORLD,
                                  seed=seed))


def dp4_worker(argv) -> int:
    """One of the DP4_WORLD processes of the dp4 phase (run as
    ``chip_smoke.py --dp4-worker RANK WORLD HOST:PORT SEED``), on card
    RANK: joins NCCL through the MVAE_* variables and runs the resident
    dispatch of full-width c4_cond at 32 rows, 2 + DP4_TIMED dispatches
    of DP4_K steps graphed, then the same from the same state eager
    (``debug_mode``): the second dispatch of each under torch.profiler
    (graph launches, NCCL and K4 kernels), the tracer's all-reduce bytes
    and spans over the first two, steps/s over the rest; the two runs'
    bits (every tensor of the state and the generator's state) compared,
    and each run's largest parameter gap to rank 0. One JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from musicvae_tpu_torch.parallel import distributed, make_mesh
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import debug_mode, trace
    from perfbench import yardstick_dp

    rank, world, coord, seed = (int(argv[0]), int(argv[1]), argv[2],
                                int(argv[3]))
    os.environ.update(MVAE_COORDINATOR=coord, MVAE_NUM_PROCS=str(world),
                      MVAE_PROC_ID=str(rank))
    dev = torch.device("cuda", rank)
    check(distributed.initialize_from_env(device=dev), "no group")
    check(torch.distributed.get_backend() == "nccl",
          f"backend {torch.distributed.get_backend()}")
    init_s = trace.totals()["dist.init"][1]
    cfg = _dp4_config(seed)
    ds = make_bar_cache(seed, pieces=64, bars_per_piece=16)
    rng = np.random.default_rng(seed + 1)
    ds.chords = rng.integers(0, 24, len(ds)).astype(np.int32)
    ds.keys = rng.integers(0, 24, len(ds)).astype(np.int32)
    mesh = make_mesh(cfg.mesh, dev)
    b = cfg.train.batch_size
    rows = mesh.rows(b)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("bars", ds.bars), ("starts", ds.starts),
                         ("chords", ds.chords), ("keys", ds.keys))}
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds), b)

    def idxs(d):
        return torch.from_numpy(np.stack(
            [ids(d * DP4_K + j)[rows] for j in range(DP4_K)])).to(dev)

    def replica_gap(state):
        flat = torch.cat([p.detach().reshape(-1) for p in state.params])
        first = flat.clone()
        torch.distributed.broadcast(first, src=0)
        gap = (flat - first).abs().max().reshape(1)
        torch.distributed.all_reduce(gap, op=torch.distributed.ReduceOp.MAX)
        return float(gap)

    out, states = {"rank": rank, "init_s": init_s}, {}
    for graph in (True, False):
        model, state = trainer.create_state(cfg, device=dev, seed=seed)
        multi = trainer.make_train_step_indexed_multi(cfg, model, mesh=mesh)
        res = {}
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(trainer.deterministic_algorithms())
            if not graph:
                ctx.enter_context(debug_mode(nans=False, disable_jit=True))
            trace.reset()
            multi(state, data, idxs(0))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                multi(state, data, idxs(1))
                torch.cuda.synchronize()
            events = prof.key_averages()
            calls = {e.key: e.count for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.key.startswith("cuda")}
            device = {e.key: (e.count, e.device_time_total) for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.device_time_total > 0}
            nccl = {k: v for k, v in device.items() if "nccl" in k.lower()}
            res.update(
                graph_launches=_runtime_calls(calls, "cudaGraphLaunch"),
                nccl_kernels=sum(n for n, _ in nccl.values()),
                nccl_ms_per_step=sum(t for _, t in nccl.values())
                / 1e3 / DP4_K, nccl_names=sorted(nccl),
                k4_kernels=sum(n for k, (n, _) in device.items()
                               if "bce_sum<" in k),
                kernel_ms_per_step=sum(t for _, t in device.values())
                / 1e3 / DP4_K,
                allreduce_bytes=trace.counters().get("dist.allreduce_bytes"),
                allreduce_spans=trace.totals().get("dist.allreduce",
                                                   [0])[0],
                captures=trace.totals().get("graph.capture", [0])[0])
            t0 = time.perf_counter()
            for d in range(2, 2 + DP4_TIMED):
                _, m = multi(state, data, idxs(d))
            res["loss"] = float(m["loss"])
            res["steps_per_s"] = DP4_TIMED * DP4_K / (time.perf_counter()
                                                      - t0)
        res["replica_gap"] = replica_gap(state)
        res["graphed"] = all(p.program.graph is not None
                             for p in multi.programs.values())
        out["graph" if graph else "eager"] = res
        states[graph] = state
    a, e = states[True], states[False]
    out["same_bits"] = (
        all(torch.equal(x, y) for x, y in zip(_state_bits(a), _state_bits(e)))
        and torch.equal(a.generator.get_state(), e.generator.get_state()))
    out["bucket_bytes"] = yardstick_dp.bucket_bytes(_spec_of(cfg))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def dp4_phase(seed: int, card: str) -> dict:
    """Data parallelism across four cards (not in the full run: it needs a
    host of four): DP4_WORLD processes of ``dp4_worker``, one a card, over
    NCCL; on every rank the graphed dispatch equals the eager one bit for
    bit, the replicas equal rank 0 in both, a steady dispatch is DP4_K
    ``cudaGraphLaunch`` (none eager) with the NCCL all-reduce kernel in
    every step and K4 once a step, the all-reduce bytes are the
    benchmark's bucket a step (one ``dist.allreduce`` span graphed, the
    warm-up's; one a step eager). Each rank's output, NCCL's INFO lines
    among it, goes to dp4_rank<r>.log beside ``--log-file``."""
    check(torch.cuda.device_count() >= DP4_WORLD,
          f"dp4 needs {DP4_WORLD} cards, {torch.cuda.device_count()} "
          f"present")
    t_phase = time.perf_counter()
    where = os.path.dirname(os.path.abspath(LOG_FILE)) if LOG_FILE else "."
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MVAE_")}
    env.update(NCCL_DEBUG="INFO", NCCL_SOCKET_IFNAME="lo")
    logs = [os.path.join(where, f"dp4_rank{r}.log") for r in range(DP4_WORLD)]
    procs = []
    try:
        for r in range(DP4_WORLD):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dp4-worker", str(r), str(DP4_WORLD), coord,
                     str(seed)], stdout=f, stderr=subprocess.STDOUT,
                    env=env))
        for r, p in enumerate(procs):
            p.wait(timeout=DP4_WAIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    results = []
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            text = f.read()
        check(p.returncode == 0, f"dp4 rank {r}: {text[-3000:]}")
        results.append(json.loads([ln for ln in text.splitlines()
                                   if ln.startswith('{"rank"')][-1]))
    for res in results:
        log(f"dp4 rank {res['rank']} ({card}): {res}")
        g, e, bucket = res["graph"], res["eager"], res["bucket_bytes"]
        check(res["same_bits"] and g["graphed"] and not e["graphed"],
              f"rank {res['rank']}: graphed and eager differ")
        check(g["replica_gap"] == 0.0 and e["replica_gap"] == 0.0,
              f"rank {res['rank']}: replicas differ from rank 0")
        check(g["graph_launches"] == DP4_K and e["graph_launches"] == 0
              and g["nccl_kernels"] >= DP4_K and e["nccl_kernels"] >= DP4_K
              and g["k4_kernels"] == e["k4_kernels"] == DP4_K,
              f"rank {res['rank']}: a dispatch's launches")
        check(g["allreduce_bytes"] == e["allreduce_bytes"]
              == 2 * DP4_K * bucket and g["allreduce_spans"] == 1
              and e["allreduce_spans"] == 2 * DP4_K and g["captures"] == 1,
              f"rank {res['rank']}: the tracer's all-reduce counts")
    out = {"ranks": results, "seconds": time.perf_counter() - t_phase}
    log(f"dp4 phase: {out['seconds']:.1f} s; steps/s graphed "
        f"{[r['graph']['steps_per_s'] for r in results]}, eager "
        f"{[r['eager']['steps_per_s'] for r in results]}")
    return out


TP_K = 5                 # steps a dispatch, the first dispatch a warm-up
TP_MODEL = 2             # the model axis of every run: 2 processes a group
TP_WAIT_S = 600          # bound on the gloo workers
# (key, processes, dtype, first-conv kernels, model axis, steps, control)
# of each run on gloo processes sharing the card. One launch of 4 runs the
# 4-process runs, then processes 0 and 1 join a group of 2 for the rest,
# so that the start-up and the warm-up are paid once. Model 1 is plain
# data parallelism at the same world, for steps/s; the control drops the
# column-parallel backward's dx all-reduce. The runs that are printed
# (bf16), timed (data=2) or must miss (the control) take 10 steps.
TP_RUNS = (("tp_dp_f32", 4, "float32", False, TP_MODEL, 20, False),
           ("tp_f32", 2, "float32", False, TP_MODEL, 20, False),
           ("tp_bf16", 2, "bfloat16", False, TP_MODEL, 10, False),
           ("tp_conv1_f32", 2, "float32", True, TP_MODEL, 20, False),
           ("control_f32", 2, "float32", False, TP_MODEL, 10, True),
           ("dp_f32", 2, "float32", False, 1, 10, False))
TP_WORLDS = (4, 2)
TP_SAVED = "tp_conv1_f32"    # the run whose state is saved and served


def _tp_config(seed: int, dtype: str, conv1: bool, steps: int):
    """Full-width c2_gru_4bar (batch 64) in ``dtype``, the first-conv
    kernels on when ``conv1``, ``steps`` steps from ``seed``, EMA kept
    (its copies are sharded too)."""
    from musicvae_tpu_torch.config import get_config

    base = get_config("c2_gru_4bar")
    return base.replace(
        model=dataclasses.replace(base.model, dtype=dtype,
                                  use_pallas_conv1=conv1),
        train=dataclasses.replace(base.train, num_steps=steps, seed=seed,
                                  ema_decay=0.999))


@contextlib.contextmanager
def _without_dx_all_reduce():
    """The column-parallel backward with its input gradient left unreduced
    on each rank (``parallel.tp._ReduceGrad``'s backward swapped for the
    identity): the control run the f32 bound must catch."""
    from musicvae_tpu_torch.parallel import tp as tp_lib

    saved = tp_lib._ReduceGrad.backward
    tp_lib._ReduceGrad.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        tp_lib._ReduceGrad.backward = saved


def _count_collectives():
    """Wrap torch.distributed's all_gather and all_reduce with counters of
    calls and bytes; returns (counts dict, restore function)."""
    import torch.distributed as dist

    counts = {"all_gather": 0, "all_reduce": 0, "bytes": 0}
    saved = dist.all_gather, dist.all_reduce

    def gather(parts, t, *a, **kw):
        counts["all_gather"] += 1
        counts["bytes"] += t.numel() * t.element_size() * len(parts)
        return saved[0](parts, t, *a, **kw)

    def reduce(t, *a, **kw):
        counts["all_reduce"] += 1
        counts["bytes"] += t.numel() * t.element_size()
        return saved[1](t, *a, **kw)

    dist.all_gather, dist.all_reduce = gather, reduce

    def restore():
        dist.all_gather, dist.all_reduce = saved

    return counts, restore


def _tp_train(cfg, ds, dev, mesh=None, ckpt_dir=None) -> dict:
    """The config's steps of ``make_train_step_indexed_multi`` on the resident
    cache, in dispatches of TP_K, on one process (``mesh`` None) or on
    this process's rows under ``mesh``, sharded by ``shard_params`` when
    it has a model axis. Returns the loss, the checksum of the unsharded
    parameters, steps/s by host clock after the first dispatch (and the
    seconds of the set-up and of each dispatch), the launches, this
    process's state bytes and, for a group, the collectives and bytes of
    one steady dispatch a step."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.parallel import tp as tp_lib
    from musicvae_tpu_torch.train import trainer

    t0 = time.perf_counter()
    _, state = trainer.create_state(cfg, device=dev)
    if mesh is not None:
        tp_lib.shard_params(state, mesh)
    b, steps = cfg.train.batch_size, cfg.train.num_steps
    rows = slice(None) if mesh is None else mesh.rows(b)
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds), b)
    data = {"bars": torch.from_numpy(ds.bars).to(dev),
            "starts": torch.from_numpy(ds.starts).to(dev)}
    multi = trainer.make_train_step_indexed_multi(cfg, state.model,
                                                  mesh=mesh)
    collectives = None
    _kernels.reset_launches()
    stamps = [time.perf_counter()]
    with trainer.deterministic_algorithms():
        for step in range(0, steps, TP_K):
            idxs = torch.from_numpy(np.stack(
                [ids(step + j)[rows] for j in range(TP_K)])).to(dev)
            count = mesh is not None and mesh.processes > 1 and step == TP_K
            if count:
                counts, restore = _count_collectives()
            try:
                _, metrics = multi(state, data, idxs)
                loss = float(metrics["loss"])
            finally:
                if count:
                    restore()
                    collectives = {k: v / TP_K for k, v in counts.items()}
            stamps.append(time.perf_counter())
    launches = dict(_kernels.LAUNCHES)
    sd = state.state_dict()            # unsharded: gathered when sharded
    out = {"loss": loss, "step": int(state.step),
           "param_sum": float(sum(p.double().abs().sum().item()
                                  for p in sd["params"].values())),
           "ema_sum": float(sum(p.double().abs().sum().item()
                                for p in sd["ema"].values())),
           "steps_per_s": TP_K * (len(stamps) - 2) / (stamps[-1]
                                                      - stamps[1]),
           "setup_s": stamps[0] - t0,
           "dispatch_s": np.diff(stamps).tolist(),
           "launches": launches, "bytes": tp_lib.state_bytes(state),
           "collectives_per_step": collectives,
           "first_conv_channels":
               state.model.enc_feat.convs[0].weight.shape[0],
           "sharded": state.tp is not None}
    if ckpt_dir is not None:
        manager = ckpt_io.make_manager(ckpt_dir)
        ckpt_io.save(manager, state, cfg, wait=True)
    return out


def tp_worker(argv) -> int:
    """One of the gloo processes of the tp phase (run as ``chip_smoke.py
    --tp-worker RANK HOST:PORT HOST:PORT DIR``). For each world of
    TP_WORLDS that holds its rank it joins a group of that world at the
    next address, over gloo (the processes share the one card, where NCCL
    refuses two ranks), runs that world's TP_RUNS on the cache
    <DIR>/c2.npz and leaves the group; the ``TP_SAVED`` run saves its
    state into <DIR>/ck_tp. One JSON line: the runs and the wall-clock
    stamps of entry and of each join."""
    from musicvae_tpu_torch.config import MeshSpec
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.parallel import distributed, make_mesh

    stamps = {"entered": time.time()}
    rank, coords, work = int(argv[0]), argv[1:3], argv[3]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    seed = int(os.environ.get("MVAE_TP_SEED", "0"))
    ds = PianoRollDataset.load_npy(os.path.join(work, "c2.npz"))
    out = {}
    for world, coord in zip(TP_WORLDS, coords):
        if rank >= world:
            break
        check(distributed.initialize_from_env(coord, world, rank, device=dev,
                                              backend="gloo"), "no group")
        stamps[f"joined_{world}"] = time.time()
        for key, procs, dtype, conv1, model, steps, control in TP_RUNS:
            if procs != world:
                continue
            t0 = time.perf_counter()
            mesh = make_mesh(MeshSpec(model=model), dev)
            with (_without_dx_all_reduce() if control
                  else contextlib.nullcontext()):
                out[key] = _tp_train(
                    _tp_config(seed, dtype, conv1, steps), ds, dev, mesh,
                    os.path.join(work, "ck_tp") if key == TP_SAVED else None)
            out[key]["mesh"] = [mesh.data, mesh.model]
            out[key]["seconds"] = time.perf_counter() - t0
        torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "runs": out, "stamps": stamps}),
          flush=True)
    return 0


def _tp_launch(root: str, seed: int):
    """max(TP_WORLDS) tp workers sharing the card: (each one's JSON line
    by rank, the launch's wall-clock time)."""
    coords = []
    while len(coords) < len(TP_WORLDS):
        c = f"127.0.0.1:{_free_port()}"
        if c not in coords:
            coords.append(c)
    env = {"GLOO_SOCKET_IFNAME": "lo", "MVAE_TP_SEED": str(seed),
           **{k: v for k, v in os.environ.items()
              if not k.startswith("MVAE_")}}
    t_launch = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         *coords, root], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env) for r in range(max(TP_WORLDS))]
    results = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TP_WAIT_S)
            check(p.returncode == 0, f"tp worker: {e.decode()[-3000:]}")
            lines = [ln for ln in o.decode().splitlines()
                     if ln.startswith("{")]
            check(bool(lines), f"tp worker printed nothing: {o[-2000:]}")
            results.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return results, t_launch


def _column_hook_cost(seed: int, ds, dev: torch.device, steps: int = 10):
    """What the column-parallel hooks of models/layers.py cost a model
    that is not sharded: the calls of ``column_in``, ``column_out`` and
    ``shard_of`` a step of one process (counted over ``steps`` f32 steps
    of ``_tp_train``, run eagerly: a replayed graph runs no Python, so
    the hooks cost a graphed step nothing), the host time of one call on
    a replicated layer (100,000 calls, less an empty call's time), and
    their product a step beside that eager run's host time a step."""
    import timeit

    from musicvae_tpu_torch.models import layers
    from musicvae_tpu_torch.utils import debug_mode

    names = ("column_in", "column_out", "shard_of")
    saved = {n: getattr(layers, n) for n in names}
    counts = dict.fromkeys(names, 0)

    def counting(n):
        def call(*args):
            counts[n] += 1
            return saved[n](*args)
        return call

    for n in names:
        setattr(layers, n, counting(n))
    try:
        with debug_mode(nans=False, disable_jit=True):
            run = _tp_train(_tp_config(seed, "float32", False, steps), ds,
                            dev)
    finally:
        for n in names:
            setattr(layers, n, saved[n])
    dense, x = layers.Dense(4, 4), torch.zeros(4, device=dev)
    reps = 100_000
    empty = timeit.timeit(lambda: x, number=reps) / reps
    args = {"column_in": (x, dense), "column_out": (x, -1, dense),
            "shard_of": (dense,)}
    call_ns = {n: 1e9 * (timeit.timeit(lambda: saved[n](*args[n]),
                                       number=reps) / reps - empty)
               for n in names}
    per_step = {n: counts[n] / steps for n in names}
    hooks_us = sum(per_step[n] * call_ns[n] for n in names) / 1e3
    host_us = 1e6 / run["steps_per_s"]
    return {"calls_per_step": per_step, "call_ns": call_ns,
            "hooks_us_per_step": hooks_us, "host_us_per_step": host_us,
            "share": hooks_us / host_us}


def _tp_kernel_shapes(seed: int, dev: torch.device, card: str) -> dict:
    """K1 and K1b at a TP rank's first-conv shard (M = 256 bars, C = 16 /
    TP_MODEL channels, f32 as the run) and K4 at a TP process's logits
    ([64,4,96,128], f32), each against its plain version, timed beside
    its bound, its plain version and one library call."""
    g = torch.Generator(dev).manual_seed(seed + 95)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {"first_conv_s2": [], "first_conv_s2_bwd": [],
            "masked_bce_sum_dual": []}

    def row(*args, **extra):
        _shape_row(rows, "tp", card, *args, **extra)

    c = 16 // TP_MODEL
    _conv1_shape_rows(g, dev, flush, row, c, (
        (f"TP rank, M=256, C={c}, f32", 256, torch.float32),))
    _bce_shape_rows(g, dev, flush, row, (
        ("a TP process, [64,4,96,128]", (64, 4, 96, 128),
         ("masked_bce_sum_dual",)),))
    return rows


def tp_phase(seed: int, dev: torch.device, card: str):
    """A16 on the card: full-width c2_gru_4bar (batch 64 x 4, the seeded
    bar cache resident), 20 steps (10 for the runs that are printed, only
    timed, or the control) of ``make_train_step_indexed_multi`` a run,
    sharded by ``shard_params`` over gloo processes sharing the card, all
    from one launch (TP_RUNS): (a) data=1 x model=2 in f32 and
    bf16 against one process at the same global batch and seed; (b) 4
    processes, data=2 x model=2, f32; (c) (a) in f32 with the first-conv
    kernels, K1/K1b at C = 8 a rank, held against their plain versions at
    that width. f32 is held to the data-parallel bound (loss 1e-5 relative,
    parameter checksum 1e-6), which the control (the dx all-reduce
    dropped) must read outside; bf16 is printed. Each rank's parameter
    and Adam bytes against one process; steps/s at model=2, data=2 and
    one process; collectives a step; (c)'s state saved unsharded,
    restored into one process and served once (K1 every bar)."""
    import shutil
    import tempfile

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.ops import _kernels
    from musicvae_tpu_torch.parallel import tp as tp_lib
    from musicvae_tpu_torch.train import trainer

    _kernels.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="tp_smoke_",
                            dir=_kernels.BUILD_ROOT.parent)
    out, runs, failed = {"card": card}, {}, []
    t_phase = time.perf_counter()
    try:
        ds = make_bar_cache(seed)
        ds.save_npy(os.path.join(root, "c2.npz"))
        t0 = time.perf_counter()
        procs, t_launch = _tp_launch(root, seed)
        # seconds from the launch to each process's entry and joins, and
        # of each of its runs
        out["launch"] = {
            "seconds": time.perf_counter() - t0,
            "stamps_s": [{k: v - t_launch for k, v in p["stamps"].items()}
                         for p in procs],
            "run_s": {k: r["seconds"] for k, r in procs[0]["runs"].items()},
            "dispatch_s": {k: r["dispatch_s"]
                           for k, r in procs[0]["runs"].items()}}
        log(f"tp launch ({card}): {out['launch']}")
        one = {}
        for _, _, dtype, conv1, _, steps, _ in TP_RUNS:
            if (dtype, conv1, steps) not in one:
                one[(dtype, conv1, steps)] = _tp_train(
                    _tp_config(seed, dtype, conv1, steps), ds, dev)
        log(f"tp one process ({card}): "
            f"{ {'_'.join(map(str, k)): r for k, r in one.items()} }")
        out["column_hooks"] = _column_hook_cost(seed, ds, dev)
        log(f"tp column hooks on a replicated model ({card}): "
            f"{out['column_hooks']}")
        res = {}
        for key, world, dtype, conv1, model, steps, control in TP_RUNS:
            ranks = [p["runs"][key] for p in procs[:world]]
            ref = one[(dtype, conv1, steps)]
            r = {"world": world, "mesh": ranks[0]["mesh"],
                 "loss_rel_diff": abs(ranks[0]["loss"] - ref["loss"])
                 / abs(ref["loss"]),
                 "param_sum_rel_diff": abs(ranks[0]["param_sum"]
                                           - ref["param_sum"])
                 / ref["param_sum"],
                 "ema_sum_rel_diff": abs(ranks[0]["ema_sum"]
                                         - ref["ema_sum"])
                 / ref["ema_sum"],
                 "ranks_equal": all(
                     (q["loss"], q["param_sum"], q["ema_sum"])
                     == (ranks[0]["loss"], ranks[0]["param_sum"],
                         ranks[0]["ema_sum"]) for q in ranks),
                 "steps_per_s": [q["steps_per_s"] for q in ranks],
                 "one_process_steps_per_s": ref["steps_per_s"],
                 "bytes": [q["bytes"] for q in ranks],
                 "one_process_bytes": ref["bytes"],
                 "collectives_per_step":
                     ranks[0]["collectives_per_step"],
                 "first_conv_channels":
                     ranks[0]["first_conv_channels"]}
            loss_tol, sum_tol = DP_RTOL["float32"]
            within = (r["loss_rel_diff"] <= loss_tol
                      and r["param_sum_rel_diff"] <= sum_tol
                      and r["ema_sum_rel_diff"] <= sum_tol)
            r["within_f32_bound"] = within
            res[key] = r
            log(f"tp {key} ({card}): {r}")
            runs[key] = {k: sum(q["launches"][k] for q in ranks)
                         for k in ranks[0]["launches"]}
            # K4 once a step on every process; K1/K1b as often as on
            # one process, at C / model channels
            if not all(q["launches"]["masked_bce_sum_dual"] == steps
                       and q["step"] == steps for q in ranks):
                failed.append(f"{key}: K4 not once a step on every "
                              f"process: {[q['launches'] for q in ranks]}")
            if any(q["launches"][k] != ref["launches"][k] for q in ranks
                   for k in ("first_conv_s2", "first_conv_s2_bwd")):
                failed.append(f"{key}: first-conv launches differ from "
                              f"one process's")
            if conv1 and not (ref["launches"]["first_conv_s2"] > 0
                              and r["first_conv_channels"]
                              == 16 // model):
                failed.append(f"{key}: the first-conv kernels did not "
                              f"run on a {16 // model}-channel shard")
            if not r["ranks_equal"]:
                failed.append(f"{key}: the processes differ")
            if not ranks[0]["sharded"] == (model > 1):
                failed.append(f"{key}: sharded is {ranks[0]['sharded']}")
            if dtype == "float32" and within == control:
                failed.append(
                    f"{key}: {'inside' if control else 'outside'} the"
                    f" f32 bound: {r}")
        out["runs"] = res
        # (c)'s checkpoint: the unsharded file, restored into one process,
        # holds the parameters the processes gathered, and serves
        manager = ckpt_io.make_manager(os.path.join(root, "ck_tp"))
        cfg_s = ckpt_io.restore_config(manager)
        _, state = trainer.create_state(cfg_s, device=dev)
        state, _ = ckpt_io.restore(manager, state)
        restored = float(sum(p.detach().double().abs().sum().item()
                             for p in state.params))
        want = procs[0]["runs"][TP_SAVED]["param_sum"]
        out["restored"] = {"step": int(state.step), "param_sum": restored,
                           "gathered_param_sum": want,
                           "bytes": tp_lib.state_bytes(state)}
        del state
        saved_steps = next(r[5] for r in TP_RUNS if r[0] == TP_SAVED)
        check(out["restored"]["step"] == saved_steps and restored == want,
              f"TP checkpoint restored into one process: {out['restored']}")
        _kernels.reset_launches()
        rc, o, e = _cli(["serve", "--ckpt-dir", manager.directory,
                         "--use-pallas-conv1"], stdin='{"id": 1, "seed": 3}\n')
        runs["tp_serve"] = dict(_kernels.LAUNCHES)
        resp = json.loads(o.splitlines()[0]) if o else {}
        check(rc == 0 and len(resp.get("midi_b64", [])) == 4,
              f"serve of the TP checkpoint: rc {rc}, {o[:300]}: {e[-2000:]}")
        # the two warm-up sweeps (eager, then the captured graph's replay)
        # and the request's replay, 16 bars each
        check(runs["tp_serve"]["first_conv_s2"] == 48,
              f"serve of the TP checkpoint: launches {runs['tp_serve']}")
        out["restored"]["served_density"] = resp["density"]
        log(f"tp checkpoint restored and served ({card}): {out['restored']}")
        out["kernel_shapes"] = _tp_kernel_shapes(seed, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not failed, "; ".join(failed))
    out["launches"] = runs
    out["seconds"] = time.perf_counter() - t_phase
    log(f"tp launches: {runs}")
    log(f"tp phase: {out['seconds']:.1f} s")
    return runs, out


def profile_phase(seed: int, dev: torch.device):
    """Development aid, not part of the default run: where one train
    step's time goes. Which parts of a step the launch queue can hold
    behind a spin (a part that cannot makes the host wait on the card
    somewhere sync debug mode does not see), and torch.profiler's kernel
    table for a 5-step dispatch."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.train import trainer

    base = get_config("c2_gru_4bar")
    ds = make_bar_cache(seed, pieces=32)
    data_dev = {"bars": torch.from_numpy(ds.bars).to(dev),
                "starts": torch.from_numpy(ds.starts).to(dev)}
    ids = trainer.make_id_schedule(seed, len(ds), 64)
    idxs = torch.from_numpy(np.stack([ids(j) for j in range(TRAIN_K)])
                            ).to(dev)
    out = {}
    for name, conv1_kernels in (("stock_conv", False), ("conv1_kernels",
                                                         True)):
        cfg = base.replace(model=dataclasses.replace(
            base.model, use_pallas_conv1=conv1_kernels))
        model, state = trainer.create_state(cfg, device=dev)
        multi = trainer.make_train_step_indexed_multi(cfg, model)
        gather = trainer._make_window_gather(cfg)
        x = gather(data_dev, idxs[0])["x"]
        eps = torch.randn((64, 128), device=dev)
        with trainer.deterministic_algorithms():
            multi(state, data_dev, idxs)
            torch.cuda.synchronize()
            conv = model.enc_feat.convs[0]
            xb = x.reshape(256, 1, 96, 128).to(torch.bfloat16)

            def first_conv(grad):
                w = conv.weight.to(torch.bfloat16)
                y = F.conv2d(xb, w, conv.bias.to(torch.bfloat16), stride=2,
                             padding=1)
                if grad:
                    torch.autograd.grad(y.float().sum(), conv.weight)

            def fwd():
                with torch.no_grad():
                    model(x, eps)

            def fwd_bwd():
                logits, _ = model(x, eps)
                torch.autograd.grad(logits.sum(), list(model.parameters()))

            parts = {"first_conv_fwd": lambda: first_conv(False),
                     "first_conv_fwd_bwd": lambda: first_conv(True),
                     "model_fwd": fwd, "model_fwd_bwd": fwd_bwd,
                     "optimizer": lambda: state.opt.update(
                         [torch.zeros_like(p) for p in state.params])}
            held = {}
            for part, fn in parts.items():
                fn()
                torch.cuda.synchronize()
                held[part] = held_ms(fn, spin_cycles=150_000_000,
                                     strict=False)
            log(f"profile {name}: device ms of each part when the queue "
                f"held it behind the spin (None: it did not): {held}")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                multi(state, data_dev, idxs)
                torch.cuda.synchronize()
        events = prof.key_averages()
        rows = sorted(((e.key, e.count, e.device_time_total) for e in events
                       if e.device_time_total > 0 and e.device_type
                       == torch.autograd.DeviceType.CUDA),
                      key=lambda r: -r[2])
        total_us = sum(r[2] for r in rows)
        launches = sum(r[1] for r in rows)
        log(f"profile {name}: {launches / TRAIN_K:.0f} kernels a step, "
            f"{total_us / TRAIN_K / 1e3:.3f} ms of kernel time a step")
        for key, count, us in rows[:25]:
            log(f"  {us / TRAIN_K:9.1f} us/step {count / TRAIN_K:6.1f} "
                f"launches/step  {key[:110]}")
        out[name] = {"held_ms": held, "kernels_per_step": launches / TRAIN_K,
                     "kernel_ms_per_step": total_us / TRAIN_K / 1e3,
                     "top": rows[:25]}
    return out


# -- the conv epilogue -----------------------------------------------------------

EPI_CONFIGS = ("c2_gru_4bar", "c3_hier_16bar", "c2_mxu")
EPI_LAUNCHES = {"c2_gru_4bar": 12, "c3_hier_16bar": 12, "c2_mxu": 9}
# the head's last layer (ops/head_out.py), once a step each way; the patch
# head has none
HEAD_OUT_LAUNCHES = {"c2_gru_4bar": 1, "c3_hier_16bar": 1, "c2_mxu": 0}
_STEP_KERNELS = ("conv_epilogue", "conv_epilogue_bwd", "head_out_fwd",
                 "head_out_bwd")


def _step_launches(name: str) -> dict:
    """The epilogue's and the head's last layer's launches in one train
    step of config ``name`` (first-conv kernels on)."""
    epi, head = EPI_LAUNCHES[name], HEAD_OUT_LAUNCHES[name]
    return {"conv_epilogue": epi, "conv_epilogue_bwd": epi,
            "head_out_fwd": head, "head_out_bwd": head}


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| in bf16 ulps, elementwise (f32 tensors of bf16 values are
    compared as bf16: exact)."""
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _epilogue_layers(cfg, dev, seed: int):
    """One eager train step of ``cfg`` at its registered width on the card:
    the launches of the epilogue's and the head's last layer's kernels a
    step, the epilogue's plain versions' calls, and each ``conv_epilogue``
    call's (c shape, crop, gelu, out_dtype) with its count."""
    from musicvae_tpu_torch.models import layers
    from musicvae_tpu_torch.ops import _kernels, conv_epilogue as ce
    from musicvae_tpu_torch.train import trainer

    calls, plain = {}, {"fwd": 0, "bwd": 0}
    fn, ref, bwd_ref = (ce.conv_epilogue, ce.conv_epilogue_ref,
                        ce.conv_epilogue_bwd_ref)

    def recorded(c, b, crop=None, gelu=True, out_dtype=None):
        key = (tuple(c.shape), crop, gelu, out_dtype or c.dtype)
        calls[key] = calls.get(key, 0) + 1
        return fn(c, b, crop, gelu, out_dtype)

    def counted(kind, f):
        def wrapped(*a, **kw):
            plain[kind] += 1
            return f(*a, **kw)
        return wrapped

    model, state = trainer.create_state(cfg, device=dev, seed=seed)
    b, n = cfg.train.batch_size, cfg.model.num_bars
    g = torch.Generator(dev).manual_seed(seed + 11)
    x = (torch.rand((b, n, 96, 128), generator=g, device=dev)
         < 0.08).to(torch.uint8)
    step = trainer._train_step_body(cfg, model)
    ce.conv_epilogue = recorded
    ce.conv_epilogue_ref = counted("fwd", ref)
    ce.conv_epilogue_bwd_ref = counted("bwd", bwd_ref)
    try:
        with trainer.deterministic_algorithms():
            before = dict(_kernels.LAUNCHES)
            _, metrics = step(state, {"x": x})
            torch.cuda.synchronize()
    finally:
        ce.conv_epilogue = fn
        ce.conv_epilogue_ref, ce.conv_epilogue_bwd_ref = ref, bwd_ref
    launches = {k: _kernels.LAUNCHES[k] - before[k] for k in _STEP_KERNELS}
    check(bool(torch.isfinite(metrics["loss"])), f"{cfg.name}: loss not "
                                                 f"finite")
    del model, state, step, x
    return launches, plain, calls


def _epilogue_case(c, b, dy, crop, gelu, out_dtype) -> dict:
    """The kernels against the plain versions on one layer's inputs: the
    forward within 1 bf16 ulp (the share not bit-equal), dc within 1 ulp
    and zero on the cropped edge, db within 1 bf16 ulp of the reference
    plus 1e-5 of the channel's absolute sum of dc (the order of an f32 sum
    over ~10^6 terms)."""
    from musicvae_tpu_torch.ops import conv_epilogue as ce

    ho, wo = crop or tuple(c.shape[2:])
    y = ce._forward(c, b, crop, gelu, out_dtype)
    y_ref = ce.conv_epilogue_ref(c, b, crop, gelu, out_dtype)
    dc, db = ce._backward(c, b, dy, crop, gelu)
    dc_ref, db_ref = ce.conv_epilogue_bwd_ref(c, b, dy, crop, gelu)
    torch.cuda.synchronize()
    fwd_ulps = _bf16_ulps(y.float(), y_ref.float())
    dc_ulps = _bf16_ulps(dc.float(), dc_ref.float())
    edge = torch.cat([dc[:, :, ho:].flatten(), dc[:, :, :, wo:].flatten()])
    scale = dc_ref.float().abs().sum((0, 2, 3))
    db_err = (db.float() - db_ref.float()).abs()
    db_tol = db_ref.float().abs() * 2.0 ** -7 + 1e-5 * scale
    out = {"c": list(c.shape), "crop": [ho, wo], "gelu": gelu,
           "out": str(out_dtype).split(".")[-1],
           "fwd_max_ulp": int(fwd_ulps.max()),
           "fwd_not_bit_equal": float((fwd_ulps > 0).float().mean()),
           "dc_max_ulp": int(dc_ulps.max()),
           "dc_not_bit_equal": float((dc_ulps > 0).float().mean()),
           "edge_nonzero": int((edge != 0).sum()),
           "db_max_err_over_tol": float((db_err / db_tol).max()),
           "db_max_rel": float((db_err / db_ref.float().abs().clamp_min(
               1e-30)).max())}
    check(out["fwd_max_ulp"] <= 1, f"epilogue forward off by "
                                   f"{out['fwd_max_ulp']} ulp: {out}")
    check(out["dc_max_ulp"] <= 1, f"epilogue dc off by {out['dc_max_ulp']} "
                                  f"ulp: {out}")
    check(out["edge_nonzero"] == 0, f"epilogue dc not zero on the cropped "
                                    f"edge: {out}")
    check(out["db_max_err_over_tol"] <= 1.0, f"epilogue db outside its "
                                             f"tolerance: {out}")
    return out


def _epilogue_bytes(shape, crop, gelu, out_dtype, dt) -> tuple:
    """(forward, backward) bytes of one layer: each input byte read once
    and each output byte written once (forward: c over the kept grid, the
    bias, y; backward: dy, dc over the whole grid, db, and with the GELU c
    over the kept grid and the bias)."""
    n, ch, hc, wc = shape
    ho, wo = crop or (hc, wc)
    e, o = torch.finfo(dt).bits // 8, torch.finfo(out_dtype).bits // 8
    kept = n * ho * wo * ch
    full = n * hc * wc * ch
    return (kept * (e + o) + ch * e,
            kept * o + full * e + ch * e + (kept * e + ch * e if gelu else 0))


def epilogue_phase(seed: int, dev: torch.device, card: str):
    """The conv epilogue (ops/conv_epilogue.py, csrc/conv_epilogue.cu): one
    eager train step of c2_gru_4bar, c3_hier_16bar (first-conv kernels
    on) and c2_mxu at registered width launches the forward and backward
    kernels once for every conv and transposed conv of the pyramid but the
    head's last layer (12 + 12 for c2 and c3, and that layer's kernels 1 +
    1; 9 + 9 for c2_mxu) and never the plain versions;
    then each of those layers' shapes, on seeded inputs, against the plain
    versions (``_epilogue_case``), and timed from a cold L2 with their
    plain versions (ATen's chain itself) beside their byte bound, summed
    over a step."""
    import dataclasses

    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.ops import conv_epilogue as ce

    out = {"card": card}
    flush = torch.empty(2 ** 26, dtype=torch.float32, device=dev)
    for name in EPI_CONFIGS:
        cfg = get_config(name)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    use_pallas_conv1=True))
        launches, plain, calls = _epilogue_layers(cfg, dev, seed)
        want = _step_launches(name)
        log(f"epilogue {name}: launches a train step {launches}, plain "
            f"calls {plain}, layers {len(calls)}")
        check(launches == want, f"{name}: launches {launches} a step, "
                                f"expected {want}")
        check(plain == {"fwd": 0, "bwd": 0}, f"{name}: the plain epilogue "
                                             f"ran on the card: {plain}")
        g = torch.Generator(dev).manual_seed(seed + 13)
        rows, step = [], {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                          "fwd_ms": 0.0, "bwd_ms": 0.0}
        for (shape, crop, gelu, out_dtype), count in calls.items():
            n, ch, hc, wc = shape
            ho, wo = crop or (hc, wc)
            dt = get_config(name).model.dtype
            dt = torch.bfloat16 if dt == "bfloat16" else torch.float32
            c = (1.5 * torch.randn((n, hc, wc, ch), generator=g,
                                   device=dev)).to(dt).permute(0, 3, 1, 2)
            b = (0.5 * torch.randn(ch, generator=g, device=dev)).to(dt)
            dy = (0.01 * torch.randn((n, ho, wo, ch), generator=g,
                                     device=dev)).to(out_dtype)
            case = _epilogue_case(c, b, dy, crop, gelu, out_dtype)
            fwd_ms = time_ms(lambda: ce._forward(c, b, crop, gelu, out_dtype),
                             flush)
            bwd_ms = time_ms(lambda: ce._backward(c, b, dy, crop, gelu), flush)
            plain_ms = time_ms(lambda: (
                ce.conv_epilogue_ref(c, b, crop, gelu, out_dtype),
                ce.conv_epilogue_bwd_ref(c, b, dy, crop, gelu)), flush,
                iters=10)
            fb, bb = _epilogue_bytes(shape, crop, gelu, out_dtype, dt)
            bound = bound_ms(fb + bb, 0)[0]
            case.update(count=count, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                        plain_ms=plain_ms, bound_ms=bound,
                        roofline_pct=100 * bound / (fwd_ms + bwd_ms))
            log(f"  {name} {case}")
            rows.append(case)
            step["fwd_ms"] += count * fwd_ms
            step["bwd_ms"] += count * bwd_ms
            step["kernel_ms"] += count * (fwd_ms + bwd_ms)
            step["plain_ms"] += count * plain_ms
            step["bound_ms"] += count * bound
            del c, b, dy
        step["roofline_pct"] = 100 * step["bound_ms"] / step["kernel_ms"]
        log(f"epilogue {name} a train step: {step}")
        out[name] = {"launches": launches, "layers": rows, "step": step}
        torch.cuda.empty_cache()
    return out


# -- the head's last layer -------------------------------------------------------

HEAD_OUT_CONFIGS = ("c2_gru_4bar", "c3_hier_16bar")
# (bars, h, w, Cin, crop, x dtype, out dtype) beside the configs' own: the
# whole grid, an odd crop, f32, and the other channel counts the kernels
# take (8-byte loads at Cin 4, a thread's whole pixel at Cin 128)
HEAD_OUT_RAGGED = ((3, 5, 7, 16, None, torch.bfloat16, torch.float32),
                   (5, 17, 9, 8, (33, 18), torch.float32, torch.float32),
                   (2, 11, 64, 4, (21, 128), torch.bfloat16, torch.bfloat16),
                   (2, 9, 5, 128, (19, 11), torch.bfloat16, torch.float32),
                   (4, 48, 64, 32, (96, 128), torch.float32, torch.float32))


def _head_out_inputs(g, bars, h, w, cin, crop, dt, out_dtype, dev):
    """x like a GELU's output, W and b at the layer's init scale or above,
    dy at the BCE gradient's size, in the dtypes the head gives them."""
    x = torch.nn.functional.gelu(torch.randn((bars, h, w, cin), generator=g,
                                             device=dev)).to(dt)
    wt = (torch.randn((cin, 1, 3, 3), generator=g, device=dev)
          / (3.0 * cin ** 0.5)).to(dt)
    b = (0.5 * torch.randn(1, generator=g, device=dev)).to(dt)
    ho, wo = crop or (2 * h + 1, 2 * w + 1)
    dy = (0.01 * torch.randn((bars, ho, wo, 1), generator=g,
                             device=dev)).to(out_dtype)
    return x, wt, b, dy


def _ulp(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The spacing of ``dt`` at |t| (its smallest normal's below it)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(torch.finfo(dt).tiny)))
    return torch.exp2(e) * torch.finfo(dt).eps


def _head_out_case(x, wt, b, dy, crop, out_dtype) -> dict:
    """The kernels against the plain versions on one layer's inputs. With a
    zero bias the forward is the conv sum rounded once: it and dx within 1
    ulp of x's dtype plus the f32 sum's reordering (2^-24 a term of the
    sum of |products|); with the bias the sum's ulp and one of the output
    (the bias add rounds again, and a tie can go either way after a sum
    an ulp apart); dW and db within 2^-7 relative and 1e-5 of their sums
    of |products|; a second run of each kernel bit-equal to the first."""
    import torch.nn.functional as F
    from musicvae_tpu_torch.ops import head_out as ho_ops

    dt, cin = x.dtype, x.shape[-1]
    ho, wo = crop or (2 * x.shape[1] + 1, 2 * x.shape[2] + 1)
    y = ho_ops._forward(x, wt, b, crop, out_dtype)
    y2 = ho_ops._forward(x, wt, b, crop, out_dtype)
    y0 = ho_ops._forward(x, wt, torch.zeros_like(b), crop, out_dtype)
    y0_ref = ho_ops.head_out_ref(x, wt, torch.zeros_like(b), crop, out_dtype)
    dx, dw, db = ho_ops._backward(x, wt, dy, crop)
    dx2, dw2, db2 = ho_ops._backward(x, wt, dy, crop)
    y_ref = ho_ops.head_out_ref(x, wt, b, crop, out_dtype)
    dx_ref, dw_ref, db_ref = ho_ops.head_out_bwd_ref(x, wt, dy, crop)
    xa = x.permute(0, 3, 1, 2).float().abs()
    c_ref = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, None,
                               stride=2)[:, :, :ho, :wo].float()
    s_fwd = F.conv_transpose2d(xa, wt.float().abs(), None,
                               stride=2)[:, :, :ho, :wo]
    g = torch.zeros((x.shape[0], 1, 2 * x.shape[1] + 1, 2 * x.shape[2] + 1),
                    device=x.device)
    g[:, :, :ho, :wo] = dy.to(dt).float().permute(0, 3, 1, 2)
    s_dx = F.conv2d(g.abs(), wt.float().abs(), stride=2)
    s_dw = torch.ops.aten.convolution_backward(
        g.abs(), xa, wt.float(), None, [2, 2], [0, 0], [1, 1], True, [0, 0],
        1, [False, True, False])[1]
    torch.cuda.synchronize()
    reorder = 2.0 ** -24 * 4 * cin * s_fwd
    sum_err = (y0.float() - y0_ref.float()).abs().permute(0, 3, 1, 2)
    sum_tol = _ulp(c_ref, dt) + reorder
    yv, yr = y.float().permute(0, 3, 1, 2), y_ref.float().permute(0, 3, 1, 2)
    fwd_err = (yv - yr).abs()
    fwd_tol = _ulp(c_ref, dt) + _ulp(yr, dt) + reorder
    dxv = dx.float().permute(0, 3, 1, 2)
    dxr = dx_ref.float().permute(0, 3, 1, 2)
    dx_err = (dxv - dxr).abs()
    dx_tol = _ulp(dxr, dt) + 2.0 ** -24 * 9 * s_dx
    dw_err = (dw.float() - dw_ref.float()).abs()
    dw_tol = 2.0 ** -7 * dw_ref.float().abs() + 1e-5 * s_dw
    db_err = (db.float() - db_ref.float()).abs()
    db_tol = 2.0 ** -7 * db_ref.float().abs() + 1e-5 * g.abs().sum()
    out = {"x": list(x.shape), "crop": [ho, wo], "dtype": str(dt)[6:],
           "out": str(out_dtype)[6:],
           "sum_max_err_over_tol": float((sum_err / sum_tol).max()),
           "sum_not_bit_equal": float((sum_err > 0).float().mean()),
           "fwd_max_err_over_tol": float((fwd_err / fwd_tol).max()),
           "fwd_not_bit_equal": float((fwd_err > 0).float().mean()),
           "dx_max_err_over_tol": float((dx_err / dx_tol).max()),
           "dx_not_bit_equal": float((dx_err > 0).float().mean()),
           "dw_max_err_over_tol": float((dw_err / dw_tol).max()),
           "db_max_err_over_tol": float((db_err / db_tol).max()),
           "dw_max_rel": float((dw_err / dw_ref.float().abs().clamp_min(
               1e-30)).max()),
           "runs_bit_equal": bool(torch.equal(y, y2) and torch.equal(dx, dx2)
                                  and torch.equal(dw, dw2)
                                  and torch.equal(db, db2))}
    check(out["sum_max_err_over_tol"] <= 1.0
          and out["fwd_max_err_over_tol"] <= 1.0,
          f"head_out forward outside its tolerance: {out}")
    check(out["dx_max_err_over_tol"] <= 1.0, f"head_out dx outside its "
                                             f"tolerance: {out}")
    check(out["dw_max_err_over_tol"] <= 1.0
          and out["db_max_err_over_tol"] <= 1.0,
          f"head_out dW or db outside its tolerance: {out}")
    check(out["runs_bit_equal"], f"head_out: two runs differ: {out}")
    return out


def _head_out_graph_equal(x, wt, b, dy, crop, out_dtype) -> bool:
    """The forward and backward kernels captured into a CUDA graph on a
    side stream (after an eager run there, which makes the stream's ticket
    workspace): the replay's outputs equal the eager run's bit for bit."""
    from musicvae_tpu_torch.ops import head_out as ho_ops

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = (ho_ops._forward(x, wt, b, crop, out_dtype),
                 *ho_ops._backward(x, wt, dy, crop))
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = (ho_ops._forward(x, wt, b, crop, out_dtype),
                        *ho_ops._backward(x, wt, dy, crop))
        for t in captured:
            t.fill_(float("nan"))
        graph.replay()
        side.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    return all(torch.equal(a, c) for a, c in zip(eager, captured))


def _head_out_bytes(x, dy, out_dtype) -> tuple:
    """(forward, backward) bytes of the layer: each input byte read once
    and each output byte written once (forward: x, W, b, y; backward: dy,
    x, W, dx, dW, db), and (forward, backward) f32 operations (a
    multiply-add as 2: x's 9 taps a channel forward; dx's and dW's
    backward)."""
    e, o = x.element_size(), torch.finfo(out_dtype).bits // 8
    n, h, w, cin = x.shape
    xb, wb = x.numel() * e, 9 * cin * e
    yb = dy.numel() * o
    macs = n * h * w * cin * 9
    return ((xb + wb + e + yb, yb + xb + wb + xb + wb + e),
            (2 * macs, 4 * macs))


def _head_out_library(x, wt, b, dy, crop, out_dtype):
    """The path the kernels replace, as the parent ran it: cuDNN's
    transposed conv without its bias on x's channels-last NCHW view and
    the epilogue's forward; the epilogue's backward and cuDNN's input and
    weight gradients."""
    import torch.nn.functional as F
    from musicvae_tpu_torch.ops import conv_epilogue as ce

    xc = x.permute(0, 3, 1, 2)

    def fwd():
        return ce._forward(F.conv_transpose2d(xc, wt, None, stride=2), b,
                           crop, False, out_dtype)

    c = F.conv_transpose2d(xc, wt, None, stride=2)

    def bwd():
        dc, db = ce._backward(c, b, dy, crop, False)
        return torch.ops.aten.convolution_backward(
            dc, xc, wt, None, [2, 2], [0, 0], [1, 1], True, [0, 0], 1,
            [True, True, False]), db
    return fwd, bwd


def head_out_phase(seed: int, dev: torch.device, card: str):
    """The decoder head's last layer (ops/head_out.py, csrc/head_out.cu):
    its kernels' ptxas and SASS report; one eager train step of c2 and c3
    launches them 1 + 1 and the epilogue 12 + 12 (``_epilogue_layers``);
    at the configs' shape (x [bars, 48, 64, 16] bf16, the [96, 128] crop,
    f32 logits) and at ``HEAD_OUT_RAGGED`` the kernels against the plain
    versions (``_head_out_case``); a captured graph's replay against the
    eager calls; then, at the configs' shape, each kernel timed from a
    cold L2 (launch included) and alone (torch.profiler), beside its byte
    bound, the plain versions and the replaced path
    (``_head_out_library``), forward and backward."""
    import dataclasses

    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.ops import head_out as ho_ops

    out = {"card": card, "build": build_report(
        "head_out", "head_out_fwd<__nv_bfloat16, float, 8>")}
    flush = torch.empty(2 ** 26, dtype=torch.float32, device=dev)
    g = torch.Generator(dev).manual_seed(seed + 17)
    out["ragged"] = []
    for bars, h, w, cin, crop, dt, odt in HEAD_OUT_RAGGED:
        args = _head_out_inputs(g, bars, h, w, cin, crop, dt, odt, dev)
        case = _head_out_case(*args[:3], args[3], crop, odt)
        case["graph_equal"] = _head_out_graph_equal(*args, crop, odt)
        check(case["graph_equal"], f"head_out: graph replay differs from "
                                   f"eager: {case}")
        log(f"head_out ragged {case}")
        out["ragged"].append(case)
    for name in HEAD_OUT_CONFIGS:
        cfg = get_config(name)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    use_pallas_conv1=True))
        launches, plain, _ = _epilogue_layers(cfg, dev, seed)
        want = _step_launches(name)
        check(launches == want and plain == {"fwd": 0, "bwd": 0},
              f"{name}: launches {launches} a step, expected {want}; plain "
              f"epilogue calls {plain}")
        bars = cfg.train.batch_size * cfg.model.num_bars
        crop = (96, 128)
        x, wt, b, dy = _head_out_inputs(g, bars, 48, 64, 16, crop,
                                        torch.bfloat16, torch.float32, dev)
        case = _head_out_case(x, wt, b, dy, crop, torch.float32)
        case["graph_equal"] = _head_out_graph_equal(x, wt, b, dy, crop,
                                                    torch.float32)
        check(case["graph_equal"], f"{name}: head_out graph replay differs "
                                   f"from eager: {case}")
        (fb, bb), (fo, bo) = _head_out_bytes(x, dy, torch.float32)
        lib_fwd, lib_bwd = _head_out_library(x, wt, b, dy, crop,
                                             torch.float32)
        t = {"fwd_ms": time_ms(lambda: ho_ops._forward(
                 x, wt, b, crop, torch.float32), flush),
             "bwd_ms": time_ms(lambda: ho_ops._backward(x, wt, dy, crop),
                               flush),
             "fwd_alone_ms": kernel_only_ms(lambda: ho_ops._forward(
                 x, wt, b, crop, torch.float32), flush, "head_out_fwd"),
             "bwd_alone_ms": kernel_only_ms(lambda: ho_ops._backward(
                 x, wt, dy, crop), flush, "head_out_bwd"),
             "fwd_bound_ms": bound_ms(fb, fo)[0],
             "bwd_bound_ms": bound_ms(bb, bo)[0],
             "bound_by": bound_ms(fb + bb, fo + bo)[1],
             "plain_ms": time_ms(lambda: (
                 ho_ops.head_out_ref(x, wt, b, crop, torch.float32),
                 ho_ops.head_out_bwd_ref(x, wt, dy, crop)), flush, iters=10),
             "library_fwd_ms": time_ms(lib_fwd, flush, iters=10),
             "library_bwd_ms": time_ms(lib_bwd, flush, iters=10)}
        t["kernel_ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["bound_ms"] = t["fwd_bound_ms"] + t["bwd_bound_ms"]
        t["library_ms"] = t["library_fwd_ms"] + t["library_bwd_ms"]
        t["roofline_pct"] = 100 * t["bound_ms"] / t["kernel_ms"]
        t["roofline_alone_pct"] = 100 * t["bound_ms"] / (t["fwd_alone_ms"]
                                                          + t["bwd_alone_ms"])
        case.update(launches=launches, bytes=[fb, bb], **t)
        log(f"head_out {name} ({card}): {case}")
        out[name] = case
        del x, wt, b, dy, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    return out


PHASES = ("kernels", "epilogue", "head_out", "reference", "serve", "eval",
          "fused_elbo", "train", "ckpt", "corpus", "serve_stack", "kinds",
          "patch_attn", "parallel", "tp")


def _card_settings() -> None:
    """f32 convs and matmuls in f32 (no TF32), and deterministic cuBLAS
    for the train phases (read at the process's first matmul)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def main() -> int:
    global LOG_FILE
    if sys.argv[1:2] == ["--dp-worker"]:
        _card_settings()
        return dp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--tp-worker"]:
        _card_settings()
        return tp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--dp4-worker"]:
        _card_settings()
        return dp4_worker(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help=f"comma-separated subset of {','.join(PHASES)} "
                         "(and profile and dp4, which the full run leaves "
                         "out) "
                         "for development: runs those phases and prints "
                         "their details, but no kernels line and no result "
                         "line (the full run is the check)")
    ap.add_argument("--log-file", default=None, metavar="PATH",
                    help="also append every printed line to PATH (the "
                         "details line outgrows what a terminal keeps)")
    args = ap.parse_args()
    only = PHASES if args.only is None else tuple(args.only.split(","))
    if set(only) - set(PHASES) - {"profile", "dp4"}:
        ap.error(f"--only takes {PHASES + ('profile', 'dp4')}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    _card_settings()
    dev = torch.device("cuda", 0)

    if args.log_file is not None:
        LOG_FILE = args.log_file
        os.makedirs(os.path.dirname(os.path.abspath(LOG_FILE)),
                    exist_ok=True)
    card = header()
    details, runs, entries = {}, {}, []
    t_run, starts = time.perf_counter(), {}

    def mark(phase):
        starts[phase] = round(time.perf_counter() - t_run, 1)
        log(f"phase {phase} starts at {starts[phase]} s")

    if "kernels" in only:
        mark("kernels")
        entries, details["kernel_checks"] = kernel_checks(args.seed, dev)
    if "epilogue" in only:
        mark("epilogue")
        details["epilogue"] = epilogue_phase(args.seed, dev, card)
    if "head_out" in only:
        mark("head_out")
        details["head_out"] = head_out_phase(args.seed, dev, card)
    if "reference" in only:
        mark("reference")
        details["reference"] = reference_check(args.seed, dev)
    if "serve" in only:
        mark("serve")
        serve_runs, details["serve"] = serve_phase(args.seed, dev, card)
        runs.update(serve_runs)
    if "eval" in only:
        mark("eval")
        eval_runs, details["eval"] = eval_phase(args.seed, dev, card)
        runs.update(eval_runs)
    if "fused_elbo" in only:
        mark("fused_elbo")
        runs["fused_elbo"], details["fused_elbo"] = fused_elbo_phase(
            args.seed, dev)
    if "train" in only:
        mark("train")
        train_runs, details["train"] = train_phase(args.seed, dev, card)
        runs.update(train_runs)
    if "ckpt" in only:
        mark("ckpt")
        ckpt_runs, details["ckpt"] = ckpt_phase(args.seed, dev, card)
        runs.update(ckpt_runs)
    if "corpus" in only:
        mark("corpus")
        corpus_runs, details["corpus"] = corpus_phase(args.seed, dev, card)
        runs.update(corpus_runs)
    if "serve_stack" in only:
        mark("serve_stack")
        stack_runs, details["serve_stack"] = serve_stack_phase(
            args.seed, dev, card)
        runs.update(stack_runs)
    if "kinds" in only:
        mark("kinds")
        kinds_runs, details["kinds"] = kinds_phase(args.seed, dev, card)
        runs.update(kinds_runs)
        shapes = details["kinds"]["kernel_shapes"]
        for e in entries:
            rows = shapes.get(e["name"].split()[0])
            if rows:
                e["kinds_shapes"] = rows
    if "patch_attn" in only:
        mark("patch_attn")
        pa_runs, details["patch_attn"] = patch_attn_phase(args.seed, dev,
                                                          card)
        runs.update(pa_runs)
        for e in entries:
            rows = details["patch_attn"]["kernel_shapes"].get(
                e["name"].split()[0])
            if rows:
                e["patch_attn_shapes"] = rows
    if "parallel" in only:
        mark("parallel")
        par_runs, details["parallel"] = parallel_phase(args.seed, dev, card)
        runs.update(par_runs)
        for e in entries:
            rows = details["parallel"]["kernel_shapes"].get(
                e["name"].split()[0])
            if rows:
                e["parallel_shapes"] = rows
    if "tp" in only:
        mark("tp")
        tp_runs, details["tp"] = tp_phase(args.seed, dev, card)
        runs.update(tp_runs)
        for e in entries:
            rows = details["tp"]["kernel_shapes"].get(e["name"].split()[0])
            if rows:
                e["tp_shapes"] = rows
    if "profile" in only:
        mark("profile")
        details["profile"] = profile_phase(args.seed, dev)
    if "dp4" in only:
        mark("dp4")
        details["dp4"] = dp4_phase(args.seed, card)

    starts["end"] = round(time.perf_counter() - t_run, 1)
    log(f"phases started at (s): {starts}")
    log("details: " + json.dumps({**details, "launches": runs,
                                  "phase_starts_s": starts,
                                  "torch": torch.__version__,
                                  "cuda": torch.version.cuda}))
    if args.only is not None:
        log(f"partial run ({args.only}): no result line")
        return 0
    for e in entries:
        kname = e["name"].split()[0]
        e["launches_by_path"] = {path: n[kname] for path, n in runs.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        path = e.pop("path")
        check(runs[path][kname] > 0, f"{kname} not launched on its path "
                                     f"({path})")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
