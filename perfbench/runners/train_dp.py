"""The data-parallel training cell: ``train()`` of the program on P
processes, one a card, as ``train`` runs under a multi-process launch
(the ``MVAE_*`` variables): each process trains on its rows of every
global batch of the configuration's ``batch_size`` over NCCL (gloo on the
CPU), and the step averages the gradients over the group.

This process is rank 0. It writes the run's context into a directory of
its own, starts ranks 1..P−1 (``python3 -m perfbench.runners.train_dp
--worker ...``, from the checkout's root) and runs its own rank. Every
rank makes the same corpus, labels, weights and state from ``--seed``
on its own card and runs one ``train()`` call; the window is rank 0's, as
in the one-process cells (perfbench/runners/train.py): from the log read
that fences the first dispatch after warm-up to the one that fences the
last, at which rank 0's ``stop`` ends the run on every rank (the
program's stop is collective). ``train_bars_per_s`` counts the global
batch's bars.

``correct``: each rank's first three steps (eager, capture, replay; read
at ``trainer._RowStep`` as the one-process runner reads them) against the
plain reference (perfbench/reference/cond.py) at the global batch on
rank 0's card, by the one-process runner's ``loss_gap``, ``grad_gap`` and
``change_gap``, the worst rank's; and ``replica_gap``, the largest
difference of any parameter between rank 0 and any other rank after the
window, which must be 0. The memory peak is the fullest card's; the
forbidden modules are every rank's.

The cell measures the step as the program captures it on the cards, one
graph a step with the all-reduce inside. A program that runs the step
eagerly under NCCL (four host loops in lockstep, another workload) is
not run: rank 0 ends the run, exit ``EAGER_EXIT``, at its second step,
the one that would be the capture, before any window.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import harness, yardstick_dp
from perfbench.harness import Check, Outcome
from perfbench.reference import cond as ref_cond
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train
from perfbench.runners import train as train_runner

WAIT_S = 300             # a rank's end after rank 0's, at most
STACKS_AFTER_S = 300     # a rank still running this long after its
#                          window should have ended prints its threads'
#                          stacks on standard error
FAULTS = ("skip_allreduce",)
EAGER_EXIT = 8           # the program ran the step eagerly on the card


def _say(rank: int, what: str) -> None:
    """A rank's progress on standard error (a worker's goes to its file in
    the run's directory)."""
    print(f"perfbench dp rank {rank}: {what} at "
          f"{time.perf_counter():.3f}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class DPSetup(train_runner.Setup):
    """A rank's inputs: the one-process runner's, with the windows'
    labels."""
    chords: Any = None
    keys: Any = None


def _labels(mix: dict, starts: np.ndarray, spec: dict, seed: int):
    """(chord [windows], key [windows]): a chord class for every bar and a
    key class for every piece, drawn from ``seed``; a window's chord is
    its first bar's, its key its piece's."""
    m = spec["model"]
    rng = np.random.default_rng(seed)
    per = mix["bars_per_piece"]
    bar_chords = rng.integers(0, m["cond_chord_classes"],
                              mix["pieces"] * per)
    piece_keys = rng.integers(0, m["cond_key_classes"], mix["pieces"])
    return (bar_chords[starts].astype(np.int32),
            piece_keys[starts // per].astype(np.int32))


def prepare(ctx: harness.Ctx, dev: torch.device) -> DPSetup:
    """The corpus, its labels, the weights and the state at step 0 of one
    rank, from ``--seed`` (the same on every rank)."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.models.vae import PianoRollVAE
    from musicvae_tpu_torch.train import trainer

    spec, mix = ctx.spec, ctx.mix
    cfg = harness.port_config(spec)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, seed=harness.derived_seed(ctx.seed, 0)))
    nb = cfg.model.num_bars
    bars, starts = train_runner.make_corpus(
        mix, nb, harness.derived_seed(ctx.seed, 1), dev)
    chords, keys = _labels(mix, starts, spec,
                           harness.derived_seed(ctx.seed, 5))
    ds = PianoRollDataset(bars, starts, nb, chords, keys,
                          piece_ids=starts // mix["bars_per_piece"])
    p0 = ref.make_params(ref_cond.param_shapes(spec),
                         harness.derived_seed(ctx.seed, 2), dev)
    model = PianoRollVAE(cfg.model, cfg.midi, cfg.train.remat_encoder)
    model.load_state_dict({k: v.cpu() for k, v in p0.items()})
    noise_seed = harness.derived_seed(ctx.seed, 3)
    state = trainer.init_state(cfg, model.to(dev), seed=noise_seed)
    return DPSetup(cfg, spec, dev, bars, starts, ds, p0, state, noise_seed,
                   0, False, chords, keys)


def reference_of(su: DPSetup, q=ref.exact, rows=None) -> dict:
    """The reference's first steps at the global batch over the windows
    and noise the program's first steps read, worked out again from the
    run's seeds, in f32 with TF32 off."""
    batch, nb = su.cfg.train.batch_size, su.cfg.model.num_bars
    ids = ref_train.resident_ids(su.cfg.train.seed, su.starts.shape[0],
                                 batch, train_runner.PRE_STEPS)
    batches = [ref_cond.gather(su.bars, su.starts, su.chords, su.keys, i, nb)
               for i in ids]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return ref_cond.run_steps(su.spec, su.p0, batches, su.noise_seed,
                                  su.device, q, rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def _plant(fault: Optional[str]) -> None:
    """A fault of this rank's program, for the controls
    (perfbench/controls_dp.py): ``skip_allreduce`` keeps the rank's own
    gradients and metrics (the all-reduce still runs, on a copy, so that
    the group's collectives stay in step)."""
    if fault is None:
        return
    if fault != "skip_allreduce":
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    from musicvae_tpu_torch.train import trainer
    real = trainer._average_over_group

    def local(grads, metrics, mesh):
        real(grads, metrics, mesh)
        return list(grads), dict(metrics)

    trainer._average_over_group = local


def _require_capture() -> Callable[[], None]:
    """Watch this rank's second step (``trainer._RowStep``, the step
    ``first_steps`` reads): if it left no captured graph, say so and end
    the process, exit ``EAGER_EXIT`` (the other ranks follow their
    parent, ``_watch_parent``). Returns what puts the step back."""
    from musicvae_tpu_torch.train import trainer
    call = trainer._RowStep.__call__
    seen = [0]

    def checked(self, j, rows, eps, shifts):
        out = call(self, j, rows, eps, shifts)
        seen[0] += 1
        if seen[0] == 2 and getattr(self.program, "graph", None) is None:
            print("perfbench: the program ran the data-parallel step "
                  "eagerly on the card; this cell measures it captured, "
                  "one graph a step with the all-reduce inside",
                  file=sys.stderr, flush=True)
            os._exit(EAGER_EXIT)
        return out

    trainer._RowStep.__call__ = checked

    def restore():
        trainer._RowStep.__call__ = call

    return restore


class _Follow:
    """A rank's ``log_fn`` and ``stop`` other than rank 0's: its logs are
    kept, and it never asks to stop (rank 0's stop ends every rank)."""
    requested = False

    def __init__(self):
        self.logs: List[tuple] = []
        self.nonfinite = 0

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self.logs.append((step, time.perf_counter()))
        self.nonfinite += int(metrics.get("nonfinite", 0.0) > 0)


def _replica_gap(state) -> float:
    """The largest difference of any parameter between rank 0 and this
    rank, the largest over the group (a collective)."""
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1) for p in state.params])
    first = flat.clone()
    dist.broadcast(first, src=0)
    gap = (flat - first).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def rank_run(ctx: harness.Ctx, rank: int, world: int, coord: str,
             num_steps: int, window=None, fault: Optional[str] = None):
    """One rank: join the group, make the inputs, run ``train()`` to
    ``num_steps`` (``window``: rank 0's ``log_fn`` and ``stop``), read its
    first steps and the replicas' gap, and leave the group (every rank at
    the same point). Returns (setup, first steps, follower or window,
    replica gap, memory peak)."""
    import torch.distributed as dist
    from musicvae_tpu_torch.parallel import distributed

    cuda = ctx.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if not cuda:
        # one thread a rank: the ranks step in lockstep, and a rank whose
        # threads wait for cores that other work holds stalls them all
        torch.set_num_threads(1)
    faulthandler.dump_traceback_later(ctx.seconds + STACKS_AFTER_S)
    os.environ.update(MVAE_COORDINATOR=coord, MVAE_NUM_PROCS=str(world),
                      MVAE_PROC_ID=str(rank))
    distributed.initialize_from_env(device=dev,
                                    backend="nccl" if cuda else "gloo")
    _say(rank, "joined the group")
    _plant(fault)
    su = prepare(ctx, dev)
    _say(rank, "made its inputs")
    follow = window if window is not None else _Follow()
    restore = _require_capture() if cuda and rank == 0 else None
    try:
        first = train_runner.first_steps(su, num_steps, log_fn=follow.log,
                                         stop=follow)
    finally:
        if restore is not None:
            restore()
    _say(rank, f"trained to step {int(su.state.step)}")
    gap = _replica_gap(su.state)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # no graph holding the communicator's kernels may outlive it
    gc.collect()
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    _say(rank, "left the group")
    return su, first, follow, gap, peak


# -- the worker ranks --------------------------------------------------------------

def _cpu_first(first: dict) -> dict:
    return {"losses": first["losses"],
            "grads": {k: v.cpu() for k, v in first["grads"].items()},
            "params": {k: v.cpu() for k, v in first["params"].items()}}


def _watch_parent() -> None:
    """End this process when the rank that started it is gone (a rank
    left alone waits in a collective for ever)."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(7)

    threading.Thread(target=watch, daemon=True).start()


def worker(argv: List[str]) -> int:
    """``--worker RANK WORLD HOST:PORT DIR [FAULT]``: one rank; its first
    steps and its report go into DIR."""
    rank, world, coord, work = int(argv[0]), int(argv[1]), argv[2], argv[3]
    fault = argv[4] if len(argv) > 4 else None
    _watch_parent()
    saved = harness.load_json(os.path.join(work, "ctx.json"))
    ctx = harness.Ctx(saved["workload"], saved["spec"], saved["mix"],
                      saved["seed"], saved["seconds"], False,
                      saved["device"], world)
    su, first, follow, gap, peak = rank_run(ctx, rank, world, coord,
                                            saved["num_steps"], fault=fault)
    torch.save(_cpu_first(first), os.path.join(work, f"first_{rank}.pt"))
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump({"memory_peak_bytes": peak, "replica_gap": gap,
                   "nonfinite": follow.nonfinite,
                   "steps": int(su.state.step),
                   "forbidden": harness.forbidden_loaded()}, f)
    _say(rank, "wrote its report")
    return 0


# -- rank 0 --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """Ranks 1..P−1 of a run, started from this process (rank 0), each
    writing into ``work``; a thread ends this process, and the others, as
    soon as one of them fails (its standard error's end goes to ours)."""

    def __init__(self, ctx: harness.Ctx, num_steps: int,
                 faults: Dict[int, str]):
        self.world = ctx.chips
        self.work = tempfile.mkdtemp(prefix="perfbench_dp_")
        with open(os.path.join(self.work, "ctx.json"), "w") as f:
            json.dump({"workload": ctx.workload, "spec": ctx.spec,
                       "mix": ctx.mix, "seed": ctx.seed,
                       "seconds": ctx.seconds, "device": ctx.device,
                       "num_steps": num_steps}, f)
        self.coord = f"127.0.0.1:{_free_port()}"
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MVAE_")}
        self.procs = []
        for r in range(1, self.world):
            err = open(os.path.join(self.work, f"stderr_{r}.txt"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "perfbench.runners.train_dp",
                 "--worker", str(r), str(self.world), self.coord, self.work,
                 *([faults[r]] if r in faults else [])],
                cwd=harness.ROOT, env=env, stdout=err,
                stderr=subprocess.STDOUT))
        self.done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _tail(self, r: int) -> str:
        with open(os.path.join(self.work, f"stderr_{r}.txt")) as f:
            return f.read()[-4000:]

    def _watch(self) -> None:
        while not self.done.is_set():
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    print(f"perfbench: rank {r} failed (exit "
                          f"{p.returncode}):\n{self._tail(r)}",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(6)
            time.sleep(0.2)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def results(self) -> List[dict]:
        """Each worker rank's report and first steps, once it has ended."""
        self.done.set()
        out = []
        try:
            for r, p in enumerate(self.procs, 1):
                rc = p.wait(timeout=WAIT_S)
                if rc != 0:
                    raise RuntimeError(f"rank {r} failed (exit {rc}):\n"
                                       f"{self._tail(r)}")
                rep = harness.load_json(os.path.join(self.work,
                                                     f"rank_{r}.json"))
                rep["first"] = torch.load(
                    os.path.join(self.work, f"first_{r}.pt"),
                    weights_only=True)
                out.append(rep)
        finally:
            self.kill()
            shutil.rmtree(self.work, ignore_errors=True)
        return out


def _on(first: dict, dev) -> dict:
    return {"losses": first["losses"],
            "grads": {k: v.to(dev) for k, v in first["grads"].items()},
            "params": {k: v.to(dev) for k, v in first["params"].items()}}


def worst_readings(su: DPSetup, firsts: List[dict], reference: dict
                   ) -> Dict[str, float]:
    """The one-process runner's readings of every rank's first steps
    against the reference, the worst rank's of each."""
    worst: Dict[str, float] = {}
    for r, first in enumerate(firsts):
        got = train_runner.readings(su.spec, su.p0, _on(first, su.device),
                                    reference)
        for k in ("loss", "grad", "change"):
            if got[k] >= worst.get(k, -1.0):
                worst[k], worst[k + "_rank"] = got[k], r
    return worst


def launch(ctx: harness.Ctx, num_steps: int, window=None,
           faults: Optional[Dict[int, str]] = None):
    """Every rank of one run: (rank 0's setup, first steps, window and
    replica gap, the fullest card's memory peak, every rank's first
    steps, the other ranks' reports)."""
    faults = faults or {}
    ranks = Launch(ctx, num_steps, faults)
    try:
        su, first, window, gap, peak = rank_run(
            ctx, 0, ranks.world, ranks.coord, num_steps, window,
            faults.get(0))
    except BaseException:
        ranks.kill()
        raise
    others = ranks.results()
    peak = max([peak] + [o["memory_peak_bytes"] for o in others])
    firsts = [first] + [o["first"] for o in others]
    return su, window, gap, peak, firsts, others


def run(ctx: harness.Ctx) -> Outcome:
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import trace

    world = ctx.chips
    k = trainer.pick_k(harness.port_config(ctx.spec), False)
    window = train_runner._Window(ctx.seconds, ctx.mix["trace_dispatches"]
                                  * k if ctx.trace else 0)
    su, window, gap, peak, firsts, others = launch(ctx, 10 ** 7, window)
    counted = trace.counters().get("dist.allreduce_bytes")
    (s0, t0), (s1, t1) = window.logs[0], window.logs[-1]
    steps = s1 - s0
    batch, nb = su.cfg.train.batch_size, su.cfg.model.num_bars
    bucket = yardstick_dp.bucket_bytes(su.spec)
    print(f"set-up s: first dispatch logged at {t0 - ctx.t_start!r}; "
          f"{world} ranks, {int(su.state.step)} steps; all-reduce bytes "
          f"counted {counted!r}, a step by the configuration {bucket}",
          file=sys.stderr)

    metrics, trace_facts = {}, {}
    if ctx.trace:
        trace_facts = harness.reduce_events(
            window.prof.profiler.kineto_results.events())
        del trace_facts["device"]
        trace_facts.update(
            steps=steps, k=k,
            flops_per_step=yardstick_dp.train_step_flops(su.spec,
                                                         batch // world))
    else:
        metrics["train_bars_per_s"] = steps * batch * nb / (t1 - t0)
        metrics["setup_s"] = t0 - ctx.t_start

    failed = window.nonfinite + sum(o["nonfinite"] for o in others)
    su.state = su.data = None
    del window
    if su.device.type == "cuda":
        torch.cuda.empty_cache()
    got = worst_readings(su, firsts, reference_of(su))
    limits = su.spec["limits"]["train"]
    checks = [Check(f"{name}_gap", got[name], limits[name])
              for name in ("loss", "grad", "change")]
    checks.append(Check("replica_gap", gap, limits["replica"]))
    forbidden = sorted({m for o in others for m in o["forbidden"]})
    return Outcome(metrics, trace_facts, attempted=steps, failed=failed,
                   checks=checks, memory_peak_bytes=peak,
                   forbidden=forbidden)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one worker rank of the "
                                 "data-parallel training cell")
    ap.add_argument("--worker", nargs="+", required=True)
    sys.exit(worker(ap.parse_args().worker))
