"""The training cells: ``train()`` of the program over a resident corpus or
a streamed iterator of host batches, as ``train`` and ``train --stream``
run it.

Set-up makes the corpus, the weights and one train state from the seed,
and starts the one ``train()`` call of the run on that state. The call
logs every ``log_every`` steps (the registered 100, so a dispatch is 100
steps); each log reads the metrics on the host, which fences the
dispatch. Its first dispatch runs the step eagerly, captures its graph
and replays it (set-up); the window runs from the first log to the first
log at least ``--seconds`` later, where ``stop`` ends the run.

The first steps of that dispatch (eager, capture, replay) are read as the
call runs them and, after the window, worked out again by the reference
(perfbench/reference/train.py) and compared: each step's loss, the first
gradient (Adam's first moment after one step over 1 − b1) and the change
of the parameters over the steps, each gradient and change by its worst
leaf.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import harness, yardstick
from perfbench.harness import Check, Outcome
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

PRE_STEPS = 3               # the first steps, compared with the reference
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: left out of the change
ZERO_GRAD_SHARE = 1e-3


def make_corpus(mix: dict, num_bars: int, seed: int, device) -> tuple:
    """(bars [pieces·bars_per_piece, T, P] uint8 on the host, window
    starts): ``pieces`` pieces of ``bars_per_piece`` bars, each cell on
    with probability ``density``, drawn on ``device`` in blocks; a window
    at every bar of a piece."""
    n_pieces, per = mix["pieces"], mix["bars_per_piece"]
    total = n_pieces * per
    bars = np.empty((total, 96, 128), np.uint8)
    gen = torch.Generator(device).manual_seed(seed)
    block = 4096
    for i in range(0, total, block):
        n = min(block, total - i)
        cells = torch.rand((n, 96, 128), generator=gen, device=device)
        bars[i:i + n] = (cells < mix["density"]).to(torch.uint8).cpu().numpy()
    starts = (np.arange(n_pieces)[:, None] * per
              + np.arange(per - num_bars + 1)[None, :]).reshape(-1)
    return bars, starts.astype(np.int32)


def leaf_gap(prog: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, the
    larger; and that leaf's name."""
    names = keep if keep is not None else list(reference)
    ref_norms = {k: float(torch.linalg.vector_norm(reference[k].float()))
                 for k in names}
    median = float(np.median(list(ref_norms.values())))
    worst, leaf = 0.0, ""
    for k in names:
        pn = float(torch.linalg.vector_norm(prog[k].float()))
        gap = abs(pn - ref_norms[k]) / max(ref_norms[k], median)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    median = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= ZERO_GRAD_SHARE * median]


def readings(spec: dict, p0, prog: dict, reference: dict) -> Dict[str, float]:
    """The numbers compared: ``loss`` (the steps' largest relative loss
    gap), ``grad`` (the first gradient by its worst leaf) and ``change``
    (the parameters' change over the steps by its worst moving leaf)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                     reference["losses"]))
    grad, grad_leaf = leaf_gap(prog["grads"], reference["grads"])
    keep = moving_leaves(reference["grads"])
    change, change_leaf = leaf_gap(
        {k: prog["params"][k] - p0[k] for k in keep},
        {k: reference["params"][k] - p0[k] for k in keep}, keep)
    return {"loss": loss, "grad": grad, "change": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf}


class _Window:
    """The measured call's ``log_fn`` and ``stop``: each log's step and
    host time, and ``requested`` once ``seconds`` have passed since the
    first log. Traced (``trace_steps`` > 0), the profiler runs from the
    first log for ``trace_steps`` steps, and the run stops there."""

    def __init__(self, seconds: float, trace_steps: int = 0):
        self.seconds, self.trace_steps = seconds, trace_steps
        self.logs: List[tuple] = []
        self.prof = None
        self.profiling = False
        self.nonfinite = 0

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self.logs.append((step, time.perf_counter()))
        self.nonfinite += int(metrics.get("nonfinite", 0.0) > 0)
        if self.trace_steps and len(self.logs) == 1:
            self.prof = harness.profiler()
            self.prof.start()
            self.profiling = True
        elif self.profiling and step - self.logs[0][0] >= self.trace_steps:
            self.prof.stop()
            self.profiling = False

    @property
    def requested(self) -> bool:
        if not self.logs:
            return False
        if self.trace_steps:
            return self.prof is not None and not self.profiling
        return self.logs[-1][1] - self.logs[0][1] >= self.seconds


def _spanned(obj, attr: str, name: str, sums: List[float], window):
    """Wrap ``obj.attr`` in a host span named perfbench.<name> whose
    seconds, while the window's profiler runs, are added to ``sums``."""
    from torch.profiler import record_function
    fn = getattr(obj, attr)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        with record_function("perfbench." + name):
            out = fn(*a, **kw)
        if window.profiling:
            sums.append(time.perf_counter() - t0)
        return out

    setattr(obj, attr, wrapped)
    return fn


@dataclasses.dataclass
class Setup:
    """A run's inputs made from its seed, and the one train state."""
    cfg: Any
    spec: dict
    device: torch.device
    bars: np.ndarray
    starts: np.ndarray
    data: Any                 # the dataset, or its iterator (streamed)
    p0: Dict[str, torch.Tensor]
    state: Any
    noise_seed: int
    iter_seed: int
    streamed: bool


def prepare(ctx: harness.Ctx) -> Setup:
    """The corpus, the weights and the state at step 0, from ``--seed``."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.models.vae import PianoRollVAE
    from musicvae_tpu_torch.train import trainer

    spec, mix = ctx.spec, ctx.mix
    cfg = harness.port_config(spec)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, seed=harness.derived_seed(ctx.seed, 0)))
    dev = torch.device(ctx.device)
    nb, batch = cfg.model.num_bars, cfg.train.batch_size
    streamed = mix["data"] == "stream"
    bars, starts = make_corpus(mix, nb, harness.derived_seed(ctx.seed, 1), dev)
    n = starts.shape[0]
    ds = PianoRollDataset(bars, starts, nb, np.zeros(n, np.int32),
                          np.zeros(n, np.int32),
                          piece_ids=starts // mix["bars_per_piece"])
    p0 = ref.make_params(ref.param_shapes(spec),
                         harness.derived_seed(ctx.seed, 2), dev)
    model = PianoRollVAE(cfg.model, cfg.midi, cfg.train.remat_encoder)
    model.load_state_dict({k: v.cpu() for k, v in p0.items()})
    noise_seed = harness.derived_seed(ctx.seed, 3)
    state = trainer.init_state(cfg, model.to(dev), seed=noise_seed)
    iter_seed = harness.derived_seed(ctx.seed, 4)
    data = ds.iterator(batch, iter_seed, x_dtype=np.uint8) if streamed \
        else ds
    return Setup(cfg, spec, dev, bars, starts, data, p0, state, noise_seed,
                 iter_seed, streamed)


def first_steps(su: Setup, num_steps: int = PRE_STEPS, **kw) -> dict:
    """Run ``train()`` on the state to step ``num_steps`` (``kw``: its
    ``log_fn`` and ``stop``), and read its first ``PRE_STEPS`` steps as
    that call runs them, at the program's per-step call
    (``trainer._RowStep``: a dispatch copies row j of its stacked inputs
    into the step's buffers and runs the step, the first eagerly, the
    second as its graph's capture, each after as a replay): each step's
    loss, the first gradient (Adam's first moment after the first step
    over 1 − b1) and the parameters after the last. The copies are
    enqueued behind the step on its stream; the host reads them after the
    call."""
    from musicvae_tpu_torch.train import trainer

    names = list(su.p0)
    first: dict = {"losses": []}
    call = trainer._RowStep.__call__

    def watched(self, j, rows, eps, shifts):
        out = call(self, j, rows, eps, shifts)
        first["losses"].append(out["loss"].detach().clone())
        if len(first["losses"]) == 1:
            first["grads"] = {k: m.detach() / (1.0 - su.cfg.train.adam_b1)
                              for k, m in zip(names, self.state.opt.mu)}
        if len(first["losses"]) == PRE_STEPS:
            first["params"] = {k: p.detach().clone()
                               for k, p in zip(names, self.state.params)}
            trainer._RowStep.__call__ = call
        return out

    trainer._RowStep.__call__ = watched
    try:
        trainer.train(su.cfg, su.data, num_steps=num_steps, state=su.state,
                      device=su.device, **kw)
    finally:
        trainer._RowStep.__call__ = call
    first["losses"] = [float(v) for v in first["losses"]]
    return first


def reference_of(su: Setup, q=ref.exact, rows=None) -> dict:
    """The reference's first steps over the batches the program's first
    steps read, worked out again from the run's seeds."""
    batch, nb = su.cfg.train.batch_size, su.cfg.model.num_bars
    n = su.starts.shape[0]
    ids = (ref_train.streamed_ids(su.iter_seed, n, batch, PRE_STEPS)
           if su.streamed else
           ref_train.resident_ids(su.cfg.train.seed, n, batch, PRE_STEPS))
    batches = [ref_train.gather(su.bars, su.starts, i, nb) for i in ids]
    return reference_steps(su.spec, su.p0, batches, su.noise_seed,
                           su.device, q, rows)


def _join_producers() -> None:
    """Wait for the streaming producer threads ``train()`` started."""
    for t in threading.enumerate():
        if t.name == "mvae-prefetch":
            t.join(timeout=60)


def run(ctx: harness.Ctx) -> Outcome:
    from musicvae_tpu_torch.train import trainer

    su = prepare(ctx)
    t_prepared = time.perf_counter()
    batch, nb = su.cfg.train.batch_size, su.cfg.model.num_bars
    k = trainer.pick_k(su.cfg, False)
    window = _Window(ctx.seconds, ctx.mix["trace_dispatches"] * k
                     if ctx.trace else 0)
    producer: List[float] = []
    restore = []
    if ctx.trace and su.streamed:
        restore = [(trainer, "_stack_host_batches", _spanned(
                        trainer, "_stack_host_batches", "producer_stack",
                        producer, window)),
                   (trainer._StackUploader, "put", _spanned(
                       trainer._StackUploader, "put", "producer_upload",
                       producer, window))]
    try:
        first = first_steps(su, 10 ** 7, log_fn=window.log, stop=window)
    finally:
        for obj, attr, fn in restore:
            setattr(obj, attr, fn)
    _join_producers()
    (s0, t0), (s1, t1) = window.logs[0], window.logs[-1]
    print(f"set-up s: inputs and state {t_prepared - ctx.t_start!r}, first "
          f"dispatch {t0 - t_prepared!r}", file=sys.stderr)
    steps = s1 - s0
    cuda = su.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(su.device) if cuda else 0

    metrics, trace = {}, {}
    if ctx.trace:
        trace = harness.reduce_events(
            window.prof.profiler.kineto_results.events())
        del trace["device"]
        trace.update(steps=steps, k=k,
                     flops_per_step=yardstick.train_step_flops(su.spec, batch),
                     producer_s=sum(producer),
                     producer_stacks=len(producer) // 2)
    else:
        metrics["train_bars_per_s"] = steps * batch * nb / (t1 - t0)
        metrics["setup_s"] = t0 - ctx.t_start

    failed = window.nonfinite
    # the program's state goes before the reference runs
    su.state = su.data = None
    del window
    if cuda:
        torch.cuda.empty_cache()
    got = readings(su.spec, su.p0, first, reference_of(su))
    limits = su.spec["limits"]["train"]
    checks = [Check(f"{name}_gap", got[name], limits[name])
              for name in ("loss", "grad", "change")]
    return Outcome(metrics, trace, attempted=steps, failed=failed, checks=checks,
                   memory_peak_bytes=peak)


def reference_steps(spec, p0, batches, noise_seed, dev, q=ref.exact,
                    rows=None):
    """The reference's first steps in f32 (TF32 off)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return ref_train.run_steps(spec, p0, batches, noise_seed, dev, q,
                                   rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
