"""Command line: ``python -m musicvae_tpu_torch`` ``preprocess``, ``train``,
``eval``, ``eval-gen``, ``generate``, ``reconstruct``, ``describe`` and
``serve``: the counterparts of the JAX package's cli.py commands.

``preprocess`` tensorizes a MIDI glob (or a synthetic corpus) into the
``.npz`` bar cache on the host. ``train`` trains a config on the card, on
the resident data path, from a bar cache (``--data``), a MIDI glob
(``--midi-glob``, tensorized in-process) or a synthetic corpus;
checkpoints into ``--ckpt-dir`` (checkpoints/io.py), continues a run with
``--resume``, logs JSON lines under ``--log-dir`` and prints the final
metrics. A SIGTERM or ^C saves the exact step and exits 0. ``eval`` scores
a checkpoint on a bar cache or a MIDI glob (``cmd_eval``); ``generate``
samples MIDI from a checkpoint, optionally continuing or morphing real
music (``--seed-midi``, ``--encode``, ``--interp-midi-b``); ``reconstruct``
encodes and decodes MIDI files and reports cell P/R/F1; ``eval-gen``
scores generations against a corpus (utils/genmetrics.py); ``describe``
reports what a checkpoint directory holds without touching a device
(``cmd_describe``). Streaming, the sharded corpus and the cond kind's
flags are later items of ROADMAP.md; they are parsed and refused.

``serve`` is the counterpart of ``cmd_serve`` with its default
stdin transport (``_serve_stdin_serial``): a persistent generation service
speaking the line-delimited JSON protocol of docs/SERVING.md, over a
checkpoint (``--ckpt-dir``, its EMA weights with ``--ema``), a state dict
(``--weights``) or random weights.

  request:  {"id": any, "seed": int}
  response: {"id": any, "midi_b64": [str, ...], "density": float,
             "latency_ms": float}
  stats:    {"id": any, "cmd": "stats"} → {"id": any, "stats": {served,
             errors, requests, step, config, samples, bars, uptime_s}}
  error:    {"id": any, "error": str}

Every failure, a request for a feature the port has not reached included,
is answered in-band under the request's id; the service keeps running.
EOF on stdin ends it. Logs go to stderr; stdout carries protocol lines.
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import List, Optional, TextIO

import numpy as np
import torch

from musicvae_tpu_torch.config import Config, GenSpec, get_config
from musicvae_tpu_torch.generate.sampler import bars_to_midi, make_generate_fn
from musicvae_tpu_torch.midi.smf import SMFError
from musicvae_tpu_torch.models.vae import PianoRollVAE, build_model

# serve flags and request fields of the JAX package that later slices of
# the port bring (ROADMAP.md); using one is an error, never a silent no-op
_LATER_FLAGS = ("port", "coalesce", "reload_every", "pipeline", "warm_seed")
_LATER_FIELDS = ("seed_midi_b64",)
_LATER_CMDS = ("reload",)

# the JAX package's wording, for the commands that take --ema
_EMA_ERROR = ("error: --ema needs a checkpoint trained with "
              "--ema-decay > 0 (this one has no EMA weights)")


class Service:
    """One generation service: a model, its sweep function and the
    counters ``stats`` reports. ``handle`` answers one protocol line."""

    def __init__(self, cfg: Config, model: PianoRollVAE, step: int = 0):
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.generate = make_generate_fn(cfg, model)
        self.step = step
        self.served = self.errors = self.requests = 0
        self.t_start = time.perf_counter()

    def warm(self) -> None:
        """One sweep, so the first request pays no one-time set-up (the
        kernel build, cuDNN's algorithm choice)."""
        self.generate(torch.Generator(self.device).manual_seed(0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def handle(self, line: str) -> Optional[dict]:
        """The response to one request line; None for a blank line."""
        line = line.strip()
        if not line:
            return None
        rid = None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("a request is a JSON object")
            rid = req.get("id")
            cmd = req.get("cmd")
            if cmd == "stats":
                return self._stats(rid)
            if cmd in _LATER_CMDS:
                raise NotImplementedError(
                    f"cmd {cmd!r} is not in the PyTorch port yet")
            if cmd is not None:
                raise ValueError(f"unknown cmd {cmd!r} (expected 'stats')")
            for field in _LATER_FIELDS:
                if req.get(field) is not None:
                    raise NotImplementedError(
                        f"request field {field!r} is not in the PyTorch "
                        "port yet")
            seed = int(req.get("seed", self.requests))
            self.requests += 1
            resp = self._generate(rid, seed)
            self.served += 1
            return resp
        except Exception as e:      # the service never dies on a request
            self.errors += 1
            traceback.print_exc(file=sys.stderr)
            return {"id": rid, "error": f"{type(e).__name__}: {e}"}

    def _generate(self, rid, seed: int) -> dict:
        t_req = time.perf_counter()
        gen = torch.Generator(self.device).manual_seed(seed)
        bars = self.generate(gen).cpu().numpy()
        midis = [base64.b64encode(bars_to_midi(bars[i], self.cfg)).decode()
                 for i in range(bars.shape[0])]
        return {"id": rid, "midi_b64": midis,
                "density": float(bars.mean()),
                "latency_ms": round(1e3 * (time.perf_counter() - t_req), 1)}

    def _stats(self, rid) -> dict:
        cfg = self.cfg
        return {"id": rid, "stats": {
            "served": self.served, "errors": self.errors,
            "requests": self.requests, "step": self.step,
            "config": cfg.name, "samples": cfg.gen.num_samples,
            "bars": cfg.gen.num_bars,
            "uptime_s": round(time.perf_counter() - self.t_start, 1)}}


def serve_stream(service: Service, inp: TextIO, out: TextIO) -> int:
    """Answer request lines from ``inp`` on ``out`` until EOF, in order."""
    t0 = time.perf_counter()
    for line in inp:
        resp = service.handle(line)
        if resp is not None:
            out.write(json.dumps(resp) + "\n")
            out.flush()
    dt = time.perf_counter() - t0
    print(f"served {service.served} requests, {service.errors} errors in "
          f"{dt:.1f}s", file=sys.stderr)
    return 0


def serve_config(args: argparse.Namespace,
                 cfg: Optional[Config] = None) -> Config:
    """The config a ``serve`` invocation runs: ``cfg`` (a checkpoint's) or
    the named config, with the generation shape and the first-conv kernel
    flag from the command line."""
    cfg = get_config(args.config) if cfg is None else cfg
    model = cfg.model
    if args.use_pallas_conv1:
        model = dataclasses.replace(model, use_pallas_conv1=True)
    return cfg.replace(model=model, gen=GenSpec(
        num_bars=args.bars, num_samples=args.samples,
        interpolate=args.interpolate, sample_mode=args.sample_mode))


def restore_checkpoint(ckpt_dir: str, device, cfg_fn=None):
    """(config, state) of the newest restorable step in ``ckpt_dir`` on
    ``device``: the checkpoint's config, passed through ``cfg_fn`` when
    given (flags that do not change the state's layout), and a state
    made for it and overwritten from disk."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train.trainer import create_state

    manager = ckpt_io.make_manager(ckpt_dir)
    if manager.latest_step() is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    cfg = ckpt_io.restore_config(manager)
    if cfg_fn is not None:
        cfg = cfg_fn(cfg)
    _, state = create_state(cfg, device=device)
    state, _ = ckpt_io.restore(manager, state)
    return cfg, state


def _ema_model(state):
    """The state's EMA model, or None after printing _EMA_ERROR."""
    if state.ema_model is None:
        print(_EMA_ERROR, file=sys.stderr)
    return state.ema_model


def _checkpoint_model(args: argparse.Namespace, cfg_fn,
                      ema_note: str = "using EMA weights"):
    """(config, model) of the newest restorable step of --ckpt-dir on
    --device: the checkpoint's config, through ``cfg_fn``, wins over
    --config (with a note); with --ema the EMA weights, or None after
    printing the error when the checkpoint has none."""
    cfg, state = restore_checkpoint(args.ckpt_dir, args.device, cfg_fn)
    if args.config != cfg.name:
        print(f"note: checkpoint was trained with config {cfg.name!r}; "
              f"using it", file=sys.stderr)
    if not args.ema:
        return cfg, state.model
    model = _ema_model(state)
    if model is None:
        return None
    print(ema_note, file=sys.stderr)
    return cfg, model


def cmd_serve(args: argparse.Namespace) -> int:
    later = [f"--{f.replace('_', '-')}" for f in _LATER_FLAGS
             if getattr(args, f) not in (None, False)]
    if later:
        print(f"error: {', '.join(later)} not in the PyTorch port yet "
              "(see ROADMAP.md)", file=sys.stderr)
        return 2
    if args.ema and args.ckpt_dir is None:
        print("error: --ema serves a checkpoint's EMA weights; give "
              "--ckpt-dir", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    step = 0
    if args.ckpt_dir is not None:
        cfg, state = restore_checkpoint(
            args.ckpt_dir, args.device,
            lambda c: serve_config(args, c))
        model = state.model
        if args.ema:
            model = _ema_model(state)
            if model is None:
                return 2
        step = int(state.step)
        source = (f"{args.ckpt_dir} step {step}"
                  + (", EMA weights" if args.ema else ""))
    elif args.weights is not None:
        cfg = serve_config(args)
        model = build_model(cfg, device=args.device)
        sd = torch.load(args.weights, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        source = args.weights
    else:
        cfg = serve_config(args)
        model = build_model(cfg, device=args.device, seed=args.init_seed)
        source = f"random init, seed {args.init_seed}"
    service = Service(cfg, model, step)
    service.warm()
    print(f"serving {cfg.name} ({source}) on {service.device}: "
          f"{args.samples}x{args.bars} bars/request, ready in "
          f"{time.perf_counter() - t0:.1f}s; reading JSON lines on stdin",
          file=sys.stderr)
    return serve_stream(service, sys.stdin, sys.stdout)


# train flags of the JAX package that later slices of the port bring,
# with the ROADMAP.md item each waits for
_LATER_TRAIN_FLAGS = {"stream": "A13", "host_sharded": "A13"}


class _UsageError(ValueError):
    """A flag error found past argparse (e.g. a --meter the grid cannot
    represent). main() prints it as a one-line error; every other
    ValueError keeps its traceback."""


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _apply_midi_overrides(cfg: Config, args: argparse.Namespace) -> Config:
    """--max-events / --ignore-time-signature / --meter onto cfg.midi.
    These are ingestion knobs, applied to checkpoint-restored configs
    too."""
    from musicvae_tpu_torch.config import meter_grid

    kw = {}
    if args.max_events is not None:
        kw["max_events"] = args.max_events
    if args.ignore_time_signature:
        kw["ignore_time_signature"] = True
    if args.meter:
        try:
            num, den = (int(v) for v in args.meter.split("/"))
        except ValueError:
            raise _UsageError(f"--meter expects N/D (e.g. 3/4), "
                              f"got {args.meter!r}") from None
        try:
            kw.update(meter_grid(num, den, cfg.midi.steps_per_bar))
        except ValueError as e:
            raise _UsageError(str(e)) from None
    if kw:
        cfg = cfg.replace(midi=dataclasses.replace(cfg.midi, **kw))
    return cfg


def _read_midi_corpus(midi_glob: str, labels_path: Optional[str] = None):
    """(pieces, rc) of a MIDI glob: (bytes, chord, key) triples in sorted
    path order, a JSON sidecar {basename: {chord, key}} supplying labels
    (None where it has none), and rc 0; or (None, rc) after an error: 2
    for a label outside 0..23, 1 when nothing matches."""
    import glob

    sidecar = {}
    if labels_path:
        with open(labels_path) as f:
            sidecar = json.load(f)
    pieces = []
    for path in sorted(glob.glob(midi_glob)):
        with open(path, "rb") as f:
            data = f.read()
        lab = sidecar.get(os.path.basename(path), {})
        chord = lab.get("chord")
        key = lab.get("key")
        for name, v in (("chord", chord), ("key", key)):
            if v is not None and not 0 <= int(v) < 24:
                print(f"error: label {name}={v} for {path} out of "
                      f"range 0..23", file=sys.stderr)
                return None, 2
        pieces.append((data, chord, key))
    if not pieces:
        print(f"no MIDI files match {midi_glob}", file=sys.stderr)
        return None, 1
    return pieces, 0


def cmd_preprocess(args: argparse.Namespace) -> int:
    """MIDI glob (default: a synthetic corpus) → the ``.npz`` bar cache,
    on the host."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.data.synthetic import synth_corpus

    cfg = _apply_midi_overrides(get_config(args.config), args)
    if args.midi_glob:
        pieces, rc = _read_midi_corpus(args.midi_glob, args.labels)
        if rc:
            return rc
        infer = not args.no_infer_labels
    else:
        pieces = synth_corpus(args.synthetic_pieces, n_bars=32,
                              seed=cfg.train.seed, meter=cfg.midi.meter)
        infer = False  # synthetic pieces carry ground-truth labels
    ds = PianoRollDataset.from_corpus(pieces, cfg.midi, cfg.model.num_bars,
                                      infer_labels=infer)
    ds.save_npy(args.out)
    print(f"wrote {len(ds)} windows of {cfg.model.num_bars} bars to "
          f"{args.out}")
    return 0


def _check_cache_grid(ds, cfg: Config, path: str) -> Optional[str]:
    """None if the cache's quantization grid matches cfg.midi, else the
    error string: a cache built under another meter must never feed a
    model whose MidiSpec claims a different grid. Caches without grid
    metadata were all built on the 24/4 default."""
    g = ds.grid or (24, 4)
    cache_spq = g[0]
    cache_spb = (g[2] if len(g) > 2 else 0) or g[0] * g[1]
    if (cache_spq, cache_spb) != (cfg.midi.steps_per_quarter,
                                  cfg.midi.steps_per_bar):
        return (f"{path} was quantized on grid {cache_spq} steps/quarter x "
                f"{cache_spb} steps/bar but the config expects "
                f"{cfg.midi.steps_per_quarter}x{cfg.midi.steps_per_bar}; "
                f"re-run preprocess")
    return None


def _train_overrides(args: argparse.Namespace) -> dict:
    """The TrainSpec fields the command line sets."""
    return {k: v for k, v in (
        ("num_steps", args.steps),
        ("batch_size", args.batch_size),
        ("beta_schedule", args.beta_schedule),
        ("beta_cycle_steps", args.beta_cycle_steps),
        ("beta_warmup_steps", args.beta_warmup_steps),
        ("free_bits", args.free_bits),
        ("learning_rate", args.lr),
        ("lr_schedule", args.lr_schedule),
        ("lr_warmup_steps", args.lr_warmup_steps),
        ("lr_min_ratio", args.lr_min_ratio),
        ("grad_clip_norm", args.grad_clip),
        ("ema_decay", args.ema_decay),
        ("eval_every", args.eval_every),
        ("eval_batches", args.eval_batches),
        ("log_every", args.log_every),
        ("ckpt_every", args.ckpt_every),
        ("holdout_frac", args.holdout_frac),
        ("transpose_aug", args.transpose_aug),
        ("corpus_layout", args.corpus_layout),
    ) if v is not None}


def _width_overrides(args: argparse.Namespace) -> dict:
    """The ModelSpec widths the command line sets (capacity sweeps; the
    checkpoint stores the effective config)."""
    return {k: tuple(int(c) for c in v.split(","))
            for k, v in (("enc_channels", args.enc_channels),
                         ("dec_channels", args.dec_channels))
            if v is not None}


def _with_conv1_flag(cfg: Config, args: argparse.Namespace) -> Config:
    if not args.use_pallas_conv1:
        return cfg
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 use_pallas_conv1=True))


def train_config(args: argparse.Namespace) -> Config:
    """The config a fresh ``train`` invocation runs: the named config with
    the command line's overrides."""
    cfg = get_config(args.config)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                **_width_overrides(args)),
                      train=dataclasses.replace(cfg.train,
                                                **_train_overrides(args)))
    return _apply_midi_overrides(_with_conv1_flag(cfg, args), args)


def _refused(args: argparse.Namespace) -> int:
    """2 after naming the flags of later ROADMAP.md items, else 0."""
    later = [f"--{f.replace('_', '-')} (ROADMAP.md item {item})"
             for f, item in _LATER_TRAIN_FLAGS.items()
             if getattr(args, f, None) not in (None, False)]
    if getattr(args, "corpus_layout", None) == "sharded":
        later.append("--corpus-layout sharded (ROADMAP.md item A13)")
    if later:
        print(f"error: {', '.join(later)} not in the PyTorch port yet",
              file=sys.stderr)
        return 2
    return 0


def _resume(args, manager, overrides: dict):
    """(config, state) of the run ``--resume`` continues, or (None, rc)
    after an error: the checkpoint's config wins, the command line's
    train overrides apply over it, and the EMA weights follow a changed
    ``--ema-decay``."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train.trainer import create_state

    ckpt_cfg = ckpt_io.restore_config(manager)
    if (overrides.get("lr_schedule", ckpt_cfg.train.lr_schedule)
            != ckpt_cfg.train.lr_schedule):
        print(f"error: cannot change --lr-schedule on resume (the "
              f"checkpoint was trained with "
              f"{ckpt_cfg.train.lr_schedule!r}; its lr curve would jump); "
              f"start a fresh --ckpt-dir to train under another schedule",
              file=sys.stderr)
        return None, 2
    widths = {k: v for k, v in _width_overrides(args).items()
              if getattr(ckpt_cfg.model, k) != v}
    if widths:
        print(f"error: cannot change the model's widths on resume (the "
              f"checkpoint's model has enc_channels "
              f"{ckpt_cfg.model.enc_channels}, dec_channels "
              f"{ckpt_cfg.model.dec_channels}; asked for {widths})",
              file=sys.stderr)
        return None, 2
    _, state = create_state(_with_conv1_flag(ckpt_cfg, args),
                            device=args.device)
    state, cfg = ckpt_io.restore(manager, state)
    # the MIDI ingestion flags apply over the restored config too
    cfg = _apply_midi_overrides(_with_conv1_flag(cfg, args), args)
    if overrides:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
        print(f"resumed with CLI overrides: {overrides}", file=sys.stderr)
        # EMA toggled across the resume: on starts the average at the
        # resumed weights, off drops it
        if cfg.train.ema_decay > 0 and state.ema_model is None:
            state.ema_model = copy.deepcopy(state.model).requires_grad_(
                False)
            print("ema enabled on resume: average starts at the resumed "
                  "params", file=sys.stderr)
        elif cfg.train.ema_decay <= 0 and state.ema_model is not None:
            state.ema_model = None
    # the step actually restored: after a corrupt-latest fallback it is
    # older than the latest step
    print(f"resumed from step {int(state.step)}", file=sys.stderr)
    return cfg, state


def _load_cache(path: str, cfg: Config):
    """The bar cache at ``path`` for ``cfg``, or None after an error."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset

    ds = PianoRollDataset.load_npy(path)
    if ds.num_bars != cfg.model.num_bars:
        print(f"error: {path} has {ds.num_bars}-bar windows but config "
              f"{cfg.name!r} trains on {cfg.model.num_bars}-bar windows; "
              f"re-run preprocess with --config {cfg.name}", file=sys.stderr)
        return None
    err = _check_cache_grid(ds, cfg, path)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return None
    return ds


def _train_data(args: argparse.Namespace, cfg: Config):
    """The training corpus for ``cfg``: the bar cache of --data, else the
    --midi-glob tensorized in-process (labels from --labels, else
    inferred), else a synthetic corpus; None after an error."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.data.synthetic import synth_corpus

    if args.data:
        return _load_cache(args.data, cfg)
    if args.midi_glob:
        pieces, rc = _read_midi_corpus(args.midi_glob, args.labels)
        if rc:
            return None
        ds = PianoRollDataset.from_corpus(pieces, cfg.midi,
                                          cfg.model.num_bars,
                                          infer_labels=True)
        print(f"tensorized {len(pieces)} MIDI files from {args.midi_glob}",
              file=sys.stderr)
        return ds
    return PianoRollDataset.from_corpus(
        synth_corpus(64, n_bars=32, seed=cfg.train.seed,
                     meter=cfg.midi.meter),
        cfg.midi, cfg.model.num_bars)


def cmd_train(args: argparse.Namespace) -> int:
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train.preemption import GracefulStop
    from musicvae_tpu_torch.train.trainer import train
    from musicvae_tpu_torch.utils.logging import MetricsLogger

    if _refused(args):
        return 2
    cfg = train_config(args)
    if args.data and not os.path.exists(args.data):
        print(f"error: --data {args.data} does not exist", file=sys.stderr)
        return 2
    manager = ckpt_io.make_manager(args.ckpt_dir, cfg.train.ckpt_keep)
    state = None
    if args.resume and manager.latest_step() is not None:
        cfg, state = _resume(args, manager, _train_overrides(args))
        if cfg is None:
            return state
    elif manager.latest_step() is not None:
        # a fresh run into a directory holding another run's steps would
        # have its saves refused (they are not newer) and a later --resume
        # would restore the other run
        print(f"error: {args.ckpt_dir} already contains a checkpoint at "
              f"step {manager.latest_step()}; pass --resume to continue "
              f"it or use a fresh --ckpt-dir", file=sys.stderr)
        return 2
    # the data under the final config (the checkpoint's on resume: a run
    # trained with --meter 3/4 re-tensorizes on the 3/4 grid)
    ds = _train_data(args, cfg)
    if ds is None:
        return 2
    eval_ds = best_manager = None
    if cfg.train.eval_every > 0:
        ds, eval_ds = ds.split(cfg.train.holdout_frac, seed=cfg.train.seed)
        best_manager = ckpt_io.make_manager(
            os.path.join(args.ckpt_dir, "best"), keep=1)
        print(f"holdout: {len(eval_ds)} eval windows ({len(ds)} train), "
              f"eval every {cfg.train.eval_every} steps", file=sys.stderr)
    print(f"dataset: {len(ds)} windows; device: {args.device}",
          file=sys.stderr)
    logger = MetricsLogger(args.log_dir)
    # SIGTERM/SIGINT: finish the dispatch in flight, checkpoint the exact
    # step, exit 0 with a resume hint
    try:
        with GracefulStop() as stop:
            _, state, metrics = train(
                cfg, ds, ckpt_manager=manager, log_fn=logger, state=state,
                eval_data=eval_ds, best_ckpt_manager=best_manager,
                stop=stop, device=args.device)
    finally:
        logger.close()
    if best_manager is not None:
        best_manager.wait_until_finished()
    ckpt_io.save(manager, state, cfg, wait=True)
    if stop.requested:
        print(f"preempted: checkpoint saved at step {int(state.step)}; "
              f"continue with --resume", file=sys.stderr)
        return 0
    print(f"final metrics: { {k: float(v) for k, v in metrics.items()} }")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """Reconstruction metrics of a checkpoint on a bar cache: every window
    of the cache scored once in a fixed order (a ``default_rng(0)``
    permutation), up to ``--batches`` batches; a final partial batch is
    padded to the batch size with weight-0 rows, and the means are
    weighted by real windows."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.utils.metrics import make_eval_fn

    loaded = _checkpoint_model(args, lambda c: _apply_midi_overrides(c, args),
                               ema_note="scoring EMA weights")
    if loaded is None:
        return 2
    cfg, model = loaded
    if args.midi_glob:
        pieces, rc = _read_midi_corpus(args.midi_glob)
        if rc:
            return rc
        ds = PianoRollDataset.from_corpus(pieces, cfg.midi,
                                          cfg.model.num_bars,
                                          infer_labels=True)
    elif args.data:
        ds = _load_cache(args.data, cfg)
        if ds is None:
            return 2
    else:
        print("error: eval needs --data or --midi-glob", file=sys.stderr)
        return 2
    dev = next(model.parameters()).device
    eval_fn = make_eval_fn(cfg, model)
    b = cfg.train.batch_size
    acc: dict = {}
    real = []
    perm = np.random.default_rng(0).permutation(len(ds)).astype(np.int32)
    for i in range(min(args.batches, -(-len(perm) // b))):
        idx = perm[i * b:(i + 1) * b]
        n_real = idx.shape[0]
        w = None
        if n_real < b:        # tail: pad by wrapping, zero-weight the pad
            idx = np.resize(idx, b)
            w = torch.zeros(b, device=dev)
            w[:n_real] = 1.0
        x = torch.from_numpy(ds.batch(idx, x_dtype=np.uint8)["x"]).to(dev)
        eps = torch.randn((b, cfg.model.z_dim), device=dev,
                          generator=torch.Generator(dev).manual_seed(i))
        for k, v in eval_fn(x, eps, w).items():
            acc.setdefault(k, []).append(float(v))
        real.append(n_real)
    wt = np.asarray(real, np.float64)
    means = {k: float(np.dot(v, wt) / wt.sum()) for k, v in acc.items()}
    print(" ".join(f"{k}={v:.5g}" for k, v in sorted(means.items())))
    return 0


def _gen_spec_from_args(args: argparse.Namespace) -> GenSpec:
    return GenSpec(num_bars=args.bars, num_samples=args.samples,
                   interpolate=args.interpolate,
                   temperature=args.temperature,
                   sample_mode=args.sample_mode,
                   sample_temperature=args.sample_temperature)


def _load_gen_state(args: argparse.Namespace, gen: GenSpec, what: str):
    """(cfg, model) for generate and eval-gen, with ``gen`` applied: the
    newest restorable step of --ckpt-dir on the device, its config winning
    over --config (with a note), or, with no checkpoint there, random
    weights for --config with a warning. With --ema the EMA weights; None
    after printing the error when there are none."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io

    if ckpt_io.make_manager(args.ckpt_dir).latest_step() is not None:
        return _checkpoint_model(
            args, lambda c: _apply_midi_overrides(c.replace(gen=gen), args))
    cfg = _apply_midi_overrides(get_config(args.config).replace(gen=gen),
                                args)
    print(f"warning: no checkpoint found, {what} from random init",
          file=sys.stderr)
    if args.ema:
        print(_EMA_ERROR, file=sys.stderr)
        return None
    return cfg, build_model(cfg, device=args.device, seed=cfg.train.seed)


def _make_packed_gen(gen):
    """(dispatch, to_host) around a sweep function: ``dispatch`` packs the
    sweep's bars to 1 bit a cell on the card (ops/pack.py), ``to_host``
    pulls the packed bytes (1/8 of the bars) and unpacks them to uint8 on
    the host."""
    from musicvae_tpu_torch.ops.pack import pack_bits, unpack_bits_np

    def dispatch(*a, **kw) -> torch.Tensor:
        return pack_bits(gen(*a, **kw))

    def to_host(packed: torch.Tensor) -> np.ndarray:
        return unpack_bits_np(packed.cpu().numpy())

    return dispatch, to_host


def _seed_from_midi(cfg: Config, model: PianoRollVAE, path: str,
                    encode: bool, num_samples: int,
                    generator: torch.Generator):
    """(sweep kwargs, error or None) for continuing a real MIDI file: its
    LAST bar becomes every sample's first prev-bar condition
    (``seed_bar``, uint8 on the model's device); with ``encode`` its last
    ``model.num_bars``-bar window (zero-padded at the front when the piece
    is shorter) is encoded and a posterior draw a sample pins the first
    phrase's latent (``z0``)."""
    from musicvae_tpu_torch.generate.sampler import make_encode_fn
    from musicvae_tpu_torch.midi import tensorize

    dev = next(model.parameters()).device
    with open(path, "rb") as f:
        data = f.read()
    bars = tensorize.corpus_to_bars([data], cfg.midi, as_uint8=True)[0]
    if bars.shape[0] == 0:
        return {}, f"{path} contains no bars after tensorization"
    if not cfg.model.use_prev_bar and not encode:
        print(f"warning: config {cfg.name!r} has use_prev_bar=False — the "
              f"seed bar does not condition the decoder; use --encode to "
              f"seed through the latent instead", file=sys.stderr)
    seed_bar = torch.from_numpy(bars[-1]).to(dev)[None].repeat(
        num_samples, 1, 1)
    kw = {"seed_bar": seed_bar}
    if encode:
        nb = cfg.model.num_bars
        window = bars[-nb:]
        if window.shape[0] < nb:
            window = np.concatenate(
                [np.zeros((nb - window.shape[0],) + window.shape[1:],
                          np.uint8), window], axis=0)
        x = torch.from_numpy(window).to(dev, torch.float32)[None].repeat(
            num_samples, 1, 1, 1)
        kw.update(make_encode_fn(cfg, model)(x, generator))
    return kw, None


def _later_gen_flags(args: argparse.Namespace) -> int:
    """2 after naming the cond kind's flags (ROADMAP.md item A9), else
    0."""
    later = [f"--{f} (ROADMAP.md item A9)" for f in ("chord", "key")
             if getattr(args, f) is not None]
    if later:
        print(f"error: {', '.join(later)} not in the PyTorch port yet",
              file=sys.stderr)
        return 2
    return 0


def cmd_generate(args: argparse.Namespace) -> int:
    """Bar-by-bar sampling from a checkpoint (or random weights) into
    ``--out-dir``: ``rolls.npy`` (uint8 [samples, bars, T, P]) and up to
    ``--write-midis`` ``sample_NNNN.mid`` files."""
    if _later_gen_flags(args):
        return 2
    loaded = _load_gen_state(args, _gen_spec_from_args(args),
                             what="generating")
    if loaded is None:
        return 2
    cfg, model = loaded
    dev = next(model.parameters()).device
    # one generator for the command: the encodes, then the sweep
    gen = torch.Generator(dev).manual_seed(args.seed)
    kw = {}
    if args.seed_midi:
        seed_kw, err = _seed_from_midi(cfg, model, args.seed_midi,
                                       args.encode, args.samples, gen)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        kw.update(seed_kw)
    elif args.encode:
        print("error: --encode needs --seed-midi", file=sys.stderr)
        return 2
    if args.interp_midi_b:
        if not (args.seed_midi and args.encode and args.interpolate):
            print("error: --interp-midi-b morphs between two encoded "
                  "pieces; it needs --seed-midi, --encode and "
                  "--interpolate", file=sys.stderr)
            return 2
        kw_b, err = _seed_from_midi(cfg, model, args.interp_midi_b, True,
                                    args.samples, gen)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        # B's encoded posterior pins the slerp END; B's seed bar is
        # discarded — the sweep starts from A's material
        kw["z1"] = kw_b["z0"]
    dispatch, to_host = _make_packed_gen(make_generate_fn(cfg, model))
    t0 = time.perf_counter()
    packed = dispatch(gen, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    bars = to_host(packed)
    t2 = time.perf_counter()
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(min(args.write_midis, bars.shape[0])):
        path = os.path.join(args.out_dir, f"sample_{i:04d}.mid")
        with open(path, "wb") as f:
            f.write(bars_to_midi(bars[i], cfg))
    np.save(os.path.join(args.out_dir, "rolls.npy"), bars)
    t3 = time.perf_counter()
    print(f"timing: sweep_ms={1e3 * (t1 - t0):.3f} "
          f"pack_pull_ms={1e3 * (t2 - t1):.3f} "
          f"export_ms={1e3 * (t3 - t2):.3f}", file=sys.stderr)
    print(f"generated {bars.shape[0]} x {bars.shape[1]} bars -> "
          f"{args.out_dir}")
    return 0


def cmd_eval_gen(args: argparse.Namespace) -> int:
    """Sample-quality statistics of generations, optionally against a
    reference corpus (utils/genmetrics.py). Prints one JSON object:
    {"samples", "bars_per_sample", "gen": stats[, "ref": stats,
    "compare": divergences]}."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.utils.genmetrics import (bar_stats,
                                                     compare_stats,
                                                     to_jsonable)

    loaded = _load_gen_state(args, _gen_spec_from_args(args),
                             what="scoring")
    if loaded is None:
        return 2
    cfg, model = loaded
    dev = next(model.parameters()).device
    dispatch, to_host = _make_packed_gen(make_generate_fn(cfg, model))
    bars = to_host(dispatch(torch.Generator(dev).manual_seed(args.seed)))
    gstats = bar_stats(bars)
    result = {"samples": int(bars.shape[0]),
              "bars_per_sample": int(bars.shape[1]),
              "gen": to_jsonable(gstats)}
    ref_ds = None
    if args.data:
        ref_ds = PianoRollDataset.load_npy(args.data)
        err = _check_cache_grid(ref_ds, cfg, args.data)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    elif args.midi_glob:
        pieces, rc = _read_midi_corpus(args.midi_glob)
        if rc:
            return rc
        # bar_stats is bar-level: 1-bar windows keep every bar of pieces
        # shorter than the model's window
        try:
            ref_ds = PianoRollDataset.from_corpus(pieces, cfg.midi, 1)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if ref_ds is not None:
        rstats = bar_stats(np.asarray(ref_ds.bars))
        result["ref"] = to_jsonable(rstats)
        result["compare"] = to_jsonable(compare_stats(gstats, rstats))
    print(json.dumps(result))
    return 0


def cmd_reconstruct(args: argparse.Namespace) -> int:
    """MIDI in → encode → posterior sample → teacher-forced decode →
    binarize → MIDI out into --out-dir, with the cell precision, recall
    and F1 of each file's reconstruction against its input roll,
    crop-masked. Each file goes through fixed [1, num_bars, T, P] windows
    (the tail zero-padded), window w with the posterior seed --seed + w."""
    import glob

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.generate.sampler import reconstruct_fn
    from musicvae_tpu_torch.midi import tensorize

    if ckpt_io.make_manager(args.ckpt_dir).latest_step() is None:
        print(f"error: no checkpoint in {args.ckpt_dir}; reconstruct needs "
              f"a trained model", file=sys.stderr)
        return 2
    loaded = _checkpoint_model(args, lambda c: _apply_midi_overrides(c, args))
    if loaded is None:
        return 2
    cfg, model = loaded
    dev = next(model.parameters()).device
    rec = reconstruct_fn(cfg, model)
    paths = sorted(glob.glob(args.midi_glob))
    if not paths:
        print(f"no MIDI files match {args.midi_glob}", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    nb = cfg.model.num_bars
    lo, hi = cfg.midi.pitch_lo, cfg.midi.pitch_hi
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        bars = tensorize.corpus_to_bars([data], cfg.midi, as_uint8=True)[0]
        n = bars.shape[0]
        if n == 0:
            print(f"warning: {path} has no bars; skipped", file=sys.stderr)
            continue
        pad = (-n) % nb
        if pad:
            bars = np.concatenate(
                [bars, np.zeros((pad,) + bars.shape[1:], np.uint8)], axis=0)
        x_all = torch.from_numpy(bars).to(dev, torch.float32)
        outs = [rec(x_all[w * nb:(w + 1) * nb][None],
                    torch.Generator(dev).manual_seed(args.seed + w))
                for w in range(bars.shape[0] // nb)]
        roll = torch.cat([o[0] for o in outs]).to(torch.uint8).cpu(
            ).numpy()[:n]
        # cell-level reconstruction quality vs the input, crop-masked
        t = bars[:n, :, lo:hi].astype(np.float64)
        r = roll[:, :, lo:hi].astype(np.float64)
        tp = float((r * t).sum())
        prec = tp / max(r.sum(), 1.0)
        recall = tp / max(t.sum(), 1.0)
        f1 = 2 * prec * recall / max(prec + recall, 1e-9)
        out_path = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(path))[0] + ".recon.mid")
        with open(out_path, "wb") as f:
            f.write(bars_to_midi(roll, cfg))
        print(f"{path}: {n} bars -> {out_path}  "
              f"precision={prec:.3f} recall={recall:.3f} f1={f1:.3f}")
    return 0


def cmd_describe(args: argparse.Namespace) -> int:
    """What a checkpoint directory holds, read-only and without a device:
    the embedded config, the steps and the quarantined ones, the
    best-checkpoint sidecar, and the parameter count of a model built on
    the ``meta`` device (the GRU's r/z hidden biases, constants that the
    JAX model does not have, are not counted)."""
    import glob

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.models.layers import GRUCell

    if not os.path.isdir(args.ckpt_dir):
        print(f"error: no checkpoint in {args.ckpt_dir}", file=sys.stderr)
        return 2
    manager = ckpt_io.make_manager(args.ckpt_dir)
    steps = manager.all_steps()
    if not steps:
        print(f"error: no checkpoint in {args.ckpt_dir}", file=sys.stderr)
        return 2
    cfg = ckpt_io.restore_config(manager)
    with torch.device("meta"):
        model = PianoRollVAE(cfg.model, cfg.midi, cfg.train.remat_encoder)
    n_params = sum(p.numel() for p in model.parameters()) - sum(
        2 * m.weight_hh.shape[1] for m in model.modules()
        if isinstance(m, GRUCell))
    quarantined = sorted(
        os.path.basename(p) for pat in ("*.corrupt", "*.corrupt.*")
        for p in glob.glob(os.path.join(args.ckpt_dir, pat)))
    info = {
        "config": cfg.name,
        "model_kind": cfg.model.kind,
        "params": n_params,
        "steps": steps,
        "latest_step": steps[-1],
        "quarantined": quarantined,
        "roll": f"{cfg.midi.steps_per_bar}x{cfg.midi.num_pitches}",
        "meter": "{}/{}".format(*cfg.midi.meter),
        "stem": cfg.model.stem,
        "temporal": cfg.model.temporal,
        "window_bars": cfg.model.num_bars,
        "dtype": cfg.model.dtype,
        "ema": cfg.train.ema_decay > 0,
    }
    sidecar = os.path.join(args.ckpt_dir, "best", "best_metric.json")
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                info["best"] = json.load(f)
        except (OSError, ValueError):
            info["best"] = "unreadable"
    print(json.dumps(info, indent=2))
    return 0


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")


def _add_midi_flags(p: argparse.ArgumentParser) -> None:
    """The MIDI-ingestion knobs of every command that reads .mid files,
    applied after a checkpoint's config is restored."""
    p.add_argument("--max-events", type=_positive_int, default=None,
                   help="max notes per MIDI file (MidiSpec.max_events, "
                        "default 4096)")
    p.add_argument("--ignore-time-signature", action="store_true",
                   help="tensorize files whose declared time signature "
                        "does not match the config's bar length anyway "
                        "(bar boundaries follow the config, not the file; "
                        "default is a hard error)")
    p.add_argument("--meter", default=None, metavar="N/D",
                   help="ingest in this meter with exact bar boundaries "
                        "(config.meter_grid): 3/4, 6/8, 2/4, ... adapt the "
                        "grid resolution of the 96-step bar; 5/4 and 7/8 "
                        "adapt the bar length (120, 84 steps). Exports "
                        "declare the original meter")


def _add_gen_flags(p: argparse.ArgumentParser, samples: int) -> None:
    """The sweep's shape and sampling flags (GenSpec)."""
    p.add_argument("--bars", type=int, default=16)
    p.add_argument("--samples", type=int, default=samples)
    p.add_argument("--interpolate", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="latent-space z scale")
    p.add_argument("--sample-mode", choices=["threshold", "bernoulli"],
                   default="threshold",
                   help="bar output: deterministic binarize or a "
                        "stochastic per-cell Bernoulli draw")
    p.add_argument("--sample-temperature", type=float, default=1.0,
                   help="Bernoulli mode: sigmoid(logits/T) sharpening")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", action="store_true",
                   help="the checkpoint's EMA weights (requires training "
                        "with --ema-decay)")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m musicvae_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("preprocess", help="MIDI → piano-roll window cache "
                                          "(host only)")
    p.add_argument("--config", default="c2_gru_4bar")
    _add_midi_flags(p)
    p.add_argument("--midi-glob", default=None,
                   help="glob of .mid files (default: synthetic corpus)")
    p.add_argument("--synthetic-pieces", type=int, default=64)
    p.add_argument("--labels", default=None,
                   help="JSON sidecar {basename: {'chord': c, 'key': k}} "
                        "overriding inferred labels for those files")
    p.add_argument("--no-infer-labels", action="store_true",
                   help="pin unlabeled real-MIDI chord/key to 0 instead of "
                        "inferring them from the rolls")
    p.add_argument("--out", default="data/rolls.npz")
    p.set_defaults(fn=cmd_preprocess)
    p = sub.add_parser("serve", help="persistent generation service "
                                     "(JSON lines on stdin/stdout)")
    p.add_argument("--config", default="c2_gru_4bar")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--ckpt-dir", default=None,
                     help="serve the newest restorable step of this "
                          "checkpoint directory (train --ckpt-dir), with "
                          "its config")
    src.add_argument("--weights", default=None, metavar="PT",
                     help="torch.save of the port's state dict (e.g. "
                          "checkpoints/convert.py flax_params_to_state_dict "
                          "of trained JAX params)")
    src.add_argument("--init-seed", type=int, default=0,
                     help="random weights from this seed (default 0) when "
                          "no --ckpt-dir or --weights is given")
    p.add_argument("--ema", action="store_true",
                   help="with --ckpt-dir: serve the EMA weights (requires "
                        "training with --ema-decay)")
    p.add_argument("--bars", type=int, default=16)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--interpolate", action="store_true")
    p.add_argument("--sample-mode", choices=["threshold", "bernoulli"],
                   default="threshold")
    p.add_argument("--use-pallas-conv1", action="store_true",
                   help="first encoder conv through the hand-written CUDA "
                        "kernel (ModelSpec.use_pallas_conv1)")
    _add_device(p)
    for flag in ("port", "coalesce", "reload_every"):
        p.add_argument(f"--{flag.replace('_', '-')}", default=None,
                       help="not in the PyTorch port yet")
    for flag in ("pipeline", "warm_seed"):
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train", help="train a config")
    p.add_argument("--config", default="c2_gru_4bar")
    _add_midi_flags(p)
    p.add_argument("--data", default=None,
                   help="npz bar cache from preprocess")
    p.add_argument("--midi-glob", default=None,
                   help="train straight from .mid files (tensorized "
                        "in-process; labels from --labels, else inferred); "
                        "--data takes precedence. Default with neither: a "
                        "synthetic corpus")
    p.add_argument("--labels", default=None,
                   help="with --midi-glob: JSON sidecar {basename: {chord, "
                        "key}} as in preprocess")
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    p.add_argument("--resume", action="store_true",
                   help="continue the newest restorable step in --ckpt-dir "
                        "(its config wins; the flags given override it)")
    p.add_argument("--steps", type=int, default=None,
                   help="total steps (a resumed run stops at this step)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--lr", type=float, default=None,
                   help="Adam learning rate (config default)")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default=None)
    p.add_argument("--lr-warmup-steps", type=int, default=None)
    p.add_argument("--lr-min-ratio", type=float, default=None)
    p.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--beta-schedule", choices=["linear", "cyclical"],
                   default=None)
    p.add_argument("--beta-cycle-steps", type=int, default=None)
    p.add_argument("--beta-warmup-steps", type=int, default=None)
    p.add_argument("--free-bits", type=float, default=None,
                   help="KL floor in nats per latent dimension (0 = off)")
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--eval-every", type=int, default=None,
                   help="held-out eval every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None,
                   help="metrics log cadence in steps; also bounds the "
                        "steps per dispatch")
    p.add_argument("--ckpt-every", type=int, default=None,
                   help="checkpoint cadence in steps, 0 = off (the final "
                        "and preemption saves still happen)")
    p.add_argument("--enc-channels", default=None,
                   help="comma-separated ModelSpec.enc_channels override "
                        "(stored in the checkpoint)")
    p.add_argument("--dec-channels", default=None,
                   help="comma-separated ModelSpec.dec_channels override")
    p.add_argument("--transpose-aug", type=int, default=None,
                   help="pitch-transpose augmentation: uniform per-example "
                        "shift in [-K, +K] semitones per step (0 = off)")
    p.add_argument("--holdout-frac", type=float, default=None)
    p.add_argument("--corpus-layout", choices=["replicated", "sharded"],
                   default=None)
    p.add_argument("--use-pallas-conv1", action="store_true",
                   help="first encoder conv, forward and backward, through "
                        "the hand-written CUDA kernels")
    _add_device(p)
    for flag in ("stream", "host_sharded"):
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="reconstruction metrics of a "
                                    "checkpoint on a bar cache or MIDI")
    p.add_argument("--config", default="c2_gru_4bar",
                   help="only compared with the checkpoint's own")
    _add_midi_flags(p)
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    p.add_argument("--data", default=None,
                   help="npz bar cache from preprocess")
    p.add_argument("--midi-glob", default=None,
                   help="score raw .mid files directly (alternative to "
                        "--data)")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--ema", action="store_true",
                   help="score the checkpoint's EMA weights (requires "
                        "training with --ema-decay)")
    _add_device(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("eval-gen",
                       help="sample-quality statistics of generations, "
                            "optionally against a reference corpus")
    p.add_argument("--config", default="c2_gru_4bar")
    _add_midi_flags(p)
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    p.add_argument("--data", default=None,
                   help="npz cache from preprocess: the reference corpus")
    p.add_argument("--midi-glob", default=None,
                   help="compare against .mid files directly (tensorized "
                        "in-process); --data takes precedence")
    _add_gen_flags(p, samples=64)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_gen)

    p = sub.add_parser("generate", help="bar-by-bar autoregressive sampling")
    p.add_argument("--config", default="c2_gru_4bar")
    _add_midi_flags(p)
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    _add_gen_flags(p, samples=4)
    for flag in ("chord", "key"):
        p.add_argument(f"--{flag}", type=int, default=None,
                       help="conditional models: not in the PyTorch port "
                            "yet")
    p.add_argument("--seed-midi", default=None,
                   help="continue from real music: the file's last bar "
                        "seeds the prev-bar conditioning")
    p.add_argument("--encode", action="store_true",
                   help="with --seed-midi: also start the latent path "
                        "from the encoded posterior of the file's last "
                        "window instead of the prior")
    p.add_argument("--interp-midi-b", default=None,
                   help="morph between two real pieces: with --seed-midi A "
                        "--encode --interpolate, the sweep slerps from A's "
                        "encoded latent to this file's")
    p.add_argument("--out-dir", default="generated")
    p.add_argument("--write-midis", type=int, default=8)
    _add_device(p)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("reconstruct",
                       help="MIDI in -> encode -> decode -> MIDI out "
                            "(eval-time reconstruction + P/R/F1)")
    p.add_argument("--config", default="c2_gru_4bar")
    _add_midi_flags(p)
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    p.add_argument("--midi-glob", required=True,
                   help="glob of .mid files to reconstruct")
    p.add_argument("--out-dir", default="reconstructed")
    p.add_argument("--seed", type=int, default=0,
                   help="posterior-sample seed of the first window")
    p.add_argument("--ema", action="store_true",
                   help="reconstruct with the checkpoint's EMA weights "
                        "(requires training with --ema-decay)")
    _add_device(p)
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("describe",
                       help="inspect a checkpoint directory (config, "
                            "steps, best metric, param count); read-only, "
                            "touches no device")
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    p.set_defaults(fn=cmd_describe)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from musicvae_tpu_torch.checkpoints.io import OrbaxLayoutError

    args = make_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, OrbaxLayoutError, _UsageError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except SMFError as e:        # malformed or unsupported MIDI input
        print(f"error: malformed MIDI: {e}", file=sys.stderr)
        return 2
