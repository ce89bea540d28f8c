"""Command line: ``python -m musicvae_tpu_torch`` ``train``, ``eval``,
``describe`` and ``serve``.

``train`` is the counterpart of the JAX package's cli.py ``cmd_train`` for
the resident data path: it trains a config on a bar cache (the ``.npz`` that
``python -m musicvae_tpu preprocess`` writes) on the card, checkpoints into
``--ckpt-dir`` (checkpoints/io.py), continues a run with ``--resume``, logs
JSON lines under ``--log-dir`` and prints the final metrics. A SIGTERM or
^C saves the exact step and exits 0. ``eval`` scores a checkpoint on a bar
cache (``cmd_eval``), ``describe`` reports what a checkpoint directory
holds without touching a device (``cmd_describe``). MIDI ingestion,
streaming and the sharded corpus are later items of ROADMAP.md; their
flags are parsed and refused.

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

import torch

from musicvae_tpu_torch.config import Config, GenSpec, get_config
from musicvae_tpu_torch.generate.sampler import bars_to_midi, make_generate_fn
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


def cmd_serve(args: argparse.Namespace) -> int:
    later = [f"--{f.replace('_', '-')}" for f in _LATER_FLAGS
             if getattr(args, f) not in (None, False)]
    if args.sample_mode != "threshold":
        later.append(f"--sample-mode {args.sample_mode}")
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


# train and eval flags of the JAX package that later slices of the port
# bring, with the ROADMAP.md item each waits for
_LATER_TRAIN_FLAGS = {"midi_glob": "A7", "labels": "A7", "stream": "A13",
                      "host_sharded": "A13"}


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
    return _with_conv1_flag(cfg, args)


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
    cfg = _with_conv1_flag(cfg, args)
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


def cmd_train(args: argparse.Namespace) -> int:
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train.preemption import GracefulStop
    from musicvae_tpu_torch.train.trainer import train
    from musicvae_tpu_torch.utils.logging import MetricsLogger

    if _refused(args):
        return 2
    cfg = train_config(args)
    if not os.path.exists(args.data):
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
    # the data under the final config (the checkpoint's on resume)
    ds = _load_cache(args.data, cfg)
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
    import numpy as np

    from musicvae_tpu_torch.utils.metrics import make_eval_fn

    if _refused(args):
        return 2
    cfg, state = restore_checkpoint(args.ckpt_dir, args.device)
    if args.config != cfg.name:
        print(f"note: checkpoint was trained with config {cfg.name!r}; "
              f"using it", file=sys.stderr)
    model = state.model
    if args.ema:
        model = _ema_model(state)
        if model is None:
            return 2
        print("scoring EMA weights", file=sys.stderr)
    if not args.data:
        print("error: eval needs --data", file=sys.stderr)
        return 2
    ds = _load_cache(args.data, cfg)
    if ds is None:
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


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m musicvae_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    for flag in ("port", "coalesce", "reload_every"):
        p.add_argument(f"--{flag.replace('_', '-')}", default=None,
                       help="not in the PyTorch port yet")
    for flag in ("pipeline", "warm_seed"):
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train", help="train a config on a bar cache")
    p.add_argument("--config", default="c2_gru_4bar")
    p.add_argument("--data", required=True,
                   help="npz bar cache (python -m musicvae_tpu preprocess)")
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    for flag in ("midi_glob", "labels"):
        p.add_argument(f"--{flag.replace('_', '-')}", default=None,
                       help="not in the PyTorch port yet")
    for flag in ("stream", "host_sharded"):
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="reconstruction metrics of a "
                                    "checkpoint on a bar cache")
    p.add_argument("--config", default="c2_gru_4bar",
                   help="only compared with the checkpoint's own")
    p.add_argument("--ckpt-dir", default="checkpoints_out")
    p.add_argument("--data", default=None,
                   help="npz bar cache (python -m musicvae_tpu preprocess)")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--ema", action="store_true",
                   help="score the checkpoint's EMA weights (requires "
                        "training with --ema-decay)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--midi-glob", default=None,
                   help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_eval)

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
    except (FileNotFoundError, OrbaxLayoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
