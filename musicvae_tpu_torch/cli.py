"""Command line: ``python -m musicvae_tpu_torch serve`` and ``train``.

``train`` is the counterpart of the JAX package's cli.py ``cmd_train`` for
the resident data path: it trains a config on a bar cache (the ``.npz`` that
``python -m musicvae_tpu preprocess`` writes) on the card, logs JSON lines
under ``--log-dir`` and prints the final metrics. Checkpoints, resume, MIDI
ingestion, streaming and the sharded corpus are later items of ROADMAP.md;
their flags are parsed and refused.

``serve`` is the counterpart of ``cmd_serve`` with its default
stdin transport (``_serve_stdin_serial``): a persistent generation service
speaking the line-delimited JSON protocol of docs/SERVING.md.

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
_LATER_FLAGS = ("port", "coalesce", "reload_every", "pipeline", "ckpt_dir",
                "ema", "warm_seed")
_LATER_FIELDS = ("seed_midi_b64",)
_LATER_CMDS = ("reload",)


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


def serve_config(args: argparse.Namespace) -> Config:
    """The config a ``serve`` invocation runs: the named config with the
    generation shape and the first-conv kernel flag from the command
    line."""
    cfg = get_config(args.config)
    model = cfg.model
    if args.use_pallas_conv1:
        model = dataclasses.replace(model, use_pallas_conv1=True)
    return cfg.replace(model=model, gen=GenSpec(
        num_bars=args.bars, num_samples=args.samples,
        interpolate=args.interpolate, sample_mode=args.sample_mode))


def cmd_serve(args: argparse.Namespace) -> int:
    later = [f"--{f.replace('_', '-')}" for f in _LATER_FLAGS
             if getattr(args, f) not in (None, False)]
    if args.sample_mode != "threshold":
        later.append(f"--sample-mode {args.sample_mode}")
    if later:
        print(f"error: {', '.join(later)} not in the PyTorch port yet "
              "(see ROADMAP.md)", file=sys.stderr)
        return 2
    cfg = serve_config(args)
    t0 = time.perf_counter()
    if args.weights is not None:
        model = build_model(cfg, device=args.device)
        state = torch.load(args.weights, map_location="cpu",
                           weights_only=True)
        model.load_state_dict(state, strict=True)
        source = args.weights
    else:
        model = build_model(cfg, device=args.device, seed=args.init_seed)
        source = f"random init, seed {args.init_seed}"
    service = Service(cfg, model)
    service.warm()
    print(f"serving {cfg.name} ({source}) on {service.device}: "
          f"{args.samples}x{args.bars} bars/request, ready in "
          f"{time.perf_counter() - t0:.1f}s; reading JSON lines on stdin",
          file=sys.stderr)
    return serve_stream(service, sys.stdin, sys.stdout)


# train flags of the JAX package that later slices of the port bring, with
# the ROADMAP.md item each waits for
_LATER_TRAIN_FLAGS = {
    "ckpt_dir": "A8", "resume": "A8", "ckpt_every": "A8",
    "midi_glob": "A7", "labels": "A7", "stream": "A13",
    "host_sharded": "A13", "enc_channels": "A12", "dec_channels": "A12",
}


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


def train_config(args: argparse.Namespace) -> Config:
    """The config a ``train`` invocation runs: the named config with the
    command line's overrides."""
    cfg = get_config(args.config)
    overrides = {k: v for k, v in (
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
        ("holdout_frac", args.holdout_frac),
        ("transpose_aug", args.transpose_aug),
        ("corpus_layout", args.corpus_layout),
    ) if v is not None}
    # no checkpoints yet: their cadence must not shape the dispatch size
    overrides["ckpt_every"] = 0
    model = cfg.model
    if args.use_pallas_conv1:
        model = dataclasses.replace(model, use_pallas_conv1=True)
    return cfg.replace(model=model,
                       train=dataclasses.replace(cfg.train, **overrides))


def cmd_train(args: argparse.Namespace) -> int:
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.train.trainer import train
    from musicvae_tpu_torch.utils.logging import MetricsLogger

    later = [f"--{f.replace('_', '-')} (ROADMAP.md item {item})"
             for f, item in _LATER_TRAIN_FLAGS.items()
             if getattr(args, f) not in (None, False)]
    if args.corpus_layout == "sharded":
        later.append("--corpus-layout sharded (ROADMAP.md item A13)")
    if later:
        print(f"error: {', '.join(later)} not in the PyTorch port yet",
              file=sys.stderr)
        return 2
    cfg = train_config(args)
    if not os.path.exists(args.data):
        print(f"error: --data {args.data} does not exist", file=sys.stderr)
        return 2
    ds = PianoRollDataset.load_npy(args.data)
    if ds.num_bars != cfg.model.num_bars:
        print(f"error: {args.data} has {ds.num_bars}-bar windows but config "
              f"{cfg.name!r} trains on {cfg.model.num_bars}-bar windows; "
              f"re-run preprocess with --config {cfg.name}", file=sys.stderr)
        return 2
    err = _check_cache_grid(ds, cfg, args.data)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    eval_ds = None
    if cfg.train.eval_every > 0:
        ds, eval_ds = ds.split(cfg.train.holdout_frac, seed=cfg.train.seed)
        print(f"holdout: {len(eval_ds)} eval windows ({len(ds)} train), "
              f"eval every {cfg.train.eval_every} steps", file=sys.stderr)
    print(f"dataset: {len(ds)} windows; device: {args.device}",
          file=sys.stderr)
    logger = MetricsLogger(args.log_dir)
    try:
        _, _, metrics = train(cfg, ds, log_fn=logger, eval_data=eval_ds,
                              device=args.device)
    finally:
        logger.close()
    print(f"final metrics: { {k: float(v) for k, v in metrics.items()} }")
    return 0


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m musicvae_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve", help="persistent generation service "
                                     "(JSON lines on stdin/stdout)")
    p.add_argument("--config", default="c2_gru_4bar")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--weights", default=None, metavar="PT",
                     help="torch.save of the port's state dict (e.g. "
                          "checkpoints/convert.py flax_params_to_state_dict "
                          "of trained JAX params)")
    src.add_argument("--init-seed", type=int, default=0,
                     help="random weights from this seed (default 0) when "
                          "no --weights is given")
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
    for flag in ("port", "coalesce", "reload_every", "ckpt_dir"):
        p.add_argument(f"--{flag.replace('_', '-')}", default=None,
                       help="not in the PyTorch port yet")
    for flag in ("pipeline", "ema", "warm_seed"):
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train", help="train a config on a bar cache")
    p.add_argument("--config", default="c2_gru_4bar")
    p.add_argument("--data", required=True,
                   help="npz bar cache (python -m musicvae_tpu preprocess)")
    p.add_argument("--steps", type=int, default=None)
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
    for flag in ("ckpt_dir", "ckpt_every", "midi_glob", "labels",
                 "enc_channels", "dec_channels"):
        p.add_argument(f"--{flag.replace('_', '-')}", default=None,
                       help="not in the PyTorch port yet")
    for flag in ("resume", "stream", "host_sharded"):
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true",
                       help="not in the PyTorch port yet")
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)
