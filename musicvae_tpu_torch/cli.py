"""Command line: ``python -m musicvae_tpu_torch`` ``preprocess``, ``train``,
``eval``, ``eval-gen``, ``generate``, ``reconstruct``, ``describe``,
``convert`` and ``serve``: the counterparts of the JAX package's cli.py
commands.

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
(``cmd_describe``); ``convert`` moves weights between the port's
checkpoints and torch or safetensors files (``cmd_convert``). Every
command runs the four parity kinds (conv_bar, gru_seq, hier, cond).
Streaming and the sharded corpus are later items of ROADMAP.md; their
flags are parsed and refused.

``serve`` is the counterpart of ``cmd_serve``: a persistent generation
service speaking the line-delimited JSON protocol of docs/SERVING.md, over
a checkpoint (``--ckpt-dir``, its EMA weights with ``--ema``), a state dict
(``--weights``) or random weights.

  request:  {"id": any, "seed": int, "seed_midi_b64": str?, "chord": int?,
             "key": int?}
  response: {"id": any, "midi_b64": [str, ...], "density": float,
             "latency_ms": float}
  stats:    {"id": any, "cmd": "stats"} → {"id": any, "stats": {served,
             errors, requests, step, config, samples, bars, uptime_s}}
  reload:   {"id": any, "cmd": "reload"} → {"id": any, "reloaded":
             step|null, "step": current}
  error:    {"id": any, "error": str}

``seed_midi_b64`` (base64 SMF bytes) seeds the prev-bar conditioning with
the file's last bar. ``chord``/``key`` (classes 0..23) condition a cond
model's every sample and bar; an omitted one is drawn from
``np.random.default_rng(seed)`` as the JAX server draws it
(``request_labels``). Other kinds ignore them, as the JAX package does.
Transports: stdin, one sweep a
request (``serve_stream``; ``--pipeline`` enqueues sweep i+1 on the card
before pulling and exporting i), stdin under ``--coalesce W`` (up to W
queued requests in one sweep, ``serve_stream_coalesced``), and a threaded
TCP server (``--port``, ``serve_socket``) with one device lock, or a
dispatcher thread under ``--coalesce``. ``--reload-every SECS`` and the
``reload`` command swap newer weights of the checkpoint directory into the
running service (``_make_reload_once``). Every failure is answered
in-band under the request's id; the service keeps running. EOF on stdin
ends it. Logs go to stderr; stdout carries protocol lines.
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import json
import os
import queue
import sys
import threading
import time
import traceback
from typing import List, Optional, TextIO

import numpy as np
import torch

from musicvae_tpu_torch.config import Config, GenSpec, get_config
from musicvae_tpu_torch.generate.sampler import (
    bars_to_midi, make_coalesced_generate_fn, make_generate_fn,
    seed_generator)
from musicvae_tpu_torch.midi.smf import SMFError
from musicvae_tpu_torch.models.vae import PianoRollVAE, build_model
from musicvae_tpu_torch.ops.pack import pack_bits, unpack_bits_np
from musicvae_tpu_torch.parallel import distributed, make_mesh
from musicvae_tpu_torch.parallel.mesh import data_axis

# the JAX package's wording, for the commands that take --ema
_EMA_ERROR = ("error: --ema needs a checkpoint trained with "
              "--ema-decay > 0 (this one has no EMA weights)")


def _gen_response(rid, bars, cfg: Config, t_req: float) -> dict:
    """The one generation-response schema of every transport: base64 SMF
    a sample, density, and latency_ms from the caller's ``t_req`` (the
    request's dispatch on the serial paths, the drain window's start on
    the coalesced stdin path; queue wait included either way)."""
    midis = [base64.b64encode(bars_to_midi(bars[i], cfg)).decode()
             for i in range(bars.shape[0])]
    return {"id": rid, "midi_b64": midis,
            "density": float(bars.mean()),
            "latency_ms": round(1e3 * (time.perf_counter() - t_req), 1)}


def _check_cmd(req: dict) -> None:
    """An unknown ``cmd`` is an in-band error, never a generation."""
    cmd = req.get("cmd")
    if cmd is not None and cmd not in ("stats", "reload"):
        raise ValueError(f"unknown cmd {cmd!r} (expected 'stats' or "
                         f"'reload')")


def _stats_response(rid, cfg: Config, step: int, served: int, errors: int,
                    requests: int, t_start: float) -> dict:
    """The live counters ``{"cmd": "stats"}`` answers with; a hot reload
    shows as a change of ``step``."""
    return {"id": rid, "stats": {
        "served": served, "errors": errors, "requests": requests,
        "step": step, "config": cfg.name,
        "samples": cfg.gen.num_samples, "bars": cfg.gen.num_bars,
        "uptime_s": round(time.perf_counter() - t_start, 1)}}


def to_host(packed: torch.Tensor) -> np.ndarray:
    """Pull 1-bit packed bars (``pack_bits`` on the card: 1/8 of the bytes
    cross) to the host, waiting for their sweep, and unpack them to
    uint8."""
    return unpack_bits_np(packed.cpu().numpy())


def request_labels(cfg: Config, req: dict, seed: int):
    """(chord [B, N], key_sig [B]) int64 classes of a request to a cond
    model, (None, None) for other kinds: a given ``chord``/``key`` for
    every sample (and bar), an omitted one drawn from
    ``np.random.default_rng(seed)``, the chords first, as the JAX server
    draws them. A class out of range raises ValueError."""
    if cfg.model.kind != "cond":
        return None, None
    b, n = cfg.gen.num_samples, cfg.gen.num_bars
    rng = np.random.default_rng(seed)
    out = []
    for field, classes, shape in (
            ("chord", cfg.model.cond_chord_classes, (b, n)),
            ("key", cfg.model.cond_key_classes, (b,))):
        if req.get(field) is None:
            out.append(rng.integers(0, classes, shape))
            continue
        v = int(req[field])
        if not 0 <= v < classes:
            raise ValueError(f"{field} {v} out of range")
        out.append(np.full(shape, v, np.int64))
    return tuple(out)


def _seed_bar(cfg: Config, b64: str) -> np.ndarray:
    """The last bar, uint8 [T, P], of a base64 SMF file."""
    from musicvae_tpu_torch.midi import tensorize

    bars = tensorize.corpus_to_bars([base64.b64decode(b64)], cfg.midi,
                                    as_uint8=True)[0]
    if bars.shape[0] == 0:
        raise ValueError("seed MIDI contains no bars")
    return bars[-1]


class _Weights:
    """One set of served weights with its sweep functions. A reload
    replaces the whole object in one assignment: a sweep that has read it
    finishes on the weights it started with, and no parameter is ever
    written while a sweep reads it. The sweeps' CUDA graphs belong to
    ``generate`` and ``coalesced``, so new weights come with graphs of
    their own, captured at their second sweep a signature and width
    (under the TCP server's device lock; a reload building its state in
    another thread may use the card meanwhile: utils/graphs.py captures
    thread-locally)."""

    def __init__(self, cfg: Config, model: PianoRollVAE, step: int):
        self.model, self.step = model, step
        self.generate = make_generate_fn(cfg, model)
        self.coalesced = make_coalesced_generate_fn(cfg, model)


class Service:
    """One generation service: the served weights, the request parser
    every transport shares, and the counters ``stats`` reports.
    ``handle`` answers one protocol line."""

    def __init__(self, cfg: Config, model: PianoRollVAE, step: int = 0,
                 reload_once=None):
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.weights = _Weights(cfg, model, step)
        # () -> newer step swapped in, or None (_make_reload_once); None
        # when there is no checkpoint directory to reload from
        self.reload_once = reload_once
        self.served = self.errors = self.requests = 0
        self.t_start = time.perf_counter()
        self.lock = threading.Lock()        # the counters

    @property
    def model(self) -> PianoRollVAE:
        return self.weights.model

    @property
    def generate(self):
        return self.weights.generate

    @property
    def step(self) -> int:
        return self.weights.step

    def swap(self, model: PianoRollVAE, step: int) -> None:
        self.weights = _Weights(self.cfg, model, step)

    def warm(self, seeded: bool = False) -> None:
        """Two sweeps (and with ``seeded`` two from a seed bar), so the
        first request pays no one-time set-up: the first runs eagerly (the
        kernel build, cuDNN's algorithm choice), the second captures the
        sweep's CUDA graph on the card (``make_generate_fn``). Weights a
        reload swaps in capture theirs at their first requests."""
        seed_bars = [None]
        if seeded:
            seed_bars.append(np.zeros((self.cfg.midi.steps_per_bar,
                                       self.cfg.midi.num_pitches), np.uint8))
        labels = request_labels(self.cfg, {}, 0)
        for sb in seed_bars:
            for _ in range(2):
                to_host(self.dispatch(seed_generator(0, self.device), sb,
                                      *labels))

    def prepare(self, line: str):
        """(rid, kind, payload) of one request line, None for a blank one.
        kind "gen": payload (generator, seed bar [T, P] uint8 or None,
        chord [B, N] and key_sig [B] classes or None: ``request_labels``),
        the request counted; "stats": the request count so far; "reload":
        None; "error": the message (counted when answered)."""
        line = line.strip()
        if not line:
            return None
        rid = None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("a request is a JSON object")
            rid = req.get("id")
            _check_cmd(req)
            cmd = req.get("cmd")
            if cmd == "stats":
                with self.lock:
                    return rid, cmd, self.requests
            if cmd == "reload":
                return rid, cmd, None
            with self.lock:
                seed = int(req.get("seed", self.requests))
                self.requests += 1
            chord, key_sig = request_labels(self.cfg, req, seed)
            sb = None
            if req.get("seed_midi_b64"):
                sb = _seed_bar(self.cfg, req["seed_midi_b64"])
            return rid, "gen", (seed_generator(seed, self.device), sb,
                                chord, key_sig)
        except Exception as e:      # the service never dies on a request
            traceback.print_exc(file=sys.stderr)
            return rid, "error", f"{type(e).__name__}: {e}"

    def dispatch(self, generator: torch.Generator,
                 seed_bar: Optional[np.ndarray],
                 chord: Optional[np.ndarray] = None,
                 key_sig: Optional[np.ndarray] = None) -> torch.Tensor:
        """Enqueue one request's sweep: its bars, 1-bit packed on the card
        (1/8 of the bytes cross to the host)."""
        sb = None
        if seed_bar is not None:        # contiguous: K1 refuses a stride-0
            sb = torch.from_numpy(seed_bar).to(self.device)[None].repeat(
                self.cfg.gen.num_samples, 1, 1)
        kw = {}
        if chord is not None:
            kw = {"chord": torch.from_numpy(chord).to(self.device),
                  "key_sig": torch.from_numpy(key_sig).to(self.device)}
        return pack_bits(self.weights.generate(generator, seed_bar=sb, **kw))

    def respond(self, rid, bars: np.ndarray, t_req: float) -> dict:
        resp = _gen_response(rid, bars, self.cfg, t_req)
        with self.lock:
            self.served += 1
        return resp

    def error(self, rid, msg: str) -> dict:
        with self.lock:
            self.errors += 1
        return {"id": rid, "error": msg}

    def stats(self, rid, requests: int) -> dict:
        with self.lock:
            return _stats_response(rid, self.cfg, self.step, self.served,
                                   self.errors, requests, self.t_start)

    def reload(self, rid) -> dict:
        """The ``reload`` command's answer; raises when it fails."""
        if self.reload_once is None:
            raise ValueError("reload needs a checkpoint directory: start "
                             "serve with --ckpt-dir")
        return {"id": rid, "reloaded": self.reload_once(), "step": self.step}

    def answer(self, entry) -> dict:
        """The response to a prepared command or error entry."""
        rid, kind, payload = entry
        if kind == "error":
            return self.error(rid, payload)
        if kind == "stats":
            return self.stats(rid, payload)
        try:
            return self.reload(rid)
        except Exception as e:
            traceback.print_exc(file=sys.stderr)
            return self.error(rid, f"{type(e).__name__}: {e}")

    def handle(self, line: str) -> Optional[dict]:
        """The response to one request line; None for a blank line."""
        entry = self.prepare(line)
        if entry is None:
            return None
        rid, kind, payload = entry
        if kind != "gen":
            return self.answer(entry)
        t_req = time.perf_counter()
        try:
            return self.respond(rid, to_host(self.dispatch(*payload)),
                                t_req)
        except Exception as e:
            traceback.print_exc(file=sys.stderr)
            return self.error(rid, f"{type(e).__name__}: {e}")


def _line_queue(inp: TextIO) -> "queue.Queue":
    """A queue fed from ``inp`` by a reader thread, ending with None at
    EOF: the serve loop can see whether a next request is already waiting
    without ever blocking a ready response on more input."""
    q: "queue.Queue" = queue.Queue(maxsize=256)

    def read():
        for ln in inp:
            q.put(ln)
        q.put(None)

    threading.Thread(target=read, daemon=True, name="serve-stdin").start()
    return q


def _summary(service: Service, t0: Optional[float], before) -> None:
    """The transport's closing line: what it served since the counters
    read ``before`` (served, errors), from its first request on."""
    served, errors = (service.served - before[0],
                      service.errors - before[1])
    dt = (time.perf_counter() - t0) if t0 is not None else 0.0
    rate = f" ({served / dt:.1f} req/s)" if served and dt > 0 else ""
    print(f"served {served} requests, {errors} errors in {dt:.1f}s{rate}",
          file=sys.stderr)


def serve_stream(service: Service, inp: TextIO, out: TextIO,
                 pipeline: bool = False) -> int:
    """Answer request lines from ``inp`` on ``out`` until EOF, in order,
    one sweep a request. With ``pipeline``, when the next request is
    already waiting, its sweep is enqueued on the card before request i
    is pulled and exported (depth 1): the host exports i while the card
    runs i+1. An idle service still answers each request at once."""
    inq = _line_queue(inp)
    pending = []        # at most one in flight: (rid, packed bars, t_req)
    t_serve0, before = None, (service.served, service.errors)

    def emit(resp: dict) -> None:
        out.write(json.dumps(resp) + "\n")
        out.flush()

    def flush() -> None:
        """Pull the sweep in flight, export and answer it; a failure on
        the card surfaces here, in-band under its own request's id."""
        if not pending:
            return
        rid, packed, t_req = pending.pop()
        try:
            emit(service.respond(rid, to_host(packed), t_req))
        except Exception as e:
            traceback.print_exc(file=sys.stderr)
            emit(service.error(rid, f"{type(e).__name__}: {e}"))

    while True:
        line = inq.get()
        if line is None:
            flush()
            break
        entry = service.prepare(line)
        if entry is None:
            flush()     # a blank line must not strand a ready response
            continue
        rid, kind, payload = entry
        if kind != "gen":
            flush()     # responses keep request order
            emit(service.answer(entry))
            continue
        t_req = time.perf_counter()
        if t_serve0 is None:
            t_serve0 = t_req
        try:
            packed = service.dispatch(*payload)
        except Exception as e:
            traceback.print_exc(file=sys.stderr)
            flush()
            emit(service.error(rid, f"{type(e).__name__}: {e}"))
            continue
        flush()         # export request i while the card runs i+1
        pending.append((rid, packed, t_req))
        if not pipeline or inq.empty():
            flush()     # idle (or serial mode): answer at once
    _summary(service, t_serve0, before)
    return 0


class _CoalescedRunner:
    """Host side of dynamic batching: up to ``width`` requests' (generator,
    seed bar, chord, key_sig) into one coalesced sweep
    (``make_coalesced_generate_fn``). Two tiers: a lone request runs at
    W=1, at a lone sweep's cost; 2+ pad to the full width with seed-0
    generators, zero seed bars and (cond) class-0 labels, whose bars are
    dropped before the unpack. Both tiers run the same sweep, so a slot's
    music does not depend on the tier."""

    def __init__(self, service: Service, width: int):
        self.service, self.width = service, width
        cfg = service.cfg
        self._shape = (cfg.gen.num_samples, cfg.midi.steps_per_bar,
                       cfg.midi.num_pitches)

    def warm(self) -> None:
        """Both tiers twice, so no request pays a one-time set-up: a
        tier's first sweep runs eagerly (the kernel build, cuDNN's
        algorithm choice), its second captures its CUDA graph on the card
        (``make_coalesced_generate_fn``). Weights a reload swaps in
        capture theirs at their first requests."""
        def item():
            return (seed_generator(0, self.service.device), None,
                    *request_labels(self.service.cfg, {}, 0))

        for n in sorted({1, min(2, self.width)}):
            for _ in range(2):
                self.run([item() for _ in range(n)])

    def run(self, items) -> List[np.ndarray]:
        """items: [(generator, seed bar [T, P] uint8 or None, chord,
        key_sig), ...] (``Service.prepare``'s payloads), at most ``width``
        → one uint8 [B, N, T, P] bars array an item, in order."""
        cfg, dev = self.service.cfg, self.service.device
        n = len(items)
        pad = (1 if n == 1 else self.width) - n
        gens = [it[0] for it in items] + [seed_generator(0, dev)
                                          for _ in range(pad)]
        seed_bars = np.zeros((n + pad,) + self._shape, np.uint8)
        for i, it in enumerate(items):
            if it[1] is not None:
                seed_bars[i] = it[1]
        labels = {}
        if cfg.model.kind == "cond":
            b, nb = cfg.gen.num_samples, cfg.gen.num_bars
            chords = np.zeros((n + pad, b, nb), np.int64)
            keys = np.zeros((n + pad, b), np.int64)
            for i, it in enumerate(items):
                chords[i], keys[i] = it[2], it[3]
            labels = {"chords": list(torch.from_numpy(chords).to(dev)),
                      "key_sigs": list(torch.from_numpy(keys).to(dev))}
        # one read of the weights: a reload cannot tear the sweep
        coalesced = self.service.weights.coalesced
        packed = coalesced(gens, torch.from_numpy(seed_bars).to(dev),
                           **labels)
        bars = to_host(packed[:n])
        return [bars[i] for i in range(n)]


def serve_stream_coalesced(service: Service, runner: _CoalescedRunner,
                           inp: TextIO, out: TextIO) -> int:
    """stdin under ``--coalesce W``: drain up to W queued lines at a time
    and answer their generations from one sweep. Responses keep request
    order; a malformed request gets its error in position without
    spoiling the batch; a failure of the sweep is reported under every
    request of it. A ``reload`` line is a barrier: the drained lines
    split around it, so every generation after it runs on the reloaded
    weights."""
    inq = _line_queue(inp)
    t_serve0, before = None, (service.served, service.errors)

    def emit(resp: dict) -> None:
        out.write(json.dumps(resp) + "\n")
        out.flush()

    eof = False
    while not eof:
        lines = [inq.get()]
        while len(lines) < runner.width:
            try:
                lines.append(inq.get_nowait())
            except queue.Empty:
                break
        entries = []
        for line in lines:
            if line is None:
                eof = True
                break
            entry = service.prepare(line)
            if entry is not None:
                entries.append(entry)
        if not entries:
            continue
        t_req = time.perf_counter()
        if t_serve0 is None:
            t_serve0 = t_req
        groups: list = [[]]             # generation groups split by reloads
        for e in entries:
            if e[1] == "reload":
                groups += [e, []]
            else:
                groups[-1].append(e)
        for grp in groups:
            if isinstance(grp, tuple):      # the reload barrier itself
                emit(service.answer(grp))
                continue
            gens = [payload for _, kind, payload in grp if kind == "gen"]
            results, run_err = iter(()), None
            if gens:
                try:
                    results = iter(runner.run(gens))
                except Exception as e:
                    traceback.print_exc(file=sys.stderr)
                    run_err = f"{type(e).__name__}: {e}"
            for entry in grp:
                rid, kind, _ = entry
                if kind != "gen":
                    emit(service.answer(entry))
                elif run_err is not None:
                    emit(service.error(rid, run_err))
                else:
                    emit(service.respond(rid, next(results), t_req))
    _summary(service, t_serve0, before)
    return 0


class _Batcher:
    """Cross-client coalescing for the TCP transport: handler threads
    submit (generator, seed bar) and wait on a Future; one dispatcher
    thread drains the queue up to the runner's width and answers a whole
    batch from one sweep."""

    def __init__(self, runner: _CoalescedRunner):
        self.runner = runner
        self.q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    def submit(self, item):
        import concurrent.futures

        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        # the lock orders submit against stop(): an item enqueued here is
        # ahead of the stop sentinel, so no handler waits forever
        with self._lock:
            if self._stopped:
                fut.set_exception(ConnectionError(
                    "service is shutting down"))
                return fut
            self.q.put((item, fut))
        return fut

    def stop(self) -> None:
        """End the dispatcher thread; later submissions fail at once."""
        with self._lock:
            self._stopped = True
            self.q.put(None)
        self._thread.join(timeout=60)

    def _loop(self) -> None:
        while True:
            first = self.q.get()
            if first is None:               # stop() sentinel
                return
            batch = [first]
            while len(batch) < self.runner.width:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self.q.put(None)        # answer this batch first
                    break
                batch.append(nxt)
            try:
                results = self.runner.run([item for item, _ in batch])
                for (_, fut), bars in zip(batch, results):
                    fut.set_result(bars)
            except Exception as e:  # a failed sweep fails each request
                for _, fut in batch:
                    fut.set_exception(e)


def _make_reload_once(manager, service: Service, use_ema: bool = False):
    """Hot reload: ``reload_once() -> step or None`` reads the checkpoint
    directory again and, when it holds a newer step, restores that step
    into a second model on the service's device and swaps it in (the
    step; None when already current). Requests that have started finish
    on the weights they started with. A step that fails to restore (e.g.
    one being written) raises: the watcher retries, the ``reload``
    command reports it in-band. Nothing is ever quarantined: the server
    only reads the directory, which the trainer owns. One reload at a
    time; poll and push may both run."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train.trainer import create_state

    lock = threading.Lock()
    shapes = _param_shapes(service.cfg)

    def reload_once() -> Optional[int]:
        with lock:
            manager.reload()
            latest = manager.latest_step()
            if latest is None or latest <= service.step:
                return None
            cfg_new = ckpt_io.restore_config(manager, step=latest)
            if use_ema and cfg_new.train.ema_decay <= 0:
                raise ValueError(
                    f"step {latest} carries no EMA weights but the "
                    f"service was started with --ema; retrain with "
                    f"--ema-decay or restart the service without --ema")
            if _param_shapes(cfg_new) != shapes:
                raise ValueError(
                    f"step {latest} was trained with a different model "
                    f"structure than this service compiled for; restart "
                    f"the service on the new checkpoint")
            # the service's own model settings; the step's train spec
            # decides whether the state holds EMA weights
            _, state = create_state(service.cfg.replace(train=cfg_new.train),
                                    device=service.device)
            state, _ = ckpt_io.restore(manager, state, step=latest)
            service.swap(state.ema_model if use_ema else state.model,
                         latest)
            print(f"reloaded checkpoint step {latest}", file=sys.stderr)
            return latest

    return reload_once


def _param_shapes(cfg: Config) -> dict:
    """{name: shape} of the parameters of cfg's model (built on the meta
    device: no memory, no draws)."""
    with torch.device("meta"):
        model = PianoRollVAE(cfg.model, cfg.midi)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _start_reload_watcher(every: float, reload_once,
                          stop: threading.Event) -> threading.Thread:
    """``serve --reload-every SECS``: a daemon thread calls
    ``reload_once`` every ``every`` seconds until ``stop`` is set; a
    failure is logged and tried again at the next poll."""

    def watch():
        while not stop.wait(every):
            try:
                reload_once()
            except Exception as e:
                print(f"warning: checkpoint reload failed "
                      f"({type(e).__name__}: {e}); will retry",
                      file=sys.stderr)

    t = threading.Thread(target=watch, daemon=True, name="serve-reload")
    t.start()
    return t


def serve_socket(service: Service, host: str = "127.0.0.1", port: int = 0,
                 max_requests: int = 0, runner=None, banner: str = "",
                 on_listen=None) -> int:
    """The TCP transport: a threaded server speaking the same protocol, a
    thread a connection, all on the one service.

    One device lock serializes a request's dispatch and pull (interleaved
    sweeps on one stream would be right but slow, and would share the
    launch counters); the SMF export of each response happens outside it,
    so one client's export overlaps another's sweep. With ``runner``
    (``--coalesce W``) a ``_Batcher`` takes the lock's place: handler
    threads submit and one dispatcher answers up to W queued requests
    from one sweep. A connection's responses keep its request order.

    ``max_requests`` > 0 stops the server after that many generation
    requests. ``on_listen(host, port)`` is called once the socket is bound
    (``port`` 0 picks a free one; the address is also announced on
    stderr). A SIGTERM or ^C stops accepting, lets the requests in flight
    finish and returns; the handlers are installed only when this runs
    on the main thread."""
    import socketserver

    from musicvae_tpu_torch.train.preemption import GracefulStop

    cfg = service.cfg
    batcher = _Batcher(runner) if runner is not None else None
    device_lock = threading.Lock()
    state_lock = threading.Lock()
    counts = {"t0": None, "inflight": 0, "answered": 0}
    before = (service.served, service.errors)
    draining = threading.Event()

    def generate(payload):
        if batcher is not None:
            return batcher.submit(payload).result()
        with device_lock:       # one sweep in flight, dispatch and pull
            return to_host(service.dispatch(*payload))

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                if draining.is_set():
                    return
                # undecodable bytes reach json.loads and are answered
                # in-band like any other malformed request
                line = raw.decode("utf-8", errors="replace")
                entry = service.prepare(line)
                if entry is None:
                    continue
                rid, kind, payload = entry
                if kind != "gen":       # an error counts, a command not
                    resp = service.answer(entry)
                    ok = self._write(resp)
                    if self._count_done("error" in resp) or not ok:
                        return
                    continue
                with state_lock:
                    counts["inflight"] += 1
                    if counts["t0"] is None:
                        counts["t0"] = time.perf_counter()
                try:
                    t_req = time.perf_counter()
                    try:
                        bars = generate(payload)
                        resp = service.respond(rid, bars, t_req)
                    except Exception as e:
                        traceback.print_exc(file=sys.stderr)
                        resp = service.error(rid, f"{type(e).__name__}: {e}")
                    # the stop check runs even when the reply could not be
                    # written: the request was served and counted
                    ok = self._write(resp)
                    if self._count_done(True) or not ok:
                        return
                finally:
                    with state_lock:
                        counts["inflight"] -= 1

        def _write(self, resp: dict) -> bool:
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError):
                return False    # the client went away mid-reply

        def _count_done(self, answered: bool) -> bool:
            """Count an answered request (a generation or an error) and
            return True, with the server told to stop, once this server
            has answered ``max_requests``."""
            with state_lock:
                counts["answered"] += answered
                done = 0 < max_requests <= counts["answered"]
            if done:
                threading.Thread(target=server.shutdown, daemon=True).start()
            return done

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    closed = threading.Event()
    with Server((host, port), Handler) as server, GracefulStop() as stop:
        bound_host, bound_port = server.server_address[:2]
        print(f"{banner}; listening on {bound_host}:{bound_port}",
              file=sys.stderr)
        if on_listen is not None:
            on_listen(bound_host, bound_port)

        def watch_signals():
            while not closed.wait(0.1):
                if stop.requested:
                    server.shutdown()
                    return

        threading.Thread(target=watch_signals, daemon=True,
                         name="serve-signals").start()
        try:
            server.serve_forever(poll_interval=0.1)
        except KeyboardInterrupt:
            pass
        finally:
            closed.set()
            if stop.requested:
                draining.set()      # handlers take no new lines
                _drain(counts, state_lock)
            if batcher is not None:
                batcher.stop()
    _summary(service, counts["t0"], before)
    return 0


def _drain(counts: dict, state_lock: threading.Lock,
           deadline_s: float = 30.0) -> None:
    """Wait until no request has been in flight for 0.3 s (one zero can be
    the instant between a finished request and the next), at most
    ``deadline_s``."""
    deadline = time.monotonic() + deadline_s
    zero_since = None
    while time.monotonic() < deadline:
        with state_lock:
            idle = counts["inflight"] == 0
        if idle:
            zero_since = zero_since or time.monotonic()
            if time.monotonic() - zero_since > 0.3:
                break
        else:
            zero_since = None
        time.sleep(0.05)
    with state_lock:
        left = counts["inflight"]
    print(f"shutdown signal: drain deadline expired with {left} request(s) "
          f"still in flight" if left else
          "shutdown signal: in-flight requests drained", file=sys.stderr)


def serve_config(args: argparse.Namespace,
                 cfg: Optional[Config] = None) -> Config:
    """The config a ``serve`` invocation runs: ``cfg`` (a checkpoint's) or
    the named config, with the generation shape, the first-conv kernel
    flag and the MIDI ingestion flags from the command line."""
    cfg = get_config(args.config) if cfg is None else cfg
    model = cfg.model
    if args.use_pallas_conv1:
        model = dataclasses.replace(model, use_pallas_conv1=True)
    cfg = cfg.replace(model=model, gen=GenSpec(
        num_bars=args.bars, num_samples=args.samples,
        interpolate=args.interpolate, sample_mode=args.sample_mode,
        sample_temperature=args.sample_temperature))
    return _apply_midi_overrides(cfg, args)


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


def _serve_flag_error(args: argparse.Namespace) -> Optional[str]:
    """The first flag combination ``serve`` refuses, before any restore."""
    if args.coalesce < 1:
        return "--coalesce must be >= 1"
    if args.coalesce > 1 and args.pipeline:
        return ("--pipeline and --coalesce are mutually exclusive "
                "(coalescing already overlaps host encode with the next "
                "batch's device sweep)")
    if args.ema and args.ckpt_dir is None:
        return "--ema serves a checkpoint's EMA weights; give --ckpt-dir"
    if args.reload_every > 0 and args.ckpt_dir is None:
        return ("--reload-every polls a checkpoint directory for newer "
                "steps; give --ckpt-dir")
    return None


def cmd_serve(args: argparse.Namespace) -> int:
    err = _serve_flag_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    step, manager = 0, None
    if args.ckpt_dir is not None:
        from musicvae_tpu_torch.checkpoints import io as ckpt_io

        cfg, state = restore_checkpoint(
            args.ckpt_dir, args.device,
            lambda c: serve_config(args, c))
        model = state.model
        if args.ema:
            model = _ema_model(state)
            if model is None:
                return 2
        step = int(state.step)
        manager = ckpt_io.make_manager(args.ckpt_dir)
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
    if manager is not None:
        service.reload_once = _make_reload_once(manager, service,
                                                use_ema=args.ema)
    runner = None
    if args.coalesce > 1:
        runner = _CoalescedRunner(service, args.coalesce)
        runner.warm()
    else:
        service.warm(seeded=args.warm_seed)
    banner = (f"serving {cfg.name} ({source}) on {service.device}: "
              f"{args.samples}x{args.bars} bars/request, ready in "
              f"{time.perf_counter() - t0:.1f}s")
    if runner is not None:
        banner += f", coalescing up to {args.coalesce} requests/dispatch"
    stop_reload = threading.Event()
    if args.reload_every > 0:
        _start_reload_watcher(args.reload_every, service.reload_once,
                              stop_reload)
    try:
        if args.port is not None:
            return serve_socket(service, args.host, args.port,
                                args.max_requests, runner, banner)
        print(f"{banner}; reading JSON lines on stdin", file=sys.stderr)
        if runner is not None:
            return serve_stream_coalesced(service, runner, sys.stdin,
                                          sys.stdout)
        return serve_stream(service, sys.stdin, sys.stdout,
                            pipeline=args.pipeline)
    finally:
        stop_reload.set()


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


def _train_stream(args: argparse.Namespace, cfg: Config, ds):
    """What ``train()`` reads: the resident dataset ``ds``; with
    ``--stream`` its iterator of global batches; with ``--host-sharded``
    this process's ``host_shard`` streaming its rows of each global batch
    (``HostLocalBatches``). None after an error."""
    from musicvae_tpu_torch.data.dataset import HostLocalBatches

    b, seed = cfg.train.batch_size, cfg.train.seed
    if args.host_sharded:
        # eval would need every process to hold the same holdout: the
        # full-corpus contract this mode removes
        if cfg.train.eval_every > 0:
            print("error: --host-sharded is a streaming mode without "
                  "in-training eval (hosts hold disjoint corpus shards; "
                  "the replicated eval sweep needs identical host data). "
                  "Set --eval-every 0.", file=sys.stderr)
            return None
        # the processes of one model group (a config mesh with a model
        # axis) train on the same rows: the shard goes by the data index
        pc, rank = data_axis(cfg.mesh)
        if b % pc:
            print(f"error: batch_size {b} not divisible by {pc} processes",
                  file=sys.stderr)
            return None
        shard = ds.host_shard(rank, pc, seed=seed)
        print(f"host shard {rank}/{pc}: {len(shard)} windows "
              f"({shard.bars.shape[0]} bars resident on this host)",
              file=sys.stderr)
        return HostLocalBatches(shard.iterator(b // pc, seed=seed,
                                               x_dtype=np.uint8))
    if args.stream:
        return ds.iterator(b, seed=seed, x_dtype=np.uint8)
    return ds


def cmd_train(args: argparse.Namespace) -> int:
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train.preemption import GracefulStop
    from musicvae_tpu_torch.train.trainer import train
    from musicvae_tpu_torch.utils.logging import MetricsLogger

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
    world, rank = distributed.world_size(), distributed.rank()
    print(f"dataset: {len(ds)} windows; device: {args.device}"
          + (f"; process {rank} of {world}" if world > 1 else ""),
          file=sys.stderr)
    data = _train_stream(args, cfg, ds)
    if data is None:
        return 2
    # the metrics are the group's averages: process 0 logs them
    logger = MetricsLogger(args.log_dir) if rank == 0 else None
    # SIGTERM/SIGINT: finish the dispatch in flight, checkpoint the exact
    # step, exit 0 with a resume hint
    try:
        with GracefulStop() as stop:
            _, state, metrics = train(
                cfg, data, ckpt_manager=manager, log_fn=logger, state=state,
                eval_data=eval_ds, best_ckpt_manager=best_manager,
                stop=stop, device=args.device)
    finally:
        if logger is not None:
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
    from musicvae_tpu_torch.models.vae import draw_eps
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
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 ds.batch(idx, x_dtype=np.uint8).items()}
        eps = draw_eps(cfg.model, b, torch.Generator(dev).manual_seed(i))
        for k, v in eval_fn(batch["x"], eps, w, batch["chord"],
                            batch["key_sig"]).items():
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


def _seed_from_midi(cfg: Config, model: PianoRollVAE, path: str,
                    encode: bool, num_samples: int,
                    generator: torch.Generator):
    """(sweep kwargs, error or None) for continuing a real MIDI file: its
    LAST bar becomes every sample's first prev-bar condition
    (``seed_bar``, uint8 on the model's device); with ``encode`` its last
    ``model.num_bars``-bar window (zero-padded at the front when the piece
    is shorter) is encoded and a posterior draw a sample pins the first
    phrase's latent (``z0``; for hier the phrase latent ``z_phrase0``). A
    cond model encodes the window under the key and chord of its summed
    pitch-class histogram."""
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
        labels = {}
        if cfg.model.kind == "cond":
            from musicvae_tpu_torch.midi import labels as labels_mod

            hist = labels_mod.bar_pc_histograms(window).sum(0)
            k = labels_mod.key_from_hist(hist)
            c = labels_mod.chord_from_hist(hist, fallback=k)
            labels = {"chord": torch.full((num_samples, nb), int(c),
                                          device=dev),
                      "key_sig": torch.full((num_samples,), int(k),
                                            device=dev)}
        kw.update(make_encode_fn(cfg, model)(x, generator, **labels))
    return kw, None


def _cond_flags(args: argparse.Namespace, cfg: Config, dev):
    """(sweep kwargs, rc) of ``--chord``/``--key`` on a cond model: each
    given class for every sample (and bar), rc 2 after the JAX package's
    error for one out of range. Other kinds ignore the flags, as the JAX
    package does."""
    kw = {}
    if cfg.model.kind != "cond":
        return kw, 0
    b, n = cfg.gen.num_samples, cfg.gen.num_bars
    for flag, name, classes, shape in (
            ("chord", "chord", cfg.model.cond_chord_classes, (b, n)),
            ("key", "key_sig", cfg.model.cond_key_classes, (b,))):
        v = getattr(args, flag)
        if v is None:
            continue
        if not 0 <= v < classes:
            print(f"error: --{flag} {v} out of range 0..{classes - 1}",
                  file=sys.stderr)
            return kw, 2
        kw[name] = torch.full(shape, v, device=dev)
    return kw, 0


def cmd_generate(args: argparse.Namespace) -> int:
    """Bar-by-bar sampling from a checkpoint (or random weights) into
    ``--out-dir``: ``rolls.npy`` (uint8 [samples, bars, T, P]) and up to
    ``--write-midis`` ``sample_NNNN.mid`` files."""
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
        # B's encoded posterior pins the slerp END (for hier the phrase
        # latent's morph end); B's seed bar is discarded — the sweep
        # starts from A's material
        if "z0" in kw_b:
            kw["z1"] = kw_b["z0"]
        if "z_phrase0" in kw_b:
            kw["z_phrase1"] = kw_b["z_phrase0"]
    cond_kw, rc = _cond_flags(args, cfg, dev)
    if rc:
        return rc
    kw.update(cond_kw)
    sweep = make_generate_fn(cfg, model)
    t0 = time.perf_counter()
    packed = pack_bits(sweep(gen, **kw))
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
    bars = to_host(pack_bits(make_generate_fn(cfg, model)(
        torch.Generator(dev).manual_seed(args.seed))))
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
    (the tail zero-padded), window w with the posterior seed --seed + w. A
    cond model reads each window under the file's key and the window's
    chord, from their pitch-class histograms (midi/labels.py)."""
    import glob

    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.generate.sampler import reconstruct_fn
    from musicvae_tpu_torch.midi import labels as labels_mod
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
        if cfg.model.kind == "cond":
            hists = labels_mod.bar_pc_histograms(bars)
            ksig = labels_mod.key_from_hist(hists.sum(0))
        outs = []
        for w in range(bars.shape[0] // nb):
            labels = {}
            if cfg.model.kind == "cond":
                c = labels_mod.chord_from_hist(
                    hists[w * nb:(w + 1) * nb].sum(0), fallback=ksig)
                labels = {"chord": torch.full((1, nb), int(c), device=dev),
                          "key_sig": torch.full((1,), int(ksig),
                                                device=dev)}
            outs.append(rec(x_all[w * nb:(w + 1) * nb][None],
                            torch.Generator(dev).manual_seed(args.seed + w),
                            **labels))
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
    from musicvae_tpu_torch.models.vae import param_count

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
    n_params = param_count(model)
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


def _read_torch_state_dict(args: argparse.Namespace) -> dict:
    """The state dict of --from-torch (a bare state dict, or a
    reference-style {'model': state_dict, ...} bundle) or of
    --from-safetensors."""
    from musicvae_tpu_torch.checkpoints import safetensors_io

    if args.from_safetensors:
        return safetensors_io.load_file(args.from_safetensors)[0]
    sd = torch.load(args.from_torch, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd \
            and not any("." in k for k in sd):
        sd = sd["model"]
    return sd


def cmd_convert(args: argparse.Namespace) -> int:
    """Weights between the port's checkpoints and torch or safetensors
    files, one direction an invocation:

      convert --from-torch model.pt --config c2_gru_4bar --out ckpt_dir
      convert --to-torch ckpt_dir --out model.pt
      convert --from-safetensors model.safetensors --config ... --out dir
      convert --to-safetensors ckpt_dir --out model.safetensors

    The files use the torch oracle's tensor names, as the JAX package's
    do: one naming, three formats. An import is checked against --config
    before anything is written (checkpoints/convert.py
    ``canonical_state_dict``) and becomes the port's checkpoint format
    with a fresh optimizer at --step; optimizer moments do not convert. A
    JAX (Orbax) checkpoint comes in through import_orbax_checkpoint.py,
    and an export goes to Orbax through the JAX package's own ``convert
    --from-torch``. Configs with the patch stem or the attention core
    have no oracle names and are refused, as the JAX package refuses
    them."""
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.checkpoints import safetensors_io
    from musicvae_tpu_torch.checkpoints.convert import (
        StateDictMismatch, UnconvertibleConfig, canonical_state_dict)
    from musicvae_tpu_torch.train.trainer import init_state

    sources = [args.from_torch, args.to_torch, args.from_safetensors,
               args.to_safetensors]
    if sum(bool(s) for s in sources) != 1:
        print("error: convert needs exactly one of --from-torch / "
              "--to-torch / --from-safetensors / --to-safetensors",
              file=sys.stderr)
        return 2
    if args.from_torch or args.from_safetensors:
        src = args.from_torch or args.from_safetensors
        cfg = _apply_midi_overrides(get_config(args.config), args)
        try:
            sd = canonical_state_dict(_read_torch_state_dict(args), cfg)
        except (StateDictMismatch, UnconvertibleConfig) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        model = build_model(cfg, device=args.device)
        model.load_state_dict(sd, strict=True)
        state = init_state(cfg, model)
        state.step.fill_(args.step)
        manager = ckpt_io.make_manager(args.out, keep=1)
        if not ckpt_io.save(manager, state, cfg, wait=True):
            print(f"error: {args.out} already holds step "
                  f"{manager.latest_step()} (not older than --step "
                  f"{args.step})", file=sys.stderr)
            return 2
        n = sum(t.numel() for t in sd.values())
        print(f"converted {src} -> {args.out} (config {cfg.name}, {n} "
              f"params, step {args.step})")
        return 0
    ckpt = args.to_torch or args.to_safetensors
    cfg, state = restore_checkpoint(
        ckpt, args.device, lambda c: _apply_midi_overrides(c, args))
    model = _ema_model(state) if args.ema else state.model
    if model is None:
        return 2
    try:
        sd = canonical_state_dict(model.state_dict(), cfg)
    except UnconvertibleConfig as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    step = int(state.step)
    if args.to_torch:
        torch.save(sd, args.out)
    else:
        safetensors_io.save_file(sd, args.out, metadata={
            "config": cfg.name, "step": str(step),
            "format": "musicvae_tpu/torch-names"})
    print(f"converted {ckpt} (config {cfg.name}, step {step}) -> "
          f"{args.out} ({len(sd)} tensors)")
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
    _add_midi_flags(p)
    p.add_argument("--bars", type=int, default=16)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--interpolate", action="store_true")
    p.add_argument("--sample-mode", choices=["threshold", "bernoulli"],
                   default="threshold")
    p.add_argument("--sample-temperature", type=float, default=1.0,
                   help="Bernoulli mode: sigmoid(logits/T) sharpening")
    p.add_argument("--use-pallas-conv1", action="store_true",
                   help="first encoder conv through the hand-written CUDA "
                        "kernel (ModelSpec.use_pallas_conv1)")
    p.add_argument("--warm-seed", action="store_true",
                   help="also run one seeded (seed_midi_b64) sweep at "
                        "start-up")
    p.add_argument("--pipeline", action="store_true",
                   help="stdin, one sweep a request: when the next request "
                        "is waiting, enqueue its sweep on the card before "
                        "pulling and exporting the current one (depth 1)")
    p.add_argument("--coalesce", type=int, default=1,
                   help="dynamic batching width W: up to W queued requests "
                        "run as one sweep at batch W x samples; a lone "
                        "request runs alone. 1 = off")
    p.add_argument("--port", type=int, default=None,
                   help="serve the same protocol over TCP instead of stdin, "
                        "a thread a connection (0 = a free port, announced "
                        "on stderr)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --port (default loopback)")
    p.add_argument("--max-requests", type=int, default=0,
                   help="with --port: stop after N requests (0 = serve "
                        "until interrupted)")
    p.add_argument("--reload-every", type=float, default=0.0,
                   help="with --ckpt-dir: poll the directory every SECS "
                        "seconds and swap a newer step's weights into the "
                        "running service. 0 = off")
    _add_device(p)
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
                   default=None,
                   help="resident bar-cache layout: the whole corpus on "
                        "every device (default) or dealt piece-wise over "
                        "the data-parallel processes, 1/P of it a device "
                        "(train/sharded_corpus.py)")
    p.add_argument("--stream", action="store_true",
                   help="stream host batches instead of the device-"
                        "resident cache (corpora larger than device "
                        "memory; bit-packed, uploaded while the device "
                        "runs the dispatch before)")
    p.add_argument("--host-sharded", action="store_true",
                   help="multi-process: each process loads only its "
                        "PianoRollDataset.host_shard of the corpus and "
                        "streams its rows of the global batch (implies "
                        "--stream; no in-training eval)")
    p.add_argument("--use-pallas-conv1", action="store_true",
                   help="first encoder conv, forward and backward, through "
                        "the hand-written CUDA kernels")
    _add_device(p)
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
                       help=f"cond models: condition every sample on this "
                            f"{flag} class (0..23; default a random class "
                            f"a sample); other kinds ignore it")
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

    p = sub.add_parser("convert",
                       help="weights between the port's checkpoints and "
                            "torch / safetensors files")
    p.add_argument("--config", default="c2_gru_4bar",
                   help="--from-*: the config the weights are for")
    _add_midi_flags(p)
    p.add_argument("--from-torch", default=None, metavar="PT",
                   help="torch state dict (or {'model': ...} bundle) to "
                        "import as a checkpoint into --out")
    p.add_argument("--to-torch", default=None, metavar="CKPT_DIR",
                   help="checkpoint directory to export as a torch state "
                        "dict at --out")
    p.add_argument("--from-safetensors", default=None, metavar="ST",
                   help="safetensors file to import (the torch export's "
                        "tensor names) as a checkpoint into --out")
    p.add_argument("--to-safetensors", default=None, metavar="CKPT_DIR",
                   help="checkpoint directory to export as a safetensors "
                        "file at --out (config and step in its metadata)")
    p.add_argument("--out", required=True,
                   help="destination: a checkpoint directory for --from-*, "
                        "a file for --to-*")
    p.add_argument("--ema", action="store_true",
                   help="--to-*: export the EMA weights (requires training "
                        "with --ema-decay)")
    p.add_argument("--step", type=int, default=0,
                   help="--from-*: the step of the written checkpoint")
    _add_device(p)
    p.set_defaults(fn=cmd_convert)

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
    if args.cmd in ("train", "eval", "generate", "serve"):
        # the commands that use the device join a multi-process launch
        # (parallel/distributed.py); preprocess is host-side and waits on
        # no other process
        distributed.initialize_from_env(device=args.device)
        # one card a process: a bare "cuda" is this process's card
        # (cuda:LOCAL_RANK) for every state the command builds, a resumed
        # run's included
        args.device = str(make_mesh(None, args.device).device)
    try:
        return args.fn(args)
    except (FileNotFoundError, OrbaxLayoutError, _UsageError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except SMFError as e:        # malformed or unsupported MIDI input
        print(f"error: malformed MIDI: {e}", file=sys.stderr)
        return 2
