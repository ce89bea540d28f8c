"""The serving cells: the program's TCP service (``serve --port 0
--coalesce W``) in a process of its own (perfbench/served.py), under an
open-loop load that this process generates from the mix.

Set-up makes the weights from the seed (the seed init with the layer the
configuration's ``assumed.serve_weights`` names rescaled), writes them
where the server reads them (``--weights``), starts the server, waits for
the port it announces, opens a pool of connections and sends a burst of
warm-up requests. The window then sends ``round(rate · seconds)``
requests on the schedule of perfbench/traffic.py, each on a free
connection of the pool, and waits for every answer, up to a minute past
the window's close. A request's latency runs from when it was due to the
last byte of its answer; one that fails or never comes counts as
infinitely late. The server is stopped (SIGTERM) before the results are
judged.

``correct``: a sample of the answered requests, drawn from the seed, is
worked out again by the reference (perfbench/reference/): each response's
MIDI is read back into bars and must be the bytes the reference writes for
those bars (and its ``density`` their mean); and, the request's latent
path drawn again from its seed, the reference's f32 decoder, fed the bars
the service served, must put each served cell on the side of the
threshold the service chose, to within ``limits.serve.gap`` logits.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import harness, traffic
from perfbench.harness import Check, Outcome
from perfbench.reference import midi as ref_midi
from perfbench.reference import model as ref

WAIT_PAST_CLOSE_S = 60.0      # how long answers are awaited past the window
SERVER_START_S = 600.0        # the server's start, its first build included
SERVED = os.path.join(harness.BENCH, "served.py")


def server_command(ctx: harness.Ctx, report: str, weights: str) -> list:
    spec, mix = ctx.spec, ctx.mix
    cmd = [sys.executable, SERVED, "--report", report]
    if ctx.trace:
        cmd.append("--trace")
    cmd += ["--", "serve", "--config", spec["name"], "--weights", weights,
            "--port", "0", "--coalesce", str(mix["coalesce"]),
            "--samples", str(mix["samples"]), "--bars", str(mix["bars"]),
            "--device", ctx.device]
    if spec["model"]["use_pallas_conv1"]:
        cmd.append("--use-pallas-conv1")
    return cmd


class Server:
    """The server process: started, its announced port awaited, its
    standard error kept (the last lines), stopped by SIGTERM."""

    def __init__(self, cmd: list):
        env = dict(os.environ, PYTHONPATH=harness.ROOT)
        self.proc = subprocess.Popen(cmd, cwd=harness.ROOT, env=env,
                                     stdin=subprocess.DEVNULL,
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True)
        self.lines: List[str] = []
        self.port: "queue.Queue" = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            self.lines = (self.lines + [line.rstrip()])[-200:]
            if "listening on " in line:
                self.port.put(int(line.rsplit(":", 1)[1]))
        self.port.put(None)

    def wait_port(self) -> int:
        try:
            port = self.port.get(timeout=SERVER_START_S)
        except queue.Empty:
            port = None
        if port is None:
            self.stop()
            raise RuntimeError("the server did not start:\n"
                               + "\n".join(self.lines[-40:]))
        return port

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)
        return self.proc.returncode


class Client:
    """A pool of connections, each used by one request at a time: a
    request waits for a free connection only when all are busy (the pool
    is sized so that none does)."""

    def __init__(self, port: int, size: int, timeout: float):
        self.free: "queue.Queue" = queue.Queue()
        self.conns = []
        for _ in range(size):
            s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
            self.conns.append((s, s.makefile("rb")))
            self.free.put(self.conns[-1])

    def request(self, rid: int, seed: int) -> dict:
        """Send one generation request; its answer's line (parsed by
        ``parse`` once the window has closed, so that no sender holds the
        interpreter while the schedule runs), or an error, and the send
        and receive times."""
        conn = self.free.get()
        sent = time.perf_counter()
        try:
            conn[0].sendall((json.dumps({"id": rid, "seed": seed})
                             + "\n").encode())
            line = conn[1].readline()
            done = time.perf_counter()
            out = {"line": line} if line else {"resp": {"error": "closed"}}
        except OSError as e:
            done, out = time.perf_counter(), {"resp": {"error": repr(e)}}
        self.free.put(conn)
        return dict(out, sent=sent, done=done)

    def close(self) -> None:
        for s, f in self.conns:
            f.close()
            s.close()


def drive(client: Client, plan, t0: float, threads: int) -> List[dict]:
    """Send each planned (due, seed) request at t0 + due from a pool of
    ``threads`` senders; the results in plan order (None: never sent)."""
    results: List[Optional[dict]] = [None] * len(plan)
    todo: "queue.Queue" = queue.Queue()

    def sender():
        while True:
            item = todo.get()
            if item is None:
                return
            i, seed = item
            results[i] = client.request(i, seed)

    workers = [threading.Thread(target=sender, daemon=True)
               for _ in range(threads)]
    for w in workers:
        w.start()
    for i, (due, seed) in enumerate(plan):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put((i, seed))
    for _ in workers:
        todo.put(None)
    deadline = t0 + plan[-1][0] + WAIT_PAST_CLOSE_S
    for w in workers:
        w.join(timeout=max(0.0, deadline - time.perf_counter()))
    return results


def parse(results: List[Optional[dict]]) -> List[Optional[dict]]:
    """Each result's answer line read as JSON, under ``resp``."""
    for r in results:
        if r is not None and "line" in r:
            try:
                r["resp"] = json.loads(r.pop("line"))
            except ValueError as e:
                r["resp"] = {"error": repr(e)}
    return results


def answered(r: Optional[dict], samples: int) -> bool:
    return (r is not None and "error" not in r["resp"]
            and len(r["resp"].get("midi_b64", ())) == samples)


def run(ctx: harness.Ctx) -> Outcome:
    seconds = ctx.mix["trace_seconds"] if ctx.trace else ctx.seconds
    return judge(ctx, seconds, *window(ctx, seconds))


def serve_params(ctx: harness.Ctx) -> Dict[str, torch.Tensor]:
    """The served weights, made on the run's device from the configuration's
    own weight seed (every run serves the same weights, so the served
    density, and the export's work, is the same whatever ``--seed``), kept
    on the host."""
    sw = ctx.spec["assumed"]["serve_weights"]
    p0 = ref.make_params(ref.param_shapes(ctx.spec), sw["seed"], ctx.device,
                         scale=sw["scale"], bias=sw["bias"])
    return {k: v.cpu() for k, v in p0.items()}


class Serving:
    """The server of a run, from its weights to its report: ``with
    Serving(ctx, weights, seconds) as sv`` starts it, waits for its port,
    opens the client's pool (``sv.client``) and sends the warm-up burst;
    leaving stops it (first telling it ``sv.window``, the traced window)
    and reads its report into ``sv.report``."""

    def __init__(self, ctx: harness.Ctx, params, seconds: float):
        self.ctx, self.params, self.seconds = ctx, params, seconds
        self.window = [0, 0]
        self.report: dict = {}

    def __enter__(self):
        ctx, mix = self.ctx, self.ctx.mix
        self.work = tempfile.mkdtemp(prefix="perfbench-serve-")
        weights = os.path.join(self.work, "weights.pt")
        self.path = os.path.join(self.work, "report.json")
        torch.save(self.params, weights)
        self.server = Server(server_command(ctx, self.path, weights))
        try:
            self.client = Client(self.server.wait_port(), mix["connections"],
                                 self.seconds + WAIT_PAST_CLOSE_S)
            t_ready = time.perf_counter()
            warm = [(0.0, s) for _, s in traffic.schedule(
                mix["warmup_requests"], 1.0,
                harness.derived_seed(ctx.seed, 5))]
            drive(self.client, warm, t_ready, mix["connections"])
            print(f"set-up s: server ready {t_ready - ctx.t_start!r}, "
                  f"warm-up burst {time.perf_counter() - t_ready!r}",
                  file=sys.stderr)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        try:
            if hasattr(self, "client"):
                self.client.close()
            with open(self.path + ".window", "w") as f:
                json.dump(self.window, f)
            rc = self.server.stop()
            if rc != 0:
                raise RuntimeError(f"the server exited with {rc}:\n"
                                   + "\n".join(self.server.lines[-40:]))
            with open(self.path) as f:
                self.report = json.load(f)
        finally:
            shutil.rmtree(self.work, ignore_errors=True)
        return False


def window(ctx: harness.Ctx, seconds: float):
    """Set-up, the warm-up burst and the window's load: (plan, results,
    t0, the served weights, the server's report)."""
    p0 = serve_params(ctx)
    plan = traffic.schedule(ctx.mix["rate_per_s"], seconds,
                            harness.derived_seed(ctx.seed, 6))
    with Serving(ctx, p0, seconds) as sv:
        t0 = time.perf_counter()
        sv.window[0] = time.time_ns()
        results = drive(sv.client, plan, t0, ctx.mix["connections"])
        sv.window[1] = time.time_ns()
    return plan, parse(results), t0, p0, sv.report


def checked(ctx: harness.Ctx, plan, results) -> List[int]:
    """The answered requests the reference works out again: a sample drawn
    from the seed."""
    ok = [answered(r, ctx.mix["samples"]) for r in results]
    return [i for i in traffic.sample(len(plan), ctx.mix["check_requests"],
                                      harness.derived_seed(ctx.seed, 7))
            if ok[i]]


def latency_metrics(plan, results, t0: float, seconds: float,
                    samples: int) -> Dict[str, float]:
    """The end-to-end metrics of a window: each request's latency from when
    it was due to its answer, infinite for one that failed or never came;
    their median and 95th percentile; and the requests answered over the
    window's time (its length, or longer when answers came after it)."""
    ok = [answered(r, samples) for r in results]
    lat = [1e3 * (r["done"] - t0 - due) if good else float("inf")
           for (due, _), r, good in zip(plan, results, ok)]
    last = max((r["done"] for r in results if r is not None), default=t0)
    return {"serve_p50_ms": harness.percentile(lat, 50),
            "serve_p95_ms": harness.percentile(lat, 95),
            "serve_req_per_s": sum(ok) / max(seconds, last - t0)}


def judge(ctx, seconds: float, plan, results, t0: float, p0, served
          ) -> Outcome:
    """The metrics, the lateness line and the checks of a serve run."""
    spec, mix = ctx.spec, ctx.mix
    ok = [answered(r, mix["samples"]) for r in results]
    late = sorted(1e3 * (r["sent"] - t0 - due)
                  for (due, _), r in zip(plan, results) if r is not None)
    if late:
        print(f"generator lateness ms: p50 {harness.percentile(late, 50)!r}"
              f" p99 {harness.percentile(late, 99)!r} max {late[-1]!r}"
              f" over {len(late)} requests", file=sys.stderr)
    metrics: Dict[str, float] = {}
    if not ctx.trace:
        metrics = latency_metrics(plan, results, t0, seconds,
                                  mix["samples"])
        metrics["setup_s"] = t0 - ctx.t_start
        print(f"latency ms: p50 {metrics['serve_p50_ms']!r} p95 "
              f"{metrics['serve_p95_ms']!r}", file=sys.stderr)
        inside = [r["resp"]["latency_ms"] for r, good in zip(results, ok)
                  if good] or [float("nan")]
        dens = [r["resp"]["density"] for r, good in zip(results, ok)
                if good] or [float("nan")]
        print(f"in-server latency ms: p50 {harness.percentile(inside, 50)!r}"
              f"; served density: mean {float(np.mean(dens))!r}",
              file=sys.stderr)
    picks = checked(ctx, plan, results)
    bars, bad_midi = decode_all(spec, mix, [results[i]["resp"]
                                            for i in picks])
    gap = logit_gap(spec, mix, p0, [plan[i][1] for i in picks], bars,
                    ctx.device) if picks else float("inf")
    limits = spec["limits"]["serve"]
    checks = [Check("unanswered", float(len(ok) - sum(ok)), 0.0),
              Check("midi_mismatch", float(bad_midi), 0.0),
              Check("logit_gap", gap, limits["gap"])]
    trace = served.get("trace", {})
    if trace:
        trace.update(samples=mix["samples"], bars=mix["bars"],
                     coalesce=mix["coalesce"])
        p50 = latency_metrics(plan, results, t0, seconds,
                              mix["samples"])["serve_p50_ms"]
        if np.isfinite(p50):
            trace["p50_ms"] = p50
    return Outcome(metrics, trace, attempted=len(plan),
                   failed=len(ok) - sum(ok), checks=checks,
                   memory_peak_bytes=served["memory_peak_bytes"],
                   forbidden=served["forbidden"])


def decode(spec: dict, mix: dict, resp: dict):
    """A response's bars [samples, bars, T, P] read back from its MIDI, and
    how many of its samples' bytes or density differ from what the
    reference makes of those bars."""
    out, bad = [], 0
    for b64 in resp["midi_b64"]:
        data = base64.b64decode(b64)
        try:
            bars = ref_midi.read(data, spec, mix["bars"])
        except (ValueError, KeyError, IndexError):
            bad += 1
            bars = np.zeros((mix["bars"], 96, spec["midi"]["num_pitches"]),
                            np.uint8)
        bad += int(ref_midi.write(bars, spec) != data)
        out.append(bars)
    bars = np.stack(out)
    bad += int(float(bars.mean()) != resp["density"])
    return bars, bad


def latent_path(spec: dict, mix: dict, seed: int, device) -> tuple:
    """A request's per-bar latents [samples, bars, z] and reset bars: one
    N(0, 1) draw [phrases, samples, z] from a generator seeded with the
    request's seed, a phrase's z held over its num_bars bars, the
    recurrent state restarted at each phrase's first bar."""
    per = spec["model"]["num_bars"]
    phrases = -(-mix["bars"] // per)
    gen = torch.Generator(device).manual_seed(seed)
    noise = torch.randn((phrases, mix["samples"], spec["model"]["z_dim"]),
                        generator=gen, device=device)
    z = noise.repeat_interleave(per, dim=0)[:mix["bars"]].transpose(0, 1)
    return z, [k % per == 0 for k in range(mix["bars"])]


def logit_gap(spec: dict, mix: dict, params, seeds: List[int],
              bars: List[np.ndarray], device, control=None) -> float:
    """The widest margin by which a served cell lies on the wrong side of
    the threshold in the reference's logits (0 when every cell agrees);
    in blocks of requests, in f32 with TF32 off. With ``control`` (a
    precision, ``reference.model.fp8``) the cells judged are not the
    served ones but those the reference in that precision chooses, fed
    the same served bars."""
    if spec["model"]["kind"] != "gru_seq":
        raise ValueError("the serve reference decodes gru_seq models")
    thr = spec["midi"]["binarize_threshold"]
    logit_t = float(np.log(thr) - np.log1p(-thr))
    mask = ref.pitch_mask(spec, device) > 0
    worst = 0.0
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            P = {k: v.to(device) for k, v in params.items()}
            for i in range(0, len(seeds), 8):
                zs, resets = zip(*(latent_path(spec, mix, s, device)
                                   for s in seeds[i:i + 8]))
                served = torch.from_numpy(
                    np.concatenate(bars[i:i + 8])).to(device)
                z = torch.cat(zs)
                logits = ref.decode_step_logits(P, served, z, resets[0],
                                                spec)
                on = served > 0
                if control is not None:
                    on = ref.decode_step_logits(P, served, z, resets[0],
                                                spec, control) > logit_t
                wrong = torch.where(on, logit_t - logits, logits - logit_t)
                # a cell outside the pitch mask is never served on
                wrong = torch.where(mask, wrong, torch.where(
                    on, torch.full_like(wrong, float("inf")),
                    torch.zeros_like(wrong)))
                worst = max(worst, float(wrong.clamp_min(0).max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return worst


def decode_all(spec, mix, resps):
    """(the bars of each response, the MIDI mismatches over them)."""
    decoded = [decode(spec, mix, r) for r in resps]
    return [b for b, _ in decoded], sum(n for _, n in decoded)
