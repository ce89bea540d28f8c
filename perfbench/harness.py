"""What every cell's run shares: the run's context, the configuration and
mix files found by name, the statistics, the reduction of a profiler
trace, the per-layer metric readers, the import check and the result
line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")

# top-level module names no run may load: the JAX stack and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "musicvae_tpu")


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""
    workload: str
    spec: dict              # the configuration file
    mix: dict               # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    chips: int = 1
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


@dataclasses.dataclass
class TraceRun:
    """What a per-layer reader reads: the run's context and the trace
    facts its runner gathered."""
    ctx: Ctx
    trace: Dict[str, Any]

    @property
    def spec(self) -> dict:
        return self.ctx.spec


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a runner hands back: the end-to-end metrics (untraced runs),
    the trace facts the per-layer readers read (traced runs), the work
    attempted and failed, the checks that decide ``correct``, the
    device's memory peak, and the forbidden modules (``FORBIDDEN``) that
    a process of the run other than this one had loaded."""
    metrics: Dict[str, float]
    trace: Dict[str, Any]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    forbidden: List[str] = dataclasses.field(default_factory=list)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    spec = load_json(os.path.join(ROOT, cfg_entry["file"]))
    mix = load_json(os.path.join(BENCH, "mixes", w["traffic"] + ".json"))
    return w, spec, mix


def port_config(spec: dict):
    """The program's Config object for a configuration file."""
    from musicvae_tpu_torch import config as C

    def build(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in fields})

    return C.Config(name=spec["name"], midi=build(C.MidiSpec, spec["midi"]),
                    model=build(C.ModelSpec, spec["model"]),
                    train=build(C.TrainSpec, spec["train"]),
                    gen=build(C.GenSpec, spec["gen"]),
                    mesh=build(C.MeshSpec, spec["mesh"]))


def derived_seed(seed: int, what: int) -> int:
    """A seed of its own for each input a run makes from ``--seed``."""
    return (seed * 8 + what) % (1 << 63)


# -- statistics -----------------------------------------------------------------

def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    closest ranks; infinite values sort above every finite one."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or xs[hi] == xs[lo]:
        return xs[lo]
    if math.isinf(xs[hi]):
        return xs[hi]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# -- profiler traces ------------------------------------------------------------

def profiler():
    """A torch profiler of the host's ops on every thread and of the
    device's operations; started by the caller."""
    from torch.profiler import ProfilerActivity, profile
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events, window: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, Any]:
    """The facts the per-layer readers take from a profiler trace (kineto
    events): device time by kernel name, the device's busy seconds and
    the window's length, and the breakdown the result line carries; and,
    for a runner's own use, every device interval with its name (ns),
    under ``device``. The window is ``window`` (ns) or the span of all
    events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        if e.device_type() != cuda:
            host.append((s, s + d, e.name()))
        elif not e.is_user_annotation():
            # a device operation, not a host range drawn on the device's
            # timeline
            dev.append((s, s + d, e.name()))
    if window is None:
        every = dev + host
        window = (min(s for s, _, _ in every), max(e for _, e, _ in every))
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    kernels: Dict[str, List[float]] = {}
    for s, e, n in dev:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_host_doing(host, a, b), (b - a) * 1e-9] for a, b in gaps[:10]]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_s,
            "kernels": kernels,
            "device": sorted(dev),
            "breakdown": {"device_ops": [[n[:120], v[1]] for n, v in top],
                          "idle_gaps": idle}}


def _host_doing(host, a: int, b: int) -> str:
    """What the host was doing over a device gap [a, b): the shortest host
    event that covers at least half of it, else the one that covers most
    of it."""
    best, best_cover = None, 0
    half = None
    for s, e, n in host:
        cover = min(e, b) - max(s, a)
        if cover <= 0:
            continue
        if 2 * cover >= b - a and (half is None or e - s < half[0]):
            half = (e - s, n)
        if cover > best_cover:
            best, best_cover = n, cover
    name = half[1] if half is not None else best
    return (name or "no traced host event")[:120]


# -- per-layer metrics ------------------------------------------------------------

def reader(name: str) -> Callable:
    """The reader of per-layer metric ``name``: ``read`` of
    perfbench/metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_metrics(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    reported = {n for n, m in e2e.items()
                if "workloads" not in m or workload in m["workloads"]}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def end_to_end_metrics(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


# -- the result ------------------------------------------------------------------

def forbidden_loaded() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(chips: int, memory_peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes)}


def result_line(outcome: Outcome, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    line = {"correct": all(c.ok for c in outcome.checks)
            and bool(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return json.dumps(line)
