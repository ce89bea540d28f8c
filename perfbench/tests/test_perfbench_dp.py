"""The data-parallel training cell on the CPU at small shapes, two gloo
processes standing in for the four cards: a sound run is correct and
reports its metrics, its traced run its per-layer metrics; a rank that
keeps its own gradients (``controls_dp``'s fault) fails ``replica_gap``
and ``grad_gap``; a second step that left no graph ends the run. And the
cell's arithmetic and readers: the NCCL kernels
found by name in a synthetic kernel table (None where it holds none), the
all-reduce's bytes for c4_cond against the program's parameters, the
cond step's FLOPs, and ``dist.init`` read from a tracer snapshot."""

import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

import tiny
from perfbench import controls_dp, harness, yardstick, yardstick_dp
from perfbench import run as runner

CELL = "c4_cond.train-dp4"


def _ctx(trace=False, seed=2 ** 31 + 77):
    w, _, mix = harness.cell(harness.benchmark(), CELL)
    spec = tiny.spec(w["config"])
    mix = dict(mix, pieces=8, bars_per_piece=8, trace_dispatches=1)
    return harness.Ctx(CELL, spec, mix, seed, 0.1, trace, "cpu", 2)


def _module(name):
    path = os.path.join(harness.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_sound_run_is_correct():
    line = json.loads(runner.execute(harness.benchmark(), _ctx()))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["replica_gap"]["value"] == 0.0
    assert set(line["metrics"]) == {"train_bars_per_s", "setup_s"}


def test_a_traced_run_reads_its_layers():
    line = json.loads(runner.execute(harness.benchmark(), _ctx(trace=True)))
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    # no NCCL kernel on the CPU: the all-reduce's roofline is not read
    assert set(got) == {"mfu.train_dp", "device_idle.train_dp",
                        "dist_setup_s.train_dp"}
    assert got["dist_setup_s.train_dp"]["value"] > 0


def test_a_rank_without_the_all_reduce_is_caught():
    ctx = _ctx()
    got = controls_dp.readings(ctx, "skip_allreduce")
    limits = ctx.spec["limits"]["train"]
    assert got["replica"] > limits["replica"]
    assert got["grad"] > limits["grad"] and got["grad_rank"] == 1
    sound = controls_dp.readings(ctx, "program")
    assert sound["replica"] == 0.0 and sound["grad"] < 1e-5


_SECOND_STEP = """
import types
from musicvae_tpu_torch.train import trainer
from perfbench.runners import train_dp
trainer._RowStep.__call__ = lambda self, j, rows, eps, shifts: {"step": j}
restore = train_dp._require_capture()
step = types.SimpleNamespace(program=types.SimpleNamespace(graph=GRAPH))
for j in range(3):
    trainer._RowStep.__call__(step, j, {}, None, None)
restore()
assert trainer._RowStep.__call__(step, 0, {}, None, None) == {"step": 0}
print("ran three steps")
"""


@pytest.mark.parametrize("graph", ["None", "object()"])
def test_an_eager_second_step_ends_the_run(graph):
    out = subprocess.run(
        [sys.executable, "-c", _SECOND_STEP.replace("GRAPH", graph)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    if graph == "None":
        assert out.returncode == 8, out.stderr
        assert "eagerly" in out.stderr and "ran three" not in out.stdout
    else:
        assert out.returncode == 0, out.stderr
        assert "ran three steps" in out.stdout


def _run(kernels, steps=100):
    spec = harness.load_json(os.path.join(harness.BENCH, "configs",
                                          "c4_cond.json"))
    ctx = harness.Ctx(CELL, spec, {}, 1, 1.0, True)
    return harness.TraceRun(ctx, {"kernels": kernels, "steps": steps,
                                  "window_s": 1.0, "busy_s": 0.5,
                                  "flops_per_step": 1e9})


def test_the_allreduce_roofline_reads_nccl_kernels_by_name():
    read = harness.reader("allreduce_roofline.train_dp")
    bound = yardstick_dp.allreduce_bound_s(_run({}).spec)
    kernels = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": [100, 0.01],
               "ncclDevKernel_AllReduce_Sum_i32_RING_LL(x)": [2, 0.0002],
               "void mvk::bce_sum<float>": [100, 0.5]}
    assert read(_run(kernels)) == pytest.approx(
        100 * bound / (0.0102 / 100))
    assert read(_run({"void mvk::bce_sum<float>": [100, 0.5]})) is None
    assert read(_run({})) is None
    assert read(_run(kernels, steps=0)) is None


def test_the_bucket_is_every_parameter_and_three_metrics():
    from musicvae_tpu_torch.models.vae import PianoRollVAE
    spec = _run({}).spec
    cfg = harness.port_config(spec)
    model = PianoRollVAE(cfg.model, cfg.midi)
    params = sum(p.numel() for p in model.parameters())
    assert yardstick_dp.bucket_bytes(spec) == 4 * (params + 3)
    assert 2.5e6 < params < 3.5e6
    assert yardstick_dp.allreduce_bound_s(spec) == pytest.approx(
        4 * (params + 3) / 450e9)


def test_the_cond_step_is_the_gru_step_and_its_conditioning():
    spec = _run({}).spec
    plain = dict(spec, model=dict(spec["model"], kind="gru_seq"))
    extra = yardstick_dp.train_step_flops(spec, 32) - \
        yardstick.train_step_flops(plain, 32)
    m = spec["model"]
    c, h, bars = 2 * m["cond_embed_dim"], m["gru_hidden"], 32 * 4
    head = c * 3 * 4 * m["dec_channels"][0]        # a 3 x 4 x 128 grid
    assert extra == 2 * 3 * bars * (2 * 3 * h * c + head)
    assert math.isclose(harness.reader("mfu.train_dp")(_run({})),
                        100 * 1e9 * 100 / 989e12)


def test_dist_setup_reads_the_init_span():
    mod = _module("dist_setup_s.train_dp")
    assert mod.seconds({"totals": {"dist.init": [1, 2.5]}}) == 2.5
    assert mod.seconds({"totals": {"graph.warmup": [1, 2.0]}}) is None
    assert harness.reader("device_idle.train_dp")(_run({})) == \
        pytest.approx(50.0)
