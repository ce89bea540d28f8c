"""The benchmark's arithmetic: percentiles, the serve window's metrics with
failed requests, the open-loop schedule, the kernels' bounds and the model
FLOP counts."""

import json
import math
import os

import pytest

from perfbench import harness, traffic, yardstick
from perfbench.runners import serve


def test_percentile_interpolates_and_sorts_misses_last():
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert harness.percentile([0.0, 10.0], 95) == pytest.approx(9.5)
    xs = [1.0] * 94 + [float("inf")] * 6
    assert harness.percentile(xs, 50) == 1.0
    assert math.isinf(harness.percentile(xs, 95))


def _result(done, sent=0.0, ok=True, samples=4):
    resp = ({"midi_b64": ["x"] * samples, "density": 0.0} if ok
            else {"error": "boom"})
    return {"resp": resp, "sent": sent, "done": done}


def test_latency_metrics_time_from_due_and_count_failures_as_misses():
    plan = [(0.0, 1), (1.0, 2), (2.0, 3), (3.0, 4)]
    results = [_result(0.1), _result(1.3), _result(2.2, ok=False), None]
    m = serve.latency_metrics(plan, results, t0=0.0, seconds=4.0, samples=4)
    # latencies 100, 300, inf, inf: the median interpolates into a miss
    assert math.isinf(m["serve_p50_ms"]) and math.isinf(m["serve_p95_ms"])
    assert m["serve_req_per_s"] == pytest.approx(2 / 4.0)
    results = [_result(0.1), _result(1.3), _result(2.2), _result(3.1)]
    m = serve.latency_metrics(plan, results, 0.0, 4.0, 4)
    assert m["serve_p50_ms"] == pytest.approx(150.0)
    assert m["serve_req_per_s"] == pytest.approx(1.0)


def test_a_late_answer_stretches_the_window():
    plan = [(0.0, 1), (1.0, 2)]
    m = serve.latency_metrics(plan, [_result(0.5), _result(6.0)], 0.0,
                              2.0, 4)
    assert m["serve_req_per_s"] == pytest.approx(2 / 6.0)


def test_schedule_is_the_same_for_a_seed_and_the_same_work_for_every_seed():
    a = traffic.schedule(40.0, 20.0, 2 ** 33 + 1)
    assert a == traffic.schedule(40.0, 20.0, 2 ** 33 + 1)
    b = traffic.schedule(40.0, 20.0, 7)
    assert len(a) == len(b) == 800
    gaps = lambda s: sorted(round(y[0] - x[0], 9) for x, y in zip(s, s[1:]))
    assert a != b
    # the same set of gaps (the last one closes the window) in another order
    assert gaps(a + [(20.0, 0)]) == pytest.approx(gaps(b + [(20.0, 0)]))
    assert a[0][0] == 0.0 and a[-1][0] < 20.0
    assert len({s for _, s in a}) == len(a)
    # every block of consecutive requests holds one gap of each stratum
    rng = __import__("numpy").random.default_rng(5)
    g = traffic.gaps_in_order(800, rng)
    rank = g.argsort().argsort() // (800 // traffic.BLOCK)
    for b in range(0, 800, traffic.BLOCK):
        assert sorted(rank[b:b + traffic.BLOCK]) == list(range(traffic.BLOCK))
    assert traffic.sample(800, 16, 3) == traffic.sample(800, 16, 3)
    assert len(set(traffic.sample(800, 16, 3))) == 16


@pytest.mark.parametrize("bound,expect_us", [
    # PERF.md's kernel table (bytes over 3.35 TB/s or f32 operations
    # over 67 TFLOP/s, the larger)
    (lambda: yardstick.k4_bound_s(64 * 4 * 96 * 128), 8.45),
    (lambda: yardstick.k4_bound_s(25_165_824), 67.61),
    (lambda: yardstick.k1b_bound_s(256, 16), 9.01),
    (lambda: yardstick.k1b_bound_s(2048, 16), 72.12),
    (lambda: yardstick.k1_bound_s(256, 16), 8.45),
    (lambda: yardstick.k1_bound_s(4, 16), 0.13),
    (lambda: yardstick.k1_bound_s(16, 16), 0.53),
    (lambda: yardstick.k1_bound_s(2048, 16), 67.61),
])
def test_kernel_bounds_match_the_kernel_table(bound, expect_us):
    assert bound() * 1e6 == pytest.approx(expect_us, abs=0.006)


def _spec(name):
    return harness.load_json(os.path.join(harness.BENCH, "configs",
                                          name + ".json"))


@pytest.mark.parametrize("name,batch,xla_gflop,more", [
    # MFU.json's XLA cost-model counts; perfbench counts 4.1 % and 5.4 %
    # more (PERF.md §3 says why)
    ("c2_gru_4bar", 64, 59.406, 0.0415),
    ("c3_hier_16bar", 128, 478.704, 0.0543),
])
def test_train_flops_against_the_xla_count(name, batch, xla_gflop, more):
    with open(os.path.join(harness.ROOT, "MFU.json")) as f:
        row = [r for r in json.load(f)["rows"] if r["config"] == name
               and r["what"] == "train"][0]
    assert row["gflops_per_step"] == pytest.approx(xla_gflop)
    ours = yardstick.train_step_flops(_spec(name), batch) / 1e9
    assert ours / xla_gflop - 1 == pytest.approx(more, abs=0.001)


def test_sweep_flops_scale_with_rows():
    spec = _spec("c2_gru_4bar")
    one = yardstick.sweep_flops(spec, 4, 16, 4)
    assert yardstick.sweep_flops(spec, 32, 16, 4) == pytest.approx(8 * one)
    assert one / 1e9 == pytest.approx(3.449, abs=0.001)
