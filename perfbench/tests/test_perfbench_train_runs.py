"""A training cell's run on the CPU at small shapes, past its look for a
card, comes out correct and reports its metrics."""

import json

import pytest

import tiny
from perfbench import harness
from perfbench import run as runner


@pytest.mark.parametrize("workload, rate", [
    ("c2_gru_4bar.train-resident", "train_bars_per_s"),
    ("c3_hier_16bar.train-resident", "train_bars_per_s.hier")])
def test_a_sound_run_is_correct(workload, rate):
    line = json.loads(runner.execute(harness.benchmark(), tiny.ctx(workload)))
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {rate, "setup_s"}


def test_a_traced_streamed_run_reads_its_producer():
    """The streamed data path, whose mix and reader are kept for its cell."""
    from perfbench.runners import train as train_runner
    ctx = tiny.ctx("c2_gru_4bar.train-resident", trace=True,
                   traffic="train-stream")
    outcome = train_runner.run(ctx)
    assert all(c.ok for c in outcome.checks)
    run = harness.TraceRun(ctx, outcome.trace)
    assert harness.reader("producer_ms_per_step.stream")(run) > 0
    assert harness.reader("mfu.train")(run) > 0
