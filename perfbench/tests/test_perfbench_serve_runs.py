"""The serve cell's run on the CPU at a small load (its server runs the
configuration as it is), past the look for a card: sound, it comes out
correct, and traced it reads the median latency the client saw; with
served bars altered where the server produces them, not correct; with a
module of the JAX stack loaded in the server, no result."""

import json
import os

import pytest

from perfbench import harness
from perfbench import run as runner
from perfbench.runners import serve

import tiny

WORKLOAD = "c2_gru_4bar.serve-tcp"


def test_a_sound_run_is_correct():
    line = json.loads(runner.execute(harness.benchmark(),
                                     tiny.ctx(WORKLOAD)))
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] == 2
    assert set(line["metrics"]) == {"serve_req_per_s", "setup_s"}


def test_a_traced_run_reads_the_client_timed_median():
    line = json.loads(runner.execute(harness.benchmark(),
                                     tiny.ctx(WORKLOAD, trace=True)))
    assert line["correct"] is True, line["checks"]
    p50 = line["metrics"]["p50_ms.serve"]
    assert p50["unit"] == "ms" and 0 < p50["value"] < 60e3


def test_an_altered_answer_is_caught(monkeypatch):
    monkeypatch.setattr(serve, "SERVED", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "served_flipped.py"))
    line = json.loads(runner.execute(harness.benchmark(),
                                     tiny.ctx(WORKLOAD)))
    assert line["correct"] is False
    gap = line["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_a_server_that_loaded_jax_gives_no_result(monkeypatch, capsys):
    monkeypatch.setattr(serve, "SERVED", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "served_loads_jax.py"))
    with pytest.raises(SystemExit) as exit_:
        runner.execute(harness.benchmark(), tiny.ctx(WORKLOAD))
    assert exit_.value.code == 4
    assert "jax" in capsys.readouterr().err
