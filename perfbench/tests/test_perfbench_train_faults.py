"""A training cell's run on the CPU at small shapes, past its look for a
card, with the timed path broken underneath (a step that leaves the state
unchanged; half of each batch left out of the loss, the mean taken over
the rest; a dispatch that feeds each of its steps its first row), comes
out not correct; and with no card there is no result."""

import json
import subprocess
import sys

import pytest

import tiny
from perfbench import harness
from perfbench import run as runner


def _run(workload, trace=False):
    line = json.loads(runner.execute(harness.benchmark(),
                                     tiny.ctx(workload, trace=trace)))
    return line


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from musicvae_tpu_torch.train import trainer
    monkeypatch.setattr(trainer.Adam, "update", lambda self, *a, **k: None)
    line = _run("c2_gru_4bar.train-resident")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from musicvae_tpu_torch.train import trainer
    elbo = trainer.elbo_from_outputs

    def half(cfg, logits, x, latents, *a, **k):
        h = logits.shape[0] // 2
        return elbo(cfg, logits[:h], x[:h],
                    [(mu[:h], lv[:h]) for mu, lv in latents], *a, **k)

    monkeypatch.setattr(trainer, "elbo_from_outputs", half)
    line = _run("c3_hier_16bar.train-resident")
    assert line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] > \
        line["checks"]["grad_gap"]["limit"]


def test_a_dispatch_that_repeats_its_first_row_is_caught(monkeypatch):
    from musicvae_tpu_torch.train import trainer
    call = trainer._RowStep.__call__
    monkeypatch.setattr(trainer._RowStep, "__call__",
                        lambda self, j, *a: call(self, 0, *a))
    line = _run("c2_gru_4bar.train-resident")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > \
        line["checks"]["change_gap"]["limit"]


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "c2_gru_4bar.train-resident", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr
