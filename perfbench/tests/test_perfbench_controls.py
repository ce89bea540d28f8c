"""The controls of ``correct`` on the card, at each cell's own size: the
reference put in the program's place in fp8 (the precision below the
configurations' bf16) must fail a number of every cell, on three seeds;
and so must each fault a training cell can have (half of each batch left
out of the loss; a state left unchanged reads 1 on the change and needs no
run). Run on the card by perfbench/README.md's card command; skipped
elsewhere."""

import pytest

from perfbench import controls, harness

SEEDS = (101, 102, 103)
TRAIN = ["c2_gru_4bar.train-resident", "c3_hier_16bar.train-resident"]


def _ctx(workload, seed, device, seconds=0.0):
    _, spec, mix = harness.cell(harness.benchmark(), workload)
    return harness.Ctx(workload, spec, mix, seed, seconds, False, device)


@pytest.mark.card
@pytest.mark.parametrize("variant", ["control", "half"])
@pytest.mark.parametrize("workload", TRAIN)
def test_a_train_control_fails(card, workload, variant):
    for seed in SEEDS:
        ctx = _ctx(workload, seed, card)
        limits = ctx.spec["limits"]["train"]
        got = controls.train_readings(ctx, variant)
        assert any(got[k] > limits[k] for k in limits), (seed, got)


@pytest.mark.card
@pytest.mark.parametrize("workload", TRAIN)
def test_sound_train_readings_pass(card, workload):
    ctx = _ctx(workload, SEEDS[0], card)
    limits = ctx.spec["limits"]["train"]
    got = controls.train_readings(ctx, "program")
    assert all(got[k] <= limits[k] for k in limits), got


@pytest.mark.card
def test_the_serve_control_fails(card):
    for seed in SEEDS:
        ctx = _ctx("c2_gru_4bar.serve-tcp", seed, card, 5.0)
        limit = ctx.spec["limits"]["serve"]["gap"]
        got = controls.serve_readings(ctx, 5.0)
        assert got["checked"] == ctx.mix["check_requests"]
        assert got["gap"] <= limit < got["control_gap"], (seed, got)
