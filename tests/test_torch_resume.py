"""Resume from the port's checkpoint files through ``train()`` (train/
trainer.py) on the CPU at tiny f32 widths: a run cut at a checkpoint and
continued from disk in a fresh state equals the uninterrupted run bit for
bit; the best-eval checkpoint and its ``best_metric.json`` sidecar are
written and honoured on resume; a stop request saves the exact step it
was answered at; ``train(state=...)`` takes the config's optimizer
settings."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from musicvae_tpu_torch.checkpoints import io
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.train.preemption import GracefulStop
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import bar_dataset, same_state, train_cfg


@pytest.mark.parametrize("kw", [dict(), dict(ema_decay=0.9,
                                             transpose_aug=2,
                                             grad_clip_norm=1.0)])
def test_resume_from_disk_is_bit_exact(tmp_path, kw):
    """4 steps saving every 2 == 2 steps, a restore of step 2 from disk
    into a state of other weights and generator, and 2 more steps."""
    cfg = train_cfg(ckpt_every=2, **kw)
    ds = bar_dataset()
    mgr = io.make_manager(str(tmp_path / "ckpt"))
    logged_a, logged_b = [], []
    _, state_a, last_a = trainer.train(
        cfg, ds, num_steps=4, ckpt_manager=mgr, device="cpu",
        log_fn=lambda s, m: logged_a.append((s, m)))
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 4]
    _, state_b = trainer.create_state(cfg, device="cpu", seed=77)
    state_b, cfg_b = io.restore(io.make_manager(mgr.directory), state_b,
                                step=2)
    assert int(state_b.step) == 2 and cfg_b == cfg
    _, state_b, last_b = trainer.train(
        cfg_b, ds, num_steps=4, state=state_b,
        log_fn=lambda s, m: logged_b.append((s, m)))
    assert same_state(state_a, state_b)
    assert last_a.keys() == last_b.keys()
    assert all(torch.equal(last_a[k], last_b[k]) for k in last_a)
    assert logged_b == logged_a[-1:]


def _best_run(tmp_path, num_steps, state=None):
    cfg = train_cfg(eval_every=2, eval_batches=1)
    train_ds, eval_ds = bar_dataset().split(0.34, seed=cfg.train.seed)
    best = io.make_manager(str(tmp_path / "best"), keep=1)
    evals = []
    _, state, _ = trainer.train(
        cfg, train_ds, num_steps=num_steps, eval_data=eval_ds,
        best_ckpt_manager=best, state=state, device="cpu",
        log_fn=lambda s, m: evals.append((s, m["eval_loss"]))
        if "eval_loss" in m else None)
    best.wait_until_finished()
    return state, best, evals


@pytest.mark.parametrize("sidecar", ["kept", "better", "unreadable"])
def test_best_checkpoint_and_its_sidecar(tmp_path, sidecar):
    """The lowest eval loss so far is saved with its sidecar; a resumed
    run reads the sidecar and saves only what beats it, and an unreadable
    sidecar means a fresh best."""
    state, best, evals = _best_run(tmp_path, 4)
    path = os.path.join(best.directory, "best_metric.json")
    low_step, low = min(evals, key=lambda e: e[1])
    with open(path) as f:
        assert json.load(f) == {"eval_loss": low, "step": low_step}
    assert best.all_steps() == [low_step]
    if sidecar == "better":
        with open(path, "w") as f:
            json.dump({"eval_loss": -1.0, "step": 0}, f)
    elif sidecar == "unreadable":
        with open(path, "w") as f:
            f.write("{truncated")
    _, best, evals = _best_run(tmp_path, 8, state)
    with open(path) as f:
        got = json.load(f)
    if sidecar == "better":
        assert got == {"eval_loss": -1.0, "step": 0}
        assert best.all_steps() == [low_step]
    else:
        first = low if sidecar == "kept" else float("inf")
        later = [e for e in evals if e[1] < first]
        want = min(later, key=lambda e: e[1]) if later else (low_step, low)
        assert got == {"eval_loss": want[1], "step": want[0]}
        assert best.all_steps() == [want[0]]


class _StopAfter:
    """A stop whose ``requested`` turns true once the loop has logged
    ``after`` steps."""

    def __init__(self, after):
        self.after, self.logged = after, []

    @property
    def requested(self):
        return bool(self.logged) and self.logged[-1] >= self.after

    def log(self, step, metrics):
        self.logged.append(step)


@pytest.mark.parametrize("ckpt_every,stop_at", [(0, 2), (4, 4), (4, 2)])
def test_stop_saves_the_step_it_answered_at(tmp_path, ckpt_every, stop_at):
    """Asked to stop after a dispatch, the loop saves that exact step once
    (the cadence's own save counts) and returns."""
    cfg = train_cfg(ckpt_every=ckpt_every)
    mgr = io.make_manager(str(tmp_path / "ckpt"))
    stop = _StopAfter(stop_at)
    _, state, _ = trainer.train(cfg, bar_dataset(), num_steps=8,
                                ckpt_manager=mgr, stop=stop, log_fn=stop.log,
                                device="cpu")
    mgr.wait_until_finished()
    assert int(state.step) == stop_at and stop.logged[-1] == stop_at
    assert mgr.all_steps() == [stop_at]
    _, fresh = trainer.create_state(cfg, device="cpu")
    assert same_state(io.restore(mgr, fresh)[0], state)


def test_graceful_stop_turns_a_signal_into_a_request():
    """The handler sets the flag and re-arms the signal's previous
    handler, which comes back on exit."""
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    with GracefulStop() as stop:
        assert not stop.requested
        handler = signal.getsignal(signal.SIGTERM)
        if handler is not prev:         # the main thread: installed
            handler(signal.SIGTERM, None)
            assert stop.requested
            assert signal.getsignal(signal.SIGTERM) is prev
    assert signal.getsignal(signal.SIGTERM) is prev


def test_train_takes_the_configs_optimizer_settings():
    """A state handed to ``train`` steps with the config's learning rate
    (as a resumed run with ``--lr`` does), keeping its moments."""
    ds = bar_dataset()
    cfg = train_cfg()
    _, state = trainer.create_state(cfg, device="cpu")
    _, state, _ = trainer.train(cfg, ds, num_steps=2, state=state)
    frozen = [p.detach().clone() for p in state.params]
    mu = [m.clone() for m in state.opt.mu]
    _, state, _ = trainer.train(
        cfg.replace(train=dataclasses.replace(cfg.train, learning_rate=0.0)),
        ds, num_steps=4, state=state)
    assert int(state.step) == 4
    assert all(torch.equal(a, b) for a, b in zip(frozen, state.params))
    assert not all(torch.equal(a, b) for a, b in zip(mu, state.opt.mu))
    assert np.isfinite(float(state.opt.count))
