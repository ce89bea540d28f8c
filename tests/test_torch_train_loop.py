"""The port's host loop (train/trainer.py ``train``), its dataset, logger
and ``train`` subcommand, on the CPU at tiny f32 widths: a K-step dispatch
equals K single steps and a run resumed through ``state_dict()`` equals an
uninterrupted one, bit for bit; eval and EMA keys appear at their cadence;
the streaming and sharded-corpus paths and their flags run, and tensor
parallelism, the one thing the port does not implement, is refused by
name; the bar cache is the JAX package's on disk.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from musicvae_tpu.data.dataset import PianoRollDataset as JaxDataset
from musicvae_tpu_torch.cli import main
from musicvae_tpu_torch.config import MeshSpec, MidiSpec
from musicvae_tpu_torch.data.dataset import PianoRollDataset
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.parallel import distributed, make_mesh
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.utils.logging import MetricsLogger
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                same_state, tiny_pair)

TRAIN_KW = dict(batch_size=2, log_every=2, ckpt_every=0, eval_every=0,
                beta_warmup_steps=4, seed=3)


def _cfg(**kw):
    _, tc = tiny_pair()
    return tc.replace(train=dataclasses.replace(tc.train,
                                                **{**TRAIN_KW, **kw}))


def _dataset(seed=0, pieces=6, bars_per_piece=8, num_bars=4,
             cls=PianoRollDataset):
    rng = np.random.default_rng(seed)
    bars = (rng.random((pieces * bars_per_piece, 96, 128)) < 0.05
            ).astype(np.uint8)
    per = bars_per_piece - num_bars + 1
    starts = (np.arange(pieces)[:, None] * bars_per_piece
              + np.arange(per)[None, :]).reshape(-1)
    return cls(bars, starts, num_bars, rng.integers(0, 24, starts.shape[0]),
               rng.integers(0, 24, starts.shape[0]),
               np.repeat(np.arange(pieces), per), grid=(24, 4, 0))


def _same_bits(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    flat = lambda sd: ([sd["step"], sd["opt"]["count"], sd["rng"]]
                       + list(sd["params"].values())
                       + list(sd["opt"]["mu"].values())
                       + list(sd["opt"]["nu"].values())
                       + list((sd["ema"] or {}).values()))
    return all(torch.equal(x, y) for x, y in zip(flat(sa), flat(sb))) \
        and len(flat(sa)) == len(flat(sb))


# -- the dispatch -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(transpose_aug=3, ema_decay=0.9,
                                             grad_clip_norm=1.0,
                                             remat_encoder=True)])
def test_k_step_dispatch_equals_k_single_steps_bit_for_bit(kw):
    cfg = _cfg(**kw)
    ds = _dataset()
    data = {"bars": torch.from_numpy(ds.bars),
            "starts": torch.from_numpy(ds.starts)}
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds), 2)
    idxs = torch.from_numpy(np.stack([ids(j) for j in range(3)]))
    model_a, state_a = trainer.create_state(cfg, device="cpu")
    model_b, state_b = trainer.create_state(cfg, device="cpu")
    assert _same_bits(state_a, state_b)
    multi = trainer.make_train_step_indexed_multi(cfg, model_a)
    single = trainer.make_train_step_indexed(cfg, model_b)
    _, m_multi = multi(state_a, data, idxs)
    for j in range(3):
        _, m_single = single(state_b, data, idxs[j])
    assert int(state_a.step) == 3 and _same_bits(state_a, state_b)
    assert m_multi.keys() == m_single.keys() == {
        "loss", "recon", "kl", "beta", "grad_norm", "nonfinite"}
    assert all(torch.equal(m_multi[k], m_single[k]) for k in m_multi)


def test_window_gather_keeps_uint8_and_matches_host_batch():
    cfg = _cfg()
    ds = _dataset()
    data = {"bars": torch.from_numpy(ds.bars),
            "starts": torch.from_numpy(ds.starts)}
    idx = np.array([0, 7, 29, 3], np.int32)
    got = trainer._make_window_gather(cfg)(data, torch.from_numpy(idx))["x"]
    assert got.dtype == torch.uint8 and got.shape == (4, 4, 96, 128)
    np.testing.assert_array_equal(got.numpy(),
                                  ds.batch(idx, x_dtype=np.uint8)["x"])


# -- train() ------------------------------------------------------------------------

def test_train_resumed_through_state_dict_equals_uninterrupted_run():
    """2 + 2 steps through state_dict()/load_state_dict() equal 4 steps bit
    for bit: params, moments, count, step, EMA and the generator's state
    (the noise and the shifts of steps 3 and 4 come from it)."""
    cfg = _cfg(ema_decay=0.9, transpose_aug=2)
    ds = _dataset()
    _, full, m_full = trainer.train(cfg, ds, num_steps=4, device="cpu")
    _, half, _ = trainer.train(cfg, ds, num_steps=2, device="cpu")
    saved = half.state_dict()
    _, resumed = trainer.create_state(cfg.replace(train=dataclasses.replace(
        cfg.train, seed=99)), device="cpu")            # other weights
    assert not _same_bits(resumed, half)
    resumed.load_state_dict(saved)
    assert _same_bits(resumed, half)
    _, resumed, m_res = trainer.train(cfg, ds, num_steps=4, state=resumed,
                                      device="cpu")
    assert int(resumed.step) == 4 and _same_bits(resumed, full)
    assert all(torch.equal(m_full[k], m_res[k]) for k in m_full)
    # the state dict is a copy: training on did not change it
    assert int(saved["step"]) == 2


def test_train_twice_from_one_seed_gives_the_same_bits():
    cfg = _cfg()
    ds = _dataset()
    _, a, _ = trainer.train(cfg, ds, num_steps=3, device="cpu")
    _, b, _ = trainer.train(cfg, ds, num_steps=3, device="cpu")
    assert _same_bits(a, b)
    # a finished run is not trained again
    _, c, m = trainer.train(cfg, ds, num_steps=3, state=b, device="cpu")
    assert c is b and int(c.step) == 3 and m == {}


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_train_logs_eval_and_ema_keys_at_their_cadence(ema_decay):
    cfg = _cfg(eval_every=4, eval_batches=2, ema_decay=ema_decay)
    train_ds, eval_ds = _dataset().split(0.34, seed=cfg.train.seed)
    logged = []
    _, state, _ = trainer.train(cfg, train_ds, num_steps=8,
                                eval_data=eval_ds, device="cpu",
                                log_fn=lambda s, m: logged.append((s, m)))
    step_logs = [(s, m) for s, m in logged if "loss" in m]
    eval_logs = [(s, m) for s, m in logged if "eval_loss" in m]
    assert [s for s, _ in step_logs] == [2, 4, 6, 8]
    assert [s for s, _ in eval_logs] == [4, 8]
    base = {"loss", "recon", "kl", "precision", "recall", "f1"}
    want = {"eval_" + k for k in base}
    if ema_decay > 0:
        want |= {"eval_ema_" + k for k in base}
    for _, m in eval_logs:
        assert set(m) == want
        assert all(isinstance(v, float) and np.isfinite(v)
                   for v in m.values())
    for _, m in step_logs:
        assert set(m) == {"loss", "recon", "kl", "beta", "grad_norm",
                          "nonfinite"}
    assert (state.ema_model is not None) == (ema_decay > 0)
    if ema_decay > 0:      # the average trails the weights
        assert not torch.equal(state.ema_params[0], state.params[0])


def test_train_eval_is_the_same_sweep_every_time():
    """The eval partition and its noise are fixed, so scoring the same
    weights twice gives the same numbers."""
    cfg = _cfg(eval_every=2, eval_batches=1, learning_rate=0.0)
    train_ds, eval_ds = _dataset().split(0.34, seed=cfg.train.seed)
    logged = []
    trainer.train(cfg, train_ds, num_steps=4, eval_data=eval_ds,
                  device="cpu", log_fn=lambda s, m: logged.append(m))
    evals = [m for m in logged if "eval_loss" in m]
    assert len(evals) == 2 and evals[0] == evals[1]


@pytest.mark.parametrize("mesh,item", [
    (MeshSpec(data=2, model=2), "A16"),
])
def test_train_refuses_unported_arguments(mesh, item, monkeypatch):
    """A config whose mesh has a model axis (tensor parallelism, ROADMAP.md
    item ``item``, now ported) builds its layout when ``train`` is given
    none, and the layout refuses, in the JAX package's words, a model
    axis larger than the world, and one the world's processes do not
    divide."""
    cfg = _cfg().replace(mesh=mesh)
    with pytest.raises(ValueError, match="model axis 2 > 1 devices"):
        trainer.train(cfg, _dataset(), num_steps=1, device="cpu")
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="3 processes are not a multiple "
                                         "of the model axis 2"):
        trainer.train(cfg, _dataset(), num_steps=1, device="cpu")


def test_train_returns_at_a_stop_request():
    """A stop that is already requested ends the run after its first
    dispatch; without a checkpoint manager nothing is saved."""
    class Stop:
        requested = True

    _, state, metrics = trainer.train(_cfg(), _dataset(), num_steps=8,
                                      stop=Stop(), device="cpu")
    assert int(state.step) == 2 and "loss" in metrics


def test_train_refuses_streaming_and_sharded_corpus():
    """What the streaming and sharded-corpus paths refuse: an iterator
    that runs dry before the run's steps (the JAX package's message), and
    a sharded corpus over processes that do not divide the batch."""
    from musicvae_tpu_torch.parallel import DataMesh

    ds = _dataset()
    with pytest.raises(RuntimeError, match="exhausted before 4 steps"):
        trainer.train(_cfg(), iter([ds.batch(np.arange(2))]), num_steps=4,
                      device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 corpus shards"):
        trainer.train(_cfg(corpus_layout="sharded"), ds, num_steps=2,
                      device="cpu",
                      mesh=DataMesh(3, 0, torch.device("cpu")))


def test_train_streams_and_shards_the_corpus():
    """An iterator of host batches trains (f32 rolls cross packed) the
    same steps as the resident path on the same batches, and the sharded
    layout (one shard on one process) trains on the data layout
    ``train`` is handed."""
    ds = _dataset()
    cfg = _cfg()
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds), 2)
    batches = (ds.batch(ids(j)) for j in range(4))
    _, streamed, _ = trainer.train(cfg, batches, num_steps=4, device="cpu")
    _, resident, _ = trainer.train(cfg, ds, num_steps=4, device="cpu")
    assert int(streamed.step) == 4 and same_state(streamed, resident)
    _, state, metrics = trainer.train(
        _cfg(corpus_layout="sharded"), ds, num_steps=2, device="cpu",
        mesh=make_mesh(MeshSpec(), "cpu"))
    assert int(state.step) == 2 and np.isfinite(float(metrics["loss"]))


def test_train_defaults_to_the_card_and_says_so_without_one():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: train() would run on it")
    with pytest.raises(RuntimeError, match="is_available"):
        trainer.train(_cfg(), _dataset(), num_steps=1)


def test_load_state_dict_refuses_mismatched_states():
    _, state = trainer.create_state(_cfg(), device="cpu")
    _, with_ema = trainer.create_state(_cfg(ema_decay=0.5), device="cpu")
    with pytest.raises(ValueError, match="EMA"):
        state.load_state_dict(with_ema.state_dict())
    sd = state.state_dict()
    del sd["params"]["z_head.bias"]
    with pytest.raises(KeyError, match="z_head.bias"):
        state.load_state_dict(sd)


def test_deterministic_algorithms_restores_settings():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.utils.deterministic.fill_uninitialized_memory)
    with trainer.deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
    assert before == (torch.are_deterministic_algorithms_enabled(),
                      torch.backends.cudnn.deterministic,
                      torch.utils.deterministic.fill_uninitialized_memory)


# -- dataset, logger, CLI ------------------------------------------------------------

def test_dataset_cache_is_the_jax_packages(tmp_path):
    """save_npy / load_npy round-trip across the two packages, and split,
    batch and iterator give the same arrays."""
    ours, theirs = _dataset(4), _dataset(4, cls=JaxDataset)
    ours.save_npy(str(tmp_path / "port.npz"))
    theirs.save_npy(str(tmp_path / "jax.npz"))
    from_port = JaxDataset.load_npy(str(tmp_path / "port.npz"))
    from_jax = PianoRollDataset.load_npy(str(tmp_path / "jax.npz"))
    for a, b in ((from_port, theirs), (from_jax, ours)):
        assert len(a) == len(b) == 30 and a.num_bars == b.num_bars
        assert a.grid == b.grid == (24, 4)
        for f in ("bars", "starts", "chords", "keys", "piece_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for (a, b) in zip(ours.split(0.3, seed=5), theirs.split(0.3, seed=5)):
        np.testing.assert_array_equal(a.starts, b.starts)
    idx = np.array([3, 0, 17])
    np.testing.assert_array_equal(ours.window_indices(idx),
                                  theirs.window_indices(idx))
    for dtype in (np.float32, np.uint8):
        a, b = ours.batch(idx, dtype), theirs.batch(idx, dtype)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ia, ib = ours.iterator(4, seed=2), theirs.iterator(4, seed=2)
    for _ in range(9):                         # crosses an epoch boundary
        np.testing.assert_array_equal(next(ia)["x"], next(ib)["x"])


def test_dataset_refuses_what_waits_for_later_items(tmp_path):
    ds = _dataset()
    midi_ds = PianoRollDataset.from_corpus(synth_corpus(2, 5, seed=1),
                                           MidiSpec(), 4)
    assert len(midi_ds) == 4 and midi_ds.grid == (24, 4)
    with pytest.raises(ValueError, match="no windows"):
        PianoRollDataset.from_corpus([], MidiSpec(), 4)
    shards = [ds.host_shard(p, 2) for p in range(2)]
    assert sum(len(s) for s in shards) == len(ds)
    with pytest.raises(ValueError, match="not in"):
        ds.host_shard(2, 2)
    with pytest.raises(ValueError, match="holdout_frac"):
        ds.split(1.5)
    np.savez(str(tmp_path / "old.npz"), windows=np.zeros(3))
    with pytest.raises(ValueError, match="not a bar-format cache"):
        PianoRollDataset.load_npy(str(tmp_path / "old.npz"))


def test_metrics_logger_writes_jsonl(tmp_path):
    logger = MetricsLogger(str(tmp_path / "logs"), use_tensorboard=False,
                           echo=False)
    logger(5, {"loss": torch.tensor(2.5), "kl": 0.25})
    logger(10, {"loss": np.float32(1.5)})
    logger.close()
    lines = [json.loads(ln) for ln in
             (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [5, 10]
    assert lines[0]["loss"] == 2.5 and lines[0]["kl"] == 0.25
    assert lines[1]["steps_per_sec"] > 0


def test_train_subcommand_runs_from_a_saved_cache(tmp_path, capsys):
    cache = str(tmp_path / "cache.npz")
    _dataset(5, cls=JaxDataset).save_npy(cache)     # the JAX package's file
    log_dir = tmp_path / "logs"
    # full-width c2 on the CPU: keep the batch at 1 and the run at 4 steps
    rc = main(["train", "--data", cache, "--steps", "4", "--batch-size", "1",
               "--log-every", "2", "--eval-every", "4", "--eval-batches",
               "1", "--holdout-frac", "0.34", "--ema-decay", "0.9",
               "--device", "cpu", "--log-dir", str(log_dir),
               "--ckpt-dir", str(tmp_path / "ckpt")])
    assert rc == 0
    assert "final metrics" in capsys.readouterr().out
    lines = [json.loads(ln) for ln in
             (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [2, 4, 4]
    assert np.isfinite(lines[0]["loss"]) and lines[0]["nonfinite"] == 0.0
    assert "eval_loss" in lines[2] and "eval_ema_f1" in lines[2]
    # the final save, and the best checkpoint of the one eval
    assert os.listdir(tmp_path / "ckpt" / "4") and os.listdir(
        tmp_path / "ckpt" / "best" / "4")
    assert json.loads((tmp_path / "ckpt" / "best" / "best_metric.json")
                      .read_text())["step"] == 4


@pytest.mark.parametrize("flags", [
    ["--stream"],
    ["--host-sharded", "--eval-every", "0"],
    ["--corpus-layout", "sharded"],
])
def test_train_subcommand_runs_the_data_parallel_flags(flags, tmp_path,
                                                       capsys):
    """Each data path of the JAX package's ``train`` through the port's
    command line, on the CPU at narrow widths, from the JAX package's
    cache file: two steps, a finite loss."""
    cache = str(tmp_path / "cache.npz")
    _dataset(5, cls=JaxDataset).save_npy(cache)
    rc = main(["train", "--data", cache, "--steps", "2", "--batch-size",
               "2", "--log-every", "2", "--enc-channels", "4,8,8,8,8",
               "--dec-channels", "8,8,8,8,8", "--device", "cpu",
               "--log-dir", str(tmp_path / "logs"),
               "--ckpt-dir", str(tmp_path / "ckpt"), *flags])
    assert rc == 0
    out = capsys.readouterr()
    assert "final metrics" in out.out
    lines = [json.loads(ln) for ln in
             (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [2]
    assert np.isfinite(lines[0]["loss"])
    if "--host-sharded" in flags:
        assert "host shard 0/1" in out.err


@pytest.mark.parametrize("world,flags,needle", [
    (1, ["--eval-every", "5"], "Set --eval-every 0"),
    (3, ["--eval-every", "0"], "batch_size 2 not divisible by 3 processes"),
])
def test_train_subcommand_refuses_unported_flags(world, flags, needle,
                                                 tmp_path, capsys,
                                                 monkeypatch):
    """What ``--host-sharded`` cannot do is refused with the JAX package's
    messages: an eval cadence, and a batch that the processes do not
    divide (three processes, as the launch would report them)."""
    from musicvae_tpu_torch.parallel import distributed

    cache = str(tmp_path / "cache.npz")
    _dataset(5).save_npy(cache)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    assert main(["train", "--data", cache, "--host-sharded", "--device",
                 "cpu", "--batch-size", "2", "--log-dir",
                 str(tmp_path / "logs"), "--ckpt-dir", str(tmp_path / "ck"),
                 *flags]) == 2
    assert needle in capsys.readouterr().err


def test_train_subcommand_checks_its_cache(tmp_path, capsys):
    assert main(["train", "--data", str(tmp_path / "none.npz"),
                 "--device", "cpu"]) == 2
    assert "does not exist" in capsys.readouterr().err
    one_bar = str(tmp_path / "one.npz")
    _dataset(num_bars=1).save_npy(one_bar)
    assert main(["train", "--data", one_bar, "--device", "cpu"]) == 2
    assert "1-bar windows" in capsys.readouterr().err
    ds = _dataset()
    ds.grid = (32, 3)
    other_grid = str(tmp_path / "grid.npz")
    ds.save_npy(other_grid)
    assert main(["train", "--data", other_grid, "--device", "cpu"]) == 2
    assert "quantized on grid" in capsys.readouterr().err
    # without --data, --midi-glob is read, else a synthetic corpus made
    assert main(["train", "--device", "cpu", "--midi-glob",
                 str(tmp_path / "none" / "*.mid"), "--ckpt-dir",
                 str(tmp_path / "ck")]) == 2
    assert "no MIDI files match" in capsys.readouterr().err
