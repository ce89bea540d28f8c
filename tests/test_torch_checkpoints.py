"""The port's checkpoint files (musicvae_tpu_torch/checkpoints/io.py) on the
CPU at tiny f32 widths: the config JSON is the JAX package's for every
registered config; a saved state restores bit for bit, generator included;
keep-N retention, the refusal of a step that is not newer, and the commit
by rename; a damaged latest step is retried, skipped and quarantined
(``.corrupt``, ``.corrupt.N``) only once an older step restores; a run
whose every step fails says that nothing was quarantined; an explicit
step is strict; a directory in the Orbax layout names the importer."""

import os

import pytest
import torch

from musicvae_tpu.checkpoints import io as jax_io
from musicvae_tpu.config import all_config_names as jax_names
from musicvae_tpu.config import get_config as jax_get_config
from musicvae_tpu_torch.checkpoints import io
from musicvae_tpu_torch.config import all_config_names, get_config
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import bar_dataset, same_state, train_cfg


def _trained_state(cfg, steps: int = 2, seed: int = 0):
    """A state whose moments, EMA and generator have moved: ``steps``
    steps on a tiny dataset."""
    ds = bar_dataset()
    data = {"bars": torch.from_numpy(ds.bars),
            "starts": torch.from_numpy(ds.starts)}
    ids = trainer.make_id_schedule(seed, len(ds), cfg.train.batch_size)
    model, state = trainer.create_state(cfg, device="cpu", seed=seed)
    step = trainer.make_train_step_indexed(cfg, model)
    for j in range(steps):
        step(state, data, torch.from_numpy(ids(j)))
    return state


@pytest.fixture(scope="module")
def state():
    return _trained_state(train_cfg())


def _saved(tmp_path, state, steps, keep=3, cfg=None):
    """A manager with ``state`` saved at each of ``steps``."""
    mgr = io.make_manager(str(tmp_path / "ckpt"), keep=keep)
    for s in steps:
        state.step.fill_(s)
        assert io.save(mgr, state, cfg or train_cfg(), wait=True)
    return mgr


def _truncate(mgr, step):
    path = os.path.join(mgr.step_dir(step), io.STATE_FILE)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)


@pytest.mark.parametrize("name", sorted(all_config_names()))
def test_config_json_is_the_jax_packages(name):
    """The same string as the JAX package's ``config_to_json``, and the
    JAX string read by the port is the registered config."""
    assert name in jax_names()
    want = jax_io.config_to_json(jax_get_config(name))
    assert io.config_to_json(get_config(name)) == want
    assert io.config_from_json(want) == get_config(name)


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_save_restore_is_bit_exact(tmp_path, ema_decay):
    cfg = train_cfg(ema_decay=ema_decay)
    saved = _trained_state(cfg, seed=0)
    mgr = io.make_manager(str(tmp_path / "ckpt"))
    assert io.save(mgr, saved, cfg, wait=True) and mgr.all_steps() == [2]
    assert sorted(os.listdir(mgr.step_dir(2))) == [io.CONFIG_FILE,
                                                    io.STATE_FILE]
    sd = torch.load(os.path.join(mgr.step_dir(2), io.STATE_FILE),
                    weights_only=True)
    assert (sd["ema"] is None) == (ema_decay == 0)
    _, fresh = trainer.create_state(cfg, device="cpu", seed=99)
    assert not same_state(fresh, saved)
    restored, cfg_back = io.restore(io.make_manager(mgr.directory), fresh)
    assert restored is fresh and cfg_back == cfg
    assert same_state(restored, saved)
    # the generator goes on with the same draws
    assert torch.equal(torch.randn(5, generator=restored.generator),
                       torch.randn(5, generator=saved.generator))


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_newest_n(tmp_path, state, keep):
    mgr = _saved(tmp_path, state, [1, 2, 3, 4], keep=keep)
    want = [1, 2, 3, 4][-keep:]
    assert mgr.all_steps() == want and mgr.latest_step() == 4
    assert sorted(int(d) for d in os.listdir(mgr.directory)) == want
    assert io.make_manager(mgr.directory).all_steps() == want


@pytest.mark.parametrize("step", [5, 3])
def test_save_refuses_a_step_that_is_not_newer(tmp_path, state, step):
    mgr = _saved(tmp_path, state, [5])
    before = os.path.getmtime(os.path.join(mgr.step_dir(5), io.STATE_FILE))
    state.step.fill_(step)
    assert io.save(mgr, state, train_cfg(), wait=True) is False
    assert mgr.all_steps() == [5]
    assert sorted(os.listdir(mgr.directory)) == ["5"]
    assert os.path.getmtime(os.path.join(mgr.step_dir(5),
                                         io.STATE_FILE)) == before


@pytest.mark.parametrize("how", ["leftover", "failed_write"])
def test_uncommitted_step_is_never_listed(tmp_path, state, monkeypatch, how):
    """A write that did not reach its rename (left over from a crash, or
    failing now) lists no step; the failure surfaces at the wait."""
    d = tmp_path / "ckpt"
    if how == "leftover":
        (d / ".7.tmp-123").mkdir(parents=True)
        (d / ".7.tmp-123" / io.STATE_FILE).write_bytes(b"partial")
        mgr = io.make_manager(str(d))
    else:
        def broken(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(io.torch, "save", broken)
        mgr = io.make_manager(str(d))
        state.step.fill_(7)
        with pytest.raises(RuntimeError, match="failed"):
            io.save(mgr, state, train_cfg(), wait=True)
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    assert io.make_manager(str(d)).all_steps() == []
    assert not [n for n in os.listdir(d) if not n.startswith(".")]
    with pytest.raises(FileNotFoundError):
        io.restore(mgr, state)


@pytest.mark.parametrize("taken", [0, 1, 2])
def test_corrupt_latest_falls_back_and_is_quarantined(tmp_path, state,
                                                      capsys, taken):
    """The truncated latest is tried twice, the next-newest restores, and
    the latest moves to ``.corrupt`` (``.corrupt.N`` past names taken)."""
    mgr = _saved(tmp_path, state, [2, 4])
    _truncate(mgr, 4)
    for n in range(taken):
        os.mkdir(mgr.step_dir(4) + (".corrupt" if n == 0
                                    else f".corrupt.{n}"))
    _, fresh = trainer.create_state(train_cfg(), device="cpu", seed=5)
    restored, _ = io.restore(mgr, fresh)
    assert int(restored.step) == 2
    err = capsys.readouterr().err
    assert err.count("step 4 failed to restore") == 2
    assert "retrying once" in err and "falling back" in err
    name = "4.corrupt" if taken == 0 else f"4.corrupt.{taken}"
    assert os.path.exists(os.path.join(mgr.directory, name))
    assert f"as {name}" in err
    assert mgr.all_steps() == [2]
    assert io.restore_config(mgr) == train_cfg()
    state.step.fill_(4)                  # the step can be written again
    assert io.save(mgr, state, train_cfg(), wait=True)


@pytest.mark.parametrize("fault", ["corrupt", "template"])
def test_every_step_failing_quarantines_nothing(tmp_path, state, fault):
    mgr = _saved(tmp_path, state, [2, 4])
    template = trainer.create_state(train_cfg(), device="cpu")[1]
    if fault == "corrupt":
        _truncate(mgr, 2)
        _truncate(mgr, 4)
    else:                 # a template that disagrees with every step
        template = trainer.create_state(train_cfg(ema_decay=0.5),
                                        device="cpu")[1]
    with pytest.raises(RuntimeError, match="nothing was deleted or "
                                           "quarantined"):
        io.restore(mgr, template)
    assert sorted(os.listdir(mgr.directory)) == ["2", "4"]


@pytest.mark.parametrize("fault", ["corrupt", "missing"])
def test_explicit_step_is_strict(tmp_path, state, fault):
    mgr = _saved(tmp_path, state, [2, 4])
    _, fresh = trainer.create_state(train_cfg(), device="cpu")
    if fault == "corrupt":
        _truncate(mgr, 4)
        with pytest.raises(Exception) as info:
            io.restore(mgr, fresh, step=4)
        assert not isinstance(info.value, RuntimeError) or \
            "all checkpoint steps" not in str(info.value)
    else:
        with pytest.raises(FileNotFoundError):
            io.restore(mgr, fresh, step=3)
        with pytest.raises(FileNotFoundError):
            io.restore_config(mgr, step=3)
    assert sorted(os.listdir(mgr.directory)) == ["2", "4"]
    restored, _ = io.restore(mgr, fresh, step=2)
    assert int(restored.step) == 2


@pytest.mark.parametrize("marker", ["_CHECKPOINT_METADATA", "state"])
def test_orbax_layout_names_the_importer(tmp_path, state, marker):
    step_dir = tmp_path / "jax" / "100"
    step_dir.mkdir(parents=True)
    if marker == "state":
        (step_dir / "state").mkdir()
    else:
        (step_dir / marker).write_text("{}")
    mgr = io.make_manager(str(tmp_path / "jax"))
    assert mgr.all_steps() == [100]
    for fn in (lambda: io.restore(mgr, state),
               lambda: io.restore_config(mgr)):
        with pytest.raises(io.OrbaxLayoutError,
                           match="import_orbax_checkpoint.py"):
            fn()
    assert os.listdir(tmp_path / "jax") == ["100"]


def test_make_manager_creates_nothing_until_a_save(tmp_path):
    mgr = io.make_manager(str(tmp_path / "none"))
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    assert not (tmp_path / "none").exists()
    with pytest.raises(ValueError):
        io.make_manager(str(tmp_path / "x"), keep=0)
