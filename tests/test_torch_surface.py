"""The port's import surface against the JAX package's: every name each
JAX package and subpackage exports, and every top-level name of the JAX
modules in ``MODULES``, the port has too (less the names listed in
``EXCLUDED`` with their reasons), and the functions ported for it,
``crop_view``, ``roll_to_notes``, ``init_params`` and ``debug_mode``,
behave as the JAX package's do.
"""

import ast
import dataclasses
import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import musicvae_tpu as jax_pkg
from musicvae_tpu.config import MidiSpec as JMidiSpec
from musicvae_tpu.midi import tensorize as jtensorize
from musicvae_tpu_torch.config import MidiSpec
from musicvae_tpu_torch.midi import tensorize
from musicvae_tpu_torch.models import init_params
from musicvae_tpu_torch.models.vae import build_model
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.utils import debug_mode
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                train_cfg)

PACKAGES = ("", ".midi", ".ops", ".models", ".data", ".generate",
            ".checkpoints", ".train", ".utils", ".parallel")

# JAX names the port leaves out, and why
EXCLUDED = {
    # Pallas-only: the port's kernels are CUDA, behind the same functions
    # (ops/fused_elbo.py, ops/conv1.py)
    "masked_bce_sum_pallas": "a Pallas kernel's entry",
    "masked_bce_sum_pallas_dual": "a Pallas kernel's entry",
    "kl_sum_pallas": "a Pallas kernel's entry",
    "build_band": "the Pallas first conv's banded-MXU weight layout",
    "M_TILE": "the Pallas first conv's tile of bars",
    # jax.sharding placement: each of the port's processes drives one
    # device and holds whole tensors or model shards (parallel/tp.py)
    "batch_sharding": "a jax.sharding NamedSharding",
    "replicated": "a jax.sharding NamedSharding",
    "put_global": "jax.Array placement across processes",
    "put_tree": "jax.Array placement across processes",
    "put_host_local": "jax.Array placement across processes",
    "host_init_device": "jax's host-side init device",
}
# (JAX module, the port's module) whose top-level names are compared
MODULES = (("ops/fused_elbo.py", "ops.fused_elbo"),
           ("ops/conv1_pallas.py", "ops.conv1"),
           ("ops/losses.py", "ops.losses"),
           ("parallel/mesh.py", "parallel.mesh"),
           ("parallel/tp.py", "parallel.tp"),
           ("parallel/distributed.py", "parallel.distributed"),
           ("midi/tensorize.py", "midi.tensorize"),
           ("models/vae.py", "models.vae"),
           ("utils/debug.py", "utils.debug"))


def _exports(module) -> set:
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("sub", PACKAGES)
def test_port_exports_the_jax_names(sub):
    want = _exports(importlib.import_module("musicvae_tpu" + sub))
    got = _exports(importlib.import_module("musicvae_tpu_torch" + sub))
    assert want - set(EXCLUDED) <= got, sorted(want - set(EXCLUDED) - got)


def _jax_names(jax_file: str) -> set:
    """The public top-level defs, classes and constants of a JAX module,
    read from its source."""
    path = os.path.join(os.path.dirname(jax_pkg.__file__), jax_file)
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    names |= {t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("jax_file,port", MODULES)
def test_port_modules_define_the_jax_names(jax_file, port):
    want = _jax_names(jax_file)
    got = set(vars(importlib.import_module("musicvae_tpu_torch." + port)))
    assert want - set(EXCLUDED) <= got, sorted(want - set(EXCLUDED) - got)


def test_every_exclusion_is_a_jax_name():
    assert set(EXCLUDED) <= set().union(*(_jax_names(f) for f, _ in MODULES))


def _midi_pair(**kw):
    spec = JMidiSpec(**kw)
    return spec, MidiSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(pitch_lo=21, pitch_hi=109)),
    (2, dict(steps_per_quarter=12, ignore_time_signature=True))])
def test_crop_view_and_roll_to_notes_equal_jax(seed, kw):
    """The crop and the note runs of seeded rolls, as bars and as a flat
    roll, f32 (thresholded) and uint8."""
    jspec, spec = _midi_pair(**kw)
    rng = np.random.default_rng(seed)
    bars = (rng.random((3, spec.steps_per_bar, 128)) < 0.2)
    for roll in (bars.astype(np.float32), bars.astype(np.uint8),
                 bars.reshape(-1, 128).astype(np.float32) * 0.9):
        np.testing.assert_array_equal(
            tensorize.crop_view(roll, spec),
            np.asarray(jtensorize.crop_view(roll, jspec)))
        got = tensorize.roll_to_notes(roll, spec)
        want = jtensorize.roll_to_notes(roll, jspec)
        assert [dataclasses.astuple(n) for n in got] == \
            [dataclasses.astuple(n) for n in want]
        assert len(got) > 0
    t = torch.from_numpy(bars.astype(np.uint8))
    assert tensorize.crop_view(t, spec).shape[-1] == \
        spec.pitch_hi - spec.pitch_lo


def test_init_params_draws_from_the_generator():
    """(model, state dict) on the generator's device: the same generator
    seed gives the same weights, another seed others, and the state dict
    is the model's."""
    cfg = train_cfg()
    model, sd = init_params(cfg, torch.Generator().manual_seed(5))
    _, again = init_params(cfg, torch.Generator().manual_seed(5))
    _, other = init_params(cfg, torch.Generator().manual_seed(6))
    assert next(model.parameters()).device.type == "cpu"
    assert set(sd) == set(build_model(cfg, "cpu", seed=0).state_dict())
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not all(torch.equal(sd[k], other[k]) for k in sd)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


def _nan_step(cfg):
    _, state = trainer.create_state(cfg, device="cpu", seed=1)
    x = torch.zeros((cfg.train.batch_size, cfg.model.num_bars, 96, 128))
    x[0, 0, 0, 60] = float("nan")
    return trainer.make_train_step(cfg, state.model), state, {"x": x}


@pytest.mark.parametrize("disable_jit", [False, True])
def test_debug_mode_raises_on_a_nan_loss(disable_jit):
    """Inside ``debug_mode`` a step whose loss is NaN raises
    FloatingPointError before its backward (``disable_jit`` is accepted
    and changes nothing); outside, the step runs and reports it in
    ``nonfinite``."""
    cfg = train_cfg()
    step, state, batch = _nan_step(cfg)
    with debug_mode(disable_jit=disable_jit):
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="non-finite"):
            step(state, batch)
    assert not torch.is_anomaly_enabled()
    assert int(state.step) == 0
    _, m = step(state, batch)
    assert float(m["nonfinite"]) == 1.0
    with debug_mode(nans=False):
        _, m = step(state, batch)
    assert float(m["nonfinite"]) == 1.0
