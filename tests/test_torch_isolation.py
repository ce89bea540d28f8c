"""The port stands alone: no module of musicvae_tpu_torch imports jax or
the JAX package, and its CUDA entry points refuse to run without a GPU
instead of quietly running on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from musicvae_tpu_torch.cli import main
from musicvae_tpu_torch.config import get_config
from musicvae_tpu_torch.models.vae import build_model

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import musicvae_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "musicvae_tpu"))
print(" ".join(names), "|", ",".join(bad))
"""

_NEW_MODULES = ("train.trainer", "data.dataset", "utils.logging",
                "ops.augment", "ops.fused_elbo", "ops.conv1",
                "checkpoints.io", "train.preemption", "native",
                "midi.labels", "data.synthetic", "ops.pack",
                "utils.genmetrics", "client", "checkpoints.safetensors_io",
                "parallel.distributed", "parallel.mesh",
                "train.sharded_corpus", "parallel.tp", "utils.debug")

# every module of the port imported with the compiler and the loader
# disabled (after torch, which loads its own libraries): an import that
# built or loaded a native library would raise
_IMPORT_BUILDS_NOTHING = """
import ctypes, importlib, pkgutil, subprocess
import numpy, torch
def refuse(*a, **k):
    raise AssertionError(f"called at import: {a[:1]}")
subprocess.run = subprocess.Popen = ctypes.CDLL = refuse
import musicvae_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from musicvae_tpu_torch import native
from musicvae_tpu_torch.ops import _kernels
print(native._lib is None and not native._build_failed
      and _kernels._lib is None)
"""

_IMPORT_SMOKE = """
import sys
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "musicvae_tpu"))
print(",".join(bad))
"""


def test_no_module_imports_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, _, bad = out.stdout.strip().partition(" | ")
    names = names.split()
    assert len(names) >= 22, out.stdout
    for mod in _NEW_MODULES:        # imported with no nvcc and no GPU here
        assert f"musicvae_tpu_torch.{mod}" in names, mod
    assert bad.strip() == "", f"imports {bad}"


def test_importing_builds_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_BUILDS_NOTHING],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_no_source_file_mentions_jax_imports():
    for path in [*(REPO / "musicvae_tpu_torch").rglob("*.py"),
                 REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "flax", "musicvae_tpu"), \
                    f"{path}: {s}"


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    cfg = get_config("c2_gru_4bar")
    with pytest.raises(RuntimeError, match="is_available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["serve", "--bars", "1", "--samples", "1"])


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_chip_smoke_imports_without_jax_nvcc_or_gpu():
    out = _run(["-c", _IMPORT_SMOKE], cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imports {out.stdout}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke run would start")
    out = _run(["chip_smoke.py"], cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available" in out.stderr


def test_train_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    from musicvae_tpu_torch.train.trainer import create_state
    with pytest.raises(RuntimeError, match="is_available"):
        create_state(get_config("c2_gru_4bar"))
