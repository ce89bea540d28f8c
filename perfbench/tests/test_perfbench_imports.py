"""No run may load the JAX stack or the JAX package, and the reference
loads nothing of the program. Each check runs in a fresh interpreter and
compares whole top-level module names (the program's name begins with the
JAX package's)."""

import json
import subprocess
import sys

import pytest

from perfbench import harness

FORBIDDEN = list(harness.FORBIDDEN)


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": harness.ROOT, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("runner", ["train", "serve"])
def test_a_cells_imports_load_no_jax(runner):
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import perfbench.run, perfbench.harness\n"
            f"import perfbench.runners.{runner}\n"
            "import musicvae_tpu_torch.cli, musicvae_tpu_torch.train.trainer\n"
            "import musicvae_tpu_torch.generate.sampler\n"
            "import perfbench.served, perfbench.controls, perfbench.sweep\n")
    loaded = _loaded_after(code)
    assert "musicvae_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import perfbench.reference.model, perfbench.reference.train\n"
        "import perfbench.reference.midi\n")
    assert not loaded & set(FORBIDDEN + ["musicvae_tpu_torch"])


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "musicvae_tpu_torch_x", sys)
    assert "musicvae_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "musicvae_tpu.config", sys)
    assert "musicvae_tpu" in harness.forbidden_loaded()
