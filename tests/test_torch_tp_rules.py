"""The port's tensor-parallel rule table against the JAX package's
``param_shardings``, leaf by leaf, and the model axis of the port's
``make_mesh`` layout (no process group: the rules and the layout are
host-side).

Parity: for each registered config at full width, the JAX package's
params come from ``jax.eval_shape`` of its ``init_params`` (traced, not
run), and its shardings from its own ``param_shardings`` on a
(data=2, model=M) mesh of the conftest's 8 fake devices. Each leaf is
filled with the model shard that holds each element (1..M, or -1 where
replicated) and carried into the port's layout by the port's converter,
which only transposes and concatenates; the port's ``param_shardings``
on its own model must give every element the same shard. Elements the
converter fills itself (the GRU's r/z hidden biases, which flax lacks)
are skipped.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from musicvae_tpu import config as jcfg
from musicvae_tpu.models import init_params as jax_init
from musicvae_tpu.parallel import make_mesh as jax_make_mesh
from musicvae_tpu.parallel import param_shardings as jax_param_shardings
from musicvae_tpu.parallel.mesh import MODEL_AXIS
from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.models.vae import PianoRollVAE
from musicvae_tpu_torch.parallel import tp
from musicvae_tpu_torch.parallel.mesh import DataMesh
from torch_port_helpers import one_torch_thread  # noqa: F401

CONFIGS = ("c2_gru_4bar", "c3_hier_16bar", "c4_cond", "c2_trf", "c2_mxu")
CPU = torch.device("cpu")


def _shapes(name: str):
    return jax.eval_shape(lambda k: jax_init(jcfg.get_config(name), k)[1],
                          jax.random.key(0))


def _meta_model(name: str):
    cfg = tcfg.get_config(name)
    with torch.device("meta"):
        return PianoRollVAE(cfg.model, cfg.midi)


def _jax_marks(name: str, m: int, rules=None) -> dict:
    """The port's state dict of shard marks under the JAX package's
    shardings on a (data=2, model=m) mesh."""
    mesh = jax_make_mesh(jcfg.MeshSpec(data=2, model=m))
    shapes = _shapes(name)
    kw = {} if rules is None else {"rules": rules}
    shardings = jax_param_shardings(shapes, mesh, **kw)

    def mark(leaf, sharding):
        out = np.full(leaf.shape, -1, np.int8)
        for d, axis in enumerate(sharding.spec):
            if axis == MODEL_AXIS:
                shard = np.arange(leaf.shape[d]) // (leaf.shape[d] // m) + 1
                out[...] = shard.reshape([-1 if i == d else 1
                                          for i in range(leaf.ndim)])
        return out

    marks = jax.tree.map(mark, shapes, shardings)
    return flax_params_to_state_dict(marks, tcfg.get_config(name))


def _port_marks(model, layouts: dict, m: int) -> dict:
    """The same marks from the port's layouts."""
    out = {}
    for n, p in model.named_parameters():
        lay = layouts[n]
        t = torch.full(p.shape, -1, dtype=torch.int8)
        if lay is not None:
            size = p.shape[lay.dim]
            within = torch.arange(size) % (size // lay.gates)
            shard = within // (size // lay.gates // m) + 1
            t[...] = shard.to(torch.int8).reshape(
                [-1 if i == lay.dim else 1 for i in range(p.dim())])
        out[n] = t
    return out


@pytest.mark.parametrize("m", [4, 3])
@pytest.mark.parametrize("name", CONFIGS)
def test_rules_shard_what_the_jax_package_shards(name, m):
    """Every element lands on the shard the JAX package puts it on, at a
    model axis of 4 (the JAX tests' mesh) and of 3 (which many widths do
    not divide: the divisibility fallback, leaf by leaf)."""
    model = _meta_model(name)
    layouts = tp.param_shardings(model, DataMesh(2, 0, CPU, model=m))
    want = _jax_marks(name, m)
    got = _port_marks(model, layouts, m)
    assert set(got) == set(want)
    for n in got:
        w = want[n].to(torch.int8)
        keep = w != 0          # 0: filled by the converter, not from JAX
        assert torch.equal(got[n][keep], w[keep]), n
    if m == 4:
        assert any(layouts.values())
        # the 1-channel parity head cannot shard; the patch head can
        assert layouts.get("head.deconvs.4.weight") is None
        if name == "c2_mxu":
            assert layouts["head.out.weight"] == tp.Layout(0)


def test_gru_rules_shard_every_gate():
    """The fused [r; z; n] GRU tensors shard per gate: rank r holds rows
    g·H + [r·H/M, (r+1)·H/M) of each gate g, as flax's separate gate
    kernels shard."""
    model = _meta_model("c2_gru_4bar")
    layouts = tp.param_shardings(model, DataMesh(1, 0, CPU, model=2))
    for n in ("enc_gru", "dec_gru"):
        for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            assert layouts[f"{n}.{p}"] == tp.Layout(0, 3)
    t = torch.arange(12.0)          # H = 4: [r0..r3, z0..z3, n0..n3]
    lay = tp.Layout(0, 3)
    parts = [lay.local(t, r, 2) for r in range(2)]
    assert parts[1].tolist() == [2, 3, 6, 7, 10, 11]
    assert torch.equal(lay.join(parts), t)


def test_rule_rank_mismatch_falls_back_replicated():
    """A rule whose dim lies past a matching parameter's rank leaves it
    replicated, as the JAX package's rank check does
    (tests/test_parallel.py:390)."""
    model = _meta_model("c2_gru_4bar")
    rules = [(r"\.bias(_ih|_hh)?$", 1, 1)]
    layouts = tp.param_shardings(model, DataMesh(2, 0, CPU, model=4), rules)
    assert not any(layouts.values())
    want = _jax_marks("c2_gru_4bar", 4, [(r".*/bias$", P(None, MODEL_AXIS))])
    assert all(bool((t[t != 0] == -1).all()) for t in want.values())


def test_shard_params_refuses_what_a_layer_cannot_shard():
    """A rule that shards a parameter whose layer does not compute column-
    parallel (a LayerNorm), or a conv weight on its input dim, is a
    ValueError: never a silent replication or a wrong result."""
    from musicvae_tpu_torch.train import trainer

    cfg = tcfg.get_config("c2_trf")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, enc_channels=(8, 8, 16), dec_channels=(16, 8, 8),
        z_dim=8, gru_hidden=16, bar_feat_dim=16, dtype="float32"))
    mesh = DataMesh(1, 0, CPU, model=2)
    for rules in ([(r"ln1\.0\.weight$", 0, 1)],
                  [(r"^enc_feat\.convs\.1\.weight$", 1, 1),
                   (r"^enc_feat\.convs\.1\.bias$", 0, 1)],
                  [(r"^z_head\.weight$", 0, 1)]):
        _, state = trainer.create_state(cfg, device="cpu")
        with pytest.raises(ValueError, match="column-parallel"):
            tp.shard_params(state, mesh, rules)
        assert state.tp is None
    # no model axis: nothing to shard
    _, state = trainer.create_state(cfg, device="cpu")
    assert tp.shard_params(state, DataMesh(2, 0, CPU)).tp is None


def test_processes_take_rows_by_their_data_index():
    """With a model axis, process p has data index p // M and model index
    p % M (the JAX device grid's reshape(data, model)), and takes its data
    index's rows of the global batch."""
    for p in range(6):
        mesh = DataMesh(3, p, CPU, model=2)
        assert (mesh.processes, mesh.data_rank, mesh.model_rank) == (
            6, p // 2, p % 2)
        n = 4
        assert mesh.rows(12) == slice(p // 2 * n, (p // 2 + 1) * n)
