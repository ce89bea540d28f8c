"""The port's tensor parallelism on the CPU: one launch of four gloo
processes (tests/torch_tp_worker.py) laid out as data=2 x model=2, each
mode held against one port process at the same global batch, and the
Adam case also against the JAX package's ``make_train_step`` on the same
weights, batches and noise (tests/test_parallel.py's TP checks are the
JAX package's own: rtol 1e-4 / atol 1e-4 with Adam, 5e-3 / 3e-4 for the
attention config with SGD). A control without the column-parallel
backward's dx all-reduce must fail the Adam tolerance.

The one-process baselines and the JAX reference are computed here while
the four workers run; every wait on them is bounded.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_tp_worker as w
from musicvae_tpu import config as jcfg
from musicvae_tpu.models import build_model as jax_build_model
from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import (InjectedEps, bar_dataset, jax_params,
                                jax_train_state, latent_keys,
                                one_torch_thread,  # noqa: F401
                                port_model)

HERE = os.path.dirname(os.path.abspath(__file__))
WAIT_S = 240
ADAM_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_parallel.py:77
ATTN_TOL = dict(rtol=5e-3, atol=3e-4)      # tests/test_parallel.py:315


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_config(tc):
    jc = jcfg.get_config(tc.name)
    return jc.replace(model=jcfg.ModelSpec(**dataclasses.asdict(tc.model)),
                      train=jcfg.TrainSpec(**dataclasses.asdict(tc.train)))


def _inputs(mode: str, seed: int) -> dict:
    """A mode's start state, batches and noise: the weights are the
    port's init carried through the JAX package's oracle importer (the
    conv stem; the attention config keeps the port's init)."""
    tc = w.config(mode)
    rng = np.random.default_rng(seed)
    b, n = tc.train.batch_size, tc.model.num_bars
    x = (rng.random((w.STEPS, b, n, 96, 128)) < 0.05).astype(np.float32)
    eps = rng.standard_normal((w.STEPS, b, tc.model.z_dim)).astype(
        np.float32)
    if mode == "attn":
        _, state = trainer.create_state(tc, device="cpu", seed=seed)
        params = None
    else:
        _, params = jax_params(_jax_config(tc), tc, seed=seed)
        state = trainer.init_state(tc, port_model(tc, params))
    return {"state": state.state_dict(), "x": torch.tensor(x),
            "eps": torch.tensor(eps), "params": params}


def _one_process(mode: str, given: dict) -> dict:
    """The mode on one process at the global batch: its metrics and
    parameters. conv1's baseline runs the stock first conv, as the JAX
    package's test holds its kernel run against the replicated XLA
    conv."""
    tc = w.config(mode)
    if mode == "conv1":
        tc = tc.replace(model=dataclasses.replace(tc.model,
                                                  use_pallas_conv1=False))
    _, state = trainer.create_state(tc, device="cpu")
    state.load_state_dict(given["state"])
    out = {}
    if mode == "attn":
        out["loss"] = w.sgd_steps(tc, state, list(given["x"]),
                                  given["eps"])
    else:
        step = trainer.make_train_step(tc, state.model)
        for j in range(w.STEPS):
            _, m = step(state, {"x": given["x"][j]}, eps=given["eps"][j])
        out.update({k: float(v) for k, v in m.items()})
    out["params"] = w.named_tensors(state.state_dict())
    return out


def _jax_adam(given: dict) -> tuple:
    """The JAX package's ``make_train_step`` (one device: its TP run
    equals its replicated one, tests/test_parallel.py:77), three steps on
    the same weights and batches with the noise handed in: (last
    metrics, params in the port's layout)."""
    tc = w.config("adam")
    jc = _jax_config(tc)
    state = jax_train_state(jc, given["params"], seed=11)
    model = InjectedEps(jax_build_model(jc), latent_keys(state.rng, w.STEPS),
                        given["eps"].numpy())
    step = jtrainer.make_train_step(jc, model, use_pallas=False)
    for j in range(w.STEPS):
        state, metrics = step(state, {"x": jax.numpy.asarray(
            given["x"][j].numpy())})
    return ({k: float(v) for k, v in metrics.items()},
            flax_params_to_state_dict(jax.tree.map(np.asarray,
                                                   state.params), tc))


def _global_batches(mode: str):
    """What one process trains on in place of the four processes' data:
    the corpus; for host_sharded the global batches that the two data
    indices' shards stream between them (``train --host-sharded``'s
    iterators)."""
    ds = bar_dataset(seed=0)
    if mode != "host_sharded":
        return ds
    cfg, data = w.config(mode), 2
    seed, half = cfg.train.seed, cfg.train.batch_size // data
    its = [ds.host_shard(d, data, seed=seed).iterator(half, seed=seed,
                                                      x_dtype=np.uint8)
           for d in range(data)]
    return ({k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            for parts in zip(*its))


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp"))
    bar_dataset(seed=0).save_npy(os.path.join(work, "corpus.npz"))
    inputs = {m: _inputs(m, seed) for m, seed in
              (("adam", 7), ("attn", 8), ("conv1", 9))}
    torch.save({m: {k: v for k, v in i.items() if k != "params"}
                for m, i in inputs.items()},
               os.path.join(work, "inputs.pt"))
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MVAE_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK"))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_tp_worker.py"),
         coordinator, str(w.WORLD), str(p), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=os.path.dirname(HERE)) for p in range(w.WORLD)]
    try:
        one = {m: _one_process(m, inputs[m])
               for m in ("adam", "attn", "conv1")}
        for mode in ("train", "host_sharded"):
            _, state, m = trainer.train(w.config(mode), _global_batches(mode),
                                        device="cpu")
            one[mode] = {"loss": float(m["loss"]), "step": int(state.step),
                         "param_sum": float(sum(
                             np.abs(p.detach().numpy().astype(
                                 np.float64)).sum() for p in state.params))}
        jax_ref = _jax_adam(inputs["adam"])
        results = []
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, err.decode(errors="replace")[-3000:]
            lines = [ln for ln in out.decode().splitlines()
                     if ln.startswith("{")]
            assert lines, out.decode()[-2000:]
            results.append(json.loads(lines[-1])["modes"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    params = {m: [torch.load(os.path.join(work, f"{m}_{p}.pt"),
                             weights_only=True) for p in range(w.WORLD)]
              for m in ("adam", "control", "attn", "conv1")}
    return {"procs": results, "one": one, "jax": jax_ref,
            "params": params, "work": work}


def _close(got: dict, want: dict, tol: dict) -> bool:
    return set(got) == set(want) and all(
        np.allclose(got[n].numpy(), want[n].numpy(), **tol) for n in got)


def test_the_processes_lay_out_as_the_jax_grid(launch):
    """Process p has data index p // 2 and model index p % 2."""
    assert [r["mesh"] for r in launch["procs"]] == [
        [2, 2, p // 2, p % 2] for p in range(w.WORLD)]


@pytest.mark.parametrize("mode,tol", [("adam", ADAM_TOL),
                                      ("attn", ATTN_TOL),
                                      ("conv1", ADAM_TOL)])
def test_tensor_parallel_equals_one_process(launch, mode, tol):
    """Every process gathers the same unsharded parameters (and conv1's
    EMA copies), within the JAX package's TP tolerance of one process at
    the global batch, with the last loss to 1e-4 relative; each held
    about half the parameter bytes. conv1's first conv ran on 8 of 16
    channels a rank."""
    procs = [r[mode] for r in launch["procs"]]
    params = launch["params"][mode]
    for p in params[1:]:
        assert all(torch.equal(p[n], params[0][n]) for n in p)
    one = launch["one"][mode]
    np.testing.assert_allclose(procs[0]["loss"], one["loss"], rtol=1e-4)
    for n, t in params[0].items():
        np.testing.assert_allclose(t.numpy(), one["params"][n].numpy(),
                                   err_msg=n, **tol)
    full = sum(t.numel() * 4 for n, t in one["params"].items()
               if not n.startswith("ema."))
    assert all(r["bytes"]["params"] < 0.55 * full for r in procs)
    if mode == "conv1":
        assert [r["first_conv_channels"] for r in procs] == [8] * w.WORLD


def test_adam_equals_the_jax_package(launch):
    """The Adam case (clip 1.0: the clip's norm is the unsharded tree's)
    against the JAX package's make_train_step: metrics to rtol 1e-4, the
    parameters to rtol 1e-4 / atol 1e-4."""
    want_m, want_p = launch["jax"]
    got = launch["procs"][0]["adam"]
    for k in ("loss", "recon", "kl", "beta", "grad_norm"):
        np.testing.assert_allclose(got[k], want_m[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    params = launch["params"]["adam"][0]
    assert set(params) == set(want_p)
    for n, t in params.items():
        np.testing.assert_allclose(t.numpy(), want_p[n].numpy(), err_msg=n,
                                   **ADAM_TOL)


def test_the_control_without_the_dx_all_reduce_fails(launch):
    """Dropping the input gradient's all-reduce of the column-parallel
    backward must fail the Adam tolerance the sound run holds."""
    params = launch["params"]["control"][0]
    assert not _close(params, launch["one"]["adam"]["params"], ADAM_TOL)


def test_a_tp_checkpoint_restores_on_one_process(launch):
    """The Adam case's state, saved by the four processes, is the
    unsharded file: one process restores it to the tensors they gathered,
    and a fresh sharded state restores it to the same shards."""
    manager = ckpt_io.make_manager(os.path.join(launch["work"], "ck_adam"))
    _, state = trainer.create_state(w.config("adam"), device="cpu")
    state, _ = ckpt_io.restore(manager, state)
    assert int(state.step) == w.STEPS
    gathered = launch["params"]["adam"][0]
    assert all(torch.equal(t, gathered[n])
               for n, t in w.named_tensors(state.state_dict()).items())
    assert all(r["adam"]["restored_equal"] for r in launch["procs"])


def test_train_with_a_model_axis_replicates(launch):
    """``train()`` under ``MeshSpec(data=1, model=2)`` on four processes
    (data=2 x model=2, replicated, as the JAX package's train() runs such
    a mesh) equals one process at the global batch: loss to 1e-5 and the
    parameter checksum to 1e-6 relative, the same bits on every
    process."""
    _assert_train_equals_one_process(launch, "train")


def test_host_sharded_train_with_a_model_axis_shards_by_data_index(launch):
    """``train --host-sharded``'s stream under ``MeshSpec(data=1,
    model=2)`` on four processes: each process streams its data index's
    shard (of two), so the two processes of a model group train on the
    same rows, and the run equals one process fed the global batches the
    two shards make between them, as ``train`` above."""
    _assert_train_equals_one_process(launch, "host_sharded")


def _assert_train_equals_one_process(launch, mode: str) -> None:
    got = [r[mode] for r in launch["procs"]]
    assert all(g == got[0] for g in got)
    one = launch["one"][mode]
    assert got[0]["step"] == one["step"] == 6
    np.testing.assert_allclose(got[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["param_sum"], one["param_sum"],
                               rtol=1e-6)
