"""The port's multi-process data parallelism on the CPU: one launch of two
gloo processes (tests/torch_dp_worker.py) runs the ``train`` command in
every data mode, and each equals one process at the global batch (loss
to rtol 1e-5, a parameter checksum to 1e-6, as the JAX package's
tests/test_multiprocess.py holds its own), both processes ending with the
same checkpoint, only process 0 writing the metrics log; ``--host-sharded``
refuses on every process what it cannot do; a corpus that differs on one
process fails on both; a stop asked of one process stops both at the same
step with one checkpoint, and ``train --resume`` on two processes
continues it to the uninterrupted run's bits. The sharded-corpus step of
the two processes is also held against the JAX package's over a 2-device
mesh, on the same weights, ids and noise.

The one-process baselines and the JAX reference are computed here while
the two workers run; every wait on them is bounded.
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
from jax.sharding import NamedSharding, PartitionSpec

import torch_dp_worker as w
from musicvae_tpu import config as jcfg
from musicvae_tpu.data.dataset import PianoRollDataset as JaxDataset
from musicvae_tpu.parallel import make_mesh as jax_make_mesh
from musicvae_tpu.train import sharded_corpus as jsc
from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.train.sharded_corpus import make_sharded_id_schedule
from torch_port_helpers import (InjectedEps, bar_dataset, jax_params,
                                jax_train_state, latent_keys,
                                one_torch_thread,  # noqa: F401
                                port_model)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
WAIT_S = 240
DP_MODES = ("resident", "stream", "host_sharded", "sharded", "mxu")
INDEXED_STEPS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_config(tc):
    """The JAX package's config equal to the port's ``tc`` (the tiny c2 of
    the worker's "indexed" mode) on a 2-device data mesh."""
    jc = jcfg.get_config(tc.name)
    return jc.replace(
        model=jcfg.ModelSpec(**dataclasses.asdict(tc.model)),
        train=jcfg.TrainSpec(**dataclasses.asdict(tc.train)),
        mesh=jcfg.MeshSpec(data=WORLD))


def _one_process(mode: str, ds) -> dict:
    """``mode`` on one process at the global batch: the streamed modes
    feed the global batches the two processes' iterators or shards make
    between them."""
    cfg = w.config(mode)
    b, half = cfg.train.batch_size, cfg.train.batch_size // WORLD
    seed = cfg.train.seed          # the command line's iterators' seed
    data = ds
    if mode == "stream":
        data = ds.iterator(b, seed=seed, x_dtype=np.uint8)
    elif mode in ("host_sharded", "sharded"):
        shards = [ds.host_shard(p, WORLD, seed=cfg.train.seed)
                  for p in range(WORLD)]
        if mode == "host_sharded":
            its = [s.iterator(half, seed=seed, x_dtype=np.uint8)
                   for s in shards]
            parts_at = lambda step: [next(i) for i in its]   # noqa: E731
        else:
            ids = make_sharded_id_schedule(
                cfg.train.seed, np.array([len(s) for s in shards]), b)
            parts_at = lambda step: [                        # noqa: E731
                s.batch(ids(step)[p * half:(p + 1) * half], np.uint8)
                for p, s in enumerate(shards)]

        def merged():
            step = 0
            while True:
                parts = parts_at(step)
                yield {k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]}
                step += 1

        data = merged()
    _, state, metrics = trainer.train(cfg, data, device="cpu")
    return {"step": int(state.step), "loss": float(metrics["loss"]),
            "param_sum": w.param_sum(state)}


def _jax_indexed(tc, jmodel, params, eps, ds):
    """The JAX package's sharded-corpus step, ``INDEXED_STEPS`` of them in
    one ``make_train_step_indexed_multi`` over a 2-device mesh with its
    shard_map gather, the noise handed in: (metrics, params)."""
    jc = _jax_config(tc)
    mesh = jax_make_mesh(jc.mesh)
    jds = JaxDataset(ds.bars, ds.starts, ds.num_bars, ds.chords, ds.keys,
                     ds.piece_ids, grid=ds.grid)
    arrays, counts = jsc.build_sharded_arrays(jds, WORLD, jc.train.seed)
    shardings = jsc.sharded_data_shardings(mesh)
    data = {k: jax.device_put(v, shardings[k]) for k, v in arrays.items()}
    ids = jsc.make_sharded_id_schedule(jc.train.seed, counts,
                                       jc.train.batch_size)
    idxs = jax.device_put(
        np.stack([ids(j) for j in range(INDEXED_STEPS)]),
        NamedSharding(mesh, PartitionSpec(None, "data")))
    state = jax_train_state(jc, params, seed=11)
    model = InjectedEps(jmodel, latent_keys(state.rng, INDEXED_STEPS), eps)
    multi = jtrainer.make_train_step_indexed_multi(
        jc, model, INDEXED_STEPS, gather=jsc.make_sharded_gather(jc, mesh))
    state, metrics = multi(state, data, idxs)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dp"))
    ds = bar_dataset(seed=0)
    ds.save_npy(os.path.join(work, "corpus.npz"))
    # the indexed mode's weights and noise, the JAX package's too
    tc = w.config("indexed")
    jc = _jax_config(tc)
    jmodel, params = jax_params(jc, tc, seed=7)
    state = trainer.init_state(tc, port_model(tc, params))
    eps = np.random.default_rng(5).standard_normal(
        (INDEXED_STEPS, tc.train.batch_size, tc.model.z_dim)).astype(
        np.float32)
    torch.save({"state": state.state_dict(), "eps": torch.tensor(eps)},
               os.path.join(work, "indexed_in.pt"))

    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MVAE_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK"))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_worker.py"),
         coordinator, str(WORLD), str(p), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=os.path.dirname(HERE)) for p in range(WORLD)]
    try:
        baselines = {m: _one_process(m, ds) for m in DP_MODES}
        jax_ref = _jax_indexed(tc, jmodel, params, eps, ds)
        results = []
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, err.decode(errors="replace")[-3000:]
            lines = [ln for ln in out.decode().splitlines()
                     if ln.startswith("{")]
            assert lines, out.decode()[-2000:]
            results.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    indexed_out = [torch.load(os.path.join(work, f"indexed_out_{p}.pt"),
                              weights_only=True) for p in range(WORLD)]
    return {"procs": [r["modes"] for r in results], "one": baselines,
            "jax": jax_ref, "indexed_out": indexed_out, "tc": tc}


_RESULT = ("rc", "step", "loss", "grad_norm", "param_sum")


@pytest.mark.parametrize("mode", DP_MODES)
def test_two_processes_equal_one_at_the_global_batch(launch, mode):
    two, one = [r[mode] for r in launch["procs"]], launch["one"][mode]
    assert two[0]["rc"] == 0, two[0]["err"]
    assert two[0]["step"] == two[1]["step"] == one["step"] == 6
    # both processes read the same checkpoint and printed the same
    # metrics, bit for bit; process 0 alone logged them
    assert [{k: r[k] for k in _RESULT} for r in two] == \
        [{k: two[0][k] for k in _RESULT}] * WORLD
    assert [r["logged"] for r in two] == [True, False]
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["param_sum"], one["param_sum"],
                               rtol=1e-6)


def test_host_sharding_refuses_on_every_process(launch):
    """An eval cadence, and a batch of 5 over 2 processes: exit 2 on both
    processes with the JAX package's messages, before any collective."""
    res = [r["refusals"] for r in launch["procs"]]
    for r in res:
        assert r["eval"]["rc"] == r["batch"]["rc"] == 2, r
        assert "Set --eval-every 0" in r["eval"]["err"]
        assert "batch_size 5 not divisible by 2 processes" in \
            r["batch"]["err"]


def test_resume_on_two_processes_continues_to_the_same_bits(launch):
    """``train --resume`` on both processes from the checkpoint the
    one-sided stop left at step 2 reaches step 6 with the bits of the
    uninterrupted resident run."""
    for r in launch["procs"]:
        res, whole = r["resume"], r["resident"]
        assert res["rc"] == 0, res["err"]
        assert "resumed from step 2" in res["err"]
        assert {k: res[k] for k in _RESULT} == {k: whole[k] for k in _RESULT}


def test_a_diverged_corpus_fails_on_every_process(launch):
    assert [r["desync"] for r in launch["procs"]] == \
        [{"desync_caught": True}] * WORLD


def test_a_stop_asked_of_one_process_stops_both(launch):
    """Only process 1's flag is set; k = gcd(log_every 2, ckpt_every 6) =
    2, so both stop after the first dispatch and step 2 is saved once."""
    res = [r["preempt"] for r in launch["procs"]]
    assert res[0]["step"] == res[1]["step"] == 2, res
    assert res[0]["saved_steps"] == res[1]["saved_steps"] == [2], res
    assert res[0]["loss"] == res[1]["loss"]


def test_sharded_corpus_step_matches_jax_on_two_devices(launch):
    """Three sharded-corpus steps, the port on two processes against the
    JAX package's shard_map gather on a 2-device mesh: the same weights,
    window ids and noise. Metrics to rtol 1e-4 and the parameters to
    2e-5 absolute (test_torch_train_step.py's measures: f32 sums in other
    orders, which Adam's first steps carry into the weights)."""
    want_m, want_p = launch["jax"]
    got = [r["indexed"] for r in launch["procs"]]
    assert got[0] == got[1]
    for k in ("loss", "recon", "kl", "beta", "grad_norm"):
        np.testing.assert_allclose(got[0][k], want_m[k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    want = flax_params_to_state_dict(want_p, launch["tc"])
    out0, out1 = launch["indexed_out"]
    assert set(out0) == set(want)
    for n, p in out0.items():
        assert torch.equal(p, out1[n]), n
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=0,
                                   atol=2e-5, err_msg=n)
