"""The data-parallel step that the port captures as one CUDA graph under
an NCCL group (train/trainer.py ``make_train_step_indexed_multi`` with a
process group), on the CPU: one launch of two gloo processes
(tests/torch_dp_capture_worker.py), where the same body runs eagerly over
the static inputs a graph reads on the cards:

- the body reads nothing back to the host and makes no tensor from host
  data, which capture requires (``torch_port_helpers.no_host_reads``);
- it equals the eager data-parallel step (``make_train_step_indexed``
  under the group) bit for bit over three steps, the generator's state
  included, and both processes hold the same bits;
- it equals one process at the global batch within ``DP_RTOL``;
- the tracer's ``dist.allreduce_bytes`` over the steps equals the
  benchmark's own count of the step's bucket (perfbench/yardstick_dp.py)
  for full-width c4_cond, and an eager step's all-reduce is a
  ``dist.allreduce`` span.

And in this process: which dispatches may be captured (``_graphable``),
that ``train()`` lets its dispatch's programs go when it returns, and the
tracer's counting of a capture at each replay.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dp_capture_worker as w
from musicvae_tpu_torch.parallel.mesh import DataMesh
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.utils import trace
from torch_port_helpers import (  # noqa: F401
    bar_dataset, bench_spec, one_torch_thread)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import yardstick_dp  # noqa: E402

WORLD = 2
WAIT_S = 240
# two processes against one at the global batch, (loss, parameter
# checksum) relative: the order of the gradient sums alone differs, as
# tests/test_torch_dp_train.py holds its own
DP_RTOL = (1e-5, 1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dp_capture"))
    ds = bar_dataset(seed=4, pieces=4, bars_per_piece=8, num_bars=4)
    ds.save_npy(os.path.join(work, "corpus.npz"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MVAE_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK"))}
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_capture_worker.py"),
         coordinator, str(WORLD), str(p), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=REPO) for p in range(WORLD)]
    try:
        cfg = w.config()
        model, state = trainer.create_state(cfg, device="cpu")
        multi = trainer.make_train_step_indexed_multi(cfg, model)
        _, metrics = multi(state, w.resident(ds, cfg),
                           w.idxs(cfg, ds, w.STEPS))
        one = {"loss": float(metrics["loss"]), "param_sum": w.param_sum(state)}
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
    return {"procs": results, "one": one}


def test_the_captured_body_reads_nothing_back(launch):
    # the worker ran the dispatch under no_host_reads: it got this far
    for r in launch["procs"]:
        assert np.isfinite(r["loss"]) and not r["graphable"]


def test_the_dispatch_equals_the_eager_step_bit_for_bit(launch):
    procs = launch["procs"]
    assert all(r["same_bits"] for r in procs)
    assert procs[0]["losses"] == procs[1]["losses"]
    assert procs[0]["param_sum"] == procs[1]["param_sum"]


def test_two_processes_equal_one_at_the_global_batch(launch):
    one = launch["one"]
    for r in launch["procs"]:
        assert abs(r["loss"] - one["loss"]) <= DP_RTOL[0] * abs(one["loss"])
        assert abs(r["param_sum"] - one["param_sum"]) <= \
            DP_RTOL[1] * one["param_sum"]


def test_allreduce_bytes_are_the_yardsticks_bucket(launch):
    full = yardstick_dp.bucket_bytes(bench_spec(w.config(full=True)))
    tiny = yardstick_dp.bucket_bytes(bench_spec(w.config()))
    for r in launch["procs"]:
        assert r["full_steps"] == w.FULL_STEPS
        assert r["full_counters"]["dist.allreduce_bytes"] == \
            w.FULL_STEPS * full
        assert r["multi_counters"]["dist.allreduce_bytes"] == w.STEPS * tiny
        assert r["multi_spans"] == w.STEPS
    # every trainable parameter's f32 gradient and three metrics
    _, state = trainer.create_state(w.config(full=True), device="cpu")
    assert full == 4 * (sum(p.numel() for p in state.params) + 3)


class _State:
    tp = None


@pytest.mark.parametrize("group, backend, model, sharded, graphable", [
    (False, None, 1, False, True),
    (True, "nccl", 1, False, True),
    (True, "gloo", 1, False, False),
    (True, "nccl", 2, False, False),
    (True, "nccl", 1, True, False)])
def test_which_dispatches_are_captured(monkeypatch, group, backend, model,
                                       sharded, graphable):
    """No group, or NCCL without a model axis or a sharded state: the
    graph. gloo, a model axis (tensor parallelism's collectives) or a
    sharded state: eager."""
    monkeypatch.setattr(trainer.dist, "get_backend", lambda *a: backend)
    mesh = DataMesh(2 // model, 0, torch.device("cpu"), group, model)
    state = _State()
    if sharded:
        state.tp = object()
    assert trainer._graphable(mesh, state) is graphable
    assert trainer._graphable(None, state)


def test_the_dispatchs_program_goes_with_train(monkeypatch):
    """No collection of cycles needed: an NCCL communicator cannot be
    destroyed while a graph holding its kernels lives, so train() lets
    its dispatch's programs go when it returns."""
    import gc
    import weakref

    from musicvae_tpu_torch.utils import graphs
    made = []
    init = graphs.Program.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        made.append(weakref.ref(self))

    monkeypatch.setattr(graphs.Program, "__init__", recorded)
    ds = bar_dataset(seed=4, pieces=4, bars_per_piece=8, num_bars=4)
    gc.disable()
    try:
        trainer.train(w.config(), ds, num_steps=3, device="cpu")
        assert made and all(r() is None for r in made)
    finally:
        gc.enable()


def test_a_capture_counts_at_each_replay():
    trace.reset()
    with trace.capture_counts() as record:
        assert trace.capturing()
        trace.count("dist.allreduce_bytes", 12)
    assert not trace.capturing()
    assert record == {"dist.allreduce_bytes": 12}
    assert "dist.allreduce_bytes" not in trace.counters()
    for _ in range(3):
        trace.add_counts(record)
    assert trace.counters()["dist.allreduce_bytes"] == 36
    trace.reset()
