"""The numpy half of the port's data parallelism against the JAX package,
bit for bit on the same dataset: ``host_shard`` for 1, 2 and 3 processes
and its errors, ``HostLocalBatches``, ``build_sharded_arrays`` and
``make_sharded_id_schedule`` (with its error for a batch the shards do not
divide); and the launch side on its own: ``initialize_from_env``'s
parsing (``init_process_group`` stubbed, mirroring the JAX package's
tests/test_parallel.py), ``make_mesh``'s clamp, the rows a process takes
and the refusal of tensor parallelism.
"""

import dataclasses

import numpy as np
import pytest
import torch

from musicvae_tpu.config import C2_GRU_4BAR
from musicvae_tpu.data import dataset as jdataset
from musicvae_tpu.data import synth_corpus
from musicvae_tpu.train import sharded_corpus as jsc
from musicvae_tpu_torch.config import MeshSpec, get_config
from musicvae_tpu_torch.data import dataset as tdataset
from musicvae_tpu_torch.parallel import distributed, mesh as tmesh
from musicvae_tpu_torch.train import sharded_corpus as tsc

FIELDS = ("bars", "starts", "chords", "keys", "piece_ids")
MVAE = ("MVAE_COORDINATOR", "MVAE_NUM_PROCS", "MVAE_PROC_ID",
        "MVAE_AUTO_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
        "RANK", "LOCAL_RANK")


@pytest.fixture(scope="module")
def pair():
    """(JAX dataset, the port's) over the same 9 synthetic pieces."""
    j = jdataset.PianoRollDataset.from_corpus(
        synth_corpus(num_pieces=9, n_bars=8, seed=2), C2_GRU_4BAR.midi,
        C2_GRU_4BAR.model.num_bars)
    t = tdataset.PianoRollDataset(j.bars, j.starts, j.num_bars, j.chords,
                                  j.keys, j.piece_ids, grid=j.grid)
    return j, t


def _same(a, b):
    assert len(a) == len(b) and a.num_bars == b.num_bars
    assert a.grid == b.grid
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("pc", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 7])
def test_host_shard_equals_jax(pair, pc, seed):
    j, t = pair
    shards = [t.host_shard(p, pc, seed=seed) for p in range(pc)]
    for p, s in enumerate(shards):
        _same(s, j.host_shard(p, pc, seed=seed))
    # disjoint pieces covering every window
    assert sum(len(s) for s in shards) == len(t)
    assert len(set().union(*(set(s.piece_ids) for s in shards))) == 9


@pytest.mark.parametrize("args,match", [
    ((2, 2), "not in"), ((-1, 2), "not in"), ((0, 10), "cannot shard")])
def test_host_shard_errors_equal_jax(pair, args, match):
    j, t = pair
    with pytest.raises(ValueError, match=match) as port:
        t.host_shard(*args)
    with pytest.raises(ValueError) as ref:
        j.host_shard(*args)
    assert str(port.value) == str(ref.value)


def test_host_local_batches_iterate_as_jax(pair):
    j, t = pair
    a = tdataset.HostLocalBatches(t.host_shard(1, 2, seed=3).iterator(
        2, seed=4, x_dtype=np.uint8))
    b = jdataset.HostLocalBatches(j.host_shard(1, 2, seed=3).iterator(
        2, seed=4, x_dtype=np.uint8))
    assert iter(a) is iter(a)
    for _ in range(7):                     # past an epoch of the shard
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_build_sharded_arrays_equals_jax(pair, n_shards):
    j, t = pair
    got, got_counts = tsc.build_sharded_arrays(t, n_shards, seed=5)
    want, want_counts = jsc.build_sharded_arrays(j, n_shards, seed=5)
    np.testing.assert_array_equal(got_counts, want_counts)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a process's block is its shard, padded
    for d in range(n_shards):
        block = tsc.local_block(got, n_shards, d)
        shard = t.host_shard(d, n_shards, seed=5)
        np.testing.assert_array_equal(block["bars"][:shard.bars.shape[0]],
                                      shard.bars)
        np.testing.assert_array_equal(block["starts"][:len(shard)],
                                      shard.starts)


@pytest.mark.parametrize("counts,b", [([9, 4], 8), ([3, 30, 2], 6),
                                      ([50], 16)])
def test_sharded_id_schedule_equals_jax(counts, b):
    counts = np.array(counts, np.int64)
    got = tsc.make_sharded_id_schedule(11, counts, b)
    want = jsc.make_sharded_id_schedule(11, counts, b)
    for step in (0, 1, 2, 7, 30, 3, 0):            # out of order too
        g, w = got(step), want(step)
        assert g.dtype == w.dtype and g.shape == (b,)
        np.testing.assert_array_equal(g, w)


def test_sharded_id_schedule_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible by 3") as port:
        tsc.make_sharded_id_schedule(0, np.array([5, 5, 5]), 8)
    with pytest.raises(ValueError) as ref:
        jsc.make_sharded_id_schedule(0, np.array([5, 5, 5]), 8)
    assert str(port.value) == str(ref.value)


# -- the launch ----------------------------------------------------------------------

@pytest.fixture
def no_launch(monkeypatch):
    """No launch variables, no group, and ``init_process_group`` stubbed:
    the calls it would have made are recorded, and the group then counts
    as joined."""
    for var in MVAE:
        monkeypatch.delenv(var, raising=False)
    calls, joined = [], []
    monkeypatch.setattr(distributed.dist, "is_initialized",
                        lambda: bool(joined))

    def init(**kw):
        calls.append(kw)
        joined.append(True)

    monkeypatch.setattr(distributed.dist, "init_process_group", init)
    return calls


def test_initialize_from_env_parsing(no_launch, monkeypatch):
    # nothing configured: one process, no group
    assert distributed.initialize_from_env() is False and no_launch == []
    # a partial set names what is missing
    monkeypatch.setenv("MVAE_COORDINATOR", "host0:1234")
    monkeypatch.setenv("MVAE_NUM_PROCS", "4")
    with pytest.raises(ValueError, match="MVAE_PROC_ID"):
        distributed.initialize_from_env()
    monkeypatch.setenv("MVAE_PROC_ID", "0")
    assert distributed.initialize_from_env(device="cpu") is True
    assert no_launch == [dict(backend="gloo", init_method="tcp://host0:1234",
                              world_size=4, rank=0)]
    # a second call joins nothing more
    assert distributed.initialize_from_env() is True and len(no_launch) == 1


def test_initialize_explicit_args_beat_env(no_launch, monkeypatch):
    monkeypatch.setenv("MVAE_COORDINATOR", "env:1")
    monkeypatch.setenv("MVAE_NUM_PROCS", "8")
    monkeypatch.setenv("MVAE_PROC_ID", "7")
    assert distributed.initialize_from_env("arg:2", 2, 1, backend="gloo")
    assert no_launch == [dict(backend="gloo", init_method="tcp://arg:2",
                              world_size=2, rank=1)]


def test_initialize_reads_torchrun_only_when_asked(no_launch, monkeypatch):
    for k, v in dict(MASTER_ADDR="10.0.0.1", MASTER_PORT="29500",
                     WORLD_SIZE="2", RANK="1", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize_from_env() is False
    monkeypatch.setenv("MVAE_AUTO_DISTRIBUTED", "1")
    assert distributed.initialize_from_env(device="cpu") is True
    assert no_launch == [dict(backend="gloo",
                              init_method="tcp://10.0.0.1:29500",
                              world_size=2, rank=1)]
    assert distributed.local_rank() == 1


def test_initialize_refuses_a_bad_launch(no_launch, monkeypatch):
    monkeypatch.setenv("MVAE_AUTO_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize_from_env()
    with pytest.raises(ValueError, match="process id 2 not in"):
        distributed.initialize_from_env("h:1", 2, 2)
    assert no_launch == []


def test_one_process_checks_nothing():
    """Without a group the host check has nobody to disagree with."""
    distributed.assert_hosts_identical("anything", b"x")
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_make_mesh_clamps_the_data_axis_and_refuses_tp(monkeypatch):
    # c4_cond is registered for 8 data-parallel devices: one process
    # runs its global batch, as the JAX package's clamp does
    spec = get_config("c4_cond").mesh
    assert spec.data == 8
    m = tmesh.make_mesh(spec, "cpu")
    assert (m.data, m.rank, m.device, m.group) == (
        1, 0, torch.device("cpu"), False)
    assert m.rows(256) == slice(0, 256)
    assert tmesh.make_mesh(MeshSpec(), "cuda").device == \
        torch.device("cuda", 0)
    # a model axis the world cannot hold: the JAX package's ValueError,
    # and a world it does not divide
    with pytest.raises(ValueError, match="model axis 2 > 1 devices"):
        tmesh.make_mesh(dataclasses.replace(spec, model=2), "cpu")
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="3 processes are not a multiple "
                                         "of the model axis 2"):
        tmesh.make_mesh(dataclasses.replace(spec, model=2), "cpu")


def test_rows_are_process_contiguous():
    """Process p of P takes rows [p·B/P, (p+1)·B/P) of the global batch,
    the JAX mesh's order, and a batch they do not divide is refused."""
    x = np.arange(12)[:, None] * np.ones((1, 3))
    got = [tmesh.shard_batch(x, tmesh.DataMesh(3, p, torch.device("cpu")))
           for p in range(3)]
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert got[1][:, 0].tolist() == [4, 5, 6, 7]
    stacked = np.zeros((5, 12, 2))
    assert tmesh.shard_batch(stacked, tmesh.DataMesh(
        2, 1, torch.device("cpu")), axis=1).shape == (5, 6, 2)
    with pytest.raises(ValueError, match="not divisible by 5"):
        tmesh.DataMesh(5, 0, torch.device("cpu")).rows(12)


@pytest.mark.parametrize("device,want", [("cuda", "cuda:1"),
                                         ("cuda:0", "cuda:0"),
                                         ("cpu", "cpu")])
def test_commands_run_on_the_process_card(no_launch, monkeypatch, device,
                                          want):
    """The device commands' bare "cuda" is this process's card
    (torchrun's LOCAL_RANK) before the command builds any state, so a
    resumed run's state lands there too; an explicit device stays."""
    from musicvae_tpu_torch import cli

    seen = []
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(cli, "cmd_train",
                        lambda args: seen.append(args.device) or 0)
    assert cli.main(["train", "--device", device]) == 0
    assert seen == [want]
