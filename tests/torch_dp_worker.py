"""One process of the port's multi-process training check
(tests/test_torch_dp_train.py), on the CPU over gloo.

    python torch_dp_worker.py <coordinator host:port> <num_procs> <proc_id>
        <work dir> [mode ...]

Joins the group through the ``MVAE_*`` variables
(``initialize_from_env``), then runs each mode in turn at tiny f32 widths
and prints one JSON line: {"proc": p, "modes": {mode: result}}. The data
modes run the ``train`` command (``cli.main``) as a launch would, each
process on the same command line, the checkpoint directory shared and a
log directory a process:

- resident: the resident corpus, replicated; each process trains on its
  rows of every global batch.
- stream: ``--stream``; every process's iterator is seeded alike and
  yields the global batch, of which each keeps its rows.
- host_sharded: ``--host-sharded``; each process holds only its
  ``host_shard`` of the corpus and streams its own rows.
- sharded: ``--corpus-layout sharded``, each process's device holding
  its shard's block.
- mxu: a tiny c2_mxu with ``free_bits`` and ``transpose_aug``, resident:
  the global floor and the global noise draw.
- refusals: ``--host-sharded`` with an eval cadence, and with a batch
  the processes do not divide: exit 2 on every process.

And through ``train()`` and the step:

- indexed: 3 steps of ``make_train_step_indexed_multi`` on the sharded
  layout's block from the weights and noise in <work dir>/indexed_in.pt;
  the parameters after them go to <work dir>/indexed_out_<p>.pt.
- desync: process 1 flips one cell of its corpus; every process must
  raise at the start-up hash check.
- preempt: only process 1's stop flag is set; both processes stop at the
  same step and process 0 saves it once into <work dir>/preempt.
- resume: ``train --resume`` continues preempt's checkpoint to the end
  of the run (it must equal resident's uninterrupted run).

The work dir also holds the corpus (corpus.npz), written by the parent.
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, REPO)

from musicvae_tpu_torch.config import get_config  # noqa: E402
from musicvae_tpu_torch.data.dataset import PianoRollDataset  # noqa: E402

TINY = dict(enc_channels=(4, 8, 8, 8, 8), dec_channels=(8, 8, 8, 8, 8),
            z_dim=16, gru_hidden=32, bar_feat_dim=32, dtype="float32")
MXU_TINY = dict(enc_channels=(8, 8, 16), dec_channels=(16, 8, 8), z_dim=8,
                gru_hidden=16, bar_feat_dim=16, dtype="float32")
TRAIN = dict(batch_size=4, num_steps=6, log_every=2, ckpt_every=6,
             eval_every=0, beta_warmup_steps=4, learning_rate=1e-3, seed=3)
MODES = ("resident", "stream", "host_sharded", "sharded", "mxu", "refusals",
         "indexed", "desync", "preempt", "resume")
# the command line of each data mode, after --config and --data
CLI_FLAGS = {"resident": [], "stream": ["--stream"],
             "host_sharded": ["--host-sharded"],
             "sharded": ["--corpus-layout", "sharded"], "mxu": []}


def config(mode: str = "resident"):
    """The tiny config of a mode (the parent builds its baselines from
    the same function)."""
    name, model_kw, train_kw = "c2_gru_4bar", TINY, {}
    if mode == "mxu":
        name, model_kw = "c2_mxu", MXU_TINY
        train_kw = dict(free_bits=0.125, transpose_aug=2)
    if mode in ("sharded", "indexed"):
        train_kw = dict(corpus_layout="sharded")
    cfg = get_config(name)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, **{**TRAIN, **train_kw}))


def register_configs() -> None:
    """The tiny configs under the names the command line is given
    (``config_name``), in this process's registry."""
    from musicvae_tpu_torch import config as config_lib

    for mode in ("resident", "mxu"):
        cfg = config(mode)
        config_lib._CONFIGS[config_name(mode)] = cfg.replace(
            name=config_name(mode))


def config_name(mode: str) -> str:
    return "dp_tiny_mxu" if mode == "mxu" else "dp_tiny"


def param_sum(state) -> float:
    return float(sum(np.abs(p.detach().numpy().astype(np.float64)).sum()
                     for p in state.params))


def train_cli(mode: str, work: str, rank: int, *flags) -> dict:
    """``train`` through the command line in ``mode`` (into
    <work>/<mode>/ckpt, logging into <work>/<mode>/logs<rank>): its exit
    code, the step and parameters of the checkpoint it left (every
    process reads process 0's), the final metrics it printed, and whether
    this process wrote a metrics log."""
    from musicvae_tpu_torch import cli
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.train import trainer

    ckpt_dir = (os.path.join(work, "preempt") if mode == "resume"
                else os.path.join(work, mode, "ckpt"))
    log_dir = os.path.join(work, mode, f"logs{rank}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["train", "--config", config_name(mode), "--data",
                       os.path.join(work, "corpus.npz"), "--device", "cpu",
                       "--ckpt-dir", ckpt_dir, "--log-dir", log_dir,
                       *CLI_FLAGS.get(mode, []), *flags])
    res = {"rc": rc, "err": err.getvalue()[-2000:],
           "logged": os.path.exists(os.path.join(log_dir, "metrics.jsonl"))}
    if rc:
        return res
    final = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("final metrics: ")]
    metrics = ast.literal_eval(final[-1][len("final metrics: "):])
    manager = ckpt_io.make_manager(ckpt_dir)
    _, state = trainer.create_state(config(mode), device="cpu")
    state, _ = ckpt_io.restore(manager, state)
    res.update(step=int(state.step), loss=metrics["loss"],
               grad_norm=metrics["grad_norm"], param_sum=param_sum(state))
    return res


def run(mode: str, ds, work: str, rank: int, world: int) -> dict:
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.parallel import make_mesh
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.train.sharded_corpus import (
        build_sharded_arrays, local_block, make_sharded_id_schedule)

    if mode in CLI_FLAGS:
        return train_cli(mode, work, rank)
    if mode == "resume":
        return train_cli(mode, work, rank, "--resume")
    if mode == "refusals":
        b = config(mode).train.batch_size
        return {"eval": train_cli(mode, work, rank, "--host-sharded",
                                  "--eval-every", "2"),
                "batch": train_cli(mode, work, rank, "--host-sharded",
                                   "--batch-size", str(b + 1))}
    cfg = config(mode)
    b = cfg.train.batch_size
    if mode == "desync":
        if rank == 1:
            ds = PianoRollDataset(ds.bars.copy(), ds.starts, ds.num_bars,
                                  ds.chords, ds.keys, ds.piece_ids,
                                  grid=ds.grid)
            ds.bars[0, 0, 60] ^= 1
        try:
            trainer.train(cfg, ds, device="cpu")
        except RuntimeError as e:
            return {"desync_caught": "divergence" in str(e)}
        return {"desync_caught": False}
    if mode == "preempt":
        class Stop:
            requested = rank == 1

        manager = ckpt_io.make_manager(os.path.join(work, "preempt"))
        _, state, metrics = trainer.train(cfg, ds, ckpt_manager=manager,
                                          stop=Stop(), device="cpu")
        manager.wait_until_finished()
        torch.distributed.barrier()        # process 0's write committed
        manager.reload()
        return {"step": int(state.step), "saved_steps": manager.all_steps(),
                "loss": float(metrics["loss"])}
    if mode == "indexed":
        # the weights and noise the parent gives the JAX package too
        given = torch.load(os.path.join(work, "indexed_in.pt"),
                           weights_only=True)
        _, state = trainer.create_state(cfg, device="cpu")
        state.load_state_dict(given["state"])
        mesh = make_mesh(cfg.mesh, "cpu")
        arrays, counts = build_sharded_arrays(ds, world, cfg.train.seed)
        block = local_block(arrays, world, rank)
        data = {k: torch.from_numpy(block[k]) for k in ("bars", "starts")}
        ids = make_sharded_id_schedule(cfg.train.seed, counts, b)
        idxs = torch.from_numpy(np.stack([ids(j)[mesh.rows(b)]
                                          for j in range(3)]))
        multi = trainer.make_train_step_indexed_multi(cfg, state.model,
                                                      mesh=mesh)
        _, metrics = multi(state, data, idxs, eps=given["eps"])
        torch.save({n: p.detach() for n, p in
                    state.model.named_parameters()},
                   os.path.join(work, f"indexed_out_{rank}.pt"))
        return {k: float(v) for k, v in metrics.items()}
    raise ValueError(f"unknown mode {mode!r}")


def main() -> int:
    coordinator, world, rank, work = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4])
    modes = sys.argv[5:] or MODES
    torch.set_num_threads(1)
    os.environ.update(MVAE_COORDINATOR=coordinator, MVAE_NUM_PROCS=str(world),
                      MVAE_PROC_ID=str(rank))
    from musicvae_tpu_torch.parallel import initialize_from_env, world_size
    assert initialize_from_env(device="cpu") and world_size() == world
    register_configs()
    ds = PianoRollDataset.load_npy(os.path.join(work, "corpus.npz"))
    out = {mode: run(mode, ds, work, rank, world) for mode in modes}
    torch.distributed.destroy_process_group()
    print(json.dumps({"proc": rank, "modes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
