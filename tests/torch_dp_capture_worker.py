"""One process of the data-parallel capture check
(tests/test_torch_dp_capture.py), on the CPU over gloo.

    python torch_dp_capture_worker.py <coordinator host:port> <num_procs>
        <proc_id> <work dir>

Joins the group through the ``MVAE_*`` variables, then, at the tiny f32
widths of ``config()`` (a cond model, whose step reads the chord and key
labels too) on <work dir>/corpus.npz:

- the resident dispatch (``make_train_step_indexed_multi``, the body a
  captured NCCL step holds, run eagerly over its static inputs as the
  CPU runs it) for ``STEPS`` steps in one dispatch, under the guard that
  makes host reads raise;
- the same steps from the same state with ``make_train_step_indexed``
  (the eager data-parallel step), one call a step;
- full-width c4_cond (registered widths, f32 compute) for
  ``FULL_STEPS`` steps of one row a process.

Prints one JSON line: the losses, the bit comparison, this process's
parameter checksum, and the tracer's all-reduce bytes and spans.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, os.pardir))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from musicvae_tpu_torch.config import get_config  # noqa: E402
from musicvae_tpu_torch.data.dataset import PianoRollDataset  # noqa: E402

TINY = dict(enc_channels=(4, 8, 8, 8, 8), dec_channels=(8, 8, 8, 8, 8),
            z_dim=16, gru_hidden=32, bar_feat_dim=32, cond_embed_dim=4,
            dtype="float32")
TRAIN = dict(batch_size=4, num_steps=6, log_every=3, ckpt_every=0,
             eval_every=0, beta_warmup_steps=4, learning_rate=1e-3, seed=3)
STEPS = 3
FULL_STEPS = 2


def config(full: bool = False):
    """The tiny cond config (the parent builds its baseline from it), or
    full-width c4_cond in f32 at one row a process of two."""
    cfg = get_config("c4_cond")
    model_kw = dict(dtype="float32") if full else TINY
    train_kw = dict(TRAIN, batch_size=2) if full else TRAIN
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, **train_kw))


def resident(ds, cfg):
    data = {"bars": torch.from_numpy(ds.bars),
            "starts": torch.from_numpy(ds.starts)}
    if cfg.model.kind == "cond":
        data.update(chords=torch.from_numpy(ds.chords),
                    keys=torch.from_numpy(ds.keys))
    return data


def idxs(cfg, ds, steps, rows=slice(None)):
    """[steps, rows] window ids of the first ``steps`` steps."""
    from musicvae_tpu_torch.train import trainer
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds),
                                   cfg.train.batch_size)
    return torch.from_numpy(np.stack([ids(j)[rows] for j in range(steps)]))


def param_sum(state) -> float:
    return float(sum(np.abs(p.detach().numpy().astype(np.float64)).sum()
                     for p in state.params))


def main() -> int:
    coordinator, world, rank, work = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(2)
    os.environ.update(MVAE_COORDINATOR=coordinator, MVAE_NUM_PROCS=str(world),
                      MVAE_PROC_ID=str(rank))
    from musicvae_tpu_torch.parallel import initialize_from_env, make_mesh
    from musicvae_tpu_torch.train import trainer
    from musicvae_tpu_torch.utils import trace
    from torch_port_helpers import no_host_reads, same_state

    assert initialize_from_env(device="cpu")
    ds = PianoRollDataset.load_npy(os.path.join(work, "corpus.npz"))
    out = {"proc": rank}

    cfg = config()
    mesh = make_mesh(cfg.mesh, "cpu")
    rows = mesh.rows(cfg.train.batch_size)
    model_a, state_a = trainer.create_state(cfg, device="cpu")
    model_b, state_b = trainer.create_state(cfg, device="cpu")
    out["graphable"] = trainer._graphable(mesh, state_a)
    data = resident(ds, cfg)
    ids = idxs(cfg, ds, STEPS, rows)
    trace.reset()
    multi = trainer.make_train_step_indexed_multi(cfg, model_a, mesh=mesh)
    with no_host_reads():
        _, m_multi = multi(state_a, data, ids)
    out["multi_counters"] = trace.counters()
    out["multi_spans"] = trace.totals().get("dist.allreduce", [0, 0.0])[0]
    single = trainer.make_train_step_indexed(cfg, model_b, mesh=mesh)
    losses = []
    for j in range(STEPS):
        _, m_single = single(state_b, data, ids[j])
        losses.append(float(m_single["loss"]))
    out["same_bits"] = (
        same_state(state_a, state_b)
        and all(torch.equal(m_multi[k], m_single[k]) for k in m_multi))
    out["losses"] = losses
    out["loss"] = float(m_multi["loss"])
    out["param_sum"] = param_sum(state_a)

    full = config(full=True)
    trace.reset()
    model, state = trainer.create_state(full, device="cpu")
    multi = trainer.make_train_step_indexed_multi(full, model, mesh=mesh)
    multi(state, resident(ds, full),
          idxs(full, ds, FULL_STEPS, mesh.rows(full.train.batch_size)))
    out["full_counters"] = trace.counters()
    out["full_steps"] = int(state.step)
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
