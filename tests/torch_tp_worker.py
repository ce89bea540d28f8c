"""One process of the port's tensor-parallel check
(tests/test_torch_tp_train.py), on the CPU over gloo.

    python torch_tp_worker.py <coordinator host:port> <num_procs> <proc_id>
        <work dir>

Joins a group of 4 processes through the ``MVAE_*`` variables, lays them
out as data=2 x model=2 (``make_mesh(MeshSpec(model=2))``) and runs each
mode at tiny f32 widths from the weights, batches and noise the parent
wrote into <work dir>/inputs.pt; it prints one JSON line, {"proc": p,
"modes": {mode: result}}, and writes the unsharded parameters (and EMA
copies) of each mode's state, which every process gathers, into
<work dir>/<mode>_<p>.pt (``named_tensors``):

- adam: 3 steps of ``make_train_step`` with Adam and a clip on a state
  sharded by ``shard_params``; the state is then saved (process 0 writes
  the unsharded file into <work dir>/ck_adam) and restored into a fresh
  sharded state, which must gather to the same tensors;
- control: adam without the dx all-reduce of the column-parallel
  backward (``without_dx_all_reduce``), which must miss;
- attn: the attention config, 3 plain SGD steps (``sgd_steps``);
- conv1: adam with the first-conv kernel path (``use_pallas_conv1``) at
  16 first-conv channels, 8 a rank, and EMA copies (sharded alike);
- train: ``train()`` on the corpus <work dir>/corpus.npz with a mesh of
  ``MeshSpec(data=1, model=2)`` (here data=2, model=2), replicated, as
  the JAX package's ``train()`` runs such a mesh;
- host_sharded: train, streaming what ``train --host-sharded`` streams
  (the command line's ``_train_stream``): each process its data index's
  shard of the corpus, shared by the processes of its model group.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, REPO)

from musicvae_tpu_torch.config import MeshSpec, get_config  # noqa: E402

WORLD = 2 * 2
STEPS = 3
TINY = dict(enc_channels=(4, 8, 8, 8, 8), dec_channels=(8, 8, 8, 8, 8),
            z_dim=16, gru_hidden=32, bar_feat_dim=32, dtype="float32")
ATTN_TINY = dict(enc_channels=(8, 8, 16), dec_channels=(16, 8, 8), z_dim=8,
                 gru_hidden=16, bar_feat_dim=16, attn_heads=4,
                 dtype="float32")
TRAIN = dict(batch_size=4, beta_warmup_steps=4, learning_rate=1e-3, seed=3)
SGD_LR = 1e-2
MODES = ("adam", "control", "attn", "conv1", "train", "host_sharded")


def config(mode: str):
    """The tiny config of a mode (the parent builds its baselines and the
    JAX config from the same function)."""
    name, model_kw, train_kw = "c2_gru_4bar", TINY, dict(grad_clip_norm=1.0)
    if mode == "attn":
        name, model_kw, train_kw = "c2_trf", ATTN_TINY, {}
    if mode == "conv1":
        model_kw = dict(TINY, enc_channels=(16, 8, 8, 8, 8),
                        use_pallas_conv1=True)
        train_kw = dict(train_kw, ema_decay=0.9)
    if mode in ("train", "host_sharded"):
        train_kw = dict(num_steps=6, log_every=2, ckpt_every=0,
                        eval_every=0)
    cfg = get_config(name)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, **{**TRAIN, **train_kw}))


@contextlib.contextmanager
def without_dx_all_reduce():
    """The column-parallel backward with its input gradient left unreduced
    on each rank (``parallel.tp._ReduceGrad``'s backward swapped for the
    identity): the control run that an equivalence check must catch."""
    from musicvae_tpu_torch.parallel import tp

    saved = tp._ReduceGrad.backward
    tp._ReduceGrad.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        tp._ReduceGrad.backward = saved


def named_tensors(sd: dict) -> dict:
    """The parameters of a state dict by name, and its EMA copies as
    "ema.<name>"."""
    return {**sd["params"],
            **{f"ema.{n}": t for n, t in (sd["ema"] or {}).items()}}


def sgd_steps(cfg, state, xs, eps, mesh=None):
    """STEPS plain SGD steps (lr ``SGD_LR``) of the ELBO at β 0.5 on
    ``state``'s parameters: x[j] holds this process's rows (all of them
    on one process), eps[j] the global batch's noise, and under a mesh
    with a data axis the gradients are averaged over the data group.
    Returns the last step's loss."""
    from musicvae_tpu_torch.train import trainer

    params = state.params
    for j in range(STEPS):
        e = eps[j] if mesh is None else eps[j][mesh.rows(eps[j].shape[0])]
        logits, latents = state.model(xs[j], (e,))
        loss, metrics = trainer.elbo_from_outputs(cfg, logits, xs[j],
                                                  latents, 0.5)
        grads = torch.autograd.grad(loss, params)
        metrics = {k: metrics[k].detach() for k in ("loss", "recon", "kl")}
        with torch.no_grad():
            if mesh is not None and mesh.data > 1:
                grads, metrics = trainer._average_over_group(grads, metrics,
                                                             mesh)
            torch._foreach_add_(params, grads, alpha=-SGD_LR)
    return float(metrics["loss"])


def run(mode: str, work: str, inputs: dict, mesh) -> dict:
    from musicvae_tpu_torch.checkpoints import io as ckpt_io
    from musicvae_tpu_torch.data.dataset import PianoRollDataset
    from musicvae_tpu_torch.parallel import make_mesh, shard_params
    from musicvae_tpu_torch.parallel import tp as tp_lib
    from musicvae_tpu_torch.train import trainer

    cfg = config(mode)
    if mode in ("train", "host_sharded"):
        cfg = cfg.replace(mesh=MeshSpec(data=1, model=2))
        data = PianoRollDataset.load_npy(os.path.join(work, "corpus.npz"))
        if mode == "host_sharded":
            from musicvae_tpu_torch import cli

            data = cli._train_stream(argparse.Namespace(
                host_sharded=True, stream=False), cfg, data)
        _, state, metrics = trainer.train(cfg, data, device="cpu")
        return {"loss": float(metrics["loss"]), "step": int(state.step),
                "param_sum": float(sum(
                    np.abs(p.detach().numpy().astype(np.float64)).sum()
                    for p in state.params))}
    given = inputs["attn" if mode == "attn" else
                   "conv1" if mode == "conv1" else "adam"]
    _, state = trainer.create_state(cfg, device="cpu")
    state.load_state_dict(given["state"])
    shard_params(state, mesh)
    rows = mesh.rows(cfg.train.batch_size)
    xs = [x[rows] for x in given["x"]]
    out = {"bytes": tp_lib.state_bytes(state),
           "first_conv_channels":
               state.model.enc_feat.convs[0].weight.shape[0]}
    if mode == "attn":
        out["loss"] = sgd_steps(cfg, state, xs, given["eps"], mesh)
    else:
        step = trainer.make_train_step(cfg, state.model, mesh=mesh)
        with (without_dx_all_reduce() if mode == "control"
              else contextlib.nullcontext()):
            for j in range(STEPS):
                _, metrics = step(state, {"x": xs[j]}, eps=given["eps"][j])
        out.update({k: float(v) for k, v in metrics.items()})
    sd = state.state_dict()
    torch.save(named_tensors(sd), os.path.join(
        work, f"{mode}_{torch.distributed.get_rank()}.pt"))
    if mode == "adam":
        ckpt_io.save(ckpt_io.make_manager(os.path.join(work, "ck_adam")),
                     state, cfg, wait=True)
        # restored into a fresh sharded state: the same tensors gathered
        _, fresh = trainer.create_state(cfg, device="cpu")
        shard_params(fresh, make_mesh(MeshSpec(model=2), "cpu"))
        fresh, _ = ckpt_io.restore(
            ckpt_io.make_manager(os.path.join(work, "ck_adam")), fresh)
        again = fresh.state_dict()
        out["restored_equal"] = all(
            torch.equal(a[n], b[n]) for a, b in (
                (again["params"], sd["params"]),
                (again["opt"]["mu"], sd["opt"]["mu"]),
                (again["opt"]["nu"], sd["opt"]["nu"])) for n in b)
    return out


def main() -> int:
    coordinator, world, rank, work = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    os.environ.update(MVAE_COORDINATOR=coordinator, MVAE_NUM_PROCS=str(world),
                      MVAE_PROC_ID=str(rank))
    from musicvae_tpu_torch.parallel import initialize_from_env, make_mesh
    assert initialize_from_env(device="cpu")
    mesh = make_mesh(MeshSpec(model=2), "cpu")
    assert (mesh.data, mesh.model) == (2, 2)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    out = {mode: run(mode, work, inputs, mesh) for mode in MODES}
    out["mesh"] = [mesh.data, mesh.model, mesh.data_rank, mesh.model_rank]
    torch.distributed.destroy_process_group()
    print(json.dumps({"proc": rank, "modes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
