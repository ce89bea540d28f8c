"""The ELBO train step and the host loop around it.

Counterpart of the JAX package's train/trainer.py: batch → forward
(encoder → reparameterize → decoder) → masked-BCE + KL-annealed ELBO →
backward → Adam, with the β schedule, the noise, the optional transpose
augmentation, the optimizer, ``grad_norm``, ``nonfinite`` and the EMA all
inside the step, on the device. The host loop draws window ids (or, when
streaming, stacks host batches), dispatches K steps at a time and does the
log, eval and checkpoint I/O. Its data paths are the JAX package's three:

- resident (a ``PianoRollDataset``): the bar cache is uploaded once and
  every batch is gathered on the device by window id, the corpus either
  replicated on every device or, with ``corpus_layout="sharded"``, dealt
  piece-wise over the data-parallel processes (train/sharded_corpus.py);
- streaming (an iterator of host batches, for corpora larger than device
  memory): a producer thread packs the rolls to 1 bit a cell and uploads
  the next K batches while the device runs the current ones;
- per-process streaming (``data.HostLocalBatches``): each process's
  iterator yields only its own rows of the global batch.

Multi-process data parallelism (parallel/): each process drives one
device and trains on its rows of every global batch; the gradients and
the logged metrics are averaged over the data group inside the step, so
every process holds the same state. Under tensor parallelism
(parallel/tp.py ``shard_params``) the processes of a model group train
on the same rows, each holding its shards of the weights and of their
moments; the clip's norm then spans the shards.

What differs from the JAX package, and why:

- State is mutable. Parameters live in the ``nn.Module``; a step updates
  them, the optimizer moments, the step counter and the generator in place
  and returns the same ``TrainState``.
- The counterpart of jit over ``lax.scan`` is a captured CUDA graph
  (utils/graphs.py): on a CUDA device with no process group and outside
  ``utils/debug.py`` ``debug_mode``, the resident K-step dispatch
  (``make_train_step_indexed_multi``) captures one step and replays it
  once a row of window ids, which an enqueued device copy puts in the
  step's static input, and the streamed dispatch
  (``make_train_step_multi``) likewise a row of the uploaded stack; the
  first step runs eagerly (the warm-up). The evals are graphs too
  (utils/metrics.py ``make_eval_fn``). Runs with a process group
  (collectives) and ``debug_mode`` run the same step eagerly, a Python
  loop with no host synchronisation inside (no ``.item()``, no
  host-made tensors). Metrics come back as device tensors and are read
  at log boundaries only.
- Noise comes from the state's ``torch.Generator`` on the device, in a
  fixed order each step: the transpose shifts, then each latent level's
  normals (``vae.draw_eps``: the phrase level, then the bar level, for
  hier), always for the global batch, of which a process keeps its rows:
  the draws of P processes are those of one. Every step function also
  takes ``eps`` (and ``shifts``) from the caller, which is how the tests
  feed both packages the same numbers.
- The gradients are taken with ``torch.autograd.grad`` and averaged over
  the process group explicitly, in one flat all-reduce (no
  DistributedDataParallel: its hooks belong to ``.backward()``), before
  ``grad_norm``, the clip, Adam and the EMA see them, as the JAX
  package's psum places them.
- The optimizer is a small Adam over ``torch._foreach`` ops that follows
  optax's arithmetic (``adam``/``adamw``, ``clip_by_global_norm``, the lr
  schedules, ``mu_dtype``), with its count on the device.
  ``torch.optim.Adam`` and ``clip_grad_norm_`` place eps, the clip factor
  and the bias corrections differently.
- ``use_pallas_loss`` takes effect on a CUDA device: the differentiated
  loss then goes through the dual-output BCE kernel (ops/fused_elbo.py).

Checkpoints are checkpoints/io.py's files, written by process 0, and a
preemption stop is train/preemption.py's ``GracefulStop``, decided
collectively; a sharded state is saved unsharded.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.data.dataset import HostLocalBatches
from musicvae_tpu_torch.midi.tensorize import pitch_mask
from musicvae_tpu_torch.models.vae import (PianoRollVAE, build_model,
                                           draw_eps, resolve_device)
from musicvae_tpu_torch.ops import augment, fused_elbo, losses
from musicvae_tpu_torch.ops.pack import pack_bits_np, unpack_bits
from musicvae_tpu_torch.parallel import distributed
from musicvae_tpu_torch.parallel import tp as tp_lib
from musicvae_tpu_torch.parallel.mesh import (DataMesh, make_mesh,
                                              shard_batch)
from musicvae_tpu_torch.utils import graphs

# cuBLAS is reproducible under torch.use_deterministic_algorithms only with
# a fixed workspace, chosen through this variable, which PyTorch reads at
# the process's first CUDA matmul: set here, when training code is first
# imported, unless the caller chose a value
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ADAM_EPS = 1e-8               # optax.adam's default; eps_root is 0


# -- learning rate and optimizer ---------------------------------------------

def make_lr(cfg: Config):
    """Learning rate per TrainSpec: a float ("constant") or a function of
    the optimizer's update count, a 0-d tensor, returning a 0-d f32 tensor
    on its device ("cosine": optional linear warmup, then cosine decay to
    lr*lr_min_ratio at num_steps). The formulas are optax's
    ``linear_schedule``, ``cosine_decay_schedule`` and ``join_schedules``:
    the cosine part sees ``count − warmup``."""
    t = cfg.train
    if t.lr_schedule == "constant":
        return t.learning_rate
    if t.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}; "
                         "expected 'constant' or 'cosine'")
    lr, warmup = t.learning_rate, t.lr_warmup_steps
    decay_steps = float(max(t.num_steps - warmup, 1))

    def cos(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp_max(count.to(torch.float32), decay_steps)
        decay = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return lr * ((1.0 - t.lr_min_ratio) * decay + t.lr_min_ratio)

    if warmup <= 0:
        return cos

    def warm(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, 0, warmup).to(torch.float32)
        return (0.0 - lr) * (1.0 - c / warmup) + lr

    def joined(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        return torch.where(count < warmup, warm(count), cos(count - warmup))

    return joined


def global_norm(tensors: List[torch.Tensor], tp=None) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over the list, a 0-d tensor (optax.global_norm).
    ``tp`` (a tensor-parallel state's ``parallel.tp.TPState``, its entries
    in the list's order): the norm of the whole tree the shards make up,
    the sharded entries' Σ‖t‖² summed over the model group and each
    replicated entry counted once."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if tp is None:
        return torch.linalg.vector_norm(norms)
    return tp_lib.global_norm(norms, tp)


class Adam:
    """optax's ``adam`` / ``adamw`` behind an optional
    ``clip_by_global_norm``, as ``make_optimizer`` of the JAX package
    chains them, over ``torch._foreach`` ops with every scalar that changes
    from step to step (count, bias corrections, lr, clip factor) on the
    device.

        g      ← g if ‖g‖ < clip else (g / ‖g‖) · clip
        mu     ← (1 − b1)·g + b1·mu          (kept in ``adam_mu_dtype``)
        nu     ← (1 − b2)·g² + b2·nu
        count  ← count + 1
        u      ← (mu / (1 − b1^count)) / (sqrt(nu / (1 − b2^count)) + eps)
        u      ← u + weight_decay·p          (adamw)
        p      ← p − lr(count − 1)·u

    The bias-corrected update uses ``mu`` before it is rounded to
    ``adam_mu_dtype``, as optax does."""

    def __init__(self, cfg: Config, params: List[torch.Tensor]):
        self.params = list(params)
        self.configure(cfg)
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self._one = torch.ones((), dtype=torch.float32, device=dev)

    def configure(self, cfg: Config) -> None:
        """Take the hyperparameters of ``cfg.train``: betas, weight decay,
        clip and lr schedule. The moments and the count stay, so a run
        resumed under changed settings (``train --resume --lr ...``) goes
        on with them, as the JAX package's does, whose optimizer is built
        from the config of each run."""
        t = cfg.train
        if t.adam_mu_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"adam_mu_dtype {t.adam_mu_dtype!r} not in "
                             f"{tuple(_MOMENT_DTYPES)}")
        mu_dtype = _MOMENT_DTYPES[t.adam_mu_dtype]
        if hasattr(self, "mu") and mu_dtype != self.mu_dtype:
            raise ValueError(f"adam_mu_dtype cannot change from "
                             f"{self.mu_dtype} on a state with moments")
        self.b1, self.b2 = t.adam_b1, t.adam_b2
        self.weight_decay = t.weight_decay
        self.clip = t.grad_clip_norm
        self.lr = make_lr(cfg)
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor],
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """One optimizer step on the parameters, in place. ``grad_norm``:
        the gradients' global norm when the caller already has it."""
        grads = list(grads)
        if self.clip > 0:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            keep = norm < self.clip
            # (g / ‖g‖)·clip when clipping, g / 1 · 1 (exact) otherwise
            grads = torch._foreach_div(grads, torch.where(keep, self._one,
                                                          norm))
            torch._foreach_mul_(grads, torch.where(
                keep, self._one, self._one * self.clip))
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        # b1·mu is taken in mu's own dtype (rounded to bf16 when the
        # moment is kept so), then added in f32; an f32 moment is updated
        # in place (the same sum: addition commutes bit for bit), so a
        # captured step (utils/graphs.py) reads and writes one tensor
        if self.mu_dtype == torch.float32:
            mu = self.mu
            torch._foreach_mul_(mu, self.b1)
        else:
            mu = [m.to(torch.float32) for m in
                  torch._foreach_mul(self.mu, self.b1)]
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, sq)
        self.count += 1
        count = self.count.to(torch.float32)
        u = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, count))
        denom = torch._foreach_div(self.nu, 1.0 - torch.pow(self.b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(u, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(self.params, u)
        if self.mu_dtype != torch.float32:
            torch._foreach_copy_(self.mu, mu)


def make_optimizer(cfg: Config, params: List[torch.Tensor]) -> Adam:
    return Adam(cfg, params)


# -- train state ---------------------------------------------------------------

class TrainState:
    """Everything a train step reads and updates in place: the model (its
    parameters are the trained weights), the optimizer with its moments
    and count, the step counter (an int32 0-d tensor on the device), the
    device generator the noise comes from, and the EMA copy of the model
    (None when ``TrainSpec.ema_decay`` is 0). ``tp``: None, or after
    ``parallel.tp.shard_params`` which parameters hold only this
    process's shard (their moments and EMA copies too)."""

    def __init__(self, model: PianoRollVAE, opt: Adam, step: torch.Tensor,
                 generator: torch.Generator,
                 ema_model: Optional[PianoRollVAE] = None):
        self.model, self.opt, self.step = model, opt, step
        self.generator, self.ema_model = generator, ema_model
        self.tp: Optional[tp_lib.TPState] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return self.opt.params

    @property
    def ema_params(self) -> Optional[List[torch.Tensor]]:
        return (None if self.ema_model is None
                else list(self.ema_model.parameters()))

    def _names(self) -> List[str]:
        return [n for n, _ in self.model.named_parameters()]

    def state_dict(self, device=None) -> Dict[str, Any]:
        """A copy of the whole state: params, moments and EMA by parameter
        name, count, step and the generator's state. ``device``: where the
        copy goes (default the state's own device); a copy from the card to
        the CPU waits for the card once, after every tensor's copy is
        queued (checkpoints/io.py ``save``). A tensor-parallel state gives
        the unsharded tensors, gathered over its model group: every
        process of the group must call this together."""
        names = self._names()
        dev = self.step.device
        to = dev if device is None else torch.device(device)

        def copy(t):
            t = t.detach()
            return t.clone() if to == dev else t.to(to, non_blocking=True)

        def named(tensors):
            if self.tp is not None:
                tensors = self.tp.unshard_all(tensors)
            return {n: copy(t) for n, t in zip(names, tensors)}

        sd = {"params": named(self.params),
              "opt": {"mu": named(self.opt.mu), "nu": named(self.opt.nu),
                      "count": copy(self.opt.count)},
              "step": copy(self.step),
              "rng": self.generator.get_state(),
              "ema": (None if self.ema_model is None
                      else named(self.ema_params))}
        if to != dev and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Overwrite this state with ``sd`` (a ``state_dict()``, or the
        same layout filled from a JAX run by checkpoints/convert.py). An
        ``sd`` without "rng", or with the state of another kind of
        generator (a CPU state's on a CUDA state, or the reverse), keeps
        this state's generator: the noise of one kind cannot continue on
        the other. A tensor-parallel state takes the unsharded tensors
        and keeps its own shard of each."""
        names = self._names()

        def load(dst, src, what):
            if set(src) != set(names):
                raise KeyError(f"{what}: keys differ from the model's "
                               f"parameters: {sorted(set(src) ^ set(names))}")
            for i, (n, d) in enumerate(zip(names, dst)):
                t = torch.as_tensor(src[n])
                if self.tp is not None:
                    t = self.tp.local(i, t.reshape(self.tp.shapes[i]))
                d.copy_(t.reshape(d.shape))

        load(self.params, sd["params"], "params")
        load(self.opt.mu, sd["opt"]["mu"], "opt.mu")
        load(self.opt.nu, sd["opt"]["nu"], "opt.nu")
        self.opt.count.copy_(torch.as_tensor(sd["opt"]["count"]))
        self.step.copy_(torch.as_tensor(sd["step"]))
        rng = sd.get("rng")
        if rng is not None and rng.numel() == \
                self.generator.get_state().numel():
            self.generator.set_state(rng)
        if (sd.get("ema") is None) != (self.ema_model is None):
            raise ValueError("the state dict and this state disagree on "
                             "whether EMA weights are kept")
        if self.ema_model is not None:
            load(self.ema_params, sd["ema"], "ema")


def init_state(cfg: Config, model: PianoRollVAE,
               seed: Optional[int] = None) -> TrainState:
    """The state at step 0 around ``model`` as it stands (for example with
    converted weights loaded): zero moments, the noise generator on the
    model's device seeded with ``seed`` (default ``cfg.train.seed``), and
    the EMA copy starting at the model's weights."""
    dev = next(model.parameters()).device
    seed = cfg.train.seed if seed is None else seed
    ema_model = None
    if cfg.train.ema_decay > 0:
        ema_model = copy.deepcopy(model).requires_grad_(False)
    return TrainState(
        model, make_optimizer(cfg, list(model.parameters())),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.Generator(dev).manual_seed(seed), ema_model)


def create_state(cfg: Config, device="cuda",
                 seed: Optional[int] = None) -> Tuple[PianoRollVAE,
                                                      TrainState]:
    """(model, state) at step 0 on ``device``: weights drawn from ``seed``
    (default ``cfg.train.seed``) as ``build_model`` draws them, and
    ``init_state`` around them."""
    seed = cfg.train.seed if seed is None else seed
    model = build_model(cfg, device=device, seed=seed)
    return model, init_state(cfg, model, seed)


# -- the loss and the step -------------------------------------------------------

def _group_mean(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The mean of ``t`` over ``mesh``'s data group (a copy)."""
    t = t.clone()
    dist.all_reduce(t, group=mesh.data_group)
    return t / mesh.data


def elbo_from_outputs(cfg: Config, logits, x, latents, beta,
                      use_pallas: bool = False, free_bits: float = 0.0,
                      pallas_dual: bool = False,
                      mesh: Optional[DataMesh] = None):
    """recon + beta * (sum of per-level KLs), batch-mean (ops/losses.py).

    With ``use_pallas`` the masked-BCE sum goes through ops/fused_elbo.py
    (the CUDA kernel on the card); ``pallas_dual`` selects the dual-output
    forward, for differentiated graphs. x goes in as it is, uint8 included.

    ``free_bits`` > 0 floors each latent dimension's batch-mean KL in the
    minimized objective; the reported ``kl`` stays the true KL. ``mesh``:
    these are one process's rows of a global batch split evenly over the
    processes of ``mesh``'s data group, and the floor applies to the
    global batch's means (``losses.kl_free_bits``'s ``reduce``)."""
    mask = pitch_mask(cfg.midi, logits.device)
    batch = logits.shape[0]
    if use_pallas:
        kernel = (fused_elbo.masked_bce_sum_dual if pallas_dual
                  else fused_elbo.masked_bce_sum)
        recon = kernel(logits, x, mask) / batch
    else:
        recon = losses.masked_bce_sum(logits, x, mask) / batch
    kl = sum(losses.kl_diag_gaussian(mu, lv) for mu, lv in latents) / batch
    if free_bits > 0.0:
        reduce = None if mesh is None else functools.partial(_group_mean,
                                                             mesh=mesh)
        kl_obj = sum(losses.kl_free_bits(mu, lv, free_bits, reduce)
                     for mu, lv in latents) / batch
    else:
        kl_obj = kl
    loss = recon + beta * kl_obj
    return loss, {"loss": loss, "recon": recon, "kl": kl, "beta": beta}


_AVERAGED = ("loss", "recon", "kl")     # metrics averaged over the group


def _average_over_group(grads: List[torch.Tensor],
                        metrics: Dict[str, torch.Tensor], mesh: DataMesh):
    """(grads, metrics) averaged over ``mesh``'s data group: one flat f32
    bucket of every gradient and the ``_AVERAGED`` metrics, one
    all-reduce (SUM), then ÷ data. Every process of the group gets the
    same bits. Under tensor parallelism a process's gradients are those
    of its own shards, which the processes of its data group share."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [metrics[k].reshape(1).to(grads[0].dtype)
                        for k in _AVERAGED])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.data
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    metrics = dict(metrics)
    for j, k in enumerate(_AVERAGED):
        metrics[k] = flat[i + j].to(metrics[k].dtype)
    return out, metrics


def _train_step_body(cfg: Config, model: PianoRollVAE,
                     use_pallas: Optional[bool] = None,
                     mesh: Optional[DataMesh] = None) -> Callable:
    """The single-step update every step function shares:
    (state, batch, eps=None, shifts=None) → (state, metrics).

    ``mesh`` (parallel/mesh.py): ``batch`` holds this process's rows of
    the global batch; the noise is drawn for the global batch and this
    process keeps its rows (``eps`` and ``shifts``, when given, are the
    global batch's too), and with a process group the gradients and the
    loss, recon and kl are averaged over the data group. A state sharded
    by ``parallel.tp.shard_params`` takes its clip's norm over the whole
    tree its model group holds."""
    t = cfg.train
    cond = cfg.model.kind == "cond"
    if t.transpose_aug and cond and (cfg.model.cond_chord_classes != 24
                                     or cfg.model.cond_key_classes != 24):
        raise ValueError(
            "transpose_aug on a cond model rotates chord/key labels with "
            "the pitch shift, which requires the 24-class root*2+minor "
            "encoding (midi/labels.py); got "
            f"{cfg.model.cond_chord_classes}/{cfg.model.cond_key_classes} "
            "classes — an unknown encoding cannot be rotated safely")
    if t.transpose_aug < 0:
        raise ValueError(f"transpose_aug must be >= 0, got "
                         f"{t.transpose_aug}")
    if t.remat_encoder != model.remat_encoder:
        raise ValueError(
            f"TrainSpec.remat_encoder is {t.remat_encoder} but the model "
            f"was built with remat_encoder={model.remat_encoder}; build it "
            f"from the same config (build_model, create_state)")
    device = next(model.parameters()).device
    if use_pallas is None:
        use_pallas = t.use_pallas_loss and device.type == "cuda"
    world = 1 if mesh is None else mesh.data
    # averaged over the data group whenever a group is joined and the
    # group is not one process of a model axis
    reduce = mesh is not None and mesh.group and (
        mesh.data > 1 or mesh.model == 1)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   eps=None, shifts: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("this step was built for another model than "
                             "the state's")
        x = batch["x"]
        rows = slice(None)
        if world > 1:
            rows = mesh.rows(x.shape[0] * world)
        labels = {}
        if cond:
            labels = {"chord": batch["chord"], "key_sig": batch["key_sig"]}
        beta = losses.beta_schedule(state.step, t.beta_max,
                                    t.beta_warmup_steps, t.beta_hold_steps,
                                    t.beta_schedule, t.beta_cycle_steps)
        # the state's generator gives the shifts first, then the noise,
        # both for the global batch
        if t.transpose_aug:
            if shifts is None:
                shifts = augment.random_shifts(
                    state.generator, x.shape[0] * world, t.transpose_aug)
            shifts = shifts[rows]
            x = augment.transpose_rolls(x, shifts)
            if cond:
                # the labels transpose with the content
                labels = {"chord": augment.rotate_chord_classes(
                              labels["chord"], shifts[:, None]),
                          "key_sig": augment.rotate_chord_classes(
                              labels["key_sig"], shifts)}
        if eps is None:
            eps = draw_eps(cfg.model, x.shape[0] * world, state.generator)
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        eps = tuple(e[rows] for e in eps)
        logits, latents = model(x, eps, **labels)
        loss, metrics = elbo_from_outputs(cfg, logits, x, latents, beta,
                                          use_pallas, free_bits=t.free_bits,
                                          pallas_dual=True,
                                          mesh=mesh if reduce else None)
        if torch.is_anomaly_enabled() and not bool(torch.isfinite(loss)):
            # utils/debug.py debug_mode: jax_debug_nans' counterpart
            raise FloatingPointError(f"non-finite train loss "
                                     f"{float(loss.detach())} (debug_mode)")
        grads = torch.autograd.grad(loss, state.params)
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            if reduce:
                grads, metrics = _average_over_group(grads, metrics, mesh)
            metrics["grad_norm"] = global_norm(grads, state.tp)
            metrics["nonfinite"] = 1.0 - torch.isfinite(
                metrics["loss"]).to(torch.float32)
            state.opt.update(grads, metrics["grad_norm"])
            if state.ema_model is not None:
                ema = state.ema_params
                torch._foreach_mul_(ema, t.ema_decay)
                torch._foreach_add_(ema, state.params,
                                    alpha=1.0 - t.ema_decay)
            state.step += 1
        return state, metrics

    return train_step


def make_train_step(cfg: Config, model: PianoRollVAE,
                    use_pallas: Optional[bool] = None,
                    mesh: Optional[DataMesh] = None) -> Callable:
    """(state, batch, eps=None, shifts=None) → (state, metrics), with
    batch {"x": [B,N,T,P] uint8 or float} and, for cond, "chord" [B,N]
    and "key_sig" [B]; ``eps`` the noise of each latent level
    (``vae.eps_shapes``), ``shifts`` [B] the transpose shifts. Under a
    ``mesh`` the batch is this process's rows (``_train_step_body``)."""
    return _train_step_body(cfg, model, use_pallas, mesh)


def make_train_step_multi(cfg: Config, model: PianoRollVAE,
                          use_pallas: Optional[bool] = None,
                          packed_x: bool = False,
                          mesh: Optional[DataMesh] = None) -> Callable:
    """K steps over stacked host batches per call: (state, stacked,
    eps=None, shifts=None) → (state, last step's metrics as device
    tensors), every entry of ``stacked`` with a leading [K] axis; ``eps``
    [K, ...] a latent level, ``shifts`` [K,B]. The body is exactly the
    single-step update over static inputs: before each step, enqueued
    device copies put row j of each entry (and of ``eps`` and ``shifts``
    when given) into them, with no host synchronisation in between.

    ``packed_x``: the batch carries the rolls bit-packed under "x_packed"
    (uint8 [K,B,N,T,P/8], ops/pack.py), and each step unpacks its row on
    the device to the uint8 rolls the resident path gathers: 8x fewer
    bytes over the host link than uint8 rolls, 32x fewer than f32 (the
    streaming path).

    On a CUDA device, with no process group and outside
    ``utils/debug.py`` ``debug_mode``, the step runs as one captured CUDA
    graph, as ``make_train_step_indexed_multi``'s does: the first step
    eagerly, the second captured, each step after as a replay, bit for
    bit an eager step; kept for the state and the shapes and dtypes of a
    row of each per-step input. The stack's own tensors (made afresh for
    each stack by the streaming producer) are read only by the row
    copies, on the current stream; the graph reads its buffers. Not for
    two threads at once."""
    single = _train_step_body(cfg, model, use_pallas, mesh)
    graphable = not (mesh is not None and mesh.group)
    programs: Dict[tuple, _RowStep] = {}

    def body(state):
        def step(rows, eps, shifts):
            batch = dict(rows)
            if packed_x:
                batch["x"] = unpack_bits(batch.pop("x_packed"), torch.uint8)
            return single(state, batch, eps, shifts)[1]
        return step

    def multi(state, stacked, eps=None, shifts=None):
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        key = _dispatch_key(state, {}, stacked, eps, shifts)
        return state, _dispatch(programs, key, lambda: _RowStep(
            body(state), state, stacked, eps, shifts, graphable),
            stacked, eps, shifts)

    multi.programs = programs
    return multi


def _make_window_gather(cfg: Config) -> Callable:
    """(device data, [B] window ids) → batch dict, all on the device: the
    bar cache stays resident as uint8 with int32 window starts, and the
    gathered batch stays uint8 (the model's first conv casts to its
    compute dtype and the loss reads uint8). With the window labels
    resident too ("chords", "keys"), the batch carries "chord" (the
    window's class over its N bars) and "key_sig"."""
    nb = cfg.model.num_bars

    def gather(data: Dict[str, torch.Tensor], idx: torch.Tensor):
        starts = data["starts"].index_select(0, idx)
        bar_idx = starts[:, None] + torch.arange(nb, dtype=starts.dtype,
                                                 device=starts.device)
        bars = data["bars"]
        x = bars.index_select(0, bar_idx.reshape(-1))
        batch = {"x": x.reshape(idx.shape[0], nb, *bars.shape[1:])}
        if "chords" in data:
            batch["chord"] = data["chords"].index_select(0, idx)[:, None] \
                .expand(-1, nb)
            batch["key_sig"] = data["keys"].index_select(0, idx)
        return batch

    return gather


def make_train_step_indexed(cfg: Config, model: PianoRollVAE,
                            use_pallas: Optional[bool] = None,
                            mesh: Optional[DataMesh] = None) -> Callable:
    """Train step over a device-resident dataset: (state, data, idx,
    eps=None, shifts=None) → (state, metrics). ``data`` holds the corpus's
    bars (uint8 [T,96,128]) and window ``starts`` (int32) on the device,
    and for cond the window labels ``chords`` and ``keys``; ``idx`` is a
    [B] int32 window-id vector, the only per-step transfer. Under a
    ``mesh``, ``idx`` names this process's rows of the global batch, in
    its own ``data`` (the whole corpus, or its shard's block under the
    sharded layout)."""
    single = _train_step_body(cfg, model, use_pallas, mesh)
    gather = _make_window_gather(cfg)

    def step(state, data, idx, eps=None, shifts=None):
        return single(state, gather(data, idx), eps, shifts)

    return step


def make_train_step_indexed_multi(cfg: Config, model: PianoRollVAE,
                                  use_pallas: Optional[bool] = None,
                                  mesh: Optional[DataMesh] = None
                                  ) -> Callable:
    """K device-resident indexed steps per call: (state, data, idxs [K,B],
    eps=None, shifts=None [K,B]) → (state, last step's metrics as device
    tensors); ``eps`` is [K,B,z], or a tuple of one [K, ...] tensor a
    latent level (hier: [K,B,z_phrase] and [K,B,N,z]). The body is
    exactly the single-step update (``make_train_step_indexed``) over
    static inputs: before each step, enqueued device copies put row j of
    ``idxs`` (and of ``eps`` and ``shifts`` when given) into them, with
    no host synchronisation in between, so the host enqueues ahead of the
    card.

    On a CUDA device, with no process group (``mesh`` None or without
    one) and outside ``utils/debug.py`` ``debug_mode``, the step runs as
    one captured CUDA graph (utils/graphs.py ``Program``): the first step
    eagerly, the second captured, and each step after as a replay, the
    counterpart of the JAX package's jit over ``lax.scan``; a graph's
    step, transpose shifts and normals (from ``state.generator``) are an
    eager step's, bit for bit. The graph is kept with this function for
    the state, the resident ``data`` tensors and the argument shapes it
    was captured for, as jit keeps a program a signature; other ones
    capture anew. Under a process group (the step's collectives) and in
    ``debug_mode`` every step is eager. Not for two threads at once."""
    single = make_train_step_indexed(cfg, model, use_pallas, mesh)
    graphable = not (mesh is not None and mesh.group)
    programs: Dict[tuple, _RowStep] = {}

    def multi(state, data, idxs, eps=None, shifts=None):
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        rows = {"idx": idxs}
        key = _dispatch_key(state, data, rows, eps, shifts)
        return state, _dispatch(programs, key, lambda: _RowStep(
            lambda r, e, s: single(state, data, r["idx"], e, s)[1],
            state, rows, eps, shifts, graphable), rows, eps, shifts)

    multi.programs = programs
    return multi


def _dispatch_key(state: TrainState, data: dict, rows: dict, eps,
                  shifts) -> tuple:
    """What a captured step is bound to: the state (its tensors and
    generator, the optimizer's settings), the resident data tensors, and
    the shapes and dtypes of a row of each per-step input."""
    def row(t):
        return None if t is None else (tuple(t.shape[1:]), t.dtype)

    opt = state.opt
    held = [*state.params, *opt.mu, *opt.nu, opt.count, state.step,
            *state.model.buffers(), *(state.ema_params or ())]
    return (id(state), id(state.generator),
            tuple(t.data_ptr() for t in held),
            (opt.b1, opt.b2, opt.weight_decay, opt.clip, opt.lr,
             opt.mu_dtype),
            tuple((k, v.data_ptr(), tuple(v.shape), v.dtype)
                  for k, v in sorted(data.items())),
            tuple((k, row(v)) for k, v in sorted(rows.items())),
            None if eps is None else tuple(map(row, eps)), row(shifts))


def _dispatch(programs: dict, key: tuple, make: Callable, rows: dict, eps,
              shifts) -> Dict[str, torch.Tensor]:
    """A dispatch's steps through the program of its ``key`` (made by
    ``make``; one signature's program at a time): the last step's
    metrics, copied (a replay's metrics are the graph's tensors, which
    the next dispatch overwrites)."""
    step = programs.get(key)
    if step is None:
        programs.clear()
        step = programs[key] = make()
    metrics: Dict[str, torch.Tensor] = {}
    for j in range(next(iter(rows.values())).shape[0]):
        metrics = step(j, rows, eps, shifts)
    return {k: v.clone() for k, v in metrics.items()}


class _RowStep:
    """One dispatch signature's static inputs, a row of each per-step
    input (``rows`` by name, each latent level's noise, the shifts), and
    the step that reads them, a ``graphs.Program``: a call copies row j
    of each into its buffer (enqueued device copies) and runs
    ``body(row buffers, noise buffers, shifts buffer)``. It keeps the
    state."""

    def __init__(self, body: Callable, state: TrainState, rows: dict, eps,
                 shifts, graphable: bool):
        dev = state.step.device
        self.state = state

        def buffer(t):
            return torch.empty(t.shape[1:], dtype=t.dtype, device=dev)

        self.rows = {k: buffer(v) for k, v in rows.items()}
        self.eps = None if eps is None else tuple(map(buffer, eps))
        self.shifts = None if shifts is None else buffer(shifts)
        self.program = graphs.Program(
            lambda: body(self.rows, self.eps, self.shifts), dev,
            (state.generator,), graphable)

    def __call__(self, j: int, rows: dict, eps,
                 shifts) -> Dict[str, torch.Tensor]:
        for k, buf in self.rows.items():
            buf.copy_(rows[k][j])
        if eps is not None:
            for buf, e in zip(self.eps, eps):
                buf.copy_(e[j])
        if shifts is not None:
            self.shifts.copy_(shifts[j])
        return self.program()


def pick_k(cfg: Config, do_eval: bool) -> int:
    """Steps per dispatch: the largest divisor of the log/ckpt/eval cadence
    gcd, capped at 100. k divides every cadence, so once the step counter
    is k-aligned (``dispatch_sizes``) every absolute boundary lands on a
    dispatch edge. Cadences <= 0 mean "off" and don't constrain k; with
    every cadence off k is the cap."""
    cadences = [c for c in (cfg.train.log_every, cfg.train.ckpt_every) +
                ((cfg.train.eval_every,) if do_eval else ()) if c > 0]
    if not cadences:
        return 100
    g = math.gcd(*cadences) if len(cadences) > 1 else cadences[0]
    return max(d for d in range(1, min(g, 100) + 1) if g % d == 0)


def dispatch_sizes(start: int, total: int, k: int) -> list:
    """Per-dispatch step counts covering [start, total): an alignment
    dispatch up to the next multiple of k, the steady-state k, and a final
    partial dispatch. Every multiple of k inside the range is visited, so
    absolute log/eval boundaries (which k divides) are never skipped."""
    sizes = []
    s = start
    while s < total:
        ki = min(k - s % k, total - s)
        sizes.append(ki)
        s += ki
    return sizes


def make_id_schedule(seed: int, n: int, b: int) -> Callable[[int], np.ndarray]:
    """Stateless per-step window-id schedule: step -> [b] int32 ids, a pure
    function of (seed, step), so a run restarted at step S draws the ids a
    continuous run would at S. Epoch e uses the permutation seeded by
    (seed, 0, e), consumed b ids per step with the (< b) remainder dropped;
    corpora smaller than one batch sample with replacement per step (seeded
    (seed, 1, step)). The same draws as the JAX package's."""
    bpe = n // b          # batches (= steps) per epoch; 0 when n < b
    cache: Dict[str, Any] = {}

    def ids_for_step(step: int) -> np.ndarray:
        if bpe == 0:
            return np.random.default_rng((seed, 1, step)).integers(
                0, n, size=b).astype(np.int32)
        epoch, pos = divmod(step, bpe)
        if cache.get("epoch") != epoch:
            cache["epoch"] = epoch
            cache["perm"] = np.random.default_rng(
                (seed, 0, epoch)).permutation(n).astype(np.int32)
        return cache["perm"][pos * b:(pos + 1) * b]

    return ids_for_step


# -- the host loop -----------------------------------------------------------------

@contextlib.contextmanager
def deterministic_algorithms():
    """Bit-reproducible training inside the block: deterministic PyTorch
    and cuDNN algorithms, no autotuning. Uninitialized memory is left
    unfilled (every kernel here writes all of its output). The previous
    settings come back on exit."""
    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2], prev[3]
        torch.utils.deterministic.fill_uninitialized_memory = prev[4]


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload without making the host wait for the card's queued work."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _write_json_atomic(path: str, obj) -> None:
    """Crash-safe JSON write: tmp + fsync + os.replace, so a reader never
    sees a truncated file (the best-metric sidecar guards exactly the
    crash-mid-write window)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _StackUploader:
    """Host stacks to the device for the streaming producer. On a CUDA
    device each array is staged in a pinned host buffer, reused (two a
    key, in turn; a buffer is refilled only after its last copy's event
    has completed), and copied ``non_blocking`` on a side stream, and the
    stack comes with an event recorded after its copies, which the
    compute stream waits on before the stack's first step. On the CPU
    the arrays become tensors as they are."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self._buffers: Dict[Tuple[str, int], Tuple[torch.Tensor,
                                                       Any]] = {}
            self._turn = 0

    def put(self, arrays: Dict[str, np.ndarray]):
        """(dict of device tensors, the copies' event or None)."""
        if not self.cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in arrays.items()}, None
        turn, self._turn = self._turn, 1 - self._turn
        out, pinned = {}, {}
        with torch.cuda.stream(self.stream):
            for k, v in arrays.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf, done = self._buffers.get((k, turn), (None, None))
                if done is not None:
                    done.synchronize()
                if buf is None or buf.shape != src.shape:
                    buf = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                buf.copy_(src)
                out[k] = torch.empty(src.shape, dtype=src.dtype,
                                     device=self.device)
                out[k].copy_(buf, non_blocking=True)
                pinned[k] = buf
            event = torch.cuda.Event()
            event.record(self.stream)
        for k, buf in pinned.items():
            self._buffers[(k, turn)] = (buf, event)
        return out, event


def _stack_host_batches(host: List[Dict[str, np.ndarray]], cond: bool):
    """K host batches → the stacked arrays a packed streaming step reads:
    "x_packed" [K,B,N,T,P/8] (binary rolls, else a ValueError: packing
    would collapse other values) and, for cond, "chord" and "key_sig"."""
    xv = np.stack([h["x"] for h in host])
    if not ((xv == 0) | (xv == 1)).all():
        raise ValueError("streaming batches must carry binary rolls "
                         "(x ∈ {0,1}); got non-binary values, which "
                         "bit-packing would corrupt")
    stacked = {"x_packed": pack_bits_np(xv)}
    if cond:
        for k in ("chord", "key_sig"):
            stacked[k] = np.stack([np.asarray(h[k], np.int32) for h in host])
    return stacked


def _start_producer(data, sizes, cfg: Config, mesh: DataMesh,
                    num_steps: int, uploader: _StackUploader):
    """The streaming path's producer thread ("mvae-prefetch"): for each
    dispatch it stacks K host batches from ``data``, packs them, keeps
    this process's rows (unless the iterator already yields only those,
    ``HostLocalBatches``) and uploads them while the device runs the
    dispatch before. Returns (queue, quit event): the queue holds two
    stacks at most; before the first stack of a multi-process run comes
    a ("check_hosts", what, chunks) item for the loop's collective check;
    any failure is put on the queue for the loop to raise. Setting the
    quit event ends the thread within 0.2 s of a full queue."""
    batch_q: "queue.Queue" = queue.Queue(maxsize=2)
    producer_quit = threading.Event()
    host_local = isinstance(data, HostLocalBatches)
    cond = cfg.model.kind == "cond"
    b = cfg.train.batch_size

    class _Quit(Exception):
        pass

    def _qput(item):
        # a bounded wait that notices the loop has gone
        while not producer_quit.is_set():
            try:
                batch_q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue
        raise _Quit

    def _producer():
        try:
            for di, ki in enumerate(sizes):
                stacked = _stack_host_batches(
                    [next(data) for _ in range(ki)], cond)
                local = stacked["x_packed"].shape[1]
                if di == 0:
                    if host_local and local * mesh.data != b:
                        raise ValueError(
                            "host-local streaming batches must carry "
                            f"batch_size/process_count = {b}/{mesh.data} "
                            f"rows each; got {local}")
                    if mesh.processes > 1:
                        # replicated: every process's stack is the same
                        # (its content hashed); host-local: only the
                        # structure must agree
                        chunks = ([repr(sorted(
                            (k, v.shape, str(v.dtype))
                            for k, v in stacked.items())).encode()]
                            if host_local else
                            [np.ascontiguousarray(v).tobytes()
                             for _, v in sorted(stacked.items())])
                        _qput(("check_hosts",
                               "streaming first-batch structure"
                               if host_local else "streaming first batch",
                               chunks))
                if not host_local and mesh.data > 1:
                    stacked = {k: np.ascontiguousarray(
                        shard_batch(v, mesh, axis=1))
                        for k, v in stacked.items()}
                _qput(("stack",) + uploader.put(stacked))
        except _Quit:
            return
        except StopIteration:
            try:
                _qput(RuntimeError(
                    f"streaming data iterator exhausted before "
                    f"{num_steps} steps; supply an infinite iterator or "
                    f"fewer num_steps"))
            except _Quit:
                return
        except BaseException as e:          # noqa: BLE001: raised by the loop
            try:
                _qput(e)
            except _Quit:
                return

    threading.Thread(target=_producer, daemon=True,
                     name="mvae-prefetch").start()
    return batch_q, producer_quit


def _next_stack(batch_q: "queue.Queue", device: torch.device):
    """The next streamed stack, ready for the compute stream: a failure of
    the producer is raised here, a cross-process check item is run (a
    collective), and on a CUDA device the compute stream waits for the
    stack's copies and the allocator learns that it reads them."""
    item = batch_q.get()
    if isinstance(item, BaseException):
        raise item
    if item[0] == "check_hosts":
        distributed.assert_hosts_identical(item[1], *item[2])
        return _next_stack(batch_q, device)
    _, tensors, event = item
    if event is not None:
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in tensors.values():
            t.record_stream(compute)
    return tensors


def _collective_stop(requested: bool, mesh: DataMesh) -> bool:
    """Whether any process of the group was asked to stop: every process
    stops at the same dispatch and enters the save together."""
    if mesh.processes == 1:
        return requested
    dev = distributed.collective_device()
    flag = torch.tensor([int(requested)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _broadcast_float(value: float, mesh: DataMesh) -> float:
    """Process 0's ``value`` on every process."""
    if mesh.processes == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=distributed.collective_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def train(cfg: Config,
          data: Any,
          num_steps: Optional[int] = None,
          mesh: Optional[DataMesh] = None,
          ckpt_manager=None,
          log_fn: Optional[Callable[[int, Dict], None]] = None,
          state: Optional[TrainState] = None,
          eval_data: Any = None,
          best_ckpt_manager=None,
          stop=None,
          device="cuda"):
    """Host-side loop. ``data`` is a ``PianoRollDataset`` (its bars and
    window starts are uploaded to the device once and every batch is
    gathered there by index, ``make_train_step_indexed_multi``; with
    ``cfg.train.corpus_layout="sharded"`` each process uploads only its
    shard's block, train/sharded_corpus.py) or an iterator of host
    batches (the streaming path for corpora larger than device memory,
    ``make_train_step_multi(packed_x=True)`` behind a producer thread; a
    ``data.HostLocalBatches`` iterator yields only this process's rows).

    ``mesh`` (parallel/mesh.py ``make_mesh``, by default from
    ``cfg.mesh`` on ``device``, or the state's device): under a process
    group of P processes each trains on its rows of every global batch
    of ``cfg.train.batch_size`` and the step averages the gradients over
    the group. At start-up the processes check that they hold the same
    resident corpus and seed (or, streaming, the same first stack; only
    its structure under ``HostLocalBatches``).

    ``num_steps`` is the TOTAL step count: a ``state`` that is already at
    step S continues from S and stops at num_steps. With ``state`` the
    run continues on that state's model and device.

    With ``eval_data`` (a held-out PianoRollDataset) and
    cfg.train.eval_every > 0, a deterministic eval sweep over a fixed
    partition runs every eval_every steps, the same on every process, and
    is logged under ``eval_*`` keys (``eval_ema_*`` for the EMA weights
    when they are kept). With ``best_ckpt_manager`` the state with the
    lowest ``eval_loss`` so far is saved there, and that loss is kept
    beside it in ``best_metric.json``, which a resumed run reads (process
    0 reads it and broadcasts it), so its first eval cannot replace a
    better earlier state.

    ``ckpt_manager`` (checkpoints/io.py) receives the state every
    cfg.train.ckpt_every steps, at the end of a dispatch (``pick_k`` makes
    dispatches end on those steps); process 0 writes. ``stop`` (a
    preemption.GracefulStop, or anything with a ``requested`` attribute)
    is read once a dispatch, collectively (all processes stop when any
    was asked to): the loop then saves the exact step it reached into
    ``ckpt_manager`` and returns.

    The run is bit-reproducible (``deterministic_algorithms``).

    Returns (model, final_state, last_metrics); the metrics are device
    tensors."""
    if mesh is None:
        where = device if state is None else next(
            state.model.parameters()).device
        mesh = make_mesh(cfg.mesh, resolve_device(where))
    if state is None:
        model, state = create_state(cfg, device=mesh.device)
    else:
        model = state.model
        state.opt.configure(cfg)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    num_steps = num_steps if num_steps is not None else cfg.train.num_steps
    b = cfg.train.batch_size
    # host mirror of state.step: one read at start-up, none per step
    start_step = int(state.step)

    eval_every = cfg.train.eval_every
    do_eval = (eval_every > 0 and eval_data is not None
               and len(eval_data) > 0)
    if do_eval:
        from musicvae_tpu_torch.utils.metrics import make_eval_fn
        eval_fns = [("eval_", make_eval_fn(cfg, model))]
        if state.ema_model is not None:
            eval_fns.append(("eval_ema_", make_eval_fn(cfg, state.ema_model)))
        eb = min(b, len(eval_data))
        # fixed partition: the same eval windows every sweep
        eval_perm = np.random.default_rng(cfg.train.seed).permutation(
            len(eval_data)).astype(np.int32)
        n_eval_batches = min(cfg.train.eval_batches,
                             max(1, len(eval_data) // eb))

        def run_eval() -> Dict[str, float]:
            # each model's eval is a graph a signature on the card; the
            # noise is drawn outside it, from a generator a batch, and a
            # batch's metrics come back to the host in one read
            names: List[str] = []
            rows = []
            for i in range(n_eval_batches):
                batch = eval_data.batch(eval_perm[i * eb:(i + 1) * eb],
                                        x_dtype=np.uint8)
                xb = _to_device(batch["x"], dev)
                labels = {}
                if cfg.model.kind == "cond":
                    labels = {k: _to_device(batch[k], dev)
                              for k in ("chord", "key_sig")}
                eps = draw_eps(cfg.model, xb.shape[0],
                               torch.Generator(dev).manual_seed(i))
                ms = [(prefix, fn(xb, eps, **labels))
                      for prefix, fn in eval_fns]
                names = [prefix + mk for prefix, m in ms for mk in m]
                rows.append(torch.stack([mv for _, m in ms
                                         for mv in m.values()]).tolist())
            return {mk: sum(col) / len(col)
                    for mk, col in zip(names, zip(*rows))}

        # the best eval loss so far persists beside the best checkpoint;
        # an unreadable sidecar means a fresh best. Process 0's is every
        # process's: they must agree to enter the best save together
        best_eval_loss = float("inf")
        if best_ckpt_manager is not None:
            best_metric_path = os.path.join(best_ckpt_manager.directory,
                                            "best_metric.json")
            try:
                with open(best_metric_path) as f:
                    best_eval_loss = float(json.load(f)["eval_loss"])
            except (OSError, ValueError, KeyError, TypeError):
                pass
            best_eval_loss = _broadcast_float(best_eval_loss, mesh)

    k = pick_k(cfg, do_eval)
    sizes = dispatch_sizes(start_step, num_steps, k)
    resident = hasattr(data, "bars")
    if resident:
        arrays = {"bars": data.bars, "starts": data.starts}
        if cfg.train.corpus_layout == "sharded":
            # each process uploads only its shard's block: 1/P of the
            # corpus a device
            from musicvae_tpu_torch.train.sharded_corpus import (
                build_sharded_arrays, local_block, make_sharded_id_schedule)
            arrays, counts = build_sharded_arrays(data, mesh.data,
                                                  cfg.train.seed)
            arrays = local_block(arrays, mesh.data, mesh.data_rank)
            ids_for_step = make_sharded_id_schedule(cfg.train.seed, counts,
                                                    b)
        elif cfg.train.corpus_layout == "replicated":
            if cfg.model.kind == "cond":
                arrays.update(chords=data.chords, keys=data.keys)
            ids_for_step = make_id_schedule(cfg.train.seed, len(data), b)
        else:
            raise ValueError(f"unknown corpus_layout "
                             f"{cfg.train.corpus_layout!r}; expected "
                             "'replicated' or 'sharded'")
        if cfg.model.kind != "cond":
            arrays = {kk: arrays[kk] for kk in ("bars", "starts")}
        rows = mesh.rows(b)
        # every process must hold the same corpus and seed: it draws the
        # same ids and trains on its rows of them
        distributed.assert_hosts_identical(
            "resident corpus", np.ascontiguousarray(data.bars),
            np.ascontiguousarray(data.starts),
            np.ascontiguousarray(data.chords),
            np.ascontiguousarray(data.keys),
            np.int64(cfg.train.seed).tobytes())
        data_dev = {kk: _to_device(v, dev) for kk, v in arrays.items()}
        multi_fn = make_train_step_indexed_multi(cfg, model, mesh=mesh)
    else:
        multi_fn = make_train_step_multi(cfg, model, packed_x=True,
                                         mesh=mesh)
        batch_q, producer_quit = _start_producer(
            data, sizes, cfg, mesh, num_steps, _StackUploader(dev))

    metrics: Dict[str, torch.Tensor] = {}
    step = start_step
    try:
        with deterministic_algorithms():
            for ki in sizes:
                if resident:
                    idxs = np.stack([ids_for_step(step + j)[rows]
                                     for j in range(ki)])
                    state, metrics = multi_fn(state, data_dev,
                                              _to_device(idxs, dev))
                else:
                    state, metrics = multi_fn(state,
                                              _next_stack(batch_q, dev))
                step += ki
                if (log_fn is not None and cfg.train.log_every > 0
                        and step % cfg.train.log_every == 0):
                    log_fn(step, {mk: float(mv)
                                  for mk, mv in metrics.items()})
                if do_eval and step % eval_every == 0:
                    eval_metrics = run_eval()
                    if log_fn is not None:
                        log_fn(step, eval_metrics)
                    # process 0's loss decides on every process: they
                    # enter the best save (and its barrier) together
                    eval_loss = _broadcast_float(eval_metrics["eval_loss"],
                                                 mesh)
                    if (best_ckpt_manager is not None
                            and eval_loss < best_eval_loss):
                        best_eval_loss = eval_loss
                        ckpt_io.save(best_ckpt_manager, state, cfg)
                        if mesh.rank == 0:
                            os.makedirs(best_ckpt_manager.directory,
                                        exist_ok=True)
                            _write_json_atomic(best_metric_path,
                                               {"eval_loss": best_eval_loss,
                                                "step": step})
                saved = (ckpt_manager is not None
                         and cfg.train.ckpt_every > 0
                         and step % cfg.train.ckpt_every == 0)
                if saved:
                    ckpt_io.save(ckpt_manager, state, cfg)
                if stop is not None and _collective_stop(
                        bool(stop.requested), mesh):
                    if ckpt_manager is not None and not saved:
                        ckpt_io.save(ckpt_manager, state, cfg)
                    break
    finally:
        if not resident:
            # a producer blocked on a full queue sees this within 0.2 s
            producer_quit.set()
    return model, state, metrics
