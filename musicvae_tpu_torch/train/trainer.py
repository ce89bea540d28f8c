"""The ELBO train step and the host loop around it.

Counterpart of the JAX package's train/trainer.py, for the resident,
replicated data path: batch → forward (encoder → reparameterize → decoder)
→ masked-BCE + KL-annealed ELBO → backward → Adam, with the β schedule, the
noise, the optional transpose augmentation, the optimizer, ``grad_norm``,
``nonfinite`` and the EMA all inside the step, on the device. The host loop
only draws window ids, dispatches K steps at a time and does the log and
eval I/O.

What differs from the JAX package, and why:

- State is mutable. Parameters live in the ``nn.Module``; a step updates
  them, the optimizer moments, the step counter and the generator in place
  and returns the same ``TrainState``.
- There is no jit: a K-step dispatch is a Python loop of eager steps with
  no host synchronisation inside (no ``.item()``, no host-made tensors).
  Metrics come back as device tensors and are read at log boundaries only.
- Noise comes from the state's ``torch.Generator`` on the device, in a
  fixed order each step: the transpose shifts, then each latent level's
  normals (``vae.draw_eps``: the phrase level, then the bar level, for
  hier). Every step function also takes ``eps`` (and ``shifts``) from the
  caller, which is how the tests feed both packages the same numbers.
- The optimizer is a small Adam over ``torch._foreach`` ops that follows
  optax's arithmetic (``adam``/``adamw``, ``clip_by_global_norm``, the lr
  schedules, ``mu_dtype``), with its count on the device.
  ``torch.optim.Adam`` and ``clip_grad_norm_`` place eps, the clip factor
  and the bias corrections differently.
- ``use_pallas_loss`` takes effect on a CUDA device: the differentiated
  loss then goes through the dual-output BCE kernel (ops/fused_elbo.py).

Checkpoints are checkpoints/io.py's files, and a preemption stop is
train/preemption.py's single-process ``GracefulStop``. Streaming
iterators, a device mesh and the sharded corpus layout are later items of
ROADMAP.md: ``train`` refuses them by name.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.midi.tensorize import pitch_mask
from musicvae_tpu_torch.models.vae import PianoRollVAE, build_model, draw_eps
from musicvae_tpu_torch.ops import augment, fused_elbo, losses

# cuBLAS is reproducible under torch.use_deterministic_algorithms only with
# a fixed workspace, chosen through this variable, which PyTorch reads at
# the process's first CUDA matmul: set here, when training code is first
# imported, unless the caller chose a value
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ADAM_EPS = 1e-8               # optax.adam's default; eps_root is 0


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the PyTorch port yet "
                               f"(ROADMAP.md item {item})")


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


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over the list, a 0-d tensor (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


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
        # moment is kept so), then added in f32
        mu = torch._foreach_mul(grads, 1.0 - self.b1)
        torch._foreach_add_(mu, [m.to(torch.float32) for m in
                                 torch._foreach_mul(self.mu, self.b1)])
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
        if self.mu_dtype == torch.float32:
            self.mu = mu
        else:
            torch._foreach_copy_(self.mu, mu)


def make_optimizer(cfg: Config, params: List[torch.Tensor]) -> Adam:
    return Adam(cfg, params)


# -- train state ---------------------------------------------------------------

class TrainState:
    """Everything a train step reads and updates in place: the model (its
    parameters are the trained weights), the optimizer with its moments
    and count, the step counter (an int32 0-d tensor on the device), the
    device generator the noise comes from, and the EMA copy of the model
    (None when ``TrainSpec.ema_decay`` is 0)."""

    def __init__(self, model: PianoRollVAE, opt: Adam, step: torch.Tensor,
                 generator: torch.Generator,
                 ema_model: Optional[PianoRollVAE] = None):
        self.model, self.opt, self.step = model, opt, step
        self.generator, self.ema_model = generator, ema_model

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
        queued (checkpoints/io.py ``save``)."""
        names = self._names()
        dev = self.step.device
        to = dev if device is None else torch.device(device)

        def copy(t):
            t = t.detach()
            return t.clone() if to == dev else t.to(to, non_blocking=True)

        def named(tensors):
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
        the other."""
        names = self._names()

        def load(dst, src, what):
            if set(src) != set(names):
                raise KeyError(f"{what}: keys differ from the model's "
                               f"parameters: {sorted(set(src) ^ set(names))}")
            for n, d in zip(names, dst):
                d.copy_(torch.as_tensor(src[n]).reshape(d.shape))

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

def elbo_from_outputs(cfg: Config, logits, x, latents, beta,
                      use_pallas: bool = False, free_bits: float = 0.0,
                      pallas_dual: bool = False):
    """recon + beta * (sum of per-level KLs), batch-mean (ops/losses.py).

    With ``use_pallas`` the masked-BCE sum goes through ops/fused_elbo.py
    (the CUDA kernel on the card); ``pallas_dual`` selects the dual-output
    forward, for differentiated graphs. x goes in as it is, uint8 included.

    ``free_bits`` > 0 floors each latent dimension's batch-mean KL in the
    minimized objective; the reported ``kl`` stays the true KL."""
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
        kl_obj = sum(losses.kl_free_bits(mu, lv, free_bits)
                     for mu, lv in latents) / batch
    else:
        kl_obj = kl
    loss = recon + beta * kl_obj
    return loss, {"loss": loss, "recon": recon, "kl": kl, "beta": beta}


def _train_step_body(cfg: Config, model: PianoRollVAE,
                     use_pallas: Optional[bool] = None) -> Callable:
    """The single-step update every step function shares:
    (state, batch, eps=None, shifts=None) → (state, metrics)."""
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

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   eps=None, shifts: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("this step was built for another model than "
                             "the state's")
        x = batch["x"]
        labels = {}
        if cond:
            labels = {"chord": batch["chord"], "key_sig": batch["key_sig"]}
        beta = losses.beta_schedule(state.step, t.beta_max,
                                    t.beta_warmup_steps, t.beta_hold_steps,
                                    t.beta_schedule, t.beta_cycle_steps)
        # the state's generator gives the shifts first, then the noise
        if t.transpose_aug:
            if shifts is None:
                shifts = augment.random_shifts(state.generator, x.shape[0],
                                               t.transpose_aug)
            x = augment.transpose_rolls(x, shifts)
            if cond:
                # the labels transpose with the content
                labels = {"chord": augment.rotate_chord_classes(
                              labels["chord"], shifts[:, None]),
                          "key_sig": augment.rotate_chord_classes(
                              labels["key_sig"], shifts)}
        if eps is None:
            eps = draw_eps(cfg.model, x.shape[0], state.generator)
        logits, latents = model(x, eps, **labels)
        loss, metrics = elbo_from_outputs(cfg, logits, x, latents, beta,
                                          use_pallas, free_bits=t.free_bits,
                                          pallas_dual=True)
        grads = torch.autograd.grad(loss, state.params)
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = global_norm(grads)
            metrics["nonfinite"] = 1.0 - torch.isfinite(loss).to(
                torch.float32)
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
                    use_pallas: Optional[bool] = None) -> Callable:
    """(state, batch, eps=None, shifts=None) → (state, metrics), with
    batch {"x": [B,N,T,P] uint8 or float} and, for cond, "chord" [B,N]
    and "key_sig" [B]; ``eps`` the noise of each latent level
    (``vae.eps_shapes``), ``shifts`` [B] the transpose shifts."""
    return _train_step_body(cfg, model, use_pallas)


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
                            use_pallas: Optional[bool] = None) -> Callable:
    """Train step over a device-resident dataset: (state, data, idx,
    eps=None, shifts=None) → (state, metrics). ``data`` holds the corpus's
    bars (uint8 [T,96,128]) and window ``starts`` (int32) on the device,
    and for cond the window labels ``chords`` and ``keys``; ``idx`` is a
    [B] int32 window-id vector, the only per-step transfer."""
    single = _train_step_body(cfg, model, use_pallas)
    gather = _make_window_gather(cfg)

    def step(state, data, idx, eps=None, shifts=None):
        return single(state, gather(data, idx), eps, shifts)

    return step


def make_train_step_indexed_multi(cfg: Config, model: PianoRollVAE,
                                  use_pallas: Optional[bool] = None
                                  ) -> Callable:
    """K device-resident indexed steps per call: (state, data, idxs [K,B],
    eps=None, shifts=None [K,B]) → (state, last step's metrics as device
    tensors); ``eps`` is [K,B,z], or a tuple of one [K, ...] tensor a
    latent level (hier: [K,B,z_phrase] and [K,B,N,z]). The body is
    exactly the single-step update, run eagerly once per row of ``idxs``
    with no host synchronisation in between: the host enqueues ahead of
    the card."""
    single = make_train_step_indexed(cfg, model, use_pallas)

    def multi(state, data, idxs, eps=None, shifts=None):
        metrics: Dict[str, torch.Tensor] = {}
        if isinstance(eps, torch.Tensor):
            eps = (eps,)
        for j in range(idxs.shape[0]):
            state, metrics = single(
                state, data, idxs[j],
                None if eps is None else tuple(e[j] for e in eps),
                None if shifts is None else shifts[j])
        return state, metrics

    return multi


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


def train(cfg: Config,
          data: Any,
          num_steps: Optional[int] = None,
          mesh=None,
          ckpt_manager=None,
          log_fn: Optional[Callable[[int, Dict], None]] = None,
          state: Optional[TrainState] = None,
          eval_data: Any = None,
          best_ckpt_manager=None,
          stop=None,
          device="cuda"):
    """Host-side loop over a ``PianoRollDataset``: its bars and window
    starts are uploaded to ``device`` once and every batch is gathered
    there by index (``make_train_step_indexed_multi``).

    ``num_steps`` is the TOTAL step count: a ``state`` that is already at
    step S continues from S and stops at num_steps. With ``state`` the
    run continues on that state's model and device.

    With ``eval_data`` (a held-out PianoRollDataset) and
    cfg.train.eval_every > 0, a deterministic eval sweep over a fixed
    partition runs every eval_every steps and is logged under ``eval_*``
    keys (``eval_ema_*`` for the EMA weights when they are kept). With
    ``best_ckpt_manager`` the state with the lowest ``eval_loss`` so far is
    saved there, and that loss is kept beside it in ``best_metric.json``,
    which a resumed run reads, so its first eval cannot replace a better
    earlier state.

    ``ckpt_manager`` (checkpoints/io.py) receives the state every
    cfg.train.ckpt_every steps, at the end of a dispatch (``pick_k`` makes
    dispatches end on those steps). ``stop`` (a preemption.GracefulStop,
    or anything with a ``requested`` attribute) is read once a dispatch:
    when set, the loop saves the exact step it reached into
    ``ckpt_manager`` and returns.

    The run is bit-reproducible (``deterministic_algorithms``). ``mesh``,
    a streaming iterator as ``data`` and ``corpus_layout="sharded"`` are
    not ported yet and raise.

    Returns (model, final_state, last_metrics); the metrics are device
    tensors."""
    if mesh is not None:
        raise _later("training over a device mesh", "A13")
    if not hasattr(data, "bars"):
        raise _later("training from a streaming batch iterator", "A13")
    if cfg.train.corpus_layout != "replicated":
        raise _later(f"corpus_layout={cfg.train.corpus_layout!r}", "A13")

    if state is None:
        model, state = create_state(cfg, device=device)
    else:
        model = state.model
        state.opt.configure(cfg)
    dev = next(model.parameters()).device
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
            acc: Dict[str, list] = {}
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
                for prefix, fn in eval_fns:
                    for mk, mv in fn(xb, eps, **labels).items():
                        acc.setdefault(prefix + mk, []).append(float(mv))
            return {mk: sum(mv) / len(mv) for mk, mv in acc.items()}

        # the best eval loss so far persists beside the best checkpoint;
        # an unreadable sidecar means a fresh best
        best_eval_loss = float("inf")
        if best_ckpt_manager is not None:
            best_metric_path = os.path.join(best_ckpt_manager.directory,
                                            "best_metric.json")
            try:
                with open(best_metric_path) as f:
                    best_eval_loss = float(json.load(f)["eval_loss"])
            except (OSError, ValueError, KeyError, TypeError):
                pass

    k = pick_k(cfg, do_eval)
    sizes = dispatch_sizes(start_step, num_steps, k)
    data_dev = {"bars": _to_device(data.bars, dev),
                "starts": _to_device(data.starts, dev)}
    if cfg.model.kind == "cond":
        data_dev["chords"] = _to_device(data.chords, dev)
        data_dev["keys"] = _to_device(data.keys, dev)
    multi_fn = make_train_step_indexed_multi(cfg, model)
    ids_for_step = make_id_schedule(cfg.train.seed, len(data), b)

    metrics: Dict[str, torch.Tensor] = {}
    step = start_step
    with deterministic_algorithms():
        for ki in sizes:
            idxs = np.stack([ids_for_step(step + j) for j in range(ki)])
            state, metrics = multi_fn(state, data_dev, _to_device(idxs, dev))
            step += ki
            if (log_fn is not None and cfg.train.log_every > 0
                    and step % cfg.train.log_every == 0):
                log_fn(step, {mk: float(mv) for mk, mv in metrics.items()})
            if do_eval and step % eval_every == 0:
                eval_metrics = run_eval()
                if log_fn is not None:
                    log_fn(step, eval_metrics)
                if (best_ckpt_manager is not None
                        and eval_metrics["eval_loss"] < best_eval_loss):
                    best_eval_loss = eval_metrics["eval_loss"]
                    ckpt_io.save(best_ckpt_manager, state, cfg)
                    os.makedirs(best_ckpt_manager.directory, exist_ok=True)
                    _write_json_atomic(best_metric_path,
                                       {"eval_loss": best_eval_loss,
                                        "step": step})
            saved = (ckpt_manager is not None and cfg.train.ckpt_every > 0
                     and step % cfg.train.ckpt_every == 0)
            if saved:
                ckpt_io.save(ckpt_manager, state, cfg)
            if stop is not None and stop.requested:
                if ckpt_manager is not None and not saved:
                    ckpt_io.save(ckpt_manager, state, cfg)
                break
    return model, state, metrics
