"""The train step of the patch-stem and attention models against the JAX
package's, at tiny f32 widths on weights that the JAX package initialised
and the port's converter carried: one step's parameter gradients against
``jax.grad`` of the same loss, then the metrics of three steps under
c2_trf's and c3_trf's registered TrainSpecs (grad clip 1.0, lr warmup
then cosine, free bits, transpose augmentation with the shifts handed to
both packages), at the registered schedule and at one squeezed into the
three steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from musicvae_tpu.ops import augment as jaugment
from musicvae_tpu.ops import losses as jlosses
from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import (jax_init_params, jax_port_model,
                                kind_inputs, one_torch_thread,  # noqa: F401
                                patch_pair, to_jax, to_torch)

GRAD_CASES = {"c2_trf": {}, "c3_trf": {}, "c2_mxu": {}}


def _with_train(jc, tc, **kw):
    return (jc.replace(train=dataclasses.replace(jc.train, **kw)),
            tc.replace(train=dataclasses.replace(tc.train, **kw)))


def _jax_loss_fn(jc, jmodel, use_pallas, free_bits=0.0):
    def loss_fn(params, x, eps, beta):
        logits, latents = jmodel.apply({"params": params}, x, eps=eps)
        return jtrainer.elbo_from_outputs(
            jc, logits, x, latents, beta, use_pallas, free_bits=free_bits,
            pallas_dual=True)
    return loss_fn


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_step_gradients_match_jax_grad(name, use_pallas):
    """Every parameter's gradient within 1e-6 of ``jax.grad``'s plus 1e-5
    of that tensor's largest entry: the loss is a sum over every cell of
    the window, so its gradients run to tens, and f32 sums in another
    order leave a few entries up to 2.5e-6 apart."""
    jc, tc = patch_pair(name)
    jmodel, params = jax_init_params(jc, seed=3)
    model = jax_port_model(tc, params)
    x, eps, _ = kind_inputs(np.random.default_rng(31), jc.model, 3, 0.08)
    beta = 0.3
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jc, jmodel, use_pallas), has_aux=True))(
        params, jnp.asarray(x), to_jax(eps), beta)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), tc)

    logits, latents = model(torch.tensor(x), to_torch(eps))
    loss, m = trainer.elbo_from_outputs(
        tc, logits, torch.tensor(x), latents, beta, use_pallas,
        pallas_dual=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["kl"].detach()), float(jm["kl"]),
                               rtol=1e-4)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 + 1e-5 * np.abs(w).max(),
                                   err_msg=n)


def _jax_steps(jc, jmodel, params, batches):
    """The JAX package's step from its own pieces, the noise injected and
    the rolls transposed beforehand (its augmentation is off)."""
    t = jc.train
    opt = jtrainer.make_optimizer(jc)
    loss_fn = _jax_loss_fn(jc, jmodel, False, t.free_bits)

    @jax.jit
    def step(params, opt_state, i, x, eps):
        beta = jlosses.beta_schedule(i, t.beta_max, t.beta_warmup_steps,
                                     t.beta_hold_steps, t.beta_schedule,
                                     t.beta_cycle_steps)
        grads, metrics = jax.grad(loss_fn, has_aux=True)(params, x, eps,
                                                         beta)
        updates, opt_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return optax.apply_updates(params, updates), opt_state, metrics

    opt_state = opt.init(params)
    out = []
    for i, (x, eps) in enumerate(batches):
        params, opt_state, metrics = step(
            params, opt_state, jnp.asarray(i, jnp.int32), jnp.asarray(x),
            to_jax(eps))
        out.append({k: float(v) for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("schedule", ["registered", "squeezed"])
@pytest.mark.parametrize("name", ["c2_trf", "c3_trf"])
def test_three_steps_metrics_match_jax(name, schedule):
    """Three steps at batch 3 under the registered TrainSpec (its warmup
    of 1,000 steps keeps the lr near 0), and under the same spec with the
    lr warmup, cosine and KL ramp squeezed into 4 steps, so that the
    clip, the schedule and the free-bits floor all act: loss, recon, KL,
    beta and the pre-clip grad norm within 1e-4."""
    kw = dict(batch_size=3)
    if schedule == "squeezed":
        kw.update(num_steps=4, lr_warmup_steps=1, beta_warmup_steps=2,
                  learning_rate=3e-3)
    jc, tc = _with_train(*patch_pair(name), **kw)
    assert tc.train.grad_clip_norm == 1.0 and tc.train.free_bits > 0
    assert tc.train.lr_schedule == "cosine" and tc.train.transpose_aug == 5
    jmodel, params = jax_init_params(jc, seed=4)
    shifts = [np.array(s, np.int32) for s in ([3, -5, 0], [1, 4, -2],
                                               [-1, 0, 5])]
    batches = [kind_inputs(np.random.default_rng(40 + i), jc.model, 3, 0.08)
               for i in range(3)]
    moved = [(np.asarray(jaugment.transpose_rolls(jnp.asarray(x),
                                                  jnp.asarray(s))), eps)
             for (x, eps, _), s in zip(batches, shifts)]
    jc0 = jc.replace(train=dataclasses.replace(jc.train, transpose_aug=0))
    want = _jax_steps(jc0, jmodel, params, moved)
    model = jax_port_model(tc, params)
    state = trainer.init_state(tc, model)
    step = trainer.make_train_step(tc, model)
    for i, ((x, eps, _), s) in enumerate(zip(batches, shifts)):
        _, m = step(state, {"x": torch.tensor(x)}, eps=to_torch(eps),
                    shifts=torch.tensor(s))
        assert float(m["nonfinite"]) == 0.0
        for k in ("loss", "recon", "kl", "beta", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[i][k], rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    if schedule == "squeezed":
        assert want[2]["loss"] < want[0]["loss"]
