"""The port's train step against the JAX package's, in three parts, since
Adam's first steps turn any sign flip of a tiny gradient into a visible
parameter difference: (1) the host-side schedules and the optimizer on
injected gradients, (2) one step's gradients against ``jax.grad`` of the
same loss, (3) the metrics of three full steps from the same parameters,
batches and injected noise.

Tiny f32 widths (torch_port_helpers.tiny_pair); the JAX side runs on the
CPU, its Pallas loss kernel in interpret mode where ``use_pallas`` is on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from musicvae_tpu.ops import losses as jlosses
from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.checkpoints.convert import (
    flax_params_to_state_dict, flax_train_state_to_state_dict)
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import bars, jax_params, port_model, tiny_pair


def _with_train(jc, tc, **kw):
    return (jc.replace(train=dataclasses.replace(jc.train, **kw)),
            tc.replace(train=dataclasses.replace(tc.train, **kw)))


# -- (e) host-side schedules ----------------------------------------------------

@pytest.mark.parametrize("seed,n,b", [(0, 100, 8), (3, 64, 64), (5, 7, 16),
                                      (9, 1000, 64)])
def test_id_schedule_equal_to_jax(seed, n, b):
    want = jtrainer.make_id_schedule(seed, n, b)
    got = trainer.make_id_schedule(seed, n, b)
    for step in (0, 1, 2, 11, 12, 13, 40, 41, 1000, 5, 0):   # out of order too
        w, g = want(step), got(step)
        assert g.dtype == np.int32 and g.shape == (b,)
        np.testing.assert_array_equal(g, w)


def test_dispatch_sizes_and_pick_k_equal_to_jax():
    for start in (0, 1, 7, 99, 100, 250):
        for total in (0, 100, 101, 1000):
            for k in (1, 5, 50, 100):
                assert trainer.dispatch_sizes(start, total, k) \
                    == jtrainer.dispatch_sizes(start, total, k)
    for log_every in (0, 1, 5, 100, 150, 250):
        for ckpt_every in (0, 50, 1000):
            for eval_every in (0, 20, 500):
                for do_eval in (False, True):
                    jc, tc = _with_train(*tiny_pair(), log_every=log_every,
                                         ckpt_every=ckpt_every,
                                         eval_every=eval_every)
                    assert trainer.pick_k(tc, do_eval) \
                        == jtrainer.pick_k(jc, do_eval)


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="cosine", num_steps=100, lr_min_ratio=0.1),
    dict(lr_schedule="cosine", num_steps=100, lr_warmup_steps=10,
         lr_min_ratio=0.1),
    dict(lr_schedule="cosine", num_steps=20, lr_warmup_steps=30)])
def test_make_lr_matches_optax(kw):
    jc, tc = _with_train(*tiny_pair(), learning_rate=3e-3, **kw)
    want, got = jtrainer.make_lr(jc), trainer.make_lr(tc)
    if kw["lr_schedule"] == "constant":
        assert got == want == 3e-3
        return
    for count in (0, 1, 5, 9, 10, 11, 29, 30, 31, 50, 99, 100, 101, 5000):
        g = got(torch.tensor(count, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(float(g), float(want(count)), rtol=2e-6,
                                   atol=1e-10)


def test_make_lr_refuses_unknown_schedule():
    _, tc = _with_train(*tiny_pair(), lr_schedule="linear")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        trainer.make_lr(tc)


# -- (f) the optimizer on injected gradients -----------------------------------

def _adam_state(opt_state):
    """The ScaleByAdamState inside a (nested) optax chain state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("name,kw,tol", [
    ("adam", dict(), 1e-7),
    ("adamw", dict(weight_decay=0.01), 1e-7),
    ("clip_triggers", dict(grad_clip_norm=0.5), 1e-7),
    ("clip_idle", dict(grad_clip_norm=1e6), 1e-7),
    ("cosine_warmup", dict(lr_schedule="cosine", lr_warmup_steps=2,
                           num_steps=10, lr_min_ratio=0.1), 1e-7),
    ("adamw_clip_cosine", dict(weight_decay=0.01, grad_clip_norm=0.5,
                               lr_schedule="cosine", lr_warmup_steps=2,
                               num_steps=10), 1e-7),
    # a bf16 first moment: one flipped rounding of mu (4e-3 relative) moves
    # a weight by lr · 4e-3 = 4e-6
    ("mu_bf16", dict(adam_mu_dtype="bfloat16"), 1e-5),
])
def test_optimizer_matches_optax_on_injected_gradients(name, kw, tol):
    jc, tc = _with_train(*tiny_pair(), learning_rate=1e-3, **kw)
    rng = np.random.default_rng(21)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    opt = jtrainer.make_optimizer(jc)
    opt_state = opt.init(jparams)
    tparams = [torch.tensor(params[k]) for k in shapes]
    adam = trainer.make_optimizer(tc, tparams)
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)
                     ).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = opt.update(jax.tree.map(jnp.asarray, grads),
                                        opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        adam.update([torch.tensor(grads[k]) for k in shapes])
        for k, got in zip(shapes, tparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(jparams[k]),
                                       atol=tol, rtol=0,
                                       err_msg=f"{name} step {step} {k}")
    js = _adam_state(opt_state)
    assert int(adam.count) == int(js.count) == 3
    for k, mu, nu in zip(shapes, adam.mu, adam.nu):
        assert str(mu.dtype).endswith(tc.train.adam_mu_dtype)
        np.testing.assert_allclose(mu.float().numpy(),
                                   np.asarray(js.mu[k], np.float32),
                                   atol=1e-7 if tol == 1e-7 else 1e-2)
        np.testing.assert_allclose(nu.numpy(), np.asarray(js.nu[k]),
                                   rtol=1e-6, atol=1e-12)


def test_optimizer_refuses_unknown_moment_dtype():
    _, tc = _with_train(*tiny_pair(), adam_mu_dtype="float16")
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        trainer.make_optimizer(tc, [torch.zeros(2)])


# -- (g) one step's gradients -----------------------------------------------------

def _jax_loss_fn(jc, jmodel, use_pallas, free_bits):
    def loss_fn(params, x, eps, beta):
        logits, latents = jmodel.apply({"params": params}, x, eps=(eps,))
        return jtrainer.elbo_from_outputs(
            jc, logits, x, latents, beta, use_pallas, free_bits=free_bits,
            pallas_dual=True)
    return loss_fn


def _batch(seed, jc, b=3):
    rng = np.random.default_rng(seed)
    x = bars(rng, (b, jc.model.num_bars, 96, 128), 0.08)
    eps = rng.standard_normal((b, jc.model.z_dim)).astype(np.float32)
    return x, eps


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("free_bits", [0.0, 0.02])
def test_step_gradients_match_jax_grad(use_pallas, free_bits):
    """The port's parameter gradients of the train loss against jax.grad
    of the JAX package's loss (its dual Pallas kernel in interpret mode
    when ``use_pallas``), mapped into the port's layout by the linear
    params converter. Per tensor: 2e-4 of its largest entry (f32 sums in
    different orders through five convs and eight GRU steps)."""
    jc, tc = tiny_pair()
    jmodel, params = jax_params(jc, tc, seed=3)
    model = port_model(tc, params)
    x, eps = _batch(31, jc)
    beta = 0.3
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jc, jmodel, use_pallas, free_bits), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(eps), beta)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), tc)

    logits, latents = model(torch.tensor(x), torch.tensor(eps))
    loss, m = trainer.elbo_from_outputs(
        tc, logits, torch.tensor(x), latents, beta, use_pallas,
        free_bits=free_bits, pallas_dual=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["kl"]), float(jm["kl"]), rtol=1e-4)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=n)
    # flax has no r/z hidden biases: the port's stay constant
    h = tc.model.gru_hidden
    for n, g in zip(names, grads):
        if n.endswith("bias_hh"):
            assert float(g[:2 * h].abs().max()) == 0.0


# -- (h) three full steps -------------------------------------------------------------

_STEP_KW = dict(batch_size=3, beta_warmup_steps=4, learning_rate=1e-3)


def _jax_steps(jc, jmodel, params, batches, use_pallas=False):
    """The JAX package's step built from its own pieces (elbo_from_outputs,
    make_optimizer, beta_schedule) with the noise injected: its
    ``make_train_step`` draws eps from a threefry key the port cannot
    reproduce."""
    t = jc.train
    opt = jtrainer.make_optimizer(jc)
    loss_fn = _jax_loss_fn(jc, jmodel, use_pallas, t.free_bits)

    @jax.jit
    def step(params, opt_state, i, x, eps):
        beta = jlosses.beta_schedule(i, t.beta_max, t.beta_warmup_steps,
                                     t.beta_hold_steps, t.beta_schedule,
                                     t.beta_cycle_steps)
        grads, metrics = jax.grad(loss_fn, has_aux=True)(params, x, eps, beta)
        updates, opt_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return optax.apply_updates(params, updates), opt_state, metrics

    opt_state = opt.init(params)
    out = []
    for i, (x, eps) in enumerate(batches):
        params, opt_state, metrics = step(params, opt_state,
                                          jnp.asarray(i, jnp.int32),
                                          jnp.asarray(x), jnp.asarray(eps))
        out.append((jax.tree.map(np.asarray, params), opt_state,
                    {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(free_bits=0.02, grad_clip_norm=1.0, weight_decay=0.01,
         lr_schedule="cosine", lr_warmup_steps=2, num_steps=10)])
def test_three_steps_metrics_match_jax(kw):
    """Per-step loss, recon, kl, beta and grad_norm over three steps, rtol
    1e-4: after Adam's first steps the parameters differ in the last f32
    digits, which the next step's loss sees."""
    jc, tc = _with_train(*tiny_pair(), **_STEP_KW, **kw)
    jmodel, params = jax_params(jc, tc, seed=4)
    batches = [_batch(40 + i, jc) for i in range(3)]
    want = _jax_steps(jc, jmodel, params, batches)
    model = port_model(tc, params)
    state = trainer.init_state(tc, model)
    step = trainer.make_train_step(tc, model)
    for i, (x, eps) in enumerate(batches):
        same, m = step(state, {"x": torch.tensor(x)}, eps=torch.tensor(eps))
        assert same is state and int(state.step) == i + 1
        assert float(m["nonfinite"]) == 0.0
        for k in ("loss", "recon", "kl", "beta", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[i][2][k], rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert want[2][2]["loss"] < want[0][2]["loss"]


def test_step_from_a_converted_mid_run_state_matches_jax():
    """Two JAX steps, then the params and the optax Adam state (mu, nu,
    count) carried into the port's TrainState: the third step's metrics
    agree, so the optimizer state means the same in both packages."""
    jc, tc = _with_train(*tiny_pair(), **_STEP_KW)
    jmodel, params = jax_params(jc, tc, seed=5)
    batches = [_batch(50 + i, jc) for i in range(3)]
    want = _jax_steps(jc, jmodel, params, batches)
    mid_params, mid_opt, _ = want[1]
    adam = _adam_state(mid_opt)
    model = port_model(tc, params)                 # step-0 weights for now
    state = trainer.init_state(tc, model)
    state.load_state_dict(flax_train_state_to_state_dict(
        tc, mid_params, jax.tree.map(np.asarray, adam.mu),
        jax.tree.map(np.asarray, adam.nu), int(adam.count)))
    assert int(state.step) == int(state.opt.count) == 2
    x, eps = batches[2]
    _, m = trainer.make_train_step(tc, model)(
        state, {"x": torch.tensor(x)}, eps=torch.tensor(eps))
    for k in ("loss", "recon", "kl", "beta", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), want[2][2][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    after = flax_params_to_state_dict(want[2][0], tc)
    for n, p in model.named_parameters():
        # one Adam step moves a weight by at most ~lr = 1e-3
        np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(),
                                   atol=2e-5, rtol=0, err_msg=n)


def test_step_transpose_aug_and_uint8_batch():
    """Injected shifts transpose the batch before the forward, as the JAX
    step does; a uint8 batch gives the same metrics as its f32 copy."""
    jc, tc = _with_train(*tiny_pair(), **_STEP_KW, transpose_aug=5)
    jmodel, params = jax_params(jc, tc, seed=6)
    x, eps = _batch(60, jc)
    shifts = np.array([3, -5, 0], np.int32)
    from musicvae_tpu.ops.augment import transpose_rolls
    xs = np.asarray(transpose_rolls(jnp.asarray(x), jnp.asarray(shifts)))
    jc0 = jc.replace(train=dataclasses.replace(jc.train, transpose_aug=0))
    want = _jax_steps(jc0, jmodel, params, [(xs, eps)])[0][2]
    got = []
    for xb in (torch.tensor(x), torch.tensor(x).to(torch.uint8)):
        model = port_model(tc, params)
        state = trainer.init_state(tc, model)
        _, m = trainer.make_train_step(tc, model)(
            state, {"x": xb}, eps=torch.tensor(eps),
            shifts=torch.tensor(shifts))
        got.append({k: float(v) for k, v in m.items()})
    assert got[0] == got[1]
    for k in ("loss", "recon", "kl", "grad_norm"):
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("pallas_conv1", [False, True])
def test_remat_encoder_changes_no_bit(pallas_conv1):
    """TrainSpec.remat_encoder recomputes the encoder's bar features in
    the backward pass: the same metrics and the same updated parameters,
    bit for bit, with the stock first conv and through the first-conv
    Function."""
    out = []
    for remat in (False, True):
        jc, tc = _with_train(*tiny_pair(use_pallas_conv1=pallas_conv1),
                             **_STEP_KW, remat_encoder=remat)
        _, params = jax_params(jc, tc, seed=8)
        model = port_model(tc, params)
        assert model.remat_encoder == remat
        state = trainer.init_state(tc, model)
        x, eps = _batch(80, jc)
        _, m = trainer.make_train_step(tc, model)(
            state, {"x": torch.tensor(x)}, eps=torch.tensor(eps))
        out.append((m, [p.detach().clone() for p in state.params]))
    (m0, p0), (m1, p1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_step_refuses_what_it_does_not_run():
    _, tc = _with_train(*tiny_pair(), remat_encoder=True)
    model = port_model(tiny_pair()[1], jax_params(*tiny_pair(), seed=0)[1])
    with pytest.raises(ValueError, match="remat_encoder"):
        trainer.make_train_step(tc, model)      # built without remat
    _, tc = _with_train(*tiny_pair(), transpose_aug=-1)
    with pytest.raises(ValueError, match="transpose_aug"):
        trainer.make_train_step(tc, model)
    _, tc = tiny_pair()
    other = port_model(tc, jax_params(*tiny_pair(), seed=1)[1])
    with pytest.raises(ValueError, match="another model"):
        trainer.make_train_step(tc, model)(
            trainer.init_state(tc, other),
            {"x": torch.zeros((1, 4, 96, 128))})
