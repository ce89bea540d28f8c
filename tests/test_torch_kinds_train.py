"""The train step of the conv bar-VAE (C1), the hierarchical VAE (C3)
and the chord/key VAE (C4) against the JAX package's, at tiny f32 widths
and the tolerances of tests/test_torch_train_step.py: one step's
parameter gradients against ``jax.grad`` of the same loss (2e-4 of each
tensor's largest entry), the metrics of three steps (rtol 1e-4). Then
what is particular to these kinds: the window gather's labels, the cond
labels rotating with the transpose augmentation, the 24-class guard, the
per-level noise order of the state's generator, K-step dispatches with
per-level noise, and a hier run resumed from disk bit for bit."""

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
from musicvae_tpu_torch.checkpoints import io
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.models.vae import draw_eps
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import (KINDS, TRAIN_KW, bar_dataset, jax_params,
                                kind_inputs, kind_pair,
                                one_torch_thread,  # noqa: F401
                                port_model, same_state, to_jax, to_torch)

_STEP_KW = dict(batch_size=3, beta_warmup_steps=4, learning_rate=1e-3)


def _with_train(jc, tc, **kw):
    return (jc.replace(train=dataclasses.replace(jc.train, **kw)),
            tc.replace(train=dataclasses.replace(tc.train, **kw)))


def _jax_loss_fn(jc, jmodel, use_pallas, free_bits=0.0):
    def loss_fn(params, x, eps, labels, beta):
        logits, latents = jmodel.apply({"params": params}, x, eps=eps,
                                       **labels)
        return jtrainer.elbo_from_outputs(
            jc, logits, x, latents, beta, use_pallas, free_bits=free_bits,
            pallas_dual=True)
    return loss_fn


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", KINDS)
def test_step_gradients_match_jax_grad(name, use_pallas):
    jc, tc = kind_pair(name)
    jmodel, params = jax_params(jc, tc, seed=3)
    model = port_model(tc, params)
    x, eps, labels = kind_inputs(np.random.default_rng(31), jc.model, 3,
                                 0.08)
    beta = 0.3
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jc, jmodel, use_pallas), has_aux=True))(
        params, jnp.asarray(x), to_jax(eps), to_jax(labels), beta)
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), tc)

    logits, latents = model(torch.tensor(x), to_torch(eps),
                            **to_torch(labels))
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
                                   atol=2e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=n)
        if n.endswith("bias_hh"):    # flax has no r/z hidden biases
            assert float(g[:2 * tc.model.gru_hidden].abs().max()) == 0.0


def _jax_steps(jc, jmodel, params, batches):
    """The JAX package's step from its own pieces with the noise (and,
    rotated or not, the labels) injected, as in test_torch_train_step."""
    t = jc.train
    opt = jtrainer.make_optimizer(jc)
    loss_fn = _jax_loss_fn(jc, jmodel, False, t.free_bits)

    @jax.jit
    def step(params, opt_state, i, x, eps, labels):
        beta = jlosses.beta_schedule(i, t.beta_max, t.beta_warmup_steps,
                                     t.beta_hold_steps, t.beta_schedule,
                                     t.beta_cycle_steps)
        grads, metrics = jax.grad(loss_fn, has_aux=True)(params, x, eps,
                                                         labels, beta)
        updates, opt_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return optax.apply_updates(params, updates), opt_state, metrics

    opt_state = opt.init(params)
    out = []
    for i, (x, eps, labels) in enumerate(batches):
        params, opt_state, metrics = step(
            params, opt_state, jnp.asarray(i, jnp.int32), jnp.asarray(x),
            to_jax(eps), to_jax(labels))
        out.append({k: float(v) for k, v in metrics.items()})
    return out


def _batch(x, labels):
    return {"x": torch.tensor(x), **to_torch(labels)}


@pytest.mark.parametrize("name", KINDS)
def test_three_steps_metrics_match_jax(name):
    jc, tc = _with_train(*kind_pair(name), **_STEP_KW)
    jmodel, params = jax_params(jc, tc, seed=4)
    batches = [kind_inputs(np.random.default_rng(40 + i), jc.model, 3, 0.08)
               for i in range(3)]
    want = _jax_steps(jc, jmodel, params, batches)
    model = port_model(tc, params)
    state = trainer.init_state(tc, model)
    step = trainer.make_train_step(tc, model)
    for i, (x, eps, labels) in enumerate(batches):
        _, m = step(state, _batch(x, labels), eps=to_torch(eps))
        assert float(m["nonfinite"]) == 0.0
        for k in ("loss", "recon", "kl", "beta", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[i][k], rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert want[2]["loss"] < want[0]["loss"]


def test_cond_labels_rotate_with_transpose_aug():
    """Injected shifts transpose the rolls and rotate the chord and key
    classes (root*2 + minor) as the JAX step does: its step on the
    transposed rolls and rotated labels gives the port's metrics."""
    jc, tc = _with_train(*kind_pair("c4_cond"), **_STEP_KW, transpose_aug=5)
    jmodel, params = jax_params(jc, tc, seed=6)
    x, eps, labels = kind_inputs(np.random.default_rng(60), jc.model, 3,
                                 0.08)
    shifts = np.array([3, -5, 0], np.int32)
    xs = np.asarray(jaugment.transpose_rolls(jnp.asarray(x),
                                             jnp.asarray(shifts)))
    rot = {"chord": np.asarray(jaugment.rotate_chord_classes(
               jnp.asarray(labels["chord"]), jnp.asarray(shifts)[:, None])),
           "key_sig": np.asarray(jaugment.rotate_chord_classes(
               jnp.asarray(labels["key_sig"]), jnp.asarray(shifts)))}
    assert not np.array_equal(rot["chord"], labels["chord"])
    jc0 = jc.replace(train=dataclasses.replace(jc.train, transpose_aug=0))
    want = _jax_steps(jc0, jmodel, params, [(xs, eps, rot)])[0]
    model = port_model(tc, params)
    state = trainer.init_state(tc, model)
    _, m = trainer.make_train_step(tc, model)(
        state, _batch(x, labels), eps=to_torch(eps),
        shifts=torch.tensor(shifts))
    for k in ("loss", "recon", "kl", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("classes", [(12, 24), (24, 25)])
def test_transpose_aug_needs_24_classes(classes):
    """Both packages refuse to rotate an unknown label encoding, with the
    same message; without augmentation the classes are free."""
    kw = dict(cond_chord_classes=classes[0], cond_key_classes=classes[1])
    jc, tc = _with_train(*kind_pair("c4_cond", **kw), transpose_aug=2)
    jmodel, _ = jax_params(*kind_pair("c4_cond"))
    with pytest.raises(ValueError) as want:
        jtrainer.make_train_step(jc, jmodel)
    model = port_model(kind_pair("c4_cond", **kw)[1],
                       jax_params(*kind_pair("c4_cond", **kw))[1])
    with pytest.raises(ValueError) as got:
        trainer.make_train_step(tc, model)
    assert str(got.value) == str(want.value)
    assert "24-class" in str(got.value)
    tc0 = tc.replace(train=dataclasses.replace(tc.train, transpose_aug=0))
    trainer.make_train_step(tc0, model)


@pytest.mark.parametrize("name", KINDS)
def test_window_gather_labels_match_jax(name):
    """The resident gather of both packages: the same bars and, for cond,
    the window's chord over its N bars and its key."""
    jc, tc = kind_pair(name)
    ds = bar_dataset(seed=2, num_bars=tc.model.num_bars)
    data = {"bars": ds.bars, "starts": ds.starts}
    if name == "c4_cond":
        data.update(chords=ds.chords, keys=ds.keys)
    idx = np.array([4, 0, 9, 4], np.int32)
    want = jtrainer._make_window_gather(jc)(to_jax(data), jnp.asarray(idx))
    got = trainer._make_window_gather(tc)(to_torch(data), torch.tensor(idx))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _cfg(name, **train_kw):
    _, tc = kind_pair(name)
    return tc.replace(train=dataclasses.replace(
        tc.train, **{**TRAIN_KW, **train_kw}))


@pytest.mark.parametrize("name", KINDS)
def test_generator_draws_shifts_then_each_level(name):
    """With no noise handed in, a step draws from the state's generator
    the transpose shifts, then the phrase level's normals, then the bar
    level's: a twin state handed those draws ends in the same bits."""
    cfg = _cfg(name, transpose_aug=3)
    ds = bar_dataset(seed=1, num_bars=cfg.model.num_bars)
    data = {"bars": torch.tensor(ds.bars), "starts": torch.tensor(ds.starts),
            "chords": torch.tensor(ds.chords), "keys": torch.tensor(ds.keys)}
    idx = torch.tensor([1, 5], dtype=torch.int32)
    states = [trainer.create_state(cfg, device="cpu", seed=9)[1]
              for _ in range(2)]
    twin = torch.Generator()
    twin.set_state(states[1].generator.get_state())
    shifts = torch.randint(-3, 4, (2,), generator=twin)
    eps = draw_eps(cfg.model, 2, twin)
    trainer.make_train_step_indexed(cfg, states[0].model)(
        states[0], data, idx)
    trainer.make_train_step_indexed(cfg, states[1].model)(
        states[1], data, idx, eps=eps, shifts=shifts)
    states[1].generator.set_state(twin.get_state())
    assert same_state(*states)


def test_multi_step_takes_per_level_noise():
    """make_train_step_indexed_multi with hier's per-level noise
    ([K,B,z_phrase], [K,B,N,z]) equals K single steps given each row."""
    cfg = _cfg("c3_hier_16bar")
    ds = bar_dataset(seed=3, num_bars=cfg.model.num_bars)
    data = {"bars": torch.tensor(ds.bars), "starts": torch.tensor(ds.starts)}
    idxs = torch.tensor([[0, 3], [2, 7], [5, 1]], dtype=torch.int32)
    g = torch.Generator().manual_seed(4)
    per_step = [draw_eps(cfg.model, 2, g) for _ in range(3)]
    stacked = tuple(torch.stack(level) for level in zip(*per_step))
    assert stacked[0].shape == (3, 2, cfg.model.z_phrase_dim)
    assert stacked[1].shape == (3, 2, cfg.model.num_bars, cfg.model.z_dim)
    a = trainer.create_state(cfg, device="cpu", seed=5)[1]
    b = trainer.create_state(cfg, device="cpu", seed=5)[1]
    _, ma = trainer.make_train_step_indexed_multi(cfg, a.model)(
        a, data, idxs, eps=stacked)
    single = trainer.make_train_step_indexed(cfg, b.model)
    for j in range(3):
        _, mb = single(b, data, idxs[j], eps=per_step[j])
    assert same_state(a, b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("name", ["c3_hier_16bar", "c4_cond"])
def test_resume_from_disk_is_bit_exact(tmp_path, name):
    """4 steps saving every 2, with an eval every 2 and the transpose
    augmentation on, equal 2 steps, a restore of step 2 from disk into a
    state of other weights and generator, and 2 more steps."""
    cfg = _cfg(name, ckpt_every=2, eval_every=2, eval_batches=1,
               transpose_aug=2, ema_decay=0.9)
    train_ds, eval_ds = bar_dataset(num_bars=cfg.model.num_bars).split(
        0.34, seed=cfg.train.seed)
    mgr = io.make_manager(str(tmp_path / "ckpt"))
    logged_a, logged_b = [], []
    _, state_a, last_a = trainer.train(
        cfg, train_ds, num_steps=4, ckpt_manager=mgr, device="cpu",
        eval_data=eval_ds, log_fn=lambda s, m: logged_a.append((s, m)))
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 4]
    assert any("eval_ema_loss" in m for _, m in logged_a)
    _, state_b = trainer.create_state(cfg, device="cpu", seed=77)
    state_b, cfg_b = io.restore(io.make_manager(mgr.directory), state_b,
                                step=2)
    assert int(state_b.step) == 2 and cfg_b == cfg
    _, state_b, last_b = trainer.train(
        cfg_b, train_ds, num_steps=4, state=state_b, eval_data=eval_ds,
        log_fn=lambda s, m: logged_b.append((s, m)))
    assert same_state(state_a, state_b)
    assert all(torch.equal(last_a[k], last_b[k]) for k in last_a)
    assert logged_b == logged_a[-2:]
