"""The port's streaming train path on the CPU at tiny f32 widths: the K-step
function over stacked, bit-packed host batches (train/trainer.py
``make_train_step_multi(packed_x=True)``) against the JAX package's own
``make_train_step_multi(packed_x=True)`` on the same weights, batches and
noise (the JAX side's threefry noise replaced through its "latent" key,
torch_port_helpers.InjectedEps); K streamed steps equal K single steps bit
for bit; and ``train()`` on an iterator passes the producer's failures to
its caller, names an exhausted iterator, refuses rolls that packing would
corrupt, and leaves no producer thread behind after a stop.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.ops.pack import pack_bits_np as jax_pack_bits_np
from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.ops.pack import pack_bits_np
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import (InjectedEps, bar_dataset, bars, jax_params,
                                jax_train_state, latent_keys,
                                one_torch_thread, port_model, same_state,
                                tiny_pair, train_cfg)

assert one_torch_thread   # the fixture applies to this module
K, B = 3, 3


def _stack(seed: int, nb: int):
    """K batches of B binary windows: (rolls [K,B,N,T,P] f32, their
    packing [K,B,N,T,P/8] uint8)."""
    x = bars(np.random.default_rng(seed), (K, B, nb, 96, 128), 0.08)
    packed = pack_bits_np(x)
    np.testing.assert_array_equal(packed, jax_pack_bits_np(x))
    return x, packed


def test_streamed_multi_step_matches_jax():
    """Three packed micro-steps in one call of each package's
    ``make_train_step_multi``: the last step's loss to 1e-5 relative,
    recon, kl and grad_norm to 1e-4, and the parameters to
    test_torch_train_step.py's 2e-5 absolute."""
    jc, tc = tiny_pair()
    kw = dict(batch_size=B, beta_warmup_steps=4, learning_rate=1e-3)
    jc = jc.replace(train=dataclasses.replace(jc.train, **kw))
    tc = tc.replace(train=dataclasses.replace(tc.train, **kw))
    jmodel, params = jax_params(jc, tc, seed=6)
    _, packed = _stack(60, jc.model.num_bars)
    eps = np.random.default_rng(61).standard_normal(
        (K, B, jc.model.z_dim)).astype(np.float32)

    state = jax_train_state(jc, params, seed=2)
    model = InjectedEps(jmodel, latent_keys(state.rng, K), eps)
    jmulti = jtrainer.make_train_step_multi(jc, model, K, packed_x=True)
    state, want = jmulti(state, {"x_packed": jnp.asarray(packed)})
    want_p = flax_params_to_state_dict(jax.tree.map(np.asarray,
                                                    state.params), tc)

    pmodel = port_model(tc, params)
    pstate = trainer.init_state(tc, pmodel)
    multi = trainer.make_train_step_multi(tc, pmodel, packed_x=True)
    _, got = multi(pstate, {"x_packed": torch.from_numpy(packed)},
                   eps=torch.from_numpy(eps))
    assert int(pstate.step) == K
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("recon", "kl", "beta", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for n, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   atol=2e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize("kw", [dict(), dict(transpose_aug=2, ema_decay=0.9,
                                             free_bits=0.02)])
def test_k_streamed_steps_equal_k_single_steps(kw):
    cfg = train_cfg(batch_size=B, **kw)
    x, packed = _stack(70, cfg.model.num_bars)
    _, state_a = trainer.create_state(cfg, device="cpu")
    _, state_b = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_multi(cfg, state_a.model, packed_x=True)
    single = trainer.make_train_step(cfg, state_b.model)
    _, m_multi = multi(state_a, {"x_packed": torch.from_numpy(packed)})
    for j in range(K):
        _, m_single = single(state_b, {"x": torch.from_numpy(
            x[j].astype(np.uint8))})
    assert int(state_a.step) == K and same_state(state_a, state_b)
    assert all(torch.equal(m_multi[k], m_single[k]) for k in m_single)


def _batches(n=None, x=None):
    ds = bar_dataset()
    it = ds.iterator(2, seed=1, x_dtype=np.uint8)
    for i, batch in enumerate(it):
        if n is not None and i == n:
            return
        if x is not None:
            batch = dict(batch, x=x(batch["x"]))
        yield batch


def _failing():
    yield from _batches(2)
    raise ValueError("the corpus reader failed")


@pytest.mark.parametrize("data,err,match", [
    (_failing, ValueError, "the corpus reader failed"),
    (lambda: _batches(3), RuntimeError,
     "streaming data iterator exhausted before 8 steps"),
    (lambda: _batches(x=lambda v: v * 2), ValueError, "binary rolls"),
])
def test_train_on_an_iterator_raises_the_producers_failure(data, err, match):
    with pytest.raises(err, match=match):
        trainer.train(train_cfg(), data(), num_steps=8, device="cpu")
    _no_producer_left()


def _no_producer_left():
    for t in threading.enumerate():
        if t.name == "mvae-prefetch":
            t.join(timeout=5.0)
            assert not t.is_alive(), "a producer thread outlived train()"


def test_a_stop_leaves_no_producer_thread():
    """A stop after the first dispatch: the producer, blocked on a full
    queue of later stacks, ends within its 0.2 s poll."""
    class Stop:
        requested = True

    _, state, metrics = trainer.train(train_cfg(), _batches(), num_steps=40,
                                      stop=Stop(), device="cpu")
    assert int(state.step) == 2 and np.isfinite(float(metrics["loss"]))
    _no_producer_left()
