"""The port's compiled streamed train dispatch (train/trainer.py
``make_train_step_multi``: a static-input step over one row of the
uploaded stack, a captured CUDA graph on the card) on the CPU at tiny f32
widths, where the same step runs eagerly over the same buffers:

- (a) a streamed dispatch of each model family reads nothing back to the
  host and makes no tensor from host data, which capture requires;
- (b) streamed dispatches of uneven sizes equal the same steps taken one
  by one with ``make_train_step`` on the unpacked rolls, bit for bit, the
  generator's state included, whether the noise and shifts are drawn or
  handed in, each dispatch on a stack of its own;
- (c) one program a signature (the state, a row's shapes and dtypes);
- (d) the dispatches equal the JAX package's jitted
  ``make_train_step_multi(packed_x=True)`` at the train-step tolerances
  of tests/test_torch_stream_train.py.

Graph against eager on the card is ``chip_smoke.py``'s train phase.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.models.vae import eps_shapes
from musicvae_tpu_torch.ops.pack import unpack_bits_np
from musicvae_tpu_torch.train import trainer
from torch_port_helpers import (FAMILIES, InjectedEps, bar_dataset,
                                family_config, jax_params, jax_train_state,
                                latent_keys, no_host_reads,
                                one_torch_thread,  # noqa: F401
                                port_model, same_state, tiny_pair)


def _stack(cfg, ds, start: int, k: int):
    """K host batches from ``start`` on, as the streaming producer stacks
    them: ({"x_packed" [K,B,N,T,P/8] and, for cond, "chord", "key_sig"}
    as tensors, the host batches)."""
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds),
                                   cfg.train.batch_size)
    host = [ds.batch(ids(start + j), x_dtype=np.uint8) for j in range(k)]
    stacked = trainer._stack_host_batches(host, cfg.model.kind == "cond")
    return {kk: torch.from_numpy(v) for kk, v in stacked.items()}, host


def _single_batch(host: dict, cond: bool) -> dict:
    batch = {"x": torch.from_numpy(host["x"])}
    if cond:
        batch.update(chord=torch.from_numpy(host["chord"].astype(np.int32)),
                     key_sig=torch.from_numpy(
                         host["key_sig"].astype(np.int32)))
    return batch


# -- (a) no host read in the step body ----------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_streamed_dispatch_reads_nothing_back(name):
    """Two streamed steps of each family with every option of the step
    that adds work on the card (as tests/test_torch_graph_dispatch.py)."""
    cfg = family_config(
        name, transpose_aug=2, ema_decay=0.9, grad_clip_norm=1.0,
        weight_decay=0.01, lr_schedule="cosine", lr_warmup_steps=2,
        num_steps=10, free_bits=0.02, adam_mu_dtype="bfloat16",
        beta_schedule="cyclical", beta_cycle_steps=4)
    ds = bar_dataset(num_bars=cfg.model.num_bars)
    model, state = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_multi(cfg, model, packed_x=True)
    stacked, _ = _stack(cfg, ds, 0, 2)
    with no_host_reads():
        _, m = multi(state, stacked)
    assert int(state.step) == 2 and np.isfinite(float(m["loss"]))


# -- (b) the static-input streamed dispatch -----------------------------------

SIZES = trainer.dispatch_sizes(2, 8, 3)          # [1, 3, 2]


@pytest.mark.parametrize("name", ["c2_gru_4bar", "c3_hier_16bar",
                                  "c4_cond", "c2_trf"])
@pytest.mark.parametrize("handed", [False, True])
def test_uneven_streamed_dispatches_equal_single_steps_bit_for_bit(
        name, handed):
    """Dispatches of 1, 3 and 2 streamed steps, each on a stack of its own
    (dropped after its dispatch, as the producer's are), against six
    single steps on the unpacked rolls from the same state: every
    dispatch's metrics and the final state (params, moments, count, step,
    EMA, the generator's state) bit for bit. ``handed``: each latent
    level's noise and the transpose shifts come from the caller, through
    their static buffers; else from the state's generator."""
    assert SIZES == [1, 3, 2]
    cfg = family_config(name, transpose_aug=2, ema_decay=0.9)
    cond = cfg.model.kind == "cond"
    ds = bar_dataset(num_bars=cfg.model.num_bars)
    model_a, state_a = trainer.create_state(cfg, device="cpu")
    model_b, state_b = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_multi(cfg, model_a, packed_x=True)
    single = trainer.make_train_step(cfg, model_b)
    rng = np.random.default_rng(7)
    b = cfg.train.batch_size
    start = 0
    for k in SIZES:
        stacked, host = _stack(cfg, ds, start, k)
        np.testing.assert_array_equal(
            unpack_bits_np(stacked["x_packed"].numpy()),
            np.stack([h["x"] for h in host]))
        eps = shifts = None
        if handed:
            eps = tuple(torch.from_numpy(rng.standard_normal(
                (k, *s)).astype(np.float32))
                for s in eps_shapes(cfg.model, b))
            shifts = torch.from_numpy(rng.integers(-2, 3, (k, b)))
        _, m = multi(state_a, stacked, eps, shifts)
        del stacked
        for j in range(k):
            _, want = single(
                state_b, _single_batch(host[j], cond),
                None if eps is None else tuple(e[j] for e in eps),
                None if shifts is None else shifts[j])
        assert m.keys() == want.keys()
        assert all(torch.equal(m[key], want[key]) for key in m), start
        start += k
    assert len(multi.programs) == 1         # one signature, one program
    assert int(state_a.step) == sum(SIZES)
    assert torch.equal(state_a.generator.get_state(),
                       state_b.generator.get_state())
    assert same_state(state_a, state_b)


def test_unpacked_stacks_take_the_same_step():
    """``packed_x=False``: the stack carries the rolls themselves, a row
    of them a step; the same bits as the packed stack's steps."""
    cfg = family_config("c2_gru_4bar")
    ds = bar_dataset()
    _, state_a = trainer.create_state(cfg, device="cpu")
    _, state_b = trainer.create_state(cfg, device="cpu")
    packed = trainer.make_train_step_multi(cfg, state_a.model, packed_x=True)
    plain = trainer.make_train_step_multi(cfg, state_b.model)
    stacked, host = _stack(cfg, ds, 0, 3)
    _, m_a = packed(state_a, stacked)
    _, m_b = plain(state_b, {"x": torch.from_numpy(
        np.stack([h["x"] for h in host]))})
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)
    assert same_state(state_a, state_b)


# -- (c) a program a signature ------------------------------------------------

def test_each_signature_gets_its_own_program():
    """The same state and row shapes reuse the program, whatever the
    dispatch's size; a row of another shape (a batch of 3) or another
    state captures anew, one signature's program kept at a time; the
    metrics a dispatch returned outlive the next dispatch."""
    cfg = family_config("c2_gru_4bar")
    ds = bar_dataset()
    model, state = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_multi(cfg, model, packed_x=True)
    _, first_m = multi(state, _stack(cfg, ds, 0, 2)[0])
    kept = {k: v.clone() for k, v in first_m.items()}
    first = next(iter(multi.programs.values()))
    _, second_m = multi(state, _stack(cfg, ds, 2, 1)[0])
    assert next(iter(multi.programs.values())) is first
    assert all(torch.equal(first_m[k], kept[k]) for k in kept)
    assert not torch.equal(first_m["loss"], second_m["loss"])
    wide = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=3))
    multi(state, _stack(wide, ds, 0, 1)[0])
    second = next(iter(multi.programs.values()))
    assert second is not first and len(multi.programs) == 1
    multi(trainer.init_state(cfg, model), _stack(cfg, ds, 0, 1)[0])
    assert next(iter(multi.programs.values())) is not second
    assert first.program.graph is None      # the CPU runs it eagerly


# -- (d) against the JAX package ----------------------------------------------

def test_streamed_dispatches_match_the_jax_scan():
    """Two dispatches of two packed steps through each package's
    ``make_train_step_multi`` (the JAX one jitted over ``lax.scan``) on
    the same weights, stacks and noise: each dispatch's last loss to 1e-5
    relative, recon, kl, beta and grad_norm to 1e-4, and the parameters
    after four steps to 2e-5 absolute."""
    k, b = 2, 3
    jc, tc = tiny_pair()
    kw = dict(batch_size=b, beta_warmup_steps=4, learning_rate=1e-3, seed=3)
    jc = jc.replace(train=dataclasses.replace(jc.train, **kw))
    tc = tc.replace(train=dataclasses.replace(tc.train, **kw))
    jmodel, params = jax_params(jc, tc, seed=8)
    ds = bar_dataset(seed=2)
    eps = np.random.default_rng(81).standard_normal(
        (2 * k, b, jc.model.z_dim)).astype(np.float32)
    jstate = jax_train_state(jc, params, seed=5)
    jmulti = jtrainer.make_train_step_multi(
        jc, InjectedEps(jmodel, latent_keys(jstate.rng, 2 * k), eps), k,
        packed_x=True)
    model = port_model(tc, params)
    state = trainer.init_state(tc, model)
    multi = trainer.make_train_step_multi(tc, model, packed_x=True)
    for d in range(2):
        stacked, _ = _stack(tc, ds, d * k, k)
        jstate, want = jmulti(jstate, {"x_packed": jnp.asarray(
            stacked["x_packed"].numpy())})
        _, got = multi(state, stacked,
                       eps=torch.from_numpy(eps[d * k:(d + 1) * k]))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        for name in ("recon", "kl", "beta", "grad_norm"):
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"dispatch {d} {name}")
    assert int(jstate.step) == int(state.step) == 2 * k
    want_p = flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params), tc)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   atol=2e-5, rtol=0, err_msg=n)
