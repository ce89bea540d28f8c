"""The port's compiled train dispatch (train/trainer.py
``make_train_step_indexed_multi`` over utils/graphs.py ``Program``) on the
CPU at tiny f32 widths, where its step runs eagerly over the static inputs
a captured CUDA graph reads on the card:

- (a) one dispatch of each model family reads nothing back to the host and
  makes no tensor from host data, which capture requires (shown here
  without a card, under a guard that makes those calls raise);
- (b) dispatches of uneven sizes (``dispatch_sizes``) equal the same steps
  taken one by one with ``make_train_step_indexed``, bit for bit, the
  generator's state included, whether the noise and shifts are drawn or
  handed in; and they equal the JAX package's
  ``make_train_step_indexed_multi`` (its jit over ``lax.scan``) at the
  train-step tolerances of tests/test_torch_train_step.py;
- the launch counting that replays use, and the switches that keep a run
  eager (the CPU, ``debug_mode``).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.train import trainer as jtrainer
from musicvae_tpu_torch.ops import _kernels
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.utils import debug_mode, graphs
from torch_port_helpers import (FAMILIES, HostRead, bar_dataset,
                                family_config, jax_params, no_host_reads,
                                one_torch_thread,  # noqa: F401
                                port_model, same_state, tiny_pair)

def _resident(cfg, ds):
    data = {"bars": torch.from_numpy(ds.bars),
            "starts": torch.from_numpy(ds.starts)}
    if cfg.model.kind == "cond":
        data.update(chords=torch.from_numpy(ds.chords.astype(np.int32)),
                    keys=torch.from_numpy(ds.keys.astype(np.int32)))
    return data


def _idxs(cfg, ds, start, k):
    ids = trainer.make_id_schedule(cfg.train.seed, len(ds),
                                   cfg.train.batch_size)
    return torch.from_numpy(np.stack([ids(start + j) for j in range(k)]))


# -- (a) no host read in the step body ----------------------------------------------

def test_guard_catches_host_reads():
    t = torch.ones(2)
    with no_host_reads():
        for read in (lambda: t.sum().item(), lambda: bool(t.sum()),
                     lambda: float(t[0]), lambda: t.tolist(),
                     lambda: t.cpu(), lambda: torch.tensor([0.5]),
                     lambda: torch.as_tensor([1.0])):
            with pytest.raises(HostRead):
                read()
        assert torch.as_tensor(t) is t
    assert t.sum().item() == 2.0


@pytest.mark.parametrize("name", FAMILIES)
def test_dispatch_reads_nothing_back(name):
    """Two steps of each family, with every option of the step that adds
    work on the card (transpose shifts, EMA, the clip, weight decay, the
    cosine schedule, free bits, bf16 moments, the cyclical β)."""
    cfg = family_config(
        name, transpose_aug=2, ema_decay=0.9, grad_clip_norm=1.0,
        weight_decay=0.01, lr_schedule="cosine", lr_warmup_steps=2,
        num_steps=10, free_bits=0.02, adam_mu_dtype="bfloat16",
        beta_schedule="cyclical", beta_cycle_steps=4)
    ds = bar_dataset(num_bars=cfg.model.num_bars)
    model, state = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_indexed_multi(cfg, model)
    data, idxs = _resident(cfg, ds), _idxs(cfg, ds, 0, 2)
    with no_host_reads():
        _, m = multi(state, data, idxs)
    assert int(state.step) == 2 and np.isfinite(float(m["loss"]))


# -- (b) the static-input dispatch ----------------------------------------------------

SIZES = trainer.dispatch_sizes(2, 8, 3)          # [1, 3, 2]


@pytest.mark.parametrize("name", ["c2_gru_4bar", "c3_hier_16bar",
                                  "c4_cond"])
@pytest.mark.parametrize("handed", [False, True])
def test_uneven_dispatches_equal_single_steps_bit_for_bit(name, handed):
    """Dispatches of 1, 3 and 2 steps against six single steps from the
    same state: every step's metrics and the final state (params, moments,
    count, step, the generator's state) bit for bit. ``handed``: the
    noise of each latent level and the transpose shifts come from the
    caller, through their static buffers; else from the state's
    generator."""
    assert SIZES == [1, 3, 2]
    cfg = family_config(name, transpose_aug=2, ema_decay=0.9)
    ds = bar_dataset(num_bars=cfg.model.num_bars)
    model_a, state_a = trainer.create_state(cfg, device="cpu")
    model_b, state_b = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_indexed_multi(cfg, model_a)
    single = trainer.make_train_step_indexed(cfg, model_b)
    data = _resident(cfg, ds)
    rng = np.random.default_rng(7)
    b = cfg.train.batch_size
    start = 0
    for k in SIZES:
        idxs = _idxs(cfg, ds, start, k)
        eps = shifts = None
        if handed:
            from musicvae_tpu_torch.models.vae import eps_shapes
            eps = tuple(torch.from_numpy(rng.standard_normal(
                (k, *s)).astype(np.float32))
                for s in eps_shapes(cfg.model, b))
            shifts = torch.from_numpy(rng.integers(-2, 3, (k, b)))
        _, m = multi(state_a, data, idxs, eps, shifts)
        for j in range(k):
            _, want = single(state_b, data, idxs[j],
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


def test_metrics_outlive_the_next_dispatch():
    """A dispatch's metrics are the caller's own: the next dispatch does
    not overwrite them (a replay writes the graph's own tensors)."""
    cfg = family_config("c2_gru_4bar")
    ds = bar_dataset()
    model, state = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_indexed_multi(cfg, model)
    data = _resident(cfg, ds)
    _, first = multi(state, data, _idxs(cfg, ds, 0, 2))
    kept = {k: v.clone() for k, v in first.items()}
    _, second = multi(state, data, _idxs(cfg, ds, 2, 2))
    assert all(torch.equal(first[k], kept[k]) for k in kept)
    assert not torch.equal(first["loss"], second["loss"])


def test_a_new_state_or_data_gets_its_own_program():
    cfg = family_config("c2_gru_4bar")
    ds = bar_dataset()
    model, state = trainer.create_state(cfg, device="cpu")
    multi = trainer.make_train_step_indexed_multi(cfg, model)
    data = _resident(cfg, ds)
    idxs = _idxs(cfg, ds, 0, 1)
    multi(state, data, idxs)
    first = next(iter(multi.programs.values()))
    multi(state, data, idxs)
    assert next(iter(multi.programs.values())) is first
    multi(state, {k: v.clone() for k, v in data.items()}, idxs)
    second = next(iter(multi.programs.values()))
    assert second is not first and len(multi.programs) == 1
    state.opt.configure(cfg.replace(train=dataclasses.replace(
        cfg.train, learning_rate=1e-4)))
    multi(state, data, idxs)
    assert next(iter(multi.programs.values())) is not second


def test_f32_moments_are_updated_in_place():
    """A captured step reads and writes the same moment tensors every
    replay: the optimizer never replaces them."""
    cfg = family_config("c2_gru_4bar")
    ds = bar_dataset()
    model, state = trainer.create_state(cfg, device="cpu")
    mu = list(state.opt.mu)
    multi = trainer.make_train_step_indexed_multi(cfg, model)
    multi(state, _resident(cfg, ds), _idxs(cfg, ds, 0, 2))
    assert all(a is b for a, b in zip(mu, state.opt.mu))
    assert any(float(m.abs().sum()) > 0 for m in mu)


class _InjectedNoise:
    """The JAX model with its 'latent' draws made from the step's key
    here, ``jax.random.normal(key, [B, z])``, so the test can hand the
    port the same normals."""

    def __init__(self, jmodel, z: int):
        self.jmodel, self.z = jmodel, z

    def apply(self, variables, x, rngs, **kw):
        eps = jax.random.normal(rngs["latent"], (x.shape[0], self.z))
        return self.jmodel.apply(variables, x, eps=(eps,), **kw)


def test_dispatches_match_the_jax_scan():
    """The JAX package's ``make_train_step_indexed_multi`` (jit over
    ``lax.scan``) and the port's dispatch over the same window ids, noise
    and weights, in dispatches of 1, 3 and 2 steps: the last step's
    loss, recon, kl, beta and grad_norm of each dispatch at rtol 1e-4 and
    the parameters after all six at atol 2e-5 (the tolerances of
    tests/test_torch_train_step.py)."""
    kw = dict(batch_size=3, beta_warmup_steps=4, learning_rate=1e-3,
              seed=3)
    jc, tc = tiny_pair()
    jc = jc.replace(train=dataclasses.replace(jc.train, **kw))
    tc = tc.replace(train=dataclasses.replace(tc.train, **kw))
    jmodel, params = jax_params(jc, tc, seed=4)
    ds = bar_dataset()
    jdata = {"bars": jnp.asarray(ds.bars), "starts": jnp.asarray(ds.starts)}
    jmulti = jtrainer.make_train_step_indexed_multi(
        jc, _InjectedNoise(jmodel, jc.model.z_dim), 3)
    opt = jtrainer.make_optimizer(jc)
    key = jax.random.key(11)
    jstate = jtrainer.TrainState(params=params, opt_state=opt.init(params),
                                 step=jnp.zeros((), jnp.int32), rng=key)
    model = port_model(tc, params)
    state = trainer.init_state(tc, model)
    multi = trainer.make_train_step_indexed_multi(tc, model)
    data = _resident(tc, ds)
    start = 0
    for k in SIZES:
        idxs = _idxs(tc, ds, start, k)
        eps = []
        for _ in range(k):          # the JAX step's key chain
            step_key, key = jax.random.split(key)
            eps.append(np.asarray(jax.random.normal(
                step_key, (kw["batch_size"], jc.model.z_dim))))
        jstate, jm = jmulti(jstate, jdata, jnp.asarray(idxs.numpy()))
        _, m = multi(state, data, idxs, torch.from_numpy(np.stack(eps)))
        for name in ("loss", "recon", "kl", "beta", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {start + k} {name}")
        start += k
    assert int(jstate.step) == int(state.step) == 6
    want = port_model(tc, jax.tree.map(np.asarray, jstate.params))
    for (n, p), (_, w) in zip(model.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=n)


# -- launch counts and the eager switches ----------------------------------------------

def test_capture_records_launches_and_replays_count_them():
    """While a stream is captured, the launches on it go to the capture's
    record from any thread (autograd runs a backward in its own thread);
    launches on other streams still count; each replay adds the
    record."""
    captured, other = 1111, 2222           # stream pointers
    _kernels.reset_launches()
    backward = threading.Thread(target=_kernels.launched,
                                args=("first_conv_s2_bwd", captured))
    with _kernels.capture_launches(captured) as record:
        _kernels.launched("masked_bce_sum_dual", captured)
        _kernels.launched("first_conv_s2", captured)
        _kernels.launched("first_conv_s2", captured)
        backward.start()
        backward.join(10)
        _kernels.launched("kl_sum", other)
    assert not backward.is_alive()
    assert _kernels.LAUNCHES["kl_sum"] == 1
    assert record["masked_bce_sum_dual"] == 1 and record["first_conv_s2"] == 2
    assert record["first_conv_s2_bwd"] == 1
    assert _kernels.LAUNCHES["masked_bce_sum_dual"] == 0
    assert _kernels.LAUNCHES["first_conv_s2_bwd"] == 0
    for _ in range(3):
        _kernels.count_replay(record)
    assert _kernels.LAUNCHES["masked_bce_sum_dual"] == 3
    assert _kernels.LAUNCHES["first_conv_s2"] == 6
    assert _kernels.LAUNCHES["first_conv_s2_bwd"] == 3
    _kernels.launched("masked_bce_sum_dual", captured)   # capture over
    assert _kernels.LAUNCHES["masked_bce_sum_dual"] == 4
    _kernels.reset_launches()


def test_programs_run_eagerly_off_the_card_and_in_debug_mode():
    """A program is a graph only on a CUDA device outside debug_mode; on
    the CPU it runs its function at every call."""
    calls = []
    program = graphs.Program(lambda: calls.append(1) or len(calls),
                             torch.device("cpu"))
    assert [program() for _ in range(3)] == [1, 2, 3]
    cuda = torch.device("cuda", 0)
    assert graphs.enabled(cuda) and not graphs.enabled(torch.device("cpu"))
    with debug_mode(nans=False, disable_jit=True):
        assert not graphs.enabled(cuda)
        with debug_mode(nans=False):
            assert not graphs.enabled(cuda)
    assert graphs.enabled(cuda)
    with debug_mode():
        assert not graphs.enabled(cuda)
    assert graphs.enabled(cuda)
