"""The port's compiled eval (utils/metrics.py ``make_eval_fn``: a
static-input ``graphs.StaticProgram`` a signature, a captured CUDA graph
on the card) on the CPU at tiny f32 widths, where the same program runs
eagerly over the same buffers:

- (a) one eval of each model family, weighted and not, reads nothing back
  to the host and makes no tensor from host data, which capture requires;
- (b) repeated calls equal the eager body (the forward and
  ``eval_metrics`` on the caller's tensors) bit for bit, and the metrics
  a call returned are unchanged by the next call;
- (c) each signature (x's dtype, the noise's shapes, the weights, the
  labels) has a program of its own, and the EMA model's eval has its
  own; ``train()``'s evals read each batch's metrics in one host read,
  with the means of the metrics read one by one;
- (d) the eval equals the JAX package's jitted ``make_eval_fn`` on the
  same weights, batch and noise: loss, recon and kl within 1e-5 relative
  (the loss tolerance), precision, recall and F1 within 1e-6.

Graph against eager on the card is ``chip_smoke.py``'s eval phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.utils.metrics import make_eval_fn as j_make_eval_fn
from musicvae_tpu_torch.models.vae import build_model, draw_eps
from musicvae_tpu_torch.train import trainer
from musicvae_tpu_torch.utils.metrics import eval_metrics, make_eval_fn
from torch_port_helpers import (FAMILIES, HandedEps, bar_dataset,
                                family_config, jax_init_params, jax_params,
                                jax_port_model, kind_inputs, kind_pair,
                                no_host_reads,
                                one_torch_thread,  # noqa: F401
                                patch_pair, port_model)

B = 3


def _model(name, seed=5):
    cfg = family_config(name)
    return cfg, build_model(cfg, device="cpu", seed=seed)


def _inputs(cfg, seed, weighted=False, x_dtype=np.uint8):
    """(x, eps, weights, labels) of one eval batch, as tensors."""
    x, eps, labels = kind_inputs(np.random.default_rng(seed), cfg.model, B,
                                 0.08)
    x = x[:, :, :cfg.midi.steps_per_bar].astype(x_dtype)
    w = (torch.tensor([1.0, 1.0, 0.0]) if weighted else None)
    return (torch.from_numpy(x), tuple(map(torch.from_numpy, eps)), w,
            {k: torch.from_numpy(v) for k, v in labels.items()})


# -- (a) no host read in the eval body ----------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_eval_reads_nothing_back(name, weighted):
    cfg, model = _model(name)
    eval_fn = make_eval_fn(cfg, model)
    x, eps, w, labels = _inputs(cfg, 1, weighted)
    with no_host_reads():
        m = eval_fn(x, eps, w, **labels)
    assert sorted(m) == ["f1", "kl", "loss", "precision", "recall", "recon"]
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in m.values())
    assert np.isfinite(float(m["loss"]))


# -- (b) the program against its eager body -----------------------------------

@pytest.mark.parametrize("name", ["c2_gru_4bar", "c1_conv_bar",
                                  "c3_hier_16bar", "c4_cond", "c2_trf"])
def test_eval_equals_the_eager_body(name):
    """Three batches through one program, weighted as the CLI's tail
    batch is: each call's metrics equal the forward and ``eval_metrics``
    run on the caller's tensors, bit for bit; an earlier call's metrics
    stay as they were."""
    cfg, model = _model(name)
    eval_fn = make_eval_fn(cfg, model)
    kept = []
    for seed in (11, 12, 13):
        x, eps, w, labels = _inputs(cfg, seed, weighted=True)
        got = eval_fn(x, eps, w, **labels)
        with torch.inference_mode():
            logits, latents = model(x, eps, **labels)
            want = eval_metrics(cfg, logits, x, latents, w)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got), seed
        kept.append((got, want))
    for got, want in kept:
        assert all(torch.equal(got[k], want[k]) for k in got)
    assert len(eval_fn.programs) == 1
    assert not torch.equal(kept[0][0]["loss"], kept[1][0]["loss"])


# -- (c) a program a signature ------------------------------------------------

def test_each_signature_has_its_own_program():
    cfg, model = _model("c4_cond")
    eval_fn = make_eval_fn(cfg, model)
    x, eps, w, labels = _inputs(cfg, 2)
    first = eval_fn(x, eps, **labels)
    eval_fn(x, eps, **labels)
    assert len(eval_fn.programs) == 1
    eval_fn(x, eps, torch.ones(B), **labels)               # weighted
    eval_fn(x.float(), eps, **labels)                      # f32 rolls
    eval_fn(x, eps, chord=labels["chord"].long(),
            key_sig=labels["key_sig"].long())              # int64 labels
    eval_fn(x[:2], tuple(e[:2] for e in eps),
            **{k: v[:2] for k, v in labels.items()})       # batch of 2
    assert len(eval_fn.programs) == 5
    again = eval_fn(x, eps, **labels)
    assert all(torch.equal(first[k], again[k]) for k in first)
    other = make_eval_fn(cfg, model)
    other(x, eps, **labels)
    assert other.programs.keys() == {next(iter(eval_fn.programs))}
    assert next(iter(other.programs.values())) is not \
        next(iter(eval_fn.programs.values()))
    hier_cfg, hier = _model("c3_hier_16bar")
    hier_fn = make_eval_fn(hier_cfg, hier)
    hx, heps, _, _ = _inputs(hier_cfg, 3)
    hier_fn(hx, heps)
    hier_fn(hx, (heps[0], heps[1].double()))      # the bar level in f64
    assert len(hier_fn.programs) == 2


def test_train_evals_the_model_and_its_ema_through_their_programs():
    """``train()`` with an eval cadence and the EMA: the logged eval
    metrics, read from each batch's stacked metrics in one host read,
    equal the means of the metrics of the same batches read one by one
    from a fresh eval function of each model."""
    cfg = family_config("c2_gru_4bar", num_steps=4, eval_every=2,
                        eval_batches=2, ema_decay=0.9)
    train_ds, eval_ds = bar_dataset(pieces=8).split(0.25, seed=1)
    logged = []
    _, state, _ = trainer.train(cfg, train_ds, eval_data=eval_ds,
                                log_fn=lambda s, m: logged.append((s, m)),
                                device="cpu")
    evals = [m for _, m in logged if "eval_loss" in m]
    assert len(evals) == 2
    eb = min(cfg.train.batch_size, len(eval_ds))
    perm = np.random.default_rng(cfg.train.seed).permutation(
        len(eval_ds)).astype(np.int32)
    want = {}
    for prefix, model in (("eval_", state.model),
                          ("eval_ema_", state.ema_model)):
        fn = make_eval_fn(cfg, model)
        for i in range(2):
            x = torch.from_numpy(eval_ds.batch(perm[i * eb:(i + 1) * eb],
                                               x_dtype=np.uint8)["x"])
            eps = draw_eps(cfg.model, eb, torch.Generator().manual_seed(i))
            for k, v in fn(x, eps).items():
                want.setdefault(prefix + k, []).append(float(v))
    assert evals[-1] == {k: sum(v) / len(v) for k, v in want.items()}
    assert evals[-1]["eval_loss"] != evals[-1]["eval_ema_loss"]


# -- (d) against the JAX package ----------------------------------------------

def _jax_case(name, seed):
    """(JAX config, port config, flax model, flax params, port model) on
    the same weights."""
    if name in ("c2_trf", "c2_mxu"):
        jc, tc = patch_pair(name)
        jmodel, params = jax_init_params(jc, seed)
        return jc, tc, jmodel, params, jax_port_model(tc, params)
    jc, tc = kind_pair(name)
    jmodel, params = jax_params(jc, tc, seed)
    return jc, tc, jmodel, params, port_model(tc, params)


@pytest.mark.parametrize("name,weighted", [
    ("c2_gru_4bar", True), ("c3_hier_16bar", False), ("c4_cond", False),
    ("c2_trf", True)])
def test_eval_matches_jax(name, weighted):
    """Two batches through one program against the JAX eval on the same
    noise (its latent draws handed in): loss, recon and kl within 1e-5
    relative, precision, recall and F1 within 1e-6."""
    jc, tc, jmodel, params, model = _jax_case(name, 6)
    if "z_head" in params:
        # an O(1) posterior: at init mu ~ 0 and logvar ~ 0, and the KL is
        # all cancellation, below any relative tolerance
        zb = params["z_head"]["Dense_0"]["bias"]
        params["z_head"]["Dense_0"]["bias"] = zb + np.random.default_rng(
            6).standard_normal(zb.shape).astype(np.float32)
        model = port_model(tc, params)
    eval_fn = make_eval_fn(tc, model)
    for seed in (21, 22):
        x, eps, w, labels = _inputs(tc, seed, weighted, np.float32)
        batch = {"x": jnp.asarray(x.numpy()),
                 **{k: jnp.asarray(v.numpy()) for k, v in labels.items()}}
        want = j_make_eval_fn(jc, HandedEps(jmodel, [e.numpy()
                                                     for e in eps]))(
            params, batch, jax.random.key(0),
            None if w is None else jnp.asarray(w.numpy()))
        got = eval_fn(x, eps, w, **labels)
        assert sorted(got) == sorted(want)
        for k in ("loss", "recon", "kl"):
            assert abs(float(got[k]) - float(want[k])) <= \
                1e-5 * abs(float(want[k])), (name, seed, k)
        for k in ("precision", "recall", "f1"):
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                  abs=1e-6), (name, k)
    assert len(eval_fn.programs) == 1

