"""The port's attention core (ModelSpec.temporal "attn", models/layers.py
``AttnStack``) against the JAX package's, at the tiny widths of
tests/test_attn.py on weights that the JAX package initialised and the
port's converter carried: the stack alone, causal and bidirectional; the
KV-cache step against the parallel forward and across a segment start;
the whole model's forward (f32 within 3e-5 / 5e-4) for c2_trf, c3_trf,
the conv stem with attention and cond with attention; in bf16 within 8
bf16 ulps of the largest magnitude, not the 4 of the GRU models: each
attention layer rounds its residual stream in bf16 twice more, and on
these inputs the JAX package's own bf16 logits lie up to 5.2 ulps from
its f32 logits (the port's up to 3.7); closed-loop generation against the
JAX package's and against the port's own teacher-forced decode (1e-4),
and seam-split sweeps against the joined sweep, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.models.layers import AttnStack as JaxAttnStack
from musicvae_tpu_torch.models import layers
from torch_port_helpers import (check_forward, jax_init_params,
                                jax_port_model, jitted,
                                one_torch_thread,  # noqa: F401
                                patch_pair)

WIRING = {"c2_trf": {}, "c3_trf": {},
          "conv_stem": dict(temporal="attn"),
          "cond": dict(temporal="attn")}
BASE = {"c2_trf": "c2_trf", "c3_trf": "c3_trf", "conv_stem": "c2_gru_4bar",
        "cond": "c4_cond"}


def pair(case, seed=0, **model_kw):
    """(JAX config, port config, flax model, params, the port's model with
    them loaded strictly) for a wiring case."""
    jc, tc = patch_pair(BASE[case], **{**WIRING[case], **model_kw})
    jmodel, params = jax_init_params(jc, seed)
    return jc, tc, jmodel, params, jax_port_model(tc, params)


def gen_inputs(spec, b, n, seed, resets=(0,)):
    """(z [B,N,z], reset [B,N], kwargs: z_phrase (hier, [B,N,zp] per
    bar), chord and key_sig (cond)) as numpy."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, n, spec.z_dim)).astype(np.float32)
    reset = np.zeros((b, n), np.float32)
    reset[:, list(resets)] = 1.0
    kw = {}
    if spec.kind == "hier":
        kw["z_phrase"] = rng.standard_normal(
            (b, n, spec.z_phrase_dim)).astype(np.float32)
    if spec.kind == "cond":
        kw["chord"] = rng.integers(0, 24, (b, n)).astype(np.int32)
        kw["key_sig"] = rng.integers(0, 24, (b,)).astype(np.int32)
    return z, reset, kw


def port_generate(model, z, reset, kw, seed_bar=None):
    with torch.no_grad():
        return model.generate(
            torch.tensor(z), torch.tensor(reset),
            None if seed_bar is None else torch.as_tensor(seed_bar),
            **{k: torch.tensor(v) for k, v in kw.items()})


@pytest.mark.parametrize("which", ["enc_attn", "seq_attn"])
def test_attn_stack_matches_jax(which):
    """The encoder's bidirectional and the decoder's causal stack on the
    same input, each with its carried weights."""
    jc, _, _, params, model = pair("c2_trf", seed=1)
    p = params["enc_attn"] if which == "enc_attn" else \
        params["decoder"]["seq_attn"]
    spec = jc.model
    stack = JaxAttnStack(hidden=spec.gru_hidden, num_layers=spec.attn_layers,
                         heads=spec.attn_heads, max_len=spec.attn_max_bars,
                         causal=which == "seq_attn", dtype="float32")
    mine = getattr(model, which)
    u = np.random.default_rng(1).standard_normal(
        (3, 6, mine.inp.in_features)).astype(np.float32)
    want = jax.jit(lambda p, u: stack.apply({"params": p}, u))(
        p, jnp.asarray(u))
    with torch.no_grad():
        got = mine(torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)
    if which == "seq_attn":      # causal: bar k does not see bar k + 1
        u2 = u.copy()
        u2[:, 4:] += 1.0
        with torch.no_grad():
            got2 = mine(torch.tensor(u2))
        assert torch.equal(got[:, :4], got2[:, :4])
        assert not torch.equal(got[:, 4:], got2[:, 4:])


def test_step_matches_parallel_and_jax_step():
    """The KV-cache step replayed over a sequence reproduces the causal
    forward (1e-5, tests/test_attn.py's tolerance), and the JAX
    package's step bar by bar."""
    jc, _, _, params, model = pair("c2_trf", seed=2)
    spec, stack = jc.model, model.seq_attn
    jstack = JaxAttnStack(hidden=spec.gru_hidden, num_layers=2,
                          heads=spec.attn_heads, max_len=spec.attn_max_bars,
                          causal=True, dtype="float32")
    b, n = 3, 7
    u = np.random.default_rng(2).standard_normal(
        (b, n, stack.inp.in_features)).astype(np.float32)
    jstep = jax.jit(lambda p, c, u, i, s: jstack.apply(
        {"params": p}, c, u, i, s, method=jstack.step))
    jcache = tuple((jnp.zeros((b, n, 16)),) * 2 for _ in range(2))
    cache = layers.attn_cache(b, n, 2, 16, torch.float32)
    start = torch.zeros(b, dtype=torch.long)
    outs = []
    with torch.no_grad():
        par = stack(torch.tensor(u))
        for i in range(n):
            outs.append(stack.step(cache, torch.tensor(u[:, i]), i, start))
            jcache, want = jstep(params["decoder"]["seq_attn"], jcache,
                                 jnp.asarray(u[:, i]), jnp.int32(i),
                                 jnp.zeros((b,), jnp.int32))
            np.testing.assert_allclose(outs[-1].numpy(), np.asarray(want),
                                       rtol=0, atol=3e-5)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), par.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_step_segment_isolation():
    """With start moved to k, the steps from k on ignore what came before:
    the suffix replayed as a fresh sequence gives the same outputs."""
    _, _, _, _, model = pair("c2_trf", seed=3)
    stack = model.seq_attn
    b, n, k = 2, 6, 3
    u = torch.tensor(np.random.default_rng(3).standard_normal(
        (b, n, stack.inp.in_features)).astype(np.float32))

    def run(u_seq, start_at):
        cache = layers.attn_cache(b, u_seq.shape[1], 2, 16, torch.float32)
        with torch.no_grad():
            return torch.stack([
                stack.step(cache, u_seq[:, i], i,
                           torch.full((b,), start_at(i), dtype=torch.long))
                for i in range(u_seq.shape[1])], 1)

    seg = run(u, lambda i: 0 if i < k else k)
    fresh = run(u[:, k:], lambda i: 0)
    np.testing.assert_allclose(seg[:, k:].numpy(), fresh.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_attn_stack_refuses_a_sequence_past_the_table():
    stack = layers.AttnStack(4, 8, 1, 2, max_len=3, dtype="float32")
    with pytest.raises(ValueError, match="exceeds attn_max_bars=3"):
        stack(torch.zeros(1, 4, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["c2_trf", "c3_trf"])
def test_forward_matches_jax(case, dtype):
    check_forward(BASE[case], dtype, bf16_ulps=8, **WIRING[case])


@pytest.mark.parametrize("case", ["conv_stem", "cond"])
def test_forward_matches_jax_f32(case):
    check_forward(BASE[case], **WIRING[case])


@pytest.mark.parametrize("case", list(WIRING))
def test_generate_matches_jax(case):
    """Closed-loop sweeps of 5 bars with a reset at bars 0 and 3: the same
    bars, logits within 5e-4; hier takes a per-bar z_phrase path, cond
    its chord and key labels."""
    jc, _, jmodel, params, model = pair(case, seed=4)
    z, reset, kw = gen_inputs(jc.model, 2, 5, 4, resets=(0, 3))
    want_logits, want_bars = jitted(jmodel, "generate")(
        params, jnp.asarray(z), jnp.asarray(reset),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    logits, bars = port_generate(model, z, reset, kw)
    np.testing.assert_array_equal(bars.numpy(), np.asarray(want_bars))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=5e-4)


@pytest.mark.parametrize("case", list(WIRING))
def test_closed_loop_matches_teacher(case):
    """Generate with one reset at bar 0, then teacher-decode the generated
    bars with the same z (and phrase path, and labels): the same
    function, within 1e-4."""
    jc, _, _, _, model = pair(case, seed=5)
    z, reset, kw = gen_inputs(jc.model, 2, 4, 5)
    logits, bars = port_generate(model, z, reset, kw)
    with torch.no_grad():
        cond_vec = None
        if "chord" in kw:
            cond_vec = model.cond_vector(torch.tensor(kw["chord"]),
                                         torch.tensor(kw["key_sig"]))
        zp = torch.tensor(kw["z_phrase"]) if "z_phrase" in kw else None
        teacher = model.teacher(torch.tensor(z), bars.float(), cond_vec, zp)
    np.testing.assert_allclose(logits.numpy(), teacher.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["c2_trf", "c3_trf"])
def test_seam_split_equals_joined_sweep(case):
    """A sweep with a reset at bar 3 equals a sweep of bars 0-2 chained
    into a sweep of bars 3-5 seeded with its last bar: positions count
    from the segment's start and the previous bar crosses the seam."""
    jc, _, _, _, model = pair(case, seed=6)
    z, reset, kw = gen_inputs(jc.model, 2, 6, 6, resets=(0, 3))
    _, joined = port_generate(model, z, reset, kw)
    halves = [{k: v[:, s] if k == "z_phrase" else v for k, v in kw.items()}
              for s in (slice(0, 3), slice(3, 6))]
    _, a = port_generate(model, z[:, :3], reset[:, :3], halves[0])
    _, b = port_generate(model, z[:, 3:], reset[:, :3], halves[1],
                         seed_bar=a[:, -1])
    assert torch.equal(joined, torch.cat([a, b], dim=1))


def test_sweep_past_the_table_is_refused():
    _, _, _, _, model = pair("c2_trf", seed=7, attn_max_bars=4)
    z, reset, kw = gen_inputs(model.spec, 1, 5, 7)
    with pytest.raises(ValueError, match="5-bar sweep exceeds attn_max_bars"):
        port_generate(model, z, reset, kw)


def test_init_like_flax_draws_the_attention_initializers():
    """``build_model``'s random weights for c2_trf: LayerNorm scales 1 and
    biases 0, the position tables N(0, 0.02²) untruncated (flax's
    ``normal(0.02)``), the attention denses lecun-normal."""
    from musicvae_tpu_torch.config import get_config
    from musicvae_tpu_torch.models.vae import build_model

    model = build_model(get_config("c2_trf"), device="cpu", seed=0)
    lns = [m for m in model.modules() if isinstance(m, layers.LayerNorm)]
    assert len(lns) == 2 * (2 * 2 + 1)
    assert all(torch.equal(m.weight, torch.ones_like(m.weight))
               and torch.equal(m.bias, torch.zeros_like(m.bias)) for m in lns)
    for stack in (model.enc_attn, model.seq_attn):
        pos = stack.pos_emb.detach()
        assert abs(float(pos.std()) - 0.02) < 0.001
        assert float(pos.abs().max()) > 2.5 * 0.02          # untruncated
        w = stack.qkv[0].weight.detach()
        std = w.shape[1] ** -0.5
        assert abs(float(w.std()) - std) < 0.05 * std
