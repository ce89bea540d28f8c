"""The port's conv bar-VAE (C1), hierarchical VAE (C3) and chord/key
VAE (C4) against the JAX package's, on the same converted weights and
injected noise, at tiny widths: the forward's (mu, logvar) of every latent
level within 3e-5 and its logits within 5e-4 in f32 (the tolerances of
tests/test_torch_parity.py), with the first-conv kernel flag and the
prev-bar conditioning each flipped.

In bf16 the two packages round the same bf16 operations in different
orders (XLA fuses, torch runs op by op), so a value may sit one or two
bf16 roundings away: there each output is held to 4 bf16 ulps (4·2^-8)
of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu_torch.models import layers
from musicvae_tpu_torch.models.vae import (PianoRollVAE, build_model,
                                           check_supported, draw_eps,
                                           eps_shapes)
from torch_port_helpers import (KINDS, jax_params, jax_zero_params,
                                jitted, kind_inputs, kind_pair,
                                one_torch_thread,  # noqa: F401
                                port_model, to_jax, to_torch)

VARIANTS = {"f32": {}, "conv1_kernel": dict(use_pallas_conv1=True),
            "prev_bar_flipped": None, "bf16": dict(dtype="bfloat16")}


def _variant_kw(name, variant):
    if variant == "prev_bar_flipped":     # C1 has none, the others have it
        return dict(use_prev_bar=name == "c1_conv_bar")
    return VARIANTS[variant]


def _forward_pair(name, seed=0, b=2, **model_kw):
    jc, tc = kind_pair(name, **model_kw)
    jmodel, params = jax_params(jc, tc, seed)
    model = port_model(tc, params)
    x, eps, labels = kind_inputs(np.random.default_rng(seed), jc.model, b)
    want = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                      eps=to_jax(eps), **to_jax(labels))
    with torch.no_grad():
        got = model(torch.tensor(x), to_torch(eps), **to_torch(labels))
    return jc, want, got


def _close(got, want, atol, bf16, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if bf16:
        atol = 4 * 2.0 ** -8 * max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", KINDS)
def test_forward_matches_jax(name, variant):
    jc, (logits_j, lat_j), (logits, lat) = _forward_pair(
        name, seed=1, **_variant_kw(name, variant))
    bf16 = variant == "bf16"
    assert logits.dtype == torch.float32
    assert len(lat) == len(lat_j) == (2 if name == "c3_hier_16bar" else 1)
    _close(logits, logits_j, 5e-4, bf16, "logits")
    for i, ((mu, lv), (mu_j, lv_j)) in enumerate(zip(lat, lat_j)):
        assert mu.dtype == lv.dtype == torch.float32
        _close(mu, mu_j, 3e-5, bf16, f"mu level {i}")
        _close(lv, lv_j, 3e-5, bf16, f"logvar level {i}")


@pytest.mark.parametrize("name", KINDS)
def test_encode_matches_jax(name):
    """``encode`` per kind: C1's trunk on the window's first bar, C4's
    features joined by the chord/key vector, C3's phrase posterior with
    the bar features it returns beside it."""
    jc, tc = kind_pair(name, use_pallas_conv1=True)
    jmodel, params = jax_params(jc, tc, 2)
    model = port_model(tc, params)
    x, _, labels = kind_inputs(np.random.default_rng(2), jc.model, 3)

    def run(mdl, x, chord=None, key_sig=None):
        cond_vec = None if chord is None else mdl.cond_vector(chord, key_sig)
        return mdl.encode(x, cond_vec)

    want = jax.jit(lambda p, x, lab: jmodel.apply(
        {"params": p}, x, **lab, method=run))(params, jnp.asarray(x),
                                              to_jax(labels))
    with torch.no_grad():
        cond_vec = None
        if labels:
            cond_vec = model.cond_vector(*to_torch(
                (labels["chord"], labels["key_sig"])))
        got = model.encode(torch.tensor(x), cond_vec)
    level = "phrase" if name == "c3_hier_16bar" else "z"
    for g, w in zip(got[:2], want[level]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)
    if name == "c3_hier_16bar":
        np.testing.assert_allclose(got[2].numpy(),
                                   np.asarray(want["bar_feats"]), atol=3e-5)
        assert got[2].shape == (3, 3, jc.model.bar_feat_dim)


@pytest.mark.parametrize("name", ["c1_conv_bar", "c3_hier_16bar",
                                  "c4_cond", "c2_gru_4bar"])
def test_state_dict_names_are_the_oracles(name):
    """The top-level module names are the torch oracle's
    (tests/oracle/oracle_model.py): every name, and every shape."""
    from tests.oracle.oracle_model import OracleVAE

    jc, tc = kind_pair(name)
    oracle = OracleVAE(jc)
    want = {k: tuple(v.shape) for k, v in oracle.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in
           PianoRollVAE(tc.model, tc.midi).state_dict().items()}
    assert got == want


def test_conductor_rz_hidden_biases_stay_detached():
    """The GRU r/z hidden-bias repair covers hier's conductor: those
    entries get no gradient, as flax keeps one r/z bias, while its other
    parameters do."""
    jc, tc = kind_pair("c3_hier_16bar")
    _, params = jax_params(jc, tc, 3)
    model = port_model(tc, params)
    x, eps, _ = kind_inputs(np.random.default_rng(3), jc.model, 2, 0.1)
    logits, lat = model(torch.tensor(x), to_torch(eps))
    loss = logits.square().mean() + sum(m.square().sum() for m, _ in lat)
    loss.backward()
    h = tc.model.gru_hidden
    for name in ("conductor", "dec_gru", "enc_gru"):
        cell = getattr(model, name)
        assert float(cell.bias_hh.grad[:2 * h].abs().max()) == 0.0, name
        assert float(cell.bias_hh.grad[2 * h:].abs().max()) > 0.0, name
        assert float(cell.weight_hh.grad.abs().max()) > 0.0, name


def test_embed_draws_flax_initializer():
    """flax nn.Embed's default: normal, variance 1/features, no
    truncation; torch's own Embedding draws N(0, 1)."""
    emb = layers.Embed(24, 1024)
    torch.manual_seed(0)
    emb.reset_parameters()
    std = float(emb.weight.detach().std())
    assert abs(std - 1024 ** -0.5) < 0.05 * 1024 ** -0.5
    assert float(emb.weight.abs().max()) > 2.5 * 1024 ** -0.5  # untruncated
    model = build_model(kind_pair("c4_cond")[1], device="cpu", seed=0)
    for mod in (model.chord_emb, model.key_emb):
        assert abs(float(mod.weight.detach().std()) - 16 ** -0.5) < 0.1


@pytest.mark.parametrize("name", ["c3_mxu", "c3_trf", "c2_mxu_wide"])
def test_patch_and_attention_still_refused(name):
    """(Named when the port refused these configs.) ``check_supported``
    takes them now, at their registered widths and at the parity kinds'
    tiny ones, and the port's model loads flax params of the JAX
    package's shapes strictly."""
    from musicvae_tpu_torch.checkpoints.convert import (
        flax_params_to_state_dict)
    from musicvae_tpu_torch.config import get_config

    check_supported(get_config(name).model)
    jc, tc = kind_pair(name)
    check_supported(tc.model)
    model = PianoRollVAE(tc.model, tc.midi)
    model.load_state_dict(flax_params_to_state_dict(jax_zero_params(jc), tc),
                          strict=True)


def test_unknown_kind_refused():
    import dataclasses
    _, tc = kind_pair("c4_cond")
    with pytest.raises(ValueError, match="unknown ModelSpec.kind"):
        check_supported(dataclasses.replace(tc.model, kind="rnn"))


@pytest.mark.parametrize("name", KINDS)
def test_draw_eps_order_and_shapes(name):
    """One tensor a latent level, drawn in level order from the
    generator: for hier the phrase level's normals come first."""
    _, tc = kind_pair(name)
    shapes = eps_shapes(tc.model, 5)
    eps = draw_eps(tc.model, 5, torch.Generator().manual_seed(7))
    assert [tuple(e.shape) for e in eps] == shapes
    g = torch.Generator().manual_seed(7)
    for e, shape in zip(eps, shapes):
        assert torch.equal(e, torch.randn(shape, generator=g))


def test_hier_generate_checks_the_phrase_path():
    _, tc = kind_pair("c3_hier_16bar")
    model = build_model(tc, device="cpu", seed=0)
    z = torch.zeros(2, 4, tc.model.z_dim)
    reset = torch.ones(2, 4)
    with pytest.raises(ValueError, match="one phrase latent per generated"):
        model.generate(z, reset, z_phrase=torch.zeros(2, 3,
                                                      tc.model.z_phrase_dim))
    with pytest.raises(ValueError, match="pass z_phrase"):
        model.generate(z, reset)
