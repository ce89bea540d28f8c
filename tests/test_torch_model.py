"""The port's C2 model against the JAX package's, with the JAX params
carried across by the port's converter: encode (mu, logvar) within 3e-5
and teacher-forced logits within 5e-4 (the tolerances of
tests/test_torch_parity.py), with the first-conv kernel flag off and on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.checkpoints.torch_convert import (
    flax_params_to_torch_state_dict)
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.models.vae import PianoRollVAE
from torch_port_helpers import (bars, jax_params, jax_zero_params, jitted,
                                patch_pair, port_model, tiny_pair)


def _case(pallas_conv1: bool, seed: int = 0, b: int = 2):
    jc, tc = tiny_pair(use_pallas_conv1=pallas_conv1)
    jmodel, params = jax_params(jc, tc, seed)
    model = port_model(tc, params)
    rng = np.random.default_rng(seed)
    x = bars(rng, (b, jc.model.num_bars, 96, 128))
    eps = rng.standard_normal((b, jc.model.z_dim)).astype(np.float32)
    return jc, tc, jmodel, params, model, x, eps


@pytest.mark.parametrize("pallas_conv1", [False, True])
def test_encode_matches_jax(pallas_conv1):
    _, _, jmodel, params, model, x, _ = _case(pallas_conv1)
    enc = jitted(jmodel, "encode")(params, jnp.asarray(x))
    mu_j, lv_j = enc["z"]
    with torch.no_grad():
        mu, lv = model.encode(torch.tensor(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=3e-5)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), atol=3e-5)


@pytest.mark.parametrize("pallas_conv1", [False, True])
def test_forward_matches_jax(pallas_conv1):
    _, _, jmodel, params, model, x, eps = _case(pallas_conv1, seed=1)
    logits_j, lat_j = jitted(jmodel, "__call__")(
        params, jnp.asarray(x), eps=(jnp.asarray(eps),))
    with torch.no_grad():
        logits, lat = model(torch.tensor(x), torch.tensor(eps))
    assert logits.shape == logits_j.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=5e-4)
    for (mu, lv), (mu_j, lv_j) in zip(lat, lat_j):
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=3e-5)
        np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), atol=3e-5)


def test_forward_uint8_input_equals_f32():
    """A uint8 roll (the resident cache format) scores like its f32 copy."""
    _, _, _, _, model, x, eps = _case(True, seed=2)
    with torch.no_grad():
        a, _ = model(torch.tensor(x), torch.tensor(eps))
        b, _ = model(torch.tensor(x).to(torch.uint8), torch.tensor(eps))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_converter_matches_jax_torch_export():
    """Key for key and value for value, the JAX package's flax → torch
    export; and the port's model takes it with strict=True."""
    jc, tc = tiny_pair()
    _, params = jax_params(jc, tc, 3)
    mine = flax_params_to_state_dict(params, tc)
    theirs = flax_params_to_torch_state_dict(params, jc)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0)
    model = PianoRollVAE(tc.model, tc.midi)
    assert sorted(model.state_dict()) == sorted(mine)
    model.load_state_dict(theirs, strict=True)


def test_converter_no_prev_bar():
    jc, tc = tiny_pair(use_prev_bar=False)
    _, params = jax_params(jc, tc, 4)
    sd = flax_params_to_state_dict(params, tc)
    assert not any(k.startswith("prev_feat") for k in sd)
    PianoRollVAE(tc.model, tc.midi).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", ["c3_mxu", "c3_trf", "c2_mxu_wide",
                                  "c2_mxu", "c2_trf"])
def test_unported_kinds_raise(name):
    """(Named when the port refused these configs.) They build now, and
    the converter carries flax params of the JAX package's shapes into
    them with strict=True, key for key."""
    jc, tc = patch_pair(name)
    params = jax_zero_params(jc)
    sd = flax_params_to_state_dict(params, tc)
    model = PianoRollVAE(tc.model, tc.midi)
    assert sorted(model.state_dict()) == sorted(sd)
    model.load_state_dict(sd, strict=True)
