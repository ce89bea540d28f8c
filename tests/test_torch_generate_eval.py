"""The port's inference path against the JAX package's: latent paths,
closed-loop generation, eval, MIDI export, and the serve protocol."""

import base64
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu.generate.sampler import latent_path as j_latent_path
from musicvae_tpu.midi import smf as jsmf
from musicvae_tpu.midi import tensorize as jtens
from musicvae_tpu.utils.metrics import make_eval_fn as j_make_eval_fn
from musicvae_tpu_torch.cli import Service, main, serve_stream
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.generate.sampler import latent_path, make_generate_fn
from musicvae_tpu_torch.midi import smf, tensorize
from musicvae_tpu_torch.utils.metrics import make_eval_fn
from torch_port_helpers import (bars, jax_params, jitted, port_midi_spec,
                                port_model, tiny_pair)

MARGIN = 1e-3     # |logit − logit(threshold)| below which a cell may flip


@pytest.mark.parametrize("interpolate,num_bars", [(False, 10), (True, 9),
                                                  (True, 3)])
def test_latent_path_matches_jax(interpolate, num_bars):
    """Same normals in, same path and reset mask out (the JAX draws are
    reproduced from its key split and handed to the port as noise)."""
    jc, tc = tiny_pair()
    key = jax.random.key(7)
    batch, temp = 3, 0.8
    z_j, reset_j = j_latent_path(key, jc, batch, num_bars, interpolate, temp)
    if interpolate:
        k_a, k_b = jax.random.split(key)
        noise = np.stack([np.asarray(jax.random.normal(k, (batch, 16)))
                          for k in (k_a, k_b)])
    else:
        noise = np.asarray(jax.random.normal(key, (-(-num_bars // 4),
                                                   batch, 16)))
    z, reset = latent_path(tc, batch, num_bars, interpolate, temp,
                           noise=torch.tensor(noise))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5)
    np.testing.assert_array_equal(reset.numpy(), np.asarray(reset_j))


@pytest.mark.parametrize("pallas_conv1", [False, True])
def test_generation_matches_jax(pallas_conv1):
    """Same z path, reset and seed bar in both packages. Bar by bar while
    the bars so far agree: logits within 5e-4, and binary cells equal
    wherever the JAX logit is more than MARGIN from logit(threshold). A
    cell inside the margin may flip; after a flip the feedback differs
    and the comparison stops. Flips are counted and reported."""
    jc, tc = tiny_pair(use_pallas_conv1=pallas_conv1)
    jmodel, params = jax_params(jc, tc, 5)
    model = port_model(tc, params)
    rng = np.random.default_rng(5)
    b, n = 2, 6
    z = rng.standard_normal((b, n, 16)).astype(np.float32)
    reset = np.zeros((b, n), np.float32)
    reset[:, ::4] = 1.0
    seed_bar = bars(rng, (b, 96, 128), 0.1).astype(np.uint8)
    logits_j, bars_j = jitted(jmodel, "generate")(
        params, jnp.asarray(z), jnp.asarray(reset), jnp.asarray(seed_bar))
    logits_j, bars_j = np.asarray(logits_j), np.asarray(bars_j)
    with torch.no_grad():
        logits, bars_t = model.generate(torch.tensor(z), torch.tensor(reset),
                                        torch.tensor(seed_bar))
    assert bars_t.dtype == torch.uint8 and bars_t.shape == bars_j.shape
    logits, bars_t = logits.numpy(), bars_t.numpy()
    flips, compared = 0, 0
    for k in range(n):
        np.testing.assert_allclose(logits[:, k], logits_j[:, k], atol=5e-4)
        near = np.abs(logits_j[:, k]) <= MARGIN        # logit(0.5) = 0
        diff = bars_t[:, k] != bars_j[:, k]
        assert not (diff & ~near).any(), f"bar {k}: flip outside margin"
        compared += 1
        flips += int(diff.sum())
        if flips:
            break
    print(f"generation parity: {compared} bars compared, {flips} flips")
    assert compared >= 1


def _eps_of(jmodel, params, x, key):
    """The N(0,1) draw the JAX model's reparameterization takes from
    rngs={"latent": key}: the root module's first make_rng("latent")."""
    def draw(mdl, x):
        k = mdl.make_rng("latent")
        mu, _ = mdl.encode(x)["z"]
        return jax.random.normal(k, mu.shape, mu.dtype)
    return jax.jit(lambda p, x, key: jmodel.apply(
        {"params": p}, x, method=draw, rngs={"latent": key}))(params, x, key)


@pytest.mark.parametrize("weighted", [False, True])
def test_eval_matches_jax(weighted):
    """make_eval_fn against the JAX make_eval_fn with the same posterior
    noise: loss/recon/kl within 1e-5 relative, P/R/F1 equal; the
    weighted tail-batch branch included."""
    jc, tc = tiny_pair("c2_cropped")
    jmodel, params = jax_params(jc, tc, 6)
    rng = np.random.default_rng(6)
    # an O(1) posterior: at init mu ~ 0 and logvar ~ 0, and the KL is
    # all cancellation, below any relative tolerance
    zb = params["z_head"]["Dense_0"]["bias"]
    params["z_head"]["Dense_0"]["bias"] = (
        zb + rng.standard_normal(zb.shape).astype(np.float32))
    model = port_model(tc, params)
    x = bars(rng, (3, 4, 96, 128), 0.08)
    key = jax.random.key(11)
    eps = np.asarray(_eps_of(jmodel, params, jnp.asarray(x), key))
    lj, _ = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                      eps=(jnp.asarray(eps),))
    lk, _ = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                       rngs={"latent": key})
    np.testing.assert_allclose(np.asarray(lj), np.asarray(lk), atol=1e-6)
    w = np.array([1.0, 1.0, 0.0], np.float32) if weighted else None
    want = j_make_eval_fn(jc, jmodel)(params, {"x": jnp.asarray(x)}, key,
                                      None if w is None else jnp.asarray(w))
    got = make_eval_fn(tc, model)(torch.tensor(x), torch.tensor(eps),
                                  None if w is None else torch.tensor(w))
    assert sorted(got) == sorted(want)
    for k in ("loss", "recon", "kl"):
        assert abs(float(got[k]) - float(want[k])) <= \
            1e-5 * abs(float(want[k])), k
    for k in ("precision", "recall", "f1"):
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6), k


@pytest.mark.parametrize("cfg_kw,dtype", [
    ({}, np.uint8),
    ({"pitch_lo": 24, "pitch_hi": 108}, np.float32),
    ({"steps_per_quarter": 32, "quarters_per_bar": 3, "meter_numerator": 3,
      "meter_denominator": 4, "tempo_bpm": 90.0, "velocity": 64}, np.uint8),
])
def test_midi_export_byte_identical(cfg_kw, dtype):
    jc, _ = tiny_pair()
    jspec = jc.midi.__class__(**{**jc.midi.__dict__, **cfg_kw})
    tspec = port_midi_spec(jspec)
    roll = bars(np.random.default_rng(8), (4, 96, 128), 0.1).astype(dtype)
    got = tensorize.bars_to_midi_bytes(roll, tspec)
    assert got == jtens.bars_to_midi_bytes(roll, jspec)
    assert dataclasses.asdict(smf.parse_smf(got)) == \
        dataclasses.asdict(jsmf.parse_smf(got))


def _service(num_bars=3, samples=2):
    jc, tc = tiny_pair(use_pallas_conv1=True)
    tc = tc.replace(gen=GenSpec(num_bars=num_bars, num_samples=samples))
    _, params = jax_params(jc, tc, 9)
    return Service(tc, port_model(tc, params)), tc


def test_serve_protocol_in_process():
    service, tc = _service()
    lines = [{"id": 1, "seed": 3}, {"id": "b", "seed": 4},
             {"id": 2, "cmd": "stats"}, {"id": 3, "seed": 3}]
    inp = io.StringIO("".join(json.dumps(r) + "\n" for r in lines) + "\n")
    out = io.StringIO()
    assert serve_stream(service, inp, out) == 0
    resp = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["id"] for r in resp] == [1, "b", 2, 3]
    for r in (resp[0], resp[1], resp[3]):
        assert set(r) == {"id", "midi_b64", "density", "latency_ms"}
        assert len(r["midi_b64"]) == 2 and 0.0 <= r["density"] <= 1.0
        for m in r["midi_b64"]:
            midi = smf.parse_smf(base64.b64decode(m))
            assert midi.time_signatures == ((4, 4),)
            assert all(nt.end_tick <= 3 * 4 * 480 for nt in midi.notes)
    assert resp[0]["midi_b64"] == resp[3]["midi_b64"]      # same seed
    st = resp[2]["stats"]
    assert (st["served"], st["errors"], st["requests"]) == (2, 0, 2)
    assert (st["config"], st["samples"], st["bars"]) == ("c2_gru_4bar", 2, 3)


def test_serve_bars_equal_generate_fn():
    """A response's MIDI is the export of the sweep for that seed."""
    service, tc = _service()
    resp = service.handle(json.dumps({"id": 0, "seed": 21}))
    sweep = make_generate_fn(tc, service.model)
    sweep_bars = sweep(torch.Generator().manual_seed(21))
    assert sweep_bars.shape == (2, 3, 96, 128)
    for i, m in enumerate(resp["midi_b64"]):
        assert base64.b64decode(m) == tensorize.bars_to_midi_bytes(
            sweep_bars[i].numpy(), tc.midi)
    assert resp["density"] == pytest.approx(float(
        sweep_bars.float().mean()))


@pytest.mark.parametrize("req,match", [
    ("{not json", "JSONDecodeError"),
    ('{"id": 5, "cmd": "nope"}', "unknown cmd"),
    ('{"id": 5, "cmd": "reload"}', "reload needs a checkpoint directory"),
    ('{"id": 5, "seed_midi_b64": "TVRoZA=="}', "SMFError"),
    ('[1, 2]', "JSON object"),
])
def test_serve_errors_in_band(req, match):
    service, _ = _service(num_bars=1, samples=1)
    resp = service.handle(req)
    assert match in resp["error"]
    assert service.errors == 1 and service.served == 0
    ok = service.handle('{"id": 6, "seed": 1}')     # still serving
    assert ok["id"] == 6 and "midi_b64" in ok


@pytest.mark.parametrize("argv,match", [
    (["--coalesce", "0"], "--coalesce must be >= 1"),
    (["--pipeline", "--coalesce", "2"], "mutually exclusive"),
    (["--reload-every", "5"], "give --ckpt-dir"),
])
def test_serve_flag_errors(argv, match, capsys):
    """Flag combinations serve refuses with exit 2, before any model is
    built (the JAX package's checks, and --reload-every with nothing to
    poll)."""
    assert main(["serve", "--device", "cpu", *argv]) == 2
    assert match in capsys.readouterr().err


def test_serve_port_max_requests(capsys, monkeypatch):
    """``serve --port 0 --max-requests 1`` over random weights answers one
    request from a client and exits 0."""
    import threading

    from musicvae_tpu_torch import cli
    from musicvae_tpu_torch.client import ServeClient

    bound, done, midis = {}, {}, []
    real = cli.serve_socket

    def serve_socket(*a, **kw):      # learn the port the server bound
        ready = threading.Event()
        kw["on_listen"] = lambda h, p: (bound.update(port=p), ready.set())
        t = threading.Thread(target=lambda: done.update(
            rc=real(*a, **kw)), daemon=True)
        t.start()
        assert ready.wait(60)
        with ServeClient(port=bound["port"], timeout=60) as c:
            midis.extend(c.generate(seed=5))
        t.join(60)
        assert not t.is_alive()
        return done["rc"]

    monkeypatch.setattr(cli, "serve_socket", serve_socket)
    rc = main(["serve", "--device", "cpu", "--port", "0",
                      "--max-requests", "1", "--bars", "1", "--samples",
                      "1"])
    assert rc == 0 and len(midis) == 1 and midis[0][:4] == b"MThd"
    assert "served 1 requests, 0 errors" in capsys.readouterr().err
