"""The port's coalesced serving against the single-request path and the
JAX package: ``make_coalesced_generate_fn`` slot by slot, the runner's two
tiers, stdin ``--coalesce`` and ``--pipeline`` against serial serving, the
reload barrier, the response helpers against the JAX package's own, and
``serve --sample-temperature`` and ``--meter``."""

import base64
import dataclasses
import io as stdio
import json
import queue
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musicvae_tpu.cli as jcli
from musicvae_tpu import config as jcfg
from musicvae_tpu.generate import sampler as jsampler
from musicvae_tpu.midi import tensorize as jtens
from musicvae_tpu.ops import pack as jpack
from musicvae_tpu_torch import cli
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.generate import sampler
from musicvae_tpu_torch.ops.pack import unpack_bits_np
from musicvae_tpu_torch.train.trainer import create_state
from torch_port_helpers import (jax_params, jitted, port_midi_spec,
                                port_model, tiny_pair)
from torch_port_helpers import one_torch_thread  # noqa: F401

U_MARGIN = 1e-6       # |u − σ(l/T)| below which a Bernoulli cell may flip
BARS, SAMPLES = 3, 2


def _cfgs(mode="threshold", seed=21, **gen_kw):
    """(JAX config, port config, flax model, flax params, port model) at
    tiny f32 widths with the first-conv kernel's path, 2 samples x 3
    bars."""
    jc, tc = tiny_pair(use_pallas_conv1=True)
    gen = dict(num_bars=BARS, num_samples=SAMPLES, sample_mode=mode,
               **gen_kw)
    jc = jc.replace(gen=dataclasses.replace(jc.gen, **gen))
    tc = tc.replace(gen=GenSpec(**gen))
    jmodel, params = jax_params(jc, tc, seed)
    return jc, tc, jmodel, params, port_model(tc, params)


def _seed_bars(w, rng, seeded=(1,)):
    """[W, B, T, P] uint8: zeros, except a random bar repeated over the
    samples of each slot in ``seeded``."""
    sb = np.zeros((w, SAMPLES, 96, 128), np.uint8)
    for i in seeded:
        sb[i] = (rng.random((96, 128)) < 0.1).astype(np.uint8)
    return sb


@pytest.mark.parametrize("mode", ["threshold", "bernoulli"])
def test_coalesced_slots_equal_the_single_path(mode):
    """W=3, a seeded slot between two plain ones: slot i's draws are
    seed i's generator's, in the single path's order, and its bars equal
    make_generate_fn's for that seed exactly (one thread on the CPU; the
    batch of 6 rows does not change a row's arithmetic here)."""
    _, tc, _, _, model = _cfgs(mode, interpolate=mode == "bernoulli")
    sb = _seed_bars(3, np.random.default_rng(0))
    seeds = (5, 2 ** 63 + 7, -3)
    packed = sampler.make_coalesced_generate_fn(tc, model)(
        [sampler.seed_generator(s, "cpu") for s in seeds],
        torch.from_numpy(sb))
    assert packed.dtype == torch.uint8
    assert packed.shape == (3, SAMPLES, BARS, 96, 16)
    got = unpack_bits_np(packed.numpy())
    single = sampler.make_generate_fn(tc, model)
    for i, s in enumerate(seeds):
        want = single(sampler.seed_generator(s, "cpu"),
                      seed_bar=torch.from_numpy(sb[i]) if i == 1 else None)
        np.testing.assert_array_equal(got[i], want.numpy())
    assert not np.array_equal(got[0], got[2])
    with pytest.raises(ValueError, match="outside the range"):
        sampler.seed_generator(2 ** 64, "cpu")


def _jax_slot_draws(key, jc):
    """The normals and Bernoulli uniforms the JAX sweep draws from one
    slot's key (its latent path's normals, then a uniform a bar)."""
    k_z, _, _, _, k_bin = jax.random.split(key, 5)
    noise = np.asarray(jax.random.normal(k_z, (1, SAMPLES, 16)))
    bin_keys = jax.random.split(k_bin, BARS)
    u = np.stack([np.asarray(jax.random.uniform(bk, (SAMPLES, 96, 128)))
                  for bk in bin_keys], axis=1)              # [B,N,T,P]
    return k_z, bin_keys, noise, u


def test_coalesced_matches_jax_coalesced():
    """The JAX package's make_coalesced_generate_fn, W=3 (one seeded
    slot), Bernoulli at T=0.7: its per-slot draws handed to the port's
    coalesced sweep give the same packed bars, except cells whose uniform
    lies within U_MARGIN of the JAX probability (bar by bar while the
    bars agree)."""
    jc, tc, jmodel, params, model = _cfgs("bernoulli",
                                          sample_temperature=0.7)
    sb = _seed_bars(3, np.random.default_rng(1))
    seeds = (3, 4, 5)
    kd = np.array([[0, s] for s in seeds], np.uint32)
    want = np.asarray(jsampler.make_coalesced_generate_fn(jc, jmodel)(
        params, jax.random.wrap_key_data(jnp.asarray(kd)), jnp.asarray(sb),
        jnp.zeros((3, SAMPLES, BARS), jnp.int32),
        jnp.zeros((3, SAMPLES), jnp.int32)))
    draws = [_jax_slot_draws(jax.random.key(s), jc) for s in seeds]
    got = sampler.make_coalesced_generate_fn(tc, model)(
        [None] * 3, torch.from_numpy(sb),
        noises=[torch.tensor(d[2]) for d in draws],
        uniforms=[torch.tensor(d[3]) for d in draws]).numpy()
    assert got.shape == want.shape
    compared = flips = 0
    for i, (k_z, bin_keys, _, u) in enumerate(draws):
        z_j, reset_j = jsampler.latent_path(k_z, jc, SAMPLES, BARS, False)
        logits_j, _ = jitted(jmodel, "generate")(
            params, z_j, reset_j, jnp.asarray(sb[i]), bin_keys=bin_keys,
            sample_temperature=0.7)
        p = np.asarray(jax.nn.sigmoid(logits_j / 0.7))
        g, w = jpack.unpack_bits_np(got[i]), jpack.unpack_bits_np(want[i])
        for k in range(BARS):
            diff = g[:, k] != w[:, k]
            assert not (diff & ~(np.abs(u[:, k] - p[:, k]) < U_MARGIN)
                        ).any(), f"slot {i} bar {k}: flip outside margin"
            compared += 1
            flips += int(diff.sum())
            if diff.any():
                break
    print(f"coalesced vs JAX: {compared} bars compared, {flips} flips")
    assert compared >= 3 * BARS - 2


def _service(tc, model, step=0):
    return cli.Service(tc, model, step)


def test_lone_tier_equals_full_tier():
    """A lone request (W=1) and the same request padded into the full
    width give the same bars; a pad slot never reaches the caller."""
    _, tc, _, _, model = _cfgs()
    runner = cli._CoalescedRunner(_service(tc, model), 3)
    rng = np.random.default_rng(2)
    bar = (rng.random((96, 128)) < 0.1).astype(np.uint8)
    for sb in (None, bar):
        lone = runner.run([(sampler.seed_generator(9, "cpu"), sb)])
        full = runner.run([(sampler.seed_generator(9, "cpu"), sb),
                           (sampler.seed_generator(1, "cpu"), None)])
        assert len(lone) == 1 and len(full) == 2
        assert lone[0].shape == (SAMPLES, BARS, 96, 128)
        np.testing.assert_array_equal(lone[0], full[0])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A port checkpoint directory (checkpoints/io.py) of the tiny c2 with
    the first-conv flag and EMA weights at step 1, and a MIDI file."""
    _, tc = tiny_pair(use_pallas_conv1=True)
    tc = tc.replace(train=dataclasses.replace(tc.train, ema_decay=0.9))
    root = tmp_path_factory.mktemp("serve_ckpt")
    _, state = create_state(tc, device="cpu", seed=4)
    state.step.fill_(1)
    assert ckpt_io.save(ckpt_io.make_manager(str(root / "ck")), state, tc,
                        wait=True)
    midi = synth_corpus(1, 4, seed=3)[0][0]
    return str(root / "ck"), tc, base64.b64encode(midi).decode()


def _lines(b64):
    reqs = [{"id": 0, "seed": 3}, {"id": 1, "seed_midi_b64": b64},
            {"id": 2, "cmd": "stats"}, {"id": 3, "seed": 3},
            {"id": 4, "seed_midi_b64": "bm90IG1pZGk="}, "{bad json",
            {"id": 6, "cmd": "nope"}, {"id": 7, "seed": 2 ** 70},
            {"id": 8}, {"id": 9, "seed": 8, "seed_midi_b64": b64}]
    return "".join((r if isinstance(r, str) else json.dumps(r)) + "\n"
                   for r in reqs) + "\n"


def _serve_cli(argv, stdin, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", stdio.StringIO(stdin))
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    assert rc == 0, err
    return [json.loads(ln) for ln in out.splitlines()], err


def _strip(resp):
    """A response without its timings."""
    r = {k: v for k, v in resp.items() if k != "latency_ms"}
    if "stats" in r:
        r["stats"] = {k: v for k, v in r["stats"].items()
                      if k != "uptime_s"}
    return r


def test_stdin_coalesce_and_pipeline_equal_serial(ckpt, capsys,
                                                  monkeypatch):
    """The same request lines (plain, seeded, stats, errors, default
    seeds) through ``serve`` serial, ``--pipeline`` and ``--coalesce 3``
    over a port checkpoint: the same responses, bytes and order, timings
    aside."""
    ck, _, b64 = ckpt
    base = ["serve", "--ckpt-dir", ck, "--bars", BARS, "--samples", SAMPLES,
            "--device", "cpu"]
    runs = {name: _serve_cli(base + extra, _lines(b64), capsys,
                             monkeypatch)
            for name, extra in (("serial", []), ("pipeline", ["--pipeline"]),
                                ("coalesce", ["--coalesce", 3]),
                                ("warm", ["--warm-seed"]))}
    serial = [_strip(r) for r in runs["serial"][0]]
    assert [r["id"] for r in serial] == [0, 1, 2, 3, 4, None, 6, 7, 8, 9]
    assert serial[0]["midi_b64"] == serial[3]["midi_b64"]
    assert serial[1]["midi_b64"] != serial[0]["midi_b64"]
    assert serial[2]["stats"]["requests"] == 2
    assert serial[2]["stats"]["step"] == 1
    for i, frag in ((4, "SMFError"), (5, "JSONDecodeError"),
                    (6, "unknown cmd 'nope'"), (7, "outside the range")):
        assert frag in serial[i]["error"], serial[i]
    for name in ("pipeline", "coalesce", "warm"):
        assert [_strip(r) for r in runs[name][0]] == serial, name
    assert "coalescing up to 3 requests/dispatch" in runs["coalesce"][1]
    assert "served 5 requests, 4 errors" in runs["coalesce"][1]


def test_reload_barrier_mid_batch(ckpt, tmp_path, monkeypatch):
    """A ``reload`` line inside one drained batch splits it: the requests
    before it run on step 1, those after it on step 2, as a serial service
    on each step's weights answers them."""
    import shutil

    ck0, tc, _ = ckpt
    ck = str(tmp_path / "ck")
    shutil.copytree(ck0, ck)
    tc = tc.replace(gen=GenSpec(num_bars=BARS, num_samples=SAMPLES))
    cfg, state = cli.restore_checkpoint(ck, "cpu", lambda c: c.replace(
        gen=tc.gen))
    service = cli.Service(cfg, state.model, int(state.step))
    manager = ckpt_io.make_manager(ck)
    service.reload_once = cli._make_reload_once(manager, service)
    _, new = create_state(cfg, device="cpu", seed=99)
    new.step.fill_(2)
    assert ckpt_io.save(manager, new, cfg, wait=True)
    lines = [json.dumps(r) for r in (
        {"id": "a", "seed": 1}, {"id": "b", "seed": 2},
        {"id": "r", "cmd": "reload"}, {"id": "c", "seed": 1},
        {"id": "s", "cmd": "stats"})]

    def one_window(inp):        # every line queued before the first drain
        q = queue.Queue()
        for ln in inp:
            q.put(ln)
        q.put(None)
        return q

    monkeypatch.setattr(cli, "_line_queue", one_window)
    calls = []
    runner = cli._CoalescedRunner(service, 8)
    real_run = runner.run
    runner.run = lambda items: calls.append(len(items)) or real_run(items)
    out = stdio.StringIO()
    cli.serve_stream_coalesced(service, runner,
                               stdio.StringIO("\n".join(lines) + "\n"), out)
    resp = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
    assert calls == [2, 1]
    assert resp["r"] == {"id": "r", "reloaded": 2, "step": 2}
    assert resp["s"]["stats"]["step"] == 2
    old = cli.Service(cfg, state.model)
    fresh = cli.Service(cfg, new.model)
    for rid, svc, seed in (("a", old, 1), ("b", old, 2), ("c", fresh, 1)):
        assert resp[rid]["midi_b64"] == svc.handle(json.dumps(
            {"seed": seed}))["midi_b64"], rid
    assert resp["a"]["midi_b64"] != resp["c"]["midi_b64"]


def test_response_helpers_match_jax():
    """_gen_response, _stats_response and _check_cmd's errors equal the
    JAX package's own functions."""
    jc, tc = tiny_pair()
    bars = (np.random.default_rng(3).random((2, 2, 96, 128)) < 0.05
            ).astype(np.uint8)
    a = jcli._gen_response(7, bars, jc, 0.0)
    b = cli._gen_response(7, bars, tc, 0.0)
    assert a.keys() == b.keys() == {"id", "midi_b64", "density",
                                    "latency_ms"}
    assert (a["midi_b64"], a["density"]) == (b["midi_b64"], b["density"])
    t0 = 0.0
    a = jcli._stats_response("s", jc, {"step": 12}, 3, 1, 5, t0)
    b = cli._stats_response("s", tc, 12, 3, 1, 5, t0)
    assert a.keys() == b.keys() and a["stats"].keys() == b["stats"].keys()
    for k in a["stats"]:
        if k != "uptime_s":
            assert a["stats"][k] == b["stats"][k], k
    assert abs(a["stats"]["uptime_s"] - b["stats"]["uptime_s"]) <= 0.1
    for req in ({"cmd": "nope"}, {"cmd": 3}, {"cmd": "STATS"}):
        with pytest.raises(ValueError) as ja:
            jcli._check_cmd(req)
        with pytest.raises(ValueError) as pa:
            cli._check_cmd(req)
        assert str(pa.value) == str(ja.value)
    for req in ({"cmd": "stats"}, {"cmd": "reload"}, {"seed": 1}):
        jcli._check_cmd(req)
        cli._check_cmd(req)


def _serve_args(*extra):
    return cli.make_parser().parse_args(
        ["serve", "--bars", str(BARS), "--samples", str(SAMPLES),
         "--device", "cpu", *extra])


def test_serve_sample_temperature_matches_jax():
    """``serve --sample-mode bernoulli --sample-temperature 0.5``: the
    served config's sweep, with the JAX sweep's draws handed in, equals
    the JAX sweep at that temperature (cells within U_MARGIN of their
    probability may flip)."""
    jc, tc, jmodel, params, model = _cfgs("bernoulli",
                                          sample_temperature=0.5)
    cfg = cli.serve_config(_serve_args("--sample-mode", "bernoulli",
                                       "--sample-temperature", "0.5"),
                           tc.replace(gen=GenSpec()))
    assert cfg.gen == tc.gen
    key = jax.random.key(22)
    want = np.asarray(jsampler.make_generate_fn(jc, jmodel)(params, key))
    k_z, bin_keys, noise, u = _jax_slot_draws(key, jc)
    z_j, reset_j = jsampler.latent_path(k_z, jc, SAMPLES, BARS, False)
    logits_j, _ = jitted(jmodel, "generate")(
        params, z_j, reset_j, bin_keys=bin_keys, sample_temperature=0.5)
    p = np.asarray(jax.nn.sigmoid(logits_j / 0.5))
    got = sampler.make_generate_fn(cfg, model)(
        None, noise=torch.tensor(noise), uniforms=torch.tensor(u)).numpy()
    # at T=1 instead, the cells whose uniform lies between σ(l) and
    # σ(2l) (|Δp| ~ 1e-4 here, far above U_MARGIN) would flip
    for k in range(BARS):
        diff = got[:, k] != want[:, k]
        assert not (diff & ~(np.abs(u[:, k] - p[:, k]) < U_MARGIN)).any()
        if diff.any():
            break


def test_serve_meter_flag_tensorizes_seed_midi_on_its_grid():
    """``serve --meter 3/4``: a 3/4 seed file tensorizes on the 3/4 grid,
    as the JAX package's tensorizer gives it; without the flag the file's
    time signature is refused (in-band)."""
    jc, tc = tiny_pair()
    data = synth_corpus(1, 4, seed=5, meter=(3, 4))[0][0]
    b64 = base64.b64encode(data).decode()
    cfg = cli.serve_config(_serve_args("--meter", "3/4"), tc)
    assert cfg.midi.steps_per_quarter == 32
    jmidi = dataclasses.replace(jc.midi, **jcfg.meter_grid(3, 4))
    assert port_midi_spec(jmidi) == cfg.midi
    want = jtens.corpus_to_bars([data], jmidi, as_uint8=True)[0][-1]
    np.testing.assert_array_equal(cli._seed_bar(cfg, b64), want)
    with pytest.raises(ValueError):
        cli._seed_bar(cli.serve_config(_serve_args(), tc), b64)
