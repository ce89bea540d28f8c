"""The frozen reference (perfbench/reference/) against the program at small
f32 shapes on the CPU: the teacher-forced forward of both kinds, the
closed-loop decoder fed the bars the program served, the first train
steps, and the MIDI bytes. A test, unlike the reference, may import the
program."""

import numpy as np
import pytest
import torch

import tiny
from perfbench import harness
from perfbench.runners import train as train_runner
from perfbench.reference import midi as ref_midi
from perfbench.reference import model as ref


def _program(spec, params):
    from musicvae_tpu_torch.models.vae import PianoRollVAE
    cfg = harness.port_config(spec)
    model = PianoRollVAE(cfg.model, cfg.midi, cfg.train.remat_encoder)
    model.load_state_dict({k: v.clone() for k, v in params.items()})
    return cfg, model


@pytest.mark.parametrize("config", ["c2_gru_4bar", "c3_hier_16bar"])
def test_forward_matches_the_program(config):
    spec = tiny.spec(config)
    params = ref.make_params(ref.param_shapes(spec), 3, "cpu")
    cfg, model = _program(spec, params)
    gen = torch.Generator().manual_seed(1)
    n = spec["model"]["num_bars"]
    x = (torch.rand((3, n, 96, 128), generator=gen) < 0.1).to(torch.uint8)
    from musicvae_tpu_torch.models.vae import draw_eps
    eps = draw_eps(cfg.model, 3, gen)
    with torch.no_grad():
        logits, lat = model(x, eps)
        r_logits, r_lat = ref.forward(params, x, list(eps), spec)
    torch.testing.assert_close(r_logits, logits, rtol=1e-4, atol=1e-4)
    for (mu, lv), (rmu, rlv) in zip(lat, r_lat):
        torch.testing.assert_close(rmu, mu, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(rlv, lv, rtol=1e-4, atol=1e-5)


def test_teacher_forced_decoder_matches_the_closed_loop_sweep():
    spec = tiny.spec("c2_gru_4bar")
    mix = {"bars": 8, "samples": 3}
    params = ref.make_params(ref.param_shapes(spec), 4, "cpu",
                             bias={"head.deconvs.4.bias": 0.1})
    cfg, model = _program(spec, params)
    from musicvae_tpu_torch.generate.sampler import latent_path
    from perfbench.runners import serve
    z, reset = serve.latent_path(spec, mix, 99, "cpu")
    gen = torch.Generator().manual_seed(99)
    z_prog, reset_prog = latent_path(cfg, 3, 8, False, generator=gen)
    torch.testing.assert_close(z, z_prog, rtol=0, atol=0)
    assert reset == [bool(v) for v in reset_prog[0]]
    with torch.no_grad():
        logits, bars = model.generate(z_prog, reset_prog)
        r_logits = ref.decode_step_logits(params, bars, z, reset, spec)
    torch.testing.assert_close(r_logits, logits, rtol=1e-4, atol=1e-4)
    assert serve.logit_gap(spec, mix, params, [99], [bars.numpy()],
                           "cpu") < 1e-3


@pytest.mark.parametrize("workload,traffic", [
    ("c2_gru_4bar.train-resident", None),
    ("c3_hier_16bar.train-resident", None),
    ("c2_gru_4bar.train-resident", "train-stream")])
def test_first_train_steps_match_the_program(workload, traffic):
    su = train_runner.prepare(tiny.ctx(workload, traffic=traffic))
    got = train_runner.readings(su.spec, su.p0, train_runner.first_steps(su),
                       train_runner.reference_of(su))
    assert got["loss"] < 1e-6 and got["grad"] < 1e-5
    assert got["change"] < 1e-4


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_midi_bytes_match_the_program_and_read_back(density):
    from musicvae_tpu_torch.generate.sampler import bars_to_midi
    spec = tiny.spec("c2_gru_4bar")
    bars = (np.random.default_rng(5).random((16, 96, 128)) < density
            ).astype(np.uint8)
    data = bars_to_midi(bars, harness.port_config(spec))
    assert ref_midi.write(bars, spec) == data
    assert (ref_midi.read(data, spec, 16) == bars).all()


def test_midi_reader_refuses_what_it_cannot_read():
    spec = tiny.spec("c2_gru_4bar")
    data = ref_midi.write(np.ones((2, 96, 128), np.uint8), spec)
    with pytest.raises(ValueError):
        ref_midi.read(data, spec, 1)        # notes past the bars
    with pytest.raises(ValueError):
        ref_midi.read(b"RIFF" + data[4:], spec, 2)
