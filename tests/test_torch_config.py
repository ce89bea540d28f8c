"""The port's config module against the JAX package's: every registered
config is the same, field for field."""

import dataclasses

import pytest

from musicvae_tpu import config as jcfg
from musicvae_tpu_torch import config as tcfg


def test_same_registered_names():
    assert tcfg.all_config_names() == jcfg.all_config_names()
    assert len(tcfg.all_config_names()) == 15


@pytest.mark.parametrize("name", jcfg.all_config_names())
def test_config_asdict_equal(name):
    t, j = tcfg.get_config(name), jcfg.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.midi.steps_per_bar == j.midi.steps_per_bar
    assert t.midi.meter == j.midi.meter


def test_spec_defaults_equal():
    for tc, jc in ((tcfg.MidiSpec, jcfg.MidiSpec),
                   (tcfg.ModelSpec, jcfg.ModelSpec),
                   (tcfg.TrainSpec, jcfg.TrainSpec),
                   (tcfg.GenSpec, jcfg.GenSpec),
                   (tcfg.MeshSpec, jcfg.MeshSpec),
                   (tcfg.Config, jcfg.Config)):
        assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())


def test_unknown_config_raises():
    with pytest.raises(KeyError, match="unknown config"):
        tcfg.get_config("nope")
