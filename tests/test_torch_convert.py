"""The port's ``convert`` and its safetensors reader and writer on the CPU:
files byte-identical to the ``safetensors`` package's, the torch state
dict's canonical form against the JAX package's torch → flax → torch round
trip (numpy, nothing compiled), all four directions through the CLI, the
shape check before anything is written, and ``--ema``."""

import dataclasses
import json
import os
import struct

import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from musicvae_tpu.checkpoints.torch_convert import (
    flax_params_to_torch_state_dict, torch_state_dict_to_flax)
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.checkpoints import safetensors_io
from musicvae_tpu_torch.checkpoints.convert import (StateDictMismatch,
                                                    canonical_state_dict)
from musicvae_tpu_torch.cli import main
from musicvae_tpu_torch.config import get_config
from musicvae_tpu_torch.models.vae import build_model
from musicvae_tpu_torch.train.trainer import create_state
from torch_port_helpers import tiny_pair
from torch_port_helpers import one_torch_thread  # noqa: F401

META = {"config": "c2_gru_4bar", "step": "7",
        "format": "musicvae_tpu/torch-names"}


def _tensors():
    """One tensor of every dtype the format names that torch makes on the
    CPU, odd shapes included (0-d, empty, 1-byte types)."""
    g = torch.Generator().manual_seed(0)
    return {"enc.w": torch.randn(3, 4, generator=g),
            "a.u8": torch.arange(5, dtype=torch.uint8),
            "bf": torch.randn(5, generator=g).to(torch.bfloat16),
            "h": torch.randn(2, 2, generator=g).to(torch.float16),
            "i64": torch.arange(3), "i32": torch.arange(4).int(),
            "i16": torch.arange(2).to(torch.int16),
            "i8": torch.arange(-2, 2).to(torch.int8),
            "u16": torch.arange(3).to(torch.uint16),
            "f64": torch.randn(2, generator=g).double(),
            "empty": torch.zeros(0, 2), "scalar": torch.tensor(2.5),
            "mask": torch.tensor([True, False, True]),
            "f8": torch.randn(4, generator=g).to(torch.float8_e4m3fn)}


def _bytes(t):
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("metadata", [None, {}, {"step": "3"}])
def test_safetensors_writer_is_byte_identical(tmp_path, metadata):
    """The port's writer gives the package's bytes for the same tensors."""
    a, b = str(tmp_path / "pkg.st"), str(tmp_path / "port.st")
    st_save_file(_tensors(), a, metadata=metadata)
    safetensors_io.save_file(_tensors(), b, metadata=metadata)
    assert open(a, "rb").read() == open(b, "rb").read()


def _split(path):
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    return n, json.loads(raw[8:8 + n]), raw[8 + n:]


def test_safetensors_metadata_order(tmp_path):
    """With the three keys convert writes, the package emits them in hash
    order (it changes between processes); the port sorts them. Apart from
    that order the files are the same: header length, header content and
    tensor bytes."""
    a, b = str(tmp_path / "pkg.st"), str(tmp_path / "port.st")
    st_save_file(_tensors(), a, metadata=META)
    safetensors_io.save_file(_tensors(), b, metadata=META)
    (na, ha, da), (nb, hb, db) = _split(a), _split(b)
    assert (na, ha, da) == (nb, hb, db)
    assert list(hb["__metadata__"]) == sorted(META)
    assert list(ha) == list(hb)                 # the same tensor order


def test_safetensors_reader_reads_the_package(tmp_path):
    path = str(tmp_path / "pkg.st")
    st_save_file(_tensors(), path, metadata=META)
    got, meta = safetensors_io.load_file(path)
    want = st_load_file(path)
    assert meta == META and list(got) == list(_split(path)[1])[1:]
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert _bytes(got[k]) == _bytes(t), k
    st_save_file({"x": torch.ones(2)}, path)
    assert safetensors_io.load_file(path)[1] is None


@pytest.mark.parametrize("damage", ["truncated", "gap", "tail", "short"])
def test_safetensors_reader_refuses_malformed(tmp_path, damage):
    path = str(tmp_path / "x.st")
    safetensors_io.save_file({"a": torch.ones(4), "b": torch.ones(2)}, path)
    n, header, data = _split(path)
    if damage == "truncated":
        raw = open(path, "rb").read()[:-3]
    elif damage == "short":
        raw = b"\x00" * 5
    else:
        if damage == "gap":     # "b" starts 4 bytes after "a" ends
            header["b"]["data_offsets"] = [20, 28]
            data = data[:16] + b"\x00" * 4 + data[16:]
        else:                   # bytes after the last tensor
            data = data + b"\x00" * 8
        text = json.dumps(header, separators=(",", ":")).encode()
        text += b" " * (-len(text) % 8)
        raw = struct.pack("<Q", len(text)) + text + data
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError):
        safetensors_io.load_file(path)


def _state_dict(cfg, seed):
    """A torch state dict for ``cfg`` with every GRU's r/z hidden biases
    nonzero (a reference-style model's, which flax cannot hold apart)."""
    sd = build_model(cfg, device="cpu", seed=seed).state_dict()
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if "bias" in k else v)
            for k, v in sd.items()}


def _jax_round_trip(sd, jc):
    return flax_params_to_torch_state_dict(torch_state_dict_to_flax(sd, jc),
                                           jc)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


def test_canonical_state_dict_matches_jax_round_trip():
    """The fold of bias_hh[:2H] into bias_ih[:2H] gives the JAX package's
    torch → flax → torch tensors bit for bit; the canonical form is a
    fixed point."""
    jc, tc = tiny_pair()
    sd = _state_dict(tc, 3)
    got = canonical_state_dict(sd, tc)
    _same(got, _jax_round_trip(sd, jc))
    h = tc.model.gru_hidden
    assert not got["dec_gru.bias_hh"][:2 * h].any()
    assert got["dec_gru.bias_hh"][2 * h:].any()
    _same(canonical_state_dict(got, tc), got)
    model = build_model(tc, device="cpu")
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("case", ["shape", "missing", "extra"])
def test_convert_refuses_a_mismatch_before_writing(tmp_path, capsys, case):
    """A state dict that is not c2's (another width, a missing or an
    unknown tensor) exits 2 naming it, and --out is never created."""
    _, tc = tiny_pair()
    sd = dict(build_model(get_config("c2_gru_4bar"), device="cpu",
                          seed=0).state_dict())
    if case == "shape":
        sd = build_model(tc, device="cpu", seed=0).state_dict()
        want = "expects"
    elif case == "missing":
        del sd["z_head.bias"]
        want = "z_head.bias: missing"
    else:
        sd["extra.weight"] = torch.ones(1)
        want = "extra.weight: not a parameter"
    src, out = tmp_path / "sd.pt", tmp_path / "out"
    torch.save(sd, src)
    assert main(["convert", "--from-torch", str(src), "--out", str(out),
                 "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "does not match config 'c2_gru_4bar'" in err and want in err
    assert not out.exists()
    with pytest.raises(StateDictMismatch):
        canonical_state_dict(sd, get_config("c2_gru_4bar"))


def test_convert_all_directions_match_jax(tmp_path, capsys):
    """Full-width c2: --from-torch (a {'model': ...} bundle, nonzero r/z
    hidden biases) → --to-safetensors → --from-safetensors →
    --to-torch gives the JAX package's round trip of the same file bit
    for bit; the checkpoints written carry --step and a fresh optimizer;
    the safetensors file has the JAX package's metadata keys."""
    cfg = get_config("c2_gru_4bar")
    from musicvae_tpu.config import get_config as j_get_config

    sd = _state_dict(cfg, 5)
    src = tmp_path / "ref.pt"
    torch.save({"model": sd, "epoch": 3}, src)
    cpu = ["--device", "cpu"]
    ck1, ck2 = tmp_path / "ck1", tmp_path / "ck2"
    st, back = tmp_path / "m.safetensors", tmp_path / "back.pt"
    for argv in (["--from-torch", src, "--out", ck1, "--step", 7],
                 ["--to-safetensors", ck1, "--out", st],
                 ["--from-safetensors", st, "--out", ck2, "--step", 9],
                 ["--to-torch", ck2, "--out", back]):
        assert main(["convert", *map(str, argv), *cpu]) == 0, \
            capsys.readouterr().err
    out = capsys.readouterr().out
    assert "converted" in out and "step 7" in out
    _same(torch.load(back, weights_only=True),
          _jax_round_trip(sd, j_get_config("c2_gru_4bar")))
    _, meta = safetensors_io.load_file(str(st))
    assert meta == {"config": "c2_gru_4bar", "step": "7",
                    "format": "musicvae_tpu/torch-names"}
    m = ckpt_io.make_manager(str(ck2))
    assert m.all_steps() == [9]
    _, state = create_state(ckpt_io.restore_config(m), device="cpu")
    state, _ = ckpt_io.restore(m, state)
    assert int(state.step) == 9 and int(state.opt.count) == 0
    assert not any(t.any() for t in state.opt.mu)


def test_convert_ema(tmp_path, capsys):
    """--to-torch --ema exports the checkpoint's EMA weights, without it
    the trained ones; --ema on a checkpoint without EMA weights exits 2
    with the JAX package's message."""
    _, tc = tiny_pair()
    for name, ema in (("with", 0.9), ("without", 0.0)):
        cfg = tc.replace(train=dataclasses.replace(tc.train,
                                                   ema_decay=ema))
        _, state = create_state(cfg, device="cpu", seed=1)
        if state.ema_model is not None:
            with torch.no_grad():
                for p in state.ema_model.parameters():
                    p.add_(1.0)
        state.step.fill_(4)
        assert ckpt_io.save(ckpt_io.make_manager(str(tmp_path / name)),
                            state, cfg, wait=True)
        if name == "with":
            want = {"": state.model.state_dict(),
                    "--ema": state.ema_model.state_dict()}
    for flag, sd in want.items():
        out = tmp_path / f"x{flag}.pt"
        assert main(["convert", "--to-torch", str(tmp_path / "with"),
                     "--out", str(out), "--device", "cpu"]
                    + ([flag] if flag else [])) == 0
        _same(torch.load(out, weights_only=True),
              canonical_state_dict(sd, tc))
    capsys.readouterr()
    assert main(["convert", "--to-safetensors", str(tmp_path / "without"),
                 "--out", str(tmp_path / "y.st"), "--ema",
                 "--device", "cpu"]) == 2
    assert ("--ema needs a checkpoint trained with --ema-decay > 0"
            in capsys.readouterr().err)
    assert not os.path.exists(tmp_path / "y.st")


def test_convert_needs_exactly_one_direction(capsys):
    assert main(["convert", "--from-torch", "x", "--to-torch", "y",
                 "--out", "z"]) == 2
    assert main(["convert", "--out", "z"]) == 2
    assert "exactly one of" in capsys.readouterr().err
