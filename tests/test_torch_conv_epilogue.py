"""The conv pyramid's epilogue (musicvae_tpu_torch/ops/conv_epilogue.py,
csrc/conv_epilogue.cu), checked on the CPU where the kernels cannot run:

- the plain versions are ATen's chain after a conv with a bias (the
  broadcast add, the transposed conv's crop, the tanh-GELU, the logits'
  cast), forward and backward, bit for bit;
- the models' conv pyramid through ``conv_epilogue`` gives a c2-shaped
  model's loss and gradients of the pre-epilogue code (convs with their
  bias, ATen's chain after them);
- the wrapper's checks refuse what the kernels cannot take;
- the kernels' index arithmetic and bias-gradient tree, mirrored here in
  numpy, write every element once, read dy where the crop keeps it, and sum
  each channel's positions.

The card holds the kernels themselves against the plain versions
(chip_smoke.py ``epilogue``, and the cuda-marked test below)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch.models import layers
from musicvae_tpu_torch.models.vae import build_model
from musicvae_tpu_torch.ops import conv_epilogue as ce
from musicvae_tpu_torch.parallel.tp import column_in, column_out

# (name, C, conv grid, crop, gelu, logits): a trunk conv, a head transposed
# conv with its crop, the head's last layer (C = 1, [97, 129] cropped to
# the [96, 128] bar, f32 logits), and a patch head's output conv
CASES = [("conv", 8, (6, 8), None, True, False),
         ("deconv", 8, (7, 9), (6, 8), True, False),
         ("deconv_c16", 16, (13, 17), (12, 16), True, False),
         ("last", 1, (97, 129), (96, 128), False, True),
         ("out_conv", 16, (6, 4), None, False, True)]
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(ch, grid, crop, dt, logits, seed=0):
    """c [2,C,H,W] channels-last (an NHWC tensor's NCHW view, as cuDNN
    hands it over), b [C], dy over the kept grid in the output dtype."""
    g = torch.Generator().manual_seed(seed)
    h, w = grid
    ho, wo = crop or grid
    c = (1.5 * torch.randn(2, h, w, ch, generator=g)).to(dt)
    b = (0.5 * torch.randn(ch, generator=g)).to(dt)
    out = torch.float32 if logits else dt
    dy = (0.1 * torch.randn(2, ho, wo, ch, generator=g)).to(out)
    return c.permute(0, 3, 1, 2), b, dy, out


def _chain(c, b, crop, gelu, out):
    """ATen's chain as the pre-epilogue layers ran it after cuDNN: the
    conv's ``add_`` of the bias, the crop view, the GELU, the cast."""
    h = c + b.view(1, -1, 1, 1)
    if crop is not None:
        h = h[:, :, :crop[0], :crop[1]]
    if gelu:
        h = F.gelu(h, approximate="tanh")
    return h.to(out).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dt", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_is_atens_chain(case, dt):
    """Forward values, and dc and db under autograd, equal the chain's bit
    for bit."""
    _, ch, grid, crop, gelu, logits = case
    c, b, dy, out = _inputs(ch, grid, crop, dt, logits)
    cl, bl = c.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = _chain(cl, bl, crop, gelu, out)
    want_dc, want_db = torch.autograd.grad(want, (cl, bl), dy)
    cg, bg = c.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = ce.conv_epilogue(cg, bg, crop, gelu, out)
    dc, db = torch.autograd.grad(got, (cg, bg), dy)
    assert got.dtype == out and got.is_contiguous()
    assert tuple(got.shape) == (2, *(crop or grid), ch)
    assert torch.equal(got, want)
    assert dc.dtype == dt and db.dtype == dt
    assert torch.equal(dc, want_dc) and torch.equal(db, want_db)
    if crop is not None:       # the cropped edge: a true zero gradient
        assert not dc[:, :, crop[0]:].any()
        assert not dc[:, :, :, crop[1]:].any()


# -- the models, through the epilogue and as they were -----------------------

def _trunk_before(self, x):
    """``ConvTrunk.forward`` before the epilogue: NCHW views, each conv
    with its bias, then the GELU."""
    dt = self.compute_dtype
    convs = list(self.convs)
    if self.patch is not None:
        h = layers.space_to_depth(x.to(dt), *self.patch).permute(0, 3, 1, 2)
    elif self.first_conv_kernel and tuple(x.shape[1:]) == (96, 128):
        c0 = convs.pop(0)
        w = c0.weight[:, 0].permute(1, 2, 0).contiguous()
        h = layers.first_conv_s2(x, w, c0.bias, gelu=True, out_dtype=dt)
        h = column_out(h, -1, c0).permute(0, 3, 1, 2)
    else:
        h = x.to(dt)[:, None]
    for conv in convs:
        h = layers._gelu(F.conv2d(column_in(h, conv), conv.weight.to(dt),
                                  conv.bias.to(dt), stride=conv.stride,
                                  padding=1))
        h = column_out(h, 1, conv)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _upsample_before(h, deconvs, dt, gelu_last):
    for i, d in enumerate(deconvs):
        t, p = h.shape[2], h.shape[3]
        h = F.conv_transpose2d(column_in(h, d), d.weight.to(dt),
                               d.bias.to(dt), stride=2)[:, :, :2 * t, :2 * p]
        if gelu_last or i + 1 < len(deconvs):
            h = layers._gelu(h)
        h = column_out(h, 1, d)
    return h


def _head_before(self, v):
    h = layers._gelu(self.fc(v))
    h = h.reshape(h.shape[0], self.t0, self.p0, -1).permute(0, 3, 1, 2)
    h = _upsample_before(h, self.deconvs, self.compute_dtype, False)
    return h[:, 0, :self.steps, :self.pitches].to(
        self.logits_dtype).contiguous()


def _patch_head_before(self, v):
    dt = self.compute_dtype
    h = layers._gelu(self.fc(v))
    h = h.reshape(h.shape[0], self.t0, self.p0, -1).permute(0, 3, 1, 2)
    h = _upsample_before(h, self.deconvs, dt, True)
    h = F.conv2d(column_in(h, self.out), self.out.weight.to(dt),
                 self.out.bias.to(dt), padding=1)
    h = layers.depth_to_space(column_out(h, 1, self.out).permute(0, 2, 3, 1),
                              *self.patch)
    return h[:, :self.steps, :self.pitches].to(self.logits_dtype).contiguous()


TINY = dict(enc_channels=(4, 8, 8, 8, 8), dec_channels=(8, 8, 8, 8, 8),
            z_dim=16, gru_hidden=32, bar_feat_dim=32)
PATCH_TINY = dict(enc_channels=(8, 8, 16), dec_channels=(16, 8, 8),
                  z_dim=8, gru_hidden=16, bar_feat_dim=16)
# (registered config, widths, tolerance): the first conv without its
# kernel takes a one-channel input that is now a channels-last view, and
# the CPU's f32 conv takes another path for it (bf16 and every later conv
# keep their bits)
MODELS = {"c2": ("c2_gru_4bar", TINY, {"float32": 1e-5, "bfloat16": 0.0}),
          "c2_k1": ("c2_gru_4bar", {**TINY, "use_pallas_conv1": True},
                    {"float32": 0.0, "bfloat16": 0.0}),
          "c2_mxu": ("c2_mxu", PATCH_TINY, {"float32": 0.0,
                                            "bfloat16": 0.0})}


def _loss_and_grads(model, x, eps):
    logits, latents = model(x, eps)
    w = torch.linspace(-0.5, 1.0, logits.numel()).view_as(logits)
    loss = (logits.float() * w).sum() + sum(
        (mu.float() ** 2).sum() + lv.float().sum() for mu, lv in latents)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", tuple(MODELS))
def test_model_loss_and_grads_unchanged(name, dtype, monkeypatch):
    """A c2-shaped model (with and without the first-conv kernel's plain
    version) and the patch stem's c2_mxu at tiny widths on the CPU: the
    loss and every parameter's gradient through ``conv_block`` equal the
    pre-epilogue layers' bit for bit (on the CPU it runs ATen's conv with
    its bias and the same chain on NHWC views of the same tensors), but
    for ``MODELS``' one tolerance, relative to each gradient's norm."""
    registered, kw, tol = MODELS[name]
    cfg = tcfg.get_config(registered)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype,
                                                **kw))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", seed=5)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((2, cfg.model.num_bars, 96, 128))
                          < 0.08).astype(np.uint8))
    eps = (torch.from_numpy(rng.standard_normal(
        (2, cfg.model.z_dim)).astype(np.float32)),)
    loss, grads = _loss_and_grads(model, x, eps)
    monkeypatch.setattr(layers.ConvTrunk, "forward", _trunk_before)
    monkeypatch.setattr(layers.BarDecoderHead, "forward", _head_before)
    monkeypatch.setattr(layers.PatchHead, "forward", _patch_head_before)
    want_loss, want_grads = _loss_and_grads(model, x, eps)
    tol = tol[dtype]
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    assert abs(loss - want_loss) <= tol * abs(want_loss)
    for (pname, _), g, w in zip(model.named_parameters(), grads, want_grads):
        assert float((g - w).norm()) <= tol * float(w.norm()), pname


# -- the wrapper's checks ------------------------------------------------------

def _nhwc(n, h, w, c, dt=torch.bfloat16):
    return torch.zeros(n, h, w, c, dtype=dt).permute(0, 3, 1, 2)


def _misaligned():
    """A channels-last [1,8,2,2] bf16 view whose data starts 2 bytes into
    its storage."""
    return torch.zeros(1 + 32, dtype=torch.bfloat16)[1:].view(
        1, 2, 2, 8).permute(0, 3, 1, 2)


REFUSED = {
    "nchw_layout": lambda: (torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16),
                            torch.zeros(8, dtype=torch.bfloat16), None,
                            torch.bfloat16),
    "f16": lambda: (_nhwc(2, 4, 4, 8, torch.float16),
                    torch.zeros(8, dtype=torch.float16), None, torch.float16),
    "out_f16": lambda: (_nhwc(2, 4, 4, 8), torch.zeros(8, dtype=torch.bfloat16),
                        None, torch.float16),
    "c_not_dividing_2048": lambda: (_nhwc(2, 4, 4, 3),
                                    torch.zeros(3, dtype=torch.bfloat16),
                                    None, torch.bfloat16),
    "bias_dtype": lambda: (_nhwc(2, 4, 4, 8), torch.zeros(8), None,
                           torch.bfloat16),
    "bias_shape": lambda: (_nhwc(2, 4, 4, 8),
                           torch.zeros(4, dtype=torch.bfloat16), None,
                           torch.bfloat16),
    "crop_outside": lambda: (_nhwc(2, 4, 4, 8),
                             torch.zeros(8, dtype=torch.bfloat16), (5, 4),
                             torch.bfloat16),
    "misaligned": lambda: (_misaligned(), torch.zeros(8, dtype=torch.bfloat16),
                           None, torch.bfloat16),
    "not_4d": lambda: (torch.zeros(2, 4, 8, dtype=torch.bfloat16),
                       torch.zeros(8, dtype=torch.bfloat16), None,
                       torch.bfloat16),
}


@pytest.mark.parametrize("what", tuple(REFUSED))
def test_check_refuses_what_the_kernels_cannot_take(what):
    """``check``, which the wrapper runs before a CUDA launch, on a CPU
    stand-in: each input the kernels cannot take raises ValueError."""
    c, b, crop, out = REFUSED[what]()
    with pytest.raises(ValueError):
        ce.check("conv_epilogue", c, b, crop, out)


@pytest.mark.parametrize("ch, grid, crop", [(8, (4, 4), None),
                                            (1, (97, 129), (96, 128)),
                                            (512, (7, 5), (6, 4))])
def test_check_takes_the_pyramids_layers(ch, grid, crop):
    """Channels-last bf16 and f32 conv outputs of the pyramid's shapes pass,
    and the kept grid comes back."""
    for dt in DTYPES:
        c = _nhwc(2, *grid, ch, dt)
        got = ce.check("conv_epilogue", c, torch.zeros(ch, dtype=dt), crop,
                       torch.float32)
        assert got == (crop or grid)


# -- the kernels' arithmetic, mirrored -------------------------------------------

def _fwd_indices(n, hc, wc, ch, ho, wo):
    """For every element the forward writes (flat y index e): the flat
    index of c it reads, by the kernel's arithmetic (row r = e / (wo·C),
    k = e mod (wo·C), bar b = r / ho, row i = r mod ho)."""
    e = np.arange(n * ho * wo * ch)
    length = wo * ch
    r, k = e // length, e % length
    b, i = r // ho, r % ho
    return (b * hc + i) * wc * ch + k


def _bwd_indices(n, hc, wc, ch, ho, wo):
    """For every element of dc (flat e): whether the crop keeps it and the
    flat index of dy it reads, by the kernel's arithmetic."""
    e = np.arange(n * hc * wc * ch)
    row, length = wc * ch, wo * ch
    r, k = e // row, e % row
    b, i = r // hc, r % hc
    keep = (i < ho) & (k < length)
    return keep, (b * ho + i) * length + k


SHAPES = [(3, 7, 9, 8, 6, 8), (2, 97, 129, 1, 96, 128), (2, 6, 8, 16, 6, 8),
          (1, 13, 9, 256, 12, 8), (5, 4, 3, 2, 4, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_index_arithmetic_reads_the_kept_grid(shape):
    """The forward reads exactly c[:, :ho, :wo] in y's order; the backward
    reads every dy element once, at its own position in the grid, and
    writes zero elsewhere."""
    n, hc, wc, ch, ho, wo = shape
    grid = np.arange(n * hc * wc * ch).reshape(n, hc, wc, ch)
    np.testing.assert_array_equal(_fwd_indices(*shape),
                                  grid[:, :ho, :wo].reshape(-1))
    keep, src = _bwd_indices(*shape)
    want = np.zeros((n, hc, wc, ch), bool)
    want[:, :ho, :wo] = True
    np.testing.assert_array_equal(keep, want.reshape(-1))
    np.testing.assert_array_equal(np.sort(src[keep]),
                                  np.arange(n * ho * wo * ch))
    # in the kept region dy's flat index is y's: the same NHWC order
    np.testing.assert_array_equal(src[keep], np.arange(n * ho * wo * ch))


def _span_walk(total, length, ch):
    """The scalar path's walk (C < 8): warp span sp, lane l, slot j takes
    element sp·256 + 32j + l, its row position (r, k) kept by increments
    of 32 from the first slot's division, as the kernels keep it. Returns
    every element's (row, k) and its channel slot."""
    out = {}
    for sp in range(-(-total // 256)):
        for lane in range(32):
            e0 = sp * 256 + lane
            r, k = divmod(e0, length)
            for j in range(8):
                e = e0 + 32 * j
                if e < total:
                    out[e] = (r, k, lane % ch)
                k += 32
                while k >= length:
                    k -= length
                    r += 1
    return out


@pytest.mark.parametrize("total, length, ch", [(2 * 97 * 129, 129, 1),
                                               (2 * 96 * 128, 128, 1),
                                               (3 * 5 * 6 * 2, 12, 2),
                                               (7 * 4 * 3 * 4, 12, 4),
                                               (50, 8, 2)])
def test_scalar_walk_visits_each_element_once(total, length, ch):
    """The scalar path writes every element once, knows its row and place
    in the row (so its crop test and dy index are the vector path's), and
    the element's channel is its lane's."""
    walk = _span_walk(total, length, ch)
    assert sorted(walk) == list(range(total))
    for e, (r, k, slot) in walk.items():
        assert (r, k) == divmod(e, length)
        assert slot == e % ch


@pytest.mark.parametrize("ch", (1, 2, 8, 16, 128, 512, 2048))
@pytest.mark.parametrize("elements", (8, 8 * 300, 2048 * 600 + 24,
                                      2048 * 49 * 65 * 16))
def test_bias_gradient_tree_sums_each_channel(ch, elements):
    """A thread's 8 channels never change along its grid-stride walk, and
    the block tree (halving while half >= C) leaves each channel's sum of
    the block's positions in red[ch]; the grids are functions of the
    element count alone, within their caps."""
    for blocks, cap in ((ce.fwd_blocks, ce.FWD_MAX_BLOCKS),
                        (ce.bwd_blocks, ce.BWD_MAX_BLOCKS)):
        grid = blocks(elements)
        assert 1 <= grid <= cap and grid == blocks(elements)
        assert grid * ce.THREADS * ce.GROUP % ch == 0
    groups = -(-elements // ce.GROUP)
    g = np.arange(min(groups, 10 ** 6))
    tid = g % ce.THREADS
    for j in range(ce.GROUP):
        assert ((g * ce.GROUP + j) % ch == (tid * ce.GROUP + j) % ch).all()
    rng = np.random.default_rng(ch)
    red = rng.integers(-8, 8, ce.CHUNK).astype(np.int64)
    want = np.array([red[p::ch].sum() for p in range(ch)])
    half = ce.CHUNK // 2
    while half >= ch:
        red[:half] += red[half:2 * half]
        half //= 2
    np.testing.assert_array_equal(red[:ch], want)


def _reader():
    """perfbench/metrics/conv_epilogue_roofline.train_hier.py, loaded as the
    harness loads a reader."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
            / "conv_epilogue_roofline.train_hier.py")
    spec = importlib.util.spec_from_file_location("epilogue_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("use_pallas_conv1", (True, False))
def test_reader_bytes_are_the_models_epilogue_calls(use_pallas_conv1,
                                                     monkeypatch):
    """The benchmark's reader counts the bytes of the very calls c3's train
    step makes: a forward of the registered c3 (f32 on the CPU, one
    window) records each ``conv_block`` call's shapes, and their bytes
    (each input read once, each output written once, forward and
    backward; the backward reads c and the bias only for the GELU′, which
    the head's last layer lacks) sum to the reader's ``step_bytes``."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = json.loads((root / "perfbench" / "configs"
                       / "c3_hier_16bar.json").read_text())
    spec["model"].update(dtype="float32", use_pallas_conv1=use_pallas_conv1)
    spec["train"]["batch_size"] = 1
    cfg = tcfg.get_config("c3_hier_16bar")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float32", use_pallas_conv1=use_pallas_conv1))
    model = build_model(cfg, device="cpu", seed=0)
    calls = []
    block = layers.conv_block

    def recorded(x, weight, bias, stride, padding, transposed=False,
                 crop=None, gelu=True, out_dtype=None):
        n, h, w, _ = x.shape
        ch = weight.shape[1] if transposed else weight.shape[0]
        if transposed:     # the conv output's grid, before the crop
            grid = tuple((d - 1) * s - 2 * q + 3
                         for d, s, q in zip((h, w), stride, padding))
        else:
            grid = tuple((d + 2 * q - 3) // s + 1
                         for d, s, q in zip((h, w), stride, padding))
        calls.append(((n, ch, *grid), crop or grid, gelu,
                      out_dtype or x.dtype))
        return block(x, weight, bias, stride, padding, transposed, crop,
                     gelu, out_dtype)

    monkeypatch.setattr(layers, "conv_block", recorded)
    x = torch.zeros(1, 16, 96, 128, dtype=torch.uint8)
    eps = (torch.zeros(1, 256), torch.zeros(1, 16, 64))
    with torch.no_grad():
        model(x, eps)
    total = 0
    for (n, ch, hc, wc), (ho, wo), gelu, out in calls:
        o = torch.finfo(out).bits // 8
        kept, full = n * ho * wo * ch, n * hc * wc * ch
        total += (kept * 4 + ch * 4 + kept * o          # forward
                  + kept * o + full * 4 + ch * 4        # dy, dc, db
                  + (kept * 4 + ch * 4 if gelu else 0))  # c, b for GELU′
    assert len(calls) == (13 if use_pallas_conv1 else 15)
    assert [g for *_, g, _ in calls].count(False) == 1
    assert _reader().step_bytes(spec) == total


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_the_plain_versions_on_the_card(case):
    """On the card, at a small size: the forward and dc within 1 bf16 ulp
    of the plain versions, dc zero on the cropped edge, db within 1 ulp
    and 1e-5 of the channel's absolute sum (chip_smoke.py ``epilogue``
    runs the same check at the registered widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    _, ch, grid, crop, gelu, logits = case
    c, b, dy, out = _inputs(ch, grid, crop, torch.bfloat16, logits)
    c = c.contiguous(memory_format=torch.channels_last).cuda()
    b, dy = b.cuda(), dy.cuda()
    y = ce._forward(c, b, crop, gelu, out)
    dc, db = ce._backward(c, b, dy, crop, gelu)
    want_y = ce.conv_epilogue_ref(c, b, crop, gelu, out)
    want_dc, want_db = ce.conv_epilogue_bwd_ref(c, b, dy, crop, gelu)

    def ulps(a, w):
        i = torch.stack([a.bfloat16(), w.bfloat16()]).view(torch.int16)
        i = i.int()
        i = torch.where(i < 0, -(i & 0x7FFF), i)
        return int((i[0] - i[1]).abs().max())

    assert ulps(y.float(), want_y.float()) <= 1
    assert ulps(dc.float(), want_dc.float()) <= 1
    if crop is not None:
        assert not dc[:, :, crop[0]:].any() and not dc[:, :, :, crop[1]:].any()
    err = (db.float() - want_db.float()).abs()
    tol = want_db.float().abs() * 2.0 ** -7 + 1e-5 * want_dc.float().abs().sum(
        (0, 2, 3))
    assert (err <= tol).all()
